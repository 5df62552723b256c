"""The session context and device resolution for the port's entry points.

Counterpart of ``analytics_zoo_tpu/common/context.py``: one typed
:class:`ZooTpuConfig`, and :func:`init_nncontext`, which creates (or
returns) the process-wide :class:`NNContext` holding the session's
device mesh.  Here one process drives one device, so the mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the process group
(``parallel/mesh.py``): the launcher's pod when its variables are set,
else a world of one.

Every entry point also takes a ``device`` and resolves it through
:func:`resolve_device`, so a context is never required: ``None`` means
``"cuda"``, and there is no quiet fallback to the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import torch

log = logging.getLogger("analytics_zoo_tpu_torch")

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises:
    the port never carries on quietly on the CPU; pass ``device="cpu"``
    to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class ZooTpuConfig:
    """Typed session configuration (the JAX package's fields and
    defaults)."""

    app_name: str = "analytics-zoo-tpu"
    mesh_axes: Optional[Dict[str, int]] = None  # None -> all ranks on data
    compute_dtype: str = "float32"
    seed: int = 0
    log_level: str = "INFO"
    version_check: bool = False


class NNContext:
    """Holds the device mesh, the config and this process's device for a
    session."""

    def __init__(self, conf: ZooTpuConfig, mesh, device: torch.device):
        self.conf = conf
        self.mesh = mesh
        self.app_name = conf.app_name
        self.device = device

    @property
    def devices(self):
        """Every rank's device, in rank order: one process drives one
        device (``cuda:<local rank>`` on a card, the CPU under gloo)."""
        if self.mesh.device_type != "cuda":
            return [torch.device("cpu")] * self.device_count
        local = max(torch.cuda.device_count(), 1)
        return [torch.device("cuda", r % local)
                for r in range(self.device_count)]

    @property
    def device_count(self):
        return self.mesh.mesh.numel()

    def axis_sizes(self) -> Dict[str, int]:
        """The axes the session asked for, with their sizes (the JAX
        mesh's ``shape``); the mesh names the other axes at size 1."""
        from ..parallel.mesh import axis_sizes
        sizes = axis_sizes(self.mesh)
        named = len(self.conf.mesh_axes or {"data": 0})
        return dict(list(sizes.items())[:named])

    def __repr__(self):
        return (f"NNContext(app={self.app_name!r}, "
                f"platform={self.device.type}, "
                f"mesh={self.axis_sizes()})")


_CONTEXT: Optional[NNContext] = None


def init_nncontext(conf: Optional[ZooTpuConfig] = None,
                   app_name: Optional[str] = None,
                   device=None) -> NNContext:
    """Create (or return) the process-wide context: repeated calls return
    the same context, and a bare string ``conf`` is the app name.  Joins
    the launcher's pod when its variables are set (else a world of one),
    builds the mesh from ``conf.mesh_axes`` and makes it the default.
    ``device`` is this process's device (``None`` means ``"cuda"``,
    which raises without a card): a world of one joins on the card it
    names, and a card that is not the rank's in a group already joined
    (the pod's: local rank modulo the cards) raises."""
    global _CONTEXT
    if _CONTEXT is not None:
        return _CONTEXT
    if isinstance(conf, str):
        conf, app_name = None, app_name or conf
    conf = conf or ZooTpuConfig()
    if app_name:
        conf.app_name = app_name
    dev = resolve_device(device)
    logging.basicConfig(level=getattr(logging, conf.log_level, logging.INFO))
    if conf.version_check:
        check_version()
    from ..parallel import distributed as dist_lib
    from ..parallel import mesh as mesh_lib
    dist_lib.maybe_initialize_distributed(dev)
    mesh = mesh_lib.create_mesh(conf.mesh_axes, device=dev)
    if dev.type == "cuda":  # the rank's card, as the group's join set it
        joined = mesh_lib.device_of(mesh)
        if dev.index is not None and dev.index != joined.index:
            raise ValueError(
                f"device {str(dev)!r} is not this rank's card in its "
                f"process group ({str(joined)!r})")
        dev = joined
    mesh_lib.set_default_mesh(mesh)
    _CONTEXT = NNContext(conf, mesh, dev)
    log.info("initNNContext: process %d/%d, %d %s device(s), mesh %s",
             dist_lib.process_index(), dist_lib.process_count(),
             _CONTEXT.device_count, dev.type, _CONTEXT.axis_sizes())
    return _CONTEXT


# the reference's camelCase entry point
initNNContext = init_nncontext


def get_nncontext() -> Optional[NNContext]:
    return _CONTEXT


def reset_nncontext():
    """Forget the context and the default mesh (the process group stays
    joined, as a pod's does)."""
    global _CONTEXT
    _CONTEXT = None
    from ..parallel import mesh as mesh_lib
    mesh_lib.set_default_mesh(None)


def check_version():
    """Log the port's and torch's versions."""
    log.info("analytics-zoo-tpu-torch %s on torch %s (CUDA %s)",
             __version__, torch.__version__, torch.version.cuda)
    return __version__
