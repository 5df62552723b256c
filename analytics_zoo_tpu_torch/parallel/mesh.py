"""Device meshes: the named axes the parallel strategies run over.

Counterpart of ``analytics_zoo_tpu/parallel/mesh.py``.  The JAX package
runs one controller over every device; here one process drives one
device, and a mesh is a ``torch.distributed`` ``DeviceMesh`` over the
ranks of the process group, one rank a device.

Axis convention (the JAX package's):
  data   - data parallelism (gradients averaged)
  fsdp   - parameter and optimizer sharding (ZeRO), gradients averaged
  tensor - tensor parallelism within layers
  seq    - sequence parallelism (ring attention)
  expert - expert parallelism (MoE)
  pipe   - pipeline stages

:func:`create_mesh` names every one of the six axes: the axes the caller
gives, in the caller's order (rank ``r``'s coordinates are ``r`` in that
row-major layout, as the JAX package reshapes its device list), then the
others at size 1.  An axis of size 1 is the JAX package's absent axis:
every rule and strategy treats the two alike.

When no process group exists, :func:`create_mesh` joins the launcher's
pod (``parallel/distributed.py``) or else a world of one: NCCL for a CUDA
device, gloo for ``device="cpu"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from . import distributed as dist_lib

AXES = ("data", "fsdp", "tensor", "seq", "expert", "pipe")

#: the axes a batch is split over; gradients are averaged over them
DATA_AXES = ("data", "fsdp")


@dataclass(frozen=True)
class NamedSharding:
    """A layout on a mesh: ``spec`` holds, per tensor dimension, the
    mesh axis (or tuple of axes, major first) it is split over, or None
    (``parallel/sharding.py``'s spec vocabulary).  A leaf of a tree, not
    a node."""

    mesh: object
    spec: tuple


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh``, or of a mapping of axis sizes
    (the rule tables take either)."""
    if mesh is None:
        return {}
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if hasattr(mesh, "shape") and hasattr(mesh.shape, "items"):
        return dict(mesh.shape)  # a JAX-like mesh: .shape is a mapping
    return dict(mesh)


def _device_type(device) -> str:
    if device is None:
        return "cuda"
    return torch.device(device).type


def _join_world(device, timeout_s: float) -> None:
    """The process group: the launcher's pod when its variables are
    set, else a world of one on an in-process store, on ``device``'s
    card (``cuda:0`` where it names none)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    device_type = _device_type(device)
    if dist_lib.maybe_initialize_distributed(device_type,
                                             timeout_s=timeout_s):
        return
    from datetime import timedelta
    if device_type == "cuda":
        index = None if device is None else torch.device(device).index
        torch.cuda.set_device(index or 0)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), world_size=1, rank=0,
                            timeout=timedelta(seconds=timeout_s))
    dist_lib.shutdown_at_exit()


def create_mesh(axes: Optional[Dict[str, int]] = None, device=None,
                timeout_s: float = 300.0):
    """A ``DeviceMesh`` over every rank of the process group with named
    axis sizes; with no ``axes``, every rank on the ``data`` axis.  One
    size of -1 absorbs the remaining ranks.  ``device`` is the device
    type the ranks compute on (default ``"cuda"``; ``"cpu"`` for gloo).
    Raises ValueError when the sizes do not multiply to the world
    size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type(device)
    _join_world(device, timeout_s)
    n = dist.get_world_size()
    axes = dict(axes or {"data": n})
    known = math.prod(v for v in axes.values() if v != -1)
    for k, v in axes.items():
        if v == -1:
            axes[k] = n // known
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(f"Mesh axes {axes} need {total} devices, have {n}")
    for name in AXES:
        axes.setdefault(name, 1)
    return init_device_mesh(device_type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes.keys()))


def device_of(mesh) -> torch.device:
    """This rank's device on ``mesh`` (its current CUDA device, or the
    CPU for a gloo mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _axes_present(mesh, names: Sequence[str]) -> tuple:
    sizes = axis_sizes(mesh)
    return tuple(a for a in names if sizes.get(a, 1) > 1)


def data_sharding(mesh, batch_axes: Sequence[str] = DATA_AXES):
    """The layout of a batch: its leading dim split over the data-ish
    axes of size > 1, the rest replicated."""
    present = _axes_present(mesh, batch_axes)
    return NamedSharding(mesh, (present,) if present else ())


def replicated(mesh):
    return NamedSharding(mesh, ())


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in DATA_AXES)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 on an axis of size 1)."""
    if axis_sizes(mesh).get(axis, 1) == 1:
        return 0
    return mesh.get_local_rank(axis)


def data_index(mesh, batch_axes: Sequence[str] = DATA_AXES) -> int:
    """Which of the ``dp_size`` batch shards this rank feeds: its
    row-major coordinate over the data axes (ranks that differ only on
    the other axes feed the same rows)."""
    sizes = axis_sizes(mesh)
    index = 0
    for a in batch_axes:
        index = index * sizes.get(a, 1) + axis_index(mesh, a)
    return index


def _ranks_by(mesh, axes: Sequence[str]):
    """Rank lists of the sub-meshes spanned by ``axes`` (each list the
    ranks that differ only on those axes, row-major over them)."""
    names = list(mesh.mesh_dim_names)
    layout = mesh.mesh
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    moved = layout.permute(rest + keep).reshape(
        -1, math.prod(layout.shape[i] for i in keep) if keep else 1)
    return [row.tolist() for row in moved]


def group_over(mesh, axes: Sequence[str]):
    """The process group of the ranks that differ only on ``axes``
    (created once a mesh, collectively: every rank calls it with the
    same ``axes`` in the same order); None when it holds one rank."""
    axes = tuple(a for a in axes if axis_sizes(mesh).get(a, 1) > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_zoo_groups", {})
    if axes not in cache:
        import torch.distributed as dist
        cache[axes], _ = dist.new_subgroups_by_enumeration(
            _ranks_by(mesh, axes))
    return cache[axes]


_DEFAULT_MESH = None
_ACTIVE_MESH = None


def set_default_mesh(mesh) -> None:
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


class active_mesh:
    """Context manager marking the mesh a Trainer is running under, so
    mesh-aware layers (ring attention, SwitchMoE's expert branch) see the
    mesh handed to ``compile(mesh=...)`` rather than only the process
    default."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


def get_active_mesh():
    """The mesh of the running Trainer (inside one), else the process
    default, without creating one."""
    return _ACTIVE_MESH if _ACTIVE_MESH is not None else _DEFAULT_MESH


def get_default_mesh(device=None):
    """The process default mesh, created on first use over every rank
    on the ``data`` axis."""
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        _DEFAULT_MESH = create_mesh(device=device)
    return _DEFAULT_MESH


_BATCH_GROUP = None


class batch_split:
    """Context manager marking that the model runs on this rank's rows of
    a batch split over ``group`` (the process group of the data axes; the
    Trainer's step, ``evaluate`` and ``predict`` set it while their plan
    splits the batch).  The layers whose result depends on the whole
    batch reduce over it, as the JAX package's do under ``jit`` on the
    global batch: BatchNormalization's training statistics and
    SwitchMoE's routing.  ``None`` (one device, or no plan): no
    collective."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        global _BATCH_GROUP
        self._prev = _BATCH_GROUP
        _BATCH_GROUP = self.group
        return self.group

    def __exit__(self, *exc):
        global _BATCH_GROUP
        _BATCH_GROUP = self._prev
        return False


def batch_group():
    """The process group the running batch is split over, or None."""
    return _BATCH_GROUP
