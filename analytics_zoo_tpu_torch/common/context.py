"""Device resolution for the port's entry points.

Counterpart of ``analytics_zoo_tpu/common/context.py``, reduced to what
the port needs: the JAX package's context holds a device mesh, while here
every entry point takes a ``device`` and resolves it through
:func:`resolve_device`.
"""

from __future__ import annotations

import torch


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
