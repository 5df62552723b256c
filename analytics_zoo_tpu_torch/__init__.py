"""analytics_zoo_tpu_torch: the PyTorch/CUDA port of analytics_zoo_tpu.

A package of its own beside the JAX one, laid out like it so that each
module's counterpart is easy to find.  It imports torch, numpy and the
standard library only.  Entry points take ``device=`` and default to
``"cuda"``; without a card they raise unless ``device="cpu"`` is asked
for.  The hand-written CUDA kernels live under ``ops/csrc`` and are built
at first use (``ops/_kernels.py``).
"""

from .common.context import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
