"""analytics_zoo_tpu_torch: the PyTorch/CUDA port of analytics_zoo_tpu.

A package of its own beside the JAX one, laid out like it so that each
module's counterpart is easy to find.  It imports torch, numpy and the
standard library only.  A session starts with :func:`init_nncontext`
(``common/context.py``); entry points take ``device=`` and default to
``"cuda"``; without a card they raise unless ``device="cpu"`` is asked
for.  The hand-written CUDA kernels live under ``ops/csrc`` and are built
at first use (``ops/_kernels.py``).
"""

from .common.context import (NNContext, ZooTpuConfig, __version__,
                             init_nncontext, initNNContext, get_nncontext,
                             reset_nncontext, check_version, resolve_device)

#: the graph and data names the JAX package exports at its top level,
#: imported at first use so that importing the package stays cheap
_LAZY = {"Input": "core.graph", "Variable": "core.graph",
         "GraphModule": "core.graph", "Layer": "core.module",
         "Dataset": "data.dataset"}

__all__ = ["NNContext", "ZooTpuConfig", "init_nncontext", "initNNContext",
           "get_nncontext", "reset_nncontext", "check_version",
           "resolve_device", *_LAZY, "__version__"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
