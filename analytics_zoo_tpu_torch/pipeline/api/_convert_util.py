"""Static-vs-traced dispatch shared by the graph importers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/_convert_util.py``.  Both
converters (``tfgraph/converter.py`` and ``onnx/converter.py``) keep
shape math on the host in numpy: a numpy value (or a Python number) is
*static*, a ``torch.Tensor`` is *traced* (a value of the call's inputs
or parameters, on the call's device).  An op whose arguments are all
static runs in numpy; otherwise its static arguments become tensors on
the call's device (:meth:`ConvertCtx.tensor`) and it runs in torch.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

#: numpy dtypes as the JAX package sees them without x64: float64 arrays
#: narrow to f32 when they meet the device (integers keep their width
#: here: torch indexes with int64)
_NARROW = {np.dtype("float64"): np.dtype("float32")}


def is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def require_static(v, what: str):
    """Require a host-static value (shape math); fail with guidance."""
    if not is_static(v):
        raise ValueError(
            f"{what} must be statically known (got a traced value); keep "
            "shape-producing subgraphs free of graph inputs")
    return np.asarray(v)


def static_ints(v, what: str) -> List[int]:
    return [int(x) for x in np.atleast_1d(require_static(v, what))]


def to_tensor(v, device) -> torch.Tensor:
    """``v`` as a tensor on ``device`` (a tensor stays as it is; numpy
    float64 narrows to f32, as the JAX package's device arrays do)."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
    if a.dtype == np.uint16 or a.dtype == np.uint32:
        a = a.astype(np.int64)  # torch lacks arithmetic on these
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a)  # a decoded buffer is read-only
    return torch.as_tensor(a, device=device)


class ConvertCtx:
    """Per-call conversion context: params, the random generator, the
    training flag, the call's device and the graph's constant cache.

    ``rng`` is a ``torch.Generator`` on the call's device; every random
    node draws from it in turn (:meth:`next_rng`).  The JAX package folds
    a fresh key per node instead, so the two packages' random draws
    differ (ROADMAP Queue 3, Known differences)."""

    def __init__(self, params, rng, training, device=None, consts=None):
        self.params = params
        self.rng = rng
        self.training = training
        self.device = device if device is not None else torch.device("cpu")
        self.node_seq = 0
        # id of a folded constant array -> its tensors by device, kept by
        # the converted graph across calls
        self._consts = consts

    def next_rng(self) -> torch.Generator:
        if self.rng is None:
            raise ValueError(
                "graph contains random ops (dropout?); pass rng= to the "
                "converted function")
        self.node_seq += 1
        return self.rng

    def tensor(self, v) -> torch.Tensor:
        """``v`` on the call's device; a constant folded when the graph
        was built is copied there once and kept."""
        if isinstance(v, torch.Tensor):
            return v
        cache = self._consts
        if cache is not None and id(v) in cache:
            by_dev = cache[id(v)][1]
            key = str(self.device)
            if key not in by_dev:
                by_dev[key] = to_tensor(v, self.device)
            return by_dev[key]
        return to_tensor(v, self.device)

    def nb(self, np_fn, torch_fn):
        """An n-ary op that stays in numpy when all its arguments are
        static, else runs in torch on tensors."""
        def h(*args):
            if all(is_static(a) for a in args):
                return np_fn(*args)
            return torch_fn(*[self.tensor(a) for a in args])
        return h


def constant_cache(values) -> dict:
    """The cache :class:`ConvertCtx` reads, over the folded constant
    arrays ``values`` (each kept alive beside its tensors)."""
    return {id(v): (v, {}) for v in values
            if isinstance(v, np.ndarray)}


def require_module(name: str, what: str):
    """``import name`` for ``what``, or an ImportError that names the
    package (``tensorflow``, ``pandas``): the port imports them only in
    the functions that need them, and the card's machine may lack them."""
    import importlib
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"{what} needs the {name!r} package, which is not installed "
            "here") from e
