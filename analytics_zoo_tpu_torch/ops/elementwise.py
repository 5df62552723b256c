"""Primitive symbolic ops over ``Variable`` graphs.

Counterpart of ``analytics_zoo_tpu/ops/elementwise.py``: the reference's
``AutoGrad`` op set (abs, sum, clip, square, sqrt, maximum, mean, log,
epsilon, exp, pow, softsign, softplus, stack, expand_dims, contiguous,
mm, l2_normalize, batch_dot) and the ``Variable`` operators.  Each op is
a parameterless ``OpLayer`` node applying a registered torch function;
on plain tensors (or numbers) the same call evaluates eagerly, so the
ops also work inside ``Lambda`` and ``CustomLoss`` functions.

Axes index the full array, batch included, as in the JAX package.  The
torch functions are chosen to give ``jnp``'s values and gradients:
``amax``/``amin`` (values, not pairs; ties share the gradient),
``torch.maximum`` for relu and clip (a tie at the bound takes half the
gradient, as ``jnp.maximum`` gives it), ``logaddexp`` for softplus,
integer inputs promoted to f32 where ``jnp`` promotes them, and
``jnp.take``'s fill mode for slice and index_select (an index in
[-n, n) wraps, one outside gives NaN, or the integer minimum, instead
of raising).  ``mm`` and ``batch_dot`` take ``axes`` and ignore it, as
the JAX package's do: ``mm`` is a (broadcast) matmul, ``batch_dot`` the
``b...ik,b...kj->b...ij`` product.
"""

from __future__ import annotations

import builtins
from typing import Callable, Dict

import numpy as np
import torch

from ..core.graph import Variable, broadcast_shapes
from ..core.module import Layer, promote, register_layer

_OPS: Dict[str, Callable] = {}
_SHAPE_FNS: Dict[str, Callable] = {}


def def_op(name: str, fn: Callable, shape_fn: Callable = None):
    """Register op ``name``: ``fn(tensors, **kwargs)`` computes it,
    ``shape_fn(shapes, **kwargs)`` infers its batch shape (default: the
    first input's)."""
    _OPS[name] = fn
    _SHAPE_FNS[name] = shape_fn or (lambda shapes, **kw: shapes[0])


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


@register_layer
class OpLayer(Layer):
    """Parameterless node applying a registered op to its inputs."""

    needs_input_shape = False

    def __init__(self, op=None, op_kwargs=None, name=None, input_shape=None):
        super().__init__(name=name or None, input_shape=input_shape)
        self.op = op
        self.op_kwargs = dict(op_kwargs or {})

    def forward(self, inputs):
        return _OPS[self.op](_as_list(inputs), **self.op_kwargs)

    def compute_output_shape(self, input_shape):
        shapes = (input_shape if input_shape
                  and isinstance(input_shape[0], (tuple, list))
                  else [input_shape])
        return _SHAPE_FNS[self.op]([tuple(s) for s in shapes],
                                   **self.op_kwargs)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(op=self.op, op_kwargs=self.op_kwargs)
        return cfg


def _jnp_array(value) -> np.ndarray:
    """``value`` at the dtype ``jnp.asarray`` gives it without x64:
    floats f32, integers i32."""
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        return arr.astype(np.float32)
    if arr.dtype.kind in "iu":
        return arr.astype(np.int32)
    return arr


@register_layer
class ConstantLayer(Layer):
    """Zero-input node producing a fixed array (a graph-captured
    constant).  The value is neither a parameter nor state: it lives in
    the config and moves to the model's device when the model builds
    the layer."""

    is_source = True
    needs_input_shape = False

    def __init__(self, value=None, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.value = torch.from_numpy(_jnp_array(value))

    def build_params(self, input_shape, generator):
        self.value = self.value.to(generator.device)

    def forward(self):
        return self.value

    def compute_output_shape(self, input_shape):
        return tuple(self.value.shape)

    def get_config(self):
        cfg = super().get_config()
        cfg["value"] = self.value.cpu().numpy().tolist()
        return cfg


def constant(value, name=None) -> Variable:
    layer = ConstantLayer(value=value, name=name)
    return Variable(layer, (), tuple(layer.value.shape), name=layer.name)


def _as_variable(x):
    return x if isinstance(x, Variable) else constant(x)


def _apply(op: str, variables, **op_kwargs):
    """On Variables the op becomes a graph node; on tensors and numbers
    it runs now (numbers become tensors on the first tensor's device, at
    ``jnp``'s dtypes)."""
    if not builtins.any(isinstance(v, Variable) for v in variables):
        device = next((v.device for v in variables
                       if isinstance(v, torch.Tensor)), None)
        return _OPS[op]([v if isinstance(v, torch.Tensor)
                         else torch.as_tensor(_jnp_array(v), device=device)
                         for v in variables], **op_kwargs)
    vs = [_as_variable(v) for v in variables]
    layer = OpLayer(op=op, op_kwargs=op_kwargs)
    return Variable.from_layer(layer, vs if len(vs) > 1 else vs[0])


def _float(x):
    """Integer and bool tensors at f32, as ``jnp`` promotes them for a
    transcendental op or a mean; floating ones as they are."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _dims(axis):
    """A reduction's ``axis`` (int, list or tuple; a config round trip
    turns tuples into lists) as torch's ``dim``."""
    return axis if axis is None or isinstance(axis, int) else tuple(axis)


# ---------------- shape helpers ----------------

def _broadcast_shape_fn(shapes, **kw):
    out = shapes[0]
    for s in shapes[1:]:
        out = broadcast_shapes(out, s)
    return out


def _reduce_shape_fn(shapes, axis=None, keepdims=False, **kw):
    s = list(shapes[0])
    if axis is None:
        return () if not keepdims else tuple(1 for _ in s)
    axes = [axis] if isinstance(axis, int) else list(axis)
    axes = [a % len(s) for a in axes]
    if keepdims:
        for a in axes:
            s[a] = 1
        return tuple(s)
    return tuple(d for i, d in enumerate(s) if i not in axes)


# ---------------- binary elementwise ----------------

def _maximum(a, b):
    a, b = promote(a, b)
    return torch.maximum(a, b)


def _minimum(a, b):
    a, b = promote(a, b)
    return torch.minimum(a, b)


def_op("add", lambda xs: xs[0] + xs[1], _broadcast_shape_fn)
def_op("sub", lambda xs: xs[0] - xs[1], _broadcast_shape_fn)
def_op("mul", lambda xs: xs[0] * xs[1], _broadcast_shape_fn)
def_op("div", lambda xs: xs[0] / xs[1], _broadcast_shape_fn)
def_op("maximum", lambda xs: _maximum(xs[0], xs[1]), _broadcast_shape_fn)
def_op("minimum", lambda xs: _minimum(xs[0], xs[1]), _broadcast_shape_fn)


def add(x, y):
    return _apply("add", [x, y])


def sub(x, y):
    return _apply("sub", [x, y])


def mul(x, y):
    return _apply("mul", [x, y])


def div(x, y):
    return _apply("div", [x, y])


def maximum(x, y):
    return _apply("maximum", [x, y])


def minimum(x, y):
    return _apply("minimum", [x, y])


# ---------------- unary ----------------

def _scalar_like(x, value):
    """``value`` as a 0-d tensor at the dtype ``x`` promotes a Python
    float to (f32 for integer ``x``)."""
    return torch.tensor(value, dtype=torch.result_type(x, float(value)),
                        device=x.device)


def _clip(x, min=None, max=None):  # noqa: A002 - jnp.clip's names
    # jnp.clip is minimum(maximum(x, min), max): a tie at a bound takes
    # half the gradient, where torch.clamp passes all of it
    if min is not None:
        x = _maximum(x, _scalar_like(x, min))
    if max is not None:
        x = _minimum(x, _scalar_like(x, max))
    return x


def _softplus(x):
    x = _float(x)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def_op("neg", lambda xs: -xs[0])
def_op("abs", lambda xs: torch.abs(xs[0]))
def_op("square", lambda xs: torch.square(xs[0]))
def_op("sqrt", lambda xs: torch.sqrt(_float(xs[0])))
def_op("log", lambda xs: torch.log(_float(xs[0])))
def_op("exp", lambda xs: torch.exp(_float(xs[0])))
def_op("pow", lambda xs, p=2.0: torch.pow(xs[0], p))
def_op("softsign", lambda xs: xs[0] / (1.0 + torch.abs(xs[0])))
def_op("softplus", lambda xs: _softplus(xs[0]))
def_op("clip", lambda xs, min=None, max=None: _clip(xs[0], min, max))
def_op("contiguous", lambda xs: xs[0])
def_op("relu", lambda xs: _maximum(xs[0], _scalar_like(xs[0], 0.0)))
def_op("sigmoid", lambda xs: 1.0 / (1.0 + torch.exp(-_float(xs[0]))))
def_op("tanh", lambda xs: torch.tanh(_float(xs[0])))


def neg(x):
    return _apply("neg", [x])


def abs(x):  # noqa: A001 - the reference's AutoGrad.abs
    return _apply("abs", [x])


def square(x):
    return _apply("square", [x])


def sqrt(x):
    return _apply("sqrt", [x])


def log(x):
    return _apply("log", [x])


def exp(x):
    return _apply("exp", [x])


def pow(x, p):  # noqa: A001
    return _apply("pow", [x], p=float(p))


def softsign(x):
    return _apply("softsign", [x])


def softplus(x):
    return _apply("softplus", [x])


def clip(x, min=None, max=None):  # noqa: A002
    return _apply("clip", [x], min=min, max=max)


def contiguous(x):
    return _apply("contiguous", [x])


def relu(x):
    return _apply("relu", [x])


def sigmoid(x):
    return _apply("sigmoid", [x])


def tanh(x):
    return _apply("tanh", [x])


def epsilon():
    """Fuzz factor of the reference's AutoGrad.epsilon."""
    return 1e-7


# ---------------- reductions ----------------

def _no_axes(axis) -> bool:
    """An empty axis list: ``jnp`` reduces over nothing, where torch's
    ``dim=()`` means every axis."""
    return axis is not None and not isinstance(axis, int) and not len(axis)


def _sum(x, axis=None, keepdims=False):
    if _no_axes(axis):
        return x
    out = torch.sum(x, dim=_dims(axis), keepdim=keepdims)
    # jnp keeps int32 (and sums bools to int32); torch widens to int64
    return out if out.is_floating_point() else out.to(torch.int32)


def _mean(x, axis=None, keepdims=False):
    if _no_axes(axis):
        return _float(x)
    return torch.mean(_float(x), dim=_dims(axis), keepdim=keepdims)


def _extreme(fn, x, axis=None, keepdims=False):
    """``amax``/``amin``: values only, ties share the gradient."""
    if _no_axes(axis):
        return x
    return fn(x, dim=() if axis is None else _dims(axis), keepdim=keepdims)


def_op("sum", lambda xs, axis=None, keepdims=False:
       _sum(xs[0], axis, keepdims), _reduce_shape_fn)
def_op("mean", lambda xs, axis=None, keepdims=False:
       _mean(xs[0], axis, keepdims), _reduce_shape_fn)
def_op("max", lambda xs, axis=None, keepdims=False:
       _extreme(torch.amax, xs[0], axis, keepdims), _reduce_shape_fn)
def_op("min", lambda xs, axis=None, keepdims=False:
       _extreme(torch.amin, xs[0], axis, keepdims), _reduce_shape_fn)


def sum(x, axis=None, keepdims=False):  # noqa: A001
    return _apply("sum", [x], axis=axis, keepdims=keepdims)


def mean(x, axis=None, keepdims=False):
    return _apply("mean", [x], axis=axis, keepdims=keepdims)


def max(x, axis=None, keepdims=False):  # noqa: A001
    return _apply("max", [x], axis=axis, keepdims=keepdims)


def min(x, axis=None, keepdims=False):  # noqa: A001
    return _apply("min", [x], axis=axis, keepdims=keepdims)


# ---------------- shape manipulation ----------------

def _expand_dims_shape(shapes, axis=0, **kw):
    s = list(shapes[0])
    a = axis if axis >= 0 else len(s) + 1 + axis
    s.insert(a, 1)
    return tuple(s)


def _squeeze_shape(shapes, axis=None, **kw):
    s = list(shapes[0])
    a = axis % len(s)
    if s[a] not in (1, None):
        raise ValueError(f"Cannot squeeze axis {axis} of shape {shapes[0]}")
    return tuple(d for i, d in enumerate(s) if i != a)


def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if x.shape[axis] != 1:
        raise ValueError(f"Cannot squeeze axis {axis} of shape "
                         f"{tuple(x.shape)}")
    return torch.squeeze(x, axis)


def_op("expand_dims", lambda xs, axis=0: torch.unsqueeze(xs[0], axis),
       _expand_dims_shape)
def_op("squeeze", lambda xs, axis=None: _squeeze(xs[0], axis),
       _squeeze_shape)


def expand_dims(x, axis=0):
    return _apply("expand_dims", [x], axis=axis)


def squeeze(x, axis):
    return _apply("squeeze", [x], axis=axis)


def _stack_shape(shapes, axis=0, **kw):
    s = list(shapes[0])
    a = axis if axis >= 0 else len(s) + 1 + axis
    s.insert(a, len(shapes))
    return tuple(s)


def_op("stack", lambda xs, axis=0: torch.stack(promote(*xs), dim=axis),
       _stack_shape)


def stack(variables, axis=0):
    return _apply("stack", list(variables), axis=axis)


def _concat_shape(shapes, axis=-1, **kw):
    s = list(shapes[0])
    a = axis % len(s)
    total = 0
    for sh in shapes:
        if sh[a] is None:
            total = None
            break
        total += sh[a]
    s[a] = total
    return tuple(s)


def_op("concat", lambda xs, axis=-1: torch.cat(promote(*xs), dim=axis),
       _concat_shape)


def concat(variables, axis=-1):
    return _apply("concat", list(variables), axis=axis)


def _fill_value(dtype):
    """What ``jnp.take`` gives for an index out of range."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min


def _take(x, indices, dim: int):
    """``jnp.take(x, indices, axis=dim)`` in its default fill mode, for
    a static int or list of ints: an index in [-n, n) wraps, one outside
    gives the fill value.  In-range contiguous indices are a view."""
    n = x.shape[dim]
    scalar = isinstance(indices, (int, np.integer))
    idx = [int(indices)] if scalar else [int(i) for i in indices]
    valid = [-n <= i < n for i in idx]
    norm = [i % n if ok else 0 for i, ok in zip(idx, valid)]
    if builtins.all(valid):
        if scalar:
            return x.select(dim, norm[0])
        start = norm[0] if norm else 0
        if norm == list(range(start, start + len(norm))):
            return x.narrow(dim, start, len(norm))
    pick = torch.tensor(norm, dtype=torch.long, device=x.device)
    out = torch.index_select(x, dim, pick)
    if not builtins.all(valid):
        shape = [1] * x.dim()
        shape[dim] = len(idx)
        keep = torch.tensor(valid, device=x.device).reshape(shape)
        out = torch.where(keep, out, torch.full((), _fill_value(x.dtype),
                                                dtype=x.dtype,
                                                device=x.device))
    return out.squeeze(dim) if scalar else out


def _slice_shape(shapes, dim=0, start=0, length=1, **kw):
    s = list(shapes[0])
    s[dim % len(s)] = length
    return tuple(s)


def_op("slice", lambda xs, dim=0, start=0, length=1:
       _take(xs[0], range(start, start + length), dim), _slice_shape)


def slice(x, dim, start_index, length):  # noqa: A001
    return _apply("slice", [x], dim=dim, start=start_index, length=length)


def _index_select_shape(shapes, dim=0, index=0, **kw):
    s = list(shapes[0])
    del s[dim % len(s)]
    return tuple(s)


def_op("index_select", lambda xs, dim=0, index=0: _take(xs[0], index, dim),
       _index_select_shape)


def index_select(x, dim, index):
    return _apply("index_select", [x], dim=dim, index=index)


def _getitem_shape(shapes, item=None, **kw):
    probe = np.zeros([d if d is not None else 2 for d in shapes[0]])
    out = probe[_decode_item(item)].shape
    # restore None batch if the batch axis survived a full slice
    if (shapes[0] and shapes[0][0] is None and isinstance(item, (list, tuple))
            and item and item[0] == ["slice", None, None, None]):
        out = (None,) + tuple(out[1:])
    return tuple(out)


def _encode_item(item):
    """A basic index (ints and slices) as JSON: a slice becomes
    ``["slice", start, stop, step]``."""
    items = item if isinstance(item, tuple) else (item,)
    enc = []
    for it in items:
        if isinstance(it, builtins.slice):
            enc.append(["slice", it.start, it.stop, it.step])
        else:
            enc.append(int(it))
    return enc


def _decode_item(enc):
    out = []
    for it in enc:
        if isinstance(it, (list, tuple)) and it and it[0] == "slice":
            out.append(builtins.slice(it[1], it[2], it[3]))
        else:
            out.append(it)
    return tuple(out)


def _getitem(x, item):
    """numpy's basic indexing; torch refuses a negative step, so those
    axes are gathered."""
    dim, out = 0, x
    for it in _decode_item(item):
        if isinstance(it, builtins.slice):
            if it.step is not None and it.step < 0:
                rows = range(*it.indices(out.shape[dim]))
                out = torch.index_select(out, dim, torch.tensor(
                    list(rows), dtype=torch.long, device=x.device))
            else:
                out = out[(builtins.slice(None),) * dim + (it,)]
            dim += 1
        else:
            out = out.select(dim, it)
    return out


def_op("getitem", lambda xs, item=None: _getitem(xs[0], item),
       _getitem_shape)


def getitem(x, item):
    return _apply("getitem", [x], item=_encode_item(item))


# ---------------- linear algebra ----------------

def _mm_shape(shapes, axes=None, **kw):
    a, b = shapes
    return tuple(a[:-1]) + (b[-1],)


def_op("mm", lambda xs, axes=None: torch.matmul(*promote(xs[0], xs[1])),
       _mm_shape)


def mm(x, y, axes=None):
    """Matrix multiply (the reference's AutoGrad.mm)."""
    return _apply("mm", [x, y])


def_op("batch_dot",
       lambda xs, axes=None: torch.einsum("b...ik,b...kj->b...ij",
                                          *promote(xs[0], xs[1])),
       _mm_shape)


def batch_dot(x, y, axes=None):
    return _apply("batch_dot", [x, y])


def _l2_normalize(x, axis=-1):
    sq = torch.sum(torch.square(x), dim=axis, keepdim=True)
    return x / torch.sqrt(torch.maximum(sq, _scalar_like(sq, 1e-12)))


def_op("l2_normalize", lambda xs, axis=-1: _l2_normalize(xs[0], axis))


def l2_normalize(x, axis=-1):
    return _apply("l2_normalize", [x], axis=axis)
