"""Frozen TF GraphDef → a torch function.

Counterpart of ``analytics_zoo_tpu/pipeline/api/tfgraph/converter.py``:
each GraphDef node maps to a torch expression (every op of the JAX
package's table), so a user's TF graph becomes one function that
autograd differentiates.  The graph comes from the port's own codec
(``proto.py``; a TF ``GraphDef`` given is re-read through its bytes),
so no TF runtime is needed.

* NHWC convolutions and pools run as NCHW torch ops between permutes;
  TF ``SAME`` padding (the extra row and column at the bottom and right)
  pads first, with ``-inf`` before a max pool; a ``SAME`` average leaves
  the padding out of its count.
* Shape math (Const/Shape/Pack/Range arithmetic feeding Reshape,
  StridedSlice, Tile, ...) runs on the host in numpy.  Nodes that depend
  on no input and no variable are evaluated once, when the graph is
  built; their arrays reach a device once (``ConvertCtx.tensor``).
* Variables (``VariableV2``, ``VarHandleOp``/``ReadVariableOp``) are
  entries of the params dict.  Random ops draw from the call's
  ``torch.Generator``.  TF control flow is rejected, as in the JAX
  package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import proto as _proto
from .._convert_util import (ConvertCtx as _Ctx, constant_cache,
                             is_static as _is_static,
                             require_static as _static,
                             static_ints as _ints, to_tensor)
from ..onnx.converter import (index as _index, one_hot as _one_hot_t,
                              pad_nd as _pad_nd,
                              softplus as _softplus, split_even as _split_even,
                              split_points as _split_points, take as _take,
                              window_max as _window_max,
                              window_sum as _window_sum,
                              _tensor_reduce, _NP_REDUCE)

_TORCH_OF_NP = {np.dtype("float32"): torch.float32,
                np.dtype("float64"): torch.float32,
                np.dtype("float16"): torch.float16,
                np.dtype("int32"): torch.int32, np.dtype("int64"): torch.int64,
                np.dtype("int16"): torch.int16, np.dtype("int8"): torch.int8,
                np.dtype("uint8"): torch.uint8, np.dtype("bool"): torch.bool}


# ---------------------------------------------------------------------------
# attrs + refs

def _attr(node, key, default=None):
    """An attribute as Python (int, float, bool, str, list, numpy dtype,
    shape tuple, ndarray)."""
    if key not in node.attr:
        return default
    v = _proto.attr_value(node.attr[key])
    return default if v is None else v


def _attr_torch_dtype(node, key, default):
    a = node.attr.get(key)
    if a is None:
        return default
    if _proto.base_dtype(a.type) == _proto.DT_BFLOAT16:
        return torch.bfloat16
    return _TORCH_OF_NP[_proto.np_dtype(a.type)]


def _parse_ref(ref: str) -> Optional[Tuple[str, int]]:
    """'name:idx' -> (name, idx); control deps ('^name') -> None."""
    if ref.startswith("^"):
        return None
    name, _, idx = ref.partition(":")
    return name, int(idx) if idx else 0


def _norm_tensor_name(name: str) -> Tuple[str, int]:
    r = _parse_ref(name)
    assert r is not None, name
    return r


# op handlers.  signature: handler(ctx, node, args) -> output | tuple

def _param(ctx, node):
    if node.name not in ctx.params:
        raise KeyError(
            f"variable '{node.name}' has no value in params "
            f"(have: {sorted(ctx.params)})")
    return ctx.params[node.name]


def _ew(t_fn, np_fn=None):
    """Elementwise unary handler."""
    def h(ctx, node, args):
        (x,) = args
        if np_fn is not None and _is_static(x):
            return np_fn(x)
        return t_fn(ctx.tensor(x))
    return h


def _bin(t_fn, np_fn):
    return lambda ctx, node, args: ctx.nb(np_fn, t_fn)(*args)


# ---- convolutions and pools (NHWC or NCHW) ----

def _to_nchw(x, df):
    return x.permute(0, 3, 1, 2) if df == "NHWC" else x


def _from_nchw(x, df):
    return x.permute(0, 2, 3, 1) if df == "NHWC" else x


def _conv_dims(node):
    df = _attr(node, "data_format", "NHWC")
    strides = _attr(node, "strides", [1, 1, 1, 1])
    dil = _attr(node, "dilations", [1, 1, 1, 1])
    sp = (2, 3) if df == "NCHW" else (1, 2)
    return df, tuple(strides[i] for i in sp), tuple(dil[i] for i in sp), sp


def same_pads(in_sizes, ks, strides, dil=None):
    """TF/XLA ``SAME`` padding (lax.padtype_to_pads): the output is
    ceil(in / stride) and the extra row or column goes at the end."""
    dil = dil or [1] * len(ks)
    pairs = []
    for n, k, s, d in zip(in_sizes, ks, strides, dil):
        kd = (k - 1) * d + 1
        out = -(-n // s)
        total = max((out - 1) * s + kd - n, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def _conv_pairs(node, sp, x_nchw, ks, strides, dil):
    p = _attr(node, "padding", "VALID")
    if p == "EXPLICIT":
        ep = _attr(node, "explicit_paddings")
        pairs = [(ep[2 * i], ep[2 * i + 1]) for i in range(len(ep) // 2)]
        return [pairs[i] for i in sp]
    if p == "SAME":
        return same_pads(x_nchw.shape[2:], ks, strides, dil)
    return [(0, 0)] * len(ks)


def _conv_nchw(x, w_oihw, strides, dil, pairs, groups=1):
    if all(lo == hi for lo, hi in pairs):
        return F.conv2d(x, w_oihw, None, strides, [lo for lo, _ in pairs],
                        dil, groups)
    x = _pad_nd(x, [(0, 0), (0, 0)] + list(pairs))
    return F.conv2d(x, w_oihw, None, strides, 0, dil, groups)


def _conv2d(ctx, node, args):
    x, w = ctx.tensor(args[0]), ctx.tensor(args[1])
    df, strides, dil, sp = _conv_dims(node)
    xc = _to_nchw(x, df)
    pairs = _conv_pairs(node, sp, xc, w.shape[:2], strides, dil)
    return _from_nchw(_conv_nchw(xc, w.permute(3, 2, 0, 1), strides, dil,
                                 pairs), df)


def _depthwise_conv2d(ctx, node, args):
    x, w = ctx.tensor(args[0]), ctx.tensor(args[1])
    df, strides, dil, sp = _conv_dims(node)
    h, wd, cin, mult = w.shape
    xc = _to_nchw(x, df)
    pairs = _conv_pairs(node, sp, xc, (h, wd), strides, dil)
    # HW(1)(cin*mult) as the JAX package reshapes it, then OIHW
    w = torch.reshape(w, (h, wd, 1, cin * mult)).permute(3, 2, 0, 1)
    return _from_nchw(_conv_nchw(xc, w, strides, dil, pairs, groups=cin), df)


def _conv_transpose_pads(k, s, padding):
    """``lax.conv_transpose``'s padding of the dilated input (for the
    dilated kernel size ``k``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError("Padding mode must be `SAME` or `VALID`.")
    return pad_a, pad_len - pad_a


def _conv2d_backprop_input(ctx, node, args):
    input_sizes, w, dy = args
    w, dy = ctx.tensor(w), ctx.tensor(dy)
    df, strides, dil, sp = _conv_dims(node)
    pad = _attr(node, "padding", "VALID")
    # the whole transposed convolution, then lax.conv_transpose's pads
    # relative to it (a pad of k-1 keeps an edge, less crops it)
    full = F.conv_transpose2d(_to_nchw(dy, df), w.permute(3, 2, 0, 1),
                              None, strides, 0, 0, 1, dil)
    crops = []
    for k, s, d in zip(w.shape[:2], strides, dil):
        kd = (k - 1) * d + 1
        a, b = _conv_transpose_pads(kd, s, pad)
        crops.append((a - (kd - 1), b - (kd - 1)))
    out = _from_nchw(_pad_nd(full, [(0, 0), (0, 0)] + crops), df)
    want = tuple(_ints(input_sizes, "Conv2DBackpropInput input_sizes"))
    if tuple(out.shape) != want:  # a SAME deconv can overshoot: crop
        out = out[tuple(slice(0, s) for s in want)]
    return out


def _pool_spec(node, x):
    df = _attr(node, "data_format", "NHWC")
    ks = list(_attr(node, "ksize"))
    st = list(_attr(node, "strides"))
    pad = _attr(node, "padding", "VALID")
    sp = (2, 3) if df == "NCHW" else (1, 2)
    other = [i for i in range(4) if i not in sp]
    if any(ks[i] != 1 or st[i] != 1 for i in other):
        raise NotImplementedError(
            "pooling over the batch or channel axis is not supported")
    ks, st = [ks[i] for i in sp], [st[i] for i in sp]
    xc = _to_nchw(x, df)
    pairs = (same_pads(xc.shape[2:], ks, st) if pad == "SAME"
             else [(0, 0), (0, 0)])
    return df, ks, st, pad, xc, pairs


def _maxpool(ctx, node, args):
    x = ctx.tensor(args[0])
    df, ks, st, pad, xc, pairs = _pool_spec(node, x)
    fill = (-np.inf if x.is_floating_point()
            else torch.iinfo(x.dtype).min)
    xp = _pad_nd(xc, [(0, 0), (0, 0)] + pairs, value=fill)
    return _from_nchw(_window_max(xp, ks, st), df)


def _avgpool(ctx, node, args):
    x = ctx.tensor(args[0])
    df, ks, st, pad, xc, pairs = _pool_spec(node, x)
    summed = _window_sum(_pad_nd(xc, [(0, 0), (0, 0)] + pairs), ks, st)
    if pad == "VALID":
        return _from_nchw(summed / float(np.prod(ks)), df)
    # TF leaves the padded elements out of the average under SAME
    counts = _window_sum(_pad_nd(torch.ones_like(xc), [(0, 0), (0, 0)]
                                 + pairs), ks, st)
    return _from_nchw(summed / counts, df)


def _matmul(ctx, node, args):
    a, b = ctx.tensor(args[0]), ctx.tensor(args[1])
    if _attr(node, "transpose_a", False):
        a = a.transpose(-1, -2)
    if _attr(node, "transpose_b", False):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _batch_matmul(ctx, node, args):
    a, b = ctx.tensor(args[0]), ctx.tensor(args[1])
    if _attr(node, "adj_x", False):
        a = a.transpose(-1, -2)
    if _attr(node, "adj_y", False):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _bias_add(ctx, node, args):
    x, b = ctx.tensor(args[0]), ctx.tensor(args[1])
    if _attr(node, "data_format", "NHWC") == "NCHW" and x.ndim > 1:
        return x + torch.reshape(b, (1, -1) + (1,) * (x.ndim - 2))
    return x + b


def _reduction(name):
    t_fn, np_fn = _tensor_reduce(name), _NP_REDUCE[name]

    def h(ctx, node, args):
        x, axes = args
        keep = bool(_attr(node, "keep_dims", _attr(node, "keepdims", False)))
        # TF reduces over axis=[] as a no-op, not over every axis
        ax = tuple(_ints(axes, "reduction axes"))
        if _is_static(x):
            return np_fn(np.asarray(x), axis=ax, keepdims=keep)
        if not ax:
            return x
        return t_fn(x, ax, keep)
    return h


def _fused_batch_norm(ctx, node, args):
    x, scale, offset, mean, var = args
    x = ctx.tensor(x)
    eps = _attr(node, "epsilon", 1e-3)
    df = _attr(node, "data_format", "NHWC")
    axis = 1 if df == "NCHW" else x.ndim - 1
    red = tuple(i for i in range(x.ndim) if i != axis)
    is_training = bool(_attr(node, "is_training", True))
    n_mean = (0 if mean is None else np.size(mean) if _is_static(mean)
              else mean.numel())
    if is_training and (n_mean == 0 or ctx.training):
        m = torch.mean(x, dim=red)
        v = torch.var(x, dim=red, unbiased=False)
    else:
        m, v = ctx.tensor(mean), ctx.tensor(var)
    bshape = tuple(x.shape[i] if i == axis else 1 for i in range(x.ndim))
    rs = lambda t: torch.reshape(t, bshape)
    y = (x - rs(m)) * rs(ctx.tensor(scale)) * torch.rsqrt(rs(v) + eps) \
        + rs(ctx.tensor(offset))
    return (y, m, v, m, v, torch.zeros((), dtype=x.dtype, device=x.device))


def _strided_slice(ctx, node, args):
    x, begin, end, strides = args
    begin = _ints(begin, "StridedSlice begin")
    end = _ints(end, "StridedSlice end")
    strides = _ints(strides, "StridedSlice strides")
    bm = _attr(node, "begin_mask", 0)
    em = _attr(node, "end_mask", 0)
    elm = _attr(node, "ellipsis_mask", 0)
    nam = _attr(node, "new_axis_mask", 0)
    sam = _attr(node, "shrink_axis_mask", 0)
    ndim = np.asarray(x).ndim if _is_static(x) else x.ndim
    spec_len = len(begin)
    n_spec_dims = sum(1 for i in range(spec_len)
                      if not (nam >> i) & 1 and not (elm >> i) & 1)
    idx: List[Any] = []
    for i in range(spec_len):
        if (elm >> i) & 1:
            idx.extend([slice(None)] * (ndim - n_spec_dims))
        elif (nam >> i) & 1:
            idx.append(None)
        elif (sam >> i) & 1:
            idx.append(begin[i])
        else:
            b = None if (bm >> i) & 1 else begin[i]
            e = None if (em >> i) & 1 else end[i]
            idx.append(slice(b, e, strides[i]))
    return _index(x, idx)


def _tf_slice(ctx, node, args):
    x, begin, size = args
    begin = _ints(begin, "Slice begin")
    size = _ints(size, "Slice size")
    shape = np.asarray(x).shape if _is_static(x) else x.shape
    idx = [slice(b, shape[i] if s == -1 else b + s)
           for i, (b, s) in enumerate(zip(begin, size))]
    return _index(x, idx)


def _gather(ctx, node, args):
    params, indices = args[0], args[1]
    axis = _ints(args[2], "Gather axis")[0] if len(args) > 2 else 0
    if _attr(node, "batch_dims", 0):
        return torch.take_along_dim(ctx.tensor(params),
                                    ctx.tensor(indices).long(), dim=axis)
    if _is_static(params) and _is_static(indices):
        return np.take(params, indices, axis=axis)
    return _take(params, indices, axis, ctx)


def _concat(axis_first: bool):
    def h(ctx, node, args):
        if axis_first:
            axis, vals = args[0], args[1:]
        else:
            axis, vals = args[-1], args[:-1]
        ax = _ints(axis, "Concat axis")[0]
        if all(_is_static(v) for v in vals):
            return np.concatenate([np.asarray(v) for v in vals], axis=ax)
        return torch.cat([ctx.tensor(v) for v in vals], dim=ax)
    return h


def _split(ctx, node, args):
    axis, value = args
    return _split_even(ctx.tensor(value), _attr(node, "num_split"),
                       _ints(axis, "Split axis")[0])


def _split_v(ctx, node, args):
    value, sizes, axis = args
    sizes = _ints(sizes, "SplitV sizes")
    return _split_points(ctx.tensor(value), np.cumsum(sizes)[:-1].tolist(),
                         _ints(axis, "SplitV axis")[0])


def _pack(ctx, node, args):
    ax = _attr(node, "axis", 0)
    if all(_is_static(a) for a in args):
        return np.stack([np.asarray(a) for a in args], axis=ax)
    return torch.stack([ctx.tensor(a) for a in args], dim=ax)


def _unpack(ctx, node, args):
    x = ctx.tensor(args[0])
    moved = torch.movedim(x, _attr(node, "axis", 0), 0)
    return tuple(moved[i] for i in range(_attr(node, "num")))


def _softmax_xent(ctx, node, args):
    logits, labels = ctx.tensor(args[0]), ctx.tensor(args[1])
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.sum(labels * logp, dim=-1)
    grad = torch.softmax(logits, dim=-1) - labels
    return (loss, grad)


def _sparse_softmax_xent(ctx, node, args):
    logits, labels = ctx.tensor(args[0]), ctx.tensor(args[1]).long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, labels[..., None])[..., 0]
    grad = torch.softmax(logits, dim=-1) - F.one_hot(
        labels, logits.shape[-1]).to(logits.dtype)
    return (loss, grad)


def _random_uniform(ctx, node, args):
    shape = tuple(_ints(args[0], "RandomUniform shape"))
    dt = _attr_torch_dtype(node, "dtype", torch.float32)
    return torch.rand(shape, generator=ctx.next_rng(), device=ctx.device,
                      dtype=dt)


def _random_normal(ctx, node, args):
    shape = tuple(_ints(args[0], "RandomStandardNormal shape"))
    dt = _attr_torch_dtype(node, "dtype", torch.float32)
    return torch.randn(shape, generator=ctx.next_rng(), device=ctx.device,
                       dtype=dt)


def _resize_nearest(x, size):
    """``jax.image.resize(..., "nearest")`` on NHWC: source index
    floor((i + 0.5) * in / out), computed in f32 as jax does."""
    for d, n in zip((1, 2), size):
        m = x.shape[d]
        if m == n:
            continue
        off = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                       * np.float32(m) / np.float32(n)).astype(np.int64)
        x = x.index_select(d, torch.as_tensor(off, device=x.device))
    return x


def _resize(method: str):
    def h(ctx, node, args):
        x = ctx.tensor(args[0])
        h_w = _ints(args[1], "Resize size")
        if method == "nearest":
            return _resize_nearest(x, h_w)
        # jax.image.resize's bilinear: half-pixel centres, antialiased
        # along an axis that shrinks (as the port's ResizeBilinear layer)
        shrinks = h_w[0] < x.shape[1] or h_w[1] < x.shape[2]
        y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(h_w),
                          mode="bilinear", align_corners=False,
                          antialias=shrinks)
        return y.permute(0, 2, 3, 1)
    return h


def _cast(ctx, node, args):
    (x,) = args
    dst = _attr_torch_dtype(node, "DstT", None)
    if _is_static(x) and dst != torch.bfloat16:
        return np.asarray(x).astype(_attr(node, "DstT"))
    return ctx.tensor(x).to(dst)


def _reshape(ctx, node, args):
    x, shape = args
    tgt = _ints(shape, "Reshape shape")
    if _is_static(x):
        return np.reshape(np.asarray(x), tgt)
    return torch.reshape(x, tgt)


def _one_hot(ctx, node, args):
    indices, depth, on, off = args
    d = _ints(depth, "OneHot depth")[0]
    oh = _one_hot_t(ctx, indices, d, _attr(node, "axis", -1))
    return oh * ctx.tensor(on) + (1.0 - oh) * ctx.tensor(off)


def _top_k(ctx, node, args):
    x = ctx.tensor(args[0])
    k = _ints(args[1], "TopKV2 k")[0] if len(args) > 1 else \
        _attr(node, "k")
    vals, idxs = torch.topk(x, k, dim=-1, largest=True, sorted=True)
    return (vals, idxs.to(torch.int32))


def _select(ctx, node, args):
    c, t, f = args
    if not _is_static(c) or not _is_static(t) or not _is_static(f):
        c, t, f = (ctx.tensor(v) for v in (c, t, f))
        if c.ndim == 1 and t.ndim > 1 and c.shape[0] == t.shape[0]:
            c = c.reshape((-1,) + (1,) * (t.ndim - 1))  # V1 Select rule
        return torch.where(c.bool(), t, f)
    return np.where(c, t, f)


def _select_v2(ctx, node, args):
    if all(_is_static(a) for a in args):
        return np.where(*args)
    c, t, f = (ctx.tensor(v) for v in args)
    return torch.where(c.bool(), t, f)


def _arg(fn):
    def h(ctx, node, args):
        out = fn(ctx.tensor(args[0]), dim=_ints(args[1], "axis")[0])
        dt = _attr(node, "output_type", np.dtype("int64"))
        return out.to(_TORCH_OF_NP[np.dtype(dt)])
    return h


def _squeeze(ctx, node, args):
    x = ctx.tensor(args[0])
    dims = tuple(_attr(node, "squeeze_dims", []) or [])
    if not dims:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(d % x.ndim for d in dims))


def _expand_dims(ctx, node, args):
    ax = _ints(args[1], "axis")[0]
    if _is_static(args[0]):
        return np.expand_dims(np.asarray(args[0]), ax)
    x = args[0]
    return torch.unsqueeze(x, ax if ax >= 0 else ax + x.ndim + 1)


def _pads(args):
    return [tuple(p) for p in np.asarray(_static(args[1], "Pad paddings"))]


def _pad_v2(ctx, node, args):
    value = args[2]
    return _pad_nd(ctx.tensor(args[0]), _pads(args), value=float(
        np.asarray(value).item()) if _is_static(value) else
        float(value.item()))


def _range(ctx, node, args):
    if all(_is_static(a) for a in args):
        return np.arange(*[_static(a, "Range arg").item() for a in args],
                         dtype=np.asarray(_static(args[0], "Range")).dtype)
    return torch.arange(*[ctx.tensor(a) for a in args])


def _div_no_nan(ctx, node, args):
    a, b = ctx.tensor(args[0]), ctx.tensor(args[1])
    return torch.where(b == 0, torch.zeros_like(a), a / b)


def _fill(ctx, node, args):
    dims = tuple(_ints(args[0], "Fill dims"))
    v = ctx.tensor(args[1])
    return torch.full(dims, 0, dtype=v.dtype, device=v.device) + v


def _shape(ctx, node, args):
    x = args[0]
    return np.asarray(np.asarray(x).shape if _is_static(x) else x.shape,
                      dtype=np.int32)


_H: Dict[str, Any] = {
    # plumbing
    "Const": lambda ctx, node, args: _attr(node, "value"),
    "Identity": lambda ctx, node, args: args[0],
    "IdentityN": lambda ctx, node, args: tuple(args),
    "Snapshot": lambda ctx, node, args: args[0],
    "StopGradient": lambda ctx, node, args: ctx.tensor(args[0]).detach(),
    "PreventGradient": lambda ctx, node, args: ctx.tensor(args[0]).detach(),
    "CheckNumerics": lambda ctx, node, args: args[0],
    "NoOp": lambda ctx, node, args: None,
    "Cast": _cast,
    # variables
    "VariableV2": lambda ctx, node, args: _param(ctx, node),
    "Variable": lambda ctx, node, args: _param(ctx, node),
    "VarHandleOp": lambda ctx, node, args: node.name,  # handle = its name
    "ReadVariableOp": lambda ctx, node, args: ctx.params[args[0]],
    # shape math
    "Shape": _shape,
    "Rank": lambda ctx, node, args: np.int32(
        (np.asarray(args[0]) if _is_static(args[0]) else args[0]).ndim),
    "Size": lambda ctx, node, args: np.int32(int(np.prod(
        (np.asarray(args[0]) if _is_static(args[0]) else args[0]).shape))),
    "Reshape": _reshape,
    "Squeeze": _squeeze,
    "ExpandDims": _expand_dims,
    "Transpose": lambda ctx, node, args: ctx.tensor(args[0]).permute(
        *_ints(args[1], "Transpose perm")),
    "Pad": lambda ctx, node, args: _pad_nd(ctx.tensor(args[0]),
                                           _pads(args)),
    "PadV2": _pad_v2,
    "MirrorPad": lambda ctx, node, args: _pad_nd(
        ctx.tensor(args[0]), _pads(args),
        "reflect" if _attr(node, "mode") == "REFLECT" else "symmetric"),
    "ConcatV2": _concat(axis_first=False),
    "Concat": _concat(axis_first=True),
    "Split": _split,
    "SplitV": _split_v,
    "Pack": _pack,
    "Unpack": _unpack,
    "Tile": lambda ctx, node, args: torch.tile(
        ctx.tensor(args[0]), tuple(_ints(args[1], "Tile multiples"))),
    "Slice": _tf_slice,
    "StridedSlice": _strided_slice,
    "GatherV2": _gather,
    "Gather": _gather,
    "BroadcastTo": lambda ctx, node, args: torch.broadcast_to(
        ctx.tensor(args[0]), tuple(_ints(args[1], "BroadcastTo shape"))),
    "Fill": _fill,
    "ZerosLike": lambda ctx, node, args: torch.zeros_like(
        ctx.tensor(args[0])),
    "OnesLike": lambda ctx, node, args: torch.ones_like(
        ctx.tensor(args[0])),
    "Range": _range,
    "OneHot": _one_hot,
    # math: binary
    "Add": _bin(torch.add, np.add),
    "AddV2": _bin(torch.add, np.add),
    "AddN": lambda ctx, node, args: sum(
        (ctx.tensor(a) for a in args[1:]), ctx.tensor(args[0])),
    "Sub": _bin(torch.subtract, np.subtract),
    "Mul": _bin(torch.multiply, np.multiply),
    "RealDiv": _bin(torch.true_divide, np.divide),
    "Div": _bin(torch.true_divide, np.divide),
    "DivNoNan": _div_no_nan,
    "FloorDiv": _bin(torch.floor_divide, np.floor_divide),
    "FloorMod": _bin(torch.remainder, np.mod),
    "Pow": _bin(torch.pow, np.power),
    "SquaredDifference": _bin(lambda a, b: torch.square(a - b),
                              lambda a, b: np.square(a - b)),
    "Maximum": _bin(torch.maximum, np.maximum),
    "Minimum": _bin(torch.minimum, np.minimum),
    # math: unary
    "Neg": _ew(torch.negative, np.negative),
    "Abs": _ew(torch.abs, np.abs),
    "Square": _ew(torch.square, np.square),
    "Sqrt": _ew(torch.sqrt),
    "Rsqrt": _ew(torch.rsqrt),
    "Exp": _ew(torch.exp),
    "Log": _ew(torch.log),
    "Log1p": _ew(torch.log1p),
    "Sign": _ew(torch.sign, np.sign),
    "Floor": _ew(torch.floor, np.floor),
    "Ceil": _ew(torch.ceil, np.ceil),
    "Round": _ew(torch.round, np.round),
    "Reciprocal": _ew(torch.reciprocal),
    "Erf": _ew(torch.erf),
    "Sin": _ew(torch.sin),
    "Cos": _ew(torch.cos),
    "Tanh": _ew(torch.tanh),
    "Sigmoid": _ew(torch.sigmoid),
    # NN
    "MatMul": _matmul,
    "BatchMatMul": _batch_matmul,
    "BatchMatMulV2": _batch_matmul,
    "Einsum": lambda ctx, node, args: torch.einsum(
        _attr(node, "equation"), *[ctx.tensor(a) for a in args]),
    "Conv2D": _conv2d,
    "DepthwiseConv2dNative": _depthwise_conv2d,
    "Conv2DBackpropInput": _conv2d_backprop_input,
    "BiasAdd": _bias_add,
    "MaxPool": _maxpool,
    "AvgPool": _avgpool,
    "Relu": _ew(torch.relu),
    "Relu6": _ew(lambda x: torch.clamp(x, 0, 6)),
    "LeakyRelu": lambda ctx, node, args: F.leaky_relu(
        ctx.tensor(args[0]), _attr(node, "alpha", 0.2)),
    "Elu": _ew(F.elu),
    "Selu": _ew(F.selu),
    "Softplus": _ew(_softplus),
    "Softsign": _ew(F.softsign),
    "Softmax": _ew(lambda x: torch.softmax(x, dim=-1)),
    "LogSoftmax": _ew(lambda x: torch.log_softmax(x, dim=-1)),
    "L2Loss": _ew(lambda x: 0.5 * torch.sum(torch.square(x))),
    "FusedBatchNorm": _fused_batch_norm,
    "FusedBatchNormV2": _fused_batch_norm,
    "FusedBatchNormV3": _fused_batch_norm,
    "SoftmaxCrossEntropyWithLogits": _softmax_xent,
    "SparseSoftmaxCrossEntropyWithLogits": _sparse_softmax_xent,
    "ResizeBilinear": _resize("bilinear"),
    "ResizeNearestNeighbor": _resize("nearest"),
    # reductions
    "Mean": _reduction("mean"),
    "Sum": _reduction("sum"),
    "Max": _reduction("max"),
    "Min": _reduction("min"),
    "Prod": _reduction("prod"),
    "All": _reduction("all"),
    "Any": _reduction("any"),
    "ArgMax": _arg(torch.argmax),
    "ArgMin": _arg(torch.argmin),
    "TopKV2": _top_k,
    # comparison / logic
    "Greater": _bin(torch.greater, np.greater),
    "GreaterEqual": _bin(torch.greater_equal, np.greater_equal),
    "Less": _bin(torch.less, np.less),
    "LessEqual": _bin(torch.less_equal, np.less_equal),
    "Equal": _bin(torch.eq, np.equal),
    "NotEqual": _bin(torch.ne, np.not_equal),
    "LogicalAnd": _bin(torch.logical_and, np.logical_and),
    "LogicalOr": _bin(torch.logical_or, np.logical_or),
    "LogicalNot": _ew(torch.logical_not, np.logical_not),
    "Select": _select,
    "SelectV2": _select_v2,
    # random
    "RandomUniform": _random_uniform,
    "RandomStandardNormal": _random_normal,
}

_VAR_OPS = {"VariableV2", "Variable", "VarHandleOp"}
_CONTROL_FLOW = {"Switch", "Merge", "Enter", "Exit", "NextIteration",
                 "LoopCond", "While", "StatelessWhile", "If", "StatelessIf"}
#: ops whose value is not a function of constants alone
_NOT_FOLDED = _VAR_OPS | {"ReadVariableOp", "RandomUniform",
                          "RandomStandardNormal", "Placeholder",
                          "PlaceholderWithDefault"}


def graph_def_of(data):
    """The port's GraphDef of ``data``: bytes, the port's own message, or
    TF's (re-read through its bytes)."""
    if isinstance(data, (bytes, bytearray)):
        return _proto.parse_graph_def(data)
    if isinstance(data, _proto.GraphDef):
        return data
    return _proto.parse_graph_def(data.SerializeToString())


class ConvertedGraph:
    """A TF GraphDef compiled to a torch function.

    ``fn = ConvertedGraph(gd, inputs, outputs)`` then ``fn(params,
    *input_arrays, rng=None, training=False, device=None) ->
    [outputs]``.  ``inputs``/``outputs`` are TF tensor names (``"node:0"``
    or ``"node"``).  ``variable_names`` lists the reachable variable nodes
    (``params`` maps each name to an array; empty for frozen graphs).
    Numpy inputs go to the params' device, else to ``device`` (``"cuda"``
    unless asked otherwise).
    """

    def __init__(self, graph_def, inputs: Sequence[str],
                 outputs: Sequence[str]):
        graph_def = graph_def_of(graph_def)
        self._nodes = {n.name: n for n in graph_def.node}
        self._input_refs = [_norm_tensor_name(n) for n in inputs]
        self._output_refs = [_norm_tensor_name(n) for n in outputs]
        self.input_names = list(inputs)
        self.output_names = list(outputs)
        self._order = self._toposort()
        self.variable_names = [n for n in self._order
                               if self._nodes[n].op in _VAR_OPS]
        for name in self._order:
            op = self._nodes[name].op
            if op in _CONTROL_FLOW:
                raise NotImplementedError(
                    f"TF control-flow op {op} (node {name}) is not "
                    "supported: express loops and conditions in a torch "
                    "function instead")
            if op not in _H and op != "Placeholder" and \
                    op != "PlaceholderWithDefault":
                raise NotImplementedError(
                    f"unsupported TF op {op!r} (node {name!r}); supported: "
                    f"{sorted(_H)}")
        self._fold()

    def _data_inputs(self, node) -> List[Tuple[str, int]]:
        refs = []
        for raw in node.input:
            r = _parse_ref(raw)
            if r is not None:
                refs.append(r)
        return refs

    def _toposort(self) -> List[str]:
        fed = {name for name, _ in self._input_refs}
        order: List[str] = []
        seen: Dict[str, int] = {}  # 0=visiting, 1=done
        stack = [(name, False) for name, _ in reversed(self._output_refs)]
        while stack:
            name, processed = stack.pop()
            if processed:
                seen[name] = 1
                order.append(name)
                continue
            if seen.get(name) in (0, 1):
                continue
            seen[name] = 0
            stack.append((name, True))
            if name in fed:
                continue
            if name not in self._nodes:
                raise KeyError(f"graph has no node {name!r}")
            for dep, _ in reversed(self._data_inputs(self._nodes[name])):
                if seen.get(dep) != 1:
                    stack.append((dep, False))
        return order

    def _fold(self):
        """Evaluate, once, every node that depends on no fed input, no
        variable and no random op and whose value stays in numpy (the
        frozen weights and the shape math over them); a call starts from
        these values and runs the rest."""
        fed = {name for name, _ in self._input_refs}
        env: Dict[Tuple[str, int], Any] = {}
        ctx = _Ctx({}, None, False)
        self._todo: List[str] = []
        for name in self._order:
            node = self._nodes.get(name)
            refs = [] if node is None else self._data_inputs(node)
            if name in fed or node.op in _NOT_FOLDED or not all(
                    r in env for r in refs):
                self._todo.append(name)
                continue
            try:
                out = _H[node.op](ctx, node, [env[r] for r in refs])
            except Exception:  # raised again, with its context, at a call
                self._todo.append(name)
                continue
            outs = out if isinstance(out, tuple) else (out,)
            if out is None or not all(_is_static(v) for v in outs):
                self._todo.append(name)
                continue
            for i, v in enumerate(outs):
                env[(name, i)] = v
        self._folded = env
        self._consts = constant_cache(env.values())

    def __call__(self, params: Dict[str, Any], *input_values,
                 rng: Optional[torch.Generator] = None,
                 training: bool = False, device=None):
        if len(input_values) != len(self._input_refs):
            raise ValueError(
                f"expected {len(self._input_refs)} inputs "
                f"({self.input_names}), got {len(input_values)}")
        dev = None
        for v in list(params.values()) + list(input_values):
            if isinstance(v, torch.Tensor):
                dev = v.device
                break
        if dev is None:
            from ....common.context import resolve_device
            dev = resolve_device(device)
        params = {k: to_tensor(v, dev) for k, v in params.items()}
        env: Dict[Tuple[str, int], Any] = dict(self._folded)
        env.update(zip(self._input_refs,
                       (to_tensor(v, dev) for v in input_values)))
        fed = {name for name, _ in self._input_refs}
        ctx = _Ctx(params, rng, training, dev, self._consts)
        for name in self._todo:
            if name in fed:
                continue
            node = self._nodes[name]
            if node.op == "Placeholder":
                raise ValueError(
                    f"placeholder {name!r} reachable from outputs but not "
                    f"listed in inputs {self.input_names}")
            args = [env[r] for r in self._data_inputs(node)]
            if node.op == "PlaceholderWithDefault":
                out = args[0]
            else:
                out = _H[node.op](ctx, node, args)
            if isinstance(out, tuple):
                for i, v in enumerate(out):
                    env[(name, i)] = v
            else:
                env[(name, 0)] = out
        return [env[r] for r in self._output_refs]


def convert_graph_def(graph_def, inputs: Sequence[str],
                      outputs: Sequence[str]) -> ConvertedGraph:
    """Convert a (frozen or variable-bearing) GraphDef to a torch
    callable."""
    return ConvertedGraph(graph_def, inputs, outputs)
