"""ONNX GraphProto → a torch function.

Counterpart of ``analytics_zoo_tpu/pipeline/api/onnx/converter.py``: each
node maps to a torch expression, so an imported model is one function
that autograd differentiates (fine-tuning its float initializers), and
every op of the JAX package's table has its torch form here.

* ONNX convolutions and pools are NCHW, weights OIHW: torch's own
  layout.  Asymmetric and ``auto_pad`` padding pads first (``F.pad``,
  with ``-inf`` before a max pool) and then runs the op unpadded.
* Shape-feeding subgraphs (Shape → Concat → Reshape, Slice starts/ends,
  Pad pads, ...) run on the host in numpy (``_convert_util``).  Integer
  initializers and Constant nodes are static; float initializers are
  parameters.  Nodes that depend on no input are evaluated once, when
  the graph is built, and their arrays reach a device once.
* Unsupported ops fail at conversion with the op list, not mid-call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .proto import GraphProto, NodeProto, attrs_dict, tensor_to_numpy
from .._convert_util import (ConvertCtx as _Ctx, constant_cache,
                             is_static as _is_static,
                             require_static as _static,
                             static_ints as _ints, to_tensor)

# ONNX TensorProto.DataType -> torch dtype (Cast's ``to``)
_TORCH_DTYPE = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                5: torch.int16, 6: torch.int32, 7: torch.int64,
                9: torch.bool, 10: torch.float16, 11: torch.float32,
                16: torch.bfloat16}


def _shape(x):
    return np.asarray(x).shape if _is_static(x) else tuple(x.shape)


def _ndim(x):
    return len(_shape(x))


# ---------------------------------------------------------------------------
# shared tensor helpers (the TF converter uses them too)

def index(x, idx):
    """``x[idx]`` with numpy's semantics, negative steps included (torch
    slicing takes positive steps only)."""
    if _is_static(x):
        return np.asarray(x)[tuple(idx)]
    idx = list(idx)
    if any(it is Ellipsis for it in idx):
        n_real = sum(1 for it in idx if it is not None and it is not Ellipsis)
        e = idx.index(Ellipsis)
        idx[e:e + 1] = [slice(None)] * (x.ndim - n_real)
    plain, flips = [], []
    out_dim = in_dim = 0
    for it in idx:
        if it is None:
            plain.append(None)
            out_dim += 1
            continue
        if isinstance(it, slice) and it.step is not None and it.step < 0:
            flips.append((out_dim, list(range(*it.indices(x.shape[in_dim])))))
            plain.append(slice(None))
        else:
            plain.append(it)
        if not isinstance(it, (int, np.integer)):
            out_dim += 1
        in_dim += 1
    out = x[tuple(plain)]
    for d, sel in flips:
        out = out.index_select(d, torch.as_tensor(sel, dtype=torch.long,
                                                  device=out.device))
    return out


def pad_nd(x, pairs, mode="constant", value=0.0):
    """``jnp.pad(x, pairs, mode)`` for any rank: constant pads (negative
    pads crop), "reflect", "edge" and "symmetric" through index maps."""
    pairs = [(int(lo), int(hi)) for lo, hi in pairs]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pairs):
            flat += [lo, hi]
        if not any(flat):
            return x
        return F.pad(x, flat, value=float(value))
    out = x
    for d, (lo, hi) in enumerate(pairs):
        if not lo and not hi:
            continue
        n = out.shape[d]
        i = np.arange(-lo, n + hi)
        if mode == "edge":
            i = np.clip(i, 0, n - 1)
        elif mode == "reflect":
            period = 2 * (n - 1) if n > 1 else 1
            i = np.abs(i) % period
            i = np.where(i > n - 1, period - i, i)
        elif mode == "symmetric":
            i = np.mod(i, 2 * n)
            i = np.where(i >= n, 2 * n - 1 - i, i)
        else:
            raise NotImplementedError(f"pad mode {mode!r}")
        out = out.index_select(d, torch.as_tensor(i, dtype=torch.long,
                                                  device=out.device))
    return out


def _conv_fn(rank):
    return {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[rank]


def _convT_fn(rank):
    return {1: F.conv_transpose1d, 2: F.conv_transpose2d,
            3: F.conv_transpose3d}[rank]


def _spatial_pad(x, pairs, value=0.0):
    """Pad the trailing spatial dims of an NC... tensor by ``pairs``."""
    return pad_nd(x, [(0, 0), (0, 0)] + list(pairs), value=value)


def window_sum(x, ks, strides):
    """Sums over windows of the trailing spatial dims (no padding)."""
    rank = len(ks)
    if rank == 1:
        return F.avg_pool1d(x, ks, strides) * ks[0]
    pool = F.avg_pool2d if rank == 2 else F.avg_pool3d
    return pool(x, ks, strides, divisor_override=1)


def window_max(x, ks, strides):
    rank = len(ks)
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[rank]
    return pool(x, ks, strides)


# ---------------------------------------------------------------------------
# conv / pool (ONNX: NCHW, weights OIHW, pads = [b..., e...])

def _spatial_rank(x) -> int:
    if _ndim(x) - 2 not in (1, 2, 3):
        raise NotImplementedError(f"conv/pool spatial rank {_ndim(x) - 2}")
    return _ndim(x) - 2


def _pad_pairs(attrs, rank) -> List[Tuple[int, int]]:
    pads = attrs.get("pads")
    if pads is None:
        return [(0, 0)] * rank
    return [(int(pads[i]), int(pads[i + rank])) for i in range(rank)]


def _auto_pad(attrs, rank, ks, strides):
    ap = attrs.get("auto_pad", "NOTSET")
    if ap in ("NOTSET", ""):
        return _pad_pairs(attrs, rank)
    if ap == "VALID":
        return [(0, 0)] * rank
    # SAME_UPPER / SAME_LOWER (as the JAX package computes them)
    pairs = []
    for k, s in zip(ks, strides):
        total = max(k - s, 0) if s <= k else 0
        lo = total // 2
        hi = total - lo
        pairs.append((hi, lo) if ap == "SAME_LOWER" else (lo, hi))
    return pairs


def _conv(ctx, node, attrs, args):
    x, w = ctx.tensor(args[0]), ctx.tensor(args[1])
    rank = _spatial_rank(x)
    ks = attrs.get("kernel_shape", list(w.shape[2:]))
    strides = attrs.get("strides", [1] * rank)
    dil = attrs.get("dilations", [1] * rank)
    group = attrs.get("group", 1)
    pads = _auto_pad(attrs, rank, ks, strides)
    if all(lo == hi for lo, hi in pads):
        out = _conv_fn(rank)(x, w, None, tuple(strides),
                             tuple(lo for lo, _ in pads), tuple(dil), group)
    else:
        out = _conv_fn(rank)(_spatial_pad(x, pads), w, None, tuple(strides),
                             0, tuple(dil), group)
    if len(args) > 2 and args[2] is not None:
        out = out + torch.reshape(ctx.tensor(args[2]), (1, -1) + (1,) * rank)
    return out


def _conv_transpose(ctx, node, attrs, args):
    x, w = ctx.tensor(args[0]), ctx.tensor(args[1])
    rank = _spatial_rank(x)
    strides = attrs.get("strides", [1] * rank)
    dil = attrs.get("dilations", [1] * rank)
    group = attrs.get("group", 1)
    if group != 1:
        raise NotImplementedError("grouped ConvTranspose")
    pads = _pad_pairs(attrs, rank)
    out_pad = attrs.get("output_padding", [0] * rank)
    # the whole transposed convolution (weights (Cin, Cout, *k), torch's
    # layout), then the ONNX pads crop it and output_padding extends it
    full = _convT_fn(rank)(x, w, None, tuple(strides), 0, 0, 1, tuple(dil))
    out = _spatial_pad(full, [(-p0, -p1 + op) for (p0, p1), op in
                              zip(pads, out_pad)])
    if len(args) > 2 and args[2] is not None:
        out = out + torch.reshape(ctx.tensor(args[2]), (1, -1) + (1,) * rank)
    return out


def _pool(is_max):
    def h(ctx, node, attrs, args):
        x = ctx.tensor(args[0])
        rank = _spatial_rank(x)
        ks = list(attrs["kernel_shape"])
        strides = list(attrs.get("strides", [1] * rank))
        if attrs.get("ceil_mode", 0):
            raise NotImplementedError("pool ceil_mode=1")
        pads = _auto_pad(attrs, rank, ks, strides)
        if is_max:
            return window_max(_spatial_pad(x, pads, value=-np.inf), ks,
                              strides)
        summed = window_sum(_spatial_pad(x, pads), ks, strides)
        if attrs.get("count_include_pad", 0):
            return summed / float(np.prod(ks))
        counts = window_sum(_spatial_pad(torch.ones_like(x), pads), ks,
                            strides)
        return summed / counts
    return h


def _global_pool(fn):
    def h(ctx, node, attrs, args):
        x = ctx.tensor(args[0])
        return fn(x, dim=tuple(range(2, x.ndim)), keepdim=True)
    return h


def _gemm(ctx, node, attrs, args):
    a, b = ctx.tensor(args[0]), ctx.tensor(args[1])
    if attrs.get("transA", 0):
        a = a.transpose(-1, -2)
    if attrs.get("transB", 0):
        b = b.transpose(-1, -2)
    out = attrs.get("alpha", 1.0) * torch.matmul(a, b)
    if len(args) > 2 and args[2] is not None:
        out = out + attrs.get("beta", 1.0) * ctx.tensor(args[2])
    return out


def _batch_norm(ctx, node, attrs, args):
    x, scale, bias, mean, var = (ctx.tensor(a) for a in args[:5])
    eps = attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    rs = lambda t: torch.reshape(t, shape)
    return (x - rs(mean)) * rs(scale) * torch.rsqrt(rs(var) + eps) \
        + rs(bias)


def _instance_norm(ctx, node, attrs, args):
    x, scale, bias = (ctx.tensor(a) for a in args)
    eps = attrs.get("epsilon", 1e-5)
    red = tuple(range(2, x.ndim))
    m = torch.mean(x, dim=red, keepdim=True)
    v = torch.var(x, dim=red, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - m) * torch.rsqrt(v + eps) * torch.reshape(scale, shape) \
        + torch.reshape(bias, shape)


def _lrn(ctx, node, attrs, args):
    x = ctx.tensor(args[0])
    size = attrs["size"]
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    bias = attrs.get("bias", 1.0)
    half = size // 2
    # the channel window's sum of squares: pad the channel axis, add the
    # size shifted views
    sq = pad_nd(torch.square(x), [(0, 0), (half, size - 1 - half)]
                + [(0, 0)] * (x.ndim - 2))
    c = x.shape[1]
    ssum = sq[:, 0:c]
    for i in range(1, size):
        ssum = ssum + sq[:, i:i + c]
    return x / torch.pow(bias + (alpha / size) * ssum, beta)


def _dropout(ctx, node, attrs, args):
    x = args[0]
    ratio = attrs.get("ratio", 0.5)
    if len(args) > 1 and args[1] is not None:
        ratio = float(_static(args[1], "Dropout ratio").item())
    training = ctx.training
    if len(args) > 2 and args[2] is not None:
        training = bool(_static(args[2], "Dropout training_mode").item())
    n_out = len(node.output)
    x = ctx.tensor(x)
    if not training or ratio == 0.0:
        mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        return (x, mask) if n_out > 1 else x
    keep = torch.rand(x.shape, generator=ctx.next_rng(),
                      device=x.device) < (1.0 - ratio)
    y = torch.where(keep, x / (1.0 - ratio), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
    return (y, keep) if n_out > 1 else y


def _reshape(ctx, node, attrs, args):
    x, shape = args[0], args[1] if len(args) > 1 else attrs.get("shape")
    tgt = _ints(shape, "Reshape shape")
    in_shape = _shape(x)
    # ONNX: 0 copies the input dim (unless allowzero), -1 is inferred
    tgt = [in_shape[i] if d == 0 and not attrs.get("allowzero", 0) else d
           for i, d in enumerate(tgt)]
    if _is_static(x):
        return np.reshape(np.asarray(x), tgt)
    return torch.reshape(x, tgt)


def _flatten(ctx, node, attrs, args):
    x = ctx.tensor(args[0])
    ax = attrs.get("axis", 1)
    if ax < 0:  # ONNX: a negative axis counts from the rank
        ax += x.ndim
    lead = int(np.prod(x.shape[:ax])) if ax else 1
    return torch.reshape(x, (lead, -1))


def _squeeze(ctx, node, attrs, args):
    x = args[0]
    axes = attrs.get("axes")
    if len(args) > 1 and args[1] is not None:
        axes = _ints(args[1], "Squeeze axes")
    if _is_static(x):
        x = np.asarray(x)
        return (np.squeeze(x) if axes is None
                else np.squeeze(x, tuple(int(a) for a in axes)))
    if axes is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(int(a) % x.ndim for a in axes))


def _unsqueeze(ctx, node, attrs, args):
    x = args[0]
    axes = attrs.get("axes")
    if len(args) > 1 and args[1] is not None:
        axes = _ints(args[1], "Unsqueeze axes")
    out = x
    for ax in sorted(int(a) for a in axes):
        if _is_static(out):
            out = np.expand_dims(out, ax)
        else:
            out = torch.unsqueeze(out, ax if ax >= 0 else ax + out.ndim + 1)
    return out


def _slice(ctx, node, attrs, args):
    x = args[0]
    if len(args) > 1:  # opset >= 10: starts/ends/axes/steps are inputs
        starts = _ints(args[1], "Slice starts")
        ends = _ints(args[2], "Slice ends")
        axes = (_ints(args[3], "Slice axes") if len(args) > 3 and
                args[3] is not None else list(range(len(starts))))
        steps = (_ints(args[4], "Slice steps") if len(args) > 4 and
                 args[4] is not None else [1] * len(starts))
    else:  # opset < 10: attributes
        starts = attrs["starts"]
        ends = attrs["ends"]
        axes = attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    ndim = _ndim(x)
    idx: List[Any] = [slice(None)] * ndim
    INT64_MAX = (1 << 63) - 1
    for s, e, a, st in zip(starts, ends, axes, steps):
        e = None if e >= INT64_MAX - 1 else e
        s_ = None if (st < 0 and s >= INT64_MAX - 1) else s
        e_ = None if (st < 0 and e is not None and e < -(1 << 62)) else e
        idx[a % ndim] = slice(s_, e_, st)
    return index(x, idx)


def take(data, indices, axis, ctx):
    """``jnp.take(data, indices, axis)`` for indices in [-n, n) (a
    negative one counts from the end)."""
    data = ctx.tensor(data)
    axis = axis % data.ndim
    i = ctx.tensor(indices).long()
    n = data.shape[axis]
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    out = data.index_select(axis, i.reshape(-1))
    return out.reshape(data.shape[:axis] + tuple(i.shape)
                       + data.shape[axis + 1:])


def _gather(ctx, node, attrs, args):
    data, indices = args
    axis = attrs.get("axis", 0)
    if _is_static(data) and _is_static(indices):
        return np.take(data, np.asarray(indices, np.int64), axis=axis)
    return take(data, indices, axis, ctx)


def _pad(ctx, node, attrs, args):
    x = ctx.tensor(args[0])
    mode = attrs.get("mode", "constant")
    if len(args) > 1 and args[1] is not None:
        pads = _ints(args[1], "Pad pads")
        cval = (float(np.asarray(_static(args[2], "Pad value")).item())
                if len(args) > 2 and args[2] is not None else 0.0)
    else:
        pads = attrs["pads"]
        cval = attrs.get("value", 0.0)
    n = len(pads) // 2
    pairs = [(pads[i], pads[i + n]) for i in range(n)]
    if mode == "constant":
        return pad_nd(x, pairs, value=cval)
    return pad_nd(x, pairs, "reflect" if mode == "reflect" else "edge")


def _concat(ctx, node, attrs, args):
    ax = attrs.get("axis", 0)
    if all(_is_static(a) for a in args):
        return np.concatenate([np.asarray(a) for a in args], axis=ax)
    return torch.cat([ctx.tensor(a) for a in args], dim=ax)


def split_points(x, points, axis):
    """``jnp.split(x, points, axis)`` at the given split points."""
    n = x.shape[axis]
    bounds = [0] + [int(p) for p in points] + [n]
    return tuple(x.narrow(axis, a, b - a)
                 for a, b in zip(bounds[:-1], bounds[1:]))


def split_even(x, parts, axis):
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"cannot split {n} into {parts} equal parts")
    return split_points(x, [n // parts * i for i in range(1, parts)], axis)


def _split(ctx, node, attrs, args):
    x = ctx.tensor(args[0])
    ax = attrs.get("axis", 0)
    sizes = attrs.get("split")
    if len(args) > 1 and args[1] is not None:
        sizes = _ints(args[1], "Split sizes")
    if sizes is None:
        return split_even(x, len(node.output), ax)
    return split_points(x, np.cumsum(sizes)[:-1].tolist(), ax)


def reduce(x, fn, dims, keep):
    """``fn`` over ``dims`` one dim at a time from the last (for the
    reductions torch takes on one dim only)."""
    for d in sorted((int(a) % x.ndim for a in dims), reverse=True):
        x = fn(x, dim=d, keepdim=keep)
    return x


_TORCH_REDUCE = {"mean": torch.mean, "sum": torch.sum, "max": torch.amax,
                 "min": torch.amin}
_ONE_DIM_REDUCE = {"prod": torch.prod, "all": torch.all, "any": torch.any}


def _tensor_reduce(name):
    """torch's form of the numpy/jnp reduction ``name``, with numpy's
    ``axis`` (None: every dim) and ``keepdims``."""
    def h(x, axis, keepdims):
        dims = tuple(range(x.ndim)) if axis is None else axis
        if name in _TORCH_REDUCE:
            return _TORCH_REDUCE[name](x, dim=dims, keepdim=keepdims)
        if name == "l2":
            return torch.sqrt(torch.sum(torch.square(x), dim=dims,
                                        keepdim=keepdims))
        one = _ONE_DIM_REDUCE[name]
        return reduce(x if name == "prod" else x.bool(),
                      lambda t, dim, keepdim: one(t, dim=dim,
                                                  keepdim=keepdim),
                      dims, keepdims)
    return h


_NP_REDUCE = {"mean": np.mean, "sum": np.sum, "max": np.max, "min": np.min,
              "prod": np.prod, "all": np.all, "any": np.any,
              "l2": lambda x, axis, keepdims: np.sqrt(
                  np.sum(np.square(x), axis=axis, keepdims=keepdims))}


def _reduction(name):
    t_fn, np_fn = _tensor_reduce(name), _NP_REDUCE[name]

    def h(ctx, node, attrs, args):
        x = args[0]
        axes = attrs.get("axes")
        if len(args) > 1 and args[1] is not None:
            axes = _ints(args[1], "reduction axes")
        keep = bool(attrs.get("keepdims", 1))
        if axes is not None and len(axes) == 0:
            # ONNX: empty axes reduces all dims unless noop_with_empty_axes
            if attrs.get("noop_with_empty_axes", 0):
                return x
            ax = None
        else:
            ax = tuple(int(a) for a in axes) if axes is not None else None
        if _is_static(x):
            return np_fn(np.asarray(x), axis=ax, keepdims=keep)
        return t_fn(x, ax, keep)
    return h


def _arg_reduce(fn):
    def h(ctx, node, attrs, args):
        x = ctx.tensor(args[0])
        ax = attrs.get("axis", 0)
        keep = bool(attrs.get("keepdims", 1))
        return fn(x, dim=ax, keepdim=keep).long()
    return h


def _clip(ctx, node, attrs, args):
    x = ctx.tensor(args[0])
    lo = attrs.get("min")
    hi = attrs.get("max")
    if len(args) > 1 and args[1] is not None:
        lo = args[1]
    if len(args) > 2 and args[2] is not None:
        hi = args[2]
    if lo is not None:
        x = torch.maximum(x, ctx.tensor(lo).to(x.dtype))
    if hi is not None:
        x = torch.minimum(x, ctx.tensor(hi).to(x.dtype))
    return x


def _cast(ctx, node, attrs, args):
    from .proto import np_dtype
    (x,) = args
    to = attrs["to"]
    if _is_static(x) and to != 16:
        return np.asarray(x).astype(np_dtype(to))
    return ctx.tensor(x).to(_TORCH_DTYPE[to])


def _softmax_like(fn):
    def h(ctx, node, attrs, args):
        return fn(ctx.tensor(args[0]), dim=attrs.get("axis", -1))
    return h


def _constant(ctx, node, attrs, args):
    if "value" in attrs:
        return attrs["value"]
    for k in ("value_float", "value_int"):
        if k in attrs:
            return np.asarray(attrs[k])
    for k in ("value_floats", "value_ints"):
        if k in attrs:
            return np.asarray(attrs[k])
    raise NotImplementedError(f"Constant node {node.name} with no value")


def _constant_of_shape(ctx, node, attrs, args):
    shape = tuple(_ints(args[0], "ConstantOfShape shape"))
    val = attrs.get("value")
    if val is None:
        return np.zeros(shape, np.float32)
    return np.full(shape, np.asarray(val).reshape(-1)[0],
                   np.asarray(val).dtype)


def _expand(ctx, node, attrs, args):
    x, shape = args
    tgt = _ints(shape, "Expand shape")
    in_shape = _shape(x)
    # ONNX Expand: numpy broadcast; 1s in the target keep the input dim
    n = max(len(tgt), len(in_shape))
    in_p = (1,) * (n - len(in_shape)) + tuple(in_shape)
    tgt_p = [1] * (n - len(tgt)) + list(tgt)
    out = tuple(max(a, b) for a, b in zip(in_p, tgt_p))
    if _is_static(x):
        return np.broadcast_to(x, out)
    return torch.broadcast_to(x, out)


def _tile(ctx, node, attrs, args):
    x, reps = args
    reps = tuple(_ints(reps, "Tile repeats"))
    if _is_static(x):
        return np.tile(x, reps)
    return torch.tile(x, reps)


def one_hot(ctx, indices, depth, axis):
    """``jax.nn.one_hot(indices, depth, axis=axis)`` (f32; an index out
    of [0, depth) gives a row of zeros)."""
    i = ctx.tensor(indices).long()
    oh = (i.unsqueeze(-1) == torch.arange(depth, device=i.device)).to(
        torch.float32)
    if axis != -1:
        oh = torch.movedim(oh, -1, axis if axis >= 0 else axis)
    return oh


def _onehot(ctx, node, attrs, args):
    indices, depth, values = args
    ax = attrs.get("axis", -1)
    d = _ints(depth, "OneHot depth")[0]
    off, on = np.asarray(_static(values, "OneHot values"))
    oh = one_hot(ctx, indices, d, ax)
    return oh * float(on - off) + float(off)


def _topk(ctx, node, attrs, args):
    x = ctx.tensor(args[0])
    k = (_ints(args[1], "TopK k")[0] if len(args) > 1
         else attrs["k"])
    ax = attrs.get("axis", -1)
    vals, idxs = torch.topk(x, k, dim=ax,
                            largest=bool(attrs.get("largest", 1)),
                            sorted=True)
    return vals, idxs.long()


def _where(ctx, node, attrs, args):
    if all(_is_static(a) for a in args):
        return np.where(*args)
    c, a, b = (ctx.tensor(v) for v in args)
    return torch.where(c.bool(), a, b)


def _ew(t_fn, np_fn=None):
    def h(ctx, node, attrs, args):
        (x,) = args
        if np_fn is not None and _is_static(x):
            return np_fn(x)
        return t_fn(ctx.tensor(x))
    return h


def _bin(t_fn, np_fn):
    def h(ctx, node, attrs, args):
        return ctx.nb(np_fn, t_fn)(*args)
    return h


def _variadic(t_fn):
    def h(ctx, node, attrs, args):
        out = ctx.tensor(args[0])
        for a in args[1:]:
            out = t_fn(out, ctx.tensor(a))
        return out
    return h


def _mean(ctx, node, attrs, args):
    out = ctx.tensor(args[0])
    for a in args[1:]:
        out = out + ctx.tensor(a)
    return out / len(args)


def _true_div(a, b):
    return torch.true_divide(a, b)


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _shape_op(ctx, node, attrs, args):
    return np.asarray(_shape(args[0]), np.int64)


def _size_op(ctx, node, attrs, args):
    return np.int64(int(np.prod(_shape(args[0]))))


def _transpose(ctx, node, attrs, args):
    perm = attrs.get("perm")
    if _is_static(args[0]):
        return np.transpose(np.asarray(args[0]), perm)
    x = args[0]
    return x.permute(*(perm if perm is not None
                       else reversed(range(x.ndim))))


def _range(ctx, node, attrs, args):
    return np.arange(*[np.asarray(_static(a, "Range")).item() for a in args])


def _einsum(ctx, node, attrs, args):
    return torch.einsum(attrs["equation"], *[ctx.tensor(a) for a in args])


def _prelu(ctx, node, attrs, args):
    x, slope = ctx.tensor(args[0]), ctx.tensor(args[1])
    return torch.where(x >= 0, x, x * slope)


def _hard_sigmoid(ctx, node, attrs, args):
    x = ctx.tensor(args[0])
    return torch.clamp(attrs.get("alpha", 0.2) * x + attrs.get("beta", 0.5),
                       0, 1)


_H: Dict[str, Any] = {
    # plumbing
    "Identity": lambda ctx, node, attrs, args: args[0],
    "Constant": _constant,
    "ConstantOfShape": _constant_of_shape,
    "Cast": _cast,
    "Shape": _shape_op,
    "Size": _size_op,
    "Dropout": _dropout,
    # shape ops
    "Reshape": _reshape,
    "Flatten": _flatten,
    "Transpose": _transpose,
    "Squeeze": _squeeze,
    "Unsqueeze": _unsqueeze,
    "Slice": _slice,
    "Gather": _gather,
    "Concat": _concat,
    "Split": _split,
    "Pad": _pad,
    "Expand": _expand,
    "Tile": _tile,
    "Range": _range,
    "OneHot": _onehot,
    # math: binary (numpy-style broadcast)
    "Add": _bin(torch.add, np.add),
    "Sub": _bin(torch.subtract, np.subtract),
    "Mul": _bin(torch.multiply, np.multiply),
    "Div": _bin(_true_div, np.divide),
    "Pow": _bin(torch.pow, np.power),
    "Mod": _bin(torch.remainder, np.mod),
    "Min": _variadic(torch.minimum),
    "Max": _variadic(torch.maximum),
    "Sum": _variadic(torch.add),
    "Mean": _mean,
    "MatMul": _bin(torch.matmul, np.matmul),
    "Gemm": _gemm,
    "Einsum": _einsum,
    # math: unary
    "Neg": _ew(torch.negative, np.negative),
    "Abs": _ew(torch.abs, np.abs),
    "Sqrt": _ew(torch.sqrt),
    "Exp": _ew(torch.exp),
    "Log": _ew(torch.log),
    "Reciprocal": _ew(torch.reciprocal),
    "Floor": _ew(torch.floor, np.floor),
    "Ceil": _ew(torch.ceil, np.ceil),
    "Round": _ew(torch.round, np.round),
    "Sign": _ew(torch.sign, np.sign),
    "Erf": _ew(torch.erf),
    "Sin": _ew(torch.sin),
    "Cos": _ew(torch.cos),
    "Clip": _clip,
    # activations
    "Relu": _ew(torch.relu),
    "LeakyRelu": lambda ctx, node, attrs, args: F.leaky_relu(
        ctx.tensor(args[0]), attrs.get("alpha", 0.01)),
    "PRelu": _prelu,
    "Elu": lambda ctx, node, attrs, args: F.elu(
        ctx.tensor(args[0]), attrs.get("alpha", 1.0)),
    "Selu": _ew(F.selu),
    "Celu": lambda ctx, node, attrs, args: F.celu(
        ctx.tensor(args[0]), attrs.get("alpha", 1.0)),
    "Sigmoid": _ew(torch.sigmoid),
    "HardSigmoid": _hard_sigmoid,
    "Tanh": _ew(torch.tanh),
    "Softplus": _ew(softplus),
    "Softsign": _ew(F.softsign),
    "Softmax": _softmax_like(torch.softmax),
    "LogSoftmax": _softmax_like(torch.log_softmax),
    # jax.nn.gelu's default is the tanh approximation
    "Gelu": _ew(lambda x: F.gelu(x, approximate="tanh")),
    # NN
    "Conv": _conv,
    "ConvTranspose": _conv_transpose,
    "MaxPool": _pool(is_max=True),
    "AveragePool": _pool(is_max=False),
    "GlobalAveragePool": _global_pool(torch.mean),
    "GlobalMaxPool": _global_pool(torch.amax),
    "BatchNormalization": _batch_norm,
    "InstanceNormalization": _instance_norm,
    "LRN": _lrn,
    # reductions
    "ReduceMean": _reduction("mean"),
    "ReduceSum": _reduction("sum"),
    "ReduceMax": _reduction("max"),
    "ReduceMin": _reduction("min"),
    "ReduceProd": _reduction("prod"),
    "ReduceL2": _reduction("l2"),
    "ArgMax": _arg_reduce(torch.argmax),
    "ArgMin": _arg_reduce(torch.argmin),
    "TopK": _topk,
    # comparison / logic
    "Greater": _bin(torch.greater, np.greater),
    "GreaterOrEqual": _bin(torch.greater_equal, np.greater_equal),
    "Less": _bin(torch.less, np.less),
    "LessOrEqual": _bin(torch.less_equal, np.less_equal),
    "Equal": _bin(torch.eq, np.equal),
    "Not": _ew(torch.logical_not, np.logical_not),
    "And": _bin(torch.logical_and, np.logical_and),
    "Or": _bin(torch.logical_or, np.logical_or),
    "Xor": _bin(torch.logical_xor, np.logical_xor),
    "Where": _where,
}

#: ops whose value is not a function of their inputs alone
_RANDOM = {"Dropout"}


class OnnxGraph:
    """An ONNX GraphProto compiled to a torch function.

    ``fn = OnnxGraph(graph)``; then ``fn(params, *inputs, rng=None,
    training=False, device=None) -> [outputs]``.  Inputs and params may
    be numpy or tensors; numpy goes to the params' device (else to
    ``device``, ``"cuda"`` unless asked otherwise).

    Float initializers become entries of ``fn.initial_params`` (numpy,
    trainable); integer initializers stay host-static so shape-feeding
    subgraphs stay in numpy.
    """

    def __init__(self, graph: GraphProto):
        self.graph = graph
        init_names = {t.name for t in graph.initializer}
        self.input_names: List[str] = [
            vi.name for vi in graph.input if vi.name not in init_names]
        self.output_names: List[str] = [vi.name for vi in graph.output]

        self.initial_params: Dict[str, np.ndarray] = {}
        self._static_consts: Dict[str, np.ndarray] = {}
        for t in graph.initializer:
            arr = tensor_to_numpy(t)
            if np.issubdtype(arr.dtype, np.floating):
                self.initial_params[t.name] = arr
            else:
                self._static_consts[t.name] = arr

        self._producer: Dict[str, Tuple[NodeProto, int]] = {}
        for node in graph.node:
            for i, out in enumerate(node.output):
                if out:
                    self._producer[out] = (node, i)
        missing_ops = sorted({n.op_type for n in graph.node
                              if n.op_type not in _H})
        if missing_ops:
            raise NotImplementedError(
                f"unsupported ONNX ops {missing_ops}; supported: "
                f"{sorted(_H)}")
        self._order = self._toposort()
        self._attrs = [attrs_dict(n) for n in self._order]
        self._fold()

    def _toposort(self) -> List[NodeProto]:
        """Iterative DFS (deep exported chains overflow Python's
        recursion limit)."""
        known = (set(self.input_names) | set(self.initial_params)
                 | set(self._static_consts))
        order: List[NodeProto] = []
        state: Dict[int, int] = {}  # id(node): 0 visiting, 1 done

        def deps(node):
            for ref in node.input:
                if ref and ref not in known:
                    if ref not in self._producer:
                        raise KeyError(
                            f"node {node.name or node.op_type} consumes "
                            f"unknown value {ref!r}")
                    yield self._producer[ref][0]

        stack = [(self._producer[out][0], False)
                 for out in reversed(self.output_names)
                 if out in self._producer]
        while stack:
            node, processed = stack.pop()
            if processed:
                state[id(node)] = 1
                order.append(node)
                continue
            s = state.get(id(node))
            if s == 1:
                continue
            if s == 0:
                raise ValueError("ONNX graph has a cycle")
            state[id(node)] = 0
            stack.append((node, True))
            for d in deps(node):
                if state.get(id(d)) != 1:
                    stack.append((d, False))
        return order

    def _fold(self):
        """Evaluate, once, every node whose inputs are all static values
        known now (integer initializers, Constant nodes and what is
        computed from them) and whose result stays in numpy; the call
        then starts from these values."""
        env: Dict[str, Any] = dict(self._static_consts)
        ctx = _Ctx({}, None, False)
        self._todo: List[int] = []
        for k, (node, attrs) in enumerate(zip(self._order, self._attrs)):
            refs = [r for r in node.input if r]
            if node.op_type in _RANDOM or not all(r in env for r in refs):
                self._todo.append(k)
                continue
            try:
                out = _H[node.op_type](ctx, node, attrs,
                                       [env[r] if r else None
                                        for r in node.input])
            except Exception:  # raised again, with its context, at a call
                self._todo.append(k)
                continue
            outs = out if isinstance(out, tuple) else (out,)
            if not all(_is_static(v) for v in outs):
                self._todo.append(k)
                continue
            for name, v in zip(node.output, outs):
                if name:
                    env[name] = v
        self._folded = env
        self._consts = constant_cache(env.values())

    def _device(self, params, inputs, device):
        for v in list(params.values()) + list(inputs):
            if isinstance(v, torch.Tensor):
                return v.device
        from ....common.context import resolve_device
        return resolve_device(device)

    def __call__(self, params: Dict[str, Any], *input_values,
                 rng: Optional[torch.Generator] = None,
                 training: bool = False, device=None):
        if len(input_values) != len(self.input_names):
            raise ValueError(
                f"expected {len(self.input_names)} inputs "
                f"({self.input_names}), got {len(input_values)}")
        dev = self._device(params, input_values, device)
        env: Dict[str, Any] = dict(self._folded)
        env.update({k: to_tensor(v, dev) for k, v in params.items()})
        env.update(zip(self.input_names,
                       (to_tensor(v, dev) for v in input_values)))
        ctx = _Ctx(params, rng, training, dev, self._consts)
        for k in self._todo:
            node, attrs = self._order[k], self._attrs[k]
            args = [env[r] if r else None for r in node.input]
            out = _H[node.op_type](ctx, node, attrs, args)
            if isinstance(out, tuple):
                for name, v in zip(node.output, out):
                    if name:
                        env[name] = v
            else:
                env[node.output[0]] = out
        missing = [o for o in self.output_names if o not in env]
        if missing:
            raise KeyError(f"graph outputs never produced: {missing}")
        return [env[o] for o in self.output_names]

    @property
    def input_shapes(self) -> List[Optional[Tuple]]:
        """Declared shapes from graph.input value_info (None dims for
        symbolic/batch dims)."""
        shapes = []
        by_name = {vi.name: vi for vi in self.graph.input}
        for name in self.input_names:
            vi = by_name.get(name)
            if vi is None or vi.type is None or vi.type.tensor_type is None \
                    or vi.type.tensor_type.shape is None:
                shapes.append(None)
                continue
            dims = []
            for d in vi.type.tensor_type.shape.dim:
                dims.append(int(d.dim_value) if d.dim_value else None)
            shapes.append(tuple(dims))
        return shapes
