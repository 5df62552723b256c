"""Post-training int8 quantization for inference.

Counterpart of ``analytics_zoo_tpu/ops/quantize.py`` (the reference's
'-quantize' model variants, BigDL's 8-bit scheme).  Weights are
quantized per output channel (symmetric absmax int8) ahead of time;
activations per sample, on the device, at every call
(:func:`dynamic_quantize`).  The product accumulates exactly in int32
and one rescale, ``acc * (x_scale * w_scale)``, returns to f32, in the
JAX package's order of operations, so the int8 weights and the int32
accumulators equal the JAX package's.

The JAX package leaves its int8 products to XLA
(``lax.dot_general``/``conv_general_dilated`` with an int32
``preferred_element_type``), outside any Pallas kernel.  Here the
product is ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card), which
on CUDA takes only more than 16 rows and a depth and width that are
multiples of 8, and below a depth of 128 finds no algorithm for many
row counts (on an H100 with CUDA 12.8, ``scripts/profile_torch_int8.py``
saw 180 of 1,222 shapes refused, every one at a depth under 128):
:func:`int_matmul` pads all three with zeros, which add nothing to an
int32 sum, on every device, so the CPU runs the shapes the card runs.
Torch has no int8 convolution: :func:`conv_accumulate` gathers the int8
patches itself (strided views, one copy) and runs :func:`int_matmul` on
them.  No path falls back to a float product.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import shapes as shape_utils
from ..core.graph import GraphModule, InputLayer, Variable
from ..core.module import Layer, register_layer

_EPS = 1e-12
#: ``torch._int_mm`` on CUDA: rows > 16, depth and width multiples of 8,
#: depth at least 128 (below it cuBLASLt refuses many row counts); rows
#: are rounded to a multiple of 8 as well (every refusal seen was at a
#: row count that is not one)
_MIN_ROWS = 17
_MIN_DEPTH = 128
_ALIGN = 8


# ---------------------------------------------------------------------------
# primitives

_DIVISORS: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}


def _over_127(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax / 127`` as a true quotient on every device.  CUDA turns a
    division by a host scalar into a product with its reciprocal, one
    bit off the quotient for some values: the scales, and then the int8
    roundings, would differ from the CPU's and the JAX package's."""
    key = (absmax.device, absmax.dtype)
    if key not in _DIVISORS:
        _DIVISORS[key] = torch.full((), 127.0, dtype=absmax.dtype,
                                    device=absmax.device)
    return absmax / _DIVISORS[key]


def quantize_per_channel(w, out_axis: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization per output channel: (w_q int8
    of ``w``'s shape, scale f32 of shape (channels,)), with ``w ≈ w_q *
    scale`` along ``out_axis``."""
    w = torch.as_tensor(w).detach().float()
    axis = out_axis % w.ndim
    red = tuple(i for i in range(w.ndim) if i != axis)
    absmax = w.abs().amax(dim=red) if red else w.abs()
    scale = torch.clamp_min(_over_127(absmax), _EPS)
    bshape = tuple(w.shape[i] if i == axis else 1 for i in range(w.ndim))
    wq = torch.clamp(torch.round(w / scale.reshape(bshape)), -127, 127)
    return wq.to(torch.int8), scale


def dynamic_quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample dynamic activation quantization (absmax, symmetric):
    the scale reduces over every axis but the leading batch axis and
    keeps its dims ((b, 1, ..., 1)), so one outlier sample does not widen
    the others' windows.  Computed on the device, with no host sync."""
    x = torch.as_tensor(x)
    red = tuple(range(1, x.ndim)) if x.ndim > 1 else tuple(range(x.ndim))
    absmax = x.abs().amax(dim=red, keepdim=True) if red else x.abs()
    scale = torch.clamp_min(_over_127(absmax), _EPS).float()
    xq = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return xq, scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t.contiguous()
    out = t.new_zeros((rows, cols))
    out[:r, :c] = t
    return out


def _padded(rows: int, depth: int) -> Tuple[int, int]:
    """The (rows, depth) of the first operand ``torch._int_mm`` is given."""
    return (_round_up(max(rows, _MIN_ROWS), _ALIGN),
            max(_round_up(depth, _ALIGN), _MIN_DEPTH))


def _int_mm_padded(a: torch.Tensor, b: torch.Tensor,
                   m: int) -> torch.Tensor:
    # ``a`` already padded (its first m rows and b.shape[0] columns real)
    n = b.shape[1]
    out = torch._int_mm(a, _pad2(b, a.shape[1], _round_up(n, _ALIGN)))
    return out[:m, :n]


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``a`` (M, K) and ``b`` (K, N),
    through ``torch._int_mm`` with M, K and N zero-padded to shapes it
    takes on the card."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    m, k = a.shape
    return _int_mm_padded(_pad2(a, *_padded(m, k)), b, m)


def int8_matmul(x, w_q, w_scale):
    """``x @ dequant(w_q)`` with int8 operands and int32 accumulation:
    ``acc * (x_scale * w_scale)`` in f32."""
    xq, xs = dynamic_quantize(x)
    acc = int_matmul(xq.reshape(-1, xq.shape[-1]), w_q)
    acc = acc.reshape(*x.shape[:-1], w_q.shape[-1])
    return acc.float() * (xs * w_scale)


def _conv_pads(spatial, kernel, strides, dilation, padding):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * len(spatial)
        if padding.upper() == "SAME":
            return [shape_utils.same_padding(n, k, s, d) for n, k, s, d in
                    zip(spatial, kernel, strides, dilation)]
        raise ValueError(f"unknown padding {padding!r}")
    return [tuple(p) for p in padding]


def conv_accumulate(xq: torch.Tensor, w_q: torch.Tensor,
                    strides: Sequence[int],
                    padding: Union[str, Sequence[Tuple[int, int]]],
                    dilation: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """The int32 accumulators of a channels-last convolution of int8
    ``xq`` (N, spatial..., C) with int8 HWIO ``w_q``: the patches
    gathered from strided views into an (N·out, k·C) int8 matrix, in the
    HWIO order of ``w_q`` flattened, times ``w_q`` by :func:`int_matmul`.
    ``padding`` is "VALID", "SAME" (XLA's split) or (low, high) pairs."""
    rank = xq.ndim - 2
    kernel = tuple(w_q.shape[:rank])
    strides = tuple(strides)
    dilation = tuple(dilation) if dilation is not None else (1,) * rank
    pads = _conv_pads(xq.shape[1:1 + rank], kernel, strides, dilation,
                      padding)
    if any(lo or hi for lo, hi in pads):
        flat = [0, 0]  # F.pad lists the last axis (channels) first
        for lo, hi in reversed(pads):
            flat += [lo, hi]
        xq = F.pad(xq, flat)
    patches = xq
    for i, (k, s, d) in enumerate(zip(kernel, strides, dilation)):
        # a view: (..., out_i, ..., C, k_1, ..., k_i)
        patches = patches.unfold(1 + i, (k - 1) * d + 1, s)[..., ::d]
    out = patches.shape[1:1 + rank]
    # (N, out..., C, k...) -> (N, out..., k..., C): HWIO's row order
    perm = ((0,) + tuple(range(1, 1 + rank))
            + tuple(range(rank + 2, 2 * rank + 2)) + (rank + 1,))
    patches = patches.permute(perm)
    rows, depth = xq.shape[0] * math.prod(out), w_q[..., 0].numel()
    padded = _padded(rows, depth)
    if padded == (rows, depth):
        cols = patches.reshape(rows, depth)  # a view where it can be
    else:
        # the patches copied once, straight into the padded matrix
        cols = xq.new_zeros(padded)
        cols[:rows, :depth].view(patches.shape).copy_(patches)
    acc = _int_mm_padded(cols, w_q.reshape(-1, w_q.shape[-1]), rows)
    return acc.reshape(xq.shape[0], *out, w_q.shape[-1])


def int8_conv(x_cl, w_q, w_scale, strides, padding, dilation=None):
    """Channels-last convolution with int8 operands and int32
    accumulation; f32 out with the per-output-channel rescale."""
    xq, xs = dynamic_quantize(x_cl)
    acc = conv_accumulate(xq, w_q, strides, padding, dilation)
    return acc.float() * (xs * w_scale)


# ---------------------------------------------------------------------------
# quantized layer wrappers

class _QuantizedLayer(Layer):
    """Holds the converted tensors as frozen parameters keyed as the JAX
    package's quantized params; reuses the source layer's name, so the
    rebuilt graph's tree lines up with the float one.  The source layer
    stays outside the module tree (its float weights are not this
    layer's)."""

    def __init__(self, src: Layer, initial: Dict[str, torch.Tensor]):
        super().__init__(name=src.name, trainable=False)
        self.__dict__["src"] = src
        for key, value in initial.items():
            self.register_parameter(key, nn.Parameter(value,
                                                      requires_grad=False))
        self.built = True

    @staticmethod
    def _float_copy(t: torch.Tensor) -> torch.Tensor:
        return t.detach().float().clone()

    def compute_output_shape(self, input_shape):
        return self.src.compute_output_shape(input_shape)

    def get_config(self):
        raise NotImplementedError(
            "quantized models are an inference-time artifact and are not "
            "serialized; save the float model and re-quantize after load")


@register_layer
class QuantizedDense(_QuantizedLayer):
    """int8 inference version of Dense (y = act(x @ W + b))."""

    @classmethod
    def from_layer(cls, dense, params) -> "QuantizedDense":
        wq, scale = quantize_per_channel(params["W"], out_axis=-1)
        initial = {"Wq": wq, "w_scale": scale}
        if dense.bias:
            initial["b"] = cls._float_copy(params["b"])
        return cls(dense, initial)

    def forward(self, x):
        y = int8_matmul(x, self.Wq, self.w_scale)
        if self.src.bias:
            y = y + self.b
        if self.src.activation is not None:
            y = self.src.activation(y)
        return y


@register_layer
class QuantizedConv(_QuantizedLayer):
    """int8 inference version of the plain 1-D and 2-D convolutions, with
    their stride, padding (same, valid, causal) and dilation."""

    @classmethod
    def from_layer(cls, conv, params) -> "QuantizedConv":
        wq, scale = quantize_per_channel(params["W"], out_axis=-1)
        initial = {"Wq": wq, "w_scale": scale}
        if conv.bias:
            initial["b"] = cls._float_copy(params["b"])
        return cls(conv, initial)

    def forward(self, x):
        from ..pipeline.api.keras.layers.convolutional import (
            from_channels_last, to_channels_last)
        src = self.src
        x_cl = to_channels_last(x, src.data_format, src.rank)
        pads = src._pads(x_cl.shape[1:1 + src.rank])
        y = int8_conv(x_cl, self.Wq, self.w_scale, strides=src.subsample,
                      padding=pads, dilation=src.dilation)
        if src.bias:
            y = y + self.b
        if src.activation is not None:
            y = src.activation(y)
        return from_channels_last(y, src.data_format, src.rank)


@register_layer
class QuantizedEmbedding(_QuantizedLayer):
    """int8 inference version of Embedding: the table stored int8 with a
    scale per row (each token's vector its own absmax window),
    dequantized after the gather: a 4x smaller table, and 4x fewer bytes
    gathered."""

    @classmethod
    def from_layer(cls, emb, params) -> "QuantizedEmbedding":
        tq, scale = quantize_per_channel(params["embeddings"], out_axis=0)
        return cls(emb, {"Eq": tq, "e_scale": scale})

    def forward(self, ids):
        idx = ids.long()
        return self.Eq[idx].float() * self.e_scale[idx][..., None]


@register_layer
class QuantizedSeparableConv(_QuantizedLayer):
    """int8 inference version of SeparableConvolution2D: the 1x1
    pointwise convolution, where nearly all the FLOPs and weights are,
    runs int8; the depthwise convolution stays f32."""

    @classmethod
    def from_layer(cls, sep, params) -> "QuantizedSeparableConv":
        wq, scale = quantize_per_channel(params["pointwise"], out_axis=-1)
        initial = {"depthwise": cls._float_copy(params["depthwise"]),
                   "Pq": wq, "p_scale": scale}
        if sep.bias:
            initial["b"] = cls._float_copy(params["b"])
        return cls(sep, initial)

    def forward(self, x):
        from ..pipeline.api.keras.layers.convolutional import (
            channels_first_view, from_channels_last, pad_spatial,
            to_channels_last)
        src = self.src
        x_cl = to_channels_last(x, src.data_format, 2)
        if src.border_mode == "same":
            x_cl = pad_spatial(x_cl, [
                shape_utils.same_padding(n, k, s) for n, k, s in
                zip(x_cl.shape[1:3], src.kernel_size, src.subsample)])
        y = F.conv2d(channels_first_view(x_cl, 2),
                     self.depthwise.permute(3, 2, 0, 1),
                     stride=src.subsample, groups=x_cl.shape[-1])
        y = int8_conv(y.permute(0, 2, 3, 1), self.Pq, self.p_scale,
                      strides=(1, 1), padding="VALID")
        if src.bias:
            y = y + self.b
        if src.activation is not None:
            y = src.activation(y)
        return from_channels_last(y, src.data_format, 2)


# ---------------------------------------------------------------------------
# graph transformation

def _quantizable(layer: Layer, params) -> Optional[type]:
    """The quantized wrapper class of a supported layer, else None.

    Supported: Dense, the plain 1-D/2-D convolutions, Embedding lookups
    and SeparableConvolution2D (its pointwise part), each only when the
    subclass does not override the compute path (``forward``): such a
    layer stays in float."""
    from ..pipeline.api.keras.layers.convolutional import (
        SeparableConvolution2D, _ConvND)
    from ..pipeline.api.keras.layers.core import Dense
    from ..pipeline.api.keras.layers.embedding import Embedding
    if isinstance(layer, Embedding) \
            and type(layer).forward is Embedding.forward \
            and "embeddings" in params:
        return QuantizedEmbedding
    if isinstance(layer, SeparableConvolution2D) \
            and type(layer).forward is SeparableConvolution2D.forward \
            and "pointwise" in params:
        return QuantizedSeparableConv
    if "W" not in params or not torch.as_tensor(
            params["W"]).is_floating_point():
        return None
    if isinstance(layer, Dense) and type(layer).forward is Dense.forward:
        return QuantizedDense
    if isinstance(layer, _ConvND) and type(layer).forward is _ConvND.forward:
        return QuantizedConv
    return None


def quantize_graph(graph: GraphModule):
    """Rebuild ``graph`` with its supported layers swapped for int8
    wrappers.  Returns (new_graph, params, state): the new graph's
    parameter and state trees, keyed as the JAX package's
    ``quantize_graph`` keys them.  Every other layer is a copy of the
    float one, weights and state included: the new graph is a snapshot,
    as the JAX package's (which holds that moment's arrays), so later
    training of the float model leaves it as it was."""
    from ..models.jax_params import state_tree, weight_tree
    new_of: Dict[int, Variable] = {}
    layer_map: Dict[int, Layer] = {}
    for v in graph.nodes:
        if isinstance(v.layer, InputLayer):
            new_of[v.node_id] = v  # inputs are shared
            continue
        layer = v.layer
        if id(layer) not in layer_map:
            params = layer.params()
            qcls = _quantizable(layer, params)
            layer_map[id(layer)] = (qcls.from_layer(layer, params)
                                    if qcls is not None
                                    else copy.deepcopy(layer))
        new_of[v.node_id] = Variable(
            layer_map[id(layer)], [new_of[p.node_id] for p in v.inputs],
            v.shape, name=v.name)
    outputs = [new_of[o.node_id] for o in graph.output_vars]
    new_graph = GraphModule(list(graph.input_vars),
                            outputs[0] if graph.single_output else outputs,
                            name=f"{graph.name}_int8")
    return new_graph, weight_tree(new_graph), state_tree(new_graph)


def quantized_size_bytes(tree) -> int:
    """Total byte size of a params tree's leaves (tensors or arrays)."""
    if isinstance(tree, dict):
        return sum(quantized_size_bytes(v) for v in tree.values())
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)
