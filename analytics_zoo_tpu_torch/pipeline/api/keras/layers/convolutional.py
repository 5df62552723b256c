"""Convolutions (Convolution1D, Convolution2D, SeparableConvolution2D)
and the layout layers ZeroPadding2D and SpaceToDepth2D.

Counterpart of ``_ConvND``, ``Convolution1D``, ``Convolution2D``,
``SeparableConvolution2D``, ``ZeroPadding2D`` and ``SpaceToDepth2D`` in
``analytics_zoo_tpu/pipeline/api/keras/layers/convolutional.py``.

Layout: the public input is channels-last (NHWC, or NWC in 1-D), as in
the JAX package; ``dim_ordering="th"`` takes channels-first.  The weight
``W`` keeps the JAX package's layout, HWIO (WIO in 1-D), so weights move
between the packages unchanged; each call views it as OIHW for
``F.conv2d`` and the input as channels-first (a permuted view of an NHWC
tensor, which cuDNN runs channels-last), then permutes the result back.
Padding is explicit: ``same`` pads as XLA's ``SAME`` does, the odd
element on the high side, at any stride (``F.conv2d(padding="same")``
pads symmetrically and refuses stride > 1).  Convolutions on the card
run at the precision ``torch.backends.cudnn.allow_tf32`` sets (TF32 by
PyTorch's default).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .....core import shapes as shape_utils
from .....core.module import Layer, promote, register_layer
from .. import activations
from ..regularizers import RegularizedLayerMixin

_CONV = {1: F.conv1d, 2: F.conv2d}


def to_channels_last(x, data_format: str, rank: int):
    if data_format == "channels_first":
        return x.permute((0,) + tuple(range(2, 2 + rank)) + (1,))
    return x


def from_channels_last(x, data_format: str, rank: int):
    if data_format == "channels_first":
        return x.permute((0, rank + 1) + tuple(range(1, rank + 1)))
    return x


def channels_first_view(x_cl, rank: int):
    """(N, spatial..., C) -> a (N, C, spatial...) view."""
    return x_cl.permute((0, rank + 1) + tuple(range(1, rank + 1)))


def channels_last_shape(input_shape, data_format: str):
    if data_format == "channels_first":
        return ((input_shape[0],) + tuple(input_shape[2:])
                + (input_shape[1],))
    return tuple(input_shape)


def pad_spatial(x_cl, pads, value: float = 0.0):
    """Pad the spatial axes of a channels-last tensor by ``pads``, one
    (low, high) pair per spatial axis."""
    if not any(lo or hi for lo, hi in pads):
        return x_cl
    flat = [0, 0]  # F.pad lists the last axis (channels) first
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x_cl, flat, value=value)


class _ConvND(RegularizedLayerMixin, Layer):
    """Shared machinery of the 1-D and 2-D convolutions."""

    rank: int = 2

    def __init__(self, nb_filter, kernel_size, init="glorot_uniform",
                 activation=None, border_mode="valid", subsample=1,
                 dilation=1, dim_ordering=None, bias=True,
                 W_regularizer=None, b_regularizer=None, input_shape=None,
                 name=None, trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self._setup_regularizers(W_regularizer, b_regularizer)
        if border_mode not in ("valid", "same") and not (
                border_mode == "causal" and self.rank == 1):
            raise ValueError(
                f"{type(self).__name__}: unsupported border_mode "
                f"{border_mode!r}")
        self.nb_filter = int(nb_filter)
        self.kernel_size = shape_utils.normalize_tuple(
            kernel_size, self.rank, "kernel_size")
        self.subsample = shape_utils.normalize_tuple(
            subsample, self.rank, "subsample")
        self.dilation = shape_utils.normalize_tuple(
            dilation, self.rank, "dilation")
        self.border_mode = border_mode
        self.init_name = init
        self.activation_name = activation if not callable(activation) else None
        self.activation = activations.get(activation)
        self.bias = bias
        self.data_format = shape_utils.normalize_data_format(dim_ordering)
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        in_ch = int(channels_last_shape(input_shape, self.data_format)[-1])
        self.add_param("W", self.init_name,
                       self.kernel_size + (in_ch, self.nb_filter), generator)
        if self.bias:
            self.add_param("b", "zeros", (self.nb_filter,), generator)

    def _pads(self, spatial):
        if self.border_mode == "same":
            return [shape_utils.same_padding(n, k, s, d) for n, k, s, d in
                    zip(spatial, self.kernel_size, self.subsample,
                        self.dilation)]
        if self.border_mode == "causal":
            return [(self.dilation[0] * (self.kernel_size[0] - 1), 0)]
        return [(0, 0)] * self.rank

    def forward(self, x):
        r = self.rank
        x_cl = to_channels_last(x, self.data_format, r)
        x_cl = pad_spatial(x_cl, self._pads(x_cl.shape[1:1 + r]))
        self._add_penalty()
        x_cl, w, *b = promote(x_cl, *((self.W, self.b) if self.bias
                                      else (self.W,)))
        # HWIO -> OIHW (WIO -> OIW): a view
        w = w.permute((r + 1, r) + tuple(range(r)))
        y = _CONV[r](channels_first_view(x_cl, r), w, *b,
                     stride=self.subsample, dilation=self.dilation)
        y = y.permute((0,) + tuple(range(2, 2 + r)) + (1,))  # channels last
        if self.activation is not None:
            y = self.activation(y)  # on channels last, as the JAX package
        return from_channels_last(y, self.data_format, r)

    def compute_output_shape(self, input_shape):
        cl = channels_last_shape(input_shape, self.data_format)
        spatial = [
            shape_utils.conv_output_length(
                cl[1 + i], self.kernel_size[i], self.border_mode,
                self.subsample[i], self.dilation[i])
            for i in range(self.rank)]
        out_cl = (cl[0],) + tuple(spatial) + (self.nb_filter,)
        if self.data_format == "channels_first":
            return (out_cl[0], out_cl[-1]) + tuple(out_cl[1:-1])
        return out_cl

    def get_config(self):
        cfg = super().get_config()
        cfg.update(nb_filter=self.nb_filter,
                   kernel_size=list(self.kernel_size), init=self.init_name,
                   activation=self.activation_name,
                   border_mode=self.border_mode,
                   subsample=list(self.subsample),
                   dilation=list(self.dilation), bias=self.bias,
                   dim_ordering=self.data_format,
                   **self._regularizer_config())
        return cfg


@register_layer
class Convolution1D(_ConvND):
    """1-D convolution over (batch, steps, channels)."""

    rank = 1

    def __init__(self, nb_filter, filter_length=3, kernel_size=None, **kw):
        super().__init__(nb_filter, kernel_size or filter_length, **kw)


@register_layer
class Convolution2D(_ConvND):
    """2-D convolution over (batch, rows, cols, channels)."""

    rank = 2

    def __init__(self, nb_filter, nb_row=3, nb_col=3, kernel_size=None, **kw):
        super().__init__(nb_filter, kernel_size or (nb_row, nb_col), **kw)


@register_layer
class SeparableConvolution2D(Layer):
    """Depthwise-separable convolution: a depthwise convolution (one
    group per input channel, ``depth_multiplier`` filters each), then a
    1x1 pointwise one.  The parameters keep the JAX package's names and
    layouts: ``depthwise`` (kh, kw, 1, in*depth_multiplier), ``pointwise``
    (1, 1, in*depth_multiplier, nb_filter), ``b``."""

    def __init__(self, nb_filter, nb_row=3, nb_col=3, init="glorot_uniform",
                 activation=None, border_mode="valid", subsample=(1, 1),
                 depth_multiplier=1, dim_ordering=None, bias=True,
                 input_shape=None, name=None, trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"SeparableConvolution2D: unsupported "
                             f"border_mode {border_mode!r}")
        self.nb_filter = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.subsample = shape_utils.normalize_tuple(subsample, 2)
        self.border_mode = border_mode
        self.depth_multiplier = int(depth_multiplier)
        self.init_name = init
        self.activation_name = activation if not callable(activation) else None
        self.activation = activations.get(activation)
        self.bias = bias
        self.data_format = shape_utils.normalize_data_format(dim_ordering)
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        in_ch = int(channels_last_shape(input_shape, self.data_format)[-1])
        mid = in_ch * self.depth_multiplier
        self.add_param("depthwise", self.init_name,
                       self.kernel_size + (1, mid), generator)
        self.add_param("pointwise", self.init_name,
                       (1, 1, mid, self.nb_filter), generator)
        if self.bias:
            self.add_param("b", "zeros", (self.nb_filter,), generator)

    def forward(self, x):
        x_cl = to_channels_last(x, self.data_format, 2)
        if self.border_mode == "same":
            x_cl = pad_spatial(x_cl, [
                shape_utils.same_padding(n, k, s) for n, k, s in
                zip(x_cl.shape[1:3], self.kernel_size, self.subsample)])
        x_cl, dw, pw, *b = promote(
            x_cl, self.depthwise, self.pointwise,
            *((self.b,) if self.bias else ()))
        # HWIO -> OIHW views; the depthwise O axis is channel-major
        # (output o reads input o // depth_multiplier), as XLA's groups
        y = F.conv2d(channels_first_view(x_cl, 2), dw.permute(3, 2, 0, 1),
                     stride=self.subsample, groups=x_cl.shape[-1])
        y = F.conv2d(y, pw.permute(3, 2, 0, 1), *b)
        y = y.permute(0, 2, 3, 1)
        if self.activation is not None:
            y = self.activation(y)
        return from_channels_last(y, self.data_format, 2)

    def compute_output_shape(self, input_shape):
        cl = channels_last_shape(input_shape, self.data_format)
        spatial = [
            shape_utils.conv_output_length(
                cl[1 + i], self.kernel_size[i], self.border_mode,
                self.subsample[i]) for i in range(2)]
        out = (cl[0],) + tuple(spatial) + (self.nb_filter,)
        if self.data_format == "channels_first":
            return (out[0], out[3], out[1], out[2])
        return out

    def get_config(self):
        cfg = super().get_config()
        cfg.update(nb_filter=self.nb_filter, nb_row=self.kernel_size[0],
                   nb_col=self.kernel_size[1], init=self.init_name,
                   activation=self.activation_name,
                   border_mode=self.border_mode,
                   subsample=list(self.subsample),
                   depth_multiplier=self.depth_multiplier, bias=self.bias,
                   dim_ordering=self.data_format)
        return cfg


class _PadCropBase(Layer):
    def __init__(self, dim_ordering=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.data_format = shape_utils.normalize_data_format(dim_ordering)


@register_layer
class ZeroPadding2D(_PadCropBase):
    """Zero rows and columns around the image: ``padding`` (rows, cols)
    pads both sides of each axis by its value, (top, bottom, left, right)
    each side by its own."""

    def __init__(self, padding=(1, 1), dim_ordering=None, input_shape=None,
                 name=None):
        super().__init__(dim_ordering=dim_ordering, input_shape=input_shape,
                         name=name)
        if len(padding) == 2:
            self.padding = ((padding[0], padding[0]),
                            (padding[1], padding[1]))
        else:
            self.padding = ((padding[0], padding[1]),
                            (padding[2], padding[3]))

    def forward(self, x):
        (top, bottom), (left, right) = self.padding
        if self.data_format == "channels_last":
            return F.pad(x, [0, 0, left, right, top, bottom])
        return F.pad(x, [left, right, top, bottom])

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        axes = (1, 2) if self.data_format == "channels_last" else (2, 3)
        for ax, (lo, hi) in zip(axes, self.padding):
            if s[ax] is not None:
                s[ax] += lo + hi
        return tuple(s)

    def get_config(self):
        cfg = super().get_config()
        cfg["padding"] = [p for pair in self.padding for p in pair]
        cfg["dim_ordering"] = self.data_format
        return cfg


@register_layer
class SpaceToDepth2D(_PadCropBase):
    """(H, W, C) -> (H/b, W/b, b*b*C) by b x b blocks, the packed channel
    of block offset (r, s) and channel c being (r*b + s)*C + c: the
    space-to-depth stem of ResNet-50 (``space_to_depth=True``)."""

    def __init__(self, block_size=2, dim_ordering=None, input_shape=None,
                 name=None):
        super().__init__(dim_ordering=dim_ordering, input_shape=input_shape,
                         name=name)
        self.block_size = int(block_size)

    def forward(self, x):
        b = self.block_size
        cf = self.data_format == "channels_first"
        x = x.permute(0, 2, 3, 1) if cf else x
        n, h, w, c = x.shape
        if h % b or w % b:
            raise ValueError(
                f"SpaceToDepth2D: spatial dims ({h}, {w}) not divisible "
                f"by block_size {b}")
        y = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(n, h // b, w // b, b * b * c)
        return y.permute(0, 3, 1, 2) if cf else y

    def compute_output_shape(self, input_shape):
        b = self.block_size
        if self.data_format == "channels_first":
            n, c, h, w = input_shape
        else:
            n, h, w, c = input_shape
        if (h is not None and h % b) or (w is not None and w % b):
            # fail when the model is built, not at its first call
            raise ValueError(
                f"SpaceToDepth2D: spatial dims ({h}, {w}) not divisible "
                f"by block_size {b}")
        if self.data_format == "channels_first":
            return (n, c * b * b, h // b, w // b)
        return (n, h // b, w // b, c * b * b)

    def get_config(self):
        cfg = super().get_config()
        cfg["block_size"] = self.block_size
        cfg["dim_ordering"] = self.data_format
        return cfg
