"""The convolution family and the layout layers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
convolutional.py``, every class of it: ``Convolution1D/2D/3D``,
``AtrousConvolution1D/2D``, ``ShareConvolution2D``,
``SeparableConvolution2D``, ``Deconvolution2D``,
``LocallyConnected1D/2D``, ``ZeroPadding1D/2D/3D``,
``Cropping1D/2D/3D``, ``UpSampling1D/2D/3D``, ``ResizeBilinear`` and
``SpaceToDepth2D``.

Layout: the public input is channels-last (NHWC, NWC in 1-D, NDHWC in
3-D), as in the JAX package; ``dim_ordering="th"`` takes channels-first.
The weight ``W`` keeps the JAX package's layout, HWIO (WIO, DHWIO), so
weights move between the packages unchanged; each call views it as OIHW
for ``F.conv2d`` and the input as channels-first (a permuted view of an
NHWC tensor, which cuDNN runs channels-last), then permutes the result
back.  Padding is explicit: ``same`` pads as XLA's ``SAME`` does, the
odd element on the high side, at any stride (``F.conv2d(padding="same")``
pads symmetrically and refuses stride > 1).  ``border_mode="full"``
raises, as the JAX package's convolutions do.  Convolutions on the card
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

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


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
    """Shared machinery of the 1-D, 2-D and 3-D convolutions."""

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
            raise ValueError(f"Unsupported border_mode {border_mode!r}")
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
class Convolution3D(_ConvND):
    """3-D convolution over (batch, dim1, dim2, dim3, channels); ``W``
    DHWIO."""

    rank = 3

    def __init__(self, nb_filter, kernel_dim1=3, kernel_dim2=3, kernel_dim3=3,
                 kernel_size=None, **kw):
        super().__init__(
            nb_filter, kernel_size or (kernel_dim1, kernel_dim2, kernel_dim3),
            **kw)


@register_layer
class AtrousConvolution1D(Convolution1D):
    """Dilated 1-D convolution: ``atrous_rate`` is the dilation."""

    def __init__(self, nb_filter, filter_length=3, atrous_rate=1, **kw):
        kw.setdefault("dilation", atrous_rate)
        super().__init__(nb_filter, filter_length, **kw)


@register_layer
class AtrousConvolution2D(Convolution2D):
    """Dilated 2-D convolution: ``atrous_rate`` is the dilation."""

    def __init__(self, nb_filter, nb_row=3, nb_col=3, atrous_rate=(1, 1),
                 **kw):
        kw.setdefault("dilation", atrous_rate)
        super().__init__(nb_filter, nb_row, nb_col, **kw)


@register_layer
class ShareConvolution2D(Convolution2D):
    """Convolution2D: weights are shared by calling one instance at
    several graph nodes, as in the JAX package."""


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


def _deconv_pads(k: int, s: int, border_mode: str):
    """(low, high) zero padding of the stride-dilated input in
    ``lax.conv_transpose`` at SAME or VALID (XLA's
    ``_conv_transpose_padding``)."""
    if border_mode == "same":
        total = k + s - 2
        low = k - 1 if s > k - 1 else -(-total // 2)
    else:
        total = k + s - 2 + max(k - s, 0)
        low = k - 1
    return low, total - low


@register_layer
class Deconvolution2D(Layer):
    """Transposed 2-D convolution, as ``lax.conv_transpose`` computes it
    in the JAX package: the input dilated by the stride, zero-padded as
    XLA pads it, and correlated with ``W`` (kh, kw, in, out) as stored.
    ``F.conv_transpose2d`` correlates with the kernel flipped, takes it
    as (in, out, kh, kw) and pads k - 1 on each side, so ``W`` goes in
    flipped and permuted, and the result is cropped (or zero-padded) to
    XLA's padding, which is asymmetric under ``same`` with an even
    kernel.  Output length: ``n * s`` under ``same``, ``n * s + max(k - s,
    0)`` under ``valid``."""

    def __init__(self, nb_filter, nb_row=3, nb_col=3, init="glorot_uniform",
                 activation=None, border_mode="valid", subsample=(1, 1),
                 dim_ordering=None, bias=True, input_shape=None, name=None,
                 trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"Unsupported border_mode {border_mode!r}")
        self.nb_filter = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.subsample = shape_utils.normalize_tuple(subsample, 2)
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

    def forward(self, x):
        x_cl = to_channels_last(x, self.data_format, 2)
        x_cl, w, *b = promote(x_cl, self.W,
                              *((self.b,) if self.bias else ()))
        w = torch.flip(w, (0, 1)).permute(2, 3, 0, 1)
        y = F.conv_transpose2d(channels_first_view(x_cl, 2), w,
                               stride=self.subsample)
        # the full output has k - 1 of padding on each side; F.pad lists
        # the last axis first, and crops where its padding is negative
        pads = []
        for k, s in reversed(list(zip(self.kernel_size, self.subsample))):
            low, high = _deconv_pads(k, s, self.border_mode)
            pads += [low - (k - 1), high - (k - 1)]
        y = F.pad(y, pads).permute(0, 2, 3, 1)
        if self.bias:
            y = y + b[0]
        if self.activation is not None:
            y = self.activation(y)
        return from_channels_last(y, self.data_format, 2)

    def compute_output_shape(self, input_shape):
        cl = channels_last_shape(input_shape, self.data_format)
        spatial = [
            shape_utils.deconv_output_length(
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
                   subsample=list(self.subsample), bias=self.bias,
                   dim_ordering=self.data_format)
        return cfg


def _patch_index(n_out: int, stride: int, k: int, size: int, device):
    """(n_out, k) input positions of each output's window, clamped to the
    input, and which of them lie inside it.  A position past the input's
    end reads its last element, as the JAX package's gather (which
    clamps) reads it under ``same``."""
    idx = (torch.arange(n_out, device=device)[:, None] * stride
           + torch.arange(k, device=device)[None, :])
    return idx.clamp(max=size - 1), idx < size


def _reads_past_end(n_out: int, stride: int, k: int, size: int) -> bool:
    return (n_out - 1) * stride + k > size


def _without_gradient_outside(patches, inside):
    """``patches`` whose reads past the input's end pass no gradient to
    the input: the JAX package's gather clamps them, and its gradient, a
    scatter at the same positions, drops them."""
    return torch.where(inside, patches, patches.detach())


class _LocallyConnected(Layer):
    """Shared machinery of the unshared-weight convolutions: ``W`` (out
    positions, window * channels, nb_filter) and ``b`` (out positions,
    nb_filter) in the JAX package's layout, each window's patch ordered
    by kernel position, then channel."""

    def _setup(self, nb_filter, activation, border_mode, bias):
        if border_mode not in ("valid", "same"):
            raise ValueError(f"Unsupported border_mode {border_mode!r}")
        self.nb_filter = int(nb_filter)
        self.border_mode = border_mode
        self.activation_name = activation if not callable(activation) else None
        self.activation = activations.get(activation)
        self.bias = bias

    def _add_params(self, positions, window, generator):
        self.add_param("W", "glorot_uniform",
                       (positions, window, self.nb_filter), generator)
        if self.bias:
            self.add_param("b", "zeros", (positions, self.nb_filter),
                           generator)

    def _apply(self, patches):
        """(batch, positions, window) patches -> (batch, positions,
        nb_filter), activated."""
        patches, w, *b = promote(patches, self.W,
                                 *((self.b,) if self.bias else ()))
        y = torch.einsum("bsk,sko->bso", patches, w)
        if self.bias:
            y = y + b[0]
        return y


@register_layer
class LocallyConnected1D(_LocallyConnected):
    """Convolution1D with unshared weights over (batch, steps,
    channels)."""

    def __init__(self, nb_filter, filter_length=3, activation=None,
                 border_mode="valid", subsample_length=1, bias=True,
                 input_shape=None, name=None, trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self._setup(nb_filter, activation, border_mode, bias)
        self.filter_length = int(filter_length)
        self.subsample = int(subsample_length)
        self._build_if_ready()

    def _out_steps(self, steps):
        return shape_utils.conv_output_length(
            steps, self.filter_length, self.border_mode, self.subsample)

    def build_params(self, input_shape, generator):
        steps, ch = int(input_shape[1]), int(input_shape[2])
        self._add_params(self._out_steps(steps), self.filter_length * ch,
                         generator)

    def forward(self, x):
        out_steps = self.W.shape[0]
        args = (out_steps, self.subsample, self.filter_length, x.shape[1])
        idx, inside = _patch_index(*args, x.device)
        patches = x[:, idx, :]
        if _reads_past_end(*args):
            patches = _without_gradient_outside(patches,
                                                inside[None, :, :, None])
        patches = patches.reshape(x.shape[0], out_steps, -1)
        y = self._apply(patches)
        return y if self.activation is None else self.activation(y)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self._out_steps(input_shape[1]),
                self.nb_filter)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(nb_filter=self.nb_filter, filter_length=self.filter_length,
                   activation=self.activation_name,
                   border_mode=self.border_mode,
                   subsample_length=self.subsample, bias=self.bias)
        return cfg


@register_layer
class LocallyConnected2D(_LocallyConnected):
    """Convolution2D with unshared weights; ``W`` (oh*ow, kh*kw*ch,
    nb_filter)."""

    def __init__(self, nb_filter, nb_row=3, nb_col=3, activation=None,
                 border_mode="valid", subsample=(1, 1), dim_ordering=None,
                 bias=True, input_shape=None, name=None, trainable=True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self._setup(nb_filter, activation, border_mode, bias)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.subsample = shape_utils.normalize_tuple(subsample, 2)
        self.data_format = shape_utils.normalize_data_format(dim_ordering)
        self._build_if_ready()

    def _out_spatial(self, cl):
        return tuple(
            shape_utils.conv_output_length(
                cl[1 + i], self.kernel_size[i], self.border_mode,
                self.subsample[i]) for i in range(2))

    def build_params(self, input_shape, generator):
        cl = channels_last_shape(input_shape, self.data_format)
        oh, ow = self._out_spatial(cl)
        self._add_params(oh * ow, self.kernel_size[0] * self.kernel_size[1]
                         * int(cl[-1]), generator)

    def forward(self, x):
        x_cl = to_channels_last(x, self.data_format, 2)
        b, h, w, c = x_cl.shape
        oh, ow = self._out_spatial((b, h, w, c))
        (kh, kw), (sh, sw) = self.kernel_size, self.subsample
        ri, r_in = _patch_index(oh, sh, kh, h, x.device)
        ci, c_in = _patch_index(ow, sw, kw, w, x.device)
        patches = x_cl[:, ri[:, None, :, None], ci[None, :, None, :], :]
        if _reads_past_end(oh, sh, kh, h) or _reads_past_end(ow, sw, kw, w):
            inside = r_in[:, None, :, None] & c_in[None, :, None, :]
            patches = _without_gradient_outside(patches,
                                                inside[None, ..., None])
        y = self._apply(patches.reshape(b, oh * ow, kh * kw * c))
        y = y.reshape(b, oh, ow, self.nb_filter)
        if self.activation is not None:
            y = self.activation(y)
        return from_channels_last(y, self.data_format, 2)

    def compute_output_shape(self, input_shape):
        cl = channels_last_shape(input_shape, self.data_format)
        oh, ow = self._out_spatial(cl)
        out = (cl[0], oh, ow, self.nb_filter)
        if self.data_format == "channels_first":
            return (out[0], out[3], out[1], out[2])
        return out

    def get_config(self):
        cfg = super().get_config()
        cfg.update(nb_filter=self.nb_filter, nb_row=self.kernel_size[0],
                   nb_col=self.kernel_size[1],
                   activation=self.activation_name,
                   border_mode=self.border_mode,
                   subsample=list(self.subsample), bias=self.bias,
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


def _spatial_axes(data_format: str, rank: int):
    first = 1 if data_format == "channels_last" else 2
    return tuple(range(first, first + rank))


@register_layer
class ZeroPadding1D(Layer):
    """Zero steps at both ends of (batch, steps, channels): ``padding``
    an int (both ends) or a (low, high) pair."""

    def __init__(self, padding=1, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.padding = shape_utils.normalize_tuple(padding, 2) \
            if not isinstance(padding, int) else (padding, padding)

    def forward(self, x):
        return F.pad(x, [0, 0, self.padding[0], self.padding[1]])

    def compute_output_shape(self, input_shape):
        steps = input_shape[1]
        steps = None if steps is None else steps + sum(self.padding)
        return (input_shape[0], steps, input_shape[2])

    def get_config(self):
        cfg = super().get_config()
        cfg["padding"] = list(self.padding)
        return cfg


@register_layer
class ZeroPadding3D(_PadCropBase):
    """Zeros on both sides of each of the three spatial axes, ``padding``
    elements each."""

    def __init__(self, padding=(1, 1, 1), dim_ordering=None, input_shape=None,
                 name=None):
        super().__init__(dim_ordering=dim_ordering, input_shape=input_shape,
                         name=name)
        self.padding = tuple(int(p) for p in padding)

    def forward(self, x):
        pads = [(p, p) for p in self.padding]
        if self.data_format == "channels_last":
            return pad_spatial(x, pads)
        return F.pad(x, [v for p in reversed(self.padding) for v in (p, p)])

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        for ax, p in zip(_spatial_axes(self.data_format, 3), self.padding):
            if s[ax] is not None:
                s[ax] += 2 * p
        return tuple(s)

    def get_config(self):
        cfg = super().get_config()
        cfg["padding"] = list(self.padding)
        cfg["dim_ordering"] = self.data_format
        return cfg


def _crop(x, axes, cropping):
    """A view of ``x`` with (low, high) elements cut from each axis."""
    index = [slice(None)] * x.ndim
    for ax, (lo, hi) in zip(axes, cropping):
        index[ax] = slice(lo, x.shape[ax] - hi)
    return x[tuple(index)]


def _cropped_shape(input_shape, axes, cropping):
    s = list(input_shape)
    for ax, (lo, hi) in zip(axes, cropping):
        if s[ax] is not None:
            s[ax] -= lo + hi
    return tuple(s)


@register_layer
class Cropping1D(Layer):
    """Cut ``cropping`` (low, high) steps from (batch, steps,
    channels)."""

    def __init__(self, cropping=(1, 1), input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.cropping = tuple(int(c) for c in cropping)

    def forward(self, x):
        return _crop(x, (1,), (self.cropping,))

    def compute_output_shape(self, input_shape):
        return _cropped_shape(input_shape, (1,), (self.cropping,))

    def get_config(self):
        cfg = super().get_config()
        cfg["cropping"] = list(self.cropping)
        return cfg


class _CroppingND(_PadCropBase):
    rank = 2

    def __init__(self, cropping, dim_ordering=None, input_shape=None,
                 name=None):
        super().__init__(dim_ordering=dim_ordering, input_shape=input_shape,
                         name=name)
        self.cropping = tuple(tuple(int(x) for x in c) for c in cropping)

    def forward(self, x):
        return _crop(x, _spatial_axes(self.data_format, self.rank),
                     self.cropping)

    def compute_output_shape(self, input_shape):
        return _cropped_shape(input_shape,
                              _spatial_axes(self.data_format, self.rank),
                              self.cropping)

    def get_config(self):
        cfg = super().get_config()
        cfg["cropping"] = [list(c) for c in self.cropping]
        cfg["dim_ordering"] = self.data_format
        return cfg


@register_layer
class Cropping2D(_CroppingND):
    """Cut (low, high) rows and columns: ``((top, bottom), (left,
    right))``."""

    rank = 2

    def __init__(self, cropping=((0, 0), (0, 0)), dim_ordering=None,
                 input_shape=None, name=None):
        super().__init__(cropping, dim_ordering=dim_ordering,
                         input_shape=input_shape, name=name)


@register_layer
class Cropping3D(_CroppingND):
    """Cut (low, high) elements from each of the three spatial axes."""

    rank = 3

    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), dim_ordering=None,
                 input_shape=None, name=None):
        super().__init__(cropping, dim_ordering=dim_ordering,
                         input_shape=input_shape, name=name)


def _repeat(x, axes, sizes):
    """Each element repeated ``size`` times along each axis, in place
    (``jnp.repeat``)."""
    for ax, k in zip(axes, sizes):
        x = torch.repeat_interleave(x, k, dim=ax)
    return x


def _scaled_shape(input_shape, axes, sizes):
    s = list(input_shape)
    for ax, k in zip(axes, sizes):
        if s[ax] is not None:
            s[ax] *= k
    return tuple(s)


@register_layer
class UpSampling1D(Layer):
    """Repeat each step ``length`` times."""

    def __init__(self, length=2, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.length = int(length)

    def forward(self, x):
        return _repeat(x, (1,), (self.length,))

    def compute_output_shape(self, input_shape):
        return _scaled_shape(input_shape, (1,), (self.length,))

    def get_config(self):
        cfg = super().get_config()
        cfg["length"] = self.length
        return cfg


class _UpSamplingND(_PadCropBase):
    rank = 2

    def __init__(self, size, dim_ordering=None, input_shape=None, name=None):
        super().__init__(dim_ordering=dim_ordering, input_shape=input_shape,
                         name=name)
        self.size = shape_utils.normalize_tuple(size, self.rank)

    def forward(self, x):
        return _repeat(x, _spatial_axes(self.data_format, self.rank),
                       self.size)

    def compute_output_shape(self, input_shape):
        return _scaled_shape(input_shape,
                             _spatial_axes(self.data_format, self.rank),
                             self.size)

    def get_config(self):
        cfg = super().get_config()
        cfg["size"] = list(self.size)
        cfg["dim_ordering"] = self.data_format
        return cfg


@register_layer
class UpSampling2D(_UpSamplingND):
    """Repeat each row and column ``size`` (rows, cols) times."""

    rank = 2

    def __init__(self, size=(2, 2), dim_ordering=None, input_shape=None,
                 name=None):
        super().__init__(size, dim_ordering=dim_ordering,
                         input_shape=input_shape, name=name)


@register_layer
class UpSampling3D(_UpSamplingND):
    """Repeat each element of the three spatial axes ``size`` times."""

    rank = 3

    def __init__(self, size=(2, 2, 2), dim_ordering=None, input_shape=None,
                 name=None):
        super().__init__(size, dim_ordering=dim_ordering,
                         input_shape=input_shape, name=name)


@register_layer
class ResizeBilinear(_PadCropBase):
    """Bilinear resize to (output_height, output_width), as
    ``jax.image.resize(..., "bilinear")`` computes it in the JAX package:
    half-pixel centres, and a triangle filter widened by the scale
    (antialiasing) along an axis that shrinks.  That is
    ``F.interpolate(mode="bilinear", align_corners=False)``, with
    ``antialias=True`` where an axis shrinks (along an axis that grows
    the two filters are the same).  ``align_corners`` is stored and, as
    in the JAX package, not acted on."""

    def __init__(self, output_height=None, output_width=None,
                 align_corners=False, dim_ordering=None, input_shape=None,
                 name=None):
        super().__init__(dim_ordering=dim_ordering, input_shape=input_shape,
                         name=name)
        self.output_height = int(output_height)
        self.output_width = int(output_width)
        self.align_corners = align_corners

    def forward(self, x):
        x_cf = (channels_first_view(x, 2)
                if self.data_format == "channels_last" else x)
        size = (self.output_height, self.output_width)
        shrinks = size[0] < x_cf.shape[2] or size[1] < x_cf.shape[3]
        y = F.interpolate(x_cf, size=size, mode="bilinear",
                          align_corners=False, antialias=shrinks)
        return y.permute(0, 2, 3, 1) if self.data_format == \
            "channels_last" else y

    def compute_output_shape(self, input_shape):
        if self.data_format == "channels_last":
            return (input_shape[0], self.output_height, self.output_width,
                    input_shape[3])
        return (input_shape[0], input_shape[1], self.output_height,
                self.output_width)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(output_height=self.output_height,
                   output_width=self.output_width,
                   align_corners=self.align_corners,
                   dim_ordering=self.data_format)
        return cfg
