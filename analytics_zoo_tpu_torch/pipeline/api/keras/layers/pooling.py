"""Pooling: the max and average pools in 1-D, 2-D and 3-D and the
global pools.

Counterpart of every class of
``analytics_zoo_tpu/pipeline/api/keras/layers/pooling.py``.  The input is
channels-last unless ``dim_ordering="th"``, as for the convolutions;
``border_mode="same"`` pads as XLA's ``SAME`` does (the odd element on
the high side, which can make the padding asymmetric).  Max pooling pads
with -inf, so a padded element never wins a window; average pooling
divides each window's sum by the number of real (unpadded) elements in
it, as the JAX package does, and by the window's size under ``valid``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .....core import shapes as shape_utils
from .....core.module import Layer, register_layer
from .convolutional import (channels_first_view, channels_last_shape,
                            from_channels_last, pad_spatial,
                            to_channels_last)

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def window_sums(x_cf, pool_size, strides):
    """Each window's sum over the spatial axes of a channels-first
    tensor (``avg_pool`` with divisor 1; 1-D as 2-D over a unit row,
    since ``avg_pool1d`` takes no divisor)."""
    if len(pool_size) == 1:
        return F.avg_pool2d(x_cf.unsqueeze(2), (1,) + tuple(pool_size),
                            (1,) + tuple(strides),
                            divisor_override=1).squeeze(2)
    return _AVG_POOL[len(pool_size)](x_cf, pool_size, strides,
                                     divisor_override=1)


def same_window_counts(spatial, pool_size, strides, pads, like):
    """(1, 1, out...) count of real elements in each window of a
    ``SAME``-padded input of ``spatial`` size."""
    ones = torch.ones((1, 1) + tuple(spatial), dtype=like.dtype,
                      device=like.device)
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    return window_sums(F.pad(ones, flat), pool_size, strides)


class _PoolND(Layer):
    rank = 2
    mode = "max"  # or "avg"

    def __init__(self, pool_size=2, strides=None, border_mode="valid",
                 dim_ordering=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"{type(self).__name__}: unsupported "
                             f"border_mode {border_mode!r}")
        self.pool_size = shape_utils.normalize_tuple(pool_size, self.rank)
        self.strides = (shape_utils.normalize_tuple(strides, self.rank)
                        if strides is not None else self.pool_size)
        self.border_mode = border_mode
        self.data_format = shape_utils.normalize_data_format(dim_ordering)

    def forward(self, x):
        r = self.rank
        x_cl = to_channels_last(x, self.data_format, r)
        pads = ([shape_utils.same_padding(n, k, s) for n, k, s in
                 zip(x_cl.shape[1:1 + r], self.pool_size, self.strides)]
                if self.border_mode == "same" else [(0, 0)] * r)
        if self.mode == "max":
            y = _MAX_POOL[r](channels_first_view(
                pad_spatial(x_cl, pads, value=-math.inf), r),
                self.pool_size, self.strides)
        elif not any(lo or hi for lo, hi in pads):
            y = _AVG_POOL[r](channels_first_view(x_cl, r), self.pool_size,
                             self.strides)
        else:
            # window sums over the zero-padded input, over the windows'
            # counts of real elements (a ones plane padded alike)
            sums = window_sums(
                channels_first_view(pad_spatial(x_cl, pads), r),
                self.pool_size, self.strides)
            y = sums / same_window_counts(x_cl.shape[1:1 + r],
                                          self.pool_size, self.strides,
                                          pads, x_cl)
        y = y.permute((0,) + tuple(range(2, 2 + r)) + (1,))
        return from_channels_last(y, self.data_format, r)

    def compute_output_shape(self, input_shape):
        cl = channels_last_shape(input_shape, self.data_format)
        spatial = [
            shape_utils.pool_output_length(
                cl[1 + i], self.pool_size[i], self.border_mode,
                self.strides[i]) for i in range(self.rank)]
        out = (cl[0],) + tuple(spatial) + (cl[-1],)
        if self.data_format == "channels_first":
            return (out[0], out[-1]) + tuple(out[1:-1])
        return out

    def get_config(self):
        cfg = super().get_config()
        cfg.update(pool_size=list(self.pool_size), strides=list(self.strides),
                   border_mode=self.border_mode,
                   dim_ordering=self.data_format)
        return cfg


class _Pool1D(_PoolND):
    """1-D pools take the reference's Keras-1 names (``pool_length``,
    ``stride``) and no ``dim_ordering``."""

    rank = 1

    def __init__(self, pool_length=2, stride=None, border_mode="valid",
                 input_shape=None, name=None):
        super().__init__(pool_size=pool_length, strides=stride,
                         border_mode=border_mode, input_shape=input_shape,
                         name=name)

    def get_config(self):
        cfg = Layer.get_config(self)
        cfg.update(pool_length=self.pool_size[0], stride=self.strides[0],
                   border_mode=self.border_mode)
        return cfg


@register_layer
class MaxPooling1D(_Pool1D):
    mode = "max"


@register_layer
class AveragePooling1D(_Pool1D):
    mode = "avg"


@register_layer
class MaxPooling2D(_PoolND):
    rank, mode = 2, "max"


@register_layer
class AveragePooling2D(_PoolND):
    rank, mode = 2, "avg"


class _Pool3D(_PoolND):
    rank = 3

    def __init__(self, pool_size=(2, 2, 2), strides=None, border_mode="valid",
                 dim_ordering=None, input_shape=None, name=None):
        super().__init__(pool_size=pool_size, strides=strides,
                         border_mode=border_mode, dim_ordering=dim_ordering,
                         input_shape=input_shape, name=name)


@register_layer
class MaxPooling3D(_Pool3D):
    mode = "max"


@register_layer
class AveragePooling3D(_Pool3D):
    mode = "avg"


class _GlobalPoolND(Layer):
    """Max or mean over every spatial axis: (batch, ..., channels) ->
    (batch, channels)."""

    rank = 2
    mode = "max"

    def __init__(self, dim_ordering=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.data_format = shape_utils.normalize_data_format(dim_ordering)

    def forward(self, x):
        first = 1 if self.data_format == "channels_last" else 2
        axes = tuple(range(first, first + self.rank))
        if self.mode == "max":
            return torch.amax(x, dim=axes)
        return torch.mean(x, dim=axes)

    def compute_output_shape(self, input_shape):
        ch = (input_shape[-1] if self.data_format == "channels_last"
              else input_shape[1])
        return (input_shape[0], ch)

    def get_config(self):
        cfg = super().get_config()
        cfg["dim_ordering"] = self.data_format
        return cfg


@register_layer
class GlobalMaxPooling1D(_GlobalPoolND):
    rank, mode = 1, "max"


@register_layer
class GlobalAveragePooling1D(_GlobalPoolND):
    rank, mode = 1, "avg"


@register_layer
class GlobalMaxPooling2D(_GlobalPoolND):
    rank, mode = 2, "max"


@register_layer
class GlobalAveragePooling2D(_GlobalPoolND):
    rank, mode = 2, "avg"


@register_layer
class GlobalMaxPooling3D(_GlobalPoolND):
    rank, mode = 3, "max"


@register_layer
class GlobalAveragePooling3D(_GlobalPoolND):
    rank, mode = 3, "avg"
