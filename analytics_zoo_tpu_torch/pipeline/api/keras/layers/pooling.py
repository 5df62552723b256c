"""Max pooling: MaxPooling2D.

Counterpart of ``_PoolND`` and ``MaxPooling2D`` in
``analytics_zoo_tpu/pipeline/api/keras/layers/pooling.py``.  The input is
channels-last unless ``dim_ordering="th"``, as for the convolutions;
``border_mode="same"`` pads as XLA's ``SAME`` does, with -inf, so a
padded element never wins a window.  The other pooling layers are not
ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import math

import torch.nn.functional as F

from .....core import shapes as shape_utils
from .....core.module import Layer, register_layer
from .convolutional import (channels_first_view, channels_last_shape,
                            from_channels_last, pad_spatial,
                            to_channels_last)

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d}


class _PoolND(Layer):
    rank = 2

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
        if self.border_mode == "same":
            x_cl = pad_spatial(x_cl, [
                shape_utils.same_padding(n, k, s) for n, k, s in
                zip(x_cl.shape[1:1 + r], self.pool_size, self.strides)],
                value=-math.inf)
        y = _MAX_POOL[r](channels_first_view(x_cl, r), self.pool_size,
                         self.strides)
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


@register_layer
class MaxPooling2D(_PoolND):
    rank = 2
