"""Keras-2 argument names over the Keras-1 layers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras2/layers.py``:
``Dense(units=...)``, ``Conv1D``/``Conv2D`` (``filters``,
``kernel_size``, ``strides``, ``padding``), ``Dropout(rate=...)``,
``Cropping1D``, ``LocallyConnected1D``, the 1-D pools (``pool_size``,
``strides``, ``padding``) and the ``Maximum``/``Minimum``/``Average``
merges with their functional helpers.  Each class subclasses its
Keras-1 layer and writes its config in Keras-2 words; ``serial_name``
keeps its registry entry apart from the Keras-1 class of the same name.
"""

from __future__ import annotations

from typing import Optional

import torch

from ....core.module import Layer as _BaseLayer, register_layer
from ..keras import regularizers as _reg
from ..keras.layers import convolutional as k1conv
from ..keras.layers import core as k1core
from ..keras.layers import pooling as k1pool
from ..keras.layers.merge import Merge as _K1Merge
from ..keras.layers.pooling import (  # the same in both APIs
    GlobalMaxPooling1D, GlobalMaxPooling2D, GlobalMaxPooling3D,
    GlobalAveragePooling1D, GlobalAveragePooling2D, GlobalAveragePooling3D)

Activation = k1core.Activation  # the same signature in both APIs
Flatten = k1core.Flatten


@register_layer
class Dense(k1core.Dense):
    serial_name = "Keras2Dense"

    def __init__(self, units, activation=None,
                 kernel_initializer="glorot_uniform", use_bias=True,
                 kernel_regularizer=None, bias_regularizer=None,
                 input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(output_dim=units, init=kernel_initializer,
                         activation=activation, bias=use_bias,
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer,
                         input_shape=input_shape, name=name, device=device,
                         generator=generator)

    def get_config(self):
        cfg = _BaseLayer.get_config(self)
        cfg.update(units=self.output_dim, activation=self.activation_name,
                   kernel_initializer=self.init_name, use_bias=self.bias,
                   kernel_regularizer=_reg.to_config(self.W_regularizer),
                   bias_regularizer=_reg.to_config(self.b_regularizer))
        return cfg


@register_layer
class Dropout(k1core.Dropout):
    serial_name = "Keras2Dropout"

    def __init__(self, rate, input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(p=rate, input_shape=input_shape, name=name,
                         device=device, generator=generator)

    def get_config(self):
        cfg = _BaseLayer.get_config(self)
        cfg["rate"] = self.p
        return cfg


@register_layer
class Conv1D(k1conv.Convolution1D):
    serial_name = "Keras2Conv1D"

    def __init__(self, filters, kernel_size, strides=1, padding="valid",
                 activation=None, use_bias=True,
                 kernel_initializer="glorot_uniform",
                 kernel_regularizer=None, bias_regularizer=None,
                 input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(nb_filter=filters, filter_length=kernel_size,
                         init=kernel_initializer, activation=activation,
                         border_mode=padding, subsample=strides,
                         bias=use_bias, W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer,
                         input_shape=input_shape, name=name, device=device,
                         generator=generator)

    def get_config(self):
        cfg = _BaseLayer.get_config(self)
        cfg.update(filters=self.nb_filter, kernel_size=self.kernel_size[0],
                   strides=self.subsample[0], padding=self.border_mode,
                   activation=self.activation_name, use_bias=self.bias,
                   kernel_initializer=self.init_name,
                   kernel_regularizer=_reg.to_config(self.W_regularizer),
                   bias_regularizer=_reg.to_config(self.b_regularizer))
        return cfg


@register_layer
class Conv2D(k1conv.Convolution2D):
    serial_name = "Keras2Conv2D"

    def __init__(self, filters, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, use_bias=True,
                 kernel_initializer="glorot_uniform",
                 kernel_regularizer=None, bias_regularizer=None,
                 data_format=None, input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(nb_filter=filters, kernel_size=kernel_size,
                         init=kernel_initializer, activation=activation,
                         border_mode=padding, subsample=strides,
                         dim_ordering=data_format, bias=use_bias,
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer,
                         input_shape=input_shape, name=name, device=device,
                         generator=generator)

    def get_config(self):
        cfg = _BaseLayer.get_config(self)
        cfg.update(filters=self.nb_filter,
                   kernel_size=list(self.kernel_size),
                   strides=list(self.subsample), padding=self.border_mode,
                   activation=self.activation_name, use_bias=self.bias,
                   kernel_initializer=self.init_name,
                   data_format=self.data_format,
                   kernel_regularizer=_reg.to_config(self.W_regularizer),
                   bias_regularizer=_reg.to_config(self.b_regularizer))
        return cfg


@register_layer
class Cropping1D(k1conv.Cropping1D):
    serial_name = "Keras2Cropping1D"


@register_layer
class LocallyConnected1D(k1conv.LocallyConnected1D):
    serial_name = "Keras2LocallyConnected1D"

    def __init__(self, filters, kernel_size, strides=1, padding="valid",
                 activation=None, use_bias=True, kernel_regularizer=None,
                 bias_regularizer=None, input_shape=None, name=None,
                 device=None, generator: Optional[torch.Generator] = None):
        # the regularizers are accepted and, as in the JAX package, not
        # applied
        super().__init__(nb_filter=filters, filter_length=kernel_size,
                         activation=activation, border_mode=padding,
                         subsample_length=strides, bias=use_bias,
                         input_shape=input_shape, name=name, device=device,
                         generator=generator)

    def get_config(self):
        cfg = _BaseLayer.get_config(self)
        cfg.update(filters=self.nb_filter, kernel_size=self.filter_length,
                   strides=self.subsample, padding=self.border_mode,
                   activation=self.activation_name, use_bias=self.bias)
        return cfg


class _Pool1D:
    """Keras-2 names of a 1-D pool's config."""

    def get_config(self):
        cfg = _BaseLayer.get_config(self)
        cfg.update(pool_size=self.pool_size[0], strides=self.strides[0],
                   padding=self.border_mode)
        return cfg


@register_layer
class MaxPooling1D(_Pool1D, k1pool.MaxPooling1D):
    serial_name = "Keras2MaxPooling1D"

    def __init__(self, pool_size=2, strides=None, padding="valid",
                 input_shape=None, name=None):
        super().__init__(pool_length=pool_size, stride=strides,
                         border_mode=padding, input_shape=input_shape,
                         name=name)


@register_layer
class AveragePooling1D(_Pool1D, k1pool.AveragePooling1D):
    serial_name = "Keras2AveragePooling1D"

    def __init__(self, pool_size=2, strides=None, padding="valid",
                 input_shape=None, name=None):
        super().__init__(pool_length=pool_size, stride=strides,
                         border_mode=padding, input_shape=input_shape,
                         name=name)


class _FixedMerge(_K1Merge):
    """Merge with its mode fixed by the class."""

    merge_mode: str = None

    def __init__(self, input_shape=None, name=None):
        super().__init__(layers=None, mode=self.merge_mode,
                         input_shape=input_shape, name=name)

    def get_config(self):
        return _BaseLayer.get_config(self)


@register_layer
class Maximum(_FixedMerge):
    serial_name = "Keras2Maximum"
    merge_mode = "max"


@register_layer
class Minimum(_FixedMerge):
    serial_name = "Keras2Minimum"
    merge_mode = "min"


@register_layer
class Average(_FixedMerge):
    serial_name = "Keras2Average"
    merge_mode = "ave"


def maximum(inputs, **kwargs):
    return Maximum(**kwargs)(list(inputs))


def minimum(inputs, **kwargs):
    return Minimum(**kwargs)(list(inputs))


def average(inputs, **kwargs):
    return Average(**kwargs)(list(inputs))
