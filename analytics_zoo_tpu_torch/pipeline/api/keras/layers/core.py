"""Core Keras-1 layers: Dense, Activation, Dropout, Flatten, Reshape.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``,
with the reference's signatures: widths come from the input shape.
Dense keeps the JAX package's (in, out) weight layout: ``y = x @ W + b``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .....core.module import Layer, promote, register_layer
from .. import activations
from ..regularizers import RegularizedLayerMixin


@register_layer
class Dense(RegularizedLayerMixin, Layer):
    """Fully connected layer ``y = act(x @ W + b)``, ``W`` (in, out); the
    input width is the last axis of the input shape.  The product
    promotes mixed dtypes as ``jnp`` does."""

    def __init__(self, output_dim, init="glorot_uniform", activation=None,
                 W_regularizer=None, b_regularizer=None, bias=True,
                 input_dim=None, input_shape=None, name=None,
                 trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        if input_dim is not None and input_shape is None:
            input_shape = (input_dim,)
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self._setup_regularizers(W_regularizer, b_regularizer)
        self.output_dim = int(output_dim)
        self.init_name = init
        self.activation_name = activation if not callable(activation) else None
        self.activation = activations.get(activation)
        self.bias = bias
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        self.add_param("W", self.init_name,
                       (int(input_shape[-1]), self.output_dim), generator)
        if self.bias:
            self.add_param("b", "zeros", (self.output_dim,), generator)

    def forward(self, x):
        self._add_penalty()
        x, w = promote(x, self.W)
        y = x @ w
        if self.bias:
            y = y + self.b
        if self.activation is not None:
            y = self.activation(y)
        return y

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(output_dim=self.output_dim, init=self.init_name,
                   activation=self.activation_name, bias=self.bias,
                   **self._regularizer_config())
        return cfg


@register_layer
class Activation(Layer):
    def __init__(self, activation=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.activation_name = activation
        self.activation = activations.get(activation)

    def forward(self, x):
        return self.activation(x)

    def get_config(self):
        cfg = super().get_config()
        cfg["activation"] = self.activation_name
        return cfg


@register_layer
class Dropout(Layer):
    """Inverted dropout; identity at inference or when ``p == 0``.  The
    mask is drawn from the layer's own generator: the ``generator`` given
    at construction, else one seeded from the generator that builds the
    layer."""

    needs_input_shape = False

    def __init__(self, p=0.5, input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.p = float(p)
        self.generator = generator
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        if self.generator is None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device))
            self.generator = torch.Generator(generator.device).manual_seed(
                seed)

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)

    def get_config(self):
        cfg = super().get_config()
        cfg["p"] = self.p
        return cfg


@register_layer
class Flatten(Layer):
    """Flatten all non-batch axes in their order: an NHWC input gives
    features in (h, w, c) order, as the JAX package's does."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def compute_output_shape(self, input_shape):
        dims = input_shape[1:]
        if any(d is None for d in dims):
            return (input_shape[0], None)
        return (input_shape[0], math.prod(dims))


@register_layer
class Reshape(Layer):
    """Reshape the non-batch axes to ``target_shape``; one entry may be
    -1.  The elements keep their logical (row-major, NHWC) order, as
    ``jnp.reshape`` keeps them, whatever the memory format of the input
    (a convolution's output is a permuted view)."""

    def __init__(self, target_shape=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.target_shape = tuple(int(d) for d in target_shape)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.target_shape)

    def compute_output_shape(self, input_shape):
        dims = input_shape[1:]
        tgt = list(self.target_shape)
        if -1 in tgt:
            known = math.prod(d for d in tgt if d != -1)
            total = (math.prod(dims) if all(d is not None for d in dims)
                     else None)
            tgt[tgt.index(-1)] = total // known if total else None
        return (input_shape[0],) + tuple(tgt)

    def get_config(self):
        cfg = super().get_config()
        cfg["target_shape"] = list(self.target_shape)
        return cfg
