"""Core Keras-1 layers: Dense, Activation, Dropout.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``.
Dense keeps the JAX package's (in, out) weight layout: ``y = x @ W + b``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .....core.module import Layer, make_generator, register_layer
from .. import activations


@register_layer
class Dense(Layer):
    """Fully connected layer ``y = act(x @ W + b)``, ``W`` (in, out)."""

    def __init__(self, input_dim: int, output_dim: int,
                 init="glorot_uniform", activation=None, bias: bool = True,
                 name: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        g = make_generator(device, generator)
        self.activation = activations.get(activation)
        self.bias = bias
        self.add_param("W", init, (int(input_dim), int(output_dim)), g)
        if bias:
            self.add_param("b", "zeros", (int(output_dim),), g)

    def forward(self, x):
        y = x @ self.W
        if self.bias:
            y = y + self.b
        if self.activation is not None:
            y = self.activation(y)
        return y


@register_layer
class Activation(Layer):
    def __init__(self, activation=None, name: Optional[str] = None):
        super().__init__(name)
        self.activation = activations.get(activation)

    def forward(self, x):
        return self.activation(x)


@register_layer
class Dropout(Layer):
    """Inverted dropout; identity at inference or when ``p == 0``.  The
    mask is drawn from the layer's own generator."""

    def __init__(self, p: float = 0.5, name: Optional[str] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.p = float(p)
        self.generator = make_generator(device, generator)

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)
