"""LayerNorm over the feature axis.

Counterpart of ``LayerNorm`` in
``analytics_zoo_tpu/pipeline/api/keras/layers/normalization.py``: the
population variance (``jnp.var``), ``eps`` inside the square root."""

from __future__ import annotations

from typing import Optional

import torch

from .....core.module import Layer, make_generator, register_layer


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


@register_layer
class LayerNorm(Layer):
    def __init__(self, features: int, epsilon: float = 1e-5,
                 name: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.epsilon = float(epsilon)
        g = make_generator(device, generator)
        self.add_param("gamma", "ones", (int(features),), g)
        self.add_param("beta", "zeros", (int(features),), g)

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta, self.epsilon)
