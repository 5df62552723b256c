"""LayerNorm over the feature axis.

Counterpart of ``LayerNorm`` in
``analytics_zoo_tpu/pipeline/api/keras/layers/normalization.py``: the
population variance (``jnp.var``), ``eps`` inside the square root; the
width of ``gamma`` and ``beta`` is the last axis of the input shape."""

from __future__ import annotations

from typing import Optional

import torch

from .....core.module import Layer, register_layer


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


@register_layer
class LayerNorm(Layer):
    def __init__(self, epsilon=1e-5, input_shape=None, name=None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.epsilon = float(epsilon)
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        n = int(input_shape[-1])
        self.add_param("gamma", "ones", (n,), generator)
        self.add_param("beta", "zeros", (n,), generator)

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta, self.epsilon)

    def get_config(self):
        cfg = super().get_config()
        cfg["epsilon"] = self.epsilon
        return cfg
