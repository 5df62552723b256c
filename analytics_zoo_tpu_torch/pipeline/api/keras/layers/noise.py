"""Noise layers: GaussianNoise and GaussianDropout.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/noise.py``.
In training each draws from the layer's own ``torch.Generator``
(``RandomLayer``), so its stream is independent of the JAX package's
threefry keys; in eval mode both return the input exactly."""

from __future__ import annotations

from typing import Optional

import torch

from .....core.module import RandomLayer, register_layer


@register_layer
class GaussianNoise(RandomLayer):
    """``x + sigma * N(0, 1)`` in training."""

    def __init__(self, sigma=0.1, input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.sigma = float(sigma)
        self._build_if_ready()

    def forward(self, x):
        if not self.training:
            return x
        return x + self.sigma * torch.randn(
            x.shape, generator=self.generator, device=x.device,
            dtype=x.dtype)

    def get_config(self):
        cfg = super().get_config()
        cfg["sigma"] = self.sigma
        return cfg


@register_layer
class GaussianDropout(RandomLayer):
    """``x * (1 + sqrt(p / (1 - p)) * N(0, 1))`` in training."""

    def __init__(self, p=0.5, input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.p = float(p)
        self._build_if_ready()

    def forward(self, x):
        if not self.training or self.p <= 0:
            return x
        stddev = (self.p / (1.0 - self.p)) ** 0.5
        return x * (1.0 + stddev * torch.randn(
            x.shape, generator=self.generator, device=x.device,
            dtype=x.dtype))

    def get_config(self):
        cfg = super().get_config()
        cfg["p"] = self.p
        return cfg
