"""Advanced activations: ELU, LeakyReLU, ThresholdedReLU, PReLU, SReLU.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
advanced_activations.py``.  Each branch point is a ``torch.where``, which
routes the gradient as ``jnp.where`` does: at a tie with the threshold
all of it goes to the branch the condition selects.  PReLU's ``alpha``
(one per channel, 0.25 at init) and SReLU's ``t_left``, ``a_left``,
``t_right``, ``a_right`` (one per channel, 0, 0, 1, 1 at init) keep the
JAX package's names and shapes."""

from __future__ import annotations

from typing import Optional

import torch

from .....core import initializers
from .....core.module import Layer, register_layer


@register_layer
class ELU(Layer):
    """``x`` where positive, else ``alpha * (exp(x) - 1)``."""

    def __init__(self, alpha=1.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.alpha = float(alpha)

    def forward(self, x):
        return torch.where(x > 0, x, self.alpha * (torch.exp(x) - 1.0))

    def get_config(self):
        cfg = super().get_config()
        cfg["alpha"] = self.alpha
        return cfg


@register_layer
class LeakyReLU(Layer):
    """``x`` where positive, else ``alpha * x``."""

    def __init__(self, alpha=0.3, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.alpha = float(alpha)

    def forward(self, x):
        return torch.where(x > 0, x, self.alpha * x)

    def get_config(self):
        cfg = super().get_config()
        cfg["alpha"] = self.alpha
        return cfg


@register_layer
class ThresholdedReLU(Layer):
    """``x`` where above ``theta``, else 0."""

    def __init__(self, theta=1.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.theta = float(theta)

    def forward(self, x):
        return torch.where(x > self.theta, x, 0.0)

    def get_config(self):
        cfg = super().get_config()
        cfg["theta"] = self.theta
        return cfg


@register_layer
class PReLU(Layer):
    """LeakyReLU with a learned slope ``alpha`` per channel (last
    axis)."""

    def __init__(self, input_shape=None, name=None, trainable=True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        self.add_param("alpha", initializers.constant(0.25),
                       (int(input_shape[-1]),), generator)

    def forward(self, x):
        return torch.where(x > 0, x, self.alpha * x)


@register_layer
class SReLU(Layer):
    """S-shaped ReLU: slope ``a_left`` below ``t_left``, 1 between, slope
    ``a_right`` above ``t_right``; the four learned per channel."""

    def __init__(self, input_shape=None, name=None, trainable=True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        n = (int(input_shape[-1]),)
        for pname, value in (("t_left", 0.0), ("a_left", 0.0),
                             ("t_right", 1.0), ("a_right", 1.0)):
            self.add_param(pname, initializers.constant(value), n, generator)

    def forward(self, x):
        tl, al, tr, ar = self.t_left, self.a_left, self.t_right, self.a_right
        y = torch.where(x < tl, tl + al * (x - tl), x)
        return torch.where(x > tr, tr + ar * (x - tr), y)
