"""Normalization layers: BatchNormalization and LayerNorm.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
normalization.py``.

BatchNormalization keeps its moving statistics and their update count as
layer state (buffers ``moving_mean``, ``moving_var``, ``count``, f32 at
any compute dtype).  In training mode it normalizes with the batch
statistics of :func:`~analytics_zoo_tpu_torch.ops.batchnorm.
batch_norm_train` (closed-form backward) and updates the state in place:
``moving = momentum*moving + (1-momentum)*batch`` with the biased
variance, ``count += 1``.  In eval mode it normalizes with the moving
statistics debiased against their (0, 1) init, as the JAX package does:
``count = 0`` gives the init, ``count = inf`` (imported statistics)
passes them through exactly.

LayerNorm: the population variance (``jnp.var``), ``eps`` inside the
square root; the width of ``gamma`` and ``beta`` is the last axis of the
input shape."""

from __future__ import annotations

from typing import Optional

import torch

from .....core import shapes as shape_utils
from .....core.module import Layer, register_layer
from .....ops import batchnorm as bn_ops


@register_layer
class BatchNormalization(Layer):
    """The reference's signature; ``beta_init`` and ``gamma_init`` are
    accepted and, as in the JAX package, the parameters start at zeros
    and ones."""

    stateful = True

    def __init__(self, epsilon=1e-3, momentum=0.99, beta_init="zero",
                 gamma_init="one", dim_ordering=None, input_shape=None,
                 name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.data_format = shape_utils.normalize_data_format(dim_ordering)
        self._build_if_ready()

    def _channel_axis(self, ndim: int) -> int:
        return (1 if self.data_format == "channels_first" and ndim > 2
                else ndim - 1)

    def build_params(self, input_shape, generator):
        n = int(input_shape[self._channel_axis(len(input_shape))])
        self.add_param("gamma", "ones", (n,), generator)
        self.add_param("beta", "zeros", (n,), generator)
        dev = generator.device
        self.add_state("moving_mean", torch.zeros((n,), device=dev))
        self.add_state("moving_var", torch.ones((n,), device=dev))
        self.add_state("count", torch.zeros((), device=dev))

    def forward(self, x):
        ch_axis = self._channel_axis(x.ndim)
        if self.training:
            bn_fn = (bn_ops.batch_norm_train_naive if bn_ops.USE_NAIVE
                     else bn_ops.batch_norm_train)
            out, mean, var = bn_fn(x, self.gamma, self.beta, self.epsilon,
                                   ch_axis)
            m = self.momentum
            with torch.no_grad():
                self.moving_mean.copy_(m * self.moving_mean + (1 - m) * mean)
                self.moving_var.copy_(m * self.moving_var + (1 - m) * var)
                self.count.add_(1.0)
            return out
        mean, var = self.debiased_statistics()
        return bn_ops.batch_norm_inference(x, self.gamma, self.beta, mean,
                                           var, self.epsilon, ch_axis)

    def debiased_statistics(self):
        """The moving statistics with the EMA's weight on its (0, 1) init
        taken out: ``ema_t = m^t*init + (1 - m^t)*avg``."""
        cnt = self.count
        decay = torch.pow(self.momentum, cnt)
        denom = torch.clamp_min(1.0 - decay, 1e-12)
        seen = cnt > 0
        mean = torch.where(seen, self.moving_mean / denom, 0.0)
        var = torch.where(seen, (self.moving_var - decay) / denom, 1.0)
        return mean, var

    def get_config(self):
        cfg = super().get_config()
        cfg.update(epsilon=self.epsilon, momentum=self.momentum,
                   dim_ordering=self.data_format)
        return cfg


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
