"""Normalization layers: BatchNormalization, LayerNorm and the two local
response normalizations.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
normalization.py``.

BatchNormalization keeps its moving statistics and their update count as
layer state (buffers ``moving_mean``, ``moving_var``, ``count``, f32 at
any compute dtype).  While the Trainer's plan splits the batch over the
data axes, the training statistics are the global batch's
(``parallel.mesh.batch_group``), so every rank's state is the same.  In training mode it normalizes with the batch
statistics of :func:`~analytics_zoo_tpu_torch.ops.batchnorm.
batch_norm_train` (closed-form backward) and updates the state in place:
``moving = momentum*moving + (1-momentum)*batch`` with the biased
variance, ``count += 1``.  In eval mode it normalizes with the moving
statistics debiased against their (0, 1) init, as the JAX package does:
``count = 0`` gives the init, ``count = inf`` (imported statistics)
passes them through exactly.  The debias is taken in f64 and rounded
once to f32, so the card and the CPU give the same bits (f32 ``pow``
differs between them in the last bit).

LayerNorm: the population variance (``jnp.var``), ``eps`` inside the
square root; the width of ``gamma`` and ``beta`` is the last axis of the
input shape.

LRN2D normalizes across channels, ``x / (k + alpha/n * sum)**beta`` over a
window of ``n`` channels zero-padded by ``n // 2`` on each side;
WithinChannelLRN2D within each channel over a ``size`` x ``size``
spatial window, ``SAME``-padded, whose mean of squares divides by the
count of real positions in the window, as the JAX package's does."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .....core import shapes as shape_utils
from .....core.module import Layer, register_layer
from .....ops import batchnorm as bn_ops
from .....parallel.mesh import batch_group
from .convolutional import channels_first_view, pad_spatial
from .pooling import same_window_counts, window_sums


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
                                   ch_axis, group=batch_group())
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
        taken out: ``ema_t = m^t*init + (1 - m^t)*avg``, in f64 from the
        f32 momentum the JAX package's ``jnp.power`` takes, rounded once
        to f32."""
        cnt = self.count.double()
        decay = torch.pow(float(np.float32(self.momentum)), cnt)
        denom = torch.clamp_min(1.0 - decay, 1e-12)
        seen = cnt > 0
        mean = torch.where(seen, self.moving_mean.double() / denom, 0.0)
        var = torch.where(seen, (self.moving_var.double() - decay) / denom,
                          1.0)
        return mean.float(), var.float()

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


@register_layer
class WithinChannelLRN2D(Layer):
    """Local response normalization within each channel of an NHWC
    input: ``x / (1 + alpha * mean(x**2))**beta`` over the ``size`` x
    ``size`` window around each position."""

    def __init__(self, size=5, alpha=1.0, beta=0.75, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.size = int(size)
        self.alpha = float(alpha)
        self.beta = float(beta)

    def forward(self, x):
        window = (self.size, self.size)
        pads = [shape_utils.same_padding(n, self.size, 1)
                for n in x.shape[1:3]]
        summed = window_sums(channels_first_view(
            pad_spatial(torch.square(x), pads), 2), window, (1, 1))
        counts = same_window_counts(x.shape[1:3], window, (1, 1), pads, x)
        scale = (1.0 + self.alpha * summed / counts) ** self.beta
        return x / scale.permute(0, 2, 3, 1)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(size=self.size, alpha=self.alpha, beta=self.beta)
        return cfg


@register_layer
class LRN2D(Layer):
    """Cross-channel local response normalization (AlexNet's)."""

    def __init__(self, alpha=1e-4, k=1.0, beta=0.75, n=5, dim_ordering=None,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.alpha, self.k, self.beta, self.n = (
            float(alpha), float(k), float(beta), int(n))
        self.data_format = shape_utils.normalize_data_format(dim_ordering)

    def forward(self, x):
        if self.data_format == "channels_first":
            x = x.movedim(1, -1)
        half, c = self.n // 2, x.shape[-1]
        padded = F.pad(torch.square(x), [half, half])
        # summed in the JAX package's order: ((0 + s_0) + s_1) + ...
        acc = sum(padded[..., i:i + c] for i in range(self.n))
        y = x / (self.k + self.alpha / self.n * acc) ** self.beta
        return y.movedim(-1, 1) if self.data_format == "channels_first" \
            else y

    def get_config(self):
        cfg = super().get_config()
        cfg.update(alpha=self.alpha, k=self.k, beta=self.beta, n=self.n,
                   dim_ordering=self.data_format)
        return cfg
