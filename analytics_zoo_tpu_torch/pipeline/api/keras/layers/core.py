"""Core Keras-1 layers: Dense and SparseDense, Activation, Dropout and
the spatial dropouts, Flatten, Reshape, Permute, RepeatVector, Masking,
Highway, MaxoutDense and TimeDistributed.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``,
with the reference's signatures: widths come from the input shape.
Dense keeps the JAX package's (in, out) weight layout: ``y = x @ W + b``;
Highway (``W_h``, ``W_t``, ``b_h``, ``b_t``) and MaxoutDense (``W``
(nb_feature, in, out), ``b``) keep theirs too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .....core import initializers
from .....core import shapes as shape_utils
from .....core.module import (Layer, RandomLayer, get_layer_class, promote,
                              register_layer, remat_call,
                              serial_class_name)
from .. import activations
from ..regularizers import RegularizedLayerMixin


@register_layer
class Dense(RegularizedLayerMixin, Layer):
    """Fully connected layer ``y = act(x @ W + b)``, ``W`` (in, out); the
    input width is the last axis of the input shape.  The product
    promotes mixed dtypes as ``jnp`` does."""

    #: set by the sharded trainer while the layer computes on its
    #: tensor-axis block (``parallel/placement.py``), else None
    _tensor_split = None

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
        if self._tensor_split is not None:
            return self._tensor_split(self, x)
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
class SparseDense(Dense):
    """Dense over a dense input: the JAX package, like XLA, keeps no
    sparse layout, and neither does the port."""


@register_layer
class Dropout(RandomLayer):
    """Inverted dropout; identity at inference or when ``p == 0``.  The
    mask is drawn from the layer's own generator (``RandomLayer``)."""

    def __init__(self, p=0.5, input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.p = float(p)
        self._build_if_ready()

    def _mask_shape(self, x):
        return x.shape

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(self._mask_shape(x), generator=self.generator,
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


@register_layer
class SpatialDropout1D(Dropout):
    """Dropout of whole channels of (batch, steps, channels): one mask
    entry a sample and channel, the same at every step."""

    def _mask_shape(self, x):
        return (x.shape[0], 1, x.shape[2])


class _SpatialDropoutND(Dropout):
    rank = 2

    def __init__(self, p=0.5, dim_ordering=None, input_shape=None, name=None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(p=p, input_shape=input_shape, name=name,
                         device=device, generator=generator)
        self.data_format = shape_utils.normalize_data_format(dim_ordering)

    def _mask_shape(self, x):
        ones = (1,) * self.rank
        if self.data_format == "channels_last":
            return (x.shape[0],) + ones + (x.shape[-1],)
        return (x.shape[0], x.shape[1]) + ones


@register_layer
class SpatialDropout2D(_SpatialDropoutND):
    """Dropout of whole channels of a 4-D input."""

    rank = 2


@register_layer
class SpatialDropout3D(_SpatialDropoutND):
    """Dropout of whole channels of a 5-D input."""

    rank = 3


@register_layer
class Permute(Layer):
    """Permute the non-batch axes; ``dims`` counts them from 1, as
    Keras-1 does."""

    def __init__(self, dims=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dims = tuple(int(d) for d in dims)

    def forward(self, x):
        return x.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(input_shape[d] for d in self.dims)

    def get_config(self):
        cfg = super().get_config()
        cfg["dims"] = list(self.dims)
        return cfg


@register_layer
class RepeatVector(Layer):
    """(batch, features) -> (batch, n, features)."""

    def __init__(self, n=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.n = int(n)

    def forward(self, x):
        return x.unsqueeze(1).expand(-1, self.n, -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.n, input_shape[1])

    def get_config(self):
        cfg = super().get_config()
        cfg["n"] = self.n
        return cfg


@register_layer
class Masking(Layer):
    """Zero each position whose features (last axis) all equal
    ``mask_value``: a dense multiplicative mask, carrying no metadata,
    as in the JAX package."""

    def __init__(self, mask_value=0.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.mask_value = float(mask_value)

    def forward(self, x):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, 0.0)

    def get_config(self):
        cfg = super().get_config()
        cfg["mask_value"] = self.mask_value
        return cfg


@register_layer
class Highway(Layer):
    """``y = t * act(x @ W_h + b_h) + (1 - t) * x`` with the transform gate
    ``t = sigmoid(x @ W_t + b_t)``; ``b_t`` starts at -2 (carry at
    init)."""

    def __init__(self, activation="tanh", bias=True, input_shape=None,
                 name=None, trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self.activation_name = activation
        self.activation = activations.get(activation or "linear")
        self.bias = bias
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        d = int(input_shape[-1])
        self.add_param("W_h", "glorot_uniform", (d, d), generator)
        self.add_param("W_t", "glorot_uniform", (d, d), generator)
        if self.bias:
            self.add_param("b_h", "zeros", (d,), generator)
            self.add_param("b_t", initializers.constant(-2.0), (d,),
                           generator)

    def forward(self, x):
        x, w_h, w_t = promote(x, self.W_h, self.W_t)
        h = x @ w_h
        t = x @ w_t
        if self.bias:
            h = h + self.b_h
            t = t + self.b_t
        h = self.activation(h)
        t = torch.sigmoid(t)
        return t * h + (1.0 - t) * x

    def get_config(self):
        cfg = super().get_config()
        cfg.update(activation=self.activation_name, bias=self.bias)
        return cfg


@register_layer
class MaxoutDense(Layer):
    """The largest of ``nb_feature`` affine maps: ``W`` (nb_feature, in,
    out), ``b`` (nb_feature, out)."""

    def __init__(self, output_dim, nb_feature=4, bias=True, input_shape=None,
                 name=None, trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.bias = bias
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        d = int(input_shape[-1])
        self.add_param("W", "glorot_uniform",
                       (self.nb_feature, d, self.output_dim), generator)
        if self.bias:
            self.add_param("b", "zeros", (self.nb_feature, self.output_dim),
                           generator)

    def forward(self, x):
        x, w = promote(x, self.W)
        y = torch.einsum("bd,kdo->bko", x, w)
        if self.bias:
            y = y + self.b
        return torch.amax(y, dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.output_dim)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(output_dim=self.output_dim, nb_feature=self.nb_feature,
                   bias=self.bias)
        return cfg


@register_layer
class TimeDistributed(Layer):
    """``layer`` applied at every step of (batch, steps, ...), with time
    folded into the batch: one call of the inner layer.  Its parameters
    and state are the inner layer's, keyed as the JAX package keys them
    (no extra level); an inner BatchNormalization updates its statistics
    through it in training."""

    stateful = True

    def __init__(self, layer=None, input_shape=None, name=None,
                 trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self.layer = layer
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        self.layer.build((input_shape[0],) + tuple(input_shape[2:]),
                         generator)

    def params(self):
        return self.layer.params()

    def state(self):
        return self.layer.state()

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        out = remat_call(self.layer, x.reshape((b * t,) + tuple(x.shape[2:])))
        return out.reshape((b, t) + tuple(out.shape[1:]))

    def compute_output_shape(self, input_shape):
        inner_in = (input_shape[0],) + tuple(input_shape[2:])
        inner_out = self.layer.compute_output_shape(inner_in)
        return (input_shape[0], input_shape[1]) + tuple(inner_out[1:])

    def get_config(self):
        cfg = super().get_config()
        cfg["layer"] = {"class_name": serial_class_name(self.layer),
                        "config": self.layer.get_config()}
        return cfg

    @classmethod
    def from_config(cls, config):
        config = dict(config)
        inner = config.pop("layer")
        layer = get_layer_class(inner["class_name"]).from_config(
            inner["config"])
        return super().from_config(dict(config, layer=layer))
