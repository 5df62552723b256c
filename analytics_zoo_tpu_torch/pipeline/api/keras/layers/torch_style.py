"""Torch-style Keras-1 layers: elementwise math, thresholds, learned
scales and biases, the VAE's GaussianSampler, KerasLayerWrapper, and
tensor surgery (Narrow, Select, Squeeze).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
torch_style.py``, every class of it.  Dims follow the reference: ``dim``/
``dims`` are 0-based over the full shape, batch axis included; the batch
axis may not be narrowed, selected or squeezed; for Narrow and Select
-1 is the last axis, while Squeeze takes positive dims only.  Mul
(``w``, a scalar), CAdd (``b``), CMul (``w``) and Scale (``w``, ``b``)
keep the JAX package's parameter names and shapes (``size`` includes the
batch axis, typically 1 there).  HardTanh clips as ``jnp.clip`` does (a
tie with a bound takes half the gradient).  RReLU and GaussianSampler
draw from their own generator in training (``RandomLayer``); in eval
mode RReLU's slope is ``(lower + upper) / 2`` and GaussianSampler returns
the mean.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from .....core import initializers
from .....core.module import Layer, RandomLayer, register_layer
from .. import activations


class _Elementwise(Layer):
    """Shared base of the elementwise layers: the output shape is the
    input's."""

    needs_input_shape = False

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


@register_layer
class AddConstant(_Elementwise):
    """``x + constant``."""

    def __init__(self, constant, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.constant = float(constant)

    def forward(self, x):
        return x + self.constant

    def get_config(self):
        cfg = super().get_config()
        cfg["constant"] = self.constant
        return cfg


@register_layer
class MulConstant(_Elementwise):
    """``x * constant``."""

    def __init__(self, constant, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.constant = float(constant)

    def forward(self, x):
        return x * self.constant

    def get_config(self):
        cfg = super().get_config()
        cfg["constant"] = self.constant
        return cfg


@register_layer
class BinaryThreshold(_Elementwise):
    """1 where ``x > value``, else 0 (no gradient)."""

    def __init__(self, value=1e-6, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.value = float(value)

    def forward(self, x):
        return (x > self.value).to(x.dtype)

    def get_config(self):
        cfg = super().get_config()
        cfg["value"] = self.value
        return cfg


@register_layer
class Threshold(_Elementwise):
    """``x`` where ``x > th``, else ``v``."""

    def __init__(self, th=1e-6, v=0.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.th = float(th)
        self.v = float(v)

    def forward(self, x):
        return torch.where(x > self.th, x, self.v)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(th=self.th, v=self.v)
        return cfg


@register_layer
class HardShrink(_Elementwise):
    """``x`` where ``|x| > value``, else 0."""

    def __init__(self, value=0.5, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.value = float(value)

    def forward(self, x):
        return torch.where(torch.abs(x) > self.value, x, 0.0)

    def get_config(self):
        cfg = super().get_config()
        cfg["value"] = self.value
        return cfg


@register_layer
class SoftShrink(_Elementwise):
    """``x`` moved ``value`` towards 0, and 0 inside the band."""

    def __init__(self, value=0.5, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.value = float(value)

    def forward(self, x):
        return torch.where(
            x > self.value, x - self.value,
            torch.where(x < -self.value, x + self.value, 0.0))

    def get_config(self):
        cfg = super().get_config()
        cfg["value"] = self.value
        return cfg


@register_layer
class HardTanh(_Elementwise):
    """``x`` clipped to [min_value, max_value]."""

    def __init__(self, min_value=-1.0, max_value=1.0, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        if max_value <= min_value:
            raise ValueError("max_value must be > min_value")
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def forward(self, x):
        return activations.clip(x, self.min_value, self.max_value)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(min_value=self.min_value, max_value=self.max_value)
        return cfg


@register_layer
class RReLU(RandomLayer, _Elementwise):
    """Leaky ReLU whose negative slope is drawn from U[lower, upper] for
    each element in training, and is ``(lower + upper) / 2`` in eval
    mode."""

    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, input_shape=None,
                 name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.lower = float(lower)
        self.upper = float(upper)
        self._build_if_ready()

    def forward(self, x):
        if self.training:
            u = torch.rand(x.shape, generator=self.generator,
                           device=x.device, dtype=x.dtype)
            slope = u * (self.upper - self.lower) + self.lower
        else:
            slope = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, x * slope)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(lower=self.lower, upper=self.upper)
        return cfg


@register_layer
class Exp(_Elementwise):
    def forward(self, x):
        return torch.exp(x)


@register_layer
class Log(_Elementwise):
    def forward(self, x):
        return torch.log(x)


@register_layer
class Sqrt(_Elementwise):
    def forward(self, x):
        return torch.sqrt(x)


@register_layer
class Square(_Elementwise):
    def forward(self, x):
        return torch.square(x)


@register_layer
class Negative(_Elementwise):
    def forward(self, x):
        return -x


@register_layer
class Identity(_Elementwise):
    def forward(self, x):
        return x


@register_layer
class Power(_Elementwise):
    """``(shift + scale * x) ** power``."""

    def __init__(self, power, scale=1.0, shift=0.0, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.power = float(power)
        self.scale = float(scale)
        self.shift = float(shift)

    def forward(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(power=self.power, scale=self.scale, shift=self.shift)
        return cfg


class _Learned(_Elementwise):
    """An elementwise layer with learned tensors of a fixed shape: it
    builds at construction on ``device`` (or ``generator``'s device)."""

    #: (name, init value) of each parameter
    learned = ()

    def __init__(self, input_shape=None, name=None, trainable=True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)

    def _shape(self):
        return ()

    def build_params(self, input_shape, generator):
        for pname, value in self.learned:
            self.add_param(pname, initializers.constant(value), self._shape(),
                           generator)


@register_layer
class Mul(_Learned):
    """``x * w``, ``w`` a learned scalar (1 at init)."""

    learned = (("w", 1.0),)

    def __init__(self, input_shape=None, name=None, trainable=True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self._build_if_ready()

    def forward(self, x):
        return x * self.w


class _Sized(_Learned):
    def _shape(self):
        return self.size

    def get_config(self):
        cfg = super().get_config()
        cfg["size"] = list(self.size)
        return cfg


@register_layer
class CAdd(_Sized):
    """``x + b``, ``b`` of shape ``size`` (0 at init), broadcast.
    ``b_regularizer`` is stored and, as in the JAX package, not
    applied."""

    learned = (("b", 0.0),)

    def __init__(self, size, b_regularizer=None, input_shape=None, name=None,
                 trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self.size = tuple(int(s) for s in size)
        self.b_regularizer = b_regularizer
        self._build_if_ready()

    def forward(self, x):
        return x + self.b


@register_layer
class CMul(_Sized):
    """``x * w``, ``w`` of shape ``size`` (1 at init), broadcast.
    ``w_regularizer`` is stored and, as in the JAX package, not
    applied."""

    learned = (("w", 1.0),)

    def __init__(self, size, w_regularizer=None, input_shape=None, name=None,
                 trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self.size = tuple(int(s) for s in size)
        self.w_regularizer = w_regularizer
        self._build_if_ready()

    def forward(self, x):
        return x * self.w


@register_layer
class Scale(_Sized):
    """``x * w + b`` (CMul, then CAdd) with ``w``, ``b`` of shape
    ``size``."""

    learned = (("w", 1.0), ("b", 0.0))

    def __init__(self, size, input_shape=None, name=None, trainable=True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self.size = tuple(int(s) for s in size)
        self._build_if_ready()

    def forward(self, x):
        return x * self.w + self.b


@register_layer
class GaussianSampler(RandomLayer):
    """The VAE's reparameterization: from inputs ``[mean, log_var]``,
    ``mean + exp(log_var / 2) * eps`` with ``eps ~ N(0, 1)`` in training
    (:meth:`draw`), the mean in eval mode."""

    def __init__(self, input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self._build_if_ready()

    def draw(self, like):
        """N(0, 1) noise of ``like``'s shape, dtype and device."""
        return torch.randn(like.shape, generator=self.generator,
                           dtype=like.dtype, device=like.device)

    def forward(self, inputs):
        mean, log_var = inputs
        if not self.training:
            return mean
        return mean + torch.exp(log_var * 0.5) * self.draw(mean)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[0])


@register_layer
class KerasLayerWrapper(Layer):
    """Any torch callable as a layer.  An ``nn.Module`` is a child of the
    layer: its parameters are the layer's, and move to the model's
    device when the model builds it.  Without ``output_shape`` the
    output shape comes from one call on ``device="meta"`` tensors (a
    module runs as a meta copy).  The layer cannot be saved by config,
    as in the JAX package."""

    needs_input_shape = False

    def __init__(self, fn, output_shape=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.fn = fn
        self._output_shape = output_shape

    def build_params(self, input_shape, generator):
        if isinstance(self.fn, nn.Module):
            self.fn.to(generator.device)

    def params(self):
        return (dict(self.fn.named_parameters())
                if isinstance(self.fn, nn.Module) else {})

    def forward(self, x):
        return self.fn(x)

    def compute_output_shape(self, input_shape):
        if self._output_shape is not None:
            return (input_shape[0],) + tuple(self._output_shape)
        # a graph shape's batch dim is None: probe with 1, then restore it
        concrete = tuple(1 if s is None else s for s in input_shape)
        fn = (copy.deepcopy(self.fn).to("meta")
              if isinstance(self.fn, nn.Module) else self.fn)
        out = tuple(fn(torch.empty(concrete, device="meta")).shape)
        if input_shape[0] is None:
            out = (None,) + out[1:]
        return out

    def get_config(self):
        raise NotImplementedError(
            "KerasLayerWrapper wraps an arbitrary python callable and "
            "cannot be config-serialized; save weights instead")


def _positive_dim(dim, ndim, layer):
    positive = dim + ndim if dim < 0 else dim
    if not 0 <= positive < ndim:
        raise ValueError(f"{layer}: invalid dim {dim} for {ndim}D input")
    if positive == 0:
        raise ValueError(f"{layer}: cannot touch the batch dimension")
    return positive


@register_layer
class Narrow(Layer):
    """``length`` elements from ``offset`` along ``dim`` (a negative
    length counts from the end)."""

    def __init__(self, dim, offset, length=1, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)
        self.offset = int(offset)
        self.length = int(length)

    def _resolve(self, full_shape):
        d = _positive_dim(self.dim, len(full_shape), "Narrow")
        size = full_shape[d]
        length = self.length
        if length < 0:
            length = length + size - self.offset + 1
        if not (0 <= self.offset and self.offset + length <= size):
            raise ValueError(
                f"Narrow: offset {self.offset} + length {length} out of "
                f"range for axis size {size}")
        return d, length

    def forward(self, x):
        d, length = self._resolve(tuple(x.shape))
        return x.narrow(d, self.offset, length)

    def compute_output_shape(self, input_shape):
        d, length = self._resolve(input_shape)
        out = list(input_shape)
        out[d] = length
        return tuple(out)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(dim=self.dim, offset=self.offset, length=self.length)
        return cfg


@register_layer
class Select(Layer):
    """Index ``index`` of axis ``dim``, the axis dropped."""

    def __init__(self, dim, index, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)
        self.index = int(index)

    def forward(self, x):
        d = _positive_dim(self.dim, x.ndim, "Select")
        idx = self.index + x.shape[d] if self.index < 0 else self.index
        return x.select(d, idx)

    def compute_output_shape(self, input_shape):
        d = _positive_dim(self.dim, len(input_shape), "Select")
        return tuple(s for i, s in enumerate(input_shape) if i != d)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(dim=self.dim, index=self.index)
        return cfg


@register_layer
class Squeeze(Layer):
    """Drop singleton axes: every non-batch one when ``dims`` is None."""

    def __init__(self, dims=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        if dims is not None and not hasattr(dims, "__len__"):
            dims = (dims,)
        self.dims = tuple(int(d) for d in dims) if dims is not None else None
        if self.dims is not None and any(d <= 0 for d in self.dims):
            raise ValueError(
                "Squeeze dims must be positive (0 is the batch axis)")

    def _axes(self, full_shape):
        if self.dims is None:
            return tuple(i for i, s in enumerate(full_shape)
                         if i > 0 and s == 1)
        for d in self.dims:
            if full_shape[d] != 1:
                raise ValueError(
                    f"Squeeze: axis {d} has size {full_shape[d]} != 1")
        return self.dims

    def forward(self, x):
        return torch.squeeze(x, dim=self._axes(tuple(x.shape)))

    def compute_output_shape(self, input_shape):
        axes = set(self._axes(tuple(input_shape)))
        return tuple(s for i, s in enumerate(input_shape) if i not in axes)

    def get_config(self):
        cfg = super().get_config()
        cfg["dims"] = list(self.dims) if self.dims is not None else None
        return cfg
