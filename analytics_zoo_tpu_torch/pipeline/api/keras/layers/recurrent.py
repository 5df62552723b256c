"""Recurrent layers: SimpleRNN, LSTM, GRU, ConvLSTM2D and Bidirectional.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
recurrent.py``, with the Keras-1 semantics of the reference
(``inner_activation`` defaults to ``hard_sigmoid``, ``return_sequences``,
``go_backwards``) and the JAX package's parameter layout: ``W`` (in,
gates*H) from ``init``, ``U`` (H, gates*H) from ``inner_init``, ``b``
(gates*H,); LSTM gates in the order [i, f, c, o], GRU in [z, r, h] with
the reset gate applied before the recurrent product, ``(r*h) @ U_h``
(Keras' ``reset_after=False``).  cuDNN's ``nn.LSTM``/``nn.GRU`` differ in
both the inner activation and the GRU form, so they cannot serve.

As in the JAX package, the input projection of every timestep is one
GEMM over (batch*time, in) before the loop, and only the recurrent
product stays in it.  The JAX package runs the loop as one ``lax.scan``;
here it is a Python loop of eager ops on the device (one GEMM and the
gates' elementwise ops a step) over ``unbind``'s views of the
projection, whose backward stacks the steps' gradients in one op (a
slice a step would scatter each into a zero tensor of the whole
projection).  The carry starts as f32 zeros, as ``jnp.zeros`` does, and
the products promote as ``jnp``'s do, so under a bf16 ``compute_dtype``
the recurrence runs in f32 as there (``U`` is cast once, before the
loop).

ConvLSTM2D takes and returns channels-last tensors, (batch, time, rows,
cols, channels), with HWIO kernels ``W`` (kh, kw, in, 4*filters) and
``U`` (kh, kw, filters, 4*filters); inside, the loop runs channels-first
for cuDNN, with the input convolution of every timestep hoisted into one
call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .....core import shapes as shape_utils
from .....core.module import (Layer, get_layer_class, promote,
                              register_layer, serial_class_name)
from .. import activations


def _at_carry_dtype(u):
    """A recurrent weight at the dtype of its product with the f32 carry
    (``jnp`` promotes a bf16 weight to f32 there)."""
    return u.to(torch.promote_types(u.dtype, torch.float32))


class _RecurrentBase(Layer):
    gate_count = 1

    def __init__(self, output_dim, activation="tanh",
                 inner_activation="hard_sigmoid", init="glorot_uniform",
                 inner_init="orthogonal", return_sequences=False,
                 go_backwards=False, input_shape=None, name=None,
                 trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self.output_dim = int(output_dim)
        self.activation_name = activation
        self.activation = activations.get(activation)
        self.inner_activation_name = inner_activation
        self.inner_activation = activations.get(inner_activation)
        self.init_name = init
        self.inner_init_name = inner_init
        self.return_sequences = bool(return_sequences)
        self.go_backwards = bool(go_backwards)
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        d, h, g = int(input_shape[-1]), self.output_dim, self.gate_count
        self.add_param("W", self.init_name, (d, g * h), generator)
        self.add_param("U", self.inner_init_name, (h, g * h), generator)
        self.add_param("b", "zeros", (g * h,), generator)

    def initial_carry(self, x):
        return x.new_zeros((x.shape[0], self.output_dim),
                           dtype=torch.float32)

    def recurrent_weights(self):
        """What :meth:`step` multiplies the carry by, made once a call."""
        return _at_carry_dtype(self.U)

    def step(self, u, carry, zt):
        """(recurrent weights, carry, this step's input projection) ->
        (carry, output)."""
        raise NotImplementedError

    def forward(self, x):
        if self.go_backwards:
            x = torch.flip(x, (1,))
        x, w, b = promote(x, self.W, self.b)
        z = x @ w + b  # (batch, time, gates*H): every step's projection
        u = self.recurrent_weights()
        carry = self.initial_carry(x)
        outs = []
        for zt in z.unbind(1):
            carry, h = self.step(u, carry, zt)
            outs.append(h)
        if self.return_sequences:
            return torch.stack(outs, dim=1)
        return outs[-1]

    def compute_output_shape(self, input_shape):
        if self.return_sequences:
            return (input_shape[0], input_shape[1], self.output_dim)
        return (input_shape[0], self.output_dim)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(output_dim=self.output_dim,
                   activation=self.activation_name,
                   inner_activation=self.inner_activation_name,
                   init=self.init_name, inner_init=self.inner_init_name,
                   return_sequences=self.return_sequences,
                   go_backwards=self.go_backwards)
        return cfg


@register_layer
class SimpleRNN(_RecurrentBase):
    """``h = activation(x W + b + h U)``."""

    gate_count = 1

    def step(self, u, carry, zt):
        h = self.activation(zt + carry @ u)
        return h, h

    def get_config(self):
        cfg = super().get_config()
        cfg.pop("inner_activation", None)
        return cfg


@register_layer
class LSTM(_RecurrentBase):
    """Gates [i, f, c, o]; the inner activation runs once over the whole
    gate slab (the c slice of it unused), one elementwise pass instead
    of three."""

    gate_count = 4

    def initial_carry(self, x):
        h = super().initial_carry(x)
        return h, torch.zeros_like(h)

    def step(self, u, carry, zt):
        h_prev, c_prev = carry
        n = self.output_dim
        z = zt + h_prev @ u
        s = self.inner_activation(z)
        i, f, o = s[:, :n], s[:, n:2 * n], s[:, 3 * n:]
        g = self.activation(z[:, 2 * n:3 * n])
        c = f * c_prev + i * g
        h = o * self.activation(c)
        return (h, c), h


@register_layer
class GRU(_RecurrentBase):
    """Gates [z, r, h]: ``z, r = inner(x W + b + h U_zr)``, ``hh =
    activation(x W_h + b_h + (r*h) U_h)``, ``h = z*h + (1-z)*hh``."""

    gate_count = 3

    def recurrent_weights(self):
        u = _at_carry_dtype(self.U)
        n = self.output_dim
        return u[:, :2 * n], u[:, 2 * n:]

    def step(self, u, carry, zt):
        n = self.output_dim
        u_zr, u_h = u
        zr = self.inner_activation(zt[:, :2 * n] + carry @ u_zr)
        z_gate, r_gate = zr[:, :n], zr[:, n:]
        hh = self.activation(zt[:, 2 * n:] + (r_gate * carry) @ u_h)
        h = z_gate * carry + (1.0 - z_gate) * hh
        return h, h


def _same_pads(size, kernel, stride):
    """F.pad's (left, right, top, bottom) for XLA's SAME on (rows,
    cols)."""
    (t, b_), (l, r) = (shape_utils.same_padding(n, k, s)
                       for n, k, s in zip(size, kernel, stride))
    return (l, r, t, b_)


@register_layer
class ConvLSTM2D(Layer):
    """Convolutional LSTM over channels-last (batch, time, rows, cols,
    channels); the four gates' convolutions are one convolution with
    4*filters output channels."""

    def __init__(self, nb_filter, nb_kernel=3, activation="tanh",
                 inner_activation="hard_sigmoid", border_mode="same",
                 subsample=1, return_sequences=False, go_backwards=False,
                 input_shape=None, name=None, trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self.nb_filter = int(nb_filter)
        self.kernel = shape_utils.normalize_tuple(nb_kernel, 2)
        self.activation_name = activation
        self.activation = activations.get(activation)
        self.inner_activation_name = inner_activation
        self.inner_activation = activations.get(inner_activation)
        self.border_mode = border_mode
        self.subsample = shape_utils.normalize_tuple(subsample, 2)
        self.return_sequences = bool(return_sequences)
        self.go_backwards = bool(go_backwards)
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        c, f = int(input_shape[-1]), self.nb_filter
        self.add_param("W", "glorot_uniform", self.kernel + (c, 4 * f),
                       generator)
        self.add_param("U", "glorot_uniform", self.kernel + (f, 4 * f),
                       generator)
        self.add_param("b", "zeros", (4 * f,), generator)

    def _conv(self, x, w, stride):
        """NCHW ``x`` by an HWIO kernel, padded as the border mode says."""
        if self.border_mode == "same":
            x = F.pad(x, _same_pads(x.shape[2:], self.kernel, stride))
        return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)

    def forward(self, x):
        if self.go_backwards:
            x = torch.flip(x, (1,))
        x, w, u, b = promote(x, self.W, self.U, self.b)
        bsz, steps = x.shape[:2]
        # every timestep's input convolution in one call, channels-first
        xs = x.reshape((bsz * steps,) + tuple(x.shape[2:])).permute(
            0, 3, 1, 2)
        zx = self._conv(xs, w, self.subsample) + b[:, None, None]
        zx = zx.reshape((bsz, steps) + tuple(zx.shape[1:]))
        n = self.nb_filter
        h = zx.new_zeros((bsz, n) + tuple(zx.shape[3:]),
                         dtype=torch.float32)
        c = torch.zeros_like(h)
        u = _at_carry_dtype(u)
        outs = []
        for zt in zx.unbind(1):
            z = zt + self._conv(h, u, (1, 1))
            s = self.inner_activation(z)
            i, f, o = s[:, :n], s[:, n:2 * n], s[:, 3 * n:]
            g = self.activation(z[:, 2 * n:3 * n])
            c = f * c + i * g
            h = o * self.activation(c)
            outs.append(h)
        if self.return_sequences:
            return torch.stack(outs, dim=1).permute(0, 1, 3, 4, 2)
        return outs[-1].permute(0, 2, 3, 1)

    def compute_output_shape(self, input_shape):
        b, t, h, w, _ = input_shape
        oh = shape_utils.conv_output_length(
            h, self.kernel[0], self.border_mode, self.subsample[0])
        ow = shape_utils.conv_output_length(
            w, self.kernel[1], self.border_mode, self.subsample[1])
        if self.return_sequences:
            return (b, t, oh, ow, self.nb_filter)
        return (b, oh, ow, self.nb_filter)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(nb_filter=self.nb_filter, nb_kernel=list(self.kernel),
                   activation=self.activation_name,
                   inner_activation=self.inner_activation_name,
                   border_mode=self.border_mode,
                   subsample=list(self.subsample),
                   return_sequences=self.return_sequences,
                   go_backwards=self.go_backwards)
        return cfg


@register_layer
class Bidirectional(Layer):
    """Runs ``layer`` forward and a clone of it (built from its config
    with ``go_backwards`` flipped) backward over the same input; the
    backward sequence output is flipped back into step order, then the
    two merge by ``merge_mode`` (concat, sum, mul or ave).  Its
    parameters are the two layers' trees, ``{"forward": ..., "backward":
    ...}``, as in the JAX package."""

    def __init__(self, layer=None, merge_mode="concat", input_shape=None,
                 name=None, trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        if merge_mode not in ("concat", "sum", "mul", "ave"):
            raise ValueError(f"Unknown merge_mode {merge_mode!r}")
        self.layer = layer
        self.merge_mode = merge_mode
        cfg = dict(layer.get_config())
        cfg.pop("name", None)
        cfg["go_backwards"] = not cfg.get("go_backwards", False)
        self.backward_layer = type(layer).from_config(cfg)
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        self.layer.build(input_shape, generator)
        self.backward_layer.build(input_shape, generator)

    def params(self):
        return {"forward": self.layer.params(),
                "backward": self.backward_layer.params()}

    def forward(self, x):
        fwd = self.layer(x)
        bwd = self.backward_layer(x)
        if self.layer.return_sequences:
            bwd = torch.flip(bwd, (1,))  # back into step order
        if self.merge_mode == "concat":
            return torch.cat([fwd, bwd], dim=-1)
        if self.merge_mode == "sum":
            return fwd + bwd
        if self.merge_mode == "mul":
            return fwd * bwd
        return (fwd + bwd) / 2.0

    def compute_output_shape(self, input_shape):
        out = self.layer.compute_output_shape(input_shape)
        if self.merge_mode == "concat":
            return tuple(out[:-1]) + (out[-1] * 2,)
        return tuple(out)

    def get_config(self):
        cfg = super().get_config()
        cfg["merge_mode"] = self.merge_mode
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
