"""Merge, with every mode of the reference, and the functional
``merge``.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/merge.py``:
modes ``sum``, ``mul``, ``max``, ``min``, ``ave``, ``sub``, ``div``,
``concat``, ``dot`` and ``cosine`` over a list of inputs.  ``max`` and
``min`` are ``ops/elementwise.py``'s ``maximum``/``minimum``, which split
the gradient of a tie between the inputs as ``jnp.maximum`` does.
``layers`` (branch layers of a Sequential) is accepted and stored, and
not used, as in the JAX package."""

from __future__ import annotations

import torch

from .....core.graph import broadcast_shapes
from .....core.module import Layer, register_layer
from .....ops import elementwise as E
from .. import activations

MODES = ("sum", "mul", "max", "min", "ave", "sub", "div", "concat", "dot",
         "cosine")


def _unit_rows(x):
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / activations.clip(norm, low=1e-12)


@register_layer
class Merge(Layer):
    def __init__(self, layers=None, mode="sum", concat_axis=-1,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.mode = mode
        self.concat_axis = int(concat_axis)
        self.layers = layers

    def forward(self, inputs):
        xs = list(inputs)
        m = self.mode
        if m in ("sum", "mul", "max", "min"):
            op = {"sum": torch.add, "mul": torch.mul, "max": E.maximum,
                  "min": E.minimum}[m]
            out = xs[0]
            for x in xs[1:]:
                out = op(out, x)
            return out
        if m == "ave":
            return sum(xs) / float(len(xs))
        if m == "sub":
            return xs[0] - xs[1]
        if m == "div":
            return xs[0] / xs[1]
        if m == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        if m == "dot":
            return torch.sum(xs[0] * xs[1], dim=-1, keepdim=True)
        if m == "cosine":
            return torch.sum(_unit_rows(xs[0]) * _unit_rows(xs[1]), dim=-1,
                             keepdim=True)
        raise ValueError(f"Unknown merge mode {self.mode!r}")

    def compute_output_shape(self, input_shape):
        shapes = [tuple(s) for s in input_shape]
        if self.mode == "concat":
            out = list(shapes[0])
            ax = self.concat_axis % len(out)
            dims = [s[ax] for s in shapes]
            out[ax] = None if None in dims else sum(dims)
            return tuple(out)
        if self.mode in ("dot", "cosine"):
            return (shapes[0][0], 1)
        out = shapes[0]
        for s in shapes[1:]:
            out = broadcast_shapes(out, s)
        return out

    def get_config(self):
        cfg = super().get_config()
        cfg.update(mode=self.mode, concat_axis=self.concat_axis)
        return cfg


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    """Functional merge over Variables (or tensors)."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(list(inputs))
