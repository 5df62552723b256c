"""Merge, modes ``sum`` (the residual connection) and ``concat``.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/merge.py``;
its other modes, and branch ``layers``, are not ported yet (see
ROADMAP.md)."""

from __future__ import annotations

import torch

from .....core.module import Layer, register_layer


@register_layer
class Merge(Layer):
    def __init__(self, layers=None, mode="sum", concat_axis=-1,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        if layers is not None or mode not in ("sum", "concat"):
            raise NotImplementedError(
                "Merge supports mode 'sum' or 'concat' over a list of "
                f"inputs only (got mode={mode!r}); the rest is not ported "
                "yet (see ROADMAP.md)")
        self.mode = mode
        self.concat_axis = int(concat_axis)

    def forward(self, inputs):
        xs = list(inputs)
        if self.mode == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    def compute_output_shape(self, input_shape):
        shapes = [tuple(s) for s in input_shape]
        if self.mode == "sum":
            return shapes[0]
        out = list(shapes[0])
        ax = self.concat_axis % len(out)
        dims = [s[ax] for s in shapes]
        out[ax] = None if None in dims else sum(dims)
        return tuple(out)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(mode=self.mode, concat_axis=self.concat_axis)
        return cfg
