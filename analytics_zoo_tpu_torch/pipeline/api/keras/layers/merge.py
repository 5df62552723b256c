"""Merge, ``mode="sum"`` only (the residual connection).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/merge.py``;
its other modes come with the layer set."""

from __future__ import annotations

from typing import Optional

from .....core.module import Layer, register_layer


@register_layer
class Merge(Layer):
    def __init__(self, mode: str = "sum", name: Optional[str] = None):
        super().__init__(name)
        if mode != "sum":
            raise ValueError(f"Merge supports mode='sum' only, got {mode!r}")

    def forward(self, inputs):
        xs = list(inputs)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
