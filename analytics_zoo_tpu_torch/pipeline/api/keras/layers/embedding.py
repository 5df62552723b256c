"""Embedding: a trainable lookup table named ``embeddings``.

Counterpart of ``Embedding`` in
``analytics_zoo_tpu/pipeline/api/keras/layers/embedding.py``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .....core.module import Layer, make_generator, register_layer


@register_layer
class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 name: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.add_param("embeddings", init, (int(input_dim), int(output_dim)),
                       make_generator(device, generator))

    def forward(self, ids):
        return F.embedding(ids.long(), self.embeddings)
