"""Embedding: a trainable lookup table named ``embeddings``.

Counterpart of ``Embedding`` in
``analytics_zoo_tpu/pipeline/api/keras/layers/embedding.py``.  The table's
shape comes from ``input_dim`` and ``output_dim``, so the layer builds at
construction whenever it is given a device or generator."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .....core.module import Layer, register_layer
from ..regularizers import RegularizedLayerMixin, to_config


@register_layer
class Embedding(RegularizedLayerMixin, Layer):
    needs_input_shape = False
    _reg_w_key = "embeddings"

    def __init__(self, input_dim, output_dim, init="uniform",
                 input_length=None, W_regularizer=None, input_shape=None,
                 name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        if input_length is not None and input_shape is None:
            input_shape = (input_length,)
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self._setup_regularizers(W_regularizer)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.init_name = init
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        self.add_param("embeddings", self.init_name,
                       (self.input_dim, self.output_dim), generator)

    def forward(self, ids):
        self._add_penalty()
        return F.embedding(ids.long(), self.embeddings)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(input_dim=self.input_dim, output_dim=self.output_dim,
                   init=self.init_name,
                   W_regularizer=to_config(self.W_regularizer))
        return cfg
