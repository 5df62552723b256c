"""Embedding layers: Embedding, SparseEmbedding and WordEmbedding.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
embedding.py``.  ``Embedding`` is a trainable lookup table named
``embeddings``; its shape comes from ``input_dim`` and ``output_dim``, so
the layer builds at construction whenever it is given a device or
generator.  ``SparseEmbedding`` is the same layer (ids arrive densely
padded).  ``WordEmbedding`` serves lookups from a frozen pretrained
table parsed from a GloVe-format text file: the table is layer state
(the buffer ``table``), so no optimizer touches it, whatever
``trainable`` says."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
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


@register_layer
class SparseEmbedding(Embedding):
    """Embedding fed by id bags padded to a dense shape: the semantics of
    ``Embedding``."""


@register_layer
class WordEmbedding(Layer):
    """Frozen pretrained word embeddings from ``embedding_file`` (one
    word and its vector a line, space separated).  ``word_index`` maps
    words to 1-based rows (default: the file's order,
    :meth:`get_word_index`); row 0 is the zero padding vector, as is
    every indexed word the file lacks.  The table goes into the config
    (``_table``), so ``from_config`` rebuilds the layer without the
    file.  ``_output_dim`` is accepted and, as in the JAX package, not
    used: the table's width is the output's."""

    needs_input_shape = False
    stateful = True

    def __init__(self, embedding_file=None, word_index=None, trainable=False,
                 input_length=None, input_shape=None, name=None,
                 _table=None, _output_dim=None, device=None,
                 generator: Optional[torch.Generator] = None):
        if input_length is not None and input_shape is None:
            input_shape = (input_length,)
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.embedding_file = embedding_file
        self.word_index = word_index
        if _table is not None:
            self._table = np.asarray(_table, dtype=np.float32)
        elif embedding_file is not None:
            wi = word_index or WordEmbedding.get_word_index(embedding_file)
            self.word_index = wi
            self._table = _build_table(embedding_file, wi)
        else:
            raise ValueError("WordEmbedding needs embedding_file or _table")
        self.output_dim = self._table.shape[1]
        self._build_if_ready()

    @staticmethod
    def get_word_index(embedding_file) -> Dict[str, int]:
        """word -> 1-based index, in the file's order (0 is reserved for
        padding and unknown words)."""
        index = {}
        with open(embedding_file, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                index[line.split(" ", 1)[0]] = i + 1
        return index

    def build_params(self, input_shape, generator):
        self.add_state("table", torch.from_numpy(self._table).to(
            generator.device))

    def forward(self, ids):
        return F.embedding(ids.long(), self.table)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)

    def get_config(self):
        cfg = super().get_config()
        cfg["_table"] = self._table.tolist()
        return cfg


def _build_table(embedding_file, word_index) -> np.ndarray:
    """Rows ordered by index; row 0 and the rows of words the file lacks
    are zero."""
    vectors = {}
    dim = None
    with open(embedding_file, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            word, vec = parts[0], np.asarray(parts[1:], dtype=np.float32)
            dim = dim or len(vec)
            if word in word_index:
                vectors[word_index[word]] = vec
    table = np.zeros((max(word_index.values()) + 1, dim), dtype=np.float32)
    for idx, vec in vectors.items():
        table[idx] = vec
    return table
