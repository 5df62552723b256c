"""TextClassifier: the zoo's text classification model.

Counterpart of ``analytics_zoo_tpu/models/textclassification.py``
(reference TextClassifier.scala:31-60): an optional frozen
``WordEmbedding`` (raw token ids in), else pre-embedded input of shape
(sequence_length, token_length); then a cnn (Convolution1D of
``encoder_output_dim`` filters, width 5, relu, and GlobalMaxPooling1D),
lstm or gru encoder; Dense(128), Dropout(0.2), relu and a softmax Dense
over ``class_num``.  The graph is a ``Sequential`` named ``net``, built
inside the class's name scope as in the JAX package, so the two
packages' layer names match.
"""

from __future__ import annotations

from ..pipeline.api.keras.engine import Sequential
from ..pipeline.api.keras.layers import (
    GRU, LSTM, Activation, Convolution1D, Dense, Dropout,
    GlobalMaxPooling1D, WordEmbedding)
from .common import ZooModel, register_zoo_model


@register_zoo_model
class TextClassifier(ZooModel):
    def __init__(self, class_num=None, token_length=None,
                 sequence_length=500, encoder="cnn", encoder_output_dim=256,
                 embedding_file=None, word_index=None, name=None,
                 device=None, seed: int = 0, **kw):
        super().__init__(name=name, class_num=class_num,
                         token_length=token_length,
                         sequence_length=sequence_length, encoder=encoder,
                         encoder_output_dim=encoder_output_dim,
                         embedding_file=embedding_file,
                         word_index=word_index, **kw)
        self.build_graph(device, seed)

    def build_model(self, device, seed: int) -> Sequential:
        h = self.hyper
        enc = h["encoder"].lower()
        if enc not in ("cnn", "lstm", "gru"):
            raise ValueError(
                f"Unsupported encoder for TextClassifier: {h['encoder']}")
        model = Sequential(name="net", device=device, seed=seed)
        if h.get("embedding_file"):
            model.add(WordEmbedding(
                h["embedding_file"], word_index=h.get("word_index"),
                input_length=h["sequence_length"]))
            first_shape = None  # the embedding gives the input shape
        else:
            first_shape = (h["sequence_length"], h["token_length"])
        dim = h["encoder_output_dim"]
        if enc == "cnn":
            model.add(Convolution1D(dim, 5, activation="relu",
                                    input_shape=first_shape))
            model.add(GlobalMaxPooling1D())
        elif enc == "lstm":
            model.add(LSTM(dim, input_shape=first_shape))
        else:
            model.add(GRU(dim, input_shape=first_shape))
        model.add(Dense(128))
        model.add(Dropout(0.2))
        model.add(Activation("relu"))
        model.add(Dense(h["class_num"], activation="softmax"))
        return model
