"""The port's text classification family against the JAX package's, on
the CPU: WordEmbedding, SparseEmbedding and TextClassifier.

Counterparts of ``tests/test_model_zoo.py``'s TextClassifier tests (the
cnn encoder learns a separable task, the rnn encoders build and predict
distributions, an unknown encoder raises the JAX package's error) and of
``tests/test_serialization_sweep.py``'s WordEmbedding round trip.  A
GloVe-format file written under ``tmp_path`` gives the JAX package's
word index (1-based, in file order) and table (row 0 and missing words
zero), frozen in the layer state whatever ``trainable`` says.  A whole
TextClassifier (lstm, and gru and cnn, small widths, a WordEmbedding on
token ids) moves the JAX model's weights and table across
(``from_jax_params`` with its state): predictions within 1e-5, then 3
adagrad steps through both packages' ``fit`` (dropout off: the packages'
random streams differ), losses within 1e-5
relative, every parameter within 1e-5 of its tensor's largest entry,
the table unchanged.
"""

import numpy as np
import pytest
import torch
import jax

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.models.textclassification import (
    TextClassifier as JTextClassifier)
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.models import (TextClassifier, from_jax_params,
                                            to_jax_state)
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential, load_model
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _glove(path, words, dim, seed=0):
    vecs = np.random.default_rng(seed).normal(size=(len(words), dim))
    with open(path, "w", encoding="utf-8") as f:
        for w, v in zip(words, vecs):
            f.write(w + " " + " ".join(f"{x:.6f}" for x in v) + "\n")
    return np.round(vecs, 6).astype(np.float32)


def test_torch_text_classifier_cnn_trains():
    model = TextClassifier(class_num=3, token_length=16, sequence_length=24,
                           encoder="cnn", encoder_output_dim=32,
                           device="cpu")
    model.compile(optimizer={"name": "adam", "lr": 5e-3},
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 256).astype(np.int32)
    x = rng.normal(0, 0.1, (256, 24, 16)).astype(np.float32)
    for i in range(256):
        x[i, :, y[i] * 5:y[i] * 5 + 3] += 1.0  # class-dependent channels
    model.fit(x, y, batch_size=32, nb_epoch=4)
    assert model.evaluate(x, y, batch_size=32)["accuracy"] > 0.8


@pytest.mark.parametrize("encoder", ["lstm", "gru"])
def test_torch_text_classifier_rnn_builds(encoder):
    model = TextClassifier(class_num=2, token_length=8, sequence_length=12,
                           encoder=encoder, encoder_output_dim=16,
                           device="cpu")
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    x = np.random.default_rng(1).normal(size=(16, 12, 8)).astype(np.float32)
    probs = model.predict(x, batch_size=8)
    assert probs.shape == (16, 2)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-4)


def test_text_classifier_bad_encoder_raises_jax_error():
    with pytest.raises(ValueError,
                       match="Unsupported encoder for TextClassifier: "
                             "transformer"):
        TextClassifier(class_num=2, token_length=8, sequence_length=12,
                       encoder="transformer", device="cpu")
    hyper = TextClassifier(class_num=2, token_length=8, device="cpu").hyper
    assert hyper["sequence_length"] == 500
    assert hyper["encoder_output_dim"] == 256


def test_word_embedding_index_and_table_match_jax(tmp_path):
    path = str(tmp_path / "glove.txt")
    vecs = _glove(path, ["the", "cat", "sat"], 4)
    index = L.WordEmbedding.get_word_index(path)
    assert index == JL.WordEmbedding.get_word_index(path) == {
        "the": 1, "cat": 2, "sat": 3}
    # a word the file lacks keeps a zero row; row 0 is padding
    wi = {"cat": 1, "dog": 2, "sat": 4}
    layer = L.WordEmbedding(path, wi, trainable=True, input_length=5,
                            device="cpu")
    jl = JL.WordEmbedding(path, wi, input_length=5)
    np.testing.assert_array_equal(layer.table.numpy(), jl._table)
    np.testing.assert_array_equal(layer.table[1].numpy(), vecs[1])
    assert not layer.table[[0, 2, 3]].any() and layer.table.shape == (5, 4)
    assert list(layer.parameters()) == []  # frozen: state, not params
    assert set(layer.state()) == {"table"}
    ids = np.array([[1, 4, 0, 2, 3]])
    np.testing.assert_array_equal(
        layer(torch.from_numpy(ids)).numpy(),
        np.asarray(jl.apply({}, jl.init_state(None), ids)[0]))
    assert layer.compute_output_shape((None, 5)) == (None, 5, 4)


def test_word_embedding_config_and_save_round_trip(tmp_path):
    """Counterpart of test_word_embedding_roundtrip: the table rides in
    the config, so load_model rebuilds it without the file."""
    glove = tmp_path / "glove.txt"
    _glove(str(glove), ["a", "b", "c"], 4)
    model = Sequential(device="cpu")
    model.add(L.WordEmbedding(str(glove), {"a": 1, "b": 2, "c": 3},
                              input_length=3))
    ids = np.asarray([[1, 2, 3]], np.int32)
    ref = model.predict(ids, batch_size=1)
    cfg = model.layers[0].get_config()
    assert "embedding_file" not in cfg and len(cfg["_table"]) == 4
    again = L.WordEmbedding.from_config(cfg)
    np.testing.assert_array_equal(again._table, model.layers[0]._table)
    model.save_model(str(tmp_path / "we"))
    glove.unlink()
    loaded = load_model(str(tmp_path / "we"), device="cpu")
    np.testing.assert_allclose(ref, loaded.predict(ids, batch_size=1),
                               rtol=1e-5, atol=1e-6)


def test_sparse_embedding_is_embedding():
    a = L.SparseEmbedding(10, 3, device="cpu")
    b = L.Embedding(10, 3, device="cpu")
    with torch.no_grad():
        b.embeddings.copy_(a.embeddings)
    ids = torch.tensor([[1, 9, 0]])
    np.testing.assert_array_equal(a(ids).detach().numpy(),
                                  b(ids).detach().numpy())
    assert type(a).from_config(a.get_config()).get_config() == a.get_config()


@pytest.mark.parametrize("encoder", ["lstm", "gru", "cnn"])
def test_text_classifier_predicts_and_trains_like_jax(tmp_path, encoder):
    path = str(tmp_path / "glove.txt")
    words = [f"w{i}" for i in range(30)]
    _glove(path, words, 6)
    hyper = dict(class_num=3, sequence_length=10, encoder=encoder,
                 encoder_output_dim=8, embedding_file=path)
    zoo.reset_nncontext()
    zoo.init_nncontext()
    jm = JTextClassifier(**hyper)
    tm = TextClassifier(**hyper, device="cpu")
    assert [l.name for l in tm.to_graph().layers] == \
        [l.name for l in jm.to_graph().layers]
    # the two packages draw dropout masks from different streams: train
    # both without it
    for m in (jm, tm):
        for layer in m.to_graph().layers:
            if type(layer).__name__ == "Dropout":
                layer.p = 0.0
    optimizer = {"name": "adagrad", "lr": 0.05}
    jm.compile(optimizer=optimizer, loss="sparse_categorical_crossentropy")
    jm.trainer.ensure_initialized()
    from_jax_params(tm, jax.device_get(jm.get_weights()),
                    jax.device_get(jm.trainer.state.model_state))
    tm.compile(optimizer=optimizer, loss="sparse_categorical_crossentropy")
    rng = np.random.default_rng(2)
    x = rng.integers(0, 31, (24, 10)).astype(np.int32)
    y = rng.integers(0, 3, 24).astype(np.int32)
    np.testing.assert_allclose(tm.predict(x, batch_size=8),
                               np.asarray(jm.predict(x, batch_size=8)), **TOL)
    table = tm.to_graph().layers[0].table.clone()
    ref = jm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)
    out = tm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)
    assert len(out["loss"]) == len(ref["loss"]) == 3
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
    jw = jax.device_get(jm.get_weights())
    for layer, leaves in tm.get_weights().items():
        for key, a in leaves.items():
            b = np.asarray(jw[layer][key])
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=f"{layer}/{key}")
    assert torch.equal(tm.to_graph().layers[0].table, table)
    state = to_jax_state(tm)
    np.testing.assert_array_equal(
        next(iter(state.values()))["table"], table.numpy())
