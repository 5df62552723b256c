"""The port's graph engine (``Input``, functional ``Model``, nested
``Sequential``) against the JAX package's.

Each model is built in both packages inside one ``name_scope``, so the
layers get the same names, and the JAX model's weights go into the port
(``set_weights``).  Outputs agree within 1e-5, training losses within
1e-5 relative.  Both run on the CPU; the attention model runs the port's
``"auto"`` (blockwise) and ``"flash"`` (the CUDA kernels' plain versions,
forward and backward) against the JAX package's ``"auto"``.
"""

import json

import numpy as np
import pytest
import torch
import jax

from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu_torch.core.graph import Variable
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.pipeline.api.keras import (Model, Sequential,
                                                        load_model)
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import KerasNet

PACKAGES = {"jax": (jname_scope, jlayers, JModel, JSequential),
            "torch": (name_scope, tlayers, Model, Sequential)}
TOL = dict(rtol=1e-5, atol=1e-5)


def both(build, scope):
    """``build(layers, Model, Sequential)`` in each package, under
    ``scope``; the port's gets the JAX model's weights."""
    out = {}
    for pkg, (scope_fn, layers, model_cls, seq_cls) in PACKAGES.items():
        kw = {} if pkg == "jax" else {"device": "cpu"}
        with scope_fn(scope):
            out[pkg] = build(layers, lambda *a, **k: model_cls(*a, **k, **kw),
                             lambda **k: seq_cls(**k, **kw))
    weights = jax.device_get(out["jax"].get_weights())
    out["torch"].set_weights(weights)
    return out["jax"], out["torch"]


def two_in_two_out(L, M, _):
    a, b = L.Input((4,), name="a"), L.Input((6,), name="b")
    ha = L.Dense(5, activation="tanh")(a)
    hb = L.Dense(5)(b)
    s = L.Merge(mode="sum")([ha, hb])
    c = L.Merge(mode="concat")([s, hb])
    return M(input=[a, b], output=[L.Dense(3, activation="softmax")(c),
                                   L.Dense(2)(hb)])


def shared_dense(L, M, _):
    x = L.Input((6,))
    d = L.Dense(6, activation="tanh")
    h = L.Dense(4, activation="relu", name="mid")(d(d(x)))
    return M(input=x, output=L.Dense(3, activation="softmax")(h))


def _xy(n, widths=(4, 6), classes=3, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(n, w)).astype(np.float32) for w in widths]
    return xs, rng.integers(0, classes, n).astype(np.int32)


def test_two_inputs_two_outputs_match_jax():
    jm, tm = both(two_in_two_out, "two")
    (xa, xb), _ = _xy(10)
    ref = jm.predict([xa, xb], batch_size=8)
    out = tm.predict([xa, xb], batch_size=8)
    assert isinstance(out, list) and len(out) == 2
    assert [o.shape for o in out] == [(10, 3), (10, 2)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, np.asarray(r), **TOL)
    assert [v.name for v in tm.inputs] == ["a", "b"]


def test_shared_layer_is_one_entry_and_trains_like_jax():
    """A Dense called twice holds one set of weights, and its gradient is
    the sum over both calls: 3 sgd steps give the JAX package's losses."""
    jm, tm = both(shared_dense, "shared")
    assert len(tm.to_graph().layers) == 3
    assert set(tm.get_weights()) == set(jax.device_get(jm.get_weights()))
    (x,), y = _xy(24, widths=(6,))
    for m in (jm, tm):
        m.compile(optimizer={"name": "sgd", "lr": 0.5},
                  loss="sparse_categorical_crossentropy")
    ref = jm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    out = tm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)
    assert out[-1] != out[0]


def test_new_graph_to_model_get_layer():
    jm, tm = both(shared_dense, "surgery")
    (x,), _ = _xy(8, widths=(6,))
    jsub, tsub = jm.new_graph(["mid"]), tm.new_graph(["mid"])
    np.testing.assert_allclose(tsub.predict(x), np.asarray(jsub.predict(x)),
                               **TOL)
    mid = tm.get_layer("mid")
    assert tsub.get_layer("mid") is mid  # shared, weights too
    with torch.no_grad():
        mid.b.add_(1.0)
    assert not np.allclose(tsub.predict(x), np.asarray(jsub.predict(x)))
    with pytest.raises(ValueError, match="no layer named"):
        tm.get_layer("nope")
    seq = Sequential(device="cpu")
    seq.add(tlayers.Dense(5, input_shape=(6,)))
    seq.add(tlayers.Dense(2, activation="softmax"))
    as_model = seq.to_model()
    assert isinstance(as_model, Model)
    np.testing.assert_array_equal(as_model.predict(x), seq.predict(x))
    assert as_model.get_layer(seq.layers[1].name) is seq.layers[1]


def test_config_round_trip_and_save_load(tmp_path):
    _, tm = both(two_in_two_out, "cfg")
    cfg = tm.get_config()
    json.dumps(cfg)  # the reference's architecture.json is plain JSON
    back = Model.from_config(cfg, device="cpu", seed=5)

    def shape_of(c):
        return [(n["name"], n["layer"]) for n in c["nodes"]]
    assert shape_of(back.get_config()) == shape_of(cfg)
    (xa, xb), _ = _xy(6)
    assert not np.allclose(back.predict([xa, xb])[0], tm.predict([xa, xb])[0])
    back.set_weights(tm.get_weights())
    for o, r in zip(back.predict([xa, xb]), tm.predict([xa, xb])):
        np.testing.assert_array_equal(o, r)
    tm.save_model(str(tmp_path / "m"))
    arch = json.loads((tmp_path / "m" / "architecture.json").read_text())
    assert arch["class_name"] == "Model" and arch["config"] == cfg
    loaded = load_model(str(tmp_path / "m"), device="cpu")
    for o, r in zip(loaded.predict([xa, xb]), tm.predict([xa, xb])):
        np.testing.assert_array_equal(o, r)


def attention_model(impl):
    def build(L, M, _):
        x = L.Input((16,))
        h = L.Embedding(37, 16)(x)
        h = L.PositionalEmbedding(24)(h)
        h = L.LayerNorm()(h)
        h = L.MultiHeadSelfAttention(2, causal=True, implementation=impl)(h)
        return M(input=x, output=L.Dense(37, activation="log_softmax")(h))
    return build


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_attention_model_matches_jax(impl):
    """Input -> Embedding -> PositionalEmbedding -> LayerNorm ->
    MultiHeadSelfAttention(causal) -> Dense, with the reference's
    signatures: predict within 1e-5, then 2 adam steps' losses within
    1e-5 relative."""
    jm, tm = both(lambda L, M, S: attention_model("auto")(L, M, S)
                  if L is jlayers else attention_model(impl)(L, M, S),
                  f"attn_{impl}")
    rng = np.random.default_rng(3)
    x = rng.integers(0, 37, (16, 16)).astype(np.int32)
    y = rng.integers(0, 37, (16, 16)).astype(np.int32)
    np.testing.assert_allclose(tm.predict(x, batch_size=8),
                               np.asarray(jm.predict(x, batch_size=8)),
                               **TOL)
    for m in (jm, tm):
        m.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll")
    ref = jm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    out = tm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)


def test_jax_lenet_config_loads_through_sequential_from_config():
    """The JAX package's get_config() of LeNet builds the port's model:
    the same layer names and classes, weights of the same shapes."""
    L = jlayers
    with jname_scope("jlenet"):
        jm = JSequential()
        jm.add(L.Convolution2D(6, 5, 5, activation="relu",
                               border_mode="same", input_shape=(28, 28, 1)))
        jm.add(L.MaxPooling2D())
        jm.add(L.Convolution2D(16, 5, 5, activation="relu"))
        jm.add(L.MaxPooling2D())
        jm.add(L.Flatten())
        jm.add(L.Dense(120, activation="relu"))
        jm.add(L.Dropout(0.1))
        jm.add(L.Dense(84, activation="relu"))
        jm.add(L.Dense(10, activation="softmax"))
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               metrics=["accuracy"])
    cfg = json.loads(json.dumps(jm.get_config()))
    tm = Sequential.from_config(cfg, device="cpu")
    assert tm.name == jm.name
    assert [(type(l).__name__, l.name) for l in tm.layers] == \
        [(type(l).__name__, l.name) for l in jm.layers]
    jw = jax.device_get(jm.get_weights())
    tw = tm.get_weights()
    assert sorted(tw) == sorted(jw)
    for layer, leaves in tw.items():
        assert {k: v.shape for k, v in leaves.items()} == \
            {k: np.shape(v) for k, v in jw[layer].items()}
    tm.set_weights(jw)
    x = np.random.default_rng(0).normal(size=(8, 28, 28, 1)).astype(
        np.float32)
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               **TOL)
    assert tm._compile_args["loss"] == "sparse_categorical_crossentropy"


def test_nested_sequential_matches_jax():
    """Sequential.add(Sequential): the inner model is one layer of the
    outer, its weights one nested entry, as in the JAX package."""
    def build(L, _, S):
        inner = S()
        inner.add(L.Dense(8, activation="tanh", input_shape=(5,)))
        inner.add(L.Dense(6))
        outer = S()
        outer.add(inner)
        outer.add(L.Dense(2, activation="softmax"))
        return outer
    jm, tm = both(build, "nest")
    jw, tw = jax.device_get(jm.get_weights()), tm.get_weights()
    inner = tm.layers[0]
    assert isinstance(inner, KerasNet)
    assert set(tw) == set(jw) == {inner.name, tm.layers[1].name}
    assert set(tw[inner.name]) == set(jw[inner.name])
    (x,), _ = _xy(8, widths=(5,))
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               **TOL)
    np.testing.assert_array_equal(tm.to_model().predict(x), tm.predict(x))


def test_models_draw_from_their_seed():
    def build(seed):
        x = tlayers.Input((4,))
        y = tlayers.Dense(4)(tlayers.Dense(4)(x))
        return Model(input=x, output=y, device="cpu", seed=seed)
    a, b, c = build(0), build(0), build(1)
    wa, wb, wc = (list(m.get_weights().values()) for m in (a, b, c))
    np.testing.assert_array_equal(wa[0]["W"], wb[0]["W"])
    np.testing.assert_array_equal(wa[1]["W"], wb[1]["W"])
    assert not np.array_equal(wa[0]["W"], wa[1]["W"])
    assert not np.array_equal(wa[0]["W"], wc[0]["W"])


def test_variable_arithmetic_is_not_ported_yet():
    """Variable arithmetic adds op nodes: each operator adds an OpLayer
    node (ops/elementwise.py) with the JAX package's shape, and a model
    over them runs (tests/test_torch_autograd.py holds the values).  The
    name dates from when these operators raised; it stays so that the
    test keeps its history."""
    x = tlayers.Input((3,))
    assert isinstance(x, Variable) and x.shape == (None, 3)
    for op, shape in ((lambda: x + x, (None, 3)),
                      (lambda: x * 2.0, (None, 3)),
                      (lambda: -x, (None, 3)), (lambda: x[:, 0], (None,))):
        v = op()
        assert isinstance(v, Variable) and v.shape == shape
        assert type(v.layer).__name__ == "OpLayer"
    m = Model(input=x, output=-(x * 2.0) + x[:, :1], device="cpu")
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(m.predict(xv, batch_size=2),
                                  -(xv * 2.0) + xv[:, :1])
