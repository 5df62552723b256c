"""Weight regularizers on the port: the counterparts of
``tests/test_regularizers.py`` (all but its keras2 case, whose API is not
ported), and the training and evaluate losses of a regularized model
against the JAX package's on the same weights.

The penalty enters the training loss inside the differentiated function,
and ``evaluate`` adds it to every sample's loss, as in the JAX package.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu.pipeline.api.keras import regularizers as jreg
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.pipeline.api.keras import (Model, Sequential,
                                                        load_model)
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Convolution2D, Dense, Embedding, Flatten, Input, Merge)
from analytics_zoo_tpu_torch.pipeline.api.keras.regularizers import (
    L1, L1L2, L2, collect_penalties, get)


def test_regularizer_values():
    w = torch.tensor([[1.0, -2.0], [3.0, -4.0]])
    assert float(L1(0.1)(w)) == pytest.approx(1.0)
    assert float(L2(0.1)(w)) == pytest.approx(3.0)
    assert float(L1L2(0.1, 0.1)(w)) == pytest.approx(4.0)


def test_get_resolution():
    assert isinstance(get("l2"), L2)
    assert isinstance(get({"type": "L1", "l1": 0.5}), L1)
    assert get(None) is None
    with pytest.raises(ValueError):
        get("elastic")
    for reg in (L1(0.3), L2(0.2), L1L2(0.1, 0.4)):
        ref = getattr(jreg, type(reg).__name__)(**reg._rates())
        assert reg.get_config() == ref.get_config()
        assert repr(reg) == repr(ref)


def test_l2_shrinks_weights_via_fit():
    rs = np.random.RandomState(0)
    x = rs.rand(64, 6).astype(np.float32)
    y = rs.rand(64, 4).astype(np.float32)

    def norm_after(reg):
        m = Sequential(device="cpu")
        m.add(Dense(4, W_regularizer=reg, bias=False, input_shape=(6,),
                    name="d"))
        m.compile(optimizer={"name": "sgd", "lr": 0.1}, loss="mse")
        m.fit(x, y, batch_size=64, nb_epoch=20)
        return float(torch.sum(torch.square(m.layers[0].W.detach())))

    assert norm_after(L2(1.0)) < 0.2 * norm_after(None)


def test_training_loss_includes_penalty():
    rs = np.random.RandomState(0)
    x = rs.rand(32, 6).astype(np.float32)
    y = rs.rand(32, 4).astype(np.float32)
    base, reg = [], []
    for W_reg, out in ((None, base), (L2(0.5), reg)):
        m = Sequential(device="cpu")
        m.add(Dense(4, W_regularizer=W_reg, input_shape=(6,), name="d"))
        m.compile(optimizer={"name": "sgd", "lr": 0.0}, loss="mse")
        h = m.fit(x, y, batch_size=32, nb_epoch=1)
        pen = (0.0 if W_reg is None
               else float(L2(0.5)(m.layers[0].W.detach())))
        out.extend([h["loss"][-1], pen])
    np.testing.assert_allclose(reg[0] - base[0], reg[1], rtol=1e-4)


def test_regularized_convolution_trains_and_round_trips(tmp_path):
    m = Sequential(device="cpu")
    m.add(Convolution2D(4, 3, 3, W_regularizer=L2(0.01),
                        b_regularizer=L1(0.01), border_mode="same",
                        input_shape=(8, 8, 3)))
    m.add(Flatten())
    m.add(Dense(2, W_regularizer="l2"))
    m.compile(optimizer="adam", loss="mse")
    rs = np.random.RandomState(0)
    x = rs.rand(16, 8, 8, 3).astype(np.float32)
    y = rs.rand(16, 2).astype(np.float32)
    h = m.fit(x, y, batch_size=8, nb_epoch=2)
    assert np.isfinite(h["loss"][-1])
    ref = m.predict(x[:4], batch_size=4)
    m.save_model(str(tmp_path / "m"))
    loaded = load_model(str(tmp_path / "m"), device="cpu")
    np.testing.assert_allclose(loaded.predict(x[:4], batch_size=4), ref,
                               rtol=1e-5, atol=1e-6)
    conv = [l for l in loaded.to_graph().layers
            if type(l).__name__ == "Convolution2D"][0]
    assert isinstance(conv.W_regularizer, L2)
    assert isinstance(conv.b_regularizer, L1)


def test_nested_model_regularizer_reaches_loss():
    rs = np.random.RandomState(0)
    x = rs.rand(32, 6).astype(np.float32)
    y = rs.rand(32, 4).astype(np.float32)

    def fit(reg):
        inner = Sequential(device="cpu")
        inner.add(Dense(4, W_regularizer=reg, input_shape=(6,),
                        name="inner_d"))
        outer = Sequential(device="cpu")
        outer.add(inner)
        outer.compile(optimizer={"name": "sgd", "lr": 0.0}, loss="mse")
        return outer.fit(x, y, batch_size=32, nb_epoch=1)["loss"][-1]

    assert fit(L2(0.5)) > fit(None) + 1e-3


def test_shared_layer_adds_its_penalty_at_each_node():
    shared = Dense(4, W_regularizer=L2(1.0), input_shape=(6,),
                   name="shared")
    inp = Input((6,), name="x")
    out = Merge(mode="sum")([shared(inp), shared(inp)])
    model = Model(input=inp, output=out, device="cpu")
    with collect_penalties() as penalties:
        model(torch.zeros((2, 6)))
    pen_once = float(L2(1.0)(shared.W.detach()))
    np.testing.assert_allclose(float(penalties.total()), 2 * pen_once,
                               rtol=1e-5)


def test_embedding_regularizer():
    m = Sequential(device="cpu")
    m.add(Embedding(10, 4, W_regularizer=L2(0.5), input_shape=(3,),
                    name="emb"))
    m.add(Flatten())
    m.add(Dense(1))
    m.compile(optimizer={"name": "sgd", "lr": 0.0}, loss="mse")
    rs = np.random.RandomState(0)
    x = rs.randint(0, 10, (16, 3)).astype(np.int32)
    y = np.zeros((16, 1), np.float32)
    h = m.fit(x, y, batch_size=16, nb_epoch=1)
    pen = float(L2(0.5)(m.layers[0].embeddings.detach()))
    assert h["loss"][-1] >= pen - 1e-5
    assert pen > 0
    assert m.layers[0].get_config()["W_regularizer"] == {"type": "L2",
                                                         "l2": 0.5}


def test_no_penalty_outside_a_collector():
    """Predict computes no penalty: a regularized layer adds one only to
    an open collector."""
    d = Dense(3, W_regularizer=L2(1.0), input_dim=2, device="cpu")
    with collect_penalties() as outer:
        with collect_penalties() as inner:
            d(torch.ones((1, 2)))
        assert outer.total() is None and len(inner.terms) == 1
    d(torch.ones((1, 2)))


def _build(layers, model):
    model.add(layers.Convolution2D(3, 3, 3, W_regularizer=L2(0.05)
                                   if layers is tlayers else
                                   jreg.L2(0.05),
                                   b_regularizer="l1", border_mode="same",
                                   input_shape=(6, 6, 2)))
    model.add(layers.Flatten())
    model.add(layers.Dense(3, W_regularizer={"type": "L1L2", "l1": 0.01,
                                             "l2": 0.02}))
    return model


def test_regularized_training_and_evaluate_follow_jax():
    """3 adam steps and evaluate (with a padded tail) of a regularized
    conv + dense model, from the same weights: losses within 1e-5
    relative, weights within 1e-5."""
    rs = np.random.RandomState(1)
    x = rs.rand(24, 6, 6, 2).astype(np.float32)
    y = rs.rand(24, 3).astype(np.float32)
    with jname_scope("reg"):
        jm = _build(jlayers, JSequential())
    with name_scope("reg"):
        tm = _build(tlayers, Sequential(device="cpu"))
    jm.compile({"name": "adam", "lr": 1e-2}, "mse")
    tm.set_weights(jax.device_get(jm.get_weights()))
    tm.compile({"name": "adam", "lr": 1e-2}, "mse")
    ref = jm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    out = tm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    jw = jax.device_get(jm.get_weights())
    for layer, leaves in tm.get_weights().items():
        for key, a in leaves.items():
            np.testing.assert_allclose(a, np.asarray(jw[layer][key]),
                                       rtol=0, atol=1e-5)
    ref_e, out_e = jm.evaluate(x, y, batch_size=10), tm.evaluate(
        x, y, batch_size=10)
    assert out_e["loss"] == pytest.approx(ref_e["loss"], rel=1e-5)


def test_l1_gradient_at_zero_is_jax_s():
    """``jnp.abs`` has gradient +1 at 0, ``torch.abs`` 0; biases start
    at 0, so an L1 ``b_regularizer`` must take JAX's."""
    w = np.array([0.0, -0.5, 2.0, 0.0], np.float32)
    for reg, jr in ((L1(0.3), jreg.L1(0.3)), (L1L2(0.3, 0.1),
                                               jreg.L1L2(0.3, 0.1))):
        t = torch.from_numpy(w.copy()).requires_grad_()
        (g,) = torch.autograd.grad(reg(t), t)
        ref = jax.grad(lambda a: jr(a))(jnp.asarray(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-6)
        assert float(reg(t)) == pytest.approx(float(jr(jnp.asarray(w))))
