"""freeze / freeze_up_to / unfreeze on the port: the counterpart of every
test of ``tests/test_freeze.py``, the pin of the freeze fault, and the
optimizer statistics against the JAX package's across a toggle.

The flags are the layers' ``trainable``; the trainer reads them at every
step, takes gradients only for trainable parameters (zeros for the
rest), drops the frozen parameters' updates, and keeps one optimizer
state over every parameter, so a toggle never resets anyone's moments.
"""

import numpy as np
import pytest
import jax

from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu_torch.pipeline.api.keras import (Model, Sequential,
                                                        load_model)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (Dense, Input,
                                                               Merge)


def _model(layers=None, seq=None):
    m = seq or Sequential(device="cpu")
    L = layers
    if L is None:
        from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    m.add(L.Dense(8, input_shape=(4,), activation="relu", name="backbone1"))
    m.add(L.Dense(8, activation="relu", name="backbone2"))
    m.add(L.Dense(2, name="head"))
    return m


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.normal(size=(64, 2)).astype(np.float32)
    return x, y


def _weights(m):
    return {k: {kk: np.array(vv) for kk, vv in v.items()}
            for k, v in m.get_weights().items()}


def _moments(m):
    """The adam moments by (layer, parameter): {"mu": {...}, "nu": {...}}."""
    names = {id(p): (layer.name, key) for layer in m.layers
             for key, p in layer.params().items()}
    adam = m.trainer.state.opt_state.states[0]
    return {k: {names[id(p)]: t.numpy().copy()
                for p, t in zip(m.trainer.state.params, adam[k])}
            for k in ("mu", "nu")}


def test_freeze_up_to_trains_only_the_head():
    m = _model()
    m.compile("sgd", "mse")
    x, y = _data()
    m.fit(x, y, batch_size=32, nb_epoch=1)
    m.freeze_up_to(["backbone2"])
    assert m.frozen_layer_names() == ["backbone1", "backbone2"]
    before = _weights(m)
    m.fit(x, y, batch_size=32, nb_epoch=2)
    after = _weights(m)
    for name in ("backbone1", "backbone2"):
        np.testing.assert_array_equal(after[name]["W"], before[name]["W"],
                                      err_msg=name)
    assert not np.allclose(after["head"]["W"], before["head"]["W"])
    assert m.trainer.state.epoch == 3

    m.unfreeze()
    assert m.frozen_layer_names() == []
    before = _weights(m)
    m.fit(x, y, batch_size=32, nb_epoch=2)
    after = _weights(m)
    assert not np.allclose(after["backbone1"]["W"], before["backbone1"]["W"])


def test_freeze_exact_zero_updates_under_adam():
    m = _model()
    m.compile("adam", "mse")
    x, y = _data()
    m.fit(x, y, batch_size=32, nb_epoch=3)
    m.freeze("backbone2")
    before = _weights(m)
    m.fit(x, y, batch_size=32, nb_epoch=2)
    after = _weights(m)
    np.testing.assert_array_equal(after["backbone2"]["W"],
                                  before["backbone2"]["W"])
    assert not np.allclose(after["backbone1"]["W"], before["backbone1"]["W"])
    assert not np.allclose(after["head"]["W"], before["head"]["W"])
    with pytest.raises(ValueError, match="unknown layer"):
        m.freeze("nope")
    with pytest.raises(ValueError, match="unknown layer"):
        m.freeze_up_to(["nope"])
    m.unfreeze(["backbone2"])
    before = _weights(m)
    m.fit(x, y, batch_size=32, nb_epoch=1)
    after = _weights(m)
    assert not np.allclose(after["backbone2"]["W"], before["backbone2"]["W"])


def test_freeze_toggle_preserves_adam_moments():
    m = _model()
    m.compile("adam", "mse")
    x, y = _data()
    m.fit(x, y, batch_size=32, nb_epoch=3)
    before = _moments(m)
    assert any(np.abs(v).max() > 0 for v in before["mu"].values())
    m.freeze("backbone2")
    after = _moments(m)
    for k in before:
        for key in before[k]:
            np.testing.assert_array_equal(after[k][key], before[k][key])
    m.fit(x, y, batch_size=32, nb_epoch=1)
    before = _moments(m)
    m.unfreeze()
    after = _moments(m)
    for k in before:
        for key in before[k]:
            np.testing.assert_array_equal(after[k][key], before[k][key])
    assert m.trainer.optimizer.lr_fn is not None


def test_freeze_up_to_spares_parallel_branches():
    inp = Input(shape=(4,), name="fz_in")
    b1 = Dense(8, activation="relu", name="fz_b1")(inp)
    b2 = Dense(8, activation="relu", name="fz_b2")(b1)
    c1 = Dense(8, activation="relu", name="fz_c1")(inp)
    merged = Merge(mode="concat", concat_axis=-1)([b2, c1])
    out = Dense(2, name="fz_head")(merged)
    m = Model(input=inp, output=out, device="cpu")
    m.freeze_up_to(["fz_b2"])
    frozen = m.frozen_layer_names()
    assert "fz_b1" in frozen and "fz_b2" in frozen
    assert "fz_c1" not in frozen and "fz_head" not in frozen


def test_freeze_persists_through_save_load(tmp_path):
    m = _model()
    m.compile("sgd", "mse")
    x, y = _data()
    m.fit(x, y, batch_size=32, nb_epoch=1)
    m.freeze_up_to(["backbone1"])
    path = str(tmp_path / "frozen.zoo")
    m.save_model(path)
    m2 = load_model(path, device="cpu")
    assert m2.frozen_layer_names() == ["backbone1"]
    before = _weights(m2)
    m2.fit(x, y, batch_size=32, nb_epoch=2)
    after = _weights(m2)
    np.testing.assert_array_equal(after["backbone1"]["W"],
                                  before["backbone1"]["W"])
    assert not np.allclose(after["head"]["W"], before["head"]["W"])


# ---- the fault and the JAX package's statistics --------------------------

def test_freezing_a_layer_after_fit_by_its_flag_trains_on():
    """Pin: the trainer once kept the parameter list it built at the
    first fit from ``requires_grad``, so a layer frozen afterwards by its
    ``trainable`` flag made the next fit raise ("One of the
    differentiated Tensors does not require grad"); and a layer built
    frozen never entered the optimizer state, so unfreezing could not
    train it."""
    x, y = _data()
    m = Sequential(device="cpu")
    m.add(Dense(8, input_shape=(4,), name="a"))
    m.add(Dense(2, name="b"))
    m.compile("adam", "mse")
    m.fit(x, y, batch_size=32, nb_epoch=1)
    m.layers[1].trainable = False
    before = _weights(m)
    m.fit(x, y, batch_size=32, nb_epoch=1)
    after = _weights(m)
    np.testing.assert_array_equal(after["b"]["W"], before["b"]["W"])
    np.testing.assert_array_equal(after["b"]["b"], before["b"]["b"])
    assert not np.allclose(after["a"]["W"], before["a"]["W"])

    built_frozen = Sequential(device="cpu")
    built_frozen.add(Dense(8, input_shape=(4,), name="c", trainable=False))
    built_frozen.add(Dense(2, name="d"))
    built_frozen.compile("adam", "mse")
    w0 = _weights(built_frozen)
    built_frozen.fit(x, y, batch_size=32, nb_epoch=1)
    np.testing.assert_array_equal(_weights(built_frozen)["c"]["W"],
                                  w0["c"]["W"])
    built_frozen.unfreeze()
    built_frozen.fit(x, y, batch_size=32, nb_epoch=1)
    assert not np.allclose(_weights(built_frozen)["c"]["W"], w0["c"]["W"])


def test_moments_and_weights_follow_jax_across_a_toggle():
    """The same model and weights in both packages: adam for 3 epochs,
    freeze backbone2 for 2, unfreeze for 1.  Frozen weights are
    bit-identical across their frozen epochs in both, and every weight
    and adam moment agrees with the JAX package's within 1e-5."""
    x, y = _data()
    jm, tm = _model(jlayers, JSequential()), _model()
    tm.set_weights(jm.get_weights())
    for m in (jm, tm):
        m.compile({"name": "adam", "lr": 1e-2}, "mse")
    steps = [("fit", 3), ("freeze", None), ("fit", 2), ("unfreeze", None),
             ("fit", 1)]
    frozen_before = None
    for op, n in steps:
        for m in (jm, tm):
            if op == "fit":
                m.fit(x, y, batch_size=32, nb_epoch=n, shuffle=False)
            else:
                getattr(m, op)(["backbone2"] if op == "freeze" else None)
        if op == "freeze":
            frozen_before = _weights(tm)["backbone2"]["W"]
        if op == "unfreeze":
            np.testing.assert_array_equal(_weights(tm)["backbone2"]["W"],
                                          frozen_before)
    jw = jax.device_get(jm.get_weights())
    for layer, leaves in _weights(tm).items():
        for key, a in leaves.items():
            np.testing.assert_allclose(a, np.asarray(jw[layer][key]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{layer}/{key}")
    adam = next(s for s in jax.tree_util.tree_leaves(
        jm.trainer.state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))
    ours = _moments(tm)
    for k in ("mu", "nu"):
        ref = jax.device_get(getattr(adam, k))
        for (layer, key), a in ours[k].items():
            np.testing.assert_allclose(a, np.asarray(ref[layer][key]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} {layer}/{key}")
