"""LeNet on the port: the counterpart of every assertion of
``tests/test_lenet_e2e.py`` on ``device="cpu"``, and parity with the JAX
package.

The LeNet definition is the reference's, unchanged; only the
``Sequential`` takes ``device="cpu"`` (its default is ``"cuda"``).  For
parity both packages build it inside ``name_scope("lenet")``, so their
layers get the same names, and the JAX model's weights go into the port:
``predict`` agrees within 1e-5, and 5 adam steps (``shuffle=False``,
``Dropout(0.0)``) give losses within 1e-5 relative.
"""

import numpy as np
import pytest
import jax

from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.pipeline.api.keras import (Sequential,
                                                        load_model)
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from analytics_zoo_tpu_torch.train.checkpoint import latest_tag
from analytics_zoo_tpu_torch.train.summary import read_scalars


def make_data(n=512, classes=10, seed=0):
    """Synthetic separable 'MNIST': class-dependent blobs (the recipe of
    tests/test_lenet_e2e.py)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=n)
    x = rng.normal(0, 0.3, size=(n, 28, 28, 1)).astype(np.float32)
    for i in range(n):
        c = y[i]
        x[i, 2 * c:2 * c + 3, 2 * c:2 * c + 3, 0] += 2.0
    return x, y.astype(np.int32)


def build_lenet(model, layers=tlayers, dropout=0.1):
    """tests/test_lenet_e2e.py's LeNet, added to ``model``."""
    model.add(layers.Convolution2D(6, 5, 5, activation="relu",
                                   border_mode="same",
                                   input_shape=(28, 28, 1)))
    model.add(layers.MaxPooling2D())
    model.add(layers.Convolution2D(16, 5, 5, activation="relu"))
    model.add(layers.MaxPooling2D())
    model.add(layers.Flatten())
    model.add(layers.Dense(120, activation="relu"))
    model.add(layers.Dropout(dropout))
    model.add(layers.Dense(84, activation="relu"))
    model.add(layers.Dense(10, activation="softmax"))
    return model


def lenet():
    return build_lenet(Sequential(device="cpu"))


def test_lenet_trains_and_validates(tmp_path):
    x, y = make_data(512)
    xv, yv = make_data(128, seed=1)
    model = lenet()
    assert model.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in model.parameters())
    model.set_tensorboard(str(tmp_path / "logs"), "lenet")
    model.set_checkpoint(str(tmp_path / "ckpts"))
    model.compile(optimizer={"name": "adam", "lr": 1e-3},
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    history = model.fit(x, y, batch_size=64, nb_epoch=3,
                        validation_data=(xv, yv))
    losses = history["loss"]
    assert len(losses) == 3 * (512 // 64)
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert history["val"], "validation should run every epoch"
    acc = history["val"][-1]["accuracy"]
    assert acc > 0.5, f"synthetic-blob accuracy should be high, got {acc}"

    # incremental fit continues epochs
    h2 = model.fit(x, y, batch_size=64, nb_epoch=1)
    assert model.trainer.state.epoch == 4
    assert len(h2["loss"]) == 512 // 64

    # tensorboard scalars got written, and read back
    logs = list((tmp_path / "logs" / "lenet" / "train").iterdir())
    assert any(f.name.startswith("events.out.tfevents") for f in logs)
    loss_log = read_scalars(str(tmp_path / "logs"), "lenet", "Loss")
    assert [s for s, _ in loss_log] == list(range(1, 4 * 8 + 1))
    np.testing.assert_allclose([v for _, v in loss_log],
                               losses + h2["loss"], rtol=1e-6)
    assert len(read_scalars(str(tmp_path / "logs"), "lenet", "accuracy",
                            split="validation")) == 3

    # checkpoints appeared (epoch-triggered), one per epoch
    assert any(f.suffix == ".npz" for f in (tmp_path / "ckpts").iterdir())
    assert latest_tag(str(tmp_path / "ckpts")) == "epoch4"


def test_lenet_checkpoint_restores_training_state(tmp_path):
    """An epoch checkpoint restores weights, optimizer state and counters
    into a model built from another seed: the next epoch's losses are the
    same (without dropout, whose masks the checkpoint does not hold)."""
    x, y = make_data(128)
    runs = []
    for resume in (False, True):
        model = build_lenet(Sequential(device="cpu", seed=int(resume)),
                            dropout=0.0)
        model.set_checkpoint(str(tmp_path / "ckpts"))
        model.compile(optimizer="adam",
                      loss="sparse_categorical_crossentropy")
        if resume:
            model.trainer.load_weights(str(tmp_path / "ckpts"), "epoch1")
            assert model.trainer.state.epoch == 1
            assert model.trainer.state.step == 2
        else:
            model.fit(x, y, batch_size=64, nb_epoch=1)
        runs.append(model.fit(x, y, batch_size=64, nb_epoch=1)["loss"])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6)


def test_lenet_predict_evaluate():
    x, y = make_data(256)
    model = lenet()
    model.compile(optimizer="adam",
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy", "top5accuracy"])
    model.fit(x, y, batch_size=64, nb_epoch=2, verbose=False)
    probs = model.predict(x[:100], batch_size=64)
    assert probs.shape == (100, 10)
    np.testing.assert_allclose(np.sum(probs, axis=1), 1.0, rtol=1e-4)
    classes = model.predict_classes(x[:100])
    assert classes.shape == (100,)
    results = model.evaluate(x, y, batch_size=64)
    assert set(results) >= {"accuracy", "top5accuracy", "loss"}
    one_based = model.predict_classes(x[:10], zero_based_label=False)
    assert (one_based == classes[:10] + 1).all()


def test_save_load_roundtrip(tmp_path):
    x, y = make_data(128)
    model = lenet()
    model.compile(optimizer="adam",
                  loss="sparse_categorical_crossentropy")
    model.fit(x, y, batch_size=64, nb_epoch=1)
    ref = model.predict(x[:64], batch_size=64)
    model.save_model(str(tmp_path / "model"))

    loaded = load_model(str(tmp_path / "model"), device="cpu")
    out = loaded.predict(x[:64], batch_size=64)
    np.testing.assert_allclose(ref, out, rtol=1e-5, atol=1e-5)
    assert [l.name for l in loaded.layers] == [l.name for l in model.layers]
    assert loaded.trainer is not None  # compiled again from the config


def test_topology_api_parity():
    """get_layer / to_model / clear_gradient_clipping."""
    x, y = make_data(128)
    model = lenet()
    model.set_gradient_clipping_by_l2_norm(1.0)
    model.clear_gradient_clipping()
    assert model._clip_norm is None and model._clip_value is None
    model.compile(optimizer="adam",
                  loss="sparse_categorical_crossentropy")
    model.fit(x, y, batch_size=64, nb_epoch=1)

    dense = [l for l in model.to_graph().layers
             if type(l).__name__ == "Dense"][0]
    assert model.get_layer(dense.name) is dense
    with pytest.raises(ValueError, match="no layer named"):
        model.get_layer("nope")

    # Sequential -> functional Model keeps the trained weights
    as_model = model.to_model()
    ref = model.predict(x[:32], batch_size=32)
    out = as_model.predict(x[:32], batch_size=32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def _parity_pair(dropout=0.0):
    """The same LeNet in both packages, compiled alike, the JAX model's
    initial weights loaded into the port's."""
    compile_kw = dict(optimizer={"name": "adam", "lr": 1e-3},
                      loss="sparse_categorical_crossentropy")
    with jname_scope("lenet"):
        jm = build_lenet(JSequential(), jlayers, dropout)
    jm.compile(**compile_kw)
    with name_scope("lenet"):
        tm = build_lenet(Sequential(device="cpu"), tlayers, dropout)
    tm.compile(**compile_kw)
    weights = jax.device_get(jm.get_weights())
    assert list(tm.get_weights()) == sorted(weights)
    tm.set_weights(weights)
    return jm, tm


def test_lenet_predict_matches_jax():
    jm, tm = _parity_pair(dropout=0.1)
    x, _ = make_data(64, seed=3)
    ref = np.asarray(jm.predict(x, batch_size=32))
    out = tm.predict(x, batch_size=32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_lenet_adam_trajectory_matches_jax():
    """5 adam steps on the same batches: losses within 1e-5 relative, and
    the weights after them within 1e-5."""
    jm, tm = _parity_pair(dropout=0.0)
    x, y = make_data(40, seed=4)
    ref = jm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    out = tm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)["loss"]
    assert len(out) == len(ref) == 5
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)
    jw = jax.device_get(jm.get_weights())
    for layer, leaves in tm.get_weights().items():
        for k, v in leaves.items():
            np.testing.assert_allclose(v, np.asarray(jw[layer][k]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{layer}/{k}")
