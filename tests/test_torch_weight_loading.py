"""Pretrained-weight import (``models/weight_loading.py``) on the port,
against the source frameworks and the JAX package, on the CPU.

Counterparts of ``tests/test_weight_loading.py``: inception-v3 in the
registry; a tf.keras InceptionV3 (random init, 96x96, no top) imported
by creation order into the port's ``inception_v3`` (the JAX package's
oracle bound, 1e-3; the case is marked slow there and runs here at
batch 2); structural mismatches raise; a torch ``nn.Sequential`` with
BatchNorm and a bias-free conv imported within 1e-5.  Beyond them: a
small seeded tf.keras CNN with BatchNormalization (moving statistics
set) loaded into both packages gives the keras model's outputs and the
JAX package's within 1e-5, with ``count`` inf; a torch CNN trained on
sklearn's bundled digits, whose Flatten -> Dropout -> Linear head needs
the CHW -> HWC row reorder, keeps its held-out accuracy and decisions
(``tests/test_pretrained_e2e.py``'s torch gate, without ``Net``); and a
functional model whose graph order differs from its creation order
pairs by creation order, as the JAX package pairs.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from analytics_zoo_tpu.core.graph import Input as JInput
from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.models import weight_loading as jwl
from analytics_zoo_tpu.pipeline.api import keras as jkeras
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu_torch.core.graph import Input
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.models import ImageClassifier, to_jax_state
from analytics_zoo_tpu_torch.models.image.classification import inception_v3
from analytics_zoo_tpu_torch.models.weight_loading import (
    _our_layers_by_kind, load_tf_keras_weights, load_torch_state_dict)
from analytics_zoo_tpu_torch.pipeline.api.keras import Model, Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2))


def test_torch_inception_v3_in_registry():
    clf = ImageClassifier("inception-v3", input_shape=(96, 96, 3),
                          num_classes=7, device="cpu")
    x = np.random.RandomState(0).rand(4, 96, 96, 3).astype(np.float32)
    probs = clf.predict(x, batch_size=4)
    assert probs.shape == (4, 7)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-4)


def test_torch_inception_v3_forward_matches_tf_keras():
    tf = pytest.importorskip("tensorflow")
    tf.keras.utils.set_random_seed(0)
    keras_model = tf.keras.applications.InceptionV3(
        weights=None, include_top=False, input_shape=(96, 96, 3),
        pooling="avg")
    ours = inception_v3(input_shape=(96, 96, 3), include_top=False,
                        device="cpu")
    load_tf_keras_weights(ours, keras_model)
    x = np.random.RandomState(0).rand(2, 96, 96, 3).astype(np.float32)
    want = np.asarray(keras_model(x, training=False))
    got = ours.predict(x, batch_size=2)
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_torch_tf_keras_converter_rejects_structural_mismatch():
    tf = pytest.importorskip("tensorflow")
    wrong = tf.keras.Sequential([tf.keras.Input((8,)),
                                 tf.keras.layers.Dense(4)])
    ours = Sequential(device="cpu")
    ours.add(L.Convolution2D(4, 3, 3, input_shape=(6, 6, 3)))
    with pytest.raises(ValueError, match="op-count mismatch"):
        load_tf_keras_weights(ours, wrong)


def test_torch_tf_keras_cnn_with_bn_loads_into_both_packages():
    tf = pytest.importorskip("tensorflow")
    tf.keras.utils.set_random_seed(3)
    km = tf.keras.Sequential([
        tf.keras.Input((10, 10, 3)),
        tf.keras.layers.Conv2D(6, 3, padding="same"),
        tf.keras.layers.BatchNormalization(epsilon=1e-3),
        tf.keras.layers.Activation("relu"),
        tf.keras.layers.Conv2D(4, 3, padding="same", use_bias=False),
        tf.keras.layers.BatchNormalization(scale=False),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(5),
    ])
    rs = np.random.RandomState(3)
    for layer in km.layers:  # moving statistics away from (0, 1)
        if isinstance(layer, tf.keras.layers.BatchNormalization):
            n = layer.moving_mean.shape[0]
            layer.moving_mean.assign(rs.uniform(-0.5, 0.5, n))
            layer.moving_variance.assign(rs.uniform(0.5, 1.5, n))

    def build(mod, device=None):
        m = mod.Sequential(**({"device": device} if device else {}))
        m.add(mod_layers[mod].Convolution2D(6, 3, 3, border_mode="same",
                                            input_shape=(10, 10, 3)))
        m.add(mod_layers[mod].BatchNormalization(epsilon=1e-3))
        m.add(mod_layers[mod].Activation("relu"))
        m.add(mod_layers[mod].Convolution2D(4, 3, 3, border_mode="same",
                                            bias=False))
        m.add(mod_layers[mod].BatchNormalization(epsilon=1e-3))
        m.add(mod_layers[mod].Flatten())
        m.add(mod_layers[mod].Dense(5))
        return m

    import analytics_zoo_tpu_torch.pipeline.api.keras as tkeras
    mod_layers = {tkeras: L, jkeras: jlayers}
    ours = load_tf_keras_weights(build(tkeras, "cpu"), km)
    theirs = jwl.load_tf_keras_weights(build(jkeras), km)
    x = rs.rand(3, 10, 10, 3).astype(np.float32)
    want = np.asarray(km(x, training=False))
    got = ours.predict(x, batch_size=3)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(theirs.predict(x, 3)), **TOL)
    counts = [s["count"] for s in to_jax_state(ours).values()]
    assert len(counts) == 2 and all(np.isinf(c) for c in counts)


def _torch_cnn():
    torch.manual_seed(0)
    t = nn.Sequential(nn.Conv2d(3, 6, 3, padding=1), nn.BatchNorm2d(6),
                      nn.ReLU(), nn.Conv2d(6, 4, 3, padding=1), nn.ReLU(),
                      nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(4, 5))
    with torch.no_grad():
        t[1].running_mean.uniform_(-0.5, 0.5)
        t[1].running_var.uniform_(0.5, 1.5)
    return t.eval()


def test_torch_state_dict_layout_conversion():
    tmodel = _torch_cnn()

    def build(mod, lyr, **kw):
        m = mod.Sequential(**kw)
        m.add(lyr.Convolution2D(6, 3, 3, border_mode="same",
                                input_shape=(10, 10, 3)))
        m.add(lyr.BatchNormalization(epsilon=1e-5))
        m.add(lyr.Activation("relu"))
        m.add(lyr.Convolution2D(4, 3, 3, border_mode="same",
                                activation="relu"))
        m.add(lyr.GlobalAveragePooling2D())
        m.add(lyr.Dense(5))
        return m

    import analytics_zoo_tpu_torch.pipeline.api.keras as tkeras
    ours = load_torch_state_dict(build(tkeras, L, device="cpu"),
                                 tmodel.state_dict())
    theirs = jwl.load_torch_state_dict(build(jkeras, jlayers),
                                       tmodel.state_dict())
    x = np.random.RandomState(0).rand(3, 10, 10, 3).astype(np.float32)
    with torch.no_grad():
        want = tmodel(_nchw(x)).numpy()
    got = ours.predict(x, batch_size=3)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(theirs.predict(x, 3)), **TOL)


def test_torch_bias_free_source_zeroes_our_bias():
    torch.manual_seed(1)
    t = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1, bias=False),
                      nn.AdaptiveAvgPool2d(1), nn.Flatten()).eval()
    ours = Sequential(device="cpu")
    ours.add(L.Convolution2D(4, 3, 3, border_mode="same",
                             input_shape=(6, 6, 3)))
    ours.add(L.GlobalAveragePooling2D())
    with torch.no_grad():
        ours.stack[0].b.fill_(5.0)
    load_torch_state_dict(ours, t.state_dict())
    assert float(ours.stack[0].b.detach().abs().max()) == 0.0
    x = np.random.RandomState(0).rand(2, 6, 6, 3).astype(np.float32)
    with torch.no_grad():
        want = t(_nchw(x)).numpy()
    np.testing.assert_allclose(ours.predict(x, batch_size=2), want,
                               rtol=1e-4, atol=1e-6)


def test_torch_converter_rejects_mismatch():
    ours = Sequential(device="cpu")
    ours.add(L.Dense(4, input_shape=(8,)))
    t = nn.Sequential(nn.Linear(8, 4), nn.Linear(4, 2))
    with pytest.raises(ValueError, match="op-count mismatch"):
        load_torch_state_dict(ours, t.state_dict())
    wrong_width = nn.Sequential(nn.Linear(8, 3))
    with pytest.raises(ValueError, match="shape"):
        load_torch_state_dict(ours, wrong_width.state_dict())


def test_torch_trained_digits_cnn_imports_with_its_accuracy():
    """The torch gate of ``tests/test_pretrained_e2e.py``: a CNN trained
    on sklearn's real digits, its state_dict imported into the
    structurally matching Sequential (the Linear after Flatten and
    Dropout needs the CHW -> HWC reorder)."""
    datasets = pytest.importorskip("sklearn.datasets")
    d = datasets.load_digits()
    x = (d.images / 16.0).astype(np.float32)[..., None]
    y = d.target.astype(np.int64)
    perm = np.random.default_rng(0).permutation(len(x))
    split = int(0.8 * len(x))
    tr, te = perm[:split], perm[split:]
    torch.manual_seed(0)
    tm = nn.Sequential(nn.Conv2d(1, 8, 3), nn.ReLU(), nn.Flatten(),
                       nn.Dropout(0.0), nn.Linear(8 * 6 * 6, 10))
    opt = torch.optim.Adam(tm.parameters(), 1e-2)
    xt, yt = _nchw(x[tr]), torch.from_numpy(y[tr])
    for _ in range(60):
        opt.zero_grad()
        nn.functional.cross_entropy(tm(xt), yt).backward()
        opt.step()
    tm.eval()
    with torch.no_grad():
        src_logits = tm(_nchw(x[te])).numpy()
    src_acc = float((src_logits.argmax(1) == y[te]).mean())
    assert src_acc >= 0.85
    m = Sequential(device="cpu")
    m.add(L.Convolution2D(8, 3, 3, input_shape=(8, 8, 1),
                          activation="relu"))
    m.add(L.Flatten())
    m.add(L.Dropout(0.0))
    m.add(L.Dense(10))
    load_torch_state_dict(m, tm.state_dict())
    logits = m.predict(x[te], batch_size=64)
    np.testing.assert_allclose(logits, src_logits, rtol=1e-5, atol=1e-5)
    assert float((logits.argmax(1) == y[te]).mean()) == src_acc


def test_torch_pairing_follows_creation_order_as_jax():
    """Two branches created in one order and joined in the other: graph
    order and creation order differ, and both packages pair the source's
    convolutions by creation order."""
    def build(lyr, inp, mdl, **kw):
        x = inp((8, 8, 3))
        a = lyr.Convolution2D(4, 3, 3, border_mode="same")   # created 1st
        b = lyr.Convolution2D(4, 1, 1)                        # created 2nd
        hb = b(x)   # used first
        ha = a(x)
        y = lyr.Merge(mode="concat")([hb, ha])
        return mdl(input=x, output=y, **kw)

    torch.manual_seed(2)
    t = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.Conv2d(4, 4, 1))
    with name_scope("pair"):
        ours = build(L, Input, Model, device="cpu")
    with jname_scope("pair"):
        theirs = build(jlayers, JInput, jkeras.Model)
    assert [l.name for l in ours.to_graph().layers] != [
        l.name for l in _our_layers_by_kind(ours)["conv"]]
    assert [l.name for l in _our_layers_by_kind(ours)["conv"]] == [
        l.name for l in jwl._our_layers_by_kind(theirs)["conv"]]
    # the 3x3 conv takes the first torch conv's weights
    sd = {k: v for k, v in t.state_dict().items()}
    sd["1.weight"] = torch.randn(4, 3, 1, 1)
    load_torch_state_dict(ours, sd)
    w3 = _our_layers_by_kind(ours)["conv"][0].W.detach().numpy()
    np.testing.assert_array_equal(
        w3, sd["0.weight"].numpy().transpose(2, 3, 1, 0))
