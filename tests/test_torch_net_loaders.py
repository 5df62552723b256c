"""The port's model loaders against tf.keras, torch and the JAX package.

Counterparts of ``tests/test_net_loaders.py``: a ``.keras``/``.h5`` file
and a live tf.keras model import through ``Net.load_keras`` /
``Net.from_tf_keras`` and serve through ``InferenceModel.load_tf``
(several inputs, integer inputs), held to tf.keras and to the JAX
package's ``TFNet.fn`` (the JAX ``InferenceModel`` does not import in
this process); a frozen ``.pb``; a torch ``state_dict``; the Caffe and
``.t7`` refusals with the JAX package's messages; a zoo save loaded in a
fresh process.  Then level 1 of ``tests/test_pretrained_e2e.py``: a
tf.keras CNN trained on sklearn's digits, saved as ``.h5``, and a torch
CNN's ``state_dict`` reach their source models' held-out accuracy
through the port, with the source's predictions.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp  # noqa: E402

from analytics_zoo_tpu.pipeline.api.net import Net as JNet  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api.net import Net  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.inference import (  # noqa: E402
    InferenceModel)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _keras_model():
    return tf.keras.Sequential([
        tf.keras.layers.Input((12,)),
        tf.keras.layers.Dense(8, activation="relu"),
        tf.keras.layers.Dense(3, activation="softmax"),
    ])


def _jax_fn(jnet, *xs):
    """The JAX package's converted graph on ``xs`` (its TFNet.fn, the
    function its InferenceModel.load_tf serves)."""
    import jax
    out = jnet.fn(jnet.init_params(jax.random.PRNGKey(0), None),
                  *[jnp.asarray(x) for x in xs],
                  rng=jax.random.PRNGKey(0))
    return np.asarray(out[0])


def test_load_keras_file_round_trip(tmp_path):
    km = _keras_model()
    path = str(tmp_path / "model.keras")
    km.save(path)
    net = Net.load_keras(hdf5_path=path, device="cpu")
    x = np.random.RandomState(0).rand(4, 12).astype(np.float32)
    got = net.predict(x)
    np.testing.assert_allclose(got, km(x).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _jax_fn(JNet.load_keras(
        hdf5_path=path), x), rtol=1e-6, atol=1e-6)


def test_from_tf_keras_live_model():
    km = _keras_model()
    net = Net.from_tf_keras(km, device="cpu")
    x = np.random.RandomState(1).rand(6, 12).astype(np.float32)
    np.testing.assert_allclose(net.predict(x), km(x).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_serve_imported_model_multi_input():
    a = tf.keras.layers.Input((4,))
    b = tf.keras.layers.Input((3,))
    out = tf.keras.layers.Dense(2)(tf.keras.layers.Concatenate()([a, b]))
    km = tf.keras.Model([a, b], out)
    serving = InferenceModel(device="cpu")
    serving.load_tf(net=Net.from_tf_keras(km, device="cpu"))
    rs = np.random.RandomState(0)
    x1 = rs.rand(5, 4).astype(np.float32)
    x2 = rs.rand(5, 3).astype(np.float32)
    try:
        got = serving.predict((x1, x2))
    finally:
        serving.close()
    np.testing.assert_allclose(got, km([x1, x2]).numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got, _jax_fn(JNet.from_tf_keras(km), x1, x2),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="pass path"):
        InferenceModel(device="cpu").load_tf()


def test_serve_imported_model_int_inputs():
    """Integer ids reach the served graph's gather as integers."""
    ids = tf.keras.layers.Input((3,), dtype="int32")
    feats = tf.keras.layers.Input((4,))
    emb = tf.keras.layers.Flatten()(tf.keras.layers.Embedding(10, 2)(ids))
    out = tf.keras.layers.Dense(2)(
        tf.keras.layers.Concatenate()([emb, feats]))
    km = tf.keras.Model([ids, feats], out)
    serving = InferenceModel(device="cpu")
    serving.load_tf(net=Net.from_tf_keras(km, device="cpu"))
    rs = np.random.RandomState(0)
    xi = rs.randint(0, 10, (5, 3)).astype(np.int32)
    xf = rs.rand(5, 4).astype(np.float32)
    try:
        got = serving.predict((xi, xf))
    finally:
        serving.close()
    np.testing.assert_allclose(got, km([xi, xf]).numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got, _jax_fn(JNet.from_tf_keras(km), xi, xf),
                               rtol=1e-6, atol=1e-6)


def test_load_tf_frozen_pb_and_folder(tmp_path):
    import tensorflow.compat.v1 as tf1
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, [None, 5], name="inp")
        w = tf1.get_variable("w", [5, 2])
        out = tf1.nn.softmax(tf1.matmul(x, w), name="out")
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            xv = np.random.RandomState(0).rand(3, 5).astype(np.float32)
            want = sess.run(out, {x: xv})
            gd = tf1.graph_util.convert_variables_to_constants(
                sess, g.as_graph_def(), ["out"])
    pb = str(tmp_path / "frozen.pb")
    with open(pb, "wb") as f:
        f.write(gd.SerializeToString())
    net = Net.load_tf(pb, input_names=["inp:0"], output_names=["out:0"],
                      device="cpu")
    np.testing.assert_allclose(net.predict(xv), want, rtol=1e-5, atol=1e-6)
    from analytics_zoo_tpu_torch.pipeline.api.tfgraph.net import write_meta
    folder = tmp_path / "export"
    folder.mkdir()
    os.replace(pb, folder / "frozen_inference_graph.pb")
    write_meta(str(folder), ["inp:0"], ["out:0"])
    im = InferenceModel(device="cpu").load_tf(str(folder))
    try:
        np.testing.assert_allclose(im.predict(xv), want, rtol=1e-5,
                                   atol=1e-6)
    finally:
        im.close()
    np.testing.assert_allclose(
        JNet.load_tf(str(folder)).predict(xv), want, rtol=1e-5, atol=1e-6)


def test_load_torch_state_dict_file(tmp_path):
    import torch.nn as nn
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    t = nn.Sequential(nn.Linear(6, 4), nn.ReLU(), nn.Linear(4, 2))
    path = str(tmp_path / "weights.pt")
    torch.save(t.state_dict(), path)
    ours = Sequential(device="cpu")
    ours.add(Dense(4, activation="relu", input_shape=(6,)))
    ours.add(Dense(2))
    Net.load_torch(path, net=ours)
    x = np.random.RandomState(0).rand(3, 6).astype(np.float32)
    with torch.no_grad():
        want = t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours.predict(x), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="state_dict"):
        Net.load_torch(str(tmp_path / "missing.pt"), net=ours)


@pytest.mark.parametrize("call", [
    lambda N: N.load_torch("/nonexistent.t7"),
    lambda N: N.load_caffe("a.prototxt", "b.caffemodel")])
def test_legacy_format_refusals_match_jax(call):
    with pytest.raises(NotImplementedError) as ours:
        call(Net)
    with pytest.raises(NotImplementedError) as ref:
        call(JNet)
    assert str(ours.value) == str(ref.value)


def test_net_load_zoo_model_in_fresh_process(tmp_path):
    """Net.load of a zoo-family save works in a process that never
    imported ``analytics_zoo_tpu_torch.models`` (the model class resolves
    on demand)."""
    save = f"""
from analytics_zoo_tpu_torch.models import ImageClassifier
m = ImageClassifier("squeezenet", input_shape=(32, 32, 1), num_classes=3,
                    device="cpu")
m.save_model({str(tmp_path / 'm')!r})
print("SAVED")
"""
    load = f"""
import sys
from analytics_zoo_tpu_torch.pipeline.api.net import Net
assert "analytics_zoo_tpu_torch.models" not in sys.modules, "premature"
net = Net.load({str(tmp_path / 'm')!r}, device="cpu")
import numpy as np
p = net.predict(np.zeros((2, 32, 32, 1), np.float32), batch_size=2)
assert p.shape == (2, 3), p.shape
print("LOADED", type(net).__name__)
"""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    for script, marker in [(save, "SAVED"), (load, "LOADED ImageClassifier")]:
        proc = subprocess.run([sys.executable, "-c", script],
                              capture_output=True, text=True, timeout=300,
                              env=env, cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr[-1500:]
        assert marker in proc.stdout


# ---- level 1 of tests/test_pretrained_e2e.py -------------------------------

def _digits_data():
    from sklearn.datasets import load_digits
    d = load_digits()
    x = (d.images / 16.0).astype(np.float32)[..., None]
    y = d.target.astype(np.int32)
    perm = np.random.default_rng(0).permutation(len(x))
    split = int(0.8 * len(x))
    return (x[perm[:split]], y[perm[:split]],
            x[perm[split:]], y[perm[split:]])


def test_trained_h5_checkpoint_reaches_source_accuracy(tmp_path):
    x_tr, y_tr, x_te, y_te = _digits_data()
    tf.keras.utils.set_random_seed(0)
    km = tf.keras.Sequential([
        tf.keras.layers.Input((8, 8, 1)),
        tf.keras.layers.Conv2D(16, 3, activation="relu"),
        tf.keras.layers.Conv2D(16, 3, activation="relu"),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(64, activation="relu"),
        tf.keras.layers.Dense(10, activation="softmax"),
    ])
    km.compile("adam", "sparse_categorical_crossentropy",
               metrics=["accuracy"])
    km.fit(x_tr, y_tr, epochs=8, batch_size=64, verbose=0)
    src_acc = float(km.evaluate(x_te, y_te, verbose=0)[1])
    assert src_acc >= 0.93, f"source model undertrained: {src_acc}"
    ckpt = str(tmp_path / "digits_cnn.h5")
    km.save(ckpt)
    probs = Net.load_keras(hdf5_path=ckpt, device="cpu").predict(x_te)
    our_acc = float(np.mean(np.argmax(probs, axis=1) == y_te))
    assert abs(our_acc - src_acc) <= 0.01, (our_acc, src_acc)
    src_probs = km.predict(x_te, verbose=0)
    agree = np.mean(np.argmax(probs, 1) == np.argmax(src_probs, 1))
    assert agree >= 0.99, agree
    np.testing.assert_allclose(probs, src_probs, rtol=1e-4, atol=1e-5)


def test_trained_torch_state_dict_reaches_source_accuracy(tmp_path):
    import torch.nn as nn
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Convolution2D, Dense, Dropout, Flatten)
    x_tr, y_tr, x_te, y_te = _digits_data()
    torch.manual_seed(0)
    xt = torch.tensor(x_tr).permute(0, 3, 1, 2)
    yt = torch.tensor(y_tr, dtype=torch.long)
    tm = nn.Sequential(nn.Conv2d(1, 8, 3), nn.ReLU(), nn.Flatten(),
                       nn.Dropout(0.0), nn.Linear(8 * 6 * 6, 10))
    opt = torch.optim.Adam(tm.parameters(), 1e-3)
    for _ in range(60):
        opt.zero_grad()
        nn.CrossEntropyLoss()(tm(xt), yt).backward()
        opt.step()
    with torch.no_grad():
        src_logits = tm(torch.tensor(x_te).permute(0, 3, 1, 2)).numpy()
    src_acc = float((src_logits.argmax(1) == y_te).mean())
    assert src_acc >= 0.85, src_acc
    ckpt = str(tmp_path / "digits_torch.pt")
    torch.save(tm.state_dict(), ckpt)
    m = Sequential(device="cpu")
    m.add(Convolution2D(8, 3, 3, input_shape=(8, 8, 1), activation="relu"))
    m.add(Flatten())
    m.add(Dropout(0.0))
    m.add(Dense(10))
    Net.load_torch(ckpt, net=m)
    logits = m.predict(x_te, batch_size=64)
    our_acc = float(np.mean(np.argmax(logits, 1) == y_te))
    assert abs(our_acc - src_acc) <= 0.01, (our_acc, src_acc)
    np.testing.assert_array_equal(np.argmax(logits, 1),
                                  np.argmax(src_logits, 1))
