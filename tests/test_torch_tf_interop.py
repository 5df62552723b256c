"""The port's TF interop against the JAX package's and TF's own runtime.

The port's GraphDef codec (``tfgraph/proto.py``) decodes TF's
``SerializeToString`` bytes to TF's own nodes, attributes and tensors,
and graphs it encodes parse and run in TF.  Graphs that TF freezes (as
``tests/test_tf_interop.py`` builds them, and a sweep over the rest of
the converter's table) run through both converters on the same inputs
(1e-6, 1e-5 for convolution, pooling, resizing and normalisation) and
against ``sess.run``.  ``TFOptimizer`` (a regression, and a classifier
with dropout and validation) follows the JAX ``TFOptimizer`` within
1e-5; the dropout graph's ``RandomUniform`` is one fixed draw in both
packages there, since their random streams differ.  ``TFPredictor``,
``TFDataset``'s divisibility and the unsupported-op message close it.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
tf1 = tf.compat.v1

import jax.numpy as jnp  # noqa: E402

from analytics_zoo_tpu.pipeline.api import tfgraph as J  # noqa: E402
from analytics_zoo_tpu.pipeline.api.tfgraph import converter as jconv  # noqa: E402
from analytics_zoo_tpu.pipeline.api.keras.metrics import (  # noqa: E402
    Accuracy as JAccuracy)
from analytics_zoo_tpu.train.triggers import MaxEpoch as JMaxEpoch  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api import tfgraph as T  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import Accuracy  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api.tfgraph import converter as tconv  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api.tfgraph import dataset as tds  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api.tfgraph import proto as P  # noqa: E402
from analytics_zoo_tpu_torch.train.triggers import MaxEpoch  # noqa: E402


def _freeze(build, feeds):
    """Build a graph with ``build() -> (inputs, outputs)``, initialise its
    variables (graph seed 0) and freeze it: (GraphDef, input names,
    output names, sess.run's outputs on ``feeds``)."""
    g = tf.Graph()
    with g.as_default():
        tf1.set_random_seed(0)
        ins, outs = build()
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            want = sess.run(outs, dict(zip(ins, feeds)))
            gd = tf1.graph_util.convert_variables_to_constants(
                sess, g.as_graph_def(), [o.op.name for o in outs])
    return gd, [t.name for t in ins], [t.name for t in outs], want


# ---- the codec ---------------------------------------------------------------

def _sample_graph():
    def build():
        x = tf1.placeholder(tf.float32, [None, 6, 6, 3], name="x")
        k = tf1.get_variable("k", [3, 3, 3, 4])
        h = tf.nn.conv2d(x, k, strides=[1, 2, 2, 1], padding="SAME")
        h = tf.nn.bias_add(h, tf.constant([0.1, 0.2, 0.3, 0.4]))
        h = tf.cast(h, tf.float16)
        h = tf.cast(h, tf.bfloat16)
        h = tf.cast(h, tf.float32)
        h = tf.reshape(h, [-1, 36]) * tf.constant(2.0)
        flags = tf.constant([True, False])
        ids = tf.constant([[1, 2], [3, 4]], tf.int64)
        half = tf.constant(np.full((2, 2), 0.5, np.float16))
        out = tf.identity(h, name="out")
        return [x], [out, flags, ids, half]
    return _freeze(build, [np.ones((1, 6, 6, 3), np.float32)])


def test_codec_decodes_tf_bytes_to_tf_contents():
    gd, _, _, _ = _sample_graph()
    ours = P.parse_graph_def(gd.SerializeToString())
    assert [(n.name, n.op, list(n.input)) for n in ours.node] == \
        [(n.name, n.op, list(n.input)) for n in gd.node]
    for mine, theirs in zip(ours.node, gd.node):
        assert set(mine.attr) == set(theirs.attr), mine.name
        for key, a in theirs.attr.items():
            b = mine.attr[key]
            which = a.WhichOneof("value")
            assert b.which() == which, (mine.name, key)
            if which == "tensor":
                want = tf.make_ndarray(a.tensor)
                got = P.tensor_to_numpy(b.tensor)
                if a.tensor.dtype == tf.bfloat16.as_datatype_enum:
                    want = want.astype(np.float32)
                assert got.shape == want.shape
                np.testing.assert_array_equal(got, want)
            elif which == "type":
                assert P.base_dtype(b.type) == a.type
            elif which == "list":
                assert list(b.list.i) == list(a.list.i)
                assert list(b.list.s) == list(a.list.s)
            elif which == "shape":
                assert P.shape_of(b.shape) == tuple(
                    d.size for d in a.shape.dim)
            else:
                assert getattr(b, which) == getattr(a, which)
    # re-encoding the port's decode parses in TF to the same nodes (the
    # function library, empty here, is not among the codec's messages)
    again = tf1.GraphDef()
    again.ParseFromString(P.encode(ours))
    assert list(again.node) == list(gd.node)
    assert again.versions == gd.versions


def test_codec_graphs_encoded_here_parse_and_run_in_tf():
    """A graph built with the port's codec alone runs in TF and in the
    port's converter alike."""
    w = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    gd = P.make_graph([
        P.placeholder("x", (None, 4)),
        P.const("w", w),
        P.const("b", np.float32(0.5)),
        P.const("axes", np.array([1], np.int32)),
        P.make_node("MatMul", "mm", ["x", "w"], T=np.float32,
                    transpose_a=False, transpose_b=False),
        P.make_node("AddV2", "add", ["mm", "b"], T=np.float32),
        P.make_node("Mean", "out", ["add", "axes"], T=np.float32,
                    Tidx=np.int32, keep_dims=False),
    ])
    data = P.encode(gd)
    parsed = tf1.GraphDef()
    parsed.ParseFromString(data)
    assert parsed.node[4].attr["transpose_a"].WhichOneof("value") == "b"
    x = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    g = tf.Graph()
    with g.as_default():
        tf1.import_graph_def(parsed, name="")
        with tf1.Session(graph=g) as sess:
            want = sess.run("out:0", {"x:0": x})
    fn = tconv.ConvertedGraph(data, ["x:0"], ["out:0"])
    (got,) = fn({}, x, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---- the op sweep --------------------------------------------------------------

def _r(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _mlp():
    x = tf1.placeholder(tf.float32, [None, 10], name="x")
    w1 = tf1.get_variable("w1", [10, 16])
    b1 = tf1.get_variable("b1", [16], initializer=tf1.zeros_initializer())
    h = tf.nn.relu(tf.matmul(x, w1) + b1)
    w2 = tf1.get_variable("w2", [16, 4])
    return [x], [tf.nn.softmax(tf.matmul(h, w2), name="probs")]


def _convnet():
    x = tf1.placeholder(tf.float32, [None, 12, 12, 3], name="img")
    k = tf1.get_variable("k", [3, 3, 3, 8])
    h = tf.nn.conv2d(x, k, strides=[1, 1, 1, 1], padding="SAME")
    h = tf.nn.bias_add(h, tf1.get_variable(
        "cb", [8], initializer=tf1.zeros_initializer()) + 0.1)
    h = tf.nn.relu(h)
    h = tf.nn.max_pool2d(h, 2, 2, "VALID")
    h = tf.nn.avg_pool2d(h, 3, 2, "SAME")
    h = tf.reshape(h, [-1, int(np.prod(h.shape[1:]))])
    w = tf1.get_variable("w", [int(h.shape[1]), 5])
    return [x], [tf.nn.log_softmax(tf.matmul(h, w), name="out")]


def _tensor_ops():
    x = tf1.placeholder(tf.float32, [None, 6, 4], name="x")
    a = tf.transpose(x, [0, 2, 1])
    b = tf.concat([x[:, :2, :], x[:, 2:4, :]], axis=1)
    c = tf.pad(b, [[0, 0], [1, 1], [0, 0]])
    d = tf.reduce_mean(c, axis=2, keepdims=True)
    e = tf.expand_dims(tf.squeeze(d, axis=2), -1)
    f = tf.sigmoid(e) * tf.tanh(e) + tf.sqrt(tf.abs(e) + 1.0)
    gthr = tf.gather(x, [0, 2], axis=2)
    sl = x[:, 1:5:2, ::-1]
    return [x], [tf.reduce_sum(f, axis=[1, 2], name="o1"),
                 tf.reshape(tf.matmul(a, gthr), [-1], name="o2"),
                 tf.reduce_max(sl, axis=1, name="o3")]


def _batchnorm():
    x = tf1.placeholder(tf.float32, [None, 8, 8, 4], name="x")
    scale = tf1.get_variable("scale", [4], initializer=tf1.ones_initializer())
    offset = tf1.get_variable("offset", [4],
                              initializer=tf1.zeros_initializer())
    mean = tf1.get_variable("mean", [4],
                            initializer=tf1.random_normal_initializer())
    var = tf1.get_variable("var", [4], initializer=tf1.ones_initializer())
    h, _, _ = tf1.nn.fused_batch_norm(x, scale, offset, mean + 0.3,
                                      var + 0.5, is_training=False)
    return [x], [tf.identity(h, name="out")]


def _strided_convs():
    """TF SAME at stride 2 (odd sizes: the extra row/column at the end),
    depthwise, Conv2DBackpropInput, pools, resizes."""
    x = tf1.placeholder(tf.float32, [None, 11, 9, 3], name="x")
    k = tf1.get_variable("k", [3, 3, 3, 5])
    h = tf.nn.conv2d(x, k, strides=[1, 2, 2, 1], padding="SAME")
    dw = tf1.get_variable("dw", [3, 3, 5, 2])
    h2 = tf.nn.depthwise_conv2d(h, dw, [1, 1, 1, 1], "SAME")
    kt = tf1.get_variable("kt", [3, 3, 4, 10])
    up = tf.nn.conv2d_transpose(h2, kt, [tf.shape(x)[0], 12, 10, 4],
                                [1, 2, 2, 1], "SAME")
    mp = tf.nn.max_pool2d(x, 3, 2, "SAME")
    ap = tf.nn.avg_pool2d(x, 3, 2, "SAME")
    shrink = tf1.image.resize_bilinear(x, [5, 4])
    grow = tf1.image.resize_bilinear(x, [15, 13])
    near = tf1.image.resize_nearest_neighbor(x, [7, 12])
    return [x], [tf.identity(h2, "dwc"), tf.identity(up, "up"),
                 tf.identity(mp, "mp"), tf.identity(ap, "ap"),
                 tf.identity(shrink, "shrink"), tf.identity(grow, "grow"),
                 tf.identity(near, "near")]


def _math_ops():
    x = tf1.placeholder(tf.float32, [None, 5], name="x")
    y = tf.abs(x) + 0.5
    outs = [tf.math.floordiv(x, y), tf.math.floormod(x, y),
            tf.math.squared_difference(x, y), tf.math.rsqrt(y),
            tf.math.log1p(y), tf.nn.relu6(x * 4.0),
            tf.nn.leaky_relu(x, 0.3), tf.nn.elu(x), tf.nn.selu(x),
            tf.nn.softplus(x), tf.nn.softsign(x), tf.nn.l2_loss(x),
            tf.maximum(x, y - 1.0), tf.minimum(x, 0.2), tf.pow(y, 1.5),
            tf.math.divide_no_nan(x, tf.round(x)), tf.math.reciprocal(y),
            tf.math.erf(x), tf.sin(x), tf.cos(x), tf.exp(x),
            tf.math.log(y), tf.square(x), tf.negative(x), tf.sign(x),
            tf.floor(x), tf.math.ceil(x), tf.add_n([x, y, x]),
            x - y, x / y, tf.math.truediv(x, y),
            tf.cast(x > 0, tf.float32) + tf.cast(x <= 0.5, tf.float32),
            tf.cast(tf.logical_and(x > -1, x < 1), tf.int32),
            tf.cast(tf.logical_or(x > 1, tf.logical_not(x < -1)), tf.int32),
            tf.cast(tf.equal(tf.round(x), 0.0), tf.int32)
            + tf.cast(tf.not_equal(tf.round(x), 1.0), tf.int32)
            + tf.cast(x >= 0, tf.int32) + tf.cast(x < 0, tf.int32),
            tf.nn.softmax(x), tf.nn.log_softmax(x)]
    return [x], [tf.identity(o, f"m{i}") for i, o in enumerate(outs)]


def _shape_ops():
    x = tf1.placeholder(tf.float32, [None, 6, 4], name="x")
    ids = tf1.placeholder(tf.int32, [None, 3], name="ids")
    n = tf.shape(x)[0]
    parts = tf.split(x, 2, axis=1)
    pv = tf.split(x, [1, 3], axis=2)
    st = tf.stack([parts[0], parts[1]], axis=1)
    un = tf.unstack(x, axis=2)
    outs = [
        tf.reshape(st, tf.stack([n, -1])), pv[1], un[3],
        tf.tile(parts[0], [1, 2, 1]), tf.fill(tf.stack([n, 2]), 3.0)
        + tf.reduce_sum(x, [1, 2])[:, None],
        tf.cast(tf.range(0, 5, 2), tf.float32)[None, :] + x[:, 0, :3][:, :1],
        tf.one_hot(ids, 5, on_value=2.0, off_value=-1.0, axis=1),
        tf.math.top_k(x[:, :, 0], k=3)[0],
        tf.cast(tf.math.top_k(x[:, :, 0], k=3)[1], tf.float32),
        tf.cast(tf.argmax(x, axis=1), tf.float32),
        tf.cast(tf.argmin(x, axis=2, output_type=tf.int32), tf.float32),
        tf.where(x > 0, x, -x),
        tf1.where(x[:, 0, 0] > 0, x[:, 0, :], x[:, 1, :]),
        tf.matmul(x, x, transpose_b=True),
        tf.einsum("bij,bkj->bik", x, x),
        tf.pad(x, [[0, 0], [2, 1], [1, 0]], mode="REFLECT"),
        tf.pad(x, [[0, 0], [1, 2], [0, 1]], mode="SYMMETRIC"),
        tf.pad(x, [[0, 0], [1, 0], [0, 2]], constant_values=-3.0),
        tf.gather(x, tf.tile(ids[:, None, :2] % 4, [1, 6, 1]), axis=2,
                  batch_dims=2),
        tf.slice(x, [0, 1, 1], [-1, 3, 2]),
        x[:, None, ..., 1:3],
        tf.cast(tf.reduce_all(x > -1.5, axis=1), tf.float32),
        tf.cast(tf.reduce_any(x > 1.5, axis=[1]), tf.float32),
        tf.reduce_prod(x, axis=2), tf.reduce_min(x, axis=[1, 2]),
        tf.zeros_like(x) + tf.ones_like(x),
        tf.broadcast_to(x[:, :1, :], tf.stack([n, 3, 4])),
        tf.nn.sparse_softmax_cross_entropy_with_logits(
            labels=ids[:, 0] % 4, logits=x[:, 0, :]),
        tf.nn.softmax_cross_entropy_with_logits(
            labels=tf.nn.softmax(x[:, 1, :]), logits=x[:, 0, :]),
        tf.stop_gradient(x) * tf.cast(tf.size(x), tf.float32)
        / tf.cast(tf.rank(x), tf.float32),
    ]
    return [x, ids], [tf.identity(o, f"s{i}") for i, o in enumerate(outs)]


SWEEP = {
    "mlp": (_mlp, [_r(6, 10)], 1e-6),
    "convnet": (_convnet, [_r(4, 12, 12, 3, seed=1)], 1e-5),
    "tensor_ops": (_tensor_ops, [_r(3, 6, 4, seed=2)], 1e-6),
    "batchnorm": (_batchnorm, [_r(2, 8, 8, 4, seed=3)], 1e-5),
    "strided_convs": (_strided_convs, [_r(2, 11, 9, 3, seed=4)], 1e-5),
    "math_ops": (_math_ops, [_r(4, 5, seed=5)], 1e-6),
    "shape_ops": (_shape_ops, [_r(3, 6, 4, seed=6), np.random.default_rng(
        7).integers(0, 9, (3, 3)).astype(np.int32)], 1e-6),
}


@pytest.mark.parametrize("key", sorted(SWEEP))
def test_frozen_graph_matches_jax_converter_and_session(key):
    build, feeds, tol = SWEEP[key]
    gd, ins, outs, want = _freeze(build, feeds)
    ours = tconv.ConvertedGraph(P.parse_graph_def(gd.SerializeToString()),
                                ins, outs)
    ref = jconv.ConvertedGraph(gd, ins, outs)
    got = ours({}, *feeds, device="cpu")
    jgot = ref({}, *[jnp.asarray(f) for f in feeds])
    for name, g, j, w in zip(outs, got, jgot, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g)
        j = np.asarray(j)
        assert g.shape == j.shape, (name, g.shape, j.shape)
        np.testing.assert_allclose(g, j, rtol=tol, atol=tol, err_msg=name)
        # and TF's own runtime (its resizes and SAME deconvolution differ
        # from the JAX package's by design: held to the JAX side only)
        if name.split(":")[0] not in ("shrink", "grow", "near", "up"):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=name)


def test_sweep_covers_the_jax_table():
    """Every op of the JAX converter's table has a port handler, and the
    frozen sweep reaches most of them."""
    assert set(tconv._H) == set(jconv._H)
    seen = set()
    for build, feeds, _ in SWEEP.values():
        gd, _, _, _ = _freeze(build, feeds)
        seen |= {n.op for n in gd.node}
    assert len(seen & set(jconv._H)) >= 90, sorted(set(jconv._H) - seen)


def test_tfnet_from_session_and_export_round_trip(tmp_path):
    g = tf.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, [None, 7], name="x")
        w = tf1.get_variable("w", [7, 3])
        out = tf.nn.elu(tf.matmul(x, w), name="out")
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            xv = np.random.RandomState(4).randn(5, 7).astype(np.float32)
            want = sess.run(out, {x: xv})
            folder = T.export_tf(sess, str(tmp_path / "export"), [x], [out])
            live = T.TFNet.from_session(sess, [x], [out], freeze=False,
                                        device="cpu")
            frozen = T.TFNet.from_session(sess, [x], [out], device="cpu")
    net = T.TFNet(folder, device="cpu")
    jnet = J.TFNet(folder)
    np.testing.assert_allclose(net.predict(xv), jnet.predict(xv),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(net.predict(xv), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(frozen.predict(xv), want, rtol=1e-5,
                               atol=1e-5)
    assert list(live.params()) == ["w"] and live.params()["w"].requires_grad
    np.testing.assert_allclose(live.predict(xv), want, rtol=1e-5, atol=1e-5)
    assert net.compute_output_shape((None, 7)) == (None, 3)


def _regression_graph(X, Y, pkg):
    g = tf.Graph()
    with g.as_default():
        ds = pkg.TFDataset.from_ndarray([X, Y], batch_size=32)
        x, y = ds.tensors
        w = tf1.get_variable("w", [4, 1], initializer=tf1.zeros_initializer())
        b = tf1.get_variable("b", [1], initializer=tf1.zeros_initializer())
        pred = tf.matmul(x, w) + b
        loss = tf.reduce_mean(tf.square(pred - y), name="mse")
    return loss, w


def test_tfoptimizer_regression_follows_jax():
    rs = np.random.RandomState(5)
    X = rs.randn(256, 4).astype(np.float32)
    Y = X @ np.array([[1.5], [-2.0], [0.5], [3.0]], np.float32) + 0.25
    jloss, jw = _regression_graph(X, Y, J)
    jopt = J.TFOptimizer(jloss, {"name": "sgd", "lr": 0.1})
    ref = jopt.optimize(JMaxEpoch(6))
    loss, w = _regression_graph(X, Y, T)
    opt = T.TFOptimizer(loss, {"name": "sgd", "lr": 0.1}, device="cpu")
    out = opt.optimize(MaxEpoch(6))
    assert len(out["loss"]) == len(ref["loss"]) == 48
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5,
                               atol=1e-7)
    assert out["loss"][-1] < 0.05
    np.testing.assert_allclose(opt.sess.run(w), jopt.sess.run(jw),
                               rtol=1e-5, atol=1e-6)
    opt.sess.close()
    jopt.sess.close()


def _classifier_graph(X, labels, pkg):
    g = tf.Graph()
    with g.as_default():
        ds = pkg.TFDataset.from_ndarray([X, labels], batch_size=32,
                                        val_tensors=[X, labels])
        x, y = ds.tensors
        init = lambda shape, s: tf1.constant_initializer(
            np.random.default_rng(s).normal(0, 0.3, shape))
        w1 = tf1.get_variable("w1", [12, 32], initializer=init((12, 32), 0))
        b1 = tf1.get_variable("b1", [32], initializer=tf1.zeros_initializer())
        h = tf.nn.relu(tf.matmul(x, w1) + b1)
        h = tf.nn.dropout(h, rate=0.1)
        w2 = tf1.get_variable("w2", [32, 3], initializer=init((32, 3), 1))
        b2 = tf1.get_variable("b2", [3], initializer=tf1.zeros_initializer())
        logits = tf.matmul(h, w2) + b2
        loss = tf.reduce_mean(
            tf.nn.sparse_softmax_cross_entropy_with_logits(
                labels=y, logits=logits), name="loss")
    return loss, logits, y


def _fixed_uniform(shape):
    return np.random.default_rng(123).uniform(size=shape).astype(np.float32)


def test_tfoptimizer_classifier_with_dropout_follows_jax(monkeypatch):
    monkeypatch.setitem(
        jconv._H, "RandomUniform", lambda ctx, node, args: jnp.asarray(
            _fixed_uniform(tuple(np.asarray(args[0])))))
    monkeypatch.setitem(
        tconv._H, "RandomUniform", lambda ctx, node, args: torch.as_tensor(
            _fixed_uniform(tuple(np.asarray(args[0]))), device=ctx.device))
    rs = np.random.RandomState(6)
    X = rs.randn(256, 12).astype(np.float32)
    labels = (np.abs(X[:, :3]).argmax(axis=1)).astype(np.int32)
    jl, jlogits, jy = _classifier_graph(X, labels, J)
    jopt = J.TFOptimizer(jl, {"name": "adam", "lr": 1e-2},
                         val_outputs=[jlogits], val_labels=[jy],
                         val_method=JAccuracy())
    ref = jopt.optimize(JMaxEpoch(4))
    loss, logits, y = _classifier_graph(X, labels, T)
    opt = T.TFOptimizer(loss, {"name": "adam", "lr": 1e-2},
                        val_outputs=[logits], val_labels=[y],
                        val_method=Accuracy(), device="cpu")
    out = opt.optimize(MaxEpoch(4))
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5,
                               atol=1e-6)
    assert out["loss"][-1] < out["loss"][0]
    acc, jacc = opt.evaluate(), jopt.evaluate()
    assert acc["accuracy"] == pytest.approx(jacc["accuracy"], abs=1e-6)
    assert out["val"][-1]["accuracy"] == pytest.approx(
        ref["val"][-1]["accuracy"], abs=1e-6)
    opt.sess.close()
    jopt.sess.close()


def test_tfpredictor_matches_session_and_jax():
    rs = np.random.RandomState(7)
    X = rs.randn(40, 6).astype(np.float32)
    g = tf.Graph()
    with g.as_default():
        ds = T.TFDataset.from_ndarray([X], batch_per_core=4, has_label=False)
        (x,) = ds.tensors
        w = tf1.get_variable("w", [6, 2])
        out = tf.nn.softmax(tf.matmul(x, w))
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            want = sess.run(out, {x: X})
            got = T.TFPredictor(sess, [out], dataset=ds,
                                device="cpu").predict()
            jds = J.TFDataset.from_ndarray([X], batch_per_core=4,
                                           has_label=False)
            jds._placeholders = ds.tensors
            jgot = J.TFPredictor(sess, [out], dataset=jds).predict()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-6, atol=1e-6)


def test_tfdataset_batch_divisibility(monkeypatch):
    T.TFDataset.from_ndarray([np.zeros((20, 3), np.float32)], batch_size=10)
    monkeypatch.setattr(tds, "_data_parallel_degree", lambda: 8)
    with pytest.raises(ValueError, match="divisible"):
        T.TFDataset.from_ndarray([np.zeros((20, 3), np.float32)],
                                 batch_size=10)  # as the JAX package's 8
    assert T.TFDataset.from_ndarray([np.zeros((20, 3), np.float32)],
                                    batch_per_core=2).batch_size == 16


def test_unsupported_op_reports_as_jax():
    g = tf.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, [None, 3], name="x")
        out = tf.boolean_mask(x, tf.reduce_sum(x, axis=1) > 0)
        gd = g.as_graph_def()
    with pytest.raises(NotImplementedError) as ours:
        tconv.ConvertedGraph(P.parse_graph_def(gd.SerializeToString()),
                             [x.name], [out.name])
    with pytest.raises(NotImplementedError) as ref:
        jconv.ConvertedGraph(gd, [x.name], [out.name])
    assert "unsupported TF op" in str(ours.value)
    assert str(ours.value) == str(ref.value)
