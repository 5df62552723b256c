"""The port's int8 inference (``ops/quantize.py``) against the JAX
package's, on the CPU.

Counterparts of the 22 cases of ``tests/test_quantize.py``, with the
same bounds against each package's own float model, plus exact parity:
``quantize_per_channel`` and ``dynamic_quantize`` give the JAX package's
int8 values and scales bit for bit, and ``int8_matmul``/``int8_conv``
its int32 accumulators and f32 results exactly (0 error) on the same
inputs, at the shapes ``torch._int_mm`` refuses on the card unpadded
(rows <= 16, a depth or width not a multiple of 8: ResNet-50's stem at
K = 147, SSD's heads at N = 84 and 126).  Quantized models built from
the same float weights (moved by ``from_jax_params``) hold the JAX
package's quantized tree bit for bit and its outputs within 1e-5 (of
the largest entry): the int8 products are exact, and only the float
layers between them (pooling sums, softmax) round in another order.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax

from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.ops import quantize as JQ
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.layers import (
    Convolution2D as JConv2D, Dense as JDense, Embedding as JEmbedding,
    Flatten as JFlatten, SeparableConvolution2D as JSeparable)
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.models import (ImageClassifier, ObjectDetector,
                                            TextClassifier, from_jax_params,
                                            to_jax_params)
from analytics_zoo_tpu_torch.ops.quantize import (
    QuantizedConv, QuantizedDense, _quantizable, conv_accumulate,
    dynamic_quantize, int8_conv, int8_matmul, int_matmul, quantize_graph,
    quantize_per_channel, quantized_size_bytes)
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Convolution2D, Dense, Embedding, Flatten, SeparableConvolution2D)
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

PARITY = 1e-5   # quantized model against the JAX package's, of max|ref|


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _max_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _tree_equal(got, ref):
    assert set(got) == set(ref)
    for name in ref:
        assert set(got[name]) == set(ref[name]), name
        for key in ref[name]:
            g, r = np.asarray(got[name][key]), np.asarray(ref[name][key])
            assert g.dtype == r.dtype and np.array_equal(g, r), (name, key)


# ---------------------------------------------------------------- primitives

def test_torch_per_channel_round_trip_equals_jax():
    rs = np.random.RandomState(0)
    w = rs.randn(16, 8).astype(np.float32) * np.linspace(0.1, 3.0, 8)
    w = w.astype(np.float32)
    wq, scale = quantize_per_channel(w, out_axis=-1)
    assert wq.dtype == torch.int8 and tuple(scale.shape) == (8,)
    deq = wq.numpy().astype(np.float32) * scale.numpy()
    err = np.abs(deq - w).max(axis=0)
    assert np.all(err <= np.abs(w).max(axis=0) / 127.0 + 1e-6)
    jwq, jscale = JQ.quantize_per_channel(w, out_axis=-1)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    # rows as the output axis (the embedding table's)
    twq, ts = quantize_per_channel(w, out_axis=0)
    jwq, js = JQ.quantize_per_channel(w, out_axis=0)
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_torch_dynamic_quantize_per_sample_equals_jax():
    x = np.asarray([[-30.0, 0.0, 1.5], [-3.0, 0.0, 1.5]], np.float32)
    xq, s = dynamic_quantize(_t(x))
    assert xq.dtype == torch.int8 and tuple(s.shape) == (2, 1)
    np.testing.assert_allclose(xq.numpy().astype(np.float32) * s.numpy(),
                               x, atol=float(s.max()))
    np.testing.assert_array_equal(np.abs(xq.numpy()).max(axis=1),
                                  [127, 127])
    np.testing.assert_allclose(s.numpy()[:, 0], [30.0 / 127, 3.0 / 127],
                               rtol=1e-6)
    rs = np.random.RandomState(5)
    for shape in [(4, 9, 11, 5), (3, 7), (6,)]:
        a = (rs.randn(*shape) * 10).astype(np.float32)
        xq, s = dynamic_quantize(_t(a))
        jq, js = JQ.dynamic_quantize(jnp.asarray(a))
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_torch_int8_matmul_close_to_float_and_equal_to_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 64).astype(np.float32)
    w = rs.randn(64, 32).astype(np.float32)
    wq, ws = quantize_per_channel(w)
    got = int8_matmul(_t(x), wq, ws).numpy()
    want = x @ w
    assert np.abs(got - want).max() / np.abs(want).max() < 0.03
    jwq, jws = JQ.quantize_per_channel(w)
    np.testing.assert_array_equal(
        got, np.asarray(JQ.int8_matmul(jnp.asarray(x), jwq, jws)))


def test_torch_int8_matmul_under_inference_mode_f32_out():
    rs = np.random.RandomState(2)
    wq, ws = quantize_per_channel(rs.randn(16, 4).astype(np.float32))
    x = torch.from_numpy(rs.randn(2, 16).astype(np.float32))
    with torch.inference_mode():
        out = int8_matmul(x, wq, ws)
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), int8_matmul(x, wq, ws))


@pytest.mark.parametrize("m,k,n", [
    (2, 64, 16), (16, 147, 64), (17, 64, 84), (3, 2048, 1000),
    (5, 24, 126), (40, 152, 88), (1, 5, 3)])
def test_torch_int_matmul_pads_to_an_exact_product(m, k, n):
    rs = np.random.RandomState(m * 7 + n)
    a = rs.randint(-127, 128, (m, k)).astype(np.int8)
    b = rs.randint(-127, 128, (k, n)).astype(np.int8)
    got = int_matmul(_t(a), _t(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))
    with pytest.raises(TypeError, match="int8"):
        int_matmul(_t(a).float(), _t(b))


@pytest.mark.parametrize("kernel,strides,padding,dilation,cin,cout", [
    ((7, 7), (2, 2), "SAME", (1, 1), 3, 64),      # ResNet-50's stem
    ((3, 3), (1, 1), "SAME", (1, 1), 8, 8),
    ((1, 1), (1, 1), "VALID", (1, 1), 16, 8),
    ((3, 3), (2, 1), [(1, 2), (0, 1)], (1, 1), 5, 7),
    ((3, 3), (1, 1), "VALID", (2, 2), 5, 84),      # SSD's head width
    ((3, 3), (3, 2), "SAME", (2, 1), 5, 126),
])
def test_torch_int8_conv_accumulators_equal_jax(kernel, strides, padding,
                                                 dilation, cin, cout):
    rs = np.random.RandomState(cin * 31 + cout)
    x = (rs.randn(3, 13, 11, cin)
         * rs.rand(3, 1, 1, 1) * 10).astype(np.float32)
    w = rs.randn(*kernel, cin, cout).astype(np.float32)
    wq, ws = quantize_per_channel(w)
    xq, _ = dynamic_quantize(_t(x))
    acc = conv_accumulate(xq, wq, strides, padding, dilation)
    jacc = lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()),
        window_strides=strides, padding=padding, rhs_dilation=dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    jwq, jws = JQ.quantize_per_channel(w)
    jy = JQ.int8_conv(jnp.asarray(x), jwq, jws, strides, padding, dilation,
                      ("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(
        int8_conv(_t(x), wq, ws, strides, padding, dilation).numpy(),
        np.asarray(jy))


def test_torch_int8_conv1d_causal_equals_jax():
    rs = np.random.RandomState(9)
    x = rs.randn(2, 12, 6).astype(np.float32)
    w = rs.randn(3, 6, 10).astype(np.float32)
    wq, ws = quantize_per_channel(w)
    pads = [(4, 0)]  # causal at dilation 2
    jwq, jws = JQ.quantize_per_channel(w)
    jy = JQ.int8_conv(jnp.asarray(x), jwq, jws, (1,), pads, (2,),
                      ("NWC", "WIO", "NWC"))
    np.testing.assert_array_equal(
        int8_conv(_t(x), wq, ws, (1,), pads, (2,)).numpy(), np.asarray(jy))


# ------------------------------------------------------- model quantization

def _both(build_jax, build_port, x):
    """A JAX model and the port's with its weights: float predictions of
    each, their quantized twins' predictions, and the quantized trees."""
    with jname_scope("q"):
        jm = build_jax()
    jm.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    params = jax.device_get(jm.get_weights())
    with name_scope("q"):
        tm = build_port()
    from_jax_params(tm, params)
    t = jm.ensure_inference_ready()
    _, jq, _ = JQ.quantize_graph(jm.to_graph(), t.state.params,
                                 t.state.model_state)
    qm = tm.quantize()
    return dict(jax_float=np.asarray(jm.predict(x, batch_size=16)),
                jax_q=np.asarray(jm.quantize().predict(x, batch_size=16)),
                float=tm.predict(x, batch_size=16),
                q=qm.predict(x, batch_size=16), qm=qm, tm=tm,
                jax_qparams=jax.device_get(jq))


def _mlp_pair():
    def build_jax():
        m = JSequential()
        m.add(JDense(16, activation="relu", input_shape=(10,)))
        m.add(JDense(2, activation="softmax"))
        return m

    def build_port():
        m = Sequential(device="cpu")
        m.add(Dense(16, activation="relu", input_shape=(10,)))
        m.add(Dense(2, activation="softmax"))
        return m
    x = np.random.RandomState(0).randn(64, 10).astype(np.float32)
    return _both(build_jax, build_port, x)


@pytest.fixture(scope="module")
def mlp():
    return _mlp_pair()


def test_torch_quantized_mlp_near_float_and_jax(mlp):
    assert mlp["q"].shape == mlp["float"].shape == (64, 2)
    agree = (np.argmax(mlp["q"], -1) == np.argmax(mlp["float"], -1)).mean()
    assert agree >= 0.95
    np.testing.assert_allclose(mlp["q"], mlp["float"], atol=0.08)
    assert _max_rel(mlp["q"], mlp["jax_q"]) <= PARITY
    assert mlp["qm"].name.endswith("_int8")


def test_torch_quantized_params_smaller_and_equal_jax(mlp):
    _, qparams, _ = quantize_graph(mlp["tm"].to_graph())
    assert quantized_size_bytes(qparams) < 0.45 * quantized_size_bytes(
        to_jax_params(mlp["tm"]))
    _tree_equal(to_jax_params(mlp["qm"]), mlp["jax_qparams"])
    # the float model keeps its weights: the twin holds copies
    from analytics_zoo_tpu_torch.models.jax_params import weight_tree
    for leaves in weight_tree(mlp["tm"]).values():
        assert all(p.requires_grad for p in leaves.values())


def test_torch_quantized_conv_model_near_float_and_jax():
    def build_jax():
        m = JSequential()
        m.add(JConv2D(4, 3, 3, activation="relu", border_mode="same",
                      input_shape=(8, 8, 3)))
        m.add(JFlatten())
        m.add(JDense(5, activation="softmax"))
        return m

    def build_port():
        m = Sequential(device="cpu")
        m.add(Convolution2D(4, 3, 3, activation="relu", border_mode="same",
                            input_shape=(8, 8, 3)))
        m.add(Flatten())
        m.add(Dense(5, activation="softmax"))
        return m
    x = np.random.RandomState(3).randn(6, 8, 8, 3).astype(np.float32)
    r = _both(build_jax, build_port, x)
    np.testing.assert_allclose(r["q"], r["float"], atol=0.08)
    assert _max_rel(r["q"], r["jax_q"]) <= PARITY
    _tree_equal(to_jax_params(r["qm"]), r["jax_qparams"])


def test_torch_unsupported_layers_stay_float():
    w = {"W": torch.ones(3, 3, 4, 4)}

    class OwnConv(Convolution2D):
        def forward(self, x):
            return super().forward(x)

    class OwnDense(Dense):
        def forward(self, x):
            return super().forward(x)

    assert _quantizable(SeparableConvolution2D(4), w) is None
    assert _quantizable(OwnConv(4, 3, 3), w) is None
    assert _quantizable(OwnDense(4), {"W": torch.ones(4, 4)}) is None
    assert _quantizable(Dense(4), {"W": torch.ones(4, 4, dtype=torch.int8)}
                        ) is None
    assert _quantizable(Dense(4), {"W": torch.ones(4, 4)}) is QuantizedDense
    assert _quantizable(Convolution2D(4, 3, 3), w) is QuantizedConv


def test_torch_quantized_handle_is_a_snapshot():
    """The int8 twin holds copies of the float layers it does not
    quantize (BatchNorm's statistics, the float weights), as the JAX
    package's holds that moment's arrays: fitting the source model after
    ``to_serving(quantize=True)`` and ``quantize()`` changes neither."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Activation, BatchNormalization)
    m = Sequential(device="cpu", seed=0)
    m.add(Convolution2D(4, 3, 3, border_mode="same", input_shape=(8, 8, 3)))
    m.add(BatchNormalization())
    m.add(Activation("relu"))
    m.add(Flatten())
    m.add(Dense(6))
    m.add(BatchNormalization())
    m.add(Dense(3, activation="softmax"))
    rs = np.random.RandomState(0)
    x = rs.randn(16, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 3, 16).astype(np.int32)
    im = m.to_serving(quantize=True)
    twin = m.quantize()
    try:
        served, held = im.predict(x), twin.predict(x, batch_size=16)
        m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
        m.fit(x + 1.0, y, batch_size=8, nb_epoch=2)
        moved = m.quantize().predict(x, batch_size=16)
        assert np.abs(moved - held).max() > 1e-4  # the fit did move it
        np.testing.assert_array_equal(im.predict(x), served)
        np.testing.assert_array_equal(twin.predict(x, batch_size=16), held)
    finally:
        im.close()


def test_torch_quantized_model_refuses_its_config(mlp):
    with pytest.raises(NotImplementedError, match="re-quantize"):
        mlp["qm"].get_config()


# --------------------------------------------------------- family coverage

def test_torch_quantized_embedding_near_float_and_jax():
    def build_jax():
        m = JSequential()
        m.add(JEmbedding(50, 8, input_shape=(6,)))
        m.add(JFlatten())
        m.add(JDense(3, activation="softmax"))
        return m

    def build_port():
        m = Sequential(device="cpu")
        m.add(Embedding(50, 8, input_shape=(6,)))
        m.add(Flatten())
        m.add(Dense(3, activation="softmax"))
        return m
    ids = np.random.RandomState(0).randint(0, 50, (32, 6)).astype(np.int32)
    r = _both(build_jax, build_port, ids)
    np.testing.assert_allclose(r["q"], r["float"], atol=0.05)
    assert _max_rel(r["q"], r["jax_q"]) <= PARITY
    emb = [v for v in to_jax_params(r["qm"]).values() if "Eq" in v]
    assert emb and emb[0]["Eq"].dtype == np.int8
    _tree_equal(to_jax_params(r["qm"]), r["jax_qparams"])


def test_torch_quantized_separable_conv_near_float_and_jax():
    def build_jax():
        m = JSequential()
        m.add(JSeparable(8, 3, 3, depth_multiplier=2, activation="relu",
                         input_shape=(12, 12, 3)))
        m.add(JFlatten())
        m.add(JDense(4, activation="softmax"))
        return m

    def build_port():
        m = Sequential(device="cpu")
        m.add(SeparableConvolution2D(8, 3, 3, depth_multiplier=2,
                                     activation="relu",
                                     input_shape=(12, 12, 3)))
        m.add(Flatten())
        m.add(Dense(4, activation="softmax"))
        return m
    x = np.random.RandomState(0).randn(8, 12, 12, 3).astype(np.float32)
    r = _both(build_jax, build_port, x)
    np.testing.assert_allclose(r["q"], r["float"], atol=0.05)
    assert _max_rel(r["q"], r["jax_q"]) <= PARITY
    _tree_equal(to_jax_params(r["qm"]), r["jax_qparams"])


def test_torch_quantized_text_classifier_keeps_accuracy():
    """A trained TextClassifier (cnn) keeps its accuracy within 2 points
    in int8 and agrees on >= 95% of its decisions."""
    rs = np.random.RandomState(0)
    n, classes, seq, dim = 128, 3, 24, 16
    y = rs.randint(0, classes, n).astype(np.int32)
    x = rs.randn(n, seq, dim).astype(np.float32) * 0.3
    for i in range(n):
        x[i, : seq // 2, y[i]] += 1.5
    clf = TextClassifier(class_num=classes, token_length=dim,
                         sequence_length=seq, encoder="cnn",
                         encoder_output_dim=32, device="cpu")
    clf.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    torch.manual_seed(0)
    clf.fit(x, y, batch_size=16, nb_epoch=8)
    f32 = clf.predict(x, batch_size=16)
    f32_acc = float((np.argmax(f32, -1) == y).mean())
    assert f32_acc > 0.85
    q = clf.quantize().predict(x, batch_size=16)
    q_acc = float((np.argmax(q, -1) == y).mean())
    assert (np.argmax(q, -1) == np.argmax(f32, -1)).mean() >= 0.95
    assert abs(f32_acc - q_acc) <= 0.02 + 1e-9


def test_torch_vgg16_quantize_near_float():
    clf = ImageClassifier("vgg-16", input_shape=(32, 32, 3), num_classes=4,
                          device="cpu")
    q = ImageClassifier("vgg-16-quantize", input_shape=(32, 32, 3),
                        num_classes=4, device="cpu")
    q.set_weights(clf.get_weights())
    x = np.random.RandomState(0).rand(8, 32, 32, 3).astype(np.float32)
    f32 = clf.predict(x, batch_size=8)
    qp = q.predict(x, batch_size=8)
    np.testing.assert_allclose(qp, f32, atol=0.05)
    assert (np.argmax(qp, -1) == np.argmax(f32, -1)).all()
    _, qparams, _ = quantize_graph(clf.to_graph())
    assert quantized_size_bytes(qparams) < quantized_size_bytes(
        to_jax_params(clf)) / 3


def test_torch_ssd_quantize_near_float():
    det = ObjectDetector("ssd-mobilenet-300", num_classes=4,
                         max_detections=10, device="cpu")
    qdet = ObjectDetector("ssd-mobilenet-300-quantize", num_classes=4,
                          max_detections=10, device="cpu")
    qdet.set_weights(det.get_weights())
    x = np.random.RandomState(0).rand(2, 300, 300, 3).astype(np.float32)
    raw_f = det.predict(x, batch_size=2)
    raw_q = qdet.predict(x, batch_size=2)
    assert raw_f.shape == raw_q.shape
    assert np.abs(raw_f - raw_q).max() / np.abs(raw_f).max() < 0.12
    _, qparams, _ = quantize_graph(det.to_graph())
    assert quantized_size_bytes(qparams) < quantized_size_bytes(
        to_jax_params(det)) / 3


def test_torch_transfer_weights_drops_the_int8_net():
    a = ImageClassifier("squeezenet-quantize", input_shape=(32, 32, 3),
                        num_classes=3, device="cpu")
    rs = np.random.RandomState(0)
    x = rs.rand(8, 32, 32, 3).astype(np.float32)
    before = a.predict(x, batch_size=8)
    donor = ImageClassifier("squeezenet", input_shape=(32, 32, 3),
                            num_classes=3, device="cpu", seed=1)
    donor.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    donor.fit(x, rs.randint(0, 3, 8).astype(np.int32), batch_size=8,
              nb_epoch=2)
    a.transfer_weights_from(donor)
    after = a.predict(x, batch_size=8)
    assert np.abs(after - before).max() > 1e-6
    np.testing.assert_allclose(after, donor.quantize().predict(x, 8),
                               rtol=0, atol=1e-6)


def test_torch_unknown_detector_quantize_suffix_still_checked():
    with pytest.raises(ValueError, match="Unknown detector"):
        ObjectDetector("nope-quantize", device="cpu")


# ------------------------------------------------------ registry and serving

def test_torch_image_classifier_quantize_name_builds_int8(tmp_path):
    m = ImageClassifier("squeezenet-quantize", input_shape=(32, 32, 3),
                        num_classes=4, device="cpu")
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    assert m.predict(x, batch_size=2).shape == (2, 4)
    assert m._quantized_net is not None
    # the same weights through the JAX package's int8 squeezenet
    from analytics_zoo_tpu.models.image import ImageClassifier as JIC
    jm = JIC("squeezenet-quantize", input_shape=(32, 32, 3), num_classes=4)
    jm.set_weights(m.get_weights())
    assert _max_rel(m.predict(x, batch_size=2),
                    np.asarray(jm.predict(x, batch_size=2))) <= PARITY


def test_torch_quantized_cache_dropped_on_weight_change():
    m = ImageClassifier("squeezenet-quantize", input_shape=(32, 32, 3),
                        num_classes=4, device="cpu")
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    p1 = m.predict(x, batch_size=2)
    first = m._quantized_net
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
              seed=7)
    assert m._quantized_net is None
    # compile keeps the weights in the port: new ones come by set_weights
    rs = np.random.RandomState(1)
    m.set_weights({n: {k: v + rs.normal(0, 0.05, v.shape).astype(v.dtype)
                       for k, v in d.items()}
                   for n, d in m.get_weights().items()})
    assert m._quantized_net is None
    p2 = m.predict(x, batch_size=2)
    assert m._quantized_net is not first
    assert not np.allclose(p1, p2)


def test_torch_inference_model_reload_keeps_quantize(mlp, tmp_path):
    path = str(tmp_path / "m")
    mlp["tm"].save_model(path)
    im = InferenceModel(device="cpu").load(path, quantize=True)
    x = np.random.RandomState(0).randn(64, 10).astype(np.float32)
    try:
        assert im._quantize_flag is True
        np.testing.assert_array_equal(im.predict(x), mlp["q"])
        im.reload(path)
        assert im._quantize_flag is True
        np.testing.assert_array_equal(im.predict(x), mlp["q"])
        im.reload(path, quantize=False)
        assert im._quantize_flag is False
        np.testing.assert_allclose(im.predict(x), mlp["float"], atol=1e-6)
    finally:
        im.close()


def test_torch_inference_model_honors_quantize_name():
    m = ImageClassifier("squeezenet-quantize", input_shape=(32, 32, 3),
                        num_classes=3, device="cpu")
    im = InferenceModel().load_keras_net(m)
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    try:
        assert im._quantize_flag is True
        out = im.predict(x)
        assert out.shape == (2, 3)
        np.testing.assert_allclose(out, m.predict(x, batch_size=2),
                                   rtol=0, atol=1e-6)
    finally:
        im.close()


def test_torch_image_classifier_unknown_quantize_name():
    with pytest.raises(ValueError, match="quantize"):
        ImageClassifier("no-such-net-quantize", device="cpu")


def test_torch_inference_model_quantize_flag(mlp):
    x = np.random.RandomState(0).randn(64, 10).astype(np.float32)[:8]
    im = InferenceModel().load_keras_net(mlp["tm"], quantize=True)
    serving = mlp["tm"].to_serving(quantize=True, warmup_shapes=(10,))
    try:
        out = im.predict(x)
        np.testing.assert_allclose(out, mlp["float"][:8], atol=0.08)
        np.testing.assert_array_equal(out, mlp["q"][:8])
        np.testing.assert_array_equal(serving.predict(x), out)
        assert im.serving_stats()["buckets"] == ()  # exact-shape path
    finally:
        im.close()
        serving.close()
