"""Golden oracles for the port's new layers: tf.keras (Keras 3) where it
has the layer, independent numpy formulas where it does not, as in
``tests/test_keras_oracle.py``.

Each Keras spec builds the port's layer on the CPU, copies its weights
into the Keras layer through a layout converter, and compares the
forward (inference mode), the input gradient and the weight gradients of
a random projection of the output, and the inferred output shape.  The
stochastic layers are held by their statistics in training and are
exact in eval mode.
"""

import numpy as np
import pytest
import torch

import tensorflow as tf
from tensorflow import keras as K

from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

RNG = np.random.default_rng(12345)
B = 4  # batch size for every spec


def _rand(shape, scale=1.0):
    return (scale * RNG.normal(size=shape)).astype(np.float32)


def _built(layer, shape):
    layer.build((None,) + tuple(shape), torch.Generator().manual_seed(0))
    layer.eval()
    return layer


def run_oracle(layer, keras_fn, shape, conv=None, rtol=1e-4, atol=1e-4):
    """``layer`` (the port's) against ``keras_fn()``; ``conv(params) ->
    [np arrays]`` maps the port's parameters (numpy) into the Keras
    layer's ``get_weights()`` order and layout.  It is linear, so the
    weight gradients map through it too."""
    x = _rand((B,) + shape)
    layer = _built(layer, shape)
    params = {k: v.detach().numpy() for k, v in layer.params().items()}
    keras_layer = keras_fn()
    keras_layer(tf.constant(x))
    if conv is not None:
        keras_layer.set_weights([np.asarray(w) for w in conv(params)])
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    k_out = np.asarray(keras_layer(tf.constant(x)))
    assert tuple(out.shape) == k_out.shape
    np.testing.assert_allclose(out.detach().numpy(), k_out, rtol=rtol,
                               atol=atol, err_msg="forward")
    inferred = layer.compute_output_shape((B,) + tuple(shape))
    assert tuple(inferred) == k_out.shape

    w_proj = _rand(k_out.shape)
    names = list(params)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(w_proj)).sum(),
        [xt] + [layer.params()[k] for k in names])
    xv = tf.Variable(x)
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(keras_layer(xv) * w_proj)
    k_grads = tape.gradient(loss, [xv] + list(
        keras_layer.trainable_variables))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(k_grads[0]),
                               rtol=rtol * 10, atol=atol * 10,
                               err_msg="input gradient")
    if conv is not None and names:
        mine = conv({k: g.numpy() for k, g in zip(names, grads[1:])})
        assert len(mine) == len(k_grads) - 1
        for g, kg in zip(mine, k_grads[1:]):
            np.testing.assert_allclose(
                np.asarray(g), np.asarray(tf.convert_to_tensor(kg)),
                rtol=rtol * 10, atol=atol * 10, err_msg="weight gradient")


W_b = lambda p: [p["W"], p["b"]]


def deconv_conv(p):
    """The port's ``W`` (kh, kw, in, out), correlated as stored, into
    Keras's Conv2DTranspose kernel (kh, kw, out, in), which the gradient
    op mirrors: the spatial axes flip."""
    return [np.ascontiguousarray(p["W"][::-1, ::-1].transpose(0, 1, 3, 2)),
            p["b"]]


KERAS_SPECS = [
    ("conv3d", lambda: L.Convolution3D(4, 2, 2, 2),
     lambda: K.layers.Conv3D(4, 2), (5, 5, 5, 2), W_b),
    ("conv3d_same_stride", lambda: L.Convolution3D(3, 3, 3, 3,
                                                   border_mode="same",
                                                   subsample=(2, 2, 2)),
     lambda: K.layers.Conv3D(3, 3, padding="same", strides=2),
     (5, 6, 5, 2), W_b),
    ("atrous_conv1d", lambda: L.AtrousConvolution1D(5, 3, atrous_rate=2),
     lambda: K.layers.Conv1D(5, 3, dilation_rate=2), (12, 3), W_b),
    ("atrous_conv2d", lambda: L.AtrousConvolution2D(5, 3, 3,
                                                    atrous_rate=(2, 2)),
     lambda: K.layers.Conv2D(5, 3, dilation_rate=2), (10, 10, 3), W_b),
    ("share_conv2d", lambda: L.ShareConvolution2D(6, 3, 3),
     lambda: K.layers.Conv2D(6, 3), (8, 8, 3), W_b),
    ("deconv2d", lambda: L.Deconvolution2D(5, 3, 3),
     lambda: K.layers.Conv2DTranspose(5, 3), (6, 6, 3), deconv_conv),
    ("deconv2d_same_stride",
     lambda: L.Deconvolution2D(5, 3, 3, border_mode="same",
                               subsample=(2, 2)),
     lambda: K.layers.Conv2DTranspose(5, 3, padding="same", strides=2),
     (6, 6, 3), deconv_conv),
    ("deconv2d_valid_stride_even",
     lambda: L.Deconvolution2D(4, 4, 4, subsample=(2, 2)),
     lambda: K.layers.Conv2DTranspose(4, 4, strides=2), (5, 5, 2),
     deconv_conv),
    ("zeropad1d", lambda: L.ZeroPadding1D(2),
     lambda: K.layers.ZeroPadding1D(2), (6, 3), None),
    ("zeropad3d", lambda: L.ZeroPadding3D((1, 1, 1)),
     lambda: K.layers.ZeroPadding3D(1), (4, 4, 4, 2), None),
    ("crop1d", lambda: L.Cropping1D((1, 2)),
     lambda: K.layers.Cropping1D((1, 2)), (8, 3), None),
    ("crop2d", lambda: L.Cropping2D(((1, 1), (2, 1))),
     lambda: K.layers.Cropping2D(((1, 1), (2, 1))), (8, 8, 2), None),
    ("crop3d", lambda: L.Cropping3D(((1, 1), (1, 1), (1, 1))),
     lambda: K.layers.Cropping3D(1), (6, 6, 6, 2), None),
    ("upsample1d", lambda: L.UpSampling1D(3),
     lambda: K.layers.UpSampling1D(3), (5, 3), None),
    ("upsample2d", lambda: L.UpSampling2D((2, 3)),
     lambda: K.layers.UpSampling2D((2, 3)), (4, 4, 2), None),
    ("upsample3d", lambda: L.UpSampling3D(2),
     lambda: K.layers.UpSampling3D(2), (3, 3, 3, 2), None),
    ("maxpool1d", lambda: L.MaxPooling1D(2),
     lambda: K.layers.MaxPooling1D(2), (8, 3), None),
    ("maxpool1d_stride", lambda: L.MaxPooling1D(3, stride=2,
                                                border_mode="same"),
     lambda: K.layers.MaxPooling1D(3, strides=2, padding="same"),
     (9, 3), None),
    ("avgpool1d", lambda: L.AveragePooling1D(2),
     lambda: K.layers.AveragePooling1D(2), (8, 3), None),
    ("avgpool1d_same", lambda: L.AveragePooling1D(3, stride=2,
                                                  border_mode="same"),
     lambda: K.layers.AveragePooling1D(3, strides=2, padding="same"),
     (9, 3), None),
    ("maxpool3d", lambda: L.MaxPooling3D(),
     lambda: K.layers.MaxPooling3D(), (6, 6, 6, 2), None),
    ("avgpool3d", lambda: L.AveragePooling3D(),
     lambda: K.layers.AveragePooling3D(2), (6, 6, 6, 2), None),
    ("avgpool3d_same", lambda: L.AveragePooling3D((3, 3, 3), (2, 2, 2),
                                                  border_mode="same"),
     lambda: K.layers.AveragePooling3D(3, strides=2, padding="same"),
     (5, 5, 5, 2), None),
    ("elu", lambda: L.ELU(alpha=0.7),
     lambda: K.layers.ELU(alpha=0.7), (6,), None),
    ("leakyrelu", lambda: L.LeakyReLU(alpha=0.2),
     lambda: K.layers.LeakyReLU(negative_slope=0.2), (6,), None),
    ("thresholdedrelu", lambda: L.ThresholdedReLU(theta=0.8),
     lambda: K.layers.ReLU(threshold=0.8), (6,), None),
    ("prelu", lambda: L.PReLU(),
     lambda: K.layers.PReLU(), (6,), lambda p: [p["alpha"]]),
    ("permute", lambda: L.Permute((2, 1)),
     lambda: K.layers.Permute((2, 1)), (3, 5), None),
    ("repeatvector", lambda: L.RepeatVector(5),
     lambda: K.layers.RepeatVector(5), (6,), None),
    ("sparse_dense", lambda: L.SparseDense(8),
     lambda: K.layers.Dense(8), (6,), W_b),
    ("timedistributed_dense",
     lambda: L.TimeDistributed(L.Dense(6)),
     lambda: K.layers.TimeDistributed(K.layers.Dense(6)), (5, 4), W_b),
    ("timedistributed_conv2d",
     lambda: L.TimeDistributed(L.Convolution2D(4, 3, 3)),
     lambda: K.layers.TimeDistributed(K.layers.Conv2D(4, 3)),
     (3, 6, 6, 2), W_b),
]


@pytest.mark.parametrize("spec", KERAS_SPECS,
                         ids=[s[0] for s in KERAS_SPECS])
def test_torch_layer_vs_keras(spec):
    _, make, keras_fn, shape, conv = spec
    run_oracle(make(), keras_fn, shape, conv=conv)


MERGE_CASES = [
    ("sum", lambda: K.layers.Add()),
    ("mul", lambda: K.layers.Multiply()),
    ("max", lambda: K.layers.Maximum()),
    ("min", lambda: K.layers.Minimum()),
    ("ave", lambda: K.layers.Average()),
    ("sub", lambda: K.layers.Subtract()),
    ("concat", lambda: K.layers.Concatenate(axis=-1)),
    ("dot", lambda: K.layers.Dot(axes=-1)),
    ("cosine", lambda: K.layers.Dot(axes=-1, normalize=True)),
]


@pytest.mark.parametrize("mode,keras_fn", MERGE_CASES,
                         ids=[c[0] for c in MERGE_CASES])
def test_torch_merge_vs_keras(mode, keras_fn):
    x1, x2 = _rand((B, 6)), _rand((B, 6))
    out = L.Merge(mode=mode)([torch.from_numpy(x1), torch.from_numpy(x2)])
    k_out = keras_fn()([tf.constant(x1), tf.constant(x2)])
    np.testing.assert_allclose(out.numpy(), np.asarray(k_out), rtol=1e-5,
                               atol=1e-5)


def _params(layer):
    return {k: v.detach().numpy() for k, v in layer.params().items()}


def test_torch_masking_numpy_oracle():
    x = _rand((B, 5, 3))
    x[:, 2, :] = 0.0
    out = L.Masking(mask_value=0.0)(torch.from_numpy(x)).numpy()
    keep = np.any(x != 0.0, axis=-1, keepdims=True)
    np.testing.assert_array_equal(out, np.where(keep, x, 0.0))
    assert (out[:, 2, :] == 0).all()


def test_torch_highway_numpy_oracle():
    layer = _built(L.Highway(activation="tanh"), (6,))
    p = _params(layer)
    x = _rand((B, 6))
    out = layer(torch.from_numpy(x)).detach().numpy()
    h = np.tanh(x @ p["W_h"] + p["b_h"])
    t = 1.0 / (1.0 + np.exp(-(x @ p["W_t"] + p["b_t"])))
    np.testing.assert_allclose(out, t * h + (1 - t) * x, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(p["b_t"], -2.0 * np.ones(6))


def test_torch_maxout_dense_numpy_oracle():
    layer = _built(L.MaxoutDense(5, nb_feature=3), (6,))
    p = _params(layer)
    x = _rand((B, 6))
    out = layer(torch.from_numpy(x)).detach().numpy()
    expect = np.max(np.einsum("bd,kdo->bko", x, p["W"]) + p["b"], axis=1)
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


def test_torch_srelu_numpy_oracle():
    layer = _built(L.SReLU(), (6,))
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(_rand((6,))))
        layer.t_right.copy_(layer.t_left + torch.from_numpy(
            np.abs(_rand((6,)))) + 0.1)
    p = _params(layer)
    x = _rand((B, 6), scale=2.0)
    out = layer(torch.from_numpy(x)).detach().numpy()
    expect = np.where(x < p["t_left"], p["t_left"] + p["a_left"]
                      * (x - p["t_left"]),
                      np.where(x > p["t_right"], p["t_right"] + p["a_right"]
                               * (x - p["t_right"]), x))
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [5, 3])
def test_torch_lrn2d_vs_tf_nn_lrn(n):
    x = _rand((B, 6, 6, 8))
    out = L.LRN2D(alpha=1e-3, k=2.0, beta=0.75, n=n)(
        torch.from_numpy(x)).numpy()
    k_out = np.asarray(tf.nn.local_response_normalization(
        tf.constant(x), depth_radius=n // 2, bias=2.0, alpha=1e-3 / n,
        beta=0.75))
    np.testing.assert_allclose(out, k_out, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size,shape", [(3, (5, 5)), (4, (6, 5))])
def test_torch_within_channel_lrn_numpy_oracle(size, shape):
    x = _rand((2,) + shape + (2,))
    out = L.WithinChannelLRN2D(size=size, alpha=1.0, beta=0.75)(
        torch.from_numpy(x)).numpy()
    lo = (size - 1) // 2
    hi = size - 1 - lo
    pads = ((0, 0), (lo, hi), (lo, hi), (0, 0))
    sq = np.pad(x ** 2, pads)
    ones = np.pad(np.ones_like(x), pads)
    h, w = shape
    summed = sum(sq[:, i:i + h, j:j + w] for i in range(size)
                 for j in range(size))
    counts = sum(ones[:, i:i + h, j:j + w] for i in range(size)
                 for j in range(size))
    np.testing.assert_allclose(out, x / (1.0 + summed / counts) ** 0.75,
                               rtol=1e-4, atol=1e-5)


def test_torch_locally_connected1d_numpy_oracle():
    layer = _built(L.LocallyConnected1D(4, filter_length=3), (8, 3))
    p = _params(layer)
    x = _rand((B, 8, 3))
    out = layer(torch.from_numpy(x)).detach().numpy()
    expect = np.stack([x[:, s:s + 3, :].reshape(B, -1) @ p["W"][s]
                       + p["b"][s] for s in range(6)], axis=1)
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_torch_locally_connected2d_numpy_oracle():
    layer = _built(L.LocallyConnected2D(3, 2, 2), (5, 5, 2))
    p = _params(layer)
    x = _rand((B, 5, 5, 2))
    out = layer(torch.from_numpy(x)).detach().numpy()
    W, b = p["W"].reshape(4, 4, -1, 3), p["b"].reshape(4, 4, 3)
    expect = np.stack([np.stack([
        x[:, i:i + 2, j:j + 2, :].reshape(B, -1) @ W[i, j] + b[i, j]
        for j in range(4)], axis=1) for i in range(4)], axis=1)
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(7, 9), (5, 6)])
def test_torch_resize_bilinear_vs_tf(out_hw):
    """Up, and the same size (tf's bilinear does not antialias, so the
    downsampling comparison is against the JAX package:
    test_resize_bilinear_matches_jax)."""
    x = _rand((B, 5, 6, 3))
    out = L.ResizeBilinear(*out_hw)(torch.from_numpy(x)).numpy()
    k_out = np.asarray(tf.image.resize(tf.constant(x), out_hw,
                                       method="bilinear"))
    np.testing.assert_allclose(out, k_out, rtol=1e-4, atol=1e-4)


def test_torch_resize_bilinear_down_vs_tf_antialias():
    x = _rand((B, 11, 13, 3))
    out = L.ResizeBilinear(4, 5)(torch.from_numpy(x)).numpy()
    k_out = np.asarray(tf.image.resize(tf.constant(x), (4, 5),
                                       method="bilinear", antialias=True))
    np.testing.assert_allclose(out, k_out, rtol=1e-4, atol=1e-4)


STOCH = [
    ("dropout", lambda g: L.Dropout(0.4, generator=g), (10,)),
    ("spatialdropout1d", lambda g: L.SpatialDropout1D(0.4, generator=g),
     (6, 8)),
    ("spatialdropout2d", lambda g: L.SpatialDropout2D(0.4, generator=g),
     (5, 5, 8)),
    ("spatialdropout3d", lambda g: L.SpatialDropout3D(0.4, generator=g),
     (4, 4, 4, 8)),
    ("gaussiannoise", lambda g: L.GaussianNoise(0.3, generator=g), (10,)),
    ("gaussiandropout", lambda g: L.GaussianDropout(0.3, generator=g),
     (10,)),
    ("rrelu", lambda g: L.RReLU(generator=g), (10,)),
]


@pytest.mark.parametrize("spec", STOCH, ids=[s[0] for s in STOCH])
def test_torch_stochastic_layers(spec):
    """Eval mode is the identity (RReLU's eval slope acts on negatives
    only, and the inputs are positive); in training the output differs
    and keeps the mean (inverted scaling); the spatial dropouts drop
    whole channels."""
    name, make, shape = spec
    layer = make(torch.Generator().manual_seed(7))
    x = torch.from_numpy(np.abs(_rand((64,) + shape)) + 3.0)
    layer.eval()
    np.testing.assert_array_equal(layer(x).numpy(), x.numpy())
    layer.train()
    out = layer(x).numpy()
    if name == "rrelu":
        np.testing.assert_array_equal(out, x.numpy())
        neg = layer(-x).numpy() / -x.numpy()
        assert 1 / 8 <= neg.min() and neg.max() <= 1 / 3
        return
    assert not np.allclose(out, x.numpy())
    assert abs(out.mean() - float(x.mean())) < 0.15 * abs(float(x.mean()))
    if name.startswith("spatialdropout"):
        # a dropped channel is zero at every position of its sample
        flat = out.reshape(64, -1, shape[-1])
        dropped = (flat == 0).all(axis=1)
        assert dropped.any() and ((flat == 0).any(axis=1) == dropped).all()
