"""Full-registry serialization sweep of the port, the counterpart of
``tests/test_serialization_sweep.py``: every class in the port's layer
registry either round-trips through ``save_model``/``load_model`` with
equal predictions, or is listed with the reason it cannot (multi-input
ones have their own tests below).  A coverage test fails when a layer is
registered without a case here.

Beside it, the API coverage: every class of the JAX package's layer
modules and of its ``keras2`` exists in the port's module of the same
name, and its signature begins with the JAX package's.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.core.module import _LAYER_REGISTRY
from analytics_zoo_tpu_torch.pipeline.api.keras import (Model, Sequential,
                                                        load_model)
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
import analytics_zoo_tpu_torch.pipeline.api.keras2 as K2

# modules that register layers on import: all of them, so the coverage
# check sees the same registry in any test order
import analytics_zoo_tpu_torch.ops.quantize  # noqa: F401
import analytics_zoo_tpu_torch.ops.elementwise  # noqa: F401
import analytics_zoo_tpu_torch.pipeline.api.autograd  # noqa: F401
import analytics_zoo_tpu_torch.pipeline.api.onnx  # noqa: F401
import analytics_zoo_tpu_torch.pipeline.api.tfgraph  # noqa: F401

RNG = np.random.default_rng(7)


def _f(shape):
    return RNG.normal(size=shape).astype(np.float32)


def _ints(shape, hi):
    return RNG.integers(0, hi, shape).astype(np.int32)


def _positive(n, s):
    return np.abs(_f((n,) + s)) + 0.5


# name -> (layer factory taking the per-sample input shape, that shape,
#          optional input generator)
CASES = {
    # core
    "Dense": (lambda s: L.Dense(5, input_shape=s), (6,), None),
    "SparseDense": (lambda s: L.SparseDense(5, input_shape=s), (6,), None),
    "Activation": (lambda s: L.Activation("relu", input_shape=s), (6,), None),
    "Dropout": (lambda s: L.Dropout(0.3, input_shape=s), (6,), None),
    "SpatialDropout1D": (lambda s: L.SpatialDropout1D(0.3, input_shape=s),
                         (5, 6), None),
    "SpatialDropout2D": (lambda s: L.SpatialDropout2D(0.3, input_shape=s),
                         (5, 5, 3), None),
    "SpatialDropout3D": (lambda s: L.SpatialDropout3D(0.3, input_shape=s),
                         (4, 4, 4, 2), None),
    "Flatten": (lambda s: L.Flatten(input_shape=s), (3, 4), None),
    "Reshape": (lambda s: L.Reshape((8,), input_shape=s), (2, 4), None),
    "Permute": (lambda s: L.Permute((2, 1), input_shape=s), (3, 5), None),
    "RepeatVector": (lambda s: L.RepeatVector(4, input_shape=s), (6,), None),
    "Masking": (lambda s: L.Masking(0.0, input_shape=s), (5, 3), None),
    "Highway": (lambda s: L.Highway(input_shape=s), (6,), None),
    "MaxoutDense": (lambda s: L.MaxoutDense(5, input_shape=s), (6,), None),
    "TimeDistributed": (
        lambda s: L.TimeDistributed(L.Dense(4), input_shape=s), (5, 6), None),
    # embeddings
    "Embedding": (lambda s: L.Embedding(20, 6, input_shape=s), (7,),
                  lambda n, s: _ints((n,) + s, 20)),
    "SparseEmbedding": (lambda s: L.SparseEmbedding(20, 6, input_shape=s),
                        (7,), lambda n, s: _ints((n,) + s, 20)),
    # convolutional
    "Convolution1D": (lambda s: L.Convolution1D(4, 3, input_shape=s),
                      (8, 3), None),
    "Convolution2D": (lambda s: L.Convolution2D(4, 3, 3, input_shape=s),
                      (8, 8, 2), None),
    "Convolution3D": (lambda s: L.Convolution3D(3, 2, 2, 2, input_shape=s),
                      (5, 5, 5, 2), None),
    "AtrousConvolution1D": (
        lambda s: L.AtrousConvolution1D(4, 3, atrous_rate=2, input_shape=s),
        (10, 3), None),
    "AtrousConvolution2D": (
        lambda s: L.AtrousConvolution2D(4, 3, 3, atrous_rate=(2, 2),
                                        input_shape=s), (9, 9, 2), None),
    "ShareConvolution2D": (
        lambda s: L.ShareConvolution2D(4, 3, 3, input_shape=s),
        (8, 8, 2), None),
    "SeparableConvolution2D": (
        lambda s: L.SeparableConvolution2D(4, 3, 3, input_shape=s),
        (8, 8, 2), None),
    "Deconvolution2D": (lambda s: L.Deconvolution2D(4, 3, 3, input_shape=s),
                        (6, 6, 2), None),
    "LocallyConnected1D": (
        lambda s: L.LocallyConnected1D(4, 3, input_shape=s), (8, 3), None),
    "LocallyConnected2D": (
        lambda s: L.LocallyConnected2D(3, 2, 2, input_shape=s),
        (5, 5, 2), None),
    "ZeroPadding1D": (lambda s: L.ZeroPadding1D(2, input_shape=s),
                      (5, 3), None),
    "ZeroPadding2D": (lambda s: L.ZeroPadding2D((1, 2), input_shape=s),
                      (5, 5, 2), None),
    "ZeroPadding3D": (lambda s: L.ZeroPadding3D((1, 1, 1), input_shape=s),
                      (4, 4, 4, 2), None),
    "Cropping1D": (lambda s: L.Cropping1D((1, 1), input_shape=s),
                   (6, 3), None),
    "Cropping2D": (lambda s: L.Cropping2D(((1, 1), (1, 1)), input_shape=s),
                   (6, 6, 2), None),
    "Cropping3D": (
        lambda s: L.Cropping3D(((1, 1), (1, 1), (1, 1)), input_shape=s),
        (5, 5, 5, 2), None),
    "UpSampling1D": (lambda s: L.UpSampling1D(2, input_shape=s), (5, 3),
                     None),
    "UpSampling2D": (lambda s: L.UpSampling2D((2, 2), input_shape=s),
                     (4, 4, 2), None),
    "UpSampling3D": (lambda s: L.UpSampling3D((2, 2, 2), input_shape=s),
                     (3, 3, 3, 2), None),
    "SpaceToDepth2D": (lambda s: L.SpaceToDepth2D(2, input_shape=s),
                       (4, 4, 3), None),
    "SwitchMoE": (lambda s: L.SwitchMoE(n_experts=4, hidden_dim=8,
                                        input_shape=s), (6,), None),
    "MultiHeadSelfAttention": (
        lambda s: L.MultiHeadSelfAttention(2, causal=True,
                                           implementation="naive",
                                           input_shape=s), (8, 12), None),
    "PositionalEmbedding": (
        lambda s: L.PositionalEmbedding(max_len=16, input_shape=s),
        (8, 6), None),
    "ResizeBilinear": (
        lambda s: L.ResizeBilinear(output_height=6, output_width=7,
                                   input_shape=s), (4, 5, 2), None),
    # pooling
    "MaxPooling1D": (lambda s: L.MaxPooling1D(2, input_shape=s), (8, 3),
                     None),
    "AveragePooling1D": (lambda s: L.AveragePooling1D(2, input_shape=s),
                         (8, 3), None),
    "MaxPooling2D": (lambda s: L.MaxPooling2D(input_shape=s), (6, 6, 2),
                     None),
    "AveragePooling2D": (lambda s: L.AveragePooling2D(input_shape=s),
                         (6, 6, 2), None),
    "MaxPooling3D": (lambda s: L.MaxPooling3D(input_shape=s), (4, 4, 4, 2),
                     None),
    "AveragePooling3D": (lambda s: L.AveragePooling3D(input_shape=s),
                         (4, 4, 4, 2), None),
    "GlobalMaxPooling1D": (lambda s: L.GlobalMaxPooling1D(input_shape=s),
                           (6, 3), None),
    "GlobalAveragePooling1D": (
        lambda s: L.GlobalAveragePooling1D(input_shape=s), (6, 3), None),
    "GlobalMaxPooling2D": (lambda s: L.GlobalMaxPooling2D(input_shape=s),
                           (5, 5, 2), None),
    "GlobalAveragePooling2D": (
        lambda s: L.GlobalAveragePooling2D(input_shape=s), (5, 5, 2), None),
    "GlobalMaxPooling3D": (lambda s: L.GlobalMaxPooling3D(input_shape=s),
                           (4, 4, 4, 2), None),
    "GlobalAveragePooling3D": (
        lambda s: L.GlobalAveragePooling3D(input_shape=s), (4, 4, 4, 2),
        None),
    # normalization
    "BatchNormalization": (lambda s: L.BatchNormalization(input_shape=s),
                           (5, 5, 3), None),
    "WithinChannelLRN2D": (lambda s: L.WithinChannelLRN2D(input_shape=s),
                           (5, 5, 2), None),
    "LRN2D": (lambda s: L.LRN2D(input_shape=s), (5, 5, 4), None),
    "LayerNorm": (lambda s: L.LayerNorm(input_shape=s), (6,), None),
    # recurrent
    "SimpleRNN": (lambda s: L.SimpleRNN(4, input_shape=s), (6, 3), None),
    "LSTM": (lambda s: L.LSTM(4, input_shape=s), (6, 3), None),
    "GRU": (lambda s: L.GRU(4, input_shape=s), (6, 3), None),
    "ConvLSTM2D": (lambda s: L.ConvLSTM2D(3, 3, input_shape=s),
                   (4, 5, 5, 2), None),
    "Bidirectional": (
        lambda s: L.Bidirectional(L.LSTM(4, return_sequences=True),
                                  input_shape=s), (6, 3), None),
    # advanced activations
    "ELU": (lambda s: L.ELU(0.8, input_shape=s), (6,), None),
    "LeakyReLU": (lambda s: L.LeakyReLU(0.1, input_shape=s), (6,), None),
    "ThresholdedReLU": (lambda s: L.ThresholdedReLU(0.5, input_shape=s),
                        (6,), None),
    "PReLU": (lambda s: L.PReLU(input_shape=s), (6,), None),
    "SReLU": (lambda s: L.SReLU(input_shape=s), (6,), None),
    # noise
    "GaussianNoise": (lambda s: L.GaussianNoise(0.2, input_shape=s), (6,),
                      None),
    "GaussianDropout": (lambda s: L.GaussianDropout(0.2, input_shape=s),
                        (6,), None),
    # torch-style
    "AddConstant": (lambda s: L.AddConstant(2.0, input_shape=s), (6,), None),
    "MulConstant": (lambda s: L.MulConstant(2.0, input_shape=s), (6,), None),
    "BinaryThreshold": (lambda s: L.BinaryThreshold(0.1, input_shape=s),
                        (6,), None),
    "Threshold": (lambda s: L.Threshold(0.1, 0.0, input_shape=s), (6,),
                  None),
    "HardShrink": (lambda s: L.HardShrink(0.4, input_shape=s), (6,), None),
    "SoftShrink": (lambda s: L.SoftShrink(0.4, input_shape=s), (6,), None),
    "HardTanh": (lambda s: L.HardTanh(input_shape=s), (6,), None),
    "RReLU": (lambda s: L.RReLU(input_shape=s), (6,), None),
    "Exp": (lambda s: L.Exp(input_shape=s), (6,), None),
    "Log": (lambda s: L.Log(input_shape=s), (6,), _positive),
    "Sqrt": (lambda s: L.Sqrt(input_shape=s), (6,), _positive),
    "Square": (lambda s: L.Square(input_shape=s), (6,), None),
    "Negative": (lambda s: L.Negative(input_shape=s), (6,), None),
    "Identity": (lambda s: L.Identity(input_shape=s), (6,), None),
    "Power": (lambda s: L.Power(2.0, input_shape=s), (6,), _positive),
    "Mul": (lambda s: L.Mul(input_shape=s), (6,), None),
    "CAdd": (lambda s: L.CAdd([6], input_shape=s), (6,), None),
    "CMul": (lambda s: L.CMul([6], input_shape=s), (6,), None),
    "Scale": (lambda s: L.Scale([6], input_shape=s), (6,), None),
    "Narrow": (lambda s: L.Narrow(1, 1, 3, input_shape=s), (6,), None),
    "Select": (lambda s: L.Select(1, 2, input_shape=s), (4, 3), None),
    "Squeeze": (lambda s: L.Squeeze(2, input_shape=s), (3, 1, 4), None),
    # keras2 skins (registered under Keras2* serial names)
    "Keras2Dense": (lambda s: K2.layers.Dense(5, input_shape=s), (6,), None),
    "Keras2Dropout": (lambda s: K2.layers.Dropout(0.3, input_shape=s),
                      (6,), None),
    "Keras2Conv1D": (lambda s: K2.layers.Conv1D(4, 3, input_shape=s),
                     (8, 3), None),
    "Keras2Conv2D": (lambda s: K2.layers.Conv2D(4, 3, input_shape=s),
                     (8, 8, 2), None),
    "Keras2Cropping1D": (
        lambda s: K2.layers.Cropping1D((1, 1), input_shape=s), (6, 3), None),
    "Keras2LocallyConnected1D": (
        lambda s: K2.layers.LocallyConnected1D(4, 3, input_shape=s),
        (8, 3), None),
    "Keras2MaxPooling1D": (
        lambda s: K2.layers.MaxPooling1D(2, input_shape=s), (8, 3), None),
    "Keras2AveragePooling1D": (
        lambda s: K2.layers.AveragePooling1D(2, input_shape=s), (8, 3),
        None),
}

# registry entries that cannot round-trip standalone, with the reason;
# the multi-input ones get their own tests below
SKIPS = {
    "InputLayer": "graph plumbing; exercised by every functional Model",
    "Model": "container; round-tripped in "
             "test_torch_functional_model_roundtrip",
    "Sequential": "container; round-tripped by every CASE",
    "Merge": "multi-input; test_torch_merge_roundtrip",
    "GaussianSampler": "multi-input ([mean, log_var]); "
                       "test_torch_sampler_roundtrip",
    "KerasLayerWrapper": "wraps an arbitrary python callable; get_config "
                         "raises NotImplementedError by design",
    "WordEmbedding": "needs an embedding file; "
                     "test_torch_word_embedding_roundtrip",
    "Keras2Maximum": "multi-input; test_torch_merge_roundtrip",
    "Keras2Minimum": "multi-input; test_torch_merge_roundtrip",
    "Keras2Average": "multi-input; test_torch_merge_roundtrip",
    # registered by the autograd DSL and the int8 route, round-tripped by
    # their own tests
    "Lambda": "wraps a python callable; test_torch_autograd covers it",
    "ParameterLayer": "autograd Parameter node; "
                      "test_op_graph_save_load_and_config",
    "OpLayer": "autograd op node; test_op_graph_save_load_and_config",
    "ConstantLayer": "autograd constant node; "
                     "test_op_graph_save_load_and_config",
    "QuantizedDense": "int8 inference twin, made by quantize(), not saved "
                      "by config; test_torch_quantize covers it",
    "QuantizedConv": "int8 inference twin; test_torch_quantize",
    "QuantizedEmbedding": "int8 inference twin; test_torch_quantize",
    "QuantizedSeparableConv": "int8 inference twin; test_torch_quantize",
    # registered by the importers (as in the JAX package's sweep)
    "TFNet": "frozen-graph net; covered by test_torch_tf_interop",
    "OnnxNet": "onnx-imported net; covered by test_torch_onnx",
}


def test_torch_registry_fully_covered():
    registry = set(_LAYER_REGISTRY)
    covered = set(CASES) | set(SKIPS)
    missing = registry - covered
    assert not missing, (
        f"layers registered but absent from the serialization sweep: "
        f"{sorted(missing)}: add a CASE (or a justified SKIP)")
    stale = covered - registry
    assert not stale, f"sweep entries no longer registered: {sorted(stale)}"


def _roundtrip(model, x, path, n):
    ref = model.predict(x, batch_size=n)
    model.save_model(path)
    loaded = load_model(path, device="cpu")
    out = loaded.predict(x, batch_size=n)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    return loaded


@pytest.mark.parametrize("name", sorted(CASES), ids=sorted(CASES))
def test_torch_layer_roundtrip(name, tmp_path):
    layer_fn, shape, input_gen = CASES[name]
    n = 4
    x = input_gen(n, shape) if input_gen else _f((n,) + shape)
    model = Sequential(device="cpu")
    model.add(layer_fn(tuple(shape)))
    loaded = _roundtrip(model, x, str(tmp_path / name), n)
    assert type(loaded.layers[0]) is type(model.layers[0])
    assert loaded.layers[0].get_config() == model.layers[0].get_config()


def test_torch_merge_roundtrip(tmp_path):
    modes = ["sum", "mul", "max", "min", "ave", "sub", "div", "concat",
             "dot", "cosine"]
    merges = [lambda m=m: L.Merge(mode=m) for m in modes] + [
        K2.layers.Maximum, K2.layers.Minimum, K2.layers.Average]
    x = (_f((4, 6)), _f((4, 6)))
    for i, make in enumerate(merges):
        a, b = L.Input((6,)), L.Input((6,))
        out = make()([L.Dense(6)(a), L.Dense(6)(b)])
        model = Model(input=[a, b], output=out, device="cpu")
        _roundtrip(model, x, str(tmp_path / f"merge_{i}"), 4)


def test_torch_sampler_roundtrip(tmp_path):
    xin = L.Input((8,))
    z = L.GaussianSampler()([L.Dense(3)(xin), L.Dense(3)(xin)])
    model = Model(input=xin, output=z, device="cpu")
    x = _f((4, 8))
    loaded = _roundtrip(model, x, str(tmp_path / "vae"), 4)
    # in eval mode the sampler returns the mean
    mean = model.to_graph().layers[0]
    np.testing.assert_array_equal(
        loaded.predict(x, batch_size=4),
        mean(torch.from_numpy(x)).detach().numpy())


def test_torch_word_embedding_roundtrip(tmp_path):
    glove = tmp_path / "glove.txt"
    vecs = _f((3, 4))
    with open(glove, "w") as f:
        for w, v in zip(["a", "b", "c"], vecs):
            f.write(w + " " + " ".join(f"{x:.6f}" for x in v) + "\n")
    model = Sequential(device="cpu")
    model.add(L.WordEmbedding(str(glove), {"a": 1, "b": 2, "c": 3},
                              input_length=3))
    _roundtrip(model, np.asarray([[1, 2, 3]], np.int32), str(tmp_path / "we"),
               1)


def test_torch_functional_model_roundtrip(tmp_path):
    xin = L.Input((6,))
    h = L.Highway(activation="relu")(L.Dense(8)(xin))
    out = L.Dense(3, activation="softmax")(L.PReLU()(h))
    model = Model(input=xin, output=out, device="cpu")
    _roundtrip(model, _f((4, 6)), str(tmp_path / "func"), 4)


# ---- API coverage: every class of the JAX package's layer modules ----

JAX_LAYER_MODULES = (
    [f"pipeline.api.keras.layers.{m}" for m in (
        "advanced_activations", "attention", "convolutional", "core",
        "embedding", "merge", "moe", "noise", "normalization", "pooling",
        "recurrent", "torch_style")]
    + ["pipeline.api.keras2.layers"])


def _classes(module):
    return {n: c for n, c in vars(module).items()
            if inspect.isclass(c) and c.__module__ == module.__name__}


@pytest.mark.parametrize("module", JAX_LAYER_MODULES)
def test_torch_every_jax_layer_class_has_a_port_with_its_signature(module):
    """Every class the JAX package's module defines (its private bases
    included) is in the port's module of the same name, and the port's
    signature begins with the JAX package's (the port may add ``trainable``,
    ``device`` and ``generator`` after it)."""
    jm = importlib.import_module(f"analytics_zoo_tpu.{module}")
    tm = importlib.import_module(f"analytics_zoo_tpu_torch.{module}")
    classes = _classes(jm)
    assert classes
    for name, cls in classes.items():
        assert hasattr(tm, name), f"{module}.{name} is not ported"
        ref = [p for p in inspect.signature(cls).parameters
               if p not in ("kw", "kwargs")]
        own = list(inspect.signature(getattr(tm, name)).parameters)
        assert own[:len(ref)] == ref, (name, ref, own)


def test_torch_keras2_exports_the_jax_names():
    jk2 = importlib.import_module("analytics_zoo_tpu.pipeline.api.keras2")
    public = {n for n in dir(jk2) if not n.startswith("_")
              and n not in ("layers",)}
    # Sequential and Model load at first use, as in pipeline.api.keras
    assert [n for n in sorted(public) if not hasattr(K2, n)] == []
    jl = importlib.import_module("analytics_zoo_tpu.pipeline.api.keras")
    jnames = {n for n in dir(jl.layers) if not n.startswith("_")
              and inspect.isclass(getattr(jl.layers, n))}
    assert [n for n in sorted(jnames) if not hasattr(L, n)] == []
    assert callable(L.merge) and callable(K2.maximum)
