"""Three repairs of the port, each pinned here, and TransformerLM's
parameters pinned across them.

1. ``blockwise_attention`` at bf16 promotes ``v`` as ``jnp.einsum`` does:
   the output is f32, as the JAX package's, and its values agree with the
   JAX package's blockwise output within 1e-2.
2. The layers take the reference's signatures (every class of the layer
   set, pinned one by one) and infer their widths from the input
   shape.
3. Unnamed layers get unique names from per-class counters, and a weight
   tree with a duplicate layer name is refused instead of dropping one.
"""

import hashlib
import importlib
import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu_torch.core.module import fresh_name, name_scope
from analytics_zoo_tpu_torch.models import (TransformerLM, from_jax_params,
                                            to_jax_params)
from analytics_zoo_tpu_torch.ops import attention as tattn
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers

# the package's ops/__init__ exports a function named ``attention``
jattn = importlib.import_module("analytics_zoo_tpu.ops.attention")


def _bf16_inputs():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("entry", ["blockwise", "auto", "bhsd_blockwise",
                                   "bhsd_auto"])
def test_blockwise_attention_at_bf16_returns_jax_dtype_and_values(entry):
    q, k, v = _bf16_inputs()
    ref = jattn.attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                          causal=True, implementation="blockwise")
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    if entry.startswith("bhsd_"):
        out = tattn.attention_bhsd(*(t.transpose(1, 2) for t in ts),
                                   causal=True,
                                   implementation=entry[5:]).transpose(1, 2)
    else:
        out = tattn.attention(*ts, causal=True, implementation=entry)
    assert ref.dtype == jnp.float32
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-2)


#: the reference's layer signatures, which the port's begin with
LAYERS = ["Dense", "Activation", "Dropout", "Flatten", "Embedding",
          "LayerNorm", "MultiHeadSelfAttention", "PositionalEmbedding",
          "Convolution2D", "Convolution1D", "MaxPooling2D", "Merge",
          # ported by the earlier slices
          "AveragePooling2D", "BatchNormalization", "Bidirectional",
          "ConvLSTM2D", "GRU", "GlobalAveragePooling1D",
          "GlobalAveragePooling2D", "GlobalAveragePooling3D",
          "GlobalMaxPooling1D", "GlobalMaxPooling2D", "GlobalMaxPooling3D",
          "LSTM", "Reshape", "SeparableConvolution2D", "SimpleRNN",
          "SpaceToDepth2D", "SparseEmbedding", "SwitchMoE", "WordEmbedding",
          "ZeroPadding2D",
          # the rest of the layer set
          "ELU", "LeakyReLU", "ThresholdedReLU", "PReLU", "SReLU",
          "GaussianNoise", "GaussianDropout",
          "Convolution3D", "AtrousConvolution1D", "AtrousConvolution2D",
          "ShareConvolution2D", "Deconvolution2D", "LocallyConnected1D",
          "LocallyConnected2D", "ZeroPadding1D", "ZeroPadding3D",
          "Cropping1D", "Cropping2D", "Cropping3D", "UpSampling1D",
          "UpSampling2D", "UpSampling3D", "ResizeBilinear",
          "MaxPooling1D", "MaxPooling3D", "AveragePooling1D",
          "AveragePooling3D",
          "SparseDense", "SpatialDropout1D", "SpatialDropout2D",
          "SpatialDropout3D", "Permute", "RepeatVector", "Masking",
          "Highway", "MaxoutDense", "TimeDistributed",
          "LRN2D", "WithinChannelLRN2D",
          "AddConstant", "MulConstant", "BinaryThreshold", "Threshold",
          "HardShrink", "SoftShrink", "HardTanh", "RReLU", "Exp", "Log",
          "Sqrt", "Square", "Negative", "Identity", "Power", "Mul", "CAdd",
          "CMul", "Scale", "GaussianSampler", "KerasLayerWrapper", "Narrow",
          "Select", "Squeeze"]


@pytest.mark.parametrize("name", LAYERS)
def test_layer_signatures_match_the_reference(name):
    ref = list(inspect.signature(getattr(jlayers, name)).parameters)
    own = list(inspect.signature(getattr(tlayers, name)).parameters)
    ref = [p for p in ref if p not in ("kw", "kwargs")]
    assert own[:len(ref)] == ref


def test_widths_are_inferred_from_the_input_shape():
    """An explicit input_dim/input_shape with a device builds at
    construction; without one the model builds the layer from the shape
    before it."""
    d = tlayers.Dense(6, input_dim=8, device="cpu")
    assert tuple(d.W.shape) == (8, 6)
    ln = tlayers.LayerNorm(input_shape=(5, 12), device="cpu")
    assert tuple(ln.gamma.shape) == (12,)
    attn = tlayers.MultiHeadSelfAttention(4, input_shape=(10, 32),
                                          device="cpu")
    assert tuple(attn.Wq.shape) == (32, 4, 8)
    assert tuple(attn.Wo.shape) == (4, 8, 32)
    pos = tlayers.PositionalEmbedding(16, input_shape=(10, 32),
                                      device="cpu")
    assert tuple(pos.table.shape) == (16, 32)
    late = tlayers.Dense(3)
    assert not late.built and late.params() == {}
    model = Sequential(device="cpu")
    model.add(tlayers.Dense(7, input_shape=(5,)))
    model.add(late)
    assert tuple(late.W.shape) == (7, 3)
    with pytest.raises(ValueError, match="input_shape"):
        Sequential(device="cpu").add(tlayers.Dense(3))


def test_unnamed_layers_get_unique_names_and_all_their_weights():
    model = Sequential(device="cpu")
    model.add(tlayers.Dense(4, input_shape=(3,)))
    model.add(tlayers.Dense(4))
    names = [l.name for l in model.layers]
    assert len(set(names)) == 2
    assert all(n.startswith("dense_") for n in names)
    weights = model.get_weights()
    assert list(weights) == names
    assert {k: v["W"].shape for k, v in weights.items()} == \
        {names[0]: (3, 4), names[1]: (4, 4)}
    # same-shaped layers of one model draw different weights
    model2 = Sequential(device="cpu")
    model2.add(tlayers.Dense(4, input_shape=(4,)))
    model2.add(tlayers.Dense(4))
    w = list(model2.get_weights().values())
    assert not np.array_equal(w[0]["W"], w[1]["W"])


def test_fresh_names_count_per_class_and_scope():
    a, b = fresh_name("probe"), fresh_name("probe")
    assert int(b.rsplit("_", 1)[1]) == int(a.rsplit("_", 1)[1]) + 1
    with name_scope("s"):
        assert fresh_name("probe") == "s/probe_1"
        assert tlayers.Dense(2).name == "s/dense_1"
    with name_scope("s"):
        assert tlayers.Dense(2).name == "s/dense_1"


def test_duplicate_layer_names_are_refused():
    model = Sequential(device="cpu")
    model.add(tlayers.Dense(4, input_shape=(3,), name="same"))
    model.add(tlayers.Dense(4, name="same"))
    with pytest.raises(ValueError, match="'same'"):
        model.get_weights()
    with pytest.raises(ValueError, match="'same'"):
        from_jax_params(model, {"same": {}})


def test_positional_remap_when_names_differ():
    """Weights of a model whose layers got other auto-names load by
    position when every shape matches, and raise when one does not."""
    def build(seed, width=4):
        m = Sequential(device="cpu", seed=seed)
        m.add(tlayers.Dense(width, input_shape=(3,)))
        m.add(tlayers.Dense(2))
        return m
    src, dst = build(1), build(2)
    assert list(src.get_weights()) != list(dst.get_weights())
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    assert not np.array_equal(dst.predict(x), src.predict(x))
    dst.set_weights(src.get_weights())
    np.testing.assert_array_equal(dst.predict(x), src.predict(x))
    with pytest.raises(ValueError, match="positional remap"):
        dst.set_weights(build(3, width=5).get_weights())


#: sha256 of TransformerLM(vocab 59, seq 32, 2 layers, d_model 32, 2 heads,
#: dropout 0.1, seed 7)'s parameters (sorted layer/param names, then their
#: bytes), recorded before the layers took the reference's signatures
LM_PARAMS_SHA256 = (
    "953097908f3243c0e83b93ecc29dee3343b6172cb496bf94f37ece116c798c79")


def test_transformer_lm_parameters_are_unchanged_for_a_seed():
    model = TransformerLM(vocab_size=59, seq_len=32, n_layers=2, d_model=32,
                          n_heads=2, dropout=0.1, seed=7, device="cpu")
    tree = to_jax_params(model)
    h = hashlib.sha256()
    for layer in sorted(tree):
        for key in sorted(tree[layer]):
            h.update(f"{layer}/{key}".encode())
            h.update(np.ascontiguousarray(tree[layer][key]).tobytes())
    assert h.hexdigest() == LM_PARAMS_SHA256
    assert list(tree)[:4] == ["tok_embed", "pos_embed", "ln_attn_0",
                              "attn_0"]
