"""The port's TransformerLM and layers against the JAX package's.

One JAX ``TransformerLM(vocab_size=59, seq_len=32, n_layers=2,
d_model=32, n_heads=2)`` with seeded, perturbed weights; its param tree
(``ensure_inference_ready().state.params``) goes into the port through
``from_jax_params``.  Both run on the CPU; log-probs agree within
atol 1e-4 (f32, two layers; sums run in another order).
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models import TransformerLM as JaxLM
from analytics_zoo_tpu.pipeline.api.keras import activations as jact
from analytics_zoo_tpu.pipeline.api.keras.layers import (
    Dense as JDense, Embedding as JEmbedding, LayerNorm as JLayerNorm)
from analytics_zoo_tpu_torch import resolve_device
from analytics_zoo_tpu_torch.core import initializers
from analytics_zoo_tpu_torch.models import (
    TransformerLM, from_jax_params, to_jax_params)
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential, activations
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Dense, Embedding, LayerNorm)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=59, seq_len=32, n_layers=2, d_model=32, n_heads=2)


def jax_lm(seed=0):
    """The JAX model with every leaf perturbed from a numpy seed (biases
    and norms away from their 0/1 init; a sharper head)."""
    m = JaxLM(**SMALL)
    params = jax.device_get(m.ensure_inference_ready().state.params)
    rng = np.random.default_rng(seed)
    tree = {}
    for layer, leaves in params.items():
        tree[layer] = {}
        for key, a in leaves.items():
            a = np.asarray(a) + rng.normal(0, 0.1, a.shape)
            if layer == "lm_head" and key == "W":
                a = a * 5
            tree[layer][key] = a.astype(np.float32)
    m.set_weights(tree)
    return m, tree


def port_lm(tree, **kw):
    m = TransformerLM(**SMALL, device="cpu", **kw)
    from_jax_params(m, tree)
    return m


def test_predict_matches_jax():
    jm, tree = jax_lm()
    tm = port_lm(tree)
    x = np.random.default_rng(1).integers(0, 59, (3, 32))
    ref = jm.predict(x, batch_size=3)
    out = tm.predict(x, batch_size=2)
    assert out.shape == (3, 32, 59) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_param_round_trip_is_bit_exact():
    _, tree = jax_lm(seed=2)
    back = to_jax_params(port_lm(tree))
    assert set(back) == {k for k, v in tree.items() if v}
    for layer, leaves in tree.items():
        for key, a in leaves.items():
            assert back[layer][key].dtype == a.dtype
            np.testing.assert_array_equal(back[layer][key], a)


def test_param_tree_matches_jax_structure():
    """A freshly built port model has the JAX model's layer names, param
    names and shapes."""
    jm = JaxLM(**SMALL)
    ref = jax.device_get(jm.ensure_inference_ready().state.params)
    own = to_jax_params(TransformerLM(**SMALL, device="cpu"))
    assert {k for k, v in ref.items() if v} == set(own)
    for layer, leaves in own.items():
        assert {k: v.shape for k, v in leaves.items()} == \
            {k: np.shape(v) for k, v in ref[layer].items()}


def test_from_jax_params_rejects_mismatches():
    _, tree = jax_lm(seed=3)
    m = TransformerLM(**SMALL, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "ln_final"}
    with pytest.raises(KeyError, match="ln_final"):
        from_jax_params(m, missing)
    bad = {k: dict(v) for k, v in tree.items()}
    bad["lm_head"]["W"] = bad["lm_head"]["W"][:, :7]
    with pytest.raises(ValueError, match="lm_head/W"):
        from_jax_params(m, bad)


def test_init_is_seeded_and_distributed_like_jax():
    """The two frameworks' streams differ, so init is checked by
    distribution: glorot bounds and variance, the uniform scales, the
    0/1 norms and biases; and one seed gives one model."""
    a = TransformerLM(**SMALL, device="cpu", seed=0)
    b = TransformerLM(**SMALL, device="cpu", seed=0)
    c = TransformerLM(**SMALL, device="cpu", seed=1)
    pa, pb, pc = to_jax_params(a), to_jax_params(b), to_jax_params(c)
    for layer in pa:
        for key in pa[layer]:
            np.testing.assert_array_equal(pa[layer][key], pb[layer][key])
    assert not np.array_equal(pa["attn_0"]["Wq"], pc["attn_0"]["Wq"])
    g = torch.Generator().manual_seed(0)
    w = initializers.glorot_uniform((400, 600), g).numpy()
    limit = math.sqrt(6.0 / 1000)
    assert np.abs(w).max() <= limit
    assert abs(w.mean()) < 0.01 * limit
    assert abs(w.var() / (limit ** 2 / 3) - 1) < 0.02
    wq = pa["attn_0"]["Wq"]  # (d_model, heads, head_dim): JAX's fans
    assert np.abs(wq).max() <= math.sqrt(6.0 / (32 * 2 + 32 * 16))
    assert np.abs(pa["tok_embed"]["embeddings"]).max() <= 0.05
    assert np.abs(pa["pos_embed"]["table"]).max() <= 0.05 * 0.02
    np.testing.assert_array_equal(pa["ln_attn_0"]["gamma"], 1.0)
    np.testing.assert_array_equal(pa["ln_attn_0"]["beta"], 0.0)
    np.testing.assert_array_equal(pa["mlp_up_0"]["b"], 0.0)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Sequential()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Dense(4, input_dim=4, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert TransformerLM(**SMALL, device="cpu").device.type == "cpu"


def test_moe_is_not_ported_yet():
    """Switch-MoE is ported (moe_every builds SwitchMoE blocks), and so
    is the expert-parallel moe_sharded: it checks its axis as the JAX
    package's does."""
    from analytics_zoo_tpu_torch.parallel.expert import moe_sharded
    lm = TransformerLM(**SMALL, moe_every=2, device="cpu")
    assert [lm.is_moe_block(i) for i in range(SMALL["n_layers"])] == [
        (i + 1) % 2 == 0 for i in range(SMALL["n_layers"])]
    moe = getattr(lm, "moe_1")
    x = torch.zeros(6, SMALL["d_model"])
    with pytest.raises(ValueError, match="tokens"):
        moe_sharded(x, moe.moe_params(), {"expert": 4})


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "analytics_zoo_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py or the port's profile
    scripts, imports jax or the JAX package (matched by exact top-level
    name, not by prefix)."""
    assert _forbidden("analytics_zoo_tpu.ops.attention")
    assert _forbidden("jax.numpy")
    assert not _forbidden("analytics_zoo_tpu_torch.ops")
    files = sorted((REPO / "analytics_zoo_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py",
              *sorted((REPO / "scripts").glob("profile_torch_*.py"))]
    assert len(files) > 15
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imports(f) if _forbidden(m)]
    assert bad == []


@pytest.mark.parametrize("which", ["layernorm", "dense_gelu", "embedding"])
def test_layers_match_jax(which):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    if which == "layernorm":
        jl = JLayerNorm(name="t_ln")
        tl = LayerNorm(input_shape=(5, 8), device="cpu")
        shape = (None, 5, 8)
    elif which == "dense_gelu":
        jl = JDense(6, activation="gelu", name="t_dense")
        tl = Dense(6, activation="gelu", input_dim=8, device="cpu")
        shape = (None, 5, 8)
    else:
        jl, tl = JEmbedding(11, 8, name="t_emb"), Embedding(11, 8,
                                                          device="cpu")
        shape = (None, 5)
        x = rng.integers(0, 11, (3, 5))
    params, _ = jl.init(jax.random.PRNGKey(0), shape)
    params = {k: np.asarray(v) + rng.normal(0, 0.1, np.shape(v))
              .astype(np.float32) for k, v in params.items()}
    assert set(params) == set(tl.params())
    with torch.no_grad():
        for key, p in tl.params().items():
            p.copy_(torch.from_numpy(params[key]))
    ref = jl.call({k: jnp.asarray(v) for k, v in params.items()}, {},
                  jnp.asarray(x))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_activations_match_jax():
    """Every name of the JAX package's activations; gelu is the tanh
    approximation (jax.nn.gelu's default)."""
    x = np.linspace(-6, 6, 101, dtype=np.float32).reshape(1, 101)
    assert set(activations._ACTIVATIONS) == set(jact._ACTIVATIONS)
    for name in jact._ACTIVATIONS:
        np.testing.assert_allclose(
            activations.get(name)(torch.from_numpy(x)).numpy(),
            np.asarray(jact.get(name)(jnp.asarray(x))), rtol=1e-5,
            atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="Unknown activation"):
        activations.get("nope")
