"""The port's generate() against the JAX package's, from shared weights.

Greedy and ragged token streams must be equal; the validation errors
must carry the same messages; ``_sample`` fed the JAX draw's own
uniforms must pick the same tokens.  Both run on the CPU.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models import TransformerLM as JaxLM
from analytics_zoo_tpu.models.generation import _sample as jax_sample
from analytics_zoo_tpu_torch.models import TransformerLM, from_jax_params
from analytics_zoo_tpu_torch.models.generation import _sample

VOCAB = 59
SMALL = dict(vocab_size=VOCAB, seq_len=32, n_layers=2, d_model=32,
             n_heads=2)


def models(seed=0):
    """The JAX model with perturbed seeded weights (a sharp head keeps
    the greedy argmax far from f32 ties), and the port loaded from it."""
    jm = JaxLM(**SMALL)
    params = jax.device_get(jm.ensure_inference_ready().state.params)
    rng = np.random.default_rng(seed)
    tree = {layer: {key: ((np.asarray(a) + rng.normal(0, 0.1, a.shape))
                          * (5 if (layer, key) == ("lm_head", "W") else 1)
                          ).astype(np.float32)
                    for key, a in leaves.items()}
            for layer, leaves in params.items()}
    jm.set_weights(tree)
    tm = TransformerLM(**SMALL, device="cpu")
    from_jax_params(tm, tree)
    return jm, tm


def test_greedy_streams_equal_jax():
    jm, tm = models()
    prompt = np.random.default_rng(1).integers(0, VOCAB, (3, 8))
    ref = jm.generate(prompt, max_new_tokens=6, temperature=0.0)
    out = tm.generate(prompt, max_new_tokens=6, temperature=0.0)
    assert out.shape == (3, 14) and out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


def test_ragged_streams_equal_jax():
    jm, tm = models(seed=1)
    prompt = np.random.default_rng(2).integers(0, VOCAB, (3, 8))
    lens = np.array([8, 5, 1])
    ref = jm.generate(prompt, max_new_tokens=5, prompt_lengths=lens)
    out = tm.generate(prompt, max_new_tokens=5, prompt_lengths=lens)
    np.testing.assert_array_equal(out, ref)


def test_greedy_matches_port_forward_argmax():
    """Each greedy token is the full forward's argmax at the position
    before it: pins the prefill and every cached step to the forward."""
    _, tm = models(seed=2)
    prompt = np.random.default_rng(3).integers(0, VOCAB, (2, 8))
    out = tm.generate(prompt, max_new_tokens=6)
    logp = tm.predict(out[:, :13], batch_size=2)
    np.testing.assert_array_equal(out[:, 8:], logp[:, 7:].argmax(-1))


def test_zero_new_tokens_returns_prompt():
    jm, tm = models()
    prompt = np.arange(8)[None].repeat(2, 0)
    np.testing.assert_array_equal(tm.generate(prompt, 0),
                                  jm.generate(prompt, 0))


VALIDATION = [
    ("rank", dict(prompt=np.zeros((8,), int), max_new_tokens=2)),
    ("max_len", dict(max_new_tokens=30)),
    ("lengths shape", dict(max_new_tokens=2, prompt_lengths=[8, 8, 8])),
    ("lengths range", dict(max_new_tokens=2, prompt_lengths=[0, 8])),
    ("lengths above", dict(max_new_tokens=2, prompt_lengths=[9, 8])),
    ("beam with lengths", dict(max_new_tokens=2, prompt_lengths=[8, 8],
                               num_beams=2)),
    ("beam sampling", dict(max_new_tokens=2, num_beams=2, top_p=0.9)),
    ("beam zero tokens", dict(max_new_tokens=0, num_beams=2)),
    ("beam width", dict(max_new_tokens=2, num_beams=VOCAB + 1)),
]


@pytest.mark.parametrize("what,kw", VALIDATION, ids=[v[0] for v in VALIDATION])
def test_validation_errors_match_jax(what, kw):
    jm, tm = models()
    kw = dict(kw)
    prompt = kw.pop("prompt", np.zeros((2, 8), int))
    with pytest.raises(ValueError) as ref:
        jm.generate(prompt, **kw)
    with pytest.raises(ValueError) as out:
        tm.generate(prompt, **kw)
    assert str(out.value) == str(ref.value)


def test_beam_search_is_not_ported_yet():
    _, tm = models()
    with pytest.raises(NotImplementedError, match="beam"):
        tm.generate(np.zeros((2, 8), int), 2, num_beams=2)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.8, None, None),
    (1.0, 5, None),
    (0.9, None, 0.9),
    (0.7, 9, 0.8),
    (1.3, 1, None),
    (0.5, None, 1e-9),
])
def test_sample_with_shared_uniforms_matches_jax(temperature, top_k, top_p):
    """The JAX draw's uniforms (``jax.random.uniform`` on its key, as
    inside its ``_sample``) fed to the port: the same tokens.  Logits are
    continuous random values, so the sort has no ties."""
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(16, VOCAB)) * 3).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        u = np.array(jax.random.uniform(key, (16,), jnp.float32))
        ref = np.asarray(jax_sample(jnp.asarray(logits), key, temperature,
                                    top_k, top_p))
        out = _sample(torch.from_numpy(logits), temperature, top_k, top_p,
                      uniforms=torch.from_numpy(u))
        np.testing.assert_array_equal(out.numpy(), ref)


def test_sample_greedy_is_argmax_and_sorts_ties_like_jax():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0]])
    np.testing.assert_array_equal(_sample(logits, 0.0).numpy(), [1, 0])
    # top_k=1 keeps the first of the tied maxima, as lax.top_k orders them
    u = torch.tensor([0.99, 0.99])
    ref = jax_sample(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
                     1.0, 1, None)
    np.testing.assert_array_equal(_sample(logits, 1.0, 1, uniforms=u),
                                  np.asarray(ref))


def test_sampled_generate_is_seeded():
    _, tm = models()
    prompt = np.random.default_rng(5).integers(0, VOCAB, (2, 8))
    a = tm.generate(prompt, 4, temperature=1.0, seed=0)
    b = tm.generate(prompt, 4, temperature=1.0, seed=0)
    c = tm.generate(prompt, 4, temperature=1.0, seed=1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(
        tm.generate(prompt, 4, temperature=0.7, top_k=1, seed=5),
        tm.generate(prompt, 4))
