"""The port's serving-side decode pieces against the JAX package's.

``_decode_window`` (the k-query cached decode) and ``_prefill_ext`` (the
prefix-conditioned tail prefill) from the same weights and inputs: logits,
hidden states and caches within 1e-5.  Beam search: the tokens of
``generate(num_beams=W)`` equal the JAX package's for W in {2, 3, 4},
every beam's score within 1e-5, and ``_backtrack_beams`` exactly equal.
All on the CPU.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models import generation as jgen
from analytics_zoo_tpu_torch.models import generation as tgen

from test_torch_generate import SMALL, VOCAB, models

TOL = 1e-5
SEQ = SMALL["seq_len"]


def jax_params(jm):
    return jm.ensure_inference_ready().state.params


def random_caches(rng, b, t):
    h = SMALL["n_heads"]
    d = SMALL["d_model"] // h
    return [tuple(rng.normal(size=(b, h, t, d)).astype(np.float32)
                  for _ in range(2)) for _ in range(SMALL["n_layers"])]


def test_decode_window_matches_jax_with_clamped_positions():
    """k = 3 queries per row; the last row's positions run past the end
    of the cache, so its writes clamp onto position t - 1."""
    jm, tm = models(seed=3)
    rng = np.random.default_rng(0)
    b, k, t = 3, 3, SEQ
    caches = random_caches(rng, b, t)
    x = rng.normal(size=(b, k, SMALL["d_model"])).astype(np.float32)
    pos = np.array([4, 17, t - 2], np.int32)
    ref_logits, ref_caches = jgen._decode_window(
        jax_params(jm), jm.hyper,
        [(jnp.asarray(a), jnp.asarray(c)) for a, c in caches],
        jnp.asarray(x), jnp.asarray(pos))
    tc = [(torch.from_numpy(a.copy()), torch.from_numpy(c.copy()))
          for a, c in caches]
    with torch.no_grad():
        logits = tgen._decode_window(tm, tc, torch.from_numpy(x),
                                     torch.from_numpy(pos).long())
    assert logits.shape == (b, k, VOCAB)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=TOL, rtol=TOL)
    for (ck, cv), (rk, rv) in zip(tc, ref_caches):
        np.testing.assert_allclose(ck.numpy(), np.asarray(rk), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(cv.numpy(), np.asarray(rv), atol=TOL,
                                   rtol=TOL)


def test_prefill_ext_matches_jax():
    jm, tm = models(seed=4)
    rng = np.random.default_rng(1)
    p_len, s_t = 8, 5
    prefix_kv = random_caches(rng, 1, p_len)
    tail = rng.integers(0, VOCAB, (1, s_t)).astype(np.int32)
    ref_x, ref_tc = jgen._prefill_ext(
        jax_params(jm), jm.hyper, jnp.asarray(tail),
        [(jnp.asarray(a), jnp.asarray(c)) for a, c in prefix_kv], p_len)
    with torch.no_grad():
        x, tc = tgen._prefill_ext(
            tm, torch.from_numpy(tail),
            [(torch.from_numpy(a), torch.from_numpy(c))
             for a, c in prefix_kv], p_len)
    assert x.shape == (1, s_t, SMALL["d_model"])
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), atol=TOL,
                               rtol=TOL)
    for (k, v), (rk, rv) in zip(tc, ref_tc):
        np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("width", [2, 3, 4])
def test_beam_search_matches_jax(width):
    jm, tm = models(seed=5)
    prompt = np.random.default_rng(width).integers(0, VOCAB, (2, 6))
    new = 5
    np.testing.assert_array_equal(
        tm.generate(prompt, new, num_beams=width),
        jm.generate(prompt, new, num_beams=width))
    ref = jgen.build_beam_fn(jm.hyper, 6, new, width)(
        jax_params(jm), jnp.asarray(prompt))
    with torch.no_grad():
        out = tgen.build_beam_fn(6, new, width)(
            tm, torch.as_tensor(prompt, dtype=torch.long))
    ref_seqs, ref_scores = jgen._backtrack_beams(*ref)
    seqs, scores = tgen._backtrack_beams(*out)
    np.testing.assert_array_equal(seqs, ref_seqs)
    np.testing.assert_allclose(scores, np.asarray(ref_scores), atol=TOL,
                               rtol=TOL)
    # descending cumulative log-prob per row
    assert (np.diff(scores, axis=1) <= 0).all()


def test_backtrack_beams_equals_jax():
    rng = np.random.default_rng(6)
    steps, b, W = 4, 3, 3
    tok0 = rng.integers(0, VOCAB, (b, W))
    toks = rng.integers(0, VOCAB, (steps, b, W))
    parents = rng.integers(0, W, (steps, b, W))
    scores = -np.sort(rng.random((b, W)), axis=1)
    ref = jgen._backtrack_beams(tok0, toks, parents, scores)
    out = tgen._backtrack_beams(torch.from_numpy(tok0),
                                torch.from_numpy(toks),
                                torch.from_numpy(parents), scores)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[0].dtype == ref[0].dtype
    np.testing.assert_array_equal(out[1], ref[1])


def test_single_token_beam_search_matches_jax():
    jm, tm = models(seed=7)
    prompt = np.random.default_rng(8).integers(0, VOCAB, (2, 4))
    np.testing.assert_array_equal(tm.generate(prompt, 1, num_beams=3),
                                  jm.generate(prompt, 1, num_beams=3))
