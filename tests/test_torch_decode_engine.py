"""The port's continuous-batching DecodeEngine and InferenceModel's
generate plane on the CPU, the counterparts of
``tests/test_serving_decode.py``.

Greedy streams (ragged prompts, per-row max_new, EOS) must be
token-identical to the JAX package's ``generate`` of the same prompts,
padded to the engine's prompt bucket; fused windows, the prefix pool and
speculative decoding must not change a stream; the plan count must not
move with occupancy; sampled streams replay and do not depend on
occupancy (their bits differ from JAX's threefry stream, so the
selection itself is held to JAX's ``_sample`` with shared uniforms).
Every engine and handle is closed by a fixture finalizer and every wait
has a timeout.
"""

import copy
import threading
import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models import TransformerLM as JaxLM
from analytics_zoo_tpu.models.generation import _sample as jax_sample
from analytics_zoo_tpu_torch.models import TransformerLM, from_jax_params
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.inference import (
    DecodeEngine, DecodeEngineClosedError, InferenceModel, TokenStream,
    skeleton_draft)
from analytics_zoo_tpu_torch.pipeline.inference.decode import (
    select_tokens, slot_uniforms)

VOCAB, SEQ, BUCKET = 64, 48, 16
CFG = dict(vocab_size=VOCAB, seq_len=SEQ, n_layers=2, d_model=32,
           n_heads=2)
WAIT = 60  # seconds: the bound of every blocking wait


def pair(seed=0):
    """The JAX model with perturbed seeded weights (a sharp head keeps
    greedy picks far from f32 ties) and the port loaded from them."""
    jm = JaxLM(**CFG)
    params = jax.device_get(jm.ensure_inference_ready().state.params)
    rng = np.random.default_rng(seed)
    tree = {layer: {key: ((np.asarray(a) + rng.normal(0, 0.1, a.shape))
                          * (5 if (layer, key) == ("lm_head", "W") else 1)
                          ).astype(np.float32)
                    for key, a in leaves.items()}
            for layer, leaves in params.items()}
    jm.set_weights(tree)
    tm = TransformerLM(**CFG, device="cpu")
    from_jax_params(tm, tree)
    return jm, tm.eval()


@pytest.fixture(scope="module")
def models():
    return pair()


@pytest.fixture(scope="module")
def lm(models):
    return models[1]


@pytest.fixture(scope="module")
def engine(lm):
    """One warmed engine (capacity 3, one prompt bucket) for the tests
    that only submit to it."""
    eng = DecodeEngine(lm, capacity=3, max_len=SEQ, prompt_buckets=(BUCKET,))
    eng.warmup()
    yield eng
    eng.close()


@pytest.fixture
def make_engine(lm):
    """Engines a test builds; each is closed when the test ends."""
    made = []

    def make(model=None, warm=True, **kw):
        kw.setdefault("capacity", 2)
        kw.setdefault("max_len", SEQ)
        kw.setdefault("prompt_buckets", (BUCKET,))
        eng = DecodeEngine(model if model is not None else lm, **kw)
        made.append(eng)
        if warm:
            eng.warmup()
        return eng

    yield make
    for eng in made:
        eng.close()


@pytest.fixture
def make_handle():
    made = []

    def make(**kw):
        im = InferenceModel(**kw)
        made.append(im)
        return im

    yield make
    for im in made:
        im.close()


def jax_streams(jm, prompts, max_news):
    """The JAX package's greedy continuations: every prompt padded to the
    bucket, decoded by one ragged ``generate``, cut to its max_new."""
    padded = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts])
    full = jm.generate(padded, max_new_tokens=max(max_news),
                       prompt_lengths=lens)
    return [full[i, L:L + m] for i, (L, m) in enumerate(zip(lens,
                                                           max_news))]


def prompts_of(rng, lengths):
    return [rng.integers(0, VOCAB, int(n)) for n in lengths]


# ---------------------------------------------------------- equivalence
def test_engine_greedy_streams_equal_jax(models, engine):
    """Ragged prompts with per-row max_new, decoded side by side in the
    slots: each stream equals the JAX package's generate."""
    jm, _ = models
    rng = np.random.default_rng(7)
    prompts = prompts_of(rng, (3, 7, BUCKET, 5, 11, 2))
    max_news = [9, 4, 12, 7, 3, 12]
    outs = engine.generate(prompts, max_news, timeout=WAIT)
    for out, ref in zip(outs, jax_streams(jm, prompts, max_news)):
        np.testing.assert_array_equal(out, ref)
        assert out.dtype == np.int32


def test_eos_evicts_early_and_is_included(models, engine):
    jm, _ = models
    prompt = np.random.default_rng(11).integers(0, VOCAB, 6)
    ref = jax_streams(jm, [prompt], [12])[0]
    eos = int(ref[4])
    stop = int(np.argmax(ref == eos))  # first occurrence
    out = engine.generate([prompt], [12], eos_id=eos, timeout=WAIT)[0]
    np.testing.assert_array_equal(out, ref[:stop + 1])
    assert int(out[-1]) == eos


def test_fused_windows_change_overhead_not_tokens(make_engine):
    rng = np.random.default_rng(3)
    prompts = prompts_of(rng, (4, 9, 6, 13))
    max_news = [11, 5, 8, 2]
    outs = {}
    for fuse in (1, 4):
        eng = make_engine(step_fuse=fuse)
        outs[fuse] = eng.generate(prompts, max_news, timeout=WAIT)
        if fuse == 4:
            assert eng.stats()["fused_dispatches"] > 0
    for a, b in zip(outs[1], outs[4]):
        np.testing.assert_array_equal(a, b)


def test_plans_built_once_at_every_occupancy(make_engine):
    """A warmed engine serves occupancy 1..capacity, ramping up and
    draining down, without building (on the card: capturing) another
    plan or another admission."""
    capacity = 3
    eng = make_engine(capacity=capacity)
    built = eng.stats()["plans_built"]
    assert built == 3  # the single step and the windows of 4 and 2
    rng = np.random.default_rng(0)
    for k in range(1, capacity + 1):
        streams = [eng.submit(rng.integers(0, VOCAB, 4 + i), 6)
                   for i in range(k)]
        for s in streams:
            assert s.result(timeout=WAIT).shape == (6,)
    streams = [eng.submit(rng.integers(0, VOCAB, 5), 4 * (i + 1))
               for i in range(capacity)]
    for i, s in enumerate(streams):
        assert s.result(timeout=WAIT).shape == (4 * (i + 1),)
    stats = eng.stats()
    assert stats["plans_built"] == built
    assert stats["captures"] == 0  # the CPU runs the bodies eagerly
    assert stats["prefill_misses"] == {BUCKET: 1}
    assert stats["admitted"] == sum(range(1, capacity + 1)) + capacity
    assert stats["slots_active"] == 0


def test_slots_recycle_beyond_capacity(engine):
    before = engine.stats()
    rng = np.random.default_rng(5)
    n = 10  # > 3x capacity
    prompts = prompts_of(rng, rng.integers(2, BUCKET + 1, n))
    max_news = [int(rng.integers(1, 10)) for _ in range(n)]
    outs = engine.generate(prompts, max_news, timeout=WAIT)
    assert [len(o) for o in outs] == max_news
    after = engine.stats()
    assert after["admitted"] - before["admitted"] == n
    assert after["evicted"] - before["evicted"] == n
    assert after["slots_active"] == 0
    assert after["queued"] == 0
    assert after["prefill_misses"] == before["prefill_misses"]


# ------------------------------------------------------- streaming API
def test_token_stream_iterates_incrementally(models, engine):
    jm, _ = models
    prompt = np.random.default_rng(13).integers(0, VOCAB, 8)
    ref = jax_streams(jm, [prompt], [10])[0]
    stream = engine.submit(prompt, 10)
    got = []
    deadline = time.monotonic() + WAIT
    for tok in stream:
        got.append(tok)
        assert time.monotonic() < deadline
    np.testing.assert_array_equal(np.asarray(got, np.int32), ref)
    assert stream.done
    np.testing.assert_array_equal(stream.result(timeout=1), ref)
    assert len(stream.t_tokens) == 10
    assert stream.t_tokens[0] >= stream.t_submit


def test_token_stream_result_timeout():
    s = TokenStream(request_id=1)  # never finished by anyone
    with pytest.raises(TimeoutError):
        s.result(timeout=0.05)


def test_submit_validation(engine):
    with pytest.raises(ValueError, match="non-empty 1-D"):
        engine.submit(np.zeros((2, 3), np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit([1, 2, 3], 0)
    with pytest.raises(ValueError, match="exceeds the largest"):
        engine.submit(np.zeros(BUCKET + 1, np.int32), 4)
    with pytest.raises(ValueError, match="exceeds"):
        engine.submit(np.zeros(BUCKET, np.int32), SEQ)  # > max_len


def test_generate_batch_validation_is_all_or_nothing(engine):
    before = engine.stats()
    with pytest.raises(ValueError, match="exceeds the largest"):
        engine.generate([np.ones(4, np.int32),
                         np.zeros(BUCKET + 1, np.int32)], 4)
    assert engine.stats()["admitted"] == before["admitted"]


def test_engine_config_validation(lm):
    with pytest.raises(ValueError, match="capacity"):
        DecodeEngine(lm, capacity=0)
    with pytest.raises(ValueError, match="prefix_pool"):
        DecodeEngine(lm, capacity=1, prefix_pool=-1)
    with pytest.raises(ValueError, match="positional table"):
        DecodeEngine(lm, capacity=1, max_len=SEQ + 1)
    with pytest.raises(ValueError, match="room to decode"):
        DecodeEngine(lm, capacity=1, max_len=8, prompt_buckets=(8,))


# ------------------------------------------------------------ lifecycle
def test_close_drains_then_rejects(make_engine):
    eng = make_engine()
    rng = np.random.default_rng(1)
    streams = [eng.submit(rng.integers(0, VOCAB, 4), 8)
               for _ in range(4)]  # 2 queued behind 2 active
    eng.close(timeout=WAIT)
    for s in streams:
        assert s.result(timeout=WAIT).shape == (8,)
    with pytest.raises(DecodeEngineClosedError):
        eng.submit(rng.integers(0, VOCAB, 4), 2)
    eng.close()  # idempotent


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_crash_net_fails_all_streams(make_engine):
    eng = make_engine()
    boom = RuntimeError("injected decode crash")

    def exploding(*a, **kw):
        raise boom

    eng._step_plan = exploding
    eng._stepk_plans = {k: exploding for k in eng._stepk_plans}
    rng = np.random.default_rng(2)
    streams = [eng.submit(rng.integers(0, VOCAB, 4), 8) for _ in range(4)]
    for s in streams:
        with pytest.raises(RuntimeError, match="injected decode crash"):
            s.result(timeout=WAIT)
    deadline = time.monotonic() + 10
    while not eng.closed and time.monotonic() < deadline:
        time.sleep(0.02)
    with pytest.raises(DecodeEngineClosedError):
        eng.submit(rng.integers(0, VOCAB, 4), 2)


def test_concurrent_submitters(models, engine):
    """Many threads streaming through one engine: every stream equals the
    JAX package's generate (no bleed between requests)."""
    jm, _ = models
    rng = np.random.default_rng(17)
    cases = [(rng.integers(0, VOCAB, int(rng.integers(2, 12))),
              int(rng.integers(1, 9))) for _ in range(8)]
    refs = jax_streams(jm, [p for p, _ in cases], [m for _, m in cases])
    outs = [None] * len(cases)
    errs = []

    def worker(i):
        try:
            outs[i] = engine.submit(*cases[i]).result(timeout=WAIT)
        except BaseException as e:  # noqa: BLE001 - asserted below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not errs, errs
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)


def test_unwarmed_engine_serves_and_late_warmup_raises(models, make_engine):
    jm, _ = models
    eng = make_engine(warm=False)
    prompt = np.random.default_rng(31).integers(0, VOCAB, 5)
    out = eng.submit(prompt, 4).result(timeout=WAIT)
    np.testing.assert_array_equal(out, jax_streams(jm, [prompt], [4])[0])
    assert eng.stats()["prefill_misses"] == {BUCKET: 1}
    assert eng.stats()["plans_built"] == 3
    with pytest.raises(RuntimeError, match="before the first"):
        eng.warmup()


# ---------------------------------------------------- InferenceModel
def test_inference_model_generate_wiring(models, make_handle):
    jm, lm = models
    im = make_handle(supported_concurrent_num=2, decode_capacity=2,
                     decode_prompt_buckets=(BUCKET,))
    im.load_keras_net(lm)
    rng = np.random.default_rng(23)
    prompts = prompts_of(rng, (5, 9))
    outs = im.generate(prompts, [6, 3], timeout=WAIT)
    for out, ref in zip(outs, jax_streams(jm, prompts, [6, 3])):
        np.testing.assert_array_equal(out, ref)
    stream = im.generate_stream(prompts[0], 6)
    np.testing.assert_array_equal(stream.result(timeout=WAIT), outs[0])
    stats = im.serving_stats()
    assert stats["decode"]["capacity"] == 2
    assert stats["decode"]["tokens"] >= 15
    # the predict plane serves the same model
    logp = im.predict(np.zeros((1, BUCKET), np.int32))
    assert logp.shape == (1, BUCKET, VOCAB)


def test_inference_model_without_engine_raises(lm, make_handle):
    im = make_handle(supported_concurrent_num=1)
    im.load_keras_net(lm)
    with pytest.raises(RuntimeError, match="no decode engine"):
        im.generate([[1, 2, 3]], 4)


def dense_net():
    net = Sequential(device="cpu")
    net.add(Dense(4, input_shape=(3,)))
    return net


def test_decode_capacity_requires_lm(make_handle):
    im = make_handle(supported_concurrent_num=1, decode_capacity=2)
    with pytest.raises(ValueError, match="generation-capable"):
        im.load_keras_net(dense_net())


def test_failed_reload_leaves_handle_on_old_version(lm, make_handle):
    """A reload whose engine build fails leaves both planes on the old
    version."""
    im = make_handle(supported_concurrent_num=1, decode_capacity=2,
                     decode_prompt_buckets=(BUCKET,))
    im.load_keras_net(lm)
    prompt = np.random.default_rng(37).integers(0, VOCAB, 5)
    before = im.generate([prompt], [4], timeout=WAIT)[0]
    old_engine = im.decode_engine
    with pytest.raises(ValueError, match="generation-capable"):
        im.load_keras_net(dense_net())
    assert im.decode_engine is old_engine
    assert not old_engine.closed
    np.testing.assert_array_equal(
        im.generate([prompt], [4], timeout=WAIT)[0], before)
    out = im.predict(np.zeros((1, BUCKET), np.int32))
    assert out.shape[-1] == VOCAB


def test_saved_lm_loads_and_serves(models, make_handle, tmp_path):
    """``load`` rebuilds a saved TransformerLM (the port's save_model
    format) and serves it with an engine."""
    jm, lm = models
    lm.save_model(str(tmp_path / "lm"))
    im = make_handle(decode_capacity=2, decode_prompt_buckets=(BUCKET,),
                     device="cpu")
    im.load(str(tmp_path / "lm"))
    prompt = np.random.default_rng(41).integers(0, VOCAB, 7)
    np.testing.assert_array_equal(
        im.generate([prompt], [5], timeout=WAIT)[0],
        jax_streams(jm, [prompt], [5])[0])


@pytest.mark.parametrize("kw", [dict(replicas=2), dict(replicas="all"),
                                dict(hedging=True), dict(mesh={"tp": 2}),
                                dict(store_tag="m")])
def test_unported_handle_options_raise(kw):
    """Every option here is ported now: ``replicas``, ``hedging`` and
    ``store_tag`` serve, and a malformed ``mesh`` spec (``tp`` is no spec
    key) raises at construction, with the JAX package's message."""
    if "mesh" in kw:
        with pytest.raises(ValueError, match="unknown mesh spec keys"):
            InferenceModel(**kw)
        return
    im = InferenceModel(device="cpu", max_batch_size=2, **kw)
    im.load_fn(lambda p, x: x * p["s"], {"s": np.float32(3.0)})
    try:
        x = np.ones((2, 4), np.float32)
        np.testing.assert_array_equal(im.predict(x), 3.0 * x)
        assert im.n_replicas >= 1
    finally:
        im.close()


# ------------------------------------------------------------ sampling
def test_sampled_streams_replay_and_occupancy_invariance(engine):
    rng = np.random.default_rng(41)
    prompts = prompts_of(rng, (4, 9, 6))
    kw = dict(temperature=0.8, top_k=16, top_p=0.95)
    a = engine.generate(prompts, [8, 5, 7], seed=[7, 8, 9], timeout=WAIT,
                        **kw)
    b = engine.generate(prompts, [8, 5, 7], seed=[7, 8, 9], timeout=WAIT,
                        **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    alone = engine.generate([prompts[1]], [5], seed=8, timeout=WAIT,
                            **kw)[0]
    np.testing.assert_array_equal(alone, a[1])
    c = engine.generate([prompts[1]], [5], seed=1234, timeout=WAIT, **kw)[0]
    assert not np.array_equal(c, a[1])
    assert engine.stats()["sampled_tokens"] >= 27


def test_greedy_requests_share_the_sampling_plan_bit_exact(models, engine):
    jm, _ = models
    rng = np.random.default_rng(43)
    gp, sp = rng.integers(0, VOCAB, 6), rng.integers(0, VOCAB, 9)
    ref = jax_streams(jm, [gp], [8])[0]
    s_greedy = engine.submit(gp, 8)
    s_sampled = engine.submit(sp, 8, temperature=1.1, seed=5)
    out_g = s_greedy.result(timeout=WAIT)
    s_sampled.result(timeout=WAIT)
    np.testing.assert_array_equal(out_g, ref)


def test_sampling_validation(engine):
    with pytest.raises(ValueError, match="temperature"):
        engine.submit([1, 2], 4, temperature=-0.5)
    with pytest.raises(ValueError, match="temperature"):
        engine.submit([1, 2], 4, temperature=float("nan"))
    with pytest.raises(ValueError, match="top_k"):
        engine.submit([1, 2], 4, temperature=0.5, top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        engine.submit([1, 2], 4, temperature=0.5, top_p=0.0)
    with pytest.raises(ValueError, match="top_p"):
        engine.submit([1, 2], 4, temperature=0.5, top_p=1.5)
    with pytest.raises(ValueError, match="seed"):
        engine.submit([1, 2], 4, seed=-1)
    with pytest.raises(ValueError, match="seed"):
        engine.generate([[1, 2]], [4], seed=[2 ** 40])


def test_per_slot_selection_matches_jax_sample():
    """The engine's per-slot selection (temperature 0 rows, top-k 0 and
    top-p 1 rows off) against the JAX package's ``_sample`` with traced
    per-row values, fed each JAX key's own uniform."""
    rng = np.random.default_rng(4)
    n = 12
    logits = (rng.normal(size=(n, VOCAB)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.8, 1.0, 1.3] * 3, np.float32)
    topk = np.array([0, 5, 0, 9, 1, 0] * 2, np.int32)
    topp = np.array([1.0, 1.0, 0.9, 0.8, 1.0, 1e-9] * 2, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    ref = jax.vmap(lambda lg, k, t, tk, tp: jax_sample(lg, k, t, tk, tp))(
        jnp.asarray(logits), keys, jnp.asarray(temp), jnp.asarray(topk),
        jnp.asarray(topp))
    u = np.array([jax.random.uniform(k, (), jnp.float32) for k in keys])
    out = select_tokens(torch.from_numpy(logits), torch.from_numpy(u),
                        torch.from_numpy(temp),
                        torch.from_numpy(topk).long(),
                        torch.from_numpy(topp))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_slot_uniforms_are_a_function_of_seed_and_index():
    seed = torch.tensor([0, 1, 2 ** 31 - 1, 7] * 256, dtype=torch.long)
    index = torch.arange(1024, dtype=torch.long)
    u = slot_uniforms(seed, index)
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    np.testing.assert_array_equal(u.numpy(),
                                  slot_uniforms(seed, index).numpy())
    # row order does not matter: each value depends on its own pair only
    perm = torch.randperm(1024, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(slot_uniforms(seed[perm], index[perm]),
                                  u[perm])
    # close to uniform: each tenth of [0, 1) holds about a tenth
    hist = np.histogram(u.numpy(), bins=10, range=(0, 1))[0]
    assert hist.min() > 60 and hist.max() < 145, hist


# -------------------------------------------------------- prefix pool
@pytest.fixture(scope="module")
def shared_prefix_requests():
    """Every prompt opens with the same 8-token prefix (the small bucket,
    where the pool splits) and carries its own tail."""
    rng = np.random.default_rng(47)
    head = rng.integers(0, VOCAB, 8)
    return [np.concatenate([head, rng.integers(0, VOCAB, int(u))])
            for u in (3, 5, 2, 0, 7)]


def test_prefix_pool_hits_and_streams_match_pool_off(
        make_engine, shared_prefix_requests):
    prompts = shared_prefix_requests
    max_news = [6] * len(prompts)
    pooled = make_engine(prompt_buckets=(8, BUCKET), prefix_pool=4)
    plain = make_engine(prompt_buckets=(8, BUCKET))
    o_pool = pooled.generate(prompts, max_news, timeout=WAIT)
    o_plain = plain.generate(prompts, max_news, timeout=WAIT)
    for a, b in zip(o_pool, o_plain):
        np.testing.assert_array_equal(a, b)
    st = pooled.stats()
    assert st["prefix_misses"] == 1
    assert st["prefix_hits"] == len(prompts) - 1
    for a, b in zip(pooled.generate(prompts, max_news, timeout=WAIT),
                    o_pool):
        np.testing.assert_array_equal(a, b)
    assert pooled.stats()["prefix_misses"] == 1
    assert pooled.stats()["plans_built"] == 3


def test_prefix_pool_eviction_recomputes_never_wrong(make_engine):
    rng = np.random.default_rng(53)
    pfx_a, pfx_b = (rng.integers(0, VOCAB, 8) for _ in range(2))
    pa = np.concatenate([pfx_a, rng.integers(0, VOCAB, 4)])
    pb = np.concatenate([pfx_b, rng.integers(0, VOCAB, 4)])
    eng = make_engine(prompt_buckets=(8, BUCKET), prefix_pool=1)
    ref_a = eng.generate([pa], [6], timeout=WAIT)[0]
    ref_b = eng.generate([pb], [6], timeout=WAIT)[0]
    for _ in range(2):  # thrash: a evicts b evicts a ...
        np.testing.assert_array_equal(
            eng.generate([pa], [6], timeout=WAIT)[0], ref_a)
        np.testing.assert_array_equal(
            eng.generate([pb], [6], timeout=WAIT)[0], ref_b)
    st = eng.stats()
    assert st["prefix_evictions"] >= 4, st
    assert st["prefix_hits"] == 0
    assert st["prefix_pool_entries"] == 1


# ------------------------------------------------------ speculative
def test_spec_forced_full_rejection_is_bit_exact(make_engine):
    """A draft that always proposes token 0 against a target that never
    emits it: every window falls back to the exact step's token, and the
    streams equal the same target's plain engine."""
    _, target = pair(seed=1)
    with torch.no_grad():
        target.lm_head.b[0] -= 1e9
    draft = skeleton_draft(target)
    # the draft's own head, biased to token 0
    draft.lm_head = copy.deepcopy(target.lm_head)
    with torch.no_grad():
        draft.lm_head.b[0] += 2e9
    rng = np.random.default_rng(61)
    prompts = [rng.integers(1, VOCAB, int(n)) for n in (4, 9, 6)]
    max_news = [9, 4, 7]
    spec = make_engine(target, capacity=3, draft=draft, spec_tokens=4)
    plain = make_engine(target, capacity=3)
    o_spec = spec.generate(prompts, max_news, timeout=WAIT)
    o_plain = plain.generate(prompts, max_news, timeout=WAIT)
    for a, b in zip(o_spec, o_plain):
        np.testing.assert_array_equal(a, b)
    st = spec.stats()
    assert st["spec_proposed"] > 0
    assert st["spec_accepted"] == 0
    assert st["spec_acceptance"] == 0.0
    assert st["plans_built"] == 1
    assert not any(0 in np.asarray(o) for o in o_spec)


def test_spec_streams_match_non_spec_and_accept(make_engine):
    """A residual-dominated target (block weights scaled by 0.05) against
    its 0-layer skeleton draft: real acceptance, and streams equal to the
    plain engine's, greedy and sampled."""
    _, target = pair(seed=2)
    with torch.no_grad():
        for name, p in target.named_parameters():
            if name.startswith(("attn_", "mlp_", "ln_attn", "ln_mlp")):
                p.mul_(0.05)
    rng = np.random.default_rng(67)
    prompts = [rng.integers(0, VOCAB, int(n)) for n in (4, 9, 6, 12)]
    max_news = [9, 4, 12, 6]
    spec = make_engine(target, capacity=3, draft=skeleton_draft(target))
    plain = make_engine(target, capacity=3)
    for a, b in zip(spec.generate(prompts, max_news, timeout=WAIT),
                    plain.generate(prompts, max_news, timeout=WAIT)):
        np.testing.assert_array_equal(a, b)
    assert spec.stats()["spec_accepted"] > 0
    kw = dict(temperature=0.7, top_k=24, seed=[1, 2, 3, 4], timeout=WAIT)
    for a, b in zip(spec.generate(prompts, max_news, **kw),
                    plain.generate(prompts, max_news, **kw)):
        np.testing.assert_array_equal(a, b)


def test_spec_config_validation(lm):
    draft = skeleton_draft(lm)
    with pytest.raises(ValueError, match="spec_tokens"):
        DecodeEngine(lm, draft=draft, spec_tokens=1)
    other = TransformerLM(**dict(CFG, vocab_size=7, n_layers=0),
                          device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        DecodeEngine(lm, draft=other)
    with pytest.raises(ValueError, match="mutually"):
        DecodeEngine(lm, draft=draft, prefix_pool=2)
