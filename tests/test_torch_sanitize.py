"""The port's runtime sanitizer over its serving hot loops on the CPU:
the counterparts of the reference's sanitize cases in
``tests/test_serving_fastpath.py``, ``tests/test_serving_replicas.py``,
``tests/test_serving_decode.py`` and ``tests/test_execstore.py``.

On a card the guard is c10's sync debug mode (``torch.cuda.
set_sync_debug_mode("error")``), which these tests cannot reach: the
CPU has no device to sync with.  So the ``sync_guard`` fixture stands in
for it here: it reports a card to the sanitizer, keeps the mode the
sanitizer sets, and makes the Python-level calls c10 would flag —
``Tensor.item()``, ``.cpu()`` and ``.tolist()`` — raise under "error"
(warn under "warn"), in every thread, as the real mode does.  It sees
only those three calls (not ``int(t)`` or a blocking ``.to()``), so it
pins that the warmed serving paths make none of them; the card itself
holds the rest (``tests/test_torch_cuda.py``, ``chip_smoke.py
--phases sanitize``).  Every handle and engine is closed by the test,
and every wait is bounded.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.models import TransformerLM
from analytics_zoo_tpu_torch.pipeline.inference import (DecodeEngine,
                                                        InferenceModel)
from analytics_zoo_tpu_torch.tools.zoolint import RecompileDetected

VOCAB, SEQ, BUCKET = 64, 48, 16
WAIT = 60  # seconds: the bound of every blocking wait
SYNC_ERROR = "called a synchronizing CUDA operation"


@pytest.fixture
def zoolint_sanitize():
    """The port's runtime sanitizer: zero unexpected compile-like events
    (kernel builds, signature builds, graph captures) and, with a card,
    no implicit syncs (docs/dev/zoolint_torch.md §Runtime sanitizer)."""
    from analytics_zoo_tpu_torch.tools.zoolint import sanitize
    return sanitize


@pytest.fixture
def sync_guard(monkeypatch):
    """The CPU stand-in for c10's sync debug mode (module doc).  Yields
    the mode holder: ``state["mode"]`` is what the sanitizer set."""
    from analytics_zoo_tpu_torch.tools.zoolint import sanitizer
    state = {"mode": 0, "sets": []}

    def set_mode(mode):
        mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        state["mode"] = int(mode)
        state["sets"].append(int(mode))

    def guarded(name):
        real = getattr(torch.Tensor, name)

        def call(self, *args, **kwargs):
            if state["mode"] == 2:
                raise RuntimeError(f"{SYNC_ERROR} (Tensor.{name})")
            if state["mode"] == 1:
                warnings.warn(f"{SYNC_ERROR} (Tensor.{name})")
            return real(self, *args, **kwargs)
        return call

    monkeypatch.setattr(sanitizer, "_card_in_use", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, guarded(name))
    return state


def _handle(fn, params, **kw):
    kw.setdefault("device", "cpu")
    im = InferenceModel(**kw)
    im.load_fn(fn, params)
    return im


@pytest.fixture(scope="module")
def lm():
    torch.manual_seed(0)
    return TransformerLM(vocab_size=VOCAB, seq_len=SEQ, n_layers=2,
                         d_model=32, n_heads=2, device="cpu",
                         seed=0).eval()


# ----------------------------------------------------- the guard itself
def test_guard_sets_error_and_restores_entry_mode(zoolint_sanitize,
                                                  sync_guard):
    """"disallow" sets "error" for the block and the entry mode comes
    back at exit, also when the block raised; "log" sets "warn"; None
    leaves the mode alone."""
    t = torch.ones(3)
    with zoolint_sanitize(max_compiles=0) as rep:
        assert sync_guard["mode"] == 2
        with pytest.raises(RuntimeError, match=SYNC_ERROR):
            t.sum().item()  # the injected implicit fetch
    assert (rep.sync_mode_before, rep.sync_mode_in_block) == (0, 2)
    assert sync_guard["mode"] == 0
    with pytest.raises(ZeroDivisionError):
        with zoolint_sanitize(max_compiles=0):
            1 / 0
    assert sync_guard["mode"] == 0
    with zoolint_sanitize(max_compiles=0, transfer_guard="log"):
        with pytest.warns(UserWarning, match=SYNC_ERROR):
            t.tolist()
    with zoolint_sanitize(max_compiles=0, transfer_guard=None):
        assert t.sum().item() == 3.0
    assert sync_guard["sets"] == [2, 0, 2, 0, 1, 0]
    with pytest.raises(ValueError, match="transfer_guard"):
        with zoolint_sanitize(transfer_guard="forbid"):
            pass


# ------------------------------------- test_serving_fastpath.py's cases
def test_torch_coalescer_hot_loop_is_sanitize_clean(zoolint_sanitize,
                                                    sync_guard):
    """The coalescer hot loop — concurrent callers, the dispatcher
    thread, padded dispatch, fan-out — builds nothing and makes no
    implicit fetch once warmed.  The dispatcher runs in a thread of its
    own, which is why the guard is process-wide."""
    im = _handle(lambda p, x: x @ p["w"], {"w": np.eye(4, dtype=np.float32)},
                 supported_concurrent_num=2, max_batch_size=8,
                 coalescing=True, max_wait_ms=2.0)
    errors = []

    def worker(i):
        try:
            im.predict(np.full((1 + i % 3, 4), float(i), np.float32))
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errors.append(repr(e))

    try:
        im.warmup((4,))
        with zoolint_sanitize(max_compiles=0) as rep:
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(12)]
            [t.start() for t in threads]
            [t.join(WAIT) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert rep.compiles == 0
    finally:
        im.close()


def test_torch_sanitize_catches_recompile_injected_into_hot_loop(
        zoolint_sanitize):
    """The negative control: an unwarmed signature slipped into the same
    coalesced hot loop IS caught, and named by kind."""
    im = _handle(lambda p, x: x * p["s"], {"s": np.float32(2.0)},
                 supported_concurrent_num=2, max_batch_size=8,
                 coalescing=True, max_wait_ms=2.0)
    try:
        im.warmup((4,))
        with pytest.raises(RecompileDetected, match="signature_build"):
            with zoolint_sanitize(max_compiles=0, transfer_guard=None):
                im.predict(np.ones((1, 4), np.float32))  # warm: clean
                im.predict(np.ones((1, 6), np.float32))  # new signature
    finally:
        im.close()


def test_torch_sanitize_catches_implicit_sync_injected_into_dispatch(
        zoolint_sanitize, sync_guard):
    """A forward that regresses to an implicit fetch (``.item()`` inside
    the dispatched function) aborts the dispatch under the guard and the
    caller sees it; the REAL dispatch path stays clean under the same
    guard, with the same bits."""
    def leaky(p, x):
        scale = x.abs().max().item()  # the injected implicit fetch
        return x + p["b"] * scale / scale

    bad = _handle(leaky, {"b": np.float32(1.0)}, max_batch_size=8)
    good = _handle(lambda p, x: x + p["b"], {"b": np.float32(1.0)},
                   max_batch_size=8)
    try:
        bad.warmup((4,))
        good.warmup((4,))
        with pytest.raises(RuntimeError, match=SYNC_ERROR):
            with zoolint_sanitize(max_compiles=0):
                bad.predict(np.ones((2, 4), np.float32))
        with zoolint_sanitize(max_compiles=0):
            out = good.predict(np.ones((2, 4), np.float32))
        np.testing.assert_array_equal(out, np.full((2, 4), 2.0, np.float32))
    finally:
        bad.close()
        good.close()


# ------------------------------------- test_serving_replicas.py's cases
def test_torch_multi_replica_hot_loop_is_sanitize_clean(zoolint_sanitize,
                                                        sync_guard):
    """The warmed replica-parallel loop — dispatcher thread, staging
    arena, per-replica forwards — builds nothing and makes no implicit
    fetch."""
    im = _handle(lambda p, x: x @ p["w"], {"w": np.eye(4, dtype=np.float32)},
                 supported_concurrent_num=4, max_batch_size=8,
                 coalescing=True, max_wait_ms=2.0, replicas=4)
    errors = []

    def worker(i):
        try:
            im.predict(np.full((1 + i % 3, 4), float(i), np.float32))
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    try:
        im.warmup((4,))
        with zoolint_sanitize(max_compiles=0) as rep:
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(16)]
            [t.start() for t in threads]
            [t.join(WAIT) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert rep.compiles == 0
    finally:
        im.close()


def test_torch_sanitize_catches_implicit_sync_in_a_worker_thread(
        zoolint_sanitize, sync_guard):
    """The guard is process-wide precisely so a dispatcher-style worker
    thread is covered: a fetch from a thread that is not the one that
    entered the block aborts there."""
    t = torch.arange(4.0)
    caught = []

    def dispatcher_thread():
        try:
            t.cpu()
        except RuntimeError as e:
            caught.append(str(e))

    with zoolint_sanitize(max_compiles=0):
        th = threading.Thread(target=dispatcher_thread)
        th.start()
        th.join(WAIT)
    assert not th.is_alive()
    assert caught and SYNC_ERROR in caught[0], caught


# -------------------------------------- test_serving_decode.py's cases
def test_torch_one_build_per_plan_at_every_occupancy(lm, zoolint_sanitize,
                                                     sync_guard):
    """A warmed engine serves a staggered schedule that holds occupancy
    at every level 1..capacity (ramping up, then draining) with zero
    further builds, and its loop makes no implicit fetch."""
    capacity = 3
    eng = DecodeEngine(lm, capacity=capacity, max_len=SEQ,
                       prompt_buckets=(BUCKET,))
    rng = np.random.default_rng(0)
    try:
        eng.warmup()
        with zoolint_sanitize(max_compiles=0) as rep:
            for k in range(1, capacity + 1):
                streams = [eng.submit(rng.integers(0, VOCAB, 4 + i), 6)
                           for i in range(k)]
                for s in streams:
                    assert s.result(timeout=WAIT).shape == (6,)
            streams = [eng.submit(rng.integers(0, VOCAB, 5), 4 * (i + 1))
                       for i in range(capacity)]
            for i, s in enumerate(streams):
                assert s.result(timeout=WAIT).shape == (4 * (i + 1),)
        assert rep.compiles == 0
        assert eng.stats()["slots_active"] == 0
    finally:
        eng.close()


def test_torch_prefix_pool_zero_further_builds(lm, zoolint_sanitize,
                                               sync_guard):
    """A warmed pooled engine serves eligible (split) and ineligible
    (short, monolithic) prompts — hits, misses, evictions — with zero
    further builds and no implicit fetch."""
    eng = DecodeEngine(lm, capacity=2, max_len=SEQ,
                       prompt_buckets=(8, 16), prefix_pool=1)
    rng = np.random.default_rng(59)
    head = rng.integers(0, VOCAB, 8)
    prompts = [np.concatenate([head, rng.integers(0, VOCAB, n)])
               for n in (1, 3, 5)]
    try:
        eng.warmup()
        with zoolint_sanitize(max_compiles=0) as rep:
            eng.generate(prompts, [4] * len(prompts), timeout=WAIT)
            eng.generate([rng.integers(0, VOCAB, 3)], [4],
                         timeout=WAIT)  # < smallest bucket: monolithic
            eng.generate([rng.integers(0, VOCAB, 16)], [4],
                         timeout=WAIT)  # exact-bucket prefix, no tail
        assert rep.compiles == 0
        st = eng.stats()
        assert st["prefix_hits"] >= 2 and st["prefix_misses"] >= 1
    finally:
        eng.close()


# ------------------------------------------- test_execstore.py's cases
class _FakeProc:
    """A finished ``nvcc`` that wrote ``lib:<source>`` bytes."""

    def __init__(self, name, out):
        out.write_bytes(b"lib:" + name.encode())
        self.returncode = 0

    def communicate(self):
        return "", None


class _FakeLib:
    def __init__(self, path):
        self.payload = path.read_bytes()

    def __getattr__(self, symbol):
        def fn(*args):
            return 0
        return fn


def test_torch_kernel_lib_store_hit_builds_nothing_and_is_bitexact(
        tmp_path, monkeypatch, zoolint_sanitize):
    """The port's store holds kernel libraries: a second process (a
    fresh build directory) with a warm store loads the first one's bytes
    and builds nothing — zero ``kernel_build`` events under the
    sanitizer — where the cold build counted one."""
    from analytics_zoo_tpu_torch.common import execstore
    from analytics_zoo_tpu_torch.ops import _kernels
    execstore.configure(str(tmp_path / "store"))
    loads = []
    monkeypatch.setattr(_kernels, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_compile",
                        lambda name, out: _FakeProc(name, out))
    monkeypatch.setattr(_kernels, "_load",
                        lambda path: loads.append(path.read_bytes())
                        or _FakeLib(path))
    try:
        with zoolint_sanitize(max_compiles=1, transfer_guard=None) as cold:
            _kernels.KernelLibrary().build()
        assert cold.by_kind["kernel_build"] == 1
        first = sorted(loads)
        del loads[:]
        import shutil
        shutil.rmtree(tmp_path / "build")  # a new checkout's directory
        with zoolint_sanitize(max_compiles=0, transfer_guard=None) as warm:
            _kernels.KernelLibrary().build()
        assert warm.compiles == 0
        assert sorted(loads) == first
        s = execstore.current().stats()
        assert s["hit"] == len(_kernels._SIGNATURES) and s["invalid"] == 0
    finally:
        execstore.disable()


def test_torch_no_store_io_on_warmed_dispatch_path_sanitized(
        tmp_path, monkeypatch, zoolint_sanitize, sync_guard):
    """With the store enabled, a warmed replica loop performs no store
    I/O (lookup and put booby-trapped after warm-up) and runs
    sanitize-clean: zero builds, no implicit fetch."""
    from analytics_zoo_tpu_torch.common import execstore
    from analytics_zoo_tpu_torch.common.execstore import ExecStore
    execstore.configure(str(tmp_path / "store"))
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(8, 8)).astype(np.float32) * 0.3,
              "b": np.zeros((8,), np.float32)}
    im = _handle(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), params,
                 replicas=2, coalescing=True)
    try:
        im.warmup((8,))
        x = np.ones((4, 8), np.float32)
        ref = im.predict(x)  # warm the exact live placement combination

        def _boom(self, *a, **k):
            raise AssertionError("store I/O on the per-dispatch path")

        monkeypatch.setattr(ExecStore, "lookup", _boom)
        monkeypatch.setattr(ExecStore, "put", _boom)
        with zoolint_sanitize(max_compiles=0) as rep:
            for _ in range(8):
                np.testing.assert_array_equal(im.predict(x), ref)
        assert rep.compiles == 0
    finally:
        im.close()
        execstore.disable()


# ------------------------------------------- the explicit fetch's bits
def test_host_fetch_gives_the_bits_and_no_alias():
    """The serving path's fetch (``serving._host``, a pinned
    non-blocking copy and an event on a card) returns the results' exact
    bits as numpy, for every leaf of a nested result, and copies: a
    later write to a reused buffer does not reach the fetched arrays."""
    from analytics_zoo_tpu_torch.pipeline.inference.serving import (
        _host, fetch_rows, to_device)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    b = torch.from_numpy(rng.integers(0, 9, (4,)).astype(np.int64))
    tree = {"y": a, "aux": (b, a.double())}
    want = {"y": a.numpy().copy(),
            "aux": (b.numpy().copy(), a.double().numpy().copy())}
    got = _host(tree)
    a.add_(1.0)  # the staging buffer is reused
    b.zero_()
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_array_equal(got["aux"][0], want["aux"][0])
    np.testing.assert_array_equal(got["aux"][1], want["aux"][1])
    assert got["y"].dtype == np.float32 and got["aux"][0].dtype == np.int64
    rows = fetch_rows(torch.arange(12.0).reshape(6, 2), 4)
    np.testing.assert_array_equal(rows, np.arange(8.0).reshape(4, 2))
    up = to_device((np.arange(6, dtype=np.int32).reshape(3, 2),), "cpu")
    assert up[0].dtype == torch.int32 and up[0].tolist() == [[0, 1], [2, 3],
                                                            [4, 5]]


def test_hostcopy_round_trip_owns_its_memory():
    """``common.hostcopy``, the transfers the serving and decode paths
    share: ``fetch`` gives the bits as numpy arrays the caller owns (a
    later write to the source does not reach them), ``start_fetch``
    fills a caller's buffers when the sources are on a card and clones
    CPU sources, and ``upload`` moves a host tensor as ``Tensor.to``
    on the CPU."""
    from analytics_zoo_tpu_torch.common import hostcopy
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    b = torch.arange(4, dtype=torch.int32)
    got = hostcopy.fetch([a, b])
    want = [a.numpy().copy(), b.numpy().copy()]
    a.zero_()
    b.fill_(7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype and g.flags.writeable
    host, events = hostcopy.start_fetch([b], out=[torch.empty(4)])
    hostcopy.wait(events)
    assert events == [] and host[0].dtype == torch.int32
    assert host[0].tolist() == [7] * 4
    assert host[0].data_ptr() != b.data_ptr()
    up = hostcopy.upload(b, "cpu")
    assert up.device.type == "cpu" and up.tolist() == [7] * 4


def test_closed_loop_runs_every_item_once_from_its_clients():
    """``closed_loop`` (the serve window chip_smoke's sanitize phase and
    a benchmark's selfcheck drive): every item through ``call`` once,
    results in item order, a raising item reported and not fatal to the
    rest of its client's items."""
    from analytics_zoo_tpu_torch.tools.zoolint import closed_loop
    seen = []
    lock = threading.Lock()

    def call(i):
        with lock:
            seen.append((threading.get_ident(), i))
        if i == 5:
            raise ValueError("item 5")
        return i * i

    out, wall, errors = closed_loop(call, range(12), threads=3, timeout=WAIT)
    assert out == [i * i if i != 5 else None for i in range(12)]
    assert sorted(i for _, i in seen) == list(range(12))
    assert len({t for t, _ in seen}) == 3  # three clients served them
    assert errors == ["ValueError: item 5"] and wall >= 0
