"""Port counterpart of ``tests/test_execstore.py``: the persistent store
(``analytics_zoo_tpu_torch.serving.execstore``) and the kernel-library
read-through of ``ops/_kernels.py``.

* Store level, as the JAX package's cases: round trip and counters,
  fingerprint order, a runtime change rotating the key, corrupt entries,
  the environment variables, LRU gc that spares this process's entries,
  the CLI, ``--by-model``.
* The kernel-library read-through, with a stubbed compiler and loader
  (no ``nvcc`` here): a miss builds and writes behind, a hit loads the
  stored bytes without a build, a corrupt or unloadable entry is counted
  invalid and rebuilt, and without a store the build touches no store
  file.  Entries carry the deploying model's tag.
* Where the JAX package pins per-signature entries (replica forwards,
  decode plans), the port writes none (module docstring of
  ``execstore.py``), and the counterparts pin that: with a store on, a
  second replica set or engine builds exactly as the first, the store
  sees no traffic, and a warmed dispatch touches no store file.
* Parity: a store written by either package is read by the other's
  ``stat``/``gc`` (one shimmed JAX subprocess for this file).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import execstore as store_core
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.serving import execstore
from analytics_zoo_tpu_torch.serving.execstore import ExecStore

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def store(tmp_path):
    st = execstore.configure(str(tmp_path / "store"))
    yield st
    execstore.disable()


def _entry_files(st: ExecStore):
    return sorted(p for p in os.listdir(st.root) if p.endswith(".zexe"))


def _damage(path, how):
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        if how == "bitflip":
            mid = len(raw) // 2
            f.write(raw[:mid] + bytes([raw[mid] ^ 0xFF]) + raw[mid + 1:])
        else:
            f.write(raw[: len(raw) // 3])


# ------------------------------------------------------------ raw store
def test_put_lookup_roundtrip_and_counters(store):
    fp = store.fingerprint("kind", "a", 1)
    assert store.lookup(fp) is None
    assert store.put(fp, b"payload-bytes", meta={"kind": "t", "k": 1})
    ent = store.lookup(fp)
    assert ent is not None
    assert ent.payload == b"payload-bytes"
    assert ent.meta["kind"] == "t" and ent.meta["k"] == 1
    s = store.stats()
    assert (s["miss"], s["hit"], s["write"], s["invalid"]) == (1, 1, 1, 0)
    assert s["entries"] == 1 and s["bytes"] > 0
    # no temp files left behind by the atomic publish
    assert _entry_files(store) == [fp + ".zexe"]
    assert sorted(os.listdir(store.root)) == [fp + ".zexe"]


def test_fingerprint_is_order_and_content_sensitive(store):
    assert store.fingerprint("a", "b") != store.fingerprint("b", "a")
    assert store.fingerprint("a") != store.fingerprint("a", None)
    assert store.fingerprint(("x", 1)) == store.fingerprint(("x", 1))


def test_runtime_version_change_rotates_fingerprint(store, monkeypatch):
    """A torch, CUDA, nvcc or flags change lands on a different key: a
    library built by another toolchain is never even consulted.  The
    store's runtime parts are torch, CUDA and the device; the kernel
    build adds the compiler's version and the sources' and flags'
    hash."""
    fp_now = store.fingerprint("same-parts")
    parts = store_core._runtime_parts()
    assert parts[0::2] == ("torch", "cuda", "device", "capability")
    key_now = _kernels._store_key(store, "flash_fwd.cu")
    monkeypatch.setattr(
        store_core, "_runtime_parts",
        lambda device=None: ("torch", "99.0.0", "cuda", "99.9",
                             "device", "NVIDIA H100 80GB HBM3",
                             "capability", (9, 0)))
    assert store.fingerprint("same-parts") != fp_now
    assert _kernels._store_key(store, "flash_fwd.cu") != key_now
    monkeypatch.undo()
    monkeypatch.setattr(_kernels, "_nvcc_version", lambda: "nvcc 99.9")
    assert _kernels._store_key(store, "flash_fwd.cu") != key_now
    monkeypatch.undo()
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", ["-O0"])
    assert _kernels._store_key(store, "flash_fwd.cu") != key_now


@pytest.mark.parametrize("damage", ["bitflip", "truncate"])
def test_corrupt_entry_is_invalid_then_gone(store, damage):
    fp = store.fingerprint("corruptme")
    store.put(fp, b"x" * 256, meta={"kind": "t"})
    path = os.path.join(store.root, fp + ".zexe")
    _damage(path, damage)
    assert store.lookup(fp) is None
    s = store.stats()
    assert s["invalid"] == 1
    # the corrupt file was removed so a rebuild's write replaces it
    assert not os.path.exists(path)
    assert store.put(fp, b"fresh", meta={"kind": "t"})
    assert store.lookup(fp).payload == b"fresh"


def test_env_var_enables_store(tmp_path, monkeypatch):
    monkeypatch.setenv(execstore.ENV_DIR, str(tmp_path / "envstore"))
    monkeypatch.setenv(execstore.ENV_BUDGET, "12345")
    monkeypatch.setattr(store_core, "_current", None)
    monkeypatch.setattr(store_core, "_env_checked", False)
    st = execstore.current()
    try:
        assert st is not None
        assert st.root == str(tmp_path / "envstore")
        assert st.byte_budget == 12345
    finally:
        execstore.disable()


def test_families_and_span_event(store):
    from analytics_zoo_tpu_torch.observability import Tracer
    fp = store.fingerprint("fam")
    store.put(fp, b"abc", meta={"kind": "t"})
    tracer = Tracer()
    with tracer.request("r"):
        assert store.lookup(fp) is not None
    events = [e["name"] for e in tracer.recent()[-1]["events"]]
    assert "execstore_load" in events
    fams = {f.name: f for f in store.families()}
    assert {f"zoo_execstore_{k}_total" for k in
            ("hit", "miss", "write", "invalid", "evicted")} <= set(fams)
    assert fams["zoo_execstore_hit_total"].samples[0][1] == 1
    assert fams["zoo_execstore_entries"].samples[0][1] == 1
    assert fams["zoo_execstore_bytes"].samples[0][1] > 3


# ------------------------------------------------------------------- gc
def test_gc_evicts_lru_but_never_this_process_entries(store):
    """Eviction is oldest-mtime first and never removes an entry this
    process wrote."""
    foreign = ExecStore(store.root)
    fps = []
    for i in range(4):
        fp = foreign.fingerprint("foreign", i)
        foreign.put(fp, bytes(200), meta={"kind": "f"})
        fps.append(fp)
        os.utime(os.path.join(store.root, fp + ".zexe"),
                 (1000 + i, 1000 + i))
    mine = store.fingerprint("mine")
    store.put(mine, bytes(200), meta={"kind": "m"})
    os.utime(os.path.join(store.root, mine + ".zexe"), (10, 10))
    size_of = {fp: os.path.getsize(os.path.join(store.root,
                                                fp + ".zexe"))
               for fp in fps + [mine]}
    res = store.gc(byte_budget=size_of[mine] + size_of[fps[2]]
                   + size_of[fps[3]])
    assert res["evicted"] == 2
    left = _entry_files(store)
    assert mine + ".zexe" in left
    assert fps[0] + ".zexe" not in left and fps[1] + ".zexe" not in left
    assert fps[3] + ".zexe" in left
    assert store.stats()["evicted"] == 2


def test_cli_stat_and_gc(store, capsys):
    fp = store.fingerprint("cli")
    store.put(fp, bytes(512), meta={"kind": "demo"})
    assert execstore.main(["--root", store.root, "stat"]) == 0
    out = capsys.readouterr().out
    assert "1 entries" in out and fp[:16] in out and "demo" in out
    # a fresh CLI process protects nothing: budget 0 clears the store
    assert execstore.main(["gc", "--root", store.root,
                           "--budget", "0"]) == 0
    out = capsys.readouterr().out
    assert "evicted 1" in out
    assert _entry_files(store) == []


def test_cli_runs_as_a_module(store):
    store.put(store.fingerprint("m"), bytes(64),
              meta={"kind": "kernel-lib", "model": "lm"})
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.execstore",
         "--root", store.root, "stat", "--by-model"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "1 entries" in out.stdout and "lm" in out.stdout


def test_stat_by_model_breakdown(store, capsys):
    for i in range(2):
        store.put(store.fingerprint("ncf", i), bytes(256),
                  meta={"kind": "kernel-lib", "model": "ncf"})
    store.put(store.fingerprint("lm"), bytes(1024),
              meta={"kind": "kernel-lib", "model": "lm"})
    store.put(store.fingerprint("untagged"), bytes(64),
              meta={"kind": "demo"})
    agg = store.by_model()
    assert agg["ncf"]["entries"] == 2
    assert agg["lm"]["entries"] == 1 and agg["lm"]["bytes"] > 1024
    assert agg["-"]["entries"] == 1
    assert execstore.main(
        ["--root", store.root, "stat", "--by-model"]) == 0
    out = capsys.readouterr().out
    assert "ncf" in out and "lm" in out and "4 entries" in out
    # biggest consumer prints first
    assert out.index("lm") < out.index("ncf")
    assert store.by_mesh() == {"-": {"entries": 4,
                                     "bytes": store.stats()["bytes"]}}


# ------------------------------------------ the kernel-library read-through
class _FakeProc:
    """``nvcc`` standing in: writes a library whose bytes name the
    source."""

    def __init__(self, name, out, calls):
        calls.append(name)
        Path(out).write_bytes(b"lib:" + name.encode())
        self.returncode = 0

    def communicate(self):
        return "ptxas info : stub", None


class _FakeLib:
    """A loaded library: its bytes, and a stub per symbol.  Bytes
    starting ``bad`` refuse to load, as a foreign artifact would."""

    def __init__(self, path, loads):
        self.data = Path(path).read_bytes()
        if self.data.startswith(b"bad"):
            raise OSError(f"{path}: invalid ELF header")
        loads.append(self.data)

    def __getattr__(self, symbol):
        fn = type("Fn", (), {})()
        self.__dict__[symbol] = fn
        return fn


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """A fresh build directory, a counting stub compiler and loader; the
    returned ``build()`` runs a new ``KernelLibrary`` (a new process's)
    and reports (nvcc calls, loaded library bytes)."""
    monkeypatch.setattr(_kernels, "_BUILD_ROOT", tmp_path / "build")
    calls, loads = [], []
    monkeypatch.setattr(_kernels, "_compile",
                        lambda name, out: _FakeProc(name, out, calls))
    monkeypatch.setattr(_kernels, "_load",
                        lambda path: _FakeLib(path, loads))

    def build(fresh_dir=True):
        import shutil
        if fresh_dir:
            shutil.rmtree(tmp_path / "build", ignore_errors=True)
        del calls[:], loads[:]
        fns = _kernels.KernelLibrary().build()
        assert set(fns) == {"flash_fwd", "flash_fwd_sm90", "flash_bwd_dq",
                            "flash_bwd_dkv", "flash_bwd_dq_sm90",
                            "flash_bwd_dkv_sm90"}
        return list(calls), sorted(loads)

    return build


SOURCES = sorted(_kernels._SIGNATURES)
WANT = sorted(b"lib:" + n.encode() for n in SOURCES)


def test_kernel_lib_miss_builds_and_writes_behind(store, stub_build):
    calls, loads = stub_build()
    assert calls == SOURCES and loads == WANT
    s = store.stats()
    assert (s["miss"], s["write"], s["hit"]) == (len(SOURCES),) * 2 + (0,)
    kinds = {(e["kind"], e["model"]) for e in store.entries()}
    assert kinds == {("kernel-lib", "-")}
    # a library already in the build directory never asks the store
    calls, loads = stub_build(fresh_dir=False)
    assert calls == [] and loads == WANT
    assert store.stats()["miss"] == len(SOURCES)


def test_kernel_lib_hit_loads_without_nvcc(store, stub_build,
                                           monkeypatch):
    """A fresh build directory (a new checkout, a new process) and a warm
    store: no compiler runs, no compile is noted, the same bytes load."""
    from analytics_zoo_tpu_torch.observability import profile
    stub_build()
    noted = []
    monkeypatch.setattr(profile, "note_compile",
                        lambda s, key, **kw: noted.append(key))
    calls, loads = stub_build()
    assert calls == [] and loads == WANT and noted == []
    s = store.stats()
    assert s["hit"] == len(SOURCES) and s["write"] == len(SOURCES)


@pytest.mark.parametrize("damage", ["bitflip", "truncate", "unloadable"])
def test_kernel_lib_corrupt_entry_is_invalid_and_rebuilt(store, stub_build,
                                                         damage):
    """A damaged entry never loads: counted invalid, deleted, rebuilt by
    the compiler and written again; the other sources still hit."""
    stub_build()
    fp = _kernels._store_key(store, SOURCES[0])
    path = os.path.join(store.root, fp + ".zexe")
    if damage == "unloadable":
        # a whole, checksummed entry whose library will not load
        store.put(fp, b"bad library", meta={"kind": "kernel-lib"})
    else:
        _damage(path, damage)
    calls, loads = stub_build()
    assert calls == [SOURCES[0]] and loads == WANT
    s = store.stats()
    assert s["invalid"] == 1 and s["hit"] == len(SOURCES) - 1 + (
        damage == "unloadable")
    assert store.lookup(fp).payload == b"lib:" + SOURCES[0].encode()


def test_kernel_lib_without_store_touches_no_store_file(tmp_path,
                                                        stub_build,
                                                        monkeypatch):
    execstore.disable()

    def boom(*a, **k):
        raise AssertionError("store I/O without a store")

    monkeypatch.setattr(ExecStore, "lookup", boom)
    monkeypatch.setattr(ExecStore, "put", boom)
    calls, loads = stub_build()
    assert calls == SOURCES and loads == WANT
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        _kernels._build_dir().name]


def test_kernel_lib_entries_carry_the_build_tag(store, stub_build):
    with execstore.tag_builds("lm-small"):
        with execstore.tag_builds("inner"):
            assert execstore.build_tag() == "inner"
        stub_build()
    assert execstore.build_tag() is None
    assert store.by_model() == {"lm-small": {
        "entries": len(SOURCES), "bytes": store.stats()["bytes"]}}


def test_registry_deploy_tags_entries_with_model_name(store, stub_build,
                                                      monkeypatch):
    """The registry names its deploy in the store: a kernel build that
    happens while the deploy warms up writes entries tagged with the
    model name."""
    from analytics_zoo_tpu_torch.serving import ModelRegistry
    monkeypatch.setattr(_kernels, "LIBRARY", _kernels.KernelLibrary())

    def fwd(p, x):
        _kernels.LIBRARY.build()  # a forward's first kernel launch
        return torch.tanh(x @ p["w"])

    with ModelRegistry(max_batch_size=4, device="cpu") as reg:
        reg.deploy("tagged-mlp", fn=fwd, params=_mk_params(),
                   warmup_shapes=(8,))
    agg = store.by_model()
    assert agg.get("tagged-mlp", {}).get("entries", 0) == len(SOURCES)


# -------------------------- per-signature cases: the port writes none
def _fwd(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _mk_params(seed=0, d=8):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(d, d)).astype(np.float32) * 0.3,
            "b": np.zeros((d,), np.float32)}


@pytest.fixture
def compile_counter(monkeypatch):
    from analytics_zoo_tpu_torch.observability import profile

    events = []
    monkeypatch.setattr(profile, "note_compile",
                        lambda s, key, **kw: events.append(key))
    return events


@pytest.mark.parametrize("second", ["same", "weights", "bucket"])
def test_replica_builds_touch_no_store(store, compile_counter, second):
    """The JAX package's second set loads from the store (and a weights
    or bucket change misses it); the port's replica forward is a first
    run, so each set builds its signature once, the store sees no
    traffic, and equal weights give equal bits."""
    from analytics_zoo_tpu_torch.pipeline.inference.serving import (
        ReplicaSet, fetch_rows)
    x = np.ones((4, 8), np.float32)
    rs1 = ReplicaSet(_fwd, _mk_params(), devices=["cpu"] * 2)
    rs1.ensure_compiled(x)
    out1 = fetch_rows(rs1.dispatch(rs1.replicas[0], x), 4)
    rs2 = ReplicaSet(_fwd, _mk_params(seed=int(second == "weights")),
                     devices=["cpu"] * 2)
    x2 = np.ones((16 if second == "bucket" else 4, 8), np.float32)
    assert rs2.ensure_compiled(x2) > 0.0
    out2 = fetch_rows(rs2.dispatch(rs2.replicas[1], x2), len(x2))
    assert compile_counter == ["replica-forward"] * 2
    s = store.stats()
    assert (s["entries"], s["hit"], s["miss"], s["write"]) == (0,) * 4
    if second == "same":
        assert np.array_equal(out1, out2)


@pytest.mark.parametrize("capacity", [2, 3])
def test_decode_plans_never_touch_the_store(store, capacity):
    """The JAX package persists an engine's plans; the port's plans are
    CUDA graphs (eager bodies on the CPU), rebuilt by every engine: a
    second engine builds as many plans as the first, the store sees no
    traffic, and the streams are equal."""
    from analytics_zoo_tpu_torch.models import TransformerLM
    from analytics_zoo_tpu_torch.pipeline.inference import DecodeEngine
    lm = TransformerLM(vocab_size=48, seq_len=40, n_layers=2, d_model=32,
                       n_heads=4, device="cpu").eval()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 48, int(rng.integers(3, 8)))
               for _ in range(3)]
    outs, built = [], []
    for _ in range(2):
        eng = DecodeEngine(lm, capacity=capacity, max_len=40,
                           prompt_buckets=(8,), store_tag="lm")
        eng.warmup()
        outs.append(eng.generate(prompts, 5, timeout=120))
        built.append(eng.stats()["plans_built"])
        eng.close()
    assert built[0] == built[1] >= 3
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    s = store.stats()
    assert (s["entries"], s["hit"], s["miss"], s["write"]) == (0,) * 4


def test_store_keeps_single_device_closure_path(store):
    """The JAX package routes a 1-replica model through the replica path
    when a store is on (only it can run a stored executable); the port's
    store holds no forward, so the single-device path stays."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    im = InferenceModel(replicas=1, device="cpu", store_tag="m")
    im.load_fn(_fwd, _mk_params())
    try:
        assert im._cache is not None
        assert im._cache.replica_set is None
        assert im.n_replicas == 1
    finally:
        im.close()


def test_store_off_keeps_single_device_closure_path():
    assert execstore.current() is None
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    im = InferenceModel(replicas=1, device="cpu")
    im.load_fn(_fwd, _mk_params())
    try:
        assert im._cache is not None
        assert im._cache.replica_set is None
    finally:
        im.close()


def test_no_store_io_on_warmed_dispatch_path(store, monkeypatch,
                                             compile_counter):
    """With the store enabled, a warmed serving loop does no store I/O:
    lookup and put are booby-trapped after warm-up, and the loop builds
    nothing."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    im = InferenceModel(replicas=2, coalescing=True, device="cpu")
    im.load_fn(_fwd, _mk_params())
    im.warmup((8,))
    x = np.ones((4, 8), np.float32)
    im.predict(x)
    try:
        def _boom(self, *a, **k):
            raise AssertionError("store I/O on the per-dispatch path")

        monkeypatch.setattr(ExecStore, "lookup", _boom)
        monkeypatch.setattr(ExecStore, "put", _boom)
        n = len(compile_counter)
        for _ in range(8):
            im.predict(x)
        assert len(compile_counter) == n
    finally:
        im.close()


# ------------------------------------------------ parity with the JAX side
JAX_SIDE = textwrap.dedent('''
    import json, os, sys
    import jax, jax.lib
    from jaxlib import xla_client
    jax.lib.xla_client = xla_client  # the installed jax moved it
    from analytics_zoo_tpu.serving import execstore as E

    port_root, jax_root = sys.argv[1], sys.argv[2]
    out = {}
    st = E.ExecStore(port_root)
    out["port_entries"] = sorted(
        [e["fingerprint"], e["kind"], e["model"], e["mesh"], e["bytes"]]
        for e in st.entries())
    out["port_by_model"] = st.by_model()
    out["port_by_mesh"] = st.by_mesh()
    out["port_payloads"] = {e["fingerprint"]: st.lookup(
        e["fingerprint"]).payload.decode("latin-1") for e in st.entries()}
    mine = E.ExecStore(jax_root)
    for i, (kind, model, mesh) in enumerate([
            ("replica-forward", "ncf", None),
            ("shardgroup-forward", "lm",
             {"axes": {"tensor": 2}, "strategy": "tp", "group_size": 2}),
            ("decode-plan", None, None)]):
        meta = {"kind": kind}
        if model:
            meta["model"] = model
        if mesh:
            meta["mesh"] = mesh
        mine.put(mine.fingerprint("parity", i), bytes([i]) * (100 + i),
                 meta=meta)
    out["jax_fps"] = sorted(e["fingerprint"] for e in mine.entries())
    gc_root = sys.argv[3]
    out["gc"] = E.ExecStore(gc_root).gc(byte_budget=0)
    print("RESULT " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The port writes a store; one shimmed JAX subprocess reads it,
    gc's a copy of it and writes a store of its own."""
    import shutil
    d = tmp_path_factory.mktemp("execstore_parity")
    port = ExecStore(str(d / "port"))
    for i, (kind, model) in enumerate([("kernel-lib", "lm"),
                                       ("kernel-lib", None)]):
        meta = {"kind": kind, "source": f"s{i}.cu"}
        if model:
            meta["model"] = model
        port.put(port.fingerprint("parity", i), b"\x7fELF" + bytes(64 + i),
                 meta=meta)
    shutil.copytree(d / "port", d / "gc")
    (d / "jax_side.py").write_text(JAX_SIDE)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(d / "jax_side.py"), str(d / "port"),
         str(d / "jax"), str(d / "gc")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")]
    assert line, proc.stdout[-2000:] + proc.stderr[-4000:]
    out = json.loads(line[0][len("RESULT "):])
    out["dir"] = d
    out["port"] = port
    return out


def test_port_store_reads_in_jax(jax_side):
    port = jax_side["port"]
    want = sorted([e["fingerprint"], e["kind"], e["model"], e["mesh"],
                   e["bytes"]] for e in port.entries())
    assert jax_side["port_entries"] == want
    assert jax_side["port_by_model"] == port.by_model()
    assert jax_side["port_by_mesh"] == port.by_mesh() == {
        "-": {"entries": 2, "bytes": port.stats()["bytes"]}}
    for fp, payload in jax_side["port_payloads"].items():
        assert port.lookup(fp).payload == payload.encode("latin-1")
    assert jax_side["gc"]["evicted"] == 2
    assert not list((jax_side["dir"] / "gc").glob("*.zexe"))


def test_jax_store_reads_in_port(jax_side, capsys):
    st = ExecStore(str(jax_side["dir"] / "jax"))
    assert sorted(e["fingerprint"] for e in st.entries()) == \
        jax_side["jax_fps"]
    assert {e["kind"] for e in st.entries()} == {
        "replica-forward", "shardgroup-forward", "decode-plan"}
    assert st.by_mesh() == {
        "-": {"entries": 2, "bytes": st.by_mesh()["-"]["bytes"]},
        "tensor=2/tp": {"entries": 1,
                        "bytes": st.by_mesh()["tensor=2/tp"]["bytes"]}}
    assert set(st.by_model()) == {"ncf", "lm", "-"}
    for i, fp in enumerate(sorted(jax_side["jax_fps"])):
        ent = st.lookup(fp)
        assert ent is not None and len(set(ent.payload)) == 1
    assert st.stats()["invalid"] == 0
    assert execstore.main(["--root", st.root, "stat", "--by-mesh"]) == 0
    out = capsys.readouterr().out
    assert "3 entries" in out and "tensor=2/tp" in out
    assert execstore.main(["--root", st.root, "gc", "--budget", "0"]) == 0
    assert "evicted 3" in capsys.readouterr().out
