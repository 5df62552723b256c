"""Port counterpart of ``tests/test_zoolint_contracts.py``: the port's
distributed-contract layer (ZL8xx) and its committed contract snapshot
(``contracts_snapshot_torch.json``).

Pinned contracts:
* the ContractIndex extracts the right surfaces (wire ops from send
  literals / dispatch tables / envelope-gated compares, metric family
  merge across modules, fingerprint-extras reachability with the
  fold-the-digest exemption, and the module form over a keying
  function such as the kernel-library key);
* ``zoolint contracts`` round-trips deterministically, ``--check``
  exits 0 on match / 3 on drift / 2 with no snapshot, and the
  committed snapshot matches the live port;
* ``--changed-only`` scopes the verdict (not the analysis) to files
  git considers touched;
* the port keeps the protocol fixes this layer pins in the JAX package:
  WorkerUnavailable round-trips the wire error envelope, and the
  router's scale-down sends the ``shutdown`` op the worker handles.
"""

import json
import os
import subprocess
import textwrap

import pytest

from analytics_zoo_tpu_torch.tools.zoolint import (ContractIndex,
                                                   rule_contracts)
from analytics_zoo_tpu_torch.tools.zoolint.cli import main as zoolint_main
from analytics_zoo_tpu_torch.tools.zoolint.context import ModuleContext
from analytics_zoo_tpu_torch.tools.zoolint.rules_contracts import (
    rule_fingerprint_drift, rule_metrics_schema, rule_wire_ops)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "analytics_zoo_tpu_torch")
SNAPSHOT = os.path.join(REPO, "contracts_snapshot_torch.json")


def _ctx(path, src):
    return ModuleContext(path, textwrap.dedent(src))


# ------------------------------------------------------- index units
def test_index_extracts_sent_and_handled_ops():
    router = _ctx("router.py", """\
        def call(conn):
            conn.send({"op": "predict", "id": 1})
            conn.send({"op": "flush", "id": 2})
        """)
    worker = _ctx("worker.py", """\
        class W:
            def __init__(self):
                self._control = {"predict": self._p}

            def _p(self, req):
                return req

            def serve(self, req):
                op = req.get("op")
                if op == "hello":
                    return None
        """)
    idx = ContractIndex([router, worker])
    assert set(idx.sent_ops) == {"predict", "flush"}
    assert set(idx.handled_ops) == {"predict", "hello"}
    codes = {(f.code, "flush" in f.message or "hello" in f.message)
             for f in rule_wire_ops(idx)}
    assert codes == {("ZL801", True)}


def test_op_compare_requires_envelope_binding():
    """`op == "X"` counts as a handler only where op came from an
    envelope lookup — a GraphDef converter comparing .op names is not a
    wire peer."""
    conv = _ctx("converter.py", """\
        def check(nodes):
            for n in nodes:
                op = n.op
                if op == "Placeholder":
                    continue
        """)
    idx = ContractIndex([conv])
    assert not idx.handled_ops


def test_index_merges_metric_families_across_modules():
    a = _ctx("a.py", """\
        def fams(n):
            return [Family("counter", "fx_hits_total", "h",
                           [(n, {"model": "m"})])]
        """)
    b = _ctx("b.py", """\
        def fams(n):
            return [Family("gauge", "fx_hits_total", "h",
                           [(n, {"model": "m"})])]
        """)
    idx = ContractIndex([a, b])
    assert len(idx.metric_decls["fx_hits_total"]) == 2
    findings = rule_metrics_schema(idx, root=None)
    assert {f.code for f in findings} == {"ZL811"}
    assert all("fx_hits_total" in f.message for f in findings)


def test_fingerprint_drift_reachability_and_fold():
    drifty = _ctx("eng.py", """\
        class E:
            def __init__(self, store, mult):
                self.store = store
                self._mult = mult

            def _shape(self, n):
                return n * self._mult

            def ensure(self, n):
                s = self._shape(n)
                return self.store.fingerprint("k"), s
        """)
    found = rule_fingerprint_drift([drifty])
    assert [f.code for f in found] == ["ZL821"]
    assert "_mult" in found[0].message

    folded = _ctx("eng.py", """\
        class E:
            def __init__(self, store, mult):
                self.store = store
                self._mult = mult

            def _shape(self, n):
                return n * self._mult

            def ensure(self, n):
                s = self._shape(n)
                return self.store.fingerprint("k", self._mult), s
        """)
    assert not rule_fingerprint_drift([folded])


def test_fingerprint_fold_by_canonical_digest_lineage():
    """The fold-the-digest idiom: folding a canonical form derived
    from the same constructor input covers the raw attribute."""
    src = _ctx("eng.py", """\
        class E:
            def __init__(self, store, spec):
                self.store = store
                canon = canonical(spec)
                self._spec = spec
                self._cfg = canon

            def ensure(self, n):
                meta = {"axes": self._spec}
                return self.store.fingerprint("k", self._cfg), meta
        """)
    assert not rule_fingerprint_drift([src])


def test_module_form_covers_the_kernel_library_key():
    """The kernel-library key's shape: a module function keys the store,
    and a build path reads flag constants.  A flag folded through the
    source hash is clean; an arch flag the compiler reads but the key
    never sees is the stale-build bug, ZL821.  Paths and ctypes tables
    are not configuration."""
    src = """\
        import ctypes

        FLAGS = ["-O3", "--use_fast_math"]
        ARCH = "sm_90a"
        _BUILD_ROOT = "build/kernels"
        _INT = ctypes.c_int
        _SIGNATURES = {"a.cu": [_INT]}


        def _source_hash():
            return hash(tuple(FLAGS))


        def _store_key(store, name):
            return store.fingerprint("kernel-lib", name, _source_hash())


        def _compile(name):
            return ["nvcc", *FLAGS, "-arch", ARCH, _BUILD_ROOT, name]


        class Library:
            def build(self, store):
                for name in _SIGNATURES:
                    fp = _store_key(store, name)
                    cmd = _compile(name)
                return fp, cmd, _INT
        """
    found = rule_fingerprint_drift([_ctx("kern.py", src)])
    assert [(f.code, f.symbol) for f in found] == [("ZL821", "_compile")]
    assert "ARCH" in found[0].message
    fixed = src.replace('"kernel-lib", name, _source_hash())',
                        '"kernel-lib", name, _source_hash(), ARCH)')
    assert not rule_fingerprint_drift([_ctx("kern.py", fixed)])


def test_port_kernel_library_key_folds_its_flags():
    """The port's own key (``ops/_kernels._store_key``) is in the module
    form's scope and folds every configuration constant its build path
    reads."""
    path = os.path.join(PKG, "ops", "_kernels.py")
    with open(path, encoding="utf-8") as f:
        ctx = ModuleContext("analytics_zoo_tpu_torch/ops/_kernels.py",
                            f.read())
    from analytics_zoo_tpu_torch.tools.zoolint.rules_contracts import (
        _module_consts)
    assert "NVCC_FLAGS" in _module_consts(ctx)
    assert not rule_fingerprint_drift([ctx])


def test_rule_contracts_entrypoint_combines_families():
    ctxs = [_ctx("m.py", """\
        import os

        def f():
            return os.environ.get("ZOO_FAKE_KNOB")
        """)]
    findings = rule_contracts(ctxs, root=None)
    assert {f.code for f in findings} == {"ZL812"}


# ------------------------------------------------ snapshot round-trip
def test_snapshot_is_deterministic_and_json_round_trips():
    ctxs = []
    for name in sorted(os.listdir(os.path.join(PKG, "serving",
                                               "fleet"))):
        if name.endswith(".py"):
            p = os.path.join(PKG, "serving", "fleet", name)
            with open(p, encoding="utf-8") as f:
                ctxs.append(ModuleContext("fleet/" + name, f.read()))
    snap1 = ContractIndex(ctxs).snapshot()
    snap2 = ContractIndex(list(ctxs)).snapshot()
    assert snap1 == snap2
    assert json.loads(json.dumps(snap1, sort_keys=True)) == snap1


def test_committed_snapshot_matches_live_package():
    rc = zoolint_main(["contracts", "--check", "--root", REPO])
    assert rc == 0, "contracts drift — run `zoolint contracts " \
                    "--update` and review the diff"


def test_contracts_check_detects_drift_and_missing(tmp_path):
    pkg = tmp_path / "analytics_zoo_tpu_torch"
    pkg.mkdir()
    (pkg / "mod.py").write_text(
        "def send(conn):\n    conn.send({'op': 'predict'})\n")
    root = str(tmp_path)
    # no snapshot yet: usage failure, loudly
    assert zoolint_main(["contracts", "--check", "--root", root]) == 2
    assert zoolint_main(["contracts", "--update", "--root", root]) == 0
    assert (tmp_path / "contracts_snapshot_torch.json").exists()
    assert zoolint_main(["contracts", "--check", "--root", root]) == 0
    # protocol change without a snapshot update = drift
    (pkg / "mod.py").write_text(
        "def send(conn):\n    conn.send({'op': 'generate'})\n")
    assert zoolint_main(["contracts", "--check", "--root", root]) == 3


def test_snapshot_ops_symmetric_in_package():
    """Every op the router sends has a worker handler and vice versa
    — the invariant ZL801 enforces, visible in the snapshot."""
    with open(SNAPSHOT, encoding="utf-8") as f:
        snap = json.load(f)
    assert snap["ops"]["sent"] == snap["ops"]["handled"]
    assert "shutdown" in snap["ops"]["sent"]
    assert snap["errors"]["WorkerUnavailable"] == 503
    assert "ZOO_FLEET_WIRE" in snap["env"]


# ------------------------------------------------------ changed-only
def test_changed_only_scopes_the_verdict(tmp_path):
    repo = tmp_path / "r"
    repo.mkdir()
    env = {**os.environ, "GIT_AUTHOR_NAME": "t",
           "GIT_AUTHOR_EMAIL": "t@t", "GIT_COMMITTER_NAME": "t",
           "GIT_COMMITTER_EMAIL": "t@t"}

    def git(*args):
        subprocess.run(["git", *args], cwd=repo, check=True, env=env,
                       capture_output=True)

    git("init", "-q")
    bad = "import torch\n\ndef f(xs, keep):\n    for x in xs:\n" \
          "        g = torch.cuda.CUDAGraph()\n        keep(g, x)\n"
    (repo / "old.py").write_text(bad)
    git("add", "-A")
    git("commit", "-qm", "seed")
    # the committed finding is out of scope: verdict is clean
    rc = zoolint_main([str(repo), "--root", str(repo),
                       "--changed-only"])
    assert rc == 0
    # the same finding in a NEW (untracked) file is in scope
    (repo / "new.py").write_text(bad)
    rc = zoolint_main([str(repo), "--root", str(repo),
                       "--changed-only"])
    assert rc == 3


# ------------------------------------------------------- env contract
def test_envcontract_accessors_enforce_declaration(monkeypatch):
    from analytics_zoo_tpu_torch import envcontract

    with pytest.raises(KeyError):
        envcontract.env_str("ZOO_NEVER_DECLARED")
    monkeypatch.setenv("ZOO_FLEET_MAX_FRAME", "123")
    assert envcontract.env_int("ZOO_FLEET_MAX_FRAME") == 123
    monkeypatch.setenv("ZOO_FLEET_MAX_FRAME", "garbage")
    assert envcontract.env_int("ZOO_FLEET_MAX_FRAME", 7) == 7
    monkeypatch.delenv("ZOO_RESUME", raising=False)
    assert not envcontract.env_flag("ZOO_RESUME")
    monkeypatch.setenv("ZOO_RESUME", "1")
    assert envcontract.env_flag("ZOO_RESUME")


# --------------------------------------------- regression pins (fixes)
def test_worker_unavailable_round_trips_the_wire():
    from analytics_zoo_tpu_torch.serving.errors import WorkerUnavailable
    from analytics_zoo_tpu_torch.serving.fleet import protocol

    assert "WorkerUnavailable" in protocol._ERROR_CLASSES
    err = WorkerUnavailable("no routable worker", model="m", rank=2)
    back = protocol.decode_error(protocol.encode_error(err))
    assert isinstance(back, WorkerUnavailable)
    assert back.http_status == 503
    assert back.details == {"model": "m", "rank": 2}


def test_router_reexports_worker_unavailable():
    from analytics_zoo_tpu_torch.serving import errors
    from analytics_zoo_tpu_torch.serving.fleet import (WorkerUnavailable,
                                                       router)

    assert router.WorkerUnavailable is errors.WorkerUnavailable
    assert WorkerUnavailable is errors.WorkerUnavailable


def test_router_sends_shutdown_on_scale_down():
    """The worker's serve loop handles a "shutdown" op and the router's
    scale-down sends it — pinned via the extraction ZL801 runs on."""
    ctxs = []
    for name in ("router.py", "worker.py"):
        p = os.path.join(PKG, "serving", "fleet", name)
        with open(p, encoding="utf-8") as f:
            ctxs.append(ModuleContext("fleet/" + name, f.read()))
    idx = ContractIndex(ctxs)
    assert "shutdown" in idx.sent_ops
    assert "shutdown" in idx.handled_ops
