"""Port counterpart of ``tests/test_zoolint_v2.py``: the exception-path
dataflow rules, the capture-scope rules that take the retired ZL711's
place, the --explain/--format CLI surface, the invariant-snapshot
sanitizer, and the pinned fixes in the port's serving/.

The seeded-mutation tests are the acceptance bar made executable:
deleting the release on an exception path of the good fixture MUST
light ZL701; reverting the admission ``_acquire`` unwind fix (on a
faithful copy of its shape) MUST light ZL702; re-reading
``entry.active`` after a None check MUST light ZL721.
"""

import json
import os
import subprocess
import textwrap
import threading

import numpy as np
import pytest

from analytics_zoo_tpu_torch.tools.zoolint import (ALL_CODES, CATALOG,
                                                   FATES, explain,
                                                   lint_paths)
from analytics_zoo_tpu_torch.tools.zoolint.cli import main as zoolint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_zoolint_fixtures")
PKG = os.path.join(REPO, "analytics_zoo_tpu_torch")


@pytest.fixture
def zoolint_sanitize():
    """The port's runtime sanitizer (see ``tests/test_torch_zoolint.py``)."""
    from analytics_zoo_tpu_torch.tools.zoolint import sanitize
    return sanitize


def _lint_src(tmp_path, src: str, name: str = "mod.py", **kw):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return lint_paths([str(p)], root=str(tmp_path), **kw)


# ------------------------------------------------- seeded mutations
def test_deleting_release_on_exception_path_is_caught(tmp_path):
    """The ZL701 acceptance gate: take the GOOD fixture, delete its
    release, and the exception path must light up."""
    good = open(os.path.join(FIXTURES, "zl701_neg.py")).read()
    assert not lint_paths([os.path.join(FIXTURES, "zl701_neg.py")],
                          root=REPO)
    broken = good.replace(
        "self._sem.release()  # every exit path, unwind included",
        "pass")
    assert broken != good
    codes = [f.code for f in _lint_src(tmp_path, broken)]
    assert "ZL701" in codes


def test_reverting_acquire_unwind_fix_is_caught(tmp_path):
    """The ZL702 acceptance gate on a faithful copy of ``_acquire``'s
    shape: with the except-BaseException unwind clean, reverted
    ZL702."""
    fixed = open(os.path.join(FIXTURES, "zl702_neg.py")).read()
    reverted = open(os.path.join(FIXTURES, "zl702_pos.py")).read()
    assert "except BaseException" in fixed
    assert "except BaseException" not in reverted
    assert not _lint_src(tmp_path, fixed)
    findings = _lint_src(tmp_path, reverted)
    assert [f.code for f in findings] == ["ZL702"]
    assert "_waiting" in findings[0].message


def test_entry_active_reread_after_none_check_is_caught(tmp_path):
    """The ZL721 acceptance gate, in the ``autoscaler_for`` get_signals
    shape."""
    src = textwrap.dedent("""\
        import threading


        class Entry:
            def __init__(self):
                self.lock = threading.Lock()
                self.active = None

            def swap(self, dep):
                with self.lock:
                    self.active = dep


        def get_signals(entry):
            if entry.active is not None:
                return {"active": entry.active.model.active_replicas}
            return {"active": None}
        """)
    findings = _lint_src(tmp_path, src)
    assert [f.code for f in findings] == ["ZL721"]
    fixed = src.replace(
        "    if entry.active is not None:\n"
        "        return {\"active\": entry.active.model"
        ".active_replicas}\n"
        "    return {\"active\": None}",
        "    dep = entry.active\n"
        "    if dep is not None:\n"
        "        return {\"active\": dep.model.active_replicas}\n"
        "    return {\"active\": None}")
    assert fixed != src
    assert not _lint_src(tmp_path, fixed)


# ------------------------------------- capture scopes (ZL711's place)
def test_decode_engine_capture_bodies_pin_clean():
    """The decode engine's captured bodies (the step, fused and
    speculative plans) and the math they reach hold no capture hazard —
    the package gate keeps it that way — and the scope really covers
    them (the port donates nothing, so this takes ZL711's pin)."""
    from analytics_zoo_tpu_torch.tools.zoolint.context import ModuleContext
    from analytics_zoo_tpu_torch.tools.zoolint.engine import _iter_py_files
    from analytics_zoo_tpu_torch.tools.zoolint.rules_torch import (
        collect_capture_scopes, rule_capture_hazards)
    ctxs = []
    for fp in _iter_py_files([PKG]):
        with open(fp, encoding="utf-8") as f:
            ctxs.append(ModuleContext(os.path.relpath(fp, REPO), f.read()))
    _, captured, bodies, _ = collect_capture_scopes(ctxs)
    names = {q for _, q in captured}
    assert {"DecodeEngine._step_body", "DecodeEngine._stepk_body",
            "DecodeEngine._spec_body", "DecodeEngine._step_core",
            "_decode_step", "select_tokens", "switch_moe"} <= names
    assert [q for _, q, _ in bodies] == ["_Plan.build"]
    assert not rule_capture_hazards(ctxs)


def test_capture_scope_follows_imported_math_not_builtins(tmp_path):
    """A body's plain call reaches the function of that name in its own
    module or the module it imported it from — a shadowed builtin name
    elsewhere in the project does not drag that module in."""
    (tmp_path / "mathlib.py").write_text(textwrap.dedent("""\
        def head(x):
            return x.tolist()


        def max(x):
            return x.item()
        """))
    (tmp_path / "engine.py").write_text(textwrap.dedent("""\
        import torch

        from mathlib import head


        def capture(g, x):
            with torch.cuda.graph(g):
                head(x)
                max(1, 2)
        """))
    findings = lint_paths([str(tmp_path)], root=str(tmp_path))
    assert [(f.code, f.path, f.symbol) for f in findings] == \
        [("ZL203", "mathlib.py", "head")]


def test_capture_entries_reach_plan_bodies(tmp_path, monkeypatch):
    """A body handed over as a callable (the decode engine's ``_Plan``
    shape) is captured through the entry list; without it the lexical
    search cannot see it."""
    from analytics_zoo_tpu_torch.tools.zoolint import rules_torch
    src = """\
        import torch


        class Plan:
            def __init__(self, body):
                self.body = body

            def build(self, g):
                with torch.cuda.graph(g):
                    self.body()


        class Engine:
            def __init__(self):
                self._tok = torch.zeros(4)

            def _step_body(self):
                if self._tok.sum() > 0:
                    self._tok.add_(1)
        """
    monkeypatch.setattr(rules_torch, "DEFAULT_CAPTURE_ENTRIES",
                        ("Engine._step_body",))
    found = _lint_src(tmp_path, src)
    assert [(f.code, f.symbol) for f in found] == \
        [("ZL202", "Engine._step_body")]
    monkeypatch.setattr(rules_torch, "DEFAULT_CAPTURE_ENTRIES", ())
    assert not _lint_src(tmp_path, src)


def test_admission_acquire_pins_clean_for_resource_rules():
    """The port's admission ``_acquire`` (with the ``_grant_locked``
    seat handoff) stays balanced on every exception path."""
    path = os.path.join(PKG, "serving", "admission.py")
    findings = [f for f in lint_paths([path], root=REPO)
                if f.code in ("ZL701", "ZL702")]
    assert not findings, [f.render() for f in findings]


def test_guard_idiom_in_and_chain_is_not_a_reread(tmp_path):
    """`if flag and x.attr is not None: ...` (no re-read anywhere) is
    the SAFE idiom — the candidate must not match its own check."""
    src = """\
        import threading


        class Entry:
            def __init__(self):
                self.lock = threading.Lock()
                self.active = None

            def swap(self, dep):
                with self.lock:
                    self.active = dep


        def ready(entry, flag):
            if flag and entry.active is not None:
                return True
            return False
        """
    assert not _lint_src(tmp_path, src)
    bad = src.replace(
        "if flag and entry.active is not None:",
        "if entry.active is not None and entry.active.version > 1:")
    findings = _lint_src(tmp_path, bad)
    assert [f.code for f in findings] == ["ZL721"]


def test_lock_order_cycle_between_same_named_locks(tmp_path):
    """Two classes both naming their lock `_lock` must not alias into
    one graph node — the cross-class cycle is what ZL731 catches."""
    src = """\
        import threading


        class A:
            def __init__(self):
                self._lock = threading.Lock()


        class B:
            def __init__(self):
                self._lock = threading.Lock()


        def ab(a, b):
            with a._lock:
                with b._lock:
                    pass


        def ba(a, b):
            with b._lock:
                with a._lock:
                    pass
        """
    findings = _lint_src(tmp_path, src)
    assert [f.code for f in findings] == ["ZL731"]


def test_lock_order_cycle_spanning_three_locks(tmp_path):
    src = """\
        import threading


        class M:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()
                self._c_lock = threading.Lock()

            def one(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def two(self):
                with self._b_lock:
                    with self._c_lock:
                        pass

            def three(self):
                with self._c_lock:
                    with self._a_lock:
                        pass
        """
    findings = _lint_src(tmp_path, src)
    assert [f.code for f in findings] == ["ZL731"]
    assert "_a_lock" in findings[0].message


def test_rlock_reentry_is_not_a_cycle(tmp_path):
    src = """\
        import threading


        class M:
            def __init__(self):
                self._cond = threading.Condition(threading.RLock())

            def outer(self):
                with self._cond:
                    self.inner()

            def inner(self):
                with self._cond:
                    pass
        """
    assert not _lint_src(tmp_path, src)


# ------------------------------------------------------ CLI surface
def test_explain_known_code_exits_zero(capsys):
    rc = zoolint_main(["--explain", "ZL702"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ZL702" in out
    assert "bad:" in out and "good:" in out
    assert "docs/dev/zoolint_torch.md" in out


def test_explain_unknown_code_exits_two(capsys):
    rc = zoolint_main(["--explain", "ZL999"])
    assert rc == 2
    assert "unknown rule code" in capsys.readouterr().err


def test_catalog_covers_every_rule_code():
    for code in ALL_CODES:
        assert code in CATALOG, f"--explain missing for {code}"
        text = explain(code)
        assert text and "bad:" in text and "good:" in text
    # every code the JAX package's zoolint has, and the port's own,
    # has a fate; the retired ones explain it instead of a bad/good pair
    from analytics_zoo_tpu.tools.zoolint import ALL_CODES as JAX_CODES
    assert set(JAX_CODES) | set(ALL_CODES) == set(FATES)
    for code, (fate, why) in FATES.items():
        assert fate in ("kept", "re-aimed", "retired", "new") and why
        assert (fate == "retired") == (code not in ALL_CODES)
    assert "retired" in explain("ZL711") and "retired" in explain("ZL103")


def test_exit_code_contract(tmp_path, capsys):
    """0 clean / 2 usage / 3 findings — pinned for lint_torch.sh."""
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert zoolint_main([str(clean)]) == 0
    dirty = tmp_path / "dirty.py"
    dirty.write_text(open(os.path.join(FIXTURES,
                                       "zl701_pos.py")).read())
    assert zoolint_main([str(dirty), "--root", str(tmp_path)]) == 3
    assert zoolint_main([]) == 2  # no paths, no --explain: usage
    capsys.readouterr()


def test_format_json_payload_and_summary(tmp_path, capsys):
    dirty = tmp_path / "dirty.py"
    dirty.write_text(open(os.path.join(FIXTURES,
                                       "zl701_pos.py")).read())
    rc = zoolint_main([str(dirty), "--root", str(tmp_path),
                       "--format", "json"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 3 and data["exit"] == 3
    assert data["summary"]["total"] == 1
    assert data["summary"]["by_code"] == {"ZL701": 1}
    f = data["findings"][0]
    assert f["code"] == "ZL701" and f["path"] == "dirty.py"
    assert f["docs"].startswith("docs/dev/zoolint_torch.md#")


def test_lint_sh_emits_per_code_summary_line():
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "lint_torch.sh")],
        cwd=REPO, timeout=300, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert "zoolint summary: total=0" in proc.stdout
    assert "zoolint summary: contracts=ok" in proc.stdout
    assert "zoolint OK" in proc.stdout


# --------------------------------------- invariant-snapshot sanitizer
def test_invariant_snapshot_passes_on_warmed_serve_loop(zoolint_sanitize):
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    im = InferenceModel(max_batch_size=8, coalescing=True, device="cpu")
    try:
        im.load_fn(lambda p, x: x @ p["w"],
                   {"w": np.eye(4, dtype=np.float32)})
        im.warmup((4,))
        im.predict(np.ones((2, 4), np.float32))  # warmed + quiesced

        def invariants():
            return {"pending": im.serving_stats().get(
                "coalescer_pending", 0)}

        with zoolint_sanitize(max_compiles=0,
                              invariants=invariants) as rep:
            for n in (1, 2, 3, 5, 8, 1, 4):
                im.predict(np.ones((n, 4), np.float32))
        assert rep.compiles == 0
    finally:
        im.close()


def test_invariant_snapshot_catches_injected_counter_leak(
        zoolint_sanitize):
    from analytics_zoo_tpu_torch.tools.zoolint import InvariantLeakDetected
    gauges = {"slot_inflight": 0, "tickets": 3}
    with pytest.raises(InvariantLeakDetected, match="slot_inflight"):
        with zoolint_sanitize(max_compiles=0, transfer_guard=None,
                              invariants=lambda: dict(gauges)):
            gauges["slot_inflight"] += 1  # the seat nobody returns


def test_invariant_snapshot_catches_leaked_thread(zoolint_sanitize):
    from analytics_zoo_tpu_torch.tools.zoolint import InvariantLeakDetected
    release = threading.Event()
    try:
        with pytest.raises(InvariantLeakDetected, match="live_threads"):
            with zoolint_sanitize(max_compiles=0, transfer_guard=None,
                                  invariants=lambda: {}):
                t = threading.Thread(target=release.wait, daemon=True)
                t.start()  # still alive at block exit
    finally:
        release.set()


def test_invariant_threads_opt_out(zoolint_sanitize):
    release = threading.Event()
    try:
        with zoolint_sanitize(max_compiles=0, transfer_guard=None,
                              invariants=lambda: {},
                              invariant_threads=False):
            threading.Thread(target=release.wait, daemon=True).start()
    finally:
        release.set()


# ------------------------------------------ pinned fixes in serving/
def test_registry_models_survives_concurrent_undeploy_null():
    """``ModelRegistry.models()`` reads each entry's deployment exactly
    once (ZL721's fix shape) — pinned with an entry whose ``active``
    disappears after the first access."""
    from analytics_zoo_tpu_torch.serving.registry import ModelRegistry

    class _Dep:
        version = 7

    class _FlippingEntry:
        def __init__(self):
            self._reads = 0

        @property
        def active(self):
            self._reads += 1
            return _Dep() if self._reads == 1 else None

    reg = ModelRegistry(device="cpu")
    entry = _FlippingEntry()
    reg._entries["m"] = entry
    assert reg.models() == {"m": 7}  # a re-read would AttributeError
    assert entry._reads == 1


def test_scalar_item_store_into_a_tensor_is_a_hot_sync(tmp_path):
    """The sync the card's guard found in the decode engine's admission
    (``_slot_write``'s ``self._pos[slot] = req.length``: an item
    assignment of a Python number copies a host scalar up and waits)
    is ZL301 on the hot path; a device-to-device element copy and the
    ``fill_`` repair are not."""
    src = """\
        import torch


        class Engine:
            def __init__(self):
                self._pos = torch.zeros(4, dtype=torch.long)
                self._tok = torch.zeros(4, dtype=torch.long)

            def _admit_slot(self, req, slot, tok0):
                self._tok[slot] = tok0[0]
                self._pos[slot] = req.length
        """
    found = _lint_src(tmp_path, src)
    assert [(f.code, f.line, f.symbol) for f in found] == \
        [("ZL301", 11, "Engine._admit_slot")]
    assert "_pos" in found[0].message
    fixed = src.replace("self._pos[slot] = req.length",
                        "self._pos[slot].fill_(req.length)")
    assert not _lint_src(tmp_path, fixed)
