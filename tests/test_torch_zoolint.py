"""Port counterpart of ``tests/test_zoolint.py``: the port's static
analyzer and runtime sanitizer harness
(``analytics_zoo_tpu_torch.tools.zoolint``).

Pinned contracts:
* every live rule code has a positive fixture (fires, and ONLY it fires)
  and a negative fixture (nothing fires) in
  ``tests/torch_zoolint_fixtures/`` — the rules stay precise both ways;
* the port is clean modulo ``zoolint_baseline_torch.json``, the baseline
  stays within its budget (<= 20) and every entry carries a
  justification;
* introducing any positive fixture into a linted tree fails the CLI
  with exit 3 — the ``scripts/lint_torch.sh`` gate actually gates;
* ``zoolint.sanitize()`` passes a warmed serving hot loop, catches an
  injected recompile, and restores the sync mode and unhooks its
  listener (the injected implicit transfer needs a card:
  ``tests/test_torch_cuda.py``).

The whole-port lint runs once for this file (module-scoped fixtures).
"""

import glob
import json
import os
import shutil
import subprocess

import numpy as np
import pytest

from analytics_zoo_tpu_torch.tools.zoolint import (ALL_CODES, BaselineError,
                                                   apply_baseline,
                                                   lint_paths,
                                                   load_baseline)
from analytics_zoo_tpu_torch.tools.zoolint.cli import main as zoolint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_zoolint_fixtures")
BASELINE = os.path.join(REPO, "zoolint_baseline_torch.json")
BUDGET = 20


def _fixture(code: str, kind: str) -> str:
    return os.path.join(FIXTURES, f"{code.lower()}_{kind}.py")


@pytest.fixture
def zoolint_sanitize():
    """The port's runtime sanitizer: wrap a pinned hot loop and assert
    zero unexpected compile-like events (kernel builds, signature
    builds, CUDA-graph captures) and, on a card, no implicit host<->
    device syncs (docs/dev/zoolint_torch.md §Runtime sanitizer).  Pass
    ``invariants=`` for the invariant-snapshot mode."""
    from analytics_zoo_tpu_torch.tools.zoolint import sanitize
    return sanitize


@pytest.fixture(scope="module")
def port_findings():
    """One lint of the whole port for every test of this file."""
    return lint_paths([os.path.join(REPO, "analytics_zoo_tpu_torch")],
                      root=REPO)


@pytest.fixture(scope="module")
def lint_sh():
    """One run of the port's gate script for every test of this file."""
    return subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "lint_torch.sh")],
        cwd=REPO, timeout=300, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


# ------------------------------------------------------------ per-rule
@pytest.mark.parametrize("code", ALL_CODES)
def test_rule_positive_fixture_fires(code):
    path = _fixture(code, "pos")
    assert os.path.exists(path), f"missing positive fixture for {code}"
    codes = [f.code for f in lint_paths([path], root=REPO)]
    assert code in codes, f"{code} positive fixture produced {codes}"
    # precision: the minimal positive snippet trips nothing else
    assert set(codes) == {code}, \
        f"{code} positive fixture also tripped {set(codes) - {code}}"


@pytest.mark.parametrize("code", ALL_CODES)
def test_rule_negative_fixture_is_clean(code):
    path = _fixture(code, "neg")
    assert os.path.exists(path), f"missing negative fixture for {code}"
    findings = lint_paths([path], root=REPO)
    assert not findings, \
        f"{code} negative fixture flagged: " \
        f"{[f.render() for f in findings]}"


# ------------------------------------------------------- package gate
def test_package_clean_modulo_baseline(port_findings):
    entries = load_baseline(BASELINE)  # validates justifications
    new, suppressed, stale = apply_baseline(port_findings, entries)
    assert not new, "NEW zoolint findings (fix or justify+baseline):\n" \
        + "\n".join(f.render() for f in new)
    assert not stale, f"stale baseline entries — prune them: {stale}"
    assert len(entries) <= BUDGET, \
        f"baseline grew to {len(entries)} — the budget is {BUDGET} " \
        "justified suppressions; fix findings instead of accreting them"


def test_positive_fixture_in_package_fails_cli(tmp_path):
    """The acceptance gate: drop any rule's positive snippet into a
    linted tree and the CLI (the thing lint_torch.sh runs) exits
    non-zero."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    for pos in sorted(glob.glob(os.path.join(FIXTURES, "zl*_pos.py"))):
        shutil.copy(pos, pkg / os.path.basename(pos))
    rc = zoolint_main([str(pkg), "--baseline", BASELINE,
                       "--root", str(tmp_path)])
    assert rc == 3  # findings exit (0 clean / 2 usage / 3 findings)
    # and the findings cover EVERY rule code — no rule is gate-dead
    found = {f.code for f in lint_paths([str(pkg)], root=str(tmp_path))}
    assert found == set(ALL_CODES), \
        f"gate misses rules: {set(ALL_CODES) - found}"


def test_lint_sh_gate_passes(lint_sh):
    assert lint_sh.returncode == 0, lint_sh.stdout[-3000:]
    assert "zoolint OK" in lint_sh.stdout


# ------------------------------------------------------------ baseline
def test_baseline_rejects_empty_justification(tmp_path):
    bad = tmp_path / "b.json"
    bad.write_text(json.dumps({"suppressions": [
        {"code": "ZL101", "path": "x.py", "symbol": "f",
         "justification": "   "}]}))
    with pytest.raises(BaselineError, match="justification"):
        load_baseline(str(bad))
    rc = zoolint_main([_fixture("ZL101", "pos"),
                       "--baseline", str(bad)])
    assert rc == 2  # a broken baseline is a usage failure, loudly


def test_baseline_suppresses_on_symbol_not_line(tmp_path):
    """Suppressions key on (code, path, symbol): edits that shift line
    numbers must not invalidate the baseline."""
    src = tmp_path / "mod.py"
    src.write_text(
        "import torch\n\n\ndef serve(xs, keep):\n    for x in xs:\n"
        "        g = torch.cuda.CUDAGraph()\n        keep(g, x)\n")
    findings = lint_paths([str(src)], root=str(tmp_path))
    assert [f.code for f in findings] == ["ZL101"]
    entries = [{"code": "ZL101", "path": "mod.py", "symbol": "serve",
                "justification": "test"}]
    new, suppressed, stale = apply_baseline(findings, entries)
    assert not new and len(suppressed) == 1 and not stale
    # same finding, shifted 5 lines down: still suppressed
    src.write_text("\n\n\n\n\n" + src.read_text())
    new2, _, stale2 = apply_baseline(
        lint_paths([str(src)], root=str(tmp_path)), entries)
    assert not new2 and not stale2


def test_update_baseline_writes_unjustified_skeleton(tmp_path):
    out = tmp_path / "skel.json"
    rc = zoolint_main([_fixture("ZL401", "pos"),
                       "--baseline", str(out), "--update-baseline",
                       "--root", REPO])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["suppressions"] and all(
        e["justification"] == "" for e in data["suppressions"])
    # the skeleton is NOT usable as-is: lint fails until a human fills
    # in every justification
    with pytest.raises(BaselineError):
        load_baseline(str(out))


# ----------------------------------------------------------- sanitizer
def _handle(fn, params, **kw):
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    im = InferenceModel(max_batch_size=8, device="cpu", **kw)
    im.load_fn(fn, params)
    return im


def test_sanitize_clean_warmed_loop_passes(zoolint_sanitize):
    im = _handle(lambda p, x: x @ p["w"], {"w": np.eye(4, dtype=np.float32)})
    try:
        im.warmup((4,))
        with zoolint_sanitize(max_compiles=0) as rep:
            for n in (1, 2, 3, 5, 8, 1, 4):
                im.predict(np.ones((n, 4), np.float32))
        assert rep.compiles == 0
        assert rep.by_kind == {"kernel_build": 0, "signature_build": 0,
                               "graph_capture": 0}
    finally:
        im.close()


def test_sanitize_catches_injected_recompile(zoolint_sanitize):
    from analytics_zoo_tpu_torch.tools.zoolint import RecompileDetected
    im = _handle(lambda p, x: x * p["s"], {"s": np.float32(2.0)})
    try:
        im.warmup((4,))
        with pytest.raises(RecompileDetected,
                           match="signature_build bucket-forward"):
            with zoolint_sanitize(max_compiles=0, transfer_guard=None):
                # an unwarmed dtype signature escapes the bucket ladder
                im.predict(np.ones((2, 4), np.float16))
    finally:
        im.close()


def test_sanitize_restores_mode_and_unhooks(zoolint_sanitize):
    """The listener sees compiles inside the block only, and leaves the
    process as it found it: on the CPU there is no sync mode to set
    (nothing to guard), and the listener is gone after the block."""
    from analytics_zoo_tpu_torch.observability import profile
    before = profile.compile_listeners()
    with zoolint_sanitize(max_compiles=10) as rep:
        profile.note_compile(0.01, "nvcc:flash_fwd.cu", kind="kernel_build")
        profile.note_compile(0.02, "cuda_graph_capture",
                             kind="graph_capture")
    assert rep.compiles == 2  # the events inside WERE observed
    assert [k for k, _, _ in rep.events] == ["kernel_build",
                                             "graph_capture"]
    assert rep.sync_mode_before is None  # no card: nothing was guarded
    assert profile.compile_listeners() == before
    # the listener is unhooked: compiles outside the block don't count
    profile.note_compile(0.01, "bucket-forward")
    assert rep.compiles == 2


# ------------------------------------------------------------- context
@pytest.mark.parametrize("src,want", [
    ("import torch as t\nt.cuda.synchronize()\n",
     "torch.cuda.synchronize"),
    ("from torch import cuda\ncuda.synchronize()\n",
     "torch.cuda.synchronize"),
    ("from torch.cuda import synchronize as sync\nsync()\n",
     "torch.cuda.synchronize"),
    ("import torch.nn.functional as F\nF.relu(x)\n",
     "torch.nn.functional.relu"),
    ("import numpy as xp\nxp.asarray(y)\n", "numpy.asarray"),
])
def test_context_resolves_torch_aliases(src, want):
    """The import-alias table knows torch, torch.cuda,
    torch.nn.functional and numpy under whatever names a module binds."""
    import ast
    from analytics_zoo_tpu_torch.tools.zoolint.context import ModuleContext
    ctx = ModuleContext("m.py", src)
    call = next(n for n in ast.walk(ctx.tree) if isinstance(n, ast.Call))
    assert ctx.resolve(call.func) == want
