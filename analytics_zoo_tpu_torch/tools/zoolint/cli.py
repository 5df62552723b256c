"""zoolint command line.

    python -m analytics_zoo_tpu_torch.tools.zoolint PATH... [--baseline FILE]
    python -m analytics_zoo_tpu_torch.tools.zoolint --explain ZL701
    python -m analytics_zoo_tpu_torch.tools.zoolint contracts --check

Exit-code contract (test-pinned in tests/test_torch_zoolint.py):

    0  clean (modulo baseline), or --explain of a known code, or a
       contracts snapshot that matches the committed one
    2  usage — bad arguments, unknown --explain code, a broken
       baseline file (bad JSON / empty justification), a missing
       snapshot under ``contracts --check``
    3  findings — new findings not covered by the baseline, or
       contract drift against the committed snapshot

``--format json`` emits a machine-readable payload (findings,
suppressed, stale suppressions, a per-code summary) for CI —
``scripts/lint_torch.sh`` consumes it to print its per-code summary
line.

``--changed-only`` scopes the REPORTED findings to files touched per
git (``git diff --name-only HEAD`` + untracked): the lint still runs
over everything (cross-module rules need the whole package), only the
verdict is scoped — the pre-commit loop for a package whose full
baseline someone else owns.

``contracts`` is the committed-contract workflow: it renders the
ContractIndex (wire ops, error codes, env vars, metric families) as
deterministic JSON.  ``--update`` writes
``contracts_snapshot_torch.json``;
``--check`` diffs the live index against the committed file and exits
3 on drift, so a protocol change NOT reflected in the snapshot (and
therefore never seen in review) fails CI.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from typing import List, Optional, Set

from .baseline import (BaselineError, apply_baseline, load_baseline,
                       render_baseline)
from .catalog import explain
from .engine import lint_paths
from .hotpath import DEFAULT_HOT_ENTRIES

EXIT_CLEAN, EXIT_USAGE, EXIT_FINDINGS = 0, 2, 3
#: the package the defaults lint and index, and the port's committed files
PACKAGE = "analytics_zoo_tpu_torch"
SNAPSHOT = "contracts_snapshot_torch.json"
BASELINE = "zoolint_baseline_torch.json"


def _changed_files(root: str) -> Optional[Set[str]]:
    """Repo-relative paths touched per git (tracked diffs vs HEAD +
    untracked), None when git is unavailable (degrade to full scope —
    never silently report clean because git broke)."""
    out: Set[str] = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if res.returncode != 0:
            return None
        out.update(l.strip() for l in res.stdout.splitlines()
                   if l.strip())
    return out


def _contracts_main(argv: List[str]) -> int:
    import os

    from .engine import _iter_py_files
    from .context import ModuleContext
    from .rules_contracts import ContractIndex

    ap = argparse.ArgumentParser(
        prog="zoolint contracts",
        description="render / check the committed distributed-contract "
                    "snapshot (ops, errors, env vars, metric families)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or trees to index "
                         f"(default: {PACKAGE} under --root)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: cwd); locates the "
                         "default paths and the snapshot file")
    ap.add_argument("--snapshot", default=None,
                    help=f"snapshot path (default: {SNAPSHOT} under "
                         "--root)")
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--check", action="store_true",
                   help="diff the live index against the committed "
                        "snapshot: exit 0 match / 3 drift / 2 missing")
    g.add_argument("--update", action="store_true",
                   help="write the committed snapshot from the live "
                        "index")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root or os.getcwd())
    paths = args.paths or [os.path.join(root, PACKAGE)]
    snap_path = args.snapshot or os.path.join(root, SNAPSHOT)

    ctxs = []
    for fp in _iter_py_files(paths):
        rel = os.path.relpath(os.path.abspath(fp), root).replace(
            os.sep, "/")
        try:
            with open(fp, "r", encoding="utf-8") as f:
                ctxs.append(ModuleContext(rel, f.read()))
        except (SyntaxError, UnicodeDecodeError):
            continue  # the lint proper reports ZL000 for these
    live = ContractIndex(ctxs).snapshot()
    rendered = json.dumps(live, indent=2, sort_keys=True) + "\n"

    if args.update:
        with open(snap_path, "w", encoding="utf-8") as f:
            f.write(rendered)
        print(f"zoolint contracts: wrote {snap_path}")
        return EXIT_CLEAN
    if args.check:
        try:
            with open(snap_path, "r", encoding="utf-8") as f:
                committed = json.load(f)
        except OSError:
            print(f"zoolint contracts: no committed snapshot at "
                  f"{snap_path} — run `zoolint contracts --update` "
                  "and commit it", file=sys.stderr)
            return EXIT_USAGE
        except ValueError as e:
            print(f"zoolint contracts: {snap_path} is not valid "
                  f"JSON: {e}", file=sys.stderr)
            return EXIT_USAGE
        if committed == live:
            print("zoolint contracts: snapshot matches")
            return EXIT_CLEAN
        for section in sorted(set(live) | set(committed)):
            if live.get(section) != committed.get(section):
                print(f"zoolint contracts: drift in {section!r}:\n"
                      f"  committed: "
                      f"{json.dumps(committed.get(section), sort_keys=True)}\n"
                      f"  live:      "
                      f"{json.dumps(live.get(section), sort_keys=True)}",
                      file=sys.stderr)
        print("zoolint contracts: drift — review the change, then "
              "`zoolint contracts --update` and commit the snapshot",
              file=sys.stderr)
        return EXIT_FINDINGS
    print(rendered, end="")
    return EXIT_CLEAN


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "contracts":
        return _contracts_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="zoolint",
        description="torch-aware static analyzer for the port's "
                    "serving/training stack (rule catalog: "
                    "docs/dev/zoolint_torch.md)")
    ap.add_argument("paths", nargs="*", help="files or trees to lint")
    ap.add_argument("--explain", metavar="ZLxxx", default=None,
                    help="print one rule's rationale, a minimal "
                         "bad/good example, and its docs anchor, "
                         "then exit (0 known / 2 unknown)")
    ap.add_argument("--baseline", default=None,
                    help="JSON baseline of accepted findings")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write the current findings as a baseline "
                         "skeleton (empty justifications) and exit 0")
    ap.add_argument("--root", default=None,
                    help="root for relative finding paths (default: cwd)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--changed-only", action="store_true",
                    help="report only findings in files git considers "
                         "changed (diff vs HEAD + untracked); the "
                         "analysis itself still covers every path")
    ap.add_argument("--hot-entries", default=",".join(DEFAULT_HOT_ENTRIES),
                    help="comma-separated final names treated as serving "
                         "hot-path entry points (ZL301/ZL302)")
    args = ap.parse_args(argv)

    if args.explain is not None:
        text = explain(args.explain.upper())
        if text is None:
            print(f"zoolint: unknown rule code {args.explain!r} "
                  "(see docs/dev/zoolint_torch.md for the catalog)",
                  file=sys.stderr)
            return EXIT_USAGE
        print(text)
        return EXIT_CLEAN

    if not args.paths:
        ap.print_usage(sys.stderr)
        print("zoolint: error: paths required (or --explain ZLxxx)",
              file=sys.stderr)
        return EXIT_USAGE

    entries = tuple(e for e in args.hot_entries.split(",") if e)
    findings = lint_paths(args.paths, root=args.root, hot_entries=entries)

    if args.update_baseline:
        target = args.baseline or BASELINE
        with open(target, "w", encoding="utf-8") as f:
            f.write(render_baseline(findings))
        print(f"zoolint: wrote {len(findings)} finding(s) to {target} — "
              "fill in every justification before committing")
        return EXIT_CLEAN

    suppressed, stale = [], []
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except BaselineError as e:
            print(f"zoolint: {e}", file=sys.stderr)
            return EXIT_USAGE
        findings, suppressed, stale = apply_baseline(findings, baseline)

    if args.changed_only:
        import os
        changed = _changed_files(os.path.abspath(args.root
                                                 or os.getcwd()))
        if changed is not None:
            findings = [f for f in findings if f.path in changed]
        else:
            print("zoolint: --changed-only: git unavailable, "
                  "reporting full scope", file=sys.stderr)

    rc = EXIT_FINDINGS if findings else EXIT_CLEAN
    if args.format == "json":
        by_code = collections.Counter(f.code for f in findings)
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "suppressed": [vars(f) for f in suppressed],
            "stale_suppressions": stale,
            "summary": {"total": len(findings),
                        "by_code": dict(sorted(by_code.items())),
                        "suppressed": len(suppressed),
                        "stale": len(stale)},
            "exit": rc}, indent=2))
    else:
        for f in findings:
            print(f.render())
        for e in stale:
            print(f"zoolint: stale suppression (matches nothing): "
                  f"{e['code']} {e['path']} {e['symbol']}",
                  file=sys.stderr)
        summary = (f"zoolint: {len(findings)} new finding(s), "
                   f"{len(suppressed)} baselined, {len(stale)} stale")
        print(summary, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
