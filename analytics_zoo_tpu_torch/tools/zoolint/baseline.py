"""Baseline: accepted findings, each with a mandatory justification.

The contract (scripts/lint.sh + tests/test_zoolint.py):

* a finding matching a baseline entry on ``(code, path, symbol)`` is
  suppressed — line numbers are deliberately not part of the key, so
  unrelated edits don't invalidate the baseline;
* a NEW finding (no matching entry) fails the run;
* an entry with an empty justification fails the run — the whole point
  is that every accepted violation carries its WHY in review;
* stale entries (matching nothing) are reported so they get pruned, but
  don't fail the run — deleting dead code must not break lint.

Format (JSON, diff-reviewable)::

    {"suppressions": [
        {"code": "ZL301",
         "path": "analytics_zoo_tpu/pipeline/inference/serving.py",
         "symbol": "BucketedExecutableCache._dispatch",
         "justification": "compile-time measurement on the miss path"}
    ]}
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

from .findings import Finding


class BaselineError(ValueError):
    """The baseline file itself is malformed (bad JSON, missing keys,
    empty justification)."""


def load_baseline(path: str) -> List[Dict[str, str]]:
    with open(path, "r", encoding="utf-8") as f:
        try:
            data = json.load(f)
        except json.JSONDecodeError as e:
            raise BaselineError(f"{path}: not valid JSON: {e}") from e
    entries = data.get("suppressions")
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: expected a 'suppressions' list")
    for i, e in enumerate(entries):
        for k in ("code", "path", "symbol", "justification"):
            if not isinstance(e.get(k), str):
                raise BaselineError(
                    f"{path}: suppression #{i} missing string {k!r}")
        if not e["justification"].strip():
            raise BaselineError(
                f"{path}: suppression #{i} ({e['code']} {e['path']} "
                f"{e['symbol']}) has an empty justification — accepted "
                "violations must say why")
    return entries


def apply_baseline(findings: Sequence[Finding],
                   entries: Sequence[Dict[str, str]]
                   ) -> Tuple[List[Finding], List[Finding],
                              List[Dict[str, str]]]:
    """Returns (new, suppressed, stale_entries).  An entry suppresses
    every finding with its key — one justified entry covers multiple
    sites in the same symbol (e.g. both branches of a retry)."""
    keys = {(e["code"], e["path"], e["symbol"]) for e in entries}
    new = [f for f in findings if f.key not in keys]
    suppressed = [f for f in findings if f.key in keys]
    hit = {f.key for f in suppressed}
    stale = [e for e in entries
             if (e["code"], e["path"], e["symbol"]) not in hit]
    return new, suppressed, stale


def render_baseline(findings: Sequence[Finding]) -> str:
    """A baseline skeleton for --update-baseline: justifications start
    empty ON PURPOSE — lint fails until a human fills each one in."""
    seen = set()
    entries = []
    for f in findings:
        if f.key in seen:
            continue
        seen.add(f.key)
        entries.append({"code": f.code, "path": f.path,
                        "symbol": f.symbol, "justification": ""})
    return json.dumps({"suppressions": entries}, indent=2) + "\n"
