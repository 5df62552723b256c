"""zoolint engine: walk files, parse once, run every rule.

Module rules see one :class:`ModuleContext`; project rules (the
call-graph hot-path pass) see all of them at once.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from .context import ModuleContext
from .findings import Finding
from .hotpath import (DEFAULT_HOT_ENTRIES, collect_hot_defs,
                      rule_hot_logging, rule_hot_path)
from .rules_concurrency import (rule_blocking_under_lock,
                                rule_check_then_deref,
                                rule_lock_discipline,
                                rule_lock_order,
                                rule_thread_lifecycle,
                                rule_unbounded_queue)
from .rules_contracts import rule_contracts
from .rules_resource import rule_resource_balance
from .rules_torch import (rule_capture_hazards,
                          rule_recapture)

MODULE_RULES: Tuple[Callable[[ModuleContext], List[Finding]], ...] = (
    rule_recapture,          # ZL101 ZL102
    rule_lock_discipline,    # ZL401
    rule_blocking_under_lock,  # ZL402
    rule_thread_lifecycle,   # ZL501
    rule_unbounded_queue,    # ZL502
    rule_resource_balance,   # ZL701 ZL702 (exception-path CFG)
)

#: every rule code the port's zoolint can emit (docs + fixture tests key
#: off this); the JAX package's ZL103 and ZL711 are retired
#: (``catalog.FATES``)
ALL_CODES = ("ZL101", "ZL102", "ZL201", "ZL202", "ZL203", "ZL204",
             "ZL205", "ZL301", "ZL302", "ZL401", "ZL402", "ZL501",
             "ZL502", "ZL601", "ZL701", "ZL702", "ZL721", "ZL731",
             "ZL801", "ZL802", "ZL811", "ZL812", "ZL821")


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths: Sequence[str], root: Optional[str] = None,
               hot_entries: Tuple[str, ...] = DEFAULT_HOT_ENTRIES
               ) -> List[Finding]:
    """Lint files/trees; paths in findings are relative to ``root``
    (default: cwd) with forward slashes, so baselines are portable."""
    root = os.path.abspath(root or os.getcwd())
    ctxs: List[ModuleContext] = []
    findings: List[Finding] = []
    for fp in _iter_py_files(paths):
        rel = os.path.relpath(os.path.abspath(fp), root).replace(
            os.sep, "/")
        try:
            with open(fp, "r", encoding="utf-8") as f:
                src = f.read()
            ctx = ModuleContext(rel, src)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                "ZL000", rel, getattr(e, "lineno", 1) or 1, 0, "<module>",
                f"file does not parse: {e}"))
            continue
        ctxs.append(ctx)
    for ctx in ctxs:
        for rule in MODULE_RULES:
            findings.extend(rule(ctx))
    # the project-wide call-graph pass is computed ONCE and shared, so
    # every hot-path rule sees the identical "hot" set for free
    hot_defs = collect_hot_defs(ctxs, hot_entries)
    findings.extend(rule_hot_path(ctxs, hot_entries, hot_defs=hot_defs))
    findings.extend(rule_hot_logging(ctxs, hot_entries,
                                     hot_defs=hot_defs))
    # the captured scopes are project-wide too: a graph body's callees
    # live in other modules (the decode step's math in generation.py)
    findings.extend(rule_capture_hazards(ctxs, defs=hot_defs[0]))
    # project-wide v2 passes: shared-attr check-then-deref and the
    # global lock-acquisition graph both need every module at once
    findings.extend(rule_check_then_deref(ctxs))
    findings.extend(rule_lock_order(ctxs))
    # v3 distributed-contract pass: one ContractIndex over every
    # module, five ZL8xx families off it (root locates the docs that
    # the drift checks audit against)
    findings.extend(rule_contracts(ctxs, root=root))
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings
