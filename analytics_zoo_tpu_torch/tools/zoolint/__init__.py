"""zoolint for the port: torch-aware static analyzer + runtime sanitizer.

Static half (stdlib-only, no torch import):

    from analytics_zoo_tpu_torch.tools.zoolint import lint_paths
    findings = lint_paths(["analytics_zoo_tpu_torch"])

Rule codes (catalog with rationale: docs/dev/zoolint_torch.md; every
code of the JAX package's zoolint is kept, re-aimed or retired there,
``catalog.FATES``):

    ZL101/ZL102        recapture hazards (CUDA graph built in a loop,
                       captured and replayed per call)
    ZL201..ZL205       capture hazards inside a CUDA-graph body (host
                       cast, Python branch, host materialization, a
                       fresh host tensor copied in, a rebound Python
                       value frozen at capture)
    ZL301/ZL302        host sync on the serving hot path
    ZL401/ZL402        lock discipline (mixed-lock writes, blocking
                       device work under a lock)
    ZL501/ZL502        thread lifecycle (unjoined non-daemon threads,
                       unbounded queues)
    ZL601              bare print/stdlib logging on the hot path (use
                       the structured logger with request-id fields)
    ZL701/ZL702        resource balance over the exception-path CFG
                       (acquire/release pairing, in-flight counter
                       increments leaked on unwind)
    ZL721              check-then-deref of a shared mutable attribute
                       (re-read instead of a local snapshot)
    ZL731              lock-order cycles in the global lexical
                       lock-acquisition graph
    ZL801              wire ops sent without a handler (or handled
                       without a sender); encode/decode key asymmetry
    ZL802              ServingError subclasses that cannot round-trip
                       the wire error envelope
    ZL811              metric family schema conflicts and docs drift
    ZL812              ZOO_* env reads outside the envcontract module
    ZL821              compile-path config reads missing from the
                       store fingerprint

The ZL8xx rules are cross-module: one :class:`ContractIndex` built
over every file at once checks the agreements BETWEEN modules (wire
ops, error envelopes, metric schemas, env knobs, fingerprint keys).
``zoolint contracts`` renders the same index as a committed snapshot
(``contracts_snapshot_torch.json``) that ``scripts/lint_torch.sh``
diffs on every run.

The v2 rules run real dataflow: :mod:`cfg` builds a per-function CFG
with explicit exception edges, :mod:`dataflow` iterates forward
may-analyses over it.  ``--explain ZLxxx`` prints any rule's
rationale + minimal bad/good pair (a retired code prints its fate).

Runtime half (imports torch lazily, on first use):

    with zoolint.sanitize(max_compiles=0):
        hot_loop()

    # invariant-snapshot mode: gauge counters + live thread count must
    # come back level across a quiesced serve window
    with zoolint.sanitize(max_compiles=0,
                          invariants=lambda: {"pending": ac.pending}):
        warmed_serve_window()
"""

from .baseline import (BaselineError, apply_baseline, load_baseline,
                       render_baseline)
from .catalog import CATALOG, FATES, explain
from .cfg import CFG, build_cfg
from .dataflow import solve_forward
from .engine import ALL_CODES, lint_paths
from .findings import Finding
from .hotpath import DEFAULT_HOT_ENTRIES
from .rules_contracts import ContractIndex, rule_contracts
from .rules_torch import DEFAULT_CAPTURE_ENTRIES

__all__ = ["ALL_CODES", "BaselineError", "CATALOG", "CFG",
           "ContractIndex", "DEFAULT_CAPTURE_ENTRIES",
           "DEFAULT_HOT_ENTRIES", "FATES", "Finding",
           "InvariantLeakDetected", "RecompileDetected",
           "SanitizeError", "SanitizeReport", "apply_baseline",
           "build_cfg", "closed_loop", "explain", "lint_paths",
           "load_baseline",
           "render_baseline", "rule_contracts", "sanitize",
           "solve_forward"]


def __getattr__(name):
    # sanitize + its error types live behind a lazy import so linting
    # never drags torch into the process
    if name in ("sanitize", "SanitizeError", "RecompileDetected",
                "InvariantLeakDetected", "SanitizeReport", "closed_loop"):
        import importlib
        mod = importlib.import_module(".sanitizer", __name__)
        return getattr(mod, name)
    raise AttributeError(name)
