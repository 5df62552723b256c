"""Resource-balance rules over the exception-path CFG (ZL701/ZL702).

The dominant residual bug class of the serving stack is a *protocol* bug: a
resource taken on the way in — a semaphore slot, an in-flight counter,
a queue seat — that every exit path must give back, and the exception
exits don't.  The normal path gets reviewed; the unwind leaks.  Both
rules run a forward may-analysis ("which resources may still be held
here?") over :mod:`cfg` and flag anything still held when control
reaches the function's exceptional exit (``RAISE``).

ZL701 — acquire/release call pairing.  ``recv.acquire()`` as a bare
  statement marks ``recv`` held; ``recv.release()`` (same dotted
  receiver, or the same final attribute through a helper whose body
  releases it) frees it.  Held at an exceptional exit → finding.
  Deliberately NOT a gen event: conditional acquires (``blocking=False``
  / ``timeout=`` / the result assigned and branched on — the crash-net
  ``got = lock.acquire(timeout=1.0)`` idiom) and ``with lock:`` (balanced
  by construction).  Normal-path exits holding the resource are also
  deliberately allowed: returning while holding is how ownership
  transfer works (``_acquire_slot`` hands its slot to the dispatch),
  and the caller can see it; an exception unwinding through the caller
  cannot.

ZL702 — counter balance.  A *tracked counter* is an attribute the
  module both ``+=``s and ``-=``s somewhere (``_waiting``, ``_running``,
  ``slot_inflight[i]``, ...) — one-way stats counters never track.  An
  increment marks the counter held; a decrement of the same attribute,
  an outright re-assignment, or a call to a same-module function whose
  body decrements it (``self._grant_locked()`` hands the seat on)
  frees it.  Held at an exceptional exit → finding: the in-flight
  count stays up forever, shrinking effective capacity one exception
  at a time — exactly the admission ``_acquire`` KeyboardInterrupt seat
  leak, and the hedge-loser slot accounting before it.
"""

from __future__ import annotations

import ast
import collections
from typing import Dict, List, Optional, Set, Tuple

from .cfg import CFG, build_cfg
from .context import (ModuleContext, binding_targets, dotted_name,
                      header_parts, iter_function_defs, last_name,
                      walk_shallow)
from .dataflow import solve_forward
from .findings import Finding

_RES, _CNT = "res", "cnt"


def _counter_attr(target: ast.AST) -> Optional[str]:
    """The attribute name of an ``x.attr`` / ``x.attr[i]`` aug-assign
    target (the counter identity — receivers vary, the attr is the
    protocol)."""
    if isinstance(target, ast.Subscript):
        target = target.value
    if isinstance(target, ast.Attribute):
        return target.attr
    return None


def _tracked_counters(ctx: ModuleContext) -> Set[str]:
    """Attrs with BOTH an increment and a decrement in this module,
    where at least one increment is by literal ``1`` — the discrete-
    seat signature.  Fractional error accumulators (the canary
    router's ``_canary_acc += fraction`` / ``-= 1.0`` pair) share the
    +=/-= shape but deliberately KEEP their balance across error
    exits, so amount-shaped updates never track."""
    incs: Set[str] = set()
    unit_incs: Set[str] = set()
    decs: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.AugAssign):
            attr = _counter_attr(node.target)
            if attr is None:
                continue
            if isinstance(node.op, ast.Add):
                incs.add(attr)
                if (isinstance(node.value, ast.Constant)
                        and node.value.value == 1):
                    unit_incs.add(attr)
            elif isinstance(node.op, ast.Sub):
                decs.add(attr)
    return incs & unit_incs & decs


def _releasing_helpers(ctx: ModuleContext
                       ) -> Tuple[Dict[str, Set[str]],
                                  Dict[str, Set[str]]]:
    """Name-based one-hop call graph for kills: final function name ->
    {counter attrs it decrements} and -> {receiver tails it
    .release()s}.  A call to such a helper hands the resource on —
    ``self._grant_locked()`` decrements ``_waiting`` for the granted
    ticket, so the seat is no longer this function's to leak."""
    decrements: Dict[str, Set[str]] = collections.defaultdict(set)
    releases: Dict[str, Set[str]] = collections.defaultdict(set)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.AugAssign) \
                    and isinstance(sub.op, ast.Sub):
                attr = _counter_attr(sub.target)
                if attr is not None:
                    decrements[node.name].add(attr)
            elif (isinstance(sub, ast.Call)
                  and isinstance(sub.func, ast.Attribute)
                  and sub.func.attr == "release"):
                tail = last_name(sub.func.value)
                if tail is not None:
                    releases[node.name].add(tail)
    return decrements, releases


def _unconditional_acquire(st: ast.stmt) -> Optional[str]:
    """The dotted receiver of a bare ``recv.acquire()`` statement, None
    for conditional forms (module docstring)."""
    if not (isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)):
        return None
    call = st.value
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "acquire"):
        return None
    if call.args or any(kw.arg in ("blocking", "timeout")
                        for kw in call.keywords):
        return None
    return dotted_name(call.func.value)


def rule_resource_balance(ctx: ModuleContext) -> List[Finding]:
    tracked = _tracked_counters(ctx)
    decrements, releases = _releasing_helpers(ctx)
    findings: List[Finding] = []

    for qual, fd in iter_function_defs(ctx):
        cfg = build_cfg(fd)
        if not cfg.preds.get(CFG.RAISE):
            continue  # no exceptional exit — nothing to leak through

        def transfer(node: int, state, _cfg=cfg):
            st = _cfg.stmts.get(node)
            if st is None:
                return state
            gens: Set[Tuple] = set()
            kill_cnt: Set[str] = set()
            kill_res: Set[str] = set()
            recv = _unconditional_acquire(st)
            if recv is not None:
                gens.add((_RES, recv, st.lineno))
            for part in header_parts(st):
                for n in walk_shallow([part]):
                    if isinstance(n, ast.AugAssign):
                        attr = _counter_attr(n.target)
                        if attr is None or attr not in tracked:
                            continue
                        if isinstance(n.op, ast.Add):
                            gens.add((_CNT, attr, n.lineno))
                        elif isinstance(n.op, ast.Sub):
                            kill_cnt.add(attr)
                    elif isinstance(n, ast.Call):
                        name = last_name(n.func)
                        if (isinstance(n.func, ast.Attribute)
                                and n.func.attr == "release"):
                            d = dotted_name(n.func.value)
                            if d is not None:
                                kill_res.add(d)
                                kill_res.add(d.rsplit(".", 1)[-1])
                        if name in decrements:
                            kill_cnt |= decrements[name]
                        if name in releases:
                            kill_res |= releases[name]
            for t in binding_targets(st):
                attr = _counter_attr(t)
                if attr is not None:
                    kill_cnt.add(attr)
            out = set()
            for el in state:
                kind, key, _line = el
                if kind == _CNT and key in kill_cnt:
                    continue
                if kind == _RES and (
                        key in kill_res
                        or key.rsplit(".", 1)[-1] in kill_res):
                    continue
                out.add(el)
            return frozenset(out | gens)

        sol = solve_forward(cfg, transfer)
        for kind, key, line in sorted(sol.in_state(CFG.RAISE),
                                      key=lambda e: (e[2], e[1])):
            if kind == _RES:
                findings.append(Finding(
                    "ZL701", ctx.path, line, 0, qual,
                    f"{key}.acquire() here is not released on an "
                    "exception path out of this function: the caller "
                    "unwinds still owning the slot and nothing ever "
                    "returns it — release in a finally/except-"
                    "BaseException unwind before re-raising"))
            else:
                findings.append(Finding(
                    "ZL702", ctx.path, line, 0, qual,
                    f"counter .{key} incremented here is not "
                    "decremented on an exception path out of this "
                    "function: the in-flight count leaks on unwind "
                    "and capacity shrinks one exception at a time — "
                    "balance it in the except-BaseException unwind "
                    "(the admission _acquire seat-leak pattern)"))
    return findings
