"""A small forward dataflow framework over :mod:`cfg` graphs.

The v2 rules are all forward MAY-analyses over small finite domains
(held resources, poisoned names): union at joins, a per-statement
transfer function, iterate to fixpoint.  The one non-textbook detail is
exception edges: an ``exc`` edge contributes the source node's
**pre**-state, not its post-state — the exception may fire before the
statement's effect lands (``self._sem.acquire()`` that raises never
acquired; a release that raises mid-call may not have released).
Explicit ``raise``/``return``/``break`` edges contribute the
post-state as usual: by the time control transfers, the statement ran.

Usage::

    sol = solve_forward(cfg, transfer)       # transfer(node, in) -> out
    held_at_raise = sol.in_state(cfg.RAISE)

Transfer functions must be monotone over frozensets (only ever derive
``out`` from ``in`` by adding/removing elements based on the statement
alone) — every rule here is gen/kill shaped, so termination is the
standard argument.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Tuple

from .cfg import CFG, EXC_KINDS

State = FrozenSet[Tuple]
Transfer = Callable[[int, State], State]

EMPTY: State = frozenset()


class Solution:
    def __init__(self, cfg: CFG, ins: Dict[int, State],
                 outs: Dict[int, State]):
        self.cfg = cfg
        self._ins = ins
        self._outs = outs

    def in_state(self, node: int) -> State:
        return self._ins.get(node, EMPTY)

    def out_state(self, node: int) -> State:
        return self._outs.get(node, EMPTY)


def solve_forward(cfg: CFG, transfer: Transfer,
                  entry_state: State = EMPTY,
                  max_iters: int = 10000) -> Solution:
    """Worklist fixpoint of a forward may-analysis (module doc)."""
    ins: Dict[int, State] = {CFG.ENTRY: entry_state}
    outs: Dict[int, State] = {CFG.ENTRY: entry_state}
    work = [CFG.ENTRY]
    iters = 0
    while work:
        iters += 1
        if iters > max_iters:  # malformed graph guard — never expected
            break
        node = work.pop()
        state = outs.get(node, EMPTY)
        pre = ins.get(node, EMPTY)
        for succ, kind in cfg.succs.get(node, ()):  # propagate
            contrib = pre if kind in EXC_KINDS else state
            old = ins.get(succ)
            new = contrib if old is None else (old | contrib)
            if old is not None and new == old:
                continue
            ins[succ] = new
            outs[succ] = (new if succ in (CFG.EXIT, CFG.RAISE)
                          else transfer(succ, new))
            # re-queue even when the out-state is unchanged: exc edges
            # out of ``succ`` propagate its (just-grown) PRE-state
            work.append(succ)
    return Solution(cfg, ins, outs)
