"""Concurrency static rules.

Lock discipline
  ZL401  an attribute written both with and without its owning lock: the
         owning lock is the one held at the majority of write sites;
         sites missing it are flagged.  ``__init__`` writes (construction
         — no concurrent reader can exist yet) are exempt.
  ZL402  blocking device work (``torch.cuda.synchronize`` / a stream's
         or an event's ``synchronize`` / ``.item()`` / ``.tolist()`` /
         ``.cpu()`` / warmup / fetch_rows / dispatch_padded / predict)
         performed while holding a lock — every other thread contending
         that lock now waits on the device.

Thread lifecycle
  ZL501  non-daemon thread that is never joined in its module: leaks at
         interpreter exit and pins the process on crash.
  ZL502  unbounded queue.Queue: under overload it converts memory into
         latency instead of shedding (see serving.admission).

Shared-state races (project-wide, v2)
  ZL721  check-then-deref: a truthiness/None test on a SHARED mutable
         attribute (one written under a lock somewhere in the project)
         followed by a re-read of the same attribute in the guarded
         region, instead of a local snapshot — the attribute can be
         nulled between the check and the deref (``autoscaler_for``
         reading ``entry.active`` twice was exactly this).  Checks made
         while lexically holding a lock are exempt (the lock excludes
         the writer), as are re-reads taken back under a lock inside
         the guarded region.
  ZL731  lock-order: the project-wide lock-acquisition graph (an edge
         A -> B whenever B is acquired while A is lexically held, built
         from the same ``with recv.lock:`` sets ZL401 uses, lock
         identity resolved to its owning class via the lock-constructor
         assignments).  A cycle means two threads can block on each
         other's second lock — a deadlock waiting for load.  Self-loops
         are exempt: RLock re-entry (``_grant_locked`` under
         ``_cond``) is a sanctioned idiom.
"""

from __future__ import annotations

import ast
import collections
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .context import (ModuleContext, QualnameVisitor, binding_targets,
                      dotted_name, is_lock_ctor, last_name, lock_expr)
from .findings import Finding

# torch's blocking calls by final name (``torch.cuda.synchronize``,
# ``Stream.synchronize`` and ``Event.synchronize`` all end in
# ``synchronize``) and the port's own: its warmup, fetch and dispatch
_BLOCKING_DEVICE_CALLS = {"synchronize", "item", "tolist", "cpu",
                          "warmup", "fetch_rows", "dispatch_padded",
                          "predict", "predict_ex"}


# ----------------------------------------------------------------- ZL401
class _WriteSite:
    __slots__ = ("line", "col", "symbol", "locks", "in_init")

    def __init__(self, line, col, symbol, locks, in_init):
        self.line, self.col, self.symbol = line, col, symbol
        self.locks: Set[str] = locks
        self.in_init = in_init


class _LockDisciplineVisitor(QualnameVisitor):
    def __init__(self, ctx: ModuleContext):
        super().__init__(ctx)
        # (recv_kind, attr) -> [write sites]; recv_kind is the class
        # name for `self.x` writes and the bare variable name otherwise
        self.writes: Dict[Tuple[str, str], List[_WriteSite]] = \
            collections.defaultdict(list)
        self.lock_attrs: Set[str] = set()

    def _record(self, target: ast.AST):
        if not (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)):
            return
        recv, attr = target.value.id, target.attr
        if lock_expr(target) is not None:
            return  # assigning the lock itself
        if recv == "self":
            kind = self.class_stack[-1] if self.class_stack else "self"
        else:
            kind = recv
        in_init = bool(self.func_stack) and self.func_stack[0] == "__init__"
        self.writes[(kind, attr)].append(_WriteSite(
            target.lineno, target.col_offset, self.qualname,
            set(self.lock_stack), in_init))

    def visit_Assign(self, node: ast.Assign):
        if is_lock_ctor(self.ctx, node.value):
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    self.lock_attrs.add(t.attr)
        else:
            for t in node.targets:
                if isinstance(t, ast.Tuple):
                    for e in t.elts:
                        self._record(e)
                else:
                    self._record(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._record(node.target)
        self.generic_visit(node)


def rule_lock_discipline(ctx: ModuleContext) -> List[Finding]:
    v = _LockDisciplineVisitor(ctx)
    v.visit(ctx.tree)
    findings: List[Finding] = []
    for (kind, attr), sites in sorted(v.writes.items()):
        live = [s for s in sites if not s.in_init]
        locked = [s for s in live if s.locks]
        if not locked or len(live) < 2:
            continue  # never locked (single-writer style) or single site
        counts = collections.Counter(
            lock for s in locked for lock in s.locks)
        owner, _ = counts.most_common(1)[0]
        offenders = [s for s in live if owner not in s.locks]
        if not offenders:
            continue
        owned = sum(1 for s in live if owner in s.locks)
        for s in offenders:
            held = f"under {sorted(s.locks)}" if s.locks else "with no lock"
            findings.append(Finding(
                "ZL401", ctx.path, s.line, s.col, s.symbol,
                f"attribute {kind}.{attr} is written {held} here but "
                f"under {owner} at {owned} other site(s) — a "
                "torn/lost update is one unlucky preemption away"))
    return findings


# ----------------------------------------------------------------- ZL402
class _BlockingUnderLockVisitor(QualnameVisitor):
    def __init__(self, ctx: ModuleContext):
        super().__init__(ctx)
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call):
        name = last_name(node.func)
        if self.lock_stack and name in _BLOCKING_DEVICE_CALLS:
            self.findings.append(Finding(
                "ZL402", self.ctx.path, node.lineno, node.col_offset,
                self.qualname,
                f"blocking device call {name}() while holding "
                f"{sorted(set(self.lock_stack))}: every thread "
                "contending this lock now waits on device latency — "
                "move the dispatch outside the critical section"))
        self.generic_visit(node)


def rule_blocking_under_lock(ctx: ModuleContext) -> List[Finding]:
    v = _BlockingUnderLockVisitor(ctx)
    v.visit(ctx.tree)
    return v.findings


# ----------------------------------------------------------------- ZL501
def rule_thread_lifecycle(ctx: ModuleContext) -> List[Finding]:
    findings: List[Finding] = []
    # every `<something>.join(` receiver dotted path seen in the module
    joined: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"):
            recv = dotted_name(node.func.value)
            if recv:
                joined.add(recv)

    class V(QualnameVisitor):
        def visit_Call(self, node: ast.Call):
            if self.ctx.resolve(node.func) in ("threading.Thread",
                                               "Thread"):
                daemon = any(
                    kw.arg == "daemon"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in node.keywords)
                if not daemon and not self._target_joined(node):
                    findings.append(Finding(
                        "ZL501", self.ctx.path, node.lineno,
                        node.col_offset, self.qualname,
                        "non-daemon Thread that is never joined in this "
                        "module: it outlives its owner, pins interpreter "
                        "exit, and strands work on crash — pass "
                        "daemon=True or join it"))
            self.generic_visit(node)

        def _target_joined(self, call: ast.Call) -> bool:
            parent = self._assign_target_of(call)
            return parent is not None and parent in joined

        def _assign_target_of(self, call: ast.Call) -> Optional[str]:
            # the name/attr this Thread(...) was bound to, if any
            for node in ast.walk(self.ctx.tree):
                if isinstance(node, ast.Assign) and node.value is call:
                    for t in node.targets:
                        d = dotted_name(t)
                        if d:
                            return d
            return None

    V(ctx).visit(ctx.tree)
    return findings


# ----------------------------------------------------------------- ZL721
def collect_shared_attrs(ctxs: Sequence[ModuleContext]) -> Set[str]:
    """Attribute names written under a held lock anywhere in the
    project (``__init__`` construction writes excluded) — the
    population ZL721 treats as shared mutable state.  Attr-name keyed:
    the lock tells us SOMEONE considers this attribute contended, and
    the check-then-deref pattern is wrong wherever that attribute is
    then read unlocked."""
    shared: Set[str] = set()
    for ctx in ctxs:
        class V(QualnameVisitor):
            def _record(self, t):
                if (self.lock_stack
                        and isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and not (self.func_stack
                                 and self.func_stack[0] == "__init__")):
                    shared.add(t.attr)

            def visit_Assign(self, node):
                for t in binding_targets(node):
                    self._record(t)
                self.generic_visit(node)

            def visit_AugAssign(self, node):
                self._record(node.target)
                self.generic_visit(node)

        V(ctx).visit(ctx.tree)
    return shared


def _none_check(test: ast.AST
                ) -> List[Tuple[str, bool, List[ast.AST]]]:
    """(dotted attr, guarded_branch_is_body, tail_tests) candidates of
    a test expression: ``x.attr`` / ``x.attr is not None`` guard the
    body, ``not x.attr`` / ``x.attr is None`` guard the else.  For an
    ``and`` chain, operand i's candidate guards the operands AFTER it
    (returned as tail_tests) plus the body — never itself, or the safe
    ``if flag and x.attr is not None:`` idiom would self-match."""
    out: List[Tuple[str, bool, List[ast.AST]]] = []

    def _cand(node) -> Optional[Tuple[str, bool]]:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name):
            return dotted_name(node), True
        if (isinstance(node, ast.UnaryOp)
                and isinstance(node.op, ast.Not)
                and isinstance(node.operand, ast.Attribute)
                and isinstance(node.operand.value, ast.Name)):
            return dotted_name(node.operand), False
        if (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.left, ast.Attribute)
                and isinstance(node.left.value, ast.Name)
                and isinstance(node.comparators[0], ast.Constant)
                and node.comparators[0].value is None):
            if isinstance(node.ops[0], ast.IsNot):
                return dotted_name(node.left), True
            if isinstance(node.ops[0], ast.Is):
                return dotted_name(node.left), False
        return None

    c = _cand(test)
    if c is not None and c[0] is not None:
        out.append((c[0], c[1], []))
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for i, v in enumerate(test.values):
            c = _cand(v)
            if c is not None and c[0] is not None and c[1]:
                out.append((c[0], c[1], list(test.values[i + 1:])))
    return out


def _rereads(region: Sequence[ast.AST], dotted: str,
             skip_under_locks: bool = True) -> List[ast.AST]:
    """Load-context re-reads of ``dotted`` inside ``region``, skipping
    subtrees under a ``with <lock>:`` (a locked re-read re-validates —
    the registry's canary double-check idiom) and nested defs."""
    hits: List[ast.AST] = []
    stack = list(region)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if skip_under_locks and isinstance(n, (ast.With, ast.AsyncWith)) \
                and any(lock_expr(i.context_expr) is not None
                        for i in n.items):
            continue
        if (isinstance(n, ast.Attribute)
                and isinstance(getattr(n, "ctx", None), ast.Load)
                and dotted_name(n) == dotted):
            hits.append(n)
            continue  # the deref of interest; don't also report `x`
        stack.extend(ast.iter_child_nodes(n))
    return hits


def rule_check_then_deref(ctxs: Sequence[ModuleContext],
                          shared: Optional[Set[str]] = None
                          ) -> List[Finding]:
    """ZL721 (project rule — see the module docstring).

    Receiver scoping: for a ``self.attr`` check the attr must be
    lock-guarded IN THE SAME MODULE (a class whose own module never
    locks around the attribute is single-owner state — the Trainer's
    ``self.state`` must not be condemned because the registry locks an
    unrelated ``dep.state``); checks through other receivers
    (``entry.active`` from the autoscaler) consult the project-wide
    set, because that is exactly the cross-module escape the rule
    exists to catch."""
    # one walk per module: the per-module sets union into the
    # project-wide pool (walking every tree a second time for the
    # union would double the cost of the lint's widest pass)
    local_sets = {ctx.path: collect_shared_attrs([ctx])
                  for ctx in ctxs}
    if shared is None:
        shared = set().union(*local_sets.values()) \
            if local_sets else set()
    findings: List[Finding] = []
    for ctx in ctxs:
        local_shared = local_sets[ctx.path]

        class V(QualnameVisitor):
            def _check(self, test, body, orelse):
                if self.lock_stack:
                    return  # the check holds a lock: writer excluded
                for dotted, guards_body, tail_tests in _none_check(test):
                    recv, attr = dotted.split(".", 1)
                    attr = attr.rsplit(".", 1)[-1]
                    pool = (local_shared if recv == "self" else shared)
                    if attr not in pool:
                        continue
                    region = list(body if guards_body else orelse)
                    region += tail_tests
                    for hit in _rereads(region, dotted):
                        findings.append(Finding(
                            "ZL721", ctx.path, hit.lineno,
                            hit.col_offset, self.qualname,
                            f"{dotted} re-read after its None/"
                            "truthiness check: a concurrent writer "
                            "can null it between the check and this "
                            "deref (it is written under a lock "
                            "elsewhere) — snapshot it into a local "
                            "and check THAT "
                            "(`d = obj.attr` / `if d is not None: "
                            "use d`)"))

            def visit_If(self, node: ast.If):
                self._check(node.test, node.body, node.orelse)
                self.generic_visit(node)

            def visit_IfExp(self, node: ast.IfExp):
                self._check(node.test, [node.body], [node.orelse])
                self.generic_visit(node)

        V(ctx).visit(ctx.tree)
    return findings


# ----------------------------------------------------------------- ZL731
def _lock_owner_map(ctxs: Sequence[ModuleContext]) -> Dict[str, Set[str]]:
    """lock attr name -> {owning classes} from constructor assignments
    (``self._lock = threading.Lock()`` inside ``class X``)."""
    owners: Dict[str, Set[str]] = collections.defaultdict(set)
    for ctx in ctxs:
        class V(QualnameVisitor):
            def visit_Assign(self, node):
                if is_lock_ctor(self.ctx, node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) \
                                and self.class_stack:
                            owners[t.attr].add(self.class_stack[-1])
                self.generic_visit(node)

        V(ctx).visit(ctx.tree)
    return owners


def rule_lock_order(ctxs: Sequence[ModuleContext]) -> List[Finding]:
    """ZL731 (project rule): build the global lock-acquisition graph
    from lexical ``with`` nesting and flag cycles.  Lock identity is
    ``Class.attr`` — the enclosing class for ``self.x``, the unique
    lock-constructor owner for other receivers, module-scoped
    otherwise (two anonymous ``_lock``s in different files must not
    alias into a false cycle)."""
    owners = _lock_owner_map(ctxs)
    # edge: (src_id, dst_id) -> first acquisition site (path, line, qual)
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    for ctx in ctxs:
        class V(QualnameVisitor):
            def __init__(self, c):
                super().__init__(c)
                self.id_stack: List[str] = []

            def _ident(self, lock: str) -> str:
                recv, attr = lock.split(".", 1)
                if recv == "self" and self.class_stack:
                    return f"{self.class_stack[-1]}.{attr}"
                own = owners.get(attr, set())
                if len(own) == 1:
                    return f"{next(iter(own))}.{attr}"
                # ambiguous owner (several classes construct a lock
                # under this attr): fall back to the RECEIVER name,
                # module-scoped — collapsing `a._lock` and `b._lock`
                # into one id would drop the very edges a cross-class
                # cycle is made of, while distinct receiver names keep
                # them apart (name-based, like the hot-path graph)
                return f"{self.ctx.path}::{recv}.{attr}"

            def _visit_with(self, node):
                acquired = []
                for item in node.items:
                    lock = lock_expr(item.context_expr)
                    if lock is None:
                        continue
                    ident = self._ident(lock)
                    for held in self.id_stack:
                        if held != ident:
                            edges.setdefault(
                                (held, ident),
                                (self.ctx.path, node.lineno,
                                 self.qualname))
                    acquired.append(ident)
                    self.id_stack.append(ident)
                    self.lock_stack.append(lock)
                self.generic_visit(node)
                for _ in acquired:
                    self.id_stack.pop()
                    self.lock_stack.pop()

            visit_With = _visit_with
            visit_AsyncWith = _visit_with

        V(ctx).visit(ctx.tree)

    # cycle detection over the edge set
    graph: Dict[str, List[str]] = collections.defaultdict(list)
    for (a, b) in edges:
        graph[a].append(b)
    findings: List[Finding] = []
    reported: Set[Tuple[str, ...]] = set()

    def _dfs(start: str):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in graph.get(node, ()):
                if nxt == start:
                    cyc = tuple(path)
                    # canonicalize: rotate so the smallest id leads
                    i = cyc.index(min(cyc))
                    canon = cyc[i:] + cyc[:i]
                    if canon in reported:
                        continue
                    reported.add(canon)
                    site_path, line, qual = min(
                        edges[(a, b)] for a, b in
                        zip(canon, canon[1:] + canon[:1]))
                    chain = " -> ".join(canon + (canon[0],))
                    findings.append(Finding(
                        "ZL731", site_path, line, 0, qual,
                        f"lock-order cycle: {chain} — two threads "
                        "taking these locks from opposite ends "
                        "deadlock on each other's second acquisition; "
                        "pick one global order (or merge the locks)"))
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))

    for start in sorted(graph):
        _dfs(start)
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


# ----------------------------------------------------------------- ZL502
def rule_unbounded_queue(ctx: ModuleContext) -> List[Finding]:
    findings: List[Finding] = []

    class V(QualnameVisitor):
        def visit_Call(self, node: ast.Call):
            resolved = self.ctx.resolve(node.func)
            if resolved in ("queue.Queue", "queue.LifoQueue",
                            "queue.PriorityQueue", "Queue"):
                bounded = bool(node.args) or any(
                    kw.arg == "maxsize" and not (
                        isinstance(kw.value, ast.Constant)
                        and kw.value.value == 0)
                    for kw in node.keywords)
                if not bounded:
                    findings.append(Finding(
                        "ZL502", self.ctx.path, node.lineno,
                        node.col_offset, self.qualname,
                        "unbounded queue.Queue: under overload it "
                        "converts memory into latency instead of "
                        "shedding — pass maxsize (see "
                        "serving.admission for the argument)"))
            self.generic_visit(node)

    V(ctx).visit(ctx.tree)
    return findings
