"""Per-function control-flow graphs with explicit exception edges.

The v1 rules were flow-insensitive: they matched patterns anywhere in a
function and could not ask "does every path from this acquire reach a
release?".  The serving stack's review history shows that is exactly where
the residual bugs live — counters leaked on exception exits, cleanup
present on the normal path and missing on the unwind.  This module
gives the v2 rules (ZL7xx, :mod:`rules_resource` /
:mod:`rules_donation`) a real CFG to run dataflow over.

Model (statement-granular — serving functions are small, blocks buy
nothing):

* one node per AST statement, plus three fixed virtual nodes:
  ``ENTRY`` (0), ``EXIT`` (1, every normal completion: ``return`` and
  falling off the end) and ``RAISE`` (2, every exception that escapes
  the function);
* edges are ``(src, dst, kind)``.  Kinds: ``normal`` (sequencing),
  ``true``/``false`` (branch arms), ``loop`` (back edge),
  ``break``/``continue``, ``return``, ``raise`` (an explicit ``raise``
  statement), ``exc`` (an IMPLICIT exception mid-statement),
  ``reraise`` (a completed ``finally`` resuming a pending exception)
  and ``fallthrough`` (end of body to EXIT);
* inside a protected region (a ``try`` body, its handlers/else under a
  ``finally``) every statement that can plausibly raise gets an ``exc``
  edge to its exception continuation — the handler dispatch, the
  ``finally``, or ``RAISE``.  OUTSIDE any try, implicit exceptions are
  deliberately not modeled (every call can raise in principle; edges
  everywhere would drown the dataflow in paths no cleanup could ever
  have intercepted) — but explicit ``raise`` statements always are.

Exception dispatch: a synthetic ``except-dispatch`` node fans out to
every handler (which handler matches is dynamic), and — unless some
handler is a catch-all (bare ``except`` or ``except BaseException``) —
onward to the outer continuation.  ``except Exception`` is NOT a
catch-all: ``KeyboardInterrupt`` walks straight past it, which is
precisely how the admission ``_acquire`` seat leak happened.

``finally`` is modeled as one shared subgraph (not duplicated per
continuation): every way out of the protected region routes through it,
and its exit edges fan out to each continuation that can actually need
it (the statement after, ``RAISE`` for exception paths, ``EXIT`` for
routed returns, the loop head/exit for routed continue/break).  The
merge is a deliberate over-approximation — a path entering the finally
normally also "sees" the exceptional exit — which for may-analyses adds
at worst a conservative finding, never hides one.

``with`` bodies carry no special exception edges of their own
(``__exit__`` runs transparently); the ``with`` header itself can raise
(``__enter__``) like any other statement when protected.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

#: edge kinds whose dataflow contribution is the PRE-state of the
#: source node (the exception may fire before the statement's effect)
EXC_KINDS = ("exc",)

_NO_RAISE = (ast.Pass, ast.Break, ast.Continue, ast.Global,
             ast.Nonlocal)


class CFG:
    """One function's control-flow graph (see module docstring)."""

    ENTRY = 0
    EXIT = 1
    RAISE = 2

    def __init__(self, fd: ast.AST):
        self.fd = fd
        self.stmts: Dict[int, ast.stmt] = {}
        self.labels: Dict[int, str] = {self.ENTRY: "entry",
                                       self.EXIT: "exit",
                                       self.RAISE: "raise"}
        self.edges: List[Tuple[int, int, str]] = []
        self.succs: Dict[int, List[Tuple[int, str]]] = {}
        self.preds: Dict[int, List[Tuple[int, str]]] = {}
        self._next = 3

    # ---- construction ----
    def new_node(self, stmt: Optional[ast.stmt] = None,
                 label: Optional[str] = None) -> int:
        n = self._next
        self._next += 1
        if stmt is not None:
            self.stmts[n] = stmt
            self.labels[n] = (f"L{stmt.lineno}:"
                              f"{type(stmt).__name__}")
        else:
            self.labels[n] = label or f"synthetic{n}"
        return n

    def add_edge(self, src: int, dst: int, kind: str):
        e = (src, dst, kind)
        if e in self.succs.setdefault(src, []):
            return
        self.edges.append(e)
        self.succs[src].append((dst, kind))
        self.preds.setdefault(dst, []).append((src, kind))

    # ---- introspection (the CFG tests assert on this) ----
    def nodes(self) -> List[int]:
        return sorted(set([self.ENTRY, self.EXIT, self.RAISE])
                      | set(self.labels))

    def describe(self) -> List[Tuple[str, str, str]]:
        """Edges as readable (src_label, dst_label, kind) triples,
        sorted — what the CFG-builder tests assert against."""
        return sorted((self.labels[s], self.labels[d], k)
                      for s, d, k in self.edges)

    def node_at(self, lineno: int) -> Optional[int]:
        """The statement node starting at ``lineno`` (tests)."""
        for n, st in self.stmts.items():
            if st.lineno == lineno:
                return n
        return None


class _FinallyFrame:
    """Bookkeeping for one try-with-finally while its region builds:
    which continuations routed into the shared finally subgraph."""

    __slots__ = ("entry", "needs_exc", "needs_return", "break_frames",
                 "continue_heads", "entered_normally")

    def __init__(self, entry: int):
        self.entry = entry
        self.needs_exc = False
        self.needs_return = False
        self.break_frames: List["_LoopFrame"] = []
        self.continue_heads: List[int] = []
        self.entered_normally = False


class _LoopFrame:
    __slots__ = ("head", "breaks")

    def __init__(self, head: int):
        self.head = head
        self.breaks: List[Tuple[int, str]] = []


class _Ctx:
    """Where control transfers go from the current position."""

    __slots__ = ("exc", "exc_frame", "ret_frame", "loop", "loop_frame")

    def __init__(self, exc: int, exc_frame: Optional[_FinallyFrame],
                 ret_frame: Optional[_FinallyFrame],
                 loop: Optional[_LoopFrame],
                 loop_frame: Optional[_FinallyFrame]):
        self.exc = exc                # exception continuation node
        self.exc_frame = exc_frame    # finally frame exc routes into
        self.ret_frame = ret_frame    # finally frame returns route into
        self.loop = loop              # innermost loop
        self.loop_frame = loop_frame  # finally frame break/continue
        #                               must route through (if any)


def build_cfg(fd: ast.AST) -> CFG:
    """Build the CFG of one ``FunctionDef`` / ``AsyncFunctionDef``.
    Nested function/class definitions are single statements (their
    bodies run elsewhere); analyze them via their own CFGs."""
    cfg = CFG(fd)
    ctx = _Ctx(CFG.RAISE, None, None, None, None)
    exits = _seq(cfg, fd.body, [(CFG.ENTRY, "normal")], ctx)
    for n, _kind in exits:
        cfg.add_edge(n, CFG.EXIT, "fallthrough")
    return cfg


def _seq(cfg: CFG, stmts: Sequence[ast.stmt],
         incoming: List[Tuple[int, str]], ctx: _Ctx
         ) -> List[Tuple[int, str]]:
    cur = incoming
    for st in stmts:
        cur = _stmt(cfg, st, cur, ctx)
    return cur


def _connect(cfg: CFG, incoming: List[Tuple[int, str]], node: int):
    for src, kind in incoming:
        cfg.add_edge(src, node, kind)


def _implicit_exc(cfg: CFG, node: int, st: ast.stmt, ctx: _Ctx):
    """The mid-statement exception edge — only inside protected
    regions, and only for statements that can plausibly raise."""
    if ctx.exc == CFG.RAISE or isinstance(st, _NO_RAISE):
        return
    cfg.add_edge(node, ctx.exc, "exc")
    if ctx.exc_frame is not None:
        ctx.exc_frame.needs_exc = True


def _stmt(cfg: CFG, st: ast.stmt, incoming: List[Tuple[int, str]],
          ctx: _Ctx) -> List[Tuple[int, str]]:
    if isinstance(st, ast.Try):
        return _try(cfg, st, incoming, ctx)
    node = cfg.new_node(st)
    _connect(cfg, incoming, node)
    _implicit_exc(cfg, node, st, ctx)

    if isinstance(st, ast.Return):
        if ctx.ret_frame is not None:
            cfg.add_edge(node, ctx.ret_frame.entry, "return")
            ctx.ret_frame.needs_return = True
        else:
            cfg.add_edge(node, CFG.EXIT, "return")
        return []

    if isinstance(st, ast.Raise):
        cfg.add_edge(node, ctx.exc, "raise")
        if ctx.exc_frame is not None:
            ctx.exc_frame.needs_exc = True
        return []

    if isinstance(st, ast.Break):
        if ctx.loop is None:
            return []
        if ctx.loop_frame is not None:
            cfg.add_edge(node, ctx.loop_frame.entry, "break")
            if ctx.loop not in ctx.loop_frame.break_frames:
                ctx.loop_frame.break_frames.append(ctx.loop)
        else:
            ctx.loop.breaks.append((node, "break"))
        return []

    if isinstance(st, ast.Continue):
        if ctx.loop is None:
            return []
        if ctx.loop_frame is not None:
            cfg.add_edge(node, ctx.loop_frame.entry, "continue")
            if ctx.loop.head not in ctx.loop_frame.continue_heads:
                ctx.loop_frame.continue_heads.append(ctx.loop.head)
        else:
            cfg.add_edge(node, ctx.loop.head, "continue")
        return []

    if isinstance(st, ast.If):
        body_exits = _seq(cfg, st.body, [(node, "true")], ctx)
        if st.orelse:
            else_exits = _seq(cfg, st.orelse, [(node, "false")], ctx)
        else:
            else_exits = [(node, "false")]
        return body_exits + else_exits

    if isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
        loop = _LoopFrame(node)
        inner = _Ctx(ctx.exc, ctx.exc_frame, ctx.ret_frame, loop, None)
        body_exits = _seq(cfg, st.body, [(node, "true")], inner)
        for src, _k in body_exits:
            cfg.add_edge(src, node, "loop")
        after: List[Tuple[int, str]] = [(node, "false")]
        if st.orelse:
            after = _seq(cfg, st.orelse, [(node, "false")], ctx)
        return after + loop.breaks

    if isinstance(st, (ast.With, ast.AsyncWith)):
        return _seq(cfg, st.body, [(node, "normal")], ctx)

    # simple statement (incl. nested def/class headers, which execute
    # here as a binding; their bodies do not)
    return [(node, "normal")]


def _catch_all(handlers: Sequence[ast.ExceptHandler]) -> bool:
    for h in handlers:
        if h.type is None:
            return True
        name = h.type
        if isinstance(name, ast.Name) and name.id == "BaseException":
            return True
    return False


def _try(cfg: CFG, st: ast.Try, incoming: List[Tuple[int, str]],
         ctx: _Ctx) -> List[Tuple[int, str]]:
    frame: Optional[_FinallyFrame] = None
    f_entry_node: Optional[int] = None
    if st.finalbody:
        # the finally subgraph is built up-front so the region can
        # route into its entry; its exits are wired at the end
        f_entry_node = cfg.new_node(
            label=f"L{st.lineno}:finally")
        frame = _FinallyFrame(f_entry_node)

    # outer continuations, as seen from inside this try
    outer_exc = frame.entry if frame is not None else ctx.exc
    outer_exc_frame = frame if frame is not None else ctx.exc_frame

    dispatch: Optional[int] = None
    if st.handlers:
        dispatch = cfg.new_node(label=f"L{st.lineno}:except-dispatch")

    body_exc = dispatch if dispatch is not None else outer_exc
    body_exc_frame = (None if dispatch is not None
                      else outer_exc_frame)
    body_ctx = _Ctx(body_exc, body_exc_frame,
                    frame if frame is not None else ctx.ret_frame,
                    ctx.loop,
                    frame if frame is not None else ctx.loop_frame)
    body_exits = _seq(cfg, st.body, incoming, body_ctx)

    # handler bodies and the else clause raise PAST this try's own
    # handlers — to the finally (if any) or the outer continuation
    after_ctx = _Ctx(outer_exc, outer_exc_frame,
                     frame if frame is not None else ctx.ret_frame,
                     ctx.loop,
                     frame if frame is not None else ctx.loop_frame)

    normal_exits: List[Tuple[int, str]] = []
    if st.orelse:
        normal_exits += _seq(cfg, st.orelse, body_exits, after_ctx)
    else:
        normal_exits += body_exits

    if dispatch is not None:
        for h in st.handlers:
            h_exits = _seq(cfg, h.body, [(dispatch, "exc")], after_ctx)
            normal_exits += h_exits
        if not _catch_all(st.handlers):
            # an exception no handler matches keeps propagating
            cfg.add_edge(dispatch, outer_exc, "exc")
            if outer_exc_frame is not None:
                outer_exc_frame.needs_exc = True

    if frame is None:
        return normal_exits

    # ---- wire the shared finally subgraph ----
    if normal_exits:
        frame.entered_normally = True
        _connect(cfg, normal_exits, frame.entry)
    f_exits = _seq(cfg, st.finalbody,
                   [(frame.entry, "normal")], ctx)
    for src, _k in f_exits:
        if frame.needs_exc:
            # the finally RAN to completion before the pending
            # exception resumes — post-state, hence "reraise" (an
            # "exc" edge would wrongly discard the finally's effect,
            # e.g. the release it exists to perform)
            cfg.add_edge(src, ctx.exc, "reraise")
            if ctx.exc_frame is not None:
                ctx.exc_frame.needs_exc = True
        if frame.needs_return:
            if ctx.ret_frame is not None:
                cfg.add_edge(src, ctx.ret_frame.entry, "return")
                ctx.ret_frame.needs_return = True
            else:
                cfg.add_edge(src, CFG.EXIT, "return")
        # break/continue chain through every ENCLOSING finally too (a
        # release in the outer finally must stay visible on the path),
        # exactly like return chains through ctx.ret_frame
        for loop in frame.break_frames:
            if ctx.loop_frame is not None:
                cfg.add_edge(src, ctx.loop_frame.entry, "break")
                if loop not in ctx.loop_frame.break_frames:
                    ctx.loop_frame.break_frames.append(loop)
            else:
                loop.breaks.append((src, "break"))
        for head in frame.continue_heads:
            if ctx.loop_frame is not None:
                cfg.add_edge(src, ctx.loop_frame.entry, "continue")
                if head not in ctx.loop_frame.continue_heads:
                    ctx.loop_frame.continue_heads.append(head)
            else:
                cfg.add_edge(src, head, "continue")
    if frame.entered_normally:
        return f_exits
    return []
