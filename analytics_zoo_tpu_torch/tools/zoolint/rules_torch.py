"""Torch-specific static rules: CUDA-graph capture hazards.

A CUDA-graph capture is the port's trace: the body runs once under
``torch.cuda.graph(...)``, the device work it queued is recorded, and
every later ``replay()`` re-issues exactly that work with the same
pointers.  Host code inside the body runs ONCE, at capture.  So the
JAX package's recompile and tracer-leak classes have torch twins:

Recapture hazards
  ZL101  ``torch.cuda.CUDAGraph()`` built inside a loop body: a fresh
         capture (and a fresh pool share) per iteration.
  ZL102  a graph built and replayed within one call and never kept
         (not stored on an object, in a container, nor returned), or an
         immediately-invoked ``make_graphed_callables(f, ...)(x)``: a
         capture per call.

Capture hazards (inside a captured body: the statements of a
``with torch.cuda.graph(...)`` block, the functions named in
``DEFAULT_CAPTURE_ENTRIES``, and the functions and own methods they
call, transitively — :func:`collect_capture_scopes`)
  ZL201  ``float()``/``int()``/``bool()`` on a possibly-tensor value: a
         device->host sync (illegal while capturing), and a Python
         number frozen at capture.
  ZL202  Python ``if``/``while`` on a possibly-tensor value: the branch
         taken at capture is the only one every replay runs (shape,
         dtype, ``len()`` and ``.size()`` tests are host metadata and
         exempt).
  ZL203  host materialization inside the body: ``.item()``,
         ``.tolist()``, ``.cpu()``, ``.numpy()``, or ``np.asarray``/
         ``np.array`` of a possibly-tensor value.
  ZL204  a CPU tensor made fresh inside the body and copied to the
         card (``torch.tensor(..., device=...)``, ``torch.as_tensor``/
         ``from_numpy`` with a device or a ``.to``/``.cuda`` hop): the
         graph records the address of a host buffer that is gone by
         the first replay.
  ZL205  a Python value read at capture that the class rebinds
         elsewhere (``self.attr`` assigned outside ``__init__``): the
         graph keeps the value (or the storage) it saw at capture, so
         every replay after the rebind runs with the stale one.

A value is "possibly-tensor" when it is a parameter of a captured
function (less ``self``/``cls``, parameters with a constant default or
an annotation other than a tensor's), a ``self.attr`` the class binds
from a ``torch.*`` call, a name bound from a ``torch.*`` call, or a
name bound from an expression over those (one forward pass, as the JAX
rules taint from a jitted function's arguments).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .context import (ModuleContext, QualnameVisitor, entry_keys,
                      is_static_expr, last_name, tensor_attrs,
                      walk_shallow)
from .findings import Finding

#: final names (or ``Class.method`` suffixes) of functions that run as a
#: captured body although no ``with torch.cuda.graph`` names them: the
#: decode engine hands its bodies to ``_Plan`` as callables
#: (``self.body``), which a lexical search cannot follow
DEFAULT_CAPTURE_ENTRIES = (
    # the decode engine's step plan: one decode step over every slot
    "DecodeEngine._step_body",
    # the fused window: k steps as one captured plan
    "DecodeEngine._stepk_body",
    # the speculative window: draft, verify and accept as one plan
    "DecodeEngine._spec_body",
)

_HOST_CASTS = {"float", "int", "bool", "complex"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_GRAPH_CTORS = ("torch.cuda.CUDAGraph",)
_GRAPH_CTXS = ("torch.cuda.graph",)
_GRAPHED = ("torch.cuda.make_graphed_callables",)
_FACTORIES = ("torch.tensor", "torch.as_tensor", "torch.from_numpy")


def _is_graph_ctor(ctx: ModuleContext, node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        ctx.resolve(node.func) in _GRAPH_CTORS


def _is_graph_with(ctx: ModuleContext, node: ast.AST) -> bool:
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(i.context_expr, ast.Call)
        and ctx.resolve(i.context_expr.func) in _GRAPH_CTXS
        for i in node.items)


# --------------------------------------------------------- ZL101 / ZL102
class _RecaptureVisitor(QualnameVisitor):
    def __init__(self, ctx: ModuleContext):
        super().__init__(ctx)
        self.findings: List[Finding] = []
        self._reported: set = set()

    def _visit_loop(self, node):
        for child in walk_shallow(node.body + node.orelse):
            if _is_graph_ctor(self.ctx, child) and \
                    id(child) not in self._reported:
                self._reported.add(id(child))  # nested loops: once
                self.findings.append(Finding(
                    "ZL101", self.ctx.path, child.lineno,
                    child.col_offset, self.qualname,
                    "torch.cuda.CUDAGraph() built inside a loop: each "
                    "iteration captures afresh — build the graph once, "
                    "keep it, and replay it"))
        self.generic_visit(node)

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def visit_Call(self, node: ast.Call):
        if isinstance(node.func, ast.Call) and \
                self.ctx.resolve(node.func.func) in _GRAPHED:
            self.findings.append(Finding(
                "ZL102", self.ctx.path, node.lineno, node.col_offset,
                self.qualname,
                "immediately-invoked make_graphed_callables(f, ...)(x): "
                "a capture per call — bind the graphed callable once "
                "and call it"))
        self.generic_visit(node)

    def _visit_func(self, node):
        self.func_stack.append(node.name)
        self._per_call_graphs(node)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _per_call_graphs(self, fd):
        """A local bound to ``CUDAGraph()`` that is replayed in this
        call and never escapes it."""
        body = list(walk_shallow(fd.body))
        local: Dict[str, ast.AST] = {}
        for n in body:
            if isinstance(n, ast.Assign) and _is_graph_ctor(self.ctx,
                                                            n.value):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        local[t.id] = n.value
        for name, ctor in local.items():
            replayed = escaped = False
            for n in body:
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "replay" and \
                        isinstance(n.func.value, ast.Name) and \
                        n.func.value.id == name:
                    replayed = True
                elif isinstance(n, (ast.Return, ast.Yield)) and \
                        n.value is not None and any(
                            isinstance(x, ast.Name) and x.id == name
                            for x in ast.walk(n.value)):
                    escaped = True
                elif isinstance(n, ast.Assign) and any(
                        isinstance(x, ast.Name) and x.id == name
                        for x in ast.walk(n.value)) and any(
                        not isinstance(t, ast.Name) for t in n.targets):
                    escaped = True  # self.graph = g / table[k] = g
                elif isinstance(n, ast.Call) and \
                        self.ctx.resolve(n.func) not in _GRAPH_CTXS and \
                        any(isinstance(a, ast.Name) and a.id == name
                            for a in list(n.args)
                            + [k.value for k in n.keywords]):
                    escaped = True  # graphs.append(g) / keep(g)
            if replayed and not escaped:
                self.findings.append(Finding(
                    "ZL102", self.ctx.path, ctor.lineno, ctor.col_offset,
                    self.qualname,
                    f"CUDA graph {name!r} is captured and replayed within "
                    "one call and never kept: every call pays a capture "
                    "— build it once (store it) and replay it"))


def rule_recapture(ctx: ModuleContext) -> List[Finding]:
    if "CUDAGraph" not in ctx.source and \
            "make_graphed_callables" not in ctx.source:
        return []  # nothing to find: skip the walk
    v = _RecaptureVisitor(ctx)
    v.visit(ctx.tree)
    return v.findings


# --------------------------------------------- ZL201 .. ZL205 (project)
class _DefCollector(QualnameVisitor):
    def __init__(self, ctx: ModuleContext):
        super().__init__(ctx)
        self.defs: Dict[str, ast.AST] = {}
        self.graph_bodies: List[Tuple[str, ast.AST]] = []
        # (class, attr) rebound by a plain assignment outside __init__
        self.rebound: Set[Tuple[str, str]] = set()

    def _visit_func(self, node):
        self.func_stack.append(node.name)
        self.defs.setdefault(self.qualname, node)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _visit_with(self, node):
        if _is_graph_with(self.ctx, node):
            self.graph_bodies.append((self.qualname, node))
        super()._visit_with(node)

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def visit_Assign(self, node: ast.Assign):
        if self.class_stack and self.func_stack and \
                self.func_stack[-1] != "__init__":
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    self.rebound.add((self.class_stack[-1], t.attr))
        self.generic_visit(node)


def _imported_from(ctx: ModuleContext) -> Dict[str, str]:
    """Local name -> last component of the module it was imported from
    (``from ..ops.attention import attention_bhsd as a`` binds ``a`` to
    ``attention``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = node.module.rsplit(".", 1)[-1]
    return out


def _stem(path: str) -> str:
    base = path.rsplit("/", 1)[-1][:-3]
    if base == "__init__" and "/" in path:
        return path.rsplit("/", 2)[-2]
    return base


def _call_edges(nodes) -> Tuple[Set[str], Set[str]]:
    """(plain function names called, ``self.method`` names called) in
    ``nodes``, nested defs excluded."""
    funcs: Set[str] = set()
    meths: Set[str] = set()
    for node in walk_shallow(nodes):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                funcs.add(f.id)
            elif isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and f.value.id == "self":
                meths.add(f.attr)
    return funcs, meths


def collect_capture_scopes(ctxs: List[ModuleContext], defs=None):
    """The captured scopes of the project: every ``with
    torch.cuda.graph`` body, every def named in
    ``DEFAULT_CAPTURE_ENTRIES``, and every
    def they call — a plain call ``f(...)`` reaches the module-level
    function ``f`` of its own module, or of the module it was imported
    from (the decode step's math lives in another module; a builtin
    such as ``max`` reaches nothing), a ``self.m(...)`` call the methods
    ``m`` of the same class.  Calls on other receivers are not followed:
    a captured body calls math, not services.  ``defs`` takes the hot
    path's (path, qualname) -> def map when the engine has one.  Returns
    (defs, captured def keys, graph bodies, and for each module holding
    a captured scope its (rebound, tensor) ``(class, attr)`` sets)."""
    if defs is None:
        defs = {}
        for ctx in ctxs:
            col = _DefCollector(ctx)
            col.visit(ctx.tree)
            defs.update(((ctx.path, q), fd) for q, fd in col.defs.items())
    top: Dict[str, List[Tuple[str, str]]] = {}
    by_final: Dict[str, List[Tuple[str, str]]] = {}
    for key in defs:
        qual = key[1]
        by_final.setdefault(qual.rsplit(".", 1)[-1], []).append(key)
        if "." not in qual:
            top.setdefault(qual, []).append(key)
    ctx_of = {c.path: c for c in ctxs}
    bodies: List[Tuple[ModuleContext, str, ast.AST]] = []
    imports: Dict[str, Dict[str, str]] = {}
    for ctx in ctxs:
        imports[ctx.path] = _imported_from(ctx)
        if "graph(" in ctx.source:
            col = _DefCollector(ctx)
            col.visit(ctx.tree)
            bodies.extend((ctx, q, w) for q, w in col.graph_bodies)

    def successors(path: str, qual: str, nodes) -> List[Tuple[str, str]]:
        funcs, meths = _call_edges(nodes)
        out = [k for f in funcs for k in top.get(f, [])
               if (k[0] == path and f not in imports[path])
               or _stem(k[0]) == imports[path].get(f)]
        cls = qual.rsplit(".", 1)[0] if "." in qual else None
        if cls is not None:
            out.extend((path, f"{cls}.{m}") for m in meths
                       if (path, f"{cls}.{m}") in defs)
        return out

    frontier = [k for e in DEFAULT_CAPTURE_ENTRIES
                for k in entry_keys(e, by_final)]
    for ctx, qual, w in bodies:
        frontier.extend(successors(ctx.path, qual, w.body))
    captured: Set[Tuple[str, str]] = set(frontier)
    while frontier:
        key = frontier.pop()
        for nxt in successors(key[0], key[1], defs[key].body):
            if nxt not in captured:
                captured.add(nxt)
                frontier.append(nxt)
    attrs: Dict[str, Tuple[Set[Tuple[str, str]],
                           Set[Tuple[str, str]]]] = {}
    for path in {k[0] for k in captured} | {c.path for c, _, _ in bodies}:
        col = _DefCollector(ctx_of[path])
        col.visit(ctx_of[path].tree)
        attrs[path] = (col.rebound, tensor_attrs(ctx_of[path]))
    return defs, captured, bodies, attrs


def _host_annotated(arg: ast.arg) -> bool:
    """A parameter annotated with any type but a tensor is host state
    (``i: int``, ``model: "TransformerLM"``): the annotation is how a
    captured function says so, as ``static_argnums`` is under jit."""
    ann = arg.annotation
    return ann is not None and "Tensor" not in ast.unparse(ann)


def _hits(node: ast.AST, tainted: Set[str], cls: Optional[str],
          tensor_attrs: Set[Tuple[str, str]]) -> Set[str]:
    """The possibly-tensor names (and ``self.attr`` tensor attributes of
    ``cls``) that ``node`` reads outside host-metadata sub-expressions
    (``x.shape``, ``len(x)``, ``x.size(0)``...)."""
    found: Set[str] = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if is_static_expr(n):
            continue
        if isinstance(n, ast.Name) and n.id in tainted:
            found.add(n.id)
        elif isinstance(n, ast.Attribute) and \
                isinstance(n.value, ast.Name) and n.value.id == "self" \
                and (cls, n.attr) in tensor_attrs:
            found.add(f"self.{n.attr}")
            continue
        stack.extend(ast.iter_child_nodes(n))
    return found


def _taint(ctx: ModuleContext, fd: Optional[ast.AST],
           stmts: List[ast.AST], cls: Optional[str],
           tensor_attrs: Set[Tuple[str, str]]) -> Set[str]:
    """Possibly-tensor names of one captured scope (module doc)."""
    tainted: Set[str] = set()
    if fd is not None:
        a = fd.args
        pos = a.posonlyargs + a.args
        n_nodef = len(pos) - len(a.defaults)
        for i, arg in enumerate(pos):
            if arg.arg in ("self", "cls") or _host_annotated(arg):
                continue
            if i >= n_nodef and isinstance(a.defaults[i - n_nodef],
                                           ast.Constant):
                continue
            tainted.add(arg.arg)
        for arg, d in zip(a.kwonlyargs, a.kw_defaults):
            if not _host_annotated(arg) and not isinstance(d,
                                                           ast.Constant):
                tainted.add(arg.arg)
    for _ in range(2):  # a second pass picks up loop-carried names
        for st in walk_shallow(stmts):
            if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)) \
                    and st.value is not None:
                v = st.value
                hit = bool(_hits(v, tainted, cls, tensor_attrs)) or (
                    isinstance(v, ast.Call)
                    and (ctx.resolve(v.func) or "").startswith("torch."))
                if hit:
                    targets = (st.targets if isinstance(st, ast.Assign)
                               else [st.target])
                    for t in targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                tainted.add(n.id)
    return tainted


def _is_identity_test(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None`` never touches __bool__."""
    return (isinstance(test, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot))
                    for op in test.ops))


def _device_hop(ctx: ModuleContext, call: ast.Call) -> bool:
    """``torch.tensor/as_tensor/from_numpy(...)`` made on the host and
    moved to a device in the same expression."""
    if any(kw.arg == "device" for kw in call.keywords) and \
            ctx.resolve(call.func) in ("torch.tensor", "torch.as_tensor"):
        return True
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in ("to", "cuda") and \
            isinstance(f.value, ast.Call) and \
            ctx.resolve(f.value.func) in _FACTORIES:
        return True
    return False


def _scan_scope(ctx: ModuleContext, qual: str, stmts: List[ast.AST],
                fd: Optional[ast.AST], cls: Optional[str], attrs,
                findings: List[Finding]):
    rebound, tensor_attrs = attrs
    tainted = _taint(ctx, fd, stmts, cls, tensor_attrs)

    def hits(node):
        return _hits(node, tainted, cls, tensor_attrs)

    for node in walk_shallow(stmts):
        if isinstance(node, ast.Call):
            fn = last_name(node.func)
            if fn in _HOST_CASTS and isinstance(node.func, ast.Name) \
                    and node.args and hits(node.args[0]):
                findings.append(Finding(
                    "ZL201", ctx.path, node.lineno, node.col_offset, qual,
                    f"{fn}() on a possibly-tensor value inside a captured "
                    "body: a device->host sync (illegal while capturing) "
                    "whose number is frozen at capture — keep it a "
                    "tensor (torch.where, clamp) or hoist it out"))
            elif fn in _HOST_METHODS and not node.args and \
                    isinstance(node.func, ast.Attribute):
                findings.append(Finding(
                    "ZL203", ctx.path, node.lineno, node.col_offset, qual,
                    f".{fn}() inside a captured body: a host "
                    "materialization that syncs at capture and never "
                    "runs again at replay — copy into a pinned buffer "
                    "after the replay instead"))
            elif ctx.resolve(node.func) in ("numpy.asarray",
                                            "numpy.array") \
                    and node.args and hits(node.args[0]):
                findings.append(Finding(
                    "ZL203", ctx.path, node.lineno, node.col_offset, qual,
                    "np.asarray/np.array of a possibly-tensor value "
                    "inside a captured body forces a host round-trip "
                    "at capture — keep the math in torch"))
            elif _device_hop(ctx, node):
                findings.append(Finding(
                    "ZL204", ctx.path, node.lineno, node.col_offset, qual,
                    "a host tensor made inside a captured body and copied "
                    "to the device: the graph records a host buffer that "
                    "is freed before the first replay — make the device "
                    "tensor once, outside, and copy_ into it"))
        elif isinstance(node, (ast.If, ast.While)):
            found = hits(node.test)
            if found and not _is_identity_test(node.test):
                findings.append(Finding(
                    "ZL202", ctx.path, node.lineno, node.col_offset, qual,
                    f"Python branch on possibly-tensor {sorted(found)} "
                    "inside a captured body: the branch taken at capture "
                    "is the only one every replay runs — use torch.where, "
                    "or decide on the host before capturing"))
        elif isinstance(node, ast.Attribute) and cls is not None and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and \
                isinstance(node.ctx, ast.Load) and \
                (cls, node.attr) in rebound:
            findings.append(Finding(
                "ZL205", ctx.path, node.lineno, node.col_offset, qual,
                f"self.{node.attr} is read inside a captured body but "
                f"{cls} rebinds it outside __init__: every replay runs "
                "with the value (or storage) seen at capture — keep it "
                "a device tensor written in place (copy_/fill_), or "
                "recapture when it changes"))


def rule_capture_hazards(ctxs: List[ModuleContext],
                         defs=None) -> List[Finding]:
    """ZL201-ZL205 over every captured scope (module doc).  ``defs``:
    the engine's shared (path, qualname) -> def map, if it has one."""
    defs, captured, bodies, attrs = collect_capture_scopes(ctxs, defs=defs)
    ctx_of = {c.path: c for c in ctxs}
    findings: List[Finding] = []
    for (path, qual) in sorted(captured):
        fd = defs[(path, qual)]
        ctx = ctx_of[path]
        parts = qual.split(".")
        cls = parts[-2] if len(parts) >= 2 else None
        _scan_scope(ctx, qual, fd.body, fd, cls, attrs[path], findings)
    for ctx, qual, w in bodies:
        parts = qual.split(".")
        cls = parts[-2] if len(parts) >= 2 else None
        _scan_scope(ctx, qual, w.body, None, cls, attrs[ctx.path],
                    findings)
    return findings
