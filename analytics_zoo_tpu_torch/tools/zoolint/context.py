"""Shared AST infrastructure for zoolint rules.

One parse per file; rules receive a :class:`ModuleContext` carrying the
tree plus resolved import aliases (``torch``/``torch.cuda``/``numpy``/
``threading``/``queue`` under whatever names the module bound them), a
dotted-name resolver, and a qualname-tracking walker base.  Everything
here is stdlib-only — the static half of zoolint never imports torch.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

# attribute reads that are host metadata of a tensor (never read its
# values, so never sync) — branching or casting on these is fine inside
# a CUDA-graph capture
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad"}
# calls whose result is host metadata even with tensor arguments
STATIC_CALLS = {"len", "isinstance", "issubclass", "hasattr", "callable",
                "getattr", "type", "id", "repr", "str", "format", "size",
                "dim", "numel", "stride", "is_contiguous", "data_ptr"}
# lock-ish attribute names: `with recv.<attr>:` acquires a mutex.
# Semaphores are deliberately NOT matched — they bound concurrency, they
# don't own data.
_LOCK_NAME_HINTS = ("lock", "cond", "mutex")
_LOCK_CTORS = {"Lock", "RLock", "Condition"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_name(node: ast.AST) -> Optional[str]:
    """The final component of a call target: ``x.y.predict`` -> "predict"."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def walk_shallow(nodes: Sequence[ast.AST],
                 skip=(ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.Lambda)) -> Iterator[ast.AST]:
    """ast.walk over statements WITHOUT descending into nested function
    bodies (their code runs later, not here).  Decorators and default
    expressions of nested defs DO execute here, so they are yielded."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, skip):
            for dec in getattr(node, "decorator_list", []):
                stack.append(dec)
            args = getattr(node, "args", None)
            if isinstance(args, ast.arguments):
                stack.extend(args.defaults)
                stack.extend(d for d in args.kw_defaults if d is not None)
            continue
        stack.extend(ast.iter_child_nodes(node))


class ModuleContext:
    """One parsed module + its import-alias table."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        # alias -> canonical module ("torch", "numpy", ...)
        self.module_aliases: Dict[str, str] = {}
        # local name -> canonical dotted name ("cuda" -> "torch.cuda")
        self.name_aliases: Dict[str, str] = {}
        self._scan_imports()

    def _scan_imports(self):
        canon = {"torch": "torch", "torch.cuda": "torch.cuda",
                 "torch.nn.functional": "torch.nn.functional",
                 "numpy": "numpy", "threading": "threading",
                 "queue": "queue", "functools": "functools"}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in canon:
                        self.module_aliases[a.asname or a.name] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if node.module in canon:
                        self.name_aliases[a.asname or a.name] = \
                            f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of an expression:
        ``t.cuda.synchronize`` -> "torch.cuda.synchronize" when the
        module did ``import torch as t``; ``synchronize`` ->
        "torch.cuda.synchronize" after ``from torch.cuda import
        synchronize``."""
        name = dotted_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        if head in self.name_aliases:
            base = self.name_aliases[head]
            return f"{base}.{rest}" if rest else base
        if head in self.module_aliases:
            base = self.module_aliases[head]
            return f"{base}.{rest}" if rest else base
        return name


class QualnameVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing ``Class.method`` qualname
    and the stack of held locks (``with recv.some_lock:`` items)."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.class_stack: List[str] = []
        self.func_stack: List[str] = []
        # each entry: ("recv.attr") for every lock held at this point
        self.lock_stack: List[str] = []

    @property
    def qualname(self) -> str:
        parts = self.class_stack + self.func_stack
        return ".".join(parts) if parts else "<module>"

    # ---- scope tracking ----
    def visit_ClassDef(self, node: ast.ClassDef):
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node):
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # ---- lock tracking ----
    def _visit_with(self, node):
        acquired = []
        for item in node.items:
            lock = lock_expr(item.context_expr)
            if lock is not None:
                acquired.append(lock)
        self.lock_stack.extend(acquired)
        self.generic_visit(node)
        del self.lock_stack[len(self.lock_stack) - len(acquired):]

    visit_With = _visit_with
    visit_AsyncWith = _visit_with


def lock_expr(expr: ast.AST) -> Optional[str]:
    """"recv.attr" when a with-item context expression acquires a lock:
    a bare attribute whose name smells like a mutex (``self._lock``,
    ``entry.deploy_lock``, ``self._cond``).  Calls (``ac.admit()``) and
    semaphores are not locks."""
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        attr = expr.attr.lower()
        if any(h in attr for h in _LOCK_NAME_HINTS):
            return f"{expr.value.id}.{expr.attr}"
    return None


def is_lock_ctor(ctx: ModuleContext, node: ast.AST) -> bool:
    """``threading.Lock()`` / ``RLock()`` / ``Condition()``."""
    if not isinstance(node, ast.Call):
        return False
    resolved = ctx.resolve(node.func)
    if resolved is None:
        return False
    parts = resolved.split(".")
    return parts[-1] in _LOCK_CTORS and (
        len(parts) == 1 or parts[0] == "threading")


def iter_function_defs(ctx: "ModuleContext"):
    """Every (qualname, funcdef) in the module, nested defs included —
    the iteration order the CFG-based rules analyze functions in."""
    out: List[Tuple[str, ast.AST]] = []

    class V(QualnameVisitor):
        def _visit_func(self, node):
            self.func_stack.append(node.name)
            out.append((self.qualname, node))
            self.generic_visit(node)
            self.func_stack.pop()

        visit_FunctionDef = _visit_func
        visit_AsyncFunctionDef = _visit_func

    V(ctx).visit(ctx.tree)
    return out


def header_parts(st: ast.stmt) -> List[ast.AST]:
    """The sub-expressions a CFG node actually EVALUATES — compound
    statements' bodies are separate CFG nodes, so a rule scanning a
    node must look only at its header (an ``if``'s test, a ``for``'s
    iterator, a ``with``'s context expressions), never the body."""
    if isinstance(st, (ast.If, ast.While)):
        return [st.test]
    if isinstance(st, (ast.For, ast.AsyncFor)):
        return [st.target, st.iter]
    if isinstance(st, (ast.With, ast.AsyncWith)):
        parts: List[ast.AST] = []
        for item in st.items:
            parts.append(item.context_expr)
            if item.optional_vars is not None:
                parts.append(item.optional_vars)
        return parts
    if isinstance(st, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef)):
        return []
    return [st]


def binding_targets(st: ast.stmt) -> List[ast.AST]:
    """Every individual binding target a statement rebinds — Assign
    (tuple/list/starred targets flattened, nested included), AnnAssign,
    ``for`` targets, ``del`` — shared by the v2 rules so "what does
    this statement rebind?" has exactly one answer.  AugAssign is
    deliberately NOT included: ``x += 1`` reads-modifies-writes, and
    the resource rules treat it as its own gen/kill event."""
    roots: List[ast.AST] = []
    if isinstance(st, ast.Assign):
        roots.extend(st.targets)
    elif isinstance(st, ast.AnnAssign):
        roots.append(st.target)
    elif isinstance(st, (ast.For, ast.AsyncFor)):
        roots.append(st.target)
    elif isinstance(st, ast.Delete):
        roots.extend(st.targets)
    out: List[ast.AST] = []
    while roots:
        t = roots.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            roots.extend(t.elts)
        elif isinstance(t, ast.Starred):
            roots.append(t.value)
        else:
            out.append(t)
    return out


def is_static_expr(node: ast.AST) -> bool:
    """True when an expression is host metadata even if its leaves are
    tensors: ``x.shape``, ``x.dtype``, ``len(x)``, ``x.size(0)``,
    ``isinstance(x, T)``."""
    if isinstance(node, ast.Attribute):
        return node.attr in STATIC_ATTRS
    if isinstance(node, ast.Call):
        fn = last_name(node.func)
        return fn in STATIC_CALLS
    return False


def tensor_attrs(ctx: ModuleContext) -> Set[Tuple[str, str]]:
    """(class, attr) of every ``self.attr = torch.*(...)`` in the module:
    the attributes known to hold a tensor."""
    out: Set[Tuple[str, str]] = set()

    class V(QualnameVisitor):
        def visit_Assign(self, node):
            if self.class_stack and isinstance(node.value, ast.Call) and \
                    (ctx.resolve(node.value.func) or "").startswith(
                        "torch."):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        out.add((self.class_stack[-1], t.attr))
            self.generic_visit(node)

    V(ctx).visit(ctx.tree)
    return out


def entry_keys(name: str, by_final) -> List[Tuple[str, str]]:
    """The (path, qualname) keys an entry names in ``by_final`` (final
    name -> keys): every def of that final name, or for a
    ``Class.method`` entry the defs whose qualname ends with it."""
    if "." not in name:
        return by_final.get(name, [])
    return [k for k in by_final.get(name.rsplit(".", 1)[-1], [])
            if k[1] == name or k[1].endswith("." + name)]
