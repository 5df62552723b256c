"""Distributed-contract static rules (zoolint v3).

The v1/v2 rules analyze one function's locks, exceptions and captures.
This layer checks the AGREEMENTS between modules that make the fleet a
system: a router call site and a worker dispatch table two files away
must name the same ops, an error raised on a worker must survive the
wire envelope back to the client, a metric family must mean the same
thing wherever it is declared, an env knob must exist in exactly one
contract table, and a config value that changes built output must
rotate the store key.

All five families run off one :class:`ContractIndex` built in a single
pass over every module (the v2 shared-attr-set discipline: walking the
trees once per contract would multiply the lint's widest cost).

Wire op coverage
  ZL801  an op name sent over the fleet wire (``{"op": ...}`` request
         literal) with no worker-side handler — or a handler for an op
         nothing ever sends (dead protocol surface that rots unseen);
         plus encode_X/decode_X symmetry: a key the decoder reads that
         the paired encoder never writes is a KeyError on the first
         real frame.

Error-envelope round-trip
  ZL802  a ServingError subclass that cannot survive
         ``encode_error``/``decode_error``: missing from the wire
         registry (decodes as the bare base — wrong http_status, wrong
         retry class), duplicate class name (code collision: two
         meanings, one wire code), no reachable ``http_status``, or an
         ``__init__`` override that cannot accept
         ``cls(message, **details)``.

Metrics schema
  ZL811  one family name declared with conflicting types or label key
         sets anywhere in the package (the aggregator and dashboards
         key on both), label-name conventions (``rank`` is stamped by
         the pod aggregator, never by a declaring module; model labels
         are ``model``), ``*_total`` names must be counters, and docs
         drift against ``docs/observability.md`` and the port's own
         ``docs/dev/zoolint_torch.md`` in both directions.

Env contract
  ZL812  an ``os.environ`` read of a ``ZOO_*`` name outside the
         central ``envcontract`` module, an accessor call for a name
         the contract table never declared, or a declared name missing
         from the docs tables (``docs/serving.md``,
         ``docs/distributed-training.md`` and the port's
         ``docs/dev/zoolint_torch.md``).

Fingerprint drift
  ZL821  a constructor-derived config attribute read on the
         compile-reachable path (the call graph from the method that
         calls ``store.fingerprint``) but never folded into the
         fingerprint — the stale-build bug class: change the knob,
         redeploy, and the store happily serves the OLD build because
         the key never moved.  The module form covers a key made by a
         module function (the port's kernel-library key,
         ``ops/_kernels._store_key`` over ``common/execstore.py``'s
         ``fingerprint``): a module-level constant read on the build
         path (the functions reachable from the callers of the keying
         function) but not reached by the fingerprint's arguments.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .context import ModuleContext, QualnameVisitor, last_name
from .findings import Finding

#: substrings that mark an assignment target as an op dispatch table
_DISPATCH_HINTS = ("control", "dispatch", "handler", "handlers", "ops")
#: metric family names the package owns (docs drift only audits these;
#: fixtures use other prefixes so they never depend on repo docs)
_ZOO_NAME_RE = re.compile(r"^zoo_[a-z0-9_]+$")
#: docs mention of a family: zoo_x_{a,b}_total name alternation and/or
#: a trailing {label,...} block (lookbehind: `analytics_zoo_tpu` must
#: not read as a mention of `zoo_tpu`)
_DOC_TOKEN_RE = re.compile(
    r"(?<![A-Za-z0-9_])zoo_[a-z0-9_{},]*[a-z0-9_}]")
#: the docs the drift audits read: the JAX package's files (shared: the
#: port keeps their family and variable names) and the port's own doc,
#: which holds the port-only names
_METRIC_DOCS = ("docs/observability.md", "docs/dev/zoolint_torch.md")
_ENV_DOCS = ("docs/serving.md", "docs/distributed-training.md",
             "docs/dev/zoolint_torch.md")
#: label keys a declaring module must not stamp
_LABEL_BANNED = {
    "rank": "the pod aggregator stamps rank on every scraped family — "
            "a module-level rank label double-labels after aggregation",
    "model_name": "the model label convention is 'model'",
    "model_id": "the model label convention is 'model'",
}
#: constructor calls that mark an attribute as runtime state, never
#: key material (ZL821 candidates exclude them)
_STATEFUL_CTORS = {"Lock", "RLock", "Condition", "Event", "Semaphore",
                   "BoundedSemaphore", "Queue", "LifoQueue",
                   "PriorityQueue", "Thread", "deque", "defaultdict",
                   "OrderedDict", "WeakValueDictionary"}
#: attr-name fragments exempt from ZL821: locks/threads are state, and
#: ``*tag*`` is the store-metadata convention (rides the entry header
#: for accounting, deliberately never part of the key — execstore's
#: ``--by-model`` contract)
_EXEMPT_ATTR_HINTS = ("lock", "cond", "thread", "queue", "tag")
#: module-constant name fragments exempt from the module form: where a
#: build lands is not what it computes
_EXEMPT_CONST_HINTS = _EXEMPT_ATTR_HINTS + ("root", "dir", "log")

_ENV_ACCESSORS = ("env_str", "env_int", "env_flag")


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _read_text(root: Optional[str], rel: str) -> Optional[str]:
    if root is None:
        return None
    p = os.path.join(root, rel)
    try:
        with open(p, "r", encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def _line_of(text: str, needle: str) -> int:
    for i, line in enumerate(text.splitlines(), start=1):
        if needle in line:
            return i
    return 1


# ===================================================== contract index
class _Site:
    __slots__ = ("path", "line", "col", "symbol")

    def __init__(self, path, line, col, symbol):
        self.path, self.line, self.col = path, line, col
        self.symbol = symbol


class _MetricDecl:
    __slots__ = ("name", "mtype", "label_sets", "site")

    def __init__(self, name, mtype, label_sets, site):
        self.name, self.mtype = name, mtype
        self.label_sets: List[frozenset] = label_sets
        self.site: _Site = site


class _ErrorClass:
    __slots__ = ("name", "bases", "own_http_status", "init_node", "site")

    def __init__(self, name, bases, own_http_status, init_node, site):
        self.name, self.bases = name, bases
        self.own_http_status = own_http_status
        self.init_node = init_node
        self.site = site


class _ModuleScan(QualnameVisitor):
    """One walk per module collecting every contract surface."""

    def __init__(self, ctx: ModuleContext):
        super().__init__(ctx)
        self.sent_ops: List[Tuple[str, _Site]] = []
        self.handled_ops: List[Tuple[str, _Site]] = []
        self.codec_fns: Dict[str, ast.AST] = {}      # top-level defs
        self.error_classes: List[_ErrorClass] = []
        self.error_registries: List[Tuple[Dict[str, _Site], _Site]] = []
        self.metric_decls: List[_MetricDecl] = []
        self.metric_patterns: List[Tuple[str, str]] = []
        self.env_reads: List[Tuple[ast.AST, _Site]] = []  # key node
        self.env_accessor_calls: List[Tuple[ast.AST, _Site]] = []
        # `op == "x"` compares count as handlers only in functions
        # that bind op FROM AN ENVELOPE (op = req.get("op") /
        # req["op"]) — a TF-graph converter comparing node.op names
        # is not a wire handler
        self._op_compares: List[Tuple[str, str, _Site]] = []
        self._envelope_fns: Set[str] = set()
        self.str_consts: Dict[str, str] = {}          # module level
        self.vars_table: Optional[Dict[str, _Site]] = None
        self.vars_descs: Dict[str, str] = {}
        self._collect_top_level()
        self.visit(ctx.tree)
        for qn, op, site in self._op_compares:
            if qn in self._envelope_fns:
                self.handled_ops.append((op, site))

    @staticmethod
    def _is_op_lookup(value: ast.AST) -> bool:
        """req.get("op") or req["op"] — the envelope-dispatch marker."""
        if isinstance(value, ast.Call) \
                and isinstance(value.func, ast.Attribute) \
                and value.func.attr == "get" and value.args:
            return _str_const(value.args[0]) == "op"
        if isinstance(value, ast.Subscript):
            return _str_const(value.slice) == "op"
        return False

    # ---- helpers -------------------------------------------------
    def _site(self, node: ast.AST) -> _Site:
        return _Site(self.ctx.path, node.lineno, node.col_offset,
                     self.qualname)

    def _collect_top_level(self):
        for st in self.ctx.tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.codec_fns[st.name] = st
            elif isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                v = _str_const(st.value)
                if v is not None:
                    self.str_consts[st.targets[0].id] = v

    def _is_environ(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Attribute)
                and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id == "os")

    # ---- collection ----------------------------------------------
    def visit_Dict(self, node: ast.Dict):
        keys = [_str_const(k) if k is not None else None
                for k in node.keys]
        # sent op: a request envelope literal {"op": "<name>", ...}
        for k, v in zip(node.keys, node.values):
            if _str_const(k) == "op":
                op = _str_const(v)
                if op is not None:
                    self.sent_ops.append((op, self._site(node)))
        # registry_families idiom: {"zoo_x": [...], ...} — every key a
        # metric name (or zoo_-prefixed f-string), every value a list
        if node.keys and all(
                (k is not None
                 and (_str_const(k) is not None
                      or isinstance(k, ast.JoinedStr)))
                for k in node.keys) \
                and all(isinstance(v, ast.List) for v in node.values) \
                and any(s is not None and _ZOO_NAME_RE.match(s)
                        for s in keys):
            for k in node.keys:
                s = _str_const(k)
                if s is not None and _ZOO_NAME_RE.match(s):
                    self.metric_decls.append(_MetricDecl(
                        s, None, [], self._site(k)))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        if any(isinstance(t, ast.Name) and t.id == "op"
               for t in node.targets) and self._is_op_lookup(node.value):
            self._envelope_fns.add(self.qualname)
        for t in node.targets:
            tname = (last_name(t) or "").lower()
            if isinstance(node.value, ast.Dict):
                # op dispatch table: {"op-name": handler, ...}
                if any(h in tname for h in _DISPATCH_HINTS) \
                        and node.value.keys and all(
                            _str_const(k) is not None
                            for k in node.value.keys) \
                        and all(isinstance(v, (ast.Name, ast.Attribute))
                                for v in node.value.values):
                    for k in node.value.keys:
                        self.handled_ops.append(
                            (_str_const(k), self._site(k)))
                # error-class wire registry: {"Code": ClassRef, ...}
                if "error_classes" in tname \
                        and node.value.keys and all(
                            _str_const(k) is not None
                            for k in node.value.keys):
                    table = {_str_const(k): self._site(k)
                             for k in node.value.keys}
                    self.error_registries.append(
                        (table, self._site(node)))
                # the env contract table itself
                if isinstance(t, ast.Name) and t.id == "VARS" \
                        and self.ctx.path.endswith("envcontract.py"):
                    self._record_vars(node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        # VARS: Dict[str, str] = {...} — the annotated form
        if isinstance(node.target, ast.Name) \
                and node.target.id == "VARS" \
                and isinstance(node.value, ast.Dict) \
                and self.ctx.path.endswith("envcontract.py"):
            self._record_vars(node.value)
        self.generic_visit(node)

    def _record_vars(self, d: ast.Dict):
        self.vars_table = {
            _str_const(k): self._site(k)
            for k in d.keys if _str_const(k) is not None}
        self.vars_descs = {
            _str_const(k): (_str_const(v) or "")
            for k, v in zip(d.keys, d.values)
            if _str_const(k) is not None}

    def visit_Compare(self, node: ast.Compare):
        # handled op: `op == "x"` / `op in ("a", "b")` (a != / not-in
        # guard rejects an op, it does not handle one)
        if isinstance(node.left, ast.Name) and node.left.id == "op" \
                and len(node.ops) == 1:
            if isinstance(node.ops[0], ast.Eq):
                s = _str_const(node.comparators[0])
                if s is not None:
                    self._op_compares.append(
                        (self.qualname, s, self._site(node)))
            elif isinstance(node.ops[0], ast.In) \
                    and isinstance(node.comparators[0],
                                   (ast.Tuple, ast.List, ast.Set)):
                for e in node.comparators[0].elts:
                    s = _str_const(e)
                    if s is not None:
                        self._op_compares.append(
                            (self.qualname, s, self._site(node)))
        # env membership: "ZOO_X" in os.environ
        if len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                and self._is_environ(node.comparators[0]):
            self.env_reads.append((node.left, self._site(node)))
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef):
        bases = [last_name(b) for b in node.bases]
        bases = [b for b in bases if b]
        own_status = any(
            isinstance(st, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "http_status"
                    for t in st.targets)
            for st in node.body)
        init = next((st for st in node.body
                     if isinstance(st, ast.FunctionDef)
                     and st.name == "__init__"), None)
        self.error_classes.append(_ErrorClass(
            node.name, bases, own_status, init, self._site(node)))
        super().visit_ClassDef(node)

    def visit_Call(self, node: ast.Call):
        fn = last_name(node.func)
        # metric family declarations
        if fn == "Family" and len(node.args) >= 2:
            mtype = _str_const(node.args[0])
            name = _str_const(node.args[1])
            if name is not None and mtype is not None:
                self.metric_decls.append(_MetricDecl(
                    name, mtype, self._label_sets(node),
                    self._site(node)))
            elif isinstance(node.args[1], ast.JoinedStr):
                self._pattern(node.args[1])
        elif fn == "summary_family" and node.args:
            name = _str_const(node.args[0])
            if name is not None:
                self.metric_decls.append(_MetricDecl(
                    name, "summary", [], self._site(node)))
            elif isinstance(node.args[0], ast.JoinedStr):
                self._pattern(node.args[0])
        # env reads: os.environ.get/.pop("ZOO_X")
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("get", "pop") \
                and self._is_environ(node.func.value) and node.args:
            self.env_reads.append((node.args[0], self._site(node)))
        # envcontract accessor calls (declared-name audit)
        if fn in _ENV_ACCESSORS and node.args:
            self.env_accessor_calls.append(
                (node.args[0], self._site(node)))
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript):
        if self._is_environ(node.value) \
                and isinstance(getattr(node, "ctx", None), ast.Load):
            self.env_reads.append((node.slice, self._site(node)))
        self.generic_visit(node)

    def visit_JoinedStr(self, node: ast.JoinedStr):
        self._pattern(node)
        self.generic_visit(node)

    def _pattern(self, node: ast.JoinedStr):
        """(prefix, suffix) of a zoo_-prefixed f-string metric name —
        the docs-drift tolerance for families named per-key in a loop
        (``f"zoo_execstore_{k}_total"``)."""
        if not node.values:
            return
        prefix = _str_const(node.values[0])
        if prefix is None or not prefix.startswith("zoo_"):
            return
        suffix = _str_const(node.values[-1]) \
            if len(node.values) > 1 else ""
        self.metric_patterns.append((prefix, suffix or ""))

    def _label_sets(self, call: ast.Call) -> List[frozenset]:
        """Label key sets of one literal Family declaration: every
        all-str-key dict literal inside the samples argument (list
        comprehensions included — ast.walk descends)."""
        out: List[frozenset] = []
        for sub in call.args[2:] + [kw.value for kw in call.keywords]:
            for n in ast.walk(sub):
                if isinstance(n, ast.Dict) and n.keys and all(
                        _str_const(k) is not None for k in n.keys):
                    out.append(frozenset(
                        _str_const(k) for k in n.keys))
        return out


class ContractIndex:
    """Every cross-module contract surface, built once per lint run."""

    def __init__(self, ctxs: Sequence[ModuleContext]):
        self.scans: List[_ModuleScan] = [_ModuleScan(c) for c in ctxs]
        # module-level ZOO_-valued constants, project-wide: the
        # Attribute form of an env read (``flightrec.ENV_DIR``)
        # resolves through this map when the name is unambiguous
        self.zoo_constants: Dict[str, Set[str]] = {}
        for sc in self.scans:
            for name, val in sc.str_consts.items():
                if val.startswith("ZOO_"):
                    self.zoo_constants.setdefault(name, set()).add(val)
        self.env_vars: Optional[Dict[str, _Site]] = None
        self.env_descs: Dict[str, str] = {}
        self.envcontract_path: Optional[str] = None
        for sc in self.scans:
            if sc.vars_table is not None:
                self.env_vars = sc.vars_table
                self.env_descs = sc.vars_descs
                self.envcontract_path = sc.ctx.path
        # op tables (first site wins for reporting)
        self.sent_ops: Dict[str, _Site] = {}
        self.handled_ops: Dict[str, _Site] = {}
        for sc in self.scans:
            for op, site in sc.sent_ops:
                self.sent_ops.setdefault(op, site)
            for op, site in sc.handled_ops:
                self.handled_ops.setdefault(op, site)
        # metric families, merged by name
        self.metric_decls: Dict[str, List[_MetricDecl]] = {}
        self.metric_patterns: List[Tuple[str, str]] = []
        for sc in self.scans:
            for d in sc.metric_decls:
                self.metric_decls.setdefault(d.name, []).append(d)
            self.metric_patterns.extend(sc.metric_patterns)

    def resolve_env_name(self, sc: _ModuleScan,
                         node: ast.AST) -> Optional[str]:
        """The concrete env-var name of a read's key expression:
        string literal, module-level constant, or a cross-module
        ``mod.ENV_X`` attribute when exactly one module declares it."""
        s = _str_const(node)
        if s is not None:
            return s
        if isinstance(node, ast.Name):
            return sc.str_consts.get(node.id)
        if isinstance(node, ast.Attribute):
            vals = self.zoo_constants.get(node.attr, set())
            if len(vals) == 1:
                return next(iter(vals))
        return None

    # ---- snapshot ------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The committed-contract rendering (``zoolint contracts``):
        pure data, deterministically ordered, diffable in review."""
        errors: Dict[str, int] = {}
        for name, status in self._error_statuses().items():
            if status is not None:
                errors[name] = status
        metrics: Dict[str, Dict[str, Any]] = {}
        for name, decls in sorted(self.metric_decls.items()):
            mtype = next((d.mtype for d in decls
                          if d.mtype is not None), None)
            labels: Set[str] = set()
            for d in decls:
                for ls in d.label_sets:
                    labels |= ls
            metrics[name] = {"type": mtype or "unknown",
                             "labels": sorted(labels)}
        return {
            "ops": {"sent": sorted(self.sent_ops),
                    "handled": sorted(self.handled_ops)},
            "errors": dict(sorted(errors.items())),
            "env": {name: self.env_descs.get(name, "")
                    for name in sorted(self.env_vars or ())},
            "metrics": metrics,
        }

    def _error_statuses(self) -> Dict[str, Optional[int]]:
        """class name -> effective http_status through the in-index
        base chain (None when unreachable)."""
        classes: Dict[str, _ErrorClass] = {}
        for sc in self.scans:
            for ec in sc.error_classes:
                classes.setdefault(ec.name, ec)

        own: Dict[str, Optional[int]] = {}
        for sc in self.scans:
            for ec in sc.error_classes:
                if ec.own_http_status:
                    own.setdefault(ec.name, self._status_value(sc, ec))

        def status(name: str, seen: Set[str]) -> Optional[int]:
            if name in seen or name not in classes:
                return None
            seen.add(name)
            if name in own:
                return own[name]
            for b in classes[name].bases:
                s = status(b, seen)
                if s is not None:
                    return s
            return None

        out: Dict[str, Optional[int]] = {}
        for name, ec in classes.items():
            if self._is_serving_error(name, classes):
                out[name] = status(name, set())
        return out

    @staticmethod
    def _is_serving_error(name: str,
                          classes: Dict[str, _ErrorClass]) -> bool:
        seen: Set[str] = set()
        stack = [name]
        while stack:
            n = stack.pop()
            if n == "ServingError":
                return True
            if n in seen or n not in classes:
                continue
            seen.add(n)
            stack.extend(classes[n].bases)
        return False

    def _status_value(self, sc: _ModuleScan,
                      ec: _ErrorClass) -> Optional[int]:
        # re-find the class node to read the literal status value
        for node in ast.walk(sc.ctx.tree):
            if isinstance(node, ast.ClassDef) and node.name == ec.name:
                for st in node.body:
                    if isinstance(st, ast.Assign) and any(
                            isinstance(t, ast.Name)
                            and t.id == "http_status"
                            for t in st.targets) \
                            and isinstance(st.value, ast.Constant) \
                            and isinstance(st.value.value, int):
                        return st.value.value
        return None


# ========================================================== ZL801
def rule_wire_ops(index: ContractIndex) -> List[Finding]:
    findings: List[Finding] = []
    sent, handled = index.sent_ops, index.handled_ops
    # coverage runs only when the linted set contains BOTH sides of
    # the protocol — linting the router alone must not condemn every
    # send for lacking a handler it cannot see
    if sent and handled:
        for op in sorted(set(sent) - set(handled)):
            s = sent[op]
            findings.append(Finding(
                "ZL801", s.path, s.line, s.col, s.symbol,
                f"wire op {op!r} is sent but no dispatch-table entry "
                "or `op == ...` handler exists anywhere in the linted "
                "set — the worker replies with an unknown-op error on "
                "the first real call"))
        for op in sorted(set(handled) - set(sent)):
            s = handled[op]
            findings.append(Finding(
                "ZL801", s.path, s.line, s.col, s.symbol,
                f"wire op {op!r} has a handler but nothing ever sends "
                "it — dead protocol surface: either wire up the "
                "caller or delete the handler before it rots"))
    # encode_X/decode_X key symmetry, per module
    for sc in index.scans:
        for name, fn in sorted(sc.codec_fns.items()):
            if not name.startswith("decode_"):
                continue
            enc = sc.codec_fns.get("encode_" + name[len("decode_"):])
            if enc is None:
                continue
            written = _written_keys(enc, sc.codec_fns)
            read = _read_keys(fn, sc.codec_fns)
            if not written or not read:
                continue  # opaque codec (no literal keys on one side)
            missing = sorted(read - written)
            if missing:
                findings.append(Finding(
                    "ZL801", sc.ctx.path, fn.lineno, fn.col_offset,
                    name,
                    f"{name}() reads key(s) {missing} that its paired "
                    f"encoder never writes — a KeyError on the first "
                    "frame a real peer produces"))
    return findings


def _written_keys(fn: ast.AST,
                  module_fns: Dict[str, ast.AST]) -> Set[str]:
    """String dict keys an encoder produces, following one level of
    module-local helper calls (``encode_binary`` delegates its header
    layout to ``_binary_parts``)."""
    out: Set[str] = set()
    for body in _with_called_bodies(fn, module_fns):
        for n in ast.walk(body):
            if isinstance(n, ast.Dict):
                for k in n.keys:
                    s = _str_const(k) if k is not None else None
                    if s is not None:
                        out.add(s)
            elif isinstance(n, ast.Subscript) \
                    and isinstance(getattr(n, "ctx", None), ast.Store):
                s = _str_const(n.slice)
                if s is not None:
                    out.add(s)
    return out


def _read_keys(fn: ast.AST,
               module_fns: Dict[str, ast.AST]) -> Set[str]:
    out: Set[str] = set()
    for body in _with_called_bodies(fn, module_fns):
        for n in ast.walk(body):
            if isinstance(n, ast.Subscript) \
                    and isinstance(getattr(n, "ctx", None), ast.Load):
                s = _str_const(n.slice)
                if s is not None:
                    out.add(s)
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("get", "pop") and n.args:
                s = _str_const(n.args[0])
                if s is not None:
                    out.add(s)
            elif isinstance(n, ast.Compare) and len(n.ops) == 1 \
                    and isinstance(n.ops[0], (ast.In, ast.NotIn)):
                s = _str_const(n.left)
                if s is not None:
                    out.add(s)
    return out


def _with_called_bodies(fn: ast.AST,
                        module_fns: Dict[str, ast.AST]
                        ) -> List[ast.AST]:
    bodies = [fn]
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in module_fns \
                and module_fns[n.func.id] is not fn:
            bodies.append(module_fns[n.func.id])
    return bodies


# ========================================================== ZL802
def rule_error_envelope(index: ContractIndex) -> List[Finding]:
    findings: List[Finding] = []
    classes: Dict[str, List[Tuple[_ModuleScan, _ErrorClass]]] = {}
    by_name: Dict[str, _ErrorClass] = {}
    for sc in index.scans:
        for ec in sc.error_classes:
            classes.setdefault(ec.name, []).append((sc, ec))
            by_name.setdefault(ec.name, ec)
    serving = {name for name in classes
               if ContractIndex._is_serving_error(name, by_name)}
    if not serving:
        return findings
    registries = [table for sc in index.scans
                  for table, _ in sc.error_registries]
    registered: Set[str] = set()
    for table in registries:
        registered |= set(table)
    statuses = index._error_statuses()
    for name in sorted(serving):
        decls = classes[name]
        # code collision: ``code`` IS the class name on the wire —
        # two definitions decode to whichever one the registry holds
        if len(decls) > 1:
            for sc, ec in decls:
                findings.append(Finding(
                    "ZL802", ec.site.path, ec.site.line, ec.site.col,
                    name,
                    f"error class {name} is defined in more than one "
                    "module: the wire code is the class name, so the "
                    "registry can only round-trip one of them — "
                    "rename or consolidate"))
        sc, ec = decls[0]
        if registries and name not in registered:
            findings.append(Finding(
                "ZL802", ec.site.path, ec.site.line, ec.site.col, name,
                f"ServingError subclass {name} is missing from the "
                "wire error registry (_ERROR_CLASSES): it decodes as "
                "the bare base class — wrong http_status and wrong "
                "retry semantics on the client"))
        if statuses.get(name) is None:
            findings.append(Finding(
                "ZL802", ec.site.path, ec.site.line, ec.site.col, name,
                f"error class {name} has no reachable http_status "
                "(own or inherited within the linted set) — a web "
                "frontend cannot map it without string-matching"))
        if ec.init_node is not None:
            bad = _init_cannot_roundtrip(ec.init_node)
            if bad:
                findings.append(Finding(
                    "ZL802", ec.site.path, ec.init_node.lineno,
                    ec.init_node.col_offset, name,
                    f"{name}.__init__ cannot be called as "
                    f"cls(message, **details) ({bad}) — decode_error "
                    "raises TypeError instead of the reconstructed "
                    "exception"))
    return findings


def _init_cannot_roundtrip(init: ast.FunctionDef) -> Optional[str]:
    a = init.args
    if a.kwarg is None:
        return "no **kwargs to absorb arbitrary detail fields"
    positional = a.posonlyargs + a.args
    required = len(positional) - len(a.defaults)
    if required > 2:  # self + message
        names = [p.arg for p in positional[2:required]]
        return f"required positional parameter(s) {names} beyond message"
    return None


# ========================================================== ZL811
def rule_metrics_schema(index: ContractIndex,
                        root: Optional[str]) -> List[Finding]:
    findings: List[Finding] = []
    for name, decls in sorted(index.metric_decls.items()):
        types = {d.mtype for d in decls if d.mtype is not None}
        if len(types) > 1:
            for d in decls:
                if d.mtype is not None:
                    findings.append(Finding(
                        "ZL811", d.site.path, d.site.line, d.site.col,
                        d.site.symbol,
                        f"metric family {name!r} declared as "
                        f"{d.mtype!r} here but also as "
                        f"{sorted(types - {d.mtype})} elsewhere — one "
                        "name, one type, or the aggregator merges "
                        "apples into oranges"))
        if name.endswith("_total"):
            for d in decls:
                if d.mtype not in (None, "counter"):
                    findings.append(Finding(
                        "ZL811", d.site.path, d.site.line, d.site.col,
                        d.site.symbol,
                        f"{name!r} is declared as a {d.mtype} — the "
                        "*_total suffix promises a monotonic counter "
                        "to every PromQL rate() over it"))
        label_sets = {ls for d in decls for ls in d.label_sets if ls}
        if len(label_sets) > 1:
            d = decls[-1]
            findings.append(Finding(
                "ZL811", d.site.path, d.site.line, d.site.col,
                d.site.symbol,
                f"metric family {name!r} is declared with conflicting "
                f"label sets {sorted(sorted(ls) for ls in label_sets)}"
                " — series of one family must share one label schema"))
        for d in decls:
            for ls in d.label_sets:
                for key in sorted(ls & set(_LABEL_BANNED)):
                    findings.append(Finding(
                        "ZL811", d.site.path, d.site.line, d.site.col,
                        d.site.symbol,
                        f"label key {key!r} on {name!r}: "
                        f"{_LABEL_BANNED[key]}"))
    findings.extend(_docs_drift(index, root))
    return findings


def _expand_doc_tokens(text: str) -> Set[str]:
    """Every concrete family name the docs mention.

    Two brace idioms coexist in the docs: a MID-name group is
    alternation (``zoo_x_{a,b}_total`` -> zoo_x_a_total,
    zoo_x_b_total) and a TERMINAL (or unclosed, e.g. truncated at a
    ``=``) group is a Prometheus label block
    (``zoo_shed_total{model,class}``) — the name stops before it."""
    out: Set[str] = set()
    for tok in _DOC_TOKEN_RE.findall(text):
        variants = [""]
        i = 0
        while i < len(tok):
            c = tok[i]
            if c == "{":
                j = tok.find("}", i)
                if j < 0 or j == len(tok) - 1:
                    break  # label block: the family name is complete
                parts = tok[i + 1:j].split(",")
                variants = [v + p for v in variants for p in parts]
                i = j + 1
            else:
                variants = [v + c for v in variants]
                i += 1
        for v in variants:
            if _ZOO_NAME_RE.match(v):
                out.add(v)
    return out


def _docs_text(root: Optional[str], rels) -> Optional[str]:
    """The docs files' texts joined, None when none exists."""
    texts = [t for t in (_read_text(root, r) for r in rels)
             if t is not None]
    return "\n".join(texts) if texts else None


#: the heading of the port doc's section naming the shared docs'
#: families the port does not emit (each with its reason)
_NOT_EMITTED = "families the port does not emit"


def _not_emitted(text: Optional[str]) -> Set[str]:
    """Family names listed under the port doc's :data:`_NOT_EMITTED`
    heading (up to the next heading)."""
    out: Set[str] = set()
    if not text:
        return out
    inside = False
    for line in text.splitlines():
        if line.startswith("#"):
            inside = _NOT_EMITTED in line.lower()
        elif inside:
            out |= _expand_doc_tokens(line)
    return out


def _docs_drift(index: ContractIndex,
                root: Optional[str]) -> List[Finding]:
    findings: List[Finding] = []
    doc_rel = " / ".join(_METRIC_DOCS)
    text = _docs_text(root, _METRIC_DOCS)
    exempt = _not_emitted(_read_text(root, _METRIC_DOCS[-1]))
    zoo_decls = {n: ds for n, ds in index.metric_decls.items()
                 if _ZOO_NAME_RE.match(n)}
    # both directions gate on the docs existing AND the linted set
    # actually declaring zoo_ families — a fixture linted alone (or a
    # docs-less checkout) must not fabricate drift
    if text is None or not zoo_decls:
        return findings
    documented = _expand_doc_tokens(text)
    for name, decls in sorted(zoo_decls.items()):
        if name in documented or name in text:
            continue
        d = decls[0]
        findings.append(Finding(
            "ZL811", d.site.path, d.site.line, d.site.col,
            d.site.symbol,
            f"metric family {name!r} is emitted here but absent from "
            f"{doc_rel} — every family is part of the operator "
            "contract; add its table row"))
    emitted = set(index.metric_decls)
    summaries = {n for n, ds in index.metric_decls.items()
                 if any(d.mtype == "summary" for d in ds)}
    for tok in sorted(documented):
        if tok in emitted or tok in exempt:
            continue
        if any(tok == s + suf for s in summaries
               for suf in ("_sum", "_count")):
            continue  # summary families render _sum/_count series
        if any(tok.startswith(p) and tok.endswith(s)
               and len(tok) > len(p) + len(s)
               for p, s in index.metric_patterns):
            continue  # per-key f-string family (zoo_execstore_*_total)
        where = next((r for r in _METRIC_DOCS
                      if tok in (_read_text(root, r) or "")),
                     _METRIC_DOCS[0])
        findings.append(Finding(
            "ZL811", where, _line_of(_read_text(root, where) or "", tok),
            0, "<docs>",
            f"{doc_rel} documents metric family {tok!r} but nothing "
            "in the linted set declares it — stale docs row (or a "
            "family that silently vanished in a refactor)"))
    return findings


# ========================================================== ZL812
def rule_env_contract(index: ContractIndex,
                      root: Optional[str]) -> List[Finding]:
    findings: List[Finding] = []
    for sc in index.scans:
        if sc.ctx.path.endswith("envcontract.py"):
            continue  # the contract module's own reads are the point
        for keynode, site in sc.env_reads:
            name = index.resolve_env_name(sc, keynode)
            if name is not None and name.startswith("ZOO_"):
                findings.append(Finding(
                    "ZL812", site.path, site.line, site.col,
                    site.symbol,
                    f"os.environ read of {name!r} outside the central "
                    "envcontract module — route it through "
                    "envcontract.env_str/env_int/env_flag so the knob "
                    "is declared, documented, and snapshot-diffed"))
    if index.env_vars is not None:
        declared = set(index.env_vars)
        for sc in index.scans:
            for keynode, site in sc.env_accessor_calls:
                name = index.resolve_env_name(sc, keynode)
                if name is not None and name.startswith("ZOO_") \
                        and name not in declared:
                    findings.append(Finding(
                        "ZL812", site.path, site.line, site.col,
                        site.symbol,
                        f"envcontract accessor called with {name!r} "
                        "which VARS never declares — the call raises "
                        "KeyError at runtime; add the table entry"))
        docs = [(rel, _read_text(root, rel)) for rel in _ENV_DOCS]
        texts = [t for _, t in docs if t is not None]
        if texts:
            for name in sorted(declared):
                if not any(name in t for t in texts):
                    site = index.env_vars[name]
                    findings.append(Finding(
                        "ZL812", site.path, site.line, site.col,
                        "VARS",
                        f"declared env var {name!r} appears in no "
                        f"docs env table ({' / '.join(_ENV_DOCS)}) — "
                        "an undocumented knob is an unusable knob"))
    return findings


# ========================================================== ZL821
def rule_fingerprint_drift(ctxs: Sequence[ModuleContext]
                           ) -> List[Finding]:
    findings: List[Finding] = []
    for ctx in ctxs:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(_class_fp_drift(ctx, node))
        findings.extend(_module_fp_drift(ctx))
    return findings


def _self_attr(n: ast.AST) -> Optional[str]:
    if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
            and n.value.id == "self":
        return n.attr
    return None


def _self_call_names(expr: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            a = _self_attr(n.func)
            if a is not None:
                out.add(a)
    return out


def _local_flow(fn: ast.AST) -> Dict[str, Set[str]]:
    """local name -> self-attr names its value (transitively) derives
    from; a few fixpoint passes stand in for real ordering."""
    deps: Dict[str, Set[str]] = {}

    def refs(expr: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for n in ast.walk(expr):
            a = _self_attr(n)
            if a is not None:
                out.add(a)
            elif isinstance(n, ast.Name) and n.id in deps:
                out |= deps[n.id]
        return out

    for _ in range(3):
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign):
                r = refs(n.value)
                for t in n.targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name):
                            deps[leaf.id] = deps.get(leaf.id,
                                                     set()) | r
            elif isinstance(n, ast.AugAssign) \
                    and isinstance(n.target, ast.Name):
                deps[n.target.id] = deps.get(n.target.id,
                                             set()) | refs(n.value)
    return deps


def _attrs_reached(expr: ast.AST, flow: Dict[str, Set[str]],
                   methods: Dict[str, ast.AST],
                   visited: Set[str]) -> Set[str]:
    """self-attrs an expression's value derives from: direct reads,
    locals (via ``flow``), and the full bodies of self-methods it
    calls (transitively — ``self._fp_parts()`` folds whatever the
    override reads)."""
    out: Set[str] = set()
    for n in ast.walk(expr):
        a = _self_attr(n)
        if a is not None:
            out.add(a)
        elif isinstance(n, ast.Name) and n.id in flow:
            out |= flow[n.id]
    for m in _self_call_names(expr):
        out |= _method_attr_closure(m, methods, visited)
    return out


def _method_attr_closure(name: str, methods: Dict[str, ast.AST],
                         visited: Set[str]) -> Set[str]:
    if name in visited or name not in methods:
        return set()
    visited.add(name)
    fn = methods[name]
    out: Set[str] = set()
    for n in ast.walk(fn):
        a = _self_attr(n)
        if a is not None:
            out.add(a)
    for m in _self_call_names(fn):
        out |= _method_attr_closure(m, methods, visited)
    return out


def _class_fp_drift(ctx: ModuleContext,
                    cls: ast.ClassDef) -> List[Finding]:
    methods: Dict[str, ast.AST] = {
        st.name: st for st in cls.body
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef))}
    # the fingerprinting method(s): whoever calls *.fingerprint(...)
    fp_calls: List[Tuple[str, ast.Call]] = []
    for mname, fn in methods.items():
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "fingerprint":
                fp_calls.append((mname, n))
    if not fp_calls:
        return []
    init = methods.get("__init__")
    if init is None:
        return []

    # ---- candidates: __init__ config attrs derived from ctor params
    params = {a.arg for a in init.args.args
              + init.args.posonlyargs + init.args.kwonlyargs
              if a.arg != "self"}
    init_flow = _param_flow(init, params)
    candidates: Dict[str, ast.AST] = {}      # attr -> RHS expr
    attr_rhs: Dict[str, ast.AST] = {}
    lineage: Dict[str, Set[str]] = {}        # attr -> ctor params
    for n in ast.walk(init):
        if isinstance(n, ast.Assign) and len(n.targets) >= 1:
            for t in n.targets:
                a = _self_attr(t)
                if a is None:
                    continue
                attr_rhs.setdefault(a, n.value)
                lin: Set[str] = set()
                for leaf in ast.walk(n.value):
                    if isinstance(leaf, ast.Name):
                        lin |= init_flow.get(leaf.id, set())
                lineage[a] = lineage.get(a, set()) | lin
                if any(h in a.lower() for h in _EXEMPT_ATTR_HINTS):
                    continue
                if isinstance(n.value, ast.Call) \
                        and last_name(n.value.func) in _STATEFUL_CTORS:
                    continue
                if lin:
                    candidates.setdefault(a, n.value)
    if not candidates:
        return []

    # ---- folded: attrs whose value reaches the fingerprint args
    folded: Set[str] = set()
    receivers: Set[str] = set()
    for mname, call in fp_calls:
        flow = _local_flow(methods[mname])
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            folded |= _attrs_reached(arg, flow, methods, set())
        receivers |= _attrs_reached(call.func.value, flow, methods,
                                    set())
    # __init__-RHS closure: a folded derived attr folds whatever its
    # construction read (``_wdigest = digest(placed)`` folds the
    # weights; ``_jit = self._make_jit(...)`` folds ``_fn``)
    changed = True
    while changed:
        changed = False
        for a in sorted(folded):
            rhs = attr_rhs.get(a)
            if rhs is None:
                continue
            more = _attrs_reached(rhs, _local_flow(init), methods,
                                  set())
            if not more <= folded:
                folded |= more
                changed = True
    # shared-lineage exemption: when a folded attr is DERIVED from the
    # same ctor params as a candidate, the candidate's value is already
    # keyed by proxy — the fold-the-canonical-digest idiom
    # (``_mesh_cfg = canonical(spec); _mesh_spec = spec`` folds the
    # digest, which covers the spec)
    folded_lineage: Set[str] = set()
    for a in folded:
        folded_lineage |= lineage.get(a, set())
    for a, lin in lineage.items():
        if lin and lin <= folded_lineage:
            folded.add(a)

    # ---- compile-reachable closure from the fingerprint method(s)
    reach: Set[str] = set()
    stack = [m for m, _ in fp_calls]
    while stack:
        m = stack.pop()
        if m in reach or m not in methods:
            continue
        reach.add(m)
        stack.extend(_self_call_names(methods[m]))

    findings: List[Finding] = []
    reported: Set[str] = set()
    for mname in sorted(reach):
        fn = methods[mname]
        flow = _local_flow(fn)
        service = _service_attrs(fn, flow)
        parents = {child: parent for parent in ast.walk(fn)
                   for child in ast.iter_child_nodes(parent)}
        for n in ast.walk(fn):
            a = _self_attr(n)
            if a is None or a in reported:
                continue
            if a not in candidates or a in folded or a in receivers \
                    or a in service:
                continue
            if not isinstance(getattr(n, "ctx", None), ast.Load):
                continue
            par = parents.get(n)
            if isinstance(par, ast.Attribute) or (
                    isinstance(par, ast.Call) and par.func is n):
                continue  # self.attr.method(...): a service, not a key
            reported.add(a)
            findings.append(Finding(
                "ZL821", ctx.path, n.lineno, n.col_offset,
                f"{cls.name}.{mname}",
                f"config attribute self.{a} (constructor-derived) is "
                "read on the compile-reachable path but never folded "
                "into the store fingerprint — two deploys differing "
                "only in this knob share a key, and the second one "
                "serves the first one's STALE build; add it to "
                "the fingerprint extras (_fp_parts or the fingerprint "
                "call)"))
    return findings


def _module_consts(ctx: ModuleContext) -> Dict[str, ast.AST]:
    """Module-level names bound once by a plain assignment to
    configuration: a literal (strings, numbers, and lists, tuples, sets,
    dicts and arithmetic of them) whose every name is itself such a
    constant — flags and versions, not services, paths or ctypes types —
    less the exempt name fragments."""
    binds: Dict[str, ast.AST] = {}
    seen: Set[str] = set()
    for st in ctx.tree.body:
        targets = (st.targets if isinstance(st, ast.Assign) else
                   [st.target] if isinstance(st, ast.AnnAssign)
                   and st.value is not None else [])
        for t in targets:
            if isinstance(t, ast.Name):
                if t.id in seen:
                    binds.pop(t.id, None)
                else:
                    seen.add(t.id)
                    binds[t.id] = st.value
    literal = (ast.Constant, ast.List, ast.Tuple, ast.Set, ast.Dict,
               ast.BinOp, ast.UnaryOp, ast.JoinedStr, ast.FormattedValue,
               ast.Name, ast.Load, ast.Starred, ast.operator,
               ast.unaryop)
    out: Dict[str, ast.AST] = {}
    changed = True
    while changed:
        changed = False
        for name, v in binds.items():
            if name in out or any(h in name.lower()
                                  for h in _EXEMPT_CONST_HINTS):
                continue
            nodes = list(ast.walk(v))
            if all(isinstance(n, literal) for n in nodes) and all(
                    n.id in out for n in nodes
                    if isinstance(n, ast.Name)):
                out[name] = v
                changed = True
    return out


def _module_fp_drift(ctx: ModuleContext) -> List[Finding]:
    """ZL821's module form (module doc)."""
    if ".fingerprint(" not in ctx.source:
        return []
    funcs: Dict[str, ast.AST] = {}
    methods: List[Tuple[str, ast.AST]] = []
    for st in ctx.tree.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs[st.name] = st
            methods.append((st.name, st))
        elif isinstance(st, ast.ClassDef):
            for m in st.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods.append((f"{st.name}.{m.name}", m))
    keyers: Dict[str, List[ast.Call]] = {}
    for name, fn in funcs.items():
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "fingerprint":
                keyers.setdefault(name, []).append(n)
    if not keyers:
        return []
    consts = _module_consts(ctx)
    if not consts:
        return []

    def called(fn) -> Set[str]:
        return {n.func.id for n in ast.walk(fn)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in funcs}

    def names_closure(exprs, seen: Set[str]) -> Set[str]:
        out: Set[str] = set()
        for e in exprs:
            for n in ast.walk(e):
                if isinstance(n, ast.Name) and n.id in consts:
                    out.add(n.id)
            for f in called(e):
                if f not in seen:
                    seen.add(f)
                    out |= names_closure([funcs[f]], seen)
        return out

    folded: Set[str] = set()
    for calls in keyers.values():
        for call in calls:
            folded |= names_closure(
                list(call.args) + [kw.value for kw in call.keywords],
                set(keyers))
    roots = [(q, m) for q, m in methods
             if q not in keyers and called(m) & set(keyers)]
    reach: Dict[str, ast.AST] = {}
    stack = list(roots)
    while stack:
        q, m = stack.pop()
        if q in reach:
            continue
        reach[q] = m
        for f in called(m):
            if f not in keyers:
                stack.append((f, funcs[f]))
    findings: List[Finding] = []
    reported: Set[str] = set()
    for q in sorted(reach):
        fn = reach[q]
        parents = {child: parent for parent in ast.walk(fn)
                   for child in ast.iter_child_nodes(parent)}
        for n in ast.walk(fn):
            if not (isinstance(n, ast.Name) and n.id in consts
                    and isinstance(n.ctx, ast.Load)):
                continue
            if n.id in folded or n.id in reported:
                continue
            par = parents.get(n)
            if isinstance(par, ast.Attribute) or (
                    isinstance(par, ast.Call) and par.func is n):
                continue  # CONST.method(...): a service, not a key
            reported.add(n.id)
            findings.append(Finding(
                "ZL821", ctx.path, n.lineno, n.col_offset, q,
                f"module constant {n.id} is read on the build path but "
                "never reaches the store fingerprint's arguments — two "
                "builds differing only in it share a key, and the store "
                "serves the first one's STALE build; fold it (or a hash "
                "of it) into the keying function's fingerprint call"))
    return findings


def _param_flow(init: ast.AST, params: Set[str]) -> Dict[str, Set[str]]:
    """local -> ctor params it derives from (inside __init__)."""
    deps: Dict[str, Set[str]] = {p: {p} for p in params}
    for _ in range(3):
        for n in ast.walk(init):
            if isinstance(n, ast.Assign):
                refs: Set[str] = set()
                for leaf in ast.walk(n.value):
                    if isinstance(leaf, ast.Name) and leaf.id in deps:
                        refs |= deps[leaf.id]
                for t in n.targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name) \
                                and leaf.id not in params:
                            deps[leaf.id] = deps.get(leaf.id,
                                                     set()) | refs
    return deps


def _param_refs(expr: ast.AST, params: Set[str],
                flow: Dict[str, Set[str]]) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and flow.get(n.id):
            return True
    return False


def _service_attrs(fn: ast.AST, flow: Dict[str, Set[str]]) -> Set[str]:
    """Attrs read only to be USED as an object (receiver of a method
    call, directly or through a local) — services, not key material."""
    out: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute):
            recv = n.func.value
            a = _self_attr(recv)
            if a is not None:
                out.add(a)
            elif isinstance(recv, ast.Name) and recv.id in flow:
                out |= flow[recv.id]
    return out


# ===================================================== engine entry
def rule_contracts(ctxs: Sequence[ModuleContext],
                   root: Optional[str] = None,
                   index: Optional[ContractIndex] = None
                   ) -> List[Finding]:
    """All five ZL8xx families off one shared index (engine hook)."""
    if index is None:
        index = ContractIndex(ctxs)
    findings: List[Finding] = []
    findings.extend(rule_wire_ops(index))
    findings.extend(rule_error_envelope(index))
    findings.extend(rule_metrics_schema(index, root))
    findings.extend(rule_env_contract(index, root))
    findings.extend(rule_fingerprint_drift(ctxs))
    return findings
