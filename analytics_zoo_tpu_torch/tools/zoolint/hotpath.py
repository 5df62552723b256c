"""Hot-path rules (project-wide, call-graph based).

  ZL301  a host sync reachable from a serving hot entry point:
         ``torch.cuda.synchronize()``, a stream's ``.synchronize()``,
         ``.item()`` / ``.tolist()`` / ``.cpu()`` on a tensor, or an
         item assignment of a Python number into a tensor attribute
         (``self.t[i] = n``) — a forced wait on the request path
         serializes dispatch against compute (and raises under the
         sanitizer's sync guard).  The
         sanctioned fetch is a non-blocking copy into pinned host
         memory and an ``Event.synchronize()``, which this rule leaves
         alone.
  ZL302  implicit device→host materialization in a hot function:
         ``np.asarray`` / ``np.array`` / ``float()`` / ``.numpy()``
         wrapped DIRECTLY around a dispatch call
         (``np.asarray(self._fn(x))``) — fetch explicitly (pinned
         non-blocking copy + event) so guards and readers see it.
  ZL601  bare ``print(...)`` / stdlib ``logging`` call in a hot
         function: free-text output from the request path cannot be
         joined back to the request that produced it (and ``print``
         grabs a global interpreter I/O lock mid-dispatch).  The
         sanctioned path is the structured logger
         (``analytics_zoo_tpu_torch.observability.log.get_logger``),
         whose records carry the current request id.

The call graph is name-based and deliberately over-approximate: an edge
``f -> g`` exists when f's body calls anything whose final name is g
(``self._cache.run`` reaches every ``run`` in the package).  That
over-approximation errs toward marking code hot, which is the right
direction for a lint — the baseline absorbs the justified hits.

Hot entry points are matched by FINAL name so the rule follows renames
and new implementations (an entry spelled ``Class.method`` matches that
qualname only, for a final name too common to take whole, such as
``__call__``).  The JAX package's entries carry over where the port
kept the function's name; each is listed with why it is hot.  Where the
port's counterpart has another name, the port's name stands in its
place (said at the entry), and the entries only the port has close the
tuple.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .context import (ModuleContext, QualnameVisitor, entry_keys,
                      last_name, tensor_attrs)
from .findings import Finding

DEFAULT_HOT_ENTRIES = ("predict", "predict_ex", "_loop", "submit",
                       "dispatch_padded", "dispatch", "pack",
                       "tick", "_resolve_hedged", "maybe_reprobe",
                       "_loop_inner", "_admit_slot",
                       # the persistent store: the read-through consult
                       # under a build miss, and the port's counterpart
                       # of the JAX package's ``rehydrate`` (bytes back
                       # into a loaded kernel library, the path a warm
                       # process serves from)
                       "lookup", "_from_store",
                       # fault-tolerant training: the launcher's
                       # supervision poll loop and the per-step worker
                       # heartbeat both sit on latency-critical paths
                       # (detection latency / the training step)
                       "_supervise", "heartbeat",
                       # cross-process observability: the flight
                       # recorder's framed append runs once per
                       # training step (and per finished span), and
                       # the aggregator merge loop runs per pod scrape
                       # — a stray sync or free-text log in either
                       # taxes every step / every scrape
                       "_append", "merge_snapshots",
                       # fleet serving: the router's routed data path
                       # (pick + wire call + retry-on-sibling) and the
                       # worker's per-connection request/reply loop
                       # both run once per fleet request
                       "_route_call", "_serve_conn",
                       # decode engine v2: the prefix-pool admission
                       # (the port's counterpart of ``_prefix_lookup``)
                       # runs once per pool-eligible admission, and the
                       # window's host fan-out (the port's
                       # ``_process_step`` serves the step, fused and
                       # speculative windows alike; the JAX package's
                       # ``_process_spec``) once per dispatch — a stray
                       # sync or free-text log in either taxes every
                       # admission / window
                       "_admit_prefix", "_process_step",
                       # weight pager (serving density): the cold-
                       # request fault-in and the demotion path — both
                       # sit between an admitted request and its first
                       # byte of service, so a stray host sync or
                       # free-text log there stalls every caller
                       # queued on the same fault
                       "fault_in", "_try_evict",
                       # fleet v2 binary wire: the out-of-band payload
                       # encode/decode runs once per negotiated
                       # predict/generate frame in BOTH directions —
                       # the whole point is shaving per-hop copies, so
                       # a stray materialization or free-text log here
                       # pays twice per request
                       "encode_binary", "decode_binary",
                       # sharded serving: the group-atomic placement
                       # check (gates every paged install) and the
                       # span labeler (stamped on every dispatch) run
                       # on the request path — a stray sync or free-
                       # text log in either taxes every sharded
                       # request
                       "placement_complete", "span_labels",
                       # distributed tracing: the worker-side reply
                       # piggyback builder runs once per TRACED serve
                       # reply and the router-side inline stitch once
                       # per traced response — both sit inside the
                       # traced/untraced throughput-ratio gate, so a
                       # stray sync or free-text log in either is
                       # exactly the overhead the gate bounds
                       "reply_trace", "nest_summary",
                       # training: the step body and its per-microbatch
                       # loss (the port's counterpart of ``micro_step``;
                       # a host sync or print there lands INSIDE the
                       # training hot loop), plus the microbatch split
                       # that runs once per step between h2d and the
                       # step (the port's ``_split``; the JAX package's
                       # ``_split_microbatches``)
                       "train_step", "forward_loss", "_split",
                       # port only: the decode plan's call replays the
                       # captured graph and starts the pinned fetch once
                       # per decode dispatch (a final name too common to
                       # take whole, hence the qualname), and the
                       # dispatcher's plan pick and launch runs as often
                       # — a sync in either stalls every live stream
                       "_Plan.__call__", "_dispatch_step")
# callees whose result is a device value mid-flight: materializing their
# return implicitly is the ZL302 pattern
_DISPATCHY = {"predict_fn", "dispatch_padded"}
_MATERIALIZERS = {"numpy.asarray", "numpy.array"}
# tensor methods that copy device values to the host and wait for them
_SYNC_METHODS = {"item", "tolist", "cpu"}
# calls whose result is a host (numpy) value: ``.tolist()``/``.item()``
# on it is host work, not a sync
_HOST_RESULT_PREFIX = "numpy."


def _is_dispatchy(name: str) -> bool:
    return (name in _DISPATCHY or name.endswith("_fn")
            or name.startswith("dispatch"))


class _DefCollector(QualnameVisitor):
    """(qualname -> {called final names}) for one module."""

    def __init__(self, ctx: ModuleContext):
        super().__init__(ctx)
        self.defs: Dict[str, ast.AST] = {}

    def _visit_func(self, node):
        self.func_stack.append(node.name)
        self.defs.setdefault(self.qualname, node)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def _callees(fd: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fd):
        if isinstance(node, ast.Call):
            name = last_name(node.func)
            if name:
                out.add(name)
    return out


def _host_names(fd: ast.AST, ctx: ModuleContext) -> Set[str]:
    """Locals bound to a host value in ``fd``: a ``numpy.*`` call, a
    ``.numpy()`` view, a string-keyed subscript (a frame's column), or a
    subscript/attribute of such a local."""
    out: Set[str] = set()
    for _ in range(2):
        for n in ast.walk(fd):
            if isinstance(n, ast.Assign) and _is_host_expr(n.value, ctx,
                                                           out):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _is_host_expr(node: ast.AST, ctx: ModuleContext,
                  host: Set[str]) -> bool:
    while isinstance(node, (ast.Subscript, ast.Attribute)) and not (
            isinstance(node, ast.Attribute) and node.attr == "numpy"):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str):
            return True  # a frame's column / a dict of host arrays
        node = node.value
    if isinstance(node, ast.Name):
        return node.id in host
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "numpy":
            return True
        r = ctx.resolve(node.func) or ""
        return r.startswith(_HOST_RESULT_PREFIX)
    return False


def _sync_kind(node: ast.Call, ctx: ModuleContext,
               host: Set[str]) -> str:
    """What host sync a call is ("" when none): ``torch.cuda.
    synchronize()``, a stream's ``synchronize()``, or ``.item()`` /
    ``.tolist()`` / ``.cpu()`` on a (possibly) tensor receiver.  An
    event's ``synchronize()`` is the sanctioned explicit fetch."""
    f = node.func
    if not isinstance(f, (ast.Attribute, ast.Name)):
        return ""
    resolved = ctx.resolve(f) or ""
    if resolved == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if not isinstance(f, ast.Attribute):
        return ""
    recv = f.value
    if f.attr == "synchronize":
        rname = (last_name(recv.func) if isinstance(recv, ast.Call)
                 else last_name(recv)) or ""
        if "stream" in rname.lower():
            return "Stream.synchronize()"
        return ""
    if f.attr in _SYNC_METHODS and not node.args and \
            not _is_host_expr(recv, ctx, host):
        return f".{f.attr}()"
    return ""


_HOST_VALUE_NODES = (ast.Constant, ast.Name, ast.Attribute, ast.BinOp,
                     ast.UnaryOp, ast.BoolOp, ast.IfExp, ast.Compare,
                     ast.Load, ast.operator, ast.unaryop, ast.boolop,
                     ast.cmpop)


def _scalar_store(node: ast.AST, cls: str,
                  tensors: Set[Tuple[str, str]]) -> str:
    """``self.t[i] = n`` with ``t`` a tensor attribute of ``cls`` and ``n``
    a host value (names, numbers, attributes and arithmetic of them, no
    call or subscript): an item assignment that copies a host scalar up
    and waits.  Returns the target's text, or ""."""
    if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
        return ""
    t = node.targets[0]
    if not (isinstance(t, ast.Subscript)
            and isinstance(t.value, ast.Attribute)
            and isinstance(t.value.value, ast.Name)
            and t.value.value.id == "self"
            and (cls, t.value.attr) in tensors):
        return ""
    if all(isinstance(n, _HOST_VALUE_NODES) for n in ast.walk(node.value)):
        return f"self.{t.value.attr}[...] = <host value>"
    return ""


def collect_hot_defs(ctxs: List[ModuleContext],
                     hot_entries: Tuple[str, ...] = DEFAULT_HOT_ENTRIES):
    """The shared project pass: every def keyed by (path, qualname),
    the set of hot-reachable keys (name-based BFS from the entry
    points), and a path -> ModuleContext map.  Used by every hot-path
    rule (ZL3xx, ZL601)."""
    # 1. collect every def in the project, keyed by (path, qualname)
    defs: Dict[Tuple[str, str], ast.AST] = {}
    by_final: Dict[str, List[Tuple[str, str]]] = {}
    ctx_of: Dict[str, ModuleContext] = {}
    for ctx in ctxs:
        ctx_of[ctx.path] = ctx
        col = _DefCollector(ctx)
        col.visit(ctx.tree)
        for qual, fd in col.defs.items():
            key = (ctx.path, qual)
            defs[key] = fd
            by_final.setdefault(qual.rsplit(".", 1)[-1], []).append(key)

    # 2. BFS from the entry points over name-resolved call edges
    hot: Set[Tuple[str, str]] = set()
    frontier = [k for name in hot_entries
                for k in entry_keys(name, by_final)]
    hot.update(frontier)
    while frontier:
        key = frontier.pop()
        for callee in _callees(defs[key]):
            for nxt in by_final.get(callee, []):
                if nxt not in hot:
                    hot.add(nxt)
                    frontier.append(nxt)
    return defs, hot, ctx_of


def rule_hot_path(ctxs: List[ModuleContext],
                  hot_entries: Tuple[str, ...] = DEFAULT_HOT_ENTRIES,
                  hot_defs=None) -> List[Finding]:
    """``hot_defs``: the precomputed ``collect_hot_defs`` triple — the
    engine computes it once and shares it with every hot-path rule;
    standalone callers may omit it."""
    defs, hot, ctx_of = (hot_defs if hot_defs is not None
                         else collect_hot_defs(ctxs, hot_entries))

    # flag sync / implicit-materialize sites inside hot defs
    findings: List[Finding] = []
    tensors: Dict[str, Set[Tuple[str, str]]] = {}
    for (path, qual) in sorted(hot):
        fd = defs[(path, qual)]
        ctx = ctx_of[path]
        host = _host_names(fd, ctx)
        cls = qual.split(".")[-2] if "." in qual else ""
        if cls and path not in tensors:
            tensors[path] = tensor_attrs(ctx)
        for node in ast.walk(fd):
            store = cls and _scalar_store(node, cls, tensors[path])
            if store:
                findings.append(Finding(
                    "ZL301", path, node.lineno, node.col_offset, qual,
                    f"host sync {store} on the serving hot path: an item "
                    "assignment of a Python number copies a host scalar "
                    "to the device and waits — fill_ the element on the "
                    "device instead (t[i].fill_(n))"))
                continue
            if not isinstance(node, ast.Call):
                continue
            kind = _sync_kind(node, ctx, host)
            if kind:
                findings.append(Finding(
                    "ZL301", path, node.lineno, node.col_offset, qual,
                    f"host sync {kind} on the serving hot path "
                    f"(reachable from {'/'.join(hot_entries)}): a forced "
                    "wait serializes dispatch against compute and raises "
                    "under the sync guard — copy into pinned host memory "
                    "non-blocking and wait on an Event, or baseline with "
                    "a justification if the sync is the point (e.g. "
                    "build-time measurement)"))
                continue
            resolved = ctx.resolve(node.func)
            wraps_dispatch = (
                node.args and isinstance(node.args[0], ast.Call)
                and (lambda n: n is not None and _is_dispatchy(n))(
                    last_name(node.args[0].func)))
            numpy_view = (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "numpy"
                and isinstance(node.func.value, ast.Call)
                and (lambda n: n is not None and _is_dispatchy(n))(
                    last_name(node.func.value.func)))
            if numpy_view or (wraps_dispatch and (
                    resolved in _MATERIALIZERS
                    or (isinstance(node.func, ast.Name)
                        and node.func.id == "float"))):
                findings.append(Finding(
                    "ZL302", path, node.lineno, node.col_offset, qual,
                    "implicit device->host materialization of a "
                    "dispatch result on the hot path — fetch it "
                    "explicitly (a non-blocking copy into pinned host "
                    "memory and an Event.synchronize(): explicit "
                    "fetches pass the sync guard, implicit ones abort "
                    "it)"))
    return findings


_LOG_METHODS = {"debug", "info", "warning", "warn", "error",
                "exception", "critical", "log"}


def _stdlib_logger_names(ctx: ModuleContext) -> Set[str]:
    """Local names bound to ``logging.getLogger(...)`` results — both
    ``log = logging.getLogger(...)`` and ``self._log = ...`` (matched
    by final attribute name)."""
    names: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and ctx.resolve(node.value.func) == "logging.getLogger"):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
            elif isinstance(t, ast.Attribute):
                names.add(t.attr)
    return names


def _is_stdlib_log_call(ctx: ModuleContext, node: ast.Call,
                        logger_names: Set[str]) -> bool:
    func = node.func
    resolved = ctx.resolve(func)
    # logging.info(...) / logging.getLogger("x").info(...)
    if resolved is not None and resolved.startswith("logging."):
        return resolved.rsplit(".", 1)[-1] in _LOG_METHODS
    if not (isinstance(func, ast.Attribute)
            and func.attr in _LOG_METHODS):
        return False
    recv = func.value
    if isinstance(recv, ast.Call) and \
            ctx.resolve(recv.func) == "logging.getLogger":
        return True  # logging.getLogger(...).warning(...)
    if isinstance(recv, ast.Name):
        return recv.id in logger_names
    if isinstance(recv, ast.Attribute):
        return recv.attr in logger_names  # self._log.info(...)
    return False


def rule_hot_logging(ctxs: List[ModuleContext],
                     hot_entries: Tuple[str, ...] = DEFAULT_HOT_ENTRIES,
                     hot_defs=None) -> List[Finding]:
    """ZL601: bare print / stdlib logging inside hot-reachable
    functions.  The structured logger
    (``analytics_zoo_tpu_torch.observability.log.get_logger``) is exempt by
    construction: its instances are not created via
    ``logging.getLogger`` in the flagged module, and its records carry
    the current request id — which is the point."""
    defs, hot, ctx_of = (hot_defs if hot_defs is not None
                         else collect_hot_defs(ctxs, hot_entries))
    logger_names = {ctx.path: _stdlib_logger_names(ctx) for ctx in ctxs}
    findings: List[Finding] = []
    for (path, qual) in sorted(hot):
        fd = defs[(path, qual)]
        ctx = ctx_of[path]
        for node in ast.walk(fd):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and \
                    node.func.id == "print":
                findings.append(Finding(
                    "ZL601", path, node.lineno, node.col_offset, qual,
                    "print() on the serving hot path (reachable from "
                    f"{'/'.join(hot_entries)}): free-text output "
                    "cannot be joined back to its request and takes a "
                    "global I/O lock mid-dispatch — use the "
                    "structured logger (analytics_zoo_tpu_torch."
                    "observability.log.get_logger), whose records "
                    "carry the request id; baseline with a "
                    "justification if the output IS the tool's UI"))
            elif _is_stdlib_log_call(ctx, node, logger_names[path]):
                findings.append(Finding(
                    "ZL601", path, node.lineno, node.col_offset, qual,
                    "stdlib logging call on the serving hot path — "
                    "free-text records drop the request id.  Use the "
                    "structured logger (analytics_zoo_tpu_torch."
                    "observability.log.get_logger) so the record "
                    "carries request_id and joins the trace; baseline "
                    "with a justification for intentional module-level "
                    "diagnostics"))
    return findings
