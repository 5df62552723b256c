"""The rule catalog behind ``zoolint --explain ZLxxx``.

One entry per live rule code: the rationale (WHY the pattern costs), a
minimal bad/good example pair (kept in sync with the fixtures in
``tests/torch_zoolint_fixtures/`` — those are the executable versions),
and the docs anchor.  ``--explain`` is the on-call path: a CI failure
prints a code, and the fix should be one terminal command away.

:data:`FATES` gives every code of the JAX package's zoolint its fate in
the port — kept, re-aimed at torch, or retired — with the reason, and
names the codes only the port has.
"""

from __future__ import annotations

from typing import Dict, Optional

_DOC = "docs/dev/zoolint_torch.md"

_FAMILY_ANCHORS = {
    "1": "#zl1xx--recapture-hazards",
    "2": "#zl2xx--capture-hazards-inside-a-cuda-graph-body",
    "3": "#zl3xx--host-sync-on-the-serving-hot-path-project-wide",
    "4": "#zl4xx--lock-discipline",
    "5": "#zl5xx--thread-lifecycle",
    "6": "#zl6xx--observability-discipline-hot-path-call-graph-based",
    "7": "#zl7xx--exception-path-dataflow-rules",
    "8": "#zl8xx--distributed-contract-rules",
}

#: code -> (fate, reason) for every code of the JAX package's zoolint,
#: plus the port's own ("new")
FATES: Dict[str, tuple] = {
    "ZL101": ("re-aimed", "jax.jit in a loop becomes a CUDAGraph built "
              "in a loop: a capture is the port's compile"),
    "ZL102": ("re-aimed", "the immediately-invoked jit becomes a graph "
              "captured and replayed within one call (or an immediately-"
              "invoked make_graphed_callables)"),
    "ZL103": ("retired", "no torch counterpart: nothing in the port keys "
              "a compile cache on hashed static arguments — a CUDA graph "
              "is captured on tensors, and a Python value read at "
              "capture is ZL205's case"),
    "ZL201": ("re-aimed", "a host cast inside jit becomes a host cast "
              "inside a captured body"),
    "ZL202": ("re-aimed", "a branch on a tracer becomes a branch on a "
              "tensor inside a captured body"),
    "ZL203": ("re-aimed", "np.asarray/.item()/.tolist() inside jit "
              "become .item()/.tolist()/.cpu()/.numpy() inside a captured "
              "body"),
    "ZL204": ("new", "a fresh host tensor copied to the device inside a "
              "captured body (no JAX counterpart: jit arguments are "
              "placed by the caller)"),
    "ZL205": ("new", "a Python value read at capture and rebound "
              "between replays (a jit retraces on a changed static "
              "value; a graph silently keeps the old one)"),
    "ZL301": ("re-aimed", "block_until_ready becomes torch.cuda."
              "synchronize, a stream's synchronize, .item(), .tolist(), "
              ".cpu() and t[i] = <Python number> on the hot path"),
    "ZL302": ("re-aimed", "np.asarray/np.array/float() around a dispatch "
              "keep their intent; .numpy() on a dispatch result joins "
              "them; the fix is a pinned non-blocking copy and an event"),
    "ZL401": ("kept", "lock discipline is language-level"),
    "ZL402": ("re-aimed", "jax's blocking calls (block_until_ready, "
              "device_get) become torch's (synchronize, .item(), "
              ".tolist(), .cpu()); warmup, fetch_rows, dispatch_padded "
              "and predict stay"),
    "ZL501": ("kept", "thread lifecycle is language-level"),
    "ZL502": ("kept", "queue bounds are language-level"),
    "ZL601": ("kept", "the structured logger is the port's own "
              "observability.log.get_logger"),
    "ZL701": ("kept", "exception-path resource balance is "
              "language-level"),
    "ZL702": ("kept", "exception-path counter balance is "
              "language-level"),
    "ZL711": ("retired", "no torch counterpart: the port donates no "
              "buffers (torch has no donate_argnums; the decode engine "
              "writes its slot state in place), so no argument can be "
              "read after it was given away"),
    "ZL721": ("kept", "check-then-deref is language-level"),
    "ZL731": ("kept", "lock order is language-level"),
    "ZL801": ("kept", "pointed at the port's fleet protocol "
              "(serving/fleet/protocol.py, router.py, worker.py)"),
    "ZL802": ("kept", "pointed at the port's serving/errors.py and the "
              "protocol's error registry"),
    "ZL811": ("kept", "pointed at the port's zoo_* families; the docs "
              "audit reads docs/observability.md plus the port's own "
              "doc, docs/dev/zoolint_torch.md"),
    "ZL812": ("kept", "pointed at the port's envcontract.py; the docs "
              "audit reads docs/serving.md, docs/distributed-training.md "
              "plus docs/dev/zoolint_torch.md"),
    "ZL821": ("kept", "pointed at the store fingerprint of the port's "
              "kernel libraries (common/execstore.py)"),
}

CATALOG: Dict[str, Dict[str, str]] = {
    "ZL101": {
        "title": "torch.cuda.CUDAGraph built inside a loop",
        "rationale": "Each iteration captures afresh: one capture (the "
                     "port's compile) per iteration, forever.  Build "
                     "the graph once, keep it, and replay it.",
        "bad": "for x in xs:\n    g = torch.cuda.CUDAGraph()\n"
               "    with torch.cuda.graph(g):\n        step(x)\n"
               "    g.replay()",
        "good": "g = torch.cuda.CUDAGraph()\nwith torch.cuda.graph(g):\n"
                "    step(buf)\nfor x in xs:\n    buf.copy_(x)\n"
                "    g.replay()",
    },
    "ZL102": {
        "title": "graph captured and replayed within one call",
        "rationale": "A graph built, captured and replayed inside one "
                     "call and never kept pays a capture per call.  "
                     "Capture once (store the graph), replay many.",
        "bad": "def run(self, x):\n    g = torch.cuda.CUDAGraph()\n"
               "    with torch.cuda.graph(g):\n        self.step()\n"
               "    g.replay()",
        "good": "def build(self):\n    self.g = torch.cuda.CUDAGraph()\n"
                "    with torch.cuda.graph(self.g):\n        self.step()\n"
                "def run(self, x):\n    self.g.replay()",
    },
    "ZL201": {
        "title": "host cast of a tensor inside a captured body",
        "rationale": "float()/int()/bool() on a tensor syncs the "
                     "device (illegal while capturing) and freezes the "
                     "number seen at capture into every replay.  Keep "
                     "it a tensor (torch.where, clamp) or hoist it.",
        "bad": "def _step_body(self, x):\n    return x * float(x.max())",
        "good": "def _step_body(self, x):\n    return x * x.max()",
    },
    "ZL202": {
        "title": "Python branch on a tensor inside a captured body",
        "rationale": "The branch taken at capture is the only one every "
                     "replay runs.  Use torch.where, or decide on the "
                     "host before capturing.  Shape/dtype/len()/size() "
                     "tests are host metadata and exempt.",
        "bad": "def _step_body(self, x):\n    if x.sum() > 0:\n"
               "        x.mul_(2)",
        "good": "def _step_body(self, x):\n"
                "    x.copy_(torch.where(x.sum() > 0, x * 2, x))",
    },
    "ZL203": {
        "title": "host materialization inside a captured body",
        "rationale": ".item()/.tolist()/.cpu()/.numpy() sync at capture "
                     "and never run at replay.  Replay the graph, then "
                     "copy its outputs into pinned host memory "
                     "non-blocking and wait on an event.",
        "bad": "def _step_body(self):\n    self.last = self._tok.cpu()",
        "good": "def _step_body(self):\n    self._out.copy_(self._tok)\n"
                "# after replay: host.copy_(self._out, non_blocking=True)",
    },
    "ZL204": {
        "title": "fresh host tensor copied into a captured body",
        "rationale": "The graph records the address of the host buffer "
                     "behind torch.tensor(..., device=...) or "
                     "from_numpy(a).cuda(); it is freed before the first "
                     "replay.  Make the device tensor once, outside the "
                     "body, and copy_ into it.",
        "bad": "def _step_body(self):\n"
               "    self._pos.add_(torch.tensor([1], device='cuda'))",
        "good": "def _step_body(self):\n    self._pos.add_(self._one)",
    },
    "ZL205": {
        "title": "Python value frozen at capture",
        "rationale": "A self attribute read inside a captured body and "
                     "rebound elsewhere keeps, in every replay, the "
                     "value (or storage) seen at capture.  Keep it a "
                     "device tensor written in place (copy_/fill_), or "
                     "recapture when it changes.",
        "bad": "def set_scale(self, s):\n    self.scale = s\n"
               "def _step_body(self):\n    self._x.mul_(self.scale)",
        "good": "def set_scale(self, s):\n    self._scale.fill_(s)\n"
                "def _step_body(self):\n    self._x.mul_(self._scale)",
    },
    "ZL301": {
        "title": "host sync on the serving hot path",
        "rationale": "torch.cuda.synchronize, a stream's synchronize, "
                     ".item(), .tolist(), .cpu() and an item assignment "
                     "of a Python number into a tensor (t[i] = n) wait "
                     "for the device "
                     "on the request path, serializing dispatch against "
                     "compute (and raise under the sanitizer's sync "
                     "guard).  Copy into pinned host memory "
                     "non-blocking and wait on an Event; baseline with "
                     "a justification when the sync IS the point "
                     "(build-time measurement).",
        "bad": "def predict(self, x):\n    return self._fn(x).cpu()",
        "good": "def predict(self, x):\n"
                "    h = self._fn(x).to('cpu', non_blocking=True)\n"
                "    ev = torch.cuda.Event()\n    ev.record()\n"
                "    ev.synchronize()\n    return h",
    },
    "ZL302": {
        "title": "implicit device->host materialization on the hot path",
        "rationale": "np.asarray()/float()/.numpy() wrapped straight "
                     "around a dispatch makes the transfer invisible to "
                     "the sync guard and readers.  Fetch explicitly.",
        "bad": "rows = np.asarray(self.dispatch_padded(batch))",
        "good": "rows = fetch_rows(self.dispatch_padded(batch), n)",
    },
    "ZL401": {
        "title": "attribute written with AND without its owning lock",
        "rationale": "The lock held at the majority of write sites is "
                     "the owner; a site missing it is a torn/lost "
                     "update one preemption away.  __init__ writes "
                     "are exempt (no concurrent reader exists yet).",
        "bad": "with self._lock:\n    self.n += 1\n...\nself.n = 0",
        "good": "with self._lock:\n    self.n += 1\n...\n"
                "with self._lock:\n    self.n = 0",
    },
    "ZL402": {
        "title": "blocking device work under a held lock",
        "rationale": "synchronize/.item()/.cpu()/warmup/predict under "
                     "a lock makes every thread contending that lock "
                     "wait on device latency.  Move the dispatch "
                     "outside the critical section.",
        "bad": "with self._lock:\n    out = self._model.predict(x)",
        "good": "with self._lock:\n    model = self._model\n"
                "out = model.predict(x)",
    },
    "ZL501": {
        "title": "non-daemon thread never joined",
        "rationale": "It outlives its owner, pins interpreter exit, "
                     "and strands work on crash.  Pass daemon=True or "
                     "join it in this module.",
        "bad": "threading.Thread(target=loop).start()",
        "good": "threading.Thread(target=loop, daemon=True).start()",
    },
    "ZL502": {
        "title": "unbounded queue.Queue",
        "rationale": "Under overload an unbounded queue converts "
                     "memory into latency instead of shedding — "
                     "request N succeeds seconds too late.  Pass "
                     "maxsize (see serving/admission.py).",
        "bad": "self._q = queue.Queue()",
        "good": "self._q = queue.Queue(maxsize=1024)",
    },
    "ZL601": {
        "title": "print/stdlib logging on the serving hot path",
        "rationale": "Free-text output cannot be joined back to the "
                     "request that produced it, and print takes a "
                     "global I/O lock mid-dispatch.  Use the "
                     "structured logger (observability.log."
                     "get_logger) — its records carry the request id.",
        "bad": "def predict(self, x):\n    print('serving', x.shape)",
        "good": "_slog = get_logger('zoo.serve')\n"
                "def predict(self, x):\n"
                "    _slog.info('serving', shape=x.shape)",
    },
    "ZL701": {
        "title": "acquire() not released on an exception path",
        "rationale": "A resource acquired with recv.acquire() must be "
                     "released on EVERY path out of the function, "
                     "including the unwind: an exception escaping "
                     "between acquire and release leaks the slot "
                     "forever (the caller cannot know it was taken).  "
                     "Returning while holding is allowed — that is "
                     "ownership transfer, and the caller can see it.",
        "bad": "self._sem.acquire()\ntry:\n    return work()\n"
               "finally:\n    pass  # release deleted -> leak",
        "good": "self._sem.acquire()\ntry:\n    return work()\n"
                "finally:\n    self._sem.release()",
    },
    "ZL702": {
        "title": "counter increment not balanced on an exception path",
        "rationale": "A tracked counter (one the module both += and "
                     "-= somewhere: in-flight counts, queue seats, "
                     "slot occupancy) incremented and then leaked on "
                     "an exception exit shrinks capacity one "
                     "exception at a time — the admission _acquire "
                     "KeyboardInterrupt seat leak.  Balance it in an "
                     "except-BaseException unwind before re-raising "
                     "(or hand it to a helper that decrements it).",
        "bad": "self._waiting += 1\nwhile not ready():\n"
               "    if lapsed():\n        raise Timeout()  # seat leaks",
        "good": "self._waiting += 1\ntry:\n    while not ready():\n"
                "        if lapsed():\n            raise Timeout()\n"
                "except BaseException:\n    self._waiting -= 1\n"
                "    raise",
    },
    "ZL721": {
        "title": "check-then-deref of a shared attribute",
        "rationale": "A None/truthiness check on a shared mutable "
                     "attribute followed by a RE-READ of the same "
                     "attribute races every concurrent writer: the "
                     "attribute can be nulled between the check and "
                     "the deref.  Snapshot into a local and check "
                     "THAT (autoscaler_for reading entry.active "
                     "twice was this bug).",
        "bad": "if entry.active is not None:\n"
               "    return entry.active.version  # may be None now",
        "good": "dep = entry.active\nif dep is not None:\n"
                "    return dep.version",
    },
    "ZL731": {
        "title": "lock-order cycle",
        "rationale": "Two locks acquired in opposite orders at "
                     "different sites deadlock the first time two "
                     "threads interleave the acquisitions under "
                     "load.  Pick one global order (or merge the "
                     "locks).  RLock self-re-entry is exempt.",
        "bad": "def a(self):\n    with self._lock:\n"
               "        with self._cond: ...\n"
               "def b(self):\n    with self._cond:\n"
               "        with self._lock: ...",
        "good": "def a(self):\n    with self._lock:\n"
                "        with self._cond: ...\n"
                "def b(self):\n    with self._lock:\n"
                "        with self._cond: ...",
    },
    "ZL801": {
        "title": "wire op without a peer (or asymmetric codec keys)",
        "rationale": "The router's send sites and the worker's "
                     "dispatch table are the two halves of one "
                     "protocol, usually edited in different files.  "
                     "An op sent with no handler is an unknown-op "
                     "error on the first real call; a handler nothing "
                     "sends is dead surface that rots unseen; a "
                     "decode_X reading a key its encode_X never "
                     "writes is a KeyError on the first real frame.",
        "bad": "conn.send({\"op\": \"flush\", \"id\": rid})\n"
               "# worker: self._control = {\"predict\": ...}  # no flush",
        "good": "conn.send({\"op\": \"flush\", \"id\": rid})\n"
                "# worker: self._control = {\"predict\": ...,\n"
                "#                          \"flush\": self._flush}",
    },
    "ZL802": {
        "title": "error class that cannot round-trip the wire",
        "rationale": "decode_error rebuilds worker exceptions from "
                     "the registry keyed by class name.  A "
                     "ServingError subclass missing from it decodes "
                     "as the bare base — wrong http_status, wrong "
                     "isinstance retry class on the client.  Same "
                     "for a duplicate class name (one wire code, two "
                     "meanings), a missing http_status, or an "
                     "__init__ that cannot absorb cls(msg, **details).",
        "bad": "class WorkerUnavailable(ServingError):\n"
               "    http_status = 503\n"
               "_ERROR_CLASSES = {\"Overloaded\": Overloaded}",
        "good": "_ERROR_CLASSES = {\"Overloaded\": Overloaded,\n"
                "    \"WorkerUnavailable\": WorkerUnavailable}",
    },
    "ZL811": {
        "title": "metric family schema conflict or docs drift",
        "rationale": "The pod aggregator and every dashboard key on "
                     "family name, type, and label schema — a name "
                     "declared as counter here and gauge there "
                     "merges apples into oranges; a *_total gauge "
                     "breaks every rate(); a rank label collides "
                     "with the aggregator's own stamping; a family "
                     "absent from docs/observability.md and "
                     "docs/dev/zoolint_torch.md (or documented but "
                     "never emitted) is operator-contract drift.",
        "bad": "Family(\"counter\", \"fx_requests_total\", \"..\")\n"
               "# elsewhere:\n"
               "Family(\"gauge\", \"fx_requests_total\", \"..\")",
        "good": "Family(\"counter\", \"fx_requests_total\", \"..\")\n"
                "# one name, one type, everywhere",
    },
    "ZL812": {
        "title": "ZOO_* env read outside the env contract",
        "rationale": "A knob read wherever os.environ is handy has "
                     "no declaration, no docs row, and no snapshot "
                     "diff when it changes.  Every ZOO_* read goes "
                     "through envcontract.env_str/env_int/env_flag, "
                     "whose VARS table is the single declaration "
                     "point (and must stay documented).",
        "bad": "limit = os.environ.get(\"ZOO_FAKE_LIMIT\")",
        "good": "from analytics_zoo_tpu_torch import envcontract\n"
                "limit = envcontract.env_str(\"ZOO_FAKE_LIMIT\")\n"
                "# + a VARS entry and a docs table row",
    },
    "ZL821": {
        "title": "config read on the compile path, not in the key",
        "rationale": "The executable store replays compiles by "
                     "fingerprint.  A constructor-derived config "
                     "attribute that the compile-reachable path "
                     "reads but the fingerprint never folds means "
                     "two deploys differing only in that knob share "
                     "a key — the second serves the first's STALE "
                     "executable.  Fold the attr (or a canonical "
                     "digest of it) into the fingerprint extras.",
        "bad": "def _shape(self, n):\n"
               "    return n * self._pad_mult  # read, not folded\n"
               "def ensure(self, n):\n"
               "    fp = self.store.fingerprint(\"kind\", self._dg)",
        "good": "fp = self.store.fingerprint(\"kind\", self._dg,\n"
                "                            self._pad_mult)",
    },
}


def anchor_for(code: str) -> str:
    """The docs anchor of a rule code (family-level sections)."""
    digit = code[2] if len(code) > 2 else ""
    return _DOC + _FAMILY_ANCHORS.get(digit, "")


def explain(code: str) -> Optional[str]:
    """The --explain rendering for one code, None when unknown."""
    entry = CATALOG.get(code)
    if entry is None:
        fate = FATES.get(code)
        if fate is None:
            return None
        return (f"{code} — {fate[0]} in the port\n\n{fate[1]}\n\n"
                f"docs: {_DOC}#fates")
    bad = "\n".join("    " + l for l in entry["bad"].splitlines())
    good = "\n".join("    " + l for l in entry["good"].splitlines())
    return (f"{code} — {entry['title']}\n\n"
            f"{entry['rationale']}\n\n"
            f"bad:\n{bad}\n\n"
            f"good:\n{good}\n\n"
            f"docs: {anchor_for(code)}")
