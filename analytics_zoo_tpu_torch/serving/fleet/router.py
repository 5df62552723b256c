"""Fleet router: the thin control plane in front of the worker plane.

Counterpart of ``analytics_zoo_tpu/serving/fleet/router.py``, with the
same interface plus ``device=`` (every worker's device).  It speaks the
registry's serving envelope OUTWARD (``predict_ex``/``generate_ex`` with
deadline, trace id, priority class; structured ``Overloaded`` /
``DeadlineExceeded`` errors rebuilt concretely) and owns the fleet's
jobs:

* **Scheduling**: least-outstanding-work across live workers, ties
  rotated, weighted by residency: workers piggyback the models they
  hold on every reply, and a request for a model some worker holds pays
  ``affinity_penalty`` to land anywhere else (a soft pin that load can
  override), counted in ``zoo_fleet_affinity_total{outcome=hit|miss|
  cold}``.  A connection-level failure mid-request (the worker died
  under it) is retried ONCE on a sibling; structured serving errors are
  real rejections and never retried.
* **Deploy fan-out**: ``deploy()`` persists the artifact (weights and
  spec) on the share ONCE, then activates the version on each worker
  ONE AT A TIME, each activation the worker's own warm-before-swap, so
  a rolling upgrade never takes a worker out of service.  The first
  activation builds the kernels and fills the shared store; every later
  worker, and every restarted one, builds none.
* **Wire**: each fresh connection negotiates the binary payload with a
  ``hello`` (a worker that answers otherwise keeps that connection on
  JSON); predict/generate then carry arrays out of band.  Bytes are
  counted by direction and encoding in ``zoo_fleet_wire_bytes_total``.
* **Cross-process coalescing** (``coalesce_ms > 0``): concurrent
  predicts of one (model, priority, deadline, dtype, trailing shape)
  merge into ONE wire request; the first caller leads, waits the
  window, concatenates the riders' rows, sends one frame and splits the
  reply.
* **Elastic pool**: ``set_pool_size`` grows the worker plane (spawn or
  revive, then the ``on_worker_up`` replay) or shrinks it (unroute,
  DRAIN, retire through the supervisor: no postmortem, no restart);
  :func:`fleet_autoscaler` drives it from the router's load signals.
* **Observability**: ``metrics_text()`` scrapes every live worker and
  merges the expositions through the pod aggregator (a ``rank`` label
  on every sample, rank-less fleet totals for counters), plus the
  router's ``zoo_fleet_*`` families.  With a tracer every routed
  request carries a span with ``route_pick`` / ``worker_call`` phases
  and a ``worker`` label, the worker's leg nested under ``worker_call``.

A restarted worker comes back BLANK: the supervisor's ``on_worker_up``
hook replays the current version set onto it before the router routes
any traffic at it.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ...observability import aggregate as _aggregate
from ...observability import trace as _trace
from ...observability import tracefleet
from ...observability.log import get_logger
from ...observability.metrics import (Family, parse_prometheus_text,
                                      render_prometheus)
from ..errors import ServingError, WorkerUnavailable
from . import artifact, protocol
from .supervisor import FleetSupervisor

_slog = get_logger("zoo.serving.fleet.router")

EXECSTORE_SUBDIR = "execstore"


class _Handle:
    """Router-side view of one worker slot: endpoint + connection pool
    + the outstanding-work count the scheduler reads."""

    def __init__(self, rank: int):
        self.rank = rank
        self.port: Optional[int] = None
        self.routable = False
        # scale-down drain latch: set before draining so neither the
        # scheduler nor a racing revival probe routes new work at a
        # worker on its way out
        self.retiring = False
        self.outstanding = 0
        # residency piggyback state: the models this worker
        # reported resident on its LAST reply/ping, and its own
        # in-flight count at that moment.  Whole-object swaps under
        # the GIL — readers see the old set or the new one, never a
        # torn set — so the scheduler reads these lock-free.
        self.resident: frozenset = frozenset()
        self.worker_inflight = 0
        # the pool is GENERATION-stamped: drop_conns bumps the
        # generation, so an exchange that COMPLETED while straddling a
        # worker death (reply buffered before the kill) cannot return
        # its dead connection into a pool that was already cleaned.
        # Each pooled conn also carries its NEGOTIATED wire version —
        # negotiation is per-connection, paid once at connect.
        self.generation = 0
        self.conns: List[Tuple[int, socket.socket, int]] = []
        self.lock = threading.Lock()  # pool only

    def take_conn(self, timeout: float
                  ) -> Tuple[socket.socket, int, Optional[int]]:
        """A pooled ``(conn, generation, wire)`` — ``wire`` is None
        for a FRESH connection (the caller negotiates and passes the
        verdict back through :meth:`put_conn`)."""
        with self.lock:
            if self.conns:
                gen, conn, wire = self.conns.pop()
                return conn, gen, wire
            port, gen = self.port, self.generation
        if port is None:
            raise ConnectionError(f"worker {self.rank} has no endpoint")
        s = socket.create_connection(("127.0.0.1", port),
                                     timeout=timeout)
        s.settimeout(timeout)
        return s, gen, None

    def put_conn(self, conn: socket.socket, gen: int,
                 wire: int) -> None:
        with self.lock:
            if gen == self.generation:
                self.conns.append((gen, conn, wire))
                return
        try:  # stale generation: the endpoint it reaches is gone
            conn.close()
        except OSError:
            pass

    def drop_conns(self) -> None:
        with self.lock:
            conns, self.conns = self.conns, []
            self.generation += 1
        for _, c, _ in conns:
            try:
                c.close()
            except OSError:
                pass


class _Batch:
    """One open cross-process coalescing batch: the FIRST caller for
    a key is the leader (it waits the window, concatenates, sends one
    wire request, splits the reply); later callers are riders parked
    on ``done``.  Rows/sizes are appended under the router's coalesce
    lock; results/error are written by the leader before ``done``
    fires."""

    def __init__(self):
        self.rows: List[Any] = []
        self.sizes: List[int] = []
        self.total = 0
        self.closed = False
        self.done = threading.Event()
        self.result = None
        self.info: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None


class FleetRouter:
    """The fleet control plane (module docstring).

    ``share_dir`` holds the deploy artifacts and (unless the caller
    points ``ZOO_EXECSTORE_DIR`` elsewhere via ``env``) the shared
    store of kernel libraries.  ``registry_kwargs`` configure every
    worker's ``ModelRegistry`` identically (the same buckets and
    admission make outputs bit-identical).  ``device`` is every
    worker's device (``cuda`` unless asked otherwise)."""

    def __init__(self, share_dir: str, n_workers: int = 2, *,
                 run_dir: Optional[str] = None,
                 registry_kwargs: Optional[dict] = None,
                 fake: bool = False,
                 env: Optional[Dict[str, str]] = None,
                 max_restarts: int = 2, restart_backoff: float = 0.5,
                 watchdog_sec: float = 0.0,
                 call_timeout_s: float = 120.0,
                 wire: str = "binary",
                 affinity_penalty: int = 4,
                 coalesce_ms: float = 0.0,
                 coalesce_rows: int = 64,
                 tracer=None, device: str = "cuda"):
        self.share_dir = os.path.abspath(share_dir)
        os.makedirs(self.share_dir, exist_ok=True)
        self.call_timeout_s = call_timeout_s
        # "binary" negotiates the v2 wire per connection (old/pinned
        # workers degrade that connection to JSON); "json" skips the
        # hello entirely (the A/B lever between the two wires)
        self.wire = wire
        # affinity: a non-resident worker's score is outstanding +
        # penalty, so residency wins until the resident worker is
        # ~penalty requests deeper than a sibling — a soft pin that
        # load can override (hard pinning would turtle one worker)
        self.affinity_penalty = affinity_penalty
        # cross-process coalescing window (0 = off): concurrent
        # same-key predicts merge into one wire request
        self.coalesce_ms = coalesce_ms
        self.coalesce_rows = coalesce_rows
        self.tracer = tracer
        worker_env = dict(env or {})
        if not fake:
            worker_env.setdefault(
                "ZOO_EXECSTORE_DIR",
                os.path.join(self.share_dir, EXECSTORE_SUBDIR))
        import json as _json
        self.supervisor = FleetSupervisor(
            n_workers,
            run_dir or os.path.join(self.share_dir, "run"),
            self.share_dir, fake=fake, device=device,
            registry_json=(_json.dumps(registry_kwargs)
                           if registry_kwargs else None),
            env=worker_env, max_restarts=max_restarts,
            restart_backoff=restart_backoff,
            watchdog_sec=watchdog_sec,
            on_worker_up=self._on_worker_up,
            on_worker_down=self._on_worker_down)
        self.handles = [_Handle(r) for r in range(n_workers)]
        self._lock = threading.Lock()       # scheduling + version set
        self._active: Dict[str, int] = {}   # model -> active version
        self._next_version: Dict[str, int] = {}
        self._rr = 0
        self._retries_total = 0
        self._req_seq = 0
        # v2 telemetry: affinity outcomes, per-(direction, encoding)
        # wire bytes, and a served-latency EWMA (the autoscaler's
        # pressure signal alongside queue depth)
        self._affinity = {"hit": 0, "miss": 0, "cold": 0}
        self._wire_bytes: Dict[Tuple[str, str], int] = {}
        self._ewma_ms: Optional[float] = None
        # coalescer: one open batch per key, leader/rider protocol
        self._co_lock = threading.Lock()
        self._co_open: Dict[Any, "_Batch"] = {}
        self._fanouts: Dict[Tuple[str, int], float] = {}
        self.last_fanout: List[Dict[str, Any]] = []
        # rank -> the replay-activation reports of its LAST (re)start
        # (a restarted worker's builds are read here: warm from the
        # store, it must run no nvcc)
        self.replays: Dict[int, List[Dict[str, Any]]] = {}
        self._reviving: set = set()  # ranks with a live revival probe
        self._closed = False

    # ---- lifecycle ----
    def start(self, timeout: float = 120.0) -> None:
        """Start the worker plane and wait until every worker is
        routable (raises on timeout — a fleet that cannot field its
        workers should fail loudly at startup, not shed mysteriously
        later)."""
        self.supervisor.start()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(h.routable for h in self.handles):
                return
            if any(w.state == "dead" for w in self.supervisor.workers):
                break
            time.sleep(0.05)
        states = self.supervisor.states()
        self.supervisor.stop()
        raise RuntimeError(
            f"fleet failed to start within {timeout}s: {states}")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.supervisor.stop()
        for h in self.handles:
            h.drop_conns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- supervisor hooks (monitor thread) ----
    def _on_worker_down(self, rank: int) -> None:
        h = self.handles[rank]
        h.routable = False
        h.port = None
        h.drop_conns()

    def _on_worker_up(self, rank: int, port: int,
                      incarnation: int) -> None:
        """A (re)started worker is blank: replay the current version
        set onto it — warm from the shared store, so this is
        milliseconds — BEFORE marking it routable."""
        h = self.handles[rank]
        h.drop_conns()
        h.port = port
        with self._lock:
            replay = sorted(self._active.items())
        reports = []
        for model, version in replay:
            resp = self._call(h, {"op": "activate", "model": model,
                                  "version": version})
            reports.append({"model": model, **resp["result"]})
            _slog.info("fleet_replay_activate", rank=rank, model=model,
                       version=version,
                       compiles=resp["result"]["compiles"],
                       warm_ms=resp["result"]["warm_ms"])
        self.replays[rank] = reports
        h.routable = True

    # ---- wire calls ----
    def _negotiate(self, conn: socket.socket, rank: int) -> int:
        """Per-connection wire handshake: one ``hello`` exchange.  An
        old worker (or one pinned with ``ZOO_FLEET_WIRE=json``)
        answers without a binary verdict and the connection stays on
        the v1 JSON wire — mixed fleets interoperate per-connection.
        Transport failures propagate (the caller's normalizing try
        owns them)."""
        if self.wire != "binary":
            return protocol.WIRE_JSON
        protocol.send_frame(conn, {"op": "hello", "id": 0,
                                   "wire": protocol.WIRE_BINARY})
        resp = protocol.recv_frame(conn)
        if resp is None:
            raise protocol.FrameError(
                f"worker {rank} hung up during wire negotiation")
        if (resp.get("ok")
                and isinstance(resp.get("result"), dict)
                and resp["result"].get("wire")
                == protocol.WIRE_BINARY):
            return protocol.WIRE_BINARY
        return protocol.WIRE_JSON

    def _count_wire(self, direction: str, encoding: str,
                    nbytes: int) -> None:
        with self._lock:
            key = (direction, encoding)
            self._wire_bytes[key] = self._wire_bytes.get(key, 0) \
                + nbytes

    def _call(self, h: _Handle, req: Dict[str, Any]) -> Dict[str, Any]:
        """One request/reply exchange with one worker on a pooled
        connection.  Any transport-level failure closes the connection
        and surfaces as ConnectionError (the worker-death signal);
        a structured error envelope raises the reconstructed serving
        exception.  Serve-op payloads ride the negotiated wire
        (binary: ndarrays as raw out-of-band buffers, zero-copy on
        decode); control ops stay JSON — no arrays, and a readable
        envelope is worth more than the few bytes.  Every reply's
        ``load`` piggyback refreshes this handle's residency view."""
        with self._lock:
            self._req_seq += 1
            req = {**req, "id": self._req_seq}
        conn = None
        try:
            # take_conn INSIDE the normalizing try: a connect that
            # hangs raises TimeoutError, which is an OSError but NOT
            # a ConnectionError — without normalization a wedged
            # accept loop would escape the retry-on-sibling contract
            conn, gen, wire = h.take_conn(self.call_timeout_s)
            if wire is None:
                wire = self._negotiate(conn, h.rank)
            binary = (wire == protocol.WIRE_BINARY
                      and req.get("op") in ("predict", "generate"))
            n_tx = protocol.send_envelope(conn, req, binary=binary)
            got = protocol.recv_envelope(conn)
        except (OSError, protocol.FrameError) as e:
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            raise ConnectionError(
                f"worker {h.rank} failed mid-request: "
                f"{type(e).__name__}: {e}") from e
        self._count_wire("tx", "binary" if binary else "json", n_tx)
        if got is not None:
            self._count_wire("rx", got[2], got[1])
        resp = got[0] if got is not None else None
        if resp is None or resp.get("id") != req["id"]:
            try:
                conn.close()
            except OSError:
                pass
            raise ConnectionError(
                f"worker {h.rank} hung up mid-request")
        h.put_conn(conn, gen, wire)
        load = resp.get("load")
        if isinstance(load, dict):
            # whole-object swaps, read lock-free by the scheduler
            h.resident = frozenset(load.get("r") or ())
            h.worker_inflight = int(load.get("o") or 0)
        if not resp.get("ok"):
            raise protocol.decode_error(resp.get("error") or {})
        return resp

    def _pick(self, exclude: Optional[int] = None,
              model: Optional[str] = None,
              count: bool = True) -> _Handle:
        """Least-outstanding-work over routable workers, ties rotated
        (pure min-index would camp light traffic on worker 0),
        residency-weighted when a model is named: a worker NOT
        holding the model scores ``outstanding + affinity_penalty``,
        so requests follow residency until load outweighs the fault
        cost.  Outcomes: ``hit`` — a resident worker chosen; ``miss``
        — someone holds it but load sent us elsewhere; ``cold`` — no
        live worker holds it (somebody must fault).  The retry-on-
        sibling re-pick passes ``count=False`` — one request, one
        outcome."""
        with self._lock:
            live = [h for h in self.handles
                    if h.routable and not h.retiring
                    and h.rank != exclude]
            if not live:
                raise WorkerUnavailable(
                    "no live fleet worker available",
                    states=self.supervisor.states())
            if model is None:
                score = {h.rank: h.outstanding for h in live}
            else:
                score = {h.rank: h.outstanding
                         + (0 if model in h.resident
                            else self.affinity_penalty)
                         for h in live}
            best = min(score.values())
            candidates = [h for h in live if score[h.rank] == best]
            h = candidates[self._rr % len(candidates)]
            self._rr += 1
            h.outstanding += 1
            if model is not None and count:
                if model in h.resident:
                    self._affinity["hit"] += 1
                elif any(model in x.resident for x in live):
                    self._affinity["miss"] += 1
                else:
                    self._affinity["cold"] += 1
            return h

    def _release(self, h: _Handle) -> None:
        with self._lock:
            h.outstanding -= 1

    def _schedule_revival(self, h: _Handle) -> None:
        """Router-side unrouting must be recoverable without a worker
        restart: a DETACHED probe (never inline on the request path)
        pings the worker with backoff and restores it on success.  A
        worker that really died fails every ping until the supervisor's
        incident path takes over (``on_worker_down`` nulls the port,
        which ends the probe; the restart's ``on_worker_up`` replay
        re-routes it)."""
        with self._lock:
            if h.rank in self._reviving:
                return
            self._reviving.add(h.rank)
        threading.Thread(target=self._revive, args=(h,), daemon=True,
                         name=f"fleet-revive-{h.rank}").start()

    def _revive(self, h: _Handle) -> None:
        try:
            delay = 0.2
            deadline = time.monotonic() + max(self.call_timeout_s,
                                              30.0)
            while time.monotonic() < deadline and not self._closed:
                if (self.supervisor.worker(h.rank).state != "live"
                        or h.port is None):
                    return  # the supervisor owns this incident now
                try:
                    self._call(h, {"op": "ping"})
                except (ConnectionError, ServingError):
                    time.sleep(delay)
                    delay = min(delay * 2, 2.0)
                    continue
                if not h.retiring:
                    h.routable = True
                _slog.info("fleet_worker_revived", rank=h.rank)
                return
        finally:
            with self._lock:
                self._reviving.discard(h.rank)

    def _route_call(self, req: Dict[str, Any], span=None,
                    model: Optional[str] = None) -> Dict[str, Any]:
        """The routed data path: pick, call,
        and on a worker death retry ONCE on a sibling.  The failed
        worker is marked unroutable immediately; a detached revival
        probe then pings it — a worker that actually died stays out
        until the supervisor restarts + replays it, but a TRANSIENT
        failure (one slow request tripping the call timeout on a
        healthy worker) costs it the rotation only until the next
        successful ping, never forever."""
        if span is not None:
            span.phase_start("route_pick")
        h = self._pick(model=model)
        if span is not None:
            span.set_label("worker", h.rank)
            span.phase_start("worker_call")
        try:
            resp = self._call(h, req)
            if span is not None:
                # inline stitch: nest the worker's piggybacked span
                # summary under this worker_call occurrence
                tracefleet.nest_summary(span, resp.get("trace"))
            return resp
        except ConnectionError:
            h.routable = False
            h.drop_conns()
            self._schedule_revival(h)
            with self._lock:
                self._retries_total += 1
            _slog.warning("fleet_retry_on_sibling", failed=h.rank,
                          op=req.get("op"))
            if span is not None:
                span.set_label("retried", True)
                # the sibling leg is its OWN worker_call occurrence:
                # the stitcher attributes the failed leg (no reply,
                # no worker record) to the first occurrence and the
                # served leg to this one
                span.phase_start("worker_call")
            h2 = self._pick(exclude=h.rank, model=model, count=False)
            if span is not None:
                span.set_label("worker", h2.rank)
            try:
                resp = self._call(h2, req)
                if span is not None:
                    tracefleet.nest_summary(span, resp.get("trace"))
                return resp
            finally:
                self._release(h2)
        finally:
            self._release(h)

    # ---- serving surface ----
    def predict(self, model: str, inputs,
                deadline_ms: Optional[float] = None,
                priority_class: Optional[str] = None):
        out, _ = self.predict_ex(model, inputs,
                                 deadline_ms=deadline_ms,
                                 priority_class=priority_class)
        return out

    def predict_ex(self, model: str, inputs,
                   deadline_ms: Optional[float] = None,
                   trace_id: Optional[str] = None,
                   priority_class: Optional[str] = None
                   ) -> Tuple[Any, Dict[str, Any]]:
        # inputs stay RAW ndarrays in the request envelope — the
        # encoding decision (binary out-of-band vs JSON b64) belongs
        # to the negotiated connection at send time, not here
        if self.coalesce_ms > 0:
            import numpy as np
            x = np.asarray(inputs)
            if x.ndim >= 2:
                return self._predict_coalesced(
                    model, x, deadline_ms, trace_id, priority_class)
        return self._serve_ex(
            {"op": "predict", "model": model, "inputs": inputs},
            model, "predict", deadline_ms, trace_id, priority_class)

    def generate_ex(self, model: str, prompt_ids, max_new_tokens: int,
                    deadline_ms: Optional[float] = None,
                    trace_id: Optional[str] = None,
                    priority_class: Optional[str] = None,
                    eos_id: Optional[int] = None,
                    temperature: float = 0.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None, seed: int = 0
                    ) -> Tuple[Any, Dict[str, Any]]:
        # sampling params ride the envelope as json-safe scalars
        # (validated worker-side by the engine, so a bad value comes
        # back as the concrete ValueError, not a dead connection);
        # determinism contract: same (prompt, sampling, seed) on any
        # worker == the single-process registry, bit-exact
        return self._serve_ex(
            {"op": "generate",
             "prompt_ids": prompt_ids,
             "model": model, "max_new_tokens": int(max_new_tokens),
             "eos_id": eos_id, "temperature": float(temperature),
             "top_k": None if top_k is None else int(top_k),
             "top_p": None if top_p is None else float(top_p),
             "seed": int(seed)},
            model, "generate", deadline_ms, trace_id, priority_class)

    def _serve_ex(self, req: Dict[str, Any], model: str, op: str,
                  deadline_ms, trace_id, priority_class
                  ) -> Tuple[Any, Dict[str, Any]]:
        if deadline_ms is not None:
            req["deadline_ms"] = deadline_ms
        if priority_class is not None:
            req["priority_class"] = priority_class
        tracer = self.tracer
        span = (tracer.start_span(op, trace_id=trace_id, model=model)
                if tracer is not None else None)
        if span is not None:
            req["trace_id"] = span.trace_id
        elif trace_id is not None:
            req["trace_id"] = trace_id
        t0 = time.perf_counter()
        try:
            with _trace.activate(span):
                resp = self._route_call(req, span=span, model=model)
        except BaseException as e:
            if span is not None:
                span.set_label("error", type(e).__name__)
            raise
        finally:
            if span is not None:
                span.finish()
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            # served-latency EWMA: the autoscaler's pressure signal
            self._ewma_ms = (ms if self._ewma_ms is None
                             else 0.2 * ms + 0.8 * self._ewma_ms)
        info = dict(resp.get("info") or {})
        if span is not None:
            info["request_id"] = span.trace_id
            if span.children:
                # the per-request wire+queue remainder: worker_call
                # time the nested worker legs do NOT account for
                gap = tracefleet.inline_gap_ms(span)
                if gap is not None:
                    info["fleet_gap_ms"] = gap
        return protocol.decode_value(resp.get("result")), info

    # ---- cross-process coalescing ----
    def _predict_coalesced(self, model: str, x, deadline_ms,
                           trace_id, priority_class
                           ) -> Tuple[Any, Dict[str, Any]]:
        """Merge concurrent compatible predicts into ONE wire request
        (leader/rider).  Compatibility is the batching contract: same
        model, priority class, deadline value, dtype, and trailing
        shape — rows concatenate on axis 0 exactly like the worker's
        own coalescer merges them, so the fleet answer stays
        bit-exact vs per-request sends.  Riders share the leader's
        outcome, including its error: a shed batch sheds every
        caller, same as the in-process coalescer."""
        import numpy as np
        key = (model, priority_class, deadline_ms,
               str(x.dtype), x.shape[1:])
        with self._co_lock:
            b = self._co_open.get(key)
            if (b is not None and not b.closed
                    and b.total + len(x) <= self.coalesce_rows):
                my_off = b.total
                b.rows.append(x)
                b.sizes.append(len(x))
                b.total += len(x)
                leader = False
            else:
                b = _Batch()
                b.rows.append(x)
                b.sizes.append(len(x))
                b.total = len(x)
                self._co_open[key] = b
                leader = True
        if not leader:
            # the leader's serve carries the deadline; the extra
            # margin only guards against a lost leader thread
            if not b.done.wait(self.call_timeout_s + 30.0):
                raise WorkerUnavailable(
                    "coalesced batch leader never completed",
                    model=model)
            if b.error is not None:
                raise b.error
            out = b.result[my_off:my_off + len(x)]
            info = dict(b.info or {})
            info["coalesced"] = b.total
            return out, info
        time.sleep(self.coalesce_ms / 1e3)  # the gather window
        with self._co_lock:
            if self._co_open.get(key) is b:
                del self._co_open[key]
            b.closed = True
            rows = list(b.rows)
        batch = rows[0] if len(rows) == 1 else np.concatenate(rows)
        try:
            out, info = self._serve_ex(
                {"op": "predict", "model": model, "inputs": batch},
                model, "predict", deadline_ms, trace_id,
                priority_class)
            b.result = np.asarray(out)
            b.info = info
        except BaseException as e:  # noqa: BLE001 — riders must see
            # the leader's failure, whatever its class
            b.error = e
            raise
        finally:
            b.done.set()
        info = dict(info)
        if len(rows) > 1:
            info["coalesced"] = b.total
        return b.result[:b.sizes[0]], info

    # ---- deploy / fan-out ----
    def deploy(self, model: str, params: Optional[Dict[str, Any]],
               builder: str, builder_args: Optional[dict] = None,
               warmup_shapes=None, version: Optional[int] = None,
               deploy_kwargs: Optional[dict] = None
               ) -> Dict[str, Any]:
        """Fleet deploy: persist the artifact once, then activate it
        on every worker one at a time (rolling, warm-before-swap per
        worker).  Returns the fan-out report ``{"version",
        "fanout_s", "activations": [{rank, compiles, warm_ms,
        error?}, ...]}``.  A worker that dies mid-fan-out is skipped —
        its restart replays the new version from the share."""
        # auto-versioning is seeded from the COMMITTED artifacts on
        # disk, not in-memory state alone: a restarted router must
        # never reuse a version number and overwrite an artifact
        # long-running workers still replay from (the spec rename is
        # the commit — committed artifacts are immutable)
        disk_floor = (max(artifact.versions(self.share_dir, model),
                          default=0) + 1 if version is None else 0)
        with self._lock:
            if version is None:
                version = max(self._next_version.get(model, 1),
                              disk_floor)
            self._next_version[model] = max(
                self._next_version.get(model, 1), version + 1)
        artifact.publish(
            self.share_dir, model, version, params,
            {"builder": builder, "args": builder_args or {},
             "warmup_shapes": (list(warmup_shapes)
                               if warmup_shapes is not None else None),
             "deploy_kwargs": deploy_kwargs or {}})
        # the version set updates BEFORE fan-out so a worker
        # restarting mid-deploy replays the NEW version (activation is
        # version-pinned and idempotent, double-activation is safe)
        with self._lock:
            self._active[model] = version
        t0 = time.perf_counter()
        activations: List[Dict[str, Any]] = []
        for h in list(self.handles):
            if not (h.routable or h.port is not None):
                continue
            entry: Dict[str, Any] = {"rank": h.rank}
            ta = time.perf_counter()
            try:
                resp = self._call(h, {"op": "activate", "model": model,
                                      "version": version})
                entry.update(resp["result"])
            except (ConnectionError, ServingError) as e:
                # dead worker: its replacement replays from the share.
                # A structured deploy failure is recorded, not raised
                # mid-fan-out — the report carries the verdict.
                entry["error"] = f"{type(e).__name__}: {e}"
                _slog.error("fleet_activate_failed", rank=h.rank,
                            model=model, version=version,
                            error=entry["error"])
            entry["t_start"] = round(ta - t0, 6)
            entry["t_end"] = round(time.perf_counter() - t0, 6)
            activations.append(entry)
        fanout_s = round(time.perf_counter() - t0, 6)
        with self._lock:
            self._fanouts[(model, version)] = fanout_s
        self.last_fanout = activations
        _slog.info("fleet_deploy_fanout", model=model, version=version,
                   fanout_s=fanout_s,
                   workers=[a["rank"] for a in activations])
        return {"version": version, "fanout_s": fanout_s,
                "activations": activations}

    def promote(self, model: str) -> Dict[str, Any]:
        """Fan out a canary promote to every routable worker —
        deploy's per-worker error discipline: one dead worker is
        recorded and skipped (its replacement replays the PROMOTED
        version set), never an aborted half-promoted fleet."""
        results = []
        promoted: Optional[int] = None
        for h in list(self.handles):
            if not h.routable:
                continue
            entry: Dict[str, Any] = {"rank": h.rank}
            try:
                resp = self._call(h, {"op": "promote", "model": model})
                entry.update(resp["result"])
                promoted = entry["version"]
                # _active updates at the FIRST success (deploy's
                # discipline): a worker restarting mid-promote must
                # replay the promoted version, not the one it died on
                with self._lock:
                    self._active[model] = promoted
            except (ConnectionError, ServingError) as e:
                entry["error"] = f"{type(e).__name__}: {e}"
                _slog.error("fleet_promote_failed", rank=h.rank,
                            model=model, error=entry["error"])
            results.append(entry)
        return {"version": promoted, "activations": results}

    def undeploy(self, model: str) -> Dict[str, Any]:
        """Fan out an undeploy to every routable worker and RETIRE the
        model's fleet-level series: the per-(model, version) fan-out
        gauge and the active-version map are dropped, so a density
        fleet cycling hundreds of models does not grow the router
        scrape (or its memory) one dead series per deploy forever.
        Committed artifacts stay on the share (undeploy retires the
        SERVING state, not the deploy history); per-worker error
        discipline matches deploy/promote — a dead worker's
        replacement simply never replays the retired model."""
        results = []
        for h in list(self.handles):
            if not h.routable:
                continue
            entry: Dict[str, Any] = {"rank": h.rank}
            try:
                resp = self._call(h, {"op": "undeploy",
                                      "model": model})
                entry.update(resp["result"])
            except (ConnectionError, ServingError) as e:
                entry["error"] = f"{type(e).__name__}: {e}"
                _slog.error("fleet_undeploy_failed", rank=h.rank,
                            model=model, error=entry["error"])
            results.append(entry)
        with self._lock:
            self._active.pop(model, None)
            self._next_version.pop(model, None)
            for key in [k for k in self._fanouts if k[0] == model]:
                self._fanouts.pop(key, None)
        _slog.info("fleet_undeploy", model=model,
                   workers=[r["rank"] for r in results])
        return {"model": model, "activations": results}

    def ping(self, rank: int) -> Dict[str, Any]:
        return self._call(self.handles[rank],
                          {"op": "ping"})["result"]

    # ---- elastic pool ----
    def pool_size(self) -> int:
        """Workers that count toward capacity: everything not
        deliberately retired and not past its restart budget."""
        return sum(1 for w in self.supervisor.workers
                   if w.state not in ("retired", "dead"))

    def load_signals(self) -> Dict[str, Any]:
        """The autoscaler's view of the fleet: router-side in-flight
        total (the timely number — worker piggybacks lag one reply),
        the served-latency EWMA, and the live pool size."""
        with self._lock:
            depth = sum(h.outstanding for h in self.handles)
            ewma = self._ewma_ms
        return {"queue_depth": depth, "ewma_ms": ewma,
                "active": self.pool_size()}

    def set_pool_size(self, n: int, *, drain_timeout_s: float = 30.0,
                      start_timeout_s: float = 120.0
                      ) -> Dict[str, Any]:
        """Resize the worker plane to ``n`` workers (the autoscaler's
        ``apply_scale``, also a first-class operator verb).

        Scale-UP revives retired slots first, then appends fresh
        ranks; either way the supervisor's ``on_worker_up`` replay
        warms the newcomer from the shared execstore BEFORE it turns
        routable (no kernel build: the store holds them) and this
        call blocks until the newcomer is routable (the autoscaler
        contract: apply_scale is synchronous).

        Scale-DOWN picks the highest-rank active workers, latches
        ``retiring`` (no new picks, revival probes disarmed), DRAINS
        the router-side in-flight count to zero, then retires the
        process through the supervisor — a deliberate exit, not an
        incident.  A drain that outlives ``drain_timeout_s`` retires
        anyway (the straggler's caller gets the retry-on-sibling
        path) and reports ``forced``."""
        if n < 1:
            raise ValueError(f"pool size must be >= 1, got {n}")
        report: Dict[str, Any] = {"target": n, "grew": [],
                                  "retired": [], "forced": []}
        while self.pool_size() < n:
            retired = [w for w in self.supervisor.workers
                       if w.state == "retired"]
            if retired:
                rank = retired[0].rank
                h = self.handles[rank]
                h.retiring = False
                h.drop_conns()
                self.supervisor.revive(rank)
            else:
                with self._lock:
                    rank = len(self.supervisor.workers)
                    # the handle EXISTS before the spawn: the monitor
                    # thread's on_worker_up replay dereferences it
                    self.handles.append(_Handle(rank))
                self.supervisor.add_worker()
            deadline = time.monotonic() + start_timeout_s
            h = self.handles[rank]
            while not h.routable:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"scale-up worker {rank} not routable within "
                        f"{start_timeout_s}s: "
                        f"{self.supervisor.states()}")
                if self.supervisor.worker(rank).state == "dead":
                    raise RuntimeError(
                        f"scale-up worker {rank} died during warm-up")
                time.sleep(0.02)
            report["grew"].append(rank)
            _slog.info("fleet_scale_up", rank=rank,
                       pool=self.pool_size())
        while self.pool_size() > n:
            active = [w for w in self.supervisor.workers
                      if w.state not in ("retired", "dead")]
            victim = max(active, key=lambda w: w.rank)
            h = self.handles[victim.rank]
            h.retiring = True
            h.routable = False
            deadline = time.monotonic() + drain_timeout_s
            while True:
                with self._lock:
                    drained = h.outstanding == 0
                if drained:
                    break
                if time.monotonic() > deadline:
                    report["forced"].append(victim.rank)
                    _slog.warning("fleet_scale_down_forced",
                                  rank=victim.rank,
                                  outstanding=h.outstanding)
                    break
                time.sleep(0.01)
            # cooperative shutdown first: the worker's serve loop has a
            # "shutdown" handler for exactly this, and a worker that
            # exits on its own skips the supervisor's terminate->kill
            # escalation (retire() marks it "retired" before the exit
            # lands, so the monitor never books it as an incident)
            try:
                self._call(h, {"op": "shutdown"})
            except (ConnectionError, ServingError):
                pass  # drain already emptied it; terminate() below wins
            h.drop_conns()
            h.port = None
            h.resident = frozenset()
            self.supervisor.retire(victim.rank)
            report["retired"].append(victim.rank)
            _slog.info("fleet_scale_down", rank=victim.rank,
                       pool=self.pool_size())
        return report

    # ---- observability ----
    def families(self) -> List[Family]:
        states = self.supervisor.states()
        with self._lock:
            retries = self._retries_total
            fanouts = dict(self._fanouts)
            affinity = dict(self._affinity)
            wire_bytes = dict(self._wire_bytes)
        fams = [
            Family("gauge", "zoo_fleet_workers",
                   "fleet workers by supervision state",
                   [({"state": s}, n) for s, n in sorted(states.items())]),
            Family("counter", "zoo_fleet_router_retries_total",
                   "requests retried on a sibling after a worker "
                   "death mid-request", [({}, retries)]),
            Family("counter", "zoo_fleet_affinity_total",
                   "residency-aware routing outcomes (hit: landed "
                   "on a worker holding the model; miss: resident "
                   "worker existed but load won; cold: nobody held "
                   "it)",
                   [({"outcome": o}, n)
                    for o, n in sorted(affinity.items())]),
            Family("counter", "zoo_fleet_wire_bytes_total",
                   "router<->worker frame bytes by direction and "
                   "payload encoding",
                   [({"direction": d, "encoding": e}, n)
                    for (d, e), n in sorted(wire_bytes.items())]),
        ]
        if fanouts:
            fams.append(Family(
                "gauge", "zoo_fleet_deploy_fanout_seconds",
                "wall seconds of the last activation fan-out per "
                "(model, version)",
                [({"model": m, "version": str(v)}, s)
                 for (m, v), s in sorted(fanouts.items())]))
        return fams

    def metrics_text(self) -> str:
        """The fleet scrape: every live worker's exposition merged
        through the pod aggregator (rank labels + counter fleet
        totals), the router's own families appended."""
        pairs = []
        for h in list(self.handles):
            if not h.routable:
                continue
            try:
                resp = self._call(h, {"op": "metrics"})
            except (ConnectionError, ServingError):
                continue  # a worker dying mid-scrape skips one rank
            pairs.append((h.rank,
                          parse_prometheus_text(resp["result"]["text"])))
        fams = _aggregate.merge_snapshots(pairs)
        fams.extend(self.families())
        if self.tracer is not None:
            # the router's own trace families (span/phase aggregates
            # plus tail exemplar links) join the pod exposition under
            # rank="router" — distinct from every worker's rank label
            # AND from the aggregator's rank-less counter pod totals
            fams.extend(_aggregate.rank_labeled(
                self.tracer.families(), "router"))
        return render_prometheus(fams)

    def states(self) -> Dict[str, int]:
        return self.supervisor.states()

    @property
    def retries_total(self) -> int:
        with self._lock:
            return self._retries_total

    @property
    def affinity_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._affinity)

    @property
    def wire_bytes(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._wire_bytes)

    def set_wire(self, wire: str) -> None:
        """Flip the fleet's wire mode ("binary" negotiates v2 per
        connection, "json" pins v1) and drop every pooled connection
        so the next exchange renegotiates (the A/B lever)."""
        if wire not in ("binary", "json"):
            raise ValueError(f"wire must be binary|json, got {wire!r}")
        self.wire = wire
        for h in list(self.handles):
            h.drop_conns()


def fleet_autoscaler(router: FleetRouter, **kwargs: Any):
    """The :class:`~..autoscale.Autoscaler` pointed at the WORKER
    PLANE: queue depth = the router's in-flight total, latency = its
    served EWMA, and ``apply_scale`` resizes the worker pool through
    :meth:`FleetRouter.set_pool_size` — whole processes instead of
    in-process replicas, with the execstore replay making every
    scale-up warm.  Same hysteresis/cooldown/±1 discipline, same
    testable ``tick()``.  ``max_replicas`` defaults to the current
    pool size (growing past the initial fleet is an explicit
    decision, not a default)."""
    from ..autoscale import Autoscaler

    def apply_scale(n: int):
        router.set_pool_size(n)

    kwargs.setdefault("max_replicas", router.pool_size())
    kwargs.setdefault("initial_replicas", router.pool_size())
    kwargs.setdefault("name", "fleet")
    return Autoscaler(router.load_signals, apply_scale, **kwargs)
