"""Fleet serving worker: one process of the worker plane.

``python -m analytics_zoo_tpu_torch.serving.fleet.worker --share DIR
--port-file PATH [--fake] [--registry-json '{...}'] [--device cuda]``

Counterpart of ``analytics_zoo_tpu/serving/fleet/worker.py``.  A worker
is the single-process data plane (a :class:`~..registry.ModelRegistry`
with its bucketed forwards, coalescer, admission control and decode
engines) behind a localhost socket speaking :mod:`.protocol` frames.
It owns NO fleet state: it serves whatever committed artifacts on the
share the ``activate`` ops name, so a crashed worker's replacement
rebuilds its serving set from disk, and its kernels from the store.

Supervision contract:

* ``ZOO_HEARTBEAT_FILE``: touched from the accept loop (throttled), so a
  wedged front door reads stale and the watchdog SIGKILLs;
* ``ZOO_FLIGHTREC_DIR``: the per-process flight recorder, under
  ``rank{r}.i{inc}/`` with rank ``ZOO_TPU_PROCESS_ID`` and incarnation
  ``ZOO_RESTART_COUNT`` (both exported by the fleet supervisor);
* ``ZOO_EXECSTORE_DIR``: the shared store of kernel libraries; each
  activation reports the ``nvcc`` builds, serving-signature builds and
  CUDA-graph captures it paid (``observability.profile``'s compile
  hooks, by kind; ``compiles`` is their sum) and the store's hit and
  miss deltas;
* ``ZOO_PAGER_RESIDENT``: an int gives the registry a weight pager with
  that resident budget (``--registry-json '{"pager": {...}}'`` wins);
* ``ZOO_FLEET_WIRE=json``: pin the worker's NEGOTIATED reply wire to
  JSON (it still decodes binary requests);
* ``ZOO_FLEET_MAX_FRAME``: the frame bound; an oversize REPLY comes
  back as a structured error carrying ``attempted_bytes``, and the
  connection stays up;
* the port file is written ATOMICALLY once the socket listens: its
  presence is the router's readiness signal.

``--device`` (default ``cuda``) is where every build of this worker
places its model; the builders get it from here.  Without a card an
activation on ``cuda`` fails with the registry's ``DeployError``: a
worker never serves on the CPU unless asked to.  ``ping`` also returns
the process's kernel launch counts (``ops._kernels.launch_counts()``),
a diagnostic of this package only.  ``--fake`` serves the same protocol
with stub builders only: no device is touched and no kernel built.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ... import envcontract
from ...observability import flightrec, profile, tracefleet
from ...observability import trace as trace_mod
from ...observability.log import get_logger
from ...observability.metrics import MetricsRegistry
from .. import execstore
from ..errors import DeployError
from ..metrics import registry_collector
from ..registry import ModelRegistry
from . import artifact, protocol

_slog = get_logger("zoo.serving.fleet.worker")

_HB_MIN_INTERVAL_S = 0.5
_ACCEPT_TIMEOUT_S = 0.25


class ServingWorker:
    """The worker process body (module docstring)."""

    def __init__(self, share_dir: str, registry_kwargs: Optional[dict] = None,
                 fake: bool = False, device: str = "cuda"):
        self.share_dir = share_dir
        self.fake = fake
        self.device = device
        # identity from the flightrec helpers: the same parse that
        # names this process's recorder directory and log stamps
        self.rank = flightrec._env_rank()
        self.incarnation = flightrec._env_incarnation()
        # every worker traces: finished spans land in the flight
        # recorder, tail exemplars in the tracer, and a traced request's
        # reply carries its span summary back to the router
        self.tracer = trace_mod.Tracer(
            capacity=512, **trace_mod.tail_config_from_env())
        reg_kwargs = dict(registry_kwargs or {})
        reg_kwargs.setdefault("tracer", self.tracer)
        reg_kwargs.setdefault("device", device)
        self.registry = ModelRegistry(**reg_kwargs)
        self.metrics = MetricsRegistry()
        self.metrics.register_collector(registry_collector(self.registry))
        self.metrics.register_collector(self.tracer.families)
        self.store = None if fake else execstore.current()
        if self.store is not None:
            self.metrics.register_collector(self.store.families)
        rec = flightrec.current()
        if rec is not None:
            rec.add_collector(self.metrics.collect)
        # the compile hooks (kernel builds, signature builds, graph
        # captures): each activation reports its deltas
        self.profile = profile.install()
        self._hb_path = envcontract.env_str("ZOO_HEARTBEAT_FILE")
        self._hb_last = 0.0
        # the wire this worker will NEGOTIATE up to; it decodes either
        self.wire_max = (protocol.WIRE_JSON
                         if envcontract.env_str("ZOO_FLEET_WIRE") == "json"
                         else protocol.WIRE_BINARY)
        # load piggyback: serve-op in-flight count plus a throttled
        # residency snapshot, on every reply
        self._inflight = 0
        self._load_lock = threading.Lock()
        self._res_cache: tuple = (0.0, None)
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._conn_threads: List[threading.Thread] = []
        # control ops dispatch through a table, off the serve path
        self._control = {"activate": self._activate,
                         "promote": self._promote,
                         "undeploy": self._undeploy,
                         "ping": self._ping,
                         "metrics": self._metrics,
                         "shutdown": self._shutdown}

    # ---- supervision plumbing ----
    def _beat(self) -> None:
        if not self._hb_path:
            return
        now = time.monotonic()
        if now - self._hb_last < _HB_MIN_INTERVAL_S:
            return
        self._hb_last = now
        try:
            with open(self._hb_path, "a"):
                os.utime(self._hb_path, None)
        except OSError:
            pass  # an unwritable heartbeat must not kill serving

    # ---- socket plumbing ----
    def bind(self) -> int:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        s.listen(64)
        s.settimeout(_ACCEPT_TIMEOUT_S)
        self._listener = s
        return s.getsockname()[1]

    def serve_forever(self) -> None:
        """Accept loop (main thread): one thread per connection and a
        heartbeat touch per pass, the liveness signal the watchdog
        judges this process by."""
        assert self._listener is not None, "bind() first"
        while not self._stop.is_set():
            self._beat()
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed under us during shutdown
            conn.settimeout(None)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._conn_threads = [x for x in self._conn_threads
                                  if x.is_alive()] + [t]
        try:
            self._listener.close()
        except OSError:
            pass
        self.registry.shutdown()

    def _load_snapshot(self) -> Dict[str, Any]:
        """The per-reply load piggyback: in-flight ops and the resident
        models, the latter recomputed at most every 50 ms."""
        now = time.monotonic()
        with self._load_lock:
            out = self._inflight
            ts, res = self._res_cache
            if res is not None and now - ts <= 0.05:
                return {"o": out, "r": res}
        res = self.registry.resident_models()
        with self._load_lock:
            self._res_cache = (now, res)
            out = self._inflight
        return {"o": out, "r": res}

    def _serve_conn(self, conn: socket.socket) -> None:
        """One connection's request/reply loop.  Frame errors and
        hangups end the connection; op errors travel back as structured
        error envelopes.  The reply encoding is per connection: JSON
        until the peer negotiates binary with ``hello`` (whose own reply
        is JSON)."""
        wire = protocol.WIRE_JSON
        try:
            while not self._stop.is_set():
                got = protocol.recv_envelope(conn)
                if got is None:
                    return  # clean hangup
                req = got[0]
                rid = req.get("id")
                op = req.get("op")
                if op == "hello":
                    agreed = min(int(req.get("wire", 1)), self.wire_max)
                    protocol.send_frame(conn, {
                        "id": rid, "ok": True,
                        "result": {"wire": agreed, "rank": self.rank}})
                    wire = agreed
                    continue
                resp = self._execute(req, rid)
                resp["load"] = self._load_snapshot()
                binary = (wire == protocol.WIRE_BINARY
                          and op in ("predict", "generate"))
                try:
                    protocol.send_envelope(conn, resp, binary=binary)
                except (TypeError, ValueError, protocol.FrameError) as e:
                    # an unserializable or oversized RESULT becomes an
                    # error reply, not a dead connection the router would
                    # read as a crash and retry into a sibling.  Both
                    # failures fire before any byte reaches the socket
                    err = {"error": type(e).__name__,
                           "message": f"unserializable response: {e}"}
                    attempted = getattr(e, "attempted_bytes", None)
                    if attempted is not None:
                        err["attempted_bytes"] = attempted
                        err["max_frame_bytes"] = protocol.max_frame_bytes()
                    protocol.send_frame(conn, {
                        "id": rid, "ok": False,
                        "load": self._load_snapshot(), "error": err})
                if op == "shutdown":
                    self._stop.set()
                    return
        except (protocol.FrameError, OSError):
            pass  # dropped peer: the router already treats it as dead
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # ---- ops ----
    def _execute(self, req: Dict[str, Any], rid: Any) -> Dict[str, Any]:
        """One op, its in-flight count balanced on every exit (a hint
        for the router, which keeps its own outstanding count)."""
        try:
            self._inflight += 1
            result = self._handle(req)
        except BaseException as e:  # noqa: BLE001 — every op failure
            # becomes a structured envelope; the router re-raises it
            self._inflight -= 1
            return {"id": rid, "ok": False,
                    "error": protocol.encode_error(e)}
        else:
            self._inflight -= 1
            return {"id": rid, "ok": True, **result}

    def _handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "predict":
            # results stay raw arrays: send_envelope owns the encoding
            out, info = self.registry.predict_ex(
                req["model"], req["inputs"],
                deadline_ms=req.get("deadline_ms"),
                trace_id=req.get("trace_id"),
                priority_class=req.get("priority_class"))
            return self._serve_result(out, info, req.get("trace_id"))
        if op == "generate":
            # the same (prompt, sampling, seed) replays the single-process
            # registry's tokens on any worker of this artifact
            out, info = self.registry.generate_ex(
                req["model"], req["prompt_ids"], req["max_new_tokens"],
                deadline_ms=req.get("deadline_ms"),
                trace_id=req.get("trace_id"),
                priority_class=req.get("priority_class"),
                eos_id=req.get("eos_id"),
                temperature=req.get("temperature", 0.0),
                top_k=req.get("top_k"), top_p=req.get("top_p"),
                seed=req.get("seed", 0))
            return self._serve_result(out, info, req.get("trace_id"))
        fn = self._control.get(op)
        if fn is None:
            raise ValueError(f"unknown op {op!r}")
        return fn(req)

    def _serve_result(self, out, info, trace_id) -> Dict[str, Any]:
        """A serve op's reply, with the worker span's summary when the
        request carried a ``trace_id``."""
        resp: Dict[str, Any] = {"result": out, "info": info}
        if trace_id is not None:
            t = tracefleet.reply_trace(self.tracer, trace_id,
                                       rank=self.rank,
                                       inc=self.incarnation)
            if t is not None:
                resp["trace"] = t
        return resp

    def _promote(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return {"result": {"version": self.registry.promote(
            req["model"])}}

    def _undeploy(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Retire one model (drain and close in the registry, which also
        drops its spans): the next scrape carries none of its series."""
        drained = self.registry.undeploy(
            req["model"],
            drain_timeout=float(req.get("drain_timeout", 10.0)))
        return {"result": {"model": req["model"], "drained": drained,
                           "rank": self.rank}}

    def _ping(self, req: Dict[str, Any]) -> Dict[str, Any]:
        from ...ops import _kernels
        return {"result": {"pid": os.getpid(), "rank": self.rank,
                           "incarnation": self.incarnation,
                           "models": self.registry.models(),
                           "launches": _kernels.launch_counts()}}

    def _metrics(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return {"result": {"text": self.metrics.render_prometheus()}}

    def _shutdown(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return {"result": {"stopping": True}}

    def _activate(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Warm-before-swap activation of one committed version: build
        it from the share on this worker's device, warm it to completion
        (kernels from the store when it holds them), then the registry's
        atomic swap.  The old version serves until the swap."""
        model, version = req["model"], int(req["version"])
        spec, params = artifact.load(self.share_dir, model, version)
        s0 = self.store.stats() if self.store is not None else {}
        p0 = self.profile.snapshot()
        t0 = time.perf_counter()
        try:
            kwargs = artifact.build_deploy_kwargs(spec, params,
                                                  device=self.device)
        except Exception as e:  # the build is part of the deploy
            raise DeployError(
                f"deploy of {model!r} v{version} failed during build on "
                f"{self.device}", model=model, version=version,
                stage="build", cause=f"{type(e).__name__}: {e}") from e
        if req.get("canary_fraction") is not None:
            kwargs["canary_fraction"] = req["canary_fraction"]
        v = self.registry.deploy(model, version=version, **kwargs)
        warm_ms = round((time.perf_counter() - t0) * 1e3, 3)
        p1 = self.profile.snapshot()
        kinds = {k: p1["by_kind"][k] - p0["by_kind"][k]
                 for k in profile.COMPILE_KINDS}
        s1 = self.store.stats() if self.store is not None else {}
        hits = s1.get("hit", 0) - s0.get("hit", 0)
        misses = s1.get("miss", 0) - s0.get("miss", 0)
        compiles = p1["compiles"] - p0["compiles"]
        _slog.info("fleet_activate", model=model, version=v,
                   compiles=compiles, warm_ms=warm_ms, rank=self.rank,
                   store_hits=hits, store_misses=misses, **kinds)
        return {"result": {"version": v, "compiles": compiles,
                           "store_hits": hits, "store_misses": misses,
                           "warm_ms": warm_ms, "rank": self.rank,
                           **{f"{k}s": n for k, n in kinds.items()}}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.serving.fleet.worker",
        description="fleet serving worker (module docstring)")
    ap.add_argument("--share", required=True,
                    help="shared fleet directory (artifacts live under "
                         "deploys/, the store wherever ZOO_EXECSTORE_DIR "
                         "points)")
    ap.add_argument("--port-file", required=True,
                    help="written atomically with the bound port once "
                         "the worker is listening (readiness signal)")
    ap.add_argument("--registry-json", default=None,
                    help="ModelRegistry kwargs as JSON")
    ap.add_argument("--fake", action="store_true",
                    help="serve stub builders only; touch no device")
    ap.add_argument("--device", default="cuda",
                    help="the device every build of this worker uses "
                         "(default cuda; 'cpu' to serve on the CPU)")
    args = ap.parse_args(argv)

    flightrec.install_from_env()
    reg_kwargs = json.loads(args.registry_json) if args.registry_json \
        else {}
    pager_env = envcontract.env_str("ZOO_PAGER_RESIDENT")
    if pager_env and "pager" not in reg_kwargs:
        try:
            reg_kwargs["pager"] = {"max_resident": int(pager_env)}
        except ValueError:
            _slog.error("fleet_worker_bad_pager_env", value=pager_env)
    worker = ServingWorker(args.share, registry_kwargs=reg_kwargs,
                           fake=args.fake, device=args.device)
    port = worker.bind()
    flightrec.atomic_write(args.port_file, str(port))
    _slog.info("fleet_worker_up", rank=worker.rank,
               incarnation=worker.incarnation, port=port,
               fake=worker.fake, device=worker.device, pid=os.getpid())
    try:
        worker.serve_forever()
    finally:
        flightrec.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
