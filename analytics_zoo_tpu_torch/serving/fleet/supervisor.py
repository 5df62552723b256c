"""Fleet supervisor: N worker processes, each crash-restarted on its
own.

Counterpart of ``analytics_zoo_tpu/serving/fleet/supervisor.py``.  The
training launcher reaps the WHOLE pod on one death because training
workers are welded together by collectives; serving workers are not:
each is a complete single-process data plane, so the failure unit is
one worker.  A crash (or a heartbeat stale past the watchdog window)
costs the fleet one worker's capacity while the others serve, and the
replacement warms back from the share and the kernel store.

Per worker, per incident:

* the dead worker's flight recorder is harvested into
  ``worker_postmortem.r{rank}.i{inc}.json`` (``flightrec.write_postmortem``,
  with the supervisor's evidence, exit rc and heartbeat age, merged in);
* within ``max_restarts`` (per worker) a fresh incarnation starts after
  an exponential backoff, with ``ZOO_RESTART_COUNT`` bumped so its
  recorder and log identity are right and one-shot fault hooks disarm;
* ``on_worker_up(rank, port, incarnation)`` fires once it listens: the
  router replays the current version set onto the blank worker there,
  BEFORE routing traffic at it;
* past the budget the worker is ``dead`` and stays so
  (``zoo_fleet_workers{state}`` shows the degradation).

The pool is elastic: ``add_worker``/``revive`` grow it (the newcomer
warms through the same ``on_worker_up`` replay) and ``retire`` is the
deliberate scale-down terminal, marked BEFORE the terminate so the
monitor never books a drained worker's exit as a crash.

Workers are started with ``subprocess.Popen`` of a fresh interpreter
(``python -m analytics_zoo_tpu_torch.serving.fleet.worker``), never by
fork: the parent may hold a CUDA context.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ... import envcontract
from ...observability import flightrec
from ...observability.log import get_logger

_slog = get_logger("zoo.serving.fleet.supervisor")

_MAX_BACKOFF_S = 30.0
_POLL_S = 0.1


class _WorkerProc:
    """Supervisor-side record of one worker slot."""

    def __init__(self, rank: int):
        self.rank = rank
        self.proc: Optional[subprocess.Popen] = None
        self.incarnation = 0
        self.restarts = 0
        # live | restarting | dead | retired — ``retired`` is the
        # elastic-pool scale-down terminal: deliberate, drained, NOT
        # an incident (no postmortem, no restart budget spent); the
        # slot can be revived by a later scale-up
        self.state = "restarting"
        self.port: Optional[int] = None
        self.port_file = ""
        self.hb_path = ""
        self.restart_at = 0.0
        self.last_reason: Optional[str] = None


class FleetSupervisor:
    """Spawn + supervise the worker plane (module docstring).

    ``env`` entries overlay the inherited environment for every worker
    (the caller points ``ZOO_EXECSTORE_DIR`` at the share, sets
    ``PYTHONPATH``, ...); ``device`` is every worker's ``--device``.
    ``on_worker_up`` / ``on_worker_down`` run on the monitor thread —
    keep them quick or
    lock-light (the router's re-activation warm is the intended
    heavyweight case; incidents on other workers queue behind it)."""

    def __init__(self, n_workers: int, run_dir: str, share_dir: str, *,
                 fake: bool = False, device: str = "cuda",
                 registry_json: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 max_restarts: int = 2,
                 restart_backoff: float = 0.5,
                 watchdog_sec: float = 0.0,
                 on_worker_up: Optional[Callable] = None,
                 on_worker_down: Optional[Callable] = None):
        self.run_dir = run_dir
        self.share_dir = share_dir
        self.fake = fake
        self.device = device
        self.registry_json = registry_json
        self.extra_env = dict(env or {})
        self.max_restarts = max_restarts
        self.restart_backoff = restart_backoff
        self.watchdog_sec = watchdog_sec
        self.on_worker_up = on_worker_up
        self.on_worker_down = on_worker_down
        self.workers = [_WorkerProc(r) for r in range(n_workers)]
        self.postmortems: List[str] = []
        self._stopping = False
        self._lock = threading.Lock()
        self._monitor: Optional[threading.Thread] = None
        os.makedirs(run_dir, exist_ok=True)

    # ---- lifecycle ----
    def flight_dir(self) -> str:
        """Shared flight-recorder base: a pre-set outer
        ``ZOO_FLIGHTREC_DIR`` wins (drills harvest it themselves) —
        the launcher's convention."""
        return (envcontract.env_str(flightrec.ENV_DIR)
                or os.path.join(self.run_dir, "flightrec"))

    def start(self) -> None:
        for w in self.workers:
            self._spawn(w)
        self._monitor = threading.Thread(target=self._watch,
                                         name="fleet-supervisor",
                                         daemon=True)
        self._monitor.start()

    def _spawn(self, w: _WorkerProc) -> None:
        inc = w.incarnation
        w.port = None
        w.port_file = os.path.join(self.run_dir,
                                   f"worker{w.rank}.i{inc}.port")
        w.hb_path = os.path.join(self.run_dir,
                                 f"hb_w{w.rank}.i{inc}")
        err_path = os.path.join(self.run_dir,
                                f"stderr_w{w.rank}.i{inc}.log")
        # a second supervisor lifetime over the same run_dir reuses
        # these paths: a STALE port file must not read as readiness
        # (it names a dead socket) and a stale heartbeat mtime must
        # not trip the watchdog before the fresh worker's first beat
        for stale in (w.port_file, w.hb_path):
            try:
                os.unlink(stale)
            except OSError:
                pass
        env = dict(os.environ)
        env.update(self.extra_env)
        env["ZOO_TPU_PROCESS_ID"] = str(w.rank)
        env["ZOO_RESTART_COUNT"] = str(inc)
        env["ZOO_HEARTBEAT_FILE"] = w.hb_path
        env[flightrec.ENV_DIR] = self.flight_dir()
        # a worker is not a training pod member: the trainer resume /
        # fault contract must not leak in from an outer drill
        env.pop("ZOO_RESUME", None)
        cmd = [sys.executable, "-m",
               "analytics_zoo_tpu_torch.serving.fleet.worker",
               "--share", self.share_dir, "--port-file", w.port_file,
               "--device", self.device]
        if self.fake:
            cmd.append("--fake")
        if self.registry_json:
            cmd += ["--registry-json", self.registry_json]
        with open(err_path, "wb") as errf:
            w.proc = subprocess.Popen(cmd, env=env, stderr=errf)
        w.state = "restarting"  # live once the port file lands
        _slog.info("fleet_worker_spawned", rank=w.rank,
                   incarnation=inc, pid=w.proc.pid)

    # ---- monitoring ----
    def _watch(self) -> None:
        """The supervision poll loop: death detection + postmortem,
        bounded backoff restart, readiness promotion, heartbeat
        watchdog."""
        while not self._stopping:
            now = time.monotonic()
            for w in list(self.workers):
                if w.state in ("dead", "retired"):
                    continue
                if w.proc is not None:
                    rc = w.proc.poll()
                    if rc is not None and not self._stopping:
                        self._incident(w, rc)
                        continue
                if w.proc is None:
                    if now >= w.restart_at:
                        w.incarnation += 1
                        self._spawn(w)
                    continue
                if w.state == "restarting":
                    port = self._read_port(w)
                    if port is not None and now >= w.restart_at:
                        self._promote_live(w, port)
                elif (self.watchdog_sec and w.state == "live"):
                    age = self._hb_age(w)
                    if age is not None and age > self.watchdog_sec:
                        _slog.error("fleet_watchdog_kill", rank=w.rank,
                                    heartbeat_age_s=round(age, 3),
                                    watchdog_sec=self.watchdog_sec)
                        w.last_reason = "watchdog"
                        try:
                            w.proc.send_signal(signal.SIGKILL)
                        except OSError:
                            pass
            time.sleep(_POLL_S)

    def _read_port(self, w: _WorkerProc) -> Optional[int]:
        try:
            with open(w.port_file) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _hb_age(self, w: _WorkerProc) -> Optional[float]:
        try:
            return time.time() - os.path.getmtime(w.hb_path)
        except OSError:
            return None  # no beat yet: startup is covered by exits

    def _promote_live(self, w: _WorkerProc, port: int) -> None:
        w.port = port
        cb = self.on_worker_up
        if cb is not None:
            try:
                cb(w.rank, port, w.incarnation)
            except Exception as e:  # noqa: BLE001 — a failed replay
                # leaves the worker out of rotation; the next incident
                # or deploy retries it.  Never kill the monitor.
                _slog.error("fleet_worker_up_hook_failed", rank=w.rank,
                            error=f"{type(e).__name__}: {e}")
                w.restart_at = time.monotonic() + 0.5  # bounded retry
                return
        w.state = "live"
        _slog.info("fleet_worker_live", rank=w.rank, port=port,
                   incarnation=w.incarnation)

    def _incident(self, w: _WorkerProc, rc: int) -> None:
        """One worker death: evidence first, then the restart
        decision.  Heartbeat age is sampled at detection (the
        postmortem must reflect what the watchdog saw, not what the
        reap left behind)."""
        if w.state == "retired":
            # a deliberate retire whose exit the poll caught before
            # the state check: not an incident, no postmortem
            return
        reason = w.last_reason or "exit"
        w.last_reason = None
        age = self._hb_age(w)
        _slog.error("fleet_worker_down", rank=w.rank, rc=rc,
                    reason=reason, incarnation=w.incarnation,
                    heartbeat_age_s=(round(age, 3)
                                     if age is not None else None))
        cb = self.on_worker_down
        if cb is not None:
            try:
                cb(w.rank)
            except Exception:  # noqa: BLE001
                pass
        pm_path = os.path.join(
            self.run_dir,
            f"worker_postmortem.r{w.rank}.i{w.incarnation}.json")
        try:
            flightrec.write_postmortem(
                self.flight_dir(), pm_path, reason=reason,
                failed_rank=w.rank, incarnation=w.incarnation,
                supervisor={w.rank: {
                    "rc": rc,
                    "heartbeat_age_s": (round(age, 3)
                                        if age is not None else None)}})
            self.postmortems.append(pm_path)
        except Exception as e:  # noqa: BLE001 — a postmortem failure
            # must never eat the restart itself
            _slog.error("fleet_postmortem_failed", rank=w.rank,
                        error=f"{type(e).__name__}: {e}")
        w.proc = None
        w.port = None
        if w.restarts >= self.max_restarts:
            w.state = "dead"
            _slog.error("fleet_worker_dead", rank=w.rank,
                        restarts=w.restarts,
                        max_restarts=self.max_restarts)
            return
        w.restarts += 1
        backoff = min(self.restart_backoff * (2 ** (w.restarts - 1)),
                      _MAX_BACKOFF_S)
        w.state = "restarting"
        w.restart_at = time.monotonic() + backoff
        _slog.warning("fleet_worker_restarting", rank=w.rank,
                      restart=w.restarts, backoff_s=round(backoff, 3))

    # ---- elastic pool ----
    def add_worker(self) -> int:
        """Scale-up: append a fresh worker slot and spawn it (the
        monitor promotes it live once its port file lands, firing
        ``on_worker_up``: the replay warms it from the share and the
        store).  Returns the new rank."""
        with self._lock:
            w = _WorkerProc(len(self.workers))
            self.workers.append(w)
        self._spawn(w)
        _slog.info("fleet_worker_added", rank=w.rank)
        return w.rank

    def revive(self, rank: int) -> None:
        """Scale-up into a previously retired slot: a fresh
        incarnation with a fresh restart budget (retirement was
        deliberate, not a crash record to hold against it)."""
        w = self.workers[rank]
        if w.state != "retired":
            raise ValueError(f"worker {rank} is {w.state}, not retired")
        w.restarts = 0
        w.incarnation += 1
        w.restart_at = 0.0
        self._spawn(w)
        _slog.info("fleet_worker_revived_slot", rank=rank)

    def retire(self, rank: int, grace_s: float = 5.0) -> None:
        """Scale-down terminal for one DRAINED worker: mark retired
        FIRST (so the monitor treats the exit as deliberate — no
        postmortem, no restart), then terminate, grace, kill and
        reap.  The caller owns the drain: no new work routed and
        in-flight requests completed before calling this."""
        w = self.workers[rank]
        w.state = "retired"
        w.port = None
        p, w.proc = w.proc, None
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        _slog.info("fleet_worker_retired", rank=rank)

    # ---- introspection ----
    def states(self) -> Dict[str, int]:
        out = {"live": 0, "restarting": 0, "dead": 0, "retired": 0}
        for w in self.workers:
            out[w.state] = out.get(w.state, 0) + 1
        return out

    def live_workers(self) -> List[_WorkerProc]:
        return [w for w in self.workers
                if w.state == "live" and w.port is not None]

    def worker(self, rank: int) -> _WorkerProc:
        return self.workers[rank]

    def kill(self, rank: int, sig: int = signal.SIGKILL) -> None:
        """Drill hook: SIGKILL one worker (the supervisor detects and
        restarts it exactly as it would a real crash)."""
        w = self.workers[rank]
        if w.proc is not None and w.proc.poll() is None:
            w.proc.send_signal(sig)

    # ---- shutdown ----
    def stop(self, grace_s: float = 5.0) -> None:
        """Tear the fleet down: terminate, grace, kill, monitor joined.
        Idempotent."""
        self._stopping = True
        if self._monitor is not None:
            self._monitor.join(timeout=10)
            self._monitor = None
        procs = [w.proc for w in self.workers if w.proc is not None]
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + grace_s
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.1,
                                       deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        for p in procs:
            if p.poll() is None:
                p.kill()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
