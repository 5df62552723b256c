"""``python -m analytics_zoo_tpu_torch.launcher``: run a training script
as one process, as one process of a pod, or as a supervised local pod.

Counterpart of ``analytics_zoo_tpu/launcher.py`` (``zoo-tpu-submit``),
with its modes and flags.  It prepares the ``torch.distributed``
environment contract (``ZOO_TPU_COORDINATOR`` / ``NUM_PROCESSES`` /
``PROCESS_ID``, read by ``parallel/distributed.py`` when ``Trainer.fit``
starts) and runs the user's script.

* single process (the default): run the script;
* pod process (``--process-id`` given): export the contract for this
  rank, then run the script (once per host);
* local fan-out (``--num-processes N``, no ``--process-id``): start N
  worker processes on this machine, under a supervisor.

The supervisor is the coarse-grained recovery loop of the reference's
failure story: a worker that exits non-zero, or whose heartbeat file
(``ZOO_HEARTBEAT_FILE``, touched by ``Trainer.fit`` at every step) goes
stale past ``--watchdog-sec`` and is SIGKILLed, tears the whole pod down
at once (no survivor is left blocked in a collective), and within
``--max-restarts`` the pod is relaunched with ``ZOO_RESUME=1`` and
``ZOO_RESTART_COUNT``, so a checkpointing ``fit`` resumes from the newest
complete snapshot.  Relaunches back off exponentially from
``--restart-backoff`` (at most 30 s).  Worker 0 failing to bind the
coordinator's port at start-up is retried on a fresh port without
spending the restart budget.  ``--summary-json`` writes the restarts,
their reasons, the exit code, the post-mortems and the supervisor's
counters.  See ``train/faults.py`` for the worker's side of the
contract.

Every worker records its black box under the pod's flight-recorder
directory (``ZOO_FLIGHTREC_DIR``: a value set before the launch wins,
else ``<run_dir>/flightrec``; ``observability/flightrec.py``).  After a
crash or a hang the supervisor harvests them into
``pod_postmortem.json`` (each rank's last completed step, heartbeats,
spans and log tail, with the exit codes and heartbeat ages only the
supervisor saw) and merges their metric snapshots into
``pod_metrics.prom`` (``observability/aggregate.py``) before it
relaunches; a run with a post-mortem keeps its run directory.

``--devices-per-process`` and ``--platform`` configure the JAX package's
virtual CPU devices and platform; they are accepted and ignored here
(a worker runs on the device its model was built on).

Examples:
  python -m analytics_zoo_tpu_torch.launcher train.py --epochs 10
  python -m analytics_zoo_tpu_torch.launcher --num-processes 2 \\
      --max-restarts 3 --watchdog-sec 300 train.py
  python -m analytics_zoo_tpu_torch.launcher --coordinator host0:9876 \\
      --num-processes 16 --process-id 3 train.py
"""

from __future__ import annotations

import argparse
import json
import os
import re
import runpy
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from . import envcontract
from .observability import flightrec
from .observability.log import get_logger
from .parallel.distributed import ENV_COORD, ENV_NPROC, ENV_PID
from .train import faults
from .train import metrics as train_metrics

log = get_logger("analytics_zoo_tpu_torch.launcher")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# worker 0's stderr when the coordinator could not bind the probed port
# (the _free_port race): retried on a fresh port, off the restart budget
_BIND_ERR_RE = re.compile(
    r"(?i)address already in use|errno 98|eaddrinuse|failed to bind|"
    r"bind failed|error binding|failed to listen")
_PORT_RETRIES = 3
_STARTUP_WINDOW_S = 60.0
_MAX_BACKOFF_S = 30.0


def _run_script(script: str, script_args: List[str]):
    sys.argv = [script] + list(script_args)
    runpy.run_path(script, run_name="__main__")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.launcher",
        description="Run a training or inference script: one process, "
                    "one process of a pod, or a supervised local pod.")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 (pod mode)")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank in the pod; omit with "
                             "--num-processes>1 to fan out locally")
    parser.add_argument("--devices-per-process", type=int, default=None,
                        help="ignored (JAX virtual CPU devices)")
    parser.add_argument("--platform", default=None,
                        help="ignored (the JAX package's platform)")
    parser.add_argument("--max-restarts", type=int, default=0,
                        help="local fan-out: relaunch a crashed or hung "
                             "pod up to this many times with ZOO_RESUME=1 "
                             "(0: supervise and reap only)")
    parser.add_argument("--restart-backoff", type=float, default=1.0,
                        help="base seconds between relaunches (doubles "
                             "a restart, at most 30 s)")
    parser.add_argument("--watchdog-sec", type=float, default=0.0,
                        help="SIGKILL and relaunch the pod when a worker's "
                             "heartbeat file is older than this (0: off; "
                             "size it above the longest step)")
    parser.add_argument("--summary-json", default=None,
                        help="write the supervision summary (restarts, "
                             "reasons, rc) to this path on exit")
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.num_processes <= 1:
        if args.process_id is not None or args.coordinator:
            parser.error("--process-id/--coordinator require "
                         "--num-processes > 1 (pod mode)")
        _run_script(args.script, args.script_args)
        return 0

    if args.process_id is not None:
        if not args.coordinator:
            parser.error("--coordinator is required with --process-id")
        os.environ[ENV_COORD] = args.coordinator
        os.environ[ENV_NPROC] = str(args.num_processes)
        os.environ[ENV_PID] = str(args.process_id)
        _run_script(args.script, args.script_args)
        return 0

    return _run_supervised(args)


def _flight_dir(run_dir: str) -> str:
    """The pod's flight-recorder directory: a ``ZOO_FLIGHTREC_DIR`` set
    before the launch wins (a drill harvests it itself), else it lives
    with the other supervision files."""
    return (envcontract.env_str(flightrec.ENV_DIR)
            or os.path.join(run_dir, "flightrec"))


def _spawn_pod(args, coordinator: str, run_dir: str, incarnation: int,
               resume: bool):
    """Start every worker of one incarnation.  Each worker's stderr goes
    to a file of its own (replayed when the pod ends), where the bind
    race is read from."""
    procs, hb_paths, err_paths = [], [], []
    for pid in range(args.num_processes):
        env = dict(os.environ)
        env[ENV_COORD] = coordinator
        env[ENV_NPROC] = str(args.num_processes)
        env[ENV_PID] = str(pid)
        env[flightrec.ENV_DIR] = _flight_dir(run_dir)
        env[faults.ENV_RESTART_COUNT] = str(incarnation)
        # a fresh heartbeat file per incarnation: an old mtime must not
        # hide a hang; ZOO_RESUME only on relaunches
        hb = os.path.join(run_dir, f"hb_p{pid}.r{incarnation}")
        env[faults.ENV_HEARTBEAT] = hb
        hb_paths.append(hb)
        env.pop(faults.ENV_RESUME, None)
        if resume:
            env[faults.ENV_RESUME] = "1"
        err = os.path.join(run_dir, f"stderr_p{pid}.r{incarnation}.log")
        err_paths.append(err)
        with open(err, "wb") as errf:
            procs.append(subprocess.Popen(
                [sys.executable, args.script] + list(args.script_args),
                env=env, stderr=errf))
    return procs, hb_paths, err_paths


def _supervise(procs: list, hb_paths: List[str], watchdog_sec: float,
               started: float, poll_s: float = 0.2):
    """Watch one incarnation until it resolves: ``("ok", None)`` when
    every worker exited 0, ``("exit", rank)`` at the first non-zero exit,
    ``("watchdog", rank)`` when a live worker's heartbeat file is older
    than the window (only once the worker has made it)."""
    while True:
        alive = False
        for rank, p in enumerate(procs):
            rc = p.poll()
            if rc is None:
                alive = True
            elif rc != 0:
                return "exit", rank
        if not alive:
            return "ok", None
        if watchdog_sec:
            now = time.time()
            for rank, (p, hb) in enumerate(zip(procs, hb_paths)):
                if p.poll() is not None:
                    continue
                try:
                    last = os.path.getmtime(hb)
                except OSError:
                    continue  # no heartbeat yet: still starting
                if now - max(last, started) > watchdog_sec:
                    return "watchdog", rank
        time.sleep(poll_s)


def _reap_pod(procs: list, grace_s: float = 5.0,
              kill_first: Optional[int] = None) -> None:
    """Tear the pod down: SIGKILL the hung worker (if any), terminate the
    rest, wait out the grace period, then kill what is left."""
    if kill_first is not None and procs[kill_first].poll() is None:
        procs[kill_first].kill()
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + grace_s
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:
        if p.poll() is None:
            p.kill()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def _replay_stderr(err_paths: List[str]) -> List[str]:
    """Copy each worker's stderr to ours; return the texts."""
    texts = []
    for rank, path in enumerate(err_paths):
        try:
            with open(path, "rb") as f:
                text = f.read().decode("utf-8", "replace")
        except OSError:
            text = ""
        texts.append(text)
        if text.strip():
            sys.stderr.write(f"--- worker {rank} stderr ---\n{text}")
            if not text.endswith("\n"):
                sys.stderr.write("\n")
            sys.stderr.flush()
    return texts


def _run_supervised(args) -> int:
    run_dir = tempfile.mkdtemp(prefix="zoo-pod-")
    coordinator = args.coordinator or f"localhost:{_free_port()}"
    reasons: List[str] = []
    postmortems: List[str] = []
    rc = 1
    try:
        rc = _supervision_loop(args, run_dir, coordinator, reasons,
                               postmortems)
    finally:
        if args.summary_json:
            with open(args.summary_json, "w") as f:
                json.dump({"rc": rc,
                           "restarts": sum(r in ("exit", "watchdog")
                                           for r in reasons),
                           "port_retries": reasons.count("port"),
                           "reasons": reasons,
                           "postmortems": postmortems,
                           "metrics": train_metrics.snapshot()}, f)
        if rc == 0 and not postmortems:
            shutil.rmtree(run_dir, ignore_errors=True)
        else:
            # an incident, even one the pod recovered from, is worth
            # reading: the post-mortem, heartbeats, stderr and black boxes
            log.info("supervision files kept", run_dir=run_dir, rc=rc,
                     postmortems=postmortems)
    return rc


def _write_pod_postmortem(run_dir: str, outcome: str,
                          rank: Optional[int], incarnation: int,
                          procs: list, hb_ages: dict,
                          stale_ranks: Optional[List[int]] = None
                          ) -> Optional[str]:
    """Harvest every worker's flight recorder into the pod post-mortem
    (``flightrec.write_postmortem``: each rank's last steps, heartbeats,
    spans and log tail) with the evidence only the supervisor has (exit
    codes and heartbeat-file ages at the reap), and merge the ranks'
    metric snapshots into ``pod_metrics.prom`` beside it.  Best effort:
    a failed post-mortem never stops the restart."""
    supervisor = {
        r: {"rc": p.returncode, "heartbeat_age_s": hb_ages.get(r)}
        for r, p in enumerate(procs)}
    path = os.path.join(run_dir, f"pod_postmortem.i{incarnation}.json")
    try:
        pm = flightrec.write_postmortem(
            _flight_dir(run_dir), path, reason=outcome, failed_rank=rank,
            incarnation=incarnation, supervisor=supervisor,
            # a hung collective stalls every participant's heartbeat: the
            # whole stale set is the evidence, the convicted rank the one
            # the watchdog found first
            extra=({"stale_ranks": stale_ranks}
                   if stale_ranks is not None else None))
        flightrec.atomic_write(os.path.join(run_dir, "pod_postmortem.json"),
                               json.dumps(pm, indent=2, default=str))
    except Exception as e:
        log.error("could not write the pod post-mortem", run_dir=run_dir,
                  error=f"{type(e).__name__}: {e}")
        return None
    try:
        from .observability import aggregate
        flightrec.atomic_write(os.path.join(run_dir, "pod_metrics.prom"),
                               aggregate.aggregate_dir(_flight_dir(run_dir)))
    except Exception:
        pass  # no snapshot yet is a legal post-mortem state
    failed = pm.get("ranks", {}).get(str(rank), {})
    log.error("pod post-mortem written", path=path, reason=outcome,
              failed_rank=rank, last_step=failed.get("last_step"),
              heartbeat_age_s=failed.get("heartbeat_age_s"))
    return path


def _supervision_loop(args, run_dir: str, coordinator: str,
                      reasons: List[str], postmortems: List[str]) -> int:
    restarts = port_retries = incarnation = 0
    while True:
        started = time.time()
        procs, hb_paths, err_paths = _spawn_pod(
            args, coordinator, run_dir, incarnation, resume=restarts > 0)
        try:
            outcome, rank = _supervise(procs, hb_paths, args.watchdog_sec,
                                       started)
        except KeyboardInterrupt:
            # a grace period first (checkpoint files mid-write), then kill
            _reap_pod(procs, grace_s=10.0)
            _replay_stderr(err_paths)
            reasons.append("interrupt")
            return 130
        if outcome == "ok":
            _replay_stderr(err_paths)
            return 0
        # heartbeat ages at detection (the reap takes up to its grace
        # period); stale ranks are the live workers past the window
        now = time.time()
        hb_ages, stale_ranks = {}, []
        for r, hb in enumerate(hb_paths):
            try:
                hb_ages[r] = round(now - os.path.getmtime(hb), 3)
            except OSError:
                hb_ages[r] = None  # died before its first heartbeat
            if (outcome == "watchdog" and procs[r].poll() is None
                    and hb_ages[r] is not None
                    and hb_ages[r] > args.watchdog_sec):
                stale_ranks.append(r)
        failed_rc = procs[rank].returncode if outcome == "exit" else None
        _reap_pod(procs, grace_s=5.0,
                  kill_first=rank if outcome == "watchdog" else None)
        texts = _replay_stderr(err_paths)
        incarnation += 1
        if (outcome == "exit" and rank == 0 and not args.coordinator
                and time.time() - started < _STARTUP_WINDOW_S
                and port_retries < _PORT_RETRIES
                and _BIND_ERR_RE.search(texts[0] if texts else "")):
            port_retries += 1
            reasons.append("port")
            train_metrics.record_restart("port")
            coordinator = f"localhost:{_free_port()}"
            log.warning("coordinator port collision: relaunching the pod "
                        "on a fresh port", retry=port_retries,
                        coordinator=coordinator)
            continue
        # a real incident (not a bind race): harvest the black boxes now,
        # before the next incarnation writes beside them
        pm = _write_pod_postmortem(
            run_dir, outcome, rank, incarnation - 1, procs, hb_ages,
            stale_ranks=stale_ranks if outcome == "watchdog" else None)
        if pm:
            postmortems.append(pm)
        if restarts >= args.max_restarts:
            log.error("pod failed and the restart budget is spent",
                      reason=outcome, rank=rank, rc=failed_rc,
                      max_restarts=args.max_restarts)
            if failed_rc is None or failed_rc == 0:
                return 1
            # a death by signal N gives the shell's 128 + N
            return failed_rc if failed_rc > 0 else 128 - failed_rc
        restarts += 1
        reasons.append(outcome)
        train_metrics.record_restart(outcome)
        backoff = min(args.restart_backoff * (2 ** (restarts - 1)),
                      _MAX_BACKOFF_S)
        log.warning("pod worker failed: relaunching with ZOO_RESUME",
                    reason=outcome, rank=rank, rc=failed_rc,
                    restart=restarts, max_restarts=args.max_restarts,
                    backoff_s=round(backoff, 3))
        time.sleep(backoff)


def shell_main(argv: Optional[List[str]] = None) -> int:
    """An interactive session with the port imported (the reference's
    ``jupyter-with-zoo.sh``): a REPL (IPython when installed) with
    ``zoo``, ``ctx`` (the session, ``zoo.init_nncontext``), ``torch``,
    ``np`` and ``device`` bound, or with ``--jupyter`` a Jupyter notebook
    in the same environment."""
    parser = argparse.ArgumentParser(
        prog="zoo-torch-shell",
        description="Interactive REPL/Jupyter with analytics_zoo_tpu_torch "
                    "imported (reference jupyter-with-zoo.sh)")
    parser.add_argument("--jupyter", action="store_true",
                        help="launch jupyter notebook instead of a REPL")
    parser.add_argument("--app-name", default="zoo-tpu-torch-shell")
    parser.add_argument("--device", default=None,
                        help="the device bound as `device` (default: "
                             "cuda when available, else cpu)")
    parser.add_argument("jupyter_args", nargs=argparse.REMAINDER,
                        help="passed through to jupyter")
    args = parser.parse_args(argv)
    if args.jupyter:
        cmd = ["jupyter", "notebook"] + [
            a for a in args.jupyter_args if a != "--"]
        os.execvp(cmd[0], cmd)

    import numpy as np
    import torch
    import analytics_zoo_tpu_torch as zoo
    device = torch.device(args.device or (
        "cuda" if torch.cuda.is_available() else "cpu"))
    ctx = zoo.init_nncontext(args.app_name, device=device)
    ns = {"zoo": zoo, "ctx": ctx, "torch": torch, "np": np,
          "device": device}
    print(f"analytics-zoo-tpu-torch shell: torch {torch.__version__}, "
          f"device {device}, ctx up (mesh {ctx.axis_sizes()})\n"
          "bound: zoo, ctx, torch, np, device")
    try:
        from IPython import start_ipython
        return start_ipython(argv=["--no-banner"], user_ns=ns) or 0
    except ImportError:
        import code
        code.interact(banner="", local=ns)
        return 0


if __name__ == "__main__":
    sys.exit(main())
