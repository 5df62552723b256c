"""The port's supervising launcher (``python -m
analytics_zoo_tpu_torch.launcher``).

Counterparts of ``tests/test_supervisor.py``, driving the real
supervisor with trivial workers that import nothing (fast): a crash
relaunches the pod with ``ZOO_RESUME=1``; a partial death is reaped at
once; a stale heartbeat is SIGKILLed and relaunched; a spent restart
budget surfaces the worker's exit code; the coordinator's bind race is
retried on a fresh port.  Counterparts of ``tests/test_launcher.py``:
a single process, pod mode's required coordinator, the shell.  And one
drill on a real two-rank gloo group: rank 1 SIGKILLs itself after step
6 of 12, the supervisor reaps and relaunches the pod, both ranks resume
from the newest complete snapshot (tag 4: rank 0's tag 6 never
committed) and finish bit for bit on an uninterrupted run's weights.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a fake pod worker: no torch, just the supervision contract.  Modes:
#   crash   - rank 1 exits 3 in the first incarnation
#   partial - rank 1 exits 2; rank 0 "blocks in a collective" (sleeps)
#   hang    - rank 1 heartbeats once, then stops
#   bind    - rank 0 prints a bind error and exits 1 until the flag file
WORKER = textwrap.dedent("""
    import os, sys, time
    rank = int(os.environ.get("ZOO_TPU_PROCESS_ID", "0"))
    mode, flag = sys.argv[1], sys.argv[2]
    hb = os.environ.get("ZOO_HEARTBEAT_FILE")
    resume = os.environ.get("ZOO_RESUME")

    def beat():
        if hb:
            with open(hb, "a"):
                os.utime(hb, None)

    if mode == "crash" and rank == 1 and not resume:
        sys.exit(3)
    if mode == "hang" and rank == 1 and not resume:
        beat()
        time.sleep(300)
    if mode == "bind" and rank == 0 and not os.path.exists(flag):
        open(flag, "w").close()
        print("RuntimeError: The server socket has failed to bind "
              "(errno: 98 - Address already in use)", file=sys.stderr)
        sys.exit(1)
    if mode == "partial" and rank == 1:
        sys.exit(2)
    if mode == "partial" and rank == 0:
        time.sleep(300)
    for _ in range(4):
        beat()
        time.sleep(0.05)
    print(f"DONE rank={rank} resume={resume or 0} "
          f"restart_count={os.environ.get('ZOO_RESTART_COUNT', 0)}",
          flush=True)
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    for k in list(env):
        if k.startswith(("ZOO_TPU_", "ZOO_RESUME", "ZOO_FAULT_",
                         "ZOO_CKPT_SYNC", "ZOO_HEARTBEAT")):
            env.pop(k)
    env.update(extra)
    return env


def _launch(tmp_path, mode, extra_args=(), timeout=120):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    summary = tmp_path / "summary.json"
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher",
         "--num-processes", "2", "--restart-backoff", "0.1",
         "--summary-json", str(summary)] + list(extra_args)
        + [str(script), mode, str(tmp_path / "flag")],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=timeout)
    summ = json.loads(summary.read_text()) if summary.exists() else None
    return proc, summ


def test_crash_restarts_with_resume_env(tmp_path):
    proc, summ = _launch(tmp_path, "crash", ["--max-restarts", "1"])
    assert proc.returncode == 0, proc.stdout[-2000:]
    assert summ["restarts"] == 1 and summ["reasons"] == ["exit"]
    assert "DONE rank=0 resume=1 restart_count=1" in proc.stdout
    assert "DONE rank=1 resume=1" in proc.stdout
    assert summ["metrics"]["restarts"] == {"exit": 1}


def test_partial_death_fast_fails_with_no_restarts(tmp_path):
    start = time.time()
    proc, summ = _launch(tmp_path, "partial")
    wall = time.time() - start
    assert proc.returncode == 2, proc.stdout[-2000:]
    assert wall < 60, f"the supervisor waited on the survivor ({wall:.0f}s)"
    assert summ["restarts"] == 0 and summ["rc"] == 2


def test_watchdog_kills_and_restarts_hung_worker(tmp_path):
    proc, summ = _launch(tmp_path, "hang",
                         ["--max-restarts", "1", "--watchdog-sec", "2"])
    assert proc.returncode == 0, proc.stdout[-2000:]
    assert summ["reasons"] == ["watchdog"], summ
    assert "DONE rank=1 resume=1" in proc.stdout
    assert summ["metrics"]["restarts"] == {"watchdog": 1}


def test_restart_budget_exhaustion_fails(tmp_path):
    proc, summ = _launch(tmp_path, "crash")
    assert proc.returncode == 3
    assert summ == {"rc": 3, "restarts": 0, "port_retries": 0,
                    "reasons": [], "metrics": summ["metrics"]}


def test_coordinator_bind_race_retried_with_fresh_port(tmp_path):
    proc, summ = _launch(tmp_path, "bind")
    assert proc.returncode == 0, proc.stdout[-2000:]
    assert summ["port_retries"] == 1 and summ["restarts"] == 0
    assert summ["reasons"] == ["port"]
    assert "DONE rank=0 resume=0" in proc.stdout


def _submit(args, script, timeout=240, **env):
    return subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher"] + args
        + [str(script)], env=_env(**env), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=timeout)


def test_single_process(tmp_path):
    script = tmp_path / "demo.py"
    script.write_text("import sys; print('RESULT', sys.argv[1:])")
    proc = _submit(["--platform", "cpu", "--devices-per-process", "4"],
                   script)
    assert proc.returncode == 0, proc.stdout[-2000:]
    assert "RESULT []" in proc.stdout


def test_pod_mode_requires_coordinator(tmp_path):
    script = tmp_path / "demo.py"
    script.write_text("print('hi')")
    proc = _submit(["--num-processes", "4", "--process-id", "1"], script)
    assert proc.returncode != 0
    assert "--coordinator is required" in proc.stdout
    proc2 = _submit(["--process-id", "3"], script)
    assert proc2.returncode != 0
    assert "--num-processes" in proc2.stdout
    script.write_text("import os\nprint('ENV', *(os.environ[k] for k in ("
                      "'ZOO_TPU_COORDINATOR', 'ZOO_TPU_NUM_PROCESSES', "
                      "'ZOO_TPU_PROCESS_ID')))")
    proc3 = _submit(["--num-processes", "4", "--process-id", "1",
                     "--coordinator", "host0:9876"], script)
    assert proc3.returncode == 0 and "ENV host0:9876 4 1" in proc3.stdout


def test_zoo_torch_shell_repl():
    code = (
        "import sys, io\n"
        "import unittest.mock as mock\n"
        "with mock.patch.dict(sys.modules, {'IPython': None}):\n"
        "    sys.stdin = io.StringIO(\n"
        "        'print(\"NS\", \"zoo\" in dir(), device.type, "
        "zoo.__name__)\\n')\n"
        "    from analytics_zoo_tpu_torch.launcher import shell_main\n"
        "    sys.exit(shell_main(['--device', 'cpu']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=_env())
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "NS True cpu analytics_zoo_tpu_torch" in proc.stdout


TRAIN_DEMO = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    from analytics_zoo_tpu_torch.core.module import name_scope
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    from analytics_zoo_tpu_torch.parallel import distributed
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.train import triggers

    ckpt_dir, out = sys.argv[1], sys.argv[2]
    with name_scope("mlp"):
        m = Sequential(device="cpu", seed=0)
        m.add(L.Dense(16, activation="relu", input_shape=(8,)))
        m.add(L.Dropout(0.1))
        m.add(L.Dense(4))
    m.compile({"name": "sgd", "lr": 0.1, "momentum": 0.9},
              "sparse_categorical_crossentropy")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.integers(0, 4, 64).astype(np.int32)
    if ckpt_dir != "-":
        m.trainer.set_checkpoint(ckpt_dir,
                                 trigger=triggers.SeveralIteration(2))
    m.trainer.fit(Dataset.from_ndarray(x, y), batch_size=16,
                  end_trigger=triggers.MaxEpoch(3))
    rank = distributed.process_index()
    np.savez(f"{out}.p{rank}.npz",
             *[p.detach().numpy() for p in m.parameters()])
    print(f"RESULT proc={rank}/{distributed.process_count()} "
          f"step={m.trainer.state.step} "
          f"resumed={1 if os.environ.get('ZOO_RESUME') else 0}",
          flush=True)
""")


def test_supervisor_recovers_sigkilled_gloo_rank_mid_epoch(tmp_path):
    script = tmp_path / "train_demo.py"
    script.write_text(TRAIN_DEMO)
    ref = subprocess.run([sys.executable, str(script), "-",
                          str(tmp_path / "ref")], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "RESULT proc=0/1 step=12" in ref.stdout, ref.stderr[-2000:]
    summary = tmp_path / "summary.json"
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher",
         "--num-processes", "2", "--max-restarts", "2",
         "--restart-backoff", "0.25", "--summary-json", str(summary),
         str(script), str(tmp_path / "ckpt"), str(tmp_path / "out")],
        env=_env(ZOO_FAULT_CRASH_STEP="6", ZOO_FAULT_CRASH_RANK="1",
                 ZOO_CKPT_SYNC="1"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:]
    summ = json.loads(summary.read_text())
    assert summ["restarts"] == 1 and summ["reasons"] == ["exit"]
    lines = [l for l in proc.stdout.splitlines() if "RESULT" in l]
    assert any("proc=0/2 step=12 resumed=1" in l for l in lines), lines
    assert any("proc=1/2 step=12 resumed=1" in l for l in lines), lines
    # rank 0's tag 6 was written but never committed (rank 1 was gone)
    files = os.listdir(tmp_path / "ckpt")
    assert "ckpt_4.commit.json" in files and "ckpt_12.commit.json" in files
    with np.load(str(tmp_path / "ref.p0.npz")) as want:
        for rank in (0, 1):
            with np.load(str(tmp_path / f"out.p{rank}.npz")) as got:
                for k in want.files:
                    np.testing.assert_array_equal(got[k], want[k])
