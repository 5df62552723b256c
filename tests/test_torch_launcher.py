"""The port's supervising launcher (``python -m
analytics_zoo_tpu_torch.launcher``).

Counterparts of ``tests/test_supervisor.py``, driving the real
supervisor with trivial workers that import nothing (fast): a crash
relaunches the pod with ``ZOO_RESUME=1``; a partial death is reaped at
once; a stale heartbeat is SIGKILLed and relaunched; a spent restart
budget surfaces the worker's exit code; the coordinator's bind race is
retried on a fresh port; each incident's post-mortem harvests the
workers' flight recorders (written here in the on-disk framing, with a
torn tail) and lands the aggregated pod scrape beside it, and a hang's
names the stale heartbeat.  Counterparts of ``tests/test_launcher.py``:
a single process, pod mode's required coordinator, the shell.  And one
drill on a real two-rank gloo group training data-parallel (each rank
its half of the data): rank 1 SIGKILLs itself after step 6 of 12, the
supervisor reaps and relaunches the pod, both ranks resume from the
newest complete snapshot (tag 4: rank 0's tag 6 never committed) and
finish bit for bit on an uninterrupted pod's weights.
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
#   crashrec - each rank writes flight-recorder records and a snapshot
#              (stdlib framing: pins the format), rank 1 dies mid-write
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
    if mode == "crashrec":
        import json, struct, zlib
        d = os.path.join(os.environ["ZOO_FLIGHTREC_DIR"],
                         f"rank{rank}.i{os.environ.get('ZOO_RESTART_COUNT', 0)}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "events.seg"), "ab") as f:
            for step in range(1, 7):
                p = json.dumps({"t": "hb", "ts": time.time(),
                                "step": step}).encode()
                f.write(struct.pack("<II", len(p),
                                    zlib.crc32(p) & 0xffffffff) + p)
            f.write(struct.pack("<II", 64, 1234) + b"half")  # torn
        with open(os.path.join(d, "metrics.prom"), "w") as f:
            f.write("# TYPE zoo_train_steps_total counter\\n")
            f.write("zoo_train_steps_total 6\\n")
        if rank == 1 and not resume:
            time.sleep(0.5)  # rank 0 lands its snapshot first
            sys.exit(5)
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


def _cleanup_kept(summ):
    """Remove the run directory the launcher keeps after an incident
    (the tests read it first)."""
    import shutil
    for p in (summ or {}).get("postmortems", []):
        shutil.rmtree(os.path.dirname(p), ignore_errors=True)


def test_crash_restarts_with_resume_env(tmp_path):
    proc, summ = _launch(tmp_path, "crash", ["--max-restarts", "1"])
    _cleanup_kept(summ)
    assert proc.returncode == 0, proc.stdout[-2000:]
    assert summ["restarts"] == 1 and summ["reasons"] == ["exit"]
    assert "DONE rank=0 resume=1 restart_count=1" in proc.stdout
    assert "DONE rank=1 resume=1" in proc.stdout
    assert summ["metrics"]["restarts"] == {"exit": 1}


def test_partial_death_fast_fails_with_no_restarts(tmp_path):
    start = time.time()
    proc, summ = _launch(tmp_path, "partial")
    _cleanup_kept(summ)
    wall = time.time() - start
    assert proc.returncode == 2, proc.stdout[-2000:]
    assert wall < 60, f"the supervisor waited on the survivor ({wall:.0f}s)"
    assert summ["restarts"] == 0 and summ["rc"] == 2


def test_watchdog_kills_and_restarts_hung_worker(tmp_path):
    proc, summ = _launch(tmp_path, "hang",
                         ["--max-restarts", "1", "--watchdog-sec", "2"])
    _cleanup_kept(summ)
    assert proc.returncode == 0, proc.stdout[-2000:]
    assert summ["reasons"] == ["watchdog"], summ
    assert "DONE rank=1 resume=1" in proc.stdout
    assert summ["metrics"]["restarts"] == {"watchdog": 1}


def test_restart_budget_exhaustion_fails(tmp_path):
    """A spent budget surfaces the worker's rc, and the incident still
    gets its post-mortem (the supervisor's evidence, though these
    workers recorded nothing), as in the JAX package."""
    proc, summ = _launch(tmp_path, "crash")
    _cleanup_kept(summ)
    assert proc.returncode == 3
    assert summ == {"rc": 3, "restarts": 0, "port_retries": 0,
                    "reasons": [], "postmortems": summ["postmortems"],
                    "metrics": summ["metrics"]}
    assert len(summ["postmortems"]) == 1


def test_coordinator_bind_race_retried_with_fresh_port(tmp_path):
    proc, summ = _launch(tmp_path, "bind")
    assert proc.returncode == 0, proc.stdout[-2000:]
    assert summ["port_retries"] == 1 and summ["restarts"] == 0
    assert summ["reasons"] == ["port"]
    assert "DONE rank=0 resume=0" in proc.stdout


def test_postmortem_harvests_flight_recorders(tmp_path):
    """The reaped pod's post-mortem names rank 1's last completed step
    from its recorder (the torn tail frame dropped, never misread), with
    the supervisor's exit code; the aggregated pod scrape beside it
    holds each rank's step counter and their pod total.  The JAX
    package's harvester reads the same directory to the same ranks."""
    from analytics_zoo_tpu.observability import flightrec as jflightrec
    from analytics_zoo_tpu_torch.observability.metrics import \
        parse_prometheus_text
    proc, summ = _launch(tmp_path, "crashrec", ["--max-restarts", "1"])
    try:
        assert proc.returncode == 0, proc.stdout[-2000:]
        assert len(summ["postmortems"]) == 1
        run_dir = os.path.dirname(summ["postmortems"][0])
        with open(summ["postmortems"][0]) as f:
            pm = json.load(f)
        assert pm["reason"] == "exit" and pm["failed_rank"] == 1
        assert pm["incarnation"] == 0
        r1 = pm["ranks"]["1"]
        assert r1["rc"] == 5 and r1["last_step"] == 6
        assert [h["step"] for h in r1["heartbeats"]][-3:] == [4, 5, 6]
        with open(os.path.join(run_dir, "pod_postmortem.json")) as f:
            assert json.load(f)["failed_rank"] == 1
        with open(os.path.join(run_dir, "pod_metrics.prom")) as f:
            s = parse_prometheus_text(f.read())["samples"]
        assert s[("zoo_train_steps_total", (("rank", "0"),))] == 6
        assert s[("zoo_train_steps_total", (("rank", "1"),))] == 6
        assert s[("zoo_train_steps_total", ())] == 12
        jh = jflightrec.harvest(os.path.join(run_dir, "flightrec"))
        assert jh[1]["last_step"] == 6 and jh[1]["incarnations"] == [0, 1]
    finally:
        _cleanup_kept(summ)


def test_watchdog_postmortem_names_stale_heartbeat(tmp_path):
    """A hang's post-mortem carries the hung worker's heartbeat age (at
    least the watchdog window) and names it alone as stale: rank 0
    exited long before, and its aging file is not a second hang."""
    proc, summ = _launch(tmp_path, "hang",
                         ["--max-restarts", "1", "--watchdog-sec", "2"])
    try:
        assert proc.returncode == 0, proc.stdout[-2000:]
        assert len(summ["postmortems"]) == 1
        with open(summ["postmortems"][0]) as f:
            pm = json.load(f)
        assert pm["reason"] == "watchdog" and pm["failed_rank"] == 1
        assert pm["ranks"]["1"]["heartbeat_age_s"] >= 2.0
        assert pm["stale_ranks"] == [1]
    finally:
        _cleanup_kept(summ)


def test_train_metric_families_render_and_parse():
    """The restart and checkpoint families round-trip through both
    packages' parsers, under the JAX package's names and labels."""
    from analytics_zoo_tpu.observability.metrics import \
        parse_prometheus_text as jparse
    from analytics_zoo_tpu.train import metrics as jtm
    from analytics_zoo_tpu_torch.observability.metrics import (
        parse_prometheus_text, render_prometheus)
    from analytics_zoo_tpu_torch.train import metrics as tm
    saved = tm.snapshot()
    jsaved = jtm.snapshot()
    try:
        for m in (tm, jtm):
            m.reset()
            m.record_restart("exit")
            m.record_restart("watchdog")
            m.record_ckpt_save("sharded")
            m.record_ckpt_commit()
            m.record_ckpt_restore("ok")
            m.record_ckpt_restore("corrupt_discarded")
            m.record_step()
        text = render_prometheus(tm.train_families())
        parsed = parse_prometheus_text(text)
        assert parsed == jparse(text)
        assert parsed["types"]["zoo_train_restarts_total"] == "counter"
        s = parsed["samples"]
        assert s[("zoo_train_restarts_total", (("reason", "exit"),))] == 1
        assert s[("zoo_train_restarts_total",
                  (("reason", "watchdog"),))] == 1
        assert s[("zoo_ckpt_saves_total", (("format", "sharded"),))] == 1
        assert s[("zoo_ckpt_restores_total", (("outcome", "ok"),))] == 1
        assert s[("zoo_ckpt_restores_total",
                  (("outcome", "corrupt_discarded"),))] == 1
        assert s[("zoo_ckpt_commits_total", ())] == 1
        assert s[("zoo_train_steps_total", ())] == 1
        from analytics_zoo_tpu.observability.metrics import \
            render_prometheus as jrender
        assert jrender(jtm.train_families()) == text
    finally:
        for m, st in ((tm, saved), (jtm, jsaved)):
            m.reset()
            for r, v in st["restarts"].items():
                for _ in range(v):
                    m.record_restart(r)
            for f, v in st["ckpt_saves"].items():
                for _ in range(v):
                    m.record_ckpt_save(f)
            for o, v in st["ckpt_restores"].items():
                for _ in range(v):
                    m.record_ckpt_restore(o)
            for _ in range(st["ckpt_commits"]):
                m.record_ckpt_commit()
            for _ in range(st.get("steps", 0)):
                m.record_step()


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
    # a pod trains data-parallel: each rank feeds its half of the data,
    # 8 rows of every global batch of 16
    distributed.maybe_initialize_distributed("cpu")
    m.trainer.fit(Dataset.from_ndarray(x, y).shard_by_process(),
                  batch_size=16, end_trigger=triggers.MaxEpoch(3))
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
    ref = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher",
         "--num-processes", "2", str(script), "-", str(tmp_path / "ref")],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=120)
    assert "RESULT proc=0/2 step=12" in ref.stdout, ref.stdout[-2000:]
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
    summ = json.loads(summary.read_text())
    _cleanup_kept(summ)
    assert proc.returncode == 0, proc.stdout[-3000:]
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
