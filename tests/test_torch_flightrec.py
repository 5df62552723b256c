"""The port's cross-process observability, held against the JAX
package's: the flight recorder (framed records, torn tails, rotation,
atomic throttled snapshots, harvest and post-mortem), the pod
aggregation (rank labels, counters summed and gauges last-written over
incarnations, pod totals, the straggler view and the CLI), the
``zoo_process_info`` family, the structured logger's rank stamping, and
the training step profiler alone and through ``Trainer.fit``.

Counterparts of the 16 cases of ``tests/test_flightrec.py``.  Across the
packages: the JAX package's ``read_records`` and ``harvest`` read the
port's recorder files and the port's read the JAX package's, and the
aggregator of each package merges the other's snapshots to the same
scrape.
"""

import json
import logging
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from analytics_zoo_tpu.observability import aggregate as jaggregate
from analytics_zoo_tpu.observability import flightrec as jflightrec
from analytics_zoo_tpu_torch.observability import aggregate, flightrec
from analytics_zoo_tpu_torch.observability.metrics import (
    MetricsRegistry, parse_prometheus_text, process_info_family,
    render_prometheus)
from analytics_zoo_tpu_torch.observability.trace import TRAIN_PHASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def isolated_recorder():
    """The process recorder of either package must not leak across
    tests."""
    flightrec.shutdown()
    jflightrec.shutdown()
    yield
    flightrec.shutdown()
    jflightrec.shutdown()


# ------------------------------------------------------ flight recorder
def test_recorder_round_trip_and_torn_tail(tmp_path, isolated_recorder):
    rec = flightrec.FlightRecorder(str(tmp_path), rank=1, incarnation=2)
    for s in range(1, 5):
        rec.record_step(s)
    rec.record_log({"level": "info", "msg": "hello"})
    rec.record_span({"trace_id": "t1", "name": "train_step"})
    rec.close()
    d = os.path.join(str(tmp_path), "rank1.i2")
    seg = os.path.join(d, "events.seg")
    records = flightrec.read_records(seg)
    assert [r["step"] for r in records if r["t"] == "hb"] == [1, 2, 3, 4]
    assert any(r["t"] == "log" for r in records)
    # a SIGKILL mid-write leaves a torn frame: the reader stops there
    with open(seg, "ab") as f:
        f.write(struct.pack("<II", 500, 42) + b"torn")
    assert flightrec.read_records(seg) == records
    # so does a frame whose CRC fails
    payload = json.dumps({"t": "hb", "step": 99}).encode()
    with open(seg, "ab") as f:
        f.write(struct.pack("<II", len(payload), 0xdeadbeef) + payload)
    assert flightrec.read_records(seg) == records
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["rank"] == 1 and meta["incarnation"] == 2
    assert meta["pid"] == os.getpid()
    # torch and CUDA where the JAX package records jax and jaxlib; the
    # rest of the keys are its
    import torch
    assert meta["torch"] == torch.__version__ and meta["device"] == "cpu"
    assert {"start_unix", "anchor"} <= set(meta)


def test_recorder_segment_rotation_bounds_disk(tmp_path, isolated_recorder):
    rec = flightrec.FlightRecorder(str(tmp_path), rank=0, incarnation=0,
                                   max_segment_bytes=2048)
    for s in range(1, 501):
        rec.record_step(s)
    rec.close()
    d = os.path.join(str(tmp_path), "rank0.i0")
    sizes = [os.path.getsize(os.path.join(d, n))
             for n in ("events.seg", "events.seg.old")
             if os.path.exists(os.path.join(d, n))]
    assert len(sizes) == 2 and all(sz <= 4096 for sz in sizes)
    assert flightrec.harvest(str(tmp_path))[0]["last_step"] == 500


def test_harvest_picks_newest_incarnation_and_postmortem_merges(
        tmp_path, isolated_recorder):
    old = flightrec.FlightRecorder(str(tmp_path), rank=1, incarnation=0)
    old.record_step(7)
    old.close()
    new = flightrec.FlightRecorder(str(tmp_path), rank=1, incarnation=1)
    new.record_step(3)
    new.close()
    h = flightrec.harvest(str(tmp_path))
    assert h[1]["incarnation"] == 1 and h[1]["last_step"] == 3
    assert h[1]["incarnations"] == [0, 1]
    pm = flightrec.write_postmortem(
        str(tmp_path), str(tmp_path / "pm.json"), reason="watchdog",
        failed_rank=1, incarnation=1,
        supervisor={0: {"rc": -15, "heartbeat_age_s": 1.5},
                    1: {"rc": None, "heartbeat_age_s": 31.0}})
    assert pm["failed_rank"] == 1 and pm["reason"] == "watchdog"
    assert pm["ranks"]["1"]["last_step"] == 3
    assert pm["ranks"]["1"]["heartbeat_age_s"] == 31.0
    assert pm["ranks"]["0"]["rc"] == -15  # never recorded: still lands
    with open(tmp_path / "pm.json") as f:
        assert json.load(f) == json.loads(json.dumps(pm))


def test_recorder_hooks_capture_spans_and_logs(tmp_path, isolated_recorder):
    from analytics_zoo_tpu_torch.observability.log import get_logger
    from analytics_zoo_tpu_torch.observability.trace import Tracer
    rec = flightrec.configure(str(tmp_path), rank=0, incarnation=0)
    assert flightrec.configure(str(tmp_path)) is rec  # idempotent
    tracer = Tracer()
    with tracer.request("req", model="m") as span:
        with span.phase("execute"):
            pass
    # below the handler's threshold, it still reaches the black box
    get_logger("zoo.test.torch.flightrec").debug("quiet line", k=1)
    flightrec.shutdown()
    h = flightrec.harvest(str(tmp_path))
    assert any(s.get("name") == "req" for s in h[0]["spans"])
    assert any(r.get("msg") == "quiet line" for r in h[0]["logs"])
    with tracer.request("after"):  # unhooked: nothing to record into
        pass


def test_snapshot_atomic_and_throttled(tmp_path, isolated_recorder):
    rec = flightrec.FlightRecorder(str(tmp_path), rank=0, incarnation=0,
                                   snapshot_interval_s=60.0)
    assert rec.snapshot_metrics(force=True)
    assert not rec.snapshot_metrics()  # throttled
    prom = os.path.join(str(tmp_path), "rank0.i0", "metrics.prom")
    parsed = parse_prometheus_text(open(prom).read())
    assert any(k[0] == "zoo_process_info" for k in parsed["samples"])
    assert not os.path.exists(prom + ".tmp")
    rec.close()


def _fill(flight, base, rank, inc, steps):
    """A recorder's files written by ``flight`` (either package's
    module): heartbeats, a span, a log line, step entries and a
    snapshot."""
    rec = flight.FlightRecorder(str(base), rank=rank, incarnation=inc)
    for s in steps:
        rec.record_step(s)
    rec.record_span({"trace_id": f"t{rank}", "name": "train_step",
                     "phases": []})
    rec.record_log({"level": "info", "msg": f"rank {rank}"})
    rec.record_batch([{"t": "step", "ts": time.time(), "step": s,
                       "step_compute_ms": 1.0} for s in steps])
    rec.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_harvests_the_others_recorder(tmp_path, writer,
                                                    isolated_recorder):
    """The files keep the JAX package's format byte for byte: either
    package's ``read_records``, ``harvest`` and ``write_postmortem`` read
    the other's, to the same records."""
    write = flightrec if writer == "port" else jflightrec
    base = tmp_path / "fr"
    _fill(write, base, 0, 0, [1, 2, 3])
    _fill(write, base, 1, 1, [1, 2])
    seg = os.path.join(str(base), "rank0.i0", "events.seg")
    assert flightrec.read_records(seg) == jflightrec.read_records(seg)
    assert len(flightrec.read_records(seg)) == 8  # 3 hb, span, log, 3 step
    ours, theirs = (flightrec.harvest(str(base)),
                    jflightrec.harvest(str(base)))
    for h in (ours, theirs):
        for rec in h.values():
            rec["meta"].pop("pid", None)
    assert ours == theirs
    assert ours[0]["last_step"] == 3 and ours[1]["last_step"] == 2
    assert [e["step"] for e in ours[0]["steps"]] == [1, 2, 3]
    pm = jflightrec.write_postmortem(
        str(base), str(tmp_path / "pm.json"), reason="exit",
        failed_rank=1, incarnation=1)
    assert pm["ranks"]["1"]["last_step"] == 2
    # the snapshots (process info only) merge alike through either
    # aggregator
    text = aggregate.aggregate_dir(str(base))
    assert "zoo_process_info" in text
    assert parse_prometheus_text(text) == \
        parse_prometheus_text(jaggregate.aggregate_dir(str(base)))


# ---------------------------------------------------------- aggregation
def _write_snap(base, rank, inc, text):
    d = os.path.join(base, f"rank{rank}.i{inc}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "metrics.prom"), "w") as f:
        f.write(text)


def test_aggregate_multi_rank_round_trip(tmp_path):
    base = str(tmp_path)
    _write_snap(base, 0, 0,
                "# HELP zoo_train_steps_total steps\n"
                "# TYPE zoo_train_steps_total counter\n"
                "zoo_train_steps_total 12\n"
                "# TYPE zoo_queue_depth gauge\n"
                "zoo_queue_depth 5\n"
                "# TYPE zoo_lat_seconds summary\n"
                'zoo_lat_seconds{quantile="0.5"} 0.01\n'
                "zoo_lat_seconds_sum 0.4\n"
                "zoo_lat_seconds_count 40\n")
    # rank 1 restarted once: its counter sums over incarnations, its
    # gauge takes the newest one
    _write_snap(base, 1, 0, "# TYPE zoo_train_steps_total counter\n"
                            "zoo_train_steps_total 4\n"
                            "# TYPE zoo_queue_depth gauge\n"
                            "zoo_queue_depth 9\n")
    _write_snap(base, 1, 1, "# TYPE zoo_train_steps_total counter\n"
                            "zoo_train_steps_total 8\n"
                            "# TYPE zoo_queue_depth gauge\n"
                            "zoo_queue_depth 2\n")
    text = aggregate.aggregate_dir(base)
    parsed = parse_prometheus_text(text)
    s = parsed["samples"]
    assert s[("zoo_train_steps_total", (("rank", "0"),))] == 12
    assert s[("zoo_train_steps_total", (("rank", "1"),))] == 12
    assert s[("zoo_train_steps_total", ())] == 24  # pod total
    assert s[("zoo_queue_depth", (("rank", "1"),))] == 2
    assert s[("zoo_lat_seconds",
              (("quantile", "0.5"), ("rank", "0")))] == 0.01
    assert s[("zoo_lat_seconds_count", (("rank", "0"),))] == 40
    assert parsed["types"]["zoo_train_steps_total"] == "counter"
    assert parsed["types"]["zoo_lat_seconds"] == "summary"
    assert text.count("# TYPE zoo_train_steps_total counter") == 1
    re_text = render_prometheus(
        aggregate.aggregate_files(aggregate.iter_snapshots(base)))
    assert parse_prometheus_text(re_text)["samples"] == s
    assert text == jaggregate.aggregate_dir(base)  # the JAX package's text


def test_aggregate_typeless_snapshot_keeps_counter_semantics(tmp_path):
    base = str(tmp_path)
    _write_snap(base, 0, 0, "# TYPE zoo_train_steps_total counter\n"
                            "zoo_train_steps_total 5\n")
    with open(os.path.join(base, "rank0.prom"), "w") as f:
        f.write("zoo_train_steps_total 7\n")  # no TYPE line
    s = parse_prometheus_text(aggregate.aggregate_dir(base))["samples"]
    assert s[("zoo_train_steps_total", (("rank", "0"),))] == 12
    assert s[("zoo_train_steps_total", ())] == 12


def test_aggregate_type_conflict_raises(tmp_path):
    base = str(tmp_path)
    _write_snap(base, 0, 0, "# TYPE zoo_x counter\nzoo_x 1\n")
    _write_snap(base, 1, 0, "# TYPE zoo_x gauge\nzoo_x 2\n")
    with pytest.raises(ValueError, match="both"):
        aggregate.aggregate_dir(base)


def test_aggregate_preserves_existing_rank_label(tmp_path):
    base = str(tmp_path)
    _write_snap(base, 0, 0, "# TYPE zoo_y_total counter\n"
                            'zoo_y_total{rank="7"} 3\n')
    s = parse_prometheus_text(aggregate.aggregate_dir(base))["samples"]
    assert s == {("zoo_y_total", (("rank", "7"),)): 3.0}


def test_step_view_names_stragglers(tmp_path):
    base = str(tmp_path)
    _write_snap(base, 0, 0, "# TYPE zoo_train_steps_total counter\n"
                            "zoo_train_steps_total 20\n")
    _write_snap(base, 1, 0, "# TYPE zoo_train_steps_total counter\n"
                            "zoo_train_steps_total 14\n")
    view = aggregate.step_view(base)
    assert view["ranks"][1]["lag"] == 6 and view["stragglers"] == [1]
    view2 = aggregate.step_view(base, prev={0: 10.0, 1: 10.0},
                                interval_s=2.0)
    assert view2["ranks"][0]["steps_per_s"] == 5.0


def test_aggregate_cli_scrape_and_view(tmp_path, capsys):
    base = str(tmp_path)
    _write_snap(base, 0, 0, "# TYPE zoo_train_steps_total counter\n"
                            "zoo_train_steps_total 6\n")
    assert aggregate.main([base]) == 0
    out = capsys.readouterr().out
    assert parse_prometheus_text(out)["samples"][
        ("zoo_train_steps_total", (("rank", "0"),))] == 6
    out_path = str(tmp_path / "pod.prom")
    assert aggregate.main([base, "--out", out_path]) == 0
    assert os.path.exists(out_path)
    assert aggregate.main([base, "--view", "--json"]) == 0
    view = json.loads(capsys.readouterr().out)
    assert view["ranks"]["0"]["steps"] == 6
    # the module runs as a command, importing no jax
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; "
         "sys.argv = ['aggregate', sys.argv[1], '--view']; "
         "runpy.run_module('analytics_zoo_tpu_torch.observability."
         "aggregate', run_name='__main__'); "
         "assert 'jax' not in sys.modules", base],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "rank 0: steps=6 lag=0" in proc.stdout


# --------------------------------------------------------- process info
def test_process_info_family_default_and_env(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_PROCESS_ID", "3")
    monkeypatch.setenv("ZOO_RESTART_COUNT", "2")
    labels = process_info_family().samples[0][0]
    assert labels["rank"] == "3" and labels["incarnation"] == "2"
    assert labels["pid"] == str(os.getpid())
    assert "torch" in labels and "cuda" in labels
    assert "start_unix" in labels
    s = parse_prometheus_text(MetricsRegistry().render_prometheus())[
        "samples"]
    assert s[next(k for k in s if k[0] == "zoo_process_info")] == 1.0
    assert "zoo_process_info" not in \
        MetricsRegistry(process_info=False).render_prometheus()


# ------------------------------------------------------- log stamping
def _captured(name, emit):
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(json.loads(record.getMessage()))

    logger = logging.getLogger(name)
    handler = Capture()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        emit()
    finally:
        logger.removeHandler(handler)
    return records


def test_structured_log_stamps_rank_and_incarnation(monkeypatch):
    from analytics_zoo_tpu_torch.observability import log as log_mod
    from analytics_zoo_tpu_torch.train import faults
    monkeypatch.setenv("ZOO_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("ZOO_RESTART_COUNT", "4")
    faults.refresh()  # Trainer.fit's entry re-reads the identity too
    try:
        (rec,) = _captured("zoo.test.torch.stamp", lambda: log_mod.get_logger(
            "zoo.test.torch.stamp").info("line", extra_k=7))
    finally:
        monkeypatch.delenv("ZOO_TPU_PROCESS_ID")
        monkeypatch.delenv("ZOO_RESTART_COUNT")
        log_mod.refresh_identity()
    assert rec["rank"] == 1 and rec["incarnation"] == 4
    assert rec["extra_k"] == 7 and rec["msg"] == "line"
    assert rec["logger"] == "zoo.test.torch.stamp" and rec["level"] == "info"


def test_structured_log_unstamped_without_contract(monkeypatch):
    from analytics_zoo_tpu_torch.observability import log as log_mod
    from analytics_zoo_tpu_torch.observability.trace import Tracer
    monkeypatch.delenv("ZOO_TPU_PROCESS_ID", raising=False)
    monkeypatch.delenv("ZOO_RESTART_COUNT", raising=False)
    log_mod.refresh_identity()
    tracer = Tracer()

    def emit():
        log_mod.get_logger("zoo.test.torch.nostamp").info("line")
        with tracer.request("r", trace_id="rid-9"):
            log_mod.get_logger("zoo.test.torch.nostamp").info("in span")

    records = _captured("zoo.test.torch.nostamp", emit)
    assert "rank" not in records[0] and "incarnation" not in records[0]
    assert "request_id" not in records[0]
    assert records[1]["request_id"] == "rid-9"


# ------------------------------------------------------ step profiler
def test_step_profiler_phases_and_timeline(tmp_path):
    from analytics_zoo_tpu_torch.train.stepprof import StepProfiler
    tl = str(tmp_path / "timeline.jsonl")
    prof = StepProfiler(timeline_path=tl)
    for step in (1, 2):
        prof.last_wait_s = 0.002
        span = prof.begin_step(step, h2d_s=0.001)
        with span.phase("step_compute"):
            time.sleep(0.001)
        if step == 2:
            with span.phase("ckpt_save"):
                pass
        prof.finish_step(span, step)
    assert prof.steps == 2
    snap = prof.snapshot()
    assert set(snap["phases"]) >= {"data_wait", "h2d", "step_compute"}
    assert snap["phases"]["ckpt_save"]["count"] == 1
    s = parse_prometheus_text(render_prometheus(prof.families()))["samples"]
    assert s[("zoo_train_step_seconds_count",
              (("phase", "step_compute"),))] == 2
    assert s[("zoo_train_step_compiles_total", ())] == 0
    assert prof.write_timeline() == tl
    lines = [json.loads(ln) for ln in open(tl)]
    assert [e["step"] for e in lines] == [1, 2]
    assert all(f"{p}_ms" in lines[0] for p in TRAIN_PHASES)


def _mlp(accum=1):
    from analytics_zoo_tpu_torch.pipeline.api.keras import (Sequential,
                                                            objectives,
                                                            optimizers)
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.train.trainer import Trainer
    m = Sequential(device="cpu", seed=0)
    m.add(L.Dense(8, activation="relu", input_shape=(4,)))
    m.add(L.Dense(3))
    return m, Trainer(m, objectives.get("sparse_categorical_crossentropy"),
                      optimizers.get({"name": "sgd", "lr": 0.1}), seed=0,
                      accum_steps=accum)


def _data():
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    rng = np.random.default_rng(1)
    return Dataset.from_ndarray(
        rng.normal(size=(32, 4)).astype(np.float32),
        rng.integers(0, 3, 32).astype(np.int32))


def test_trainer_step_profiler_end_to_end(tmp_path, isolated_recorder):
    """fit with the profiler and the recorder on: every phase populated,
    losses and weights bit-identical to an unprofiled fit, the kernel
    build of the first step attributed to it, the timeline published,
    and the recorder holding the liveness markers, the batched step
    entries and the profiler's families."""
    from analytics_zoo_tpu_torch.observability import profile
    from analytics_zoo_tpu_torch.train import triggers
    ds = _data()
    plain_m, plain = _mlp()
    h_plain = plain.fit(ds, batch_size=8, shuffle=False,
                        end_trigger=triggers.MaxEpoch(2))
    traced_m, traced = _mlp()
    layer = traced_m.to_graph().layers[0]
    forward = layer.forward
    built = []

    def first_build(x):
        if not built:  # as a first launch builds the kernels
            built.append(1)
            profile.note_compile(0.05, "nvcc:flash_fwd.cu")
        return forward(x)

    layer.forward = first_build
    tl = str(tmp_path / "steps.jsonl")
    prof = traced.enable_step_profiler(timeline_path=tl)
    flightrec.configure(str(tmp_path / "fr"), rank=0, incarnation=0)
    try:
        h_traced = traced.fit(ds, batch_size=8, shuffle=False,
                              end_trigger=triggers.MaxEpoch(2))
    finally:
        flightrec.shutdown()
        profile.installed() and profile.installed().close()
    assert h_plain["loss"] == h_traced["loss"]
    for a, b in zip(plain_m.parameters(), traced_m.parameters()):
        assert (a == b).all()
    assert prof.steps == 8
    for phase in ("data_wait", "h2d", "step_compute"):
        assert prof.windows[phase].count == 8, phase
    entries = [json.loads(ln) for ln in open(tl)]
    assert len(entries) == 8
    assert entries[0].get("compiles") == 1
    assert sum(e.get("compiles", 0) for e in entries) == 1
    h = flightrec.harvest(str(tmp_path / "fr"))
    assert h[0]["last_step"] == 8
    assert [e["step"] for e in h[0]["steps"]] == list(range(1, 9))
    assert "step_compute_ms" in h[0]["steps"][0]
    s = parse_prometheus_text(open(h[0]["metrics_path"]).read())["samples"]
    assert s[("zoo_train_steps_total", ())] >= 8.0
    assert any(k[0] == "zoo_train_step_seconds" for k in s)
    assert s[("zoo_train_step_compiles_total", ())] == 1


def test_profiled_accumulation_times_the_host_split(tmp_path, monkeypatch):
    """Under gradient accumulation the profiled fit splits each batch
    into its microbatches on the prefetch thread (``grad_accum``); the
    steps' losses and weights are the unprofiled accumulated fit's bit
    for bit.  The env contract arms the profiler and its timeline."""
    from analytics_zoo_tpu_torch.train import triggers
    ds = _data()
    plain_m, plain = _mlp(accum=2)
    h_plain = plain.fit(ds, batch_size=8, shuffle=False,
                        end_trigger=triggers.MaxIteration(4))
    monkeypatch.setenv("ZOO_STEP_TIMELINE", str(tmp_path / "acc.jsonl"))
    traced_m, traced = _mlp(accum=2)
    h_traced = traced.fit(ds, batch_size=8, shuffle=False,
                          end_trigger=triggers.MaxIteration(4))
    assert h_traced["loss"] == h_plain["loss"]
    for a, b in zip(plain_m.parameters(), traced_m.parameters()):
        assert (a == b).all()
    assert traced._step_profiler.windows["grad_accum"].count == 4
    rows = [json.loads(ln) for ln in open(tmp_path / "acc.jsonl")]
    assert len(rows) == 4 and all(r["grad_accum_ms"] > 0 for r in rows)
