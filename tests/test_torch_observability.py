"""The port's observability stack, held against the JAX package's.

Counterparts of ``tests/test_observability.py`` (scalars read back from
a saved run, the summary trigger, the graph topology files, the common
utilities) and of ``tests/test_observability_stack.py`` up to the cases
that need the serving plane: spans and the tracer, ``LatencyWindow`` and
``Counters``, the registry and the Prometheus round trip, the profile
hooks (here fed by kernel builds and CUDA-graph captures, through
``profile.note_compile``) and the traced serving paths (coalesced,
solo, exact-shape, chunked, and the decode engine's generate).

Across the packages: each package's parser reads the other's render;
the families of the profile hooks and the tracer have the same names,
types and label keys; a traced predict and a traced fit give the JAX
package's phase sequences.  The JAX package's serving modules need a
shim of ``jax.lib.xla_client`` to import here, so its traced predicts run
in a subprocess of their own (never in the test process).
"""

import itertools
import json
import logging
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.observability import metrics as jmetrics
from analytics_zoo_tpu.observability import trace as jtrace
from analytics_zoo_tpu_torch.observability import (Counters, Family,
                                                   LatencyWindow,
                                                   MetricsRegistry, Span,
                                                   Tracer, current_span,
                                                   parse_prometheus_text,
                                                   profile,
                                                   render_prometheus,
                                                   summary_family, trace)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 60


def _phase_names(d):
    """Consecutive-deduped phase names of a span dict (a phase may
    recur, e.g. pad in the dispatcher then in the cache)."""
    return [k for k, _ in itertools.groupby(p["name"] for p in d["phases"])]


def _contiguous(d):
    for a, b in zip(d["phases"], d["phases"][1:]):
        assert abs(a["start_ms"] + a["dur_ms"] - b["start_ms"]) < 1e-3, d


@pytest.fixture
def closing(request):
    """Close every serving handle a test opens, even when it fails."""
    handles = []

    def add(h):
        handles.append(h)
        return h

    yield add
    for h in handles:
        h.close()


@pytest.fixture
def profile_handle():
    handle = profile.install()
    yield handle
    handle.close()


# --------------------------------------------- summaries and utilities
def test_read_scalars_from_saved_run_in_both_packages(tmp_path):
    """The port's TrainSummary files read back through the port's
    read_scalars and the JAX package's alike."""
    from analytics_zoo_tpu.train.summary import read_scalars as jread
    from analytics_zoo_tpu_torch.train.summary import (TrainSummary,
                                                       read_scalars)
    w = TrainSummary(str(tmp_path), "run1")
    for step, v in [(1, 2.0), (2, 1.5), (3, 1.1)]:
        w.add_scalar("Loss", v, step)
    w.add_scalar("Throughput", 100.0, 3)
    w.flush()
    w.close()
    for read in (read_scalars, jread):
        assert read(str(tmp_path), "run1", "Loss") == [(1, 2.0), (2, 1.5),
                                                       (3, 1.1)]
        assert read(str(tmp_path), "run1", "Throughput") == [(3, 100.0)]
        assert read(str(tmp_path), "run1", "absent") == []
        assert read(str(tmp_path), "nope", "Loss") == []


def _dense4():
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    m = Sequential(device="cpu", seed=0)
    m.add(L.Dense(4, input_shape=(4,)))
    return m


def test_fit_scalars_round_trip(tmp_path):
    from analytics_zoo_tpu_torch.train.summary import read_scalars
    m = _dense4()
    m.compile(optimizer="sgd", loss="mean_squared_error")
    m.set_tensorboard(str(tmp_path), "fitrun")
    rs = np.random.RandomState(0)
    m.fit(rs.rand(32, 4).astype(np.float32),
          rs.rand(32, 4).astype(np.float32), batch_size=8, nb_epoch=2)
    losses = read_scalars(str(tmp_path), "fitrun", "Loss")
    assert [s for s, _ in losses] == list(range(1, 9))  # 4 steps x 2


def test_summary_trigger_throttles_tags(tmp_path):
    from analytics_zoo_tpu_torch.train.summary import read_scalars
    from analytics_zoo_tpu_torch.train.triggers import SeveralIteration
    m = _dense4()
    # set before compile and set_tensorboard: queued until the writer
    # exists
    m.set_summary_trigger("Loss", SeveralIteration(4))
    m.compile(optimizer="sgd", loss="mean_squared_error")
    m.set_tensorboard(str(tmp_path), "throttled")
    rs = np.random.RandomState(0)
    m.fit(rs.rand(32, 4).astype(np.float32),
          rs.rand(32, 4).astype(np.float32), batch_size=8, nb_epoch=2)
    assert [s for s, _ in read_scalars(str(tmp_path), "throttled",
                                       "Loss")] == [4, 8]
    assert len(read_scalars(str(tmp_path), "throttled",
                            "Throughput")) == 2
    m.train_summary.set_summary_trigger("Throughput", SeveralIteration(100))
    m.fit(rs.rand(32, 4).astype(np.float32),
          rs.rand(32, 4).astype(np.float32), batch_size=8, nb_epoch=1)
    assert len(read_scalars(str(tmp_path), "throttled",
                            "Throughput")) == 2


def test_save_graph_topology_matches_the_jax_files(tmp_path):
    """The fork model's topology files: the same node lines and the same
    edges as the JAX package writes for the same model."""
    from analytics_zoo_tpu.core.graph import Input as JInput
    from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
    from analytics_zoo_tpu.pipeline.api.keras.layers import (Dense as JDense,
                                                             Merge as JMerge)
    from analytics_zoo_tpu_torch.core.graph import Input
    from analytics_zoo_tpu_torch.pipeline.api.keras import Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense, Merge

    def build(Inp, D, Mg, M, **kw):
        inp = Inp((6,), name="x")
        a = D(4, name="branch_a")(inp)
        b = D(4, name="branch_b")(inp)
        out = Mg(mode="sum", name="sum")([a, b])
        return M(input=inp, output=out, name="fork", **kw)

    paths = {}
    for pkg, model in (("port", build(Input, Dense, Merge, Model,
                                      device="cpu")),
                       ("jax", build(JInput, JDense, JMerge, JModel))):
        paths[pkg] = model.save_graph_topology(str(tmp_path / pkg))
    txt = open(os.path.join(paths["port"], "graph_topology.txt")).read()
    assert "branch_a" in txt and "branch_b" in txt
    assert "(graph input)" in txt
    dot = open(os.path.join(paths["port"], "graph_topology.dot")).read()
    assert dot.startswith("digraph") and dot.count("->") >= 4

    def edges(path):
        # node ids differ between processes' counters; names do not
        text = open(os.path.join(path, "graph_topology.txt")).read()
        return sorted(line.split(" [")[0] + " <- " + line.split("<-  ")[1]
                      for line in text.splitlines() if "<-" in line)

    assert edges(paths["port"]) == edges(paths["jax"])


def test_utils_helpers(tmp_path):
    from analytics_zoo_tpu.common.utils import pad_leading as jpad
    from analytics_zoo_tpu_torch.common.utils import (
        list_local_files, log_usage_error_and_throw, pad_leading,
        redirect_logs, save_bytes, show_info_logs)
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "f2.txt").write_text("x")
    (tmp_path / "f1.txt").write_text("y")
    files = list_local_files(str(tmp_path))
    assert [os.path.basename(f) for f in files] == ["f1.txt", "f2.txt"]

    p = str(tmp_path / "out" / "blob.bin")
    save_bytes(b"hello", p)
    assert open(p, "rb").read() == b"hello"
    with pytest.raises(FileExistsError):
        save_bytes(b"again", p)
    save_bytes(b"again", p, is_overwrite=True)
    assert open(p, "rb").read() == b"again"

    with pytest.raises(ValueError, match="bad usage"):
        log_usage_error_and_throw("bad usage")

    h = redirect_logs(str(tmp_path / "log.txt"))
    try:
        show_info_logs()
        logging.getLogger("analytics_zoo_tpu_torch").info("hello-log")
        h.flush()
        assert "hello-log" in open(str(tmp_path / "log.txt")).read()
    finally:
        logging.getLogger("analytics_zoo_tpu_torch").removeHandler(h)

    # pad_leading: numpy as the JAX package pads it, tensors alike
    ids = np.arange(6, dtype=np.int32).reshape(3, 2)
    x = np.ones((3, 2, 2), np.float32)
    want = jpad((ids, x), 2)
    got = pad_leading((ids, x), 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    t = pad_leading(torch.from_numpy(ids), 2)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), want[0])
    assert pad_leading(x, 0) is x


# ------------------------------------------------------------- tracing
def test_span_phases_are_contiguous_by_construction():
    tracer = Tracer()
    span = tracer.start_span("r")
    span.phase_start("a")
    span.phase_start("b")  # closes a at b's start
    span.phase_end()
    span.finish()
    d = tracer.recent()[0]
    a, b = d["phases"]
    assert a["name"] == "a" and b["name"] == "b"
    assert abs(a["start_ms"] + a["dur_ms"] - b["start_ms"]) < 1e-3
    assert d["phase_total_ms"] <= d["wall_ms"] + 1e-3
    assert 0.0 < d["coverage"] <= 1.0
    # the span dict has the JAX package's keys
    js = jtrace.Tracer().start_span("r")
    js.finish()
    assert set(d) == set(js.to_dict())


def test_span_finish_closes_open_phase_and_is_idempotent():
    span = Span(None, "r")
    span.phase_start("x")
    span.finish()
    assert span.phases[0][2] is not None
    end = span.end_s
    span.finish()
    assert span.end_s == end


def test_span_repeated_phases_aggregate_by_name():
    span = Span(None, "r")
    for _ in range(3):
        with span.phase("pad"):
            pass
        with span.phase("execute"):
            pass
    span.finish()
    assert set(span.phase_totals()) == {"pad", "execute"}
    assert len(span.phases) == 6


def test_tracer_ring_buffer_is_bounded_and_aggregates_all():
    tracer = Tracer(capacity=4)
    for i in range(10):
        s = tracer.start_span("r", trace_id=f"t{i}")
        with s.phase("execute"):
            pass
        s.finish()
    assert tracer.span_count == 10
    recent = tracer.recent()
    assert [d["trace_id"] for d in recent] == ["t6", "t7", "t8", "t9"]
    assert tracer.find("t3") is None
    assert tracer.find("t9") is not None
    assert tracer.recent(2) == recent[-2:]
    assert tracer.recent(0) == [] and tracer.recent(-3) == []
    assert tracer.phase_stats()["execute"]["count"] == 10


def test_activate_sets_current_span_and_restores_on_exit():
    assert current_span() is None
    span = Span(None, "r")
    with trace.activate(span):
        assert trace.tracing_active()
        assert current_span() is span
        inner = Span(None, "inner")
        with trace.activate(inner):
            assert current_span() is inner
        assert current_span() is span
    assert current_span() is None
    with trace.activate(None):
        assert current_span() is None


def test_activate_does_not_leak_across_threads_but_handoff_works():
    span = Span(None, "r")
    seen, ready, go = {}, threading.Event(), threading.Event()
    carried = [span]

    def worker():
        ready.set()
        go.wait(5)
        seen["ctx"] = current_span()  # not propagated
        carried[0].phase_start("execute")  # the explicit carry is
        carried[0].phase_end()

    t = threading.Thread(target=worker)
    t.start()
    ready.wait(5)
    with trace.activate(span):
        go.set()
        t.join(5)
    assert seen["ctx"] is None
    assert span.phase_totals()["execute"] >= 0.0


def test_phase_taxonomies_are_the_jax_packages():
    assert trace.PHASES == jtrace.PHASES
    assert trace.TRAIN_PHASES == jtrace.TRAIN_PHASES


# ------------------------------------------- LatencyWindow / Counters
def test_latency_window_empty_snapshot():
    snap = LatencyWindow().snapshot()
    assert snap["count"] == 0 and snap["window"] == 0
    assert snap["mean_ms"] is None
    assert snap["p50_ms"] is None and snap["p99_ms"] is None


def test_latency_window_single_sample_answers_every_percentile():
    w = LatencyWindow()
    w.add(0.005)
    snap = w.snapshot()
    assert snap["count"] == 1 and snap["window"] == 1
    assert snap["p50_ms"] == snap["p90_ms"] == snap["p99_ms"] == 5.0
    assert snap["mean_ms"] == 5.0


def test_latency_window_nearest_rank_matches_jax():
    """Overfill a tiny window: the same snapshot as the JAX package's
    window fed the same samples."""
    w, jw = LatencyWindow(maxlen=4), jmetrics.LatencyWindow(maxlen=4)
    for ms in (9.0, 1.0, 2.0, 3.0, 4.0):
        w.add(ms / 1e3)
        jw.add(ms / 1e3)
    snap = w.snapshot()
    assert snap == jw.snapshot()
    assert snap["count"] == 5 and snap["window"] == 4
    assert (snap["p50_ms"], snap["p90_ms"], snap["p99_ms"]) == (3.0, 4.0,
                                                                4.0)


def test_latency_window_concurrent_add_and_snapshot():
    w = LatencyWindow(maxlen=128)
    stop, errs = threading.Event(), []

    def adder():
        i = 0
        while not stop.is_set():
            w.add(0.001 * (i % 7 + 1))
            i += 1

    def snapper():
        while not stop.is_set():
            snap = w.snapshot()
            if snap["count"] and not snap["p50_ms"] <= snap["p99_ms"]:
                errs.append(snap)

    threads = [threading.Thread(target=f)
               for f in (adder, adder, snapper, snapper)]
    [t.start() for t in threads]
    time.sleep(0.2)
    stop.set()
    [t.join() for t in threads]
    assert not errs
    assert w.snapshot()["count"] >= 128


def test_counters_unknown_name_and_concurrent_inc():
    c = Counters("a")
    assert c.get("missing") == 0
    threads = [threading.Thread(
        target=lambda: [c.inc("a") for _ in range(500)]) for _ in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert c.get("a") == 2000 and c.snapshot() == {"a": 2000}


# ----------------------------------------------------------- registry
def test_metrics_registry_counter_gauge_and_conflicts():
    reg = MetricsRegistry()
    c = reg.counter("zoo_reqs_total", "reqs")
    assert reg.counter("zoo_reqs_total") is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("zoo_reqs_total")
    c.labels(model="m", version="1").inc()
    c.labels(model="m", version="1").inc(2)
    assert c.get(model="m", version="1") == 3
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)
    g = reg.gauge("zoo_depth")
    g.set(5)
    g.labels(model="m").set_fn(lambda: 11)
    assert g.get() == 5 and g.get(model="m") == 11
    with pytest.raises(TypeError):
        c.labels(model="m").set(1)


def test_prometheus_render_parse_round_trip_with_escaping():
    reg = MetricsRegistry()
    c = reg.counter("zoo_reqs_total", "help with\nnewline")
    nasty = 'quo"te\\slash\nnewline'
    c.labels(model=nasty).inc(7)
    reg.gauge("zoo_nan_gauge").set_fn(lambda: float("nan"))
    parsed = parse_prometheus_text(reg.render_prometheus())
    assert parsed["samples"][("zoo_reqs_total", (("model", nasty),))] == 7.0
    assert parsed["types"] == {"zoo_reqs_total": "counter",
                               "zoo_nan_gauge": "gauge",
                               "zoo_process_info": "gauge"}
    reg.register_collector(lambda: [Family(
        "counter", "zoo_extra_total", "", [({"k": "v"}, 1)])])
    assert ("zoo_extra_total", (("k", "v"),)) in \
        parse_prometheus_text(reg.render_prometheus())["samples"]


@pytest.mark.parametrize("renderer", ["port", "jax"])
def test_each_package_parses_the_others_render(renderer):
    """A registry with escaped labels, a NaN gauge and a summary,
    rendered by one package, parses to the same samples in both."""
    m = jmetrics if renderer == "jax" else sys.modules[
        "analytics_zoo_tpu_torch.observability.metrics"]
    reg = m.MetricsRegistry(process_info=False)
    reg.counter("zoo_reqs_total", "h\n2").labels(model='a"b\\c\nd').inc(3)
    reg.gauge("zoo_inf_gauge").set(float("inf"))
    w = m.LatencyWindow()
    for s in (0.001, 0.004):
        w.add(s)
    reg.register_collector(lambda: [m.summary_family(
        "zoo_lat_seconds", "lat", {"model": "m"}, w.snapshot())])
    text = reg.render_prometheus()
    ours, theirs = parse_prometheus_text(text), \
        jmetrics.parse_prometheus_text(text)
    assert ours == theirs
    assert ours["types"]["zoo_lat_seconds"] == "summary"
    assert ours["samples"][("zoo_lat_seconds_count",
                            (("model", "m"),))] == 2.0
    # and the two renders of the same families are the same text
    other = jmetrics if renderer == "port" else sys.modules[
        "analytics_zoo_tpu_torch.observability.metrics"]
    fams = [other.Family(f.mtype, f.name, f.help, f.samples)
            for f in reg.collect()]
    assert other.render_prometheus(fams) == text


def test_process_info_carries_torch_and_cuda_versions(monkeypatch):
    """The one label set that differs from the JAX package's: torch and
    cuda where it has jax and jaxlib; the rest is the same."""
    monkeypatch.setenv("ZOO_TPU_PROCESS_ID", "3")
    monkeypatch.setenv("ZOO_RESTART_COUNT", "2")
    from analytics_zoo_tpu_torch.observability import process_info_family
    labels = process_info_family().samples[0][0]
    jlabels = jmetrics.process_info_family().samples[0][0]
    assert set(labels) - {"torch", "cuda"} == set(jlabels) - {"jax",
                                                              "jaxlib"}
    assert labels["torch"] == torch.__version__
    assert labels["cuda"] == (torch.version.cuda or "none")
    assert labels["rank"] == "3" and labels["incarnation"] == "2"


def test_render_merges_same_named_families_single_type_block():
    fams = [Family("counter", "zoo_x_total", "h", [({"m": "a"}, 1)]),
            Family("counter", "zoo_x_total", "h", [({"m": "b"}, 2)])]
    text = render_prometheus(fams)
    assert text.count("# TYPE zoo_x_total counter") == 1
    parsed = parse_prometheus_text(text)
    assert parsed["samples"][("zoo_x_total", (("m", "a"),))] == 1.0
    assert parsed["samples"][("zoo_x_total", (("m", "b"),))] == 2.0
    with pytest.raises(ValueError, match="both"):
        render_prometheus([Family("counter", "zoo_y", "", [({}, 1)]),
                           Family("gauge", "zoo_y", "", [({}, 2)])])


def test_latency_summaries_of_two_versions_share_one_family():
    """Per-version summaries from independent collectors merge into one
    ``# TYPE`` block whose ``_count`` samples keep their labels."""
    fams = []
    for version, samples in ((1, (0.001,) * 5), (2, (0.002,) * 3)):
        w = LatencyWindow()
        for s in samples:
            w.add(s)
        fams.append(summary_family("zoo_model_latency_seconds", "lat",
                                   {"model": "m", "version": version},
                                   w.snapshot()))
    text = render_prometheus(fams)
    assert text.count("# TYPE zoo_model_latency_seconds summary") == 1
    parsed = parse_prometheus_text(text)
    for version, count in ((1, 5.0), (2, 3.0)):
        assert parsed["samples"][(
            "zoo_model_latency_seconds_count",
            (("model", "m"), ("version", str(version))))] == count


def test_prometheus_parser_rejects_garbage():
    for bad in ("metric{unclosed=\"x\" 1", "metric{k=\"bad\\q\"} 1",
                "0leading_digit 2", "metric one_point_five",
                "# TYPE zoo bogus_type"):
        with pytest.raises(ValueError, match="unparseable|bogus|TYPE"):
            parse_prometheus_text(bad + "\n")
    out = parse_prometheus_text("# a comment\n\nm_total 3\n")
    assert out["samples"][("m_total", ())] == 3.0


def test_summary_family_from_latency_window():
    w = LatencyWindow()
    for s in (0.001, 0.002, 0.003):
        w.add(s)
    fam = summary_family("zoo_lat_seconds", "lat", {"model": "m"},
                         w.snapshot())
    parsed = parse_prometheus_text(render_prometheus([fam]))
    assert parsed["types"]["zoo_lat_seconds"] == "summary"
    assert parsed["samples"][("zoo_lat_seconds_count",
                              (("model", "m"),))] == 3.0
    assert abs(parsed["samples"][("zoo_lat_seconds_sum",
                                  (("model", "m"),))] - 0.006) < 1e-9
    q50 = parsed["samples"][("zoo_lat_seconds",
                             (("model", "m"), ("quantile", "0.5")))]
    assert abs(q50 - 0.002) < 1e-9
    assert summary_family("z", "", {}, LatencyWindow().snapshot()) is None


# ------------------------------------------------------ profile hooks
def test_profile_hooks_count_compiles_and_attach_span_events():
    """A compile-like event (a kernel build, a graph capture) counts and
    lands on the active span; the families carry the JAX package's names
    and types; closed, the hooks count nothing."""
    handle = profile.install()
    assert profile.install() is handle
    try:
        before = handle.snapshot()["compiles"]
        tracer = Tracer()
        with tracer.request("r"):
            profile.note_compile(0.25, "cuda_graph_capture")
        after = handle.snapshot()
        assert after["compiles"] == before + 1
        assert after["compile_seconds"] >= 0.25
        ev = tracer.recent()[-1]["events"]
        assert [e["name"] for e in ev] == ["backend_compile"]
        assert ev[0]["key"] == "cuda_graph_capture"
        profile.note_transfer("h2d")
        profile.note_transfer("h2d")
        assert handle.snapshot()["transfers"]["h2d"] >= 2
        live = [torch.ones(2) for _ in range(3)]
        fams = {f.name: f for f in handle.families()}
        assert fams["zoo_xla_compiles_total"].samples[0][1] >= 1
        assert fams["zoo_live_buffers"].mtype == "gauge"
        # no card: the live CPU tensors, these three among them
        assert fams["zoo_live_buffers"].samples[0][1] >= len(live)
        types = {n: f.mtype for n, f in fams.items()}
        assert types == {"zoo_xla_compiles_total": "counter",
                         "zoo_xla_compile_seconds_total": "counter",
                         "zoo_transfers_total": "counter",
                         "zoo_live_buffers": "gauge"}
        assert parse_prometheus_text(render_prometheus(fams.values()))
    finally:
        handle.close()
    n = handle.snapshot()["compiles"]
    profile.note_compile(1.0, "nvcc:flash_fwd.cu")
    assert handle.snapshot()["compiles"] == n  # unhooked
    assert profile.installed() is None
    profile.note_transfer("h2d")  # a no-op, must not raise


def _served(closing, **kw):
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    m = Sequential(device="cpu", seed=0)
    m.add(L.Dense(4, input_shape=(4,)))
    return m, closing(m.to_serving(**kw))


def test_profile_attributes_coalesced_build_to_rider_span(closing,
                                                           profile_handle):
    """A build on the dispatcher thread (a bucket's first run through the
    coalescer: here one that builds a kernel) lands as an event on the
    request that paid for it, though the dispatcher has no span of its
    own; the fetch counts as a d2h transfer."""
    _, im = _served(closing, supported_concurrent_num=2, max_batch_size=4,
                    coalescing=True)
    fn = im._cache._fn

    def building(x):
        profile.note_compile(0.01, "nvcc:flash_fwd.cu")
        return fn(x)

    im._cache._fn = building
    tracer = Tracer()
    with tracer.request("predict"):
        im.predict(np.ones((2, 4), np.float32))  # the bucket's first run
    d = tracer.recent()[-1]
    assert any(e["name"] == "backend_compile" for e in d["events"]), d
    assert profile_handle.snapshot()["transfers"].get("d2h", 0) >= 1


# ------------------------------------------------- traced serving paths
def test_traced_coalesced_predict_has_full_phase_chain(closing):
    _, im = _served(closing, supported_concurrent_num=4, max_batch_size=8,
                    coalescing=True, warmup_shapes=(4,))
    tracer = Tracer()
    im.predict(np.ones((2, 4), np.float32))  # untraced
    assert tracer.span_count == 0
    with tracer.request("predict"):
        out = im.predict(np.ones((3, 4), np.float32))
    assert out.shape == (3, 4)
    d = tracer.recent()[0]
    assert _phase_names(d) == ["coalesce_wait", "pad", "device_put",
                               "execute", "depad"]
    assert all(p["dur_ms"] is not None for p in d["phases"])
    _contiguous(d)
    assert d["labels"]["bucket"] == 4


def test_traced_solo_and_exact_paths(closing):
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    m, solo = _served(closing, max_batch_size=8, warmup_shapes=(4,))
    tracer = Tracer()
    with tracer.request("predict"):
        solo.predict(np.ones((2, 4), np.float32))
    assert _phase_names(tracer.recent()[-1]) == \
        ["pad", "device_put", "execute", "depad"]
    exact = closing(InferenceModel(bucketing=False))
    exact.load_keras_net(m)
    exact.predict(np.ones((2, 4), np.float32))
    with tracer.request("predict"):
        exact.predict(np.ones((2, 4), np.float32))
    assert _phase_names(tracer.recent()[-1]) == ["device_put", "execute"]


def test_traced_oversized_batch_chunks_repeat_phases(closing):
    _, im = _served(closing, max_batch_size=4, warmup_shapes=(4,))
    tracer = Tracer()
    with tracer.request("predict"):
        out = im.predict(np.ones((10, 4), np.float32))  # 3 chunks
    assert out.shape == (10, 4)
    names = [p["name"] for p in tracer.recent()[0]["phases"]]
    assert names.count("execute") == 3 and names.count("depad") == 3
    assert names == ["pad", "device_put", "execute", "depad"] * 3


JAX_PREDICT = textwrap.dedent("""
    import itertools, json
    import jax, jax.lib
    from jaxlib import xla_client
    jax.lib.xla_client = xla_client  # the installed jax moved it
    import numpy as np
    from analytics_zoo_tpu.observability import Tracer
    from analytics_zoo_tpu.pipeline.inference import InferenceModel

    def names(d):
        return [p["name"] for p in d["phases"]]

    tr, out = Tracer(), {}
    im = InferenceModel(supported_concurrent_num=4, max_batch_size=8,
                        coalescing=True)
    im.load_jax(lambda p, x: x @ p["w"], {"w": np.eye(4, dtype=np.float32)})
    im.warmup((4,))
    with tr.request("predict"):
        im.predict(np.ones((3, 4), np.float32))
    out["coalesced"] = names(tr.recent()[-1])
    out["bucket"] = tr.recent()[-1]["labels"]["bucket"]
    im.close()
    solo = InferenceModel(max_batch_size=4)
    solo.load_jax(lambda p, x: x * p["s"], {"s": np.float32(2.0)})
    solo.warmup((4,))
    with tr.request("predict"):
        solo.predict(np.ones((10, 4), np.float32))
    out["chunked"] = names(tr.recent()[-1])
    ex = InferenceModel(bucketing=False)
    ex.load_jax(lambda p, x: x + p["b"], {"b": np.float32(1.0)})
    ex.predict(np.ones((2, 4), np.float32))
    with tr.request("predict"):
        ex.predict(np.ones((2, 4), np.float32))
    out["exact"] = names(tr.recent()[-1])
    print("RESULT " + json.dumps(out))
""")


def test_traced_predict_phases_are_the_jax_packages(tmp_path, closing):
    """The coalesced, chunked and exact-shape predicts record the phase
    sequences the JAX package's record (its serving modules run in a
    subprocess with the ``xla_client`` shim) and the same bucket label."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    script = tmp_path / "jax_predict.py"
    script.write_text(JAX_PREDICT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, str(script)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")]
    assert line, proc.stdout[-2000:] + proc.stderr[-4000:]
    want = json.loads(line[0][len("RESULT "):])

    def names(d):
        return [p["name"] for p in d["phases"]]

    tracer = Tracer()
    m, co = _served(closing, supported_concurrent_num=4, max_batch_size=8,
                    coalescing=True, warmup_shapes=(4,))
    with tracer.request("predict"):
        co.predict(np.ones((3, 4), np.float32))
    assert names(tracer.recent()[-1]) == want["coalesced"]
    assert tracer.recent()[-1]["labels"]["bucket"] == want["bucket"]
    solo = closing(m.to_serving(max_batch_size=4, warmup_shapes=(4,)))
    with tracer.request("predict"):
        solo.predict(np.ones((10, 4), np.float32))
    assert names(tracer.recent()[-1]) == want["chunked"]
    ex = closing(InferenceModel(bucketing=False))
    ex.load_keras_net(m)
    ex.predict(np.ones((2, 4), np.float32))
    with tracer.request("predict"):
        ex.predict(np.ones((2, 4), np.float32))
    assert names(tracer.recent()[-1]) == want["exact"]


def test_traced_fit_step_phases_are_the_jax_packages(tmp_path):
    """A profiled fit's step spans carry the JAX package's phase
    sequence (``data_wait, h2d, step_compute``, then ``ckpt_save`` on a
    step whose iteration checkpoint fires), and its timeline rows the
    same keys; the losses equal an unprofiled fit's."""
    import optax
    from analytics_zoo_tpu.data.dataset import Dataset as JDataset
    from analytics_zoo_tpu.pipeline.api.keras import (Sequential as JSeq,
                                                      objectives as jobj)
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
    from analytics_zoo_tpu.train import triggers as jtrig
    from analytics_zoo_tpu.train.trainer import Trainer as JTrainer
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    from analytics_zoo_tpu_torch.pipeline.api.keras import (Sequential,
                                                            objectives,
                                                            optimizers)
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.train import triggers
    from analytics_zoo_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = rng.integers(0, 3, 32).astype(np.int32)

    def record(prof, seen):
        finish = prof.finish_step

        def wrapped(span, step):
            finish(span, step)
            seen.append([p[0] for p in span.phases])
        prof.finish_step = wrapped

    jm = JSeq()
    jm.add(JDense(3, input_shape=(4,)))
    jt = JTrainer(jm.to_graph(),
                  jobj.get("sparse_categorical_crossentropy"),
                  optax.sgd(0.1), seed=0)
    jt.set_checkpoint(str(tmp_path / "jck"),
                      trigger=jtrig.SeveralIteration(2))
    jseen = []
    record(jt.enable_step_profiler(str(tmp_path / "j.jsonl")), jseen)
    jt.fit(JDataset.from_ndarray(x, y), batch_size=8, shuffle=False,
           end_trigger=jtrig.MaxIteration(4))

    def port(profiled):
        m = Sequential(device="cpu", seed=0)
        m.add(L.Dense(3, input_shape=(4,)))
        t = Trainer(m, objectives.get("sparse_categorical_crossentropy"),
                    optimizers.get({"name": "sgd", "lr": 0.1}))
        t.set_checkpoint(str(tmp_path / f"ck{profiled}"),
                         trigger=triggers.SeveralIteration(2))
        seen = []
        if profiled:
            record(t.enable_step_profiler(str(tmp_path / "t.jsonl")), seen)
        h = t.fit(Dataset.from_ndarray(x, y), batch_size=8, shuffle=False,
                  end_trigger=triggers.MaxIteration(4))
        return h["loss"], seen

    plain, _ = port(False)
    traced, seen = port(True)
    assert traced == plain
    assert seen == jseen
    assert seen[1][-1] == "ckpt_save" and "ckpt_save" not in seen[0]
    rows = [json.loads(ln) for ln in open(tmp_path / "t.jsonl")]
    jrows = [json.loads(ln) for ln in open(tmp_path / "j.jsonl")]
    assert [set(r) - {"compiles", "compile_ms"} for r in rows] == \
        [set(r) - {"compiles", "compile_ms"} for r in jrows]


def test_traced_generate_marks_decode_phases_and_labels(closing):
    """A traced generate through the decode engine: ``decode_wait ->
    prefill -> decode_step``, gap-free, with the bucket and slot labels;
    the stream equals the untraced one, and a traced multi-row generate
    leaves the span alone (one owner at a time)."""
    from analytics_zoo_tpu_torch.models import TransformerLM
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    lm = TransformerLM(vocab_size=16, seq_len=32, n_layers=2, d_model=16,
                       n_heads=2, device="cpu")
    im = closing(InferenceModel(decode_capacity=4,
                                decode_prompt_buckets=(8,)))
    im.load_keras_net(lm)
    prompt = np.arange(5) % 16
    plain = im.generate([prompt], 6, timeout=WAIT)
    tracer = Tracer()
    with tracer.request("generate"):
        traced = im.generate([prompt], 6, timeout=WAIT)
    np.testing.assert_array_equal(traced[0], plain[0])
    d = tracer.recent()[-1]
    assert _phase_names(d) == ["decode_wait", "prefill", "decode_step"]
    _contiguous(d)
    assert d["labels"]["decode_bucket"] == 8
    assert 0 <= d["labels"]["decode_slot"] < 4
    with tracer.request("stream"):
        toks = list(im.generate_stream(prompt, 6))
    np.testing.assert_array_equal(np.asarray(toks), plain[0])
    assert _phase_names(tracer.recent()[-1]) == ["decode_wait", "prefill",
                                                 "decode_step"]
    with tracer.request("batch"):
        im.generate([prompt, prompt], 3, timeout=WAIT)
    assert tracer.recent()[-1]["phases"] == []
