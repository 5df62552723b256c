"""The port's fleet tracing (``observability/tracefleet.py``): every case
of ``tests/test_tracefleet.py`` against the port's modules, then the
JAX package's ``tracefleet`` in this process (it is pure Python) on the
same spans, legs and anchors: ``stitch``, ``assemble``,
``render_waterfall`` and the summary helpers must give equal results,
and each package's harvest reads the other's flight-recorder files.
"""

import json

import pytest

from analytics_zoo_tpu.observability import flightrec as jflightrec
from analytics_zoo_tpu.observability import tracefleet as jtracefleet
from analytics_zoo_tpu_torch.observability import flightrec, tracefleet
from analytics_zoo_tpu_torch.observability import trace as trace_mod
from analytics_zoo_tpu_torch.observability.trace import Tracer


@pytest.fixture
def isolated_recorder():
    flightrec._reset_for_tests()
    yield
    flightrec._reset_for_tests()


def _finish_span(tracer, wall_s, trace_id=None, **labels):
    """A finished span with a CONTROLLED wall time."""
    span = tracer.start_span("request", trace_id=trace_id, **labels)
    span.start_s -= wall_s
    span.finish()
    return span


# ------------------------------------------------------- tail sampling
def test_tail_retains_slow_and_errored_under_cap():
    tr = Tracer(capacity=4, tail_quantile=0.9, tail_cap=2)
    for _ in range(20):
        _finish_span(tr, 0.001, model="m")
    slow = _finish_span(tr, 0.5, model="m")
    err = _finish_span(tr, 0.0005, model="m", error="boom")
    ex = {e["trace_id"]: e for e in tr.exemplars()}
    assert ex[slow.trace_id]["kind"] == "slow"
    assert ex[err.trace_id]["kind"] == "error"
    assert len(ex) <= 2
    slower = _finish_span(tr, 0.9, model="m")
    ex = {e["trace_id"] for e in tr.exemplars()}
    assert err.trace_id in ex and slower.trace_id in ex
    assert slow.trace_id not in ex
    assert len(ex) == 2


def test_exemplar_survives_ring_washout_and_scrapes():
    tr = Tracer(capacity=4, tail_quantile=0.9, tail_cap=4)
    slow = _finish_span(tr, 0.5, model="m")
    for _ in range(10):
        _finish_span(tr, 0.001, model="m")
    assert all(sd["trace_id"] != slow.trace_id for sd in tr.recent())
    found = tr.find(slow.trace_id)
    assert found is not None and found["wall_ms"] >= 400.0
    fams = {f.name: f for f in tr.families()}
    labels = {s[0]["trace_id"]: s[0]
              for s in fams["zoo_trace_exemplar_ms"].samples}
    assert labels[slow.trace_id]["kind"] == "slow"
    assert labels[slow.trace_id]["model"] == "m"


def test_retire_drops_exemplars_with_the_model():
    tr = Tracer(capacity=8, tail_quantile=0.5, tail_cap=8)
    gone = _finish_span(tr, 0.4, model="gone")
    kept = _finish_span(tr, 0.5, model="kept")
    tr.retire(model="gone")
    ex = {e["trace_id"] for e in tr.exemplars()}
    assert gone.trace_id not in ex and kept.trace_id in ex
    assert tr.find(gone.trace_id) is None


def test_tail_config_from_env(monkeypatch):
    monkeypatch.delenv("ZOO_TRACE_TAIL_Q", raising=False)
    monkeypatch.delenv("ZOO_TRACE_TAIL_CAP", raising=False)
    assert trace_mod.tail_config_from_env() == {
        "tail_quantile": 0.95, "tail_cap": 64}
    monkeypatch.setenv("ZOO_TRACE_TAIL_Q", "0.5")
    monkeypatch.setenv("ZOO_TRACE_TAIL_CAP", "7")
    assert trace_mod.tail_config_from_env() == {
        "tail_quantile": 0.5, "tail_cap": 7}
    monkeypatch.setenv("ZOO_TRACE_TAIL_Q", "0")
    assert trace_mod.tail_config_from_env()["tail_quantile"] is None
    monkeypatch.setenv("ZOO_TRACE_TAIL_Q", "garbage")
    monkeypatch.setenv("ZOO_TRACE_TAIL_CAP", "garbage")
    assert trace_mod.tail_config_from_env() == {
        "tail_quantile": 0.95, "tail_cap": 64}


# --------------------------------------------------------- inline half
def test_reply_trace_and_nest_and_gap():
    wtr = Tracer(capacity=8)
    wspan = wtr.start_span("serve", trace_id="T1", model="m")
    wspan.phase_start("execute")
    wspan.start_s -= 0.08  # 80ms worker leg
    wspan.finish()

    assert tracefleet.reply_trace(wtr, None) is None
    assert tracefleet.reply_trace(None, "T1") is None
    wire = tracefleet.reply_trace(wtr, "T1", rank=1, inc=0)
    assert isinstance(wire, str)
    summary = tracefleet.parse_summary(wire)
    assert summary["tid"] == "T1" and summary["rank"] == 1
    assert summary["phases"] and summary["phases"][0][0] == "execute"
    assert abs(summary["wall_ms"] - 80.0) < 20.0
    assert tracefleet.parse_summary("garbage") is None
    assert tracefleet.parse_summary("a|b|c") is None
    # the JAX package parses the port's wire string alike
    assert jtracefleet.parse_summary(wire) == summary

    rtr = Tracer(capacity=8)
    rspan = rtr.start_span("predict", trace_id="T1", model="m")
    rspan.phase_start("worker_call")
    rspan.phases[0][1] -= 0.1  # 100ms worker_call
    tracefleet.nest_summary(rspan, wire)
    tracefleet.nest_summary(rspan, None)
    tracefleet.nest_summary(rspan, "garbage")
    rspan.finish()
    assert len(rspan.children) == 1
    gap = tracefleet.inline_gap_ms(rspan)
    assert gap is not None and 10.0 <= gap <= 30.0
    assert rspan.to_dict()["children"][0]["tid"] == "T1"


# ------------------------------------------------------- offline stitch
def _router_span(trace_id="T1", retried=False):
    phases = [{"name": "route_pick", "start_ms": 0.0, "dur_ms": 5.0}]
    if retried:
        phases += [
            {"name": "worker_call", "start_ms": 5.0, "dur_ms": 40.0},
            {"name": "worker_call", "start_ms": 45.0, "dur_ms": 55.0}]
    else:
        phases += [
            {"name": "worker_call", "start_ms": 5.0, "dur_ms": 95.0}]
    labels = {"model": "m"}
    if retried:
        labels["retried"] = True
    return {"trace_id": trace_id, "name": "predict", "labels": labels,
            "start_unix_s": 1000.0, "start_mono_s": 50.0,
            "wall_ms": 100.0, "phases": phases}


def _leg(trace_id="T1", rank=1, inc=0, rel_s=0.010, wall_ms=80.0,
         skew_s=0.0, anchored=True):
    """A worker leg whose anchor-aligned start is ``1000 + rel_s`` plus
    a forged clock error of ``skew_s``."""
    span = {"trace_id": trace_id, "name": "serve",
            "labels": {"model": "m"},
            "start_unix_s": 1000.0 + rel_s + skew_s,
            "start_mono_s": 200.0, "wall_ms": wall_ms,
            "phases": [
                {"name": "admission_queue", "start_ms": 0.0,
                 "dur_ms": round(wall_ms * 0.2, 4)},
                {"name": "execute",
                 "start_ms": round(wall_ms * 0.2, 4),
                 "dur_ms": round(wall_ms * 0.8, 4)}]}
    anchor = ({"unix": 1000.0 + rel_s + skew_s - 10.0, "mono": 190.0}
              if anchored else None)
    return {"rank": rank, "inc": inc, "anchor": anchor, "span": span}


def test_stitch_full_attribution_no_skew():
    st = tracefleet.stitch(_router_span(), [_leg()])
    assert st["stitched_legs"] == 1 and st["occurrences"] == 1
    assert not st["partial"] and st["monotonic"]
    assert st["skew_s"] == {}
    assert st["attributed_fraction"] == pytest.approx(1.0, abs=1e-3)
    assert st["gap_ms"] == pytest.approx(15.0, abs=0.1)
    srcs = {r["src"] for r in st["rows"]}
    assert {"router", "rank1", "wire"} <= srcs


def test_forged_anchors_still_monotonic_and_skew_reported():
    st = tracefleet.stitch(
        _router_span(retried=True),
        [_leg(rank=0, inc=0, rel_s=0.006, wall_ms=35.0, skew_s=+5.0),
         _leg(rank=1, inc=1, rel_s=0.046, wall_ms=50.0, skew_s=-5.0)])
    assert st["stitched_legs"] == 2 and st["occurrences"] == 2
    assert st["monotonic"] and not st["partial"]
    assert set(st["skew_s"]) == {"rank0.i0", "rank1.i1"}
    assert st["skew_s"]["rank0.i0"] == pytest.approx(-5.0, abs=0.1)
    assert st["skew_s"]["rank1.i1"] == pytest.approx(+5.0, abs=0.1)
    for r in st["rows"]:
        assert r["start_ms"] >= -tracefleet._EPS_MS
        assert r["start_ms"] + r["dur_ms"] <= 100.0 + tracefleet._EPS_MS
    assert "clock skew corrected" in tracefleet.render_waterfall(st)


def test_retried_missing_first_leg_attributes_failed_call():
    st = tracefleet.stitch(_router_span(retried=True),
                           [_leg(rank=1, rel_s=0.046, wall_ms=50.0)])
    assert st["stitched_legs"] == 1 and not st["partial"]
    failed = [r for r in st["rows"] if r["phase"] == "worker_call_failed"]
    assert len(failed) == 1 and failed[0]["dur_ms"] == pytest.approx(40.0)
    assert st["attributed_fraction"] == pytest.approx(1.0, abs=1e-3)


def test_degrades_router_only_missing_leg():
    st = tracefleet.stitch(_router_span(), [])
    assert st["partial"] and st["stitched_legs"] == 0
    assert st["attributed_fraction"] == pytest.approx(0.05, abs=1e-3)
    tracefleet.render_waterfall(st)


def test_degrades_legs_only_no_router_half():
    st = tracefleet.stitch(None, [_leg()], trace_id="T1")
    assert st["partial"] and st["trace_id"] == "T1"
    assert any(r["src"] == "rank1" for r in st["rows"])
    tracefleet.render_waterfall(st)


def test_degrades_empty_everything():
    st = tracefleet.stitch(None, [], trace_id="T9")
    assert st["partial"] and st["rows"] == []
    assert tracefleet.stitch(None, [{"span": None}, "junk"],
                             trace_id="T9")["partial"]


def test_anchorless_leg_uses_span_wall_and_timeless_reports_no_skew():
    st = tracefleet.stitch(_router_span(), [_leg(anchored=False)])
    assert st["stitched_legs"] == 1 and st["monotonic"]
    leg = _leg(anchored=False)
    leg["span"]["start_unix_s"] = None
    leg["span"]["start_mono_s"] = None
    st = tracefleet.stitch(_router_span(), [leg])
    assert st["stitched_legs"] == 1 and st["monotonic"]
    assert st["skew_s"] == {}


def test_harvest_legs_torn_tail_and_missing_dirs(tmp_path,
                                                isolated_recorder):
    rec = flightrec.FlightRecorder(str(tmp_path), rank=0, incarnation=0)
    rec.record_span({"trace_id": "A", "name": "serve",
                     "start_unix_s": 1.0, "wall_ms": 2.0, "phases": []})
    rec.record_span({"trace_id": "B", "name": "serve",
                     "start_unix_s": 2.0, "wall_ms": 2.0, "phases": []})
    rec.close()
    seg = tmp_path / "rank0.i0" / "events.seg"
    with open(seg, "ab") as f:
        f.write(b"\x07\x00\x00\x00TORN")
    (tmp_path / "rank9.iX").mkdir()
    (tmp_path / "rank1.i0").mkdir()
    legs = tracefleet.harvest_legs(str(tmp_path))
    assert {leg["span"]["trace_id"] for leg in legs} == {"A", "B"}
    assert all(leg["rank"] == 0 for leg in legs)
    assert legs[0]["anchor"] is not None
    assert tracefleet.harvest_legs(str(tmp_path), trace_id="B")
    assert tracefleet.harvest_legs(str(tmp_path / "nope")) == []
    # the JAX package harvests the port's files to the same legs
    assert jtracefleet.harvest_legs(str(tmp_path)) == legs


def test_legs_from_postmortem_and_assemble():
    pm = {"ranks": {
        "0": {"incarnation": 0,
              "meta": {"anchor": {"unix": 990.01, "mono": 190.0}},
              "spans": [_leg()["span"], None]},
        "bad": "junk"}}
    legs = tracefleet.legs_from_postmortem(pm, trace_id="T1")
    assert len(legs) == 1 and legs[0]["rank"] == 0
    st = tracefleet.assemble("T1", [_router_span()], legs)
    assert st["stitched_legs"] == 1 and not st["partial"]
    rs = _router_span()
    rs["children"] = [tracefleet.span_summary(_leg()["span"],
                                              rank=1, inc=0)]
    st = tracefleet.assemble("T1", [rs], [])
    assert st["stitched_legs"] == 1


def test_cli_list_and_stitch_and_errors(tmp_path, capsys,
                                        isolated_recorder):
    tr = Tracer(capacity=8, tail_quantile=0.5, tail_cap=8)
    rspan = tr.start_span("predict", trace_id="T1", model="m")
    rspan.phase_start("worker_call")
    rspan.phases[0][1] -= 0.1
    rspan.start_s -= 0.1
    rspan.finish()
    ring = str(tmp_path / "ring.json")
    tracefleet.dump_ring(tr, ring)
    flight = tmp_path / "flight"
    rec = flightrec.FlightRecorder(str(flight), rank=1, incarnation=0)
    rec.record_span({"trace_id": "T1", "name": "serve",
                     "labels": {"model": "m"}, "start_unix_s": None,
                     "start_mono_s": None, "wall_ms": 80.0,
                     "phases": [{"name": "execute", "start_ms": 0.0,
                                 "dur_ms": 80.0}]})
    rec.close()

    assert tracefleet.main([str(flight), "--router", ring,
                            "--list"]) == 0
    out = capsys.readouterr().out
    assert "T1" in out and "router=y" in out and "legs=1" in out

    assert tracefleet.main([str(flight), "--router", ring,
                            "--trace", "T1"]) == 0
    out = capsys.readouterr().out
    assert "trace T1" in out and "execute" in out

    assert tracefleet.main([str(flight), "--trace", "T1",
                            "--json"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["partial"] and st["trace_id"] == "T1"

    pm_path = str(tmp_path / "pm.json")
    flightrec.write_postmortem(str(flight), pm_path, reason="kill",
                               failed_rank=1, incarnation=0)
    assert tracefleet.main(["--postmortem", pm_path, "--router", ring,
                            "--trace", "T1"]) == 0
    assert "trace T1" in capsys.readouterr().out

    with pytest.raises(SystemExit):
        tracefleet.main([])
    capsys.readouterr()
    assert tracefleet.main(["--postmortem",
                            str(tmp_path / "missing.json")]) == 2


# ---------------------------------------- against the JAX package's
STITCH_CASES = {
    "full": lambda: (_router_span(), [_leg()]),
    "forged_skew": lambda: (
        _router_span(retried=True),
        [_leg(rank=0, inc=0, rel_s=0.006, wall_ms=35.0, skew_s=+5.0),
         _leg(rank=1, inc=1, rel_s=0.046, wall_ms=50.0, skew_s=-5.0)]),
    "retried_missing_first": lambda: (
        _router_span(retried=True),
        [_leg(rank=1, rel_s=0.046, wall_ms=50.0)]),
    "router_only": lambda: (_router_span(), []),
    "legs_only": lambda: (None, [_leg()]),
    "anchorless": lambda: (_router_span(), [_leg(anchored=False)]),
    "longer_than_call": lambda: (_router_span(), [_leg(wall_ms=150.0)]),
    "junk": lambda: (None, [{"span": None}, "junk"]),
}


@pytest.mark.parametrize("case", sorted(STITCH_CASES))
def test_stitch_and_waterfall_equal_jax(case):
    router, legs = STITCH_CASES[case]()
    ours = tracefleet.stitch(router, legs, trace_id="T1")
    router, legs = STITCH_CASES[case]()
    theirs = jtracefleet.stitch(router, legs, trace_id="T1")
    assert ours == theirs
    assert tracefleet.render_waterfall(ours) == \
        jtracefleet.render_waterfall(theirs)
    assert tracefleet.render_waterfall(ours, width=20) == \
        jtracefleet.render_waterfall(theirs, width=20)


def test_assemble_and_summaries_equal_jax():
    pm = {"ranks": {
        "0": {"incarnation": 2,
              "meta": {"anchor": {"unix": 990.01, "mono": 190.0}},
              "spans": [_leg()["span"], _leg(trace_id="T2")["span"]]},
        "1": {"meta": {"incarnation": 1},
              "spans": [_leg(rel_s=0.02, wall_ms=30.0)["span"]]}}}
    for tid in ("T1", "T2", None):
        assert tracefleet.legs_from_postmortem(pm, trace_id=tid) == \
            jtracefleet.legs_from_postmortem(pm, trace_id=tid)
    legs = tracefleet.legs_from_postmortem(pm)
    routers = [_router_span(), _router_span("T2", retried=True)]
    for tid in ("T1", "T2", "T3"):
        assert tracefleet.assemble(tid, routers, legs) == \
            jtracefleet.assemble(tid, routers, legs)
    rs = _router_span()
    rs["children"] = [tracefleet.span_summary(_leg()["span"], rank=1,
                                              inc=0)]
    assert rs["children"][0] == jtracefleet.span_summary(
        _leg()["span"], rank=1, inc=0)
    assert tracefleet.assemble("T1", [rs], []) == \
        jtracefleet.assemble("T1", [rs], [])
    assert tracefleet._join_index(routers, legs) == \
        jtracefleet._join_index(routers, legs)


def test_live_span_wire_and_gap_equal_jax():
    """One live span's wire summary, parsed and gap-measured by both
    packages, agrees."""
    wtr = Tracer(capacity=8)
    wspan = wtr.start_span("serve", trace_id="W1", model="m")
    wspan.phase_start("admission_queue")
    wspan.phase_start("execute")
    wspan.start_s -= 0.05
    wspan.finish()
    wire = tracefleet.summary_wire(wspan, rank=3, inc=2)
    assert jtracefleet.summary_wire(wspan, rank=3, inc=2) == wire
    assert tracefleet.parse_summary(wire) == \
        jtracefleet.parse_summary(wire)
    rspan = Tracer(capacity=8).start_span("predict", trace_id="W1")
    rspan.phase_start("worker_call")
    rspan.phases[0][1] -= 0.07
    tracefleet.nest_summary(rspan, wire)
    rspan.finish()
    assert tracefleet.inline_gap_ms(rspan) == \
        jtracefleet.inline_gap_ms(rspan)


def test_jax_flight_files_harvest_in_the_port(tmp_path):
    """A flight directory the JAX package's recorder wrote harvests to
    the same legs in the port."""
    jflightrec._reset_for_tests()
    try:
        rec = jflightrec.FlightRecorder(str(tmp_path), rank=2,
                                        incarnation=1)
        rec.record_span(_leg(trace_id="J1")["span"])
        rec.record_span(_leg(trace_id="J2", wall_ms=20.0)["span"])
        rec.close()
    finally:
        jflightrec._reset_for_tests()
    legs = tracefleet.harvest_legs(str(tmp_path))
    assert [leg["span"]["trace_id"] for leg in legs] == ["J1", "J2"]
    assert all((leg["rank"], leg["inc"]) == (2, 1) for leg in legs)
    assert legs == jtracefleet.harvest_legs(str(tmp_path))
    st = tracefleet.assemble("J1", [_router_span("J1")], legs)
    assert st == jtracefleet.assemble("J1", [_router_span("J1")], legs)
    assert st["stitched_legs"] == 1
