"""The port's fleet (``analytics_zoo_tpu_torch.serving.fleet``): the
counterpart of ``tests/test_fleet.py``, case for case.

The frame codec (torn, short, CRC-bad and oversized frames, error
envelope fidelity, array bit-exactness, the binary wire's zero-copy
decode), the committed deploy artifact, and the supervisor and router
driven through REAL worker processes of the port in ``--fake`` mode
(stub builders: no device touched, no kernel built): fan-out order,
undeploy, retry on a worker death, revival, an all-dead fleet, priority
classes and structured errors across processes, the rank-merged scrape,
the stitched trace, version reuse after a router restart,
least-outstanding routing, the binary wire and its JSON fallback,
affinity, coalescing, the elastic pool, the autoscaler and the oversize
reply.  Real CPU workers (``device="cpu"``) replay a single-process
registry's generate token for token, and a worker asked for ``cuda``
without a card fails its activation instead of serving.

A fake worker pays the port's import (~5 s on a small CPU), so cases
share module-scoped fleets where they allow it (distinct model names
keep them apart); every router is closed in a finalizer, which stops
and reaps its workers.  The JAX side of the parity checks is in
``tests/test_torch_fleet_parity.py``.
"""

import json
import os
import socket
import struct
import threading
import time
import warnings
import zlib

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.observability.metrics import \
    parse_prometheus_text
from analytics_zoo_tpu_torch.serving import (ColdStartTimeout,
                                             DeadlineExceeded, DeployError,
                                             ModelNotFound, Overloaded,
                                             ServingError)
from analytics_zoo_tpu_torch.serving.fleet import (FleetRouter,
                                                   WorkerUnavailable,
                                                   artifact, protocol)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = "analytics_zoo_tpu_torch.serving.fleet.builders:stub"
LM = "analytics_zoo_tpu_torch.serving.fleet.builders:lm"
WORKER_ENV = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


# ------------------------------------------------------------ protocol
def _pair():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    return a, b


def test_frame_roundtrip_and_arrays():
    a, b = _pair()
    try:
        ints = np.arange(12, dtype=np.int16).reshape(3, 4)
        x = ints.astype(np.float32)
        x[0, 0] = np.nan  # bit-exact means NaN payload bits too
        obj = {"op": "predict", "id": 7, "nested": [1, "s", None],
               "inputs": protocol.encode_value(x),
               "many": protocol.encode_value([ints, {"k": x}])}
        protocol.send_frame(a, obj)
        got = protocol.recv_frame(b)
        assert got["op"] == "predict" and got["id"] == 7
        y = protocol.decode_value(got["inputs"])
        assert y.dtype == np.float32 and y.shape == (3, 4)
        assert np.array_equal(y, x, equal_nan=True)
        many = protocol.decode_value(got["many"])
        assert many[0].dtype == np.int16
        assert np.array_equal(many[1]["k"], x, equal_nan=True)
    finally:
        a.close()
        b.close()


def test_clean_eof_between_frames_is_none():
    a, b = _pair()
    protocol.send_frame(a, {"id": 1})
    a.close()
    try:
        assert protocol.recv_frame(b) == {"id": 1}
        assert protocol.recv_frame(b) is None  # hangup, not an error
    finally:
        b.close()


def test_torn_frame_raises():
    """EOF mid-payload (a worker SIGKILLed mid-sendall) is a
    FrameError, never a short JSON parsed as truth."""
    a, b = _pair()
    payload = json.dumps({"id": 2, "big": "x" * 64}).encode()
    frame = struct.pack("<II", len(payload),
                        zlib.crc32(payload) & 0xffffffff) + payload
    a.sendall(frame[:len(frame) - 10])
    a.close()
    try:
        with pytest.raises(protocol.FrameError, match="short read"):
            protocol.recv_frame(b)
    finally:
        b.close()


def test_torn_header_raises():
    a, b = _pair()
    a.sendall(b"\x05\x00")  # 2 of 8 header bytes
    a.close()
    try:
        with pytest.raises(protocol.FrameError, match="short read"):
            protocol.recv_frame(b)
    finally:
        b.close()


def test_crc_mismatch_and_oversize_raise():
    a, b = _pair()
    payload = b'{"id": 3}'
    a.sendall(struct.pack("<II", len(payload), 12345) + payload)
    try:
        with pytest.raises(protocol.FrameError, match="CRC"):
            protocol.recv_frame(b)
    finally:
        a.close()
        b.close()
    a, b = _pair()
    a.sendall(struct.pack("<II", protocol.MAX_FRAME_BYTES + 1, 0))
    try:
        with pytest.raises(protocol.FrameError, match="exceeds"):
            protocol.recv_frame(b)
    finally:
        a.close()
        b.close()


# --------------------------------------------------------- binary wire
def test_binary_payload_roundtrip_zero_copy():
    """Nested envelopes with arrays hoisted out of band round-trip
    bit-exactly (NaN and -0.0 bits included), the decode is zero-copy
    (read-only views over the received buffer), and the binary payload
    is smaller than the JSON one."""
    ints = np.arange(10, dtype=np.int16).reshape(2, 5)
    x = ints.astype(np.float32)
    x[0, 0] = np.nan
    x[1, 1] = -0.0
    obj = {"op": "predict", "id": 9, "inputs": x,
           "nested": {"deep": [ints, {"k": x}], "s": "txt", "n": None},
           "empty": np.zeros((0, 3), dtype=np.float64)}
    payload = protocol.encode_binary(obj)
    assert payload.startswith(protocol.BIN_MAGIC)
    back = protocol.decode_binary(payload)
    assert back["op"] == "predict" and back["id"] == 9
    y = back["inputs"]
    assert y.dtype == np.float32 and y.shape == (2, 5)
    assert y.tobytes() == x.tobytes()
    assert back["nested"]["deep"][0].dtype == np.int16
    assert np.array_equal(back["nested"]["deep"][0], ints)
    assert back["nested"]["s"] == "txt" and back["nested"]["n"] is None
    assert back["empty"].shape == (0, 3)
    assert y.base is not None and not y.flags.writeable
    as_json = json.dumps(protocol.encode_value(obj),
                         separators=(",", ":")).encode()
    assert len(payload) < len(as_json)


def test_binary_envelope_over_socket_first_byte_discriminates():
    a, b = _pair()
    try:
        x = np.arange(24, dtype=np.float64).reshape(4, 6)
        n_tx = protocol.send_envelope(a, {"id": 1, "inputs": x},
                                      binary=True)
        env, n_rx, enc = protocol.recv_envelope(b)
        assert enc == "binary" and n_rx == n_tx
        assert np.array_equal(env["inputs"], x)
        n_tx = protocol.send_envelope(a, {"id": 2, "inputs": x},
                                      binary=False)
        env, n_rx, enc = protocol.recv_envelope(b)
        assert enc == "json" and n_rx == n_tx
        assert np.array_equal(env["inputs"], x)
    finally:
        a.close()
        b.close()


def test_binary_torn_mid_buffer_and_crc_raise():
    payload = protocol.encode_binary(
        {"id": 4, "x": np.arange(1024, dtype=np.float64)})
    frame = struct.pack("<II", len(payload),
                        zlib.crc32(payload) & 0xffffffff) + payload
    a, b = _pair()
    a.sendall(frame[:len(frame) - 100])
    a.close()
    try:
        with pytest.raises(protocol.FrameError, match="short read"):
            protocol.recv_envelope(b)
    finally:
        b.close()
    a, b = _pair()
    a.sendall(frame[:-1] + bytes([frame[-1] ^ 0xFF]))
    try:
        with pytest.raises(protocol.FrameError, match="CRC"):
            protocol.recv_envelope(b)
    finally:
        a.close()
        b.close()


def test_binary_garbage_header_is_frame_error():
    bad = protocol.BIN_MAGIC + struct.pack("<I", 999999) + b"{}"
    with pytest.raises(protocol.FrameError, match="binary"):
        protocol.decode_binary(bad)


def test_env_frame_cap_and_attempted_bytes(monkeypatch):
    """ZOO_FLEET_MAX_FRAME caps both directions; the oversize send
    carries attempted_bytes and fires before any byte reaches the
    socket, so the connection survives."""
    monkeypatch.setenv("ZOO_FLEET_MAX_FRAME", "64")
    assert protocol.max_frame_bytes() == 64
    a, b = _pair()
    try:
        with pytest.raises(protocol.FrameError) as ei:
            protocol.send_envelope(
                a, {"id": 1, "x": np.zeros(64)}, binary=True)
        assert ei.value.attempted_bytes is not None
        assert ei.value.attempted_bytes > 64
        with pytest.raises(protocol.FrameError) as ei:
            protocol.send_frame(a, {"id": 1, "pad": "y" * 64})
        assert ei.value.attempted_bytes is not None
        monkeypatch.setenv("ZOO_FLEET_MAX_FRAME", "1048576")
        protocol.send_envelope(a, {"id": 2}, binary=False)
        assert protocol.recv_envelope(b)[0] == {"id": 2}
    finally:
        a.close()
        b.close()
    monkeypatch.setenv("ZOO_FLEET_MAX_FRAME", "64")
    a, b = _pair()
    a.sendall(struct.pack("<II", 100, 0))
    try:
        with pytest.raises(protocol.FrameError, match="exceeds"):
            protocol.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_full_width_reply_rows_against_the_default_frame_bound():
    """One full-width TransformerLM predict row is 32000 x 640 f32
    (81.9 MB): under the default 256 MiB bound 3 rows fit on the binary
    wire and 4 do not; on the JSON wire (base64, a third larger) 2 fit
    and 3 do not.  Sized from the frames' exact lengths, with no array
    materialized."""
    row = 32000 * 640 * 4
    cap = protocol.max_frame_bytes()
    assert cap == protocol.MAX_FRAME_BYTES == 256 << 20
    env = {"id": 1, "ok": True, "info": {"model": "lm", "version": 1}}
    head = len(protocol.encode_binary(dict(env, result=np.zeros(
        (1, 1, 1), np.float32))))
    for rows, fits in ((3, True), (4, False)):
        n = head + rows * row  # binary: the header plus raw buffers
        assert (n <= cap) is fits, (rows, n)
    for rows, fits in ((2, True), (3, False)):
        n = 4 * ((rows * row + 2) // 3)  # base64 of the buffer alone
        assert (n <= cap) is fits, (rows, n)


def test_tensors_encode_as_host_arrays_never_pickled():
    """A torch tensor reaching the encoder goes out as a numpy array of
    its dtype and values (both encodings), and ``to_device`` copies a
    read-only zero-copy view once instead of aliasing the frame."""
    from analytics_zoo_tpu_torch.pipeline.inference.serving import \
        to_device
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    t.requires_grad_(True)
    env = {"id": 1, "result": t * 2}
    back = protocol.decode_binary(protocol.encode_binary(env))["result"]
    assert back.dtype == np.float32
    assert np.array_equal(back, (t * 2).detach().numpy())
    js = protocol.decode_value(json.loads(json.dumps(
        protocol.encode_value(env))))["result"]
    assert np.array_equal(js, back)
    assert b"torch" not in protocol.encode_binary(env)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        placed = to_device(back, torch.device("cpu"))
    placed += 1  # a copy: the frame's bytes are untouched
    assert np.array_equal(back, (t * 2).detach().numpy())


@pytest.mark.parametrize("exc,code,detail", [
    (Overloaded("queue full", evicted=True, queue_depth=64),
     "Overloaded", ("evicted", True)),
    (DeadlineExceeded("hopeless", shed=True, predicted_ms=12.5),
     "DeadlineExceeded", ("shed", True)),
    (ModelNotFound("no such model", model="nope"),
     "ModelNotFound", ("model", "nope")),
    (DeployError("warmup blew up", model="m", version=3),
     "DeployError", ("version", 3)),
    (ColdStartTimeout("cold past deadline", model="m",
                      waited_ms=52.1),
     "ColdStartTimeout", ("waited_ms", 52.1)),
    (WorkerUnavailable("no worker", states={"dead": 2}),
     "WorkerUnavailable", ("states", {"dead": 2})),
])
def test_error_envelope_fidelity(exc, code, detail):
    """A serving error crossing the wire rebuilds the CONCRETE class
    with message, details and http_status."""
    back = protocol.decode_error(protocol.encode_error(exc))
    assert type(back) is type(exc)
    assert back.code == code
    assert back.message == exc.message
    k, v = detail
    assert back.details[k] == v
    assert back.http_status == exc.http_status


def test_unknown_error_code_degrades_to_serving_error():
    back = protocol.decode_error(
        protocol.encode_error(ValueError("bad rows")))
    assert isinstance(back, ServingError)
    assert back.details["error"] == "ValueError"
    assert "bad rows" in back.message


# ------------------------------------------------------------ artifact
def test_artifact_commit_point_is_the_spec(tmp_path):
    share = str(tmp_path)
    w = {"w0": np.arange(4, dtype=np.float32),
         "w1": torch.ones(2, 2)}  # a tensor is saved from the host
    d = artifact.publish(share, "m", 1, w, {"builder": STUB})
    assert artifact.versions(share, "m") == {1: d}
    os.makedirs(os.path.join(artifact.deploys_root(share), "m", "v2"))
    assert artifact.versions(share, "m") == {1: d}
    spec, params = artifact.load(share, "m", 1)
    assert spec["builder"] == STUB and spec["version"] == 1
    assert np.array_equal(params["w0"], w["w0"])
    assert np.array_equal(params["w1"], np.ones((2, 2), np.float32))
    with pytest.raises(ValueError, match="invalid model name"):
        artifact.publish(share, "../evil", 1, None, {"builder": STUB})


def test_artifact_refuses_the_jax_packages_builders(tmp_path):
    """A spec naming a builder of the JAX package is refused with a
    ValueError that names the path; the port's own resolves, and its
    builders take the worker's device."""
    path = "analytics_zoo_tpu.serving.fleet.builders:mlp"
    with pytest.raises(ValueError, match="analytics_zoo_tpu.serving"):
        artifact.resolve_builder(path)
    with pytest.raises(ValueError, match="module:callable"):
        artifact.resolve_builder("no_colon")
    kw = artifact.build_deploy_kwargs(
        {"builder": "analytics_zoo_tpu_torch.serving.fleet.builders:mlp",
         "args": {}, "warmup_shapes": [3], "deploy_kwargs": {
             "max_batch_size": 4}},
        {"w0": np.eye(3), "w1": np.ones((3, 2))}, device="cpu")
    assert kw["params"]["w0"].dtype == torch.float32  # f64 narrowed
    assert kw["params"]["w0"].device.type == "cpu"
    assert kw["warmup_shapes"] == (3,) and kw["max_batch_size"] == 4
    y = kw["fn"](kw["params"], torch.ones(1, 3))
    assert torch.allclose(y, torch.tanh(torch.tanh(torch.ones(1, 3))
                                        @ torch.ones(3, 2)))


# ------------------------------------------------- fake-worker fleets
def _router(share, **kw):
    kw.setdefault("max_restarts", 2)
    kw.setdefault("restart_backoff", 0.2)
    env = dict(WORKER_ENV)
    env.update(kw.pop("env", None) or {})
    kw.setdefault("fake", True)
    return FleetRouter(str(share), env=env, **kw)


@pytest.fixture
def make_fleet(tmp_path):
    routers = []

    def make(n_workers=2, **kw):
        r = _router(tmp_path / "share", n_workers=n_workers, **kw)
        routers.append(r)
        r.start(timeout=90)
        return r

    yield make
    for r in routers:
        r.close()


@pytest.fixture(scope="module")
def fleet2(tmp_path_factory):
    """A shared two-worker fake fleet (cases use distinct models)."""
    r = _router(tmp_path_factory.mktemp("fleet2"), n_workers=2)
    try:
        r.start(timeout=90)
        yield r
    finally:
        r.close()


@pytest.fixture(scope="module")
def fleet1(tmp_path_factory):
    """A shared one-worker fake fleet with priority classes and a
    single concurrency slot."""
    r = _router(tmp_path_factory.mktemp("fleet1"), n_workers=1,
                registry_kwargs={"priority_classes": {"gold": [10, 0.9]},
                                 "max_queue": 8, "max_concurrency": 1})
    try:
        r.start(timeout=90)
        yield r
    finally:
        r.close()


def _wait(cond, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def test_deploy_predict_roundtrip_and_fanout_ordering(fleet2):
    """Deploy fans out ONE worker at a time in rank order, and the
    served result is bit-exact for the version the info names."""
    r = fleet2
    rep = r.deploy("rt", None, STUB, builder_args={"scale": 2.0})
    acts = rep["activations"]
    assert [a["rank"] for a in acts] == [0, 1]
    assert all("error" not in a for a in acts)
    assert acts[0]["t_end"] <= acts[1]["t_start"]
    # a fake activation builds nothing of any kind
    assert all(a["compiles"] == a["kernel_builds"] == a["graph_captures"]
               == a["signature_builds"] == 0 for a in acts)
    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    out, info = r.predict_ex("rt", x)
    assert info["model"] == "rt" and info["version"] == 1
    assert np.array_equal(out, x * 2.0)
    r.deploy("rt", None, STUB, builder_args={"scale": 3.0})
    out, info = r.predict_ex("rt", x)
    assert info["version"] == 2 and np.array_equal(out, x * 3.0)


def test_undeploy_retires_fleet_series_and_serving(fleet2):
    r = fleet2
    r.deploy("gone", None, STUB, builder_args={"scale": 2.0})
    r.deploy("kept", None, STUB, builder_args={"scale": 3.0})
    x = np.ones((1, 4))
    assert np.array_equal(r.predict_ex("gone", x)[0], x * 2.0)
    fams = {f.name: f for f in r.families()}
    fanout = fams["zoo_fleet_deploy_fanout_seconds"]
    assert {"gone", "kept"} <= {s[0]["model"] for s in fanout.samples}
    rep = r.undeploy("gone")
    assert [a["rank"] for a in rep["activations"]] == [0, 1]
    assert all(a["model"] == "gone" for a in rep["activations"])
    with pytest.raises(ModelNotFound):
        r.predict_ex("gone", x)
    fams = {f.name: f for f in r.families()}
    models = {s[0]["model"]
              for s in fams["zoo_fleet_deploy_fanout_seconds"].samples}
    assert "gone" not in models and "kept" in models
    assert np.array_equal(r.predict_ex("kept", x)[0], x * 3.0)
    parsed = parse_prometheus_text(r.metrics_text())
    models = {dict(k[1]).get("model") for k in parsed["samples"]}
    assert "gone" not in models and "kept" in models


def test_router_retries_once_on_worker_death_mid_request(make_fleet):
    """The stub's die_after kills the worker PROCESS before it replies:
    every request completes on the sibling, the retry is counted, and
    the supervisor restarts and replays the dead worker."""
    r = make_fleet(n_workers=2)
    r.deploy("m", None, STUB,
             builder_args={"scale": 1.0, "die_after": 3,
                           "die_rank": 1})
    x = np.ones((1, 4))
    for _ in range(10):
        out, _ = r.predict_ex("m", x)
        assert np.array_equal(out, x)
    assert r.retries_total == 1
    assert _wait(lambda: r.supervisor.postmortems
                 and r.states().get("live") == 2)
    assert r.ping(1)["incarnation"] == 1
    assert r.ping(1)["models"] == {"m": 1}
    rep = r.replays[1]
    assert rep == [{"model": "m", "version": 1, "compiles": 0,
                    "store_hits": 0, "store_misses": 0,
                    "warm_ms": rep[0]["warm_ms"], "rank": 1,
                    "kernel_builds": 0, "signature_builds": 0,
                    "graph_captures": 0}]
    with open(r.supervisor.postmortems[0]) as f:
        pm = json.load(f)
    assert pm["failed_rank"] == 1 and pm["reason"] == "exit"
    assert pm["ranks"]["1"]["rc"] == 17


def test_transient_timeout_unroutes_then_revives(make_fleet):
    """A call timeout on a HEALTHY worker unroutes it only until the
    detached revival probe's next successful ping: no restart, no
    postmortem, same incarnation."""
    r = make_fleet(n_workers=2, call_timeout_s=0.3)
    r.deploy("fast", None, STUB)
    r.deploy("slow", None, STUB, builder_args={"delay_s": 0.8})
    with pytest.raises(ConnectionError):
        r.predict_ex("slow", np.ones((1, 2)))
    assert _wait(lambda: all(h.routable for h in r.handles),
                 timeout=10)
    out, _ = r.predict_ex("fast", np.ones((1, 2)))
    assert np.array_equal(out, np.ones((1, 2)))
    assert r.supervisor.postmortems == []
    assert [r.ping(rk)["incarnation"] for rk in (0, 1)] == [0, 0]


def test_all_workers_dead_raises_worker_unavailable(make_fleet):
    r = make_fleet(n_workers=1, max_restarts=0)
    r.deploy("m", None, STUB)
    r.supervisor.kill(0)
    assert _wait(lambda: r.states().get("dead") == 1)
    with pytest.raises(WorkerUnavailable) as ei:
        r.predict_ex("m", np.ones((1, 2)))
    assert ei.value.http_status == 503
    assert ei.value.details["states"]["dead"] == 1


def test_priority_class_and_structured_errors_cross_process(fleet1):
    """A priority class tags the worker-side admission counters, and a
    predictive deadline shed comes back as DeadlineExceeded(shed=True)
    with its details."""
    r = fleet1
    r.deploy("pri", None, STUB, builder_args={"delay_s": 0.05})
    x = np.ones((1, 2))
    out, _ = r.predict_ex("pri", x, priority_class="gold")
    assert np.array_equal(out, x)
    with pytest.raises(DeadlineExceeded) as ei:
        r.predict_ex("pri", x, deadline_ms=1.0, priority_class="gold")
    assert ei.value.details.get("shed") is True
    s = parse_prometheus_text(r.metrics_text())["samples"]
    assert s[("zoo_class_admitted_total",
              (("class", "gold"), ("model", "pri"),
               ("rank", "0")))] == 1.0
    assert s[("zoo_shed_total",
              (("class", "gold"), ("model", "pri"),
               ("rank", "0")))] == 1.0


def test_fleet_scrape_merges_ranks_and_fleet_families(fleet2):
    r = fleet2
    r.deploy("sc", None, STUB)
    x = np.ones((1, 2))
    for _ in range(4):
        r.predict("sc", x)
    parsed = parse_prometheus_text(r.metrics_text())
    s = parsed["samples"]
    assert parsed["types"]["zoo_fleet_workers"] == "gauge"
    assert s[("zoo_fleet_workers", (("state", "live"),))] == 2
    assert s[("zoo_fleet_workers", (("state", "dead"),))] == 0
    assert parsed["types"]["zoo_fleet_router_retries_total"] == "counter"
    assert s[("zoo_fleet_router_retries_total", ())] == 0
    assert s[("zoo_fleet_deploy_fanout_seconds",
              (("model", "sc"), ("version", "1")))] >= 0
    per_rank = [s.get(("zoo_model_requests_total",
                       (("model", "sc"), ("rank", str(rk)),
                        ("version", "1")))) for rk in (0, 1)]
    total = s[("zoo_model_requests_total",
               (("model", "sc"), ("version", "1")))]
    assert sum(v for v in per_rank if v is not None) == total == 4.0


def test_distributed_trace_stitches_across_processes(fleet2):
    """A traced request piggybacks the worker span on the reply (the
    router span gains a child and info fleet_gap_ms), the exemplars ride
    the router scrape, and the offline stitcher rebuilds the request
    from the supervisor's flight directory."""
    from analytics_zoo_tpu_torch.observability import tracefleet
    from analytics_zoo_tpu_torch.observability.trace import Tracer
    r = fleet2
    r.tracer = Tracer(capacity=64, tail_quantile=0.5, tail_cap=8)
    try:
        r.deploy("tr", None, STUB, builder_args={"scale": 2.0})
        x = np.ones((1, 2))
        infos = [r.predict_ex("tr", x)[1] for _ in range(4)]
        assert all("request_id" in info for info in infos)
        assert any("fleet_gap_ms" in info for info in infos)
        tid = infos[-1]["request_id"]
        sd = r.tracer.find(tid)
        ch = sd["children"]
        assert len(ch) == 1 and ch[0]["tid"] == tid
        assert ch[0]["rank"] in (0, 1) and ch[0]["phases"]
        flight = r.supervisor.flight_dir()
        assert _wait(lambda: tracefleet.harvest_legs(flight,
                                                     trace_id=tid))
        st = tracefleet.stitch(sd, tracefleet.harvest_legs(
            flight, trace_id=tid))
        assert st["stitched_legs"] == 1 and st["monotonic"]
        assert not st["partial"]
        assert st["attributed_fraction"] > 0.5
        text = r.metrics_text()
        assert 'zoo_trace_spans_total{rank="router"}' in text
        assert "zoo_trace_exemplar_ms" in text
    finally:
        r.tracer = None


def test_restarted_router_never_reuses_versions(tmp_path):
    """Auto-versioning starts from the COMMITTED artifacts on disk: a
    second router over the same share continues the sequence."""
    share = tmp_path / "share"
    r1 = _router(share, n_workers=1)
    try:
        r1.start(timeout=90)
        assert r1.deploy("m", None, STUB)["version"] == 1
    finally:
        r1.close()
    r2 = _router(share, n_workers=1)
    try:
        r2.start(timeout=90)
        assert r2.deploy("m", None, STUB)["version"] == 2
        assert sorted(artifact.versions(str(share), "m")) == [1, 2]
        out, info = r2.predict_ex("m", np.ones((1, 2)))
        assert info["version"] == 2
    finally:
        r2.close()


def test_least_outstanding_spreads_and_ping(fleet2):
    """Sequential requests against idle workers rotate, so both serve;
    ping reports identity and the kernel launch counts."""
    r = fleet2
    r.deploy("lo", None, STUB)
    x = np.ones((2, 2))
    for _ in range(8):
        r.predict("lo", x)
    pings = [r.ping(rk) for rk in (0, 1)]
    assert [p["models"]["lo"] for p in pings] == [1, 1]
    assert [p["rank"] for p in pings] == [0, 1]
    assert all(p["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                 "flash_bwd_dkv": 0} for p in pings)
    s = parse_prometheus_text(r.metrics_text())["samples"]
    counts = [s.get(("zoo_model_requests_total",
                     (("model", "lo"), ("rank", str(rk)),
                      ("version", "1")))) for rk in (0, 1)]
    assert all(c and c >= 3 for c in counts), counts


def test_binary_wire_shrinks_bytes_and_stays_bit_exact(fleet1):
    """The binary wire against the JSON wire on one fleet: identical
    results bit for bit, fewer bytes both ways, counted by direction
    and encoding; the reply's load piggyback fills the residency
    view."""
    r = fleet1
    r.deploy("bw", None, STUB, builder_args={"scale": 3.0})
    x = np.arange(64 * 64, dtype=np.float64).reshape(64, 64) / 7.0
    try:
        wb0 = r.wire_bytes
        out_bin, _ = r.predict_ex("bw", x)
        wb1 = r.wire_bytes
        bin_tx = wb1.get(("tx", "binary"), 0) - wb0.get(("tx", "binary"),
                                                        0)
        bin_rx = wb1.get(("rx", "binary"), 0) - wb0.get(("rx", "binary"),
                                                        0)
        assert bin_tx > 0 and bin_rx > 0
        assert "bw" in r.handles[0].resident
        r.set_wire("json")
        out_json, _ = r.predict_ex("bw", x)
        wb2 = r.wire_bytes
        json_tx = wb2.get(("tx", "json"), 0) - wb1.get(("tx", "json"), 0)
        json_rx = wb2.get(("rx", "json"), 0) - wb1.get(("rx", "json"), 0)
    finally:
        r.set_wire("binary")
    assert np.array_equal(out_bin, x * 3.0)
    assert np.asarray(out_bin).tobytes() == np.asarray(out_json).tobytes()
    assert json_tx > bin_tx * 1.2, (json_tx, bin_tx)
    assert json_rx > bin_rx * 1.2, (json_rx, bin_rx)
    with pytest.raises(ValueError):
        r.set_wire("pickle")


def test_wire_negotiation_falls_back_to_json_pinned_worker(make_fleet):
    r = make_fleet(n_workers=1, env={"ZOO_FLEET_WIRE": "json"})
    r.deploy("m", None, STUB, builder_args={"scale": 2.0})
    x = np.arange(32, dtype=np.float64).reshape(4, 8)
    out, _ = r.predict_ex("m", x)
    assert np.array_equal(out, x * 2.0)
    wb = r.wire_bytes
    assert wb[("tx", "json")] > 0 and wb[("rx", "json")] > 0
    assert not any(enc == "binary" for _, enc in wb)


def test_affinity_scoring_prefers_resident_worker(fleet2):
    """A worker holding the model wins until it is ``affinity_penalty``
    requests deeper than a sibling; outcomes counted hit/miss/cold and
    exposed as zoo_fleet_affinity_total."""
    r = fleet2
    h0, h1 = r.handles
    saved = [(h.resident, h.outstanding) for h in (h0, h1)]
    picked = []
    try:
        with r._lock:
            r._rr = 0
        base = r.affinity_counts
        h0.resident, h1.resident = frozenset(), frozenset({"aff"})

        def delta():
            now = r.affinity_counts
            return {k: now[k] - base[k] for k in now}

        for _ in range(4):
            picked.append(r._pick(model="aff"))
            assert picked[-1] is h1
        picked.append(r._pick(model="aff"))
        assert picked[-1] is h0
        picked.append(r._pick(model="aff_other"))
        assert delta() == {"hit": 4, "miss": 1, "cold": 1}
        picked.append(r._pick(model="aff", count=False))
        assert delta() == {"hit": 4, "miss": 1, "cold": 1}
        fams = {f.name: f for f in r.families()}
        aff = {s[0]["outcome"]: s[1]
               for s in fams["zoo_fleet_affinity_total"].samples}
        assert {k: aff[k] - base[k] for k in aff} == {"hit": 4, "miss": 1,
                                                      "cold": 1}
        assert "zoo_fleet_wire_bytes_total" in fams
    finally:
        for h in picked:
            r._release(h)
        for h, (res, out) in zip((h0, h1), saved):
            h.resident = res
            assert h.outstanding == out


def test_router_coalesces_concurrent_predicts(fleet1):
    """Concurrent compatible predicts merge into ONE wire request, each
    caller gets its own rows bit-exactly, and info["coalesced"] shows
    the merged ride."""
    r = fleet1
    r.deploy("co", None, STUB, builder_args={"scale": 2.0})
    xs = [np.full((2, 4), float(i)) for i in range(3)]
    outs = [None] * 3
    infos = [None] * 3
    errs = []

    def call(i):
        try:
            outs[i], infos[i] = r.predict_ex("co", xs[i])
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    r.coalesce_ms = 40.0
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.005)  # land inside the leader's window
        for t in threads:
            t.join(60)
    finally:
        r.coalesce_ms = 0.0
    assert errs == []
    for i in range(3):
        assert np.array_equal(outs[i], xs[i] * 2.0), i
    merged = [inf.get("coalesced") for inf in infos
              if inf.get("coalesced")]
    assert merged and max(merged) >= 4


def test_elastic_scale_down_drains_then_scale_up_revives(make_fleet):
    """Scale-down under live traffic latches and drains the victims
    (no dropped request, no postmortem); scale-up revives the retired
    slots as fresh incarnations that replay the version set before
    turning routable."""
    r = make_fleet(n_workers=3)
    r.deploy("m", None, STUB,
             builder_args={"scale": 2.0, "delay_s": 0.05})
    x = np.ones((1, 4))
    oks, errs = [], []

    def hammer():
        for _ in range(10):
            try:
                out, _ = r.predict_ex("m", x)
                oks.append(bool(np.array_equal(out, x * 2.0)))
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    rep = r.set_pool_size(1)
    for t in threads:
        t.join(60)
    assert errs == [] and all(oks) and len(oks) == 40
    assert rep["retired"] == [2, 1] and rep["forced"] == []
    assert r.pool_size() == 1
    assert r.states()["retired"] == 2
    assert r.supervisor.postmortems == []
    rep2 = r.set_pool_size(3)
    assert sorted(rep2["grew"]) == [1, 2]
    assert _wait(lambda: r.states().get("live") == 3)
    for rk in (1, 2):
        info = r.ping(rk)
        assert info["incarnation"] == 1
        assert info["models"] == {"m": 1}
        assert [rec["model"] for rec in r.replays[rk]] == ["m"]
    out, _ = r.predict_ex("m", x)
    assert np.array_equal(out, x * 2.0)
    with pytest.raises(ValueError):
        r.set_pool_size(0)


def test_autoscaler_drives_pool_through_load_signals(make_fleet):
    from analytics_zoo_tpu_torch.serving.fleet import fleet_autoscaler
    r = make_fleet(n_workers=2)
    r.deploy("m", None, STUB)
    r.set_pool_size(1)
    sc = fleet_autoscaler(
        r, min_replicas=1, max_replicas=2, up_queue_depth=2,
        down_queue_depth=0, hold_ticks=1, cooldown_s=0.0,
        interval_s=0.01)
    assert r.pool_size() == 1
    with r._lock:
        r.handles[0].outstanding += 3
    sc.tick()
    assert r.pool_size() == 2
    with r._lock:
        r.handles[0].outstanding -= 3
    out, _ = r.predict_ex("m", np.ones((1, 2)))
    assert np.array_equal(out, np.ones((1, 2)))


def test_oversize_reply_degrades_to_structured_error(make_fleet):
    """A reply past ZOO_FLEET_MAX_FRAME comes back as a structured
    error carrying the attempted size, not a dead connection read as a
    worker crash; the connection then serves the next request."""
    r = make_fleet(n_workers=1, env={"ZOO_FLEET_MAX_FRAME": "8192"})
    r.deploy("big", None, STUB, builder_args={"expand": 64})
    r.deploy("ok", None, STUB, builder_args={"scale": 2.0})
    x = np.ones((4, 16), dtype=np.float64)
    with pytest.raises(ServingError) as ei:
        r.predict_ex("big", x)
    d = ei.value.details
    assert d["error"] == "FrameError"
    assert d["attempted_bytes"] > 8192
    assert d["max_frame_bytes"] == 8192
    out, _ = r.predict_ex("ok", x)
    assert np.array_equal(out, x * 2.0)
    assert r.retries_total == 0
    assert r.supervisor.postmortems == []


# ----------------------------------------------- real CPU workers
LM_ARGS = {"vocab_size": 32, "seq_len": 48, "n_layers": 1,
           "d_model": 16, "n_heads": 2, "capacity": 2,
           "prompt_buckets": [8, 16], "prefix_pool": 2}


def test_cross_process_generate_determinism(tmp_path):
    """The same (prompt, seed, sampling) through a REAL port worker
    process on the CPU and through a single-process port registry built
    from the SAME builder gives the same tokens, greedy and sampled."""
    from analytics_zoo_tpu_torch.serving import ModelRegistry
    from analytics_zoo_tpu_torch.serving.fleet import builders

    prompt = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3]]  # pool-eligible: 8 + tail
    cases = [
        dict(max_new_tokens=6),
        dict(max_new_tokens=6, temperature=0.9, top_k=8, top_p=0.9,
             seed=77),
        dict(max_new_tokens=5, temperature=1.3, seed=12345),
    ]
    reg = ModelRegistry(device="cpu")
    try:
        reg.deploy("lm", **builders.lm(LM_ARGS, None, device="cpu"))
        ref = [[np.asarray(t).tolist() for t in
                reg.generate("lm", np.asarray(prompt, np.int32), **c)]
               for c in cases]
    finally:
        reg.shutdown()

    r = _router(tmp_path / "share", n_workers=1, fake=False,
                device="cpu", max_restarts=1)
    try:
        r.start(timeout=120)
        rep = r.deploy("lm", None, LM, builder_args=LM_ARGS)
        assert all("error" not in a for a in rep["activations"]), rep
        # the CPU runs eagerly: no kernel build, no graph capture
        assert rep["activations"][0]["kernel_builds"] == 0
        assert rep["activations"][0]["graph_captures"] == 0
        for c, expect in zip(cases, ref):
            out, info = r.generate_ex(
                "lm", np.asarray(prompt, np.int32), **c)
            got = [np.asarray(t).tolist() for t in out]
            assert got == expect, (c, got, expect)
            out2, _ = r.generate_ex(
                "lm", np.asarray(prompt, np.int32), **c)
            assert [np.asarray(t).tolist() for t in out2] == got
    finally:
        r.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
def test_cuda_worker_without_a_card_fails_activation(tmp_path):
    """A real worker asked for ``cuda`` on a host without a card fails
    its activation with the registry's DeployError (stage "build") and
    serves nothing: no fallback to the CPU."""
    r = _router(tmp_path / "share", n_workers=1, fake=False,
                max_restarts=0)
    try:
        r.start(timeout=120)
        rep = r.deploy("lm", None, LM, builder_args=LM_ARGS)
        (act,) = rep["activations"]
        assert act["error"].startswith("DeployError"), act
        assert "CUDA is not available" in act["error"]
        with pytest.raises(ModelNotFound):
            r.predict_ex("lm", np.zeros((1, 8), np.int32))
        assert r.ping(0)["models"] == {}
        w = np.ones((4, 4), np.float32)
        rep = r.deploy("mlp", {"w0": w}, "analytics_zoo_tpu_torch."
                       "serving.fleet.builders:mlp")
        assert rep["activations"][0]["error"].startswith("DeployError")
        assert r.ping(0)["models"] == {}
    finally:
        r.close()
