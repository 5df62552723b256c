"""The web-service sample on the port
(``apps/web-service-sample/web_service_torch.py``), in process on the
CPU with the miniature LM: the app's own ``--self-test`` (concurrent
clients, a hot swap mid-traffic with zero failed requests), the
structured error surface (404/429/504 bodies keyed as the JAX package's
``serving/errors.py`` keys them), /deploy, /promote, /metrics and
/traces; /predict against the JAX app's classifier on the same weights
and greedy /generate against the JAX ``TransformerLM.generate``, token
for token.  The JAX package's serving modules do not import here
(ROADMAP Queue 3), so its ``errors.py`` (stdlib only) is loaded by path
and its admission's error fields are read from its source."""

import ast
import importlib.util
import json
import os
import threading
import time
from http.server import ThreadingHTTPServer
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP = os.path.join(REPO, "apps", "web-service-sample")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mod():
    return _load(os.path.join(APP, "web_service_torch.py"),
                 "zoo_web_service_torch")


@pytest.fixture(scope="module")
def jax_app():
    """The JAX app (its model builders import the JAX package lazily)."""
    return _load(os.path.join(APP, "web_service.py"), "zoo_web_service_jax")


@pytest.fixture(scope="module")
def jax_errors():
    return _load(os.path.join(REPO, "analytics_zoo_tpu", "serving",
                              "errors.py"), "zoo_jax_serving_errors")


def _serve(mod, registry, obs=None):
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 mod.make_handler(registry, obs, "cpu"))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]


def _post(port, path, payload, headers=None):
    req = Request(f"http://127.0.0.1:{port}{path}",
                  data=json.dumps(payload).encode(),
                  headers={"Content-Type": "application/json",
                           **(headers or {})})
    with urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture
def app(mod):
    """The app's registry (miniature LM, CPU) behind a live server."""
    registry, obs = mod.build_registry(device="cpu")
    server, port = _serve(mod, registry, obs)
    try:
        yield registry, obs, port
    finally:
        server.shutdown()
        registry.shutdown()
        obs["profile"].close()


def _jax_fields(path, cls, message):
    """The keyword fields the JAX source passes to ``cls(message, ...)``."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == cls and node.args
                and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            text = (node.args[0].value if isinstance(node.args[0],
                                                     ast.Constant)
                    else "".join(v.value for v in node.args[0].values
                                 if isinstance(v, ast.Constant)))
            if text.startswith(message):
                return {k.arg for k in node.keywords}
    raise AssertionError(f"{cls}({message!r}, ...) not in {path}")


def _keyed_as_jax(jax_errors, code, body, fields):
    """``body`` (an HTTP error reply) is what the JAX package's
    ``error_response`` makes of the same error: status and keys."""
    cls = getattr(jax_errors, body["error"])
    details = {k: v for k, v in body.items() if k not in ("error",
                                                          "message")}
    status, payload = jax_errors.error_response(cls(body["message"],
                                                    **details))
    assert (status, payload) == (code, body)
    assert set(details) == fields, (set(details), fields)


def test_torch_self_test_in_process_hot_swap_zero_failures(mod, app,
                                                           capsys):
    """The app's own --self-test, in process: 8 concurrent clients, a
    hot swap mid-traffic, zero failed requests, both versions observed,
    one replica a core, /metrics coherent, a traced request covering its
    span wall, greedy and sampled /generate replays, the Prometheus
    exposition round-tripping."""
    registry, obs, port = app
    mod.self_test(port, device="cpu")
    out = capsys.readouterr().out
    assert "0 failed, versions seen [1, 2] OK" in out
    m = registry.metrics()
    assert m[mod.DEFAULT_MODEL]["serving"]["replicas"] == \
        max(1, os.cpu_count() or 1)
    assert m[mod.LM_MODEL]["serving"]["replicas"] == 1


def test_torch_main_self_test_prints_the_contract(mod, capsys):
    """``main(["--self-test", "--device", "cpu"])``: the JAX app's test
    strings."""
    mod.main(["--self-test", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "hot-swap v1->v2 mid-traffic" in out
    assert "0 failed" in out
    assert "serving on http://127.0.0.1:" in out


def test_torch_structured_error_surface(mod, jax_errors):
    import torch
    from analytics_zoo_tpu_torch.serving import ModelRegistry

    registry = ModelRegistry(max_queue=2, max_concurrency=1, device="cpu")
    registry.deploy(mod.DEFAULT_MODEL, mod.build_net(device="cpu"),
                    warmup_shapes=(mod.N_FEATURES,))
    gate = threading.Event()

    def slow(p, x):  # holds its slot until the test opens the gate
        gate.wait(20)
        return x @ p["w"]

    registry.deploy("slow", fn=slow,
                    params={"w": torch.ones(mod.N_FEATURES, 2)})
    server, port = _serve(mod, registry)
    x = np.zeros((1, mod.N_FEATURES), np.float32).tolist()
    try:
        # unknown model -> 404 ModelNotFound, structured body
        with pytest.raises(HTTPError) as ei:
            _post(port, "/predict", {"instances": x, "model": "nope"})
        assert ei.value.code == 404
        body = json.loads(ei.value.read())
        assert body["error"] == "ModelNotFound" and body["model"] == "nope"
        _keyed_as_jax(jax_errors, 404, body, _jax_fields(
            "analytics_zoo_tpu/serving/registry.py", "ModelNotFound",
            "no model deployed under"))

        # malformed payload -> 400 with the exception type
        with pytest.raises(HTTPError) as ei:
            _post(port, "/predict", {"wrong_key": x})
        assert ei.value.code == 400
        assert json.loads(ei.value.read())["error"] == "KeyError"

        # promote with no canary staged -> 404
        with pytest.raises(HTTPError) as ei:
            _post(port, "/promote", {"model": mod.DEFAULT_MODEL})
        assert ei.value.code == 404
        _keyed_as_jax(jax_errors, 404, json.loads(ei.value.read()),
                      {"model"})

        # a request that cannot meet its deadline -> 504, shed at
        # admission (the EWMA seeded by a first call exceeds 1 us)
        _post(port, "/predict", {"instances": x})
        with pytest.raises(HTTPError) as ei:
            _post(port, "/predict", {"instances": x, "deadline_ms": 0.001})
        assert ei.value.code == 504
        body = json.loads(ei.value.read())
        assert body["error"] == "DeadlineExceeded" and body["shed"] is True
        _keyed_as_jax(jax_errors, 504, body, _jax_fields(
            "analytics_zoo_tpu/serving/admission.py", "DeadlineExceeded",
            "deadline cannot be met"))

        # a full queue -> 429 Overloaded: one request holds the slot, two
        # wait, the rest are turned away at once
        codes, bodies = [], []

        def client():
            try:
                _post(port, "/predict", {"instances": x, "model": "slow"})
                codes.append(200)
            except HTTPError as e:
                codes.append(e.code)
                bodies.append(json.loads(e.read()))

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
        t0 = time.monotonic()
        while len(codes) < 3 and time.monotonic() - t0 < 20:
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(30)
        assert sorted(codes) == [200, 200, 200, 429, 429, 429], codes
        fields = _jax_fields("analytics_zoo_tpu/serving/admission.py",
                             "Overloaded", "admission queue full")
        for body in bodies:
            assert body["error"] == "Overloaded"
            assert body["max_queue"] == 2
            _keyed_as_jax(jax_errors, 429, body, fields)
    finally:
        gate.set()
        server.shutdown()
        registry.shutdown()


def test_torch_deploy_and_canary_over_http(mod, app):
    registry, obs, port = app
    x = np.zeros((2, mod.N_FEATURES), np.float32).tolist()
    out = _post(port, "/predict", {"instances": x})
    assert out["version"] == 1
    # stage a canary at 50%, then promote it
    dep = _post(port, "/deploy", {"model": mod.DEFAULT_MODEL, "seed": 3,
                                  "canary_fraction": 0.5})
    assert dep["version"] == 2
    versions = {_post(port, "/predict", {"instances": x})["version"]
                for _ in range(8)}
    assert versions == {1, 2}
    prom = _post(port, "/promote", {"model": mod.DEFAULT_MODEL})
    assert prom["version"] == 2
    assert _post(port, "/predict", {"instances": x})["version"] == 2
    m = _get(port, "/metrics")[mod.DEFAULT_MODEL]
    assert m["active_version"] == 2
    assert m["swap_count"] == 1


def test_torch_observability_surface_over_http(mod, app):
    """X-Request-Id response header, /traces ring buffer + by-id lookup,
    and the Prometheus exposition round-tripping with model/version/
    bucket labels."""
    from analytics_zoo_tpu_torch.observability import parse_prometheus_text
    registry, obs, port = app
    x = np.zeros((3, mod.N_FEATURES), np.float32).tolist()
    req = Request(f"http://127.0.0.1:{port}/predict",
                  data=json.dumps({"instances": x}).encode(),
                  headers={"Content-Type": "application/json",
                           "X-Request-Id": "req-test-0001"})
    with urlopen(req, timeout=30) as resp:
        assert resp.headers["X-Request-Id"] == "req-test-0001"
        out = json.loads(resp.read())
    assert out["request_id"] == "req-test-0001"

    tr = _get(port, "/traces?id=req-test-0001")
    names = [p["name"] for p in tr["phases"]]
    assert names[0] == "admission_queue"
    assert {"pad", "device_put", "execute", "depad"} <= set(names)
    assert all(p["dur_ms"] is not None for p in tr["phases"])
    # replicas="all": the span records which replica (one a core on the
    # CPU) executed the dispatch
    labels = dict(tr["labels"])
    replica = labels.pop("replica")
    assert 0 <= replica < max(1, os.cpu_count() or 1)
    assert labels == {"model": mod.DEFAULT_MODEL, "version": 1,
                      "bucket": 4}

    ring = _get(port, "/traces")
    assert ring["span_count"] >= 1
    assert any(t["trace_id"] == "req-test-0001" for t in ring["traces"])
    assert "execute" in ring["phase_stats"]

    with pytest.raises(HTTPError) as ei:  # unknown id -> structured 404
        _get(port, "/traces?id=nope")
    assert ei.value.code == 404
    with pytest.raises(HTTPError) as ei:  # malformed query -> 400
        _get(port, "/traces?n=abc")
    assert ei.value.code == 400
    assert json.loads(ei.value.read())["error"] == "ValueError"
    with pytest.raises(HTTPError) as ei:
        _get(port, "/nowhere")
    assert ei.value.code == 404

    with urlopen(f"http://127.0.0.1:{port}/metrics?format=prometheus",
                 timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        parsed = parse_prometheus_text(r.read().decode())
    samples = parsed["samples"]
    assert samples[("zoo_model_requests_total",
                    (("model", mod.DEFAULT_MODEL), ("version", "1")))] >= 1
    assert any(dict(k[1]).get("bucket") for k in samples
               if k[0] in ("zoo_bucket_hits_total",
                           "zoo_bucket_misses_total"))
    assert parsed["types"]["zoo_live_buffers"] == "gauge"
    assert _get(port, "/health") == {"status": "ok"}


def test_torch_predict_matches_jax_classifier(mod, jax_app):
    """/predict on the port's classifier carrying the JAX app's
    classifier's weights (``models/jax_params``) within 1e-6 of the JAX
    net's own predict."""
    from analytics_zoo_tpu.core.module import name_scope as j_name_scope
    from analytics_zoo_tpu_torch.core.module import name_scope
    from analytics_zoo_tpu_torch.models import from_jax_params
    from analytics_zoo_tpu_torch.serving import ModelRegistry
    # both built in one name scope, so the layers' names match whatever
    # models this process built before (the JAX tree is keyed and sorted
    # by name: "dense_10" before "dense_9")
    with j_name_scope("web"):
        jnet = jax_app.build_net(hidden=24, seed=5)
    jnet.trainer.ensure_initialized()
    with name_scope("web"):
        tnet = mod.build_net(hidden=24, seed=0, device="cpu")
    from_jax_params(tnet, jnet.get_weights())
    x = np.random.default_rng(0).normal(
        size=(13, mod.N_FEATURES)).astype(np.float32)
    want = np.asarray(jnet.predict(x))
    registry = ModelRegistry(coalescing=True, device="cpu")
    registry.deploy(mod.DEFAULT_MODEL, tnet,
                    warmup_shapes=(mod.N_FEATURES,))
    server, port = _serve(mod, registry)
    try:
        got = np.asarray(_post(port, "/predict",
                               {"instances": x.tolist()})["predictions"])
    finally:
        server.shutdown()
        registry.shutdown()
    assert got.shape == want.shape == (13, mod.N_CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_torch_generate_matches_jax_lm(mod):
    """Greedy /generate on the app's miniature LM carrying a JAX
    ``TransformerLM``'s weights equals the JAX ``generate``, token for
    token (weights perturbed from the seeded init and a sharp head, so
    that no greedy pick is an f32 tie)."""
    import jax
    from analytics_zoo_tpu.models import TransformerLM as JaxLM
    from analytics_zoo_tpu_torch.models import from_jax_params
    from analytics_zoo_tpu_torch.serving import ModelRegistry
    jm = JaxLM(**mod.LM_CONFIG)
    params = jax.device_get(jm.ensure_inference_ready().state.params)
    rng = np.random.default_rng(1)
    tree = {layer: {key: ((np.asarray(a) + rng.normal(0, 0.1, a.shape))
                          * (5 if (layer, key) == ("lm_head", "W") else 1)
                          ).astype(np.float32)
                    for key, a in leaves.items()}
            for layer, leaves in params.items()}
    jm.set_weights(tree)
    tm = mod.build_lm(device="cpu")
    from_jax_params(tm, tree)
    registry = ModelRegistry(device="cpu")
    registry.deploy(mod.LM_MODEL, tm, **mod.LM_DECODE, replicas=1)
    server, port = _serve(mod, registry)
    cases = [(rng.integers(0, mod.LM_VOCAB, int(n)), int(m))
             for n, m in ((1, 12), (5, 6), (8, 16), (3, 21))]
    try:
        got = [_post(port, "/generate", {"prompt": p.tolist(),
                                         "max_new_tokens": m})
               for p, m in cases]
    finally:
        server.shutdown()
        registry.shutdown()
    for (p, m), out in zip(cases, got):
        want = np.asarray(jm.generate(p[None].astype(np.int32),
                                      max_new_tokens=m))[0, len(p):]
        assert out["model"] == mod.LM_MODEL
        assert out["tokens"] == [want.tolist()], (p, m)
