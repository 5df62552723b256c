"""Web-service sample on the PyTorch/CUDA port: the serving CONTROL
PLANE behind an HTTP endpoint.

The port of ``web_service.py`` beside it, with the same endpoints,
bodies, error codes, headers and ``--self-test``.  The role is played by
``ModelRegistry`` (analytics_zoo_tpu_torch.serving): named + versioned
models, zero-downtime hot-swap, per-model admission control with
deadline-aware load shedding, and full observability (per-request
tracing, Prometheus metrics, and the compile-like events of the port:
kernel builds and CUDA-graph captures).  Models live on ``--device``
(default ``cuda``; ``--device cpu`` runs without a card).

POST /predict {"instances": [[...], ...],              -> {"predictions": [...],
               "model": "default",       # optional        "model": ..., "version": ...,
               "deadline_ms": 250,       # optional        "request_id": ...}
               "class": "interactive"}   # optional priority class
POST /generate {"prompt": [ids] | [[ids], ...],        -> {"tokens": [[...], ...],
                "max_new_tokens": 8,                       "model": ..., "version": ...,
                "model": "lm",           # optional        "request_id": ...}
                "temperature": 0.8,      # optional, default 0 = greedy
                "top_k": 20,             # optional truncation
                "top_p": 0.95,           # optional nucleus truncation
                "seed": 7}               # replay seed, default 0
               # continuous-batching decode: requests share the slot
               # array per decode step (see docs/serving.md).  A fixed
               # (prompt, sampling, seed) replays the same tokens at
               # any occupancy; bad sampling values are a 400 with the
               # engine's ValueError message
POST /deploy  {"model": "default", "seed": 1,          -> {"model": ..., "version": v}
               "hidden": 16, "canary_fraction": 0.2}   # canary optional
POST /promote {"model": "default"}                     -> {"version": v}
GET  /metrics                                          -> registry.metrics() (JSON)
GET  /metrics?format=prometheus                        -> text exposition 0.0.4
GET  /traces                                           -> recent trace ring buffer
GET  /traces?id=<request_id>                           -> one trace (404 if aged out)
GET  /health                                           -> {"status": "ok"}

Every /predict response carries an ``X-Request-Id`` header (client's
own header is honored, else generated) matching the trace id in
``GET /traces`` — latency questions resolve to per-phase spans
(admission_queue/coalesce_wait/pad/device_put/execute/depad), not
guesswork.

Overload/miss surface: 429 Overloaded (queue full / draining),
504 DeadlineExceeded (shed or lapsed), 404 ModelNotFound — all with a
structured JSON body {"error": <code>, "message": ..., ...fields}.

Run standalone:  python web_service_torch.py --port 8900 [--device cpu]
(then:  curl -d '{"instances": [[0.1, ...]]}' localhost:8900/predict)
With --self-test the app starts the server, fires concurrent client
traffic, HOT-SWAPS the model mid-traffic (zero failed requests, every
response tagged with exactly one version), checks /metrics (JSON and
Prometheus, round-tripped through the stdlib parser), verifies a
traced request's phases sum to its span wall time, and exits.
"""

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

DEFAULT_MODEL = "default"
LM_MODEL = "lm"
LM_VOCAB = 32
LM_SEQ = 24
N_FEATURES = 8
N_CLASSES = 3
TRACE_RING = 512


#: the miniature LM behind /generate and its continuous-batching plan;
#: ``build_registry(lm_config=..., lm_decode=...)`` serves another
LM_CONFIG = dict(vocab_size=LM_VOCAB, seq_len=LM_SEQ, n_layers=1,
                 d_model=16, n_heads=2)
LM_DECODE = dict(decode_capacity=2, decode_prompt_buckets=(8,))


def build_net(hidden: int = 16, seed: int = 0, device=None):
    """A small classifier (stand-in for a loaded zoo model; reference
    services load a pretrained BigDL/TF model).  ``seed`` varies the
    weights so a redeploy is an observably different version."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    net = Sequential(device=device, seed=seed)
    net.add(Dense(hidden, activation="relu", input_shape=(N_FEATURES,)))
    net.add(Dense(N_CLASSES, activation="softmax"))
    return net


def build_lm(config=None, device=None, seed: int = 0):
    """The TransformerLM for the continuous-batching generate path: by
    default a miniature (``LM_CONFIG``, a stand-in for a real chat
    model); ``config`` gives another's widths.  Random-initialized from
    ``seed`` — the sample demonstrates the SERVING mechanics (slot
    admission, streaming, per-token metrics), not language quality."""
    from analytics_zoo_tpu_torch.models import TransformerLM

    return TransformerLM(**(config or LM_CONFIG), device=device,
                         seed=seed).eval()


def build_registry(pager_resident=None, device=None, lm_config=None,
                   lm_decode=None):
    """The control plane + observability: one registry with a tracer,
    a Prometheus-exposable metrics registry fed by the control plane /
    tracer / compile hooks, and the default model deployed and warmed
    before the server accepts traffic.  Returns (registry, obs) where
    ``obs`` = {"tracer", "metrics", "profile"}.  Every model lives on
    ``device`` (default ``cuda``).

    ``lm_config`` (TransformerLM keyword arguments) and ``lm_decode``
    (the decode engine's ``decode_*`` arguments) size the LM behind
    /generate; by default the miniature on ``LM_DECODE``.

    ``pager_resident`` (or ``ZOO_PAGER_RESIDENT``) turns on the weight
    pager with that resident-model budget: deployments beyond it page
    out to host memory and fault back in on first request
    (``zoo_model_resident`` / ``zoo_pager_*`` land in the scrape) — the
    serving-density recipe, one flag."""
    from analytics_zoo_tpu_torch.observability import (MetricsRegistry,
                                                       Tracer, profile)
    from analytics_zoo_tpu_torch.serving import (ModelRegistry,
                                                 registry_collector)

    if pager_resident is None:
        env = os.environ.get("ZOO_PAGER_RESIDENT")
        try:
            pager_resident = int(env) if env else None
        except ValueError:
            # same degradation as the fleet worker: a typo'd env var
            # starts the server unpaged, it does not kill it
            print(f"ignoring malformed ZOO_PAGER_RESIDENT={env!r}",
                  flush=True)
            pager_resident = None
    pager = (None if pager_resident is None
             else {"max_resident": int(pager_resident)})
    tracer = Tracer(capacity=TRACE_RING)
    # replicas="all": every device of the platform serves — each card of
    # the process (on the CPU one replica a core) holds the params and
    # the coalescer schedules groups across them
    # two admission tenants: interactive traffic outlives batch under
    # overload (higher priority -> shed last) and owns 90% of freed
    # slots (fair-share weight); requests opt in via {"class": ...}
    registry = ModelRegistry(max_queue=64, max_concurrency=4,
                             supported_concurrent_num=4,
                             max_batch_size=32, coalescing=True,
                             replicas="all",
                             priority_classes={
                                 "interactive": (10, 0.9),
                                 "batch": (0, 0.1)},
                             tracer=tracer, pager=pager, device=device)
    metrics = MetricsRegistry()
    metrics.register_collector(registry_collector(registry))
    metrics.register_collector(tracer.families)
    # kernel builds and decode-graph captures count as compiles
    prof = profile.install()
    metrics.register_collector(prof.families)
    # persistent kernel-library store (enabled via ZOO_EXECSTORE_DIR):
    # zoo_execstore_{hit,miss,write,invalid,evicted}_total land in the
    # same scrape, so a fleet dashboard can watch cold starts turn
    # into disk loads
    from analytics_zoo_tpu_torch.serving import execstore
    store = execstore.current()
    if store is not None:
        metrics.register_collector(store.families)
    registry.deploy(DEFAULT_MODEL, build_net(device=device),
                    warmup_shapes=(N_FEATURES,))
    # the LM behind /generate: a continuous-batching DecodeEngine
    # (decode_capacity slots) — no predict-ladder warmup (that path is
    # unused for an LM; the engine warms its own admit/step plans at
    # load, so the first stream builds nothing).  One replica: the
    # decode state is stateful.
    registry.deploy(LM_MODEL, build_lm(lm_config, device=device),
                    **(lm_decode or LM_DECODE), replicas=1)
    return registry, {"tracer": tracer, "metrics": metrics,
                      "profile": prof}


def make_handler(registry, obs=None, device=None):
    """The HTTP handler class over ``registry``; a /deploy builds its
    net on ``device`` (default ``cuda``)."""
    from analytics_zoo_tpu_torch.serving import error_response

    tracer = (obs or {}).get("tracer")
    metrics = (obs or {}).get("metrics")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code, payload, headers=None):
            body = json.dumps(payload).encode()
            self._reply_raw(code, body, "application/json", headers)

        def _reply_raw(self, code, body, content_type, headers=None):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            try:
                self._do_get()
            except Exception as e:  # same structured surface as POST
                self._reply(*error_response(e))

        def _do_get(self):
            url = urlparse(self.path)
            query = parse_qs(url.query)
            if url.path == "/health":
                self._reply(200, {"status": "ok"})
            elif url.path == "/metrics":
                fmt = (query.get("format") or ["json"])[0]
                if fmt == "prometheus":
                    if metrics is None:
                        self._reply(404, {
                            "error": "prometheus exposition not wired"})
                        return
                    self._reply_raw(
                        200, metrics.render_prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._reply(200, registry.metrics())
            elif url.path == "/traces":
                if tracer is None:
                    self._reply(404, {"error": "tracing not wired"})
                    return
                trace_id = (query.get("id") or [None])[0]
                if trace_id is not None:
                    found = tracer.find(trace_id)
                    if found is None:
                        self._reply(404, {
                            "error": "trace not found (aged out of the "
                                     "ring buffer?)", "id": trace_id})
                    else:
                        self._reply(200, found)
                else:
                    n = int((query.get("n") or [50])[0])
                    self._reply(200, {
                        "traces": tracer.recent(n),
                        "phase_stats": tracer.phase_stats(),
                        "span_count": tracer.span_count})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                payload = self._body()
                if self.path == "/predict":
                    # prefix+counter, not uuid4 — a fresh uuid costs
                    # ~40us, material per request (PERF_NOTES §PR 4)
                    from analytics_zoo_tpu_torch.observability.trace \
                        import new_trace_id
                    rid = (self.headers.get("X-Request-Id")
                           or new_trace_id())
                    x = np.asarray(payload["instances"], dtype=np.float32)
                    preds, info = registry.predict_ex(
                        payload.get("model", DEFAULT_MODEL), x,
                        deadline_ms=payload.get("deadline_ms"),
                        trace_id=rid,
                        priority_class=payload.get("class"))
                    self._reply(200, {
                        "predictions": np.asarray(preds).tolist(), **info},
                        headers={"X-Request-Id": rid})
                elif self.path == "/generate":
                    from analytics_zoo_tpu_torch.observability.trace \
                        import new_trace_id
                    rid = (self.headers.get("X-Request-Id")
                           or new_trace_id())
                    prompt = np.asarray(payload["prompt"], dtype=np.int32)
                    if prompt.ndim == 1:
                        prompt = prompt[None, :]
                    # validate sampling BEFORE admission so a bad
                    # request 400s without consuming a slot — the
                    # same check the engine re-runs at submit
                    from analytics_zoo_tpu_torch.pipeline.inference \
                        .decode import DecodeEngine
                    temp, top_k, top_p, seed = \
                        DecodeEngine.validate_sampling(
                            payload.get("temperature", 0.0),
                            payload.get("top_k"),
                            payload.get("top_p"),
                            payload.get("seed", 0))
                    toks, info = registry.generate_ex(
                        payload.get("model", LM_MODEL), prompt,
                        int(payload.get("max_new_tokens", 8)),
                        deadline_ms=payload.get("deadline_ms"),
                        trace_id=rid,
                        priority_class=payload.get("class"),
                        temperature=temp, top_k=top_k, top_p=top_p,
                        seed=seed)
                    self._reply(200, {
                        "tokens": [np.asarray(t).tolist() for t in toks],
                        **info}, headers={"X-Request-Id": rid})
                elif self.path == "/deploy":
                    name = payload.get("model", DEFAULT_MODEL)
                    net = build_net(hidden=int(payload.get("hidden", 16)),
                                    seed=int(payload.get("seed", 0)),
                                    device=device)
                    frac = payload.get("canary_fraction")
                    v = registry.deploy(
                        name, net, warmup_shapes=(N_FEATURES,),
                        canary_fraction=(None if frac is None
                                         else float(frac)))
                    self._reply(200, {"model": name, "version": v})
                elif self.path == "/promote":
                    name = payload.get("model", DEFAULT_MODEL)
                    self._reply(200, {"model": name,
                                      "version": registry.promote(name)})
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as e:  # structured control-plane surface
                self._reply(*error_response(e))

    return Handler


def self_test(port: int, device=None, lm_decode=None):
    """Concurrent clients + a hot-swap mid-traffic: zero failed
    requests, every response tagged with exactly one version, /metrics
    coherent afterwards — then the observability checks: a traced
    request whose phase durations sum to ~its span wall, and the
    Prometheus exposition round-tripped through the stdlib parser.
    ``device`` is the server's (default ``cuda``): the classifier must
    serve on every replica of its platform; ``lm_decode`` the LM's plan
    (default ``LM_DECODE``)."""
    from urllib.request import Request, urlopen

    from analytics_zoo_tpu_torch.observability import parse_prometheus_text

    def call(path, payload=None, return_headers=False):
        if payload is None:
            req = f"http://127.0.0.1:{port}{path}"
        else:
            req = Request(f"http://127.0.0.1:{port}{path}",
                          data=json.dumps(payload).encode(),
                          headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=30) as resp:
            body = resp.read()
            if return_headers:
                return json.loads(body), dict(resp.headers)
        return json.loads(body)

    assert call("/health")["status"] == "ok"

    # payloads drawn up-front: RandomState is not thread-safe
    rs = np.random.RandomState(0)
    payloads = [rs.rand(4, N_FEATURES).tolist() for _ in range(8)]
    n_clients = 8
    results = [[] for _ in range(n_clients)]
    failures = []
    go, stop = threading.Event(), threading.Event()

    def client(i):
        go.wait()
        k = 0
        while not stop.is_set():
            try:
                out = call("/predict",
                           {"instances": payloads[(i + k) % len(payloads)]})
                results[i].append(out)
            except Exception as e:  # noqa: BLE001 — recorded, asserted 0
                failures.append((i, k, repr(e)))
            k += 1

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    go.set()
    try:
        # HOT-SWAP while the clients hammer: deploy a different net as
        # v2.  The deploy blocks through build + full-ladder warmup, so
        # the clients run against v1 that whole time; a short grace
        # afterwards guarantees post-swap traffic too.
        swap = call("/deploy", {"model": DEFAULT_MODEL, "seed": 7,
                                "hidden": 24})
        import time as _time
        _time.sleep(0.5)
    finally:
        # a failed deploy must fail the self-test, not strand the
        # clients looping forever
        stop.set()
        for t in threads:
            t.join()

    assert not failures, f"requests failed across the swap: {failures[:5]}"
    versions = set()
    total = 0
    for outs in results:
        assert outs, "a client never completed a request"
        for out in outs:
            total += 1
            preds = np.asarray(out["predictions"])
            assert preds.shape == (4, N_CLASSES)
            np.testing.assert_allclose(preds.sum(axis=1), 1.0, rtol=1e-4)
            versions.add(out["version"])  # tagged: old xor new, never both
    # traffic must actually straddle the swap: both versions observed
    assert versions == {1, swap["version"]}, versions

    m = call("/metrics")[DEFAULT_MODEL]
    assert m["active_version"] == swap["version"]
    assert m["swap_count"] >= 1
    assert m["admission"]["errors"] == 0
    assert m["admission"]["completed"] >= total
    assert m["serving"]["buckets"], "active version lost its fast path"
    # registry metric satellites: ISO deploy stamp + uptime + canary
    vstats = m["versions"][str(swap["version"])]  # JSON keys: strings
    assert "T" in vstats["deployed_at"], vstats["deployed_at"]
    assert vstats["uptime_s"] >= 0
    assert m["canary_fraction"] == 0.0
    # multi-replica serving: the new version is placed on every device
    # replicas="all" names (each card of the process; on the CPU one
    # replica a core), every replica is healthy, and the swap's traffic
    # spread across them (dispatch counts per replica are exported)
    from analytics_zoo_tpu_torch.pipeline.inference.serving import \
        available_devices
    from analytics_zoo_tpu_torch.common.context import resolve_device
    n_dev = len(available_devices(resolve_device(device)))
    assert m["serving"]["replicas"] == n_dev, m["serving"]["replicas"]
    if n_dev > 1:
        rd = m["serving"]["replica_dispatches"]
        assert len(rd) == n_dev and sum(rd.values()) > 0, rd
        assert not any(m["serving"]["replica_unhealthy"].values()), \
            m["serving"]["replica_unhealthy"]
        # one compile per bucket even though every device serves
        assert all(v == 1 for v in m["serving"]["misses"].values()), \
            m["serving"]["misses"]
        print(f"replica check: {n_dev} replicas, dispatches {rd}, "
              "all healthy, one compile per bucket OK")

    # ---- tracing: one trace per request, phases account for the wall.
    # A big batch (chunked over the bucket ladder) makes device work
    # dominate, so the untraced slack (future wake-up, JSON) stays
    # under 5% of the span wall; quiet retries absorb scheduler noise.
    big = rs.rand(128, N_FEATURES).tolist()
    best = None
    for _ in range(10):
        out, headers = call("/predict", {"instances": big},
                            return_headers=True)
        rid = headers.get("X-Request-Id")
        assert rid and out["request_id"] == rid
        tr = call(f"/traces?id={rid}")
        assert tr["trace_id"] == rid
        phase_names = {p["name"] for p in tr["phases"]}
        assert {"pad", "device_put", "execute", "depad"} <= phase_names, \
            phase_names
        assert tr["labels"]["model"] == DEFAULT_MODEL
        assert tr["labels"]["version"] == swap["version"]
        # The gate: phases must account for the span wall.  Primary
        # bar is the 95% ratio, but the UNTRACED slack is an absolute
        # cost (future wake-up + JSON render, microseconds) — under
        # full-suite scheduler load the best of 10 attempts has
        # landed at 94.99% of a small wall, which is noise, not a
        # coverage hole.  So an attempt whose uncovered gap stays
        # under an absolute 2 ms also qualifies — judged PER ATTEMPT,
        # or a qualifying-by-gap attempt could be shadowed by a
        # higher-coverage/larger-gap one.  A REAL hole (a phase not
        # recorded) leaves device-work milliseconds uncovered on this
        # 128-row request and still fails every attempt.
        if tr["coverage"] >= 0.95 or \
                tr["wall_ms"] - tr["phase_total_ms"] <= 2.0:
            best = tr
            break
        if best is None or tr["coverage"] > best["coverage"]:
            best = tr
    gap_ms = best["wall_ms"] - best["phase_total_ms"]
    assert best["coverage"] >= 0.95 or gap_ms <= 2.0, \
        f"phase durations cover only {best['coverage']:.1%} of the " \
        f"span wall ({best['wall_ms']:.2f} ms, {gap_ms:.2f} ms " \
        f"uncovered): {best['phases']}"
    print(f"trace check: request {best['trace_id']} wall "
          f"{best['wall_ms']:.2f} ms, phases sum "
          f"{best['phase_total_ms']:.2f} ms "
          f"(coverage {best['coverage']:.1%}) OK")

    # ---- continuous-batching generate: the LM model decodes through
    # the slot-array engine — deterministic (greedy), so two identical
    # requests must stream identical tokens, and the request must
    # carry the decode span phases (prefill -> decode_step)
    lm_prompt = [[1, 2, 3, 4, 5]]
    g1, gh = call("/generate", {"prompt": lm_prompt,
                                "max_new_tokens": 6},
                  return_headers=True)
    g2 = call("/generate", {"prompt": lm_prompt, "max_new_tokens": 6})
    assert g1["model"] == LM_MODEL and g1["version"] >= 1
    assert len(g1["tokens"]) == 1 and len(g1["tokens"][0]) == 6, g1
    assert g1["tokens"] == g2["tokens"], (g1, g2)
    gtr = call(f"/traces?id={gh['X-Request-Id']}")
    gphases = {p["name"] for p in gtr["phases"]}
    assert {"prefill", "decode_step"} <= gphases, gphases
    print(f"generate check: {LM_MODEL} streamed "
          f"{len(g1['tokens'][0])} tokens deterministically, decode "
          "span phases present OK")

    # ---- decode engine v2: sampled generation replays bit-identically
    # at a fixed (prompt, sampling params, seed), and bad sampling
    # values are a structured 400, never an admitted request
    sampled_req = {"prompt": lm_prompt, "max_new_tokens": 6,
                   "temperature": 0.9, "top_k": 12, "top_p": 0.95,
                   "seed": 1234}
    sg1 = call("/generate", dict(sampled_req))
    sg2 = call("/generate", dict(sampled_req))
    assert len(sg1["tokens"]) == 1 and len(sg1["tokens"][0]) == 6, sg1
    assert sg1["tokens"] == sg2["tokens"], (sg1, sg2)
    from urllib.error import HTTPError
    for bad in ({"temperature": -1}, {"temperature": "nan"},
                {"top_k": 0}, {"top_p": 1.5}, {"seed": -3}):
        try:
            call("/generate", {"prompt": lm_prompt,
                               "max_new_tokens": 4, **bad})
        except HTTPError as e:
            assert e.code == 400, (bad, e.code)
            body = json.loads(e.read())
            assert body["error"] == "ValueError", body
        else:
            raise AssertionError(
                f"bad sampling payload {bad} was not rejected")
    print("sampled generate check: fixed-seed replay bit-identical, "
          "5 bad sampling payloads rejected 400 OK")

    # ---- Prometheus exposition: scrape + round-trip the parser; the
    # per-model/version/bucket labels must survive.  A class-tagged
    # request FIRST, so the per-class families carry a non-default
    # series in the scrape (same for the /generate calls above — the
    # decode families must carry live series, not zeros).
    call("/predict", {"instances": payloads[0], "class": "batch"})
    with urlopen(f"http://127.0.0.1:{port}/metrics?format=prometheus",
                 timeout=30) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    parsed = parse_prometheus_text(text)  # raises on any bad line
    names = {k[0] for k in parsed["samples"]}
    required = ["zoo_model_requests_total", "zoo_bucket_hits_total",
                "zoo_trace_spans_total", "zoo_xla_compiles_total",
                "zoo_admission_completed_total",
                "zoo_shed_total", "zoo_class_admitted_total"]
    if n_dev > 1:
        # the replica families (active gauge included) only exist on
        # the multi-replica serving path
        required += ["zoo_replica_dispatches_total",
                     "zoo_replica_unhealthy", "zoo_model_replicas",
                     "zoo_model_replicas_active"]
    for name in required:
        assert name in names, f"{name} missing from exposition"
    labeled = [k for k in parsed["samples"]
               if k[0] == "zoo_model_requests_total"]
    assert any(dict(k[1]).get("model") == DEFAULT_MODEL
               and dict(k[1]).get("version") == str(swap["version"])
               for k in labeled), labeled
    admitted = [k for k in parsed["samples"]
                if k[0] == "zoo_class_admitted_total"]
    assert any(dict(k[1]).get("class") == "batch" for k in admitted), \
        admitted
    # the continuous-batching decode families must carry LIVE series
    # tagged with the LM model (the /generate calls above ran before
    # this scrape — the PR 6 scrape-order lesson): tokens/steps moved,
    # capacity reads the deployed slot count, occupancy is back to 0
    # on the now-idle engine
    for fam in ("zoo_decode_tokens_total", "zoo_decode_steps_total",
                "zoo_decode_slot_occupancy", "zoo_decode_slot_capacity"):
        assert fam in names, f"{fam} missing from exposition"
    dec = {k[0]: v for k, v in parsed["samples"].items()
           if k[0].startswith("zoo_decode_")
           and dict(k[1]).get("model") == LM_MODEL}
    assert dec.get("zoo_decode_tokens_total", 0) >= 12, dec
    assert dec.get("zoo_decode_steps_total", 0) > 0, dec
    assert dec.get("zoo_decode_slot_capacity") == \
        (lm_decode or LM_DECODE)["decode_capacity"], dec
    assert dec.get("zoo_decode_slot_occupancy") == 0, dec
    assert parsed["types"]["zoo_decode_tokens_total"] == "counter"
    assert parsed["types"]["zoo_decode_slot_occupancy"] == "gauge"
    print("decode scrape check: live zoo_decode_* series for "
          f"model={LM_MODEL} OK")
    assert parsed["types"]["zoo_model_requests_total"] == "counter"
    print(f"prometheus scrape OK ({len(parsed['samples'])} samples, "
          f"{len(names)} series names)")

    print(f"web-service self-test: {n_clients} concurrent clients, "
          f"hot-swap v1->v{swap['version']} mid-traffic, {total} requests, "
          f"0 failed, versions seen {sorted(versions)} OK")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--self-test", action="store_true")
    ap.add_argument("--pager-resident", type=int, default=None,
                    help="serving-density mode: page deployments "
                         "beyond this resident budget out to host "
                         "memory + the execstore (default: "
                         "$ZOO_PAGER_RESIDENT, else off)")
    ap.add_argument("--device", default="cuda",
                    help="where the models live (cuda, or cpu to run "
                         "without a card)")
    args = ap.parse_args(argv)

    registry, obs = build_registry(pager_resident=args.pager_resident,
                                   device=args.device)
    server = ThreadingHTTPServer(("127.0.0.1", args.port),
                                 make_handler(registry, obs, args.device))
    port = server.server_address[1]
    print(f"serving on http://127.0.0.1:{port} (POST /predict /deploy "
          "/promote, GET /health /metrics[?format=prometheus] /traces)",
          flush=True)
    if args.self_test:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            self_test(port, device=args.device)
        finally:
            server.shutdown()
            registry.shutdown()
            obs["profile"].close()
    else:
        try:
            server.serve_forever()
        finally:
            registry.shutdown()
            obs["profile"].close()


if __name__ == "__main__":
    main()
