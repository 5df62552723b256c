"""The port's serving control plane held against the JAX package's.

The JAX package's ``serving`` modules do not import in the test process
(``pipeline/inference/serving.py`` and ``serving/shardgroup.py`` import
``jax.lib.xla_client``, which the installed jax moved), so the JAX side
of every case runs once, in ONE subprocess for this file, with the shim
``jax.lib.xla_client = jaxlib.xla_client``; a module-scoped fixture
collects its results (JSON and an npz).  The shim is never set in the
pytest process.

The scenarios that read only the control plane's pure-Python surface
(errors, canary routing, autoscaler decisions, admission families) are
one source text run against either package's ``serving`` module.  The
registry predict (a Dense/Embedding net, weights carried across through
``jax_params``) is held within 1e-6; the registry's greedy generate of a
small TransformerLM must give equal token streams.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-6

# One source for both packages: every function takes the package's
# ``serving`` module ``S`` and returns plain JSON data.
SCENARIOS = textwrap.dedent('''
    import threading
    import time

    import numpy as np

    def run_errors(S):
        out = {}
        cases = [
            ("ServingError", S.ServingError("boom", a=1)),
            ("ModelNotFound", S.ModelNotFound(
                "no model deployed under 'x'", model="x",
                deployed=["a", "b"])),
            ("Overloaded", S.Overloaded(
                "admission queue full", queue_depth=3, max_queue=3,
                priority_class="default")),
            ("DeadlineExceeded", S.DeadlineExceeded(
                "deadline cannot be met", shed=True, predicted_ms=2.5,
                deadline_ms=1.0)),
            ("ColdStartTimeout", S.ColdStartTimeout(
                "cold", model="m", state="faulting", waited_ms=4.0)),
            ("DeployError", S.DeployError(
                "deploy failed", model="m", version=2,
                active_version=1, stage="warmup",
                cause="RuntimeError: x")),
        ]
        from importlib import import_module
        errors = import_module(S.__name__ + ".errors")
        cases.append(("WorkerUnavailable",
                      errors.WorkerUnavailable("down", workers=0)))
        for name, exc in cases:
            status, payload = S.error_response(exc)
            out[name] = {"to_dict": exc.to_dict(), "status": status,
                         "payload": payload, "code": exc.code,
                         "str": str(exc)}
        status, payload = S.error_response(ValueError("bad input"))
        out["ValueError"] = {"status": status, "payload": payload}
        return out

    class Const:
        """A duck-typed serving handle answering with one constant."""

        def __init__(self, c):
            self.c = float(c)

        def predict(self, x):
            return np.full(np.asarray(x).shape, self.c, np.float32)

        def close(self):
            pass

        def serving_stats(self):
            return {}

    def run_canary(S):
        out = {}
        for frac in (0.1, 0.25, 0.5):
            reg = S.ModelRegistry()
            try:
                reg.deploy("m", model=Const(1.0))
                reg.deploy("m", model=Const(2.0), canary_fraction=frac)
                x = np.zeros((1, 2), np.float32)
                flags = []
                for _ in range(40):
                    val, info = reg.predict_ex("m", x)
                    flags.append([bool(info["canary"]),
                                  float(val[0, 0])])
                out[str(frac)] = {
                    "flags": flags,
                    "canary": reg.metrics("m")["m"]["canary"]}
            finally:
                reg.shutdown()
        return out

    def run_autoscale(S):
        state = {"depth": 0.0, "clock": 0.0, "applied": [],
                 "fail": False}

        def get_signals():
            return {"queue_depth": state["depth"], "ewma_ms": 2.0,
                    "active": None, "running": 1,
                    "max_concurrency": 4}

        def apply_scale(n):
            state["applied"].append(n)
            if state["fail"]:
                raise RuntimeError("injected scale failure")

        sc = S.Autoscaler(get_signals, apply_scale, min_replicas=1,
                          max_replicas=4, initial_replicas=1,
                          up_queue_depth=8, down_queue_depth=1,
                          up_latency_ms=50.0, hold_ticks=2,
                          cooldown_s=10.0, clock=lambda: state["clock"],
                          name="m")
        script = ([20] * 3 + [0, 20] * 3 + [20] * 4 + [0] * 6
                  + [5] * 3 + [30] * 5 + [0] * 8)
        ticks = []
        for i, depth in enumerate(script):
            state["depth"] = float(depth)
            state["clock"] += 3.0
            state["fail"] = i in (14, 15)
            ev = sc.tick()
            ticks.append(None if ev is None else dict(ev))
        fams = [[f.mtype, f.name, sorted(
            [sorted(dict(lbl).items()), v] for lbl, v in f.samples)]
            for f in sc.families()]
        return {"ticks": ticks, "applied": state["applied"],
                "events": sc.events(), "snapshot": sc.snapshot(),
                "families": fams}

    def _wait_until(pred, timeout=10.0):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if pred():
                return True
            time.sleep(0.002)
        return False

    def run_admission(S):
        ac = S.AdmissionController(max_queue=2, max_concurrency=1,
                                   classes={"gold": (10, 0.9),
                                            "batch": (0, 0.1)})
        outcomes = []
        for cls in ("gold", "batch", None, "batch"):
            with ac.admit(priority_class=cls):
                pass
        # hold the slot, fill the queue with batch, then overflow it
        gate, started = threading.Event(), threading.Event()
        errs = []

        def hold():
            with ac.admit(priority_class="batch"):
                started.set()
                gate.wait(timeout=30)

        def wait_batch():
            try:
                with ac.admit(priority_class="batch"):
                    pass
            except Exception as e:  # noqa: BLE001 — recorded
                errs.append(type(e).__name__)

        holder = threading.Thread(target=hold)
        holder.start()
        started.wait(timeout=30)
        waiters = [threading.Thread(target=wait_batch) for _ in range(2)]
        for t in waiters:
            t.start()
        _wait_until(lambda: ac.snapshot()["queue_depth"] == 2)
        try:
            with ac.admit(priority_class="batch"):
                pass
        except Exception as e:  # noqa: BLE001 — recorded
            outcomes.append(["batch_overflow", type(e).__name__,
                             sorted(e.to_dict())])
        # a gold arrival evicts the newest batch waiter
        gold_done = []

        def gold():
            with ac.admit(priority_class="gold"):
                gold_done.append(True)

        g = threading.Thread(target=gold)
        g.start()
        _wait_until(lambda: len(errs) == 1)
        gate.set()
        for t in [holder, g] + waiters:
            t.join(timeout=30)
        outcomes.append(["evicted", sorted(errs), len(gold_done)])
        # deadline shedding from the service EWMA
        with ac.admit():
            time.sleep(0.05)
        try:
            with ac.admit(deadline_ms=1.0):
                pass
        except Exception as e:  # noqa: BLE001 — recorded
            outcomes.append(["deadline", type(e).__name__,
                             e.to_dict()["shed"]])
        ac.drain(timeout=5.0)
        try:
            with ac.admit():
                pass
        except Exception as e:  # noqa: BLE001 — recorded
            outcomes.append(["draining", type(e).__name__,
                             e.to_dict()["draining"]])
        snap = ac.snapshot()
        snapshot = {"m": {"active_version": 1, "swap_count": 0,
                          "canary_fraction": 0.0, "admission": snap,
                          "versions": {}, "serving": {}}}
        fams = []
        for f in S.registry_families(snapshot):
            samples = sorted(
                [sorted(dict(lbl).items()),
                 v if f.mtype == "counter" else None]
                for lbl, v in f.samples)
            fams.append([f.mtype, f.name, samples])
        counters = {k: v for k, v in snap.items()
                    if isinstance(v, int) and not isinstance(v, bool)}
        return {"outcomes": outcomes, "families": sorted(fams),
                "counters": counters}
''')

VOCAB, SEQ, BUCKET = 64, 48, 16
LM_CFG = dict(vocab_size=VOCAB, seq_len=SEQ, n_layers=2, d_model=32,
              n_heads=2)
PROMPT_LENS = (5, 9, 14)
MAX_NEW = (6, 4, 7)
NET_T, NET_VOCAB = 6, 20

JAX_SIDE = textwrap.dedent('''
    import json, sys
    import jax, jax.lib
    from jaxlib import xla_client
    jax.lib.xla_client = xla_client  # the installed jax moved it
    import numpy as np
    import analytics_zoo_tpu.serving as S
    from analytics_zoo_tpu.core.module import name_scope
    from analytics_zoo_tpu.models import TransformerLM
    from analytics_zoo_tpu.pipeline.api.keras import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        Dense, Embedding, Flatten)

    exec(open(sys.argv[1]).read())
    cfg = json.loads(sys.argv[2])
    out = {"errors": run_errors(S), "canary": run_canary(S),
           "autoscale": run_autoscale(S), "admission": run_admission(S)}
    arrays = {}

    # registry predict of a Dense/Embedding net
    with name_scope("x"):
        net = Sequential()
        net.add(Embedding(cfg["net_vocab"], 8,
                          input_shape=(cfg["net_t"],)))
        net.add(Flatten())
        net.add(Dense(16, activation="relu"))
        net.add(Dense(5, activation="softmax"))
    for layer, leaves in net.get_weights().items():
        for key, a in leaves.items():
            arrays[f"net::{layer}::{key}"] = np.asarray(a)
    x = np.random.default_rng(7).integers(
        0, cfg["net_vocab"], (7, cfg["net_t"])).astype(np.int32)
    reg = S.ModelRegistry()
    try:
        reg.deploy("net", net, warmup_shapes=(cfg["net_t"],),
                   warmup_dtypes=np.int32)
        y, info = reg.predict_ex("net", x)
    finally:
        reg.shutdown()
    arrays["net_x"], arrays["net_y"] = x, np.asarray(y)
    out["net_info"] = info

    # registry greedy generate of a small TransformerLM
    lm = TransformerLM(**cfg["lm"])
    params = jax.device_get(lm.ensure_inference_ready().state.params)
    rng = np.random.default_rng(3)
    tree = {layer: {key: ((np.asarray(a) + rng.normal(0, 0.1, a.shape))
                          * (5 if (layer, key) == ("lm_head", "W") else 1)
                          ).astype(np.float32)
                    for key, a in leaves.items()}
            for layer, leaves in params.items()}
    lm.set_weights(tree)
    for layer, leaves in tree.items():
        for key, a in leaves.items():
            arrays[f"lm::{layer}::{key}"] = a
    prompts = [rng.integers(0, cfg["lm"]["vocab_size"], n)
               for n in cfg["prompt_lens"]]
    reg = S.ModelRegistry()
    try:
        reg.deploy("lm", lm, decode_capacity=2,
                   decode_max_len=cfg["lm"]["seq_len"],
                   decode_prompt_buckets=(cfg["bucket"],))
        streams, infos = [], []
        for p, n in zip(prompts, cfg["max_new"]):
            o, info = reg.generate_ex("lm", [p], n)
            streams.append(np.asarray(o[0]).tolist())
            infos.append(info)
    finally:
        reg.shutdown()
    out["prompts"] = [p.tolist() for p in prompts]
    out["streams"], out["lm_infos"] = streams, infos
    np.savez(sys.argv[3], **arrays)
    print("RESULT " + json.dumps(out, default=str))
''')


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Every case's JAX-package result, from one shimmed subprocess."""
    d = tmp_path_factory.mktemp("serving_parity")
    (d / "scenarios.py").write_text(SCENARIOS)
    (d / "jax_side.py").write_text(JAX_SIDE)
    cfg = {"lm": LM_CFG, "bucket": BUCKET, "prompt_lens": PROMPT_LENS,
           "max_new": MAX_NEW, "net_t": NET_T, "net_vocab": NET_VOCAB}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(d / "jax_side.py"), str(d / "scenarios.py"),
         json.dumps(cfg), str(d / "arrays.npz")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")]
    assert line, proc.stdout[-2000:] + proc.stderr[-4000:]
    out = json.loads(line[0][len("RESULT "):])
    with np.load(d / "arrays.npz") as z:
        out["arrays"] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def port():
    """The same scenarios against the port's serving module."""
    import analytics_zoo_tpu_torch.serving as S
    ns = {}
    exec(SCENARIOS, ns)
    return ns, S


def _json(data):
    """As the JAX side's results came back: through JSON."""
    return json.loads(json.dumps(data, default=str))


def test_errors_to_dict_and_error_response_equal(jax_side, port):
    ns, S = port
    assert _json(ns["run_errors"](S)) == jax_side["errors"]


def test_canary_routing_sequences_equal(jax_side, port):
    ns, S = port
    got = _json(ns["run_canary"](S))
    assert got == jax_side["canary"]
    for frac, case in got.items():
        # the error accumulator gives 40 * fraction give or take one (ten
        # float additions of 0.1 sum to just under 1.0, in both packages)
        hits = sum(1 for canary, _ in case["flags"] if canary)
        assert abs(hits - 40 * float(frac)) <= 1, (frac, hits)
    assert sum(c for c, _ in got["0.25"]["flags"]) == 10


def test_autoscaler_decisions_equal(jax_side, port):
    ns, S = port
    got = _json(ns["run_autoscale"](S))
    assert got == jax_side["autoscale"]
    assert any(t is not None for t in got["ticks"])
    assert got["snapshot"]["apply_errors"] >= 1


def test_admission_families_equal(jax_side, port):
    ns, S = port
    got = _json(ns["run_admission"](S))
    assert got["outcomes"] == jax_side["admission"]["outcomes"]
    assert got["counters"] == jax_side["admission"]["counters"]
    assert got["families"] == jax_side["admission"]["families"]
    names = {f[1] for f in got["families"]}
    assert {"zoo_shed_total", "zoo_admission_shed_overload_total",
            "zoo_admission_queue_high_water"} <= names


def _tree(arrays, prefix):
    tree = {}
    for k, a in arrays.items():
        if k.startswith(prefix + "::"):
            _, layer, key = k.split("::")
            tree.setdefault(layer, {})[key] = a
    return tree


def test_registry_predict_matches_jax(jax_side):
    from analytics_zoo_tpu_torch.core.module import name_scope
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, Embedding, Flatten)
    from analytics_zoo_tpu_torch.serving import ModelRegistry

    arrays = jax_side["arrays"]
    with name_scope("x"):
        net = Sequential(device="cpu")
        net.add(Embedding(NET_VOCAB, 8, input_shape=(NET_T,)))
        net.add(Flatten())
        net.add(Dense(16, activation="relu"))
        net.add(Dense(5, activation="softmax"))
    net.set_weights(_tree(arrays, "net"))
    reg = ModelRegistry(device="cpu")
    try:
        reg.deploy("net", net, warmup_shapes=(NET_T,),
                   warmup_dtypes=np.int32)
        y, info = reg.predict_ex("net", arrays["net_x"])
    finally:
        reg.shutdown()
    assert info == jax_side["net_info"]
    np.testing.assert_allclose(y, arrays["net_y"], rtol=0, atol=TOL)


def test_registry_greedy_generate_matches_jax(jax_side):
    from analytics_zoo_tpu_torch.models import TransformerLM, from_jax_params
    from analytics_zoo_tpu_torch.serving import ModelRegistry

    lm = TransformerLM(**LM_CFG, device="cpu")
    from_jax_params(lm, _tree(jax_side["arrays"], "lm"))
    lm.eval()
    reg = ModelRegistry(device="cpu")
    try:
        reg.deploy("lm", lm, decode_capacity=2, decode_max_len=SEQ,
                   decode_prompt_buckets=(BUCKET,))
        for p, n, want, want_info in zip(
                jax_side["prompts"], MAX_NEW, jax_side["streams"],
                jax_side["lm_infos"]):
            out, info = reg.generate_ex("lm", [np.asarray(p)], n)
            assert np.asarray(out[0]).tolist() == want
            assert _json(info) == want_info
    finally:
        reg.shutdown()
