"""The port's fleet held against the JAX package's: frames, error
envelopes, artifact directories and an ``mlp`` predict.

The JAX package's fleet does not import in the test process
(``pipeline/inference/serving.py`` imports ``jax.lib.xla_client``,
which the installed jax moved), so the JAX side runs once, in ONE
subprocess for this file, with the shim ``jax.lib.xla_client =
jaxlib.xla_client``; the shim is never set in the pytest process.  The
subprocess

* encodes a table of JSON and binary envelopes and every error class
  into frames, and decodes the port's frames of the same table;
* reads an artifact directory the port published (``load`` and
  ``versions``) and publishes one of its own;
* serves an ``mlp`` through its registry over its ``mlp`` builder.

The port's frames must be byte-equal to the JAX package's, each package
must decode the other's frames to what it decodes from its own, each
reads the other's artifacts, and a real port worker on the CPU serving
the same weights through the port's ``mlp`` builder matches the JAX
registry within 1e-6.
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
MLP_SEED, MLP_WIDTHS, MLP_ROWS = 11, (16, 32, 8), 5

# One source for both packages: ``P`` is the package's fleet protocol
# module, ``E`` its serving errors module.
SCENARIOS = textwrap.dedent('''
    import numpy as np

    class Sink:
        """A socket stand-in that keeps what is sent."""

        def __init__(self):
            self.buf = bytearray()

        def sendall(self, data):
            self.buf += bytes(data)

    class Source:
        """A socket stand-in that reads from bytes."""

        def __init__(self, data):
            self.data, self.pos = bytes(data), 0

        def recv(self, n):
            chunk = self.data[self.pos:self.pos + n]
            self.pos += len(chunk)
            return chunk

    def arrays():
        x = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
        x[0, 0] = np.nan
        x[1, 1] = -0.0
        return {
            "f32": x,
            "f64": np.linspace(-1, 1, 10).reshape(2, 5),
            "i32": np.arange(24, dtype=np.int32).reshape(2, 3, 4),
            "i16": np.arange(5, dtype=np.int16),
            "bool": np.array([True, False, True]),
            "empty": np.zeros((0, 3), np.float64),
            "scalar": np.float32(2.5),
        }

    def envelopes():
        a = arrays()
        predict = {"op": "predict", "id": 3, "model": "m",
                   "inputs": a["f32"], "deadline_ms": 12.5,
                   "trace_id": "abc", "priority_class": "gold"}
        generate = {"op": "generate", "id": 4,
                    "prompt_ids": [a["i16"].astype(np.int32),
                                   np.arange(9, dtype=np.int32)],
                    "model": "lm", "max_new_tokens": 6, "eos_id": None,
                    "temperature": 0.9, "top_k": 8, "top_p": 0.9,
                    "seed": 77}
        reply = {"id": 3, "ok": True, "result": a["f64"],
                 "info": {"model": "m", "version": 2, "canary": False,
                          "request_id": "abc"},
                 "trace": "abc|1.500|1000.000001|5.000000|1|0|"
                          "execute:0.000:1.500",
                 "load": {"o": 1, "r": ["m"]}}
        nested = {"id": 5, "ok": True,
                  "result": [a["i32"], {"k": a["bool"], "e": a["empty"]}],
                  "info": {"n": a["scalar"], "l": [1, "s", None]}}
        out = {}
        for name, env in (("predict", predict), ("generate", generate),
                          ("reply", reply), ("nested", nested)):
            out[name + "_json"] = (env, False)
            out[name + "_binary"] = (env, True)
        out["hello"] = ({"op": "hello", "id": 0, "wire": 2}, None)
        out["activate"] = ({"op": "activate", "id": 9, "model": "m",
                            "version": 3}, None)
        return out

    class Odd:
        """A detail value JSON cannot carry (its repr travels)."""

        def __repr__(self):
            return "Odd()"

    def error_cases(E):
        return {
            "Overloaded": E.Overloaded("queue full", evicted=True,
                                       queue_depth=64),
            "DeadlineExceeded": E.DeadlineExceeded(
                "hopeless", shed=True, predicted_ms=12.5),
            "ModelNotFound": E.ModelNotFound("no such model",
                                             model="nope",
                                             deployed=["a", "b"]),
            "DeployError": E.DeployError("warmup blew up", model="m",
                                         version=3, stage="warmup"),
            "ColdStartTimeout": E.ColdStartTimeout(
                "cold", model="m", waited_ms=52.1),
            "WorkerUnavailable": E.WorkerUnavailable(
                "no live fleet worker available",
                states={"live": 0, "dead": 2}),
            "ServingError": E.ServingError("boom", a=1),
            "ValueError": ValueError("bad rows"),
            "Unsendable": E.ServingError("odd", obj=Odd()),
        }

    def encode_all(P, E):
        """{name: frame hex} for every envelope and error case."""
        frames = {}
        for name, (env, binary) in envelopes().items():
            sink = Sink()
            if binary is None:
                P.send_frame(sink, env)
            else:
                P.send_envelope(sink, env, binary=binary)
            frames[name] = sink.buf.hex()
        for name, exc in error_cases(E).items():
            sink = Sink()
            P.send_frame(sink, {"id": 1, "ok": False,
                                "error": P.encode_error(exc)})
            frames["error_" + name] = sink.buf.hex()
        return frames

    def plain(v):
        """A decoded value in JSON form, arrays by dtype, shape, bytes."""
        if isinstance(v, np.ndarray):
            return {"nd": [str(v.dtype), list(v.shape), v.tobytes().hex()]}
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return v

    def decode_all(P, frames):
        """Each frame decoded: envelopes as plain JSON with the encoding,
        errors as the rebuilt exception's class, message, details and
        status."""
        out = {}
        for name, hexed in frames.items():
            env, nbytes, enc = P.recv_envelope(Source(bytes.fromhex(hexed)))
            if name.startswith("error_"):
                exc = P.decode_error(env["error"])
                out[name] = {"cls": type(exc).__name__,
                             "message": exc.message,
                             "details": exc.details,
                             "status": exc.http_status}
            else:
                out[name] = {"env": plain(env), "bytes": nbytes,
                             "encoding": enc}
        return out

    def mlp_weights():
        rng = np.random.default_rng(MLP_SEED)
        w = {f"w{i}": rng.normal(0, 0.5, (a, b)).astype(np.float32)
             for i, (a, b) in enumerate(zip(MLP_WIDTHS, MLP_WIDTHS[1:]))}
        x = rng.normal(0, 1, (MLP_ROWS, MLP_WIDTHS[0])).astype(np.float32)
        return w, x
''').replace("MLP_SEED", str(MLP_SEED)).replace(
    "MLP_WIDTHS", str(MLP_WIDTHS)).replace("MLP_ROWS", str(MLP_ROWS))

JAX_SIDE = textwrap.dedent('''
    import json, sys
    import jax, jax.lib
    from jaxlib import xla_client
    jax.lib.xla_client = xla_client  # the installed jax moved it
    import numpy as np
    from analytics_zoo_tpu.serving import ModelRegistry, errors as E
    from analytics_zoo_tpu.serving.fleet import (artifact, builders,
                                                 protocol as P)

    exec(open(sys.argv[1]).read())
    work = sys.argv[2]
    with open(work + "/port_frames.json") as f:
        port_frames = json.load(f)
    out = {"frames": encode_all(P, E),
           "decoded_port": decode_all(P, port_frames)}

    # the port's artifact directory, read by this package
    port_share = work + "/port_share"
    spec, params = artifact.load(port_share, "mlp", 2)
    out["port_artifact"] = {
        "versions": sorted(artifact.versions(port_share, "mlp")),
        "spec": spec,
        "params": {k: [str(v.dtype), list(v.shape), v.tobytes().hex()]
                   for k, v in sorted(params.items())}}

    # this package's artifact and mlp predict over its own builder
    w, x = mlp_weights()
    jax_share = work + "/jax_share"
    artifact.publish(jax_share, "mlp", 1, w,
                     {"builder": "analytics_zoo_tpu.serving.fleet."
                                 "builders:mlp", "args": {},
                      "warmup_shapes": None, "deploy_kwargs": {}})
    spec, params = artifact.load(jax_share, "mlp", 1)
    reg = ModelRegistry()
    try:
        reg.deploy("mlp", **artifact.build_deploy_kwargs(spec, params))
        y, info = reg.predict_ex("mlp", x)
    finally:
        reg.shutdown()
    np.save(work + "/jax_mlp.npy", np.asarray(y))
    out["mlp_info"] = info
    print("RESULT " + json.dumps(out, default=str))
''')


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The port's frames and artifact first, then the JAX side in one
    shimmed subprocess; returns (port namespace, JAX results, dir)."""
    from analytics_zoo_tpu_torch.serving import errors as E
    from analytics_zoo_tpu_torch.serving.fleet import artifact
    from analytics_zoo_tpu_torch.serving.fleet import protocol as P
    d = tmp_path_factory.mktemp("fleet_parity")
    ns = {}
    exec(SCENARIOS, ns)
    port_frames = ns["encode_all"](P, E)
    (d / "port_frames.json").write_text(json.dumps(port_frames))
    w, _ = ns["mlp_weights"]()
    artifact.publish(str(d / "port_share"), "mlp", 2, w,
                     {"builder": "analytics_zoo_tpu_torch.serving.fleet."
                                 "builders:mlp", "args": {"n_layers": 2},
                      "warmup_shapes": [MLP_WIDTHS[0]],
                      "deploy_kwargs": {"max_batch_size": 8}})
    (d / "scenarios.py").write_text(SCENARIOS)
    (d / "jax_side.py").write_text(JAX_SIDE)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(d / "jax_side.py"), str(d / "scenarios.py"),
         str(d)], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")]
    assert line, proc.stdout[-2000:] + proc.stderr[-4000:]
    out = json.loads(line[0][len("RESULT "):])
    return ns, port_frames, out, d


def _names():
    ns = {}
    exec(SCENARIOS, ns)
    from analytics_zoo_tpu_torch.serving import errors as E
    return sorted(list(ns["envelopes"]()) + [
        "error_" + n for n in ns["error_cases"](E)])


@pytest.mark.parametrize("name", _names())
def test_frames_byte_equal_jax(sides, name):
    """The same envelope or error gives the same frame bytes."""
    _, port_frames, jax_out, _ = sides
    assert port_frames[name] == jax_out["frames"][name]


def test_each_package_decodes_the_others_frames(sides):
    """The JAX package decodes the port's frames to what the port
    decodes from them, and the port decodes the JAX package's frames
    to what that package's own frames decode to in the port: the same
    envelopes, arrays bit for bit, the concrete error classes with
    their details."""
    from analytics_zoo_tpu_torch.serving.fleet import protocol as P
    ns, port_frames, jax_out, _ = sides
    ours_of_ours = json.loads(json.dumps(
        ns["decode_all"](P, port_frames), default=str))
    assert jax_out["decoded_port"] == ours_of_ours
    ours_of_theirs = json.loads(json.dumps(
        ns["decode_all"](P, jax_out["frames"]), default=str))
    assert ours_of_theirs == ours_of_ours
    errs = {k: v for k, v in ours_of_ours.items() if k.startswith("error_")}
    assert errs["error_Overloaded"]["cls"] == "Overloaded"
    assert errs["error_Overloaded"]["details"]["evicted"] is True
    assert errs["error_WorkerUnavailable"]["status"] == 503
    assert errs["error_ValueError"]["cls"] == "ServingError"
    assert errs["error_ValueError"]["details"]["error"] == "ValueError"
    assert errs["error_Unsendable"]["details"]["obj"] == "Odd()"
    env = ours_of_ours["reply_binary"]
    assert env["encoding"] == "binary" and env["env"]["info"]["version"] == 2


def test_port_artifact_read_by_jax(sides):
    ns, _, jax_out, d = sides
    from analytics_zoo_tpu_torch.serving.fleet import artifact
    got = jax_out["port_artifact"]
    assert got["versions"] == [2]
    spec, params = artifact.load(str(d / "port_share"), "mlp", 2)
    assert got["spec"] == spec
    assert spec["deploy_kwargs"] == {"max_batch_size": 8}
    w, _ = ns["mlp_weights"]()
    assert got["params"] == {
        k: [str(v.dtype), list(v.shape), v.tobytes().hex()]
        for k, v in sorted(w.items())}


def test_jax_artifact_read_by_port(sides):
    """The JAX package's directory lists and loads in the port, bit for
    bit; its builder path is refused by name."""
    from analytics_zoo_tpu_torch.serving.fleet import artifact
    ns, _, _, d = sides
    share = str(d / "jax_share")
    assert sorted(artifact.versions(share, "mlp")) == [1]
    spec, params = artifact.load(share, "mlp", 1)
    assert spec["model"] == "mlp" and spec["has_weights"] is True
    w, _ = ns["mlp_weights"]()
    assert sorted(params) == sorted(w)
    assert all(params[k].tobytes() == w[k].tobytes() for k in w)
    with pytest.raises(ValueError, match="analytics_zoo_tpu.serving."
                       "fleet.builders:mlp"):
        artifact.build_deploy_kwargs(spec, params, device="cpu")


def test_mlp_port_worker_matches_jax_registry(sides, tmp_path):
    """The JAX artifact's weights deployed through a real port worker on
    the CPU with the port's ``mlp`` builder: the predict matches the
    JAX registry's within 1e-6, on both wires."""
    from analytics_zoo_tpu_torch.serving.fleet import FleetRouter, artifact
    ns, _, jax_out, d = sides
    _, params = artifact.load(str(d / "jax_share"), "mlp", 1)
    _, x = ns["mlp_weights"]()
    ref = np.load(d / "jax_mlp.npy")
    r = FleetRouter(str(tmp_path / "share"), n_workers=1, device="cpu",
                    env={"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
                    max_restarts=0)
    try:
        r.start(timeout=120)
        rep = r.deploy("mlp", params, "analytics_zoo_tpu_torch.serving."
                       "fleet.builders:mlp")
        assert "error" not in rep["activations"][0], rep
        y, info = r.predict_ex("mlp", x)
        r.set_wire("json")
        y_json, _ = r.predict_ex("mlp", x)
    finally:
        r.close()
    assert y.shape == ref.shape == (MLP_ROWS, MLP_WIDTHS[-1])
    assert float(np.max(np.abs(y - ref))) <= TOL
    assert y.tobytes() == y_json.tobytes()
    assert info["version"] == jax_out["mlp_info"]["version"] == 1
