"""The port's ring, pipeline and expert parallelism on gloo pods,
against the JAX package.

One 4-rank pod, started through the port's launcher (``python -m
analytics_zoo_tpu_torch.launcher --num-processes 4``), builds the
meshes {seq 4}, {pipe 4} and {expert 4} over its world and runs every
case on each: ``ring_attention_sharded`` (causal and not, with
``kv_lengths``), ``pipeline_apply`` with 1, 4 and 8 microbatches, and
``moe_sharded``, each on global inputs made from a numpy seed, with the
gradient of ``sum(out * w)``.  Every rank writes what it got; the test
process runs the JAX functions on the same inputs on meshes of its 8
virtual CPU devices and holds each rank's values and gradients to them
at 1e-5.  A 2-rank pod checks the mesh plumbing itself: the ``-1``
wildcard, the world-size error, the DTensor placements of the rule
tables, ``put_global``/``local_rows`` and the collectives' gradients.

Every process group has a 60 s timeout and every pod a subprocess
timeout, so a stuck collective fails one test, not the suite.
"""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from analytics_zoo_tpu.parallel.expert import MoEParams as JMoEParams
from analytics_zoo_tpu.parallel.expert import moe_sharded as jmoe_sharded
from analytics_zoo_tpu.parallel.pipeline import pipeline_apply as jpipeline
from analytics_zoo_tpu.parallel.ring_attention import (
    ring_attention_sharded as jring)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from analytics_zoo_tpu_torch.parallel import distributed
    distributed.maybe_initialize_distributed("cpu", timeout_s=60)
    RANK = distributed.process_index()
    OUT = sys.argv[1]

    def save(name, **arrays):
        np.savez(os.path.join(OUT, f"{name}.p{RANK}.npz"),
                 **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v)) for k, v in arrays.items()})
""")


def run_pod(tmp_dir, n: int, body: str, timeout: int = 110):
    """Run ``PRELUDE + body`` on an ``n``-rank gloo pod; fail with the
    pod's output when it does not exit 0."""
    script = os.path.join(tmp_dir, "pod.py")
    with open(script, "w") as f:
        f.write(PRELUDE + textwrap.dedent(body))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ZOO_TPU_", "ZOO_RESUME", "ZOO_FAULT_"))}
    env["PYTHONPATH"] = REPO
    # a session of its own: on a timeout the whole pod is killed, ranks
    # blocked in a collective included
    proc = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher",
         "--num-processes", str(n), script, str(tmp_dir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"pod timed out after {timeout} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]


def load(tmp_dir, name, rank):
    with np.load(os.path.join(tmp_dir, f"{name}.p{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------- the inputs, seeded

# run by the test process and by every pod rank (which imports no jax)
INPUTS = """
import numpy as np
B, S, H, D = 2, 32, 2, 8
RING_CASES = {"plain": dict(causal=False, lengths=None),
              "causal": dict(causal=True, lengths=None),
              "causal_lengths": dict(causal=True, lengths=[19, 32]),
              "lengths": dict(causal=False, lengths=[5, 27])}
PIPE_MICRO = (1, 4, 8)
PIPE_B, PIPE_W = 8, 6
MOE_T, MOE_D, MOE_H, MOE_E = 32, 8, 16, 8


def ring_inputs():
    rng = np.random.default_rng(10)
    return [rng.normal(size=(B, S, H, D)).astype(np.float32)
            for _ in range(4)]


def pipe_inputs():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(PIPE_B, PIPE_W)).astype(np.float32),
            (rng.normal(size=(4, PIPE_W, PIPE_W)) * 0.5).astype(np.float32),
            rng.normal(size=(4, PIPE_W)).astype(np.float32) * 0.1,
            rng.normal(size=(PIPE_B, PIPE_W)).astype(np.float32))


def moe_inputs():
    rng = np.random.default_rng(12)
    p = [rng.normal(size=(MOE_D, MOE_E)).astype(np.float32),
         (rng.normal(size=(MOE_E, MOE_D, MOE_H)) * 0.3).astype(np.float32),
         rng.normal(size=(MOE_E, MOE_H)).astype(np.float32) * 0.1,
         (rng.normal(size=(MOE_E, MOE_H, MOE_D)) * 0.3).astype(np.float32),
         rng.normal(size=(MOE_E, MOE_D)).astype(np.float32) * 0.1]
    return (rng.normal(size=(MOE_T, MOE_D)).astype(np.float32), p,
            rng.normal(size=(MOE_T, MOE_D)).astype(np.float32))


"""
exec(INPUTS)


POD4 = INPUTS + """
from analytics_zoo_tpu_torch.parallel import (create_mesh, moe_sharded,
                                              pipeline_apply,
                                              ring_attention_sharded)
from analytics_zoo_tpu_torch.parallel.expert import MoEParams

def leaf(a):
    return torch.tensor(a, requires_grad=True)

seq = create_mesh({"seq": 4}, device="cpu")
for name, case in RING_CASES.items():
    q, k, v, w = (leaf(a) for a in ring_inputs())
    out = ring_attention_sharded(q, k, v, seq, causal=case["causal"],
                                 kv_lengths=case["lengths"])
    (out * w).sum().backward()
    save("ring_" + name, out=out, dq=q.grad, dk=k.grad, dv=v.grad)

pipe = create_mesh({"pipe": 4}, device="cpu")
for micro in PIPE_MICRO:
    x, wst, bst, w = pipe_inputs()
    x, wst, bst = leaf(x), leaf(wst), leaf(bst)
    stage = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    out = pipeline_apply(stage, {"w": wst, "b": bst}, x, pipe,
                         n_microbatches=micro)
    (out * torch.tensor(w)).sum().backward()
    save(f"pipe_{micro}", out=out, dx=x.grad, dw=wst.grad, db=bst.grad)

expert = create_mesh({"expert": 4}, device="cpu")
x, p, w = moe_inputs()
x, p = leaf(x), MoEParams(*(leaf(a) for a in p))
out, aux = moe_sharded(x, p, expert)
((out * torch.tensor(w)).sum() + aux).backward()
save("moe", out=out, aux=aux, dx=x.grad,
     **{"d" + k: getattr(p, k).grad for k in MoEParams._fields})
"""


@pytest.fixture(scope="module")
def pod4(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pod4"))
    run_pod(d, 4, POD4)
    return d


def _jmesh(name, n=4):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_sharded_matches_jax(pod4, case):
    cfg = RING_CASES[case]
    q, k, v, w = (jnp.asarray(a) for a in ring_inputs())
    mesh = _jmesh("seq")
    lens = None if cfg["lengths"] is None else jnp.asarray(cfg["lengths"])

    def f(q, k, v):
        out = jring(q, k, v, mesh, causal=cfg["causal"], kv_lengths=lens)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    for rank in range(4):
        got = load(pod4, "ring_" + case, rank)
        _close(got["out"], out, f"out rank {rank}")
        for name, g in zip(("dq", "dk", "dv"), grads):
            _close(got[name], g, f"{name} rank {rank}")


@pytest.mark.parametrize("micro", PIPE_MICRO)
def test_pipeline_apply_matches_jax(pod4, micro):
    x, wst, bst, w = (jnp.asarray(a) for a in pipe_inputs())
    mesh = _jmesh("pipe")

    def f(x, wst, bst):
        out = jpipeline(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                        {"w": wst, "b": bst}, x, mesh,
                        n_microbatches=micro)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(x, wst, bst)
    for rank in range(4):
        got = load(pod4, f"pipe_{micro}", rank)
        _close(got["out"], out, f"out rank {rank}")
        for name, g in zip(("dx", "dw", "db"), grads):
            _close(got[name], g, f"{name} rank {rank}")


def test_moe_sharded_matches_jax(pod4):
    x, p, w = moe_inputs()
    mesh = _jmesh("expert")

    def f(x, p):
        out, aux = jmoe_sharded(x, JMoEParams(*p), mesh)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (out, aux)), (dx, dp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                          [jnp.asarray(a) for a in p])
    for rank in range(4):
        got = load(pod4, "moe", rank)
        _close(got["out"], out, f"out rank {rank}")
        _close(got["aux"], aux, f"aux rank {rank}")
        _close(got["dx"], dx, f"dx rank {rank}")
        for name, g in zip(JMoEParams._fields, dp):
            _close(got["d" + name], g, f"d{name} rank {rank}")


# ---------------------------------------------------- mesh plumbing

POD2 = """
from torch.distributed.tensor import DTensor, Replicate, Shard
from analytics_zoo_tpu_torch.parallel import _compat as C
from analytics_zoo_tpu_torch.parallel import mesh as M
from analytics_zoo_tpu_torch.parallel import sharding as SH

facts = {}
mesh = M.create_mesh({"fsdp": -1}, device="cpu")
facts["names"] = list(mesh.mesh_dim_names)
facts["shape"] = list(mesh.mesh.shape)
try:
    M.create_mesh({"data": 3}, device="cpu")
except ValueError as e:
    facts["error"] = str(e)
# a spec's placements and blocks
full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
spec = SH.fsdp_tree({"W": full}, mesh, min_size=1)["W"]
local = SH.local_shard(full, spec, mesh)
dt = DTensor.from_local(local, mesh, SH.spec_to_placements(spec, mesh),
                        run_check=False, shape=full.shape,
                        stride=full.stride())
facts["spec"] = list(spec)
facts["placements"] = [str(p) for p in dt.placements]
facts["full_equal"] = bool(torch.equal(dt.full_tensor(), full))
facts["gather_equal"] = bool(torch.equal(SH.gather_shard(local, spec, mesh),
                                         full))
facts["roundtrip"] = SH.dtensor_sharding(dt).spec == spec
# a batch placed from local rows and given back
rows = np.full((3, 2), RANK, np.float32)
g = distributed.put_global(rows, M.data_sharding(mesh))
facts["global_shape"] = list(g.shape)
facts["global_rows"] = g.full_tensor()[:, 0].tolist()
facts["local_rows"] = distributed.local_rows(g)[:, 0].tolist()
# an accumulation layout (accum, micro, ...) split on dim 1, and a
# global batch placed by shard_batch
from analytics_zoo_tpu_torch.data.dataset import shard_batch
micro = np.full((2, 3, 1), RANK, np.float32)
gm = distributed.put_global(micro, M.data_sharding(mesh), batch_dim=1)
facts["micro_shape"] = list(gm.shape)
facts["micro_rows"] = gm.full_tensor()[0, :, 0].tolist()
whole = np.arange(8, dtype=np.float32).reshape(4, 2)
sb = shard_batch((whole, None), M.data_sharding(mesh))
facts["shard_batch"] = [sb[0].to_local().tolist(), sb[1] is None,
                        bool(torch.equal(sb[0].full_tensor(),
                                         torch.as_tensor(whole)))]
# collectives and their gradients
x = torch.tensor([1.0 + RANK, 2.0], requires_grad=True)
y = C.ppermute(x, "fsdp", [(0, 1), (1, 0)], mesh=mesh)
(y * torch.tensor([1.0, 10.0 * (RANK + 1)])).sum().backward()
facts["ppermute"] = y.tolist()
facts["ppermute_grad"] = x.grad.tolist()
z = torch.tensor([[1.0, 2.0], [3.0, 4.0]]) + 10 * RANK
facts["all_to_all"] = C.all_to_all(z, "fsdp", 0, 0, mesh=mesh).tolist()
facts["psum"] = C.psum(torch.tensor(1.0 + RANK), "fsdp", mesh=mesh).item()
facts["pmean"] = C.pmean(torch.tensor(1.0 + RANK), "fsdp", mesh=mesh).item()
facts["axis"] = [C.axis_size("fsdp", mesh), C.axis_index("fsdp", mesh)]
# the reports, on a tiny model and short sequences
from analytics_zoo_tpu_torch.parallel import ring_report, strategy_report
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

def tiny(input_shape, num_classes, device, seed):
    m = Sequential(device=device, seed=seed)
    m.add(L.Flatten(input_shape=input_shape))
    m.add(L.Dense(256, activation="relu", name="hid"))
    m.add(L.Dense(num_classes, activation="softmax", name="fc1000"))
    return m

facts["strategies"] = strategy_report.compare_strategies(
    mesh, strategies=("replicate", "fsdp"), image_size=8, steps=1,
    model_fn=tiny)["strategies"]
facts["ring"] = ring_report.compare_ring(
    M.create_mesh({"seq": 2}, device="cpu"), seq_lengths=(64, 256),
    run_single_up_to=64, run_ring_up_to=64)["rows"]
import json
with open(os.path.join(OUT, f"facts.p{RANK}.json"), "w") as f:
    json.dump(facts, f)
"""


@pytest.fixture(scope="module")
def pod2(tmp_path_factory):
    import json
    d = str(tmp_path_factory.mktemp("pod2"))
    run_pod(d, 2, POD2)
    out = []
    for rank in range(2):
        with open(os.path.join(d, f"facts.p{rank}.json")) as f:
            out.append(json.load(f))
    return out


def test_create_mesh_names_six_axes_and_resolves_wildcard(pod2):
    for facts in pod2:
        assert facts["names"] == ["fsdp", "data", "tensor", "seq",
                                  "expert", "pipe"]
        assert facts["shape"] == [2, 1, 1, 1, 1, 1]
        assert facts["axis"][0] == 2
    assert [f["axis"][1] for f in pod2] == [0, 1]


def test_create_mesh_rejects_wrong_world_size(pod2):
    assert "need 3 devices, have 2" in pod2[0]["error"]


def test_rule_table_specs_become_dtensor_placements(pod2):
    for facts in pod2:
        assert facts["spec"] == ["fsdp", None]
        assert facts["placements"][0] == "S(0)"
        assert all(p == "R" for p in facts["placements"][1:])
        assert facts["full_equal"] and facts["gather_equal"]
        assert facts["roundtrip"]


def test_put_global_and_local_rows(pod2):
    for rank, facts in enumerate(pod2):
        assert facts["global_shape"] == [6, 2]
        assert facts["global_rows"] == [0, 0, 0, 1, 1, 1]
        assert facts["local_rows"] == [rank] * 3


def test_put_global_microbatches_and_shard_batch(pod2):
    for rank, facts in enumerate(pod2):
        assert facts["micro_shape"] == [2, 6, 1]
        assert facts["micro_rows"] == [0, 0, 0, 1, 1, 1]
        block, none_kept, whole = facts["shard_batch"]
        assert block == [[4.0 * rank, 4.0 * rank + 1],
                         [4.0 * rank + 2, 4.0 * rank + 3]]
        assert none_kept and whole


def test_collectives_and_their_gradients(pod2):
    # ppermute swaps; its backward sends the cotangents back
    assert pod2[0]["ppermute"] == [2.0, 2.0]
    assert pod2[1]["ppermute"] == [1.0, 2.0]
    assert pod2[0]["ppermute_grad"] == [1.0, 20.0]
    assert pod2[1]["ppermute_grad"] == [1.0, 10.0]
    # all_to_all: row j of the result comes from rank j
    assert pod2[0]["all_to_all"] == [[1.0, 2.0], [11.0, 12.0]]
    assert pod2[1]["all_to_all"] == [[3.0, 4.0], [13.0, 14.0]]
    for facts in pod2:
        assert facts["psum"] == 3.0 and facts["pmean"] == 1.5


def test_strategy_report_counts_collectives_and_bytes(pod2):
    rep = pod2[0]["strategies"]
    # replicate averages gradients (all-reduce); fsdp also gathers the
    # split parameters back (all-gather) and holds half of them
    assert rep["replicate"]["collectives"].get("all-reduce", 0) >= 1
    assert rep["fsdp"]["collectives"].get("all-gather", 0) >= 1
    assert (rep["fsdp"]["per_device_param_bytes"]
            < rep["replicate"]["per_device_param_bytes"])
    assert (rep["fsdp"]["per_device_opt_bytes"]
            < rep["replicate"]["per_device_opt_bytes"])
    assert all(e["step_ms"] > 0 for e in rep.values())


def test_ring_report_runs_and_counts_bytes(pod2):
    rows = pod2[0]["ring"]
    assert set(rows) == {"64", "256"}
    assert rows["64"]["ring"]["wall_ms"] > 0
    assert rows["64"]["single_device"]["wall_ms"] > 0
    assert rows["256"]["ring"]["wall_ms"] is None
    assert rows["256"]["single_device"]["note"]
    for row in rows.values():
        assert row["memory_ratio_single_over_ring"] > 1.5


# ------------------------------------------- per-process data sharding


@pytest.mark.parametrize("n,nproc", [(10, 3), (12, 4), (5, 2), (7, 1)])
def test_shard_by_process_matches_jax(n, nproc):
    from analytics_zoo_tpu.data.dataset import Dataset as JDataset
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    x = np.arange(n * 2).reshape(n, 2).astype(np.float32)
    y = np.arange(n)
    for pid in range(nproc):
        want = JDataset.from_ndarray(x, y).shard_by_process(pid, nproc)
        got = Dataset.from_ndarray(x, y).shard_by_process(pid, nproc)
        assert got.size == want.size
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.y, want.y)
        if want.valid is None:
            assert got.valid is None
        else:
            np.testing.assert_array_equal(got.valid, want.valid)


def test_check_batch_divisibility_errors_match_jax():
    from analytics_zoo_tpu.data.dataset import check_batch_divisibility as j
    from analytics_zoo_tpu_torch.data.dataset import (
        check_batch_divisibility as t)
    for args in ((32, 4, 2), (30, 4, 1), (12, 4, 8)):
        try:
            j(*args)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            t(*args)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want


# --------------------------------- validation errors, as the JAX package's


class _FakeMesh:
    """Axis sizes under names, as a DeviceMesh shows them: enough for the
    checks that run before any collective."""

    def __init__(self, **sizes):
        import torch
        self.mesh_dim_names = tuple(sizes)
        self.mesh = torch.empty(tuple(sizes.values()))


def test_ring_layer_errors_match_jax():
    import torch
    from analytics_zoo_tpu_torch.parallel.mesh import active_mesh
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        MultiHeadSelfAttention)
    layer = MultiHeadSelfAttention(2, implementation="ring",
                                   input_shape=(8, 8), device="cpu")
    x = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="carry a 'seq' axis"):
        layer(x)
    with active_mesh(_FakeMesh(data=2)):
        with pytest.raises(ValueError, match="carry a 'seq' axis"):
            layer(x)
    with active_mesh(_FakeMesh(seq=3)):
        with pytest.raises(ValueError, match="not divisible by the mesh's "
                                             "seq axis"):
            layer(x)


def test_pipeline_apply_validation_errors_match_jax():
    import torch
    from analytics_zoo_tpu_torch.parallel import pipeline_apply
    stage = lambda p, h: h @ p["w"]
    params = {"w": torch.zeros(2, 3, 3)}
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="need leading axis 3"):
        pipeline_apply(stage, params, x, {"pipe": 3})
    with pytest.raises(ValueError, match="n_microbatches must be >= 1"):
        pipeline_apply(stage, params, x, {"pipe": 2}, n_microbatches=0)
    with pytest.raises(ValueError, match="not divisible by n_microbatches"):
        pipeline_apply(stage, params, x, {"pipe": 2}, n_microbatches=3)


def test_switch_moe_notes_an_unusable_expert_axis():
    """An expert axis that does not divide the expert count runs the
    layer replicated and records why, as the JAX layer does."""
    import torch
    from analytics_zoo_tpu_torch.parallel.mesh import active_mesh
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import moe
    layer = moe.SwitchMoE(n_experts=4, hidden_dim=8, input_shape=(6, 4),
                          name="moe_fallback_probe", device="cpu")
    x = torch.randn(2, 6, 4, generator=torch.Generator().manual_seed(0))
    moe.clear_fallback_log()
    with active_mesh(_FakeMesh(expert=3)):
        got = layer(x)
    assert "expert count 4" in moe.EXPERT_FALLBACKS["moe_fallback_probe"]
    moe.clear_fallback_log()
    assert torch.equal(got, layer(x))
    assert not moe.EXPERT_FALLBACKS
