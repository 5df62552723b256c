"""The port's sharded Trainer on gloo pods, against the JAX package's.

Counterparts of ``tests/test_trainer_sharded.py`` and more, each rank a
process of a pod started through the port's launcher, the JAX side in
the test process on its 8 virtual CPU devices:

* a 4-step ``fit`` under ``fsdp`` on 2 ranks against the JAX ``Trainer``
  on {fsdp 2} from the same weights (``shuffle=False``, each rank given
  its rows of every global batch): losses and parameters at 1e-5;
* fsdp tracks replicate (1e-6); the adam moments are sharded 1/2;
  accumulation over 2 microbatches follows the unaccumulated trajectory
  (losses 1e-5, parameters 1e-4, as the JAX test bounds them);
* ``fsdp_tp`` with ``{r"W$": 1}`` on {tensor 2} against replicate at
  1e-6, not bitwise: the JAX package's own bitwise pin of this leg does
  not hold on the CPU here either (10.948372 against 10.948374);
* a cross-mesh resume: saved mid-fit on {fsdp 2}, restored on {fsdp 4}
  (4 ranks), saved again and restored on {fsdp 2}, the resumed fit ends
  bit for bit on the uninterrupted one (parameters and moments);
* snapshots across packages: a save of 2 port ranks restores in the JAX
  package on {fsdp 4}, a JAX save restores on 2 port ranks, bit for bit;
* TransformerLM under ``fsdp_tp`` with the per-layer rules on {fsdp 2,
  tensor 2} (attention on its head blocks, the MLP on column and row
  blocks), with Switch-MoE on {expert 2} and with ring attention on
  {seq 2}, each through ``fit`` against the JAX package (losses 1e-5,
  weights 1e-5);
* the layers that depend on the whole batch on {data 2}, where each
  rank holds half of it: a Sequential with BatchNormalization (its
  statistics the global batch's: losses, weights and moving statistics
  at 1e-5, both ranks' statistics equal) and the Switch-MoE
  TransformerLM with a router that drops the two ranks' tokens
  unevenly (global capacity and routing, the aux loss of the global
  statistics), each through ``fit`` against the JAX package, and again
  with their layers under remat (the backward's recompute reduces over
  the ranks too); the MoE TransformerLM's ``evaluate`` and ``predict``
  on {data 2} against the JAX package's, over a set whose tail leaves
  one rank a batch short (every rank pads to the same batches, as the
  JAX package pads its tail).

Dropout is 0 throughout (the ranks' masks differ from JAX's draws).
Every process group has a 60 s timeout and every pod a subprocess
timeout.
"""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import optax
import pytest
import jax

from analytics_zoo_tpu.data.dataset import Dataset as JDataset
from analytics_zoo_tpu.models import TransformerLM as JaxLM
from analytics_zoo_tpu.parallel import mesh as jmesh_lib
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.train import triggers as jtrig
from analytics_zoo_tpu.train.trainer import Trainer as JTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run by the test process and by every pod rank (which imports no jax)
INPUTS = """
import numpy as np

LM_RULES = {r"attn_\\d+/W[qkv]$": 1, r"attn_\\d+/Wo$": 0,
            r"mlp_up_\\d+/W$": 1, r"mlp_down_\\d+/W$": 0}
SMALL = dict(vocab_size=12, seq_len=24, n_layers=2, d_model=32, n_heads=2)


def mlp_data():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(64, 8)).astype(np.float32),
            rng.integers(0, 4, 64).astype(np.int32))


def shard_rows(n, batch, shard, n_shards):
    # the rows a data shard feeds of every global batch, in order
    per = batch // n_shards
    return np.concatenate([np.arange(b + shard * per, b + (shard + 1) * per)
                           for b in range(0, n, batch)])


def tokens(n=96, vocab=12, seq=24, seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 4, n)
    start = rng.integers(0, vocab, n)
    toks = (start[:, None] + steps[:, None]
            * np.arange(seq + 1)[None, :]) % vocab
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
"""
exec(INPUTS)

PRELUDE = INPUTS + textwrap.dedent("""
    import os, sys
    import torch
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor
    from analytics_zoo_tpu_torch.parallel import distributed
    distributed.maybe_initialize_distributed("cpu", timeout_s=60)
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    from analytics_zoo_tpu_torch.models import TransformerLM, from_jax_params
    from analytics_zoo_tpu_torch.parallel.mesh import (create_mesh,
                                                       data_index, dp_size)
    from analytics_zoo_tpu_torch.pipeline.api.keras import (Sequential,
                                                            objectives,
                                                            optimizers)
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.train import checkpoint, triggers
    from analytics_zoo_tpu_torch.train.trainer import Trainer
    RANK = distributed.process_index()
    OUT = sys.argv[1]

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                out.update(flat(v, name))
            else:
                out[name] = v
        return out

    def nest(arrays):
        tree = {}
        for name, a in arrays.items():
            node = tree
            *head, last = name.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = a
        return tree

    def save(name, **arrays):
        np.savez(os.path.join(OUT, f"{name}.p{RANK}.npz"), **arrays)

    def state_arrays(trainer):
        # every leaf of the training state whole (a DTensor gathered:
        # collective, every rank calls it)
        out = {}
        for n, leaf in checkpoint.flatten(trainer.state_tree()):
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()
            out[n] = (leaf.detach().numpy() if isinstance(leaf, torch.Tensor)
                      else np.asarray(leaf))
        return out

    def load_npz(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
""")


def run_pod(tmp_dir, n: int, body: str, timeout: int = 110):
    script = os.path.join(tmp_dir, "pod.py")
    with open(script, "w") as f:
        f.write(PRELUDE + textwrap.dedent(body))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ZOO_TPU_", "ZOO_RESUME", "ZOO_FAULT_",
                                "ZOO_TRAIN_"))}
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


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh_lib.create_mesh(axes, devices=jax.devices()[:n])


def _jmlp_trainer(mesh, strategy="fsdp"):
    m = JSequential()
    m.add(JDense(4096, activation="relu", input_shape=(8,), name="hid"))
    m.add(JDense(4, activation="softmax", name="out"))
    return JTrainer(m.to_graph(),
                    jobj.get("sparse_categorical_crossentropy"),
                    optax.adam(1e-3), mesh=mesh, strategy=strategy, seed=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _jax_state(trainer):
    """name -> array of a JAX trainer's state, under the checkpoint's
    leaf names (the names the port's saves use)."""
    from analytics_zoo_tpu.train.checkpoint import _flatten_with_names
    names, leaves, _ = _flatten_with_names(trainer.state.as_tree())
    return {n: np.asarray(l) for n, l in zip(names, leaves)
            if l is not None}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The JAX references, and the pods in order: A (2 ranks), B (4),
    C (2); B and C restore what the previous pod saved."""
    d = str(tmp_path_factory.mktemp("sharded"))
    ref = {}
    # the MLP on {fsdp 2}: initial weights, 4 steps, a save
    x, y = mlp_data()
    jt = _jmlp_trainer(_jmesh({"data": 1, "fsdp": 2}))
    jt.ensure_initialized()
    np.savez(os.path.join(d, "w0.npz"), **_flat(
        jax.device_get(jt.state.params)))
    ref["mlp_loss"] = jt.fit(JDataset.from_ndarray(x, y), batch_size=32,
                             end_trigger=jtrig.MaxIteration(4),
                             shuffle=False)["loss"]
    ref["mlp_state"] = _jax_state(jt)
    jt.save_weights(os.path.join(d, "ckpt_jax"), tag="j")
    # TransformerLM: replicated reference; Switch-MoE on {expert 2};
    # ring attention on {seq 2}
    tx, ty = tokens()
    for name, kw, mesh in (
            ("lm_tp", {}, _jmesh({"data": 1})),
            ("lm_moe", dict(moe_every=2, n_experts=4),
             _jmesh({"expert": 2})),
            ("lm_ring", dict(implementation="ring"), _jmesh({"seq": 2}))):
        jm = JaxLM(**SMALL, **kw)
        jm.compile(optimizer={"name": "adam", "lr": 3e-3},
                   loss="class_nll", mesh=mesh)
        np.savez(os.path.join(d, f"{name}_w0.npz"),
                 **_flat(jm.get_weights()))
        ref[name + "_loss"] = jm.fit(tx, ty, batch_size=32, nb_epoch=1,
                                     shuffle=False)["loss"]
        ref[name + "_w"] = _flat(jm.get_weights())
    jt = _jmlp_trainer(_jmesh({"data": 1, "fsdp": 2}))
    ref["evaluate"] = jt.evaluate(JDataset.from_ndarray(x[:49], y[:49]),
                                  16, metrics=["accuracy"])
    ref["predict"] = jt.predict(x[:49], batch_size=16)
    run_pod(d, 2, POD_A)
    run_pod(d, 4, POD_B)
    run_pod(d, 2, POD_C)
    return d, ref


MLP = """
w0 = nest(load_npz(os.path.join(OUT, "w0.npz")))
x, y = mlp_data()

def trainer(mesh, strategy, opt=None, **kw):
    m = Sequential(device="cpu", seed=0)
    m.add(L.Dense(4096, activation="relu", input_shape=(8,), name="hid"))
    m.add(L.Dense(4, activation="softmax", name="out"))
    from_jax_params(m, w0)
    return Trainer(m, objectives.get("sparse_categorical_crossentropy"),
                   opt or optimizers.get({"name": "adam", "lr": 1e-3}),
                   mesh=mesh, strategy=strategy, **kw)

def fit(t, steps):
    rows = shard_rows(64, 32, data_index(t.mesh), dp_size(t.mesh))
    return t.fit(Dataset.from_ndarray(x[rows], y[rows]), batch_size=32,
                 end_trigger=triggers.MaxIteration(steps),
                 shuffle=False)["loss"]
"""

POD_A = MLP + """
fsdp2 = create_mesh({"data": 1, "fsdp": 2}, device="cpu")
t = trainer(fsdp2, "fsdp")
loss = fit(t, 4)
st = state_arrays(t)
mu = t.state_tree()["opt_state"]["0"][".mu"]["hid"]["W"]
save("fsdp", loss=np.asarray(loss), mu_local=mu.to_local().numpy(),
     mu_placements=np.asarray([str(p) for p in mu.placements]), **st)
t.save_weights(os.path.join(OUT, "ckpt_port"), tag="p")

r = trainer(fsdp2, "replicate")
save("replicate", loss=np.asarray(fit(r, 4)), **state_arrays(r))

# norms over whole leaves: global-norm clipping (tight enough to clip
# every step) and lamb's trust ratios, replicate against fsdp
for name, spec, clip in (("clip", {"name": "adam", "lr": 1e-3}, 0.05),
                         ("lamb", {"name": "lamb", "lr": 1e-3}, None)):
    for strategy in ("replicate", "fsdp"):
        c = trainer(fsdp2, strategy,
                    opt=optimizers.get(spec, clip_norm=clip))
        save(f"{name}_{strategy}", loss=np.asarray(fit(c, 4)),
             **state_arrays(c))

data2 = create_mesh({"data": 2}, device="cpu")
for accum in (1, 2):
    a = trainer(data2, "replicate", accum_steps=accum)
    save(f"accum{accum}", loss=np.asarray(fit(a, 4)), **state_arrays(a))

tensor2 = create_mesh({"data": 1, "fsdp": 1, "tensor": 2}, device="cpu")
for strategy, kw in (("replicate", {}), ("fsdp_tp", {"tp_rules": {r"W$": 1}})):
    tp = trainer(tensor2, strategy, **kw)
    save("tensor_" + strategy, loss=np.asarray(fit(tp, 4)),
         specs=np.asarray([str(s) for s in tp.state.plan.specs]),
         **state_arrays(tp))

# evaluate and predict from the initial weights on each rank's rows
# (49 rows: rank 1's last row is a wrapped filler, masked out)
ev = trainer(fsdp2, "fsdp")
part = Dataset.from_ndarray(x[:49], y[:49]).shard_by_process(
    data_index(fsdp2), dp_size(fsdp2))
res = ev.evaluate(part, batch_size=16, metrics=["accuracy"])
save("evaluate", valid=np.asarray(part.valid is not None),
     pred=ev.predict(x[:49][RANK::2], batch_size=16),
     **{k: np.asarray(v) for k, v in res.items()})

# interrupted on {fsdp 2}: one epoch, then a save
i = trainer(fsdp2, "fsdp")
fit(i, 2)
i.save_weights(os.path.join(OUT, "ckpt_y"), tag="mid")

# a JAX save (on {fsdp 2}) restored here
j = trainer(fsdp2, "fsdp")
j.load_weights(os.path.join(OUT, "ckpt_jax"), tag="j")
save("from_jax", step=np.asarray(j.state.step), **state_arrays(j))
"""

LM = """
tx, ty = tokens()

def lm(name, mesh, strategy=None, tp_rules=None, **kw):
    m = TransformerLM(**SMALL, device="cpu", **kw)
    from_jax_params(m, nest(load_npz(os.path.join(OUT, name + "_w0.npz"))))
    m.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll",
              mesh=mesh, strategy=strategy, tp_rules=tp_rules)
    rows = shard_rows(len(tx), 32, data_index(mesh), dp_size(mesh))
    loss = m.fit(tx[rows], ty[rows], batch_size=32, nb_epoch=1,
                 shuffle=False)["loss"]
    save(name, loss=np.asarray(loss), **flat(m.get_weights()))
    return m
"""

POD_B = MLP + LM + """
fsdp4 = create_mesh({"data": 1, "fsdp": 4}, device="cpu")
t = trainer(fsdp4, "fsdp")
t.load_weights(os.path.join(OUT, "ckpt_y"), tag="mid")
w = t.state_tree()["params"]["hid"]["W"]
save("on_fsdp4", step=np.asarray(t.state.step),
     epoch=np.asarray(t.state.epoch),
     local_shape=np.asarray(w.to_local().shape), **state_arrays(t))
t.save_weights(os.path.join(OUT, "ckpt_x"), tag="mid2")

m = lm("lm_tp", create_mesh({"fsdp": 2, "tensor": 2}, device="cpu"),
       strategy="fsdp_tp", tp_rules=LM_RULES)
save("lm_tp_split", n=np.asarray(len(m.trainer.state.plan._splits)))
"""

POD_C = MLP + LM + """
fsdp2 = create_mesh({"data": 1, "fsdp": 2}, device="cpu")
t = trainer(fsdp2, "fsdp")
t.load_weights(os.path.join(OUT, "ckpt_x"), tag="mid2")
loss = fit(t, 4)
save("resumed", step=np.asarray(t.state.step), loss=np.asarray(loss),
     **state_arrays(t))

lm("lm_moe", create_mesh({"expert": 2}, device="cpu"), moe_every=2,
   n_experts=4)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import moe
save("moe_fallbacks", n=np.asarray(len(moe.EXPERT_FALLBACKS)))
lm("lm_ring", create_mesh({"seq": 2}, device="cpu"), implementation="ring")
"""


def _state_close(got, want, atol, what):
    keys = [k for k in want if k.startswith(("params/", "opt_state/"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


def _state_equal(got, want, what):
    keys = [k for k in want if k.startswith(("params/", "opt_state/"))]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{what}: {k}")


def test_fsdp_fit_matches_jax_trainer(work):
    d, ref = work
    for rank in range(2):
        got = load(d, "fsdp", rank)
        np.testing.assert_allclose(got["loss"], ref["mlp_loss"], rtol=1e-5)
        _state_close(got, ref["mlp_state"], 1e-5, f"rank {rank}")


def test_fsdp_losses_track_replicated(work):
    d, _ = work
    for rank in range(2):
        a, b = load(d, "replicate", rank), load(d, "fsdp", rank)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        _state_close(b, a, 1e-6, f"rank {rank}")


def test_fsdp_shards_optimizer_moments(work):
    d, _ = work
    for rank in range(2):
        got = load(d, "fsdp", rank)
        whole = got["opt_state/0/.mu/hid/W"]
        assert whole.shape == (8, 4096)
        assert got["mu_local"].nbytes * 2 == whole.nbytes
        assert list(got["mu_placements"][:2]) == ["R", "S(1)"]
        np.testing.assert_array_equal(
            got["mu_local"], whole[:, rank * 2048:(rank + 1) * 2048])


def test_grad_accum_matches_unaccumulated_trajectory(work):
    d, _ = work
    for rank in range(2):
        a, b = load(d, "accum1", rank), load(d, "accum2", rank)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        _state_close(b, a, 1e-4, f"rank {rank}")


def test_fsdp_tp_column_split_tracks_replicate(work):
    d, _ = work
    for rank in range(2):
        rep = load(d, "tensor_replicate", rank)
        tp = load(d, "tensor_fsdp_tp", rank)
        assert "P(None, 'tensor')" in list(tp["specs"])
        np.testing.assert_allclose(tp["loss"], rep["loss"], rtol=1e-6)
        _state_close(tp, rep, 1e-6, f"rank {rank}")


def test_cross_mesh_checkpoint_resume_bit_identical(work):
    d, _ = work
    for rank in range(4):
        on4 = load(d, "on_fsdp4", rank)
        assert int(on4["step"]) == 2 and int(on4["epoch"]) == 1
        assert list(on4["local_shape"]) == [8, 1024]  # 1/4 of (8, 4096)
    for rank in range(2):
        full, resumed = load(d, "fsdp", rank), load(d, "resumed", rank)
        assert int(resumed["step"]) == 4
        np.testing.assert_array_equal(resumed["loss"], full["loss"][2:])
        _state_equal(resumed, full, f"rank {rank}")


def test_port_save_restores_in_jax_on_fsdp4(work):
    d, _ = work
    jt = _jmlp_trainer(_jmesh({"data": 1, "fsdp": 4}))
    jt.load_weights(os.path.join(d, "ckpt_port"), tag="p")
    assert jt.state.step == 4
    got = _jax_state(jt)
    _state_equal(got, load(d, "fsdp", 0), "jax restore")
    four_way = [l for l in jax.tree_util.tree_leaves(jt.state.params)
                if l.sharding.spec != jax.sharding.PartitionSpec()]
    assert four_way


def test_jax_save_restores_on_port_ranks(work):
    d, ref = work
    for rank in range(2):
        got = load(d, "from_jax", rank)
        assert int(got["step"]) == 4
        _state_equal(got, ref["mlp_state"], f"rank {rank}")


@pytest.mark.parametrize("name", ["lm_tp", "lm_moe", "lm_ring"])
def test_transformer_lm_fit_on_mesh_matches_jax(work, name):
    d, ref = work
    ranks = 4 if name == "lm_tp" else 2
    for rank in range(ranks):
        got = load(d, name, rank)
        np.testing.assert_allclose(got["loss"], ref[name + "_loss"],
                                   rtol=1e-5)
        for k, want in ref[name + "_w"].items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-5,
                                       err_msg=f"{name} rank {rank}: {k}")
    if name == "lm_tp":
        # both attention layers and both MLPs computed on their blocks
        assert int(load(d, "lm_tp_split", 0)["n"]) == 6
    if name == "lm_moe":
        assert int(load(d, "moe_fallbacks", 0)["n"]) == 0


def test_evaluate_and_predict_on_rank_rows_match_jax(work):
    """Each rank evaluates its shard_by_process rows (the wrapped filler
    masked) and the metrics are added over the ranks: the JAX trainer's
    results over all 49 rows; each rank predicts its own rows."""
    d, ref = work
    for rank in range(2):
        got = load(d, "evaluate", rank)
        assert bool(got["valid"]) == (rank == 1)
        assert set(ref["evaluate"]) <= set(got)
        for k, want in ref["evaluate"].items():
            assert float(got[k]) == pytest.approx(want, rel=1e-6, abs=1e-7)
        np.testing.assert_allclose(got["pred"], ref["predict"][rank::2],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["clip", "lamb"])
def test_norms_count_whole_leaves_under_fsdp(work, name):
    """Clipping by the global norm and lamb's per-leaf trust ratios see
    each split leaf whole: fsdp tracks replicate at 1e-6."""
    d, _ = work
    for rank in range(2):
        rep = load(d, f"{name}_replicate", rank)
        fs = load(d, f"{name}_fsdp", rank)
        np.testing.assert_allclose(fs["loss"], rep["loss"], rtol=1e-6)
        _state_close(fs, rep, 1e-6, f"{name} rank {rank}")


def test_strategy_env_knob_and_argument(monkeypatch):
    """``ZOO_TRAIN_STRATEGY`` names the strategy when the constructor
    does not, as in the JAX package; the argument wins."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import (objectives,
                                                            optimizers)
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.train.trainer import Trainer
    m = Sequential(device="cpu")
    m.add(L.Dense(2, input_shape=(3,)))
    loss, opt = objectives.get("mse"), optimizers.get("sgd")
    monkeypatch.setenv("ZOO_TRAIN_STRATEGY", "fsdp")
    assert Trainer(m, loss, opt).strategy == "fsdp"
    assert Trainer(m, loss, opt, strategy="tp").strategy == "tp"
    monkeypatch.delenv("ZOO_TRAIN_STRATEGY")
    assert Trainer(m, loss, opt).strategy == "replicate"


# the global-batch layers on {data 2}: each rank's half of every global
# batch differs in distribution, so a rank's own statistics (or routing)
# are not the batch's
def bn_data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    second = shard_rows(64, 32, 1, 2)
    x[second] = x[second] * 2.5 + 3.0
    return x, rng.integers(0, 4, 64).astype(np.int32)


def uneven_tokens():
    # rank 0's rows count up through the low half of the vocabulary,
    # rank 1's through the high half: the router sends the two halves to
    # different experts, so their queues fill unevenly
    tx, ty = tokens(n=64)
    second = shard_rows(64, 32, 1, 2)
    return (np.where(np.isin(np.arange(64), second)[:, None],
                     tx % 6 + 6, tx % 6).astype(np.int32),
            np.where(np.isin(np.arange(64), second)[:, None],
                     ty % 6 + 6, ty % 6).astype(np.int32))


MOE_DP = dict(moe_every=2, n_experts=4, capacity_factor=1.0)
#: the evaluate/predict set: 40 rows in global batches of 32, so the
#: tail's 8 rows all fall on rank 0 and rank 1 has one batch fewer
EVAL_N = 40


def _jbn_model():
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        Activation as JActivation, BatchNormalization as JBN)
    m = JSequential()
    # no bias before the BatchNorm: its gradient is rounding noise that
    # adam turns into lr-sized steps
    m.add(JDense(16, input_shape=(8,), bias=False, name="hid"))
    m.add(JBN(name="bn"))
    m.add(JActivation("relu"))
    m.add(JDense(4, activation="softmax", name="out"))
    return m


@pytest.fixture(scope="module")
def repairs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp_repairs"))
    with open(os.path.join(d, "inputs.py"), "w") as f:
        f.write(INPUTS + "\n" + textwrap.dedent(
            __import__("inspect").getsource(bn_data)) + "\n"
            + textwrap.dedent(
                __import__("inspect").getsource(uneven_tokens)))
    ref = {}
    x, y = bn_data()
    jt = JTrainer(_jbn_model().to_graph(),
                  jobj.get("sparse_categorical_crossentropy"),
                  optax.adam(1e-3), mesh=_jmesh({"data": 2}),
                  strategy="replicate", seed=0)
    jt.ensure_initialized()
    np.savez(os.path.join(d, "bn_w0.npz"),
             **_flat(jax.device_get(jt.state.params)))
    ref["bn_loss"] = jt.fit(JDataset.from_ndarray(x, y), batch_size=32,
                            end_trigger=jtrig.MaxIteration(4),
                            shuffle=False)["loss"]
    ref["bn_state"] = _jax_state(jt)
    tx, ty = uneven_tokens()
    jm = JaxLM(**SMALL, **MOE_DP)
    jm.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll",
               mesh=_jmesh({"data": 2}))
    np.savez(os.path.join(d, "moe_dp_w0.npz"), **_flat(jm.get_weights()))
    # evaluate and predict from the same weights, on a model of their own
    je = JaxLM(**SMALL, **MOE_DP)
    je.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll",
               mesh=_jmesh({"data": 2}))
    je.set_weights(jm.get_weights())
    ref["moe_eval"] = je.evaluate(tx[:EVAL_N], ty[:EVAL_N], batch_size=32)
    ref["moe_pred"] = je.predict(tx[:EVAL_N], batch_size=32)
    ref["moe_loss"] = jm.fit(tx, ty, batch_size=32, nb_epoch=1,
                             shuffle=False)["loss"]
    ref["moe_state"] = _jax_state(jm.trainer)
    run_pod(d, 2, POD_DP)
    return d, ref


POD_DP = f"EVAL_N = {EVAL_N}\n" + """
sys.path.insert(0, OUT)
from inputs import bn_data, uneven_tokens
data2 = create_mesh({"data": 2}, device="cpu")
rows = shard_rows(64, 32, data_index(data2), dp_size(data2))

x, y = bn_data()
from analytics_zoo_tpu_torch.ops import batchnorm as bn_ops
for form in ("closed", "naive", "remat"):
    bn_ops.set_naive_bn(form == "naive")
    m = Sequential(device="cpu", seed=0)
    m.add(L.Dense(16, input_shape=(8,), bias=False, name="hid"))
    m.add(L.BatchNormalization(name="bn"))
    m.layers[-1].remat = form == "remat"
    m.add(L.Activation("relu"))
    m.add(L.Dense(4, activation="softmax", name="out"))
    from_jax_params(m, nest(load_npz(os.path.join(OUT, "bn_w0.npz"))))
    t = Trainer(m, objectives.get("sparse_categorical_crossentropy"),
                optimizers.get({"name": "adam", "lr": 1e-3}), mesh=data2,
                strategy="replicate")
    loss = t.fit(Dataset.from_ndarray(x[rows], y[rows]), batch_size=32,
                 end_trigger=triggers.MaxIteration(4),
                 shuffle=False)["loss"]
    save(f"bn_dp_{form}", loss=np.asarray(loss), **state_arrays(t))
bn_ops.set_naive_bn(False)

tx, ty = uneven_tokens()


def moe_lm(remat=False):
    lm = TransformerLM(vocab_size=12, seq_len=24, n_layers=2, d_model=32,
                       n_heads=2, moe_every=2, n_experts=4,
                       capacity_factor=1.0, remat=remat, device="cpu")
    from_jax_params(lm, nest(load_npz(os.path.join(OUT, "moe_dp_w0.npz"))))
    lm.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll",
               mesh=data2)
    return lm


for name, remat in (("moe_dp", False), ("moe_dp_remat", True)):
    lm = moe_lm(remat)
    loss = lm.fit(tx[rows], ty[rows], batch_size=32, nb_epoch=1,
                  shuffle=False)["loss"]
    save(name, loss=np.asarray(loss), **state_arrays(lm.trainer))

# evaluate and predict: rank 0 holds 24 rows (a full batch and the
# tail's 8), rank 1 16 (one batch)
ev_rows = shard_rows(64, 32, data_index(data2), dp_size(data2))
ev_rows = ev_rows[ev_rows < EVAL_N]
lm = moe_lm()
res = lm.evaluate(tx[ev_rows], ty[ev_rows], batch_size=32)
save("moe_dp_eval", rows=ev_rows, pred=lm.predict(tx[ev_rows], batch_size=32),
     **{k: np.asarray(v) for k, v in res.items()})
"""


def _model_state_close(got, want, atol, what):
    keys = [k for k in want if k.startswith("model_state/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("form", ["closed", "naive", "remat"])
def test_batchnorm_on_data_axes_takes_global_batch_statistics(repairs,
                                                              form):
    """BatchNormalization under a {data 2} plan normalises by the global
    batch's statistics, as the JAX package does under jit, in the closed
    form, in the plain one (``set_naive_bn``) and in the closed form
    under remat (its recompute in the backward reduces over the ranks
    as its forward did): the losses, weights,
    moments and moving statistics of a 4-step fit match the JAX Trainer
    on {data 2} at 1e-5, and both ranks hold the same moving
    statistics."""
    d, ref = repairs
    got = [load(d, f"bn_dp_{form}", rank) for rank in range(2)]
    for rank, g in enumerate(got):
        np.testing.assert_allclose(g["loss"], ref["bn_loss"], rtol=1e-5)
        _state_close(g, ref["bn_state"], 1e-5, f"bn rank {rank}")
        _model_state_close(g, ref["bn_state"], 1e-5, f"bn rank {rank}")
    for k in ref["bn_state"]:
        if k.startswith("model_state/"):
            np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def _moe_fit_matches_jax(repairs, name):
    d, ref = repairs
    for rank in range(2):
        g = load(d, name, rank)
        np.testing.assert_allclose(g["loss"], ref["moe_loss"], rtol=1e-5)
        _state_close(g, ref["moe_state"], 1e-5, f"moe rank {rank}")
        _model_state_close(g, ref["moe_state"], 1e-5, f"moe rank {rank}")


def test_switch_moe_on_data_axes_routes_the_global_batch(repairs):
    """Switch-MoE replicated on {data 2}, with a router that sends the
    two ranks' tokens to different experts at capacity factor 1: the
    capacity and the kept tokens are the global batch's and the aux loss
    takes the global routing statistics, so the fit (losses, weights,
    the aux loss state) matches the JAX package on {data 2} at 1e-5."""
    _moe_fit_matches_jax(repairs, "moe_dp")


def test_switch_moe_on_data_axes_under_remat(repairs):
    """The same fit with the TransformerLM's sublayers under remat: the
    recompute in the backward routes the global batch as the forward
    did, so the fit still matches the JAX package at 1e-5."""
    _moe_fit_matches_jax(repairs, "moe_dp_remat")


def test_switch_moe_on_data_axes_evaluate_and_predict(repairs):
    """``evaluate`` and ``predict`` of the MoE TransformerLM on {data 2}
    route the global batch, padded tail included, as the JAX package
    does: rank 0 holds the tail's 8 rows and rank 1 one batch fewer, so
    rank 1 runs a batch of padding alone (no rank waits in a collective
    the other never joins).  The metrics over both ranks match the JAX
    package's at 1e-5, and each rank's predictions its rows of the JAX
    package's at 1e-5."""
    d, ref = repairs
    for rank in range(2):
        g = load(d, "moe_dp_eval", rank)
        assert len(g["rows"]) == (24 if rank == 0 else 16)
        assert set(ref["moe_eval"]) <= set(g)
        for k, want in ref["moe_eval"].items():
            assert float(g[k]) == pytest.approx(want, rel=1e-5)
        np.testing.assert_allclose(g["pred"], ref["moe_pred"][g["rows"]],
                                   rtol=1e-5, atol=1e-6)
