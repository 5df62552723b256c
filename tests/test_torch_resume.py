"""Crash and resume of the port's trainer (iteration-trigger snapshots,
``ZOO_RESUME``, the mid-epoch fast-forward), against its own
uninterrupted run and against the JAX package.

Counterparts of ``tests/test_trainer_hotloop.py:155-300`` (a crash at
step 6 resumed bit for bit; a snapshot on the epoch's end with verbose;
a torn first save and an empty directory are cold starts) and of
``test_keras_fit_auto_resume``; here also with dropout 0.1 and with
``accum_steps=2``: dropout draws from generators seeded by (seed, step,
microbatch, layer) at every step, so the resumed run draws the masks of
the uninterrupted one.  A corrupt newest tag (``ZOO_FAULT_CORRUPT_TAG``)
falls back to the previous complete one.  And the JAX package resumes
from the port's snapshot to the parameters of its own uninterrupted run.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core.module import name_scope as jname_scope
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.core.module import name_scope
from analytics_zoo_tpu_torch.data.dataset import Dataset
from analytics_zoo_tpu_torch.models.jax_params import (from_jax_params,
                                                       to_jax_params)
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
from analytics_zoo_tpu_torch.train import checkpoint as ckpt
from analytics_zoo_tpu_torch.train import metrics as train_metrics
from analytics_zoo_tpu_torch.train import triggers

SGD = {"name": "sgd", "lr": 0.1, "momentum": 0.9}


def make_data(n, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, y


def build_mlp(dropout=0.0, accum=1, optimizer=SGD):
    with name_scope("mlp"):
        m = Sequential(device="cpu", seed=0)
        m.add(L.Dense(16, activation="relu", input_shape=(8,)))
        if dropout:
            m.add(L.Dropout(dropout))
        m.add(L.Dense(4))
    m.compile(optimizer, "sparse_categorical_crossentropy",
              accum_steps=accum)
    return m.trainer


def _same_params(a, b):
    for pa, pb in zip(a.state.params, b.state.params):
        assert torch.equal(pa, pb)


@pytest.fixture
def env(monkeypatch):
    for k in ("ZOO_RESUME", "ZOO_CKPT_SYNC", "ZOO_FAULT_CORRUPT_TAG",
              "ZOO_FAULT_CRASH_STEP", "ZOO_HEARTBEAT_FILE"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("dropout,accum", [(0.0, 1), (0.1, 1), (0.0, 2),
                                           (0.1, 2)])
def test_resume_after_crash_is_bit_identical(tmp_path, env, dropout,
                                             accum):
    """Crash at step 6 (mid-epoch 1: 4 steps an epoch), resume under
    ZOO_RESUME from the newest complete iteration snapshot (step 6,
    epoch step 2) in a new trainer: the same parameters, bit for bit,
    as the uninterrupted 12 steps."""
    ds = Dataset.from_ndarray(*make_data(64))
    full = build_mlp(dropout, accum)
    full.fit(ds, batch_size=16, end_trigger=triggers.MaxEpoch(3))

    path = str(tmp_path / "ckpt")
    env.setenv("ZOO_CKPT_SYNC", "1")
    crash = build_mlp(dropout, accum)
    crash.set_checkpoint(path, trigger=triggers.SeveralIteration(2))
    crash.fit(ds, batch_size=16, end_trigger=triggers.MaxIteration(6))
    assert ckpt.read_meta(path) == {"step": 6, "epoch": 1,
                                    "epoch_step": 2}

    env.setenv("ZOO_RESUME", "1")
    res = build_mlp(dropout, accum)
    res.set_checkpoint(path, trigger=triggers.SeveralIteration(2))
    hist = res.fit(ds, batch_size=16, end_trigger=triggers.MaxEpoch(3))
    assert len(hist["loss"]) == 6  # steps 7-12 replayed
    assert res.state.step == full.state.step == 12
    _same_params(full, res)


def test_corrupt_newest_tag_falls_back_to_the_previous(tmp_path, env):
    """ZOO_FAULT_CORRUPT_TAG=6 flips a byte of tag 6 after its commit:
    the resume discards it on its checksum, restores tag 4 (epoch 1,
    epoch step 0), replays steps 5-12 and ends where the uninterrupted
    run ends."""
    ds = Dataset.from_ndarray(*make_data(64))
    full = build_mlp(0.1)
    full.fit(ds, batch_size=16, end_trigger=triggers.MaxEpoch(3))
    path = str(tmp_path / "ckpt")
    env.setenv("ZOO_CKPT_SYNC", "1")
    env.setenv("ZOO_FAULT_CORRUPT_TAG", "6")
    crash = build_mlp(0.1)
    crash.set_checkpoint(path, trigger=triggers.SeveralIteration(2))
    crash.fit(ds, batch_size=16, end_trigger=triggers.MaxIteration(6))
    assert not ckpt.verify_commit(path, 6, deep=True)[0]
    env.setenv("ZOO_RESUME", "1")
    train_metrics.reset()
    res = build_mlp(0.1)
    res.set_checkpoint(path, trigger=triggers.SeveralIteration(2))
    hist = res.fit(ds, batch_size=16, end_trigger=triggers.MaxEpoch(3))
    assert len(hist["loss"]) == 8
    assert train_metrics.snapshot()["ckpt_restores"] == {
        "corrupt_discarded": 1, "ok": 1}
    _same_params(full, res)


def test_resume_at_epoch_boundary_with_verbose(tmp_path, env, capsys):
    """A snapshot on the exact end of epoch 0 (epoch step 4 of 4)
    replays an empty first epoch on resume; verbose prints its loss as
    n/a, and the run still ends bit-identical."""
    ds = Dataset.from_ndarray(*make_data(64))
    full = build_mlp()
    full.fit(ds, batch_size=16, end_trigger=triggers.MaxEpoch(2))
    path = str(tmp_path / "ckpt")
    env.setenv("ZOO_CKPT_SYNC", "1")
    crash = build_mlp()
    crash.set_checkpoint(path, trigger=triggers.SeveralIteration(4))
    crash.fit(ds, batch_size=16, end_trigger=triggers.MaxIteration(4))
    env.setenv("ZOO_RESUME", "1")
    res = build_mlp()
    res.set_checkpoint(path, trigger=triggers.SeveralIteration(4))
    res.fit(ds, batch_size=16, end_trigger=triggers.MaxEpoch(2),
            verbose=True)
    assert "loss n/a" in capsys.readouterr().out
    assert res.state.step == full.state.step == 8
    _same_params(full, res)


def test_resume_on_torn_first_save_is_cold_start(tmp_path, env):
    """A crash during the first save leaves a directory without any
    commit whose tag cannot restore: the resumed incarnation starts cold
    and trains on instead of crashing in turn."""
    import json
    path = tmp_path / "ckpt"
    path.mkdir()
    np.savez(str(path / "ckpt_2.shard-p0.npz"),
             **{"0|0:4,0:4": np.ones((4, 4), np.float32)})
    (path / "ckpt_2.json").write_text(json.dumps(
        {"format": "sharded", "tag": "2", "meta": {"step": 2},
         "n_processes": 2, "names": ["w"], "shapes": [[4, 4]],
         "dtypes": ["float32"]}))
    env.setenv("ZOO_RESUME", "1")
    train_metrics.reset()
    t = build_mlp()
    t.set_checkpoint(str(path))
    t.fit(Dataset.from_ndarray(*make_data(32)), batch_size=16,
          end_trigger=triggers.MaxEpoch(1))
    assert t.state.epoch == 1 and t.state.step == 2
    assert train_metrics.snapshot()["ckpt_restores"] == {"cold_start": 1}


def test_resume_env_without_checkpoint_is_cold_start(tmp_path, env):
    env.setenv("ZOO_RESUME", "1")
    t = build_mlp()
    t.set_checkpoint(str(tmp_path / "empty"))
    t.fit(Dataset.from_ndarray(*make_data(32)), batch_size=16,
          end_trigger=triggers.MaxEpoch(1))
    assert t.state.epoch == 1 and t.state.step == 2


def test_keras_fit_auto_resume(tmp_path, env):
    """fit(resume=True): a first run starts as usual; the same script
    run again after a crash restores the newest snapshot and trains
    ``nb_epoch`` more epochs; without set_checkpoint it is a usage
    error."""
    def make():
        m = Sequential(device="cpu")
        m.add(L.Dense(4, input_shape=(6,)))
        m.compile(optimizer="sgd", loss="mean_squared_error")
        m.set_checkpoint(str(tmp_path / "ckpt"))
        return m

    rs = np.random.RandomState(0)
    x = rs.rand(64, 6).astype(np.float32)
    y = rs.rand(64, 4).astype(np.float32)
    m1 = make()
    m1.fit(x, y, batch_size=16, nb_epoch=2, resume=True)
    assert m1.trainer.state.epoch == 2
    m2 = make()
    m2.fit(x, y, batch_size=16, nb_epoch=3, resume=True)
    assert m2.trainer.state.epoch == 5
    m3 = Sequential(device="cpu")
    m3.add(L.Dense(4, input_shape=(6,)))
    m3.compile(optimizer="sgd", loss="mean_squared_error")
    with pytest.raises(ValueError, match="set_checkpoint"):
        m3.fit(x, y, batch_size=16, nb_epoch=1, resume=True)


def test_learning_rate_scalar_per_step(tmp_path, env):
    """The LearningRate summary scalar of every step (the JAX package's
    fit writes it; the decayed rate the step used)."""
    from analytics_zoo_tpu_torch.train.summary import read_scalars
    t = build_mlp(optimizer={"name": "sgd", "lr": 0.1, "decay": 0.5})
    t.set_tensorboard(str(tmp_path / "logs"), "app")
    t.fit(Dataset.from_ndarray(*make_data(32)), batch_size=16,
          end_trigger=triggers.MaxEpoch(1))
    rates = read_scalars(str(tmp_path / "logs"), "app", "LearningRate")
    assert [s for s, _ in rates] == [1, 2]
    np.testing.assert_allclose([v for _, v in rates], [0.1, 0.1 / 1.5],
                               rtol=1e-6)


def test_jax_resumes_from_a_port_snapshot(tmp_path, env):
    """Two ways.  Exact: the port restores the JAX package's step-4
    snapshot under ZOO_RESUME, trains nothing new and writes its own
    snapshot of that state at step 4 (epoch 1, epoch step 0); a JAX
    trainer resumes from the port's file and ends bit for bit on the
    JAX package's uninterrupted 12 steps.  Trained: the port trains
    steps 1-6 from the JAX model's initial weights and snapshots every
    2; the JAX trainer resumes from the port's step 6 and ends within
    2e-5 of its uninterrupted run: the two packages' own 12-step runs
    differ by 9.8e-6 here (their f32 forward and backward agree to
    ~4e-7 a step, and sgd with momentum 0.9 carries it on)."""
    import jax
    import optax
    from analytics_zoo_tpu.data.dataset import Dataset as JDataset
    from analytics_zoo_tpu.pipeline.api.keras import objectives
    from analytics_zoo_tpu.train import triggers as jtriggers
    from analytics_zoo_tpu.train.trainer import Trainer as JTrainer

    x, y = make_data(64)

    def jax_trainer():
        with jname_scope("mlp"):
            m = JSequential()
            m.add(JL.Dense(16, activation="relu", input_shape=(8,)))
            m.add(JL.Dense(4))
        return JTrainer(m.to_graph(),
                        objectives.get("sparse_categorical_crossentropy"),
                        optax.sgd(0.1, momentum=0.9), seed=0)

    def jfit(t, trigger):
        t.fit(JDataset.from_ndarray(x, y), batch_size=16,
              end_trigger=trigger)

    def params(t):
        return jax.device_get(t.state.params)

    jfull = jax_trainer()
    jfull.ensure_initialized()
    init = jax.device_get(jfull.state.params)
    jfit(jfull, jtriggers.MaxEpoch(3))
    want = params(jfull)

    env.setenv("ZOO_CKPT_SYNC", "1")
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    j4 = jax_trainer()
    j4.set_checkpoint(jpath, trigger=jtriggers.SeveralIteration(4))
    jfit(j4, jtriggers.MaxIteration(4))
    env.setenv("ZOO_RESUME", "1")
    port = build_mlp()
    port.set_checkpoint(jpath)
    port.fit(Dataset.from_ndarray(x, y), batch_size=16,
             end_trigger=triggers.MaxIteration(4))
    assert port.state.step == 4
    ckpt.save_sharded(ppath, 4, port.state_tree(),
                      meta=ckpt.read_meta(jpath, 4))
    jres = jax_trainer()
    jres.set_checkpoint(ppath, trigger=jtriggers.SeveralIteration(4))
    jfit(jres, jtriggers.MaxEpoch(3))
    got = params(jres)
    for k in want:
        for n in want[k]:
            np.testing.assert_array_equal(np.asarray(got[k][n]),
                                          np.asarray(want[k][n]))

    env.delenv("ZOO_RESUME")
    port = build_mlp()
    from_jax_params(port.model, init)
    ppath = str(tmp_path / "trained")
    port.set_checkpoint(ppath, trigger=triggers.SeveralIteration(2))
    port.fit(Dataset.from_ndarray(x, y), batch_size=16,
             end_trigger=triggers.MaxIteration(6))
    env.setenv("ZOO_RESUME", "1")
    jres = jax_trainer()
    jres.set_checkpoint(ppath, trigger=jtriggers.SeveralIteration(2))
    jfit(jres, jtriggers.MaxEpoch(3))
    assert jres.state.step == 12
    got = params(jres)
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(np.asarray(got[k][n]),
                                       np.asarray(want[k][n]), rtol=0,
                                       atol=2e-5, err_msg=f"{k}/{n}")
    assert set(to_jax_params(port.model)) == set(want)


def test_summary_trigger_set_before_compile_gates_the_scalar(tmp_path, env):
    """set_summary_trigger before compile and set_tensorboard: applied
    once the TrainSummary exists (the JAX package's
    _apply_summary_triggers)."""
    from analytics_zoo_tpu_torch.train.summary import read_scalars
    x, y = make_data(64)
    m = Sequential(device="cpu")
    m.add(L.Dense(4, input_shape=(8,)))
    m.set_summary_trigger("Loss", triggers.SeveralIteration(2))
    m.set_tensorboard(str(tmp_path / "logs"), "app")
    m.compile("sgd", "sparse_categorical_crossentropy")
    m.fit(x, y, batch_size=16, nb_epoch=1)
    loss = read_scalars(str(tmp_path / "logs"), "app", "Loss")
    assert [s for s, _ in loss] == [2, 4]


def test_and_or_triggers():
    a, b = triggers.MaxEpoch(2), triggers.SeveralIteration(3)
    both, either = triggers.And(a, b), triggers.Or(a, b)
    assert both({"epoch": 2, "iteration": 6})
    assert not both({"epoch": 1, "iteration": 6})
    assert either({"epoch": 1, "iteration": 6})
    assert not either({"epoch": 1, "iteration": 5})


def test_env_contract_matches_the_jax_package(env):
    """The port's copy of envcontract.py declares the JAX package's
    variables and parses them the same way."""
    from analytics_zoo_tpu import envcontract as jenv
    from analytics_zoo_tpu_torch import envcontract as tenv
    assert set(tenv.VARS) == set(jenv.VARS)
    env.setenv("ZOO_FAULT_CRASH_RANK", "x")
    env.setenv("ZOO_RESTART_COUNT", "")
    for mod in (tenv, jenv):
        assert mod.env_int("ZOO_FAULT_CRASH_RANK", 1) == 1
        assert mod.env_str("ZOO_RESTART_COUNT", "d") == "d"
        assert not mod.env_flag("ZOO_RESUME")
        with pytest.raises(KeyError, match="undeclared"):
            mod.env_str("ZOO_NOT_A_KNOB")
