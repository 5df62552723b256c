"""The port's training slice against the JAX package's.

Losses, metrics, optimizer updates, batch order and triggers are held
against their JAX counterparts on the same numpy inputs; then the whole
slice: a JAX ``TransformerLM`` compiled with adam and fitted for two
shuffled epochs, and the port loaded with the same initial weights
(``from_jax_params(lm.get_weights())``) and fitted alike.  Per-step
losses agree within 1e-5 relative, final parameters within 1e-4 absolute
and ``evaluate`` within 1e-5 (f32 on the CPU; sums run in another order).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from analytics_zoo_tpu.data.dataset import Dataset as JDataset
from analytics_zoo_tpu.models import TransformerLM as JaxLM
from analytics_zoo_tpu.pipeline.api.keras import metrics as jmetrics
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.train import triggers as jtrig
from analytics_zoo_tpu_torch.data.dataset import Dataset
from analytics_zoo_tpu_torch.models import TransformerLM, from_jax_params
from analytics_zoo_tpu_torch.pipeline.api.keras import metrics, objectives
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers
from analytics_zoo_tpu_torch.train import triggers
from analytics_zoo_tpu_torch.train.trainer import Trainer, build_train_step


def periodic_tokens(n=96, vocab=12, seq=24, seed=0):
    """The periodic next-token task of tests/test_transformer_lm.py."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 4, n)
    start = rng.integers(0, vocab, n)
    toks = (start[:, None] + steps[:, None]
            * np.arange(seq + 1)[None, :]) % vocab
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


# ---- losses --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 5), (1, 3), (1, 3, 1), (6,), (2, 1)])
def test_class_nll_matches_jax(shape):
    rng = np.random.default_rng(1)
    lead = shape[:-1] if shape[-1] == 1 and len(shape) == 3 else shape
    logits = rng.normal(size=lead + (7,)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    y = rng.integers(0, 7, shape)
    ref = np.asarray(jobj.class_nll(jnp.asarray(y), jnp.asarray(logp)))
    out = objectives.class_nll(torch.from_numpy(y), torch.from_numpy(logp))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    probs = np.exp(logp)
    ref = np.asarray(jobj.sparse_categorical_crossentropy(
        jnp.asarray(y), jnp.asarray(probs)))
    out = objectives.sparse_categorical_crossentropy(
        torch.from_numpy(y), torch.from_numpy(probs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)


def test_class_nll_label_base_and_guard_match_jax():
    logp = np.log(np.full((2, 3, 4), 0.25, np.float32))
    y = np.array([[1, 4, 0], [2, 3, 5]])   # 1-based: 0 and 5 are invalid
    ref = np.asarray(jobj.ClassNLLCriterion(zero_based_label=False)(
        jnp.asarray(y), jnp.asarray(logp)))
    crit = objectives.ClassNLLCriterion(zero_based_label=False)
    out = crit(torch.from_numpy(y), torch.from_numpy(logp)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out[~np.isnan(out)], ref[~np.isnan(ref)])
    assert objectives.get(crit) is crit
    assert objectives.get("class_nll") is objectives.class_nll


def test_unported_losses_and_metrics_raise():
    """Every loss and metric name the JAX package resolves resolves here
    to the counterpart of the same name; only unknown names raise."""
    for name, fn in jobj._LOSSES.items():
        assert objectives.get(name).__name__ == fn.__name__, name
    with pytest.raises(ValueError, match="Unknown loss"):
        objectives.get("nope")
    for name in ("accuracy", "acc", "top5accuracy", "top5", "top5acc",
                 "auc", "mae", "hitratio", "hit_ratio", "hitrate", "ndcg"):
        ours, ref = metrics.get(name), jmetrics.get(name)
        assert (type(ours).__name__, ours.name) == (type(ref).__name__,
                                                    ref.name), name
    with pytest.raises(ValueError, match="Unknown metric"):
        metrics.get("nope")


# ---- metrics -------------------------------------------------------------

@pytest.mark.parametrize("zero_based", [True, False])
def test_accuracy_and_loss_metrics_match_jax_with_mask(zero_based):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5, 6, 4)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    y = rng.integers(0, 4, (5, 6)) + (0 if zero_based else 1)
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    loss_j = jobj.ClassNLLCriterion(zero_based_label=zero_based)
    loss_t = objectives.ClassNLLCriterion(zero_based_label=zero_based)
    pairs = [(jmetrics.get("accuracy", zero_based_label=zero_based),
              metrics.get("accuracy", zero_based_label=zero_based)),
             (jmetrics.Loss(loss_j), metrics.Loss(loss_t))]
    for jm, tm in pairs:
        ja, ta = jm.init(), tm.init()
        for lo, hi in ((0, 3), (3, 5)):
            ja = jm.update(ja, jnp.asarray(y[lo:hi]), jnp.asarray(logp[lo:hi]),
                           jnp.asarray(mask[lo:hi]))
            ta = tm.update(ta, torch.from_numpy(y[lo:hi]),
                           torch.from_numpy(logp[lo:hi]),
                           torch.from_numpy(mask[lo:hi]))
        assert tm.name == jm.name
        np.testing.assert_allclose(tm.result(ta), float(jm.result(ja)),
                                   rtol=1e-6)


# ---- optimizers ----------------------------------------------------------

OPT_CASES = [
    ({"name": "adam", "lr": 3e-3}, None, None),
    ("adam", None, None),
    ({"name": "adam", "lr": 1e-2, "b1": 0.8, "eps": 1e-6}, None, None),
    ({"name": "sgd", "lr": 0.1}, None, None),
    ({"name": "sgd", "lr": 0.1, "momentum": 0.9}, None, None),
    ({"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True},
     None, None),
    ({"name": "sgd", "lr": 0.1, "decay": 0.5}, None, None),
    ({"name": "adam", "lr": 1e-2, "decay": 0.1}, 0.5, None),
    ({"name": "sgd", "lr": 0.1, "momentum": 0.5}, None, (-0.3, 0.2)),
    ({"name": "adam", "lr": 3e-3}, 1.0, (-0.5, 0.5)),
]


@pytest.mark.parametrize("spec,clip_norm,clip_value", OPT_CASES)
def test_optimizer_updates_match_optax(spec, clip_norm, clip_value):
    """Five updates from the same params and gradient stream."""
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (3,), (2, 2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 2, size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    jo = jopt.get(spec, clip_norm=clip_norm, clip_value=clip_value)
    jp = [jnp.asarray(p) for p in params]
    js = jo.init(jp)
    to = optimizers.get(spec, clip_norm=clip_norm, clip_value=clip_value)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = to.init(tp)
    for step, g in enumerate(grads):
        upd, js = jo.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        to.apply(tp, [torch.from_numpy(a) for a in g], ts)
        assert to.lr_fn(step) == pytest.approx(float(jo.lr_fn(step)))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-7)
    assert ts.count == 5


def test_unported_optimizers_raise():
    """Every optimizer name resolves to optax's transforms in optax's
    order, with the JAX package's default rate; unknown names and
    options raise."""
    rate = "ScaleByLearningRate"
    chains = {"sgd": [rate], "adam": ["ScaleByAdam", rate],
              "adamax": ["ScaleByAdamax", rate], "adagrad": ["ScaleByRss",
                                                             rate],
              "adadelta": ["ScaleByAdadelta", rate],
              "rmsprop": ["ScaleByRms", rate],
              "adamw": ["ScaleByAdam", "AddDecayedWeights", rate],
              "lamb": ["ScaleByAdam", "ScaleByTrustRatio", rate],
              "lars": ["ScaleByTrustRatio", rate, "Trace"]}
    assert set(chains) == set(optimizers.DEFAULTS)
    for name, kinds in chains.items():
        opt = optimizers.get(name)
        assert [type(t).__name__ for t in opt.transforms] == kinds, name
        assert opt.lr_fn(0) == pytest.approx(jopt.get(name).lr_fn(0))
    with pytest.raises(ValueError, match="Unknown optimizer"):
        optimizers.get("nope")
    with pytest.raises(TypeError, match="unknown options"):
        optimizers.get({"name": "adam", "amsgrad": True})


# ---- data and triggers ---------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 1, 5])
@pytest.mark.parametrize("drop", [True, False])
def test_dataset_batch_order_matches_jax(epoch, drop):
    x = np.arange(23 * 2).reshape(23, 2)
    y = np.arange(23)
    ref = list(JDataset.from_ndarray(x, y).batches(
        5, shuffle=True, seed=7, epoch=epoch, drop_remainder=drop))
    out = list(Dataset.from_ndarray(x, y).batches(
        5, shuffle=True, seed=7, epoch=epoch, drop_remainder=drop))
    assert len(out) == len(ref) == (4 if drop else 5)
    for (bx, by), (rx, ry) in zip(out, ref):
        np.testing.assert_array_equal(bx, rx)
        np.testing.assert_array_equal(by, ry)
    assert Dataset.from_ndarray(x, y).size == 23
    with pytest.raises(ValueError, match="share length"):
        Dataset.from_ndarray(x, y[:5])


def test_triggers_match_jax():
    records = [{"epoch": e, "iteration": i, "epoch_finished": f, "loss": l}
               for e in (0, 2, 3) for i in (0, 6, 8) for f in (False, True)
               for l in (0.4, 2.0)]
    pairs = [(jtrig.EveryEpoch(), triggers.EveryEpoch()),
             (jtrig.MaxEpoch(3), triggers.Trigger.max_epoch(3)),
             (jtrig.MaxIteration(8), triggers.Trigger.max_iteration(8)),
             (jtrig.SeveralIteration(3), triggers.Trigger.several_iteration(3)),
             (jtrig.MinLoss(0.5), triggers.MinLoss(0.5))]
    for j, t in pairs:
        assert [bool(j(r)) for r in records] == [t(r) for r in records]
    assert triggers.MinLoss(0.5)({"loss": torch.tensor(0.25)})


# ---- the slice -----------------------------------------------------------

SMALL = dict(vocab_size=12, seq_len=24, n_layers=2, d_model=32, n_heads=2)


@pytest.mark.parametrize("implementation", ["auto", "flash"])
def test_compile_fit_evaluate_follows_jax(implementation):
    """adam 3e-3, two shuffled epochs of batch 32, then evaluate with a
    padded tail (96 = 2 * 40 + 16)."""
    x, y = periodic_tokens()
    jm = JaxLM(**SMALL, implementation=implementation)
    jm.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll",
               metrics=["accuracy"])
    tm = TransformerLM(**SMALL, implementation=implementation, device="cpu")
    from_jax_params(tm, jm.get_weights())
    tm.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll",
               metrics=["accuracy"])
    ref = jm.fit(x, y, batch_size=32, nb_epoch=2)
    out = tm.fit(x, y, batch_size=32, nb_epoch=2)
    assert len(out["loss"]) == len(ref["loss"]) == 6
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5, atol=0)
    assert out["loss"][-1] < out["loss"][0]
    ref_w, own_w = jm.get_weights(), tm.get_weights()
    for layer, leaves in own_w.items():
        for key, a in leaves.items():
            np.testing.assert_allclose(a, np.asarray(ref_w[layer][key]),
                                       rtol=0, atol=1e-4,
                                       err_msg=f"{layer}/{key}")
    ref_e = jm.evaluate(x, y, batch_size=40)
    out_e = tm.evaluate(x, y, batch_size=40)
    assert set(out_e) == set(ref_e) == {"accuracy", "loss"}
    for key in ref_e:
        assert out_e[key] == pytest.approx(ref_e[key], rel=1e-5, abs=1e-5)


def test_incremental_fit_continues_epochs_and_validates():
    """Two fits of one epoch give the batches of one fit of two (the
    shuffle seeds on the epoch), and validation runs once per epoch."""
    x, y = periodic_tokens(n=64)
    a = TransformerLM(**SMALL, device="cpu", seed=5)
    b = TransformerLM(**SMALL, device="cpu", seed=5)
    for m in (a, b):
        m.compile("adam", "class_nll", metrics=["acc"], seed=3)
    h1 = a.fit(x, y, batch_size=16, nb_epoch=1)["loss"]
    h1 += a.fit(x, y, batch_size=16, nb_epoch=1)["loss"]
    h2 = b.fit(x, y, batch_size=16, nb_epoch=2, validation_data=(x, y))
    assert h1 == h2["loss"]
    assert [v["epoch"] for v in h2["val"]] == [1, 2]
    assert set(h2["val"][0]) == {"epoch", "accuracy", "loss"}
    assert a.trainer.state.epoch == 2 and a.trainer.state.step == 8


def test_dropout_only_in_fit():
    x, y = periodic_tokens(n=16)
    lm = TransformerLM(**SMALL, dropout=0.5, device="cpu")
    modes = []
    lm.drop.register_forward_hook(lambda m, i, o: modes.append(m.training))
    lm.compile("adam", "class_nll", metrics=["accuracy"])
    lm.fit(x, y, batch_size=8, nb_epoch=1)
    assert modes and all(modes)
    modes.clear()
    e1, e2 = lm.evaluate(x, y, 16), lm.evaluate(x, y, 16)
    p1, p2 = lm.predict(x, 5), lm.predict(x, 16)
    assert modes and not any(modes)
    assert e1 == e2
    np.testing.assert_array_equal(p1, p2)
    lm.generate(x[:2, :4], 3)


def test_lifecycle_errors_and_clipping():
    x, y = periodic_tokens(n=8)
    lm = TransformerLM(**SMALL, device="cpu")
    with pytest.raises(RuntimeError, match="compiled"):
        lm.fit(x, y)
    with pytest.raises(RuntimeError, match="compiled"):
        lm.evaluate(x, y)
    assert lm.predict(x, 4).shape == (8, 24, 12)
    lm.compile("sgd", "class_nll", compute_dtype=torch.bfloat16)
    assert len(lm.fit(x, y, batch_size=4)["loss"]) == 2
    assert all(p.dtype == torch.float32 for p in lm.parameters())
    step = build_train_step(lm, objectives.class_nll, optimizers.get("sgd"),
                            accum_steps=3)
    with pytest.raises(ValueError, match="accum_steps"):
        step(lm.trainer.state, torch.from_numpy(x[:4]),
             torch.from_numpy(y[:4]))
    lm.set_constant_gradient_clipping(-0.1, 0.2)
    lm.set_gradient_clipping_by_l2_norm(1.0)
    lm.compile("sgd", "class_nll")
    kinds = [type(t).__name__ for t in lm.trainer.optimizer.transforms]
    assert kinds == ["Clip", "ClipByGlobalNorm", "ScaleByLearningRate"]
    lm.clear_gradient_clipping()
    lm.compile("sgd", "class_nll")
    assert len(lm.trainer.optimizer.transforms) == 1


def test_weights_round_trip_and_evaluate_override():
    x, y = periodic_tokens(n=8)
    a = TransformerLM(**SMALL, device="cpu", seed=1)
    b = TransformerLM(**SMALL, device="cpu", seed=2)
    b.set_weights(a.get_weights())
    np.testing.assert_array_equal(a.predict(x), b.predict(x))
    trainer = Trainer(b, objectives.class_nll, optimizers.get("sgd"))
    res = trainer.evaluate(Dataset.from_ndarray(x, y), 3,
                           metrics=["accuracy"])
    assert set(res) == {"accuracy", "loss"}
    np.testing.assert_array_equal(trainer.predict(x, 3), b.predict(x))
