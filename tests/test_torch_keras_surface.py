"""The port's optimizers, losses and metrics against the JAX package's.

Every optimizer name, with and without both clippings: five updates from
the same parameters and gradient stream against ``optax``, within atol
2e-7 (``test_optimizer_updates_match_optax``'s bound).  Every loss and
its class form: per-sample values on the same inputs within 1e-6
relative.  ``AUC``, ``MAE``, ``HitRatio`` and ``NDCG`` accumulated over
two masked batches, within 1e-6.  Then the counterparts of
``tests/test_ranking_metrics.py`` (all but the NCF evaluation, which
waits for the recommendation models).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import optax

from analytics_zoo_tpu.pipeline.api.keras import metrics as jmetrics
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu_torch.pipeline.api.keras import (metrics,
                                                        objectives,
                                                        optimizers)
from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import (HitRatio,
                                                                NDCG, get)

# ---- optimizers ----------------------------------------------------------

CLIPS = [(None, None), (0.5, (-0.3, 0.4))]
SPECS = [
    "adamax", "adagrad", "adadelta", "rmsprop", "adamw", "lamb", "lars",
    {"name": "adamax", "lr": 1e-2, "b1": 0.8, "eps": 1e-6},
    {"name": "adagrad", "lr": 3e-3, "initial_accumulator_value": 0.5},
    {"name": "adadelta", "lr": 0.5, "rho": 0.8, "weight_decay": 1e-2},
    {"name": "rmsprop", "lr": 3e-3, "momentum": 0.9, "initial_scale": 1.0},
    {"name": "adamw", "lr": 3e-3, "weight_decay": 0.1, "b2": 0.99},
    {"name": "lamb", "lr": 3e-3, "weight_decay": 0.01},
    {"name": "lars", "lr": 1e-2, "weight_decay": 1e-3, "nesterov": True},
    {"name": "rmsprop", "decay": 0.5},
]


@pytest.mark.parametrize("clip_norm,clip_value", CLIPS)
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_every_optimizer_follows_optax(spec, clip_norm, clip_value):
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (3,), (2, 2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 2, size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    grads[2][1][:] = 0.0  # a zero gradient (trust ratios take 1)
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


def test_frozen_parameters_do_not_move():
    """``apply(..., frozen=...)`` drops a frozen parameter's update, even
    where the chain's update is not zero at a zero gradient (adamw's
    decay, adam's moments)."""
    p = [torch.ones(3), torch.ones(2)]
    for name in ("adamw", "adam", "lars"):
        opt = optimizers.get({"name": name, "lr": 0.1})
        state = opt.init(p)
        opt.apply(p, [torch.ones(3), torch.ones(2)], state)
        before = [t.clone() for t in p]
        opt.apply(p, [torch.zeros(3), torch.ones(2)], state,
                  frozen=[True, False])
        assert torch.equal(p[0], before[0])
        assert not torch.equal(p[1], before[1])


# ---- losses --------------------------------------------------------------

def _loss_inputs(name, rng):
    """(y_true, y_pred) in each loss's domain."""
    shape = (6, 5)
    if name in ("binary_crossentropy", "categorical_crossentropy",
                "kld", "kullback_leibler_divergence",
                "sparse_categorical_crossentropy"):
        p = rng.uniform(0.01, 1.0, shape).astype(np.float32)
        p /= p.sum(-1, keepdims=True)
        if name == "sparse_categorical_crossentropy":
            return rng.integers(0, 5, (6,)), p
        t = (rng.uniform(size=shape) > 0.5).astype(np.float32)
        if name != "binary_crossentropy":
            t = rng.uniform(0.01, 1.0, shape).astype(np.float32)
            t /= t.sum(-1, keepdims=True)
        return t, p
    if name in ("class_nll", "classnll"):
        logits = rng.normal(size=shape).astype(np.float32)
        return (rng.integers(0, 5, (6,)),
                logits - np.log(np.exp(logits).sum(-1, keepdims=True)))
    if name in ("hinge", "squared_hinge"):
        return (np.sign(rng.normal(size=shape)).astype(np.float32),
                rng.normal(size=shape).astype(np.float32))
    if name in ("poisson", "msle", "mean_squared_logarithmic_error",
                "mape", "mean_absolute_percentage_error"):
        return (rng.uniform(0.0, 3.0, shape).astype(np.float32),
                rng.uniform(0.1, 3.0, shape).astype(np.float32))
    if name == "rank_hinge":
        return (np.zeros((6, 1), np.float32),
                rng.normal(size=(6, 1)).astype(np.float32))
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("name", sorted(jobj._LOSSES))
def test_every_loss_matches_jax(name):
    rng = np.random.default_rng(7)
    y, p = _loss_inputs(name, rng)
    ref = np.asarray(jobj.get(name)(jnp.asarray(y), jnp.asarray(p)))
    out = objectives.get(name)(torch.from_numpy(y), torch.from_numpy(p))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)


CLASS_FORMS = ["SparseCategoricalCrossEntropy", "CategoricalCrossEntropy",
               "BinaryCrossEntropy", "MeanSquaredError", "MeanAbsoluteError",
               "MeanAbsolutePercentageError", "MeanSquaredLogarithmicError",
               "Hinge", "SquaredHinge", "Poisson",
               "KullbackLeiblerDivergence", "CosineProximity", "RankHinge",
               "ClassNLLCriterion"]


@pytest.mark.parametrize("cls", CLASS_FORMS)
def test_every_loss_class_matches_jax(cls):
    jl, tl = getattr(jobj, cls)(), getattr(objectives, cls)()
    assert repr(tl) == repr(jl)
    assert objectives.get(tl) is tl
    name = next(n for n, f in objectives._LOSSES.items()
                if f is type(tl)._fn)
    y, p = _loss_inputs(name, np.random.default_rng(8))
    np.testing.assert_allclose(
        tl(torch.from_numpy(y), torch.from_numpy(p)).numpy(),
        np.asarray(jl(jnp.asarray(y), jnp.asarray(p))), rtol=1e-6,
        atol=1e-7)


# ---- metrics -------------------------------------------------------------

def _metric_batches(kind, rng):
    """Two (y_true, y_pred, mask) batches for a metric kind."""
    out = []
    for n, mask in ((12, np.ones(12, np.float32)),
                    (12, np.r_[np.ones(7), np.zeros(5)].astype(np.float32))):
        if kind == "auc_1":
            y = (rng.uniform(size=(n, 1)) > 0.4).astype(np.float32)
            p = rng.uniform(size=(n, 1)).astype(np.float32)
        elif kind == "auc_2":
            y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
            p = rng.uniform(size=(n, 2)).astype(np.float32)
            p /= p.sum(-1, keepdims=True)
        elif kind == "mae_class":
            y = rng.integers(1, 6, (n,)).astype(np.int32)
            p = np.log(rng.dirichlet(np.ones(5), n)).astype(np.float32)
        elif kind == "mae_column":
            y = rng.normal(size=(n,)).astype(np.float32)
            p = rng.normal(size=(n, 1)).astype(np.float32)
        elif kind == "mae_regression":
            y = rng.normal(size=(n, 3)).astype(np.float32)
            p = rng.normal(size=(n, 3)).astype(np.float32)
        else:  # ranking: groups of 4, one positive each
            y = np.zeros(n, np.float32)
            y[rng.integers(0, 4, n // 4) + 4 * np.arange(n // 4)] = 1
            p = rng.normal(size=(n,)).astype(np.float32)
            mask = np.r_[np.ones(8), np.zeros(4)].astype(np.float32)
        out.append((y, p, mask))
    return out


METRIC_CASES = [
    ("auc_1", lambda m: m.AUC()),
    ("auc_2", lambda m: m.AUC(threshold_num=50)),
    ("mae_class", lambda m: m.MAE(zero_based_label=False)),
    ("mae_column", lambda m: m.MAE()),
    ("mae_regression", lambda m: m.get("mae")),
    ("ranking", lambda m: m.HitRatio(k=2, neg_num=3)),
    ("ranking", lambda m: m.NDCG(k=3, neg_num=3)),
    ("ranking", lambda m: m.get("ndcg")),
]


@pytest.mark.parametrize("kind,make", METRIC_CASES)
def test_metrics_match_jax_with_masks(kind, make):
    jm, tm = make(jmetrics), make(metrics)
    assert tm.name == jm.name
    if kind == "ranking" and jm.neg_num != 3:
        jm.neg_num = tm.neg_num = 3
    ja, ta = jm.init(), tm.init()
    for y, p, mask in _metric_batches(kind, np.random.default_rng(9)):
        ja = jm.update(ja, jnp.asarray(y), jnp.asarray(p), jnp.asarray(mask))
        ta = tm.update(ta, torch.from_numpy(y), torch.from_numpy(p),
                       torch.from_numpy(mask))
    np.testing.assert_allclose(tm.result(ta), float(jm.result(ja)),
                               rtol=1e-6, atol=1e-7)


def test_auc_refuses_multiclass_scores():
    m = metrics.AUC()
    with pytest.raises(ValueError, match="binary metric"):
        m.update(m.init(), torch.zeros(4), torch.zeros((4, 3)))


# ---- tests/test_ranking_metrics.py ---------------------------------------

def _grouped(scores_per_group, pos_index_per_group):
    y_pred, y_true = [], []
    for scores, pos in zip(scores_per_group, pos_index_per_group):
        y_pred.extend(scores)
        y_true.extend(1 if i == pos else 0 for i in range(len(scores)))
    return (torch.tensor(y_true, dtype=torch.float32),
            torch.tensor(y_pred, dtype=torch.float32))


def test_hit_ratio_ranks_positive():
    m = HitRatio(k=2, neg_num=3)
    y_true, y_pred = _grouped(
        [[0.9, 0.1, 0.2, 0.3], [0.4, 0.8, 0.6, 0.1]], [0, 0])
    acc = m.update(m.init(), y_true, y_pred)
    assert m.result(acc) == pytest.approx(0.5)


def test_ndcg_values():
    m = NDCG(k=3, neg_num=3)
    y_true, y_pred = _grouped(
        [[0.9, 0.1, 0.2, 0.3], [0.4, 0.8, 0.6, 0.1]], [0, 0])
    acc = m.update(m.init(), y_true, y_pred)
    assert m.result(acc) == pytest.approx((1.0 + 0.5) / 2)


def test_ranking_metric_class_distribution_output():
    m = HitRatio(k=1, neg_num=1)
    y_true = torch.tensor([1, 0, 0, 1], dtype=torch.float32)
    logp = torch.log(torch.tensor([[0.2, 0.8], [0.6, 0.4],
                                   [0.3, 0.7], [0.4, 0.6]]))
    acc = m.update(m.init(), y_true, logp)
    assert m.result(acc) == pytest.approx(0.5)


def test_ranking_metric_mask_voids_group():
    m = HitRatio(k=1, neg_num=1)
    y_true, y_pred = _grouped([[0.9, 0.1], [0.2, 0.8]], [0, 0])
    mask = torch.tensor([1, 1, 0, 0], dtype=torch.float32)
    acc = m.update(m.init(), y_true, y_pred, mask)
    assert m.result(acc) == pytest.approx(1.0)
    assert float(acc["total"]) == 1.0


def test_ranking_metric_bad_batch():
    m = NDCG(k=2, neg_num=3)
    with pytest.raises(ValueError, match="not a multiple"):
        m.update(m.init(), torch.zeros(6), torch.zeros(6))


def test_get_by_name():
    m = get("hit_ratio")
    assert isinstance(m, HitRatio) and m.name == "hit_ratio@10"
    assert isinstance(get("ndcg"), NDCG)


def test_distinct_k_instances_do_not_collide():
    assert HitRatio(k=1, neg_num=9).name != HitRatio(k=10, neg_num=9).name
