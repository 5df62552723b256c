"""The port's recommendation zoo (NeuralCF, WideAndDeep, Recommender,
``recommendation_utils``) against the JAX package's, on the CPU.

Both packages build each model inside its class's ``name_scope``, so
layer names match and the JAX model's weights go into the port with
``from_jax_params``.  Forward passes agree within 1e-5 (atol and rtol)
for NeuralCF with and without its MF branch and all three WideAndDeep
types (deep inputs carry fractional embed ids: both packages truncate
them toward zero).  NeuralCF at the bench plan's table sizes (6040 users
x 3706 items, 5 classes; batch 256 here) trains 3 adam(1e-3) steps on
``class_nll`` through both packages' ``fit``: losses within 1e-5
relative, every parameter within 1e-5 of its tensor's largest entry.
The counterparts of ``tests/test_model_zoo.py``'s NeuralCF and
WideAndDeep tests and of ``tests/test_ranking_metrics.py``'s implicit
feedback test keep those tests' plans and thresholds; every function of
``recommendation_utils`` gives the JAX package's outputs exactly.
"""

import numpy as np
import pytest
import jax

from analytics_zoo_tpu.models import recommendation_utils as jutils
from analytics_zoo_tpu.models.recommendation import (
    ColumnFeatureInfo as JColumnFeatureInfo, NeuralCF as JNeuralCF,
    WideAndDeep as JWideAndDeep)
from analytics_zoo_tpu_torch.models import (
    ColumnFeatureInfo, NeuralCF, UserItemFeature, WideAndDeep,
    from_jax_params, get_negative_samples)
from analytics_zoo_tpu_torch.models import recommendation_utils as tutils
from analytics_zoo_tpu_torch.pipeline.api.keras import load_model
from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import HitRatio, NDCG

TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_RTOL = 1e-5

CI = dict(wide_base_dims=(5, 7), wide_cross_dims=(9,), indicator_dims=(4,),
          embed_in_dims=(10, 6), embed_out_dims=(4, 3),
          continuous_cols=("age",))


def _port_of(jmodel, cls, **hyper):
    model = cls(**hyper, device="cpu")
    from_jax_params(model, jax.device_get(jmodel.get_weights()))
    return model


def _ncf_data(n, users, items, classes, seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, users + 1, n),
                  rng.integers(1, items + 1, n)], axis=1).astype(np.int32)
    return x, rng.integers(0, classes, n).astype(np.int32)


def _wnd_data(n, seed=0, fractional=False):
    rng = np.random.default_rng(seed)
    wide = np.stack([rng.integers(1, 6, n), 5 + rng.integers(1, 8, n),
                     12 + rng.integers(1, 10, n)], axis=1).astype(np.int32)
    indicator = rng.integers(0, 2, (n, 4)).astype(np.float32)
    ids = np.stack([rng.integers(1, 11, n), rng.integers(1, 7, n)], axis=1)
    if fractional:  # ids the embeddings must truncate toward zero
        ids = ids + rng.uniform(0.0, 0.99, ids.shape)
    deep = np.concatenate([indicator, ids, rng.normal(size=(n, 1))],
                          axis=1).astype(np.float32)
    return wide, deep, rng.integers(0, 2, n).astype(np.int32)


@pytest.mark.parametrize("include_mf", [True, False])
def test_neuralcf_forward_matches_jax(include_mf):
    hyper = dict(user_count=30, item_count=40, num_classes=3, user_embed=8,
                 item_embed=6, hidden_layers=(16, 8), include_mf=include_mf,
                 mf_embed=5)
    jm = JNeuralCF(**hyper)
    tm = _port_of(jm, NeuralCF, **hyper)
    assert [l.name for l in tm.to_graph().layers if l.params()] == \
        [l.name for l in jm.to_graph().layers
         if l.name in jax.device_get(jm.get_weights())]
    x, _ = _ncf_data(24, 30, 40, 3)
    np.testing.assert_allclose(tm.predict(x, batch_size=8),
                               np.asarray(jm.predict(x, batch_size=8)),
                               **TOL)


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_wide_and_deep_forward_matches_jax(model_type):
    hyper = dict(model_type=model_type, num_classes=3, hidden_layers=(8, 4))
    jm = JWideAndDeep(column_info=JColumnFeatureInfo(**CI), **hyper)
    tm = _port_of(jm, WideAndDeep, column_info=ColumnFeatureInfo(**CI),
                  **hyper)
    if model_type != "deep":
        assert tm.get_weights()["wide_bias"]["weight"].shape == (3,)
    wide, deep, _ = _wnd_data(24, fractional=True)
    x = {"wide": wide, "deep": deep, "wide_n_deep": [wide, deep]}[model_type]
    # the wide part's zero init predicts uniform: give it a signal
    weights = tm.get_weights()
    rng = np.random.default_rng(5)
    noisy = {l: {k: v + rng.normal(0, 0.3, v.shape).astype(np.float32)
                 for k, v in d.items()} for l, d in weights.items()}
    jm.set_weights(noisy)
    tm.set_weights(noisy)
    out = tm.predict(x, batch_size=8)
    np.testing.assert_allclose(out, np.asarray(jm.predict(x, batch_size=8)),
                               **TOL)
    np.testing.assert_allclose(np.exp(out).sum(axis=1), 1.0, rtol=1e-5)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_neuralcf_bench_plan_trains_like_jax():
    """bench.py's NCF plan (6040 x 3706, 5 classes, embeds 20/20, MF 20,
    hidden (40, 20, 10), adam 1e-3, class_nll) at batch 256: 3 steps."""
    hyper = dict(user_count=6040, item_count=3706, num_classes=5,
                 user_embed=20, item_embed=20, hidden_layers=(40, 20, 10),
                 include_mf=True, mf_embed=20)
    jm = JNeuralCF(**hyper)
    tm = _port_of(jm, NeuralCF, **hyper)
    x, y = _ncf_data(3 * 256, 6040, 3706, 5)
    for m in (jm, tm):
        m.compile(optimizer={"name": "adam", "lr": 1e-3}, loss="class_nll")
    ref = jm.fit(x, y, batch_size=256, nb_epoch=1, shuffle=False)["loss"]
    out = tm.fit(x, y, batch_size=256, nb_epoch=1, shuffle=False)["loss"]
    assert len(out) == 3 and np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, rtol=TRAIN_RTOL, atol=0)
    jw = jax.device_get(jm.get_weights())
    for layer, leaves in tm.get_weights().items():
        for k, v in leaves.items():
            assert _rel(v, np.asarray(jw[layer][k])) <= TRAIN_RTOL, \
                (layer, k)


def test_torch_neuralcf_trains_and_recommends():
    """The plan of tests/test_model_zoo.py's NeuralCF test: accuracy
    above 0.85 on a parity preference, then predict_user_item_pair and
    the recommendations, sorted by probability."""
    n_users, n_items = 30, 40
    rng = np.random.default_rng(0)
    users = rng.integers(1, n_users + 1, 512)
    items = rng.integers(1, n_items + 1, 512)
    labels = ((users + items) % 2).astype(np.int32)
    x = np.stack([users, items], axis=1).astype(np.int32)
    model = NeuralCF(user_count=n_users, item_count=n_items, num_classes=2,
                     user_embed=8, item_embed=8, hidden_layers=(16, 8),
                     mf_embed=8, device="cpu")
    model.compile(optimizer={"name": "adam", "lr": 5e-3}, loss="class_nll",
                  metrics=["accuracy"])
    model.fit(x, labels, batch_size=64, nb_epoch=12)
    res = model.evaluate(x, labels, batch_size=64)
    assert res["accuracy"] > 0.85, res

    pairs = [UserItemFeature(int(u), int(i), np.array([u, i], np.int32))
             for u, i in zip(users[:64], items[:64])]
    preds = model.predict_user_item_pair(pairs)
    assert len(preds) == 64
    assert all(p.prediction in (1, 2) for p in preds)
    assert all(0 <= p.probability <= 1 for p in preds)
    for recs, key, limit in ((model.recommend_for_user(pairs, max_items=3),
                              "user_id", 3),
                             (model.recommend_for_item(pairs, max_users=2),
                              "item_id", 2)):
        groups = {}
        for r in recs:
            groups.setdefault(getattr(r, key), []).append(r.probability)
        assert set(groups) == {getattr(p, key) for p in pairs}
        for probs in groups.values():
            assert len(probs) <= limit
            assert probs == sorted(probs, reverse=True)


def test_torch_wide_and_deep_variants(tmp_path):
    """The plan of tests/test_model_zoo.py's WideAndDeep test (all three
    types fit and predict; log-probability rows sum to 1), then
    save_model/load_model of the wide_n_deep model."""
    ci = ColumnFeatureInfo(**CI)
    wide, deep, y = _wnd_data(128)
    wnd = WideAndDeep(model_type="wide_n_deep", num_classes=2,
                      column_info=ci, hidden_layers=(16, 8), device="cpu")
    wnd.compile(optimizer="adam", loss="class_nll", metrics=["accuracy"])
    wnd.fit((wide, deep), y, batch_size=32, nb_epoch=2)
    out = wnd.predict((wide, deep), batch_size=32)
    assert out.shape == (128, 2)
    np.testing.assert_allclose(np.exp(out).sum(axis=1), 1.0, rtol=1e-5)
    wnd.save_model(str(tmp_path / "wnd"))
    loaded = load_model(str(tmp_path / "wnd"), device="cpu")
    np.testing.assert_allclose(loaded.predict((wide, deep), batch_size=32),
                               out, rtol=1e-6, atol=1e-6)
    for model_type, x in (("wide", wide), ("deep", deep)):
        m = WideAndDeep(model_type=model_type, num_classes=2,
                        column_info=ci, hidden_layers=(16, 8), device="cpu")
        m.compile(optimizer="adam", loss="class_nll")
        m.fit(x, y, batch_size=32, nb_epoch=1)
        assert m.predict(x, batch_size=32).shape == (128, 2)
    with pytest.raises(ValueError, match="unknown type"):
        WideAndDeep(model_type="bogus", num_classes=2, column_info=ci,
                    device="cpu")


def test_torch_ncf_implicit_feedback_evaluation():
    """The plan of tests/test_ranking_metrics.py's implicit-feedback
    test: NeuralCF trained on sampled negatives beats chance at hit@3
    and NDCG@3 through evaluate."""
    rng = np.random.default_rng(0)
    n_users, n_items = 24, 40
    pos = [(u, i) for u in range(1, n_users + 1)
           for i in range(1, n_items + 1) if (u + i) % 4 == 0]
    negs = get_negative_samples(pos, item_count=n_items, neg_per_pos=3,
                                seed=1)
    x = np.array(pos + negs, np.int32)
    y = np.concatenate([np.ones(len(pos)),
                        np.zeros(len(negs))]).astype(np.int32)
    perm = rng.permutation(len(x))
    model = NeuralCF(user_count=n_users, item_count=n_items, num_classes=2,
                     user_embed=8, item_embed=8, hidden_layers=(16, 8),
                     include_mf=True, mf_embed=4, device="cpu")
    model.compile(optimizer={"name": "adam", "lr": 5e-3}, loss="class_nll")
    model.fit(x[perm], y[perm], batch_size=64, nb_epoch=12)
    neg_num = 9
    eval_x, eval_y = [], []
    for u, i in pos[:50]:
        eval_x.append((u, i))
        eval_y.append(1)
        drawn, j = 0, 1
        while drawn < neg_num:
            cand = ((i + j) % n_items) + 1
            j += 1
            if (u + cand) % 4 != 0:
                eval_x.append((u, cand))
                eval_y.append(0)
                drawn += 1
    res = model.evaluate(
        np.array(eval_x, np.int32), np.array(eval_y, np.int32),
        batch_size=(neg_num + 1) * 10,
        metrics=[HitRatio(k=3, neg_num=neg_num), NDCG(k=3, neg_num=neg_num)])
    assert res["hit_ratio@3"] > 0.6, res
    assert res["ndcg@3"] > 0.4, res
    assert 0.0 <= res["ndcg@3"] <= res["hit_ratio@3"] <= 1.0


def test_neuralcf_save_load_and_config(tmp_path):
    model = NeuralCF(user_count=12, item_count=9, num_classes=3,
                     user_embed=4, item_embed=4, hidden_layers=(8,),
                     mf_embed=3, device="cpu", seed=3)
    model.compile(optimizer={"name": "adam", "lr": 1e-3}, loss="class_nll")
    x, _ = _ncf_data(16, 12, 9, 3)
    out = model.predict(x, batch_size=8)
    model.save_model(str(tmp_path / "ncf"))
    loaded = load_model(str(tmp_path / "ncf"), device="cpu")
    assert type(loaded) is NeuralCF and loaded.hyper == model.hyper
    np.testing.assert_array_equal(loaded.predict(x, batch_size=8), out)
    with pytest.raises(ValueError, match="embedding units"):
        NeuralCF(user_count=3, item_count=3, num_classes=2, mf_embed=0,
                 device="cpu")


# ---- recommendation_utils: the JAX package's outputs, exactly ----

def _column_info(pkg):
    cls = ColumnFeatureInfo if pkg is tutils else JColumnFeatureInfo
    return cls(
        wide_base_cols=["occ", "gen"], wide_base_dims=[21, 3],
        wide_cross_cols=["cross"], wide_cross_dims=[100],
        indicator_cols=["genre", "gen"], indicator_dims=[5, 3],
        embed_cols=["userId", "itemId"], embed_in_dims=[50, 40],
        embed_out_dims=[8, 8], continuous_cols=["age"], label="label")


ROWS = [{"userId": u, "itemId": u + 1, "occ": u % 21, "gen": u % 3,
         "cross": (7 * u) % 100, "genre": [u % 5, (u + 2) % 5],
         "age": 20.0 + u, "label": u % 5} for u in range(1, 9)]

UTIL_CASES = {
    "hash_bucket": lambda m: [m.hash_bucket(f"k{i}", bucket_size=10, start=1)
                              for i in range(200)],
    "categorical_from_vocab_list": lambda m: [
        m.categorical_from_vocab_list(v, ["F", "M"], default=-1, start=1)
        for v in ("F", "M", "X")],
    "get_boundaries": lambda m: [m.get_boundaries(v, [20, 30, 40], default=-1,
                                                  start=1)
                                 for v in (5, 20, 25, 55, "?")],
    "get_negative_samples": lambda m: m.get_negative_samples(
        [(1, 1), (1, 2), (2, 3), (3, 5)], item_count=10, neg_per_pos=2,
        seed=0),
    "get_wide_tensor": lambda m: [m.get_wide_tensor(r, _column_info(m))
                                  for r in ROWS],
    "get_deep_tensor": lambda m: [m.get_deep_tensor(r, _column_info(m))
                                  for r in ROWS],
    "row_to_feature": lambda m: [m.row_to_feature(ROWS[2], _column_info(m), t)
                                 for t in ("wide_n_deep", "wide", "deep")],
    "row_to_sample": lambda m: m.row_to_sample(ROWS[3], _column_info(m)),
    "to_user_item_feature": lambda m: [
        (p.user_id, p.item_id, p.feature, p.label)
        for p in (m.to_user_item_feature(r, _column_info(m)) for r in ROWS)],
    "features_to_arrays": lambda m: m.features_to_arrays(
        [m.to_user_item_feature(r, _column_info(m)) for r in ROWS]),
}


def _assert_same(got, ref):
    if isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same(g, r)
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert type(got) is type(ref) and got == ref


@pytest.mark.parametrize("name", sorted(UTIL_CASES))
def test_recommendation_utils_match_jax(name):
    _assert_same(UTIL_CASES[name](tutils), UTIL_CASES[name](jutils))


def test_recommendation_utils_errors_match_jax():
    ci_t, ci_j = _column_info(tutils), _column_info(jutils)
    bad = dict(ROWS[0], occ=-1)
    for m, ci in ((tutils, ci_t), (jutils, ci_j)):
        with pytest.raises(ValueError, match="outside"):
            m.get_wide_tensor(bad, ci)
        with pytest.raises(ValueError, match="outside"):
            m.get_deep_tensor(dict(ROWS[0], genre=[7]), ci)
        with pytest.raises(TypeError):
            m.row_to_feature(ROWS[0], ci, "bogus")
