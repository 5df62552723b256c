"""Explicit-feedback Neural Collaborative Filtering on MovieLens, on the
PyTorch/CUDA port.

The port of ``ncf_explicit_feedback.py`` beside it (the reference's
apps/recommendation-ncf/ncf-explicit-feedback.ipynb): MovieLens ratings,
an 80/20 split, NeuralCF(class_num=5), Adam, validation (MAE + loss)
every epoch, the summaries read back from disk into loss curves, then
predict_user_item_pair / recommend_for_user / recommend_for_item /
evaluate(MAE), plus the implicit-feedback HitRatio/NDCG protocol.  Runs
on ``--device`` (default ``cuda``; ``--device cpu`` without a card).
Without ``--log-dir`` the summaries go to a fresh temporary directory.

REAL DATA: pass ``--data /path/to/ml-1m`` (or a ratings file directly):
ml-1m ``ratings.dat`` (``UserID::MovieID::Rating::Timestamp``) or ml-100k
``u.data`` (tab-separated ``user item rating ts``).  Without ``--data``
the app falls back to synthetic MovieLens-shaped ratings (latent-factor
affinity, same value ranges) so it always runs to its metrics.
"""

import argparse
import os
import tempfile

import numpy as np


def load_movielens(path):
    """Parse MovieLens ratings: ml-1m ``ratings.dat`` (``::`` separated)
    or ml-100k ``u.data`` (tab separated).  ``path`` may be the dataset
    directory or the ratings file itself.  Returns int32 rows of
    (user, item, rating) with users/items 1-based, ratings 1..5."""
    if os.path.isdir(path):
        for cand in ("ratings.dat", "u.data"):
            f = os.path.join(path, cand)
            if os.path.exists(f):
                path = f
                break
        else:
            raise FileNotFoundError(
                f"no ratings.dat / u.data under {path}")
    rows = []
    with open(path, encoding="latin-1") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split("::") if "::" in line else line.split()
            u, i, r = int(parts[0]), int(parts[1]), int(float(parts[2]))
            rows.append((u, i, r))
    data = np.asarray(rows, np.int32)
    if not len(data):
        raise ValueError(f"no ratings parsed from {path}")
    return data


def synthetic_movielens(n_users, n_items, n_ratings, seed=0):
    rs = np.random.RandomState(seed)
    u_factors = rs.normal(size=(n_users + 1, 4))
    i_factors = rs.normal(size=(n_items + 1, 4))
    users = rs.randint(1, n_users + 1, n_ratings)
    items = rs.randint(1, n_items + 1, n_ratings)
    affinity = np.einsum("nd,nd->n", u_factors[users], i_factors[items])
    # map affinity quintiles onto ratings 1..5 with a little noise
    edges = np.quantile(affinity, [0.2, 0.4, 0.6, 0.8])
    ratings = 1 + np.searchsorted(edges, affinity)
    flip = rs.rand(n_ratings) < 0.1
    ratings = np.where(flip, rs.randint(1, 6, n_ratings), ratings)
    return np.stack([users, items, ratings], axis=1).astype(np.int32)


def build_explicit(users, items, device):
    from analytics_zoo_tpu_torch.models import NeuralCF
    return NeuralCF(user_count=users, item_count=items, num_classes=5,
                    hidden_layers=(20, 10), include_mf=False, device=device)


def build_implicit(users, items, device):
    from analytics_zoo_tpu_torch.models import NeuralCF
    return NeuralCF(user_count=users, item_count=items, num_classes=2,
                    hidden_layers=(20, 10), include_mf=True, mf_embed=8,
                    device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None,
                    help="MovieLens dir or ratings file (ml-1m "
                         "ratings.dat / ml-100k u.data); synthetic "
                         "fallback when omitted")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--users", type=int, default=100)
    ap.add_argument("--items", type=int, default=80)
    ap.add_argument("--ratings", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.models import UserItemFeature
    from analytics_zoo_tpu_torch.train.summary import read_scalars

    init_nncontext("NCF Example", device=args.device)
    if args.data:
        data = load_movielens(args.data)
        args.users = int(data[:, 0].max())
        args.items = int(data[:, 1].max())
        # real-data scale: the reference notebook's batch size (2800),
        # clamped so tiny subsets still make at least a few steps/epoch
        args.batch_size = max(args.batch_size,
                              min(2800, max(len(data) // 10, 1)))
        print(f"loaded MovieLens: {len(data)} ratings, "
              f"{args.users} users, {args.items} items")
    else:
        data = synthetic_movielens(args.users, args.items, args.ratings)
        print("synthetic fallback (pass --data for MovieLens)")
    print("ratings:", data.shape, "users", data[:, 0].min(), "..",
          data[:, 0].max(), "items", data[:, 1].min(), "..",
          data[:, 1].max(), "labels", np.unique(data[:, 2]))

    rs = np.random.RandomState(1)
    perm = rs.permutation(len(data))
    split = int(0.8 * len(data))
    train, val = data[perm[:split]], data[perm[split:]]

    x_train = train[:, :2]
    y_train = train[:, 2] - 1          # classes 0..4
    x_val, y_val = val[:, :2], val[:, 2] - 1

    ncf = build_explicit(args.users, args.items, args.device)
    # log-softmax head + ClassNLL, the reference notebook's pairing
    ncf.compile(optimizer="adam", loss="class_nll",
                metrics=["mae", "accuracy"])
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="ncf-tb-")
    ncf.set_tensorboard(log_dir, "ncf")
    ncf.fit(x_train, y_train, batch_size=args.batch_size,
            nb_epoch=args.epochs, validation_data=(x_val, y_val))

    # read the summaries back, notebook-style loss curves as text
    loss = read_scalars(log_dir, "ncf", "Loss")
    val_mae = read_scalars(log_dir, "ncf", "mae", split="validation")
    if loss:
        print("train Loss points:", len(loss),
              "first %.3f last %.3f" % (loss[0][1], loss[-1][1]))
    if val_mae:
        print("val MAE per epoch:",
              ["%.3f" % v for _, v in val_mae])

    metrics = ncf.evaluate(x_val, y_val, batch_size=args.batch_size)
    print("validation metrics:", metrics)

    pairs = [UserItemFeature(int(u), int(i), np.array([u, i], np.int32))
             for u, i, _ in val[:200]]
    for p in ncf.predict_user_item_pair(pairs)[:5]:
        print("pair", p)
    print("-- top-3 items per user --")
    for r in ncf.recommend_for_user(pairs, max_items=3)[:6]:
        print(f"user {r.user_id}: item {r.item_id} "
              f"rating {r.prediction} (p={r.probability:.3f})")
    print("-- top-3 users per item --")
    for r in ncf.recommend_for_item(pairs, max_users=3)[:6]:
        print(f"item {r.item_id}: user {r.user_id} "
              f"rating {r.prediction} (p={r.probability:.3f})")

    # ---- implicit-feedback protocol: negative sampling + ranking ----
    # (the NCF paper's evaluation: rank the held-out positive among
    # sampled negatives; BigDL's getNegativeSamples + HitRatio/NDCG)
    from analytics_zoo_tpu_torch.models import get_negative_samples
    from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import (
        HitRatio, NDCG)

    positives = [(int(u), int(i)) for u, i, r in data if r >= 4]
    # HOLD OUT the ranking-eval positives (random across users — ml-1m
    # is user-sorted, so a head slice would cover a handful of users)
    # before training, so HR/NDCG measure unseen positives
    neg_num, k = (99, 10) if args.data else (9, 3)
    n_eval = min(1000 if args.data else 100, len(positives) // 5 or 1)
    rs3 = np.random.RandomState(3)
    perm_p = rs3.permutation(len(positives))
    eval_pos = [positives[i] for i in perm_p[:n_eval]]
    train_pos = [positives[i] for i in perm_p[n_eval:]]
    negatives = get_negative_samples(train_pos, item_count=args.items,
                                     neg_per_pos=2, seed=2)
    xi = np.array(train_pos + negatives, np.int32)
    yi = np.concatenate([np.ones(len(train_pos)),
                         np.zeros(len(negatives))]).astype(np.int32)
    implicit = build_implicit(args.users, args.items, args.device)
    implicit.compile(optimizer="adam", loss="class_nll")
    perm2 = rs.permutation(len(xi))
    implicit.fit(xi[perm2], yi[perm2], batch_size=args.batch_size,
                 nb_epoch=args.epochs)
    ex, ey = [], []
    pos_set = set(positives)
    for u, i in eval_pos:
        ex.append((u, i)); ey.append(1)
        drawn, j = 0, 1
        while drawn < neg_num:
            cand = ((i + j - 1) % args.items) + 1
            j += 1
            if (u, cand) not in pos_set:
                ex.append((u, cand)); ey.append(0); drawn += 1
    ranked = implicit.evaluate(
        np.array(ex, np.int32), np.array(ey, np.int32),
        batch_size=(neg_num + 1) * 10,
        metrics=[HitRatio(k=k, neg_num=neg_num),
                 NDCG(k=k, neg_num=neg_num)])
    chance = k / (neg_num + 1)
    print(f"implicit feedback (held-out positives): "
          f"HitRatio@{k} {ranked[f'hit_ratio@{k}']:.3f} "
          f"NDCG@{k} {ranked[f'ndcg@{k}']:.3f} "
          f"(chance hit@{k} of {neg_num + 1} = {chance:.3f})")
    print("ncf app done")


if __name__ == "__main__":
    main()
