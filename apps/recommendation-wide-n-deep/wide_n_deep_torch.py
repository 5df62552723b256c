"""Wide & Deep recommender over MovieLens-style tabular features, on the
PyTorch/CUDA port.

The port of ``wide_n_deep.py`` beside it (the reference's
apps/recommendation-wide-n-deep/wide_n_deep.ipynb): join ratings with
user (gender/age/occupation) and item (genres) tables, assemble wide ids
(base + hashed cross columns), indicator / embedding / continuous deep
features via the feature-assembly helpers, train
WideAndDeep(``--model-type``) with validation, then
predict_user_item_pair / recommend_for_user / recommend_for_item.  Runs
on synthetic MovieLens-shaped tables, on ``--device`` (default
``cuda``; ``--device cpu`` without a card).
"""

import argparse

import numpy as np

GENDERS = ["F", "M"]
GENRES = ["Crime", "Romance", "Thriller", "Adventure", "Drama",
          "Children's", "War", "Documentary", "Fantasy", "Mystery",
          "Musical", "Animation", "Film-Noir", "Horror", "Western",
          "Comedy", "Action", "Sci-Fi"]
AGE_BUCKETS = [20, 30, 40, 50]
CROSS_BUCKETS = 100


def synthetic_tables(n_users, n_items, n_ratings, seed=0):
    rs = np.random.RandomState(seed)
    users = [{"userId": u, "gender": GENDERS[rs.randint(2)],
              "age": int(rs.randint(16, 65)),
              "occupation": int(rs.randint(0, 21))}
             for u in range(1, n_users + 1)]
    items = [{"itemId": i, "genre": GENRES[rs.randint(len(GENRES))]}
             for i in range(1, n_items + 1)]
    ratings = []
    for _ in range(n_ratings):
        u = users[rs.randint(n_users)]
        it = items[rs.randint(n_items)]
        # preference structure: young users like Action/Sci-Fi/Animation,
        # older users like Drama/Documentary/Romance
        young = u["age"] < 35
        likes = (it["genre"] in ("Action", "Sci-Fi", "Animation", "Comedy")
                 if young else
                 it["genre"] in ("Drama", "Documentary", "Romance", "War"))
        base = 4 if likes else 2
        label = int(np.clip(base + rs.randint(-1, 2), 1, 5))
        ratings.append({**u, **it, "label": label})
    return ratings


def featurize(rows, info):
    """Each joined row's features (the notebook's udf stage), as
    UserItemFeatures of ``info``'s columns."""
    from analytics_zoo_tpu_torch.models import (
        categorical_from_vocab_list, get_boundaries, hash_bucket,
        to_user_item_feature)
    for r in rows:
        r["gender_id"] = categorical_from_vocab_list(r["gender"], GENDERS)
        r["age_bucket"] = get_boundaries(r["age"], AGE_BUCKETS)
        r["genre_id"] = categorical_from_vocab_list(r["genre"], GENRES)
        r["age-gender"] = hash_bucket(
            f'{r["age_bucket"]}_{r["gender"]}', bucket_size=CROSS_BUCKETS)
        r["label0"] = r["label"] - 1  # zero-based classes
    return [to_user_item_feature(r, info) for r in rows]


def column_info(users, items):
    from analytics_zoo_tpu_torch.models import ColumnFeatureInfo
    return ColumnFeatureInfo(
        wide_base_cols=["occupation", "gender_id"],
        wide_base_dims=[21, len(GENDERS)],
        wide_cross_cols=["age-gender"],
        wide_cross_dims=[CROSS_BUCKETS],
        indicator_cols=["genre_id", "gender_id"],
        indicator_dims=[len(GENRES), len(GENDERS)],
        embed_cols=["userId", "itemId"],
        embed_in_dims=[users, items],
        embed_out_dims=[16, 16],
        continuous_cols=["age"],
        label="label0")


def build_model(model_type, info, device):
    from analytics_zoo_tpu_torch.models import WideAndDeep
    return WideAndDeep(model_type=model_type, num_classes=5,
                       column_info=info, hidden_layers=(40, 20, 10),
                       device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--users", type=int, default=80)
    ap.add_argument("--items", type=int, default=60)
    ap.add_argument("--ratings", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--model-type", default="wide_n_deep",
                    choices=["wide", "deep", "wide_n_deep"])
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.models import features_to_arrays

    init_nncontext("WideAndDeep Example", device=args.device)
    rows = synthetic_tables(args.users, args.items, args.ratings)

    info = column_info(args.users, args.items)
    pairs = featurize(rows, info)
    rs = np.random.RandomState(1)
    perm = rs.permutation(len(pairs))
    split = int(0.8 * len(pairs))
    train_pairs = [pairs[i] for i in perm[:split]]
    val_pairs = [pairs[i] for i in perm[split:]]
    x_train, y_train = features_to_arrays(train_pairs)
    x_val, y_val = features_to_arrays(val_pairs)
    print("train", len(train_pairs), "val", len(val_pairs),
          "wide width", x_train[0].shape, "deep width", x_train[1].shape)

    wnd = build_model(args.model_type, info, args.device)
    # log-softmax head + ClassNLL, the reference notebook's pairing
    wnd.compile(optimizer={"name": "adam", "lr": 1e-3},
                loss="class_nll", metrics=["mae", "accuracy"])
    if args.model_type != "wide_n_deep":
        idx = {"wide": 0, "deep": 1}[args.model_type]
        x_train, x_val = [x_train[idx]], [x_val[idx]]
    wnd.fit(x_train, y_train, batch_size=args.batch_size,
            nb_epoch=args.epochs, validation_data=(x_val, y_val))
    print("validation metrics:",
          wnd.evaluate(x_val, y_val, batch_size=args.batch_size))

    if args.model_type == "wide_n_deep":
        for p in wnd.predict_user_item_pair(val_pairs[:5]):
            print("pair", p)
        print("-- top-3 items per user --")
        for r in wnd.recommend_for_user(val_pairs, max_items=3)[:6]:
            print(f"user {r.user_id}: item {r.item_id} "
                  f"rating {r.prediction} (p={r.probability:.3f})")
        print("-- top-3 users per item --")
        for r in wnd.recommend_for_item(val_pairs, max_users=3)[:6]:
            print(f"item {r.item_id}: user {r.user_id} "
                  f"rating {r.prediction} (p={r.probability:.3f})")
    print("wide-n-deep app done")


if __name__ == "__main__":
    main()
