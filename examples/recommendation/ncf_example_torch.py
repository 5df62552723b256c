"""Neural Collaborative Filtering on synthetic user/item ratings, on the
PyTorch/CUDA port.

The port of ``ncf_example.py``: explicit-feedback ratings 1..5 become
classes, recommend_for_user at the end, on ``--device`` (default
``cuda``; ``--device cpu`` without a card).
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--users", type=int, default=40)
    ap.add_argument("--items", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.models.recommendation import (
        NeuralCF, UserItemFeature)

    init_nncontext("NCF example", device=args.device)

    rs = np.random.RandomState(0)
    n = 1024
    users = rs.randint(1, args.users + 1, n)
    items = rs.randint(1, args.items + 1, n)
    # structured ratings: users like items whose parity matches
    ratings = np.where((users + items) % 2 == 0,
                       rs.randint(4, 6, n), rs.randint(1, 3, n))

    x = np.stack([users, items], axis=1).astype(np.int32)
    y = (ratings - 1).astype(np.int32)  # classes 0..4

    model = NeuralCF(user_count=args.users, item_count=args.items,
                     num_classes=5, mf_embed=8,
                     user_embed=8, item_embed=8, hidden_layers=(16, 8),
                     device=args.device)
    # the model head is log-softmax: pair it with ClassNLL (reference
    # parity), NOT sparse_categorical_crossentropy (expects probs)
    model.compile(optimizer="adam", loss="class_nll",
                  metrics=["accuracy"])
    model.fit(x, y, batch_size=64, nb_epoch=args.epochs)
    print("train metrics:", model.evaluate(x, y, batch_size=64))

    pairs = [UserItemFeature(int(u), int(i),
                             np.array([u, i], np.int32))
             for u, i in zip(users[:50], items[:50])]
    recs = model.recommend_for_user(pairs, max_items=3)
    for rec in recs[:6]:
        print(f"user {rec.user_id}: item {rec.item_id} "
              f"rating {rec.prediction} (p={rec.probability:.3f})")


if __name__ == "__main__":
    main()
