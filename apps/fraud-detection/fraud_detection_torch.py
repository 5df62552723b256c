"""Fraud detection on the PyTorch/CUDA port: imbalanced binary
classification scored by AUC.

The port of ``fraud_detection.py`` beside it (the reference's
apps/fraud-detection: creditcard transactions, heavy class imbalance,
AUC as the metric of record).  Runs on ``--device`` (default ``cuda``;
``--device cpu`` without a card).
"""

import argparse

import numpy as np

N, D = 4096, 12


def make_data(fraud_rate, seed=0):
    """(x, y, the oversampled and shuffled training x, y): fraud rows
    shifted by +1.2 plus noise, then the minority class repeated tenfold
    (the notebook's rebalancing step)."""
    rs = np.random.RandomState(seed)
    y = (rs.rand(N) < fraud_rate).astype(np.int32)
    x = rs.randn(N, D).astype(np.float32)
    x[y == 1] += rs.randn(int(y.sum()), D).astype(np.float32) * 0.5 + 1.2
    fraud_idx = np.nonzero(y == 1)[0]
    boost = rs.choice(fraud_idx, size=len(fraud_idx) * 10)
    xb = np.concatenate([x, x[boost]])
    yb = np.concatenate([y, y[boost]])
    order = rs.permutation(len(xb))
    return x, y, xb[order], yb[order]


def build_model(device):
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (
        Dense, Dropout)

    model = Sequential(name="fraud_mlp", device=device)
    model.add(Dense(32, activation="relu", input_shape=(D,)))
    model.add(Dropout(0.3))
    model.add(Dense(16, activation="relu"))
    model.add(Dense(2, activation="softmax"))
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--fraud-rate", type=float, default=0.03)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    x, y, xb, yb = make_data(args.fraud_rate)
    model = build_model(args.device)
    model.compile(optimizer="adam",
                  loss="sparse_categorical_crossentropy",
                  metrics=["auc"])
    model.fit(xb, yb, batch_size=128, nb_epoch=args.epochs)

    result = model.evaluate(x, y, batch_size=256)
    print("held-out metrics:", result)
    assert result["auc"] > 0.8, "AUC should beat chance comfortably"


if __name__ == "__main__":
    main()
