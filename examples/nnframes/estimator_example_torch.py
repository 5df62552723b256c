"""NNEstimator fit/transform over a dataframe, on the PyTorch/CUDA port.

The port of ``estimator_example.py``: train an estimator on a frame,
transform appends a prediction column.  The dataframe is pandas; the
model lives on ``--device`` (default ``cuda``; ``--device cpu`` without
a card).
"""

import argparse

import numpy as np
import pandas as pd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense
    from analytics_zoo_tpu_torch.pipeline.estimator.nn_estimator import (
        NNClassifier)
    from analytics_zoo_tpu_torch.common import init_nncontext

    init_nncontext("nnframes example", device=args.device)

    rs = np.random.RandomState(0)
    n = 512
    feats = rs.rand(n, 6).astype(np.float32)
    labels = (feats.sum(axis=1) > 3).astype(np.float32)
    df = pd.DataFrame({"features": list(feats), "label": labels})

    model = Sequential(device=args.device)
    model.add(Dense(16, activation="relu", input_shape=(6,)))
    model.add(Dense(2, activation="softmax"))

    clf = (NNClassifier(model, "sparse_categorical_crossentropy")
           .set_batch_size(64)
           .set_max_epoch(args.epochs)
           .set_learning_rate(1e-2))
    nn_model = clf.fit(df)
    out = nn_model.transform(df)
    acc = float((out["prediction"] == df["label"]).mean())
    print(f"transform accuracy: {acc:.3f}")
    print(out.head())


if __name__ == "__main__":
    main()
