"""Wide & Deep on synthetic tabular features, on the PyTorch/CUDA port.

The port of ``wide_and_deep_example.py``: categorical wide ids +
indicator/embedding/continuous deep features, trained end to end on
``--device`` (default ``cuda``; ``--device cpu`` without a card).
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--model-type", default="wide_n_deep",
                    choices=["wide", "deep", "wide_n_deep"])
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.models.recommendation import (
        ColumnFeatureInfo, WideAndDeep)

    init_nncontext("wide and deep example", device=args.device)

    rs = np.random.RandomState(0)
    n = 1024
    gender = rs.randint(0, 2, n)          # wide base col, dim 2
    occupation = rs.randint(0, 10, n)     # wide base col, dim 10
    age_bucket = rs.randint(0, 6, n)      # indicator col, dim 6
    user_id = rs.randint(0, 50, n)        # embed col, 50 -> 8
    income = rs.rand(n).astype(np.float32)  # continuous

    info = ColumnFeatureInfo(
        wide_base_cols=["gender", "occupation"],
        wide_base_dims=[2, 10],
        indicator_cols=["age_bucket"], indicator_dims=[6],
        embed_cols=["user_id"], embed_in_dims=[50], embed_out_dims=[8],
        continuous_cols=["income"])

    # wide ids offset into the concatenated wide space (getWide parity)
    wide = np.stack([gender, 2 + occupation], axis=1).astype(np.int32)
    indicator = np.eye(6, dtype=np.float32)[age_bucket]
    deep = np.concatenate(
        [indicator, user_id[:, None].astype(np.float32),
         income[:, None]], axis=1)

    # label correlated with features so training shows progress
    y = ((gender + (occupation > 5) + (income > 0.5)) % 2).astype(np.int32)

    model = WideAndDeep(model_type=args.model_type, num_classes=2,
                        column_info=info, hidden_layers=(16, 8),
                        device=args.device)
    # log-softmax head -> ClassNLL criterion (reference parity)
    model.compile(optimizer="adam", loss="class_nll",
                  metrics=["accuracy"])
    x = {"wide": [wide, deep], "deep": [deep],
         "wide_n_deep": [wide, deep]}[args.model_type]
    if args.model_type == "wide":
        x = [wide]
    model.fit(x, y, batch_size=64, nb_epoch=args.epochs)
    print("train metrics:", model.evaluate(x, y, batch_size=64))


if __name__ == "__main__":
    main()
