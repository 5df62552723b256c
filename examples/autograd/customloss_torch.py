"""CustomLoss from a Variable expression, on the PyTorch/CUDA port.

The port of ``customloss.py``: define mean absolute error as a
Variable-graph over (y_true, y_pred) and train with it, on ``--device``
(default ``cuda``; ``--device cpu`` without a card).
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.pipeline.api import autograd as A
    from analytics_zoo_tpu_torch.pipeline.api.autograd import CustomLoss
    from analytics_zoo_tpu_torch.core.graph import Input
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense

    init_nncontext("autograd customloss example", device=args.device)

    # the reference builds the loss graph from Input variables
    y_true = Input((2,), name="y_true")
    y_pred = Input((2,), name="y_pred")
    expr = A.mean(A.abs(y_true - y_pred), axis=1)
    mae = CustomLoss.from_variables(y_true, y_pred, expr)

    rs = np.random.RandomState(0)
    x = rs.rand(256, 3).astype(np.float32)
    w = np.array([[1.0, -1.0], [0.5, 2.0], [-0.3, 0.1]], np.float32)
    y = x @ w

    model = Sequential(device=args.device)
    model.add(Dense(2, input_shape=(3,)))
    model.compile(optimizer="sgd", loss=mae)
    model.fit(x, y, batch_size=32, nb_epoch=args.epochs)
    print("final train MAE:",
          float(np.mean(np.abs(model.predict(x) - y))))


if __name__ == "__main__":
    main()
