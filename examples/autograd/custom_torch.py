"""Custom layer via the autograd DSL + Lambda, on the PyTorch/CUDA port.

The port of ``custom.py``: fit a 2-layer model whose middle layer is a
user-defined expression (a Parameter plus a Lambda-composed activation),
trained with a CustomLoss, on ``--device`` (default ``cuda``;
``--device cpu`` without a card).
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    import torch
    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.pipeline.api import autograd as A
    from analytics_zoo_tpu_torch.pipeline.api.autograd import (
        CustomLoss, Lambda, Parameter)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense
    from analytics_zoo_tpu_torch.core.graph import Input

    init_nncontext("autograd custom example", device=args.device)

    rs = np.random.RandomState(0)
    x = rs.rand(args.samples, 4).astype(np.float32)
    w_true = np.array([1.5, -2.0, 0.7, 0.1], np.float32)
    y = (x @ w_true)[:, None].astype(np.float32)

    inp = Input((4,), name="features")
    hidden = Dense(8)(inp)
    # custom expression: scale hidden by a learned per-unit gate
    gate = Parameter((8,), init_method="one", name="gate")
    gated = hidden * gate
    act = Lambda(lambda t: torch.tanh(t))(gated)
    out = Dense(1)(act)
    model = Model(input=inp, output=out, name="custom_model",
                  device=args.device)

    # mean absolute error, written as an autograd expression
    loss = CustomLoss(lambda y_true, y_pred: A.mean(
        A.abs(y_true - y_pred), axis=1))

    model.compile(optimizer="adam", loss=loss)
    model.fit(x, y, batch_size=32, nb_epoch=args.epochs)
    pred = model.predict(x[:4])
    print("pred:", np.asarray(pred).ravel())
    print("true:", y[:4].ravel())


if __name__ == "__main__":
    main()
