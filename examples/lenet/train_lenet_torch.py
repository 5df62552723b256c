"""LeNet training on the PyTorch/CUDA port — the north-star config.

The port of ``train_lenet.py``: a Dataset over (synthetic) MNIST-like
arrays, a LeNet Sequential, Adam, checkpointing and validation each
epoch, on ``--device`` (default ``cuda``; ``--device cpu`` without a
card).  ``evaluate_lenet_torch.py`` reads the checkpoint back.
"""

import argparse

import numpy as np


def synthetic_mnist(n=512, seed=0):
    """Digit-like synthetic data: each class is a noisy template."""
    rs = np.random.RandomState(seed)
    templates = rs.rand(10, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, size=n).astype(np.int32)
    x = templates[y] + 0.3 * rs.rand(n, 28, 28).astype(np.float32)
    return x[..., None], y


def build_lenet(device=None):
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolutional \
        import Convolution2D
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (
        Dense, Dropout, Flatten)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.pooling import (
        MaxPooling2D)

    model = Sequential(name="lenet", device=device)
    model.add(Convolution2D(32, 5, 5, activation="relu",
                            border_mode="same", input_shape=(28, 28, 1)))
    model.add(MaxPooling2D())
    model.add(Convolution2D(64, 5, 5, activation="relu",
                            border_mode="same"))
    model.add(MaxPooling2D())
    model.add(Flatten())
    model.add(Dense(1024, activation="relu"))
    model.add(Dropout(0.5))
    model.add(Dense(10, activation="softmax"))
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common.context import init_nncontext

    ctx = init_nncontext(app_name="train_lenet", device=args.device)
    print(f"context: {ctx}")

    x, y = synthetic_mnist(args.samples)
    xv, yv = synthetic_mnist(max(args.samples // 4, args.batch_size),
                             seed=1)

    model = build_lenet(args.device)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    if args.checkpoint:
        model.set_checkpoint(args.checkpoint)
    model.fit(x, y, batch_size=args.batch_size, nb_epoch=args.epochs,
              validation_data=(xv, yv))
    result = model.evaluate(xv, yv, batch_size=args.batch_size)
    print("validation:", result)
    if args.checkpoint:
        print(f"checkpoints under {args.checkpoint}")


if __name__ == "__main__":
    main()
