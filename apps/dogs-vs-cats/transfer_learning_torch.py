"""Transfer learning on the PyTorch/CUDA port: freeze a pretrained
backbone, retrain the head.

The port of ``transfer_learning.py`` beside it (the reference's
apps/dogs-vs-cats: load inception, freeze_up_to, add a new head, short
fine-tune).  A small CNN pretrained on task A stands in for the
downloaded checkpoint; the GraphNet surgery is the same.  Runs on
``--device`` (default ``cuda``; ``--device cpu`` without a card).
"""

import argparse

import numpy as np


def make_task(seed, n=256, size=16):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 2, n).astype(np.int32)
    x = rs.rand(n, size, size, 3).astype(np.float32) * 0.4
    # class signal: bright patch top-left vs bottom-right
    for i, yi in enumerate(y):
        if yi:
            x[i, :4, :4] += 0.6
        else:
            x[i, -4:, -4:] += 0.6
    return x, y


def build_base(device):
    """The "pretrained" backbone with its original head (task A)."""
    from analytics_zoo_tpu_torch.core.graph import Input
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolutional \
        import Convolution2D
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.pooling import (
        GlobalAveragePooling2D)

    inp = Input((16, 16, 3), name="image")
    feat = Convolution2D(8, 3, 3, activation="relu",
                         name="backbone_conv1")(inp)
    feat = Convolution2D(16, 3, 3, activation="relu",
                         name="backbone_conv2")(feat)
    pooled = GlobalAveragePooling2D(name="backbone_pool")(feat)
    head_a = Dense(2, activation="softmax", name="head_a")(pooled)
    return Model(input=inp, output=head_a, name="base", device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense
    from analytics_zoo_tpu_torch.pipeline.api.net import GraphNet

    base = build_base(args.device)
    xa, ya = make_task(seed=0)
    base.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                 metrics=["accuracy"])
    base.fit(xa, ya, batch_size=32, nb_epoch=args.epochs)
    print("task A:", base.evaluate(xa, ya, batch_size=32))

    # surgery: re-root on the pooled features, freeze the backbone,
    # attach a new head for task B
    net = GraphNet.from_model(base)
    net.freeze_up_to(["backbone_pool"])
    print("frozen layers:", net.frozen_layer_names())
    trunk = net.new_graph(["backbone_pool"])
    features = trunk.outputs[0]
    head_b = Dense(2, activation="softmax", name="head_b")(features)
    tuned = Model(input=trunk.inputs, output=head_b, name="tuned",
                  device=args.device)

    xb, yb = make_task(seed=7)
    tuned.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    # pull the pretrained backbone weights into the re-rooted model
    tuned.transfer_weights_from(base)
    tuned.fit(xb, yb, batch_size=32, nb_epoch=args.epochs)
    print("task B (frozen backbone):",
          tuned.evaluate(xb, yb, batch_size=32))


if __name__ == "__main__":
    main()
