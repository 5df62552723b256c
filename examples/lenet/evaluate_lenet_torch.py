"""Evaluate a LeNet trained by ``train_lenet_torch.py`` from its
checkpoint directory, on the PyTorch/CUDA port (the port of
``evaluate_lenet.py``)."""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True,
                    help="directory written by train_lenet_torch --checkpoint")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from train_lenet_torch import build_lenet, synthetic_mnist

    init_nncontext(app_name="evaluate_lenet", device=args.device)
    model = build_lenet(args.device)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.load_weights(args.checkpoint)
    x, y = synthetic_mnist(args.samples, seed=1)
    print("evaluation:", model.evaluate(x, y, batch_size=args.batch_size))


if __name__ == "__main__":
    main()
