"""Text classification with the built-in TextClassifier, on the
PyTorch/CUDA port.

The port of ``text_classification.py`` (encoders cnn/lstm/gru; synthetic
token sequences stand in for news20), on ``--device`` (default ``cuda``;
``--device cpu`` without a card).
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoder", default="cnn",
                    choices=["cnn", "lstm", "gru"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--sequence-length", type=int, default=50)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.models.textclassification import (
        TextClassifier)

    init_nncontext("text classification example", device=args.device)

    n_classes, vocab, token_len = 4, 200, 20
    rs = np.random.RandomState(0)
    # class-k documents are biased toward tokens near k * vocab/n_classes
    y = rs.randint(0, n_classes, size=args.samples).astype(np.int32)
    tokens = (y[:, None] * (vocab // n_classes)
              + rs.randint(0, vocab // n_classes,
                           size=(args.samples, args.sequence_length)))
    # pre-embed with a fixed random table (the GloVe stand-in; with a real
    # embedding file pass embedding_file= instead and feed raw token ids)
    table = rs.randn(vocab, token_len).astype(np.float32)
    x = table[tokens]

    model = TextClassifier(
        class_num=n_classes, token_length=token_len,
        sequence_length=args.sequence_length, encoder=args.encoder,
        encoder_output_dim=32, device=args.device)
    model.compile(optimizer="adam",
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x, y, batch_size=32, nb_epoch=args.epochs)
    print("train metrics:", model.evaluate(x, y, batch_size=32))


if __name__ == "__main__":
    main()
