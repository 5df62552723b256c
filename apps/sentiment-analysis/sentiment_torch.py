"""Sentiment analysis on the PyTorch/CUDA port: embedding + BiLSTM
classifier.

The port of ``sentiment.py`` beside it (the reference's
apps/sentiment-analysis/sentiment.ipynb: IMDB reviews + GloVe
embeddings, recurrent encoders).  Runs on ``--device`` (default
``cuda``; ``--device cpu`` without a card).

REAL DATA: pass ``--data /path/to/aclImdb`` — the Large Movie Review
Dataset (Maas et al.), directory layout
``aclImdb/{train,test}/{pos,neg}/*.txt``.  Optionally ``--glove
/path/to/glove.6B.100d.txt`` initializes frozen word vectors through
``WordEmbedding``; otherwise the embedding trains from scratch.
Without ``--data`` a synthetic order-dependent sequence task keeps the
app runnable to an accuracy metric anywhere.
"""

import argparse
import os
import re

import numpy as np

_TOKEN = re.compile(r"[a-z']+")


def tokenize(text):
    return _TOKEN.findall(text.lower())


def load_imdb(root, split, max_docs=None):
    """Read aclImdb/{split}/{pos,neg}/*.txt -> (texts, labels)."""
    texts, labels = [], []
    for label, sub in ((1, "pos"), (0, "neg")):
        d = os.path.join(root, split, sub)
        files = sorted(os.listdir(d))
        if max_docs:
            files = files[:max_docs // 2]
        for f in files:
            with open(os.path.join(d, f), encoding="utf-8") as fh:
                texts.append(fh.read())
            labels.append(label)
    return texts, np.asarray(labels, np.int32)


def build_vocab(texts, max_words):
    from collections import Counter
    counts = Counter(w for t in texts for w in tokenize(t))
    # index 0 = padding, 1 = OOV (the reference's keras text pipeline)
    return {w: i + 2 for i, (w, _) in
            enumerate(counts.most_common(max_words - 2))}


def vectorize(texts, vocab, seq_len):
    out = np.zeros((len(texts), seq_len), np.int32)
    for r, t in enumerate(texts):
        ids = [vocab.get(w, 1) for w in tokenize(t)][:seq_len]
        out[r, :len(ids)] = ids      # left-aligned, zero-padded
    return out


def synthetic_task(n, seq_len, dim, seed=0):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 2, n).astype(np.int32)
    x = rs.randn(n, seq_len, dim).astype(np.float32) * 0.3
    trend = np.linspace(-1, 1, seq_len, dtype=np.float32)
    x[y == 1, :, 0] += trend
    x[y == 0, :, 0] -= trend
    return x, y


def build_model(device, seq_len, dim=None, max_words=None, glove=None,
                vocab=None):
    """The app's classifier: over token ids (``max_words``, or frozen
    GloVe vectors from ``glove`` for ``vocab``) when ``dim`` is None,
    else over ``dim``-wide synthetic feature sequences."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.recurrent import (
        Bidirectional, LSTM)

    model = Sequential(name="sentiment_bilstm", device=device)
    if dim is None:
        if glove:
            from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
                WordEmbedding)
            model.add(WordEmbedding(glove, vocab, trainable=False,
                                    input_length=seq_len))
        else:
            from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
                Embedding)
            model.add(Embedding(max_words, 64, input_shape=(seq_len,)))
        model.add(Bidirectional(LSTM(32)))
    else:
        model.add(Bidirectional(LSTM(16), input_shape=(seq_len, dim)))
    model.add(Dense(2, activation="softmax"))
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None,
                    help="aclImdb root dir; synthetic fallback if omitted")
    ap.add_argument("--glove", default=None,
                    help="GloVe .txt for frozen WordEmbedding init")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=30,
                    help="token window; raised to >=200 with --data "
                         "unless already larger")
    ap.add_argument("--max-words", type=int, default=20000)
    ap.add_argument("--max-docs", type=int, default=None,
                    help="cap docs per split (smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    if args.data:
        seq_len = max(args.seq_len, 200)   # reference uses 500; 200 for speed
        if seq_len != args.seq_len:
            print(f"note: raising --seq-len {args.seq_len} -> {seq_len}")
        train_texts, y_train = load_imdb(args.data, "train", args.max_docs)
        test_texts, y_test = load_imdb(args.data, "test", args.max_docs)
        vocab = build_vocab(train_texts, args.max_words)
        x_train = vectorize(train_texts, vocab, seq_len)
        x_test = vectorize(test_texts, vocab, seq_len)
        print(f"IMDB: {len(train_texts)} train / {len(test_texts)} test, "
              f"vocab {len(vocab) + 2}, seq_len {seq_len}")
        model = build_model(args.device, seq_len, max_words=args.max_words,
                            glove=args.glove, vocab=vocab)
    else:
        print("synthetic fallback (pass --data for aclImdb)")
        n, dim = 512, 8
        x_train, y_train = synthetic_task(n, args.seq_len, dim)
        x_test, y_test = synthetic_task(128, args.seq_len, dim, seed=1)
        model = build_model(args.device, args.seq_len, dim=dim)

    model.compile(optimizer="adam",
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x_train, y_train, batch_size=64, nb_epoch=args.epochs,
              validation_data=(x_test, y_test))
    res = model.evaluate(x_test, y_test, batch_size=64)
    print("test metrics:", res)
    if args.data:
        print("(reference notebook ballpark on full IMDB: ~0.85 test "
              "accuracy after a few epochs)")


if __name__ == "__main__":
    main()
