"""Image similarity search over CNN embeddings, on the PyTorch/CUDA port.

The port of ``image_similarity.py`` beside it (the reference's
apps/image-similarity: extract deep features, rank by cosine
similarity).  Embeddings come from an intermediate layer via new_graph
surgery.  Runs on ``--device`` (default ``cuda``; ``--device cpu``
without a card).
"""

import argparse

import numpy as np

SIZE = 24


def build_model(device):
    from analytics_zoo_tpu_torch.core.graph import Input
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolutional \
        import Convolution2D
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.pooling import (
        GlobalAveragePooling2D)

    inp = Input((SIZE, SIZE, 3), name="image")
    h = Convolution2D(8, 3, 3, activation="relu")(inp)
    h = Convolution2D(16, 3, 3, activation="relu")(h)
    emb = GlobalAveragePooling2D(name="embedding")(h)
    out = Dense(4, activation="softmax")(emb)
    return Model(input=inp, output=out, name="feature_net", device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gallery", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.pipeline.api.net import GraphNet

    model = build_model(args.device)

    # gallery: 4 visual styles (color casts)
    rs = np.random.RandomState(0)
    styles = rs.rand(4, 1, 1, 3).astype(np.float32)
    labels = rs.randint(0, 4, args.gallery)
    gallery = (rs.rand(args.gallery, SIZE, SIZE, 3).astype(np.float32)
               * 0.3 + styles[labels])

    embedder = GraphNet.from_model(model).new_graph(["embedding"])
    feats = np.asarray(embedder.predict(gallery, batch_size=32))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-8

    query_label = 2
    query = (rs.rand(1, SIZE, SIZE, 3).astype(np.float32) * 0.3
             + styles[query_label])
    q = np.asarray(embedder.predict(query, batch_size=1))
    q /= np.linalg.norm(q) + 1e-8

    sims = feats @ q.ravel()
    top = np.argsort(-sims)[:5]
    print("query style:", query_label)
    for rank, idx in enumerate(top):
        print(f"  #{rank + 1}: gallery[{idx}] style={labels[idx]} "
              f"cos={sims[idx]:.3f}")
    hit = (labels[top] == query_label).mean()
    print(f"top-5 purity: {hit:.2f}")


if __name__ == "__main__":
    main()
