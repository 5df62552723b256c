"""Serving with the PyTorch/CUDA port's InferenceModel (concurrent,
optionally int8).

The port of ``serving_example.py``: load once, predict from many
threads, on ``--device`` (default ``cuda``; ``--device cpu`` without a
card).
"""

import argparse
import threading

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--coalesce", action="store_true",
                    help="pack concurrent callers into one padded "
                         "device dispatch (serving fast path)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import (
        InferenceModel)

    init_nncontext("serving example", device=args.device)
    rs = np.random.RandomState(0)
    model = Sequential(device=args.device)
    model.add(Dense(32, activation="relu", input_shape=(16,)))
    model.add(Dense(4, activation="softmax"))
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    model.fit(rs.rand(128, 16).astype(np.float32),
              rs.randint(0, 4, 128), batch_size=32, nb_epoch=1)

    served = InferenceModel(supported_concurrent_num=args.concurrency,
                            max_batch_size=32,
                            coalescing=args.coalesce,
                            max_wait_ms=args.max_wait_ms,
                            device=args.device)
    served.load_keras_net(model, quantize=args.quantize)
    if not args.quantize:
        # build the whole bucket ladder before traffic arrives
        served.warmup((16,))

    results = {}

    def client(i):
        x = rs.rand(8, 16).astype(np.float32)
        results[i] = np.asarray(served.predict(x))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(args.concurrency * 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = served.serving_stats()
    print(f"served {len(results)} concurrent requests; "
          f"output shape {results[0].shape}; quantized={args.quantize}; "
          f"buckets {stats['buckets']} misses {stats['misses']} "
          f"dispatches {stats['dispatches']}")
    served.close()


if __name__ == "__main__":
    main()
