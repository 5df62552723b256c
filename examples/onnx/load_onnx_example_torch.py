"""Import an ONNX model and run it on the PyTorch/CUDA port.

The port of ``load_onnx_example.py``: builds a small ONNX file
programmatically (the ``onnx`` package is not required — the port
carries its own codec), then loads it as a net on ``--device`` (default
``cuda``; ``--device cpu`` without a card) and runs it.
"""

import argparse
import os
import tempfile

import numpy as np


def build_onnx_file(path: str):
    from analytics_zoo_tpu_torch.pipeline.api.onnx import proto as P

    rs = np.random.RandomState(0)
    w1 = (rs.randn(8, 16) * 0.3).astype(np.float32)
    w2 = (rs.randn(16, 4) * 0.3).astype(np.float32)
    nodes = [
        P.make_node("Gemm", ["x", "w1"], ["h"]),
        P.make_node("Relu", ["h"], ["hr"]),
        P.make_node("Gemm", ["hr", "w2"], ["logits"]),
        P.make_node("Softmax", ["logits"], ["y"], axis=-1),
    ]
    graph = P.make_graph(
        nodes, "mlp", [P.make_value_info("x", ("N", 8))],
        [P.make_value_info("y", ("N", 4))],
        initializer=[P.numpy_to_tensor(w1, "w1"),
                     P.numpy_to_tensor(w2, "w2")])
    with open(path, "wb") as f:
        f.write(P.encode(P.make_model(graph)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None,
                    help="path to a .onnx file (generated if missing; "
                         "by default a fresh one in a new temporary "
                         "directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:  # the default file's home
        if args.model is None:
            args.model = os.path.join(tmp, "example_mlp.onnx")
        run(args.model, args.device)


def run(path, device):
    if not os.path.exists(path):
        build_onnx_file(path)
        print("generated", path)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.pipeline.api.net import Net

    init_nncontext("onnx example", device=device)
    net = Net.load_onnx(path, device=device)
    x = np.random.RandomState(1).randn(5, 8).astype(np.float32)
    preds = net.predict(x)
    print("predictions:", np.round(preds, 3))
    print("row sums:", preds.sum(-1))


if __name__ == "__main__":
    main()
