"""TFNet app on the PyTorch/CUDA port: image-classification inference
from a user's TF graph.

The port of ``image_classification_inference.py`` beside it (the
reference's apps/tfnet/image_classification_inference.ipynb: load a
frozen TF image-classification graph with TFNet and run inference over
an ImageSet).  The "pretrained" graph is the JAX app's small CNN, frozen
with seeded weights and written here with the port's own GraphDef codec
(``pipeline/api/tfgraph/proto.py``), so no ``tensorflow`` is needed to
build, load or run it; TFNet converts it to torch ops once, and the app
drives it through the same preprocess -> forward -> top-k flow.  Runs on
``--device`` (default ``cuda``; ``--device cpu`` without a card).
"""

import argparse

import numpy as np

INPUT, OUTPUT = "input:0", "probs:0"


def build_graph_def(seed=0):
    """The frozen graph as GraphDef bytes: Conv2D 3x3 8 SAME + BiasAdd +
    Relu, MaxPool 2x2 VALID, Reshape to 2048, MatMul to 5 + BiasAdd
    (``logits``), Softmax (``probs``); every variable glorot-uniform
    (TF's default for ``get_variable``) from ``seed``."""
    from analytics_zoo_tpu_torch.pipeline.api.tfgraph import proto as P

    rng = np.random.default_rng(seed)
    f32 = np.float32

    def glorot(*shape):
        receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        fan_in = shape[-2] * receptive if len(shape) > 1 else shape[0]
        fan_out = shape[-1] * receptive
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-limit, limit, shape).astype(f32)

    nodes = [
        P.placeholder("input", (None, 32, 32, 3)),
        P.const("k", glorot(3, 3, 3, 8)),
        P.const("b", glorot(8)),
        P.make_node("Conv2D", "conv", ["input", "k"], T=f32,
                    strides=[1, 1, 1, 1], padding="SAME",
                    data_format="NHWC", dilations=[1, 1, 1, 1]),
        P.make_node("BiasAdd", "bias", ["conv", "b"], T=f32,
                    data_format="NHWC"),
        P.make_node("Relu", "relu", ["bias"], T=f32),
        P.make_node("MaxPool", "pool", ["relu"], T=f32,
                    ksize=[1, 2, 2, 1], strides=[1, 2, 2, 1],
                    padding="VALID", data_format="NHWC"),
        P.const("flat_shape", np.array([-1, 16 * 16 * 8], np.int32)),
        P.make_node("Reshape", "flat", ["pool", "flat_shape"], T=f32,
                    Tshape=np.int32),
        P.const("w", glorot(16 * 16 * 8, 5)),
        P.make_node("MatMul", "matmul", ["flat", "w"], T=f32,
                    transpose_a=False, transpose_b=False),
        P.const("b2", glorot(5)),
        P.make_node("BiasAdd", "logits", ["matmul", "b2"], T=f32,
                    data_format="NHWC"),
        P.make_node("Softmax", "probs", ["logits"], T=f32),
    ]
    return P.encode(P.make_graph(nodes))


def preprocess(raw):
    """The app's ImageSet pipeline: resize to 32x32, normalise by the
    channel means and stds, to a tensor array."""
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    from analytics_zoo_tpu_torch.feature.image.transforms import (
        ImageChannelNormalize, ImageMatToTensor, ImageResize)
    pipeline = (ImageResize(32, 32)
                >> ImageChannelNormalize(123.0, 117.0, 104.0, 58.0, 57.0,
                                         57.0)
                >> ImageMatToTensor())
    return ImageSet.from_arrays(raw).transform(pipeline).to_array()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.pipeline.api.tfgraph.net import TFNet

    net = TFNet(graph_def=build_graph_def(), input_names=[INPUT],
                output_names=[OUTPUT], device=args.device)

    rs = np.random.RandomState(0)
    raw = (rs.rand(args.images, 48, 48, 3) * 255).astype(np.float32)
    batch = preprocess(raw)

    out = np.asarray(net.predict(batch))
    top1 = out.argmax(axis=1)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-4)
    for i in range(args.images):
        print(f"image {i}: class {int(top1[i])} "
              f"(p={float(out[i, top1[i]]):.3f})")
    print(f"tfnet inference done: {args.images} images, "
          f"{out.shape[1]} classes")


if __name__ == "__main__":
    main()
