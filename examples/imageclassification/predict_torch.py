"""Image classification with the model-zoo registry (+ int8 variant), on
the PyTorch/CUDA port.

The port of ``imageclassification/predict.py``: predict images with a
registry model, LabelOutput top-k, on ``--device`` (default ``cuda``;
``--device cpu`` without a card).  Uses generated images; pass
--image-folder for real ones.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="squeezenet",
                    help="registry name; append -quantize for int8")
    ap.add_argument("--image-folder", default=None)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.models.image.classification import (
        ImageClassifier, label_output)

    init_nncontext("image classification example", device=args.device)

    model = ImageClassifier(args.model,
                            input_shape=(args.size, args.size, 3),
                            num_classes=args.classes, device=args.device)

    if args.image_folder:
        from analytics_zoo_tpu_torch.data.image_loader import ImageLoader
        loader = ImageLoader.from_folder(
            args.image_folder, with_label=False, batch_size=8,
            size=(args.size, args.size), scale=1 / 255.0)
        x = loader.as_dataset().x
    else:
        x = np.random.RandomState(0).rand(
            8, args.size, args.size, 3).astype(np.float32)

    probs = model.predict(x, batch_size=8)
    for i, row in enumerate(label_output(probs, top_k=args.top_k)):
        print(f"image {i}: {row}")


if __name__ == "__main__":
    main()
