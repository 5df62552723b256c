"""Object detection app on the PyTorch/CUDA port: SSD predict + visualize.

The port of ``object_detection.py`` beside it: the model-zoo SSD
(``--model``, default ``ssd-mobilenet-300`` at its 300x300 input) runs
``predict_image_set`` over synthetic frames, decodes and suppresses the
boxes on the model's device, and writes each frame annotated as a PNG.
Runs on ``--device`` (default ``cuda``; ``--device cpu`` without a
card).  Without ``--out-dir`` the PNGs go to a fresh temporary
directory, printed.
"""

import argparse
import os
import tempfile

import numpy as np


def synthetic_frames(n, seed=0):
    """A synthetic "video": ``n`` 300x300 frames of noise with a bright
    square object each."""
    rs = np.random.RandomState(seed)
    frames = rs.rand(n, 300, 300, 3).astype(np.float32) * 60
    for i in range(n):
        cx, cy = rs.randint(60, 240, 2)
        frames[i, cy - 30:cy + 30, cx - 30:cx + 30] = 220.0
    return frames


def build_detector(model, num_classes, device):
    from analytics_zoo_tpu_torch.models.image.detection import ObjectDetector
    return ObjectDetector(model_name=model, num_classes=num_classes,
                          conf_threshold=0.05, max_detections=20,
                          device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ssd-mobilenet-300",
                    help="registry name (ssd-vgg16-300, ssd-mobilenet-300,"
                         " ...)")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--num-classes", type=int, default=6)
    ap.add_argument("--out-dir", default=None,
                    help="where the annotated PNGs go (default: a fresh "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from PIL import Image

    from analytics_zoo_tpu_torch.feature.image import ImageSet
    from analytics_zoo_tpu_torch.models.image.detection import visualize

    detector = build_detector(args.model, args.num_classes, args.device)
    frames = synthetic_frames(args.frames)
    image_set = detector.predict_image_set(ImageSet.from_arrays(frames))
    label_map = {i: f"class{i}" for i in range(args.num_classes)}

    out_dir = args.out_dir or tempfile.mkdtemp(prefix="zoo_object_detection-")
    os.makedirs(out_dir, exist_ok=True)
    print(f"writing annotated frames to {out_dir}")
    for i, feature in enumerate(image_set.features):
        dets = feature["predict"]
        kept = dets[dets[:, 0] >= 0]
        annotated = visualize(frames[i], dets, label_map=label_map,
                              threshold=0.0)
        out_path = os.path.join(out_dir, f"frame{i}.png")
        Image.fromarray(annotated).save(out_path)
        print(f"frame {i}: {len(kept)} raw detections -> {out_path}")
    print(f"object detection done: {args.frames} frames annotated")


if __name__ == "__main__":
    main()
