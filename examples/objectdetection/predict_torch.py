"""SSD object detection over an ImageSet, on the PyTorch/CUDA port.

The port of ``objectdetection/predict.py`` (ObjectDetector +
predict_image_set + visualize) on ``--device`` (default ``cuda``;
``--device cpu`` without a card).  Untrained weights — demonstrates the
pipeline shape: preprocess, forward, box decode, rescale, visualize.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ssd-mobilenet-300")
    ap.add_argument("--classes", type=int, default=21)
    ap.add_argument("--out", default=None,
                    help="write a visualization PNG of image 0 here")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.feature.image.imageset import ImageSet
    from analytics_zoo_tpu_torch.models.image.detection import ObjectDetector
    from analytics_zoo_tpu_torch.common import init_nncontext

    init_nncontext("object detection example", device=args.device)

    detector = ObjectDetector(args.model, num_classes=args.classes,
                              conf_threshold=0.2, max_detections=10,
                              device=args.device)
    size = detector.image_size
    rs = np.random.RandomState(0)
    images = rs.rand(2, size, size, 3).astype(np.float32)
    image_set = ImageSet.from_arrays(images)

    result = detector.predict_image_set(image_set)
    # get_predicts: list of (uri, padded detections); valid rows have
    # class id >= 0, columns are [class, score, x1, y1, x2, y2]
    all_dets = []
    for i, (uri, dets) in enumerate(result.get_predicts()):
        valid = dets[dets[:, 0] >= 0]
        all_dets.append(valid)
        print(f"image {i}: {len(valid)} detections")
        for cls, score, x1, y1, x2, y2 in valid[:3]:
            print(f"  class {int(cls)} score {score:.3f} "
                  f"box ({x1:.0f},{y1:.0f})-({x2:.0f},{y2:.0f})")

    if args.out:
        from PIL import Image
        from analytics_zoo_tpu_torch.models.image.detection import visualize
        img = (images[0] * 255).astype(np.uint8)
        drawn = visualize(img, all_dets[0])
        Image.fromarray(np.asarray(drawn)).save(args.out)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
