"""Image augmentation pipelines, 2D and 3D, on the PyTorch/CUDA port.

The port of ``augmentation.py`` beside it (the reference's
apps/image-augmentation and image-augmentation-3d): chain
feature-engineering transformers (the reference's ``->`` composition is
``>>`` here) over an ImageSet / 3D tensor.  The transforms run on the
host (numpy), as in the JAX package; each output batch is then uploaded
to ``--device`` (default ``cuda``; ``--device cpu`` without a card),
where a model would consume it.
"""

import argparse

import numpy as np


def augment_2d(images):
    """Resize 32x32 -> center crop 24x24 -> horizontal flip -> brightness
    +10 -> channel normalisation, over an ImageSet of ``images``."""
    from analytics_zoo_tpu_torch.feature.image.imageset import ImageSet
    from analytics_zoo_tpu_torch.feature.image.transforms import (
        ImageBrightness, ImageCenterCrop, ImageChannelNormalize,
        ImageHFlip, ImageResize)

    pipeline = (ImageResize(32, 32)
                >> ImageCenterCrop(24, 24)
                >> ImageHFlip(probability=1.0)
                >> ImageBrightness(delta_low=10, delta_high=10)
                >> ImageChannelNormalize(123.0, 117.0, 104.0))
    return ImageSet.from_arrays(images).transform(pipeline).to_array()


def augment_3d(volume):
    """Rotate a volume by pi/6 about the last axis, then center crop it to
    16^3."""
    from analytics_zoo_tpu_torch.feature.image3d.transforms import (
        CenterCrop3D, Rotate3D)
    rotated = Rotate3D([0.0, 0.0, np.pi / 6]).apply({"image": volume})
    return np.asarray(CenterCrop3D([16, 16, 16]).apply(rotated)["image"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    import torch

    from analytics_zoo_tpu_torch.common.context import resolve_device

    device = resolve_device(args.device)
    rs = np.random.RandomState(0)
    images = (rs.rand(4, 40, 48, 3) * 255).astype(np.float32)
    arr = augment_2d(images)
    batch = torch.as_tensor(arr, device=device)
    print("2D pipeline output:", tuple(batch.shape), "mean",
          float(arr.mean()))

    # 3D medical-style volume
    volume = rs.rand(32, 32, 32).astype(np.float32)
    cropped = torch.as_tensor(augment_3d(volume), device=device)
    print("3D pipeline output:", tuple(cropped.shape))
    print(f"batches on {device}")


if __name__ == "__main__":
    main()
