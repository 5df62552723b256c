"""3D image augmentation app on the PyTorch/CUDA port: medical-volume
transform pipelines.

The port of ``augmentation_3d.py`` beside it (the reference's
apps/image-augmentation-3d): chain 3-D transformers — rotation, affine
warp, random/center crop — over volumetric images.  Volumes are
synthetic.  The transforms run on the host (numpy), as in the JAX
package; each cropped volume is then uploaded to ``--device`` (default
``cuda``; ``--device cpu`` without a card), where a model would consume
it.
"""

import argparse

import numpy as np


def synthetic_volume(rs, n):
    """A bright slab inside noise, so transforms visibly act."""
    vol = rs.rand(n, n, n).astype(np.float32) * 0.1
    vol[n // 3: 2 * n // 3, :, :] += 1.0
    return vol


def augment(vol, mat, seed):
    """Rotate -> affine warp by ``mat`` -> random crop 24^3 (from
    ``seed``) -> center crop 16^3."""
    from analytics_zoo_tpu_torch.feature.image3d.transforms import (
        AffineTransform3D, CenterCrop3D, RandomCrop3D, Rotate3D)
    rotated = Rotate3D([0.0, np.pi / 8, np.pi / 6]).apply({"image": vol})
    warped = AffineTransform3D(mat).apply(rotated)
    random_crop = RandomCrop3D([24, 24, 24], seed=seed).apply(warped)
    return np.asarray(CenterCrop3D([16, 16, 16]).apply(random_crop)["image"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--volumes", type=int, default=3)
    ap.add_argument("--size", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    import torch

    from analytics_zoo_tpu_torch.common.context import resolve_device

    device = resolve_device(args.device)
    rs = np.random.RandomState(0)
    n = args.size
    for i in range(args.volumes):
        vol = synthetic_volume(rs, n)
        mat = np.eye(3) + rs.uniform(-0.1, 0.1, (3, 3))
        out = torch.as_tensor(augment(vol, mat, seed=i), device=device)
        print(f"volume {i}: {vol.shape} -> rotate -> affine -> "
              f"crop {tuple(out.shape)}, mean {float(out.mean()):.4f}")
        assert out.shape == (16, 16, 16)
    print(f"3d augmentation done: {args.volumes} volumes")


if __name__ == "__main__":
    main()
