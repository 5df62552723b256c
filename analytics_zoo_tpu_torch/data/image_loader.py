"""Batched host-side image loader: files to model-ready float batches.

Counterpart of ``analytics_zoo_tpu/data/image_loader.py``: decode,
resize and normalize of a whole batch in one call of the port's native
library (libjpeg/libpng and a thread pool, ``analytics_zoo_tpu_torch/
native``), the next batch decoded on a background thread while the
consumer works; PIL per image when the native library is not built.
Batches are numpy, NHWC RGB; they go to the card in the model's
``predict`` or ``fit``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from .dataset import Dataset

_IMG_EXTS = (".jpg", ".jpeg", ".png")


def list_image_files(path: str, with_label: bool = False):
    """Recursively list image files; with_label uses the immediate
    subdirectory name as the class label (same layout ImageSet.read
    consumes)."""
    files: List[str] = []
    labels: List[int] = []
    label_names: List[str] = []
    if with_label:
        label_names = sorted(
            d for d in os.listdir(path)
            if os.path.isdir(os.path.join(path, d)))
        index = {name: i for i, name in enumerate(label_names)}
        for name in label_names:
            sub = os.path.join(path, name)
            for root, _, fnames in os.walk(sub):
                for f in sorted(fnames):
                    if f.lower().endswith(_IMG_EXTS):
                        files.append(os.path.join(root, f))
                        labels.append(index[name])
    else:
        for root, _, fnames in os.walk(path):
            for f in sorted(fnames):
                if f.lower().endswith(_IMG_EXTS):
                    files.append(os.path.join(root, f))
    return files, (np.asarray(labels, np.int32) if with_label else None), \
        label_names


def _decode_batch_pil(blobs: Sequence[bytes], size, mean, std, scale):
    import io
    from PIL import Image
    h, w = size
    out = np.empty((len(blobs), h, w, 3), np.float32)
    for i, raw in enumerate(blobs):
        img = Image.open(io.BytesIO(raw)).convert("RGB")
        if img.size != (w, h):
            img = img.resize((w, h), Image.BILINEAR)
        out[i] = np.asarray(img, np.float32)
    out *= scale
    if mean is not None:
        out -= np.asarray(mean, np.float32)
    if std is not None:
        out /= np.asarray(std, np.float32)
    return out


class ImageLoader:
    """Iterate (images, labels) batches decoded natively off the main
    thread.

    images: float32 (B, H, W, 3) RGB, normalized
    ``(pixel * scale - mean) / std``.
    """

    def __init__(self, files: Sequence[str],
                 labels: Optional[np.ndarray] = None,
                 batch_size: int = 32, size=(224, 224),
                 mean: Optional[Sequence[float]] = None,
                 std: Optional[Sequence[float]] = None,
                 scale: float = 1.0, shuffle: bool = False, seed: int = 0,
                 num_threads: int = 0, drop_remainder: bool = False,
                 prefetch: int = 2, out_dtype: str = "float32"):
        self.files = list(files)
        self.labels = labels if labels is None else np.asarray(labels)
        if self.labels is not None and len(self.labels) != len(self.files):
            raise ValueError("labels/files length mismatch")
        self.batch_size = int(batch_size)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.mean, self.std, self.scale = mean, std, float(scale)
        self.shuffle, self.seed = shuffle, seed
        self.num_threads = num_threads
        self.drop_remainder = drop_remainder
        self.prefetch = max(int(prefetch), 1)
        self._epoch = 0
        # out_dtype="uint8": emit raw resized pixels and DEFER
        # normalization to the device — a 4x smaller host→device transfer
        # (the normalize belongs in the model's step on the card)
        if out_dtype not in ("float32", "uint8"):
            raise ValueError(f"unsupported out_dtype {out_dtype!r}")
        if out_dtype == "uint8" and (mean is not None or std is not None
                                     or scale != 1.0):
            raise ValueError(
                "out_dtype='uint8' emits RAW pixels — normalization "
                "(mean/std/scale) must be applied on-device by the "
                "consumer; passing it here would be silently dropped")
        self.out_dtype = out_dtype

    @classmethod
    def from_folder(cls, path: str, with_label: bool = True, **kw
                    ) -> "ImageLoader":
        files, labels, names = list_image_files(path, with_label)
        loader = cls(files, labels=labels, **kw)
        loader.label_names = names
        return loader

    def steps_per_epoch(self) -> int:
        n = len(self.files)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _decode(self, blobs: List[bytes]) -> np.ndarray:
        if self.out_dtype == "uint8":
            if native.available():
                # the native decoder emits float32; the cast-down costs a
                # host pass (~4 bytes/px) — only the host→device transfer
                # shrinks.  A native uint8 output mode would remove it.
                raw = native.decode_resize_normalize_batch(
                    blobs, self.size, mean=None, std=None, scale=1.0,
                    num_threads=self.num_threads)
                return raw.astype(np.uint8)
            import io
            from PIL import Image
            h, w = self.size
            out = np.empty((len(blobs), h, w, 3), np.uint8)
            for i, raw in enumerate(blobs):
                img = Image.open(io.BytesIO(raw)).convert("RGB")
                if img.size != (w, h):
                    img = img.resize((w, h), Image.BILINEAR)
                out[i] = np.asarray(img, np.uint8)
            return out
        if native.available():
            return native.decode_resize_normalize_batch(
                blobs, self.size, mean=self.mean, std=self.std,
                scale=self.scale, num_threads=self.num_threads)
        return _decode_batch_pil(blobs, self.size, self.mean, self.std,
                                 self.scale)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        order = np.arange(len(self.files))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        n = len(order)
        stop = n - n % self.batch_size if self.drop_remainder else n
        starts = list(range(0, stop, self.batch_size))
        if not starts:
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer abandoned the
            # iterator — an unconditional q.put would block this thread
            # forever holding decoded batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for s in starts:
                    idx = order[s:s + self.batch_size]
                    blobs = []
                    for i in idx:
                        with open(self.files[i], "rb") as f:
                            blobs.append(f.read())
                    imgs = self._decode(blobs)
                    y = (self.labels[idx]
                         if self.labels is not None else None)
                    if not _put((imgs, y)):
                        return
                _put(_END)
            except BaseException as e:  # surface errors on the consumer
                _put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so a blocked producer sees the stop promptly
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def as_dataset(self) -> Dataset:
        """Materialize the whole loader into an in-memory Dataset."""
        xs, ys = [], []
        for imgs, y in self:
            xs.append(imgs)
            if y is not None:
                ys.append(y)
        x = np.concatenate(xs) if xs else np.empty((0,) + self.size + (3,),
                                                   np.float32)
        if ys:
            return Dataset(x, np.concatenate(ys))
        return Dataset(x)
