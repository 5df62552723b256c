"""The port's native image library (``native/``) and ``ImageLoader``
against the JAX package's, on the CPU.

Counterparts of ``tests/test_native_image.py`` (PIL and numpy as the
oracles, with its bounds), plus exact parity: the port builds its own
copy of ``zoo_native.cc`` (equal to the JAX package's) under
``build/native/``, and its decodes, resizes and normalized batches equal
the JAX package's library's bytes, and ``ImageLoader`` batches (native
and PIL routes) equal the JAX package's loader's.
"""

import io
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from analytics_zoo_tpu import native as jnative
from analytics_zoo_tpu.data.image_loader import ImageLoader as JImageLoader
from analytics_zoo_tpu_torch import native
from analytics_zoo_tpu_torch.data import image_loader
from analytics_zoo_tpu_torch.data.image_loader import (ImageLoader,
                                                       list_image_files)

REPO = Path(__file__).resolve().parents[1]
rs = np.random.RandomState(0)
IMG = rs.randint(0, 255, (37, 53, 3), dtype=np.uint8)


def make_png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def make_jpeg(arr, quality=95) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def nat():
    if not native.available():
        pytest.skip(f"native build unavailable: {native.build_error()}")
    return native


@pytest.fixture(scope="module")
def jnat():
    if not jnative.available():
        pytest.skip(f"JAX package's native build unavailable: "
                    f"{jnative.build_error()}")
    return jnative


def test_torch_native_builds_its_own_copy_under_build(nat):
    src = REPO / "analytics_zoo_tpu_torch" / "native" / "zoo_native.cc"
    assert src.read_bytes() == (
        REPO / "analytics_zoo_tpu" / "native" / "zoo_native.cc").read_bytes()
    lib = nat.library_path()
    assert lib.exists() and REPO / "build" / "native" in lib.parents
    assert not list(src.parent.glob("*.so"))
    assert nat.build_error() is None


class TestDecode:
    def test_torch_png_lossless_exact(self, nat):
        np.testing.assert_array_equal(nat.decode_image(make_png(IMG)), IMG)

    def test_torch_jpeg_matches_pil_and_jax(self, nat, jnat):
        raw = make_jpeg(IMG)
        out = nat.decode_image(raw)
        pil = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        assert np.abs(out.astype(int) - pil.astype(int)).max() <= 2
        np.testing.assert_array_equal(out, jnat.decode_image(raw))

    def test_torch_grayscale_jpeg_promoted_to_rgb(self, nat):
        gray = rs.randint(0, 255, (20, 24), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(gray, mode="L").save(buf, "JPEG", quality=95)
        out = nat.decode_image(buf.getvalue())
        assert out.shape == (20, 24, 3)
        assert np.abs(out[:, :, 0].astype(int)
                      - out[:, :, 1].astype(int)).max() == 0

    def test_torch_garbage_raises(self, nat):
        with pytest.raises(ValueError):
            nat.decode_image(b"not an image at all")

    def test_torch_upsample_matches_pil_and_jax(self, nat, jnat):
        out = nat.resize_bilinear(IMG, (74, 106))
        pil = np.asarray(Image.fromarray(IMG).resize((106, 74),
                                                     Image.BILINEAR))
        assert np.abs(out.astype(int) - pil.astype(int)).max() <= 2
        np.testing.assert_array_equal(out, jnat.resize_bilinear(IMG,
                                                                (74, 106)))

    def test_torch_downsample_matches_numpy_reference(self, nat):
        dh, dw = 16, 24
        sh, sw = IMG.shape[:2]
        fy = np.clip((np.arange(dh) + 0.5) * sh / dh - 0.5, 0, None)
        fx = np.clip((np.arange(dw) + 0.5) * sw / dw - 0.5, 0, None)
        y0, x0 = fy.astype(int), fx.astype(int)
        y1, x1 = np.minimum(y0 + 1, sh - 1), np.minimum(x0 + 1, sw - 1)
        wy, wx = (fy - y0)[:, None, None], (fx - x0)[None, :, None]
        img = IMG.astype(np.float64)
        top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
        bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
        ref = (top * (1 - wy) + bot * wy + 0.5).astype(np.uint8)
        out = nat.resize_bilinear(IMG, (dh, dw))
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
        with pytest.raises(ValueError, match="RGB"):
            nat.resize_bilinear(IMG[..., :2], (4, 4))


class TestBatch:
    def test_torch_batch_decode_normalize_equals_jax(self, nat, jnat):
        blobs = [make_png(IMG), make_jpeg(IMG[::-1].copy())]
        mean, std = [100.0, 110.0, 120.0], [50.0, 55.0, 60.0]
        out = nat.decode_resize_normalize_batch(
            blobs, (37, 53), mean=mean, std=std, num_threads=2)
        want0 = (IMG.astype(np.float32) - mean) / std
        np.testing.assert_allclose(out[0], want0, rtol=1e-5, atol=1e-5)
        assert out.shape == (2, 37, 53, 3)
        np.testing.assert_array_equal(out, jnat.decode_resize_normalize_batch(
            blobs, (37, 53), mean=mean, std=std, num_threads=2))

    def test_torch_batch_resize(self, nat, jnat):
        out = nat.decode_resize_normalize_batch(
            [make_png(IMG)] * 3, (16, 16), num_threads=3, scale=0.5)
        ref = nat.resize_bilinear(IMG, (16, 16)).astype(np.float32) * 0.5
        np.testing.assert_allclose(out[1], ref, atol=0.5)
        np.testing.assert_array_equal(out, jnat.decode_resize_normalize_batch(
            [make_png(IMG)] * 3, 16, num_threads=3, scale=0.5))
        assert nat.decode_resize_normalize_batch([], 8).shape == (0, 8, 8, 3)

    def test_torch_batch_error_modes(self, nat):
        blobs = [make_png(IMG), b"garbage"]
        with pytest.raises(ValueError, match="1/2"):
            nat.decode_resize_normalize_batch(blobs, (8, 8))
        out = nat.decode_resize_normalize_batch(blobs, (8, 8),
                                                errors="zero")
        assert np.all(out[1] == 0) and not np.all(out[0] == 0)


@pytest.fixture()
def folder(tmp_path):
    rng = np.random.default_rng(2)
    for cls_name, color in [("cat", 60), ("dog", 200)]:
        d = tmp_path / cls_name
        d.mkdir()
        for i in range(5):
            arr = np.full((20 + i, 30, 3), color, np.uint8)
            arr[::3] = rng.integers(0, 256, arr[::3].shape, dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{i}.png")
    return str(tmp_path)


class TestImageLoader:
    def test_torch_list_files_with_labels(self, folder):
        files, labels, names = list_image_files(folder, with_label=True)
        assert len(files) == 10 and names == ["cat", "dog"]
        assert labels.tolist() == [0] * 5 + [1] * 5
        plain, none, _ = list_image_files(folder)
        assert sorted(plain) == sorted(files) and none is None

    @pytest.mark.parametrize("route", ["native", "pil"])
    def test_torch_batches_equal_jax(self, folder, route, monkeypatch):
        if route == "pil":
            monkeypatch.setattr(native, "available", lambda: False)
            monkeypatch.setattr(jnative, "available", lambda: False)
        elif not (native.available() and jnative.available()):
            pytest.skip("native build unavailable")
        kw = dict(batch_size=4, size=(16, 16), scale=1 / 255.0,
                  mean=(0.4, 0.5, 0.6), std=(0.2, 0.25, 0.3),
                  shuffle=True, seed=3)
        got = list(ImageLoader.from_folder(folder, **kw))
        want = list(JImageLoader.from_folder(folder, **kw))
        assert [b[0].shape[0] for b in got] == [4, 4, 2]
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
        raw = list(ImageLoader.from_folder(folder, batch_size=10, size=8,
                                           out_dtype="uint8"))
        assert raw[0][0].dtype == np.uint8

    def test_torch_iteration_and_normalization(self, folder):
        loader = ImageLoader.from_folder(folder, batch_size=4,
                                         size=(16, 16), scale=1 / 255.0)
        imgs, labels = next(iter(loader))
        assert imgs.shape == (4, 16, 16, 3) and imgs.max() <= 1.0
        np.testing.assert_array_equal(labels, [0, 0, 0, 0])
        assert loader.steps_per_epoch() == 3
        with pytest.raises(ValueError, match="RAW"):
            ImageLoader([], out_dtype="uint8", scale=0.5)

    def test_torch_shuffle_epochs_differ(self, folder):
        loader = ImageLoader.from_folder(folder, batch_size=10, size=(8, 8),
                                         shuffle=True, seed=1)
        _, y1 = next(iter(loader))
        _, y2 = next(iter(loader))
        assert sorted(y1.tolist()) == sorted(y2.tolist())
        assert y1.tolist() != y2.tolist()

    def test_torch_abandoned_iteration_stops_producer(self, folder):
        before = threading.active_count()
        it = iter(ImageLoader.from_folder(folder, batch_size=2, size=(8, 8),
                                          prefetch=1))
        next(it)
        it.close()
        deadline = time.monotonic() + 5
        while threading.active_count() > before and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before, "producer thread leaked"

    def test_torch_as_dataset_and_drop_remainder(self, folder):
        ds = ImageLoader.from_folder(folder, batch_size=3,
                                     size=(8, 8)).as_dataset()
        assert ds.size == 10 and ds.y.shape == (10,)
        loader = ImageLoader.from_folder(folder, batch_size=4, size=(8, 8),
                                         drop_remainder=True)
        assert loader.steps_per_epoch() == 2
        assert [b[0].shape[0] for b in loader] == [4, 4]


def test_torch_bytes_to_mat_uses_native_and_records_size(nat):
    from analytics_zoo_tpu_torch.feature.image.transforms import (
        ImageBytesToMat)
    f = ImageBytesToMat().apply(make_png(IMG))
    np.testing.assert_array_equal(f["image"][:, :, ::-1],
                                  IMG.astype(np.float32))
    assert f["original_size"] == (37, 53, 3)
    assert image_loader.native is native
