"""ctypes binding of the host-side image library (``zoo_native.cc``).

Counterpart of ``analytics_zoo_tpu/native/__init__.py``, with its own
copy of the C++ source beside this file (equal to the JAX package's).
The reference decoded images with OpenCV through JNI; here libjpeg and
libpng decode, a bilinear resize and a per-channel normalize fill a
float32 NHWC batch from a ``std::thread`` pool.

The library is built with ``g++`` at first use into
``build/native/<hash>/`` under the checkout (keyed by a hash of the
source and the flags), never beside the source, and loaded with
``ctypes``.  Importing this module builds nothing.  When the toolchain
or the libjpeg/libpng headers are missing, ``available()`` is False,
``build_error()`` says why, and callers decode with PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "zoo_native.cc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
LIBS = ["-ljpeg", "-lpng", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libzoo_native.so"


def _build(path: Path) -> None:
    # a per-process temporary path renamed into place: concurrent first
    # builds from several processes never leave a torn library behind
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp),
                           *LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {proc.stderr[-2000:]}")
    os.replace(tmp, path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.zoo_decode_rgb.restype = ctypes.c_int
            lib.zoo_decode_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.zoo_free.restype = None
            lib.zoo_free.argtypes = [ctypes.c_void_p]
            lib.zoo_resize_bilinear.restype = None
            lib.zoo_resize_bilinear.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            lib.zoo_decode_batch.restype = ctypes.c_int
            lib.zoo_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.zoo_native_abi_version.restype = ctypes.c_int
            lib.zoo_native_abi_version.argtypes = []
            if lib.zoo_native_abi_version() != 1:
                raise RuntimeError("native ABI mismatch")
            _lib = lib
        except (OSError, RuntimeError) as e:  # no toolchain or headers
            _build_error = str(e)
    return _lib


def available() -> bool:
    """True when the native library is (or can be) built and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded (None when it
    was)."""
    _load()
    return _build_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def decode_image(data: bytes) -> np.ndarray:
    """Decode a JPEG/PNG blob to an (H, W, 3) uint8 RGB array."""
    lib = _require()
    out = ctypes.c_void_p()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.zoo_decode_rgb(data, len(data), ctypes.byref(out),
                            ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError("image decode failed (not a valid JPEG/PNG?)")
    try:
        buf = ctypes.cast(out, ctypes.POINTER(
            ctypes.c_uint8 * (w.value * h.value * 3))).contents
        return np.frombuffer(buf, dtype=np.uint8).reshape(
            h.value, w.value, 3).copy()
    finally:
        lib.zoo_free(out)


def decode_resize_normalize_batch(
        blobs: Sequence[bytes], size, mean: Optional[Sequence[float]] = None,
        std: Optional[Sequence[float]] = None, scale: float = 1.0,
        num_threads: int = 0, errors: str = "raise") -> np.ndarray:
    """Decode, resize and normalize a batch of image blobs into float32
    NHWC RGB: ``(pixel * scale - mean[c]) / std[c]`` per channel ``c``.
    ``errors='zero'`` zero-fills the slots that fail to decode instead of
    raising."""
    lib = _require()
    h, w = (size, size) if isinstance(size, int) else tuple(size)
    n = len(blobs)
    out = np.empty((n, h, w, 3), dtype=np.float32)
    if n == 0:
        return out
    blob_arr = (ctypes.c_char_p * n)(*[bytes(b) for b in blobs])
    len_arr = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    mean_p = ((ctypes.c_float * 3)(*[float(v) for v in mean])
              if mean is not None else None)
    std_p = ((ctypes.c_float * 3)(*[float(v) for v in std])
             if std is not None else None)
    failures = lib.zoo_decode_batch(
        blob_arr, len_arr, n, h, w, mean_p, std_p,
        ctypes.c_float(scale), num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures and errors == "raise":
        raise ValueError(f"{failures}/{n} images failed to decode")
    return out


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """Bilinear-resize an (H, W, 3) uint8 array (half-pixel centers)."""
    lib = _require()
    h, w = (size, size) if isinstance(size, int) else tuple(size)
    img = np.ascontiguousarray(img, dtype=np.uint8)
    sh, sw, c = img.shape
    if c != 3:
        raise ValueError("expected (H, W, 3) RGB input")
    dst = np.empty((h, w, 3), dtype=np.uint8)
    lib.zoo_resize_bilinear(
        img.ctypes.data_as(ctypes.c_char_p), sw, sh,
        dst.ctypes.data_as(ctypes.c_char_p), w, h)
    return dst
