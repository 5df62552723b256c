"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  It is compiled by
``nvcc`` into its own shared library at first use and bound with
``ctypes``.  Libraries go to ``build/torch_kernels/<hash>/`` under the
checkout, keyed by a hash of the sources, the headers they include
(``csrc/*.cuh``) and the compiler flags, so an edited source or header
rebuilds and an unchanged one is reused.  Importing this
module builds nothing and needs no ``nvcc``: the build runs on the first
launch, or when :func:`build` is called.  A build that runs ``nvcc``
is reported to ``observability/profile.py`` as a compile.

A wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises
when the launch returns a CUDA error, and counts its launches, in all
and by dtype (``launch_counts_by_dtype``: ``flash_fwd[bf16]``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..observability import profile

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
# every launch ends with bh, sq, sk, d, scale, causal, dtype, stream
_TAIL = [_INT, _INT, _INT, _INT, ctypes.c_float, _INT, _INT, _VOID]
# source file -> {C symbol: argtypes}
_SIGNATURES = {
    # q, k, v, lens, o, lse | bh, sq, sk, d, scale, causal, dtype, stream
    "flash_fwd.cu": {"flash_fwd": [_VOID] * 6 + _TAIL},
    # q, k, v, do, lse, delta, lens, dq | ...
    # q, k, v, do, lse, delta, lens, dk, dv | ...
    "flash_bwd.cu": {"flash_bwd_dq": [_VOID] * 8 + _TAIL,
                     "flash_bwd_dkv": [_VOID] * 9 + _TAIL},
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built from csrc/ on a host with the "
                       "CUDA toolkit")


def _build_dir() -> Path:
    """The build directory of this set of sources: a hash of the flags and
    of every ``csrc/*.cu`` and ``*.cuh`` file, so that an edited header
    rebuilds the sources that include it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


class KernelLibrary:
    """The compiled kernels: built once per process (and once per source
    hash on disk), one ``nvcc`` per source, all started together."""

    def __init__(self):
        self._fns = None
        self.build_log = ""

    def build(self) -> dict:
        if self._fns is not None:
            return self._fns
        out = _build_dir()
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs, logs = {}, []
        for name in sorted(_SIGNATURES):
            lib = out / (Path(name).stem + ".so")
            if lib.exists():
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            text, _ = proc.communicate()
            logs.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, lib)
        self.build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{self.build_log}")
        if procs:
            # the port's compile: counted by the profile hooks and put on
            # the span of the step or request that paid for it
            profile.note_compile(time.perf_counter() - t0,
                                 "nvcc:" + ",".join(sorted(procs)))
        fns = {}
        for name, symbols in _SIGNATURES.items():
            lib = ctypes.CDLL(str(out / (Path(name).stem + ".so")))
            for symbol, argtypes in symbols.items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = _INT
                fns[symbol] = fn
        self._fns = fns
        return fns


LIBRARY = KernelLibrary()


def build() -> None:
    """Build (or load) every kernel."""
    LIBRARY.build()




_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_HEAD_DIM = 256


def _check_attention_args(name, q, k, v, lens, causal, rows=()):
    """The checks every flash wrapper makes: contiguous CUDA (bh, s, d)
    q/k/v of one dtype (f32 or bf16), head_dim in [1, 256], causal only
    for sq <= sk, ``lens`` None or a contiguous (bh,) f32 tensor on q's
    device.  ``rows`` are extra (name, tensor, dtype) arguments shaped
    per query row: ``(bh, sq, d)`` at q's dtype or ``(bh, sq)`` f32."""
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} kernel: {arg} must be a CUDA "
                             f"tensor, got device {t.device}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {arg} must be a "
                             "contiguous (bh, s, d) tensor")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"{name} kernel takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"{name} kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    if not 1 <= d <= MAX_HEAD_DIM or sq < 1 or sk < 1:
        raise ValueError(f"{name} kernel: head_dim {d} must lie in "
                         f"[1, {MAX_HEAD_DIM}] and sequences must be "
                         "non-empty")
    if causal and sq > sk:
        raise ValueError(f"{name} kernel: causal needs sq <= sk")
    if lens is not None and (
            lens.shape != (bh,) or lens.dtype != torch.float32
            or lens.device != q.device or not lens.is_contiguous()):
        raise ValueError(f"{name} kernel: lens must be a contiguous (bh,) "
                         "float32 tensor on the device of q")
    for arg, t, shape, dtype in rows:
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} kernel: {arg} must be a contiguous "
                             f"{shape} {dtype} tensor on the device of q, "
                             f"got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    return bh, sq, sk, d


def _bwd_rows(q, do, lse, delta):
    rows = q.shape[:2]
    return (("do", do, tuple(q.shape), q.dtype),
            ("lse", lse, tuple(rows), torch.float32),
            ("delta", delta, tuple(rows), torch.float32))


def _launch(name, fn, q, *args):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _ptr(t):
    return None if t is None else t.data_ptr()


class _Wrapper:
    """``launches`` counts the kernel launches made through a wrapper;
    ``by_dtype`` splits them by the inputs' dtype."""

    def __init__(self):
        self.launches = 0
        self.by_dtype = collections.Counter()

    def _count(self, q):
        self.launches += 1
        self.by_dtype[_DTYPE_NAMES[q.dtype]] += 1


class FlashFwd(_Wrapper):
    """Wrapper of ``flash_fwd`` (csrc/flash_fwd.cu)."""

    def __call__(self, q, k, v, lens, causal: bool, scale: float):
        """q (bh, sq, d), k/v (bh, sk, d) CUDA tensors of one dtype;
        ``lens`` (bh,) f32 valid key counts or None.  Returns
        (o (bh, sq, d) at the input dtype, lse (bh, sq) f32)."""
        bh, sq, sk, d = _check_attention_args("flash_fwd", q, k, v, lens,
                                              causal)
        fn = LIBRARY.build()["flash_fwd"]
        o = torch.empty_like(q)
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        _launch("flash_fwd", fn, q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), _ptr(lens), o.data_ptr(), lse.data_ptr(), bh,
                sq, sk, d, float(scale), int(bool(causal)), _DTYPES[q.dtype])
        self._count(q)
        return o, lse


class FlashBwdDq(_Wrapper):
    """Wrapper of ``flash_bwd_dq`` (csrc/flash_bwd.cu)."""

    def __call__(self, q, k, v, do, lse, delta, lens, causal: bool,
                 scale: float):
        """q/do (bh, sq, d), k/v (bh, sk, d) CUDA tensors of one dtype;
        lse and delta (bh, sq) f32; ``lens`` as for ``flash_fwd``.
        Returns dq (bh, sq, d) at the input dtype."""
        bh, sq, sk, d = _check_attention_args(
            "flash_bwd_dq", q, k, v, lens, causal, rows=_bwd_rows(
                q, do, lse, delta))
        fn = LIBRARY.build()["flash_bwd_dq"]
        dq = torch.empty_like(q)
        _launch("flash_bwd_dq", fn, q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), _ptr(lens), dq.data_ptr(), bh, sq, sk, d,
                float(scale), int(bool(causal)), _DTYPES[q.dtype])
        self._count(q)
        return dq


class FlashBwdDkv(_Wrapper):
    """Wrapper of ``flash_bwd_dkv`` (csrc/flash_bwd.cu)."""

    def __call__(self, q, k, v, do, lse, delta, lens, causal: bool,
                 scale: float):
        """As :class:`FlashBwdDq`; returns (dk, dv), each (bh, sk, d) at
        the input dtype, with every row written (zeros past ``lens``)."""
        bh, sq, sk, d = _check_attention_args(
            "flash_bwd_dkv", q, k, v, lens, causal, rows=_bwd_rows(
                q, do, lse, delta))
        fn = LIBRARY.build()["flash_bwd_dkv"]
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        _launch("flash_bwd_dkv", fn, q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), _ptr(lens), dk.data_ptr(), dv.data_ptr(),
                bh, sq, sk, d, float(scale), int(bool(causal)),
                _DTYPES[q.dtype])
        self._count(q)
        return dk, dv


flash_fwd = FlashFwd()
flash_bwd_dq = FlashBwdDq()
flash_bwd_dkv = FlashBwdDkv()

#: every kernel wrapper, by name (chip_smoke.py resets and reads these)
KERNELS = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
           "flash_bwd_dkv": flash_bwd_dkv}


def reset_launch_counts():
    for kernel in KERNELS.values():
        kernel.launches = 0
        kernel.by_dtype.clear()


def launch_counts() -> dict:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def launch_counts_by_dtype() -> dict:
    """``{"flash_fwd[bf16]": n, ...}``: every kernel at both dtypes."""
    return {f"{name}[{dt}]": kernel.by_dtype[dt]
            for name, kernel in KERNELS.items()
            for dt in _DTYPE_NAMES.values()}
