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

With the persistent store on (``common/execstore.py``), a library
missing from the build directory is read from the store first: a hit is
written into the build directory and loaded, and ``nvcc`` does not run;
a miss builds and writes the library behind; an entry that is corrupt
or will not load is counted invalid, deleted and rebuilt.  Without a
store the build touches no store file.

A wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises
when the launch returns a CUDA error, and counts its launches, in all
and by dtype (``launch_counts_by_dtype``: ``flash_fwd[bf16]``).

Every kernel has two designs, chosen by shape: ``sm90`` (TMA and
``wgmma``: ``csrc/flash_fwd_sm90.cu`` for the forward, where
:func:`fwd_design` gives it every call whose rows and bases TMA takes and
whose head dim is at most 128; ``csrc/flash_bwd_sm90.cu`` for the two
backward kernels, where :func:`bwd_design` gives it the same calls, at
f32 up to head dim 64) and ``base`` (``mma.sync``: ``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) for the rest.  Launches are also counted by
design (``launch_counts_by_design``: ``flash_fwd[bf16,sm90]``,
``flash_bwd_dq[bf16,sm90]``); ``launches`` sums both.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..common import execstore
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
    # q, k, v, lens, o, lse | ...
    "flash_fwd_sm90.cu": {"flash_fwd_sm90": [_VOID] * 6 + _TAIL},
    # q, k, v, do, lse, delta, lens, dq | ...
    # q, k, v, do, lse, delta, lens, dk, dv | ...
    "flash_bwd.cu": {"flash_bwd_dq": [_VOID] * 8 + _TAIL,
                     "flash_bwd_dkv": [_VOID] * 9 + _TAIL},
    # as flash_bwd.cu's; f32 up to head dim 64, bf16 up to 128
    "flash_bwd_sm90.cu": {"flash_bwd_dq_sm90": [_VOID] * 8 + _TAIL,
                          "flash_bwd_dkv_sm90": [_VOID] * 9 + _TAIL},
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


def _source_hash() -> str:
    """A hash of the flags and of every ``csrc/*.cu`` and ``*.cuh`` file,
    so that an edited header rebuilds the sources that include it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _build_dir() -> Path:
    """The build directory of this set of sources (:func:`_source_hash`)."""
    return _BUILD_ROOT / _source_hash()[:16]


@functools.lru_cache(maxsize=1)
def _nvcc_version() -> str:
    """``nvcc --version``'s text, or ``"none"`` on a host without the
    toolkit (read once a process)."""
    try:
        return subprocess.run([_nvcc(), "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "none"


def _store_key(store, name: str) -> str:
    """The store fingerprint of ``csrc/<name>``'s library: the sources'
    and flags' hash and the compiler's version, over the store's own
    runtime parts (torch, CUDA, the device)."""
    return store.fingerprint("kernel-lib", name, _source_hash(),
                             "nvcc", _nvcc_version())


def _compile(name: str, out: Path) -> subprocess.Popen:
    """Start ``nvcc`` on ``csrc/<name>`` writing the library ``out``."""
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(_CSRC / name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(path: Path):
    """Load one built library."""
    return ctypes.CDLL(str(path))


def _from_store(store, fp: str, lib: Path):
    """The library of fingerprint ``fp`` read from ``store`` into ``lib``
    (written atomically) and loaded, or None on a miss.  An entry that
    will not load is counted invalid and removed, file and entry."""
    entry = store.lookup(fp)
    if entry is None:
        return None
    tmp = lib.with_suffix(f".{os.getpid()}.store")
    tmp.write_bytes(entry.payload)
    os.replace(tmp, lib)
    try:
        return _load(lib)
    except OSError as e:
        store.note_invalid(fp, e)
        lib.unlink()
        return None


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
        store = execstore.current()
        t0 = time.perf_counter()
        procs, logs, loaded, fps = {}, [], {}, {}
        for name in sorted(_SIGNATURES):
            lib = out / (Path(name).stem + ".so")
            if lib.exists():
                continue
            if store is not None:
                # read-through at the build miss only
                fps[name] = _store_key(store, name)
                handle = _from_store(store, fps[name], lib)
                if handle is not None:
                    loaded[name] = handle
                    continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (_compile(name, tmp), tmp, lib)
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
                                 "nvcc:" + ",".join(sorted(procs)),
                                 kind="kernel_build")
            if store is not None:
                meta = {"kind": "kernel-lib"}
                tag = execstore.build_tag()
                if tag is not None:
                    meta["model"] = tag
                for name, (_, _, lib) in sorted(procs.items()):
                    store.put(fps[name], lib.read_bytes(),
                              meta=dict(meta, source=name))
        fns = {}
        for name, symbols in _SIGNATURES.items():
            lib = loaded.get(name) or _load(out / (Path(name).stem + ".so"))
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
#: each kernel's designs: TMA and wgmma, and the mma.sync baseline
FWD_DESIGNS = ("sm90", "base")
BWD_DESIGNS = FWD_DESIGNS
SM90_MAX_HEAD_DIM = 128
#: the widest head the f32 sm90 backward takes
SM90_F32_BWD_MAX_HEAD_DIM = 64


def fwd_design(dtype, d: int, strides, ptrs) -> str:
    """The flash forward's design for a call: ``"sm90"`` where TMA and
    wgmma take it -- head dim at most 128, every tensor's rows contiguous
    16-byte multiples (``strides``: each of q, k, v's (bh, s, d) strides
    in elements), every base (``ptrs``) 16-byte aligned -- else
    ``"base"``."""
    if (d <= SM90_MAX_HEAD_DIM and (d * dtype.itemsize) % 16 == 0
            and all(st[-1] == 1 and st[-2] == d for st in strides)
            and all(p % 16 == 0 for p in ptrs)):
        return "sm90"
    return "base"


def bwd_design(dtype, d: int, strides, ptrs) -> str:
    """The backward kernels' design for a call: ``"sm90"`` where TMA and
    wgmma take it, as :func:`fwd_design` (``strides`` and ``ptrs`` of q,
    k, v and do), with the head dim at most 64 at f32
    (:data:`SM90_F32_BWD_MAX_HEAD_DIM`: past it a stage of f32 tiles and
    their TF32 lo parts and transposes does not fit in shared memory);
    ``"base"`` otherwise.  lse and delta need nothing: the sm90 kernels
    load their rows with plain loads."""
    if dtype == torch.float32 and d > SM90_F32_BWD_MAX_HEAD_DIM:
        return "base"
    return fwd_design(dtype, d, strides, ptrs)


def _chosen(name, forced, chosen, d, dtype):
    """The design a call runs: ``chosen`` (the rule's) unless ``forced``;
    ``"base"`` takes any shape, ``"sm90"`` only what the rule gives it."""
    design = chosen if forced is None else forced
    if design not in FWD_DESIGNS or (design == "sm90" and chosen != "sm90"):
        raise ValueError(f"{name}: design {design!r} does not take this "
                         f"call (head_dim {d}, {dtype}); {chosen!r} does")
    return design


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
    ``by_dtype`` splits them by the inputs' dtype, ``by_design`` by dtype
    and design (``"bf16,sm90"``).  ``total_by_design`` counts the
    launches by design since import, ``total_by_dtype_design`` by dtype
    and design: no reset clears them, so a caller can read them before
    and after a run that resets the others."""

    def __init__(self):
        self.launches = 0
        self.by_dtype = collections.Counter()
        self.by_design = collections.Counter()
        self.total_by_design = collections.Counter()
        self.total_by_dtype_design = collections.Counter()

    def _count(self, q, design):
        key = f"{_DTYPE_NAMES[q.dtype]},{design}"
        self.launches += 1
        self.by_dtype[_DTYPE_NAMES[q.dtype]] += 1
        self.by_design[key] += 1
        self.total_by_design[design] += 1
        self.total_by_dtype_design[key] += 1


class FlashFwd(_Wrapper):
    """Wrapper of the flash forward: ``flash_fwd_sm90``
    (csrc/flash_fwd_sm90.cu) or ``flash_fwd`` (csrc/flash_fwd.cu), as
    :func:`fwd_design` chooses."""

    def __call__(self, q, k, v, lens, causal: bool, scale: float):
        """q (bh, sq, d), k/v (bh, sk, d) CUDA tensors of one dtype;
        ``lens`` (bh,) f32 valid key counts or None.  Returns (o (bh, sq,
        d) at the input dtype, lse (bh, sq) f32)."""
        return self._run(None, q, k, v, lens, causal, scale)

    def _run(self, design, q, k, v, lens, causal, scale):
        """The call at a forced ``design`` (None: :func:`fwd_design`'s),
        for the tests and chip_smoke that hold both designs to the plain
        version: ``"base"`` runs the baseline on any shape, ``"sm90"``
        raises on a shape that design does not take."""
        bh, sq, sk, d = _check_attention_args("flash_fwd", q, k, v, lens,
                                              causal)
        design = _chosen("flash_fwd", design, fwd_design(
            q.dtype, d, (q.stride(), k.stride(), v.stride()),
            (q.data_ptr(), k.data_ptr(), v.data_ptr())), d, q.dtype)
        o = torch.empty_like(q)
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        symbol = "flash_fwd_sm90" if design == "sm90" else "flash_fwd"
        _launch(symbol, LIBRARY.build()[symbol], q, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), _ptr(lens), o.data_ptr(),
                lse.data_ptr(), bh, sq, sk, d, float(scale),
                int(bool(causal)), _DTYPES[q.dtype])
        self._count(q, design)
        return o, lse


class _FlashBwd(_Wrapper):
    """A backward kernel's wrapper: ``<name>_sm90``
    (csrc/flash_bwd_sm90.cu) or ``<name>`` (csrc/flash_bwd.cu), as
    :func:`bwd_design` chooses; ``outputs`` are the tensors it writes,
    each shaped as q (``"q"``) or k (``"k"``)."""

    name = ""
    outputs = ()

    def __call__(self, q, k, v, do, lse, delta, lens, causal: bool,
                 scale: float):
        return self._run(None, q, k, v, do, lse, delta, lens, causal, scale)

    def _run(self, design, q, k, v, do, lse, delta, lens, causal, scale):
        """The call at a forced ``design`` (None: :func:`bwd_design`'s),
        as :meth:`FlashFwd._run`."""
        bh, sq, sk, d = _check_attention_args(
            self.name, q, k, v, lens, causal, rows=_bwd_rows(
                q, do, lse, delta))
        tensors = (q, k, v, do)
        design = _chosen(self.name, design, bwd_design(
            q.dtype, d, [t.stride() for t in tensors],
            [t.data_ptr() for t in tensors]), d, q.dtype)
        outs = [torch.empty_like(q if o == "q" else k) for o in self.outputs]
        symbol = self.name + ("_sm90" if design == "sm90" else "")
        _launch(symbol, LIBRARY.build()[symbol], q, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), _ptr(lens), *(o.data_ptr() for o in outs),
                bh, sq, sk, d, float(scale), int(bool(causal)),
                _DTYPES[q.dtype])
        self._count(q, design)
        return outs[0] if len(outs) == 1 else tuple(outs)


class FlashBwdDq(_FlashBwd):
    """Wrapper of ``flash_bwd_dq_sm90`` or ``flash_bwd_dq``.  A call
    takes q/do (bh, sq, d), k/v (bh, sk, d) CUDA tensors of one dtype,
    lse and delta (bh, sq) f32, ``lens`` as for ``flash_fwd``, causal and
    scale, and returns dq (bh, sq, d) at the input dtype."""

    name = "flash_bwd_dq"
    outputs = ("q",)


class FlashBwdDkv(_FlashBwd):
    """Wrapper of ``flash_bwd_dkv_sm90`` or ``flash_bwd_dkv``: as
    :class:`FlashBwdDq`; returns (dk, dv), each (bh, sk, d) at the input
    dtype, with every row written (zeros past ``lens``)."""

    name = "flash_bwd_dkv"
    outputs = ("k", "k")


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
        kernel.by_design.clear()


def launch_counts() -> dict:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def launch_counts_by_dtype() -> dict:
    """``{"flash_fwd[bf16]": n, ...}``: every kernel at both dtypes."""
    return {f"{name}[{dt}]": kernel.by_dtype[dt]
            for name, kernel in KERNELS.items()
            for dt in _DTYPE_NAMES.values()}


def launch_counts_by_design() -> dict:
    """``{"flash_fwd[bf16,sm90]": n, ...}``: every kernel at both dtypes
    and designs."""
    return {f"{name}[{dt},{design}]": kernel.by_design[f"{dt},{design}"]
            for name, kernel in KERNELS.items()
            for dt in _DTYPE_NAMES.values() for design in FWD_DESIGNS}
