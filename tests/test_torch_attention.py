"""The port's attention ops against the JAX package's.

Same inputs (numpy, seeded) through both packages on the CPU.  The JAX
flash kernel runs in the Pallas interpreter (``interpret=True``); the
port's flash path on a CPU tensor is its plain version,
``flash_attention_reference``, the CUDA kernel's tile algorithm in torch.
Tolerance for f32: rtol 2e-4, atol 2e-5 (the JAX package's own attention
tests use the same).  The CUDA kernel itself is held against the plain
version only where a card is present, in ``tests/test_torch_cuda.py``.
"""

import collections
import importlib
import inspect
import shutil
import subprocess

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras.layers import (
    MultiHeadSelfAttention as JMHSA, PositionalEmbedding as JPosEmb)
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as tattn
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    MultiHeadSelfAttention, PositionalEmbedding)

# the JAX package's ops/__init__ exports a function named ``attention``
jattn = importlib.import_module("analytics_zoo_tpu.ops.attention")
RTOL, ATOL = 2e-4, 2e-5


def qkv(b=2, sq=64, sk=None, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    return (rng.normal(0, 1, (b, sq, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, h, d)).astype(np.float32))


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens", [None, [64, 37]])
def test_naive_matches_jax(causal, lens):
    q, k, v = qkv()
    ref = jattn.naive_attention(q, k, v, causal=causal, kv_lengths=lens)
    out = tattn.naive_attention(*t(q, k, v), causal=causal, kv_lengths=lens)
    close(out, ref)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens", [None, [64, 5]])
def test_blockwise_matches_jax(causal, lens):
    q, k, v = qkv(seed=1)
    ref = jattn.blockwise_attention(q, k, v, causal=causal, block_k=16,
                                    kv_lengths=lens)
    out = tattn.blockwise_attention(*t(q, k, v), causal=causal, block_k=16,
                                    kv_lengths=lens)
    close(out, ref)


FLASH_CASES = [
    # causal, sq, sk, kv_lengths, layout
    (False, 64, 64, None, "bshd"),
    (True, 64, 64, None, "bshd"),
    (True, 64, 128, None, "bhsd"),        # cross: cached-kv shape
    (False, 48, 96, None, "bhsd"),
    (False, 64, 64, [64, 37], "bshd"),
    (True, 64, 64, [64, 5], "bhsd"),
    (True, 37, 37, None, "bshd"),         # prime: the JAX side pads
    (False, 37, 53, [53, 20], "bshd"),    # prime cross with lengths
    (True, 130, 130, [130, 70], "bhsd"),  # three ragged 64-row tiles
]


@pytest.mark.parametrize("causal,sq,sk,lens,layout", FLASH_CASES)
def test_flash_plain_matches_jax_flash(causal, sq, sk, lens, layout):
    q, k, v = qkv(sq=sq, sk=sk, seed=2)
    if layout == "bhsd":
        q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    ref = jattn.flash_attention(q, k, v, causal=causal, interpret=True,
                                layout=layout, kv_lengths=lens)
    out = tattn.flash_attention(*t(q, k, v), causal=causal, layout=layout,
                                kv_lengths=lens)
    close(out, ref)
    # and the JAX oracle, in the bshd contract
    if layout == "bhsd":
        q, k, v = (a.transpose(0, 2, 1, 3) for a in (q, k, v))
        out = out.transpose(1, 2)
    close(out, jattn.naive_attention(q, k, v, causal=causal,
                                     kv_lengths=lens))


@pytest.mark.parametrize("causal,sq,sk,lens", [
    (False, 64, 64, None),
    (True, 64, 64, None),
    (True, 32, 64, None),
    (True, 64, 64, [64, 11]),
    (False, 96, 64, [40, 64]),
])
def test_flash_plain_lse_matches_jax_kernel(causal, sq, sk, lens):
    """The row logsumexp, the residual of the later backward, against
    the one the Pallas forward writes."""
    b, h, d = 2, 2, 16
    q, k, v = qkv(b=b, sq=sq, sk=sk, h=h, d=d, seed=3)
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(b * h, -1, d).copy()
    qf, kf, vf = fold(q), fold(k), fold(v)
    masked = lens is not None
    jl = (np.repeat(np.asarray(lens, np.float32), h)[:, None, None]
          if masked else np.zeros((b * h, 1, 1), np.float32))
    scale = d ** -0.5
    o_ref, lse_ref = jattn._flash_fwd_call(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(jl),
        sq, sk, causal, masked, 16, 32, scale, True)
    tl = torch.from_numpy(jl[:, 0, 0]) if masked else None
    o, lse = tattn.flash_attention_reference(*t(qf, kf, vf), causal, scale,
                                             tl)
    assert lse.shape == (b * h, sq) and lse.dtype == torch.float32
    close(o, o_ref)
    close(lse, np.asarray(lse_ref)[:, 0, :])


def test_flash_plain_bf16_rounds_p_like_the_kernel():
    """bf16 inputs: o at bf16, lse in f32, within bf16 rounding of the
    f32 result (o atol 2e-2: one bf16 ulp near 2)."""
    q, k, v = qkv(sq=64, seed=4)
    fold = lambda a: torch.from_numpy(
        a.transpose(0, 2, 1, 3).reshape(4, 64, 16).copy())
    qf, kf, vf = fold(q), fold(k), fold(v)
    o32, lse32 = tattn.flash_attention_reference(qf, kf, vf, True)
    o16, lse16 = tattn.flash_attention_reference(
        *(a.to(torch.bfloat16) for a in (qf, kf, vf)), True)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    close(o16.float(), o32, rtol=0, atol=2e-2)
    close(lse16, lse32, rtol=0, atol=2e-2)


@pytest.mark.parametrize("impl,causal,sq,sk,layout", [
    ("auto", True, 64, 64, "bshd"),     # blockwise on the CPU
    ("auto", False, 37, 37, "bshd"),    # prime: naive on the CPU
    ("auto", True, 96, 48, "bshd"),     # causal sq > sk: never flash
    ("blockwise", False, 64, 64, "bshd"),
    ("naive", True, 64, 64, "bshd"),
    ("auto", True, 64, 64, "bhsd"),
    ("auto", False, 37, 37, "bhsd"),
    ("auto", True, 96, 48, "bhsd"),
    ("blockwise", False, 64, 64, "bhsd"),
    ("naive", True, 64, 64, "bhsd"),
    ("flash", True, 64, 64, "bhsd"),    # interpret on the JAX side
])
def test_dispatch_matches_jax(impl, causal, sq, sk, layout):
    q, k, v = qkv(sq=sq, sk=sk, seed=5)
    lens = [sk, max(1, sk // 3)]
    if layout == "bhsd":
        q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
        ref = jattn.attention_bhsd(q, k, v, causal=causal,
                                   implementation=impl, kv_lengths=lens)
        out = tattn.attention_bhsd(*t(q, k, v), causal=causal,
                                   implementation=impl, kv_lengths=lens)
    else:
        ref = jattn.attention(q, k, v, causal=causal, implementation=impl,
                              kv_lengths=lens)
        out = tattn.attention(*t(q, k, v), causal=causal,
                              implementation=impl, kv_lengths=lens)
    close(out, ref)


RAISES = [
    # (what, call on a module, match)
    ("causal sq > sk", lambda m, q, k, v: m.flash_attention(
        q[:, :64], k[:, :32], v[:, :32], causal=True, **_interp(m)),
     "sq <= sk"),
    # sq = 257 is prime and > 256: no block divisor >= 8
    ("causal cross without divisor", lambda m, q, k, v: m.flash_attention(
        q, k, v, causal=True, **_interp(m)), "cross lengths"),
    ("layout", lambda m, q, k, v: m.flash_attention(
        q, k, v, layout="sbhd", **_interp(m)), "layout"),
    ("kv_lengths rank", lambda m, q, k, v: m.naive_attention(
        q, k, v, kv_lengths=np.ones((2, 2))), "kv_lengths"),
    ("block_k", lambda m, q, k, v: m.blockwise_attention(
        q, k, v, block_k=7), "must divide"),
    ("implementation", lambda m, q, k, v: m.attention(
        q, k, v, implementation="warp"), "Unknown implementation"),
]


def _interp(m):
    return {"interpret": True} if m is jattn else {}


@pytest.mark.parametrize("what,call,match", RAISES,
                         ids=[r[0] for r in RAISES])
def test_same_raises_as_jax(what, call, match):
    q, k, v = qkv(sq=257, sk=300, seed=6)
    with pytest.raises(ValueError, match=match):
        call(jattn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with pytest.raises(ValueError, match=match):
        call(tattn, *t(q, k, v))


@pytest.mark.parametrize("causal", [False, True])
def test_mhsa_layer_matches_jax(causal):
    """The layer with the JAX layer's params, single and [x, lengths]."""
    b, s, e = 2, 24, 32
    jl = JMHSA(4, causal=causal, implementation="auto", name="t_mhsa")
    params, _ = jl.init(jax.random.PRNGKey(0), (None, s, e))
    tl = MultiHeadSelfAttention(4, causal=causal, input_shape=(s, e),
                                device="cpu")
    with torch.no_grad():
        for key, p in tl.params().items():
            p.copy_(torch.from_numpy(np.array(params[key])))
    x = np.random.default_rng(7).normal(size=(b, s, e)).astype(np.float32)
    lens = np.array([24, 9])
    close(tl(torch.from_numpy(x)).detach(),
          jl.call(params, {}, jnp.asarray(x)))
    close(tl([torch.from_numpy(x), torch.from_numpy(lens[:, None])]).detach(),
          jl.call(params, {}, [jnp.asarray(x), jnp.asarray(lens[:, None])]))


def test_positional_embedding_matches_jax():
    jl = JPosEmb(16, name="t_pos")
    params, _ = jl.init(jax.random.PRNGKey(1), (None, 10, 8))
    tl = PositionalEmbedding(16, input_shape=(10, 8), device="cpu")
    # uniform(-0.05, 0.05) * 0.02
    assert float(tl.table.detach().abs().max()) <= 0.02 * 0.05
    with torch.no_grad():
        tl.table.copy_(torch.from_numpy(np.array(params["table"])))
    x = np.random.default_rng(8).normal(size=(3, 10, 8)).astype(np.float32)
    close(tl(torch.from_numpy(x)).detach(),
          jl.call(params, {}, jnp.asarray(x)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="max_len"):
        tl(torch.zeros((1, 17, 8)))


def test_kernel_module_import_builds_nothing(monkeypatch):
    """Importing the kernel loader on a host without nvcc starts no
    compiler, and the flash path on a CPU tensor takes the plain version
    without touching the library or the launch count."""
    def refuse(*a, **k):
        raise AssertionError("a subprocess was started")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    mod = importlib.reload(_kernels)
    assert mod.LIBRARY._fns is None
    q, k, v = qkv(seed=9)
    out = tattn.attention(*t(q, k, v), causal=True, implementation="flash")
    assert out.shape == q.shape
    assert mod.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                   "flash_bwd_dkv": 0}
    assert not any(mod.launch_counts_by_design().values())
    assert mod.LIBRARY._fns is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mod._nvcc()


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only: no quiet CPU path."""
    q = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.flash_fwd(q, q, q, None, True, 0.25)
    assert _kernels.flash_fwd.launches == 0


@pytest.mark.parametrize("causal,sq,sk,runs", [
    (False, 64, 64, True),
    (True, 64, 128, True),
    (False, 96, 48, True),      # sq > sk runs without causal
    (True, 96, 48, False),      # causal sq > sk
    (True, 257, 300, False),    # causal cross, no block divisor >= 8
    (True, 257, 257, True),     # causal self: no divisor needed
])
def test_flash_supports_predicate(causal, sq, sk, runs):
    """``"auto"`` sends a CUDA tensor to the kernels on the lengths the
    JAX package's predicate accepts, at any head dim: the kernels take
    head_dim 1 to MAX_HEAD_DIM, and their wrappers raise past it."""
    assert tattn._flash_supports(causal, sq, sk) is runs
    assert tattn._flash_supports(causal, sq, sk) is jattn._flash_supports(
        causal, sq, sk)
    assert _kernels.MAX_HEAD_DIM == 256


@pytest.mark.parametrize("edited", ["flash_fwd.cu", "flash_fwd_sm90.cu",
                                    "flash_bwd.cu", "flash_bwd_sm90.cu",
                                    "flash_mma.cuh", "sm90.cuh",
                                    "new_header.cuh"])
def test_build_dir_hashes_every_source_and_header(tmp_path, monkeypatch,
                                                  edited):
    """The build directory changes with any csrc/*.cu or *.cuh file, so an
    edited header never reuses a library built from the old one."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels._CSRC, csrc)
    monkeypatch.setattr(_kernels, "_CSRC", csrc)
    before = _kernels._build_dir()
    assert _kernels._build_dir() == before
    path = csrc / edited
    old = path.read_bytes() if path.exists() else None
    path.write_bytes((old or b"") + b"\n// edited\n")
    assert _kernels._build_dir() != before
    if old is None:
        path.unlink()
    else:
        path.write_bytes(old)
    assert _kernels._build_dir() == before


def _sm90_takes(dtype, d):
    """TMA and wgmma take rows of 16-byte multiples up to d = 128."""
    item = 4 if dtype == torch.float32 else 2
    return d <= 128 and (d * item) % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 20, 37, 64, 72, 128, 256])
@pytest.mark.parametrize("layout", ["contiguous", "base_off_by_one",
                                    "padded_rows"])
def test_fwd_design_rule(dtype, d, layout):
    """The forward's design is a plain function of dtype, head dim,
    strides and base alignment: ``sm90`` where TMA and wgmma take the call
    (16-byte-multiple contiguous rows, 16-byte-aligned bases, d <= 128),
    the ``base`` kernel otherwise -- a base one element off, or rows
    padded past d, go to the baseline at every d."""
    item = 4 if dtype == torch.float32 else 2
    s = 40
    strides = [(s * d, d, 1)] * 3
    ptrs = [0, 4096, 1 << 20]
    if layout == "base_off_by_one":
        ptrs[1] += item
    elif layout == "padded_rows":
        strides[2] = (s * (d + 1), d + 1, 1)
    want = "sm90" if layout == "contiguous" and _sm90_takes(dtype, d) \
        else "base"
    assert _kernels.fwd_design(dtype, d, strides, ptrs) == want
    assert want in _kernels.FWD_DESIGNS


def test_fwd_design_takes_every_main_path_launch():
    """Every flash forward of the main path is d = 64 on contiguous torch
    allocations: the sm90 design at both dtypes, a base one row further on
    too (64 elements are 16-byte multiples)."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((12, 640, 64), dtype=dtype)
        ptr = q.data_ptr() - q.data_ptr() % 16
        strides = [q.stride()] * 3
        assert _kernels.fwd_design(dtype, 64, strides, [ptr] * 3) == "sm90"
        row = 64 * q.element_size()
        assert _kernels.fwd_design(dtype, 64, strides,
                                   [ptr + row] * 3) == "sm90"


def test_signatures_name_the_sm90_forward():
    """The sm90 forward is a source of its own with its own C symbol,
    taking what the baseline takes (q, k, v, lens, o, lse and the common
    tail); the baseline keeps its symbol.  So does the sm90 backward:
    ``flash_bwd_sm90.cu``'s two symbols take what ``flash_bwd.cu``'s
    take."""
    sig = _kernels._SIGNATURES
    assert set(sig) == {"flash_fwd.cu", "flash_fwd_sm90.cu", "flash_bwd.cu",
                        "flash_bwd_sm90.cu"}
    assert sig["flash_fwd_sm90.cu"] == {
        "flash_fwd_sm90": [_kernels._VOID] * 6 + _kernels._TAIL}
    assert sig["flash_fwd.cu"] == {
        "flash_fwd": [_kernels._VOID] * 6 + _kernels._TAIL}
    assert set(sig["flash_bwd.cu"]) == {"flash_bwd_dq", "flash_bwd_dkv"}
    assert sig["flash_bwd_sm90.cu"] == {
        f"{name}_sm90": args for name, args in sig["flash_bwd.cu"].items()}
    for name in sig:
        assert (_kernels._CSRC / name).exists()


def test_launch_counts_by_design_sum_to_the_launches():
    """A launch of any kernel counts once in ``launches`` and once under
    its dtype and design; a reset clears both."""
    _kernels.reset_launch_counts()
    try:
        for dtype, design in ((torch.bfloat16, "sm90"),
                              (torch.bfloat16, "sm90"),
                              (torch.float32, "base")):
            _kernels.flash_fwd._count(torch.zeros(1, dtype=dtype), design)
        _kernels.flash_bwd_dq._count(torch.zeros(1, dtype=torch.bfloat16),
                                     "sm90")
        for design in ("sm90", "base", "base"):
            _kernels.flash_bwd_dkv._count(torch.zeros(1), design)
        by_design = _kernels.launch_counts_by_design()
        zeros = {f"{name}[{dt},{design}]": 0
                 for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                 for dt in ("f32", "bf16") for design in ("sm90", "base")}
        assert by_design == dict(zeros, **{"flash_fwd[f32,base]": 1,
                                           "flash_fwd[bf16,sm90]": 2,
                                           "flash_bwd_dq[bf16,sm90]": 1,
                                           "flash_bwd_dkv[f32,sm90]": 1,
                                           "flash_bwd_dkv[f32,base]": 2})
        for name, n in _kernels.launch_counts().items():
            assert n == sum(c for key, c in by_design.items()
                            if key.startswith(name + "["))
        assert _kernels.launch_counts_by_dtype()["flash_fwd[bf16]"] == 2
        assert _kernels.launch_counts_by_dtype()["flash_bwd_dkv[f32]"] == 3
    finally:
        _kernels.reset_launch_counts()
    assert not any(_kernels.launch_counts_by_design().values())


def test_launch_totals_by_design_outlive_a_reset():
    """``total_by_design`` counts the forward's launches by design since
    import: a reset clears the other counts and leaves it, so a run that
    resets on its own is read from before it and after it."""
    saved = collections.Counter(_kernels.flash_fwd.total_by_design)
    try:
        _kernels.flash_fwd._count(torch.zeros(1, dtype=torch.bfloat16),
                                  "sm90")
        _kernels.reset_launch_counts()
        _kernels.flash_fwd._count(torch.zeros(1), "base")
        _kernels.flash_fwd._count(torch.zeros(1), "sm90")
        assert _kernels.launch_counts()["flash_fwd"] == 2
        grown = _kernels.flash_fwd.total_by_design - saved
        assert grown == collections.Counter(sm90=2, base=1)
    finally:
        _kernels.reset_launch_counts()
        _kernels.flash_fwd.total_by_design = saved


def _bwd_sm90_takes(dtype, d):
    """The sm90 backward takes what the sm90 forward takes, up to d = 64
    at f32 (16-byte rows: a multiple of 4 there, of 8 at bf16)."""
    return _sm90_takes(dtype, d) and (dtype == torch.bfloat16 or d <= 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 20, 32, 37, 64, 72, 96, 128, 136, 256])
@pytest.mark.parametrize("layout", ["contiguous", "base_off_by_one",
                                    "padded_rows", "do_padded_rows"])
def test_bwd_design_rule(dtype, d, layout):
    """The backward's design is a plain function of dtype, head dim,
    strides and base alignment of q, k, v and do: ``sm90`` where TMA and
    wgmma take the call (16-byte-multiple contiguous rows, 16-byte-aligned
    bases, d <= 128 at bf16 and d <= 64 at f32), the ``base`` kernels
    otherwise -- an f32 head past 64, a base one element off, or rows
    padded past d in any of the four tensors."""
    item = 4 if dtype == torch.float32 else 2
    s = 40
    strides = [(s * d, d, 1)] * 4
    ptrs = [0, 4096, 1 << 20, 3 << 20]
    if layout == "base_off_by_one":
        ptrs[2] += item
    elif layout == "padded_rows":
        strides[0] = (s * (d + 8), d + 8, 1)
    elif layout == "do_padded_rows":
        strides[3] = (s * (d + 1), d + 1, 1)
    want = "sm90" if layout == "contiguous" and _bwd_sm90_takes(dtype, d) \
        else "base"
    assert _kernels.bwd_design(dtype, d, strides, ptrs) == want
    assert want in _kernels.BWD_DESIGNS


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("lengths", [None, [96, 40]])
def test_bwd_design_takes_every_mixed_launch(monkeypatch, layout, lengths):
    """The training paths' backward (bf16 and f32, d = 64) reaches the
    kernels with q, k, v and do as ``FlashAttentionFunction`` folds them,
    contiguous on fresh allocations: ``bwd_design`` gives it sm90 at both
    dtypes."""
    seen = []
    plain = tattn.flash_attention_bwd_reference

    def keep(q, k, v, o, lse, do, *rest):
        seen.append((q, k, v, do))
        return plain(q, k, v, o, lse, do, *rest)

    monkeypatch.setattr(tattn, "flash_attention_bwd_reference", keep)
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator().manual_seed(0)
        shape = (2, 96, 12, 64) if layout == "bshd" else (2, 12, 96, 64)
        q, k, v = (torch.randn(shape, generator=g).to(dtype)
                   .requires_grad_() for _ in range(3))
        lens = None if lengths is None else torch.tensor(lengths)
        out = tattn.flash_attention(q, k, v, causal=True, layout=layout,
                                    kv_lengths=lens)
        out.float().square().sum().backward()
        fq, fk, fv, fdo = seen.pop()
        assert fq.shape == (24, 96, 64) and fdo.dtype == dtype
        tensors = (fq, fk, fv, fdo)
        ptrs = [t_.data_ptr() - t_.data_ptr() % 16 for t_ in tensors]
        got = _kernels.bwd_design(dtype, 64, [t_.stride() for t_ in tensors],
                                  ptrs)
        assert got == "sm90"
        assert all(t_.is_contiguous() for t_ in tensors)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_forced_sm90_refuses_what_the_rule_does_not_give_it(name):
    """A forced ``sm90`` design raises where the design rule chose the
    baseline (d = 256, which no sm90 kernel takes): no call is quietly
    moved to the other design; ``base`` takes every shape."""
    with pytest.raises(ValueError, match="does not take"):
        _kernels._chosen(name, "sm90", "base", 256, torch.float32)
    assert _kernels._chosen(name, "base", "sm90", 64,
                            torch.bfloat16) == "base"
    assert _kernels._chosen(name, None, "sm90", 64, torch.bfloat16) == "sm90"
    with pytest.raises(ValueError, match="does not take"):
        _kernels._chosen(name, "sm100", "sm90", 64, torch.bfloat16)


def test_backward_launch_totals_by_dtype_and_design_outlive_a_reset():
    """``total_by_dtype_design`` counts a backward kernel's launches by
    dtype and design since import, as ``total_by_design`` does by design:
    a reset leaves both, so a phase is read from before and after it."""
    kern = _kernels.flash_bwd_dkv
    saved = (collections.Counter(kern.total_by_design),
             collections.Counter(kern.total_by_dtype_design))
    try:
        kern._count(torch.zeros(1, dtype=torch.bfloat16), "sm90")
        _kernels.reset_launch_counts()
        kern._count(torch.zeros(1), "base")
        assert kern.launches == 1
        assert kern.total_by_dtype_design - saved[1] == collections.Counter(
            {"bf16,sm90": 1, "f32,base": 1})
        assert kern.total_by_design - saved[0] == collections.Counter(
            sm90=1, base=1)
    finally:
        _kernels.reset_launch_counts()
        kern.total_by_design, kern.total_by_dtype_design = saved


def test_backward_calls_take_no_design():
    """The backward kernels' design is chosen by shape, never asked for:
    the public calls take the backward's arguments only."""
    for kern in (_kernels.flash_bwd_dq, _kernels.flash_bwd_dkv):
        params = inspect.signature(kern.__call__).parameters
        assert list(params) == ["q", "k", "v", "do", "lse", "delta", "lens",
                                "causal", "scale"]


def test_forward_call_takes_no_design():
    """The forward's design is chosen by shape, never asked for: the
    public call takes the attention arguments only."""
    params = inspect.signature(_kernels.flash_fwd.__call__).parameters
    assert list(params) == ["q", "k", "v", "lens", "causal", "scale"]
