"""The port's flash backward against the JAX package's, and the 3xTF32
tolerance basis of the CUDA kernels (forward and backward).

Same inputs (numpy, seeded) through both packages on the CPU.  The JAX
side differentiates its Pallas flash attention in the interpreter
(``jax.grad`` of ``flash_attention(..., interpret=True)``, which runs its
dq and dk/dv kernels); the port's side is ``FlashAttentionFunction``,
whose backward on a CPU tensor runs the plain versions of the two CUDA
kernels (``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``).
Gradients agree within atol 1e-5 at f32 (sums over at most a few hundred
keys, taken in another order); padded keys get dk = dv = 0 exactly.  The
CUDA kernels themselves are held against the plain versions only where a
card is present, in ``tests/test_torch_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as tattn
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    MultiHeadSelfAttention)

jattn = importlib.import_module("analytics_zoo_tpu.ops.attention")
ATOL = 1e-5


def qkv(b=2, sq=64, sk=None, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    return (rng.normal(0, 1, (b, sq, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, sq, h, d)).astype(np.float32))


def port_grads(q, k, v, ct, **kw):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def jax_grads(q, k, v, ct, **kw):
    f = lambda q, k, v: jattn.flash_attention(q, k, v, interpret=True, **kw)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


# the shapes of tests/test_attention_parallel.py's and
# tests/test_attention_masking.py's backward cases
GRAD_CASES = [
    # causal, sq, sk, d, kv_lengths, layout
    (False, 128, 128, 32, None, "bshd"),
    (True, 128, 128, 32, None, "bshd"),
    (True, 64, 128, 32, None, "bshd"),     # cached-kv decode shape
    (True, 127, 127, 16, None, "bshd"),    # prime: the JAX side pads
    (False, 127, 251, 16, None, "bshd"),   # prime cross
    (False, 131, 64, 16, None, "bshd"),    # awkward q only
    (True, 127, 127, 16, [127, 42], "bshd"),
    (False, 127, 251, 16, [251, 83], "bshd"),
    (False, 32, 32, 8, [32, 11], "bshd"),  # masking file's lengths
    (True, 32, 32, 8, [32, 11], "bshd"),
    (True, 64, 64, 32, None, "bhsd"),
    (False, 130, 130, 16, [130, 70], "bhsd"),
    # head dims past 128: the kernels' widest instantiation (DP = 256)
    (True, 65, 65, 192, [65, 29], "bshd"),
    (False, 40, 72, 256, None, "bhsd"),
]


@pytest.mark.parametrize("causal,sq,sk,d,lens,layout", GRAD_CASES)
def test_flash_grads_match_jax_interpret(causal, sq, sk, d, lens, layout):
    q, k, v, ct = qkv(sq=sq, sk=sk, d=d, seed=sq + sk)
    if layout == "bhsd":
        q, k, v, ct = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v, ct))
    kw = dict(causal=causal, kv_lengths=lens, layout=layout)
    out, grads = port_grads(q, k, v, ct, **kw)
    ref_out, ref_grads = jax_grads(q, k, v, ct, **kw)
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=ATOL)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")
    if lens is not None:
        seq_axis = 1 if layout == "bshd" else 2
        for b, n in enumerate(lens):
            for g in grads[1:]:
                pad = np.take(g[b], np.arange(n, sk), axis=seq_axis - 1)
                np.testing.assert_array_equal(pad, 0.0)


def test_flash_grads_prime_key_length_match_jax():
    """sk = 1009 (prime): the JAX backward falls back to its forward's
    key block; the port walks 64-key tiles with a ragged last tile."""
    q, k, v, ct = qkv(b=1, sq=64, sk=1009, h=1, d=16, seed=7)
    _, grads = port_grads(q, k, v, ct)
    _, ref = jax_grads(q, k, v, ct)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)


def test_flash_output_differentiates_through_the_function():
    """The fault repaired here: the flash path's output carried no
    grad_fn on a CUDA tensor, so a loss through it left Wq/Wk/Wv without
    gradients.  Now the output's graph runs through
    FlashAttentionFunction, and its backward calls the plain backward on
    a CPU tensor (never autograd through the plain forward)."""
    q, k, v, ct = qkv(seed=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    fold = lambda a: a.transpose(1, 2).reshape(4, 64, 16).contiguous()
    out = tattn.FlashAttentionFunction.apply(fold(tq), fold(tk), fold(tv),
                                             None, True, 0.25)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"

    out = tattn.attention(tq, tk, tv, causal=True, implementation="flash")
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            stack.extend(f for f, _ in fn.next_functions)
    assert "FlashAttentionFunctionBackward" in {type(f).__name__
                                                for f in seen}
    assert "ExpBackward0" not in {type(f).__name__ for f in seen}


def test_flash_backward_calls_the_plain_backward(monkeypatch):
    calls = []
    for name in ("flash_bwd_dq_reference", "flash_bwd_dkv_reference"):
        real = getattr(tattn, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(tattn, name, spy)
    layer = MultiHeadSelfAttention(2, implementation="flash",
                                   input_shape=(24, 16), device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 24, 16)).astype(np.float32))
    layer(x).sum().backward()
    assert calls == ["flash_bwd_dq_reference", "flash_bwd_dkv_reference"]
    assert all(layer.params()[w].grad is not None
               for w in ("Wq", "Wk", "Wv", "Wo"))
    assert _kernels.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                        "flash_bwd_dkv": 0}


def test_plain_backward_matches_jax_custom_vjp_residuals():
    """flash_attention_bwd_reference from the forward's own (o, lse)
    against the JAX package's _flash_core backward, folded arrays."""
    b, h, sq, sk, d = 2, 2, 96, 80, 16
    q, k, v, do = qkv(b=b, sq=sq, sk=sk, h=h, d=d, seed=11)
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(b * h, -1, d).copy()
    qf, kf, vf, dof = (fold(a) for a in (q, k, v, do))
    lens = np.repeat(np.array([80, 33], np.float32), h)
    scale = d ** -0.5
    core = lambda q, k, v: jattn._flash_core(
        q, k, v, jnp.asarray(lens)[:, None, None], sq, sk, False, True, 32,
        16, scale, True)
    _, vjp = jax.vjp(core, *(jnp.asarray(a) for a in (qf, kf, vf)))
    ref = vjp(jnp.asarray(dof))
    tl = torch.from_numpy(lens)
    o, lse = tattn.flash_attention_reference(
        *(torch.from_numpy(a) for a in (qf, kf, vf)), False, scale, tl)
    got = tattn.flash_attention_bwd_reference(
        torch.from_numpy(qf), torch.from_numpy(kf), torch.from_numpy(vf), o,
        lse, torch.from_numpy(dof), tl, False, scale)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)


_BMM = torch.bmm


def tf32_round(x):
    """x rounded to TF32 (10 significand bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: on the f32 bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x):
    """x cut to TF32: its low 13 significand bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


SPLITS = {
    # hi and lo both rounded to nearest
    "rna": lambda x: (tf32_round(x), tf32_round(x - tf32_round(x))),
    # the kernels' split: hi cut, lo = x - hi read by the MMA as its
    # TF32 part (cut again)
    "cut": lambda x: (tf32_cut(x), tf32_cut(x - tf32_cut(x))),
}


def bmm_3xtf32(split):
    """torch.bmm with every product in 3xTF32: a_lo.b_hi + a_hi.b_lo +
    a_hi.b_hi over TF32 parts (each partial product exact in f32, sums
    in f32), lo.lo dropped."""
    def bmm(a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        return _BMM(al, bh) + _BMM(ah, bl) + _BMM(ah, bh)
    return bmm


def _folded_case(b, h, sq, sk, d, seed):
    q, k, v, do = qkv(b=b, sq=sq, sk=sk, h=h, d=d, seed=seed)
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(b * h, -1, d).copy()
    return [fold(a) for a in (q, k, v, do)]


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("causal,sq,sk,d,lens", [
    (True, 96, 96, 32, [96, 41]),   # causal with lengths
    (True, 64, 64, 72, None),       # head_dim 72: no multiple of 16
])
def test_3xtf32_backward_within_1e5_of_exact(monkeypatch, split, causal, sq,
                                             sk, d, lens):
    """The tolerance basis of the CUDA backward kernels: their f32
    products are 3xTF32 on the tensor cores.  The plain dq/dk/dv tile
    algorithm with every product emulated that way stays within 1e-5
    relative (max|diff| / max|ref|) of the exact plain version and of the
    JAX package's _flash_core VJP (Pallas interpret mode); chip_smoke.py
    holds the kernels to 1e-4."""
    b, h = 2, 2
    qf, kf, vf, dof = _folded_case(b, h, sq, sk, d, seed=sq + d)
    scale = d ** -0.5
    lens_bh = None if lens is None else np.repeat(
        np.asarray(lens, np.float32), h)
    jlens = (jnp.ones((b * h, 1, 1), jnp.float32) if lens is None
             else jnp.asarray(lens_bh)[:, None, None])
    core = lambda q, k, v: jattn._flash_core(
        q, k, v, jlens, sq, sk, causal, lens is not None, 32, 32, scale,
        True)
    _, vjp = jax.vjp(core, *(jnp.asarray(a) for a in (qf, kf, vf)))
    jax_ref = vjp(jnp.asarray(dof))

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (qf, kf, vf, dof))
    tl = None if lens is None else torch.from_numpy(lens_bh)
    o, lse = tattn.flash_attention_reference(tq, tk, tv, causal, scale, tl)
    args = (tq, tk, tv, o, lse, tdo, tl, causal, scale)
    exact = tattn.flash_attention_bwd_reference(*args)
    monkeypatch.setattr(torch, "bmm", bmm_3xtf32(SPLITS[split]))
    emulated = tattn.flash_attention_bwd_reference(*args)
    monkeypatch.undo()
    for name, e, x, j in zip("qkv", emulated, exact, jax_ref):
        assert rel_err(e, x) <= 1e-5, f"d{name} against the exact plain"
        assert rel_err(e, j) <= 1e-5, f"d{name} against JAX"
        assert rel_err(x, j) <= 1e-5, f"d{name}: exact plain against JAX"


def test_one_pass_tf32_backward_misses_what_3xtf32_holds(monkeypatch):
    """Why three products: one TF32 product per f32 product (hi.hi only)
    misses the f32 tolerance that 3xTF32 holds (here ~9e-4 against
    ~9e-7 relative)."""
    qf, kf, vf, dof = _folded_case(2, 2, 96, 96, 32, seed=5)
    args = [torch.from_numpy(a) for a in (qf, kf, vf)]
    o, lse = tattn.flash_attention_reference(*args, True)
    args += [o, lse, torch.from_numpy(dof), None, True, 32 ** -0.5]
    exact = tattn.flash_attention_bwd_reference(*args)
    errs = {}
    for name, bmm in (("3x", bmm_3xtf32(SPLITS["rna"])),
                      ("1x", lambda a, b: _BMM(tf32_round(a),
                                               tf32_round(b)))):
        monkeypatch.setattr(torch, "bmm", bmm)
        errs[name] = max(rel_err(g, x) for g, x in zip(
            tattn.flash_attention_bwd_reference(*args), exact))
        monkeypatch.undo()
    assert errs["3x"] <= 1e-5
    assert errs["1x"] > 1e-4  # past chip_smoke.py's f32 tolerance


def _forward_case(causal, sq, sk, d, lens, seed):
    """Folded (bh, s, d) q/k/v of one case, its (bh,) lengths (or None),
    and the JAX package's Pallas forward in interpret mode: o from
    ``flash_attention`` and lse from ``_flash_fwd_call``."""
    b, h = 2, 2
    q, k, v, _ = qkv(b=b, sq=sq, sk=sk, h=h, d=d, seed=seed)
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(b * h, -1, d).copy()
    qf, kf, vf = (fold(a) for a in (q, k, v))
    lens_bh = None if lens is None else np.repeat(
        np.asarray(lens, np.float32), h)
    jlens = (jnp.ones((b * h, 1, 1), jnp.float32) if lens is None
             else jnp.asarray(lens_bh)[:, None, None])
    block = 16
    _, jax_lse = jattn._flash_fwd_call(
        *(jnp.asarray(a) for a in (qf, kf, vf)), jlens, sq, sk, causal,
        lens is not None, block, block, d ** -0.5, True)
    jax_o = jattn.flash_attention(q, k, v, causal=causal, interpret=True,
                                  kv_lengths=lens)
    jax_o = fold(np.asarray(jax_o))
    args = [torch.from_numpy(a) for a in (qf, kf, vf)]
    tl = None if lens is None else torch.from_numpy(lens_bh)
    return args, tl, jax_o, np.asarray(jax_lse)[:, 0]


def lse_err(got, ref):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(ref, np.float64)).max())


FORWARD_CASES = [
    # causal, sq, sk, d, lens
    (True, 96, 96, 32, [96, 41]),    # causal with lengths
    (False, 64, 64, 72, None),       # head_dim 72: no multiple of 16
    (True, 48, 112, 16, None),       # cross causal, sq < sk
]


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("causal,sq,sk,d,lens", FORWARD_CASES)
def test_3xtf32_forward_within_1e5_of_exact(monkeypatch, split, causal, sq,
                                            sk, d, lens):
    """The tolerance basis of the CUDA forward kernel: its f32 products
    (q.k and p.v) are 3xTF32 on the tensor cores.  The plain forward with
    both products emulated that way stays within 1e-5 of the exact plain
    version and of the JAX package's Pallas forward (interpret mode): o
    relative (max|diff| / max|ref|), lse absolute.  chip_smoke.py holds
    the kernel's lse to 1e-5, since both backward kernels replay p from
    it."""
    args, tl, jax_o, jax_lse = _forward_case(causal, sq, sk, d, lens,
                                             seed=sq + sk + d)
    scale = d ** -0.5
    exact_o, exact_lse = tattn.flash_attention_reference(*args, causal,
                                                         scale, tl)
    monkeypatch.setattr(torch, "bmm", bmm_3xtf32(SPLITS[split]))
    o, lse = tattn.flash_attention_reference(*args, causal, scale, tl)
    monkeypatch.undo()
    assert rel_err(o, exact_o) <= 1e-5
    assert lse_err(lse, exact_lse) <= 1e-5
    assert rel_err(o, jax_o) <= 1e-5
    assert lse_err(lse, jax_lse) <= 1e-5
    assert rel_err(exact_o, jax_o) <= 1e-5
    assert lse_err(exact_lse, jax_lse) <= 1e-5


def test_one_pass_tf32_forward_misses_what_3xtf32_holds(monkeypatch):
    """Why three products in the forward too: one TF32 product per f32
    product misses the kernel's f32 tolerance (1e-4 on o, here on the lse
    as well) on the inputs that 3xTF32 holds to 1e-5."""
    causal, sq, sk, d, lens = FORWARD_CASES[0]
    args, tl, _, _ = _forward_case(causal, sq, sk, d, lens, seed=sq + sk + d)
    exact_o, exact_lse = tattn.flash_attention_reference(*args, causal,
                                                         d ** -0.5, tl)
    errs = {}
    for name, bmm in (("3x", bmm_3xtf32(SPLITS["cut"])),
                      ("1x", lambda a, b: _BMM(tf32_cut(a), tf32_cut(b)))):
        monkeypatch.setattr(torch, "bmm", bmm)
        o, lse = tattn.flash_attention_reference(*args, causal, d ** -0.5,
                                                 tl)
        monkeypatch.undo()
        errs[name] = (rel_err(o, exact_o), lse_err(lse, exact_lse))
    assert max(errs["3x"]) <= 1e-5
    assert errs["1x"][0] > 1e-4 and errs["1x"][1] > 1e-4


def test_tf32_helpers_round_and_cut_the_bit_pattern():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 3 * 2 ** -11),
                      1 + 2 ** -10 - 2 ** -23], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1 + 2 ** -10, 1 + 2 ** -9,
                                      -(1 + 2 ** -9), 1 + 2 ** -10]
    assert tf32_cut(x).tolist() == [1.0, 1 + 2 ** -10, -(1 + 2 ** -10),
                                    1.0]
    for split in SPLITS.values():
        hi, lo = split(x)
        assert torch.equal(tf32_cut(hi), hi) and torch.equal(tf32_cut(lo),
                                                             lo)
        assert float((hi + lo - x).abs().max()) <= 2 ** -20


def test_plain_backward_bf16_keeps_the_rounding_points():
    """bf16 inputs: gradients come back at bf16, within bf16 rounding of
    the f32 gradients (atol 5e-2 at unit-scale inputs)."""
    q, k, v, do = (torch.from_numpy(a.transpose(0, 2, 1, 3).reshape(
        4, 64, 16).copy()) for a in qkv(seed=5))
    f32 = tattn.flash_attention_bwd_reference(
        q, k, v, *tattn.flash_attention_reference(q, k, v, True), do,
        causal=True)
    q16, k16, v16, do16 = (a.to(torch.bfloat16) for a in (q, k, v, do))
    b16 = tattn.flash_attention_bwd_reference(
        q16, k16, v16, *tattn.flash_attention_reference(q16, k16, v16, True),
        do16, causal=True)
    for g16, g32 in zip(b16, f32):
        assert g16.dtype == torch.bfloat16
        np.testing.assert_allclose(g16.float().numpy(), g32.numpy(), rtol=0,
                                   atol=5e-2)


def test_dkv_plain_writes_zeros_for_key_tiles_past_lens():
    """A key tile wholly at or past a row's length is written as exact
    zeros (the kernel skips its loop); a partly valid tile keeps zeros
    past the length too."""
    q, k, v, do = (torch.from_numpy(a.transpose(0, 2, 1, 3).reshape(
        4, -1, 16).copy()) for a in qkv(sq=100, sk=200, seed=6))
    lens = torch.tensor([200.0, 200.0, 70.0, 5.0])
    o, lse = tattn.flash_attention_reference(q, k, v, False, 0.25, lens)
    delta = tattn._flash_delta(o, do)
    dk, dv = tattn.flash_bwd_dkv_reference(q, k, v, do, lse, delta, lens,
                                           False, 0.25)
    for row, n in ((2, 70), (3, 5)):
        assert torch.all(dk[row, n:] == 0) and torch.all(dv[row, n:] == 0)
        assert torch.any(dk[row, :n] != 0)
    assert torch.all(dk[:2] != 0)


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((2, 8, 16))
    rows = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.flash_bwd_dq(q, q, q, q, rows, rows, None, True, 0.25)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.flash_bwd_dkv(q, q, q, q, rows, rows, None, True, 0.25)
    assert _kernels.flash_bwd_dq.launches == 0
    assert _kernels.flash_bwd_dkv.launches == 0
