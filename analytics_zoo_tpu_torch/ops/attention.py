"""Attention ops: naive, blockwise (online softmax) and flash attention.

Counterpart of ``analytics_zoo_tpu/ops/attention.py``.  The three
implementations share one semantics:

* ``naive_attention``: O(S^2) materialised scores; the test oracle.
* ``blockwise_attention``: a loop over key blocks with an online softmax.
* ``flash_attention``: :class:`FlashAttentionFunction`, whose forward
  is a hand-written CUDA kernel (``csrc/flash_fwd_sm90.cu`` or
  ``csrc/flash_fwd.cu``, as ``_kernels.fwd_design`` picks by shape) and
  whose backward is the two kernels of ``csrc/flash_bwd.cu`` on a CUDA
  tensor;
  on a CPU tensor their plain versions (:func:`flash_attention_reference`,
  :func:`flash_bwd_dq_reference`, :func:`flash_bwd_dkv_reference`),
  which run the kernels' tile algorithms in torch (the role Pallas
  ``interpret=True`` plays for the JAX package).

``attention`` and ``naive``/``blockwise`` take (batch, seq, heads,
head_dim); ``attention_bhsd`` takes (batch, heads, seq, head_dim).
Masking uses the finite sentinel ``NEG_INF``; causal alignment is
``q_pos = i + (sk - sq)``; ``kv_lengths`` are clamped to ``[1, sk]``.
"""

from __future__ import annotations

import math

import torch

from . import _kernels

NEG_INF = -1e30
#: the plain versions' query and key tiles (the CUDA kernels walk tiles of
#: their own sizes; see flash_attention_reference)
BLOCK_Q = 64
BLOCK_K = 64


def _clamp_lengths(kv_lengths, sk, device=None):
    """Normalize per-batch valid key lengths to f32 in [1, sk].

    The floor of 1 keeps fully-masked rows out of every implementation:
    an "empty" sequence attends to position 0 and its output must be
    masked downstream, which padded batches do anyway."""
    lens = torch.as_tensor(kv_lengths, device=device)
    if lens.dim() != 1:
        raise ValueError(
            f"kv_lengths must be (batch,), got shape {tuple(lens.shape)}")
    return lens.to(torch.float32).clamp(1, sk)


def naive_attention(q, k, v, causal: bool = False, scale: float = None,
                    kv_lengths=None):
    """Materialised-scores attention (oracle).  ``kv_lengths``: optional
    (batch,) valid key counts; keys at positions >= kv_lengths[b] are
    masked.  Padded query rows still produce outputs: mask them
    downstream."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = torch.where(mask, scores, NEG_INF)
    if kv_lengths is not None:
        lens = _clamp_lengths(kv_lengths, sk, q.device)
        kmask = torch.arange(sk, device=q.device)[None, :] < lens[:, None]
        scores = torch.where(kmask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_attention(q, k, v, causal: bool = False,
                        block_k: int = 512, scale: float = None,
                        kv_lengths=None):
    """Online-softmax attention over key blocks: O(seq) score memory."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    block_k = min(block_k, sk)
    if sk % block_k != 0:
        raise ValueError(
            f"block_k ({block_k}) must divide the key length ({sk})")
    lens = (None if kv_lengths is None
            else _clamp_lengths(kv_lengths, sk, q.device))
    q_scaled = q * scale
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    o = torch.zeros((b, h, sq, d), device=q.device)
    for start in range(0, sk, block_k):
        k_blk = k[:, start:start + block_k]
        v_blk = v[:, start:start + block_k]
        scores = torch.einsum("bqhd,bkhd->bhqk", q_scaled, k_blk)
        k_pos = start + torch.arange(block_k, device=q.device)
        if causal:
            mask = q_pos[:, None] + (sk - sq) >= k_pos[None, :]
            scores = torch.where(mask[None, None], scores, NEG_INF)
        if lens is not None:
            kmask = k_pos[None, :] < lens[:, None]
            scores = torch.where(kmask[:, None, None, :], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1)
        # p is f32 (m is): promote v as jnp.einsum does, so bf16 inputs
        # give the JAX package's f32 output
        o = (o * correction[..., None]
             + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.to(p.dtype)))
        m = m_new
    out = o / l[..., None].clamp_min(1e-30)
    return out.transpose(1, 2)  # (b, h, q, d) -> (b, q, h, d)


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: float = None, lens=None):
    """Plain version of the CUDA flash-forward kernel: its tile
    algorithm in torch, in exact f32 products (the kernel's f32 products
    are 3xTF32 on the tensor cores, within ~2^-20 relative of these).

    q (bh, sq, d), k/v (bh, sk, d) at f32 or bf16; ``lens`` (bh,) f32
    valid key counts in [1, sk] or None.  For each 64-row query tile it
    walks 64-key tiles with an online softmax (running max, denominator
    and f32 accumulator), skipping key tiles past the causal diagonal and
    past ceil(len / 64); p is rounded to the input dtype before the p*v
    product.  Returns (o (bh, sq, d) at the input dtype, lse (bh, sq)
    f32 = m + log(l)).  A tile that a row's causal or length mask covers
    wholly changes nothing for that row (p underflows to 0 and the
    correction is 1), so the skip count may be shared across rows.  The
    kernel walks other tiles (at head_dim 64: 128 query rows, 16 a warp,
    and 32 keys at f32 or 64 at bf16); a tile it skips is one whose pairs
    are all masked, so the tile size does not change the result."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    n_kb = -(-sk // BLOCK_K)
    if lens is not None:
        n_kb = min(n_kb, math.ceil(float(lens.max()) / BLOCK_K))
    for q0 in range(0, sq, BLOCK_Q):
        q1 = min(q0 + BLOCK_Q, sq)
        n_iter = n_kb
        if causal:
            n_iter = min(n_iter, (q1 - 1 + sk - sq) // BLOCK_K + 1)
        q_pos = torch.arange(q0, q1, device=q.device)
        m = torch.full((bh, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros((bh, q1 - q0), device=q.device)
        acc = torch.zeros((bh, q1 - q0, d), device=q.device)
        for j in range(n_iter):
            k0, k1 = j * BLOCK_K, min((j + 1) * BLOCK_K, sk)
            s = torch.bmm(qf[:, q0:q1], kf[:, k0:k1].transpose(1, 2)) * scale
            k_pos = torch.arange(k0, k1, device=q.device)
            if causal:
                valid = q_pos[:, None] + (sk - sq) >= k_pos[None, :]
                s = torch.where(valid[None], s, NEG_INF)
            if lens is not None:
                valid = k_pos[None, None, :].float() < lens[:, None, None]
                s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.bmm(p.to(v.dtype).float(), vf[:, k0:k1])
            acc = acc * corr[..., None] + pv
            m = m_new
        l_safe = l.clamp_min(1e-30)
        o[:, q0:q1] = (acc / l_safe[..., None]).to(q.dtype)
        lse[:, q0:q1] = m + torch.log(l_safe)
    return o, lse


def _replay_tile(qf, kf, vf, dof, lse, delta, q0, q1, k0, k1, sq, sk,
                 causal, lens, scale):
    """p and ds (f32) of one (query tile, key tile) pair, replayed from
    the forward's lse as the backward kernels do: p = exp(s * scale -
    lse) where the pair is valid, exactly 0 where it is masked, and
    ds = p * (dp - delta) * scale with dp = do . v^T."""
    s = torch.bmm(qf[:, q0:q1], kf[:, k0:k1].transpose(1, 2))
    q_pos = torch.arange(q0, q1, device=qf.device)
    k_pos = torch.arange(k0, k1, device=qf.device)
    valid = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                       device=qf.device)[None]
    if causal:
        valid = valid & (q_pos[:, None] + (sk - sq) >= k_pos[None, :])
    if lens is not None:
        valid = valid & (k_pos[None, None, :].float() < lens[:, None, None])
    p = torch.where(valid, torch.exp(s * scale - lse[:, q0:q1, None]), 0.0)
    dp = torch.bmm(dof[:, q0:q1], vf[:, k0:k1].transpose(1, 2))
    ds = p * (dp - delta[:, q0:q1, None]) * scale
    return p, ds


def _key_tiles(sk, lens):
    """Key tiles any row may reach: ceil(sk / 64), cut at ceil(len / 64)."""
    n_kb = -(-sk // BLOCK_K)
    if lens is not None:
        n_kb = min(n_kb, math.ceil(float(lens.max()) / BLOCK_K))
    return n_kb


def flash_bwd_dq_reference(q, k, v, do, lse, delta, lens, causal: bool,
                           scale: float):
    """Plain version of the CUDA kernel ``flash_bwd_dq``: its tile
    algorithm in torch, in exact f32 products (the kernel's f32 products
    are 3xTF32 on the tensor cores, within ~2^-20 relative of these).

    q/do (bh, sq, d) and k/v (bh, sk, d) at one dtype (f32 or bf16), lse
    and delta (bh, sq) f32, ``lens`` (bh,) f32 or None.  For each 64-row
    query tile it walks 64-key tiles up to its causal diagonal and
    ceil(len / 64), replays p and ds (:func:`_replay_tile`) and
    accumulates dq += ds . k in f32, with ds rounded to k's dtype first.
    The kernel walks narrower key tiles; a skipped tile is one whose pairs
    are all masked, so the tile size does not change the result.
    Returns dq (bh, sq, d) at the input dtype."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.empty_like(q)
    n_kb = _key_tiles(sk, lens)
    for q0 in range(0, sq, BLOCK_Q):
        q1 = min(q0 + BLOCK_Q, sq)
        n_iter = n_kb
        if causal:
            n_iter = min(n_iter, (q1 - 1 + sk - sq) // BLOCK_K + 1)
        acc = torch.zeros((bh, q1 - q0, d), device=q.device)
        for j in range(n_iter):
            k0, k1 = j * BLOCK_K, min((j + 1) * BLOCK_K, sk)
            _, ds = _replay_tile(qf, kf, vf, dof, lse, delta, q0, q1, k0,
                                 k1, sq, sk, causal, lens, scale)
            acc = acc + torch.bmm(ds.to(k.dtype).float(), kf[:, k0:k1])
        dq[:, q0:q1] = acc.to(q.dtype)
    return dq


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, lens, causal: bool,
                            scale: float):
    """Plain version of the CUDA kernel ``flash_bwd_dkv``: its tile
    algorithm in torch, in exact f32 products (as
    :func:`flash_bwd_dq_reference`).

    Arguments as :func:`flash_bwd_dq_reference`.  For each 64-key tile it
    walks 64-row query tiles from the first whose last row reaches it
    causally, and accumulates dv += p^T . do (p rounded to do's dtype)
    and dk += ds^T . q (ds rounded to q's dtype) in f32; a key tile at or
    past every length is left at zero.  The kernel walks narrower query
    tiles, which skips no valid pair either.  Returns (dk, dv),
    (bh, sk, d) at the input dtype."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    n_qb = -(-sq // BLOCK_Q)
    for j in range(_key_tiles(sk, lens)):
        k0, k1 = j * BLOCK_K, min((j + 1) * BLOCK_K, sk)
        start = max(0, (k0 - (sk - sq)) // BLOCK_Q) if causal else 0
        dk_acc = torch.zeros((bh, k1 - k0, d), device=q.device)
        dv_acc = torch.zeros((bh, k1 - k0, d), device=q.device)
        for i in range(start, n_qb):
            q0, q1 = i * BLOCK_Q, min((i + 1) * BLOCK_Q, sq)
            p, ds = _replay_tile(qf, kf, vf, dof, lse, delta, q0, q1, k0,
                                 k1, sq, sk, causal, lens, scale)
            dv_acc = dv_acc + torch.bmm(
                p.to(do.dtype).float().transpose(1, 2), dof[:, q0:q1])
            dk_acc = dk_acc + torch.bmm(
                ds.to(q.dtype).float().transpose(1, 2), qf[:, q0:q1])
        dk[:, k0:k1] = dk_acc.to(k.dtype)
        dv[:, k0:k1] = dv_acc.to(v.dtype)
    return dk, dv


def _flash_delta(o, do):
    """Delta = rowsum(do * o) in f32, (bh, sq): computed outside the
    kernels, as the JAX package computes it in XLA."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, lens=None,
                                  causal: bool = False, scale: float = None):
    """Plain flash backward: (dq, dk, dv) of attention at q/k/v with
    output ``o``, row logsumexp ``lse`` (from the forward) and output
    cotangent ``do`` (cast to q's dtype), through
    :func:`flash_bwd_dq_reference` and :func:`flash_bwd_dkv_reference`."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype)
    delta = _flash_delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, lens, causal, scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, lens, causal,
                                     scale)
    return dq, dk, dv


def _check_device(t):
    if not (t.is_cuda or t.device.type == "cpu"):
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{t.device}")


def _flash_fwd(qf, kf, vf, lens, causal, scale):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    _check_device(qf)
    if qf.is_cuda:
        return _kernels.flash_fwd(qf, kf, vf, lens, causal, scale)
    return flash_attention_reference(qf, kf, vf, causal, scale, lens)


def _flash_bwd(qf, kf, vf, out, lse, do, lens, causal, scale):
    """The two backward kernels on a CUDA tensor, their plain versions on
    a CPU tensor; ``do`` is contiguous at q's dtype."""
    _check_device(qf)
    if not qf.is_cuda:
        return flash_attention_bwd_reference(qf, kf, vf, out, lse, do, lens,
                                             causal, scale)
    delta = _flash_delta(out, do)
    dq = _kernels.flash_bwd_dq(qf, kf, vf, do, lse, delta, lens, causal,
                               scale)
    dk, dv = _kernels.flash_bwd_dkv(qf, kf, vf, do, lse, delta, lens, causal,
                                    scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention on folded (bh, s, d) tensors with a flash backward:
    the counterpart of the JAX package's ``_flash_core`` custom VJP.

    ``apply(qf, kf, vf, lens, causal, scale)`` returns o (bh, sq, d).  The
    forward saves the residuals the JAX VJP saves (q, k, v, lens, o,
    lse); the backward computes delta = rowsum(do * o) in f32 and runs
    the dq and dk/dv kernels (their plain versions on a CPU tensor, so
    that the CPU never differentiates the plain forward with autograd).
    ``lens`` gets no gradient."""

    @staticmethod
    def forward(ctx, qf, kf, vf, lens, causal, scale):
        out, lse = _flash_fwd(qf, kf, vf, lens, causal, scale)
        ctx.save_for_backward(qf, kf, vf, lens, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, lens, out, lse = ctx.saved_tensors
        do = do.to(qf.dtype).contiguous()
        dq, dk, dv = _flash_bwd(qf, kf, vf, out, lse, do, lens, ctx.causal,
                                ctx.scale)
        return dq, dk, dv, None, None, None


def _largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap."""
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _flash_supports(causal: bool, sq: int, sk: int) -> bool:
    """Can ``flash_attention`` run this shape?  Not causal sq > sk (rows
    before the first key are fully masked), and not the causal cross
    shapes the JAX package cannot pad (no block divisor >= 8 on both
    lengths); the CUDA kernel could run the latter, but the two packages
    keep one dispatch.  Keep in sync with flash_attention's raises.

    The head dim is not tested, as in the JAX package: the CUDA kernels
    take 1 to ``_kernels.MAX_HEAD_DIM`` (256), and a wider head raises
    in their wrappers rather than leaving the card's kernels quietly."""
    if causal and sq > sk:
        return False
    if causal and sq != sk and min(_largest_divisor(sq, 256),
                                   _largest_divisor(sk, 1024)) < 8:
        return False
    return True


def flash_attention(q, k, v, causal: bool = False, scale: float = None,
                    layout: str = "bshd", kv_lengths=None):
    """Flash attention through :class:`FlashAttentionFunction`: the CUDA
    kernels on CUDA tensors, their plain versions on CPU tensors; it is
    differentiable either way.

    ``layout="bshd"``: q/k/v are (batch, seq, heads, head_dim) and are
    transposed to (batch*heads, seq, head_dim) for the kernel.
    ``layout="bhsd"``: (batch, heads, seq, head_dim); the fold is a free
    reshape.  ``kv_lengths``: optional (batch,) valid key counts, masked
    inside the kernel.  The kernel masks its own ragged tile edges, so
    any length runs without padding."""
    if layout == "bshd":
        b, sq, h, d = q.shape
        sk = k.shape[1]
    elif layout == "bhsd":
        b, h, sq, d = q.shape
        sk = k.shape[2]
    else:
        raise ValueError(f"layout must be 'bshd' or 'bhsd', got {layout!r}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if causal and sq != sk and min(_largest_divisor(sq, 256),
                                   _largest_divisor(sk, 1024)) < 8:
        raise ValueError(
            f"causal flash attention at cross lengths (sq={sq}, "
            f"sk={sk}) needs a block divisor >= 8 on both — use "
            "blockwise/naive attention")
    if causal and sq > sk:
        raise ValueError(
            f"causal flash attention needs sq <= sk (got sq={sq}, "
            f"sk={sk}): rows before the first key are fully masked — "
            "use blockwise/naive attention")
    if layout == "bshd":
        qf, kf, vf = (a.transpose(1, 2).reshape(b * h, -1, d)
                      for a in (q, k, v))
    else:
        qf, kf, vf = (a.reshape(b * h, -1, d) for a in (q, k, v))
    qf, kf, vf = qf.contiguous(), kf.contiguous(), vf.contiguous()
    lens = None
    if kv_lengths is not None:
        # per-(batch*head) lengths in the b-major fold order
        lens = _clamp_lengths(kv_lengths, sk, q.device)
        lens = lens.repeat_interleave(h).contiguous()
    out = FlashAttentionFunction.apply(qf, kf, vf, lens, causal, scale)
    out = out.reshape(b, h, sq, d)
    return out.transpose(1, 2) if layout == "bshd" else out


def attention_bhsd(q, k, v, causal: bool = False,
                   implementation: str = "auto", kv_lengths=None):
    """(b, h, s, d)-layout dispatch.  ``"auto"`` takes the CUDA kernels on
    a CUDA tensor whose lengths they run (:func:`_flash_supports`: no
    causal sq > sk, no causal cross lengths without a block divisor
    >= 8), at any head_dim up to 256, and otherwise, as on a CPU tensor,
    the plain path the JAX package takes off-TPU: blockwise, or naive
    where a length has no block divisor >= 8.  An explicit ``"flash"``
    raises on the lengths ``"auto"`` steers away from."""
    sq, sk = q.shape[2], k.shape[2]
    if implementation == "flash" or (
            implementation == "auto" and q.is_cuda
            and _flash_supports(causal, sq, sk)):
        return flash_attention(q, k, v, causal=causal, layout="bhsd",
                               kv_lengths=kv_lengths)
    bq, bk = _largest_divisor(sq, 256), _largest_divisor(sk, 1024)
    qs, ks, vs = (a.transpose(1, 2) for a in (q, k, v))
    if implementation == "blockwise" or (
            implementation == "auto" and min(bq, bk) >= 8):
        out = blockwise_attention(qs, ks, vs, causal=causal, block_k=bk,
                                  kv_lengths=kv_lengths)
    elif implementation in ("auto", "naive"):
        out = naive_attention(qs, ks, vs, causal=causal,
                              kv_lengths=kv_lengths)
    else:
        raise ValueError(f"Unknown implementation {implementation!r}")
    return out.transpose(1, 2)


def attention(q, k, v, causal: bool = False, implementation: str = "auto",
              kv_lengths=None):
    """(b, s, h, d)-layout dispatch: the CUDA kernels on a CUDA tensor
    whose lengths they run (as :func:`attention_bhsd`), blockwise
    otherwise and on a CPU tensor; lengths with no usable block divisor
    take naive (as does the causal cross-length shape flash cannot run).
    An explicit ``"flash"`` raises where ``"auto"`` steers away."""
    sq, sk = q.shape[1], k.shape[1]
    if implementation == "auto":
        if q.is_cuda and _flash_supports(causal, sq, sk):
            return flash_attention(q, k, v, causal=causal,
                                   kv_lengths=kv_lengths)
        bq, bk = _largest_divisor(sq, 256), _largest_divisor(sk, 1024)
        if min(bq, bk) < 8:
            return naive_attention(q, k, v, causal=causal,
                                   kv_lengths=kv_lengths)
        return blockwise_attention(q, k, v, causal=causal, block_k=bk,
                                   kv_lengths=kv_lengths)
    if implementation == "flash":
        return flash_attention(q, k, v, causal=causal,
                               kv_lengths=kv_lengths)
    if implementation == "blockwise":
        return blockwise_attention(q, k, v, causal=causal,
                                   kv_lengths=kv_lengths)
    if implementation == "naive":
        return naive_attention(q, k, v, causal=causal,
                               kv_lengths=kv_lengths)
    raise ValueError(f"Unknown implementation {implementation!r}")
