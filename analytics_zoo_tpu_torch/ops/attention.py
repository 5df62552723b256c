"""Attention ops: naive, blockwise (online softmax) and flash attention.

Counterpart of ``analytics_zoo_tpu/ops/attention.py``.  The three
implementations share one semantics:

* ``naive_attention``: O(S^2) materialised scores; the test oracle.
* ``blockwise_attention``: a loop over key blocks with an online softmax.
* ``flash_attention``: the hand-written CUDA kernel
  (``csrc/flash_fwd.cu``) on a CUDA tensor; on a CPU tensor its plain
  version, :func:`flash_attention_reference`, which runs the kernel's
  tile algorithm in torch (the role Pallas ``interpret=True`` plays for
  the JAX package).

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
#: the CUDA kernel's query and key tiles (csrc/flash_fwd.cu BQ, BK)
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
        o = (o * correction[..., None]
             + torch.einsum("bhqk,bkhd->bhqd", p, v_blk))
        m = m_new
    out = o / l[..., None].clamp_min(1e-30)
    return out.transpose(1, 2)  # (b, h, q, d) -> (b, q, h, d)


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: float = None, lens=None):
    """Plain version of the CUDA flash-forward kernel: the same tile
    algorithm in torch.

    q (bh, sq, d), k/v (bh, sk, d) at f32 or bf16; ``lens`` (bh,) f32
    valid key counts in [1, sk] or None.  For each 64-row query tile it
    walks 64-key tiles with an online softmax (running max, denominator
    and f32 accumulator), skipping key tiles past the causal diagonal and
    past ceil(len / 64); p is rounded to the input dtype before the p*v
    product.  Returns (o (bh, sq, d) at the input dtype, lse (bh, sq)
    f32 = m + log(l)).  A tile that a row's causal or length mask covers
    wholly changes nothing for that row (p underflows to 0 and the
    correction is 1), so the skip count may be shared across rows."""
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


def _flash_fwd(qf, kf, vf, lens, causal, scale):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if qf.is_cuda:
        return _kernels.flash_fwd(qf, kf, vf, lens, causal, scale)
    if qf.device.type == "cpu":
        return flash_attention_reference(qf, kf, vf, causal, scale, lens)
    raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                     f"{qf.device}")


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
    keep one dispatch.  Keep in sync with flash_attention's raises."""
    if causal and sq > sk:
        return False
    if causal and sq != sk and min(_largest_divisor(sq, 256),
                                   _largest_divisor(sk, 1024)) < 8:
        return False
    return True


def flash_attention(q, k, v, causal: bool = False, scale: float = None,
                    layout: str = "bshd", kv_lengths=None):
    """Flash attention: the CUDA kernel on CUDA tensors, its plain version
    on CPU tensors.

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
    out, _ = _flash_fwd(qf, kf, vf, lens, causal, scale)
    out = out.reshape(b, h, sq, d)
    return out.transpose(1, 2) if layout == "bshd" else out


def attention_bhsd(q, k, v, causal: bool = False,
                   implementation: str = "auto", kv_lengths=None):
    """(b, h, s, d)-layout dispatch.  ``"auto"`` takes the CUDA kernel on a
    CUDA tensor, and on a CPU tensor the plain path the JAX package takes
    off-TPU: blockwise, or naive where a length has no block divisor
    >= 8."""
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
    """(b, s, h, d)-layout dispatch: the CUDA kernel on a CUDA tensor,
    blockwise on a CPU tensor; lengths with no usable block divisor take
    naive (as does the causal cross-length shape flash cannot run)."""
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
