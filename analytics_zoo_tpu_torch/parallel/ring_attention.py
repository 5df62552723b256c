"""Ring attention: sequence parallelism over the ``seq`` mesh axis.

Counterpart of ``analytics_zoo_tpu/parallel/ring_attention.py``.  The
sequence axis of q/k/v is split over the ranks of the axis; each rank
accumulates online-softmax attention of its q block against the k/v
block it holds, then passes k/v on around the ring (``ppermute``).
After ``n`` steps every q block has seen every k/v block, with peak
memory O(seq/n) a rank.  Causality uses global positions: rank ``s``
holds positions [s·L, (s+1)·L), so blocks wholly in the future add
nothing.  Each held block is walked in ``block_k`` sub-blocks, so a
step's score tile is (seq/n, block_k) rather than (seq/n)².

As in the JAX package this is plain tensor code (the JAX package's is
plain XLA): einsums and elementwise ops, no kernel of its own.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ._compat import all_gather, axis_index, axis_size, axis_slice, ppermute


def _local_attention_accumulate(q, k_blk, v_blk, q_offset, k_offset,
                                causal, scale, carry, kv_lengths=None):
    """One ring step: online-softmax statistics of the local q against
    one k/v block.  ``kv_lengths``: optional (batch,) GLOBAL valid key
    counts; key positions at or past them are masked."""
    m_prev, l_prev, o_prev = carry
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k_blk)
    sq, sk = q.shape[1], k_blk.shape[1]
    k_pos = k_offset + torch.arange(sk, device=q.device)
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask[None, None], scores, -1e30)
    if kv_lengths is not None:
        kmask = k_pos[None, :] < kv_lengths[:, None]  # (b, sk)
        scores = torch.where(kmask[:, None, None, :], scores, -1e30)
    m_blk = torch.amax(scores, dim=-1)
    m_new = torch.maximum(m_prev, m_blk)
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + torch.sum(p, dim=-1)
    o_new = (o_prev * corr[..., None]
             + torch.einsum("bhqk,bkhd->bhqd", p, v_blk))
    return m_new, l_new, o_new


def ring_attention(q, k, v, axis_name: str = "seq", causal: bool = False,
                   scale: Optional[float] = None, kv_lengths=None,
                   block_k: int = 1024, mesh=None):
    """Ring attention over this rank's LOCAL blocks: q/k/v (batch,
    seq_local, heads, head_dim), block ``i`` of the sequence on the rank
    at index ``i`` of ``axis_name`` (the JAX function's body under
    ``shard_map``).  ``kv_lengths``: optional (batch,) GLOBAL valid key
    counts, the same on every rank (each at least 1).  Returns this
    rank's (batch, seq_local, heads, head_dim) block of the output."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n = axis_size(axis_name, mesh)
    my_idx = axis_index(axis_name, mesh)
    q_offset = my_idx * sq
    shard = k.shape[1]
    from ..ops.attention import _largest_divisor
    block_k = _largest_divisor(shard, min(block_k, shard))
    if block_k < 8:
        # a prime-ish shard: keep the whole-shard product
        block_k = shard
    n_sub = shard // block_k
    perm = [(i, (i + 1) % n) for i in range(n)]
    f32 = dict(dtype=torch.float32, device=q.device)
    stats = (torch.full((b, h, sq), -1e30, **f32),
             torch.zeros((b, h, sq), **f32),
             torch.zeros((b, h, sq, d), **f32))
    k_cur, v_cur = k, v
    for i in range(n):
        # the block held at step i started at ((my_idx - i) mod n)·L
        base = ((my_idx - i) % n) * shard
        for j in range(n_sub):
            sl = slice(j * block_k, (j + 1) * block_k)
            stats = _local_attention_accumulate(
                q, k_cur[:, sl], v_cur[:, sl], q_offset,
                base + j * block_k, causal, scale, stats,
                kv_lengths=kv_lengths)
        if i < n - 1:  # the JAX loop's last rotation is unused
            k_cur = ppermute(k_cur, axis_name, perm, mesh=mesh)
            v_cur = ppermute(v_cur, axis_name, perm, mesh=mesh)
    _, l, o = stats
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "seq",
                           causal: bool = False, kv_lengths=None):
    """Ring attention of GLOBAL q/k/v (batch, seq, heads, head_dim),
    which every rank of ``axis_name`` passes whole (a replicated value):
    each rank takes its sequence block, the ring runs, and the blocks of
    the output are gathered, so every rank returns the whole (batch,
    seq, heads, head_dim) output, as the JAX function returns its global
    array.  ``kv_lengths``: optional (batch,) GLOBAL valid key counts.
    Gradients reach q/k/v whole on every rank."""
    from ..ops.attention import _clamp_lengths
    lens = None
    if kv_lengths is not None:
        lens = _clamp_lengths(kv_lengths, k.shape[1], device=q.device)
    n = axis_size(axis_name, mesh)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} is not divisible "
                         f"by the {axis_name!r} axis size ({n})")
    ql, kl, vl = (axis_slice(t, axis_name, dim=1, mesh=mesh)
                  for t in (q, k, v))
    out = ring_attention(ql, kl, vl, axis_name=axis_name, causal=causal,
                         kv_lengths=lens, mesh=mesh)
    return all_gather(out, axis_name, dim=1, mesh=mesh)
