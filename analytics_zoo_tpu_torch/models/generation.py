"""Autoregressive decoding with a preallocated KV cache.

Counterpart of ``analytics_zoo_tpu/models/generation.py``.  ``generate``
prefills the prompt in one batched causal forward (the flash kernel on a
CUDA device), then decodes token by token against per-layer K/V caches.
The JAX package runs the steps as one compiled ``lax.scan`` over a
functional cache; here the steps are a Python loop, and the caches are
allocated once at (batch, heads, prompt + max_new, head_dim) and written
in place.  The loop keeps every token on the device and reads nothing
back to the host until the end.

The decode math mirrors ``TransformerLM.forward`` (pre-norm blocks, gelu
MLP or Switch-MoE, final LayerNorm and lm_head) and reads the parameters
by layer name; MoE blocks run drop-free, as the JAX package decodes.
Beyond ``generate`` it holds what the serving engine
(``pipeline/inference/decode.py``) steps with: the k-query
``_decode_window`` (speculative verify) and the prefix-conditioned
``_prefill_ext`` (prefix-KV pool admission).  Beam search
(``build_beam_fn``, ``_backtrack_beams``) rides the batch dimension, one
row per beam, and gathers the surviving beams' caches on the device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.attention import attention_bhsd
from ..parallel.expert import switch_moe
from ..pipeline.api.keras.activations import gelu
from ..pipeline.api.keras.layers.normalization import layer_norm


def _layer_norm(ln, x, eps=1e-5):
    return layer_norm(x, ln.gamma, ln.beta, eps)


def _mlp(model, i, f):
    if model.is_moe_block(i):
        # drop-free (capacity = the token count), as the JAX package
        # decodes: a step's few tokens must never lose their FFN output
        flat = f.reshape(-1, f.shape[-1])
        out, _ = switch_moe(flat, getattr(model, f"moe_{i}").moe_params(),
                            capacity=flat.shape[0])
        return out.reshape(f.shape)
    up = getattr(model, f"mlp_up_{i}")
    down = getattr(model, f"mlp_down_{i}")
    return gelu(f @ up.W + up.b) @ down.W + down.b


def _head_logits(model, hidden):
    """Final LN + lm_head over a (b, d) hidden state."""
    x = _layer_norm(model.ln_final, hidden)
    return x @ model.lm_head.W + model.lm_head.b


def _embed_token(model, tok, pos):
    """Token + positional embedding for one decode step (tok: (rows,)
    ids; pos: an int shared position, or (rows,) per-row positions for
    ragged prompts)."""
    emb = model.tok_embed.embeddings[tok.long()]
    p = model.pos_embed.table[pos]
    return emb + p.to(emb.dtype)


def _prefill(model, prompt, cache_len):
    """Batched causal pass over the whole prompt.  Writes each layer's K/V
    into positions [0, s_p) of a (b, heads, cache_len, d) cache allocated
    here, and returns (hidden states (b, s_p, d_model), caches)."""
    s_p = prompt.shape[1]
    x = model.tok_embed.embeddings[prompt.long()]
    x = x + model.pos_embed.table[:s_p].to(x.dtype)
    caches = []
    for i in range(model.hyper["n_layers"]):
        attn = getattr(model, f"attn_{i}")
        a = _layer_norm(getattr(model, f"ln_attn_{i}"), x)
        q = torch.einsum("bse,ehd->bhsd", a, attn.Wq)
        k = torch.einsum("bse,ehd->bhsd", a, attn.Wk)
        v = torch.einsum("bse,ehd->bhsd", a, attn.Wv)
        o = attention_bhsd(q, k, v, causal=True)
        x = x + torch.einsum("bhsd,hde->bse", o, attn.Wo)
        f = _layer_norm(getattr(model, f"ln_mlp_{i}"), x)
        x = x + _mlp(model, i, f)
        b, h, _, d = k.shape
        ck = k.new_zeros((b, h, cache_len, d))
        cv = v.new_zeros((b, h, cache_len, d))
        ck[:, :, :s_p] = k
        cv[:, :, :s_p] = v
        caches.append((ck, cv))
    return x, caches


def _cache_write(c, x_new, pos):
    """Write one step's (b, h, d) k or v into the (b, h, t, d) cache ``c``
    IN PLACE at ``pos``: an int shared position, or (b,) per-row
    positions for ragged prompts."""
    if isinstance(pos, int):
        c[:, :, pos] = x_new
    else:
        c[torch.arange(c.shape[0], device=c.device), :, pos] = x_new


def _decode_step(model, caches, x_tok, pos):
    """One cached decode step: ``x_tok`` is the (b, d_model) embedding of
    the current token, ``pos`` its position (int, or (b,) per row).
    Updates the caches in place and returns the (b, vocab) logits."""
    x = x_tok
    for i in range(model.hyper["n_layers"]):
        attn = getattr(model, f"attn_{i}")
        ck, cv = caches[i]
        a = _layer_norm(getattr(model, f"ln_attn_{i}"), x)
        q = torch.einsum("be,ehd->bhd", a, attn.Wq)
        k = torch.einsum("be,ehd->bhd", a, attn.Wk)
        v = torch.einsum("be,ehd->bhd", a, attn.Wv)
        _cache_write(ck, k, pos)
        _cache_write(cv, v, pos)
        d = q.shape[-1]
        scores = torch.einsum("bhd,bhtd->bht", q, ck) / math.sqrt(d)
        t_pos = torch.arange(ck.shape[2], device=ck.device)[None, None, :]
        valid = (t_pos <= pos if isinstance(pos, int)
                 else t_pos <= pos[:, None, None])
        scores = torch.where(valid, scores, -1e30)
        probs = torch.softmax(scores.float(), dim=-1)
        o = torch.einsum("bht,bhtd->bhd", probs.to(cv.dtype), cv)
        x = x + torch.einsum("bhd,hde->be", o, attn.Wo)
        f = _layer_norm(getattr(model, f"ln_mlp_{i}"), x)
        x = x + _mlp(model, i, f)
    return _head_logits(model, x)


def _decode_window(model, caches, x_toks, pos):
    """k-query cached decode, the speculative-verify compute.

    ``x_toks`` is (b, k, d_model): the embeddings of k consecutive tokens
    per row, at positions ``pos + j`` (``pos``: (b,)).  Each token's K/V
    is written IN PLACE at its own clamped position ``min(pos + j, t - 1)``
    (one write per entry, never a block write, whose clamp would shift
    early entries onto live cache lines), then the k queries attend in
    one batched einsum under a per-query causal mask.  Returns the
    (b, k, vocab) logits.

    The k-query products have other shapes than :func:`_decode_step`'s,
    so the logits agree with k single steps to rounding, not bit for bit:
    the engine takes each window's first token from the exact single-query
    step and uses this pass only to certify draft proposals."""
    k = x_toks.shape[1]
    t = caches[0][0].shape[2]
    dev = x_toks.device
    qpos = (pos[:, None] + torch.arange(k, device=dev)[None, :]).clamp(
        max=t - 1)
    valid = (torch.arange(t, device=dev)[None, None, None, :]
             <= qpos[:, None, :, None])
    x = x_toks
    for i in range(model.hyper["n_layers"]):
        attn = getattr(model, f"attn_{i}")
        ck, cv = caches[i]
        a = _layer_norm(getattr(model, f"ln_attn_{i}"), x)
        q = torch.einsum("bke,ehd->bhkd", a, attn.Wq)
        kk = torch.einsum("bke,ehd->bhkd", a, attn.Wk)
        vv = torch.einsum("bke,ehd->bhkd", a, attn.Wv)
        for j in range(k):
            _cache_write(ck, kk[:, :, j], qpos[:, j])
            _cache_write(cv, vv[:, :, j], qpos[:, j])
        d = q.shape[-1]
        scores = torch.einsum("bhkd,bhtd->bhkt", q, ck) / math.sqrt(d)
        scores = torch.where(valid, scores, -1e30)
        probs = torch.softmax(scores.float(), dim=-1)
        o = torch.einsum("bhkt,bhtd->bhkd", probs.to(cv.dtype), cv)
        x = x + torch.einsum("bhkd,hde->bke", o, attn.Wo)
        f = _layer_norm(getattr(model, f"ln_mlp_{i}"), x)
        x = x + _mlp(model, i, f)
    b = x.shape[0]
    return _head_logits(model, x.reshape(b * k, -1)).reshape(b, k, -1)


def _prefill_ext(model, tail, prefix_kv, p_len: int):
    """Prefix-conditioned tail prefill, the prefix-KV pool's admission
    compute.  ``tail`` is (1, s_t) ids at positions ``[p_len, p_len +
    s_t)``; ``prefix_kv`` the per-layer (k, v) blocks of the first
    ``p_len`` positions, each (1, heads, p_len, d_head).  The tail queries
    attend causally over prefix + tail in one batched forward, with its
    own einsum attention (as the JAX package's).  Returns (tail hidden
    states (1, s_t, d_model), per-layer tail (k, v) blocks)."""
    s_t = tail.shape[1]
    x = model.tok_embed.embeddings[tail.long()]
    x = x + model.pos_embed.table[p_len:p_len + s_t].to(x.dtype)
    ar = torch.arange(s_t, device=tail.device)
    causal = ar[None, None, :, None] >= ar[None, None, None, :]
    tail_caches = []
    for i in range(model.hyper["n_layers"]):
        attn = getattr(model, f"attn_{i}")
        pk, pv = prefix_kv[i]
        a = _layer_norm(getattr(model, f"ln_attn_{i}"), x)
        q = torch.einsum("bse,ehd->bhsd", a, attn.Wq)
        k = torch.einsum("bse,ehd->bhsd", a, attn.Wk)
        v = torch.einsum("bse,ehd->bhsd", a, attn.Wv)
        d = q.shape[-1]
        sp = torch.einsum("bhsd,bhtd->bhst", q, pk) / math.sqrt(d)
        st = torch.einsum("bhsd,bhtd->bhst", q, k) / math.sqrt(d)
        st = torch.where(causal, st, -1e30)
        probs = torch.softmax(torch.cat([sp, st], dim=-1).float(), dim=-1)
        vall = torch.cat([pv, v], dim=2)
        o = torch.einsum("bhst,bhtd->bhsd", probs.to(vall.dtype), vall)
        x = x + torch.einsum("bhsd,hde->bse", o, attn.Wo)
        f = _layer_norm(getattr(model, f"ln_mlp_{i}"), x)
        x = x + _mlp(model, i, f)
        tail_caches.append((k, v))
    return x, tail_caches


def _top_k(x, k: int):
    """The k largest entries of the last axis, descending, ties in index
    order (as ``lax.top_k``): (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def build_beam_fn(s_p: int, max_new: int, beam_width: int):
    """One beam-search plan: ``run(model, prompt)`` with ``prompt`` a
    (b, s_p) id tensor on the model's device returns (tok0 (b, W), toks
    (max_new - 1, b, W), parents (max_new - 1, b, W), scores (b, W)) for
    :func:`_backtrack_beams`.  Deterministic; beams ride the batch
    dimension (row b*W + w), so every step is one batched decode step,
    and each step's surviving beams gather their parents' KV caches on
    the device."""
    cache_len = s_p + max_new
    W = beam_width

    def run(model, prompt):
        b = prompt.shape[0]
        x, caches = _prefill(model, prompt, cache_len)
        logp0 = torch.log_softmax(
            _head_logits(model, x[:, -1, :]).float(), dim=-1)
        cum, tok0 = _top_k(logp0, W)  # (b, W)
        caches = [(ck.repeat_interleave(W, 0), cv.repeat_interleave(W, 0))
                  for ck, cv in caches]
        brow = torch.arange(b, device=prompt.device)[:, None]
        tok, toks, parents = tok0, [], []
        for i in range(max_new - 1):
            pos = s_p + i
            logits = _decode_step(model, caches, _embed_token(
                model, tok.reshape(b * W), pos), pos)
            logp = torch.log_softmax(logits.float(), dim=-1)
            V = logp.shape[-1]
            total = cum[:, :, None] + logp.reshape(b, W, V)
            cum, idx = _top_k(total.reshape(b, W * V), W)
            parent = idx // V  # (b, W) the surviving beams' ancestors
            tok = idx % V
            caches = [tuple(c.reshape(b, W, *c.shape[1:])[brow, parent]
                            .reshape(b * W, *c.shape[1:]) for c in kv)
                      for kv in caches]
            toks.append(tok)
            parents.append(parent)
        empty = tok0.new_zeros((0, b, W))
        return (tok0, torch.stack(toks) if toks else empty,
                torch.stack(parents) if parents else empty, cum)

    return run


def _backtrack_beams(tok0, toks, parents, scores):
    """Reassemble (b, W, max_new) sequences from per-step (token, parent)
    records, walking each final beam's ancestry backwards; returns
    (seqs int32, scores) as numpy."""
    tok0, toks, parents, scores = (
        a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        for a in (tok0, toks, parents, scores))
    steps, b, W = toks.shape
    seqs = np.zeros((b, W, steps + 1), np.int32)
    rows = np.arange(b)[:, None]
    beam = np.tile(np.arange(W), (b, 1))  # final beams, in score order
    for t in range(steps - 1, -1, -1):
        seqs[:, :, t + 1] = toks[t][rows, beam]
        beam = parents[t][rows, beam]
    seqs[:, :, 0] = tok0[rows, beam]
    return seqs, scores


def _sample(logits, temperature: float, top_k: Optional[int] = None,
            top_p: Optional[float] = None,
            generator: Optional[torch.Generator] = None, uniforms=None):
    """Greedy when ``temperature == 0``, else temperature softmax with
    optional top-k and/or top-p (nucleus) truncation.

    One descending sort (stable, so ties keep index order, as
    ``lax.top_k`` does), both thresholds off the sorted values, and an
    inverse-CDF draw from one uniform per row: ``uniforms`` (shape
    ``logits.shape[:-1]``) when given, else drawn from ``generator``."""
    if float(temperature) == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / max(float(temperature), 1e-6)
    V = scaled.shape[-1]
    srt, src = torch.sort(scaled, dim=-1, descending=True, stable=True)
    if top_k is None:
        kth = torch.full_like(srt[..., :1], -math.inf)
    else:
        kk = min(int(top_k), V)
        kth = srt[..., kk - 1:kk]
    # unnormalized sorted probabilities (shared by top-p and the draw)
    e = torch.exp(srt - srt[..., :1])
    csum = torch.cumsum(e, dim=-1)
    if top_p is None:
        pth = torch.full_like(srt[..., :1], -math.inf)
    else:
        # keep the sorted prefix whose mass strictly before each entry is
        # < p of the total: the top token always survives
        keep = (csum - e) < float(top_p) * csum[..., -1:]
        pth = torch.where(keep, srt, math.inf).amin(dim=-1, keepdim=True)
    thr = torch.maximum(kth, pth)
    ek = torch.where(srt >= thr, e, 0.0)
    ck = torch.cumsum(ek, dim=-1)
    if uniforms is None:
        uniforms = torch.rand(logits.shape[:-1], generator=generator,
                              device=logits.device)
    u = torch.as_tensor(uniforms, dtype=torch.float32,
                        device=logits.device)[..., None] * ck[..., -1:]
    pick = (ck <= u).sum(dim=-1)
    # u can round up to ck[-1]: clamp to the kept prefix so a truncated
    # token is never drawn
    kept = (ek > 0.0).sum(dim=-1)
    pick = torch.minimum(pick, (kept - 1).clamp_min(0))
    return torch.gather(src, -1, pick[..., None])[..., 0]


def generate(model, prompt_ids, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, seed: int = 0,
             num_beams: int = 1, prompt_lengths=None) -> np.ndarray:
    """Generate continuations for a batch of equal-length prompts.

    Args mirror the JAX package's ``generate``: ``prompt_ids`` (batch,
    prompt_len) ids with prompt_len + max_new_tokens <= ``max_len``;
    ``temperature`` 0 is greedy; ``top_k``/``top_p`` truncate before
    sampling; ``prompt_lengths`` (batch,) are the true lengths of
    right-padded prompts, each row decoding from its own last real token.
    Sampling draws from a ``torch.Generator`` seeded with ``seed`` (its
    stream differs from ``jax.random``'s).  ``num_beams > 1`` runs
    deterministic beam search (:func:`build_beam_fn`) and returns each
    row's highest cumulative log-prob beam.

    Returns (batch, prompt_len + max_new_tokens) int32 ids: the prompt,
    then the continuation (for ragged prompts at [lengths[b],
    lengths[b] + max_new_tokens), zeros after it)."""
    prompt = np.asarray(prompt_ids)
    if prompt.ndim != 2:
        raise ValueError(f"prompt_ids must be (batch, prompt_len), got "
                         f"shape {prompt.shape}")
    h = model.hyper
    s_p = int(prompt.shape[1])
    max_new = int(max_new_tokens)
    total = s_p + max_new
    if total > h["max_len"]:
        raise ValueError(
            f"prompt ({s_p}) + max_new_tokens ({max_new_tokens}) = "
            f"{total} exceeds max_len ({h['max_len']})")
    if prompt_lengths is not None:
        lengths = np.asarray(prompt_lengths)
        if lengths.shape != (prompt.shape[0],):
            raise ValueError(
                f"prompt_lengths must be ({prompt.shape[0]},), got "
                f"shape {lengths.shape}")
        if (lengths < 1).any() or (lengths > s_p).any():
            raise ValueError(
                f"prompt_lengths must lie in [1, {s_p}]")
        if num_beams > 1:
            raise ValueError(
                "prompt_lengths is not supported with beam search — "
                "pad prompts to equal length for num_beams > 1")
    if num_beams <= 1 and max_new == 0:
        return prompt.astype(np.int32)
    if num_beams > 1:
        if temperature != 0.0 or top_k is not None or top_p is not None:
            raise ValueError(
                "beam search (num_beams > 1) is deterministic — "
                "temperature/top_k/top_p do not apply")
        if max_new_tokens < 1:
            raise ValueError("beam search needs max_new_tokens >= 1")
        if num_beams > h["vocab_size"]:
            raise ValueError(f"num_beams ({num_beams}) exceeds "
                             f"vocab_size ({h['vocab_size']})")
        run = build_beam_fn(s_p, max_new, int(num_beams))
        with torch.no_grad():
            seqs, _ = _backtrack_beams(*run(model, torch.as_tensor(
                prompt, dtype=torch.long, device=model.device)))
        # beams come out in descending cumulative log-prob order, all of
        # one length, so the first is the answer
        return np.concatenate([prompt.astype(np.int32), seqs[:, 0]], axis=1)
    dev = model.device
    b = prompt.shape[0]
    with torch.no_grad():
        prompt_t = torch.as_tensor(prompt, dtype=torch.long, device=dev)
        x, caches = _prefill(model, prompt_t, total)
        if prompt_lengths is None:
            lengths_t = None
            last_hidden = x[:, -1, :]
        else:
            lengths_t = torch.as_tensor(lengths, dtype=torch.long,
                                        device=dev)
            last_hidden = x[torch.arange(b, device=dev), lengths_t - 1]
        gen = (None if float(temperature) == 0.0
               else torch.Generator(dev).manual_seed(seed))
        sample = lambda lg: _sample(lg, temperature, top_k, top_p,
                                    generator=gen)
        tok = sample(_head_logits(model, last_hidden))
        toks = torch.empty((b, max_new), dtype=torch.long, device=dev)
        for i in range(max_new):
            toks[:, i] = tok
            if i == max_new - 1:
                break  # the last token needs no further step
            pos = s_p + i if lengths_t is None else lengths_t + i
            logits = _decode_step(model, caches,
                                  _embed_token(model, tok, pos), pos)
            tok = sample(logits)
        toks = toks.cpu().numpy().astype(np.int32)
    if prompt_lengths is None:
        return np.concatenate([prompt.astype(np.int32), toks], axis=1)
    out = np.zeros((b, total), np.int32)
    out[:, :s_p] = prompt
    rows = np.arange(b)[:, None]
    cols = lengths[:, None] + np.arange(max_new)[None]
    out[rows, cols] = toks
    # anything past each row's continuation is not real content
    out[np.arange(total)[None] >= cols[:, -1:] + 1] = 0
    return out
