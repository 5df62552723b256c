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
MLP, final LayerNorm and lm_head) and reads the parameters by layer name.
Beam search, the k-query ``_decode_window`` and the prefix-conditioned
``_prefill_ext`` are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.attention import attention_bhsd
from ..pipeline.api.keras.activations import gelu
from ..pipeline.api.keras.layers.normalization import layer_norm


def _layer_norm(ln, x, eps=1e-5):
    return layer_norm(x, ln.gamma, ln.beta, eps)


def _mlp(model, i, f):
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
    stream differs from ``jax.random``'s).  ``num_beams > 1`` is not
    ported yet and raises after the JAX package's validation.

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
        raise NotImplementedError(
            "beam search is not ported yet (see ROADMAP.md)")
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
