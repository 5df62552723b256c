"""Attention layers: MultiHeadSelfAttention and PositionalEmbedding.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
attention.py``.  q/k/v are projected straight into (batch, heads, seq,
head_dim) with ``einsum("bse,ehd->bhsd")``, so the flash kernel's
(batch*heads, seq, head_dim) fold is a free reshape.
"""

from __future__ import annotations

from typing import Optional

import torch

from .....core.module import Layer, make_generator, register_layer
from .....ops.attention import attention_bhsd


@register_layer
class MultiHeadSelfAttention(Layer):
    """Multi-head self-attention over (batch, seq, d_model) inputs.

    ``Wq``/``Wk``/``Wv`` are (d_model, heads, head_dim) and ``Wo`` is
    (heads, head_dim, d_model).  ``implementation``: ``"auto"`` (the CUDA
    kernel on a CUDA tensor, the JAX package's off-TPU choice on a CPU
    tensor), ``"flash"``, ``"blockwise"`` or ``"naive"``.  Pass
    ``[x, lengths]`` to mask keys past each row's (batch,) length."""

    def __init__(self, d_model: int, n_heads: int, head_dim=None,
                 causal: bool = True, implementation: str = "auto",
                 init="glorot_uniform", name: Optional[str] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        if implementation == "ring":
            raise NotImplementedError(
                "ring attention is not ported yet (see ROADMAP.md)")
        self.n_heads = int(n_heads)
        self.head_dim = None if head_dim is None else int(head_dim)
        hd = self.head_dim or d_model // self.n_heads
        if hd * self.n_heads != d_model and self.head_dim is None:
            raise ValueError(
                f"d_model ({d_model}) not divisible by n_heads "
                f"({self.n_heads}); pass head_dim explicitly")
        self.causal = bool(causal)
        self.implementation = implementation
        g = make_generator(device, generator)
        for w in ("Wq", "Wk", "Wv"):
            self.add_param(w, init, (d_model, self.n_heads, hd), g)
        self.add_param("Wo", init, (self.n_heads, hd, d_model), g)

    def forward(self, inputs):
        lengths = None
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != 2:
                raise ValueError(
                    "MultiHeadSelfAttention takes either one input "
                    "(batch, seq, d_model) or two ([x, lengths]); got "
                    f"{len(inputs)} inputs")
            inputs, lengths = inputs
            lengths = torch.as_tensor(lengths, device=inputs.device)
            if lengths.dim() == 2 and lengths.shape[-1] == 1:
                lengths = lengths[:, 0]  # accept (batch, 1) columns
        q = torch.einsum("bse,ehd->bhsd", inputs, self.Wq)
        k = torch.einsum("bse,ehd->bhsd", inputs, self.Wk)
        v = torch.einsum("bse,ehd->bhsd", inputs, self.Wv)
        o = attention_bhsd(q, k, v, causal=self.causal,
                           implementation=self.implementation,
                           kv_lengths=lengths)
        return torch.einsum("bhsd,hde->bse", o, self.Wo)


@register_layer
class PositionalEmbedding(Layer):
    """Learned positional table added to a (batch, seq, d_model) input:
    ``y = x + table[:seq]``; ``max_len`` bounds the table."""

    def __init__(self, max_len: int, d_model: int, init="uniform",
                 name: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.max_len = int(max_len)
        table = self.add_param("table", init, (self.max_len, int(d_model)),
                               make_generator(device, generator))
        if init == "uniform":
            with torch.no_grad():
                table.mul_(0.02)

    def forward(self, x):
        s = x.shape[-2]
        if s > self.max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_len {self.max_len}")
        return x + self.table[:s].to(x.dtype)
