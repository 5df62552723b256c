"""TransformerLM: the decoder-only language model of the zoo.

Counterpart of ``analytics_zoo_tpu/models/textgeneration.py``.  The
model is a graph of the Keras layers, wired as the JAX package's
``build_model`` wires them (so ``to_graph``, ``get_layer`` and
``freeze_up_to`` work as there).  The layers that hold parameters carry
the JAX layers' names (``tok_embed``, ``pos_embed``, ``ln_attn_{i}``,
``attn_{i}``, ``ln_mlp_{i}``, ``mlp_up_{i}``, ``mlp_down_{i}`` or
``moe_{i}``, ``ln_final``, ``lm_head``) and their parameters the JAX
shapes, so weights move between the packages by name
(``models/jax_params.py``); they are also the model's own submodules
under those names, which the decode path reads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..common.context import resolve_device
from ..core.graph import GraphModule, Input
from ..core.module import name_scope
from ..pipeline.api.keras.layers import (
    Activation, Dense, Dropout, Embedding, LayerNorm, Merge,
    MultiHeadSelfAttention, PositionalEmbedding, SwitchMoE)
from .common import ZooModel


class TransformerLM(ZooModel):
    """Decoder-only transformer language model: pre-norm blocks of causal
    multi-head self-attention and a gelu MLP, with sum residuals, a final
    LayerNorm and a log-softmax head.

    ``forward(ids)`` maps (batch, seq) token ids to (batch, seq,
    vocab_size) log-probabilities.  Parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``"cuda"``
    unless asked otherwise).  It trains as a :class:`KerasNet`:
    ``compile(optimizer, loss="class_nll")`` then ``fit(x, y)`` with
    next-token int targets (batch, seq); dropout is active in ``fit`` only,
    not in ``evaluate``, ``predict`` or ``generate``.

    ``moe_every=k`` makes the MLP of every k-th block (``(i + 1) % k ==
    0``) a pre-norm :class:`SwitchMoE` named ``moe_{i}`` (``n_experts``
    experts of width ``d_ff``, ``capacity_factor``, no residual of its
    own): its load-balancing loss joins the training loss, and
    ``generate`` and the decode engine run it drop-free.

    ``remat=True`` flags the attention, MoE and MLP sublayers: in
    training their internals are recomputed in the backward pass
    (``core.module.remat_call``), so each block keeps only its region
    boundaries; under the flash kernel the forward kernel runs again in
    the backward."""

    graph_based = True

    def __init__(self, vocab_size=None, seq_len=128, n_layers=2,
                 d_model=128, n_heads=4, d_ff=None, max_len=None,
                 dropout=0.0, implementation="auto", moe_every=None,
                 n_experts=8, capacity_factor=1.25, remat=False, name=None,
                 device=None, seed: int = 0):
        super().__init__(
            name=name, vocab_size=vocab_size, seq_len=seq_len,
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            d_ff=d_ff or 4 * d_model, max_len=max_len or seq_len,
            dropout=dropout, implementation=implementation,
            moe_every=moe_every, n_experts=n_experts,
            capacity_factor=capacity_factor, remat=remat)
        h = self.hyper
        g = torch.Generator(resolve_device(device)).manual_seed(seed)
        add = self.add_module
        # explicit widths, so every layer builds here from g: the order
        # and shapes of these draws fix the parameters a seed gives
        # (pinned by tests/test_torch_repairs.py)
        x_shape = (h["seq_len"], d_model)
        add("tok_embed", Embedding(h["vocab_size"], d_model,
                                   name="tok_embed", generator=g))
        add("pos_embed", PositionalEmbedding(
            h["max_len"], input_shape=x_shape, name="pos_embed",
            generator=g))
        for i in range(n_layers):
            add(f"ln_attn_{i}", LayerNorm(input_shape=x_shape,
                                          name=f"ln_attn_{i}", generator=g))
            add(f"attn_{i}", MultiHeadSelfAttention(
                n_heads, causal=True, implementation=implementation,
                input_shape=x_shape, name=f"attn_{i}", generator=g))
            add(f"ln_mlp_{i}", LayerNorm(input_shape=x_shape,
                                         name=f"ln_mlp_{i}", generator=g))
            if self.is_moe_block(i):
                add(f"moe_{i}", SwitchMoE(
                    n_experts, hidden_dim=h["d_ff"],
                    capacity_factor=capacity_factor, residual=False,
                    input_shape=x_shape, name=f"moe_{i}", generator=g))
                continue
            add(f"mlp_up_{i}", Dense(h["d_ff"], activation="gelu",
                                     input_dim=d_model, name=f"mlp_up_{i}",
                                     generator=g))
            add(f"mlp_down_{i}", Dense(d_model, input_dim=h["d_ff"],
                                       name=f"mlp_down_{i}", generator=g))
        add("ln_final", LayerNorm(input_shape=x_shape, name="ln_final",
                                  generator=g))
        add("lm_head", Dense(h["vocab_size"], input_dim=d_model,
                             name="lm_head", generator=g))
        for i in range(n_layers):
            for sub in ("attn", "moe", "mlp_up", "mlp_down"):
                layer = getattr(self, f"{sub}_{i}", None)
                if layer is not None:
                    layer.remat = bool(remat)
        self._device = g.device
        self.rewire(seed)

    def rewire(self, seed: int = 0) -> None:
        """(Re)build the graph over the layers this model holds now
        (after one was swapped for another model's, as a speculative
        draft shares its target's embeddings and head)."""
        with name_scope(type(self).__name__.lower()):
            graph = self._wire(seed)
        # kept out of the module tree, so that the layers stay this
        # model's submodules under their own names
        self.__dict__["_graph"] = graph

    def _wire(self, seed: int) -> GraphModule:
        """The JAX package's ``build_model`` graph over this model's
        layers: pre-norm blocks, Dropout after each sublayer when
        ``dropout`` > 0, sum residuals, the final LayerNorm and the
        log-softmax head.  Only its Dropout, Merge and Activation layers
        are new (built here from ``seed``, after every parameter was
        drawn)."""
        h = self.hyper
        tokens = Input(shape=(h["seq_len"],), name="tokens")
        x = self.pos_embed(self.tok_embed(tokens))
        for i in range(h["n_layers"]):
            a = getattr(self, f"attn_{i}")(getattr(self, f"ln_attn_{i}")(x))
            if h["dropout"]:
                a = self._own(Dropout(h["dropout"]))(a)
            x = self._own(Merge(mode="sum"))([x, a])
            f = getattr(self, f"ln_mlp_{i}")(x)
            if self.is_moe_block(i):
                f = getattr(self, f"moe_{i}")(f)
            else:
                f = getattr(self, f"mlp_down_{i}")(
                    getattr(self, f"mlp_up_{i}")(f))
            if h["dropout"]:
                f = self._own(Dropout(h["dropout"]))(f)
            x = self._own(Merge(mode="sum"))([x, f])
        x = self.ln_final(x)
        out = self._own(Activation("log_softmax"))(self.lm_head(x))
        graph = GraphModule(tokens, out, name="transformer_lm")
        graph.build(None, torch.Generator(self._device).manual_seed(seed))
        return graph

    def _own(self, layer):
        """Register a layer of the wiring as a submodule (so ``train``,
        ``eval`` and ``to`` reach it) under its own name."""
        self.add_module(layer.name.replace("/", "__"), layer)
        return layer

    @property
    def device(self) -> torch.device:
        return self.lm_head.W.device

    def to_graph(self) -> GraphModule:
        return self._graph

    def is_moe_block(self, i: int) -> bool:
        k = self.hyper["moe_every"]
        return bool(k) and (i + 1) % k == 0

    def forward(self, ids):
        return self._graph(ids)

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 num_beams: int = 1, prompt_lengths=None) -> np.ndarray:
        """Autoregressive continuation from a KV cache: greedy
        (``temperature=0``) or temperature/top-k/top-p sampling; ragged
        right-padded prompts decode from their own ``prompt_lengths``.
        See :func:`analytics_zoo_tpu_torch.models.generation.generate`."""
        from .generation import generate
        return generate(self, prompt_ids, max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        seed=seed, num_beams=num_beams,
                        prompt_lengths=prompt_lengths)
