"""SwitchMoE: a switch-routed mixture-of-experts FFN as a Keras layer.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/moe.py``:
the functional block of ``parallel/expert.py`` (:func:`switch_moe`,
experts replicated) with capacity ``expert_capacity(tokens, n_experts,
capacity_factor)`` for the tokens of each call, so under
``accum_steps`` it follows each microbatch's token count.  When the
active mesh (the one ``compile(mesh=...)`` hands the trainer) has an
``expert`` axis of size > 1 that divides the expert and token counts,
the layer runs expert-parallel (:func:`moe_sharded`); an expert axis it
cannot use is recorded in :data:`EXPERT_FALLBACKS` with the reason, and
the layer runs replicated.  Input (batch, seq, d_model) or (batch, d_model); the output has
its shape, with the input added when ``residual`` (so dropped tokens
pass through unchanged).

The load-balancing loss ``aux_weight * E * sum(f * p)`` reaches the
training loss as the JAX package's ``aux_loss`` state key does there:
the forward adds it to the penalty collector the trainer opens around
the differentiated forward and around each evaluation batch
(``regularizers.add_penalty``).  In training mode the layer also keeps
its last value in the state buffer ``aux_loss``, as the JAX package's
layer state holds it.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
from torch import nn

from .....core.module import Layer, register_layer
from .....parallel.expert import (MoEParams, expert_capacity,
                                  init_moe_params, moe_sharded, switch_moe)
from ..regularizers import add_penalty

#: layer name -> reason, for every SwitchMoE that ran replicated although
#: the active mesh has an expert axis (a silent cost otherwise); the
#: strategy report shows it, ``clear_fallback_log`` resets it
EXPERT_FALLBACKS: dict = {}
_log = logging.getLogger("analytics_zoo_tpu_torch.moe")


def clear_fallback_log():
    EXPERT_FALLBACKS.clear()


def _note_fallback(name: str, reason: str):
    if name not in EXPERT_FALLBACKS:
        _log.warning("SwitchMoE %s: expert mesh axis present but not "
                     "usable (%s): running replicated, every rank "
                     "computes every expert", name, reason)
    EXPERT_FALLBACKS[name] = reason


@register_layer
class SwitchMoE(Layer):
    """Switch-routed MoE FFN: ``y = x + MoE(x)`` (``MoE(x)`` alone when
    ``residual=False``); ``hidden_dim`` defaults to ``4 * d_model``."""

    stateful = True

    def __init__(self, n_experts: int = 8, hidden_dim: int = None,
                 capacity_factor: float = 1.25, aux_weight: float = 0.01,
                 residual: bool = True, input_shape=None, name=None,
                 trainable=True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, device=device,
                         generator=generator)
        self.n_experts = int(n_experts)
        self.hidden_dim = hidden_dim
        self.capacity_factor = float(capacity_factor)
        self.aux_weight = float(aux_weight)
        self.residual = bool(residual)
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        d = int(input_shape[-1])
        p = init_moe_params(generator, d, self.hidden_dim or 4 * d,
                            self.n_experts)
        for key, value in p._asdict().items():
            self.register_parameter(key, nn.Parameter(value))
        self.add_state("aux_loss", torch.zeros((), device=generator.device))

    def moe_params(self) -> MoEParams:
        return MoEParams(*(getattr(self, k) for k in MoEParams._fields))

    def forward(self, x):
        from .....parallel.mesh import axis_sizes, get_active_mesh
        flat = x.reshape(-1, x.shape[-1])
        mesh = get_active_mesh()
        esize = axis_sizes(mesh).get("expert", 1)
        if esize > 1 and self.n_experts % esize == 0 \
                and flat.shape[0] % esize == 0:
            out, aux = moe_sharded(flat, self.moe_params(), mesh,
                                   capacity_factor=self.capacity_factor)
        else:
            if esize > 1:
                _note_fallback(
                    self.name,
                    f"expert count {self.n_experts} is not divisible by "
                    f"the axis size {esize}" if self.n_experts % esize
                    else f"token count {flat.shape[0]} is not divisible "
                    f"by the axis size {esize}")
            cap = expert_capacity(flat.shape[0], self.n_experts,
                                  self.capacity_factor)
            out, aux = switch_moe(flat, self.moe_params(), capacity=cap)
        aux = self.aux_weight * aux
        add_penalty(aux)
        if self.training:
            with torch.no_grad():
                self.aux_loss.copy_(aux)
        y = out.reshape(x.shape)
        return x + y if self.residual else y

    def get_config(self):
        cfg = super().get_config()
        cfg.update(n_experts=self.n_experts, hidden_dim=self.hidden_dim,
                   capacity_factor=self.capacity_factor,
                   aux_weight=self.aux_weight, residual=self.residual)
        return cfg
