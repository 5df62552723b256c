"""Attention layers: MultiHeadSelfAttention and PositionalEmbedding.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
attention.py``.  q/k/v are projected straight into (batch, heads, seq,
head_dim) with ``einsum("bse,ehd->bhsd")``, so the flash kernel's
(batch*heads, seq, head_dim) fold is a free reshape.  The products
promote mixed dtypes as ``jnp`` does.

``implementation="ring"`` runs ring attention
(``parallel/ring_attention.py``) on the active mesh's ``seq`` axis, as
the JAX layer does.  Under a tensor-parallel plan whose rules split
``Wq``/``Wk``/``Wv`` on their head axis and ``Wo`` on its head axis, the
sharded trainer hands the layer its head blocks and sets
``_tensor_split`` to the mesh: the kernels then run on the local heads
and the output projection's partial sums are added over ``tensor``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .....core.module import Layer, promote, register_layer
from .....ops.attention import attention_bhsd
from .....parallel._compat import psum, pvary


def _x_shape(input_shape):
    """The x shape of a one-input or ``[x, lengths]`` input shape."""
    if (isinstance(input_shape, (list, tuple)) and input_shape
            and isinstance(input_shape[0], (list, tuple))):
        return tuple(input_shape[0])
    return tuple(input_shape)


@register_layer
class MultiHeadSelfAttention(Layer):
    """Multi-head self-attention over (batch, seq, d_model) inputs;
    d_model is the last axis of the input shape.

    ``Wq``/``Wk``/``Wv`` are (d_model, heads, head_dim) and ``Wo`` is
    (heads, head_dim, d_model), ``head_dim`` defaulting to d_model //
    n_heads.  ``implementation``: ``"auto"`` (the CUDA kernel on a CUDA
    tensor, the JAX package's off-TPU choice on a CPU tensor),
    ``"flash"``, ``"blockwise"`` or ``"naive"``.  Pass ``[x, lengths]``
    to mask keys past each row's (batch,) length."""

    #: the mesh while the sharded trainer runs this layer on its
    #: tensor-axis head blocks (``parallel/placement.py``), else None
    _tensor_split = None

    def __init__(self, n_heads, head_dim=None, causal=True,
                 implementation="auto", init="glorot_uniform",
                 input_shape=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.n_heads = int(n_heads)
        self.head_dim = None if head_dim is None else int(head_dim)
        self.causal = bool(causal)
        self.implementation = implementation
        self.init_name = init
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        d_model = int(_x_shape(input_shape)[-1])
        hd = self.head_dim or d_model // self.n_heads
        if hd * self.n_heads != d_model and self.head_dim is None:
            raise ValueError(
                f"d_model ({d_model}) not divisible by n_heads "
                f"({self.n_heads}); pass head_dim explicitly")
        for w in ("Wq", "Wk", "Wv"):
            self.add_param(w, self.init_name, (d_model, self.n_heads, hd),
                           generator)
        self.add_param("Wo", self.init_name, (self.n_heads, hd, d_model),
                       generator)

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
        split = self._tensor_split
        if split is not None:
            inputs = pvary(inputs, "tensor", mesh=split)
        x, wq, wk, wv = promote(inputs, self.Wq, self.Wk, self.Wv)
        if self.implementation == "ring":
            out = self._ring(x, wq, wk, wv, lengths)
        else:
            q = torch.einsum("bse,ehd->bhsd", x, wq)
            k = torch.einsum("bse,ehd->bhsd", x, wk)
            v = torch.einsum("bse,ehd->bhsd", x, wv)
            o = attention_bhsd(q, k, v, causal=self.causal,
                               implementation=self.implementation,
                               kv_lengths=lengths)
            out = torch.einsum("bhsd,hde->bse", *promote(o, self.Wo))
        if split is not None:
            out = psum(out, "tensor", mesh=split)
        return out

    def _ring(self, x, wq, wk, wv, lengths):
        """Sequence parallelism on the active mesh's ``seq`` axis, the
        q/k/v projected straight into the ring's (b, s, h, d)."""
        from .....parallel.mesh import axis_sizes, get_active_mesh
        from .....parallel.ring_attention import ring_attention_sharded
        mesh = get_active_mesh()
        if mesh is None or "seq" not in (
                getattr(mesh, "mesh_dim_names", None) or ()):
            raise ValueError(
                "implementation='ring' needs the active mesh to "
                "carry a 'seq' axis (create_mesh({'seq': n, ...}))")
        seq_size = axis_sizes(mesh)["seq"]
        if x.shape[-2] % seq_size:
            raise ValueError(
                f"sequence length {x.shape[-2]} is not divisible by the "
                f"mesh's seq axis ({seq_size})")
        q = torch.einsum("bse,ehd->bshd", x, wq)
        k = torch.einsum("bse,ehd->bshd", x, wk)
        v = torch.einsum("bse,ehd->bshd", x, wv)
        o = ring_attention_sharded(q, k, v, mesh, causal=self.causal,
                                   kv_lengths=lengths)
        return torch.einsum("bshd,hde->bse", *promote(o, self.Wo))

    def compute_output_shape(self, input_shape):
        return _x_shape(input_shape)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(n_heads=self.n_heads, head_dim=self.head_dim,
                   causal=self.causal, implementation=self.implementation,
                   init=self.init_name)
        return cfg


@register_layer
class PositionalEmbedding(Layer):
    """Learned positional table added to a (batch, seq, d_model) input:
    ``y = x + table[:seq]``; ``max_len`` bounds the table, d_model is the
    last axis of the input shape."""

    def __init__(self, max_len, init="uniform", input_shape=None, name=None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.max_len = int(max_len)
        self.init_name = init
        self._build_if_ready()

    def build_params(self, input_shape, generator):
        table = self.add_param("table", self.init_name,
                               (self.max_len, int(input_shape[-1])),
                               generator)
        if self.init_name == "uniform":
            with torch.no_grad():
                table.mul_(0.02)

    def forward(self, x):
        s = x.shape[-2]
        if s > self.max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_len {self.max_len}")
        return x + self.table[:s].to(x.dtype)

    def get_config(self):
        cfg = super().get_config()
        cfg.update(max_len=self.max_len, init=self.init_name)
        return cfg
