"""Layer: the port's module base, with naming, the layer registry and
deferred building.

Counterpart of ``analytics_zoo_tpu/core/module.py``.  There a layer is a
pure ``init``/``apply`` pair over a params dict keyed by parameter name;
here it is an ``nn.Module`` whose parameters carry those same names
(``W``, ``b``, ``embeddings``, ``gamma``, ...) and shapes, so
:meth:`Layer.params` is the JAX package's params dict for the layer.  A
stateful layer's state (BatchNormalization's moving statistics) is its
buffers, :meth:`Layer.state`, keyed as the JAX package's ``init_state``.

A layer's parameter widths come from its input shape, as in the
reference.  :meth:`Layer.build` creates them from a shape and a
``torch.Generator`` (on the generator's device).  A model builds its
layers (``Sequential.add``, ``Model(input, output)``) from one generator
seeded with the model's ``seed``.  A layer given ``device=`` or
``generator=`` builds at construction when its parameter shapes are known
then (an explicit ``input_shape``/``input_dim``, or none needed); else it
waits for its model.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from ..common.context import resolve_device
from . import initializers
from . import shapes as shape_utils

_LAYER_REGISTRY: Dict[str, type] = {}
_NAME_COUNTERS: "collections.Counter" = collections.Counter()
_SCOPE_STACK: list = []


def register_layer(cls):
    """Class decorator: register a layer class for config-based
    (de)serialization under ``serial_name`` or its class name."""
    _LAYER_REGISTRY[getattr(cls, "serial_name", None) or cls.__name__] = cls
    return cls


def serial_class_name(layer) -> str:
    """Registry key a layer instance serializes under."""
    return getattr(layer, "serial_name", None) or type(layer).__name__


def get_layer_class(name: str) -> type:
    if name not in _LAYER_REGISTRY:
        raise KeyError(
            f"Unknown layer class {name!r}; known: {sorted(_LAYER_REGISTRY)}")
    return _LAYER_REGISTRY[name]


def fresh_name(prefix: str) -> str:
    """``<prefix>_<k>`` from a per-prefix counter: the process-wide one, or
    inside :func:`name_scope` the scope's own (``<scope>/<prefix>_<k>``)."""
    if _SCOPE_STACK:
        scope, counter = _SCOPE_STACK[-1]
        counter[prefix] += 1
        return f"{scope}/{prefix}_{counter[prefix]}"
    _NAME_COUNTERS[prefix] += 1
    return f"{prefix}_{_NAME_COUNTERS[prefix]}"


@contextlib.contextmanager
def name_scope(scope: str):
    """Deterministic layer naming: inside the scope, auto-names restart
    from a scope-local counter (``<scope>/<type>_<k>``), so rebuilding the
    same architecture yields the same layer names in any process (and the
    JAX package's ``name_scope`` the same names as this one)."""
    _SCOPE_STACK.append((scope, collections.Counter()))
    try:
        yield
    finally:
        _SCOPE_STACK.pop()


def promote(*tensors):
    """The tensors at their common dtype, as ``jnp`` promotes the
    operands of a product (bf16 with f32 gives f32).  ``torch.matmul``,
    ``einsum`` and the convolutions refuse mixed dtypes instead, and
    under mixed precision an f32 activation (blockwise attention's
    output) meets bf16 weights."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t if t.dtype == dtype else t.to(dtype) for t in tensors)


def make_generator(device=None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Generator:
    """The generator a layer draws its init from: ``generator`` when
    given, else a fresh one seeded with 0 on the resolved ``device``
    (``"cuda"`` unless asked otherwise)."""
    if generator is not None:
        if device is not None and torch.device(device).type != \
                generator.device.type:
            raise ValueError(f"generator on {generator.device} but device "
                             f"{device!r} requested")
        return generator
    return torch.Generator(resolve_device(device)).manual_seed(0)


class Symbolic:
    """Marker base of graph nodes (``core.graph.Variable``): calling a
    layer on one adds a node instead of running the layer."""


class Layer(nn.Module):
    """Base class of the port's layers.

    Subclasses create their parameters in ``build_params(input_shape,
    generator)`` with :meth:`add_param`, compute in ``forward`` and infer
    shapes in ``compute_output_shape``; a subclass's ``__init__`` ends
    with ``self._build_if_ready()``.  Calling a layer on a graph
    ``Variable`` adds a graph node (the functional API); on tensors it
    runs ``forward``."""

    #: override when the class name collides with another registered layer
    serial_name: Optional[str] = None
    #: False where the parameter shapes need no input shape (Embedding)
    needs_input_shape: bool = True
    #: True on layers that carry non-trainable state (BatchNormalization)
    stateful: bool = False

    def __init__(self, input_shape=None, name: Optional[str] = None,
                 trainable: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.name = name or fresh_name(type(self).__name__.lower())
        self.batch_input_shape = (shape_utils.to_batch_shape(input_shape)
                                  if input_shape else None)
        self._trainable = bool(trainable)
        #: recompute this layer's internals in the backward pass instead
        #: of keeping them (``remat_call``); the JAX package's flag
        self.remat = False
        self._init_device = device
        self._init_generator = generator
        self.built = False

    def __call__(self, *args, **kwargs):
        x = args[0] if args else None
        if isinstance(x, Symbolic) or (
                isinstance(x, (list, tuple)) and x
                and all(isinstance(v, Symbolic) for v in x)):
            from .graph import Variable  # graph imports this module
            return Variable.from_layer(self, x)
        return super().__call__(*args, **kwargs)

    # ---- building ----
    def _build_if_ready(self):
        """Build now when a device or generator was given and the
        parameter shapes are known; else the model builds the layer."""
        if self._init_device is None and self._init_generator is None:
            return
        if self.batch_input_shape is None and self.needs_input_shape:
            return
        self.build(self.batch_input_shape,
                   make_generator(self._init_device, self._init_generator))

    def build(self, input_shape, generator: torch.Generator) -> None:
        """Create the parameters for ``input_shape`` (batch dim first)
        from ``generator``, on its device.  A built layer only checks that
        it lies on that device."""
        if self.built:
            check_device(self, generator.device)
            return
        self.build_params(input_shape, generator)
        self.built = True
        if not self._trainable:
            self.trainable = False

    def build_params(self, input_shape, generator: torch.Generator) -> None:
        pass

    def add_param(self, name: str, init, shape,
                  generator: torch.Generator) -> nn.Parameter:
        p = nn.Parameter(initializers.get(init)(shape, generator))
        self.register_parameter(name, p)
        return p

    def params(self) -> Dict[str, torch.Tensor]:
        """This layer's own parameters, keyed as the JAX package keys
        them."""
        return dict(self.named_parameters(recurse=False))

    def add_state(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """Register ``value`` as state: a buffer, which the layer updates
        in place in training mode, saves with its weights, and which gets
        no gradient, optimizer update or cast under ``compute_dtype``."""
        self.register_buffer(name, value)
        return value

    def state(self) -> Dict[str, torch.Tensor]:
        """This layer's own state, keyed as the JAX package's
        ``init_state`` keys it."""
        return dict(self.named_buffers(recurse=False))

    def compute_output_shape(self, input_shape):
        return input_shape

    @property
    def trainable(self) -> bool:
        return self._trainable

    @trainable.setter
    def trainable(self, flag: bool):
        """A frozen layer's parameters get no gradient and no update; the
        trainer reads the flags at every step, and its optimizer state
        keeps covering them."""
        self._trainable = bool(flag)
        for p in self.parameters():
            p.requires_grad_(self._trainable)

    # ---- serialization ----
    def get_config(self) -> dict:
        cfg = {"name": self.name}
        if self.batch_input_shape is not None:
            cfg["input_shape"] = list(self.batch_input_shape[1:])
        if not self.trainable:
            cfg["trainable"] = False
        if self.remat:
            cfg["remat"] = True  # left out when False, as in the JAX package
        return cfg

    @classmethod
    def from_config(cls, config: dict) -> "Layer":
        config = dict(config)
        trainable = config.pop("trainable", True)
        remat = config.pop("remat", False)
        layer = cls(**config)
        layer._trainable = bool(trainable)
        layer.remat = bool(remat)
        return layer


class RandomLayer(Layer):
    """Base of the layers that draw noise in training (Dropout, the noise
    layers, RReLU, GaussianSampler).  Each draws from its own
    ``torch.Generator``: the ``generator`` given at construction, else one
    seeded, when the layer is built, from the generator that builds it.
    In eval mode they draw nothing."""

    needs_input_shape = False

    def __init__(self, input_shape=None, name: Optional[str] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_shape=input_shape, name=name, device=device,
                         generator=generator)
        self.generator = generator

    def build_params(self, input_shape, generator):
        if self.generator is None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device))
            self.generator = torch.Generator(generator.device).manual_seed(
                seed)


def remat_call(layer: Layer, inputs, force: bool = False):
    """``layer(inputs)``, honouring its ``remat`` flag (or ``force``)
    in training: under ``torch.utils.checkpoint`` (non-reentrant), so
    the backward pass recomputes the layer's internals instead of
    keeping them, as the JAX package's ``remat_apply`` does with
    ``jax.checkpoint``.  The graph engine calls every node's layer
    through here, and so do the wrappers (TimeDistributed,
    Bidirectional) for their inner layers.  In eval, or without
    gradients, the layer runs as it is.

    The recompute must be the forward again: checkpointing restores the
    default CPU and CUDA generators, and here the random layers' own
    generators too (set back to their state before the forward, then
    returned to where they were), and the layer's state (BatchNorm's
    moving statistics, updated in place by the forward) is put back
    after the recompute, so that it is updated once."""
    if not ((force or layer.remat) and layer.training
            and torch.is_grad_enabled()):
        return layer(inputs)
    gens = [m.generator for m in layer.modules()
            if isinstance(m, RandomLayer) and m.generator is not None]
    before = [g.get_state() for g in gens]
    calls = []

    def run(x):
        if not calls:  # the forward
            calls.append(1)
            return layer(x)
        now = [g.get_state() for g in gens]
        kept = [b.clone() for b in layer.buffers()]
        for g, st in zip(gens, before):
            g.set_state(st)
        try:
            return layer(x)
        finally:
            for g, st in zip(gens, now):
                g.set_state(st)
            with torch.no_grad():
                for b, k in zip(layer.buffers(), kept):
                    b.copy_(k)

    return torch_checkpoint.checkpoint(run, inputs, use_reentrant=False)


def check_device(layer: nn.Module, device) -> None:
    """Raise when ``layer``'s parameters lie on another device type than
    ``device``: a model keeps all its weights on its own device."""
    want = torch.device(device).type
    for p in layer.parameters():
        if p.device.type != want:
            raise ValueError(
                f"layer {getattr(layer, 'name', layer)!r} was built on "
                f"{p.device}, but its model lives on {want}")
        return
