"""Symbolic graph: ``Variable`` nodes and ``GraphModule`` evaluation.

Counterpart of ``analytics_zoo_tpu/core/graph.py``, the engine behind the
Keras functional API (``Model(input, output)`` over layer calls).  A
``Variable`` is a symbolic node: a layer applied to other Variables, with
its inferred batch shape.  A ``GraphModule`` is an ``nn.Module`` that
holds each distinct layer instance once (in first-use order) and runs
the nodes in topological order, so a layer called at several nodes
shares its weights; autograd differentiates through the whole graph.

The autograd DSL's operators on Variables (``x + y``, ``x[...]``, ...)
need the port of the autograd layers and raise until then.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from . import shapes as shape_utils
from .module import Layer, Symbolic, fresh_name, register_layer

_NODE_IDS = itertools.count()


def _not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "arithmetic and slicing on graph Variables need the autograd "
        "layers, which are not ported yet (see ROADMAP.md)")


class Variable(Symbolic):
    """A symbolic tensor: the output of a layer applied to other
    Variables (or a graph input, whose layer is an ``InputLayer``)."""

    def __init__(self, layer: Layer, inputs: Sequence["Variable"], shape,
                 name=None):
        self.layer = layer
        self.inputs: Tuple["Variable", ...] = tuple(inputs)
        self.shape = tuple(shape)
        self.node_id = next(_NODE_IDS)
        self.name = name or (layer.name if layer is not None
                             else fresh_name("input"))

    @staticmethod
    def from_layer(layer: Layer, x) -> "Variable":
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        in_shape = [v.shape for v in xs] if len(xs) > 1 else xs[0].shape
        return Variable(layer, xs, layer.compute_output_shape(in_shape))

    def ancestors(self) -> List["Variable"]:
        """All nodes reachable from self, in topological order."""
        order, seen = [], set()

        def visit(v):
            if v.node_id in seen:
                return
            seen.add(v.node_id)
            for p in v.inputs:
                visit(p)
            order.append(v)

        visit(self)
        return order

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = \
        __truediv__ = __rtruediv__ = __neg__ = __pow__ = __getitem__ = \
        slice = index_select = squeeze = _not_ported

    def __repr__(self):
        return f"Variable({self.name}, shape={self.shape})"


@register_layer
class InputLayer(Layer):
    """Placeholder layer marking a graph input."""

    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)

    def forward(self, x):
        return x


def Input(shape, name=None) -> Variable:
    """A graph input Variable with per-sample ``shape``."""
    layer = InputLayer(input_shape=shape, name=name)
    return Variable(layer, (), shape_utils.to_batch_shape(shape),
                    name=layer.name)


class GraphModule(Layer):
    """A Layer evaluating a Variable graph from ``inputs`` to ``outputs``.

    ``layers`` holds one entry per distinct layer instance, in first-use
    order: weight sharing is calling one instance at several nodes."""

    def __init__(self, inputs, outputs, name=None):
        super().__init__(name=name)
        self.input_vars: List[Variable] = (
            list(inputs) if isinstance(inputs, (list, tuple)) else [inputs])
        self.output_vars: List[Variable] = (
            list(outputs) if isinstance(outputs, (list, tuple)) else [outputs])
        self.single_output = not isinstance(outputs, (list, tuple))
        seen = set()
        self.nodes: List[Variable] = []
        for out in self.output_vars:
            for v in out.ancestors():
                if v.node_id not in seen:
                    seen.add(v.node_id)
                    self.nodes.append(v)
        input_ids = {v.node_id for v in self.input_vars}
        for v in self.nodes:
            if isinstance(v.layer, InputLayer) and v.node_id not in input_ids:
                raise ValueError(
                    f"Graph input {v.name} is not among the model's inputs "
                    f"{[iv.name for iv in self.input_vars]}")
        layers, ids = [], set()
        for v in self.nodes:
            if not isinstance(v.layer, InputLayer) and id(v.layer) not in ids:
                ids.add(id(v.layer))
                layers.append(v.layer)
        self.layers = nn.ModuleList(layers)

    def first_use_shapes(self) -> Dict[int, object]:
        """Each layer's input shape at its first node, by ``id``."""
        shaped = {}
        for v in self.nodes:
            if v.inputs and id(v.layer) not in shaped:
                shaped[id(v.layer)] = ([p.shape for p in v.inputs]
                                       if len(v.inputs) > 1
                                       else v.inputs[0].shape)
        return shaped

    def build(self, input_shape, generator: torch.Generator) -> None:
        """Build every layer not built yet from the shape of its first
        use, in first-use order, from one ``generator``."""
        shaped = self.first_use_shapes()
        for layer in self.layers:
            layer.build(shaped[id(layer)], generator)
        self.built = True

    def forward(self, inputs):
        xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        if len(xs) != len(self.input_vars):
            raise ValueError(f"{self.name}: expected {len(self.input_vars)} "
                             f"inputs, got {len(xs)}")
        values = {v.node_id: x for v, x in zip(self.input_vars, xs)}
        for v in self.nodes:
            if v.node_id in values:
                continue
            ins = ([values[p.node_id] for p in v.inputs]
                   if len(v.inputs) > 1 else values[v.inputs[0].node_id])
            values[v.node_id] = v.layer(ins)
        outs = [values[v.node_id] for v in self.output_vars]
        return outs[0] if self.single_output else outs

    def compute_output_shape(self, input_shape):
        if self.single_output:
            return self.output_vars[0].shape
        return [v.shape for v in self.output_vars]

    @property
    def input_shapes(self):
        return [v.shape for v in self.input_vars]

    @property
    def output_shapes(self):
        return [v.shape for v in self.output_vars]
