"""Symbolic graph: ``Variable`` nodes and ``GraphModule`` evaluation.

Counterpart of ``analytics_zoo_tpu/core/graph.py``, the engine behind the
Keras functional API (``Model(input, output)`` over layer calls).  A
``Variable`` is a symbolic node: a layer applied to other Variables, with
its inferred batch shape.  A ``GraphModule`` is an ``nn.Module`` that
holds each distinct layer instance once (in first-use order) and runs
the nodes in topological order, so a layer called at several nodes
shares its weights; autograd differentiates through the whole graph.

The same engine backs the autograd DSL (``pipeline/api/autograd.py``):
a Variable's operators (``x + y``, ``x[...]``, ``x.slice(...)``, ...)
add ``ops/elementwise.py``'s op nodes, and a ``Parameter`` or a constant
is a source node, a layer with no inputs (``is_source``).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from . import shapes as shape_utils
from .module import Layer, Symbolic, fresh_name, register_layer

_NODE_IDS = itertools.count()


def broadcast_shapes(a, b):
    """Numpy-style broadcast of two batch shapes where ``None`` is
    unknown."""
    la, lb = len(a), len(b)
    n = max(la, lb)
    a = (1,) * (n - la) + tuple(a)
    b = (1,) * (n - lb) + tuple(b)
    out = []
    for da, db in zip(a, b):
        if da is None or db is None:
            out.append(None if (da in (1, None) and db in (1, None)) else
                       (da if da not in (1, None) else db))
        elif da == 1:
            out.append(db)
        elif db == 1 or da == db:
            out.append(da)
        else:
            raise ValueError(f"Cannot broadcast shapes {a} and {b}")
    return tuple(out)


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

    # -- operators: op nodes of ops/elementwise.py (imported at call
    # time: it imports this module) --
    def __add__(self, other):
        from ..ops import elementwise as E
        return E.add(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        from ..ops import elementwise as E
        return E.sub(self, other)

    def __rsub__(self, other):
        from ..ops import elementwise as E
        return E.sub(other, self)

    def __mul__(self, other):
        from ..ops import elementwise as E
        return E.mul(self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        from ..ops import elementwise as E
        return E.div(self, other)

    def __rtruediv__(self, other):
        from ..ops import elementwise as E
        return E.div(other, self)

    def __neg__(self):
        from ..ops import elementwise as E
        return E.neg(self)

    def __pow__(self, p):
        from ..ops import elementwise as E
        return E.pow(self, p)

    def __getitem__(self, item):
        from ..ops import elementwise as E
        return E.getitem(self, item)

    # the reference's Variable.slice / indexSelect / squeeze
    def slice(self, dim, start_index, length):
        from ..ops import elementwise as E
        return E.slice(self, dim, start_index, length)

    def index_select(self, dim, index):
        from ..ops import elementwise as E
        return E.index_select(self, dim, index)

    def squeeze(self, dim):
        from ..ops import elementwise as E
        return E.squeeze(self, dim)

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
            if not v.inputs and v.node_id not in input_ids and not (
                    isinstance(v.layer, InputLayer)
                    or getattr(v.layer, "is_source", False)):
                raise ValueError(
                    f"Graph node {v.name} has no inputs and is not a graph "
                    "input / Parameter / constant")
        layers, ids = [], set()
        for v in self.nodes:
            if not isinstance(v.layer, InputLayer) and id(v.layer) not in ids:
                ids.add(id(v.layer))
                layers.append(v.layer)
        self.layers = nn.ModuleList(layers)

    def first_use_shapes(self) -> Dict[int, object]:
        """Each layer's input shape at its first node, by ``id`` (None
        for a source node's layer)."""
        shaped = {}
        for v in self.nodes:
            if isinstance(v.layer, InputLayer) or id(v.layer) in shaped:
                continue
            shaped[id(v.layer)] = ([p.shape for p in v.inputs]
                                   if len(v.inputs) > 1 else
                                   v.inputs[0].shape if v.inputs else None)
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
            if not v.inputs:  # a source: Parameter or constant
                values[v.node_id] = v.layer()
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
