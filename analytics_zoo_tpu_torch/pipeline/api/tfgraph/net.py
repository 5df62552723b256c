"""TFNet: a frozen TF graph as a port layer, and ``export_tf``.

Counterpart of ``analytics_zoo_tpu/pipeline/api/tfgraph/net.py``.  The
graph is converted once (:mod:`.converter`), so a forward is torch ops
and gradients flow through it.  Loading an export folder or a ``.pb``
parses the GraphDef with the port's own codec (:mod:`.proto`): no
``tensorflow`` is needed to load or run one.  ``export_tf`` and
``TFNet.from_session`` take a live ``tf.Session`` and need TF.

The folder format is the JAX package's (and the reference's):
``frozen_inference_graph.pb`` and ``graph_meta.json``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ....core.module import make_generator, register_layer
from .._convert_util import require_module
from ..onnx.onnx_loader import GraphParams
from .converter import ConvertedGraph, graph_def_of
from .proto import parse_graph_def

_FROZEN_PB = "frozen_inference_graph.pb"
_META = "graph_meta.json"


def _tensor_names(ts):
    return [t.name if hasattr(t, "name") else str(t) for t in ts]


def export_tf(sess, folder: str, inputs: Sequence, outputs: Sequence):
    """Freeze ``sess``'s graph to constants and write the pb and the meta
    (reference ``export_tf``).  Needs tensorflow."""
    tf = require_module("tensorflow", "export_tf")
    input_names, output_names = _tensor_names(inputs), _tensor_names(outputs)
    out_ops = [n.split(":")[0] for n in output_names]
    frozen = tf.compat.v1.graph_util.convert_variables_to_constants(
        sess, sess.graph.as_graph_def(), out_ops)
    frozen = tf.compat.v1.graph_util.extract_sub_graph(frozen, out_ops)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, _FROZEN_PB), "wb") as f:
        f.write(frozen.SerializeToString())
    write_meta(folder, input_names, output_names)
    return folder


def write_meta(folder: str, input_names, output_names):
    """The folder's ``graph_meta.json``, as the JAX package writes it."""
    with open(os.path.join(folder, _META), "w") as f:
        json.dump({"input_names": list(input_names),
                   "output_names": list(output_names),
                   "temp_tensors": [], "variables": [],
                   "grad_variables": [], "grad_inputs": []}, f)


@register_layer
class TFNet(GraphParams):
    """A TF graph as a layer of the port, on ``device`` (``"cuda"``
    unless asked otherwise): from an export folder (pb and
    ``graph_meta.json``), a raw ``.pb`` with explicit input and output
    names, a GraphDef (the port's codec's or TF's), or live from a
    session.  Variables the graph still holds are the layer's trainable
    parameters; random nodes draw from the layer's generator."""

    def __init__(self, path: Optional[str] = None,
                 input_names: Optional[Sequence[str]] = None,
                 output_names: Optional[Sequence[str]] = None,
                 graph_def=None,
                 initial_params: Optional[dict] = None,
                 name: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name=name, generator=generator)
        if graph_def is None:
            graph_def, input_names, output_names = _load_graph(
                path, input_names, output_names)
        self._graph_path = path
        self.fn = ConvertedGraph(graph_def_of(graph_def), list(input_names),
                                 list(output_names))
        initial = dict(initial_params or {})
        missing = [v for v in self.fn.variable_names if v not in initial]
        if missing:
            raise ValueError(
                f"graph has variables with no values: {missing}; freeze "
                "the graph (export_tf / from_session) or pass "
                "initial_params")
        gen = make_generator(device, generator)
        self._device = gen.device
        self._set_params(initial, gen.device)
        self.build(None, gen)

    @classmethod
    def from_session(cls, sess, inputs: Sequence, outputs: Sequence,
                     freeze: bool = True, device=None) -> "TFNet":
        """Convert the session's graph; by default its variables are
        frozen into constants (reference ``TFNet.fromSession``); with
        ``freeze=False`` their values become trainable parameters.  Needs
        tensorflow."""
        tf = require_module("tensorflow", "TFNet.from_session")
        input_names, output_names = (_tensor_names(inputs),
                                     _tensor_names(outputs))
        gd = sess.graph.as_graph_def()
        if freeze:
            out_ops = [n.split(":")[0] for n in output_names]
            gd = tf.compat.v1.graph_util.convert_variables_to_constants(
                sess, gd, out_ops)
            return cls(graph_def=gd, input_names=input_names,
                       output_names=output_names, device=device)
        gd = graph_def_of(gd)
        fn = ConvertedGraph(gd, input_names, output_names)
        var_ops = {v.op.name: v for v in sess.graph.get_collection(
            tf.compat.v1.GraphKeys.GLOBAL_VARIABLES)}
        values = {}
        with sess.graph.as_default():
            for vname in fn.variable_names:
                if vname not in var_ops:
                    raise ValueError(f"no live variable for node {vname!r}")
                values[vname] = np.asarray(sess.run(var_ops[vname].value()))
        return cls(graph_def=gd, input_names=input_names,
                   output_names=output_names, initial_params=values,
                   device=device)

    def forward(self, inputs):
        xs = inputs if isinstance(inputs, (tuple, list)) else (inputs,)
        outs = self.fn(self.params(), *xs, rng=self.generator,
                       training=self.training, device=self.device)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape[0], (tuple, list)) \
            else [input_shape]
        with torch.no_grad():
            dummies = [torch.zeros((2,) + tuple(s[1:]), device="meta")
                       for s in shapes]
            params = {k: torch.empty(tuple(v.shape), device="meta")
                      for k, v in self.params().items()}
            out = self.fn(params, *dummies, device="meta")
        outs = [(None,) + tuple(o.shape[1:]) for o in out]
        return outs[0] if len(outs) == 1 else outs

    def predict(self, x, batch_per_thread: int = 32):
        """Forward ``x`` (numpy, or a list of arrays for several inputs)
        in batches, in eval mode; numpy out (a list for several
        outputs)."""
        return self._predict_batches(x, batch_per_thread)


def _load_graph(path, input_names, output_names):
    if os.path.isdir(path):
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        input_names = meta["input_names"]
        output_names = meta["output_names"]
        pb = os.path.join(path, _FROZEN_PB)
    else:
        pb = path
        if input_names is None or output_names is None:
            raise ValueError(
                "loading a bare .pb requires input_names and output_names")
    with open(pb, "rb") as f:
        return parse_graph_def(f.read()), input_names, output_names
