"""TFOptimizer / TFPredictor: train and serve user TF graphs with the
port.

Counterpart of ``analytics_zoo_tpu/pipeline/api/tfgraph/optimizer.py``
(reference ``TFOptimizer``, pyzoo/zoo/pipeline/api/net.py:326-430, and
``TFPredictor``, :523-551).  The loss graph converts to a torch function
of the dataset's slots and the graph's variables, a model under the
port's ``Trainer`` with the identity criterion (the reference's
``IdentityCriterion``); autograd replaces the exported backward graph;
after ``optimize`` the trained weights are pushed back into the live
``tf.Session``.  Both take a TF graph and session, so both need
tensorflow; the converted functions run on the port's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ....core.module import make_generator
from ....data.dataset import Dataset
from ....train import triggers as trigger_lib
from ....train.trainer import Trainer
from .._convert_util import require_module
from ..keras import optimizers as keras_optimizers
from ..onnx.onnx_loader import GraphParams
from .converter import ConvertedGraph, graph_def_of
from .dataset import TFDataset, find_dataset


def _find_placeholder_names(tensors) -> List[str]:
    """The placeholders feeding ``tensors``, by walking the graph."""
    seen, out, stack = set(), [], [t.op for t in tensors]
    while stack:
        op = stack.pop()
        if op.name in seen:
            continue
        seen.add(op.name)
        if op.type == "Placeholder":
            out.append(op.name)
        stack.extend(i.op for i in op.inputs)
    return sorted(out)


def _reachable_param_values(sess, conv: ConvertedGraph) -> Dict[str, Any]:
    """Live values of every variable node the converted graph reads."""
    tf = require_module("tensorflow", "reading TF variables")
    var_ops = {}
    for coll in (tf.compat.v1.GraphKeys.GLOBAL_VARIABLES,
                 tf.compat.v1.GraphKeys.LOCAL_VARIABLES):
        for v in sess.graph.get_collection(coll):
            var_ops[v.op.name] = v
    values = {}
    with sess.graph.as_default():
        for name in conv.variable_names:
            if name not in var_ops:
                raise ValueError(
                    f"graph variable {name!r} has no live tf.Variable; "
                    "run the variable initializer first")
            values[name] = np.asarray(sess.run(var_ops[name].value()))
    return values


class _GraphModel(GraphParams):
    """A converted loss graph as a model of the ``Trainer``: the batch is
    every slot of the dataset (features and labels: the loss graph reads
    the labels through placeholders), the output the scalar loss.  The
    trainable variables are parameters, the rest buffers."""

    def __init__(self, conv: ConvertedGraph, trainable: Dict[str, Any],
                 frozen: Dict[str, Any], device=None):
        super().__init__(name="tf_graph_model")
        self.conv = conv
        gen = make_generator(device)
        self._device = gen.device
        self._set_params(trainable, gen.device)
        self._frozen_names = list(frozen)
        for i, v in enumerate(frozen.values()):
            self.register_buffer(f"f{i}", torch.as_tensor(
                np.array(v), device=gen.device))
        self.build(None, gen)

    def frozen(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, f"f{i}")
                for i, n in enumerate(self._frozen_names)}

    def all_values(self) -> Dict[str, torch.Tensor]:
        return {**self.params(), **self.frozen()}

    def forward(self, inputs):
        xs = inputs if isinstance(inputs, (tuple, list)) else (inputs,)
        outs = self.conv(self.all_values(), *xs, rng=self.generator,
                         training=self.training, device=self.device)
        return outs[0] if len(outs) == 1 else tuple(outs)


class TFOptimizer:
    """Train a user-written TF loss graph with the port's ``Trainer`` on
    ``device`` (``"cuda"`` unless asked otherwise).  Needs tensorflow."""

    def __init__(self, loss, optim_method="sgd", sess=None,
                 val_outputs: Optional[Sequence] = None,
                 val_labels: Optional[Sequence] = None,
                 val_method=None, clip_norm: Optional[float] = None,
                 clip_value=None, metrics: Sequence = (), device=None):
        tf = require_module("tensorflow", "TFOptimizer")
        self.loss = loss
        graph = loss.graph
        self._owns_session = sess is None
        if sess is None:
            sess = tf.compat.v1.Session(graph=graph)
            with graph.as_default():
                sess.run(tf.compat.v1.global_variables_initializer())
        self.sess = sess

        ph_names = _find_placeholder_names([loss])
        self.dataset, _ = find_dataset(graph, ph_names)
        input_names = [ph.name for ph in self.dataset.tensors]
        gd = graph_def_of(graph.as_graph_def())
        self._conv = ConvertedGraph(gd, input_names, [loss.name])
        values = _reachable_param_values(sess, self._conv)
        trainable_ops = {v.op.name: v for v in graph.get_collection(
            tf.compat.v1.GraphKeys.TRAINABLE_VARIABLES)}
        self._trainable_vars = {n: v for n, v in trainable_ops.items()
                                if n in values}
        trainable = {n: values[n] for n in self._trainable_vars}
        frozen = {n: v for n, v in values.items()
                  if n not in self._trainable_vars}
        self._model = _GraphModel(self._conv, trainable, frozen, device)

        optimizer = keras_optimizers.get(optim_method, clip_norm=clip_norm,
                                         clip_value=clip_value)
        self.trainer = Trainer(self._model, loss_fn=lambda y, yp: yp,
                               optimizer=optimizer)

        # the validation graph: outputs and labels through the metrics
        self._val = None
        if val_outputs is not None and val_labels is not None:
            methods = val_method if isinstance(val_method, (list, tuple)) \
                else [val_method] if val_method is not None else []
            vconv = ConvertedGraph(
                gd, input_names,
                [t.name for t in val_outputs] + [t.name for t in val_labels])
            self._val = (vconv, len(val_outputs), list(methods) or
                         list(metrics))

    # -- reference API ---------------------------------------------------
    def set_train_summary(self, summary):
        self.trainer.train_summary = summary

    def set_val_summary(self, summary):
        self.trainer.val_summary = summary

    def set_checkpoint(self, path: str, over_write: bool = True,
                       trigger=None):
        self.trainer.set_checkpoint(path, over_write, trigger)

    def optimize(self, end_trigger=None, shuffle: bool = True,
                 verbose: bool = False):
        """Run to ``end_trigger`` (one more epoch by default), then write
        the trained weights back into the live session."""
        ds = Dataset(tuple(self.dataset.arrays))
        history = self.trainer.fit(
            ds, self.dataset.batch_size,
            end_trigger=end_trigger or trigger_lib.MaxEpoch(
                self.trainer.state.epoch + 1
                if self.trainer.state else 1),
            shuffle=shuffle, verbose=verbose)
        if self._val is not None:
            history.setdefault("val", []).append(self.evaluate())
        self._push_weights_to_session()
        return history

    def evaluate(self, batch_size: Optional[int] = None) -> Dict[str, float]:
        """The validation outputs and labels over the validation arrays
        (the training arrays when none were given), through the
        metrics; whole batches only, as the JAX package runs them."""
        if self._val is None:
            raise ValueError("no val_outputs/val_labels configured")
        vconv, n_out, methods = self._val
        arrays = self.dataset.val_arrays or self.dataset.arrays
        bs = batch_size or self.dataset.batch_size
        model = self._model
        values = {k: v.detach() for k, v in model.all_values().items()}
        gen = torch.Generator(model.device).manual_seed(0)
        accs = [m.init() for m in methods]
        n = len(arrays[0])
        with torch.no_grad():
            for i in range(0, n - n % bs or n, bs):
                batch = [torch.as_tensor(a[i:i + bs], device=model.device)
                         for a in arrays]
                outs = vconv(values, *batch, rng=gen, device=model.device)
                y_pred, y_true = outs[:n_out], outs[n_out:]
                accs = [m.update(a, y_true[0] if len(y_true) == 1
                                 else y_true,
                                 y_pred[0] if len(y_pred) == 1 else y_pred)
                        for m, a in zip(methods, accs)]
        return {m.name: float(m.result(a)) for m, a in zip(methods, accs)}

    # -- weights back to TF ------------------------------------------------
    def _current_trainable(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy()
                for k, v in self._model.params().items()}

    def _push_weights_to_session(self):
        tf = require_module("tensorflow", "TFOptimizer")
        values = self._current_trainable()
        # placeholders and assign ops are built once and reused: building
        # them a call would grow the user's graph every optimize()
        if getattr(self, "_assign_cache", None) is None:
            with self.sess.graph.as_default():
                cache = {}
                for name, var in self._trainable_vars.items():
                    ph = tf.compat.v1.placeholder(var.dtype.base_dtype,
                                                  var.shape)
                    cache[name] = (ph, var.assign(ph))
                self._assign_cache = cache
        names = list(self._trainable_vars)
        self.sess.run([self._assign_cache[n][1] for n in names],
                      feed_dict={self._assign_cache[n][0]: values[n]
                                 for n in names})


class TFPredictor:
    """Inference over a TFDataset (reference ``TFPredictor``) on
    ``device`` (``"cuda"`` unless asked otherwise).  Needs tensorflow
    (the session)."""

    def __init__(self, sess, outputs: Sequence, dataset:
                 Optional[TFDataset] = None, device=None):
        require_module("tensorflow", "TFPredictor")
        ph_names = _find_placeholder_names(list(outputs))
        if dataset is None:
            dataset, _ = find_dataset(sess.graph, ph_names)
        self.dataset = dataset
        input_names = [ph.name for ph in dataset.tensors]
        self._conv = ConvertedGraph(sess.graph.as_graph_def(), input_names,
                                    [t.name for t in outputs])
        self._device = make_generator(device).device
        self._params = {k: torch.as_tensor(v, device=self._device)
                        for k, v in _reachable_param_values(
                            sess, self._conv).items()}

    def predict(self) -> Any:
        arrays = self.dataset.arrays
        bs = self.dataset.batch_size
        n = len(arrays[0])
        outs: List[List[np.ndarray]] = []
        with torch.no_grad():
            for i in range(0, n, bs):
                batch = [torch.as_tensor(a[i:i + bs], device=self._device)
                         for a in arrays]
                outs.append([o.cpu().numpy() for o in self._conv(
                    self._params, *batch, device=self._device)])
        cat = [np.concatenate([o[j] for o in outs])
               for j in range(len(outs[0]))]
        return cat[0] if len(cat) == 1 else cat
