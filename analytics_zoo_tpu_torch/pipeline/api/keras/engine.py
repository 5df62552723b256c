"""KerasNet, Sequential and Model: the compile/fit/evaluate/predict
lifecycle over the graph engine.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine.py``.  There
a KerasNet is a graph of layers whose weights live in its Trainer's state;
here every layer is an ``nn.Module`` that owns its parameters, and the
Trainer updates them in place.  So ``compile`` never re-initializes
weights: they are made when the model builds its layers (``Sequential.add``,
``Model(input, output)``: one ``torch.Generator`` per model, seeded with
its ``seed`` on its ``device``), and a new compile only starts a fresh
optimizer state and step count.  Models that share layer instances
(``to_model``, ``new_graph``) share their weights.

A KerasNet is a Layer, so a model nests in another
(``Sequential.add(Sequential)``).  ``save_model`` writes the reference's
``architecture.json`` and, as the JAX package does, the training state
(weights, layer state and, when compiled, the optimizer state under
optax's leaf names) in the sharded checkpoint format; ``load_model``
rebuilds the model from it, and reads the JAX package's saves and the
port's earlier flat ones too.  ``fit(resume=True)`` restores the newest
snapshot of the ``set_checkpoint`` directory first.  Layers freeze by name
(``freeze``, ``freeze_up_to``, ``unfreeze``): the flags take effect at
the next step and persist through ``save_model``.  ``to_serving`` wraps
a model in an ``InferenceModel``; ``quantize`` gives its int8 inference
twin (``ops/quantize.py``).  Graph surgery beyond ``new_graph`` is not
ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ....common.context import resolve_device
from ....core.graph import GraphModule, Input, InputLayer, Variable
from ....core.module import (Layer, get_layer_class, register_layer,
                             remat_call, serial_class_name)
from ....data.dataset import Dataset
from ....train import checkpoint as checkpoint_lib
from ....train import triggers as trigger_lib
from ....train.trainer import Trainer, predict_batches
from . import metrics as metrics_lib
from . import objectives as objectives_lib
from . import optimizers as optimizers_lib


class KerasNet(Layer):
    """Compiled-model lifecycle shared by Sequential, Model and the zoo's
    models; graph-based subclasses (``graph_based``) define
    ``to_graph``."""

    #: True where the weights are those of the layers of ``to_graph()``
    graph_based = False

    def __init__(self, name=None):
        super().__init__(name=name)
        self.trainer: Optional[Trainer] = None
        self._compile_args: Optional[dict] = None
        self._tensorboard: Optional[tuple] = None
        self._checkpoint: Optional[tuple] = None
        self._summary_triggers: Dict[str, object] = {}
        self._clip_norm = None
        self._clip_value = None

    def to_graph(self) -> GraphModule:
        raise NotImplementedError(
            f"{type(self).__name__} is not built on the graph engine")

    @property
    def device(self) -> torch.device:
        return self._device

    def compile(self, optimizer, loss, metrics: Sequence = (),
                mesh=None, strategy: Optional[str] = None, seed: int = 0,
                compute_dtype=None, accum_steps: Optional[int] = None,
                tp_rules: Optional[Dict[str, int]] = None):
        """Resolve the loss, the optimizer (with the clipping set before
        compile) and the metrics; string metrics inherit the loss's
        ``zero_based_label``.  ``seed`` orders the shuffled batches.
        ``compute_dtype`` (``torch.bfloat16``: bf16 compute over f32
        master weights and moments) and ``accum_steps`` (microbatches a
        batch) go to the :class:`Trainer`, which falls back to
        ``ZOO_TRAIN_DTYPE`` and ``ZOO_TRAIN_ACCUM`` for either not
        given.  ``mesh`` (``parallel.mesh.create_mesh``), ``strategy``
        (``replicate`` | ``fsdp`` | ``tp`` | ``fsdp_tp``, else
        ``ZOO_TRAIN_STRATEGY``) and ``tp_rules`` train sharded: ``fit``'s
        ``batch_size`` is then the global batch, of which each rank feeds
        its rows."""
        loss_fn = objectives_lib.get(loss)
        opt = optimizers_lib.get(optimizer, clip_norm=self._clip_norm,
                                 clip_value=self._clip_value)
        zero_based = getattr(loss_fn, "zero_based_label", True)
        metric_objs = [metrics_lib.get(m, zero_based_label=zero_based)
                       for m in metrics]
        self.trainer = Trainer(self, loss_fn, opt, metrics=metric_objs,
                               seed=seed, compute_dtype=compute_dtype,
                               accum_steps=accum_steps, mesh=mesh,
                               strategy=strategy, tp_rules=tp_rules)
        if self._tensorboard:
            self.trainer.set_tensorboard(*self._tensorboard)
            self._apply_summary_triggers()
        if self._checkpoint:
            self.trainer.set_checkpoint(*self._checkpoint)
        self._compile_args = {"optimizer": optimizer, "loss": loss,
                              "metrics": list(metrics)}
        return self

    def set_tensorboard(self, log_dir: str, app_name: str,
                        profile: bool = False, profile_steps: int = 10):
        """Write training and validation scalars under
        ``<log_dir>/<app_name>``; ``profile=True`` also captures one
        ``torch.profiler`` trace a fit, of its first ``profile_steps``
        steps (``Trainer.set_tensorboard``).  Takes effect now or at
        compile."""
        self._tensorboard = (log_dir, app_name, profile, profile_steps)
        if self.trainer is not None:
            self.trainer.set_tensorboard(log_dir, app_name,
                                         profile=profile,
                                         profile_steps=profile_steps)
            self._apply_summary_triggers()

    def set_summary_trigger(self, tag: str, trigger):
        """Write the summary scalar ``tag`` only when ``trigger`` fires
        (BigDL setSummaryTrigger); before or after compile and
        ``set_tensorboard``."""
        self._summary_triggers[tag] = trigger
        if self.train_summary is not None:
            self.train_summary.set_summary_trigger(tag, trigger)
        return self

    def _apply_summary_triggers(self):
        if self.train_summary is not None:
            for tag, trig in self._summary_triggers.items():
                self.train_summary.set_summary_trigger(tag, trig)

    @property
    def train_summary(self):
        return None if self.trainer is None else self.trainer.train_summary

    @property
    def val_summary(self):
        return None if self.trainer is None else self.trainer.val_summary

    def set_checkpoint(self, path: str, over_write: bool = True):
        """Save the training state under ``path`` at the end of every
        epoch; takes effect now or at compile."""
        self._checkpoint = (path, over_write)
        if self.trainer is not None:
            self.trainer.set_checkpoint(path, over_write)

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        """Clip gradients by their global L2 norm; call before compile."""
        self._clip_norm = float(clip_norm)

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        """Clip each gradient element to +-max(|min|, |max|); call before
        compile."""
        self._clip_value = (float(min_value), float(max_value))

    def clear_gradient_clipping(self):
        """Drop both clippings; call before compile."""
        self._clip_norm = None
        self._clip_value = None

    def get_layer(self, name: str) -> Layer:
        """The layer of this model's graph named ``name``."""
        matches = [l for l in self.to_graph().layers if l.name == name]
        if not matches:
            raise ValueError(f"no layer named {name!r}")
        return matches[0]

    # ---- freezing ----
    def _layers_by_name(self) -> Dict[str, Layer]:
        """The model's own layers by name: its graph's, or for a model
        built by hand (TransformerLM) its child layers."""
        if self.graph_based:
            return {l.name: l for l in self.to_graph().layers}
        return {m.name: m for m in self.children() if isinstance(m, Layer)}

    def _resolve_layer_names(self, names):
        names = [names] if isinstance(names, str) else list(names)
        known = self._layers_by_name()
        unknown = [n for n in names if n not in known]
        if unknown:
            raise ValueError(f"unknown layer names {unknown}; known: "
                             f"{sorted(known)}")
        return names, known

    def _sync_freeze(self):
        if self.trainer is not None:
            self.trainer.refresh_optimizer()
        return self

    def freeze(self, names):
        """Freeze the named layers: no gradient and no update from the
        next step on."""
        names, known = self._resolve_layer_names(names)
        for n in names:
            known[n].trainable = False
        return self._sync_freeze()

    def freeze_up_to(self, names):
        """Freeze the named layers and every layer they depend on, from
        the inputs: ancestors only, so parallel branches stay
        trainable."""
        names, _ = self._resolve_layer_names(names)
        for v in self.to_graph().nodes:
            if v.layer.name in names:
                for a in v.ancestors():
                    if not isinstance(a.layer, InputLayer):
                        a.layer.trainable = False
        return self._sync_freeze()

    def unfreeze(self, names=None):
        """Unfreeze the named layers (all when ``names`` is None)."""
        if names is None:
            layers = self._layers_by_name().values()
        else:
            names, known = self._resolve_layer_names(names)
            layers = [known[n] for n in names]
        for layer in layers:
            layer.trainable = True
        return self._sync_freeze()

    def frozen_layer_names(self) -> List[str]:
        return sorted(n for n, l in self._layers_by_name().items()
                      if not l.trainable)

    def _require_compiled(self):
        if self.trainer is None:
            raise RuntimeError(
                "Model must be compiled before fit/evaluate "
                "(reference requires compile before fit too)")

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None, shuffle: bool = True,
            verbose: bool = False, resume: bool = False):
        """Train for ``nb_epoch`` more epochs on ``x``/``y`` (arrays or a
        Dataset); batches go to the model's device.  Returns the history
        ``{"loss": [...], "val": [...]}``.

        ``resume=True``: when the ``set_checkpoint`` directory holds a
        complete snapshot, the training state is restored from the
        newest one first, and ``nb_epoch`` more epochs run from there; a
        first run (no snapshot yet) starts as usual, so the same script
        survives a crash unchanged."""
        self._require_compiled()
        if resume:
            if not self._checkpoint:
                raise ValueError(
                    "fit(resume=True) needs set_checkpoint(path) first")
            ckpt_dir = self._checkpoint[0]
            if checkpoint_lib.latest_tag(ckpt_dir) is not None:
                self.trainer.load_weights(ckpt_dir)
        ds = x if isinstance(x, Dataset) else Dataset.from_ndarray(x, y)
        val_ds = None
        if validation_data is not None:
            val_ds = (validation_data if isinstance(validation_data, Dataset)
                      else Dataset.from_ndarray(*validation_data))
        self.trainer.ensure_initialized()
        start_epoch = self.trainer.state.epoch
        return self.trainer.fit(
            ds, batch_size,
            end_trigger=trigger_lib.MaxEpoch(start_epoch + nb_epoch),
            validation_data=val_ds, shuffle=shuffle, verbose=verbose)

    def evaluate(self, x, y=None, batch_size: int = 32,
                 metrics=None) -> Dict[str, float]:
        """Compiled metrics (or ``metrics``) and the mean loss over all of
        ``x``/``y``."""
        self._require_compiled()
        ds = x if isinstance(x, Dataset) else Dataset.from_ndarray(x, y)
        return self.trainer.evaluate(ds, batch_size, metrics=metrics)

    def predict(self, x, batch_size: int = 32):
        """Forward ``x`` in batches without dropout; numpy out (a list for
        several outputs).  Needs no compile.  A model compiled on a mesh
        predicts through its trainer (``Trainer.predict``: ``batch_size``
        is global, and the layers that see the whole batch see the
        global one, as in the JAX package)."""
        if self.trainer is not None and self.trainer.mesh is not None:
            return self.trainer.predict(x, batch_size)
        return predict_batches(self, x, batch_size)

    def to_serving(self, supported_concurrent_num: int = 1,
                   max_batch_size: int = 32, coalescing: bool = False,
                   max_wait_ms: float = 2.0, quantize: Optional[bool] = None,
                   warmup_shapes=None, replicas=1):
        """This model in an ``InferenceModel`` on the serving fast path
        (bucketed forward, optionally coalesced) on the model's device.
        ``warmup_shapes`` (a per-sample shape, or a list of them for
        several inputs) runs the whole bucket ladder before traffic."""
        from ...inference import InferenceModel
        im = InferenceModel(
            supported_concurrent_num=supported_concurrent_num,
            max_batch_size=max_batch_size, coalescing=coalescing,
            max_wait_ms=max_wait_ms, replicas=replicas)
        im.load_keras_net(self, quantize=quantize)
        if warmup_shapes is not None and im._cache is not None:
            # a quantized handle serves on the exact-shape path: no
            # ladder to warm
            im.warmup(warmup_shapes)
        return im

    def quantize(self) -> "Model":
        """Post-training int8 quantization: an inference-only functional
        ``Model`` named ``<name>_int8`` over this model's graph with its
        Dense, convolution, Embedding and separable pointwise layers
        swapped for int8 ones (per-output-channel weights, per-sample
        activations, int32 accumulation); the other layers are copies of
        this model's, their weights and state adopted as they are.  The
        twin is a snapshot: training this model later leaves it as it
        was."""
        from ....ops.quantize import quantize_graph
        qg, _, _ = quantize_graph(self.to_graph())
        out = (qg.output_vars[0] if qg.single_output
               else list(qg.output_vars))
        return Model(input=list(qg.input_vars), output=out,
                     name=f"{self.name}_int8", device=self.device)

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based_label: bool = True):
        """The argmax class of each prediction; ``zero_based_label=False``
        counts classes from 1."""
        classes = np.argmax(self.predict(x, batch_size), axis=-1)
        return classes if zero_based_label else classes + 1

    def get_weights(self):
        """The parameters as the JAX package's tree: {layer: {name:
        numpy array}}, in model order; the layer state is not among them,
        as in the JAX package."""
        # models/ imports this module, so its helpers load at call time
        from ....models.jax_params import to_jax_params
        return to_jax_params(self)

    def set_weights(self, params):
        """Load a {layer: {name: array}} tree (this package's or the JAX
        package's ``get_weights()``) in place; layers are matched by name,
        or by position when the names differ but every shape matches."""
        from ....models.jax_params import from_jax_params
        from_jax_params(self, params)

    def load_weights(self, directory: str, tag=None):
        """Load the weights and layer state of a checkpoint directory (a
        ``set_checkpoint`` directory, or a saved model's ``weights``);
        a compiled model restores its optimizer state and counters
        too."""
        if self.trainer is not None:
            self.trainer.load_weights(directory, tag)
        else:
            from ....models.jax_params import model_tree
            checkpoint_lib.restore_into(directory, model_tree(self), tag)
        return self

    def transfer_weights_from(self, other: "KerasNet") -> "KerasNet":
        """Copy the weights and layer state of every layer that ``other``
        shares with this model by name (transfer learning after graph
        surgery); a shape that differs raises, and so does sharing no
        layer."""
        from ....models.jax_params import (copy_leaves, state_tree,
                                           to_jax_params, to_jax_state,
                                           weight_tree)
        copied = []
        for kind, mine, theirs in (
                ("params", weight_tree(self), to_jax_params(other)),
                ("state", state_tree(self), to_jax_state(other))):
            for name, leaves in theirs.items():
                if name in mine:
                    with torch.no_grad():
                        copy_leaves(name, kind, mine[name], leaves)
                    copied.append(name)
        if not copied:
            raise ValueError(
                "transfer_weights_from: no layer names in common; the "
                "models do not share layers")
        return self

    def summary(self) -> str:
        """Print and return each layer's name, class and parameter
        count."""
        lines = [f"Model: {self.name}", "-" * 64]
        total = 0
        for layer in self.to_graph().layers:
            count = sum(p.numel() for p in layer.parameters())
            total += count
            lines.append(f"{layer.name:<36} {type(layer).__name__:<20} "
                         f"params: {count}")
        lines += ["-" * 64, f"Total params: {total}"]
        text = "\n".join(lines)
        print(text)
        return text

    def save_graph_topology(self, log_path: str) -> str:
        """Write the model's graph topology under ``log_path`` (the
        reference's ``saveGraphTopology``, Topology.scala:536-546):
        ``graph_topology.txt`` (each node and its inputs, with shapes, in
        topological order) and ``graph_topology.dot`` (Graphviz; render
        with ``dot -Tpng``), as the JAX package writes them.  Returns
        ``log_path``."""
        graph = self.to_graph()
        os.makedirs(log_path, exist_ok=True)

        def _label(v):
            kind = ("Input" if isinstance(v.layer, InputLayer)
                    else type(v.layer).__name__)
            return f"{v.name} [{kind}] {tuple(v.shape) if v.shape else ''}"

        lines = [f"model: {self.name}", ""]
        for v in graph.nodes:
            src = ", ".join(i.name for i in v.inputs) or "(graph input)"
            lines.append(f"{_label(v)}  <-  {src}")
        with open(os.path.join(log_path, "graph_topology.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        dot = ["digraph model {", "  rankdir=TB;",
               '  node [shape=box, fontsize=10];']
        for v in graph.nodes:
            dot.append(f'  n{v.node_id} [label="{_label(v)}"];')
            for i in v.inputs:
                dot.append(f"  n{i.node_id} -> n{v.node_id};")
        dot.append("}")
        with open(os.path.join(log_path, "graph_topology.dot"), "w") as f:
            f.write("\n".join(dot) + "\n")
        return log_path

    # ---- persistence ----
    def save_model(self, path: str, over_write: bool = True):
        """``architecture.json`` (``{"class_name", "config"}``, the
        reference's schema) and, under ``weights``, the tag ``final`` in
        the sharded format: the trainer's whole state when compiled (as
        the JAX package's ``save_model``), else the weights and layer
        state."""
        os.makedirs(path, exist_ok=True)
        arch_path = os.path.join(path, "architecture.json")
        if os.path.exists(arch_path) and not over_write:
            raise FileExistsError(path)
        with open(arch_path, "w") as f:
            json.dump({"class_name": type(self).__name__,
                       "config": self.get_config()}, f)
        weights = os.path.join(path, "weights")
        if self.trainer is not None:
            self.trainer.save_weights(weights)
        else:
            from ....models.jax_params import model_tree
            checkpoint_lib.save_sharded(weights, "final", model_tree(self))

    @staticmethod
    def load_model(path: str, device=None) -> "KerasNet":
        """Rebuild a model saved by :meth:`save_model` (of either
        package) on ``device`` (``"cuda"`` unless asked otherwise),
        compile it again when it was compiled, and restore the weights,
        the layer state and, when compiled, the optimizer state and
        counters the save holds."""
        with open(os.path.join(path, "architecture.json")) as f:
            arch = json.load(f)
        cls = _MODEL_CLASSES.get(arch["class_name"])
        if cls is None:
            raise ValueError(
                f"unknown model class {arch['class_name']!r}: a zoo model "
                "registers when analytics_zoo_tpu_torch.models is imported")
        model = cls.from_config(arch["config"], device=device)
        if model._compile_args is not None:
            model.compile(**model._compile_args)
        weights_dir = os.path.join(path, "weights")
        if os.path.isdir(weights_dir):
            model.load_weights(weights_dir)
        return model

    # ---- as a layer of another model ----
    def build_params(self, input_shape, generator):
        self.to_graph().build(input_shape, generator)

    def compute_output_shape(self, input_shape):
        return self.to_graph().compute_output_shape(input_shape)


def _seeded_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(int(seed))


@register_layer
class Sequential(KerasNet):
    """A stack of layers.  ``add`` builds each layer from the previous
    one's output shape (the first needs ``input_shape``) on the model's
    ``device``, drawing from the model's generator seeded with ``seed``."""

    graph_based = True

    def __init__(self, name=None, device=None, seed: int = 0):
        super().__init__(name=name)
        self._device = resolve_device(device)
        self.seed = int(seed)
        self._generator = _seeded_generator(self._device, seed)
        self.stack = nn.ModuleList()
        self._output_shape = None
        self.__dict__["_graph"] = None  # derived; not a submodule

    @staticmethod
    def _given_input_shape(layer: Layer):
        """A first layer's batch input shape: its own, or a nested
        model's."""
        if layer.batch_input_shape is None and isinstance(layer, KerasNet):
            return layer.to_graph().input_shapes[0]
        return layer.batch_input_shape

    def add(self, layer: Layer) -> "Sequential":
        if not len(self.stack):
            shape = self._given_input_shape(layer)
            if shape is None:
                raise ValueError(
                    "First layer needs input_shape (reference Sequential "
                    "requires the same)")
        else:
            shape = self._output_shape
        layer.build(shape, self._generator)
        self._output_shape = layer.compute_output_shape(shape)
        self.stack.append(layer)
        self.__dict__["_graph"] = None
        return self

    @property
    def layers(self) -> List[Layer]:
        return list(self.stack)

    def forward(self, x):
        for layer in self.stack:
            x = remat_call(layer, x)
        return x

    def to_graph(self) -> GraphModule:
        if self._graph is None:
            shape = self._given_input_shape(self.stack[0])
            x = Input(tuple(shape[1:]), name=f"{self.name}_input")
            h = x
            for layer in self.stack:
                h = layer(h)
            self.__dict__["_graph"] = GraphModule(x, h, name=self.name)
        return self._graph

    def to_model(self) -> "Model":
        """The functional ``Model`` over the same layers (and so the same
        weights), sharing this model's compiled trainer."""
        g = self.to_graph()
        model = Model(input=g.input_vars[0], output=g.output_vars[0],
                      name=self.name, device=self._device, seed=self.seed)
        model.trainer = self.trainer
        model._compile_args = self._compile_args
        return model

    def get_config(self):
        return {
            "name": self.name,
            "layers": [{"class_name": serial_class_name(l),
                        "config": l.get_config()} for l in self.stack],
            "compile_args": self._compile_args,
        }

    @classmethod
    def from_config(cls, config, device=None, seed: int = 0):
        model = cls(name=config.get("name"), device=device, seed=seed)
        for spec in config["layers"]:
            model.add(_layer_from_spec(spec, model.device))
        model._compile_args = config.get("compile_args")
        return model


@register_layer
class Model(KerasNet):
    """Functional graph model from ``input`` to ``output`` Variables
    (lists for several).  Every layer not built yet is built from the
    shape of its first use, in first-use order, on ``device`` from one
    generator seeded with ``seed``."""

    graph_based = True

    def __init__(self, input=None, output=None, name=None, device=None,
                 seed: int = 0):
        super().__init__(name=name)
        if input is None or output is None:
            raise ValueError("Model requires input and output Variables")
        self._device = resolve_device(device)
        self.seed = int(seed)
        self.graph = GraphModule(input, output, name=self.name)
        self.graph.build(None, _seeded_generator(self._device, seed))
        self.inputs = self.graph.input_vars
        self.outputs = self.graph.output_vars

    def forward(self, inputs):
        return self.graph(inputs)

    def to_graph(self) -> GraphModule:
        return self.graph

    def new_graph(self, outputs: List[str]) -> "Model":
        """A model over the same inputs re-rooted on the named nodes
        (sharing their layers and weights)."""
        by_name = {v.name: v for v in self.graph.nodes}
        outs = [by_name[n] for n in outputs]
        return Model(input=self.graph.input_vars,
                     output=outs[0] if len(outs) == 1 else outs,
                     name=f"{self.name}_sub", device=self._device)

    def get_config(self):
        nodes = []
        for v in self.graph.nodes:
            nodes.append({
                "id": v.node_id,
                "name": v.name,
                "layer": {"class_name": serial_class_name(v.layer),
                          "config": v.layer.get_config()},
                "inputs": [p.node_id for p in v.inputs],
                "shape": list(v.shape),
            })
        return {"name": self.name, "nodes": nodes,
                "input_ids": [v.node_id for v in self.graph.input_vars],
                "output_ids": [v.node_id for v in self.graph.output_vars],
                "single_output": self.graph.single_output,
                "compile_args": self._compile_args}

    @classmethod
    def from_config(cls, config, device=None, seed: int = 0):
        device = resolve_device(device)
        built: Dict[int, Variable] = {}
        layers: Dict[str, Layer] = {}
        for spec in config["nodes"]:
            layer_spec = spec["layer"]
            if layer_spec is None or layer_spec["class_name"] == "InputLayer":
                cfg = (layer_spec or {}).get("config", {})
                shape = tuple(cfg.get("input_shape") or spec["shape"][1:])
                built[spec["id"]] = Input(shape, name=spec["name"])
                continue
            lname = layer_spec["config"].get("name", spec["name"])
            if lname not in layers:
                layers[lname] = _layer_from_spec(layer_spec, device)
            parents = [built[i] for i in spec["inputs"]]
            if not parents:  # a source: Parameter or constant
                built[spec["id"]] = Variable(layers[lname], (),
                                             spec["shape"], name=spec["name"])
                continue
            built[spec["id"]] = layers[lname](
                parents if len(parents) > 1 else parents[0])
        outs = [built[i] for i in config["output_ids"]]
        single = config.get("single_output", len(outs) == 1)
        model = cls(input=[built[i] for i in config["input_ids"]],
                    output=outs[0] if single else outs,
                    name=config.get("name"), device=device, seed=seed)
        model._compile_args = config.get("compile_args")
        return model


def _layer_from_spec(spec: dict, device) -> Layer:
    layer_cls = get_layer_class(spec["class_name"])
    if issubclass(layer_cls, KerasNet):
        return layer_cls.from_config(spec["config"], device=device)
    return layer_cls.from_config(spec["config"])


#: the classes ``load_model`` rebuilds, by the name ``save_model`` wrote
#: (the zoo's models register themselves, models/common.py)
_MODEL_CLASSES = {"Sequential": Sequential, "Model": Model}


def load_model(path: str, device=None) -> KerasNet:
    return KerasNet.load_model(path, device=device)


__all__ = ["Input", "InputLayer", "KerasNet", "Model", "Sequential",
           "load_model"]
