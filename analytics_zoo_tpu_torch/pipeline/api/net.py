"""Net loaders and GraphNet: model import and transfer-learning surgery.

Counterpart of ``analytics_zoo_tpu/pipeline/api/net.py`` (reference
Net.scala:89-189 and GraphNet, pyzoo/zoo/pipeline/api/net.py:43-108).
The port's own format loads natively; ONNX files and frozen TF graphs
import through the port's codecs and converters (no ``onnx`` and no
``tensorflow`` needed); Keras files and live tf.keras models freeze
through TF first (``load_keras``, ``from_tf_keras``: they need
tensorflow); PyTorch state_dicts transfer through the layout converter;
Caffe and Torch7 ``.t7`` archives are refused with guidance.  Every
loader builds on ``device`` (``"cuda"`` unless asked otherwise).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ...core.graph import InputLayer, Variable
from ._convert_util import require_module
from .keras.engine import KerasNet, Model


class Net:
    """Static loaders (reference Net.scala:89-189)."""

    @staticmethod
    def load(path: str, weight_path: Optional[str] = None,
             device=None) -> KerasNet:
        """Load a model saved by ``save_model`` (of either package),
        the zoo's families included, in any process."""
        net = KerasNet.load_model(path, device=device)
        if weight_path is not None:
            net.load_weights(weight_path)
        return net

    load_bigdl = load  # the native format is this framework's format here

    @staticmethod
    def load_keras(json_path: Optional[str] = None,
                   hdf5_path: Optional[str] = None,
                   input_shape: Optional[Sequence[int]] = None,
                   device=None):
        """Import a Keras model (reference ``Net.load_keras``): loaded
        with tf.keras (``.h5``/``.keras``/SavedModel, or a json and hdf5
        pair), frozen to a GraphDef and wrapped as a :class:`TFNet` that
        runs on torch.  Needs tensorflow to read the file."""
        tf = require_module("tensorflow", "Net.load_keras")
        if json_path is not None:
            with open(json_path) as f:
                km = tf.keras.models.model_from_json(f.read())
            if hdf5_path is not None:
                km.load_weights(hdf5_path)
        elif hdf5_path is not None:
            km = tf.keras.models.load_model(hdf5_path, compile=False)
        else:
            raise ValueError("pass json_path and/or hdf5_path")
        return Net.from_tf_keras(km, input_shape=input_shape, device=device)

    @staticmethod
    def from_tf_keras(keras_model, input_shape: Optional[Sequence[int]]
                      = None, device=None):
        """Freeze a live tf.keras model into a :class:`TFNet`.  Needs
        tensorflow."""
        tf = require_module("tensorflow", "Net.from_tf_keras")
        from tensorflow.python.framework.convert_to_constants import (
            convert_variables_to_constants_v2)
        from .tfgraph.net import TFNet

        if input_shape is None:
            # each input's own dtype (int ids feeding an Embedding)
            specs = [tf.TensorSpec([None] + list(t.shape[1:]), t.dtype)
                     for t in keras_model.inputs]
        else:
            specs = [tf.TensorSpec([None] + list(input_shape),
                                   keras_model.inputs[0].dtype
                                   if getattr(keras_model, "inputs", None)
                                   else tf.float32)]
        fn = tf.function(lambda *a: keras_model(a[0] if len(a) == 1
                                                else list(a)))
        frozen = convert_variables_to_constants_v2(
            fn.get_concrete_function(*specs))
        return TFNet(graph_def=frozen.graph.as_graph_def(),
                     input_names=[t.name for t in frozen.inputs],
                     output_names=[t.name for t in frozen.outputs],
                     device=device)

    @staticmethod
    def load_caffe(def_path: str, model_path: str):
        raise NotImplementedError(
            "Caffe model import is not supported in the TPU build "
            "(format retired; reference kept it only for legacy zoo "
            "weights)")

    @staticmethod
    def load_torch(path: str, net=None):
        """With ``net`` given, ``path`` is a PyTorch ``state_dict``
        (``torch.save(model.state_dict(), path)``) loaded into ``net``
        through the layout converter (``models/weight_loading.py``).
        Torch7 ``.t7`` archives (the reference's format) are refused:
        their structure cannot be rebuilt from weights alone."""
        if net is None:
            raise NotImplementedError(
                "Torch7 .t7 import is not supported in the TPU build; "
                "pass net= (a structurally matching model) to load a "
                "pytorch state_dict into it via "
                "models.weight_loading.load_torch_state_dict")
        import torch
        try:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:
            raise ValueError(
                f"could not load {path!r} as a state_dict "
                f"(save with torch.save(model.state_dict(), path)): {e}")
        from ...models.weight_loading import load_torch_state_dict
        return load_torch_state_dict(net, sd)

    @staticmethod
    def load_onnx(path: str, device=None):
        """Load an ``.onnx`` model as an :class:`OnnxNet` layer with the
        port's own protobuf codec (no ``onnx`` package)."""
        from .onnx import load_onnx
        return load_onnx(path, device=device)

    @staticmethod
    def load_tf(path: str, input_names: Optional[Sequence[str]] = None,
                output_names: Optional[Sequence[str]] = None, device=None):
        """Import a frozen TF graph (reference ``Net.load_tf``, the TFNet
        folder format): an export folder (pb and ``graph_meta.json``) or
        a raw ``.pb`` with its input and output names, parsed by the
        port's codec (no ``tensorflow``) and run on torch."""
        from .tfgraph.net import TFNet
        return TFNet(path=path, input_names=input_names,
                     output_names=output_names, device=device)


class GraphNet(Model):
    """A Model with transfer-learning surgery (reference GraphNet)."""

    @classmethod
    def from_model(cls, model) -> "GraphNet":
        """A GraphNet over ``model``'s graph (its layers and weights
        shared)."""
        g = model.to_graph()
        net = cls.__new__(cls)
        KerasNet.__init__(net, name=model.name)
        net._device = model.device
        net.seed = getattr(model, "seed", 0)
        net.graph = g
        net.inputs = g.input_vars
        net.outputs = g.output_vars
        return net

    def nodes(self, names: Sequence[str]) -> List[Variable]:
        by_name = {v.name: v for v in self.graph.nodes}
        return [by_name[n] for n in names]

    def freeze_up_to(self, names: Sequence[str]) -> "GraphNet":
        """Freeze every layer from the inputs up to (and with) the named
        nodes (reference ``freezeUpTo``): their weights stop receiving
        gradients."""
        frozen_ids = set()
        for t in self.nodes(names):
            for v in t.ancestors():
                frozen_ids.add(v.node_id)
        for v in self.graph.nodes:
            if v.node_id in frozen_ids and not isinstance(v.layer,
                                                          InputLayer):
                v.layer.trainable = False
        return self._sync_freeze()

    def unfreeze(self, names=None) -> "GraphNet":
        return super().unfreeze(names)

    def to_keras(self) -> Model:
        """Reference ``GraphNet.to_keras``: it already is a keras Model."""
        return self
