"""ZooModel: base of the port's model zoo.

Counterpart of ``analytics_zoo_tpu/models/common.py``: a model of the
zoo is a :class:`KerasNet` (compile/fit/evaluate/predict) holding its
hyperparameters, a name and the config they give.  A subclass either
builds its layers in ``__init__`` and defines ``forward``
(``TransformerLM``), or defines ``build_model(device, seed)``, which
returns a graph ``Model``, and calls :meth:`ZooModel.build_graph`
(``ImageClassifier``): as in the JAX package the graph is built inside
``name_scope(<class name, lower case>)``, so the auto-named layers of the
two packages' models get equal names.  A subclass registers with
``load_model``, which rebuilds it from its saved hyperparameters.
"""

from __future__ import annotations

from typing import Optional

from ..common.context import resolve_device
from ..core.module import name_scope
from ..pipeline.api.keras.engine import _MODEL_CLASSES, KerasNet


class ZooModel(KerasNet):
    def __init__(self, name: Optional[str] = None, **hyper):
        super().__init__(name=name or type(self).__name__.lower())
        self.hyper = hyper

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _MODEL_CLASSES[cls.__name__] = cls

    def build_model(self, device, seed: int):
        raise NotImplementedError(
            f"{type(self).__name__} builds its layers in __init__")

    def build_graph(self, device=None, seed: int = 0) -> None:
        """Build ``build_model``'s graph on ``device`` (``"cuda"`` unless
        asked otherwise) from ``seed``, inside the class's name scope;
        the model's layers, weights and state are the graph's."""
        self._device = resolve_device(device)
        with name_scope(type(self).__name__.lower()):
            self.model = self.build_model(self._device, seed)
        self.graph_based = True

    def to_graph(self):
        if not self.graph_based:
            return super().to_graph()
        return self.model.to_graph()

    def forward(self, x):
        return self.model(x)

    @classmethod
    def from_config(cls, config, device=None):
        model = cls(name=config["name"], device=device, **config["hyper"])
        model._compile_args = config.get("compile_args")
        return model

    def get_config(self) -> dict:
        return {"name": self.name, "hyper": dict(self.hyper),
                "compile_args": self._compile_args}


def parse_quantize_name(model_name: str):
    """'<arch>[-quantize]' -> (arch, wants_int8): the registry's
    convention for int8 variants."""
    if model_name.endswith("-quantize"):
        return model_name[:-len("-quantize")], True
    return model_name, False


class QuantizedVariantMixin:
    """Zoo models whose registry carries '<name>-quantize' variants: such
    a variant's ``predict`` runs the int8 net (:meth:`KerasNet.quantize`),
    built from the current weights at the first call and cached; every
    entry point that changes the weights drops the cache, so the int8
    net never serves stale weights."""

    _quantized_net = None

    def _set_quantized(self, net):
        # kept out of the module tree: the twin's int8 tensors are not
        # this model's parameters
        self.__dict__["_quantized_net"] = net

    def _invalidate_quantized(self):
        self._set_quantized(None)

    def compile(self, *args, **kwargs):
        self._invalidate_quantized()
        return super().compile(*args, **kwargs)

    def fit(self, *args, **kwargs):
        self._invalidate_quantized()
        return super().fit(*args, **kwargs)

    def set_weights(self, params):
        self._invalidate_quantized()
        return super().set_weights(params)

    def load_weights(self, directory: str, tag=None):
        self._invalidate_quantized()
        return super().load_weights(directory, tag)

    def transfer_weights_from(self, other):
        self._invalidate_quantized()
        return super().transfer_weights_from(other)

    def predict(self, x, batch_size: int = 32):
        if parse_quantize_name(self.hyper["model_name"])[1]:
            if self._quantized_net is None:
                self._set_quantized(self.quantize())
            return self._quantized_net.predict(x, batch_size)
        return super().predict(x, batch_size)


def register_zoo_model(cls):
    """Make ``cls`` loadable by ``load_model`` (every ZooModel subclass
    registers when it is defined; this names it for readers)."""
    _MODEL_CLASSES[cls.__name__] = cls
    return cls
