"""ZooModel: base of the port's model zoo.

Counterpart of ``analytics_zoo_tpu/models/common.py``: a model of the
zoo is a :class:`KerasNet` (compile/fit/evaluate/predict) holding its
hyperparameters, a name and the config they give.  Here the subclass
builds its layers in ``__init__`` and defines ``forward``; the JAX
package's ``build_model`` graph has no counterpart yet.  A subclass
registers with ``load_model``, which rebuilds it from its saved hyper
parameters."""

from __future__ import annotations

from typing import Optional

from ..pipeline.api.keras.engine import _MODEL_CLASSES, KerasNet


class ZooModel(KerasNet):
    def __init__(self, name: Optional[str] = None, **hyper):
        super().__init__(name=name or type(self).__name__.lower())
        self.hyper = hyper

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _MODEL_CLASSES[cls.__name__] = cls

    @classmethod
    def from_config(cls, config, device=None):
        model = cls(name=config["name"], device=device, **config["hyper"])
        model._compile_args = config.get("compile_args")
        return model

    def get_config(self) -> dict:
        return {"name": self.name, "hyper": dict(self.hyper),
                "compile_args": self._compile_args}
