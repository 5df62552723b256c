"""ONNX model → a port layer (``OnnxNet``) and the loader entry points.

Counterpart of ``analytics_zoo_tpu/pipeline/api/onnx/onnx_loader.py``: the
whole graph becomes one torch function (:class:`.converter.OnnxGraph`)
wrapped as a :class:`~analytics_zoo_tpu_torch.core.module.Layer`, so an
imported model composes with the port's layers and fine-tunes through
autograd: its float initializers are the layer's parameters.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ....core.module import RandomLayer, make_generator, register_layer
from .converter import OnnxGraph
from .proto import ModelProto, load_model


class GraphParams(RandomLayer):
    """A layer over a converted graph function whose named arrays are its
    parameters.  Graph names may hold any character (``conv.weight``), so
    each is registered as ``p<i>`` and :meth:`params` gives them back by
    their graph names.  Random graph nodes draw from the layer's
    generator in training (``RandomLayer``)."""

    def _set_params(self, values: Dict[str, np.ndarray], device,
                    trainable: bool = True):
        self._param_names = list(values)
        for i, (name, v) in enumerate(values.items()):
            t = torch.as_tensor(np.array(v), device=device)
            self.register_parameter(
                f"p{i}", nn.Parameter(t, requires_grad=trainable
                                      and t.is_floating_point()))

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, f"p{i}")
                for i, n in enumerate(self._param_names)}

    def _predict_batches(self, x, batch_per_thread: int):
        """numpy outputs of the forward over ``x`` in batches, eval mode,
        no gradients (one array, or a list for several outputs)."""
        xs = x if isinstance(x, (tuple, list)) else (x,)
        device = self.device
        outs = []
        was = self.training
        self.eval()
        try:
            with torch.no_grad():
                for i in range(0, len(xs[0]), batch_per_thread):
                    batch = [torch.as_tensor(np.asarray(a[i:i + batch_per_thread]),
                                             device=device) for a in xs]
                    out = self(batch if len(batch) > 1 else batch[0])
                    out = out if isinstance(out, tuple) else (out,)
                    outs.append([o.detach().cpu().numpy() for o in out])
        finally:
            self.train(was)
        cat = [np.concatenate([o[j] for o in outs])
               for j in range(len(outs[0]))]
        return cat[0] if len(cat) == 1 else cat

    @property
    def device(self) -> torch.device:
        for p in self.parameters():
            return p.device
        return self._device


@register_layer
class OnnxNet(GraphParams):
    """An imported ONNX model as a layer of the port, on ``device``
    (``"cuda"`` unless asked otherwise)."""

    def __init__(self, path: Optional[str] = None,
                 model: Optional[ModelProto] = None,
                 name: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name=name, generator=generator)
        if model is None:
            model = load_model(path)
        self._path = path
        if model.graph is None:
            raise ValueError("ONNX model has no graph")
        self.fn = OnnxGraph(model.graph)
        self.opset = max((o.version for o in model.opset_import
                          if o.domain in ("", "ai.onnx")), default=13)
        gen = make_generator(device, generator)
        self._device = gen.device
        self._set_params(self.fn.initial_params, gen.device)
        self.build(None, gen)

    def forward(self, inputs):
        xs = inputs if isinstance(inputs, (tuple, list)) else (inputs,)
        outs = self.fn(self.params(), *xs,
                       rng=self.generator if self.training else None,
                       training=self.training, device=self.device)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape[0], (tuple, list)) \
            else [input_shape]
        with torch.no_grad():
            dummies = [torch.zeros((2,) + tuple(s[1:]), device="meta")
                       for s in shapes]
            params = {k: torch.empty(np.shape(v), device="meta")
                      for k, v in self.fn.initial_params.items()}
            out = self.fn(params, *dummies, device="meta")
        outs = [(None,) + tuple(o.shape[1:]) for o in out]
        return outs[0] if len(outs) == 1 else outs

    def predict(self, x, batch_per_thread: int = 32):
        """Forward ``x`` (numpy, or a list of arrays for several inputs)
        in batches, in eval mode; numpy out."""
        return self._predict_batches(x, batch_per_thread)


class OnnxLoader:
    """Reference-parity entry: load an ONNX model."""

    @staticmethod
    def from_path(path: str, device=None) -> OnnxNet:
        return OnnxNet(path=path, device=device)

    @staticmethod
    def from_bytes(data: bytes, device=None) -> OnnxNet:
        return OnnxNet(model=load_model(data), device=device)


def load_onnx(path: str, device=None) -> OnnxNet:
    """Load an ``.onnx`` file as an :class:`OnnxNet` layer on ``device``
    (``"cuda"`` unless asked otherwise)."""
    return OnnxNet(path=path, device=device)
