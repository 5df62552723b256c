"""Layer: the port's module base.

Counterpart of ``analytics_zoo_tpu/core/module.py``.  There a layer is a
pure ``init``/``apply`` pair over a params dict keyed by parameter name;
here it is an ``nn.Module`` whose parameters carry those same names
(``W``, ``b``, ``embeddings``, ``gamma``, ...) and shapes, so
:meth:`Layer.params` is the JAX package's params dict for the layer.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..common.context import resolve_device
from . import initializers

_LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    """Class decorator: register a layer class by name."""
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


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


class Layer(nn.Module):
    """Base class of the port's layers.  A layer with parameters creates
    them with :meth:`add_param`, on the device of its generator."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or type(self).__name__.lower()

    def add_param(self, name: str, init, shape,
                  generator: torch.Generator) -> nn.Parameter:
        p = nn.Parameter(initializers.get(init)(shape, generator))
        self.register_parameter(name, p)
        return p

    def params(self) -> Dict[str, torch.Tensor]:
        """This layer's own parameters, keyed as the JAX package keys
        them."""
        return dict(self.named_parameters(recurse=False))
