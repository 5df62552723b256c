"""ZooModel: base of the port's model zoo.

Counterpart of ``analytics_zoo_tpu/models/common.py``, reduced to what
the first slice needs: an ``nn.Module`` holding the hyperparameters, a
name and the config they give."""

from __future__ import annotations

from typing import Optional

from torch import nn


class ZooModel(nn.Module):
    def __init__(self, name: Optional[str] = None, **hyper):
        super().__init__()
        self.name = name or type(self).__name__.lower()
        self.hyper = hyper

    def get_config(self) -> dict:
        return {"name": self.name, "hyper": dict(self.hyper)}
