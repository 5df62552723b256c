from .common import ZooModel
from .image import ImageClassifier
from .jax_params import (from_jax_params, to_jax_params, to_jax_state)
from .textgeneration import TransformerLM

__all__ = ["ImageClassifier", "TransformerLM", "ZooModel",
           "from_jax_params", "to_jax_params", "to_jax_state"]
