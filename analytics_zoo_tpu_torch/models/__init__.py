from .common import ZooModel
from .jax_params import from_jax_params, to_jax_params
from .textgeneration import TransformerLM

__all__ = ["TransformerLM", "ZooModel", "from_jax_params", "to_jax_params"]
