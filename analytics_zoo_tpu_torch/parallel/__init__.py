from .mesh import (create_mesh, data_sharding, replicated, dp_size,
                   get_default_mesh, set_default_mesh)
from . import sharding
from .ring_attention import ring_attention, ring_attention_sharded
from .expert import (MoEParams, init_moe_params, switch_moe, moe_sharded,
                     expert_capacity)
from .pipeline import pipeline_apply
