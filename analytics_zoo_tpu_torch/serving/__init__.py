"""Serving control plane: multi-model registry, zero-downtime hot-swap,
admission control & priority-aware load shedding, canary traffic
splitting, replica autoscaling, weight paging for serving density, and a
metrics snapshot API — the lifecycle layer over the
``pipeline.inference`` data plane (bucketed forwards + request
coalescing + replica sets).

Counterpart of ``analytics_zoo_tpu/serving/`` with the same names, error
codes, metric families and span phases, with sharded serving groups
(``ShardGroup``, ``ShardGroupSet``, ``carve_groups``,
``normalize_mesh_spec``), the persistent store (``ExecStore``, which
holds the port's kernel libraries) and the multi-process fleet
(:mod:`.fleet`: ``FleetRouter``, ``FleetSupervisor``, the worker
process and its frame protocol).
"""

from . import execstore, fleet
from .admission import AdmissionController
from .autoscale import Autoscaler, autoscaler_for
from .errors import (ColdStartTimeout, DeadlineExceeded, DeployError,
                     ModelNotFound, Overloaded, ServingError,
                     error_response)
from .execstore import ExecStore
from .metrics import (Counters, LatencyWindow, registry_collector,
                      registry_families)
from .pager import ModelPager, PageRecipe
from .registry import ModelRegistry
from .shardgroup import (ShardGroup, ShardGroupSet, carve_groups,
                         normalize_mesh_spec)

__all__ = [
    "AdmissionController", "Autoscaler", "ColdStartTimeout", "Counters",
    "DeadlineExceeded", "DeployError", "ExecStore", "LatencyWindow",
    "ModelNotFound", "ModelPager", "ModelRegistry", "Overloaded",
    "PageRecipe", "ServingError", "ShardGroup", "ShardGroupSet",
    "autoscaler_for", "carve_groups", "error_response", "execstore",
    "fleet", "normalize_mesh_spec", "registry_collector",
    "registry_families",
]
