"""Serving control plane: multi-model registry, zero-downtime hot-swap,
admission control & priority-aware load shedding, canary traffic
splitting, replica autoscaling, weight paging for serving density, and a
metrics snapshot API — the lifecycle layer over the
``pipeline.inference`` data plane (bucketed forwards + request
coalescing + replica sets).

Counterpart of ``analytics_zoo_tpu/serving/`` with the same names, error
codes, metric families and span phases.  Sharded serving groups
(``ShardGroup``, ``ShardGroupSet``, ``carve_groups``,
``normalize_mesh_spec``), the persistent executable store (``ExecStore``)
and the fleet are not ported yet (see ROADMAP.md).
"""

from .admission import AdmissionController
from .autoscale import Autoscaler, autoscaler_for
from .errors import (ColdStartTimeout, DeadlineExceeded, DeployError,
                     ModelNotFound, Overloaded, ServingError,
                     error_response)
from .metrics import (Counters, LatencyWindow, registry_collector,
                      registry_families)
from .pager import ModelPager, PageRecipe
from .registry import ModelRegistry

__all__ = [
    "AdmissionController", "Autoscaler", "ColdStartTimeout", "Counters",
    "DeadlineExceeded", "DeployError", "LatencyWindow", "ModelNotFound",
    "ModelPager", "ModelRegistry", "Overloaded", "PageRecipe",
    "ServingError", "autoscaler_for", "error_response",
    "registry_collector", "registry_families",
]
