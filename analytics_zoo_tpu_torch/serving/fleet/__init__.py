"""Fleet serving: N supervised worker processes behind a router.

Counterpart of ``analytics_zoo_tpu/serving/fleet/`` with the same
module, class and function names, op names, envelope keys, artifact
layout, metric families (``zoo_fleet_*``), log events and span phases.
Each worker is the whole single-process data plane (``ModelRegistry``
with its bucketed forwards, coalescer, admission and decode engines)
behind a localhost frame protocol; the router spreads load
least-outstanding-work weighted by residency, retries a worker death
mid-request once on a sibling, and deploys by persisting ONE artifact
and activating it worker by worker, warm before the swap, every worker
after the first loading its kernels from the shared store.

* :mod:`.protocol`: the length-prefixed CRC-framed envelope codec
  (JSON and binary payloads), byte for byte the JAX package's;
* :mod:`.artifact`: the committed deploy artifact on the share;
* :mod:`.builders`: reference artifact builders (mlp, lm, stub);
* :mod:`.worker`: the worker process (``python -m ...fleet.worker``);
* :mod:`.supervisor`: per-worker crash restart, watchdog, postmortem;
* :mod:`.router`: scheduling, fan-out, the elastic pool, fleet metrics.
"""

from . import artifact, builders, protocol
from .router import FleetRouter, WorkerUnavailable, fleet_autoscaler
from .supervisor import FleetSupervisor

__all__ = ["FleetRouter", "FleetSupervisor", "WorkerUnavailable",
           "fleet_autoscaler", "artifact", "builders", "protocol"]
