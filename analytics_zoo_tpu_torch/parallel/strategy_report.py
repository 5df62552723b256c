"""Sharding-strategy comparison: step time and collective mix per
strategy.

Counterpart of ``analytics_zoo_tpu/parallel/strategy_report.py``: the
same training step (ResNet-50 at 32x32 by default, sgd with momentum)
under each strategy on the current mesh, and per strategy:

* the step's wall time after a warm-up step, ending in a synchronize
  (on the card: a device time; on the CPU: the CPU's);
* the collectives the step made, from the profiler's record of the
  ``c10d`` operators, under the JAX package's HLO names (``all-reduce``,
  ``all-gather``, ...), where the JAX package reads them from the
  compiled HLO;
* the bytes of parameters and optimizer moments each rank holds (the
  fsdp win), and on the card the peak of ``max_memory_allocated``;
* the SwitchMoE layers that ran replicated despite an expert axis.

Run by hand it starts its own world (``--ranks`` processes, gloo with
``--device cpu``) on the mesh {data 2, fsdp 2, tensor 2}::

    python -m analytics_zoo_tpu_torch.parallel.strategy_report --device cpu
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .mesh import device_of
from .report_util import (collective_counts, device_kind, peak_bytes,
                          report_args, reset_peak, run_world)


def compare_strategies(mesh=None,
                       strategies: Sequence[str] = ("replicate", "fsdp",
                                                    "fsdp_tp"),
                       batch: Optional[int] = None, image_size: int = 32,
                       num_classes: int = 16, steps: int = 3,
                       tp_rules=None, model_fn=None) -> Dict:
    """Run a train step under each strategy on ``mesh`` and measure.
    ``model_fn(input_shape=, num_classes=, device=, seed=) -> Model``
    defaults to ResNet-50.  Every rank of the mesh calls this; each feeds
    its rows of one global batch.  Returns {strategy: {...}} with the
    mesh, the global batch and the device."""
    from . import mesh as mesh_lib
    from .placement import StatePlan
    from .sharding import flatten_with_path
    from ..models.jax_params import state_tree
    from ..pipeline.api.keras import objectives, optimizers
    from ..pipeline.api.keras.layers import moe as moe_layer
    from ..train.trainer import TrainState, build_train_step, param_paths

    if model_fn is None:
        from ..models.image.classification import resnet50
        model_fn = resnet50
    mesh = mesh or mesh_lib.get_default_mesh()
    device = device_of(mesh)
    dp = mesh_lib.dp_size(mesh)
    batch = batch or max(dp * 2, 8)
    rng = np.random.default_rng(0)
    x_all = rng.normal(size=(batch, image_size, image_size, 3)).astype(
        np.float32)
    y_all = rng.integers(0, num_classes, batch).astype(np.int32)
    per = batch // dp
    rows = slice(mesh_lib.data_index(mesh) * per,
                 (mesh_lib.data_index(mesh) + 1) * per)
    x = torch.as_tensor(x_all[rows], device=device)
    y = torch.as_tensor(y_all[rows], device=device)
    loss_fn = objectives.get("sparse_categorical_crossentropy")
    report: Dict[str, Dict] = {}
    for strategy in strategies:
        model = model_fn(input_shape=(image_size, image_size, 3),
                         num_classes=num_classes, device=device, seed=0)
        opt = optimizers.get({"name": "sgd", "lr": 1e-2, "momentum": 0.9})
        params = list(model.parameters())
        paths = param_paths(model, params)
        plan = StatePlan(
            model, params, paths, mesh, strategy,
            tp_rules=(tp_rules or {r"fc1000/W": 1})
            if strategy in ("tensor", "tp", "fsdp_tp") else None,
            fsdp_min_size=2 ** 10 if strategy in ("fsdp", "fsdp_tp")
            else 2 ** 14)
        state = TrainState(params, state_tree(model), opt.init(plan.masters),
                           paths=paths, plan=plan)
        step = build_train_step(model, loss_fn, opt, plan=plan)
        moe_layer.clear_fallback_log()
        entry: Dict = {}
        with mesh_lib.active_mesh(mesh):
            # the warm-up step, and its collectives
            _, entry["collectives"] = collective_counts(
                lambda: float(step(state, x, y)))
            reset_peak(device)
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = step(state, x, y)
            float(loss)
            entry["step_ms"] = (time.perf_counter() - t0) / steps * 1e3
        if device.type == "cuda":
            entry["peak_bytes"] = peak_bytes(device)
        entry["per_device_param_bytes"] = int(sum(
            m.numel() * m.element_size() for m in plan.masters))
        moments = flatten_with_path(opt.state_tree(state.opt_state, paths))
        entry["per_device_opt_bytes"] = int(sum(
            t.numel() * t.element_size() for _, t in moments
            if isinstance(t, torch.Tensor)))
        if moe_layer.EXPERT_FALLBACKS:
            entry["moe_fallbacks"] = dict(moe_layer.EXPERT_FALLBACKS)
        report[strategy] = entry
        del model, state, plan
    return {"mesh": mesh_lib.axis_sizes(mesh), "batch": batch,
            "device_kind": device_kind(device), "strategies": report}


def main(argv=None):
    from . import distributed as dist_lib
    args = report_args(argv, 8, "step time and collectives per strategy")
    if not dist_lib.cluster_env_present():
        raise SystemExit(run_world(__name__, args.ranks,
                                   ["--device", args.device]))
    torch.set_num_threads(1)
    from . import mesh as mesh_lib
    n = args.ranks
    axes = ({"data": 2, "fsdp": 2, "tensor": 2} if n == 8
            else {"fsdp": n})
    mesh = mesh_lib.create_mesh(axes, device=args.device)
    out = compare_strategies(mesh)
    if dist_lib.is_coordinator():
        print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
