"""Trainer: the training loop, on one device or sharded over a mesh.

Counterpart of ``analytics_zoo_tpu/train/trainer.py``:
``build_train_step`` (forward, mean loss plus the regularizers'
penalties, backward, optimizer update), with mixed precision
(``compute_dtype``) and gradient accumulation (``accum_steps``);
``Trainer.fit`` with its epoch/step loop and triggers, ``evaluate`` with
the padded, masked tail, and ``predict``, each fed by a prefetch thread
(``common/prefetch.py``); freezing (a layer's ``trainable`` flag, read at
every step, over an optimizer state that always covers every parameter);
TensorBoard scalars; checkpoints in the JAX package's sharded format and
leaf names (``set_checkpoint`` with an epoch or iteration trigger), with
the resume of a supervised restart (``ZOO_RESUME``: the newest complete
snapshot, then a fast-forward into the epoch) and the supervisor's
heartbeat and fault hooks (``train/faults.py``).  The JAX package
compiles the step with ``jit``; here it runs eagerly, with the model's
parameters updated in place.  Dropout draws from generators seeded from
(seed, step, microbatch, layer) at every step, so a resumed run draws
the masks of the uninterrupted one.

Observability, armed at ``fit`` entry as in the JAX package: the flight
recorder (``ZOO_FLIGHTREC_DIR``: a liveness record a step, the metric
families snapshotted every 16th step at most every 2 s), the step
profiler (``enable_step_profiler`` or ``ZOO_STEP_PROFILE`` /
``ZOO_STEP_TIMELINE``: a span a step over ``data_wait -> h2d ->
grad_accum -> step_compute -> ckpt_save``, the upload and the
microbatch split timed on the prefetch thread) and one ``torch.profiler``
trace a fit (``set_tensorboard(..., profile=True)``).  Absent, each costs
one ``None`` check a step; present, none reads anything back from the
device.

Sharded training (``mesh=``, ``strategy=``, ``tp_rules=``; the strategy
falls back to ``ZOO_TRAIN_STRATEGY``): one process a device, each rank
of the mesh running the step on its own rows.  ``batch_size`` is the
GLOBAL batch; each rank feeds ``batch_size // dp_size(mesh)`` rows of
its own data (the rows of its data shard, ``mesh.data_index``; ranks
that differ only on the other axes feed the same rows).  The parameters
and the optimizer's moments are placed by the rule tables
(``parallel/placement.py``): gradients are averaged over the data axes,
the update runs on each rank's blocks, and the module's tensors are
refilled from them.  ``evaluate`` and ``predict`` round the per-rank
batch and mask the filler rows as the JAX package does, the metrics
added over the data axes; ``save_weights`` writes each rank's own
blocks in the JAX package's sharded format and ``load_weights`` places a
snapshot of any mesh shape under this trainer's plan.  In a pod of
several processes a Trainer with no mesh trains data-parallel over every
rank, as the JAX package's default mesh does.  A model's layer state
(BatchNormalization's moving statistics) is computed from the global
batch's statistics, all-reduced over the data axes while the plan splits
the batch, so every rank holds the same state and rank 0's save is the
pod's.  SwitchMoE routes the global batch the same way.

Losses stay on the device during an epoch and are read back in one
transfer at its end, as in the JAX package: a step makes no host sync.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from .. import envcontract
from ..common.prefetch import DeviceFeed, prefetch
from ..common.utils import pad_leading
from ..core.module import RandomLayer
from ..data.dataset import Dataset
from ..observability import flightrec
from ..observability import trace as trace_lib
from ..observability.log import get_logger
from ..parallel import distributed as dist_lib
from ..parallel import mesh as mesh_lib
from ..pipeline.api.keras import metrics as metrics_lib
from ..pipeline.api.keras.objectives import _batch_mean
from ..pipeline.api.keras.regularizers import collect_penalties
from . import checkpoint as checkpoint_lib
from . import faults
from . import metrics as train_metrics
from . import stepprof
from . import triggers as trigger_lib
from .summary import TrainSummary, ValidationSummary

#: deployment-wide defaults of the accumulation factor and the compute
#: dtype (the JAX package's env-contract knobs); arguments win
ENV_ACCUM = "ZOO_TRAIN_ACCUM"
ENV_DTYPE = "ZOO_TRAIN_DTYPE"
ENV_STRATEGY = "ZOO_TRAIN_STRATEGY"

_log = get_logger("analytics_zoo_tpu_torch.train")


def _accum_from_env() -> int:
    """``ZOO_TRAIN_ACCUM`` as an int; unset, empty or not a number: 1."""
    return envcontract.env_int(ENV_ACCUM, 1)


def _dtype_from_env() -> Optional[torch.dtype]:
    """``ZOO_TRAIN_DTYPE`` as a compute dtype (None: full f32).  An
    unknown name trains in f32 with a warning, as in the JAX package:
    an operator's typo must not stop a worker."""
    name = (envcontract.env_str(ENV_DTYPE) or "").strip().lower()
    if not name:
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    if name in ("f16", "fp16", "float16"):
        return torch.float16
    if name not in ("f32", "fp32", "float32"):
        warnings.warn(f"unknown {ENV_DTYPE}={name!r}: training in full f32",
                      stacklevel=3)
    return None


def _to_host(y):
    if isinstance(y, (list, tuple)):
        return [t.cpu() for t in y]
    return y.cpu()


def _model_device(model) -> torch.device:
    p = next(model.parameters(), None)
    return p.device if p is not None else torch.device(model.device)


def _cast_floating(x, dtype):
    """Floating tensors of ``x`` (a tensor or a list/tuple of them) at
    ``dtype``; integer ones (token ids) as they are."""
    if isinstance(x, (tuple, list)):
        return type(x)(_cast_floating(t, dtype) for t in x)
    return x.to(dtype) if x.is_floating_point() else x


class _Microbatches(tuple):
    """A batch already split into its microbatches (on the host, by the
    step profiler's prefetch transform): :func:`_split` takes it as it
    is."""


def _split_host(batch, accum: int):
    """:func:`_split` of a host batch (numpy arrays, or a tuple or list
    of them): ``accum`` tuples of row views."""
    if isinstance(batch, (tuple, list)):
        parts = [_split_host(b, accum) for b in batch]
        return tuple(type(batch)(p[i] for p in parts) for i in range(accum))
    batch = np.asarray(batch)
    if batch.shape[0] % accum:
        raise ValueError(f"batch ({batch.shape[0]}) must divide "
                         f"accum_steps ({accum})")
    return tuple(np.split(batch, accum))


def _split(batch, accum: int):
    """``accum`` equal microbatches of a batch (a tensor or a tuple or
    list of tensors): row views, microbatch i the i-th run of rows, as
    the JAX package's (accum, micro, ...) reshape."""
    if isinstance(batch, _Microbatches):
        return list(batch)
    if isinstance(batch, (tuple, list)):
        parts = [_split(b, accum) for b in batch]
        return [type(batch)(p[i] for p in parts) for i in range(accum)]
    if batch.shape[0] % accum:
        raise ValueError(f"batch ({batch.shape[0]}) must divide "
                         f"accum_steps ({accum})")
    return list(batch.chunk(accum))


def _sum_over(group, tree):
    """``tree`` (nested dicts, lists and tuples of numbers and tensors)
    with every leaf added over the ranks of ``group``: one all-reduce of
    the leaves flattened in f64; each leaf keeps its type."""
    import torch.distributed as dist
    from ..parallel.sharding import flatten_with_path, unflatten
    leaves = [l for _, l in flatten_with_path(tree)]
    device = next((l.device for l in leaves
                   if isinstance(l, torch.Tensor)), torch.device("cpu"))
    if dist.get_backend(group) == "nccl" and device.type != "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    flat = torch.cat([torch.as_tensor(l, dtype=torch.float64,
                                      device=device).reshape(-1)
                      for l in leaves])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for l in leaves:
        if isinstance(l, torch.Tensor):
            out.append(flat[at:at + l.numel()].view(l.shape).to(
                l.dtype).to(l.device))
            at += l.numel()
        else:
            out.append(float(flat[at]))
            at += 1
    return unflatten(tree, out)


class TrainState:
    """Every parameter of the model (its own tensors, updated in place;
    frozen ones too, so that freezing never changes the optimizer
    state's layout), the model's state (its stateful layers' buffers,
    as the JAX package's ``model_state`` tree: {layer: {name: tensor}};
    the layers update them in place in training mode), the optimizer
    state and the step and epoch counters.  ``paths`` is each
    parameter's key path in the params tree."""

    def __init__(self, params, model_state, opt_state, step: int = 0,
                 epoch: int = 0, paths=None, plan=None):
        self.params = params
        self.model_state = model_state
        self.opt_state = opt_state
        self.step = step
        self.epoch = epoch
        self.paths = paths
        #: the mesh placement (``parallel.placement.StatePlan``) of a
        #: sharded trainer: the optimizer updates its masters
        self.plan = plan


def param_paths(model, params) -> List[tuple]:
    """Each of ``params``' key path in the model's params tree (the
    JAX package's ``{layer: {name: ...}}``, one level more per nested
    model)."""
    from ..models.jax_params import weight_tree
    where = {}

    def walk(tree, prefix):
        for key, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, prefix + (key,))
            else:
                where[id(sub)] = prefix + (key,)

    walk(weight_tree(model), ())
    missing = [i for i, p in enumerate(params) if id(p) not in where]
    if missing:
        raise ValueError(f"parameters {missing} of the model are in no "
                         "layer's params tree")
    return [where[id(p)] for p in params]


def build_train_step(model, loss_fn, optimizer, compute_dtype=None,
                     accum_steps: int = 1, seed: int = 0, plan=None):
    """The training iteration: forward in training mode, the mean of the
    per-sample loss plus the penalties of the regularized layers,
    gradients by ``torch.autograd.grad`` (nothing is left in ``.grad``)
    for the parameters whose layer is trainable (zeros for the rest),
    and the optimizer's in-place update, which leaves frozen parameters
    where they are.

    ``compute_dtype`` (mixed precision, as the JAX package's
    ``build_train_step``): inside the differentiated function every
    floating parameter and input is cast to it, the model runs on those
    copies (``torch.func.functional_call``), and its output is cast to
    f32 before the loss; gradients return in f32 through the casts'
    backward, so the master weights and the optimizer's state stay f32.

    Every step reseeds the random layers' generators (dropout and
    every noise layer) from (``seed``, step, microbatch, layer), as the
    JAX package draws from ``fold_in(rng, step)``: the masks of a step
    do not depend on what the process drew before, so a run resumed at
    step k draws what the uninterrupted run drew there.

    ``accum_steps > 1``: the batch splits into that many equal
    microbatches; their gradients sum in f32 and scale by 1/accum, the
    loss is the mean of theirs, and microbatch i draws from generators
    seeded with i.  The microbatches run in
    turn, so microbatch i+1 sees the layer state (BatchNormalization's
    moving statistics) that microbatch i left, as the JAX package's scan
    carries it.  ``accum_steps == 1`` is the single-shot step.

    Under ``compute_dtype`` the layers' state stays f32 and is updated in
    place on the model's own buffers (``functional_call`` is given the
    parameters only).

    ``plan`` (a ``parallel.placement.StatePlan``): the sharded step.
    The layers that compute on tensor-axis blocks take them through
    ``functional_call``; the gradients are averaged over the data axes
    and cut to the masters' blocks, which the optimizer updates (its
    norms counted over the whole leaves), and the module's tensors are
    refilled from them.  The loss returned is the global batch's.  While
    the plan splits the batch over the data axes, the layers that depend
    on the whole batch (BatchNormalization's statistics, SwitchMoE's
    routing) reduce over those ranks (``parallel.mesh.batch_split``).

    Returns ``step(state, x, y) -> loss``, a device scalar."""
    accum = max(int(accum_steps), 1)
    names = [n for n, _ in model.named_parameters()]
    # the data axes' group while the plan splits the batch: BatchNorm's
    # statistics and SwitchMoE's routing are then the global batch's
    split = plan.dp_group if plan is not None else None
    dropouts = [m for m in model.modules() if isinstance(m, RandomLayer)]

    def forward_loss(params, x, y, overrides=()):
        with collect_penalties() as penalties:
            if compute_dtype is None:
                y_pred = (functional_call(
                    model, {names[i]: params[i] for i in overrides}, (x,))
                    if overrides else model(x))
            else:
                copies = {n: p.to(compute_dtype) if p.is_floating_point()
                          else p for n, p in zip(names, params)}
                y_pred = functional_call(
                    model, copies, (_cast_floating(x, compute_dtype),))
                y_pred = _cast_floating(y_pred, torch.float32)
            loss = torch.mean(loss_fn(y, y_pred))
        penalty = penalties.total()
        return loss if penalty is None else loss + penalty

    def gradients(loss, params, trainable):
        live = [p for p, t in zip(params, trainable) if t]
        got = iter(torch.autograd.grad(loss, live, allow_unused=True)
                   if live else ())
        grads = []
        for p, t in zip(params, trainable):
            g = next(got) if t else None
            grads.append(torch.zeros_like(p) if g is None else g)
        return grads

    def seed_dropout(step: int, micro: int):
        for k, layer in enumerate(dropouts):
            layer.generator.manual_seed(
                hash((seed, step, micro, k)) & (2 ** 63 - 1))

    def train_step(state: TrainState, x, y):
        trainable = [p.requires_grad for p in state.params]
        use = plan.use_tensors() if plan is not None else {}
        params = [use.get(i, p) for i, p in enumerate(state.params)]
        was_training = model.training
        model.train()
        scope = (plan.tensor_layers if plan is not None
                 else contextlib.nullcontext)
        try:
            # the backward too runs under the plan's layer scope and the
            # batch split: a remat layer recomputes its forward there
            if accum == 1:
                seed_dropout(state.step, 0)
                with scope(), mesh_lib.batch_split(split):
                    loss = forward_loss(params, x, y, use)
                    grads = gradients(loss, params, trainable)
            else:
                grads = loss = None
                for i, (xi, yi) in enumerate(zip(_split(x, accum),
                                                 _split(y, accum))):
                    seed_dropout(state.step, i)
                    with scope(), mesh_lib.batch_split(split):
                        mloss = forward_loss(params, xi, yi, use)
                        g = gradients(mloss, params, trainable)
                    if grads is None:
                        grads, loss = g, mloss.detach()
                    else:
                        grads = [a + b for a, b in zip(grads, g)]
                        loss = loss + mloss.detach()
                grads = [g * (1.0 / accum) for g in grads]
                loss = loss * (1.0 / accum)
        finally:
            model.train(was_training)
        frozen = [not t for t in trainable]
        if plan is None:
            optimizer.apply(state.params, grads, state.opt_state,
                            frozen=frozen)
            return loss.detach()
        optimizer.apply(plan.masters, plan.reduce_grads(grads),
                        state.opt_state, frozen=frozen,
                        sq_sums=plan.sq_sums)
        plan.refresh_module()
        return plan.mean_loss(loss.detach())

    return train_step


def _max_over(group, n: int) -> int:
    """The largest of the ranks' ``n`` over ``group``."""
    import torch.distributed as dist
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def _rank_batches(ds: Dataset, batch_size: int, group=None):
    """``ds``'s batches of ``batch_size`` rows in order (the tail at its
    own size) and the list of their row counts.  Under ``group`` (the
    data axes' group while the plan splits the batch) every rank runs as
    many batches, the most any rank has, a rank with fewer going on with
    batches of no rows, so that the collectives of the layers that see
    the whole batch (BatchNorm's statistics, SwitchMoE's routing) pair
    up across the ranks.  The count is agreed here, on the calling
    thread, before a prefetch thread takes the batches."""
    n = ds.size
    steps = -(-n // batch_size)
    total = steps if group is None else _max_over(group, steps)
    rows = [min(batch_size, max(n - i * batch_size, 0))
            for i in range(total)]

    def batches():
        yield from ds.batches(batch_size, shuffle=False,
                              drop_remainder=False)
        none = np.arange(0)
        for _ in range(total - steps):
            yield Dataset._index(ds.x, none), Dataset._index(ds.y, none)

    return batches(), rows


def _first_rows(y, n: int):
    if isinstance(y, list):
        return [t[:n] for t in y]
    return y[:n]


def predict_batches(model, x, batch_size: int = 32, group=None):
    """Forward ``x`` (an array or a Dataset) in batches of ``batch_size``
    without gradients or dropout, fed by a prefetch thread; returns numpy
    (a list of arrays for a model of several outputs).  The tail batch
    runs at its own size (an eager step needs no fixed shape).  Under
    ``group`` (``Trainer.predict`` while its plan splits the batch) every
    rank runs as many batches (:func:`_rank_batches`), each zero-padded
    to ``batch_size`` as the JAX package pads its tail to the compiled
    shape, so the global batch the layers reduce over is the JAX
    package's; the padded rows' outputs are dropped."""
    ds = x if isinstance(x, Dataset) else Dataset.from_ndarray(x)
    if ds.size == 0:
        raise ValueError("predict called with an empty dataset")
    batches, rows = _rank_batches(ds, batch_size, group)
    inputs = ((bx for bx, _ in batches) if group is None else
              (pad_leading(bx, batch_size - n)
               for (bx, _), n in zip(batches, rows)))
    feed = DeviceFeed(_model_device(model))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), prefetch(inputs, transform=feed) as items:
            out = [_to_host(model(feed.ready(item))) for item in items]
    finally:
        model.train(was_training)
    if group is not None:
        out = [_first_rows(o, n) for o, n in zip(out, rows)]
    if isinstance(out[0], list):  # a model of several outputs
        return [torch.cat([o[i] for o in out]).numpy()
                for i in range(len(out[0]))]
    return torch.cat(out).numpy()


class Trainer:
    """Trainer of an ``nn.Module`` whose ``forward`` maps a
    batch to predictions; ``loss_fn(y_true, y_pred)`` gives per-sample
    (or per-position) losses; ``optimizer`` is a
    :class:`~analytics_zoo_tpu_torch.pipeline.api.keras.optimizers.
    ZooOptimizer`.  ``seed`` orders the shuffled batches and seeds the
    microbatches' dropout.  ``compute_dtype`` (e.g. ``torch.bfloat16``)
    trains in mixed precision and ``accum_steps`` > 1 splits every batch
    into that many microbatches (:func:`build_train_step`); either falls
    back to its environment knob (``ZOO_TRAIN_DTYPE``,
    ``ZOO_TRAIN_ACCUM``) when not given.  ``evaluate`` and ``predict``
    run in f32 and in eval mode (BatchNormalization on its moving
    statistics).

    ``mesh`` (a ``DeviceMesh`` of ``parallel.mesh.create_mesh``),
    ``strategy`` (``replicate`` | ``fsdp`` | ``tp`` | ``fsdp_tp``, else
    ``ZOO_TRAIN_STRATEGY``, else ``replicate``) and ``tp_rules`` (leaf
    path regex -> the dimension split over ``tensor``) train sharded (see
    the module docstring)."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 metrics: Sequence = (), seed: int = 0,
                 compute_dtype=None, accum_steps: Optional[int] = None,
                 mesh=None, strategy: Optional[str] = None,
                 tp_rules: Optional[Dict[str, int]] = None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.metrics = list(metrics)
        self.seed = seed
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else _dtype_from_env())
        self.accum_steps = max(int(accum_steps) if accum_steps is not None
                               else _accum_from_env(), 1)
        self.mesh = mesh
        self.strategy = strategy or envcontract.env_str(ENV_STRATEGY,
                                                        "replicate")
        self.tp_rules = dict(tp_rules) if tp_rules else None
        self.state: Optional[TrainState] = None
        self._train_step = None

    def ensure_initialized(self):
        if self.state is None:
            from ..models.jax_params import state_tree
            device = _model_device(self.model)
            dist_lib.maybe_initialize_distributed(device)
            if self.mesh is None and dist_lib.process_count() > 1:
                # a pod trains data-parallel, as the JAX package's default
                # mesh puts every device on ``data``
                self.mesh = mesh_lib.get_default_mesh(device)
            params = list(self.model.parameters())
            paths = param_paths(self.model, params)
            plan = None
            if self.mesh is not None:
                from ..parallel.placement import StatePlan
                plan = StatePlan(self.model, params, paths, self.mesh,
                                 self.strategy, tp_rules=self.tp_rules)
            self.state = TrainState(
                params, state_tree(self.model),
                self.optimizer.init(plan.masters if plan else params),
                paths=paths, plan=plan)

    def _dp(self) -> int:
        return mesh_lib.dp_size(self.mesh) if self.mesh is not None else 1

    def _split_group(self):
        """The data axes' group while the plan splits the batch, else
        None (``parallel.mesh.batch_split``)."""
        plan = self.state.plan if self.state is not None else None
        return plan.dp_group if plan is not None else None

    def _rank_batch(self, batch_size: int) -> int:
        """The rows a rank feeds of a global batch in evaluate and
        predict (at least 1)."""
        return max(batch_size // self._dp(), 1)

    def refresh_optimizer(self):
        """Take up changed ``trainable`` flags (the JAX package re-masks
        its optimizer here).  The step reads the flags at every call and
        the optimizer state covers every parameter, frozen or not, so
        nothing is rebuilt and the statistics stay as they are:
        still-training layers keep their moments bit for bit."""

    def _maybe_auto_resume(self):
        """The supervised restart: under ``ZOO_RESUME`` a checkpointing
        fit restores the newest complete snapshot before it trains.  No
        complete snapshot, or one that cannot be read (a crash during
        the first save leaves a directory without commits): a cold
        start, never a raise, or every resumed incarnation would crash
        in turn.  An explicit ``load_weights`` still raises."""
        if (self._ckpt_path is None or not faults.resume_requested()
                or self._auto_resumed or self.state.step
                or self.state.epoch):
            return
        self._auto_resumed = True
        try:
            self.load_weights(self._ckpt_path)
        except FileNotFoundError:
            train_metrics.record_ckpt_restore("cold_start")
            _log.warning("ZOO_RESUME set but no complete checkpoint found: "
                         "cold start", path=self._ckpt_path)
            return
        except Exception as e:
            train_metrics.record_ckpt_restore("cold_start")
            _log.error("ZOO_RESUME restore failed: cold start",
                       path=self._ckpt_path,
                       error=f"{type(e).__name__}: {e}")
            return
        _log.info("resumed from checkpoint", path=self._ckpt_path,
                  epoch=self.state.epoch, step=self.state.step,
                  epoch_step=self._resume_epoch_step)

    def _iteration_checkpoint(self, epoch_step: int):
        st = self.state
        save = (checkpoint_lib.save_sharded if faults.sync_checkpoints()
                else checkpoint_lib.async_save_sharded)
        save(self._ckpt_path, st.step, self.state_tree(),
             meta={"step": st.step, "epoch": st.epoch,
                   "epoch_step": epoch_step})

    def fit(self, dataset: Dataset, batch_size: int, end_trigger=None,
            validation_data: Optional[Dataset] = None,
            validation_trigger=None, validation_batch_size: int = None,
            shuffle: bool = True, verbose: bool = False) -> Dict[str, List]:
        """Run the loop until ``end_trigger`` fires (default: one more
        epoch).  Successive calls continue the epoch count.  Returns
        ``{"loss": [per-step losses], "val": [per-epoch results]}``.
        With a checkpoint directory, ``fit`` returns once its snapshots
        are on disk."""
        device = _model_device(self.model)
        self.ensure_initialized()
        if self.state.plan is not None:
            # weights set on the model since the last step reach the
            # masters (a no-op when they are the last step's)
            self.state.plan.pull_module()
        from ..data.dataset import check_batch_divisibility
        check_batch_divisibility(batch_size, self._dp())
        batch_size //= self._dp()  # this rank's rows of the global batch
        if batch_size % self.accum_steps:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by "
                f"accum_steps ({self.accum_steps}): every microbatch has "
                "the same size")
        faults.refresh()
        faults.heartbeat()
        # the flight recorder (the black box the supervisor harvests) and
        # the step profiler arm from the env contract; absent, each costs
        # one None check a step
        recorder = flightrec.install_from_env()
        prof = self._step_profiler
        if prof is None:
            prof = self._step_profiler = stepprof.from_env()
        if recorder is not None:
            # add_collector keys by function: wiring at every fit is free
            # and follows a recorder replaced between fits
            recorder.add_collector(train_metrics.train_families)
            if prof is not None:
                recorder.add_collector(prof.families)
        self._maybe_auto_resume()
        # an iteration-trigger snapshot lands mid-epoch: skip the batches
        # the restored position already consumed (the epoch's order is
        # fixed by (seed, epoch)), so the replayed steps are the
        # uninterrupted run's
        resume_skip = int(self._resume_epoch_step or 0)
        self._resume_epoch_step = 0
        if self._train_step is None:
            self._train_step = build_train_step(
                self.model, self.loss_fn, self.optimizer,
                compute_dtype=self.compute_dtype,
                accum_steps=self.accum_steps, seed=self.seed,
                plan=self.state.plan)
        with mesh_lib.active_mesh(self.mesh):
            return self._fit(dataset, batch_size, end_trigger,
                             validation_data, validation_trigger,
                             validation_batch_size, shuffle, verbose,
                             resume_skip, device, recorder, prof)

    def _start_profile(self, device):
        """The fit's ``torch.profiler`` trace when ``set_tensorboard``
        asked for one (None otherwise, or when it cannot start: tracing
        is best effort)."""
        if self._profile_dir is None:
            return None
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        run = os.path.join(self._profile_dir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(run))
            prof.start()
        except Exception as e:
            _log.warning("could not start the torch.profiler trace",
                         error=f"{type(e).__name__}: {e}")
            return None
        return prof

    def _stop_profile(self, device):
        """Stop and write the fit's trace, if one is running."""
        profiler, self._live_profile = self._live_profile, None
        if profiler is None:
            return
        try:
            if device.type == "cuda":
                # the trace covers the device work of the steps it took
                torch.cuda.synchronize(device)
            profiler.stop()
        except Exception as e:
            _log.warning("could not write the torch.profiler trace",
                         error=f"{type(e).__name__}: {e}")

    def _profiled_feed(self, feed):
        """The prefetch transform of a profiled fit: the batch's split
        into microbatches (under accumulation) and its upload, each timed
        on the prefetch thread and shipped with the batch."""
        accum = self.accum_steps

        def put(batch):
            accum_s = 0.0
            if accum > 1:
                t0 = time.perf_counter()
                batch = tuple(_split_host(b, accum) for b in batch)
                accum_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = feed(batch)
            return out, time.perf_counter() - t0, accum_s

        return put

    def _fit(self, dataset, batch_size, end_trigger, validation_data,
             validation_trigger, validation_batch_size, shuffle, verbose,
             resume_skip, device, recorder, prof):
        self._live_profile = self._start_profile(device)
        try:
            return self._fit_loop(
                dataset, batch_size, end_trigger, validation_data,
                validation_trigger, validation_batch_size, shuffle,
                verbose, resume_skip, device, recorder, prof,
                self.state.step + self._profile_steps)
        finally:
            # the trace stops even when fit raises mid-epoch
            self._stop_profile(device)
            if prof is not None:
                prof.flush(recorder)  # the buffered step entries
                try:
                    prof.write_timeline()
                except OSError as e:
                    _log.warning("could not write the step timeline",
                                 path=prof.timeline_path,
                                 error=f"{type(e).__name__}: {e}")
            if recorder is not None:
                recorder.snapshot_metrics(force=True)

    def _fit_loop(self, dataset, batch_size, end_trigger, validation_data,
                  validation_trigger, validation_batch_size, shuffle,
                  verbose, resume_skip, device, recorder, prof,
                  profile_end):
        st = self.state
        feed = DeviceFeed(device)
        transform = feed if prof is None else self._profiled_feed(feed)
        micro = prof is not None and self.accum_steps > 1
        end_trigger = end_trigger or trigger_lib.MaxEpoch(st.epoch + 1)
        validation_trigger = validation_trigger or trigger_lib.EveryEpoch()
        ckpt_trigger = self._ckpt_trigger or trigger_lib.EveryEpoch()
        per_epoch_ckpt = isinstance(ckpt_trigger, trigger_lib.EveryEpoch)
        lr_fn = getattr(self.optimizer, "lr_fn", None)
        history: Dict[str, List] = {"loss": [], "val": []}
        stop = False
        while not (stop or end_trigger({"epoch": st.epoch,
                                        "iteration": st.step})):
            epoch_losses = []
            epoch_start = time.perf_counter()
            epoch_start_step = st.step - resume_skip
            batches = dataset.batches(batch_size, shuffle=shuffle,
                                      seed=self.seed, epoch=st.epoch)
            if resume_skip:
                batches = itertools.islice(batches, resume_skip, None)
                resume_skip = 0
            with prefetch(batches, transform=transform) as items:
                for item in (items if prof is None
                             else prof.timed_iter(items)):
                    if prof is None:
                        bx, by = feed.ready(item)
                        span = None
                    else:
                        item, h2d_s, accum_s = item
                        bx, by = feed.ready(item)
                        if micro:
                            bx, by = _Microbatches(bx), _Microbatches(by)
                        span = prof.begin_step(st.step + 1, h2d_s,
                                               accum_s=accum_s)
                    if span is None:
                        loss = self._train_step(st, bx, by)
                    else:
                        # active across the step, so a compile-like event
                        # (a kernel build) lands on the step that paid it
                        span.phase_start("step_compute")
                        with trace_lib.activate(span):
                            loss = self._train_step(st, bx, by)
                        span.phase_end()
                    st.step += 1
                    faults.heartbeat()
                    train_metrics.record_step()
                    if recorder is not None:
                        # the liveness record before the fault hook: a
                        # crash at step k leaves step k's record (the
                        # postmortem's last completed step)
                        recorder.record_step(st.step)
                        if not st.step & 15:
                            # the snapshot's own throttle is seconds; the
                            # check itself runs every 16th step
                            recorder.snapshot_metrics()
                    # an injected fault lands before the checkpoint: a
                    # crash at step k never leaves a tag k
                    faults.maybe_fault(st.step)
                    epoch_losses.append(loss)
                    if self._live_profile is not None \
                            and st.step >= profile_end:
                        self._stop_profile(device)
                    record = {"epoch": st.epoch, "iteration": st.step,
                              "loss": loss}
                    if self._ckpt_path and not per_epoch_ckpt \
                            and ckpt_trigger(record):
                        if span is not None:
                            span.phase_start("ckpt_save")
                        self._iteration_checkpoint(st.step
                                                   - epoch_start_step)
                        if span is not None:
                            span.phase_end()
                    if span is not None:
                        prof.finish_step(span, st.step)
                    if end_trigger(record):
                        stop = True
                        break
            st.epoch += 1
            # one transfer for the epoch's losses
            losses = (torch.stack(epoch_losses).cpu().tolist()
                      if epoch_losses else [])
            history["loss"].extend(losses)
            if self.train_summary is not None:
                elapsed = max(time.perf_counter() - epoch_start, 1e-9)
                base = st.step - len(losses)
                for i, lossf in enumerate(losses):
                    self.train_summary.add_scalar("Loss", lossf,
                                                  base + i + 1)
                    if lr_fn is not None:
                        self.train_summary.add_scalar(
                            "LearningRate", float(lr_fn(base + i)),
                            base + i + 1)
                self.train_summary.add_scalar(
                    "Throughput", len(losses) * batch_size * self._dp()
                    / elapsed, st.step)
                self.train_summary.flush()
            epoch_record = {"epoch": st.epoch, "iteration": st.step,
                            "epoch_finished": True,
                            "loss": losses[-1] if losses else None}
            if verbose:
                # a resume that sat on the epoch's end replays no batch
                lossf = epoch_record["loss"]
                print(f"[zoo-torch] epoch {st.epoch} step {st.step} loss "
                      f"{'n/a' if lossf is None else lossf}")
            if validation_data is not None and validation_trigger(
                    epoch_record):
                results = self.evaluate(validation_data,
                                        validation_batch_size
                                        or batch_size * self._dp())
                history["val"].append({"epoch": st.epoch, **results})
                if self.val_summary is not None:
                    for k, v in results.items():
                        self.val_summary.add_scalar(k, v, st.step)
                    self.val_summary.flush()
                if verbose:
                    print(f"[zoo-torch]   validation: {results}")
            faults.heartbeat()
            if self._ckpt_path and per_epoch_ckpt:
                checkpoint_lib.async_save_sharded(
                    self._ckpt_path, f"epoch{st.epoch}", self.state_tree(),
                    meta={"step": st.step, "epoch": st.epoch,
                          "epoch_step": 0})
        if self._ckpt_path:
            # fit returning means the snapshots are on disk, on every
            # process of the pod
            checkpoint_lib.wait_pending(self._ckpt_path)
            dist_lib.barrier("zoo_fit_ckpt_done")
        return history

    def evaluate(self, dataset: Dataset, batch_size: int,
                 metrics: Optional[Sequence] = None) -> Dict[str, float]:
        """Metrics and mean loss over the whole dataset, in f32.  The tail
        batch is zero-padded to ``batch_size`` and masked out, as in the
        JAX package, so every sample counts once.  ``metrics`` overrides
        the compiled set for this call.

        Sharded: ``batch_size`` is global, each rank evaluates its own
        data in batches of ``batch_size // dp`` rows, rows flagged
        False in ``dataset.valid`` (``shard_by_process``'s fillers) are
        masked out, and the metrics are added over the data axes; every
        rank runs as many batches (:func:`_rank_batches`)."""
        if self.mesh is not None or dist_lib.cluster_env_present():
            self.ensure_initialized()
        batch_size = self._rank_batch(batch_size)
        valid = getattr(dataset, "valid", None)
        offset = 0
        if metrics is None:
            use_metrics = self.metrics
        else:
            zero_based = getattr(self.loss_fn, "zero_based_label", True)
            use_metrics = [metrics_lib.get(m, zero_based_label=zero_based)
                           for m in metrics]
        feed = DeviceFeed(_model_device(self.model))

        def padded(batch):
            bx, by = batch
            first = bx[0] if isinstance(bx, (tuple, list)) else bx
            n_real = len(first)
            nonlocal offset
            mask = np.zeros((batch_size,), np.float32)
            mask[:n_real] = (1.0 if valid is None else
                             valid[offset:offset + n_real])
            offset += n_real
            pad = batch_size - n_real
            return feed((pad_leading(bx, pad), pad_leading(by, pad), mask))

        accs = [m.init() for m in use_metrics]
        loss_sum = loss_n = 0.0
        group = self._split_group()
        rank_batches, _ = _rank_batches(dataset, batch_size, group)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad(), mesh_lib.active_mesh(self.mesh), \
                    mesh_lib.batch_split(group), prefetch(
                    rank_batches, transform=padded) as batches:
                for item in batches:
                    x, y, mask = feed.ready(item)
                    with collect_penalties() as penalties:
                        y_pred = self.model(x)
                    accs = [m.update(a, y, y_pred, mask)
                            for m, a in zip(use_metrics, accs)]
                    if self.loss_fn is not None:
                        # the penalties count per sample, so that the
                        # evaluate loss compares with the training loss
                        per = self.loss_fn(y, y_pred)
                        penalty = penalties.total()
                        per_sample = _batch_mean(
                            per if penalty is None else per + penalty)
                        # padded samples may be NaN (the label guard)
                        per_sample = torch.where(mask > 0, per_sample, 0.0)
                        loss_sum = loss_sum + torch.sum(per_sample * mask)
                        loss_n = loss_n + torch.sum(mask)
        finally:
            self.model.train(was_training)
        plan = self.state.plan if self.state is not None else None
        if plan is not None and plan.dp_group is not None:
            accs, loss_sum, loss_n = _sum_over(plan.dp_group,
                                               (accs, loss_sum, loss_n))
        results = {m.name: m.result(a) for m, a in zip(use_metrics, accs)}
        if self.loss_fn is not None and float(loss_n) > 0:
            results["loss"] = float(loss_sum) / float(loss_n)
        return results

    def predict(self, x, batch_size: int = 32):
        """Forward ``x``; sharded, ``batch_size`` is global and each rank
        forwards its own rows in batches of ``batch_size // dp``, every
        batch padded to that size (:func:`predict_batches`)."""
        if self.mesh is not None or dist_lib.cluster_env_present():
            self.ensure_initialized()
        group = self._split_group()
        with mesh_lib.active_mesh(self.mesh), mesh_lib.batch_split(group):
            return predict_batches(self.model, x,
                                   self._rank_batch(batch_size), group)

    # ---- summaries and checkpoints ----
    train_summary: Optional[TrainSummary] = None
    val_summary: Optional[ValidationSummary] = None
    _ckpt_path: Optional[str] = None
    _ckpt_overwrite = True
    _ckpt_trigger = None
    _auto_resumed = False
    _resume_epoch_step = 0
    _profile_dir: Optional[str] = None
    _profile_steps: int = 10
    _live_profile = None  # the running fit's torch.profiler trace
    _step_profiler: "Optional[stepprof.StepProfiler]" = None

    def set_tensorboard(self, log_dir: str, app_name: str,
                        profile: bool = False, profile_steps: int = 10):
        """Loss and LearningRate per step and Throughput (samples/s) per
        epoch under ``<log_dir>/<app_name>/train``, each validation
        result per epoch under ``.../validation``.  ``profile=True`` also
        captures one ``torch.profiler`` trace a fit, of its first
        ``profile_steps`` steps (the CUDA activity too on a card), under
        ``<log_dir>/<app_name>/plugins/profile/<run>/`` where
        TensorBoard's profile plugin finds it."""
        self.train_summary = TrainSummary(log_dir, app_name)
        self.val_summary = ValidationSummary(log_dir, app_name)
        self._profile_dir = (os.path.join(log_dir, app_name)
                             if profile else None)
        self._profile_steps = int(profile_steps)

    def enable_step_profiler(self, timeline_path: Optional[str] = None
                             ) -> "stepprof.StepProfiler":
        """Turn on the per-step phase profiler (``data_wait -> h2d ->
        grad_accum -> step_compute -> ckpt_save``; ``train/stepprof.py``)
        for the following fits; ``timeline_path`` also publishes the
        bounded per-step timeline as JSONL when a fit ends.  The env
        contract reaches it without code: ``ZOO_STEP_PROFILE=1``,
        ``ZOO_STEP_TIMELINE=<path>``."""
        self._step_profiler = stepprof.StepProfiler(
            timeline_path=timeline_path)
        return self._step_profiler

    def set_checkpoint(self, path: str, over_write: bool = True,
                       trigger=None):
        """Snapshot the training state under ``path``: at the end of
        every epoch as ``ckpt_epoch<n>`` (the default ``EveryEpoch``
        trigger), or when ``trigger`` fires on a step's record
        (``SeveralIteration(k)``) as ``ckpt_<step>``, asynchronously
        (synchronously under ``ZOO_CKPT_SYNC``)."""
        self._ckpt_path = path
        self._ckpt_overwrite = over_write
        self._ckpt_trigger = trigger or trigger_lib.EveryEpoch()

    def state_tree(self) -> dict:
        """The JAX package's ``TrainState.as_tree()``: the weights
        ({layer: {param: tensor}}), the layer state and the optimizer
        state under optax's leaf names (``opt_state/0/.mu/<layer>/W``,
        ``opt_state/0/.count``, ...).  The tensors are the live ones;
        sharded, the weights and moments are DTensors over this rank's
        blocks, placed as the rule tables say."""
        from ..models.jax_params import weight_tree
        self.ensure_initialized()
        st = self.state
        opt = self.optimizer.state_tree(st.opt_state, st.paths)
        if st.plan is not None:
            return {"params": st.plan.params_tree(),
                    "model_state": st.model_state,
                    "opt_state": st.plan.opt_tree(opt)}
        return {"params": weight_tree(self.model),
                "model_state": st.model_state, "opt_state": opt}

    def save_weights(self, directory: str, tag="final"):
        """The training state in the sharded format (every process of a
        pod calls this), with the step and epoch: each rank writes its
        own blocks, a replicated leaf once."""
        self.ensure_initialized()
        checkpoint_lib.save_sharded(
            directory, tag, self.state_tree(),
            overwrite=self._ckpt_overwrite,
            meta={"step": self.state.step, "epoch": self.state.epoch})

    def load_weights(self, directory: str, tag=None):
        """Restore weights, layer state, optimizer state and counters
        from a checkpoint of either package, in either format (the
        newest complete tag when None), matched by leaf name.  An
        iteration-trigger snapshot makes the next ``fit`` fast-forward
        into its epoch.  Sharded, each leaf is placed under this
        trainer's plan, whatever mesh the snapshot came from."""
        self.ensure_initialized()
        st = self.state
        template = self.state_tree()
        names = checkpoint_lib.saved_names(directory, tag)
        legacy = any(n.startswith(("opt_state/states/", "opt_state/count"))
                     for n in names)
        if legacy:
            # the port's earlier flat saves named the optimizer's leaves
            # by position
            template["opt_state"] = {"count": np.int64(st.opt_state.count),
                                     "states": st.opt_state.states}
        elif names and not any(n.startswith("opt_state/") for n in names):
            # a save of weights and layer state only
            template.pop("opt_state")
        shardings = None
        if st.plan is not None:
            from ..parallel.sharding import dtensor_sharding, tree_map
            shardings = tree_map(dtensor_sharding, template)
        tree = checkpoint_lib.restore_sharded(directory, template, tag,
                                              shardings=shardings)
        checkpoint_lib.copy_tree_into(template, tree)
        if st.plan is not None:
            st.plan.refresh_module()
        meta = checkpoint_lib.read_meta(directory, tag)
        st.step = int(meta.get("step", st.step))
        st.epoch = int(meta.get("epoch", st.epoch))
        if "opt_state" in template:
            # optax keeps the update count in the states that use it
            # (adam's, a scheduled rate's); where none does, the updates
            # made are the steps taken
            counts = [v for n, v in checkpoint_lib.flatten(
                tree["opt_state"]) if n.split("/")[-1] in (".count",
                                                           "count")]
            st.opt_state.count = int(counts[0]) if counts else st.step
        self._resume_epoch_step = int(meta.get("epoch_step", 0))
