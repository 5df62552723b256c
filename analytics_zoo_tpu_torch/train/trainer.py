"""Trainer: the single-device training loop.

Counterpart of ``analytics_zoo_tpu/train/trainer.py``, reduced to one
device: ``build_train_step`` (forward, mean loss plus the regularizers'
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
the masks of the uninterrupted one.  The step profiler and sharding are
not ported yet (see ROADMAP.md).

Losses stay on the device during an epoch and are read back in one
transfer at its end, as in the JAX package: a step makes no host sync.
"""

from __future__ import annotations

import itertools
import logging
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from .. import envcontract
from ..common.prefetch import DeviceFeed, prefetch
from ..core.module import RandomLayer
from ..data.dataset import Dataset
from ..parallel import distributed as dist_lib
from ..pipeline.api.keras import metrics as metrics_lib
from ..pipeline.api.keras.objectives import _batch_mean
from ..pipeline.api.keras.regularizers import collect_penalties
from . import checkpoint as checkpoint_lib
from . import faults
from . import metrics as train_metrics
from . import triggers as trigger_lib
from .summary import TrainSummary, ValidationSummary

#: deployment-wide defaults of the accumulation factor and the compute
#: dtype (the JAX package's env-contract knobs); arguments win
ENV_ACCUM = "ZOO_TRAIN_ACCUM"
ENV_DTYPE = "ZOO_TRAIN_DTYPE"

_log = logging.getLogger("analytics_zoo_tpu_torch.train")


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


def _pad_tail(batch, pad: int):
    """Zero-pad the leading axis of an array (or tuple of arrays) by
    ``pad`` rows, keeping its dtype."""
    if pad == 0:
        return batch

    def one(a):
        a = np.asarray(a)
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    if isinstance(batch, (tuple, list)):
        return tuple(one(a) for a in batch)
    return one(batch)


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


def _split(batch, accum: int):
    """``accum`` equal microbatches of a batch (a tensor or a tuple or
    list of tensors): row views, microbatch i the i-th run of rows, as
    the JAX package's (accum, micro, ...) reshape."""
    if isinstance(batch, (tuple, list)):
        parts = [_split(b, accum) for b in batch]
        return [type(batch)(p[i] for p in parts) for i in range(accum)]
    if batch.shape[0] % accum:
        raise ValueError(f"batch ({batch.shape[0]}) must divide "
                         f"accum_steps ({accum})")
    return list(batch.chunk(accum))


class TrainState:
    """Every parameter of the model (its own tensors, updated in place;
    frozen ones too, so that freezing never changes the optimizer
    state's layout), the model's state (its stateful layers' buffers,
    as the JAX package's ``model_state`` tree: {layer: {name: tensor}};
    the layers update them in place in training mode), the optimizer
    state and the step and epoch counters.  ``paths`` is each
    parameter's key path in the params tree."""

    def __init__(self, params, model_state, opt_state, step: int = 0,
                 epoch: int = 0, paths=None):
        self.params = params
        self.model_state = model_state
        self.opt_state = opt_state
        self.step = step
        self.epoch = epoch
        self.paths = paths


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
                     accum_steps: int = 1, seed: int = 0):
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

    Returns ``step(state, x, y) -> loss``, a device scalar."""
    accum = max(int(accum_steps), 1)
    names = [n for n, _ in model.named_parameters()]
    dropouts = [m for m in model.modules() if isinstance(m, RandomLayer)]

    def forward_loss(params, x, y):
        with collect_penalties() as penalties:
            if compute_dtype is None:
                y_pred = model(x)
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
        was_training = model.training
        model.train()
        try:
            if accum == 1:
                seed_dropout(state.step, 0)
                loss = forward_loss(state.params, x, y)
                grads = gradients(loss, state.params, trainable)
            else:
                grads = loss = None
                for i, (xi, yi) in enumerate(zip(_split(x, accum),
                                                 _split(y, accum))):
                    seed_dropout(state.step, i)
                    mloss = forward_loss(state.params, xi, yi)
                    g = gradients(mloss, state.params, trainable)
                    if grads is None:
                        grads, loss = g, mloss.detach()
                    else:
                        grads = [a + b for a, b in zip(grads, g)]
                        loss = loss + mloss.detach()
                grads = [g * (1.0 / accum) for g in grads]
                loss = loss * (1.0 / accum)
        finally:
            model.train(was_training)
        optimizer.apply(state.params, grads, state.opt_state,
                        frozen=[not t for t in trainable])
        return loss.detach()

    return train_step


def predict_batches(model, x, batch_size: int = 32):
    """Forward ``x`` (an array or a Dataset) in batches of ``batch_size``
    without gradients or dropout, fed by a prefetch thread; returns numpy
    (a list of arrays for a model of several outputs).  The tail batch
    runs at its own size (an eager step needs no fixed shape)."""
    ds = x if isinstance(x, Dataset) else Dataset.from_ndarray(x)
    if ds.size == 0:
        raise ValueError("predict called with an empty dataset")
    feed = DeviceFeed(_model_device(model))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), prefetch(
                (bx for bx, _ in ds.batches(batch_size,
                                            drop_remainder=False)),
                transform=feed) as batches:
            out = [_to_host(model(feed.ready(item))) for item in batches]
    finally:
        model.train(was_training)
    if isinstance(out[0], list):  # a model of several outputs
        return [torch.cat([o[i] for o in out]).numpy()
                for i in range(len(out[0]))]
    return torch.cat(out).numpy()


class Trainer:
    """Single-device trainer of an ``nn.Module`` whose ``forward`` maps a
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
    statistics)."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 metrics: Sequence = (), seed: int = 0,
                 compute_dtype=None, accum_steps: Optional[int] = None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.metrics = list(metrics)
        self.seed = seed
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else _dtype_from_env())
        self.accum_steps = max(int(accum_steps) if accum_steps is not None
                               else _accum_from_env(), 1)
        self.state: Optional[TrainState] = None
        self._train_step = None

    def ensure_initialized(self):
        if self.state is None:
            from ..models.jax_params import state_tree
            params = list(self.model.parameters())
            self.state = TrainState(params, state_tree(self.model),
                                    self.optimizer.init(params),
                                    paths=param_paths(self.model, params))

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
            _log.warning("ZOO_RESUME set but no complete checkpoint in %s:"
                         " cold start", self._ckpt_path)
            return
        except Exception as e:
            train_metrics.record_ckpt_restore("cold_start")
            _log.error("ZOO_RESUME restore from %s failed (%s: %s): cold "
                       "start", self._ckpt_path, type(e).__name__, e,
                       exc_info=True)
            return
        _log.info("resumed from %s at epoch %d step %d (epoch step %d)",
                  self._ckpt_path, self.state.epoch, self.state.step,
                  self._resume_epoch_step)

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
        if batch_size % self.accum_steps:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by "
                f"accum_steps ({self.accum_steps}): every microbatch has "
                "the same size")
        device = _model_device(self.model)
        dist_lib.maybe_initialize_distributed(device)
        self.ensure_initialized()
        faults.refresh()
        faults.heartbeat()
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
                accum_steps=self.accum_steps, seed=self.seed)
        st = self.state
        feed = DeviceFeed(device)
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
            with prefetch(batches, transform=feed) as items:
                for item in items:
                    bx, by = feed.ready(item)
                    loss = self._train_step(st, bx, by)
                    st.step += 1
                    faults.heartbeat()
                    train_metrics.record_step()
                    # an injected fault lands before the checkpoint: a
                    # crash at step k never leaves a tag k
                    faults.maybe_fault(st.step)
                    epoch_losses.append(loss)
                    record = {"epoch": st.epoch, "iteration": st.step,
                              "loss": loss}
                    if self._ckpt_path and not per_epoch_ckpt \
                            and ckpt_trigger(record):
                        self._iteration_checkpoint(st.step
                                                   - epoch_start_step)
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
                    "Throughput", len(losses) * batch_size / elapsed, st.step)
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
                                        validation_batch_size or batch_size)
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
        the compiled set for this call."""
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
            mask = np.zeros((batch_size,), np.float32)
            mask[:n_real] = 1.0
            pad = batch_size - n_real
            return feed((_pad_tail(bx, pad), _pad_tail(by, pad), mask))

        accs = [m.init() for m in use_metrics]
        loss_sum = loss_n = 0.0
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad(), prefetch(
                    dataset.batches(batch_size, shuffle=False,
                                    drop_remainder=False),
                    transform=padded) as batches:
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
        results = {m.name: m.result(a) for m, a in zip(use_metrics, accs)}
        if self.loss_fn is not None and float(loss_n) > 0:
            results["loss"] = float(loss_sum) / float(loss_n)
        return results

    def predict(self, x, batch_size: int = 32):
        return predict_batches(self.model, x, batch_size)

    # ---- summaries and checkpoints ----
    train_summary: Optional[TrainSummary] = None
    val_summary: Optional[ValidationSummary] = None
    _ckpt_path: Optional[str] = None
    _ckpt_overwrite = True
    _ckpt_trigger = None
    _auto_resumed = False
    _resume_epoch_step = 0

    def set_tensorboard(self, log_dir: str, app_name: str):
        """Loss and LearningRate per step and Throughput (samples/s) per
        epoch under ``<log_dir>/<app_name>/train``, each validation
        result per epoch under ``.../validation``."""
        self.train_summary = TrainSummary(log_dir, app_name)
        self.val_summary = ValidationSummary(log_dir, app_name)

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
        ``opt_state/0/.count``, ...).  The tensors are the live ones."""
        from ..models.jax_params import weight_tree
        self.ensure_initialized()
        st = self.state
        return {"params": weight_tree(self.model),
                "model_state": st.model_state,
                "opt_state": self.optimizer.state_tree(st.opt_state,
                                                       st.paths)}

    def save_weights(self, directory: str, tag="final"):
        """The training state in the sharded format (every process of a
        pod calls this), with the step and epoch."""
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
        into its epoch."""
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
        tree = checkpoint_lib.restore_sharded(directory, template, tag)
        checkpoint_lib.copy_tree_into(template, tree)
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
