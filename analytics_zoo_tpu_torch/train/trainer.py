"""Trainer: the single-device training loop.

Counterpart of ``analytics_zoo_tpu/train/trainer.py``, reduced to one
device: ``build_train_step`` (forward, mean loss plus the regularizers'
penalties, backward, optimizer update), with mixed precision
(``compute_dtype``) and gradient accumulation (``accum_steps``);
``Trainer.fit`` with its epoch/step loop and triggers, ``evaluate`` with
the padded, masked tail, and ``predict``, each fed by a prefetch thread
(``common/prefetch.py``); freezing (a layer's ``trainable`` flag, read at
every step, over an optimizer state that always covers every parameter);
TensorBoard scalars and epoch-triggered checkpoints in the flat format.
The JAX package compiles the step with ``jit``; here it runs eagerly,
with the model's parameters updated in place.  Iteration-triggered and
sharded checkpoints, resuming, the step profiler, fault injection and
sharding are not ported yet (see ROADMAP.md).

Losses stay on the device during an epoch and are read back in one
transfer at its end, as in the JAX package: a step makes no host sync.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..common.prefetch import DeviceFeed, prefetch
from ..core.module import RandomLayer
from ..data.dataset import Dataset
from ..pipeline.api.keras import metrics as metrics_lib
from ..pipeline.api.keras.objectives import _batch_mean
from ..pipeline.api.keras.regularizers import collect_penalties
from . import checkpoint as checkpoint_lib
from . import triggers as trigger_lib
from .summary import TrainSummary, ValidationSummary

#: deployment-wide defaults of the accumulation factor and the compute
#: dtype (the JAX package's env-contract knobs); arguments win
ENV_ACCUM = "ZOO_TRAIN_ACCUM"
ENV_DTYPE = "ZOO_TRAIN_DTYPE"


def _accum_from_env() -> int:
    """``ZOO_TRAIN_ACCUM`` as an int; unset, empty or not a number: 1."""
    try:
        return int(os.environ.get(ENV_ACCUM) or 1)
    except ValueError:
        return 1


def _dtype_from_env() -> Optional[torch.dtype]:
    """``ZOO_TRAIN_DTYPE`` as a compute dtype (None: full f32).  An
    unknown name trains in f32 with a warning, as in the JAX package:
    an operator's typo must not stop a worker."""
    name = (os.environ.get(ENV_DTYPE) or "").strip().lower()
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
    state and the step and epoch counters."""

    def __init__(self, params, model_state, opt_state, step: int = 0,
                 epoch: int = 0):
        self.params = params
        self.model_state = model_state
        self.opt_state = opt_state
        self.step = step
        self.epoch = epoch

    def opt_tree(self) -> dict:
        """The optimizer state as a tree of its tensors (for
        checkpoints): the update count and each transform's state."""
        return {"count": np.int64(self.opt_state.count),
                "states": self.opt_state.states}


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

    ``accum_steps > 1``: the batch splits into that many equal
    microbatches; their gradients sum in f32 and scale by 1/accum, the
    loss is the mean of theirs, and microbatch i draws its dropout (and
    every random layer's noise) from generators seeded from (``seed``,
    step, i).  The microbatches run in
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
                                    self.optimizer.init(params))

    def refresh_optimizer(self):
        """Take up changed ``trainable`` flags (the JAX package re-masks
        its optimizer here).  The step reads the flags at every call and
        the optimizer state covers every parameter, frozen or not, so
        nothing is rebuilt and the statistics stay as they are:
        still-training layers keep their moments bit for bit."""

    def fit(self, dataset: Dataset, batch_size: int, end_trigger=None,
            validation_data: Optional[Dataset] = None,
            validation_trigger=None, validation_batch_size: int = None,
            shuffle: bool = True, verbose: bool = False) -> Dict[str, List]:
        """Run the loop until ``end_trigger`` fires (default: one more
        epoch).  Successive calls continue the epoch count.  Returns
        ``{"loss": [per-step losses], "val": [per-epoch results]}``."""
        if batch_size % self.accum_steps:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by "
                f"accum_steps ({self.accum_steps}): every microbatch has "
                "the same size")
        self.ensure_initialized()
        if self._train_step is None:
            self._train_step = build_train_step(
                self.model, self.loss_fn, self.optimizer,
                compute_dtype=self.compute_dtype,
                accum_steps=self.accum_steps, seed=self.seed)
        st = self.state
        feed = DeviceFeed(_model_device(self.model))
        end_trigger = end_trigger or trigger_lib.MaxEpoch(st.epoch + 1)
        validation_trigger = validation_trigger or trigger_lib.EveryEpoch()
        history: Dict[str, List] = {"loss": [], "val": []}
        stop = False
        while not (stop or end_trigger({"epoch": st.epoch,
                                        "iteration": st.step})):
            epoch_losses = []
            epoch_start = time.perf_counter()
            with prefetch(dataset.batches(batch_size, shuffle=shuffle,
                                          seed=self.seed, epoch=st.epoch),
                          transform=feed) as batches:
                for item in batches:
                    bx, by = feed.ready(item)
                    loss = self._train_step(st, bx, by)
                    st.step += 1
                    epoch_losses.append(loss)
                    if end_trigger({"epoch": st.epoch, "iteration": st.step,
                                    "loss": loss}):
                        stop = True
                        break
            st.epoch += 1
            # one transfer for the epoch's losses
            losses = (torch.stack(epoch_losses).cpu().tolist()
                      if epoch_losses else [])
            history["loss"].extend(losses)
            if self.train_summary is not None:
                elapsed = max(time.perf_counter() - epoch_start, 1e-9)
                for i, lossf in enumerate(losses):
                    self.train_summary.add_scalar(
                        "Loss", lossf, st.step - len(losses) + i + 1)
                self.train_summary.add_scalar(
                    "Throughput", len(losses) * batch_size / elapsed, st.step)
                self.train_summary.flush()
            epoch_record = {"epoch": st.epoch, "iteration": st.step,
                            "epoch_finished": True,
                            "loss": losses[-1] if losses else None}
            if verbose:
                print(f"[zoo-torch] epoch {st.epoch} step {st.step} loss "
                      f"{epoch_record['loss']}")
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
            if self._ckpt_path:
                self.save_weights(self._ckpt_path, f"epoch{st.epoch}")
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

    def set_tensorboard(self, log_dir: str, app_name: str):
        """Loss per step and Throughput (samples/s) per epoch under
        ``<log_dir>/<app_name>/train``, each validation result per epoch
        under ``.../validation``."""
        self.train_summary = TrainSummary(log_dir, app_name)
        self.val_summary = ValidationSummary(log_dir, app_name)

    def set_checkpoint(self, path: str, over_write: bool = True):
        """Save the training state at the end of every epoch, as
        ``ckpt_epoch<n>`` under ``path``."""
        self._ckpt_path = path
        self._ckpt_overwrite = over_write

    def state_tree(self) -> dict:
        """The model's weights ({layer: {param: tensor}}), its layer state
        and the optimizer state, as the JAX package's
        ``TrainState.as_tree``."""
        from ..models.jax_params import weight_tree
        self.ensure_initialized()
        return {"params": weight_tree(self.model),
                "model_state": self.state.model_state,
                "opt_state": self.state.opt_tree()}

    def save_weights(self, directory: str, tag="final"):
        self.ensure_initialized()
        checkpoint_lib.save_checkpoint(
            directory, tag, self.state_tree(),
            overwrite=self._ckpt_overwrite,
            meta={"step": self.state.step, "epoch": self.state.epoch})

    def load_weights(self, directory: str, tag=None):
        """Restore weights, layer state, optimizer state and counters
        from a checkpoint of this model (the newest tag when None)."""
        self.ensure_initialized()
        pairs = checkpoint_lib.restore_into(directory, self.state_tree(), tag)
        self.state.opt_state.count = int(dict(pairs)["opt_state/count"])
        meta = checkpoint_lib.read_meta(directory, tag)
        self.state.step = int(meta.get("step", self.state.step))
        self.state.epoch = int(meta.get("epoch", self.state.epoch))
