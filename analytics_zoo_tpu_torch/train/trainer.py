"""Trainer: the single-device training loop.

Counterpart of ``analytics_zoo_tpu/train/trainer.py``, reduced to one
device: ``build_train_step`` (forward, mean loss, backward, optimizer
update), ``Trainer.fit`` with its epoch/step loop and triggers,
``Trainer.evaluate`` with the padded, masked tail, and
``Trainer.predict``, TensorBoard scalars (``set_tensorboard``) and
epoch-triggered checkpoints in the flat format (``set_checkpoint``).  The
JAX package compiles the step with ``jit``; here it runs eagerly, with the
model's parameters updated in place.  Iteration-triggered and sharded
checkpoints, resuming, the step profiler, fault injection, sharding,
gradient accumulation and mixed precision are not ported yet (see
ROADMAP.md).

Losses stay on the device during an epoch and are read back in one
transfer at its end, as in the JAX package: a step makes no host sync.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.dataset import Dataset
from ..pipeline.api.keras import metrics as metrics_lib
from ..pipeline.api.keras.objectives import _batch_mean
from . import checkpoint as checkpoint_lib
from . import triggers as trigger_lib
from .summary import TrainSummary, ValidationSummary


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


def _to_device(batch, device):
    if batch is None:
        return None
    if isinstance(batch, (tuple, list)):
        return [torch.as_tensor(np.asarray(a), device=device) for a in batch]
    return torch.as_tensor(np.asarray(batch), device=device)


def _to_host(y):
    if isinstance(y, (list, tuple)):
        return [t.cpu() for t in y]
    return y.cpu()


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class TrainState:
    """The trained parameters (the model's own tensors, updated in
    place), the optimizer state and the step and epoch counters."""

    def __init__(self, params, opt_state, step: int = 0, epoch: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step
        self.epoch = epoch

    def opt_tree(self) -> dict:
        """The optimizer state as a tree of its tensors (for
        checkpoints): the update count and each transform's state."""
        return {"count": np.int64(self.opt_state.count),
                "states": self.opt_state.states}


def build_train_step(model, loss_fn, optimizer, compute_dtype=None,
                     accum_steps: int = 1):
    """The training iteration: forward in training mode, the mean of the
    per-sample loss, gradients by ``torch.autograd.grad`` (nothing is
    left in ``.grad``), and the optimizer's in-place update.

    Returns ``step(state, x, y) -> loss``, a device scalar.  Mixed
    precision (``compute_dtype``) and gradient accumulation
    (``accum_steps > 1``) are not ported yet and raise."""
    if compute_dtype is not None:
        raise NotImplementedError(
            "compute_dtype (mixed precision) is not ported yet (see "
            "ROADMAP.md)")
    if int(accum_steps) != 1:
        raise NotImplementedError(
            "accum_steps > 1 (gradient accumulation) is not ported yet "
            "(see ROADMAP.md)")

    def train_step(state: TrainState, x, y):
        was_training = model.training
        model.train()
        try:
            y_pred = model(x)
            loss = torch.mean(loss_fn(y, y_pred))
            grads = torch.autograd.grad(loss, state.params)
        finally:
            model.train(was_training)
        optimizer.apply(state.params, grads, state.opt_state)
        return loss.detach()

    return train_step


def predict_batches(model, x, batch_size: int = 32):
    """Forward ``x`` (an array or a Dataset) in batches of ``batch_size``
    without gradients or dropout; returns numpy (a list of arrays for a
    model of several outputs).  The tail batch runs at its own size (an
    eager step needs no fixed shape)."""
    ds = x if isinstance(x, Dataset) else Dataset.from_ndarray(x)
    if ds.size == 0:
        raise ValueError("predict called with an empty dataset")
    device = _model_device(model)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            out = [_to_host(model(_to_device(bx, device)))
                   for bx, _ in ds.batches(batch_size, drop_remainder=False)]
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
    ZooOptimizer`.  ``seed`` orders the shuffled batches."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 metrics: Sequence = (), seed: int = 0,
                 compute_dtype=None, accum_steps: int = 1):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.metrics = list(metrics)
        self.seed = seed
        self.compute_dtype = compute_dtype
        self.accum_steps = accum_steps
        self.state: Optional[TrainState] = None
        self._train_step = None

    def ensure_initialized(self):
        if self.state is None:
            params = [p for p in self.model.parameters() if p.requires_grad]
            self.state = TrainState(params, self.optimizer.init(params))

    def fit(self, dataset: Dataset, batch_size: int, end_trigger=None,
            validation_data: Optional[Dataset] = None,
            validation_trigger=None, validation_batch_size: int = None,
            shuffle: bool = True, verbose: bool = False) -> Dict[str, List]:
        """Run the loop until ``end_trigger`` fires (default: one more
        epoch).  Successive calls continue the epoch count.  Returns
        ``{"loss": [per-step losses], "val": [per-epoch results]}``."""
        self.ensure_initialized()
        if self._train_step is None:
            self._train_step = build_train_step(
                self.model, self.loss_fn, self.optimizer,
                compute_dtype=self.compute_dtype,
                accum_steps=self.accum_steps)
        st = self.state
        device = _model_device(self.model)
        end_trigger = end_trigger or trigger_lib.MaxEpoch(st.epoch + 1)
        validation_trigger = validation_trigger or trigger_lib.EveryEpoch()
        history: Dict[str, List] = {"loss": [], "val": []}
        stop = False
        while not (stop or end_trigger({"epoch": st.epoch,
                                        "iteration": st.step})):
            epoch_losses = []
            epoch_start = time.perf_counter()
            for bx, by in dataset.batches(batch_size, shuffle=shuffle,
                                          seed=self.seed, epoch=st.epoch):
                loss = self._train_step(st, _to_device(bx, device),
                                        _to_device(by, device))
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
        """Metrics and mean loss over the whole dataset.  The tail batch is
        zero-padded to ``batch_size`` and masked out, as in the JAX
        package, so every sample counts once.  ``metrics`` overrides the
        compiled set for this call."""
        if metrics is None:
            use_metrics = self.metrics
        else:
            zero_based = getattr(self.loss_fn, "zero_based_label", True)
            use_metrics = [metrics_lib.get(m, zero_based_label=zero_based)
                           for m in metrics]
        device = _model_device(self.model)
        accs = [m.init() for m in use_metrics]
        loss_sum = loss_n = 0.0
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for bx, by in dataset.batches(batch_size, shuffle=False,
                                              drop_remainder=False):
                    first = bx[0] if isinstance(bx, (tuple, list)) else bx
                    n_real = len(first)
                    pad = batch_size - n_real
                    mask = torch.zeros((batch_size,), device=device)
                    mask[:n_real] = 1.0
                    x = _to_device(_pad_tail(bx, pad), device)
                    y = _to_device(_pad_tail(by, pad), device)
                    y_pred = self.model(x)
                    accs = [m.update(a, y, y_pred, mask)
                            for m, a in zip(use_metrics, accs)]
                    if self.loss_fn is not None:
                        per_sample = _batch_mean(self.loss_fn(y, y_pred))
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
        """The model's weights ({layer: {param: tensor}}) and the
        optimizer state."""
        from ..models.jax_params import weight_tree
        self.ensure_initialized()
        return {"params": weight_tree(self.model),
                "opt_state": self.state.opt_tree()}

    def save_weights(self, directory: str, tag="final"):
        self.ensure_initialized()
        checkpoint_lib.save_checkpoint(
            directory, tag, self.state_tree(),
            overwrite=self._ckpt_overwrite,
            meta={"step": self.state.step, "epoch": self.state.epoch})

    def load_weights(self, directory: str, tag=None):
        """Restore weights, optimizer state and counters from a
        checkpoint of this model (the newest tag when None)."""
        self.ensure_initialized()
        pairs = checkpoint_lib.restore_into(directory, self.state_tree(), tag)
        self.state.opt_state.count = int(dict(pairs)["opt_state/count"])
        meta = checkpoint_lib.read_meta(directory, tag)
        self.state.step = int(meta.get("step", self.state.step))
        self.state.epoch = int(meta.get("epoch", self.state.epoch))
