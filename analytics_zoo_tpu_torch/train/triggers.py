"""Trigger predicates over the training record {epoch, iteration,
epoch_finished, loss}: when to stop or validate.

Counterpart of ``analytics_zoo_tpu/train/triggers.py``.  The record's
``loss`` may be a device scalar; only ``MinLoss`` reads it, and pays the
host sync.
"""

from __future__ import annotations


class Trigger:
    def __call__(self, record: dict) -> bool:
        raise NotImplementedError

    @staticmethod
    def every_epoch():
        return EveryEpoch()

    @staticmethod
    def max_epoch(n):
        return MaxEpoch(n)

    @staticmethod
    def max_iteration(n):
        return MaxIteration(n)

    @staticmethod
    def several_iteration(n):
        return SeveralIteration(n)


class EveryEpoch(Trigger):
    def __call__(self, record):
        return bool(record.get("epoch_finished", False))


class MaxEpoch(Trigger):
    def __init__(self, n):
        self.n = int(n)

    def __call__(self, record):
        return record.get("epoch", 0) >= self.n


class MaxIteration(Trigger):
    def __init__(self, n):
        self.n = int(n)

    def __call__(self, record):
        return record.get("iteration", 0) >= self.n


class SeveralIteration(Trigger):
    def __init__(self, n):
        self.n = int(n)

    def __call__(self, record):
        it = record.get("iteration", 0)
        return it > 0 and it % self.n == 0


class MinLoss(Trigger):
    def __init__(self, min_loss):
        self.min_loss = float(min_loss)

    def __call__(self, record):
        loss = record.get("loss")
        return loss is not None and bool(loss <= self.min_loss)


class And(Trigger):
    """Fires when every one of ``triggers`` fires."""

    def __init__(self, *triggers):
        self.triggers = triggers

    def __call__(self, record):
        return all(t(record) for t in self.triggers)


class Or(Trigger):
    """Fires when any one of ``triggers`` fires."""

    def __init__(self, *triggers):
        self.triggers = triggers

    def __call__(self, record):
        return any(t(record) for t in self.triggers)
