"""Prefetch: run a batch source and its host-to-device transform on a
background thread, a bounded number of items ahead of the consumer.

Counterpart of ``analytics_zoo_tpu/common/prefetch.py``, with its
contract: order is kept, an exception of the source or the transform
re-raises at the consumer at the position it occurred, abandoning the
iterator (``close()``, garbage collection, ``with``) stops the worker
promptly, and ``depth`` bounds the transformed items waiting ahead of
the consumer (2 is double buffering).

:class:`DeviceFeed` is the trainer's transform: on a CUDA device it
copies a batch from pinned host memory with ``non_blocking=True`` on a
side stream and records an event, and the consumer's stream waits on
that event (:meth:`DeviceFeed.ready`) before it uses the batch, so the
copy of batch k+1 overlaps the compute of batch k.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_END = object()
_ERR = object()


def _put(q: "queue.Queue", stop: threading.Event, item) -> bool:
    """A bounded put that notices ``close()``; False when the consumer is
    gone."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _worker(source, transform, q, stop):
    try:
        for item in source:
            if stop.is_set():
                return
            if transform is not None:
                item = transform(item)
            if not _put(q, stop, (None, item)):
                return
        _put(q, stop, (_END, None))
    except BaseException as e:  # re-raised at the consumer
        _put(q, stop, (_ERR, e))


class PrefetchIterator:
    """An iterator over ``transform(item)`` for the items of
    ``iterable``, both run on a worker thread that starts at the first
    ``next``."""

    def __init__(self, iterable: Iterable,
                 transform: Optional[Callable] = None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        # the worker holds the queue and the stop flag but not self, so an
        # abandoned iterator can be collected and its __del__ stop it
        self._thread = threading.Thread(
            target=_worker, args=(iterable, transform, self._q, self._stop),
            name="zoo-prefetch", daemon=True)
        self._started = False
        self._done = False

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        if not self._started:
            self._started = True
            self._thread.start()
        kind, val = self._q.get()
        if kind is _END:
            self._done = True
            raise StopIteration
        if kind is _ERR:
            self._done = True
            self._stop.set()
            raise val
        return val

    def close(self):
        """Stop the worker and drop the buffered items (idempotent)."""
        self._done = True
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def prefetch(iterable: Iterable, transform: Optional[Callable] = None,
             depth: int = 2) -> PrefetchIterator:
    """Prefetch ``iterable`` through a background thread; ``transform``
    runs on that thread and ``depth`` bounds the items waiting ahead of
    the consumer."""
    return PrefetchIterator(iterable, transform=transform, depth=depth)


def _map(fn, batch):
    """``fn`` over the arrays of a batch: an array, None, or a tuple or
    list of batches."""
    if batch is None:
        return None
    if isinstance(batch, (tuple, list)):
        return tuple(_map(fn, b) for b in batch)
    return fn(batch)


class DeviceFeed:
    """The transform that puts a host batch (numpy arrays, tuples of
    them, None) on ``device`` as tensors, and :meth:`ready`, which the
    consumer calls on what the transform returned.

    On a CPU device the arrays become tensors (sharing their memory where
    they can).  On a CUDA device the transform copies each array from
    pinned memory with ``non_blocking=True`` on a side stream of its own
    and records an event; ``ready`` makes the consumer's current stream
    wait for that event and marks the tensors as used on that stream, so
    the allocator does not hand their memory out before the consumer's
    work on them is done."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def _copy(self, a):
        host = torch.from_numpy(np.ascontiguousarray(a))
        return host.pin_memory().to(self.device, non_blocking=True)

    def __call__(self, batch):
        if self.stream is None:
            return _map(lambda a: torch.as_tensor(np.asarray(a),
                                                  device=self.device),
                        batch), None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = _map(self._copy, batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, item):
        """The batch of a transformed ``item``, safe to use on the
        current stream."""
        out, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            _map(lambda t: t.record_stream(stream), out)
        return out
