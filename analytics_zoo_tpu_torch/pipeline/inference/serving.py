"""Serving fast path: shape-bucketed forwards and request coalescing.

Counterpart of the single-device part of
``analytics_zoo_tpu/pipeline/inference/serving.py``.

* ``BucketedExecutableCache`` pads every batch up to a small geometric
  ladder of batch sizes, so a ragged request stream runs the model's
  forward at a handful of shapes, with per-bucket hit, miss and build
  counters and a ``warmup`` that runs each bucket once.  On the card a
  bucket's "executable" is the eager forward at that padded batch: the
  first call of a bucket initialises its cuBLAS and allocator state, and
  the counters call that a build.
* ``RequestCoalescer`` packs concurrent ``predict()`` callers into one
  padded batch per dispatch on a dispatcher thread, gathering the next
  group while the device computes the current one, and fans the rows
  back out.  The groups are staged in reusable host buffers
  (``_StagingArena``), pinned on a CUDA device so that the upload is a
  non-blocking copy.

Tracing (``observability/trace.py``): a request's span, when it has one,
records ``pad -> device_put -> execute -> depad`` (once per chunk of an
oversized batch) and, through the coalescer, ``coalesce_wait`` first;
the coalescer's pending request carries the span across to the
dispatcher thread, which activates the group's lead span around a
bucket's first run so that a compile-like event there (a kernel build)
lands in that request's trace.  The phases time the host: ``execute``
runs from the dispatch to the end of the blocking fetch.  Without a span
each site costs one ``None`` check; nothing waits for the device to fill
a phase or a label.

Padding safety: rows are independent in an inference forward (no batch
statistics, row-wise softmax), so filler rows cannot perturb real rows,
and a coalesced row equals a solo row run at the same bucket bit for
bit.  The JAX package's multi-replica ``ReplicaSet`` and hedging are not
ported (see ROADMAP.md).
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...common.context import resolve_device
from ...common.utils import pad_leading
from ...observability import profile as _profile
from ...observability import trace as _trace


#: the context of a dispatch that activates no span (reusable)
_UNTRACED = contextlib.nullcontext()


def bucket_ladder(max_batch: int, growth: float = 2.0,
                  min_batch: int = 1) -> Tuple[int, ...]:
    """The geometric ladder of padded batch sizes: ``min_batch`` scaled
    by ``growth`` until ``max_batch`` (always included)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if growth <= 1.0:
        raise ValueError(f"bucket growth must be > 1, got {growth}")
    out: List[int] = []
    b = float(max(1, min_batch))
    while int(b) < max_batch:
        if not out or int(b) != out[-1]:
            out.append(int(b))
        b *= growth
    out.append(int(max_batch))
    return tuple(out)


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(fn(a) for a in tree)
    return fn(tree)


def _rows(batched) -> int:
    first = batched[0] if isinstance(batched, (tuple, list)) else batched
    return int(np.asarray(first).shape[0])


def _slice_rows(tree, start: int, stop: int):
    return _map(lambda a: a[start:stop], tree)


def _concat_trees(trees: Sequence):
    """Concatenate result trees (arrays or tuples of arrays) row-wise."""
    if len(trees) == 1:
        return trees[0]
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(
            np.concatenate([t[i] for t in trees])
            for i in range(len(first)))
    return np.concatenate(trees)


def batch_signature(batched) -> Tuple:
    """Everything but the batch row count: per-input trailing shape and
    dtype.  Two batches coalesce, and share a bucket, iff their
    signatures match."""
    def one(a):
        a = np.asarray(a)
        return (tuple(a.shape[1:]), str(a.dtype))

    if isinstance(batched, (tuple, list)):
        return tuple(one(a) for a in batched)
    return (one(batched),)


def to_device(batched, device):
    """A host batch (numpy, or a tuple of arrays) as tensors on
    ``device``, dtypes kept.  Pinned host tensors (the staging arena's)
    upload without blocking."""
    def one(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return t.to(device, non_blocking=t.is_pinned())

    return _map(one, batched)


class BucketStats:
    """Per-bucket serving counters (thread-safe snapshots via dict
    copy)."""

    def __init__(self):
        self.hits: Dict[int, int] = {}
        self.misses: Dict[int, int] = {}
        self.build_time_s: Dict[int, float] = {}

    def snapshot(self) -> Dict[str, Dict[int, object]]:
        return {"hits": dict(self.hits), "misses": dict(self.misses),
                "build_time_s": dict(self.build_time_s)}


class BucketedExecutableCache:
    """Pad batches to a bucket ladder so that a ragged request stream
    runs the forward at a handful of shapes.

    ``fn`` maps a batch of device tensors (a tensor, or a tuple for a
    model of several inputs) to device results; ``device`` is where it
    runs.  This layer makes sure only ladder shapes reach it, counts
    hits, misses and build time per bucket, and un-pads results.
    Batches larger than the top bucket are served in top-bucket chunks
    (the tail padded).  ``device`` defaults to ``"cuda"``, as every
    entry point of the port does."""

    def __init__(self, fn: Callable, max_batch: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 growth: float = 2.0, device=None):
        self._fn = fn
        self.device = resolve_device(device)
        self.buckets = (tuple(sorted(set(int(b) for b in buckets)))
                        if buckets else bucket_ladder(max_batch, growth))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        self.max_batch = self.buckets[-1]
        self.stats = BucketStats()
        self._seen: set = set()
        self._lock = threading.Lock()

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket >= n (the top bucket for oversized
        n)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def _note_lookup(self, bucket: int, signature: Tuple) -> bool:
        """Hit/miss bookkeeping for one bucket lookup, shared by the
        dispatch path and warmup; True when this (bucket, signature) is
        new."""
        sig = (bucket, signature)
        with self._lock:
            fresh = sig not in self._seen
            if fresh:
                self._seen.add(sig)
                self.stats.misses[bucket] = \
                    self.stats.misses.get(bucket, 0) + 1
            else:
                self.stats.hits[bucket] = self.stats.hits.get(bucket, 0) + 1
        return fresh

    def _dispatch(self, batched, bucket: int, spans: Sequence = ()):
        """Run one exactly-bucket-sized padded host batch; returns the
        device results without fetching them.  A bucket's first run is
        its build: it is synchronised and timed.  ``spans`` (the riders'
        trace spans) get the bucket as a label and the ``device_put ->
        execute`` phases; ``execute`` stays open until the owner's
        ``depad``."""
        fresh = self._note_lookup(bucket, batch_signature(batched))
        for s in spans:
            s.set_label("bucket", bucket)
            s.phase_start("device_put")
        t0 = time.perf_counter()
        batched = to_device(batched, self.device)
        _profile.note_transfer("h2d")
        for s in spans:
            s.phase_start("execute")
        # the dispatcher thread has no span of its own: a bucket's first
        # run activates the lead span, so that a build there lands in the
        # trace of the request that paid for it
        with torch.no_grad(), (_trace.activate(spans[0])
                               if fresh and spans else _UNTRACED):
            out = self._fn(batched)
        if fresh:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            secs = time.perf_counter() - t0
            with self._lock:
                self.stats.build_time_s[bucket] = \
                    self.stats.build_time_s.get(bucket, 0.0) + secs
        return out

    def run(self, batched, sem: Optional[threading.Semaphore] = None,
            span=None):
        """Serve one host batch of any row count; returns host numpy
        results with the padding rows removed.  ``sem`` (the owner's
        device-concurrency bound) is held around the dispatch only.
        ``span`` (the request's trace span) records ``pad -> device_put
        -> execute -> depad``, once per chunk of an oversized batch."""
        guard = sem if sem is not None else contextlib.nullcontext()
        spans = (span,) if span is not None else ()
        n = _rows(batched)
        if n == 0:
            # run the smallest bucket and keep zero rows: the output
            # structure holds for empty inputs too
            with guard:
                out = self._dispatch(pad_leading(batched, self.buckets[0]),
                                     self.buckets[0], spans)
            return fetch_rows(out, 0, span=span)
        outs = []
        start = 0
        while start < n:
            take = min(self.max_batch, n - start)
            chunk = _slice_rows(batched, start, start + take) \
                if (start or take < n) else batched
            bucket = self.bucket_for(take)
            if span is not None:
                span.phase_start("pad")
            padded = pad_leading(chunk, bucket - take)
            with guard:
                out = self._dispatch(padded, bucket, spans)
            outs.append(fetch_rows(out, take, span=span))
            start += take
        return _concat_trees(outs)

    def dispatch_padded(self, batched, spans: Sequence = ()):
        """Pad to the bucket and dispatch, returning the device results
        without fetching them (the card computes while the caller
        gathers the next batch; :func:`fetch_rows` later).  One bucket
        only: rows must fit ``max_batch``.  ``spans`` get the ``pad``
        phase and :meth:`_dispatch`'s."""
        n = _rows(batched)
        if n > self.max_batch:
            raise ValueError(
                f"dispatch_padded: {n} rows exceed the top bucket "
                f"{self.max_batch}; use run() for chunked serving")
        bucket = self.bucket_for(max(n, 1))
        for s in spans:
            s.phase_start("pad")
        return self._dispatch(pad_leading(batched, bucket - n), bucket,
                              spans)

    def warmup(self, sample_shapes, dtypes=None) -> float:
        """Run every bucket of the ladder once for one input signature:
        ``sample_shapes`` is a per-sample shape (no batch axis), or a
        list of them for a model of several inputs, ``dtypes`` matches
        element-wise (default float32).  Returns wall seconds."""
        multi = (sample_shapes and
                 isinstance(sample_shapes[0], (tuple, list)))
        shapes = list(sample_shapes) if multi else [sample_shapes]
        if dtypes is None:
            dts = [np.float32] * len(shapes)
        elif isinstance(dtypes, (tuple, list)):
            dts = list(dtypes)
        else:
            dts = [dtypes] * len(shapes)
        t0 = time.perf_counter()
        for b in self.buckets:
            arrs = tuple(np.zeros((b,) + tuple(s), dt)
                         for s, dt in zip(shapes, dts))
            fetch_rows(self._dispatch(arrs if multi else arrs[0], b), b)
        return time.perf_counter() - t0


def fetch_rows(device_tree, n: int, span=None):
    """Fetch dispatched device results to the host (the blocking copy
    waits for the computation) and strip the padding rows.  CPU results
    are copied: they may alias a staging buffer that is reused.  With a
    ``span`` the fetch closes the open ``execute`` phase: ``depad``
    starts once the bytes are on the host."""
    host = _map(lambda t: (t.cpu() if t.is_cuda else t.clone()).numpy(),
                device_tree)
    _profile.note_transfer("d2h")
    if span is not None:
        span.phase_start("depad")
    out = _slice_rows(host, 0, n)
    if span is not None:
        span.phase_end()
    return out


class _StagingArena:
    """Reusable host buffers for the dispatcher thread, one ring per
    (bucket, signature), that coalesced riders are gathered into
    directly: no per-group concatenate and pad allocations.

    Single owner (the dispatcher thread), so no locks.  On a CUDA device
    the buffers are pinned and the upload is a non-blocking copy that
    reads the buffer after the call returns, so a buffer must not be
    rewritten while its group is in flight: each ring holds ``depth``
    buffers, rotated per dispatch, and the coalescer caps its in-flight
    groups at ``depth`` and resolves them first in, first out, so by the
    time a buffer comes round again its group has been fetched (and the
    fetch waited for the upload)."""

    __slots__ = ("depth", "pinned", "_bufs", "_turn", "_pending")

    def __init__(self, depth: int, pinned: bool = False):
        self.depth = max(1, int(depth))
        self.pinned = pinned
        self._bufs: Dict[Tuple, List] = {}
        self._turn: Dict[Tuple, int] = {}
        self._pending: Optional[Tuple] = None

    def buffers_allocated(self) -> int:
        """Staging buffers currently held."""
        return sum(1 for ring in self._bufs.values()
                   for b in ring if b is not None)

    def commit(self):
        """Advance the ring of the last ``pack``ed key, only after its
        dispatch succeeded: a failed dispatch leaves its buffer free to
        rewrite, keeping rotation in step with the in-flight cap."""
        key = self._pending
        if key is not None:
            self._pending = None
            self._turn[key] = (self._turn[key] + 1) % self.depth

    def _alloc(self, shape, dtype):
        t = torch.from_numpy(np.zeros(shape, dtype))
        return t.pin_memory() if self.pinned else t

    def pack(self, group: Sequence["_Request"], bucket: int):
        """Gather ``group``'s rows into the current staging buffers of
        (bucket, signature), zero the padding tail, and return the padded
        batch (exactly ``bucket`` rows, host tensors, the riders'
        structure)."""
        head = group[0]
        key = (bucket, head.sig)
        ring = self._bufs.get(key)
        if ring is None:
            ring = self._bufs[key] = [None] * self.depth
            self._turn[key] = 0
        turn = self._turn[key]
        self._pending = key
        multi = isinstance(head.batched, (tuple, list))
        leaves0 = list(head.batched) if multi else [head.batched]
        bufs = ring[turn]
        if bufs is None:
            bufs = ring[turn] = [
                self._alloc((bucket,) + tuple(np.asarray(l).shape[1:]),
                            np.asarray(l).dtype)
                for l in leaves0]
        views = [b.numpy() for b in bufs]
        off = 0
        for r in group:
            leaves = (leaves0 if r is head else
                      (list(r.batched) if multi else [r.batched]))
            for view, leaf in zip(views, leaves):
                view[off:off + r.n] = leaf
            off += r.n
        if off < bucket:
            for view in views:
                view[off:bucket] = 0
        return tuple(bufs) if multi else bufs[0]


class _Request:
    # ``span`` is the explicit cross-thread trace handoff: contextvars do
    # not reach the dispatcher thread (started before this request
    # existed), so the pending request carries its span
    __slots__ = ("batched", "n", "sig", "future", "span")

    def __init__(self, batched, n, sig, span=None):
        self.batched = batched
        self.n = n
        self.sig = sig
        self.future: Future = Future()
        self.span = span


_SHUTDOWN = object()


class CoalescerClosedError(RuntimeError):
    """The dispatcher is gone: this request was (or would be) never
    served.  Its own type, so callers fall back to the solo path without
    masking errors of the model itself."""


class RequestCoalescer:
    """Pack concurrent predict() calls into one device dispatch, with the
    next batch gathered while the current one computes.

    Callers ``submit()`` into a bounded queue; one dispatcher thread
    takes the head request, gathers riders of the same signature until
    ``max_batch`` rows are packed, ``max_wait_ms`` elapses or the queue
    momentarily drains, stages them into one padded batch and dispatches
    it through ``cache`` without fetching, then goes back to gathering
    while the device computes (up to ``pipeline_depth`` groups in
    flight), and fetches and fans the rows out onto each caller's Future.
    A signature mismatch ends a group: the odd request leads the next.

    On a CUDA device the dispatcher thread runs on a stream of its own.
    ``semaphore`` (the owner's ``supported_concurrent_num`` bound) is
    held from dispatch to fetch, so coalesced work counts against the
    same budget as solo calls."""

    def __init__(self, cache: BucketedExecutableCache,
                 max_batch: Optional[int] = None,
                 max_wait_ms: float = 2.0,
                 semaphore: Optional[threading.Semaphore] = None,
                 pipeline_depth: int = 2,
                 queue_size: int = 1024):
        self._cache = cache
        self.max_batch = int(max_batch or cache.max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._sem = semaphore
        self.pipeline_depth = max(1, int(pipeline_depth))
        cuda = cache.device.type == "cuda"
        self._arena = _StagingArena(self.pipeline_depth, pinned=cuda)
        self._stream = torch.cuda.Stream(cache.device) if cuda else None
        if cuda:  # after the weights the caller wrote on its stream
            self._stream.wait_stream(torch.cuda.current_stream(cache.device))
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._carry: Optional[_Request] = None
        self.dispatches = 0
        self.coalesced_requests = 0
        # submitted-but-unresolved requests, and the subset already
        # dispatched: their difference is every rider that could still
        # arrive, so a group holding them all dispatches at once
        self._outstanding = 0
        self._out_lock = threading.Lock()
        self._inflight_n = 0
        self._closed = False
        # makes (closed check + enqueue) atomic against close()'s
        # (set closed + sentinel + drain)
        self._submit_lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._crashed = False
        self._inflight: "collections.deque" = collections.deque()
        self._thread = threading.Thread(
            target=self._loop, name="zoo-serving-dispatch", daemon=True)
        self._thread.start()

    @property
    def closed(self) -> bool:
        """True once close() ran or the dispatcher died."""
        return self._closed or not self._thread.is_alive()

    @property
    def pending(self) -> int:
        """Submitted-but-unresolved request count (queued + in flight)."""
        with self._out_lock:
            return self._outstanding

    def submit(self, batched, span=None) -> Future:
        """Queue one request; its Future resolves to its rows.  ``span``
        (the request's trace span) opens ``coalesce_wait`` here, on the
        caller's thread: the queue and the gathering, until the
        dispatcher starts the group's ``pad``."""
        n = _rows(batched)
        if n > self.max_batch:
            raise ValueError(
                f"coalesced request of {n} rows exceeds max_batch "
                f"{self.max_batch}; send it through the solo path")
        if span is not None:
            span.phase_start("coalesce_wait")
        req = _Request(batched, n, batch_signature(batched), span)
        with self._submit_lock:
            if self.closed:
                raise CoalescerClosedError(
                    "RequestCoalescer is closed; no dispatcher is serving "
                    "this queue")
            with self._out_lock:
                self._outstanding += 1
            self._q.put(req)
        if self._crashed or not self._thread.is_alive():
            # the dispatcher died between the aliveness check and the
            # enqueue: its crash net may have drained already, so fail
            # what is stranded here
            self._flush_queue(CoalescerClosedError(
                "RequestCoalescer dispatcher died"))
        return req.future

    def _done(self, k: int):
        with self._out_lock:
            self._outstanding -= k

    def _flush_queue(self, exc: BaseException):
        """Fail every queued (never dispatched) request with ``exc``; only
        once no dispatcher owns the queue."""
        with self._flush_lock:
            leftovers, self._carry = (
                [self._carry] if self._carry is not None else []), None
            try:
                while True:
                    r = self._q.get_nowait()
                    if r is not _SHUTDOWN:
                        leftovers.append(r)
            except queue.Empty:
                pass
            self._done(len(leftovers))
            for r in leftovers:
                if not r.future.done():
                    r.future.set_exception(exc)

    def close(self, timeout: float = 5.0):
        """Stop the dispatcher: queued requests are served first (the
        shutdown sentinel sits behind them), then anything racing the
        shutdown fails with CoalescerClosedError.  Idempotent."""
        with self._submit_lock:
            already = self._closed
            self._closed = True
            if not already and self._thread.is_alive():
                self._q.put(_SHUTDOWN)
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # wedged mid-group: it still owns the carry and the queue
            return
        self._flush_queue(CoalescerClosedError("RequestCoalescer closed"))

    # ---- dispatcher ----
    def _gather(self, block: bool,
                pipeline_busy: bool = False) -> Tuple[List[_Request], bool]:
        """One group: head + same-signature riders until the batch is
        full, the wait budget lapses, or the queue momentarily drains
        (callers block on their futures, so waiting on an empty queue
        only adds latency; a short grace absorbs staggered arrivals).
        Returns (group, shutdown_seen)."""
        grace = max(min(self.max_wait_ms / 8.0, 0.5), 0.05) / 1000.0
        head = self._carry
        self._carry = None
        if head is None:
            try:
                head = (self._q.get() if block
                        else self._q.get(timeout=grace))
            except queue.Empty:
                return [], False
            if head is _SHUTDOWN:
                return [], True
        group, count, rows = [head], 1, head.n
        deadline = time.perf_counter() + self.max_wait_ms / 1000.0
        while rows < self.max_batch:
            # every live request not yet dispatched is in this group:
            # nothing more can ride it, so dispatch now (unless a group
            # is in flight, whose riders will want seats here)
            if not pipeline_busy \
                    and count >= self._outstanding - self._inflight_n:
                break
            remaining = deadline - time.perf_counter()
            try:
                nxt = (self._q.get_nowait() if remaining <= 0
                       else self._q.get(timeout=min(remaining, grace)))
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                return group, True
            if nxt.sig != head.sig or rows + nxt.n > self.max_batch:
                self._carry = nxt
                break
            group.append(nxt)
            count += 1
            rows += nxt.n
        return group, False

    def _acquire_slot(self, inflight):
        """Take one device-concurrency slot without deadlocking: the
        dispatcher may hold every slot through unfetched groups, so on
        contention it resolves its oldest group first."""
        if self._sem is None:
            return
        while not self._sem.acquire(blocking=False):
            if inflight:
                self._resolve(inflight.popleft())
            else:
                self._sem.acquire()  # held by solo callers: wait
                return

    def _dispatch_group(self, group: List[_Request], inflight):
        """Stage into the arena and dispatch; returns the in-flight entry
        (group, rows, device results) or None when the dispatch failed
        (its callers already failed)."""
        try:
            spans = tuple(r.span for r in group if r.span is not None)
            for s in spans:
                s.phase_start("pad")  # ends coalesce_wait; the staging
            n = sum(r.n for r in group)
            bucket = self._cache.bucket_for(max(n, 1))
            batched = self._arena.pack(group, bucket)
            self._acquire_slot(inflight)
            try:
                dev = self._cache.dispatch_padded(batched, spans)
            except BaseException:
                if self._sem is not None:
                    self._sem.release()
                raise
            self._arena.commit()
            self.dispatches += 1
            self.coalesced_requests += len(group)
            self._inflight_n += len(group)
            return group, n, dev
        except BaseException as e:
            self._done(len(group))
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)
            return None

    def _resolve(self, item):
        """Fetch a dispatched group's results and fan the rows out."""
        group, n, dev = item
        try:
            out, err = fetch_rows(dev, n), None
        except BaseException as e:
            out, err = None, e
        # un-count before waking callers, so their resubmissions are not
        # double-counted by the next gather's early-dispatch check
        self._inflight_n -= len(group)
        self._done(len(group))
        try:
            off = 0
            for r in group:
                if r.span is not None:
                    if err is None:
                        r.span.phase_start("depad")
                    else:
                        r.span.phase_end()
                if err is None:
                    rows = _slice_rows(out, off, off + r.n)
                    off += r.n
                    if r.span is not None:
                        # closed before the caller wakes: the wake-up
                        # reads as the span's tail, not as depad
                        r.span.phase_end()
                if r.future.done():  # close() may have raced us
                    continue
                if err is None:
                    r.future.set_result(rows)
                else:
                    r.future.set_exception(err)
        finally:
            if self._sem is not None:
                self._sem.release()

    def _loop(self):
        try:
            if self._stream is None:
                self._loop_inner()
            else:
                with torch.cuda.device(self._cache.device), \
                        torch.cuda.stream(self._stream):
                    self._loop_inner()
        except BaseException as e:  # crash net: never strand a caller
            # closed before the drain, so a racing submit either sees it
            # or enqueues before the drain; bounded acquire (a submitter
            # blocked on a full queue holds the lock)
            got = self._submit_lock.acquire(timeout=1.0)
            self._closed = True
            self._crashed = True
            if got:
                self._submit_lock.release()
            self._flush_queue(e)
            # dispatched-but-unresolved groups die with us too
            while self._inflight:
                group = self._inflight.popleft()[0]
                self._done(len(group))
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
                if self._sem is not None:
                    self._sem.release()
            raise

    def _loop_inner(self):
        inflight = self._inflight
        shutdown = False
        while True:
            group: List[_Request] = []
            if not shutdown:
                if inflight and self._carry is None and self._q.empty():
                    # nothing to gather and groups in flight: their
                    # callers wait, so fetch the oldest now
                    self._resolve(inflight.popleft())
                group, shutdown = self._gather(
                    block=not inflight, pipeline_busy=bool(inflight))
            elif self._carry is not None:
                # a mismatched rider pulled before the sentinel is
                # still served
                group, _ = self._gather(block=False)
            if group:
                # arena safety: never stage while the pipeline is full
                while len(inflight) >= self.pipeline_depth:
                    self._resolve(inflight.popleft())
                disp = self._dispatch_group(group, inflight)
                if disp is not None:
                    inflight.append(disp)
            if inflight and (not group
                             or len(inflight) >= self.pipeline_depth):
                self._resolve(inflight.popleft())
            if shutdown and not inflight and self._carry is None:
                return
