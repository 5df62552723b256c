"""Serving fast path: shape-bucketed forwards, request coalescing and
replicated serving with hedging.

Counterpart of ``analytics_zoo_tpu/pipeline/inference/serving.py``.

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
* ``ReplicaSet`` serves one forward from several replicas.  The JAX
  package compiles once and deserialises the executable onto every
  device; torch has no such artifact, so here a replica is its own copy
  of the parameters (and buffers) on its device, run through the same
  function ``fn(params, x)`` (for a module, one skeleton through
  ``torch.func.functional_call``).  A signature's first run on replica 0
  is its *build*, reported once through
  ``observability.profile.note_compile``; its first run on every other
  replica is a *placement* (a prime), which counts as no build.  So one
  bucket costs one build however many replicas serve it, and
  re-activating a replica costs none.  Each CUDA replica runs on a
  ``torch.cuda.Stream`` of its own: the input copy, the forward and a
  completion event all live there, and the fetch reads the results on
  that stream.  The coalescer routes each group to the healthy replica
  with the fewest undelivered groups, retries a failed dispatch once on
  another replica, re-probes unhealthy replicas on an exponential
  backoff and, with hedging, re-dispatches a straggling group to a
  second replica and takes the first result.  A device may appear in
  ``devices`` more than once (two replicas on one card, each on its own
  stream).

Tracing (``observability/trace.py``): a request's span, when it has one,
records ``pad -> device_put -> execute -> depad`` (once per chunk of an
oversized batch) and, through the coalescer, ``coalesce_wait`` first;
the coalescer's pending request carries the span across to the
dispatcher thread, which activates the group's lead span around a
bucket's first run so that a compile-like event there (a kernel build,
a replica set's build) lands in that request's trace.  Replicated
dispatches label the span with ``replica``; hedges and retries add
``hedge`` and ``replica_retry`` events.  The phases time the host:
``execute`` runs from the dispatch to the end of the blocking fetch.
Without a span each site costs one ``None`` check; nothing waits for
the device to fill a phase or a label.

Padding safety: rows are independent in an inference forward (no batch
statistics, row-wise softmax), so filler rows cannot perturb real rows,
and a coalesced row equals a solo row run at the same bucket bit for
bit.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import os
import queue
import sys
import threading
import time
from concurrent.futures import (FIRST_COMPLETED, Future,
                                ThreadPoolExecutor)
from concurrent.futures import wait as _futures_wait
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ...common.context import resolve_device
from ...common.utils import pad_leading
from ...observability import profile as _profile
from ...observability import trace as _trace
from ...observability.log import get_logger as _get_logger
from ...observability.metrics import LatencyWindow as _LatencyWindow

_slog = _get_logger("zoo.serving")

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


def tree_map(fn, tree):
    """``fn`` over every leaf of a dict/list/tuple tree (``None`` leaves
    stay ``None``): batches, results and parameter trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree) -> List:
    """The leaves of a dict/list/tuple tree, in order."""
    out: List = []
    tree_map(out.append, tree)
    return out


def _rows(batched) -> int:
    first = batched[0] if isinstance(batched, (tuple, list)) else batched
    return int(np.asarray(first).shape[0])


def _slice_rows(tree, start: int, stop: int):
    return tree_map(lambda a: a[start:stop], tree)


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
        if isinstance(a, torch.Tensor):
            t = a
        else:
            a = np.ascontiguousarray(a)
            # a read-only view (a fleet frame decoded without a copy) is
            # copied here, once: a tensor must not alias memory that
            # nothing may write
            t = torch.from_numpy(a if a.flags.writeable else a.copy())
        return t.to(device, non_blocking=t.is_pinned())

    return tree_map(one, batched)


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


def _as_tensor(a) -> torch.Tensor:
    """A parameter leaf as a tensor: tensors as they are (detached), host
    arrays and scalars copied, float64 narrowed to f32 as the JAX
    package's ``device_put`` does without x64."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    arr = np.asarray(a)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.tensor(arr)


def place_tree(tree, device, copy: bool = False):
    """Every leaf of ``tree`` as a tensor on ``device``.  A tensor already
    there is kept (no second copy) unless ``copy``."""
    return tree_map(lambda a: _as_tensor(a).to(device, copy=copy), tree)


def module_twin(net, make):
    """A copy of the module ``net`` whose every parameter and buffer is
    ``make(tensor)`` (parameters stay ``Parameter``s, without gradients),
    in eval mode.  Training state (the trainer, generators, a cached
    quantized twin) is left out.  ``make`` runs before the copy, so no
    tensor of ``net`` is copied on its device first."""
    memo = {}
    for t in itertools.chain(net.parameters(), net.buffers()):
        twin = make(t.detach())
        memo[id(t)] = (torch.nn.Parameter(twin, requires_grad=False)
                       if isinstance(t, torch.nn.Parameter) else twin)
    for mod in net.modules():
        for key, value in vars(mod).items():
            if (isinstance(value, torch.Generator)
                    or key in ("trainer", "_quantized_net")):
                memo[id(value)] = None
    # a graph's nodes link to their inputs, so the copy recurses about
    # once per layer (ResNet-50 passes 1,000 levels)
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 20000))
    try:
        twin_net = copy.deepcopy(net, memo)
    finally:
        sys.setrecursionlimit(limit)
    return twin_net.eval()


def _norm_device(device) -> torch.device:
    """A concrete device: ``"cuda"`` gets the current index (checked
    against the card by ``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def available_devices(device=None) -> List[torch.device]:
    """Every device a replica set may take on ``device``'s platform: the
    process's cards for CUDA; for the CPU, one "device" per core (the
    counterpart of the JAX package's virtual host devices)."""
    dev = _norm_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        return [dev] + [torch.device("cuda", i) for i in range(n)
                        if i != dev.index]
    return [dev] * max(1, os.cpu_count() or 1)


def _host(tree) -> Any:
    """Blocking copy of device results to host numpy.  CPU results are
    copied: they may alias a staging buffer that is reused.  A replica's
    results are read on the replica's stream, after its event."""
    def one(t):
        return (t.cpu() if t.is_cuda else t.clone()).numpy()

    if isinstance(tree, _OnStream):
        tree.event.synchronize()
        with torch.cuda.stream(tree.stream):
            return tree_map(one, tree.tree)
    return tree_map(one, tree)


class _OnStream:
    """A replica dispatch's device results with the stream they were
    computed on and the event recorded after the forward."""

    __slots__ = ("tree", "stream", "event")

    def __init__(self, tree, stream, event):
        self.tree = tree
        self.stream = stream
        self.event = event


def _on_replica(replica: "Replica"):
    """The device and stream context a replica's work is issued in."""
    if replica.stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(replica.device))
    stack.enter_context(torch.cuda.stream(replica.stream))
    return stack


class Replica:
    """One replica of a :class:`ReplicaSet`: its device, its own copy of
    the params, its stream (CUDA) and per-replica serving counters.
    Counter writes happen under the owning cache's lock (the same lock as
    the bucket counters); ``healthy``, ``active`` and the probe-backoff
    fields flip under the replica set's lock.

    ``healthy`` tracks fault state (a dispatch raised; restored by a
    successful health re-probe).  ``active`` tracks the ELASTIC set: a
    deactivated replica keeps its params and its placed signatures —
    warm, idle, off the scheduler — so re-activation is a prime, never
    a build."""

    __slots__ = ("index", "device", "params", "stream", "healthy",
                 "active", "probe_at", "probe_backoff", "dispatches",
                 "bucket_dispatches")

    def __init__(self, index: int, device, params, stream=None):
        self.index = index
        self.device = device
        self.params = params
        self.stream = stream
        self.healthy = True
        self.active = True
        self.probe_at = 0.0        # perf_counter time of the next probe
        self.probe_backoff = 0.0   # current backoff step (seconds)
        self.dispatches = 0
        self.bucket_dispatches: Dict[int, int] = {}

    def __repr__(self):
        return (f"Replica({self.index}, {self.device}, "
                f"healthy={self.healthy}, active={self.active})")


class _Placed:
    """One replica's "executable" for one placed signature: the set's
    function over that replica's params.  ``execute`` takes the batch
    already on the replica's device (inside its stream context)."""

    __slots__ = ("_fn", "_replica")

    def __init__(self, fn: Callable, replica: Replica):
        self._fn = fn
        self._replica = replica

    def execute(self, args):
        return self._fn(self._replica.params, args)


class ReplicaSet:
    """One forward served by several replicas, each with its own copy of
    the params on its device (see the module docstring for what "build"
    and "placement" mean here).

    ``fn(params, x)`` maps a params tree (dicts, lists or tuples of
    tensors) and a batch on the replica's device to results there.
    ``params`` may hold numpy arrays or tensors; replica 0 serves the
    tensors placed on ``devices[0]`` (a tensor already there is used as
    it is, never copied again) and every other replica a copy of them on
    its device.  ``devices`` is a list of torch devices, repeats
    allowed; None takes every card of the process.

    Fault handling: a replica whose dispatch raises a ``RuntimeError``
    (how a device fails in torch) is marked unhealthy and the failed
    dispatch is retried once on another healthy replica by the owning
    cache.  An unhealthy replica is RE-PROBED with a warmed run on an
    exponential backoff (``maybe_reprobe``, driven from the coalescer
    loop and the solo scheduler) and a probe that returns flips it
    healthy.  When EVERY replica is unhealthy the set still serves
    through all of them — availability over purity, the gauge shows red
    until a probe succeeds.

    Elasticity: ``set_active(n)`` shrinks or grows the SCHEDULED set (the
    autoscaler's lever).  Deactivated replicas keep their params and
    placed signatures; re-activation primes every placed signature on
    the joining replica BEFORE it takes traffic, so a scale-up never
    serves a cold replica and never builds.
    """

    def __init__(self, fn: Callable, params, devices=None,
                 probe_backoff_s: float = 0.5,
                 probe_backoff_max_s: float = 30.0):
        self._fn = fn
        # the set's placement units: one device a replica here, one
        # device group a replica in serving/shardgroup.py; the build,
        # placement, scheduling and health machinery below is shared
        units = self._carve_units(devices)
        placed0 = self._place_params(params, units[0])
        replicas = [self._make_replica(0, units[0], placed0)]
        for i, unit in enumerate(units[1:], start=1):
            replicas.append(self._make_replica(
                i, unit, self._place_params(params, unit, placed0)))
        self.replicas: Tuple[Replica, ...] = tuple(replicas)
        # per-signature executables: key -> one _Placed per replica,
        # published under _lock AFTER the build and the placements
        self._exes: Dict[Tuple, Tuple] = {}
        self._multi: Dict[Tuple, bool] = {}
        self._lock = threading.Lock()
        self._compile_locks: Dict[Tuple, threading.Lock] = {}
        self._rr = 0
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        # fast-path gate for maybe_reprobe: one int compare
        self._unhealthy_count = 0
        # serializes probes (dispatcher + solo threads may both ask)
        self._probe_guard = threading.Lock()

    # ---- placement-unit hooks (overridden by ShardGroupSet) ----
    def _carve_units(self, devices) -> List:
        """The set's units: here its devices (every card when None)."""
        devs = ([_norm_device(d) for d in devices] if devices
                else available_devices("cuda"))
        if not devs:
            raise ValueError("ReplicaSet needs at least one device")
        return devs

    def _place_params(self, params, unit, first=None):
        """``params`` on one unit.  ``first`` is the first unit's
        placement, given for every later unit: here the source of its
        copy (a tensor already on the first device is used as it is)."""
        if first is None:
            return place_tree(params, unit)
        return place_tree(first, unit, copy=True)

    def _make_replica(self, index: int, unit, placed) -> Replica:
        replica = Replica(index, unit, placed)
        if unit.type == "cuda":
            replica.stream = torch.cuda.Stream(unit)
            # after the params the caller's stream just wrote
            replica.stream.wait_stream(torch.cuda.current_stream(unit))
        return replica

    def _make_exe(self, replica: Replica):
        """One replica's executable for a newly placed signature."""
        return _Placed(self._fn, replica)

    def span_labels(self, replica: Replica) -> Dict[str, Any]:
        """Labels the dispatch path stamps on request spans."""
        return {"replica": replica.index}

    @property
    def n(self) -> int:
        return len(self.replicas)

    @property
    def n_active(self) -> int:
        return sum(1 for r in self.replicas if r.active)

    @staticmethod
    def _key(batched) -> Tuple:
        leaves = (list(batched) if isinstance(batched, (tuple, list))
                  else [batched])
        return tuple((tuple(np.asarray(a).shape), str(np.asarray(a).dtype))
                     for a in leaves)

    @staticmethod
    def key_from(bucket: int, signature: Tuple) -> Tuple:
        """The placement key from a cache-level ``(bucket,
        batch_signature)`` pair: equal to ``_key`` of the padded batch
        without walking it again."""
        return tuple(((bucket,) + tuple(shape), dtype)
                     for shape, dtype in signature)

    def compiled_keys(self) -> int:
        """How many distinct signatures are placed."""
        return len(self._exes)

    def placement_complete(self, key: Optional[Tuple] = None) -> bool:
        """True when every replica holds ``key`` (or every placed key
        when None): the pager's install guard."""
        with self._lock:
            keys = [key] if key is not None else list(self._exes)
            return all(len(self._exes[k]) == len(self.replicas)
                       for k in keys if k in self._exes)

    def _run_once(self, replica: Replica, exe, batched):
        """Run ``batched`` on ``replica`` and wait for the results,
        without counters (a build, a placement, a prime or a probe)."""
        with _on_replica(replica), torch.no_grad():
            out = exe.execute(to_device(batched, replica.device))
            return _host(out)

    def ensure_compiled(self, batched, key: Optional[Tuple] = None
                        ) -> float:
        """Make ``batched``'s signature available on every replica: its
        build (the first run, on replica 0, reported once to
        ``observability.profile``) and a placement run on each other
        replica.  Returns the wall seconds spent (0.0 when already
        placed).  Thread-safe: different signatures build in parallel,
        one signature builds exactly once, and a build that raised stays
        retryable.  A replica whose placement run raises is marked
        unhealthy (its signature still counts as placed, so a heal never
        builds)."""
        if key is None:
            key = self._key(batched)
        if key in self._exes:
            return 0.0
        with self._lock:
            klock = self._compile_locks.setdefault(key, threading.Lock())
        with klock:
            if key in self._exes:
                return 0.0
            exes = tuple(self._make_exe(r) for r in self.replicas)
            t0 = time.perf_counter()
            self._run_once(self.replicas[0], exes[0], batched)
            _profile.note_compile(time.perf_counter() - t0,
                                  "replica-forward", kind="signature_build")
            for rep, exe in zip(self.replicas[1:], exes[1:]):
                try:
                    self._run_once(rep, exe, batched)
                except RuntimeError as e:
                    self.mark_unhealthy(rep, e)
            with self._lock:
                self._multi[key] = isinstance(batched, (tuple, list))
                self._exes[key] = exes  # publish last
            return time.perf_counter() - t0

    def dispatch(self, replica: Replica, batched, spans: Sequence = (),
                 key: Optional[Tuple] = None):
        """Upload one exactly-bucket-sized host batch to ``replica``'s
        device and run its placed executable there, on the replica's
        stream; returns the device results (an ``_OnStream`` on a card;
        fetch with :func:`fetch_rows`).  The signature must be placed
        (``ensure_compiled``): dispatch never builds.  ``spans`` get the
        ``device_put -> execute`` transitions."""
        if key is None:
            key = self._key(batched)
        exe = self._exes[key][replica.index]
        for s in spans:
            s.phase_start("device_put")
        with _on_replica(replica):
            dev_x = to_device(batched, replica.device)
            _profile.note_transfer("h2d")
            for s in spans:
                s.phase_start("execute")
            with torch.no_grad():
                out = exe.execute(dev_x)
            if replica.stream is None:
                return out
            event = torch.cuda.Event()
            event.record(replica.stream)
        return _OnStream(out, replica.stream, event)

    # ---- elasticity ----
    def _zeros_for(self, key: Tuple):
        """A host batch of a placed signature (the key is every leaf's
        shape and dtype)."""
        arrs = [np.zeros(shape, dtype) for shape, dtype in key]
        return tuple(arrs) if self._multi.get(key) else arrs[0]

    def _prime(self, replica: Replica) -> None:
        """Run every placed signature once on ``replica`` and wait for it
        (warm-before-activate, and the probe's body).  Never builds."""
        for key in list(self._exes):
            _host(self.dispatch(replica, self._zeros_for(key), key=key))

    def set_active(self, n: int) -> int:
        """Resize the scheduled replica set to ``n`` replicas (clamped to
        [1, total]); returns the active count.  HEALTH-AWARE, lowest
        index first: healthy replicas take the seats before unhealthy
        ones, which join unprimed (the scheduler routes around them until
        their probe heals).  Healthy joiners are primed BEFORE the flag
        flips; a joiner whose prime raises is marked unhealthy and the
        resize carries on.  Deactivation only unschedules: in-flight
        groups resolve normally and the replica keeps its warm state."""
        n = max(1, min(int(n), len(self.replicas)))
        chosen = {r.index for r in
                  sorted(self.replicas,
                         key=lambda r: (not r.healthy, r.index))[:n]}
        joining = [r for r in self.replicas
                   if r.index in chosen and not r.active]
        leaving = [r for r in self.replicas
                   if r.active and r.index not in chosen]
        for r in joining:
            if not r.healthy:
                continue  # never dispatch a prime to a red device
            try:
                self._prime(r)
            except RuntimeError as e:
                self.mark_unhealthy(r, e)
        with self._lock:
            for r in self.replicas:
                r.active = r.index in chosen
        if joining or leaving:
            _slog.info("replica_set_active", active=n,
                       total=len(self.replicas),
                       joined=[r.index for r in joining],
                       left=[r.index for r in leaving])
        return n

    # ---- health / scheduling ----
    def healthy_indices(self) -> List[int]:
        """Replica indices eligible for dispatch: active AND healthy;
        the active set when every active replica is red, then all."""
        out = [r.index for r in self.replicas if r.healthy and r.active]
        if out:
            return out
        out = [r.index for r in self.replicas if r.active]
        return out if out else [r.index for r in self.replicas]

    def mark_unhealthy(self, replica: Replica, exc: BaseException):
        now = time.perf_counter()
        with self._lock:
            if replica.healthy:
                replica.healthy = False
                self._unhealthy_count += 1
            replica.probe_backoff = max(replica.probe_backoff,
                                        self.probe_backoff_s)
            replica.probe_at = now + replica.probe_backoff
        _slog.error("replica_unhealthy", replica=replica.index,
                    device=str(replica.device),
                    probe_in_s=round(replica.probe_backoff, 3),
                    error=f"{type(exc).__name__}: {exc}")

    def maybe_reprobe(self) -> None:
        """Time-gated health re-probe of unhealthy replicas on an
        exponential backoff (``probe_backoff_s`` doubling to
        ``probe_backoff_max_s``).  The probe runs on a detached daemon
        thread, so a device that fails SLOWLY stalls the probe, not live
        traffic; a non-blocking guard keeps probes from stacking.  Cost
        when every replica is healthy: one int compare."""
        if not self._unhealthy_count:
            return
        now = time.perf_counter()
        due = [r for r in self.replicas
               if not r.healthy and r.probe_at <= now]
        if not due:
            return
        if not self._probe_guard.acquire(blocking=False):
            return
        threading.Thread(target=self._probe_due, args=(due,),
                         name="zoo-replica-probe", daemon=True).start()

    def _probe_due(self, due: List[Replica]) -> None:
        try:
            for r in due:
                self._probe(r)
        finally:
            self._probe_guard.release()

    def _probe(self, replica: Replica) -> bool:
        """One health probe: the smallest placed signature on
        ``replica``, fetched.  Success restores health (and resets the
        backoff); failure doubles it."""
        with self._lock:
            keys = list(self._exes)
        if not keys:
            return False  # nothing placed yet — nothing warm to probe
        key = min(keys, key=lambda k: k[0][0][0] if k and k[0][0] else 0)
        try:
            _host(self.dispatch(replica, self._zeros_for(key), key=key))
        except RuntimeError as e:
            with self._lock:
                replica.probe_backoff = min(replica.probe_backoff * 2.0
                                            or self.probe_backoff_s,
                                            self.probe_backoff_max_s)
                replica.probe_at = (time.perf_counter()
                                    + replica.probe_backoff)
            _slog.info("replica_probe_failed", replica=replica.index,
                       next_probe_in_s=round(replica.probe_backoff, 3),
                       error=f"{type(e).__name__}: {e}")
            return False
        with self._lock:
            if not replica.healthy:
                replica.healthy = True
                self._unhealthy_count -= 1
            replica.probe_backoff = self.probe_backoff_s
        _slog.info("replica_recovered", replica=replica.index,
                   device=str(replica.device))
        return True

    def retry_target(self, failed: Replica) -> Optional[Replica]:
        """A healthy replica other than ``failed`` (round-robin), or None.
        Inactive-but-healthy replicas are eligible: warm and idle."""
        with self._lock:
            cands = [r for r in self.replicas
                     if r.healthy and r is not failed]
            if not cands:
                return None
            self._rr += 1
            return cands[self._rr % len(cands)]

    def pick(self) -> Replica:
        """Round-robin over active healthy replicas (the solo path's
        scheduler, and its probe driver)."""
        self.maybe_reprobe()
        with self._lock:
            idxs = [r.index for r in self.replicas
                    if r.healthy and r.active]
            if not idxs:
                idxs = [r.index for r in self.replicas if r.active] \
                    or [r.index for r in self.replicas]
            self._rr += 1
            return self.replicas[idxs[self._rr % len(idxs)]]

    def stats(self) -> Dict[str, Any]:
        return {
            "replicas": len(self.replicas),
            "replicas_active": self.n_active,
            "replica_dispatches": {r.index: r.dispatches
                                   for r in self.replicas},
            "replica_unhealthy": {r.index: (not r.healthy)
                                  for r in self.replicas},
            "replica_active": {r.index: r.active
                               for r in self.replicas},
            "replica_bucket_dispatches": {
                r.index: dict(r.bucket_dispatches)
                for r in self.replicas},
        }


class BucketedExecutableCache:
    """Pad batches to a bucket ladder so that a ragged request stream
    runs the forward at a handful of shapes.

    ``fn`` maps a batch of device tensors (a tensor, or a tuple for a
    model of several inputs) to device results; ``device`` is where it
    runs.  This layer makes sure only ladder shapes reach it, counts
    hits, misses and build time per bucket, and un-pads results.
    Batches larger than the top bucket are served in top-bucket chunks
    (the tail padded).  ``device`` defaults to ``"cuda"``, as every
    entry point of the port does.  With a ``replica_set`` dispatches
    route to its replicas instead of ``fn`` (``device`` is replica 0's)."""

    def __init__(self, fn: Callable, max_batch: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 growth: float = 2.0, device=None,
                 replica_set: Optional[ReplicaSet] = None):
        self._fn = fn
        self.replica_set = replica_set
        self.device = (replica_set.replicas[0].device
                       if replica_set is not None
                       else resolve_device(device))
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

    def _note_build(self, bucket: int, secs: float):
        with self._lock:
            self.stats.build_time_s[bucket] = \
                self.stats.build_time_s.get(bucket, 0.0) + secs

    def _dispatch(self, batched, bucket: int, spans: Sequence = (),
                  replica: Optional[Replica] = None):
        """Run one exactly-bucket-sized padded host batch; returns the
        device results without fetching them.  A bucket's first run is
        its build: it is synchronised and timed.  ``spans`` (the riders'
        trace spans) get the bucket as a label and the ``device_put ->
        execute`` phases; ``execute`` stays open until the owner's
        ``depad``.  With a replica set the batch routes to ``replica``
        (or the round-robin pick), retried once on another replica if
        the dispatch raises."""
        signature = batch_signature(batched)
        fresh = self._note_lookup(bucket, signature)
        for s in spans:
            s.set_label("bucket", bucket)
        if self.replica_set is not None:
            return self._dispatch_replica(self.replica_set, batched,
                                          bucket, signature, fresh,
                                          spans, replica)
        for s in spans:
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
            self._note_build(bucket, time.perf_counter() - t0)
        return out

    def _dispatch_replica(self, rs: ReplicaSet, batched, bucket: int,
                          signature: Tuple, fresh: bool,
                          spans: Sequence,
                          replica: Optional[Replica]):
        """Replica half of ``_dispatch``: make sure the signature is
        placed, route to a replica, and retry ONCE on another healthy
        replica when the dispatch raises a ``RuntimeError`` (the failed
        one is marked unhealthy).  ``ensure_compiled`` runs
        unconditionally (one dict lookup when warm): a concurrent cold
        dispatch may still be mid-build, and a build that raised must
        stay retryable.  Host-side errors (``TypeError``, ``ValueError``,
        interrupts) propagate untouched: one bad request must not flip a
        healthy replica red."""
        key = ReplicaSet.key_from(bucket, signature)
        with (_trace.activate(spans[0]) if (fresh and spans)
              else _UNTRACED):
            secs = rs.ensure_compiled(batched, key=key)
        if secs:
            self._note_build(bucket, secs)
        if replica is None:
            replica = rs.pick()
        for s in spans:
            for lk, lv in rs.span_labels(replica).items():
                s.set_label(lk, lv)
        try:
            out = rs.dispatch(replica, batched, spans, key=key)
        except RuntimeError as e:
            rs.mark_unhealthy(replica, e)
            alt = rs.retry_target(replica)
            if alt is None:
                raise
            for s in spans:
                for lk, lv in rs.span_labels(alt).items():
                    s.set_label(lk, lv)
                s.event("replica_retry", failed=replica.index,
                        error=type(e).__name__)
            try:
                out = rs.dispatch(alt, batched, spans, key=key)
            except RuntimeError as e2:
                # no second retry: a model-level fault would loop over
                # every replica
                rs.mark_unhealthy(alt, e2)
                raise
            replica = alt
        with self._lock:
            replica.dispatches += 1
            replica.bucket_dispatches[bucket] = \
                replica.bucket_dispatches.get(bucket, 0) + 1
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

    def dispatch_padded(self, batched, spans: Sequence = (),
                        replica: Optional[Replica] = None):
        """Pad to the bucket and dispatch, returning the device results
        without fetching them (the card computes while the caller
        gathers the next batch; :func:`fetch_rows` later).  One bucket
        only: rows must fit ``max_batch``.  ``replica`` pins the
        dispatch to one replica of the set.  ``spans`` get the ``pad``
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
                              spans, replica=replica)

    def warmup(self, sample_shapes, dtypes=None,
               buckets: Optional[Sequence[int]] = None) -> float:
        """Run every bucket of the ladder once for one input signature
        (with a replica set: build each bucket once and place it on every
        replica).  ``sample_shapes`` is a per-sample shape (no batch
        axis), or a list of them for a model of several inputs,
        ``dtypes`` matches element-wise (default float32).  Returns wall
        seconds; each bucket's build milliseconds go through the
        structured logger (``warmup_bucket``)."""
        multi = (sample_shapes and
                 isinstance(sample_shapes[0], (tuple, list)))
        shapes = list(sample_shapes) if multi else [sample_shapes]
        if dtypes is None:
            dts = [np.float32] * len(shapes)
        elif isinstance(dtypes, (tuple, list)):
            dts = list(dtypes)
        else:
            dts = [dtypes] * len(shapes)
        rs = self.replica_set
        t0 = time.perf_counter()
        for b in (buckets or self.buckets):
            arrs = tuple(np.zeros((b,) + tuple(s), dt)
                         for s, dt in zip(shapes, dts))
            batched = arrs if multi else arrs[0]
            if rs is None:
                tb = time.perf_counter()
                fetch_rows(self._dispatch(batched, b), b)
                ms = (time.perf_counter() - tb) * 1e3
            else:
                # same counter protocol as the dispatch path; priming is
                # the placement inside ensure_compiled and bypasses the
                # dispatch counters
                self._note_lookup(b, batch_signature(batched))
                secs = rs.ensure_compiled(batched)
                if secs:
                    self._note_build(b, secs)
                ms = secs * 1e3
            _slog.info("warmup_bucket", bucket=b, compile_ms=round(ms, 3),
                       replicas=(rs.n if rs is not None else 1))
        return time.perf_counter() - t0


def fetch_rows(device_tree, n: int, span=None):
    """Fetch dispatched device results to the host (the blocking copy
    waits for the computation) and strip the padding rows.  With a
    ``span`` the fetch closes the open ``execute`` phase: ``depad``
    starts once the bytes are on the host."""
    host = _host(device_tree)
    _profile.note_transfer("d2h")
    if span is not None:
        span.phase_start("depad")
    out = _slice_rows(host, 0, n)
    if span is not None:
        span.phase_end()
    return out


class _StagingArena:
    """Reusable host buffers for the dispatcher thread, one ring per
    (slot, bucket, signature), that coalesced riders are gathered into
    directly: no per-group concatenate and pad allocations.

    Single owner (the dispatcher thread), so no locks.  On a CUDA device
    the buffers are pinned and the upload is a non-blocking copy that
    reads the buffer after the call returns, so a buffer must not be
    rewritten while its group is in flight: each slot's ring holds
    ``depth`` buffers, rotated per dispatch, and the coalescer caps a
    slot's in-flight groups at ``depth`` and resolves them first in,
    first out, so by the time a buffer comes round again its group has
    been fetched (and the fetch waited for the upload).  A hedge re-reads
    its group's buffer on a second replica, so the slot stays held until
    the losing fetch returns too."""

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

    def pack(self, group: Sequence["_Request"], bucket: int,
             slot: int = 0):
        """Gather ``group``'s rows into the current staging buffers of
        (slot, bucket, signature), zero the padding tail, and return the
        padded batch (exactly ``bucket`` rows, host tensors, the riders'
        structure)."""
        head = group[0]
        key = (slot, bucket, head.sig)
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

    With a multi-replica cache the pipeline widens to one in-flight slot
    per replica, and each group routes to the healthy replica with the
    fewest undelivered groups (least-outstanding-work), so group k+1
    runs on replica B while group k's fetch from replica A is still
    pending.  On a single CUDA device the dispatcher thread runs on a
    stream of its own; replicas run on theirs.  ``semaphore`` (the
    owner's ``supported_concurrent_num`` bound) is held from dispatch to
    fetch, so coalesced work counts against the same budget as solo
    calls.

    ``hedging`` (multi-replica only): a group whose in-flight age passes
    the ``hedge_quantile`` of observed group latencies (floored at
    ``hedge_min_ms``, once ``hedge_min_samples`` groups resolved) is
    re-dispatched from the same staged buffer to a second healthy replica,
    and the first result wins.  Every replica runs the same function on
    the same parameter values, so the winner's rows are the rows either
    replica would give on that device."""

    # forced loser-drain budget: a pending hedge loser still in flight
    # past this is treated as WEDGED (its replica marked unhealthy)
    # instead of blocking the dispatcher indefinitely
    _WEDGE_TIMEOUT_S = 30.0
    # the hedge threshold quantile is recomputed every N group resolves
    _HEDGE_THR_REFRESH = 32

    def __init__(self, cache: BucketedExecutableCache,
                 max_batch: Optional[int] = None,
                 max_wait_ms: float = 2.0,
                 semaphore: Optional[threading.Semaphore] = None,
                 pipeline_depth: int = 2,
                 queue_size: int = 1024,
                 hedging: bool = False,
                 hedge_quantile: float = 0.99,
                 hedge_min_ms: float = 0.5,
                 hedge_min_samples: int = 20):
        self._cache = cache
        self.max_batch = int(max_batch or cache.max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._sem = semaphore
        self.pipeline_depth = max(1, int(pipeline_depth))
        rs = cache.replica_set
        # one slot per replica (cap 1 each) when replicated; one slot
        # with the pipeline depth as its cap otherwise
        self._rs = rs if (rs is not None and rs.n > 1) else None
        self._n_slots = self._rs.n if self._rs is not None else 1
        self._slot_cap = 1 if self._rs is not None else self.pipeline_depth
        self._slot_inflight = [0] * self._n_slots
        self._slot_rr = 0
        cuda = cache.device.type == "cuda"
        self._arena = _StagingArena(self._slot_cap, pinned=cuda)
        self._stream = None
        if cuda and self._rs is None:
            self._stream = torch.cuda.Stream(cache.device)
            # after the weights the caller wrote on its stream
            self._stream.wait_stream(torch.cuda.current_stream(cache.device))
        self.hedging = bool(hedging) and self._rs is not None
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_min_ms = float(hedge_min_ms)
        self.hedge_min_samples = int(hedge_min_samples)
        self._group_lat = _LatencyWindow(maxlen=512)
        # dispatcher-thread-owned threshold cache: (value, window count)
        self._hedge_thr: Optional[float] = None
        self._hedge_thr_at = -1
        # dispatcher-thread-owned counters (read via dict copy)
        self._hedges = {"fired": 0, "primary_won": 0, "hedge_won": 0,
                        "skipped_no_replica": 0}
        self._hedge_pool: Optional[ThreadPoolExecutor] = None
        # loser futures already reported as wedged (entries leave when
        # their loser retires)
        self._wedged_reported: set = set()
        # hedge losers still reading a staging buffer: (primary_slot,
        # future, hedge_replica_index|None); the primary slot's in-flight
        # count stays held until the losing fetch returns
        self._pending_losers: List[Tuple[int, Future,
                                         Optional[int]]] = []
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

    def hedge_stats(self) -> Dict[str, int]:
        """Copy of the hedge outcome counters."""
        return dict(self._hedges)

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
            # nothing more can ride it, so dispatch now (unless the
            # pipeline is busy, whose riders will want seats here)
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

    def _pick_slot(self) -> int:
        """Least-outstanding-work: the healthy replica with the fewest
        undelivered groups, ties rotating round-robin; slot 0 when not
        replicated.  ONLY below-cap slots are eligible (the arena-safety
        invariant): the healthy set can shrink between the caller's
        capacity check and this pick, so it falls back to any below-cap
        slot (its buffer is free, and the cache's retry re-routes the
        execution)."""
        if self._rs is None:
            return 0
        idxs = [i for i in self._rs.healthy_indices()
                if self._slot_inflight[i] < self._slot_cap]
        if not idxs:
            idxs = [i for i in range(self._n_slots)
                    if self._slot_inflight[i] < self._slot_cap]
        rr = self._slot_rr
        slot = min(idxs, key=lambda i: (self._slot_inflight[i],
                                        (i - rr) % self._n_slots))
        self._slot_rr = (slot + 1) % self._n_slots
        return slot

    def _has_free_capacity(self) -> bool:
        """True when some eligible slot is below its in-flight cap."""
        if self._rs is None:
            return len(self._inflight) < self._slot_cap
        return any(self._slot_inflight[i] < self._slot_cap
                   for i in self._rs.healthy_indices())

    def _capacity(self) -> int:
        """Total undelivered-group capacity across eligible slots."""
        if self._rs is None:
            return self._slot_cap
        return len(self._rs.healthy_indices()) * self._slot_cap

    def _dispatch_group(self, group: List[_Request], inflight):
        """Stage into the arena and dispatch; returns the in-flight entry
        (group, rows, device results, slot, dispatch time, padded batch,
        placement key) or None when the dispatch failed (its callers
        already failed).  The padded batch and key ride along so that a
        hedge can re-dispatch the same staged buffer."""
        try:
            spans = tuple(r.span for r in group if r.span is not None)
            for s in spans:
                s.phase_start("pad")  # ends coalesce_wait; the staging
            n = sum(r.n for r in group)
            slot = self._pick_slot()
            bucket = self._cache.bucket_for(max(n, 1))
            batched = self._arena.pack(group, bucket, slot)
            replica = (self._rs.replicas[slot]
                       if self._rs is not None else None)
            key = (ReplicaSet.key_from(bucket, group[0].sig)
                   if self._rs is not None else None)
            self._acquire_slot(inflight)
            try:
                dev = self._cache.dispatch_padded(batched, spans,
                                                  replica=replica)
            except BaseException:
                if self._sem is not None:
                    self._sem.release()
                raise
            self._arena.commit()
            self.dispatches += 1
            self.coalesced_requests += len(group)
            self._inflight_n += len(group)
            # charged to the PICKED slot even if the cache's retry ran on
            # another replica: the count guards this slot's buffer
            self._slot_inflight[slot] += 1
            return group, n, dev, slot, time.perf_counter(), batched, key
        except BaseException as e:
            self._done(len(group))
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)
            return None

    # ---- resolve (plain + hedged) ----
    def _fetch_slot(self, dev, n: int, slot: int):
        """Blocking host fetch of a dispatched group (a method, so that a
        test can patch a straggler delay in per slot)."""
        return fetch_rows(dev, n)

    def _fetch_hedge(self, dev, n: int, replica_index: int):
        """Blocking host fetch of a hedge re-dispatch (a separate patch
        point: a test can delay the hedge to pin primary-wins)."""
        return fetch_rows(dev, n)

    def _hedge_threshold_s(self) -> Optional[float]:
        """The in-flight age past which a group is hedged: the
        ``hedge_quantile`` of observed group latencies, floored by
        ``hedge_min_ms``; None until ``hedge_min_samples`` groups
        resolved.  Recomputed every ``_HEDGE_THR_REFRESH`` resolves."""
        c = self._group_lat.count
        if c < self.hedge_min_samples:
            return None
        if (self._hedge_thr is None
                or c - self._hedge_thr_at >= self._HEDGE_THR_REFRESH):
            q = self._group_lat.percentile(self.hedge_quantile * 100.0)
            if q is None:
                return None
            self._hedge_thr = max(q, self.hedge_min_ms / 1e3)
            self._hedge_thr_at = c
        return self._hedge_thr

    def _hedge_target(self, slot: int) -> Optional[Replica]:
        """A healthy, ACTIVE replica other than the primary's, the least
        loaded one; None when there is none (hedging no-ops)."""
        rs = self._rs
        cands = [r for r in rs.replicas
                 if r.healthy and r.active and r.index != slot]
        if not cands:
            return None
        return min(cands, key=lambda r: self._slot_inflight[r.index])

    def _hedge_executor(self) -> ThreadPoolExecutor:
        if self._hedge_pool is None:
            # every in-flight slot could hold a straggling loser, plus
            # the next group's primary+hedge pair
            self._hedge_pool = ThreadPoolExecutor(
                max_workers=self._n_slots * self._slot_cap + 2,
                thread_name_prefix="zoo-serving-hedge")
        return self._hedge_pool

    def _swallow_loser(self, fut: Future):
        """Consume a losing fetch's outcome: its result is moot and its
        error must not propagate."""
        try:
            fut.result()
        except BaseException as e:  # noqa: BLE001 — deliberate sink
            _slog.info("hedge_loser_error",
                       error=f"{type(e).__name__}: {e}")

    def _drain_losers(self, block: bool = False) -> bool:
        """Retire finished hedge losers and release their slots.  A
        loser's upload read the SAME staging buffer as the primary, so
        the primary slot's count stays held until the losing fetch
        returns.  ``block`` (every slot pinned, nothing else can free
        one) waits for whichever pending loser finishes first, bounded
        by ``_WEDGE_TIMEOUT_S``: past it the still-pending losers'
        replicas are marked unhealthy.  Returns whether any retired."""
        retired = False
        remaining: List[Tuple[int, Future, Optional[int]]] = []
        for slot, fut, alt_idx in self._pending_losers:
            if fut.done():
                self._swallow_loser(fut)
                self._wedged_reported.discard(id(fut))
                if 0 <= slot < len(self._slot_inflight):
                    self._slot_inflight[slot] -= 1
                if alt_idx is not None:
                    self._slot_inflight[alt_idx] -= 1
                retired = True
            else:
                remaining.append((slot, fut, alt_idx))
        self._pending_losers = remaining
        if block and not retired and remaining:
            done, _ = _futures_wait([f for _, f, _ in remaining],
                                    timeout=self._WEDGE_TIMEOUT_S,
                                    return_when=FIRST_COMPLETED)
            if done:
                return self._drain_losers()
            self._mark_wedged_losers()
        return retired

    def _mark_wedged_losers(self):
        """Every pending loser outlived the wedge budget: mark each one's
        replica unhealthy (once per loser).  The slot counts stay held:
        only the fetch returning may release the buffer."""
        if self._rs is None:
            return
        for slot, fut, alt_idx in self._pending_losers:
            if id(fut) in self._wedged_reported:
                continue
            self._wedged_reported.add(id(fut))
            idx = alt_idx if alt_idx is not None else slot
            if 0 <= idx < len(self._rs.replicas):
                self._rs.mark_unhealthy(
                    self._rs.replicas[idx],
                    RuntimeError(
                        f"hedge loser fetch wedged for more than "
                        f"{self._WEDGE_TIMEOUT_S:g}s"))

    def _resolve(self, item):
        """Fetch a dispatched group's results and fan the rows out."""
        group, n, dev, slot, t0, batched, key = item
        if self.hedging:
            thr = self._hedge_threshold_s()
            if thr is not None:
                self._resolve_hedged(group, n, dev, slot, t0, batched,
                                     key, thr)
                return
            # unseeded window: no hedge can fire, so fetch inline
        try:
            out = self._fetch_slot(dev, n, slot)
            err = None
        except BaseException as e:
            out, err = None, e
        self._group_lat.add(time.perf_counter() - t0)
        self._retire(group, slot)
        self._fan_out(group, out, err)

    def _resolve_hedged(self, group: List[_Request], n: int, dev,
                        slot: int, t0: float, batched, key,
                        thr: float):
        """First-wins resolve: wait for the primary fetch until the
        group's in-flight age crosses ``thr``; past it, re-dispatch the
        SAME staged batch to a second healthy replica and take whichever
        result lands first.  The loser's slot accounting is deferred to
        :meth:`_drain_losers`."""
        pool = self._hedge_executor()
        fut_p = pool.submit(self._fetch_slot, dev, n, slot)
        # the window learns the PRIMARY's latency, win or lose: the
        # first-wins latency would feed the threshold its own output
        fut_p.add_done_callback(
            lambda _f, _t0=t0: self._group_lat.add(
                time.perf_counter() - _t0))
        fut_h = None
        alt = None
        remaining = (t0 + thr) - time.perf_counter()
        done, _ = _futures_wait([fut_p], timeout=max(remaining, 0.0))
        if not done:
            alt = self._hedge_target(slot)
            if alt is None:
                self._hedges["skipped_no_replica"] += 1
            else:
                try:
                    dev2 = self._rs.dispatch(alt, batched, key=key)
                except RuntimeError as e:
                    # a failed hedge never fails the group: the primary
                    # is still in flight and authoritative
                    self._rs.mark_unhealthy(alt, e)
                    alt = None
                else:
                    self._hedges["fired"] += 1
                    self._slot_inflight[alt.index] += 1
                    bucket = _rows(batched)
                    with self._cache._lock:
                        alt.dispatches += 1
                        alt.bucket_dispatches[bucket] = \
                            alt.bucket_dispatches.get(bucket, 0) + 1
                    fut_h = pool.submit(self._fetch_hedge, dev2, n,
                                        alt.index)
        winner, loser = fut_p, None
        if fut_h is not None:
            done, _ = _futures_wait([fut_p, fut_h],
                                    return_when=FIRST_COMPLETED)
            winner = fut_p if fut_p in done else fut_h
            loser = fut_h if winner is fut_p else fut_p
        try:
            out = winner.result()
            err = None
        except BaseException as e:
            if loser is not None:
                # the winner crashed first: the other dispatch may still
                # deliver the group (bounded: a wedged loser must not
                # stall the dispatcher)
                _futures_wait([loser], timeout=self._WEDGE_TIMEOUT_S)
                if loser.done():
                    try:
                        out, err = loser.result(), None
                    except BaseException as e2:
                        out, err = None, e2
                    winner, loser = loser, None
                else:
                    out, err = None, e
                    idx = alt.index if loser is fut_h else slot
                    self._wedged_reported.add(id(loser))
                    self._rs.mark_unhealthy(
                        self._rs.replicas[idx],
                        RuntimeError(
                            f"hedge fetch wedged for more than "
                            f"{self._WEDGE_TIMEOUT_S:g}s"))
            else:
                out, err = None, e
        if fut_h is not None and err is None:
            # recorded only once a result was delivered: a hedge that
            # finished first by CRASHING is no win
            outcome = ("primary_won" if winner is fut_p
                       else "hedge_won")
            self._hedges[outcome] += 1
            for r in group:
                if r.span is not None:
                    r.span.event("hedge", outcome=outcome,
                                 primary_slot=slot,
                                 hedge_replica=alt.index)
        self._inflight_n -= len(group)
        alt_released = fut_h is None
        if loser is not None and not loser.done():
            # the slot stays owned until the losing fetch returns
            pend_alt = None
            if loser is fut_h:
                pend_alt = alt.index  # _drain_losers releases it
                alt_released = True
            self._pending_losers.append((slot, loser, pend_alt))
        else:
            if loser is not None:
                self._swallow_loser(loser)
            if 0 <= slot < len(self._slot_inflight):
                self._slot_inflight[slot] -= 1
        if not alt_released:
            self._slot_inflight[alt.index] -= 1
        self._done(len(group))
        self._fan_out(group, out, err)

    def _retire(self, group: List[_Request], slot: int):
        """Un-count a resolved group before waking its callers, so their
        resubmissions are not double-counted by the next gather."""
        self._inflight_n -= len(group)
        if 0 <= slot < len(self._slot_inflight):
            self._slot_inflight[slot] -= 1
        self._done(len(group))

    def _fan_out(self, group: List[_Request], out, err):
        """Fan a fetched group's rows (or its error) onto each caller's
        future and release the device-concurrency slot."""
        try:
            if err is None:
                off = 0
                for r in group:
                    if r.span is not None:
                        r.span.phase_start("depad")
                    rows = _slice_rows(out, off, off + r.n)
                    if r.span is not None:
                        # closed before the caller wakes: the wake-up
                        # reads as the span's tail, not as depad
                        r.span.phase_end()
                    if not r.future.done():  # close() may have raced us
                        r.future.set_result(rows)
                    off += r.n
            else:
                for r in group:
                    if r.span is not None:
                        r.span.phase_end()
                    if not r.future.done():
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
        finally:
            # no buffer is staged after the loop ends, so loser fetches
            # may finish unobserved (wait=False: a wedged one must not
            # hang shutdown)
            if self._hedge_pool is not None:
                self._hedge_pool.shutdown(wait=False)

    def _loop_inner(self):
        inflight = self._inflight
        shutdown = False
        while True:
            if self._pending_losers:
                self._drain_losers()
            if self._rs is not None:
                # due unhealthy replicas get their probe (one int
                # compare when everything is green)
                self._rs.maybe_reprobe()
            group: List[_Request] = []
            if not shutdown:
                if inflight and self._carry is None and self._q.empty():
                    # nothing to gather and groups in flight: their
                    # callers wait, so fetch the oldest now
                    self._resolve(inflight.popleft())
                # one device: any group in flight means no urgency;
                # replicated: urgency ends once every slot is occupied
                busy = (bool(inflight) if self._rs is None
                        else len(inflight) >= self._capacity())
                group, shutdown = self._gather(
                    block=not inflight, pipeline_busy=busy)
            elif self._carry is not None:
                # a mismatched rider pulled before the sentinel is
                # still served
                group, _ = self._gather(block=False)
            if group:
                # arena safety: never stage while every eligible slot is
                # at its cap: resolve FIFO (or wait out a hedge loser)
                while not self._has_free_capacity():
                    if inflight:
                        self._resolve(inflight.popleft())
                    elif self._pending_losers:
                        self._drain_losers(block=True)
                    else:
                        break
                disp = self._dispatch_group(group, inflight)
                if disp is not None:
                    inflight.append(disp)
            if inflight and (not group
                             or len(inflight) >= self._capacity()):
                self._resolve(inflight.popleft())
            if shutdown and not inflight and self._carry is None:
                while self._pending_losers:
                    if not self._drain_losers(block=True):
                        _slog.info("shutdown_abandons_wedged_losers",
                                   n=len(self._pending_losers))
                        break
                return
