"""Dataset: host-side numpy batching for the trainer.

Counterpart of ``analytics_zoo_tpu/data/dataset.py``: the in-memory
dataset (``from_ndarray``, ``from_iterable``/``from_rdd``, ``size``,
``batches``, ``map``, ``steps_per_epoch`` and ``shard_by_process``, a
rank's rows of a pod with ``valid`` flags for the rows wrapped around to
even the shards), the streams (``from_loader``, ``from_batch_iterable``,
:class:`StreamingDataset`: lazy pull, rebatching, a windowed shuffle and
a lazy ``map``), ``check_batch_divisibility``, ``shard_batch`` and the
``prefetch_iterator`` shim.  Every shuffle draws
``np.random.default_rng(seed + epoch)`` exactly as the JAX package does,
so both packages see the same batches in the same order from the same
seed, streams included.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Iterable, Iterator, List, Optional,
                    Tuple)

import numpy as np

from ..common.prefetch import prefetch


def _stack_tree(samples: List[Any]):
    """Stack a list of samples (arrays, or tuples/lists of arrays)."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(
            _stack_tree([s[i] for s in samples]) for i in range(len(first)))
    return np.stack(samples)


class Dataset:
    """A finite, re-iterable dataset of (x, y) numpy pairs (y may be
    None; x and y may be tuples of arrays)."""

    def __init__(self, x, y=None, size: Optional[int] = None, valid=None):
        self.x = x
        self.y = y
        self._size = size
        #: per-row validity (None: every row); False marks the filler
        #: rows ``shard_by_process`` wraps around, which ``evaluate``
        #: leaves out of every metric
        self.valid = valid

    @classmethod
    def from_ndarray(cls, x, y=None) -> "Dataset":
        xs = x if isinstance(x, (tuple, list)) else [x]
        n = len(np.asarray(xs[0]))
        for a in xs:
            if len(np.asarray(a)) != n:
                raise ValueError("All input arrays must share length")
        if y is not None:
            for a in (y if isinstance(y, (tuple, list)) else [y]):
                if len(np.asarray(a)) != n:
                    raise ValueError("x and y must share length")
        return cls(x, y, size=n)

    @classmethod
    def from_iterable(cls, samples: Iterable, size: Optional[int] = None
                      ) -> "Dataset":
        """From an iterable of (x, y) samples, stacked into arrays (an
        "rdd" here is any iterable of samples local to this process)."""
        samples = list(samples)
        xs = [s[0] for s in samples]
        ys = [s[1] for s in samples] if isinstance(
            samples[0], (tuple, list)) and len(samples[0]) > 1 else None
        x = _stack_tree(xs)
        y = _stack_tree(ys) if ys is not None else None
        return cls(x, y, size=len(samples))

    #: the reference's ``TFDataset.from_rdd`` name for ``from_iterable``
    from_rdd = from_iterable

    @classmethod
    def from_loader(cls, loader) -> "StreamingDataset":
        """Stream the (x, y) batches of an ``ImageLoader`` (or any object
        that re-iterates batches, with ``files`` giving its length)
        without materializing them: training over a folder larger than
        host memory."""
        n = len(getattr(loader, "files", []) or []) or None

        def factory(shuffle, seed, epoch):
            if hasattr(loader, "shuffle"):
                loader.shuffle = shuffle
            if hasattr(loader, "seed") and hasattr(loader, "_epoch"):
                # the loader's own per-epoch order from (seed, epoch)
                loader.seed = seed
                loader._epoch = epoch
            return iter(loader)

        ds = StreamingDataset(factory, size=n)
        ds._can_shuffle = hasattr(loader, "shuffle")
        return ds

    @classmethod
    def from_batch_iterable(cls, make_iter: Callable[[], Iterable],
                            size: Optional[int] = None,
                            steps_per_epoch: Optional[int] = None,
                            shuffle_buffer: Optional[int] = 8192,
                            ) -> "StreamingDataset":
        """Stream from a zero-argument factory returning an iterator of
        (x, y) numpy batches of any sizes, rebatched to the requested
        batch size.

        The factory cannot reorder its source, so ``shuffle=True``
        shuffles through a window: ``shuffle_buffer`` rows (8192 by
        default) are collected, permuted with the epoch's seed and
        emitted; the tail short of a batch carries into the next window.
        Memory stays near one window.  ``shuffle_buffer=None`` replays the
        source order (with one warning).  A row moves at most about one
        window from its place in the source: shuffle at the source too
        when it is strongly ordered (sorted by label)."""
        ds = StreamingDataset(lambda shuffle, seed, epoch: make_iter(),
                              size=size, steps_hint=steps_per_epoch)
        ds._can_shuffle = False
        ds._shuffle_buffer = shuffle_buffer
        return ds

    @property
    def size(self) -> int:
        if self._size is None:
            first = self.x[0] if isinstance(self.x, (tuple, list)) else self.x
            self._size = len(np.asarray(first))
        return self._size

    @staticmethod
    def _index(arrs, idx):
        if arrs is None:
            return None
        if isinstance(arrs, (tuple, list)):
            return tuple(np.asarray(a)[idx] for a in arrs)
        return np.asarray(arrs)[idx]

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, epoch: int = 0, drop_remainder: bool = True,
                ) -> Iterator[Tuple[Any, Any]]:
        """Yield (x, y) numpy batches; ``drop_remainder`` drops the
        trailing partial batch, as the JAX package's training does."""
        n = self.size
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(idx)
        steps = (n // batch_size if drop_remainder
                 else math.ceil(n / batch_size))
        for s in range(steps):
            sel = idx[s * batch_size:(s + 1) * batch_size]
            yield self._index(self.x, sel), self._index(self.y, sel)

    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        if drop_remainder:
            return self.size // batch_size
        return math.ceil(self.size / batch_size)

    def shard_by_process(self, process_index: Optional[int] = None,
                         process_count: Optional[int] = None) -> "Dataset":
        """This rank's shard of a pod's data: rows strided
        (``x[pid::nproc]``), the ragged edge wrapped around so that every
        shard holds ``ceil(n / nproc)`` rows (equal step counts keep the
        ranks in lockstep); the wrapped filler rows are flagged False in
        ``.valid``.  Defaults: the process's rank and the world size;
        on a mesh with axes other than the data axes, pass
        ``mesh.data_index(mesh)`` and ``mesh.dp_size(mesh)``: ranks
        that differ only there feed the same rows."""
        from ..parallel import distributed as dist_lib
        pid = (process_index if process_index is not None
               else dist_lib.process_index())
        pc = (process_count if process_count is not None
              else dist_lib.process_count())
        n = self.size
        per = math.ceil(n / pc)
        raw = np.arange(pid, pid + per * pc, pc)
        idx = raw % n
        valid = raw < n
        return Dataset(self._index(self.x, idx), self._index(self.y, idx),
                       size=per, valid=None if valid.all() else valid)

    def map(self, fn: Callable, batched: bool = False,
            batch_size: int = 4096) -> "Dataset":
        """Apply ``fn`` now.  ``batched=False``: ``fn`` maps one (x, y)
        sample (the reference's per-record Preprocessing).
        ``batched=True``: ``fn`` maps an (x_batch, y_batch) pair and runs
        on ``batch_size`` rows at a time, one Python call a chunk."""
        n = self.size
        if batched:
            xs, ys = [], []
            for s in range(0, n, batch_size):
                sel = np.arange(s, min(s + batch_size, n))
                out = fn((self._index(self.x, sel), self._index(self.y,
                                                                sel)))
                xs.append(out[0])
                ys.append(out[1])
            cat = lambda parts: (
                tuple(np.concatenate([p[i] for p in parts])
                      for i in range(len(parts[0])))
                if isinstance(parts[0], (tuple, list))
                else np.concatenate(parts))
            x = cat(xs)
            y = cat(ys) if ys[0] is not None else None
            return Dataset(x, y, size=n, valid=self.valid)
        xs, ys = [], []
        for i in range(n):
            out = fn((self._index(self.x, i), self._index(self.y, i)))
            xs.append(out[0])
            ys.append(out[1])
        x = _stack_tree(xs)
        y = _stack_tree(ys) if ys[0] is not None else None
        return Dataset(x, y, size=n, valid=self.valid)


def _batch_rows(batch) -> int:
    x = batch[0] if isinstance(batch, tuple) and len(batch) == 2 else batch
    first = x[0] if isinstance(x, (tuple, list)) else x
    return len(first)


def _batch_concat_all(batches):
    """Concatenate a list of (x, y) batches tree-wise (y may be None)."""
    def cat(parts):
        if parts[0] is None:
            return None
        if isinstance(parts[0], (tuple, list)):
            return tuple(np.concatenate([p[i] for p in parts])
                         for i in range(len(parts[0])))
        return np.concatenate(parts)
    return cat([b[0] for b in batches]), cat([b[1] for b in batches])


def _batch_slice(batch, start, stop):
    def sl(u):
        if u is None:
            return None
        if isinstance(u, (tuple, list)):
            return tuple(ui[start:stop] for ui in u)
        return u[start:stop]
    return sl(batch[0]), sl(batch[1])


def _batch_take(batch, idx):
    """Row-permute an (x, y) batch tree by an index array."""
    def tk(u):
        if u is None:
            return None
        if isinstance(u, (tuple, list)):
            return tuple(np.asarray(ui)[idx] for ui in u)
        return np.asarray(u)[idx]
    return tk(batch[0]), tk(batch[1])


class StreamingDataset(Dataset):
    """Batches streamed from a re-iterable source: nothing is held beyond
    the current window, so data larger than host memory trains in
    bounded memory.

    ``factory(shuffle, seed, epoch)`` returns a fresh iterator of (x, y)
    numpy batches of any sizes; ``batches()`` cuts them to the requested
    batch size, one concatenate per emitted batch.  The size is unknown
    (None) until one pass has run, unless given."""

    def __init__(self, factory: Callable, size: Optional[int] = None,
                 steps_hint: Optional[int] = None):
        super().__init__(None, None, size=size)
        self._factory = factory
        self._steps_hint = steps_hint
        self._maps: List[Callable] = []

    @property
    def size(self) -> Optional[int]:
        return self._size  # None until one full pass has run

    def map(self, fn: Callable, batched: bool = False
            ) -> "StreamingDataset":
        """A lazy map: ``fn`` runs on each sample (``batched=False``, as
        ``Dataset.map``) or on each streamed (x, y) batch
        (``batched=True``) as the stream is pulled."""
        if batched:
            wrapped = fn
        else:
            def wrapped(batch, _fn=fn):
                x, y = batch
                n = _batch_rows(batch)

                def at(u, i):
                    if u is None:
                        return None
                    if isinstance(u, (tuple, list)):
                        return tuple(ui[i] for ui in u)
                    return u[i]

                outs = [_fn((at(x, i), at(y, i))) for i in range(n)]
                xs = _stack_tree([o[0] for o in outs])
                ys = (_stack_tree([o[1] for o in outs])
                      if outs and outs[0][1] is not None else None)
                return xs, ys
        child = StreamingDataset(self._factory, size=self._size,
                                 steps_hint=self._steps_hint)
        child._maps = self._maps + [wrapped]
        child._can_shuffle = self._can_shuffle
        child._shuffle_buffer = self._shuffle_buffer
        return child

    _can_shuffle = True
    _shuffle_buffer: Optional[int] = None
    _warned_no_shuffle = False

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, epoch: int = 0, drop_remainder: bool = True,
                ) -> Iterator[Tuple[Any, Any]]:
        if shuffle and not self._can_shuffle:
            if self._shuffle_buffer:
                yield from self._windowed_shuffle_batches(
                    batch_size, seed, epoch, drop_remainder)
                return
            if not StreamingDataset._warned_no_shuffle:
                StreamingDataset._warned_no_shuffle = True
                from ..observability.log import get_logger
                get_logger("analytics_zoo_tpu_torch.data").warning(
                    "this stream source cannot shuffle and has "
                    "shuffle_buffer=None — every epoch replays the "
                    "source order. Shuffle at the source or pass a "
                    "shuffle_buffer to from_batch_iterable.")
        src = self._ingest(self._factory(shuffle, seed, epoch))
        # the pending chunks and their row count: one concatenate per
        # emitted batch (growing one buffer per source chunk would copy
        # the window once a chunk, on the thread that feeds the device)
        pending: List[Tuple[Any, Any]] = []
        rows = 0
        count = 0
        for chunk in src:
            pending.append(chunk)
            rows += _batch_rows(chunk)
            while rows >= batch_size:
                window = pending[0] if len(pending) == 1 else \
                    _batch_concat_all(pending)
                pending = []
                n = _batch_rows(window)
                start = 0
                while n - start >= batch_size:
                    yield _batch_slice(window, start, start + batch_size)
                    start += batch_size
                    count += batch_size
                if start < n:
                    pending = [_batch_slice(window, start, n)]
                rows = n - start
        if rows:
            count += rows
            if not drop_remainder:
                yield (pending[0] if len(pending) == 1
                       else _batch_concat_all(pending))
        if self._size is None:
            self._size = count  # learned after one full pass

    def _ingest(self, src) -> Iterator[Tuple[Any, Any]]:
        """Source chunks as (x, y) tuples through the lazy map chain: the
        one ingest path of the ordered and the shuffled iterators."""
        for chunk in src:
            if not (isinstance(chunk, tuple) and len(chunk) == 2):
                chunk = (chunk, None)
            for fn in self._maps:
                chunk = fn(chunk)
            yield chunk

    def _windowed_shuffle_batches(self, batch_size: int, seed: int,
                                  epoch: int, drop_remainder: bool
                                  ) -> Iterator[Tuple[Any, Any]]:
        """The windowed shuffle of a source that cannot reorder itself:
        collect ``_shuffle_buffer`` rows, permute them with
        ``default_rng(seed + epoch)``, emit whole batches and carry the
        tail into the next window.  The same draws as the JAX package's,
        so both emit the same batches in the same order."""
        rng = np.random.default_rng(seed + epoch)
        window_rows = max(int(self._shuffle_buffer), batch_size)
        src = self._ingest(self._factory(False, seed, epoch))
        pending: List[Tuple[Any, Any]] = []
        rows = 0
        count = 0

        def drain(final):
            nonlocal pending, rows, count
            window = (pending[0] if len(pending) == 1
                      else _batch_concat_all(pending))
            n = _batch_rows(window)
            perm = rng.permutation(n)
            window = _batch_take(window, perm)
            start = 0
            while n - start >= batch_size:
                yield _batch_slice(window, start, start + batch_size)
                start += batch_size
                count += batch_size
            if start < n:
                if final:
                    count += n - start
                    if not drop_remainder:
                        yield _batch_slice(window, start, n)
                    pending, rows = [], 0
                else:
                    pending = [_batch_slice(window, start, n)]
                    rows = n - start
            else:
                pending, rows = [], 0

        for chunk in src:
            pending.append(chunk)
            rows += _batch_rows(chunk)
            if rows >= window_rows:
                yield from drain(final=False)
        if rows:
            yield from drain(final=True)
        if self._size is None:
            self._size = count

    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        if self._size is not None:
            return super().steps_per_epoch(batch_size, drop_remainder)
        if self._steps_hint is not None:
            return self._steps_hint
        raise ValueError("unknown stream length — pass steps_per_epoch to "
                         "from_batch_iterable or iterate one epoch first")

    def shard_by_process(self, process_index=None, process_count=None):
        raise NotImplementedError(
            "shard a stream at the source (give each host its own file "
            "list / loader) rather than wrapping shard_by_process around "
            "it")


def check_batch_divisibility(batch_size: int, dp: int, n_processes: int = 1):
    """The reference's contract lifted to the mesh: the global batch
    divides the data-parallel degree and the number of data shards fed
    by processes, so every shard is equal."""
    if batch_size % max(dp, 1) != 0:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by the data-"
            f"parallel degree ({dp}) — same invariant as the reference's "
            "batch_size % total_core_num == 0")
    if batch_size % max(n_processes, 1) != 0:
        raise ValueError(
            f"global batch_size ({batch_size}) must be divisible by the "
            f"number of host processes ({n_processes}) for per-host "
            "feeding")


def shard_batch(batch, sharding):
    """Place a global host batch (the same on every rank) onto the mesh:
    each rank keeps its block under ``sharding.spec`` (a DTensor a leaf;
    None stays None)."""
    import torch
    from ..parallel.mesh import device_of
    from ..parallel.sharding import local_shard, to_dtensor
    mesh, spec = sharding.mesh, tuple(sharding.spec)

    def place(a):
        if a is None:
            return None
        full = torch.as_tensor(np.asarray(a))
        return to_dtensor(local_shard(full, spec, mesh).to(device_of(mesh)),
                          spec, mesh)

    if isinstance(batch, (tuple, list)):
        return type(batch)(place(a) for a in batch)
    return place(batch)


def prefetch_iterator(iterator: Iterator, put_fn: Callable, depth: int = 2):
    """``depth`` items of ``put_fn(item)`` in flight ahead of the
    consumer, ``put_fn`` run on a background thread
    (:func:`~analytics_zoo_tpu_torch.common.prefetch.prefetch`)."""
    return prefetch(iterator, transform=put_fn, depth=depth)
