"""Dataset: host-side numpy batching for the trainer.

Counterpart of ``analytics_zoo_tpu/data/dataset.py``, reduced to the
in-memory dataset: ``from_ndarray``, ``size``, ``batches`` and
``shard_by_process`` (a rank's rows of a pod, with ``valid`` flags for
the rows wrapped around to even the shards), ``check_batch_divisibility``,
``shard_batch`` and the ``prefetch_iterator`` shim.  The shuffle draws
``np.random.default_rng(seed + epoch)`` exactly as the JAX package does,
so both packages see the same batch order from the same seed.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np

from ..common.prefetch import prefetch


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
