"""Dataset: host-side numpy batching for the trainer.

Counterpart of ``analytics_zoo_tpu/data/dataset.py``, reduced to the
in-memory dataset the training slice needs: ``from_ndarray``, ``size``
and ``batches``, and the ``prefetch_iterator`` shim.  The shuffle draws
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

    def __init__(self, x, y=None, size: Optional[int] = None):
        self.x = x
        self.y = y
        self._size = size

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


def prefetch_iterator(iterator: Iterator, put_fn: Callable, depth: int = 2):
    """``depth`` items of ``put_fn(item)`` in flight ahead of the
    consumer, ``put_fn`` run on a background thread
    (:func:`~analytics_zoo_tpu_torch.common.prefetch.prefetch`)."""
    return prefetch(iterator, transform=put_fn, depth=depth)
