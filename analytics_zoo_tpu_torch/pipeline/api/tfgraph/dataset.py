"""TFDataset: the input handle of a TF graph trained by the port.

Counterpart of ``analytics_zoo_tpu/pipeline/api/tfgraph/dataset.py``
(reference ``TFDataset``, pyzoo/zoo/pipeline/api/net.py:432-509): host
arrays, one ``tf.placeholder`` a slot shaped ``[None] + shape``
(registered in a TF collection so ``TFOptimizer`` finds the dataset
behind the placeholders its loss reads), and the reference's
``batch_size % cores == 0``, here over the data-parallel degree of the
running mesh (else the number of processes).  The arrays need no TF; the
placeholders do.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ....data.dataset import check_batch_divisibility
from ....parallel import distributed as dist_lib
from ....parallel import mesh as mesh_lib
from .._convert_util import require_module

_COLLECTION = "analytics_zoo_tpu_tfdataset"


def _data_parallel_degree() -> int:
    """The cores a global batch divides over: the running mesh's data
    axes, else the processes of the job."""
    mesh = mesh_lib.get_active_mesh()
    if mesh is not None:
        return max(mesh_lib.dp_size(mesh), 1)
    return max(dist_lib.process_count(), 1)


class TFDataset:
    """Input pipeline feeding a user-written TF graph trained by the
    port."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int = -1,
                 batch_per_core: int = -1, has_label: bool = True,
                 val_arrays: Optional[Sequence[np.ndarray]] = None):
        if (batch_size > 0) == (batch_per_core > 0):
            raise ValueError(
                "set exactly one of batch_size (global, training) or "
                "batch_per_core (inference)")
        n_cores = _data_parallel_degree()
        if batch_size > 0:
            check_batch_divisibility(batch_size, n_cores)
            self.batch_size = batch_size
        else:
            self.batch_size = batch_per_core * n_cores
        self.has_label = has_label
        self.arrays = [np.asarray(a) for a in arrays]
        self.val_arrays = ([np.asarray(a) for a in val_arrays]
                           if val_arrays is not None else None)
        self._placeholders: Optional[List[Any]] = None

    @classmethod
    def from_ndarray(cls, tensors, batch_size: int = -1,
                     batch_per_core: int = -1, has_label: bool = True,
                     val_tensors=None) -> "TFDataset":
        if isinstance(tensors, np.ndarray):
            tensors = [tensors]
        return cls(list(tensors), batch_size, batch_per_core, has_label,
                   val_arrays=val_tensors)

    @classmethod
    def from_rdd(cls, rdd, names=None, shapes=None, types=None,
                 batch_size: int = -1, batch_per_core: int = -1,
                 has_label: bool = True, val_rdd=None) -> "TFDataset":
        """Reference ``from_rdd``: an "rdd" is any iterable of
        ndarray-lists (one element a sample)."""
        samples = [s if isinstance(s, (list, tuple)) else [s] for s in rdd]
        arrays = [np.stack([np.asarray(s[i]) for s in samples])
                  for i in range(len(samples[0]))]
        val_arrays = None
        if val_rdd is not None:
            vs = [s if isinstance(s, (list, tuple)) else [s]
                  for s in val_rdd]
            val_arrays = [np.stack([np.asarray(s[i]) for s in vs])
                          for i in range(len(vs[0]))]
        return cls(arrays, batch_size, batch_per_core, has_label,
                   val_arrays=val_arrays)

    @property
    def tensors(self) -> List[Any]:
        """One ``tf.placeholder`` a slot, shaped ``[None] + shape``, made
        in the current default graph and registered for discovery.  Needs
        tensorflow."""
        tf = require_module("tensorflow", "TFDataset.tensors")
        if self._placeholders is None:
            g = tf.compat.v1.get_default_graph()
            phs = []
            for i, a in enumerate(self.arrays):
                ph = tf.compat.v1.placeholder(
                    tf.dtypes.as_dtype(a.dtype), [None] + list(a.shape[1:]),
                    name=f"zoo_tpu_input_{i}")
                g.add_to_collection(_COLLECTION, (ph.op.name, i, self))
                phs.append(ph)
            self._placeholders = phs
        return self._placeholders

    @property
    def feature_tensors(self) -> List[Any]:
        return self.tensors[:-1] if self.has_label else self.tensors

    @property
    def label_tensor(self):
        if not self.has_label:
            raise ValueError("dataset built with has_label=False")
        return self.tensors[-1]

    def get_num_partitions(self) -> int:
        return _data_parallel_degree()


def find_dataset(graph, placeholder_names: Sequence[str]) -> Tuple[
        "TFDataset", List[int]]:
    """The registered TFDataset behind the placeholders, and each
    placeholder's slot."""
    registry = {name: (idx, ds)
                for name, idx, ds in graph.get_collection(_COLLECTION)}
    datasets = set()
    slots = []
    dataset = None
    for name in placeholder_names:
        if name not in registry:
            raise ValueError(
                f"placeholder {name!r} feeds the loss but was not created "
                "by a TFDataset (use dataset.tensors as model inputs)")
        idx, ds = registry[name]
        slots.append(idx)
        datasets.add(id(ds))
        dataset = ds
    if len(datasets) != 1:
        raise ValueError("loss depends on more than one TFDataset")
    return dataset, slots
