"""Feature-assembly helpers for the recommendation models.

Counterpart of ``analytics_zoo_tpu/models/recommendation_utils.py`` (the
reference's ``models/recommendation/utils.py``), a copy of its numpy
code: the port imports nothing of the JAX package.  ``WideAndDeep``
takes the dense form of the reference's sparse wide tensor: one id per
wide column, offset into the concatenated wide space, which the model
turns into a sparse-linear lookup (an ``Embedding`` row sum).
``hash_bucket`` hashes with crc32, so ids are the same in every process.

``row`` below is any mapping from column name to value (a plain dict or
a ``pandas`` Series).
"""

from typing import Dict, List, Optional, Sequence, Tuple
import zlib

import numpy as np

from .recommendation import ColumnFeatureInfo, UserItemFeature


def hash_bucket(content, bucket_size: int = 1000, start: int = 0) -> int:
    """Stable string hash into ``bucket_size`` buckets.

    Unlike the reference (python ``hash``, randomized per process since
    PEP 456), this uses crc32 so feature ids are reproducible across
    runs — required for checkpoint/resume to see the same vocabulary.
    """
    h = zlib.crc32(str(content).encode("utf-8"))
    return h % bucket_size + start


def categorical_from_vocab_list(value, vocab_list: Sequence,
                                default: int = -1, start: int = 0) -> int:
    try:
        return list(vocab_list).index(value) + start
    except ValueError:
        return default + start


def get_boundaries(target, boundaries: Sequence[float],
                   default: int = -1, start: int = 0) -> int:
    if target == "?":
        return default + start
    for i, b in enumerate(boundaries):
        if target < b:
            return i + start
    return len(boundaries) + start


def get_negative_samples(indexed: Sequence[Tuple[int, int]],
                         item_count: Optional[int] = None,
                         neg_per_pos: int = 1,
                         seed: int = 0) -> List[Tuple[int, int]]:
    """Sample (user, item) pairs the user has NOT interacted with.

    Reference delegates to BigDL ``getNegativeSamples``; here it is a
    pure-numpy implementation: for each positive (user, item) pair draw
    ``neg_per_pos`` items uniformly from the items outside the user's
    positive set.  Ids are 1-based, matching the models' LookupTable
    semantics.
    """
    pos_by_user: Dict[int, set] = {}
    for u, i in indexed:
        pos_by_user.setdefault(int(u), set()).add(int(i))
    if item_count is None:
        item_count = max(i for _, i in indexed)
    rs = np.random.RandomState(seed)
    out: List[Tuple[int, int]] = []
    for u, i in indexed:
        pos = pos_by_user[int(u)]
        if len(pos) >= item_count:
            continue
        for _ in range(neg_per_pos):
            j = int(rs.randint(1, item_count + 1))
            while j in pos:
                j = int(rs.randint(1, item_count + 1))
            out.append((int(u), j))
    return out


def get_wide_tensor(row, column_info: ColumnFeatureInfo) -> np.ndarray:
    """Offset each wide column's id into the concatenated wide space.

    Raises on ids outside [0, dim) — an out-of-range id (e.g. the -1 an
    unhandled OOV default produces) would otherwise silently land in an
    adjacent column's bucket range.
    """
    cols = list(column_info.wide_base_cols) + list(column_info.wide_cross_cols)
    dims = list(column_info.wide_base_dims) + list(column_info.wide_cross_dims)
    ids, acc = [], 0
    for i, col in enumerate(cols):
        if i > 0:
            acc += dims[i - 1]
        v = int(row[col])
        if not 0 <= v < dims[i]:
            raise ValueError(
                f"wide column {col!r}: id {v} outside [0, {dims[i]}) — "
                f"reserve an OOV bucket (e.g. default=0, start=1 with "
                f"dim+1) instead of letting unknowns go negative")
        ids.append(acc + v)
    return np.asarray(ids, dtype=np.int32)


def get_deep_tensor(row, column_info: ColumnFeatureInfo) -> np.ndarray:
    """Multi-hot indicators, then raw embed ids, then continuous values."""
    ind_cols = list(column_info.indicator_cols)
    ind_dims = list(column_info.indicator_dims)
    tail_cols = list(column_info.embed_cols) + list(column_info.continuous_cols)
    width = sum(ind_dims) + len(tail_cols)
    deep = np.zeros((width,), dtype=np.float32)
    acc = 0
    for i, col in enumerate(ind_cols):
        if i > 0:
            acc += ind_dims[i - 1]
        val = row[col]
        for v in (val if isinstance(val, (list, tuple, set, np.ndarray))
                  else (val,)):
            v = int(v)
            if not 0 <= v < ind_dims[i]:
                raise ValueError(
                    f"indicator column {col!r}: id {v} outside "
                    f"[0, {ind_dims[i]}) — would corrupt a neighboring "
                    f"feature slot; reserve an OOV bucket instead")
            deep[acc + v] = 1.0
    for i, col in enumerate(tail_cols):
        deep[sum(ind_dims) + i] = float(row[col])
    return deep


def row_to_feature(row, column_info: ColumnFeatureInfo,
                   model_type: str = "wide_n_deep"):
    """Assemble the model input for one row (reference row_to_sample)."""
    model_type = model_type.lower()
    if model_type == "wide_n_deep":
        return (get_wide_tensor(row, column_info),
                get_deep_tensor(row, column_info))
    if model_type == "wide":
        return (get_wide_tensor(row, column_info),)
    if model_type == "deep":
        return (get_deep_tensor(row, column_info),)
    raise TypeError("Unsupported model_type: %s" % model_type)


def to_user_item_feature(row, column_info: ColumnFeatureInfo,
                         model_type: str = "wide_n_deep") -> UserItemFeature:
    try:
        label = row[column_info.label]
    except (KeyError, IndexError):
        label = None
    return UserItemFeature(int(row["userId"]), int(row["itemId"]),
                           row_to_feature(row, column_info, model_type),
                           label=None if label is None else int(label))


def features_to_arrays(pairs: Sequence[UserItemFeature]):
    """Stack a list of UserItemFeatures into model-input arrays + labels."""
    first = pairs[0].feature
    n_parts = len(first) if isinstance(first, (tuple, list)) else 1
    if n_parts == 1:
        x = np.stack([p.feature if not isinstance(p.feature, (tuple, list))
                      else p.feature[0] for p in pairs])
    else:
        x = [np.stack([p.feature[i] for p in pairs]) for i in range(n_parts)]
    labels = [p.label for p in pairs]
    y = None if any(l is None for l in labels) \
        else np.asarray(labels, dtype=np.int32)
    return x, y


def row_to_sample(row, column_info: ColumnFeatureInfo,
                  model_type: str = "wide_n_deep"):
    """Reference ``row_to_sample`` (utils.py:88): the BigDL Sample is a
    feature+LABEL record, so this returns ``(feature, label)`` — unlike
    ``row_to_feature``, which assembles features only."""
    try:
        label = row[column_info.label]
    except (KeyError, IndexError):
        label = None
    return (row_to_feature(row, column_info, model_type),
            None if label is None else int(label))
