"""Checkpoints in the JAX package's flat format.

Counterpart of ``save_checkpoint``/``restore_checkpoint`` in
``analytics_zoo_tpu/train/checkpoint.py``: ``ckpt_<tag>.npz`` holds the
leaves of a tree as ``arr_0 .. arr_{n-1}``, and ``ckpt_<tag>.json`` their
names (the ``/``-joined key paths, in the tree's order), the tag and a
``meta`` dict.  A tree is nested dicts and lists of tensors, arrays or
numbers; ``None`` leaves are skipped.  Restoring fills a template tree:
by name, or by position when the names differ but the count and every
shape match (auto-named layers of another process).  Commit manifests,
sharded and asynchronous saves are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs of ``tree`` in its order; ``None`` is skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix or "leaf", tree)]
    out = []
    for key, sub in items:
        out += flatten(sub, f"{prefix}/{key}" if prefix else str(key))
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, tag: Any, tree, overwrite: bool = True,
                    meta: Optional[dict] = None) -> str:
    """Write ``tree`` as ``ckpt_<tag>.npz`` and ``ckpt_<tag>.json`` under
    ``directory``; the npz is written to a temporary name and renamed."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{tag}.npz")
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists and overwrite=False "
                              "(reference setCheckpoint overWrite semantics)")
    named = flatten(tree)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f"arr_{i}": _host(leaf)
                     for i, (_, leaf) in enumerate(named)})
    os.replace(tmp, path)
    manifest = {"names": [n for n, _ in named], "tag": str(tag),
                "meta": meta or {}}
    with open(os.path.join(directory, f"ckpt_{tag}.json"), "w") as f:
        json.dump(manifest, f)
    return path


def latest_tag(directory: str) -> Optional[str]:
    """The tag with the largest trailing number (``epoch3`` after
    ``epoch2``), or None when ``directory`` holds no checkpoint."""
    if not os.path.isdir(directory):
        return None
    tags = [m.group(1) for f in os.listdir(directory)
            if (m := re.match(r"ckpt_(.+)\.npz$", f))
            and not f.endswith(".tmp.npz")]
    if not tags:
        return None

    def key(t):
        m = re.search(r"(\d+)$", t)
        return int(m.group(1)) if m else -1
    return max(tags, key=key)


def read_meta(directory: str, tag: Any = None) -> dict:
    tag = latest_tag(directory) if tag is None else tag
    with open(os.path.join(directory, f"ckpt_{tag}.json")) as f:
        return json.load(f).get("meta", {})


def restore_checkpoint(directory: str, template, tag: Any = None):
    """The leaves of ``ckpt_<tag>`` (the newest tag when None) as numpy
    arrays, as (name, array) pairs in the order of ``template``'s leaves.
    Leaves are matched by name, or by position when the names differ but
    the count and every shape match; anything else raises."""
    if tag is None:
        tag = latest_tag(directory)
        if tag is None:
            raise FileNotFoundError(f"No checkpoints in {directory}")
    with np.load(os.path.join(directory, f"ckpt_{tag}.npz")) as data:
        leaves = [data[f"arr_{i}"] for i in range(len(data.files))]
    with open(os.path.join(directory, f"ckpt_{tag}.json")) as f:
        names = json.load(f)["names"]
    want = flatten(template)
    saved = dict(zip(names, leaves))
    if [n for n, _ in want] != names and set(saved) >= {n for n, _ in want}:
        pairs = [(n, saved[n]) for n, _ in want]
    elif len(want) == len(leaves):
        pairs = [(n, a) for (n, _), a in zip(want, leaves)]
    else:
        raise ValueError(
            f"checkpoint {tag} has {len(leaves)} leaves, the model "
            f"{len(want)}, and their names differ")
    for (name, tmpl), (_, arr) in zip(want, pairs):
        if tuple(np.shape(tmpl)) != tuple(arr.shape):
            raise ValueError(f"checkpoint {tag}: {name} has shape "
                             f"{arr.shape}, the model {tuple(np.shape(tmpl))}")
    return pairs


def restore_into(directory: str, template, tag: Any = None):
    """:func:`restore_checkpoint`, copied in place into the tensors of
    ``template``; returns the (name, array) pairs."""
    pairs = restore_checkpoint(directory, template, tag)
    with torch.no_grad():
        for (_, dst), (_, src) in zip(flatten(template), pairs):
            if isinstance(dst, torch.Tensor):
                dst.copy_(torch.from_numpy(np.array(src)))
    return pairs
