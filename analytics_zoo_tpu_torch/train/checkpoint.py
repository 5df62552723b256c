"""Checkpoints in the JAX package's on-disk formats: commit manifests,
the sharded format, asynchronous saves, and restore by name.

Counterpart of ``analytics_zoo_tpu/train/checkpoint.py``; the files are
the JAX package's, byte for byte in layout, so each package restores the
other's saves.

* Flat (``save_checkpoint``): ``ckpt_<tag>.npz`` holds the leaves of a
  tree as ``arr_0 .. arr_{n-1}``, and ``ckpt_<tag>.json`` their names
  (the ``/``-joined key paths), the tag and a ``meta`` dict.
* Sharded (``save_sharded``): every process writes
  ``ckpt_<tag>.shard-p<rank>.npz``, keyed ``"<leaf index>|<global
  index>"``, and rank 0 the manifest ``ckpt_<tag>.json`` with ``format``,
  ``n_processes``, ``names``, ``shapes`` and ``dtypes``.  A DTensor leaf
  (a sharded trainer's weights and moments) is written block by block,
  each block by the one rank that is its first replica (coordinate 0 on
  every mesh axis that does not split it: the JAX package's
  ``replica_id == 0`` rule); any other leaf is whole on every rank and
  rank 0 writes it.  The commit waits for every rank's file.

A tree is nested dicts (flattened in sorted key order, as
``jax.tree_util`` flattens them) and lists or tuples of tensors, arrays
or numbers.  Every save ends with the commit manifest
``ckpt_<tag>.commit.json`` (byte sizes and sha256 of every file, written
to a temporary file, fsynced and renamed): only committed tags are
restored, a tag that fails its checksums at restore is deleted and the
next complete one taken.  A crash may cost steps, never a torn restore.
Restore matches leaves by name (auto-numbers stripped, then shape), so a
renamed layer (``register_restore_rename``) or a leaf added since the
save (``register_restore_default``) is bridged, and anything else fails
loudly.  Restore returns host arrays, or, for the leaves that
``shardings`` places, DTensors holding this rank's blocks; the trainer
copies them into its tensors on their device.  The format keeps global
indices, so a save from one mesh shape restores onto any other.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import logging
import os
import re
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import distributed as dist_lib
from . import faults
from . import metrics as train_metrics

_log = logging.getLogger("analytics_zoo_tpu_torch.train.checkpoint")


# ------------------------------------------------------------- trees ----

def _items(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def _flatten(tree, none_leaves: bool = False, prefix: str = ""):
    """(names, leaves) of ``tree``: dicts in sorted key order, lists and
    tuples in order.  ``None`` is skipped, or kept as a structural leaf
    under ``none_leaves`` (the sharded format's leaf indices count it)."""
    names, leaves = [], []
    if tree is None and not none_leaves:
        return names, leaves
    if not _is_node(tree):
        return [prefix or "leaf"], [tree]
    for key, sub in _items(tree):
        n, l = _flatten(sub, none_leaves,
                        f"{prefix}/{key}" if prefix else key)
        names += n
        leaves += l
    return names, leaves


def flatten(tree) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs of ``tree`` in its flattened order."""
    names, leaves = _flatten(tree)
    return list(zip(names, leaves))


def _unflatten(template, leaves, none_leaves: bool = False):
    """``template``'s structure with its leaves replaced by ``leaves``
    (in :func:`_flatten` order)."""
    it = iter(leaves)

    def rebuild(t):
        if t is None and not none_leaves:
            return None
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)

    return rebuild(template)


def _host(leaf) -> np.ndarray:
    """A leaf as a host array (a copy of a tensor, on the calling
    thread, so the caller may update the tensor right after)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _host_tree(tree):
    names, leaves = _flatten(tree)
    return names, [_host(l) for l in leaves]


# -------------------------------------------------------------- flat ----

def save_checkpoint(directory: str, tag: Any, tree, overwrite: bool = True,
                    meta: Optional[dict] = None) -> str:
    """Write ``tree`` as ``ckpt_<tag>.npz`` and ``ckpt_<tag>.json``, then
    commit the tag."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{tag}.npz")
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists and overwrite=False "
                              "(reference setCheckpoint overWrite semantics)")
    names, leaves = _host_tree(tree)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f"arr_{i}": a for i, a in enumerate(leaves)})
    os.replace(tmp, path)
    manifest = {"names": names, "tag": str(tag), "meta": meta or {}}
    with open(os.path.join(directory, f"ckpt_{tag}.json"), "w") as f:
        json.dump(manifest, f)
    # the commit manifest is the last write: its rename is the one event
    # that makes this tag restorable
    _write_commit(directory, tag, [f"ckpt_{tag}.npz", f"ckpt_{tag}.json"],
                  1)
    train_metrics.record_ckpt_save("flat")
    return path


_PENDING: list = []


def _start_writer(directory: str, target) -> threading.Thread:
    t = threading.Thread(target=target, daemon=True)
    t.start()
    _PENDING.append((os.path.abspath(directory), t))
    return t


def async_save(directory: str, tag: Any, tree, meta: Optional[dict] = None):
    """Copy the leaves to the host now, then write on a daemon thread."""
    names, leaves = _host_tree(tree)
    host = _unflatten(tree, leaves)
    return _start_writer(directory, lambda: save_checkpoint(
        directory, tag, host, meta=meta))


def wait_pending(directory: Optional[str] = None):
    """Join the writer threads: all of them, or those writing into
    ``directory`` (one trainer's fit never waits for another's
    snapshot)."""
    want = None if directory is None else os.path.abspath(directory)
    remaining = []
    while _PENDING:
        d, t = _PENDING.pop()
        if want is None or d == want:
            t.join()
        else:
            remaining.append((d, t))
    _PENDING.extend(remaining)


# daemon writers die with the interpreter; without this a short script
# could exit before its last snapshot is written
atexit.register(wait_pending)


# --------------------------------------------------- commit protocol ----

_COMMIT_VERSION = 1
_COMMIT_WAIT_S = 120.0  # async pod commit: wait for every rank's shard


def _commit_path(directory: str, tag: Any) -> str:
    return os.path.join(directory, f"ckpt_{tag}.commit.json")


def _digest_file(path: str, chunk: int = 1 << 20) -> Tuple[int, str]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            size += len(block)
            h.update(block)
    return size, h.hexdigest()


def _write_commit(directory: str, tag: Any, filenames, n_processes: int):
    files = {}
    for fn in filenames:
        size, sha = _digest_file(os.path.join(directory, fn))
        files[fn] = {"bytes": size, "sha256": sha}
    payload = {"version": _COMMIT_VERSION, "tag": str(tag),
               "n_processes": n_processes, "files": files}
    path = _commit_path(directory, tag)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    train_metrics.record_ckpt_commit()


def read_commit(directory: str, tag: Any) -> Optional[dict]:
    """The commit manifest of ``tag``, or None when the tag was never
    committed (a torn or in-flight save, or a save from before the
    commit protocol)."""
    try:
        with open(_commit_path(directory, tag)) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload.get("files"), dict):
        return None
    return payload


def verify_commit(directory: str, tag: Any,
                  deep: bool = False) -> Tuple[bool, str]:
    """Check every file the commit covers: present at its byte size, and
    under ``deep`` (restore time) at its sha256."""
    commit = read_commit(directory, tag)
    if commit is None:
        return False, "no commit manifest"
    for fn, rec in commit["files"].items():
        path = os.path.join(directory, fn)
        try:
            size = os.path.getsize(path)
        except OSError:
            return False, f"{fn} missing"
        if size != rec.get("bytes"):
            return False, (f"{fn} is {size} bytes, commit recorded "
                           f"{rec.get('bytes')}")
        if deep:
            _, sha = _digest_file(path)
            if sha != rec.get("sha256"):
                return False, f"{fn} sha256 mismatch"
    return True, "ok"


def discard_tag(directory: str, tag: Any) -> None:
    """Delete every file of ``tag`` (a corrupt tag must not be selected
    again); another process deleting the same files is harmless."""
    tag_re = re.escape(str(tag))
    pats = [rf"ckpt_{tag_re}(\.shard-p\d+)?\.npz(\.tmp\.npz)?$",
            rf"ckpt_{tag_re}\.json$",
            rf"ckpt_{tag_re}\.commit\.json(\.tmp)?$"]
    for f in os.listdir(directory):
        if any(re.match(p, f) for p in pats):
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass


def _all_tags(directory: str) -> set:
    tags = set()
    for f in os.listdir(directory):
        if f.endswith(".tmp.npz"):  # an aborted or in-flight write
            continue
        m = re.match(r"ckpt_(.+?)(\.shard-p\d+)?\.npz$", f)
        if m:
            tags.add(m.group(1))
    return tags


def _numeric_tag_key(t):
    m = re.search(r"(\d+)$", t)
    return int(m.group(1)) if m else -1


def latest_tag(directory: str) -> Optional[str]:
    """The newest complete tag: only tags whose commit manifest passes
    the shallow check are candidates.  A directory where no tag has a
    commit (saves from before the protocol, the port's earlier flat
    saves) keeps the newest-tag rule."""
    if not os.path.isdir(directory):
        return None
    tags = _all_tags(directory)
    if not tags:
        return None
    committed = {t for t in tags if read_commit(directory, t) is not None}
    if committed:
        candidates = [t for t in committed
                      if verify_commit(directory, t)[0]]
        if not candidates:
            return None  # every committed tag is damaged: cold start
    else:
        candidates = sorted(tags)
    return max(candidates, key=_numeric_tag_key)


def _resolve_tag(directory: str, tag: Any):
    """The tag to restore.  An explicit ``tag`` is deep-verified when
    committed and raises on a mismatch.  ``tag=None``: the newest
    complete tag, deep-verified; one that fails its checksums is deleted
    and the next newest taken, until one passes or none is left
    (``FileNotFoundError``: a cold start)."""
    if tag is not None:
        if read_commit(directory, tag) is not None:
            ok, why = verify_commit(directory, tag, deep=True)
            if not ok:
                raise ValueError(
                    f"checkpoint {tag} fails its commit manifest ({why})"
                    ": torn or corrupt")
        return tag
    condemned: set = set()
    while True:
        t = latest_tag(directory)
        if t is None:
            raise FileNotFoundError(f"No checkpoints in {directory}")
        if t in condemned:
            # discard_tag could not remove it (a read-only directory):
            # refuse rather than verify the same tag forever
            raise ValueError(
                f"checkpoint {t} failed verification but could not be "
                "removed (read-only checkpoint directory?); refusing to "
                "restore a corrupt checkpoint")
        if read_commit(directory, t) is None:
            return t  # legacy directory: no checksums to hold it to
        ok, why = verify_commit(directory, t, deep=True)
        if ok:
            return t
        _log.warning("discarding corrupt checkpoint %s in %s: %s", t,
                     directory, why)
        train_metrics.record_ckpt_restore("corrupt_discarded")
        condemned.add(t)
        discard_tag(directory, t)


def restore_checkpoint(directory: str, template, tag: Any = None,
                       _record: bool = True):
    """``ckpt_<tag>`` (flat) as host arrays in ``template``'s structure;
    ``tag=None`` takes the newest complete tag."""
    tag = _resolve_tag(directory, tag)
    with np.load(os.path.join(directory, f"ckpt_{tag}.npz")) as data:
        leaves = [data[f"arr_{i}"] for i in range(len(data.files))]
    tmpl_names, flat = _flatten(template)
    saved_names = None
    manifest_path = os.path.join(directory, f"ckpt_{tag}.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            saved_names = json.load(f).get("names")
    names_usable = (saved_names is not None
                    and len(saved_names) == len(leaves))
    if len(flat) != len(leaves) or (names_usable
                                    and saved_names != tmpl_names):
        if not names_usable:
            raise ValueError(
                f"Checkpoint has {len(leaves)} leaves, template has "
                f"{len(flat)} (and no usable name manifest to bridge)")
        pairs = _remap_by_name(tag, saved_names,
                               [np.shape(l) for l in leaves],
                               list(zip(tmpl_names, flat)))
        leaves = [leaves[si] if si is not None else d for si, d in pairs]
    for tmpl, loaded in zip(flat, leaves):
        if tuple(np.shape(tmpl)) != tuple(np.shape(loaded)):
            raise ValueError(f"Leaf shape mismatch: {tuple(np.shape(tmpl))}"
                             f" vs {np.shape(loaded)}")
    if _record:
        train_metrics.record_ckpt_restore("ok")
    return _unflatten(template, leaves)


def saved_names(directory: str, tag: Any = None) -> List[str]:
    """The leaf names the manifest of ``tag`` (the newest complete tag
    when None) records; empty when there is none."""
    tag = tag if tag is not None else latest_tag(directory)
    try:
        with open(os.path.join(directory, f"ckpt_{tag}.json")) as f:
            return list(json.load(f).get("names") or [])
    except (OSError, ValueError):
        return []


def read_meta(directory: str, tag: Any = None) -> dict:
    tag = tag if tag is not None else latest_tag(directory)
    with open(os.path.join(directory, f"ckpt_{tag}.json")) as f:
        return json.load(f).get("meta", {})


# ------------------------------------------- structure evolution ----

#: (pattern, fill) pairs: a leaf added after a save (matched by
#: ``re.search`` on its name) restores from ``fill(template_leaf)``
RESTORE_DEFAULTS: list = []


def register_restore_default(pattern: str, fill) -> None:
    RESTORE_DEFAULTS.append((re.compile(pattern), fill))


def _fill_default(name, tmpl):
    for pat, fill in RESTORE_DEFAULTS:
        if pat.search(name):
            return np.asarray(fill(tmpl))
    return None


def _component_in(names, component: str) -> bool:
    pat = re.compile(rf"(^|/){component}(/|$)")
    return any(pat.search(n) for n in names)


def _lm_pre_generate_signature(leftover_saved, unmatched_tmpl) -> bool:
    """TransformerLM saves from before its embeddings had fixed names:
    both auto-named embeddings are left over in the save and both fixed
    names are missing from the template."""
    return (_component_in(leftover_saved, "embedding")
            and _component_in(leftover_saved, "positionalembedding")
            and _component_in(unmatched_tmpl, "tok_embed")
            and _component_in(unmatched_tmpl, "pos_embed"))


#: (old pattern, replacement, guard) aliases of renamed layers, run over
#: the auto-number-stripped names of saved leaves the matcher left over
RESTORE_RENAMES: list = [
    (re.compile(r"(^|/)positionalembedding(/|$)"), r"\1pos_embed\2",
     _lm_pre_generate_signature),
    (re.compile(r"(^|/)embedding(/|$)"), r"\1tok_embed\2",
     _lm_pre_generate_signature),
]


def register_restore_rename(pattern: str, replacement: str,
                            guard=None) -> None:
    """Alias an old stripped leaf path to its new spelling (``re.sub``);
    ``guard(leftover_saved, unmatched_tmpl)`` scopes it to the exact
    migration."""
    RESTORE_RENAMES.insert(0, (re.compile(pattern), replacement, guard))


def _apply_renames(stripped: str, active) -> str:
    # the first pattern that matches wins: a later alias must not rewrite
    # the target of an earlier one
    for pat, repl in active:
        renamed = pat.sub(repl, stripped)
        if renamed != stripped:
            return renamed
    return stripped


def _remap_by_name(tag, saved_names, saved_shapes, tmpl_named):
    """Pair each template leaf with a saved one: by its ordinal within
    its (auto-number-stripped name, shape) group, both sides in natural
    numeric order (an auto-number is no identity across builds, and
    lexicographic order flips at digit boundaries); then through the
    rename aliases for leftovers; then a registered default; else raise.
    Returns (saved_index, default) pairs, one of each None."""
    pool: dict = {}
    for i, (n, sh) in enumerate(zip(saved_names, saved_shapes)):
        if sh is not None:
            pool.setdefault((_strip_auto_numbers(n), tuple(sh)),
                            []).append(i)
    for members in pool.values():
        members.sort(key=lambda i: _natural_key(saved_names[i]))
    tgroups: dict = {}
    for ti, (name, tmpl) in enumerate(tmpl_named):
        if tmpl is not None:
            tgroups.setdefault(
                (_strip_auto_numbers(name), tuple(np.shape(tmpl))),
                []).append(ti)
    assign: dict = {}
    for key, tpos in tgroups.items():
        tpos.sort(key=lambda ti: _natural_key(tmpl_named[ti][0]))
        for ti, si in zip(tpos, pool.get(key, [])):
            assign[ti] = si
    consumed = set(assign.values())
    leftover_saved = {key[0] for key, members in pool.items()
                      if any(i not in consumed for i in members)}
    unmatched_tmpl = {key[0] for key, tpos in tgroups.items()
                      if any(ti not in assign for ti in tpos)}
    active = [r[:2] for r in RESTORE_RENAMES
              if len(r) < 3 or r[2] is None
              or r[2](leftover_saved, unmatched_tmpl)]
    alias_pool: dict = {}
    for (sname, shape), members in pool.items():
        rest = [i for i in members if i not in consumed]
        renamed = _apply_renames(sname, active)
        if rest and renamed != sname:
            alias_pool.setdefault((renamed, shape), []).extend(rest)
    for members in alias_pool.values():
        members.sort(key=lambda i: _natural_key(saved_names[i]))
    for key, tpos in tgroups.items():
        unmatched = [ti for ti in tpos if ti not in assign]
        for ti, si in zip(unmatched, alias_pool.get(key, [])):
            assign[ti] = si
    out = []
    for ti, (name, tmpl) in enumerate(tmpl_named):
        if tmpl is None:
            out.append((None, None))
            continue
        si = assign.get(ti)
        if si is not None:
            out.append((si, None))
            continue
        d = _fill_default(name, tmpl)
        if d is None:
            raise ValueError(
                f"checkpoint {tag} has no leaf matching {name!r} "
                f"(shape {tuple(np.shape(tmpl))}) by stripped-name+shape, "
                "and no restore default is registered for it: the model "
                "or optimizer changed since the save in a way restore "
                "cannot bridge")
        out.append((None, d))
    return out


def _strip_auto_numbers(name: str) -> str:
    """Drop the trailing ``_<n>`` auto-number of each path component."""
    return "/".join(re.sub(r"_\d+$", "", part) for part in name.split("/"))


def _natural_key(name: str):
    """Order auto-numbered components numerically: dense_9 < dense_10."""
    key = []
    for part in name.split("/"):
        m = re.match(r"(.*?)_(\d+)$", part)
        key.append((m.group(1), int(m.group(2))) if m else (part, -1))
    return key


# BatchNormalization's debias ``count``: moving statistics saved before
# it existed restore as converged averages (count inf: denominator 1)
register_restore_default(
    r"(^|/)count$",
    lambda tmpl: np.full(np.shape(tmpl), np.inf, np.float32))


# ----------------------------------------------------------- sharded ----

def _encode_index(index) -> str:
    """A block's global index (slices): 'start:stop,...' per axis."""
    return ",".join(f"{sl.start}:{sl.stop}" for sl in index)


def _decode_index(text):
    if not text:
        return ()
    return tuple(slice(int(a), int(b))
                 for a, b in (p.split(":") for p in text.split(",")))


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _dtensor_block(leaf):
    """(global index, host array) of this rank's block of a DTensor, or
    None when another rank is its first replica."""
    from torch.distributed.tensor import Shard
    from ..parallel.sharding import block_index, dtensor_sharding
    mesh = leaf.device_mesh
    for name, pl in zip(mesh.mesh_dim_names, leaf.placements):
        if not isinstance(pl, Shard) and mesh.get_local_rank(name) != 0:
            return None
    spec = dtensor_sharding(leaf).spec
    index = block_index(spec, mesh, tuple(leaf.shape))
    return index, _host(leaf.to_local())


def _snapshot_shards(tree):
    """This process's shards on the host, copied now: (names, shapes,
    dtypes, {key: array}).  A DTensor leaf gives this rank's block when
    the rank is its first replica; any other leaf is whole on rank 0
    (every rank holds the same replicated value)."""
    from torch.distributed.tensor import DTensor
    names, leaves = _flatten(tree, none_leaves=True)
    mine = dist_lib.process_index() == 0
    arrays, shapes, dtypes = {}, [], []
    for i, leaf in enumerate(leaves):
        if leaf is None:  # structural None: keeps its index, no data
            shapes.append(None)
            dtypes.append(None)
            continue
        shape = tuple(np.shape(leaf))
        shapes.append(list(shape))
        dtypes.append(_dtype_name(leaf))
        if isinstance(leaf, DTensor):
            block = _dtensor_block(leaf)
            if block is not None:
                arrays[f"{i}|{_encode_index(block[0])}"] = block[1]
        elif mine:
            whole = tuple(slice(0, d) for d in shape)
            arrays[f"{i}|{_encode_index(whole)}"] = _host(leaf)
    return names, shapes, dtypes, arrays


def _write_shards(directory: str, tag: Any, pid: int, n_processes: int,
                  names, shapes, dtypes, arrays, meta: Optional[dict],
                  overwrite: bool = True) -> str:
    """Write this process's shard file (and on rank 0 the manifest,
    whose ``n_processes`` makes restore read exactly that set of
    files)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{tag}.shard-p{pid}.npz")
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists and overwrite=False "
                              "(reference setCheckpoint overWrite semantics)")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    if pid == 0:
        manifest = {"format": "sharded", "tag": str(tag),
                    "meta": meta or {}, "n_processes": n_processes,
                    "names": names, "shapes": shapes, "dtypes": dtypes}
        with open(os.path.join(directory, f"ckpt_{tag}.json"), "w") as f:
            json.dump(manifest, f)
    train_metrics.record_ckpt_save("sharded")
    return path


def _commit_sharded(directory: str, tag: Any, n_processes: int,
                    wait_s: Optional[float] = None) -> bool:
    """Rank 0's commit: once every rank's shard file and the manifest
    are present (each written by rename, so present means complete),
    write the commit manifest.  On a timeout the tag stays uncommitted,
    never restorable."""
    shard_files = [f"ckpt_{tag}.shard-p{p}.npz" for p in range(n_processes)]
    covered = shard_files + [f"ckpt_{tag}.json"]
    deadline = time.monotonic() + (_COMMIT_WAIT_S if wait_s is None
                                   else wait_s)
    while True:
        missing = [f for f in covered
                   if not os.path.exists(os.path.join(directory, f))]
        if not missing:
            break
        if time.monotonic() > deadline:
            _log.error("checkpoint %s: commit timed out waiting for %s; "
                       "the tag stays uncommitted", tag, missing)
            return False
        time.sleep(0.05)
    _write_commit(directory, tag, covered, n_processes)
    # drill hook: a corruption after the commit is what restore's
    # checksums exist to catch
    faults.maybe_corrupt_shard(directory, tag)
    return True


def _pod_barrier(name: str):
    """Wait for every process of the pod (no-op in one process)."""
    dist_lib.barrier(name)


def save_sharded(directory: str, tag: Any, tree, overwrite: bool = True,
                 meta: Optional[dict] = None) -> str:
    """Write this process's shard file; every process of the pod calls
    this.  Returns after every process has written and rank 0 has
    committed the tag, so a restore anywhere right after is safe."""
    names, shapes, dtypes, arrays = _snapshot_shards(tree)
    pid, nproc = dist_lib.process_index(), dist_lib.process_count()
    wrote = False
    try:
        path = _write_shards(directory, tag, pid, nproc, names, shapes,
                             dtypes, arrays, meta, overwrite)
        wrote = True
    finally:
        # every process reaches the barriers, even one whose write raised
        _pod_barrier(f"zoo_ckpt_{tag}")
        try:
            if wrote and pid == 0:
                _commit_sharded(directory, tag, nproc)
        finally:
            _pod_barrier(f"zoo_ckpt_commit_{tag}")
    return path


def async_save_sharded(directory: str, tag: Any, tree,
                       meta: Optional[dict] = None):
    """:func:`save_sharded` with the files written on a daemon thread.
    The copy to the host happens here, before the thread starts, on the
    caller's stream (after the step that made the values), so the
    training loop may update its tensors in place at once.  Join with
    :func:`wait_pending` (``Trainer.fit`` does when it returns)."""
    names, shapes, dtypes, arrays = _snapshot_shards(tree)
    pid, nproc = dist_lib.process_index(), dist_lib.process_count()

    def write_and_commit():
        _write_shards(directory, tag, pid, nproc, names, shapes, dtypes,
                      arrays, meta)
        if pid == 0:
            # off the main thread no barrier is available: the commit
            # waits for the other ranks' files instead
            _commit_sharded(directory, tag, nproc)

    return _start_writer(directory, write_and_commit)


def restore_sharded(directory: str, template, tag: Any = None,
                    shardings=None):
    """Assemble every leaf of ``template`` from the shard files of
    ``tag`` (the newest complete tag when None) as host arrays, matched
    by name, and place them under ``shardings``: a tree of
    ``parallel.mesh.NamedSharding`` (or None) with ``template``'s
    structure, a placed leaf becoming a DTensor of this rank's block on
    the sharding's mesh (a tensor of the template's dtype).  None leaves,
    or ``shardings=None``, stay host arrays.  A flat checkpoint restores
    through here too."""
    tree = _restore_host(directory, template, tag)
    return tree if shardings is None else _place_tree(tree, template,
                                                      shardings)


def _place_tree(tree, template, shardings):
    """Host leaves placed under their shardings (see
    :func:`restore_sharded`)."""
    from ..parallel.mesh import device_of
    from ..parallel.sharding import local_shard, to_dtensor
    leaves = _flatten(tree, none_leaves=True)[1]
    t_leaves = _flatten(template, none_leaves=True)[1]
    s_leaves = _flatten(shardings, none_leaves=True)[1]
    if len(s_leaves) != len(leaves):
        raise ValueError(
            f"shardings tree has {len(s_leaves)} leaves, value tree has "
            f"{len(leaves)}: structures must match")
    placed = []
    for buf, tmpl, sh in zip(leaves, t_leaves, s_leaves):
        if sh is None or buf is None:
            placed.append(buf)
            continue
        mesh, spec = sh.mesh, tuple(sh.spec)
        full = torch.as_tensor(np.asarray(buf))
        if isinstance(tmpl, torch.Tensor):
            full = full.to(tmpl.dtype)
        placed.append(to_dtensor(
            local_shard(full, spec, mesh).to(device_of(mesh)), spec, mesh))
    return _unflatten(tree, placed, none_leaves=True)


def _restore_host(directory: str, template, tag: Any = None):
    tag = _resolve_tag(directory, tag)
    manifest = {}
    manifest_path = os.path.join(directory, f"ckpt_{tag}.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    n_saved = manifest.get("n_processes")
    if n_saved is not None:
        shard_files = [f"ckpt_{tag}.shard-p{p}.npz" for p in range(n_saved)]
        missing = [f for f in shard_files
                   if not os.path.exists(os.path.join(directory, f))]
        if missing:
            raise ValueError(
                f"checkpoint {tag} was written by {n_saved} processes but "
                f"{missing} are absent (is the checkpoint directory "
                "shared across all pod processes?)")
    else:
        shard_files = sorted(
            f for f in os.listdir(directory)
            if re.match(rf"ckpt_{re.escape(str(tag))}\.shard-p\d+\.npz$",
                        f))
    if not shard_files:  # a flat checkpoint
        tree = restore_checkpoint(directory, template, tag, _record=False)
        train_metrics.record_ckpt_restore("ok")
        return tree
    tmpl_names, flat = _flatten(template, none_leaves=True)
    saved_names = manifest.get("names")
    defaults: dict = {}
    if saved_names is not None and saved_names != tmpl_names:
        saved_shapes = manifest.get("shapes") or [None] * len(saved_names)
        pairs = _remap_by_name(tag, saved_names, saved_shapes,
                               list(zip(tmpl_names, flat)))
        remap = [si for si, _ in pairs]
        defaults = {ti: d for ti, (_, d) in enumerate(pairs)
                    if d is not None}
    else:
        remap = list(range(len(flat)))
    handles = [np.load(os.path.join(directory, f)) for f in shard_files]
    try:
        n_saved_leaves = (len(saved_names) if saved_names is not None
                          else len(flat))
        by_leaf: dict = {}
        for h in handles:
            for key in h.files:
                si, _, idx_text = key.partition("|")
                i = int(si)
                if i >= n_saved_leaves:
                    raise ValueError(
                        f"checkpoint {tag} has a leaf index {i} but "
                        f"records only {n_saved_leaves} leaves: shard "
                        "files from a different save mixed in?")
                by_leaf.setdefault(i, []).append((h, key, idx_text))
        out = []
        for i, tmpl in enumerate(flat):
            if tmpl is None:
                out.append(None)
                continue
            if i in defaults:  # a registered fill for a post-save leaf
                out.append(defaults[i])
                continue
            entries = by_leaf.get(remap[i])
            if not entries:
                raise ValueError(
                    f"checkpoint {tag} is missing data for leaf {i} "
                    f"(shape {tuple(np.shape(tmpl))}): incomplete shard "
                    "set?")
            shape = tuple(np.shape(tmpl))
            buf = None
            filled = 0
            for h, key, idx_text in entries:
                piece = h[key]
                index = _decode_index(idx_text)
                if not index:  # a scalar leaf
                    buf, filled = piece, 1
                    continue
                if buf is None:
                    buf = np.empty(shape, piece.dtype)
                buf[index] = piece
                filled += piece.size
            want = int(np.prod(shape)) if shape else 1
            if filled < want:
                raise ValueError(
                    f"checkpoint {tag} leaf {i} only has {filled}/{want} "
                    "elements: missing shard files (is the checkpoint "
                    "directory shared across all pod processes?)")
            if tuple(np.shape(buf)) != shape:
                raise ValueError(
                    f"Leaf shape mismatch: {shape} vs {np.shape(buf)}")
            out.append(buf)
    finally:
        for h in handles:
            h.close()
    train_metrics.record_ckpt_restore("ok")
    return _unflatten(template, out, none_leaves=True)


def restore_into(directory: str, template, tag: Any = None):
    """:func:`restore_sharded` (any format), copied in place into the
    tensors of ``template`` on their devices; returns the host tree."""
    tree = restore_sharded(directory, template, tag)
    copy_tree_into(template, tree)
    return tree


@torch.no_grad()
def copy_tree_into(template, tree) -> None:
    """Copy the host arrays of ``tree`` into the tensors of ``template``
    (same structure), each on its own device; a DTensor of ``template``
    takes its block from the DTensor ``restore_sharded`` placed."""
    from torch.distributed.tensor import DTensor
    for dst, src in zip(_flatten(template)[1], _flatten(tree)[1]):
        if isinstance(dst, DTensor):
            dst.to_local().copy_(src.to_local())
        elif isinstance(dst, torch.Tensor):
            dst.copy_(torch.as_tensor(np.asarray(src)).to(dst.device))
