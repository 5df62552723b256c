"""Persistent executable store: a content-addressed on-disk cache of
the port's compiled device code, shared by processes and machines.

Counterpart of ``analytics_zoo_tpu/serving/execstore.py``, with the same
entry format, counters, families and environment variables, so either
package's ``stat`` and ``gc`` read the other's store.  The store's core
lives here, below the kernel build (``ops/_kernels.py``) that reads
through it; ``serving/execstore.py`` re-exports it under the JAX
package's module name and carries the ``stat|gc`` CLI.

**What the port's entries hold.**  The JAX package persists XLA
executables, one per padded batch signature and one per decode plan,
because a fresh JAX process must compile each of them.  The port runs
eagerly: its per-signature "build" is a first run, and what that run
leaves behind is allocator and cuBLAS state, which dies with the
process; its decode plans are CUDA graphs, which cannot be serialized.
The one compile of the port that outlives a process is ``nvcc`` building
``ops/csrc/*.cu`` (tens of seconds on a fresh host).  So the port's
entries are **kernel libraries** (``kind: "kernel-lib"``), one a source:
``ops/_kernels.py`` reads through the store at its build miss (a library
missing from the local build directory):

* a hit writes the library bytes atomically into the build directory
  and loads them: ``nvcc`` does not run and no compile is noted;
* a miss runs ``nvcc`` as before, then writes the library behind;
* a corrupt entry (checksum, or a library that will not load) is
  counted ``invalid``, deleted, and ``nvcc`` rebuilds: the store may
  cost a rebuild, never wrong bytes.

The fingerprint covers :func:`_runtime_parts` (torch and CUDA versions,
the device's name and compute capability) and the parts the caller
gives: ``ops/_kernels.py`` adds the hash of the sources, headers and
``NVCC_FLAGS`` that names its build directory, and ``nvcc --version``.
Per-signature ``torch.export`` or AOTInductor entries were considered
and not taken: a hit would load a program no faster than the eager
first run it replaces, and a miss would pay an export that the eager
path does not.

* **Tags.**  An entry written while a deploy is building carries that
  deploy's ``store_tag`` as its ``model`` meta (:func:`tag_builds`, set
  around ``InferenceModel``'s loads and warm-ups and the decode engine's
  warm-up), so ``stat --by-model`` shows who paid for the compile.
* **Observable.**  ``zoo_execstore_{hit,miss,write,invalid,evicted}_total``
  counters, ``zoo_execstore_entries`` and ``zoo_execstore_bytes`` gauges
  (:meth:`ExecStore.families`), an ``execstore_load`` event on the
  active request span at a hit, and a structured log line for every
  verdict.

Enabling the store::

    export ZOO_EXECSTORE_DIR=/var/cache/zoo-exec
    # or, programmatically:
    from analytics_zoo_tpu_torch.serving import execstore
    execstore.configure("/var/cache/zoo-exec", byte_budget=2 << 30)

Without configuration the store is inert: no files, no lookups, the
build path as before.

Hygiene: the store is size-capped LRU.  Reads bump an entry's mtime;
``gc()`` (also ``python -m analytics_zoo_tpu_torch.serving.execstore
gc``) evicts oldest-mtime entries over the byte budget, never an entry
this process wrote or loaded.  ``stat`` prints the store table.

Entry format: one JSON header line (fingerprint, meta, payload sha256)
followed by the raw payload bytes; ``stat`` and ``entries()`` read the
header alone.  Trust model: a payload is a shared library that the
process loads, so the store directory must be trusted like the code
itself: point it at an operator-owned path.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import envcontract
from ..observability import trace as _trace
from ..observability.log import get_logger as _get_logger
from ..observability.metrics import Family

_slog = _get_logger("zoo.serving.execstore")

ENV_DIR = "ZOO_EXECSTORE_DIR"
ENV_BUDGET = "ZOO_EXECSTORE_BYTES"
_SUFFIX = ".zexe"

_COUNTER_KEYS = ("hit", "miss", "write", "invalid", "evicted")


def _runtime_parts(device=None) -> Tuple:
    """The environment half of every fingerprint: anything here changing
    means a stored library may no longer load, or may compute
    differently, so it lands on a different key.  A function of its own
    so that tests can patch a version bump."""
    import torch
    name, capability = "none", None
    if torch.cuda.is_available():
        index = (torch.device(device).index if device is not None
                 else None)
        if index is None:
            index = torch.cuda.current_device()
        name = torch.cuda.get_device_name(index)
        capability = tuple(torch.cuda.get_device_capability(index))
    return ("torch", torch.__version__, "cuda", torch.version.cuda,
            "device", name, "capability", capability)


# ---- build tags -------------------------------------------------------
_tag_lock = threading.Lock()
_tags: List[str] = []


@contextlib.contextmanager
def tag_builds(tag: Optional[str]):
    """Entries written inside this block carry ``tag`` as their ``model``
    meta (the innermost tag wins).  Process-wide, not per thread: a
    kernel build may run on a dispatcher thread of the deploy that
    started it.  ``None`` is a no-op."""
    if tag is None:
        yield
        return
    with _tag_lock:
        _tags.append(tag)
    try:
        yield
    finally:
        with _tag_lock:
            _tags.remove(tag)


def build_tag() -> Optional[str]:
    """The tag of the innermost :func:`tag_builds` block, or None."""
    with _tag_lock:
        return _tags[-1] if _tags else None


class StoreEntry:
    """One verified store read: the payload bytes + writer metadata."""

    __slots__ = ("fingerprint", "payload", "meta")

    def __init__(self, fingerprint: str, payload: bytes,
                 meta: Dict[str, Any]):
        self.fingerprint = fingerprint
        self.payload = payload
        self.meta = meta


class ExecStore:
    """The on-disk store (module docstring).  Thread-safe: counter and
    protected-set mutations are lock-guarded; file publishes are atomic
    renames, so concurrent processes sharing one directory see whole
    entries or nothing."""

    def __init__(self, root: str, byte_budget: Optional[int] = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.byte_budget = (None if byte_budget is None
                            else int(byte_budget))
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {k: 0 for k in _COUNTER_KEYS}
        # entries this process wrote OR loaded: its own deploy depends on
        # them, so gc() must never evict them out from under it
        self._protected: set = set()

    # ---- keys ----
    def fingerprint(self, *parts, device=None) -> str:
        """Content address over ``parts`` + the runtime environment
        (:func:`_runtime_parts`)."""
        h = hashlib.sha256()
        for part in _runtime_parts(device) + parts:
            h.update(repr(part).encode())
            h.update(b"\x00")
        return h.hexdigest()

    def _path(self, fp: str) -> str:
        return os.path.join(self.root, fp + _SUFFIX)

    def _count(self, key: str, n: int = 1):
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    # ---- read-through ----
    def lookup(self, fp: str) -> Optional[StoreEntry]:
        """One store read: the verified entry for ``fp``, or None on a
        miss.  A present-but-corrupt entry (truncated, bit-flipped,
        checksum mismatch) counts ``invalid``, is deleted, and reads as a
        miss.  A hit bumps the entry's mtime (the LRU clock), protects it
        from this process's gc, records an ``execstore_load`` event on
        the active request span, and logs a structured line."""
        path = self._path(fp)
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            self._count("miss")
            _slog.info("execstore_miss", key=fp[:12])
            return None
        try:
            # entry = one JSON header line + raw payload bytes (see put());
            # json.dumps escapes newlines, so the first \n is the split
            nl = raw.index(b"\n")
            obj = json.loads(raw[:nl])
            payload = raw[nl + 1:]
            meta = obj["meta"]
            if hashlib.sha256(payload).hexdigest() != obj["sha256"]:
                raise ValueError("payload checksum mismatch")
        except Exception as e:  # noqa: BLE001 — any decode failure is
            # the same verdict: invalid, delete, rebuild
            self.note_invalid(fp, e)
            return None
        try:
            os.utime(path)  # LRU touch; best-effort
        except OSError:
            pass
        with self._lock:
            self._protected.add(fp)
        self._count("hit")
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        span = _trace.current_span()
        if span is not None:
            span.event("execstore_load", key=fp[:12], ms=ms,
                       bytes=len(payload))
        _slog.info("execstore_hit", key=fp[:12], bytes=len(payload),
                   read_ms=ms)
        return StoreEntry(fp, payload, meta)

    def note_invalid(self, fp: str, error: BaseException):
        """Record (and remove) a corrupt entry so the rebuild's
        write-behind replaces it cleanly.  Also the hook a caller uses
        when the payload decodes but the library inside will not load."""
        self._count("invalid")
        try:
            os.remove(self._path(fp))
        except OSError:
            pass
        _slog.error("execstore_invalid", key=fp[:12],
                    error=f"{type(error).__name__}: {error}")

    # ---- write-behind ----
    def put(self, fp: str, payload: bytes,
            meta: Optional[Dict[str, Any]] = None) -> bool:
        """Persist one entry (a JSON header line, then the payload),
        written to a temp file and published by atomic rename, so a
        reader never sees a torn entry.  Returns False (and logs) instead
        of raising on an I/O or meta-encoding failure: the store must
        never fail a build that just succeeded.  A configured byte budget
        runs a gc after the write."""
        meta = dict(meta or {})
        meta.setdefault("created_at", time.time())
        path = self._path(fp)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            blob = json.dumps(
                {"fingerprint": fp, "meta": meta,
                 "sha256": hashlib.sha256(payload).hexdigest()}
            ).encode("utf-8") + b"\n" + payload
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError) as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            _slog.error("execstore_write_failed", key=fp[:12],
                        error=f"{type(e).__name__}: {e}")
            return False
        with self._lock:
            self._protected.add(fp)
        self._count("write")
        _slog.info("execstore_write", key=fp[:12], bytes=len(blob),
                   kind=meta.get("kind", "?"))
        if self.byte_budget is not None:
            self.gc()
        return True

    # ---- hygiene ----
    def _scan(self) -> List[Tuple[float, int, str]]:
        """(mtime, size, fingerprint) for every entry on disk."""
        out = []
        try:
            with os.scandir(self.root) as it:
                for de in it:
                    if not de.name.endswith(_SUFFIX):
                        continue
                    try:
                        st = de.stat()
                    except OSError:
                        continue
                    out.append((st.st_mtime, st.st_size,
                                de.name[:-len(_SUFFIX)]))
        except OSError:
            pass
        return out

    def gc(self, byte_budget: Optional[int] = None) -> Dict[str, Any]:
        """Size-capped LRU eviction: drop oldest-mtime entries until the
        store fits ``byte_budget`` (default: the configured budget; a
        no-op when neither is set).  Entries this process wrote or loaded
        are never evicted; they still count toward the total."""
        budget = self.byte_budget if byte_budget is None else int(byte_budget)
        entries = self._scan()
        total = sum(size for _, size, _ in entries)
        evicted = 0
        freed = 0
        if budget is not None:
            with self._lock:
                protected = set(self._protected)
            for mtime, size, fp in sorted(entries):
                if total <= budget:
                    break
                if fp in protected:
                    continue
                try:
                    os.remove(self._path(fp))
                except OSError:
                    continue
                evicted += 1
                freed += size
                total -= size
        if evicted:
            self._count("evicted", evicted)
            _slog.info("execstore_gc", evicted=evicted,
                       freed_bytes=freed, kept_bytes=total)
        return {"evicted": evicted, "freed_bytes": freed,
                "entries": len(entries) - evicted, "bytes": total}

    # ---- observability ----
    def stats(self) -> Dict[str, Any]:
        entries = self._scan()
        with self._lock:
            counters = dict(self._counters)
            protected = len(self._protected)
        return {"root": self.root, "entries": len(entries),
                "bytes": sum(size for _, size, _ in entries),
                "byte_budget": self.byte_budget,
                "protected": protected, **counters}

    def families(self) -> List[Family]:
        """Prometheus collector: plug into a MetricsRegistry."""
        s = self.stats()
        fams = [Family("counter", f"zoo_execstore_{k}_total",
                       _FAMILY_HELP[k], [({}, s[k])])
                for k in _COUNTER_KEYS]
        fams.append(Family("gauge", "zoo_execstore_entries",
                           "executables currently persisted in the "
                           "store", [({}, s["entries"])]))
        fams.append(Family("gauge", "zoo_execstore_bytes",
                           "total bytes on disk in the store",
                           [({}, s["bytes"])]))
        return fams

    def entries(self) -> List[Dict[str, Any]]:
        """Per-entry table for the ``stat`` CLI (newest first), from each
        entry's JSON header line only."""
        out = []
        for mtime, size, fp in sorted(self._scan(), reverse=True):
            try:
                with open(self._path(fp), "rb") as f:
                    head = f.readline(1 << 16)
                meta = json.loads(head).get("meta", {})
                kind = meta.get("kind", "?")
                model = meta.get("model", "-")
                mesh = _mesh_label(meta.get("mesh"))
            except Exception:  # noqa: BLE001 — stat must never crash
                kind, model, mesh = "unreadable", "-", "-"
            out.append({"fingerprint": fp, "bytes": size,
                        "mtime": mtime, "kind": kind, "model": model,
                        "mesh": mesh})
        return out

    def by_mesh(self) -> Dict[str, Dict[str, int]]:
        """Entries/bytes aggregated by the writer's ``mesh`` meta tag
        (``axes`` x ``strategy``; ``-`` for entries without one, which
        every kernel library is)."""
        agg: Dict[str, Dict[str, int]] = {}
        for e in self.entries():
            row = agg.setdefault(e["mesh"], {"entries": 0, "bytes": 0})
            row["entries"] += 1
            row["bytes"] += e["bytes"]
        return agg

    def by_model(self) -> Dict[str, Dict[str, int]]:
        """Entries/bytes aggregated by the writer's ``model`` meta tag
        (the deploy whose build wrote the entry; ``-`` when untagged)."""
        agg: Dict[str, Dict[str, int]] = {}
        for e in self.entries():
            row = agg.setdefault(e["model"], {"entries": 0, "bytes": 0})
            row["entries"] += 1
            row["bytes"] += e["bytes"]
        return agg


def _mesh_label(mesh) -> str:
    """A header ``mesh`` meta dict as a short stable label for
    aggregation: ``tensor=2/tp`` (axes sorted by name); ``-`` when the
    entry has none."""
    if not isinstance(mesh, dict):
        return "-"
    axes = mesh.get("axes")
    parts = ",".join(f"{k}={v}" for k, v in sorted(axes.items())) \
        if isinstance(axes, dict) and axes else "?"
    return f"{parts}/{mesh.get('strategy', '?')}"


_FAMILY_HELP = {
    "hit": "executable store lookups answered from disk",
    "miss": "executable store lookups that fell through to a compile",
    "write": "executables persisted to the store",
    "invalid": "corrupt/undecodable store entries detected (each one "
               "fell back to a fresh compile)",
    "evicted": "entries removed by LRU gc",
}


# ---- process-wide configuration --------------------------------------
_cur_lock = threading.Lock()
_current: Optional[ExecStore] = None
_env_checked = False


def configure(root: str, byte_budget: Optional[int] = None) -> ExecStore:
    """Enable the store for this process (every build site consults it
    from now on).  Returns the store."""
    global _current, _env_checked
    with _cur_lock:
        _current = ExecStore(root, byte_budget=byte_budget)
        _env_checked = True
        return _current


def disable():
    """Turn the store off for this process (files stay on disk)."""
    global _current, _env_checked
    with _cur_lock:
        _current = None
        _env_checked = True


def current() -> Optional[ExecStore]:
    """The process store, or None when disabled.  The first call honours
    ``ZOO_EXECSTORE_DIR`` (and ``ZOO_EXECSTORE_BYTES``), so a worker
    enables the store with one environment variable."""
    global _current, _env_checked
    if _current is None and not _env_checked:
        with _cur_lock:
            if _current is None and not _env_checked:
                _env_checked = True
                root = envcontract.env_str(ENV_DIR)
                if root:
                    budget = envcontract.env_str(ENV_BUDGET)
                    _current = ExecStore(
                        root,
                        byte_budget=int(budget) if budget else None)
    return _current
