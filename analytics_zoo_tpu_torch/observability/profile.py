"""Profiling hooks: compiles, transfers and live buffers as metrics and
span events.

Counterpart of ``analytics_zoo_tpu/observability/profile.py``.  The JAX
module subscribes to jax's monitoring stream, whose ``backend_compile``
events fire once per real XLA compile.  Torch runs eagerly and has no
such stream, so here a "compile" is one of the port's own moments of
building device code that it then reuses, reported by the code that
does it through :func:`note_compile`, with its kind
(:data:`COMPILE_KINDS`):

* ``kernel_build``: a build of the hand-written kernels
  (``ops/_kernels.py``: the ``nvcc`` processes, timed from their start to
  the last one's end; a library found on disk or in the store is loaded,
  not compiled, and counts nothing);
* ``signature_build``: a serving signature's first run on replica 0
  (``pipeline/inference/serving.py``);
* ``graph_capture``: a CUDA-graph capture of the decode engine
  (``pipeline/inference/decode.py``: the step plan, each fused window,
  the speculative window).

Each increments ``zoo_xla_compiles_total`` and adds its wall seconds to
``zoo_xla_compile_seconds_total`` (the JAX package's family names, so one
scrape and the pod aggregator read both packages alike) and lands as a
``backend_compile`` event on the current request span: a capture or a
kernel build on the request path shows up in that request's trace.  The
serving dispatch path reports its explicit uploads and fetches through
:func:`note_transfer` (``zoo_transfers_total{direction=...}``), one flag
check when nothing is installed.  ``zoo_live_buffers`` is read at scrape
time: ``torch.cuda.memory_stats()["active.all.current"]`` (live
allocations of the caching allocator) when the process uses a card, else
a count of the live tensors the garbage collector tracks.

Install once per process and plug ``handle.families`` into a
:class:`~.metrics.MetricsRegistry`::

    handle = profile.install()
    registry.register_collector(handle.families)
    ...
    handle.close()
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from . import trace
from .metrics import Family

_lock = threading.Lock()
_installed: "Optional[XlaProfile]" = None

#: the kinds of compile-like events: an ``nvcc`` run, a serving
#: signature's first build, a CUDA-graph capture
COMPILE_KINDS = ("kernel_build", "signature_build", "graph_capture")


class XlaProfile:
    """Counters fed by :func:`note_compile` and :func:`note_transfer`
    (see the module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compiles = 0
        self.compile_seconds = 0.0
        self.by_kind = dict.fromkeys(COMPILE_KINDS, 0)
        self._transfers: Dict[str, int] = {}
        self._closed = False

    # ---- feed side ----
    def _on_compile(self, seconds: float, key: str, kind: str):
        if self._closed:
            return
        with self._lock:
            self.compiles += 1
            self.compile_seconds += seconds
            self.by_kind[kind] += 1
        span = trace.current_span()
        if span is not None:
            span.event("backend_compile", seconds=round(seconds, 6),
                       key=key)

    def _note_transfer(self, direction: str):
        with self._lock:
            self._transfers[direction] = \
                self._transfers.get(direction, 0) + 1

    # ---- read side ----
    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"compiles": self.compiles,
                    "compile_seconds": round(self.compile_seconds, 6),
                    "by_kind": dict(self.by_kind),
                    "transfers": dict(self._transfers)}

    def families(self) -> List[Family]:
        """Prometheus collector (plug into MetricsRegistry)."""
        with self._lock:
            compiles = self.compiles
            seconds = self.compile_seconds
            transfers = dict(self._transfers)
        fams = [
            Family("counter", "zoo_xla_compiles_total",
                   "compile-like events (kernel builds, CUDA-graph "
                   "captures) observed since install",
                   [({}, compiles)]),
            Family("counter", "zoo_xla_compile_seconds_total",
                   "cumulative wall seconds of those events",
                   [({}, seconds)]),
        ]
        if transfers:
            fams.append(Family(
                "counter", "zoo_transfers_total",
                "explicit host<->device transfers on the serving "
                "dispatch path, by direction",
                [({"direction": d}, v)
                 for d, v in sorted(transfers.items())]))
        fams.append(Family(
            "gauge", "zoo_live_buffers",
            "live device allocations, or live CPU tensors without a card "
            "(scrape-time)",
            [({}, _live_buffer_count())]))
        return fams

    def close(self):
        """Stop counting (idempotent)."""
        global _installed
        self._closed = True
        with _lock:
            if _installed is self:
                _installed = None


def _live_buffer_count() -> float:
    import torch
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return float(torch.cuda.memory_stats().get(
                "active.all.current", 0))
        import gc
        # type(), not isinstance(): a module proxy's __class__ may warn
        return float(sum(1 for o in gc.get_objects()
                         if issubclass(type(o), torch.Tensor)))
    except Exception:
        return float("nan")


def install() -> XlaProfile:
    """Make an :class:`XlaProfile` the process's target of the hooks.
    Returns the existing handle when one is installed (one stream, one
    consumer)."""
    global _installed
    with _lock:
        if _installed is None:
            _installed = XlaProfile()
        return _installed


def installed() -> "Optional[XlaProfile]":
    return _installed


def note_compile(seconds: float, key: str,
                 kind: str = "signature_build") -> None:
    """Report one compile-like event of ``seconds`` wall time (``key``
    names what was built, ``kind`` is one of :data:`COMPILE_KINDS`).  A
    single flag check when no profile is installed."""
    handle = _installed
    if handle is not None:
        handle._on_compile(seconds, key, kind)


def note_transfer(direction: str = "h2d"):
    """Count one explicit transfer (the serving dispatch path calls this
    around its uploads and fetches).  A single flag check when no
    profile is installed."""
    handle = _installed
    if handle is not None:
        handle._note_transfer(direction)
