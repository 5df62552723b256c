"""zoolint.sanitize(): runtime sanitizer for pinned hot loops.

The static rules catch patterns; this catches FACTS — a context manager
that asserts "this block built nothing and made no implicit host<->device
sync":

* **compiles** — the port's compile-like events, the three kinds of
  ``observability.profile.COMPILE_KINDS`` (``kernel_build``: an ``nvcc``
  run; ``signature_build``: a serving signature's first run;
  ``graph_capture``: a decode plan's CUDA-graph capture), counted through
  a listener on ``profile.note_compile``, the funnel every one of them
  is reported through.  The listener leaves an installed profile as it
  is.  More than ``max_compiles`` raises :class:`RecompileDetected` at
  block exit, listing each event's kind and key.
* **transfers** — in a process that uses a card, torch's sync debug
  mode, set process-wide (``torch.cuda.set_sync_debug_mode``, a global
  of c10, not a thread-local) so that the coalescer's and the decode
  engine's threads are covered too: ``"disallow"`` sets ``"error"``,
  ``"log"`` sets ``"warn"``.  Under ``"error"`` a call that copies
  between host and device and waits for it — ``.item()``, ``.cpu()``,
  ``.tolist()``, ``int()``/``float()`` of a CUDA tensor, a blocking
  ``.to()``/``copy_`` either way, ``torch.tensor(..., device="cuda")`` —
  or a stream's ``synchronize()`` raises ``RuntimeError`` ("called a
  synchronizing CUDA operation") at the offending call.  The explicit
  fetch passes: a non-blocking copy into pinned host memory and an
  ``Event.synchronize()`` (c10 flags ``memcpy_and_sync`` and
  ``stream_synchronize``; an event wait is not flagged), which is how
  the serving path and the decode engine fetch.  A copy between
  *pageable* host memory and the card is not flagged either, though the
  driver may wait while it stages it: the port's hot paths copy through
  pinned memory both ways (``common.hostcopy``), so the guard's silence
  there is not a blind spot.

Backend caveat: on the CPU there is no device to sync with, so there is
nothing to guard — only compiles are counted there (the JAX module's
device->host caveat, for every direction).

Usage::

    with zoolint.sanitize(max_compiles=0) as rep:
        for x in pinned_hot_loop:
            model.predict(x)
    assert rep.compiles == 0    # redundant — exit would have raised

Tests get it as the ``zoolint_sanitize`` fixture; ``chip_smoke.py``'s
``sanitize`` phase runs full-width serving windows under it, driven by
:func:`closed_loop`, and reads :func:`host_memory` around them.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class SanitizeError(RuntimeError):
    """Base for sanitizer verdicts."""


class RecompileDetected(SanitizeError):
    """The sanitized block compiled more than its budget allows."""


class InvariantLeakDetected(SanitizeError):
    """A gauge invariant moved across the sanitized block: an
    in-flight/slot/ticket counter (or the live thread count) did not
    return to its entry value over a quiesced serve window — the
    runtime signature of the ZL701/ZL702 leak class (a seat taken on
    an exception path and never given back shows up here as a counter
    permanently up by one)."""


class SanitizeReport:
    """Live view into the sanitized block (yielded by sanitize())."""

    def __init__(self, label: str):
        self.label = label
        self._lock = threading.Lock()
        self._events: List[Tuple[str, str, float]] = []
        self._count = 0
        #: the sync debug mode at entry and the one set for the block
        #: (None where there is no card to guard)
        self.sync_mode_before: Optional[int] = None
        self.sync_mode_in_block: Optional[int] = None

    def _record(self, seconds: float, key: str, kind: str):
        with self._lock:
            self._count += 1
            if len(self._events) < 1000:  # cap pathological loops
                self._events.append((kind, key, seconds))

    @property
    def compiles(self) -> int:
        with self._lock:
            return self._count

    @property
    def events(self) -> List[Tuple[str, str, float]]:
        """(kind, key, seconds) of each event, in order."""
        with self._lock:
            return list(self._events)

    @property
    def by_kind(self) -> Dict[str, int]:
        """Events per kind, every kind of ``COMPILE_KINDS`` present."""
        from ...observability.profile import COMPILE_KINDS
        counts = dict.fromkeys(COMPILE_KINDS, 0)
        counts.update(collections.Counter(k for k, _, _ in self.events))
        return counts


#: the transfer_guard levels as torch sync debug modes
_GUARD_MODES = {"allow": 0, "log": 1, "disallow": 2}


def _card_in_use() -> bool:
    import torch
    return torch.cuda.is_available()


@contextlib.contextmanager
def sanitize(max_compiles: int = 0,
             transfer_guard: Optional[str] = "disallow",
             label: str = "zoolint.sanitize",
             invariants: Optional[Callable[[], Dict[str, Any]]] = None,
             invariant_threads: bool = True):
    """Assert the block stays compile- and sync-clean (module doc).

    ``max_compiles``: compile-like events the block may perform (0 for a
    warmed hot loop).  ``transfer_guard``: "disallow" (sync debug mode
    "error"), "log" ("warn"), "allow" ("default") or None to leave the
    mode as it is.  Yields a :class:`SanitizeReport`; raises
    :class:`RecompileDetected` on exit when the budget is exceeded.  An
    implicit sync raises inside torch at the offending call (a
    ``RuntimeError``).

    **Invariant-snapshot mode** (``invariants=``): pass a zero-arg
    callable returning gauge values — in-flight counts, queue seats,
    slot occupancy, admission tickets — and the block asserts every
    one of them (plus, with ``invariant_threads``, the live
    ``threading.active_count()``) returns to its entry value by block
    exit, raising :class:`InvariantLeakDetected` otherwise.  The block
    must be QUIESCED at both ends (warmed before entry, drained before
    exit — a sequential closed-loop serve window is, by construction);
    a monotonic stat counter does not belong in the snapshot, only
    gauges that a leak-free window brings back to rest.  This is the
    runtime twin of the ZL701/ZL702 static rules: the lint proves no
    exception path CAN leak a seat, the snapshot proves this run
    DIDN'T.  Checked only on clean exit (an exception unwinding out of
    the block is its own report), after the compile budget.

    The guard is process-global while the block runs — don't nest, and
    don't run unrelated card work concurrently with a sanitized block.
    """
    from ...observability import profile

    if transfer_guard is not None and transfer_guard not in _GUARD_MODES:
        raise ValueError(f"transfer_guard must be one of "
                         f"{sorted(_GUARD_MODES)} or None, got "
                         f"{transfer_guard!r}")
    report = SanitizeReport(label)
    pre_inv: Optional[Dict[str, Any]] = None
    if invariants is not None:
        pre_inv = dict(invariants())
        if invariant_threads:
            pre_inv["live_threads"] = threading.active_count()
    guard = transfer_guard is not None and _card_in_use()
    if guard:
        import torch
        report.sync_mode_before = torch.cuda.get_sync_debug_mode()
    listener = report._record
    profile.add_compile_listener(listener)
    try:
        if guard:
            torch.cuda.set_sync_debug_mode(_GUARD_MODES[transfer_guard])
            report.sync_mode_in_block = torch.cuda.get_sync_debug_mode()
        yield report
    finally:
        profile.remove_compile_listener(listener)
        if guard:
            torch.cuda.set_sync_debug_mode(report.sync_mode_before)
    if report.compiles > max_compiles:
        lines = "\n  ".join(f"{kind} {key} ({s * 1e3:.1f} ms)"
                            for kind, key, s in report.events[:10])
        raise RecompileDetected(
            f"{label}: {report.compiles} compile(s) inside a block "
            f"budgeted for {max_compiles} — a shape/dtype escaped the "
            f"warmed bucket ladder, a graph was recaptured, or a kernel "
            f"was built:\n  {lines}")
    if pre_inv is not None:
        post_inv = dict(invariants())
        if invariant_threads:
            post_inv["live_threads"] = threading.active_count()
        leaks = {k: (pre_inv.get(k), post_inv.get(k))
                 for k in sorted(set(pre_inv) | set(post_inv))
                 if pre_inv.get(k) != post_inv.get(k)}
        if leaks:
            detail = ", ".join(f"{k}: {a!r} -> {b!r}"
                               for k, (a, b) in leaks.items())
            raise InvariantLeakDetected(
                f"{label}: {len(leaks)} invariant(s) moved across a "
                f"quiesced serve window ({detail}) — an in-flight/"
                "slot/ticket counter (or a thread) leaked; an "
                "exception path somewhere took a seat it never gave "
                "back (the ZL701/ZL702 bug class, live)")


def closed_loop(call: Callable[[Any], Any], items, threads: int = 4,
                timeout: float = 300.0):
    """Run ``call(item)`` for every item from ``threads`` closed-loop
    clients (client ``t`` takes items ``t, t + threads, ...`` one after
    another), all released together: the serve window a sanitized block
    wraps.  Returns (results in item order, wall seconds, the errors
    raised, as ``"Type: message"`` strings)."""
    items = list(items)
    out: List[Any] = [None] * len(items)
    errors: List[str] = []
    go = threading.Event()

    def client(t):
        go.wait(timeout)
        for i in range(t, len(items), threads):
            try:
                out[i] = call(items[i])
            except Exception as e:  # reported to the caller
                errors.append(f"{type(e).__name__}: {e}")

    pool = [threading.Thread(target=client, args=(t,), daemon=True)
            for t in range(threads)]
    for t in pool:
        t.start()
    t0 = time.perf_counter()
    go.set()
    for t in pool:
        t.join(timeout)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in pool):
        errors.append(f"TimeoutError: a client outlived {timeout} s")
    return out, wall, errors


def host_memory() -> Dict[str, Any]:
    """The process's host memory: its resident set (``rss_bytes``, from
    ``/proc/self/statm`` where there is one, else None) and, where a card
    is in use, torch's caching host allocator, the pinned memory the
    transfers use (``pinned``: the byte counts of
    ``torch.cuda.host_memory_stats()``, else None)."""
    import os
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        rss = None
    pinned = None
    if _card_in_use():
        import torch
        stats = getattr(torch.cuda, "host_memory_stats", None)
        if stats is not None:
            pinned = {k: v for k, v in stats().items() if "bytes" in k}
    return {"rss_bytes": rss, "pinned": pinned}
