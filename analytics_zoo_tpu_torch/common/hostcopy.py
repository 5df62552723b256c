"""Host<->card copies that never make the host wait implicitly.

The serving and decode hot paths move their inputs up and their results
down through these helpers, so that a warmed loop holds no implicit
synchronisation: the sanitizer's guard (``torch.cuda.set_sync_debug_mode
("error")``) raises on a blocking ``.cpu()``, ``.item()`` or
``.tolist()``, and a copy between pageable host memory and the card may
wait for the stream while the driver stages it, which the guard does
not see.  So both directions go through pinned memory:

* :func:`upload` copies a pageable source into a pinned block of torch's
  caching host allocator on the host, then issues the copy up
  non-blocking; the allocator keeps the block until that copy is done.
* :func:`start_fetch` issues non-blocking copies down into pinned memory
  (a caller's ring, or allocator blocks) and records an event after them
  on each source device's current stream; :func:`wait` waits on those
  events, the one explicit synchronisation.
* :func:`fetch` does both and hands back numpy arrays in pageable memory
  that the caller owns, so that a reply kept by a caller holds no pinned
  memory: the pinned blocks go back to the allocator for the next fetch.
  That copy out is torch's CPU copy, split over the intra-op threads:
  most of its time is the page faults of the fresh pages.

On the CPU the copies are plain (CPU results are cloned: they may alias
a buffer that is reused).  Port-only: the JAX package's transfers are
``jax.device_put`` and ``jax.device_get``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """Tensor ``t`` on ``device``: from the host to a card through
    pinned memory (module doc); any other move as ``Tensor.to``."""
    if torch.device(device).type != "cuda" or t.device.type != "cpu":
        return t.to(device, non_blocking=True)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def start_fetch(tensors: Sequence[torch.Tensor],
                out: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[List[torch.Tensor], List["torch.cuda.Event"]]:
    """Start copying ``tensors`` to the host: (host tensors, events).
    A CUDA tensor is copied non-blocking into pinned memory (``out[i]``
    when given, else a block of torch's caching host allocator), on the
    current stream of its device, and one event is recorded after the
    copies on each such stream; a CPU tensor is cloned.  The host
    tensors hold the values once :func:`wait` has returned."""
    host: List[torch.Tensor] = []
    devices: List[torch.device] = []
    for i, t in enumerate(tensors):
        if not t.is_cuda:
            host.append(t.clone())
            continue
        if t.device not in devices:
            devices.append(t.device)
        if out is None:
            host.append(t.to("cpu", non_blocking=True))
        else:
            host.append(out[i].copy_(t, non_blocking=True))
    events = []
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        events.append(event)
    return host, events


def wait(events: Sequence["torch.cuda.Event"]) -> None:
    """Wait for :func:`start_fetch`'s copies (not an implicit sync: the
    guard passes an event's wait)."""
    for event in events:
        event.synchronize()


def fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """``tensors`` as host numpy arrays that the caller owns, waited for
    (module doc)."""
    host, events = start_fetch(tensors)
    wait(events)
    return [_pageable(h).numpy() if h.is_pinned() else h.numpy()
            for h in host]


def _pageable(h: torch.Tensor) -> torch.Tensor:
    """A pageable copy of pinned ``h``: torch's CPU copy, which splits a
    large copy (and the page faults of its fresh pages) over the
    intra-op threads."""
    out = torch.empty(h.shape, dtype=h.dtype)
    return out.copy_(h)
