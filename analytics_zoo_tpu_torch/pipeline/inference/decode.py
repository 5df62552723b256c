"""Continuous batching for autoregressive decode.

Counterpart of ``analytics_zoo_tpu/pipeline/inference/decode.py``.
``DecodeEngine`` serves token streams with iteration-level scheduling:
requests join and leave the batch at every decode step, so a short
request never waits on a long neighbour.

* **Bucketed admission.**  A prompt is right-padded to the smallest
  prompt bucket that holds it and prefilled in one causal forward (the
  flash forward kernel on the card), its K/V written into a free slot of
  the decode state.  Admission runs eagerly: it launches the flash kernel
  through its wrapper, whose launch counter is on the host.
* **One fixed-capacity slot array.**  The decode state is per-layer K/V
  caches of shape ``(capacity, heads, max_len, d_head)`` plus per-slot
  token, position and sampling values, all allocated once.  The step
  reads per-slot positions, so occupied and free slots share one
  computation whose shapes never depend on occupancy: admission and
  eviction are writes into the state.
* **Step plans are CUDA graphs.**  The single step, each fused window of
  k steps and the speculative window are captured once each, into one
  shared memory pool, and replayed; the captures happen in ``warmup``
  (or when the dispatcher starts, before any slot is live) and their
  count never moves with occupancy.
  A capture that fails raises.  On the CPU the same Python bodies run
  eagerly.  No plan leaves a live allocation behind (every result is
  copied into a state tensor made before capture), which is what makes
  one pool safe for plans replayed in any order on one stream.
* **A dispatcher thread on a stream of its own** loops: admit queued
  requests into free slots, dispatch the next step, then fetch and fan
  out the previous one.  The fetch is one non-blocking copy of the
  (k, capacity) int32 tokens into pinned memory and an event, synced
  when the step is processed: the one host sync per dispatch.
* **Per-slot sampling.**  Temperature, top-k and top-p are per-slot
  tensors (``temperature == 0`` selects the bare argmax, bit for bit the
  greedy token), and each slot's uniform is a pure integer hash of
  (request seed, absolute token index) computed on the device, so
  streams replay and do not depend on who else is decoding.  The bits
  differ from the JAX package's threefry ``fold_in`` stream.
* **Prefix-KV pool.**  A prompt is split at the largest prompt bucket
  <= its length; the prefix block's K/V and last hidden state are kept
  in an LRU keyed on a content hash, so a shared prefix is a copy plus a
  short tail prefill (``_prefill_ext``).  A hit copies what a miss
  computes with the same prefill, so hit and miss streams are equal.
* **Speculative decoding.**  A draft model proposes ``spec_tokens - 1``
  tokens; the target takes one exact single-query step (the same body as
  the plain step, so a full rejection gives the plain stream) and
  verifies the proposals with a k-query ``_decode_window``; accepted
  proposals emit up to ``spec_tokens`` tokens a dispatch.
* **Mesh: slots split over a device group.**  ``DecodeEngine(mesh=...)``
  returns a :class:`MeshDecodeEngine`, a router over member engines:
  the capacity is split over the first group the spec carves from the
  devices, and each member is a ``DecodeEngine`` of its own over a
  contiguous slice of the slots, with its own copy of the params, its
  own KV-cache slice, its own captured CUDA graphs and stream.
  Admission routes a request to the member with the fewest live
  requests.  No step has a cross-slot term, so a slot's stream is the
  unsplit engine's up to the GEMMs' rounding: each member runs them at
  ``capacity / group size`` rows, and the BLAS may pick another
  algorithm at that size.

* **Tracing.**  A request submitted with a span (``observability/
  trace.py``) carries it to the dispatcher thread: ``decode_wait``
  opens on the caller's thread, the dispatcher marks ``prefill`` at
  admission (activating the span there, so that a kernel build lands in
  its trace) and ``decode_step`` from then until eviction, and labels
  ``decode_bucket`` and ``decode_slot`` from the host integers it holds.
  Phases are marked around graph replays, never inside a capture, and
  nothing waits for the device to fill them.  Every capture is reported
  to ``observability/profile.py`` as a compile.

The decode math is :mod:`analytics_zoo_tpu_torch.models.generation`'s.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...common import execstore, hostcopy
from ...models.generation import (_decode_step, _decode_window,
                                  _embed_token, _head_logits, _prefill,
                                  _prefill_ext)
from ...observability import profile as _profile
from ...observability import trace as _trace
from .serving import (_norm_device, available_devices, bucket_ladder,
                      module_twin)

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 tensors ``x`` in [0, 2**32) and a
    constant ``c`` < 2**32, in 16-bit halves so no product leaves
    int64."""
    return ((x & 0xFFFF) * c + (((x >> 16) * c) & 0xFFFF) * 65536) & _M32


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def slot_uniforms(seed, index):
    """One uniform in [0, 1) per slot, a pure function of the int64
    tensors (request seed, absolute token index): integer tensor ops
    only, so a CUDA graph holds it and a stream replays at any
    occupancy."""
    h = _mix32((_mix32(seed & _M32) + index) & _M32)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def select_tokens(logits, uniforms, temperature, top_k, top_p):
    """Per-row token selection with per-row (tensor) sampling values,
    as the JAX package's ``_sample`` with traced scalars: the greedy
    argmax where ``temperature == 0``, else a temperature softmax cut to
    its top ``top_k`` (``<= 0``: off) and its nucleus ``top_p`` (1: off),
    drawn by inverse CDF from ``uniforms``.  One stable descending sort
    serves both cuts and the draw."""
    greedy = torch.argmax(logits, dim=-1)
    t = temperature.clamp_min(1e-6)
    scaled = logits.float() / t[:, None]
    V = scaled.shape[-1]
    srt, src = torch.sort(scaled, dim=-1, descending=True, stable=True)
    kth = srt.gather(-1, (top_k - 1).clamp(0, V - 1)[:, None])
    kth = torch.where(top_k[:, None] > 0, kth, -torch.inf)
    e = torch.exp(srt - srt[:, :1])
    csum = torch.cumsum(e, dim=-1)
    # keep the sorted prefix whose mass strictly before each entry is
    # < p of the total: the top token always survives
    keep = (csum - e) < top_p[:, None] * csum[:, -1:]
    pth = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
    ek = torch.where(srt >= torch.maximum(kth, pth), e, 0.0)
    ck = torch.cumsum(ek, dim=-1)
    pick = (ck <= uniforms[:, None] * ck[:, -1:]).sum(dim=-1)
    # u can round up to the total: clamp to the kept prefix so a cut
    # token is never drawn
    kept = (ek > 0.0).sum(dim=-1)
    pick = torch.minimum(pick, (kept - 1).clamp_min(0))
    sampled = src.gather(-1, pick[:, None])[:, 0]
    return torch.where(temperature > 0.0, sampled, greedy)


def skeleton_draft(model):
    """The cheapest draft for speculative decoding: a 0-layer
    TransformerLM sharing ``model``'s embeddings, final LayerNorm and
    head (token + position embedding -> LayerNorm -> lm_head)."""
    h = model.hyper
    draft = type(model)(vocab_size=h["vocab_size"], seq_len=h["seq_len"],
                        n_layers=0, d_model=h["d_model"],
                        n_heads=h["n_heads"], max_len=h["max_len"],
                        device=model.device)
    for name in ("tok_embed", "pos_embed", "ln_final", "lm_head"):
        setattr(draft, name, getattr(model, name))
    draft.rewire()
    return draft.eval()


class DecodeEngineClosedError(RuntimeError):
    """The decode dispatcher is gone: this request was (or would be)
    never served."""


class TokenStream:
    """Per-request streaming handle: tokens arrive one decode step at a
    time; iterate it to stream, or :meth:`result` for the whole
    continuation.  The dispatcher is the only writer (one list append a
    token; the condition is touched only once a consumer iterates)."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._tokens: List[int] = []
        self._error: Optional[BaseException] = None
        self._finished = threading.Event()
        self._live = False  # a consumer is iterating: notify pushes
        self._cond = threading.Condition()
        #: perf_counter times of submit and of each token's arrival
        self.t_submit = time.perf_counter()
        self.t_tokens: List[float] = []

    # ---- producer side (dispatcher thread only) ----
    def _push(self, tok: int):
        self.t_tokens.append(time.perf_counter())
        self._tokens.append(tok)
        if self._live:
            with self._cond:
                self._cond.notify_all()

    def _finish(self, error: Optional[BaseException] = None):
        self._error = error
        self._finished.set()
        if self._live:
            with self._cond:
                self._cond.notify_all()

    # ---- consumer side ----
    @property
    def done(self) -> bool:
        return self._finished.is_set()

    def __iter__(self):
        self._live = True
        i = 0
        while True:
            while i < len(self._tokens):
                yield int(self._tokens[i])
                i += 1
            if self._finished.is_set():
                if i < len(self._tokens):
                    continue  # tokens landed after the done flag
                if self._error is not None:
                    raise self._error
                return
            with self._cond:
                if i >= len(self._tokens) \
                        and not self._finished.is_set():
                    # bounded: a push may have raced the first iteration
                    self._cond.wait(0.05)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request finishes; returns the continuation as
        a 1-D int32 array (EOS included when hit)."""
        if not self._finished.wait(timeout=timeout):
            raise TimeoutError(
                f"decode request {self.request_id} still streaming "
                f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return np.asarray(self._tokens, np.int32)


class _DecodeRequest:
    # ``scheduled`` counts tokens covered by dispatched (possibly not yet
    # processed) steps: the pipelined loop plans fused windows from it.
    # ``span`` is the explicit cross-thread trace handoff (as the
    # coalescer's _Request): the dispatcher marks its phases directly
    __slots__ = ("prompt", "length", "bucket", "max_new", "eos_id",
                 "stream", "span", "produced", "scheduled", "temperature",
                 "top_k", "top_p", "seed")

    def __init__(self, prompt: np.ndarray, length: int, bucket: int,
                 max_new: int, eos_id: Optional[int], stream: TokenStream,
                 span=None, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0):
        self.prompt = prompt
        self.length = length
        self.bucket = bucket
        self.max_new = max_new
        self.eos_id = eos_id
        self.stream = stream
        self.span = span
        self.produced = 0
        self.scheduled = 0
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed


class _PrefixEntry:
    """One pooled prefix: the per-layer (k, v) blocks of a prefix
    prefill and its last position's hidden state (the logits source of a
    prompt that is exactly the prefix)."""

    __slots__ = ("kv", "h_last")

    def __init__(self, kv, h_last):
        self.kv = kv
        self.h_last = h_last


class _PrefixPool:
    """Dispatcher-owned LRU of prefix-KV blocks keyed on the prefix
    content hash (sha256 over the shape and the token bytes): an entry
    only ever serves the exact prefix it was computed from, and an
    evicted one is recomputed (counted, never wrong)."""

    def __init__(self, size: int):
        self.size = int(size)
        self.entries: "collections.OrderedDict[str, _PrefixEntry]" = \
            collections.OrderedDict()

    @staticmethod
    def key(prefix_ids: np.ndarray) -> str:
        ids = np.ascontiguousarray(prefix_ids, np.int32)
        h = hashlib.sha256()
        h.update(repr(ids.shape).encode())
        h.update(ids.tobytes())
        return h.hexdigest()

    def get(self, key: str) -> Optional[_PrefixEntry]:
        ent = self.entries.get(key)
        if ent is not None:
            self.entries.move_to_end(key)
        return ent

    def put(self, key: str, entry: _PrefixEntry) -> int:
        """Insert as most recent and trim to ``size``; returns how many
        entries were evicted."""
        self.entries[key] = entry
        self.entries.move_to_end(key)
        evicted = 0
        while len(self.entries) > self.size:
            self.entries.popitem(last=False)
            evicted += 1
        return evicted


def _generate(validate, submit, prompts, max_new_tokens, eos_id, timeout,
              span, temperature, top_k, top_p, seed) -> List[np.ndarray]:
    """``generate`` over an engine's ``validate`` and ``submit``: every
    row validated before the first is queued, then each row's
    continuation."""
    rows = ([np.asarray(prompts[i]) for i in range(len(prompts))]
            if isinstance(prompts, (list, tuple))
            else [r for r in np.asarray(prompts)])
    if np.ndim(max_new_tokens) == 0:
        max_news = [int(max_new_tokens)] * len(rows)
    else:
        max_news = [int(m) for m in max_new_tokens]
        if len(max_news) != len(rows):
            raise ValueError(
                f"max_new_tokens has {len(max_news)} entries for "
                f"{len(rows)} prompts")
    if np.ndim(seed) == 0:
        seeds = [int(seed)] * len(rows)
    else:
        seeds = [int(s) for s in seed]
        if len(seeds) != len(rows):
            raise ValueError(
                f"seed has {len(seeds)} entries for "
                f"{len(rows)} prompts")
    for r, m, s in zip(rows, max_news, seeds):
        validate(r, m, temperature, top_k, top_p, s)
    streams = [submit(r, m, eos_id=eos_id,
                      span=span if len(rows) == 1 else None,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=s)
               for (r, m, s) in zip(rows, max_news, seeds)]
    return [s.result(timeout=timeout) for s in streams]


class _Plan:
    """One step plan: ``body`` advances the decode state in place and
    leaves its results in ``outputs`` (state tensors).  On a CUDA device
    :meth:`build` warms the body once and captures it as a CUDA graph;
    calling the plan replays the graph and starts a non-blocking copy of
    the outputs into pinned host memory (a ring of two, as the loop holds
    at most one unprocessed dispatch), returning (host arrays, events to
    wait on: ``hostcopy.start_fetch``).  On the CPU the body runs
    eagerly and the outputs are copied."""

    def __init__(self, body, outputs: Sequence[torch.Tensor]):
        self.body = body
        self.outputs = list(outputs)
        self.graph = None
        self._host = None
        self._turn = 0

    def build(self, pool, stream):
        """Warm the body on ``stream`` and capture it into ``pool``; a
        failed capture raises."""
        self.body()
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.body()
        self.graph = graph
        self._host = [[torch.empty(t.shape, dtype=t.dtype,
                                   pin_memory=True) for t in self.outputs]
                      for _ in range(2)]

    def __call__(self):
        if self.graph is None:
            self.body()
            host, events = hostcopy.start_fetch(self.outputs)
        else:
            self.graph.replay()
            host, events = hostcopy.start_fetch(
                self.outputs, out=self._host[self._turn])
            self._turn ^= 1
        return [h.numpy() for h in host], events


_SHUTDOWN = object()


class DecodeEngine:
    """KV-cache-slotted continuous-batching decode engine (module doc).

    Args:
        model: a TransformerLM (the decode math reads its parameters by
            layer name); the engine runs on its device.
        capacity: decode slots, the fixed batch of every step plan.
        max_len: per-slot cache length (default the model's
            ``max_len``); a request needs ``prompt_len + max_new_tokens
            <= max_len``.
        prompt_buckets: the prompt-length ladder (default a geometric
            ladder up to ``max_len - 1``).
        eos_id: default end-of-sequence id (``submit`` overrides it);
            None decodes ``max_new_tokens`` always.
        max_queue: bound on submitted-but-unadmitted requests.
        step_fuse: fused-window size K: when no admission or eviction can
            land inside the next K steps they run as one plan (1 turns
            fusion off; see ``_choose_fuse``).
        prefix_pool: > 0 keeps that many prefix-KV blocks in an LRU pool
            (module doc); 0 admits every prompt in one prefill.
        draft: a small TransformerLM of the same vocabulary (see
            :func:`skeleton_draft`) turns on speculative decoding of up
            to ``spec_tokens`` tokens a dispatch.  Not with
            ``prefix_pool``.
        mesh: a sharded-serving spec (``serving.shardgroup``): the
            call returns a :class:`MeshDecodeEngine` splitting the slots
            over the first group carved from ``devices`` (default every
            device of the model's platform; a card may repeat).  Not with
            ``device``, ``prefix_pool`` or ``draft``.
        device: the engine's device, which is the model's (the engine
            runs where its model is); None takes the model's.
        store_tag: the ``model`` tag of the persistent store's entries
            written while the engine warms up (``common/execstore.py``).
    """

    def __new__(cls, *args, mesh=None, **kwargs):
        # the mesh engine is a router over member engines, not an engine
        # itself: returned as it is, so __init__ below never runs for it
        if mesh is not None:
            return MeshDecodeEngine(*args, mesh=mesh, **kwargs)
        return super().__new__(cls)

    def __init__(self, model, capacity: int = 8,
                 max_len: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, max_queue: int = 256,
                 step_fuse: int = 4, prefix_pool: int = 0, draft=None,
                 spec_tokens: int = 4, *, mesh=None, devices=None,
                 device=None, store_tag: Optional[str] = None):
        hyper = model.hyper
        if devices is not None:
            raise ValueError("devices= goes with mesh=: they are the "
                             "devices the mesh spec carves")
        if device is not None and _norm_device(device) != _norm_device(
                model.device):
            raise ValueError(f"the model is on {model.device}, the "
                             f"engine's device is {device}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if int(prefix_pool) < 0:
            raise ValueError(
                f"prefix_pool must be >= 0, got {prefix_pool}")
        if draft is not None and prefix_pool:
            raise ValueError(
                "draft (speculative) and prefix_pool are mutually "
                "exclusive in this engine version: the pooled prefix "
                "blocks would need a draft-cache twin")
        if draft is not None and spec_tokens < 2:
            raise ValueError(
                f"spec_tokens must be >= 2 (1 exact + >=1 proposed), "
                f"got {spec_tokens}")
        if draft is not None and int(draft.hyper["vocab_size"]) != int(
                hyper["vocab_size"]):
            raise ValueError(
                "draft and target must share a vocabulary "
                f"({draft.hyper['vocab_size']} vs {hyper['vocab_size']})")
        self.capacity = int(capacity)
        self.step_fuse = max(1, int(step_fuse))
        self.max_len = int(max_len or hyper["max_len"])
        if self.max_len > int(hyper["max_len"]):
            raise ValueError(
                f"max_len ({self.max_len}) exceeds the model's "
                f"positional table ({hyper['max_len']})")
        if prompt_buckets:
            self.prompt_buckets: Tuple[int, ...] = tuple(
                sorted(set(int(b) for b in prompt_buckets)))
        else:
            top = max(1, self.max_len - 1)
            self.prompt_buckets = bucket_ladder(
                top, growth=2.0, min_batch=min(8, top))
        if self.prompt_buckets[-1] >= self.max_len:
            raise ValueError(
                f"largest prompt bucket ({self.prompt_buckets[-1]}) "
                f"must leave room to decode (max_len {self.max_len})")
        self.eos_id = eos_id
        self.store_tag = store_tag
        self._model = model.eval()
        self.device = model.device
        self.spec_tokens = int(spec_tokens)
        self._draft = None
        if draft is not None:
            if int(draft.hyper["max_len"]) < self.max_len:
                raise ValueError(
                    f"draft positional table ({draft.hyper['max_len']}) "
                    f"is shorter than the engine's max_len "
                    f"({self.max_len})")
            if draft.device != self.device:
                raise ValueError(
                    f"draft on {draft.device}, target on {self.device}")
            self._draft = draft.eval()
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)

        # ---- the persistent slot array, made before any capture; a free
        # slot's token and position are don't-cares, since its cache line
        # is rewritten before it is attended
        dev = self.device
        self._caches = self._zero_caches(model)
        self._dcaches = (self._zero_caches(draft) if draft is not None
                         else [])
        cap = self.capacity
        self._tok = torch.zeros(cap, dtype=torch.int32, device=dev)
        self._pos = torch.zeros(cap, dtype=torch.long, device=dev)
        # per-slot sampling: request seed, absolute token index, and the
        # sampling values (temperature 0: argmax; top_k 0, top_p 1: off)
        self._seed = torch.zeros(cap, dtype=torch.long, device=dev)
        self._stepc = torch.zeros(cap, dtype=torch.long, device=dev)
        self._temp = torch.zeros(cap, dtype=torch.float32, device=dev)
        self._topk = torch.zeros(cap, dtype=torch.long, device=dev)
        self._topp = torch.ones(cap, dtype=torch.float32, device=dev)

        # step plans: the single step and a halving ladder of fused
        # windows (step_fuse, step_fuse // 2 > 1), or the speculative
        # window; built once (warmup, or the dispatcher's start)
        self._fuse_sizes: Tuple[int, ...] = tuple(
            sorted({k for k in (self.step_fuse, self.step_fuse // 2)
                    if k > 1}, reverse=True))
        self._step_plan: Optional[_Plan] = None
        self._stepk_plans: Dict[int, _Plan] = {}
        self._spec_plan: Optional[_Plan] = None
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None
        self._admit_built: set = set()
        self._pfx_built: set = set()
        self._prefix_pool = (_PrefixPool(prefix_pool) if prefix_pool
                             else None)

        # host-side slot bookkeeping (dispatcher-thread-owned)
        self._slots: List[Optional[_DecodeRequest]] = [None] * cap
        self._free: collections.deque = collections.deque(range(cap))
        self._counters = {"tokens": 0, "steps": 0, "prefills": 0,
                          "admitted": 0, "evicted": 0,
                          "fused_dispatches": 0, "sampled_tokens": 0,
                          "prefix_hits": 0, "prefix_misses": 0,
                          "prefix_evictions": 0, "spec_windows": 0,
                          "spec_proposed": 0, "spec_accepted": 0,
                          "plans_built": 0, "captures": 0}
        self._bucket_stats: Dict[str, Dict[int, Any]] = {
            "hits": {}, "misses": {}, "build_time_s": {}}
        self._occupancy = 0

        self._q: "queue.Queue" = queue.Queue(maxsize=int(max_queue))
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._closed = False
        self._submit_lock = threading.Lock()
        self._crashed = False
        # the request between the queue and its slot (its prefill): the
        # crash net finishes it too
        self._admitting: Optional[_DecodeRequest] = None
        # the dispatcher starts at the first submit: warmup() runs on the
        # caller's thread and writes the decode state, which belongs to
        # the dispatcher once it runs
        self._started = False
        self._warming = False
        self._start_cond = threading.Condition()
        self._thread = threading.Thread(
            target=self._decode_loop, name="zoo-decode-dispatch",
            daemon=True)
        self._after_caller()

    def _after_caller(self):
        """Order this engine's stream after the work the calling thread
        has queued on its own stream so far: the weights it wrote and
        the slot state made above."""
        if self._cuda:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _zero_caches(self, model):
        h = model.hyper
        shape = (self.capacity, int(h["n_heads"]), self.max_len,
                 int(h["d_model"]) // int(h["n_heads"]))
        return [(torch.zeros(shape, device=self.device),
                 torch.zeros(shape, device=self.device))
                for _ in range(int(h["n_layers"]))]

    def _on_device(self):
        """The context every piece of decode work runs in: no autograd,
        and on the card this engine's device and stream."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self._cuda:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _ensure_started(self):
        with self._start_cond:
            while self._warming:  # let an in-flight warmup finish
                self._start_cond.wait()
            if not self._started:
                self._started = True
                self._thread.start()

    # ---- the step bodies ------------------------------------------------
    def _select(self, logits, offset: int = 0):
        """Per-slot selection over (capacity, V) logits, each slot drawing
        the uniform of (seed, token index + offset)."""
        u = slot_uniforms(self._seed, self._stepc + offset)
        return select_tokens(logits, u, self._temp, self._topk,
                             self._topp).to(torch.int32)

    def _step_core(self):
        """One decode step over all ``capacity`` slots, without the state
        advance: writes each slot's K/V at its (clamped) position and
        returns the selected tokens.  The plain, fused and speculative
        plans all run this body, so their per-token numerics agree."""
        posc = self._pos.clamp(max=self.max_len - 1)
        emb = _embed_token(self._model, self._tok, posc)
        logits = _decode_step(self._model, self._caches, emb, posc)
        return self._select(logits)

    def _advance(self, tok, n):
        self._tok.copy_(tok)
        self._pos.copy_((self._pos + n).clamp(max=self.max_len))
        self._stepc.add_(n)

    def _step_body(self):
        self._advance(self._step_core(), 1)

    def _stepk_body(self, k: int, toks):
        for j in range(k):
            self._step_body()
            toks[j].copy_(self._tok)

    def _spec_body(self, T, accepted):
        """Draft proposals, one exact target step, the windowed verify and
        the acceptance, as one plan: ``T[0]`` is the exact step's token,
        ``T[1:]`` the verified target tokens for the proposals;
        ``accepted`` in [1, spec_tokens] counts the tokens valid to emit
        (a proposal is accepted while it equals the previous target
        token).  The draft runs one step past its proposals so that the
        last accepted token's draft K/V is written too; rejected
        positions are stale cache lines a later step rewrites before
        attending."""
        k, max_len, model = self.spec_tokens, self.max_len, self._model
        t, p = self._tok, self._pos
        props = []
        for _ in range(k):
            posc = p.clamp(max=max_len - 1)
            lg = _decode_step(self._draft, self._dcaches,
                              _embed_token(self._draft, t, posc), posc)
            t = torch.argmax(lg, dim=-1).to(torch.int32)
            props.append(t)
            p = (p + 1).clamp(max=max_len)
        dprops = torch.stack(props[:k - 1])  # (k - 1, capacity)
        t0 = self._step_core()
        embs = torch.stack(
            [_embed_token(model, dprops[j],
                          (self._pos + 1 + j).clamp(max=max_len - 1))
             for j in range(k - 1)], dim=1)
        wlogits = _decode_window(model, self._caches, embs, self._pos + 1)
        T.copy_(torch.stack([t0] + [self._select(wlogits[:, j], 1 + j)
                                    for j in range(k - 1)]))
        match = (dprops == T[:k - 1]).long()
        acc = 1 + torch.cumprod(match, dim=0).sum(dim=0)
        accepted.copy_(acc)
        self._advance(T.gather(0, (acc - 1)[None])[0], acc)

    def _make_plan(self, body, outputs) -> _Plan:
        plan = _Plan(body, outputs)
        if self._cuda:
            t0 = time.perf_counter()
            plan.build(self._pool, self._stream)
            self._counters["captures"] += 1
            # the port's compile: counted by the profile hooks
            _profile.note_compile(time.perf_counter() - t0,
                                  "cuda_graph_capture", kind="graph_capture")
        self._counters["plans_built"] += 1
        return plan

    def _ensure_step_plans(self):
        """Build the decode-loop plans (the speculative window for a
        drafted engine, else the step and the fused-window ladder)."""
        if self._step_plan is not None:
            return
        cap, dev = self.capacity, self.device
        if self._draft is not None:
            T = torch.zeros((self.spec_tokens, cap), dtype=torch.int32,
                            device=dev)
            acc = torch.zeros(cap, dtype=torch.long, device=dev)
            self._spec_plan = self._make_plan(
                lambda: self._spec_body(T, acc), [T, acc])
            self._step_plan = self._spec_plan  # the built flag
            return
        for k in self._fuse_sizes:
            toks = torch.zeros((k, cap), dtype=torch.int32, device=dev)
            self._stepk_plans[k] = self._make_plan(
                lambda k=k, toks=toks: self._stepk_body(k, toks), [toks])
        self._step_plan = self._make_plan(self._step_body, [self._tok])

    # ---- admission ------------------------------------------------------
    def _upload(self, ids) -> torch.Tensor:
        """Host token ids as an int64 tensor on the engine's device,
        through pinned memory to a card (``hostcopy.upload``: nothing
        waits for the device)."""
        return hostcopy.upload(
            torch.as_tensor(np.asarray(ids), dtype=torch.long), self.device)

    def _host_token(self, tok0) -> int:
        """The first token on the host, through pinned memory and an
        event on the card (an explicit fetch; a blocking
        ``int(tok0[0])`` would be an implicit one)."""
        host, events = hostcopy.start_fetch([tok0])
        hostcopy.wait(events)
        return int(host[0][0])

    def _first_token(self, logits0, req: _DecodeRequest):
        """The first token, at absolute index 0 of the request's
        stream.  The sampling values are filled on the device (no host
        tensor is copied up)."""
        def one(v, dtype):
            return torch.full((1,), v, dtype=dtype, device=self.device)

        seed = one(req.seed, torch.long)
        return select_tokens(
            logits0, slot_uniforms(seed, torch.zeros_like(seed)),
            one(req.temperature, torch.float32),
            one(req.top_k or 0, torch.long),
            one(1.0 if req.top_p is None else req.top_p, torch.float32)
        ).to(torch.int32)

    def _slot_write(self, slot: int, tok0, req: _DecodeRequest):
        """Activate ``slot``: its token, position and sampling state; the
        token index starts at 1, index 0 having drawn the first token.
        The host values are filled in on the device (``fill_``): an item
        assignment of a Python number copies a host scalar up and waits
        for it."""
        self._tok[slot] = tok0[0]
        self._pos[slot].fill_(req.length)
        self._seed[slot].fill_(req.seed)
        self._stepc[slot].fill_(1)
        self._temp[slot].fill_(req.temperature)
        self._topk[slot].fill_(req.top_k or 0)
        self._topp[slot].fill_(1.0 if req.top_p is None else req.top_p)

    def _note_bucket(self, bucket: int, fresh: bool, t0: float):
        stat = ("misses" if fresh
                and bucket not in self._bucket_stats["misses"] else "hits")
        self._bucket_stats[stat][bucket] = \
            self._bucket_stats[stat].get(bucket, 0) + 1
        if fresh:
            if self._cuda:
                self._stream.synchronize()
            bt = self._bucket_stats["build_time_s"]
            bt[bucket] = bt.get(bucket, 0.0) + time.perf_counter() - t0

    def _admit_monolithic(self, req: _DecodeRequest, slot: int) -> int:
        """One prefill of the whole padded prompt into ``slot``."""
        t0 = time.perf_counter()
        s_b = req.bucket
        prompt = self._upload(req.prompt)
        x, pc = _prefill(self._model, prompt, s_b)
        tok0 = self._first_token(
            _head_logits(self._model, x[0, req.length - 1][None]), req)
        for (ck, cv), (pk, pv) in zip(self._caches, pc):
            ck[slot, :, :s_b] = pk[0]
            cv[slot, :, :s_b] = pv[0]
        if self._draft is not None:
            _, dpc = _prefill(self._draft, prompt, s_b)
            for (ck, cv), (pk, pv) in zip(self._dcaches, dpc):
                ck[slot, :, :s_b] = pk[0]
                cv[slot, :, :s_b] = pv[0]
        self._slot_write(slot, tok0, req)
        fresh = s_b not in self._admit_built
        self._admit_built.add(s_b)
        self._note_bucket(s_b, fresh, t0)
        return self._host_token(tok0)

    def _prefix_bucket_for(self, n: int) -> int:
        """Largest prompt bucket <= n: the prefix split point."""
        p = self.prompt_buckets[0]
        for b in self.prompt_buckets:
            if b <= n:
                p = b
        return p

    def _prefix_fill(self, prefix_ids: np.ndarray) -> _PrefixEntry:
        """Prefill one (1, p_b) prefix: the blocks a pool hit copies."""
        p_b = prefix_ids.shape[1]
        x, pc = _prefill(self._model, self._upload(prefix_ids), p_b)
        return _PrefixEntry(pc, x[0, p_b - 1])

    def _admit_prefix(self, req: _DecodeRequest, slot: int) -> int:
        """Pool-eligible admission: split at the largest bucket <= the
        length, take the prefix block from the pool (or compute and pool
        it), prefill only the tail against it, and activate the slot."""
        t0 = time.perf_counter()
        p_b, s_b, L = self._prefix_bucket_for(req.length), req.bucket, \
            req.length
        key = _PrefixPool.key(req.prompt[0, :p_b])
        ent = self._prefix_pool.get(key)
        if ent is None:
            self._counters["prefix_misses"] += 1
            ent = self._prefix_fill(req.prompt[:, :p_b])
            self._counters["prefix_evictions"] += \
                self._prefix_pool.put(key, ent)
        else:
            self._counters["prefix_hits"] += 1
        h_last = ent.h_last
        tail_kv = None
        if s_b > p_b:
            tail = np.zeros((1, s_b - p_b), np.int64)
            tail[0, :L - p_b] = req.prompt[0, p_b:L]
            xt, tail_kv = _prefill_ext(self._model, self._upload(tail),
                                       ent.kv, p_b)
            h_last = xt[0, L - p_b - 1]
        for i, (ck, cv) in enumerate(self._caches):
            pk, pv = ent.kv[i]
            ck[slot, :, :p_b] = pk[0]
            cv[slot, :, :p_b] = pv[0]
            if tail_kv is not None:
                tk, tv = tail_kv[i]
                ck[slot, :, p_b:s_b] = tk[0]
                cv[slot, :, p_b:s_b] = tv[0]
        tok0 = self._first_token(_head_logits(self._model, h_last[None]),
                                 req)
        self._slot_write(slot, tok0, req)
        fresh = (p_b, s_b) not in self._pfx_built
        self._pfx_built.add((p_b, s_b))
        self._note_bucket(s_b, fresh, t0)
        return self._host_token(tok0)

    def warmup(self) -> float:
        """Run every prompt bucket's admission (and with a prefix pool,
        every (prefix, prompt) bucket pair) once and build every step
        plan, capturing the CUDA graphs, so that live streams never pay
        a first call.  Returns wall seconds.  The warm admissions land in
        slot 0 of the real state, which stays on the free list.  Must run
        before the first submit: the dispatcher owns the state after."""
        t0 = time.perf_counter()
        with self._start_cond:
            if self._started:
                raise RuntimeError(
                    "DecodeEngine.warmup() must run before the first "
                    "submit; the dispatcher owns the decode state once it "
                    "is serving")
            self._warming = True
        self._after_caller()
        try:
            with self._on_device(), execstore.tag_builds(self.store_tag):
                self._warm()
        finally:
            with self._start_cond:
                self._warming = False
                self._start_cond.notify_all()
        return time.perf_counter() - t0

    def _warm(self):
        def request(n, bucket):
            stream = TokenStream(0)
            return _DecodeRequest(np.zeros((1, bucket), np.int32), n,
                                  bucket, 1, None, stream)

        for b in self.prompt_buckets:
            self._admit_monolithic(request(1, b), 0)
        if self._prefix_pool is not None:
            # every (prefix bucket, prompt bucket) pair an eligible prompt
            # lands on: (b_i, b_i) at a bucket length, (b_i, b_i+1)
            # between; the pool itself is left empty
            pool, self._prefix_pool = self._prefix_pool, _PrefixPool(0)
            try:
                ladder = self.prompt_buckets
                for i, p_b in enumerate(ladder):
                    self._admit_prefix(request(p_b, p_b), 0)
                    if i + 1 < len(ladder):
                        self._admit_prefix(request(p_b + 1, ladder[i + 1]),
                                           0)
            finally:
                self._prefix_pool = pool
                for key in ("prefix_hits", "prefix_misses",
                            "prefix_evictions"):
                    self._counters[key] = 0
        self._ensure_step_plans()
        for plan in ([self._spec_plan] if self._draft is not None
                     else [self._step_plan, *self._stepk_plans.values()]):
            hostcopy.wait(plan()[1])

    # ---- submission -----------------------------------------------------
    @property
    def closed(self) -> bool:
        return (self._closed or self._crashed
                or (self._started and not self._thread.is_alive()))

    def bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt of {n} tokens exceeds the largest prompt bucket "
            f"({self.prompt_buckets[-1]})")

    @staticmethod
    def validate_sampling(temperature=0.0, top_k=None, top_p=None,
                          seed=0):
        """Sampling-parameter validation (raises ValueError); returns the
        normalized (temperature, top_k, top_p, seed)."""
        t = float(temperature)
        if not np.isfinite(t) or t < 0.0:
            raise ValueError(
                f"temperature must be a finite value >= 0, got "
                f"{temperature!r}")
        if top_k is not None:
            top_k = int(top_k)
            if top_k < 1:
                raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None:
            top_p = float(top_p)
            if not (0.0 < top_p <= 1.0):
                raise ValueError(
                    f"top_p must lie in (0, 1], got {top_p}")
        seed = int(seed)
        if not (0 <= seed < 2 ** 31):
            raise ValueError(
                f"seed must lie in [0, 2**31), got {seed}")
        return t, top_k, top_p, seed

    def _validate(self, prompt_ids, max_new_tokens, temperature=0.0,
                  top_k=None, top_p=None, seed=0):
        """Request validation (raises ValueError, mutates nothing):
        (1-D prompt, length, bucket, max_new, sampling tuple)."""
        prompt = np.asarray(prompt_ids)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(
                f"prompt_ids must be a non-empty 1-D id sequence, got "
                f"shape {prompt.shape}")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new}")
        L = int(prompt.shape[0])
        if L + max_new > self.max_len:
            raise ValueError(
                f"prompt ({L}) + max_new_tokens ({max_new}) exceeds "
                f"max_len ({self.max_len})")
        samp = self.validate_sampling(temperature, top_k, top_p, seed)
        return prompt, L, self.bucket_for(L), max_new, samp

    def submit(self, prompt_ids, max_new_tokens: int,
               eos_id: Optional[int] = None, span=None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: int = 0) -> TokenStream:
        """Queue one prompt (1-D ids, or a (1, L) row); returns its
        :class:`TokenStream` at once.  Decoding stops at EOS (``eos_id``
        overrides the engine's; included in the stream) or after
        ``max_new_tokens``.  ``temperature`` > 0 samples (top-k/top-p
        cut) from the request's (seed, token index) stream: the same
        request replays the same tokens at any occupancy.  ``span`` (the
        request's trace span) rides the request to the dispatcher."""
        prompt, L, bucket, max_new, samp = self._validate(
            prompt_ids, max_new_tokens, temperature, top_k, top_p, seed)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :L] = prompt
        with self._id_lock:
            self._next_id += 1
            rid = self._next_id
        stream = TokenStream(rid)
        if span is not None:
            # opened on the caller's thread: the queue, until the
            # dispatcher starts this request's prefill
            span.phase_start("decode_wait")
        req = _DecodeRequest(padded, L, bucket, max_new,
                             self.eos_id if eos_id is None else eos_id,
                             stream, span, temperature=samp[0],
                             top_k=samp[1], top_p=samp[2], seed=samp[3])
        with self._submit_lock:
            if self.closed:
                raise DecodeEngineClosedError(
                    "DecodeEngine is closed; no dispatcher is serving "
                    "this queue")
            self._q.put(req)
            self._ensure_started()
        if self._crashed or not self._thread.is_alive():
            # the dispatcher died between the check and the enqueue
            self._flush_queue(DecodeEngineClosedError(
                "DecodeEngine dispatcher died"))
        return stream

    def generate(self, prompts, max_new_tokens, eos_id=None,
                 timeout: Optional[float] = None, span=None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 seed=0) -> List[np.ndarray]:
        """Blocking :meth:`submit` of a batch (a (B, L) array, or a list
        of ragged 1-D rows): each row's continuation (1-D int32).
        ``max_new_tokens`` and ``seed`` may be per row.  Every row is
        validated before the first is queued.  ``span`` rides the
        request when there is exactly one row (a span has one owner at a
        time; several rows would interleave its phases)."""
        return _generate(self._validate, self.submit, prompts,
                         max_new_tokens, eos_id, timeout, span,
                         temperature, top_k, top_p, seed)

    # ---- stats ----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Point-in-time decode counters."""
        out = dict(self._counters)
        out.update(capacity=self.capacity,
                   slots_active=self._occupancy,
                   queued=self._q.qsize(),
                   prompt_buckets=self.prompt_buckets,
                   prefill_hits=dict(self._bucket_stats["hits"]),
                   prefill_misses=dict(self._bucket_stats["misses"]),
                   prefill_build_time_s=dict(
                       self._bucket_stats["build_time_s"]))
        pool = self._prefix_pool
        out["prefix_pool_size"] = pool.size if pool is not None else 0
        out["prefix_pool_entries"] = (len(pool.entries)
                                      if pool is not None else 0)
        out["spec_enabled"] = self._draft is not None
        proposed = out.get("spec_proposed", 0)
        out["spec_acceptance"] = (
            round(out.get("spec_accepted", 0) / proposed, 4)
            if proposed else None)
        return out

    # ---- dispatcher -----------------------------------------------------
    def _flush_queue(self, exc: BaseException):
        try:
            while True:
                r = self._q.get_nowait()
                if r is not _SHUTDOWN:
                    if r.span is not None:
                        r.span.phase_end()
                    r.stream._finish(exc)
        except queue.Empty:
            pass

    def close(self, timeout: float = 5.0):
        """Stop the dispatcher: active slots and queued requests are
        served first (graceful drain), then anything racing the shutdown
        fails with DecodeEngineClosedError.  Idempotent."""
        with self._submit_lock:
            already = self._closed
            self._closed = True
            if not already and self._thread.is_alive():
                self._q.put(_SHUTDOWN)
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        if not self._thread.is_alive():
            self._flush_queue(DecodeEngineClosedError(
                "DecodeEngine closed"))

    def _admit_slot(self, req: _DecodeRequest, slot: int):
        """Admit one queued request into ``slot``: prefill (pooled when
        eligible), stream the first token, and activate the slot, or
        finish the request at once when that token ends it."""
        self._admitting = req
        span = req.span
        if span is not None:
            span.phase_start("prefill")
        # the span is active across the prefill, so that a kernel build
        # there lands in its trace
        with (_trace.activate(span) if span is not None
              else contextlib.nullcontext()):
            if (self._prefix_pool is not None
                    and req.length >= self.prompt_buckets[0]):
                tok0 = self._admit_prefix(req, slot)
            else:
                tok0 = self._admit_monolithic(req, slot)
        self._counters["prefills"] += 1
        self._counters["admitted"] += 1
        self._counters["tokens"] += 1
        if req.temperature > 0.0:
            self._counters["sampled_tokens"] += 1
        req.produced = 1
        req.scheduled = 1
        req.stream._push(tok0)
        if span is not None:
            span.set_label("decode_bucket", req.bucket)
            span.set_label("decode_slot", slot)
        if (req.produced >= req.max_new
                or (req.eos_id is not None and tok0 == req.eos_id)):
            if span is not None:
                span.phase_end()
            self._counters["evicted"] += 1
            req.stream._finish()
            self._free.append(slot)
            self._admitting = None
            return
        if span is not None:
            # one phase for the whole shared-step participation
            span.phase_start("decode_step")
        self._slots[slot] = req
        self._occupancy += 1
        self._admitting = None

    def _choose_fuse(self) -> int:
        """Window size of the next dispatch.  A fused window never crosses
        a scheduling event, so admissions and evictions land on the same
        step indices as with single steps: the window is the least
        remaining-to-schedule over active slots (1 for a request that can
        end on EOS), cut to the plan ladder.  With an empty queue the
        full window is taken even past a request's end: nobody waits for
        the slot and the surplus tokens are dropped at fan-out."""
        if not self._fuse_sizes:
            return 1
        if self._q.empty():
            return self.step_fuse
        rem = self.step_fuse
        for req in self._slots:
            if req is None:
                continue
            r = (1 if req.eos_id is not None
                 else req.max_new - req.scheduled)
            if r < rem:
                rem = r
                if rem <= 1:
                    return 1
        for k in self._fuse_sizes:
            if k <= rem:
                return k
        return 1

    def _dispatch_step(self):
        """Dispatch the next window without waiting for it, and snapshot
        the slot map as of this dispatch (the fan-out routes tokens
        against it).  Returns (fetch, speculative, snapshot, window)."""
        if self._draft is not None:
            k = self.spec_tokens
            fetch = self._spec_plan()
            self._counters["spec_windows"] += 1
        else:
            k = self._choose_fuse()
            if k > 1:
                fetch = self._stepk_plans[k]()
                self._counters["fused_dispatches"] += 1
            else:
                fetch = self._step_plan()
        self._counters["steps"] += k
        for req in self._slots:
            if req is not None:
                req.scheduled += k
        return fetch, self._draft is not None, list(self._slots), k

    def _push_window(self, snapshot, toks, counts):
        """Fan one window out to the slots live at dispatch time,
        evicting finished requests: ``toks`` is (k, capacity),
        ``counts[slot]`` how many rows are valid for that slot.  A
        request finished while processing an earlier window (the snapshot
        can still name it) is skipped."""
        for slot, req in enumerate(snapshot):
            if req is None or req.stream.done:
                continue
            sampled = req.temperature > 0.0
            for j in range(counts[slot]):
                tok = int(toks[j, slot])
                req.produced += 1
                self._counters["tokens"] += 1
                if sampled:
                    self._counters["sampled_tokens"] += 1
                req.stream._push(tok)
                if (req.produced >= req.max_new
                        or (req.eos_id is not None
                            and tok == req.eos_id)):
                    if req.span is not None:
                        req.span.phase_end()
                    self._counters["evicted"] += 1
                    self._occupancy -= 1
                    req.stream._finish()
                    self._slots[slot] = None
                    self._free.append(slot)
                    break

    def _process_step(self, pending):
        """Wait for a dispatched window's tokens and fan them out."""
        (host, events), spec, snapshot, k = pending
        hostcopy.wait(events)
        toks = host[0].reshape(-1, self.capacity)
        if not spec:
            self._push_window(snapshot, toks, [k] * self.capacity)
            return
        acc = host[1]
        counts = [0] * self.capacity
        for slot, req in enumerate(snapshot):
            if req is None or req.stream.done:
                continue
            counts[slot] = int(acc[slot])
            # live slots only: free slots' windows would dilute the rate
            self._counters["spec_proposed"] += k - 1
            self._counters["spec_accepted"] += int(acc[slot]) - 1
        self._push_window(snapshot, toks, counts)

    def _decode_loop(self):
        try:
            with self._on_device():
                self._loop_inner()
        except BaseException as e:  # crash net: never strand a caller
            # _crashed flips before the lock barrier: a submit inside its
            # critical section finishes and flushes itself, a later one
            # sees closed; bounded, as a submitter blocked on a full
            # queue holds the lock until the flush frees room
            self._crashed = True
            got = self._submit_lock.acquire(timeout=1.0)
            if got:
                self._submit_lock.release()
            self._flush_queue(e)
            admitting, self._admitting = self._admitting, None
            for req in [*self._slots, admitting]:
                if req is not None and not req.stream.done:
                    if req.span is not None:
                        req.span.phase_end()
                    req.stream._finish(e)
            self._slots[:] = [None] * len(self._slots)
            self._occupancy = 0
            raise

    def _loop_inner(self):
        # one-deep pipeline: step n+1 is dispatched before step n's
        # tokens are fetched, so the host's fan-out, evictions and the
        # next admission overlap the device's step; an eviction is seen
        # one step late, so a freed slot re-admits one step later
        # plans not built by warmup() are built here, before the first
        # admission: building runs each body once, which advances every
        # slot and may only touch free ones
        self._ensure_step_plans()
        pending = None
        shutdown = False
        while True:
            while self._free and not shutdown:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    shutdown = True
                    break
                self._admit_slot(nxt, self._free.popleft())
            nxt_pending = (self._dispatch_step() if self._occupancy
                           else None)
            if pending is not None:
                self._process_step(pending)
            pending = nxt_pending
            if pending is None and not self._occupancy:
                if shutdown:
                    return
                try:
                    nxt = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if nxt is _SHUTDOWN:
                    shutdown = True
                    continue
                self._admit_slot(nxt, self._free.popleft())


class MeshDecodeEngine:
    """What ``DecodeEngine(mesh=...)`` returns: a router over member
    engines that splits the slot capacity over the first device group the
    mesh spec carves from ``devices`` (module doc).  Member ``j`` is a
    :class:`DecodeEngine` of ``capacity / group size`` slots on the
    group's ``j``-th device, with its own copy of the params (member 0
    serves the model itself when it is on that device), KV caches, CUDA
    graphs, stream and dispatcher.  :meth:`submit` routes to the member
    with the fewest live requests; :meth:`generate`, :meth:`stats`,
    :meth:`warmup` and :meth:`close` cover every member.  The JAX
    package's refusals hold: ``device`` with a mesh, ``prefix_pool`` or
    a draft under a mesh, and a capacity that does not divide by the
    group size."""

    def __init__(self, model, capacity: int = 8,
                 max_len: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, max_queue: int = 256,
                 step_fuse: int = 4, prefix_pool: int = 0, draft=None,
                 spec_tokens: int = 4, *, mesh, devices=None,
                 device=None, store_tag: Optional[str] = None):
        from ...serving.shardgroup import carve_groups, normalize_mesh_spec
        if device is not None:
            raise ValueError(
                "pass mesh= or device=, not both — the mesh spec "
                "carves the engine's device group itself")
        if prefix_pool or draft is not None:
            raise ValueError(
                "mesh-sharded decode does not support prefix_pool "
                "or speculative drafts in this engine version — "
                "their pool/draft caches would need the same slot "
                "sharding twin")
        spec = normalize_mesh_spec(mesh)
        devs = ([_norm_device(d) for d in devices] if devices
                else available_devices(model.device))
        gdevs, _ = carve_groups(devs, spec)[0]
        if int(capacity) % len(gdevs):
            raise ValueError(
                f"capacity ({capacity}) must divide evenly "
                f"over the mesh's {len(gdevs)} devices")
        per = int(capacity) // len(gdevs)
        self.members: List[DecodeEngine] = []
        for j, dev in enumerate(gdevs):
            own = model if (j == 0 and dev == model.device) else \
                module_twin(model, lambda t, dev=dev: t.to(dev, copy=True))
            self.members.append(DecodeEngine(
                own, capacity=per, max_len=max_len,
                prompt_buckets=prompt_buckets, eos_id=eos_id,
                max_queue=max_queue, step_fuse=step_fuse,
                store_tag=store_tag))
        self.capacity = int(capacity)
        self.max_len = self.members[0].max_len
        self.prompt_buckets = self.members[0].prompt_buckets
        self.store_tag = store_tag
        self.device = gdevs[0]
        self.devices = tuple(gdevs)
        self.mesh_spec = spec
        self._route_lock = threading.Lock()
        self._live: List[List[TokenStream]] = [[] for _ in self.members]

    @property
    def closed(self) -> bool:
        return any(m.closed for m in self.members)

    def warmup(self) -> float:
        """Warm every member (each admission bucket, each step plan);
        returns wall seconds."""
        t0 = time.perf_counter()
        for m in self.members:
            m.warmup()
        return time.perf_counter() - t0

    def submit(self, prompt_ids, max_new_tokens: int,
               eos_id: Optional[int] = None, span=None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: int = 0) -> TokenStream:
        """Queue one prompt on the member with the fewest live requests
        (ties to the lowest index); as :meth:`DecodeEngine.submit`."""
        with self._route_lock:
            for live in self._live:
                live[:] = [s for s in live if not s.done]
            j = min(range(len(self.members)),
                    key=lambda i: (len(self._live[i]), i))
            stream = self.members[j].submit(
                prompt_ids, max_new_tokens, eos_id=eos_id, span=span,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed)
            self._live[j].append(stream)
        return stream

    def generate(self, prompts, max_new_tokens, eos_id=None,
                 timeout: Optional[float] = None, span=None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 seed=0) -> List[np.ndarray]:
        """As :meth:`DecodeEngine.generate`, each row routed by
        :meth:`submit`; the members share one request validation."""
        return _generate(self.members[0]._validate, self.submit, prompts,
                         max_new_tokens, eos_id, timeout, span,
                         temperature, top_k, top_p, seed)

    def stats(self) -> Dict[str, Any]:
        """The members' counters summed (per-bucket counters by bucket),
        with the mesh's axes and device count."""
        per = [m.stats() for m in self.members]
        out: Dict[str, Any] = {}
        for key, first in per[0].items():
            if isinstance(first, bool) or not isinstance(
                    first, (int, float, dict)):
                out[key] = first
            elif isinstance(first, dict):
                merged: Dict[Any, Any] = {}
                for st in per:
                    for k, v in st[key].items():
                        merged[k] = merged.get(k, 0) + v
                out[key] = merged
            else:
                out[key] = sum(st[key] for st in per)
        out["capacity"] = self.capacity
        out["mesh_axes"] = dict(self.mesh_spec["axes"])
        out["mesh_devices"] = len(self.members)
        return out

    def close(self, timeout: float = 5.0):
        for m in self.members:
            m.close(timeout)
