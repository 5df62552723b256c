"""ModelRegistry: named, versioned models with zero-downtime hot-swap,
canary traffic splitting, and per-model admission control.

Counterpart of ``analytics_zoo_tpu/serving/registry.py``, with the same
methods, errors, metrics snapshot and span plumbing.  One difference of
name: a raw function deploys as ``deploy(name, fn=..., params=...)``
(``fn(params, x)`` a torch callable, served by
``InferenceModel.load_fn``) where the JAX package takes ``jax_fn=``.

The control plane over the per-model data plane (bucketed forwards,
request coalescing and replica sets in ``pipeline/inference``).  The
reference analog is the POJO serving API behind the web-service sample:
a process-wide, thread-safe serving surface whose value is the
LIFECYCLE around the compute — deploy, swap, shed, observe — not the
forward pass itself.

Deploy protocol (the zero-downtime contract)::

    registry.deploy("ncf", net, warmup_shapes=(2,))

1. a FRESH ``InferenceModel`` is built and loaded for the new version —
   the live version's executables are never touched;
2. ``warmup()`` runs the new version's whole bucket ladder TO
   COMPLETION (each bucket's build) while the old version keeps serving;
   a decode-capable version captures its decode engine's CUDA graphs at
   load, before the swap too — live traffic never pays a build.  A
   replicated model (``replicas=``) builds each bucket ONCE and places
   it on EVERY replica before the swap, and the model's admission
   concurrency is re-scaled to ``max_concurrency * replicas``;
3. the active-version pointer is swapped atomically (one reference
   assignment; every request reads it exactly once, so each response is
   computed ENTIRELY by the old or entirely by the new version);
4. the old version is closed, which DRAINS it: its coalescer's queued
   requests complete on the old forward and its decode engine finishes
   every stream it admitted, then their threads exit.

If step 1 or 2 fails, the new model is discarded and
:class:`~.errors.DeployError` is raised — the previous version was
never unplugged, so rollback is a no-op (it just keeps serving).

Every request passes the model's :class:`~.admission.AdmissionController`
(bounded queue, concurrency limit, deadline-aware shedding), and
``metrics()`` snapshots the whole plane: per-version latency
percentiles, admission/shed counters, swap counts, and the data plane's
own ``BucketStats`` re-exported per model.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..observability import trace as _trace
from .admission import AdmissionController
from .errors import ColdStartTimeout, DeployError, ModelNotFound
from .metrics import Counters, LatencyWindow
from .pager import ModelPager, PageRecipe

_RETIRED_KEPT = 4  # retired versions whose metrics stay inspectable


class _Deployment:
    """One version of one model: the serving handle + its counters."""

    def __init__(self, version: int, model):
        self.version = version
        self.model = model
        self.state = "staged"  # staged -> active/canary -> retired
        self.latency = LatencyWindow()
        self.counters = Counters("requests", "errors")
        self.deployed_at = time.time()

    def stats(self) -> Dict[str, Any]:
        # deployed_at exports as ISO-8601 (UTC) — a raw epoch float in
        # a metrics payload is unreadable and timezone-ambiguous; the
        # uptime gauge is the number dashboards actually plot
        deployed_iso = datetime.datetime.fromtimestamp(
            self.deployed_at, datetime.timezone.utc).isoformat()
        return {"state": self.state, **self.counters.snapshot(),
                "deployed_at": deployed_iso,
                "uptime_s": round(time.time() - self.deployed_at, 3),
                "latency": self.latency.snapshot()}


class _Entry:
    """Registry slot for one model name."""

    def __init__(self, name: str, admission: AdmissionController):
        self.name = name
        self.lock = threading.RLock()      # control-plane ops (brief)
        self.route_lock = threading.Lock()  # canary accumulator only
        # serializes whole deploys (build -> warmup -> swap), which can
        # take seconds: without it two racing deploys could swap in
        # either order, leaving the OLDER version active.  Held only by
        # deploy(); never on the request path.
        self.deploy_lock = threading.Lock()
        self.admission = admission
        self.active: Optional[_Deployment] = None
        self.canary: Optional[_Deployment] = None
        self.canary_fraction = 0.0
        self._canary_acc = 0.0
        self.retired: List[_Deployment] = []
        self.swap_count = 0
        self.next_version = 1
        self.warmup_shapes = None
        self.warmup_dtypes = None
        # weight-pager residency (serving/pager.py).  pager_state is
        # None for unpaged entries — the ONE read the request path
        # pays; pager_stamp is the lock-free LRU clock (a plain
        # monotonic write per request); pager_gen invalidates in-
        # flight faults across deploy/undeploy; transitions themselves
        # happen under the pager's own condition, never here.
        self.pager_state = None
        self.pager_gen = 0
        self.pager_stamp = 0.0
        self.pager_recipe = None
        self.pager_counters = Counters(
            "fault_ok", "fault_timeout", "fault_error",
            "evict_idle", "evict_pressure")


class ModelRegistry:
    """Multi-model serving control plane (see module docstring).

    ``model_defaults`` are the ``InferenceModel`` constructor kwargs
    every deploy starts from (override per-deploy via ``**model_kwargs``);
    ``max_queue``/``max_concurrency``/``default_deadline_ms`` configure
    each model's admission controller.
    """

    def __init__(self, max_queue: int = 64, max_concurrency: int = 4,
                 default_deadline_ms: Optional[float] = None,
                 priority_classes: Optional[Dict[str, Any]] = None,
                 tracer=None, pager=None, **model_defaults: Any):
        self._max_queue = max_queue
        self._max_concurrency = max_concurrency
        self._default_deadline_ms = default_deadline_ms
        # per-tenant admission classes, applied to every model's
        # controller: {"name": (priority, weight)} or {"name":
        # {"priority": ..., "weight": ...}} — see AdmissionController
        self._priority_classes = priority_classes
        # optional observability.Tracer: when set, every predict_ex
        # carries a request span through admission and the data plane
        self.tracer = tracer
        # optional weight/executable pager (serving/pager.py): a
        # ModelPager, or its constructor kwargs as a dict (the form a
        # fleet worker's --registry-json reaches for) — e.g.
        # pager={"max_resident": 4, "idle_evict_s": 300}
        if pager is None or isinstance(pager, ModelPager):
            self._pager = pager
        else:
            self._pager = ModelPager(**dict(pager))
        if self._pager is not None:
            self._pager.start_reaper()
        self._model_defaults = {
            "supported_concurrent_num": 4, "max_batch_size": 32,
            "coalescing": True, "max_wait_ms": 2.0, **model_defaults}
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self._closed = False

    # ---- lookup ----
    def _entry(self, name: str) -> _Entry:
        e = self._entries.get(name)
        if e is None:
            raise ModelNotFound(f"no model deployed under {name!r}",
                                model=name,
                                deployed=sorted(self._entries))
        return e

    def _ensure_entry(self, name: str) -> _Entry:
        with self._lock:
            if self._closed:
                raise DeployError("registry is shut down", model=name)
            e = self._entries.get(name)
            if e is None:
                e = _Entry(name, AdmissionController(
                    max_queue=self._max_queue,
                    max_concurrency=self._max_concurrency,
                    default_deadline_ms=self._default_deadline_ms,
                    classes=self._priority_classes))
                self._entries[name] = e
            return e

    def models(self) -> Dict[str, Optional[int]]:
        """name -> active version (None while only a canary is staged).
        Single read per entry: a concurrent undeploy/shutdown nulls
        ``e.active`` at any moment, and a check-then-deref here would
        crash the listing."""
        return {n: (dep.version if (dep := e.active) is not None
                    else None)
                for n, e in list(self._entries.items())}

    def resident_models(self) -> List[str]:
        """Models a request would serve WITHOUT a pager fault right
        now: active, and either unpaged (always on device) or pager
        state ``resident``.  Lock-free snapshot reads, same discipline
        as :meth:`models` — this is the residency the fleet worker
        piggybacks onto every reply for the router's affinity
        scoring, so it must cost one dict walk, never a lock."""
        return sorted(
            n for n, e in list(self._entries.items())
            if e.active is not None
            and e.pager_state in (None, "resident"))

    # ---- deploy / swap ----
    def deploy(self, name: str, net=None, *, fn=None, params=None,
               model=None, version: Optional[int] = None,
               warmup_shapes=None, warmup_dtypes=None,
               quantize: Optional[bool] = None,
               canary_fraction: Optional[float] = None,
               pageable: bool = True,
               **model_kwargs: Any) -> int:
        """Deploy ``net`` (a KerasNet/ZooModel), ``fn``+``params``
        (a raw torch forward ``fn(params, x)``), or a prebuilt serving
        handle (``model``,
        anything with predict/warmup/close/serving_stats) as a new
        version of ``name``.  Returns the version number.

        Warmup runs TO COMPLETION before the swap; on any build/warmup
        failure the previous version keeps serving and
        :class:`DeployError` is raised (rollback).  With
        ``canary_fraction`` the new version is STAGED, not swapped:
        that fraction of requests routes to it until ``promote(name)``
        or ``clear_canary(name)``.
        """
        if canary_fraction is not None:
            canary_fraction = float(canary_fraction)
            # NaN fails this check too (accumulator poison otherwise)
            if not 0.0 <= canary_fraction <= 1.0:
                raise ValueError(
                    f"canary_fraction must be in [0, 1], got "
                    f"{canary_fraction}")
        entry = self._ensure_entry(name)
        # serialize whole deploys for this name: versions are allocated
        # inside the lock, so swap order always matches version order
        with entry.deploy_lock:
            if (canary_fraction is not None and self._pager is not None
                    and entry.pager_state is not None):
                # a canary stages WITHOUT swapping the active version,
                # so there is no safe moment to detach a cold active
                # from the pager (its handle may be paged out right
                # now) — pin the entry resident first, explicitly.
                # Checked INSIDE deploy_lock: attach/detach happen
                # under it, so a racing pageable deploy cannot slip
                # this guard.
                raise DeployError(
                    f"canary staging is not supported on the paged "
                    f"entry {name!r} — redeploy with pageable=False "
                    "(pinning it resident) before staging a canary",
                    model=name)
            with entry.lock:
                if version is None:
                    version = entry.next_version
                entry.next_version = max(entry.next_version, version + 1)
            # snapshot: promote() swaps entry.active under entry.lock
            # (not deploy_lock), so a re-read here could null between
            # the check and the deref
            _dep0 = entry.active
            active_v = _dep0.version if _dep0 is not None else None

            def fail(stage: str, e: BaseException):
                raise DeployError(
                    f"deploy of {name!r} v{version} failed during "
                    f"{stage} — rolled back (v{active_v} still serving)",
                    model=name, version=version, active_version=active_v,
                    stage=stage,
                    cause=f"{type(e).__name__}: {e}") from e

            # 1. build + load a fresh handle; the live one is never
            # touched
            prebuilt = model is not None
            eff_kwargs = {**self._model_defaults, **model_kwargs}
            if model is None:
                from ..pipeline.inference import InferenceModel
                im = InferenceModel(**eff_kwargs)
                try:
                    if net is not None:
                        im.load_keras_net(net, quantize=quantize)
                    elif fn is not None:
                        im.load_fn(fn, params)
                    else:
                        raise ValueError(
                            "deploy needs net=, fn=+params=, or model=")
                except BaseException as e:
                    im.close()
                    fail("load", e)
                model = im

            # 2. warmup to completion BEFORE the swap (deploy pays the
            # compiles, live traffic never does).  A duck-typed handle
            # without the bucketed fast path's `_cache` attr is asked
            # via its own warmup(); an InferenceModel whose cache is
            # off (bucketing=False / quantized) has no ladder to warm.
            shapes = (warmup_shapes if warmup_shapes is not None
                      else entry.warmup_shapes)
            dtypes = (warmup_dtypes if warmup_dtypes is not None
                      else entry.warmup_dtypes)
            warmable = (callable(getattr(model, "warmup", None))
                        and getattr(model, "_cache", True) is not None)
            if shapes is not None and warmable:
                try:
                    model.warmup(shapes, dtypes)
                except BaseException as e:
                    model.close()
                    fail("warmup", e)

            dep = _Deployment(version, model)

            # the pager's rebuild recipe is captured BEFORE the swap
            # (host copies of the weights while the fresh handle is
            # known-consistent); None when this deploy is not pageable
            recipe = None
            if (self._pager is not None and canary_fraction is None
                    and pageable and not prebuilt):
                recipe = self._build_recipe(
                    version, model, eff_kwargs, shapes, dtypes)

            # 3. atomic pointer swap (or canary staging) + 4. drain old
            old = None
            stale = False
            with entry.lock:
                with self._lock:
                    # the registry may have shut down (or this name
                    # been undeployed) while we were building/warming —
                    # swapping into a popped entry would leak a live
                    # model nobody can ever close
                    stale = (self._closed
                             or self._entries.get(name) is not entry)
                if not stale:
                    if shapes is not None:
                        entry.warmup_shapes = shapes
                        entry.warmup_dtypes = dtypes
                    if canary_fraction is not None:
                        old = entry.canary
                        dep.state = "canary"
                        entry.canary = dep
                        entry.canary_fraction = float(canary_fraction)
                        # route_lock owns the accumulator:
                        # resetting it under entry.lock alone
                        # races _route's += and loses the reset
                        with entry.route_lock:
                            entry._canary_acc = 0.0
                    else:
                        old = entry.active
                        dep.state = "active"
                        entry.active = dep  # THE swap: one assignment
                        self._scale_admission(entry, dep)
                        if old is not None:
                            entry.swap_count += 1
            if stale:
                model.close()
                raise DeployError(
                    f"{name!r} was undeployed (or the registry shut "
                    f"down) while v{version} was building — the new "
                    "version was discarded", model=name, version=version)
            if self._pager is not None and canary_fraction is None:
                if recipe is not None:
                    # the just-swapped version IS resident (freshly
                    # built); the generation bump inside invalidates
                    # any in-flight fault of the previous version
                    self._pager.note_swapped(name, entry, recipe)
                elif entry.pager_state is not None:
                    # the new version is not pageable: pin the entry
                    # resident from here on (safe — the swap installed
                    # a live handle)
                    self._pager.detach(name, entry)
            self._retire(entry, old)
        return version

    def _build_recipe(self, version: int, model,
                      eff_kwargs: Dict[str, Any], shapes, dtypes
                      ) -> Optional[PageRecipe]:
        """The host-side rebuild recipe for a just-built deployment —
        what a cold entry keeps instead of device memory — or None
        when the deploy cannot be paged (prebuilt/duck-typed handle,
        quantized, or decode-capable: a decode engine's slot-array
        state is live stream context, not pageable weights).

        The recipe holds host copies of the weights (``.detach().cpu()``
        into numpy, so a cold model holds no memory on the card) and the
        forward: the deployed function, or for a net a skeleton of it on
        the ``meta`` device run through ``functional_call``.  Its
        ``build()`` is the fault-in: ONE upload of the host weights
        (``InferenceModel.load_fn``) and a warm-up of the bucket
        ladder."""
        from ..pipeline.inference import InferenceModel
        from ..pipeline.inference.inference_model import (
            meta_skeleton, module_forward, module_tensors)
        from ..pipeline.inference.serving import tree_leaves, tree_map
        if not isinstance(model, InferenceModel):
            return None
        if (getattr(model, "_quantize_flag", False)
                or model._decode_engine is not None):
            return None

        def host_tree(tree):
            # an explicit copy at deploy time; bf16 has no numpy type
            # and stays a CPU tensor
            def one(t):
                t = t.detach().to("cpu", copy=True)
                return t if t.dtype == torch.bfloat16 else t.numpy()
            return tree_map(one, tree)

        if model._fn is not None:
            forward = model._fn
            host_params = host_tree(model._params)
        elif model._net is not None:
            forward = module_forward(meta_skeleton(model._net))
            host_params = host_tree(module_tensors(model._net))
        else:
            return None
        host_bytes = sum(int(a.nbytes) for a in tree_leaves(host_params))
        warm = shapes is not None and model._cache is not None
        kwargs = {**eff_kwargs, "device": model._fastpath[3]}

        def _page_rebuild(span=None):
            im = InferenceModel(**kwargs)
            try:
                if span is not None:
                    span.phase_start("weights_h2d")
                im.load_fn(forward, host_params)
                if warm:
                    if span is not None:
                        span.phase_start("exec_rehydrate")
                    im.warmup(shapes, dtypes)
            except BaseException:
                im.close()
                raise
            finally:
                if span is not None:
                    span.phase_end()
            return im

        return PageRecipe(_page_rebuild, host_bytes=host_bytes,
                          version=version)

    def _scale_admission(self, entry: _Entry, dep: _Deployment):
        """Admission concurrency follows the ACTIVE version's replica
        count: N device replicas carry N times the concurrent work, so
        the per-model bound is base * replicas (reset to base when an
        un-replicated version activates).  Only activation re-scales —
        a staged canary must not re-bound the traffic the active
        version is still serving."""
        reps = getattr(dep.model, "n_replicas", 1) or 1
        entry.admission.set_max_concurrency(self._max_concurrency * reps)
        # the service-time EWMA describes the version that just
        # RETIRED: carrying a slow old model's estimate forward would
        # predictively shed deadline requests the fast new version
        # could meet (and vice versa hides real slowness behind a
        # stale fast estimate) — every activation starts clean
        entry.admission.reset_service_ewma()

    def promote(self, name: str) -> int:
        """Make the staged canary the active version (atomic swap,
        then drain the displaced one).  Returns the promoted version."""
        entry = self._entry(name)
        with entry.lock:
            dep = entry.canary
            if dep is None:
                raise ModelNotFound(f"no canary staged for {name!r}",
                                    model=name)
            old = entry.active
            dep.state = "active"
            entry.active = dep
            entry.canary = None
            entry.canary_fraction = 0.0
            self._scale_admission(entry, dep)
            if old is not None:
                entry.swap_count += 1
        self._retire(entry, old)
        return dep.version

    def clear_canary(self, name: str):
        """Discard the staged canary (the experiment failed)."""
        entry = self._entry(name)
        with entry.lock:
            dep = entry.canary
            entry.canary = None
            entry.canary_fraction = 0.0
        self._retire(entry, dep)

    def _retire(self, entry: _Entry, dep: Optional[_Deployment]):
        """Close a displaced deployment OUTSIDE the entry lock: close()
        drains its coalescer (queued requests complete on the old
        executables), which can take up to the drain timeout."""
        if dep is None:
            return
        # snapshot: the pager may null dep.model concurrently (a
        # paged-out deployment has no handle to close)
        retiring = dep.model
        if retiring is not None:
            retiring.close()
        with entry.lock:
            # state flips under entry.lock like every other state write;
            # until the drain above finishes the deployment truthfully
            # still reads as serving
            dep.state = "retired"
            entry.retired.append(dep)
            del entry.retired[:-_RETIRED_KEPT]

    # ---- serving ----
    def predict(self, name: str, inputs, deadline_ms: Optional[float] = None,
                priority_class: Optional[str] = None):
        out, _ = self.predict_ex(name, inputs, deadline_ms=deadline_ms,
                                 priority_class=priority_class)
        return out

    def predict_ex(self, name: str, inputs,
                   deadline_ms: Optional[float] = None,
                   trace_id: Optional[str] = None,
                   priority_class: Optional[str] = None
                   ) -> Tuple[Any, Dict[str, Any]]:
        """predict + routing info ``{"model", "version", "canary"}`` —
        the web frontend tags responses with the serving version so
        clients (and the hot-swap tests) can see which side of a swap
        produced them.  Raises ModelNotFound / Overloaded /
        DeadlineExceeded (structured, immediate).

        With a tracer installed the request carries a span (id
        ``trace_id`` when given — the frontend passes X-Request-Id)
        through admission and the data plane; the span is activated for
        this thread and handed across the coalescer explicitly, and
        ``info`` gains ``request_id``.  Shed/failed requests finish
        their span too, labeled with the error type.

        ``priority_class`` tags the request for the admission
        controller's shedding order and weighted fair share (the
        registry's ``priority_classes`` config names the classes)."""
        return self._serve_ex(
            name, "predict", lambda model: model.predict(inputs),
            deadline_ms=deadline_ms, trace_id=trace_id,
            priority_class=priority_class)

    def _serve_ex(self, name: str, op: str, call,
                  deadline_ms: Optional[float] = None,
                  trace_id: Optional[str] = None,
                  priority_class: Optional[str] = None
                  ) -> Tuple[Any, Dict[str, Any]]:
        """The shared serve envelope — span + admission + canary
        routing + per-version counters/latency around ONE data-plane
        ``call(model)`` — used by both :meth:`predict_ex` and
        :meth:`generate_ex` so the two paths can never drift in
        admission or span semantics."""
        entry = self._entry(name)
        tracer = self.tracer
        span = (tracer.start_span(op, trace_id=trace_id, model=name)
                if tracer is not None else None)
        # the pager deadline shares the admission clock: a faulting
        # request queues under ITS deadline (admission wait included),
        # never a separate cold-start budget.  Computed only when a
        # pager exists — the unpaged request path stays untouched.
        pager_deadline = None
        if self._pager is not None:
            eff_deadline_ms = (deadline_ms if deadline_ms is not None
                               else entry.admission.default_deadline_ms)
            if eff_deadline_ms is not None:
                pager_deadline = (time.perf_counter()
                                  + eff_deadline_ms / 1e3)
        try:
            with _trace.activate(span), \
                    entry.admission.admit(deadline_ms=deadline_ms,
                                          span=span,
                                          priority_class=priority_class
                                          ) as grant:
                dep, is_canary = self._route(entry)
                if self._pager is not None \
                        and entry.pager_state is not None:
                    dep = self._pager_serve(entry, dep, pager_deadline,
                                            span, grant)
                if span is not None:
                    span.set_label("version", dep.version)
                    if is_canary:
                        span.set_label("canary", True)
                t0 = time.perf_counter()
                try:
                    out = call(dep.model)
                except BaseException:
                    dep.counters.inc("errors")
                    raise
                dep.latency.add(time.perf_counter() - t0)
                dep.counters.inc("requests")
        except BaseException as e:
            if span is not None:
                span.set_label("error", type(e).__name__)
            raise
        finally:
            if span is not None:
                span.finish()
        info = {"model": name, "version": dep.version,
                "canary": is_canary}
        if span is not None:
            info["request_id"] = span.trace_id
        return out, info

    def _pager_serve(self, entry: _Entry, dep: _Deployment,
                     deadline: Optional[float], span, grant
                     ) -> _Deployment:
        """Residency checkout for one admitted request.  The RESIDENT
        fast path is one state read, a lock-free LRU stamp, and the
        in-flight counter the evictor's quiesce reads — it NEVER
        touches the pager lock (the density bench pins this).  Any
        other state diverts to the shared fault-in, whose wait/build
        seconds are excluded from the admission service EWMA so a
        cold start cannot poison predictive shedding."""
        pager = self._pager
        for _ in range(32):
            entry.pager_stamp = time.monotonic()
            dep.counters.inc("started")
            if entry.pager_state == "resident":
                return dep
            # not usable: balance the in-flight accounting and fault.
            # The EWMA exclusion lives in a finally: the raise paths
            # (waiter deadline lapse, late fault, ColdStartTimeout)
            # spend the SAME wall time, and admission's error-path
            # release folds service time into the EWMA too — a timed-
            # out fault must not predictively shed the traffic behind
            # it any more than a served one
            dep.counters.inc("aborted")
            t_fault = time.perf_counter()
            try:
                pager.fault_in(entry, deadline=deadline, span=span)
            finally:
                if grant is not None:
                    grant.exclude_service_s(
                        time.perf_counter() - t_fault)
            dep, _ = self._route(entry)
            if entry.pager_state is None:
                # detached mid-flight (undeploy or a redeploy that
                # pinned the entry): serve unpaged if a live handle
                # exists, else the model is gone
                if dep.model is None:
                    raise ModelNotFound(
                        f"model {entry.name!r} was undeployed while "
                        "cold", model=entry.name)
                return dep
        # the thrash 503 is an SLO miss like any other: it must move
        # the timeout counter the alerting docs point at
        entry.pager_counters.inc("fault_timeout")
        raise ColdStartTimeout(
            f"model {entry.name!r} kept being evicted before this "
            "request could run — the resident budget is too small for "
            "the concurrent working set", model=entry.name,
            thrash=True)

    def generate(self, name: str, prompt_ids, max_new_tokens,
                 deadline_ms: Optional[float] = None,
                 priority_class: Optional[str] = None,
                 eos_id: Optional[int] = None,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed=0):
        out, _ = self.generate_ex(name, prompt_ids, max_new_tokens,
                                  deadline_ms=deadline_ms,
                                  priority_class=priority_class,
                                  eos_id=eos_id,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, seed=seed)
        return out

    def generate_ex(self, name: str, prompt_ids, max_new_tokens,
                    deadline_ms: Optional[float] = None,
                    trace_id: Optional[str] = None,
                    priority_class: Optional[str] = None,
                    eos_id: Optional[int] = None,
                    temperature: float = 0.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None, seed=0
                    ) -> Tuple[Any, Dict[str, Any]]:
        """The continuous-batching generate path: same admission /
        routing / counters / span discipline as :meth:`predict_ex`,
        but the data plane is the model's ``DecodeEngine`` — the
        request joins the live slot array at the next decode step and
        streams until EOS or ``max_new_tokens``.  Returns (list of
        per-row continuation arrays, routing info).
        ``temperature``/``top_k``/``top_p``/``seed`` select per-slot
        sampling (greedy by default); a fixed (prompt, sampling,
        seed) tuple replays the same tokens on ANY deployment of the
        same weights — in this process or a fleet worker's.  The
        admission slot is held for the whole decode: a decoding
        request IS in-flight work, and releasing early would let
        max_concurrency overcommit the engine's queue.  Requires the
        deployment to have been built with ``decode_capacity``
        (raises RuntimeError otherwise)."""
        return self._serve_ex(
            name, "generate",
            lambda model: model.generate(prompt_ids, max_new_tokens,
                                         eos_id=eos_id,
                                         temperature=temperature,
                                         top_k=top_k, top_p=top_p,
                                         seed=seed),
            deadline_ms=deadline_ms, trace_id=trace_id,
            priority_class=priority_class)

    def _route(self, entry: _Entry) -> Tuple[_Deployment, bool]:
        """Pick the serving version.  Canary routing uses an error
        accumulator, not randomness: over any run of N requests the
        canary receives floor/ceil(N * fraction) of them exactly."""
        canary = entry.canary
        if canary is not None and entry.canary_fraction > 0.0:
            with entry.route_lock:
                # re-read under the lock: promote()/clear may have won
                if entry.canary is canary:
                    entry._canary_acc += entry.canary_fraction
                    if entry._canary_acc >= 1.0:
                        entry._canary_acc -= 1.0
                        return canary, True
        active = entry.active
        if active is None:
            raise ModelNotFound(
                f"model {entry.name!r} has no active version "
                "(canary-only — promote it first)", model=entry.name)
        return active, False

    # ---- lifecycle ----
    def undeploy(self, name: str, drain_timeout: float = 10.0) -> bool:
        """Remove ``name``: stop admitting, let admitted requests
        finish (graceful drain), then close every version.  Returns
        True when the drain completed within ``drain_timeout``.

        Observability is retired WITH the model: the pager forgets the
        entry (waking any queued faulters, whose in-flight rebuild is
        generation-invalidated and discarded), and the tracer's span
        ring drops this model's spans — a paged fleet cycling many
        models must not accumulate dead models' series or spans."""
        with self._lock:
            entry = self._entries.pop(name, None)
        if entry is None:
            raise ModelNotFound(f"no model deployed under {name!r}",
                                model=name)
        drained = entry.admission.drain(timeout=drain_timeout)
        # deploy_lock: an in-flight deploy either sees the popped entry
        # and discards its new model, or swaps before we get here — in
        # which case entry.active below IS that new model and we close
        # it.  Either way nothing leaks.
        with entry.deploy_lock:
            with entry.lock:
                deps = [d for d in (entry.active, entry.canary)
                        if d is not None]
                entry.active = entry.canary = None
                for d in deps:
                    d.state = "retired"
            if self._pager is not None:
                self._pager.detach(name, entry)
        for d in deps:
            m = d.model  # snapshot: paged-out deployments hold None
            if m is not None:
                m.close()
        tracer = self.tracer
        if tracer is not None and hasattr(tracer, "retire"):
            tracer.retire(model=name)
        return drained

    def shutdown(self, drain_timeout: float = 10.0):
        """Drain and close every model (idempotent)."""
        with self._lock:
            self._closed = True
            names = list(self._entries)
        for n in names:
            try:
                self.undeploy(n, drain_timeout=drain_timeout)
            except ModelNotFound:
                pass
        if self._pager is not None:
            self._pager.close()

    @property
    def pager(self) -> Optional[ModelPager]:
        """The registry's weight pager (None when paging is off)."""
        return self._pager

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # ---- observability ----
    def metrics(self, name: Optional[str] = None) -> Dict[str, Any]:
        """Point-in-time snapshot of the whole control plane (or one
        model): per-version request counts / error counts / latency
        percentiles, admission + shed counters, swap count, canary
        state, and the active version's data-plane ``serving_stats``
        (bucket hit/miss/compile counters, coalescer dispatch stats)."""
        entries = ({name: self._entry(name)} if name is not None
                   else dict(self._entries))
        out: Dict[str, Any] = {}
        for n, e in entries.items():
            with e.lock:
                active, canary = e.active, e.canary
                versions = {d.version: d.stats() for d in
                            (*e.retired, canary, active) if d is not None}
                canary_info = (None if canary is None else
                               {"version": canary.version,
                                "fraction": e.canary_fraction})
                swaps = e.swap_count
            # a paged-out deployment has no handle: snapshot the model
            # reference once (the pager may demote concurrently)
            m_active = active.model if active is not None else None
            serving = (m_active.serving_stats()
                       if m_active is not None
                       and hasattr(m_active, "serving_stats") else {})
            out[n] = {
                "active_version": active.version if active else None,
                "canary": canary_info,
                # flat copy of the routed fraction (0.0 when no canary)
                # so dashboards need not null-check the canary object
                "canary_fraction": (canary_info["fraction"]
                                    if canary_info else 0.0),
                "swap_count": swaps,
                "admission": e.admission.snapshot(),
                "versions": versions,
                "serving": serving,
            }
            pager_state = e.pager_state
            if self._pager is not None and pager_state is not None:
                # lock-free reads by design: a scrape must never
                # contend with (or count as) pager activity
                out[n]["pager"] = {
                    "state": pager_state,
                    "resident": pager_state == "resident",
                    "idle_s": round(
                        time.monotonic() - e.pager_stamp, 3),
                    **e.pager_counters.snapshot()}
        return out
