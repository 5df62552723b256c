"""InferenceModel: the thread-safe serving handle.

Counterpart of ``analytics_zoo_tpu/pipeline/inference/inference_model.py``
(reference AbstractInferenceModel, FloatInferenceModel, JTensor).  One
model serves every thread: an inference forward mutates nothing, so
``supported_concurrent_num`` is a semaphore that bounds concurrent
device work.  ``predict`` runs through the bucketed forward
(``serving.BucketedExecutableCache``), optionally coalesced across
callers (``serving.RequestCoalescer``); ``generate`` and
``generate_stream`` run through the continuous-batching
``decode.DecodeEngine`` when the handle was built with
``decode_capacity`` and holds a language model.

The handle serves on the device of the model it is given;
:meth:`load` reads a saved model onto ``device`` (``"cuda"`` unless
asked otherwise).  A quantized handle (``quantize=True``, or a model
named '<arch>-quantize') serves the model's int8 twin
(:meth:`KerasNet.quantize`) on the exact-shape path, as the JAX package
does.  :meth:`load_fn` serves a torch callable ``fn(params, x)`` over a
tree of tensors (the counterpart of the JAX package's ``load_jax``).

``replicas`` serves the bucketed path from several replicas
(``serving.ReplicaSet``): on the card ``"all"`` means every card of the
process and an int is clamped to that count; on the CPU a replica is a
copy on the CPU (``"all"`` means one per core), which is how replica
failover, re-probes, elasticity and hedging run without a card.  A list
of devices places the replicas on exactly those devices, repeats
allowed (``["cuda:0", "cuda:0"]``: two replicas on one card, each on
its own stream).  A module's replicas are its parameters and buffers
copied per device, run through the module as a skeleton with
``torch.func.functional_call``.

``mesh`` serves the bucketed path from replica GROUPS
(``serving.shardgroup.ShardGroupSet``): the devices are carved into
groups of the spec's size, each group's weights sharded across its
members and gathered on use on its first device.  The blocks are cut
from host tensors and the handle keeps only a ``meta`` skeleton of the
net, so no card holds the whole model: :meth:`load` reads a saved
model onto the host, and an in-memory net may be on the host or a
card.  A function given to :meth:`load_fn` is gathered a layer at a
time when it carries its module as ``fn.module`` (as
:func:`module_forward` makes it), else its whole tree is gathered for
each dispatch, which the group warns about.  The devices are the
``replicas`` list when one is given (a card may repeat:
``["cuda:0", "cuda:0"]`` runs a group of two on one card), else every
device of the model's platform; an int ``replicas`` is ignored under a
mesh, as the JAX package ignores it.  With ``decode_capacity`` the
decode engine splits its slots over the first group's devices
(``DecodeEngine(mesh=...)``).  ``store_tag`` names this handle in the
persistent store (``common/execstore.py``): a kernel library built while
it loads or warms up is written with that tag as its ``model``.  The
TF/graph import paths are not ported (see ROADMAP.md).

Tracing: ``predict``, ``generate`` and ``generate_stream`` read the
caller's current span once (``observability.trace.current_span``; one
flag check while nothing traces) and hand it on: the exact path marks
``device_put -> execute``, the bucketed path ``pad -> device_put ->
execute -> depad`` (after ``coalesce_wait`` through the coalescer), and
the decode engine's thread ``decode_wait -> prefill -> decode_step``.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ...common import execstore
from ...common.context import resolve_device
from ...observability import profile as _profile
from ...observability import trace as _trace
from .decode import DecodeEngine
from .serving import (BucketedExecutableCache, CoalescerClosedError,
                      ReplicaSet, RequestCoalescer, _norm_device, _rows,
                      available_devices, fetch_rows, module_twin,
                      place_tree, to_device)


class JTensor:
    """Plain data+shape carrier (reference JTensor.java), accepted and
    returned for POJO-style callers; numpy works everywhere too."""

    def __init__(self, data, shape=None):
        arr = np.asarray(data, dtype=np.float32)
        self.data = arr.ravel()
        self.shape = tuple(shape) if shape is not None else arr.shape

    def to_ndarray(self) -> np.ndarray:
        return self.data.reshape(self.shape)

    @classmethod
    def from_ndarray(cls, arr) -> "JTensor":
        return cls(arr)


def _to_ndarray(x):
    if isinstance(x, JTensor):
        return x.to_ndarray()
    a = np.asarray(x)
    # integer ids stay integer; float64 narrows to f32
    if np.issubdtype(a.dtype, np.integer):
        return a
    return a.astype(np.float32, copy=False)


def _canonical(a: np.ndarray) -> np.ndarray:
    """float64 arrays narrow to f32, as the JAX package's device_put
    does without x64; everything else as it is."""
    return a.astype(np.float32) if a.dtype == np.float64 else a


def module_forward(net):
    """``fn(params, x)`` running ``net`` as a skeleton over ``params`` (a
    dict of every parameter and buffer by name) through
    ``torch.func.functional_call``.  The call swaps the module's tensors
    for the duration of the forward, so calls are serialised by a lock
    (on a card only the launches are: the replicas' streams still
    overlap)."""
    lock = threading.Lock()

    def fn(params, x):
        with lock:
            return torch.func.functional_call(
                net, params, (list(x) if isinstance(x, tuple) else x,))

    # a sharded group runs the net's layers itself, gathering each
    # layer's weights on use (serving/shardgroup.py)
    fn.module = net
    return fn


def meta_skeleton(net):
    """A copy of ``net`` whose parameters and buffers live on the
    ``meta`` device (shapes and dtypes, no storage), for
    :func:`module_forward` over weights held elsewhere.  Made without
    touching the device (``serving.module_twin``)."""
    return module_twin(net, lambda t: torch.empty_like(t, device="meta"))


def module_tensors(net) -> dict:
    """Every parameter and buffer of ``net`` by name (detached)."""
    out = {k: v.detach() for k, v in net.named_parameters()}
    out.update({k: v.detach() for k, v in net.named_buffers()})
    return out


class InferenceModel:
    """load / predict / generate with bounded concurrency (reference
    AbstractInferenceModel API)."""

    def __init__(self, supported_concurrent_num: int = 1,
                 max_batch_size: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 bucket_growth: float = 2.0,
                 bucketing: bool = True,
                 coalescing: bool = False,
                 max_wait_ms: float = 2.0,
                 replicas=1,
                 hedging: bool = False,
                 hedge_quantile: float = 0.99,
                 hedge_min_ms: float = 0.5,
                 decode_capacity: Optional[int] = None,
                 decode_max_len: Optional[int] = None,
                 decode_prompt_buckets: Optional[Sequence[int]] = None,
                 decode_eos_id: Optional[int] = None,
                 decode_prefix_pool: int = 0,
                 decode_draft=None,
                 decode_spec_tokens: int = 4,
                 mesh: Optional[dict] = None,
                 store_tag: Optional[str] = None,
                 device=None):
        """``supported_concurrent_num`` bounds concurrent device work.

        * ``bucketing``: pad each batch up to a geometric ladder of batch
          sizes (1, 2, ... ``max_batch_size`` by ``bucket_growth``, or an
          explicit ``buckets`` list), so a ragged stream runs a handful of
          shapes.
        * ``coalescing``: concurrent ``predict()`` callers are packed by
          a dispatcher thread into one padded batch per dispatch, waiting
          at most ``max_wait_ms`` to fill ``max_batch_size`` rows; rows
          come back equal to a solo run at the same bucket.
        * ``decode_capacity``: attach a continuous-batching
          :class:`~.decode.DecodeEngine` with that many slots when a
          language model is loaded (``decode_max_len``,
          ``decode_prompt_buckets``, ``decode_eos_id``,
          ``decode_prefix_pool``, and ``decode_draft`` with
          ``decode_spec_tokens`` configure it); it is warmed at load.
        * ``replicas``: ``"all"``, an int N, or a list of devices: serve
          the bucketed path from that many replicas (module docstring),
          each bucket built once and placed on every replica; 1 (the
          default) keeps the single-device path.  Quantized handles stay
          single-device.  ``supported_concurrent_num`` is then PER
          replica.
        * ``hedging`` (coalesced, several replicas): a group in flight
          longer than the ``hedge_quantile`` of observed group latencies
          (floored at ``hedge_min_ms``) is re-dispatched to a second
          healthy replica and the first result wins.
        * ``mesh``: a sharded-serving spec dict (see
          :func:`analytics_zoo_tpu_torch.serving.shardgroup.normalize_mesh_spec`):
          replicas become replica GROUPS over the ``replicas`` device
          list (else every device of the platform), each group's weights
          sharded by the spec's rule table; the decode engine, when
          configured, splits its slots over the first group.  A bad spec
          fails here.
        * ``store_tag``: the ``model`` tag of the persistent store's
          entries this handle's builds write (``stat --by-model``).
        * ``device``: where :meth:`load` and :meth:`load_fn` put the
          model (``"cuda"`` unless asked otherwise); an in-memory model
          serves on its own device."""
        # per-model accounting tag for the persistent store: metadata on
        # the entries this handle's builds write, never part of a key
        self.store_tag = store_tag
        # normalized once here, so a malformed spec fails the
        # constructor (deploy time), not the first install
        if mesh is not None:
            from ...serving.shardgroup import normalize_mesh_spec
            mesh = normalize_mesh_spec(mesh)
        self._mesh = mesh
        self.concurrent_num = int(supported_concurrent_num)
        self._semaphore = threading.Semaphore(self.concurrent_num)
        self._sem_capacity = self.concurrent_num
        self._replicas_req = replicas
        self._hedging = bool(hedging)
        self._hedge_quantile = float(hedge_quantile)
        self._hedge_min_ms = float(hedge_min_ms)
        self._device = device
        self.max_batch_size = int(max_batch_size)
        self._buckets = buckets
        self._bucket_growth = float(bucket_growth)
        self._bucketing = bool(bucketing)
        self._coalescing = bool(coalescing)
        self.max_wait_ms = float(max_wait_ms)
        self._decode_capacity = (None if decode_capacity is None
                                 else int(decode_capacity))
        self._decode_max_len = decode_max_len
        self._decode_prompt_buckets = decode_prompt_buckets
        self._decode_eos_id = decode_eos_id
        self._decode_prefix_pool = int(decode_prefix_pool)
        self._decode_draft = decode_draft
        self._decode_spec_tokens = int(decode_spec_tokens)
        self._decode_engine: Optional[DecodeEngine] = None
        self._cache: Optional[BucketedExecutableCache] = None
        self._coalescer: Optional[RequestCoalescer] = None
        # (predict_fn, cache, coalescer, device) published as one tuple:
        # a predict() racing reload() takes one consistent path
        self._fastpath = None
        self._quantize_flag: Optional[bool] = None
        # what the handle serves, for the registry's page recipe: a net
        # (load_keras_net) or a function and its placed params (load_fn)
        self._net = None
        self._fn = None
        self._params = None

    # ---- loading ----
    def load(self, model_path: str, weight_path: Optional[str] = None,
             quantize: Optional[bool] = None):
        """Load a model saved with ``save_model`` (the port's flat
        format) onto this handle's device and serve it, with its layer
        state.  ``weight_path`` is a checkpoint directory (a saved model's
        ``weights``) whose final weights and state replace the saved
        ones.  ``quantize`` as :meth:`load_keras_net` takes it.  Under a
        mesh the model is read onto the host and only the groups' blocks
        reach the devices."""
        from ... import models  # noqa: F401  (registers the zoo's models)
        from ..api.keras.engine import KerasNet

        def read(device):
            net = KerasNet.load_model(model_path, device=device)
            if weight_path is not None:
                from ...models.jax_params import model_tree
                from ...train import checkpoint as checkpoint_lib
                checkpoint_lib.restore_into(weight_path, model_tree(net),
                                            "final")
            return net

        device = resolve_device(self._device)
        if self._mesh is not None and self._bucketing:
            net = read(torch.device("cpu"))
            quantize = self._quantizes(net, quantize)
            if not quantize:
                return self._serve_net(net, False, device)
            # a quantized handle serves single-device, where it runs
            return self._serve_net(read(device), True, device)
        return self.load_keras_net(read(device), quantize=quantize)

    def load_keras_net(self, net, quantize: Optional[bool] = None):
        """Serve an in-memory KerasNet or zoo model on its device, or
        under a mesh on the groups' devices (the net may then be on the
        host).  ``quantize=True`` serves its int8 twin; None keeps the
        handle's last choice (so ``reload`` stays int8), and on a first
        load follows a '-quantize' model name."""
        quantize = self._quantizes(net, quantize)
        if self._sharded(quantize):
            return self._serve_net(
                net, False, net.device if self._device is None
                else resolve_device(self._device))
        if self._device is not None and _norm_device(
                self._device) != _norm_device(net.device):
            raise ValueError(f"the model is on {net.device}, the handle's "
                             f"device is {self._device}")
        return self._serve_net(net, quantize, net.device)

    def _quantizes(self, net, quantize: Optional[bool]) -> bool:
        """``quantize`` resolved: the handle's last choice when None, and
        on a first load a '-quantize' model name."""
        if quantize is None:
            quantize = self._quantize_flag
        if quantize is None:
            name = getattr(net, "hyper", {}).get("model_name", "")
            quantize = isinstance(name, str) and name.endswith("-quantize")
        return bool(quantize)

    def _sharded(self, quantize: bool) -> bool:
        """Whether a load serves from replica groups (a mesh on the
        bucketed path; a quantized handle stays single-device)."""
        return self._mesh is not None and self._bucketing and not quantize

    def _serve_net(self, net, quantize: bool, device):
        """Serve ``net`` (its int8 twin when ``quantize``) on ``device``:
        the net's own device, or under a mesh the platform the groups
        are carved from.  Sharded, the groups cut their blocks from the
        net's tensors and the handle keeps a ``meta`` skeleton, so
        nothing here holds the whole model once this returns."""
        if quantize and self._decode_capacity is not None:
            raise ValueError("decode_capacity is not supported for "
                             "quantized handles")
        if quantize:
            net = net.quantize()
        net.eval()
        # build and warm the decode engine before publishing anything: a
        # reload whose engine build fails leaves the handle on the old
        # version, both planes
        with execstore.tag_builds(self.store_tag):
            engine = self._build_decode_engine(net, device)
        self._quantize_flag = quantize
        if self._sharded(quantize):
            # the set serves every dispatch, so no predict closure holds
            # the net
            skeleton = meta_skeleton(net)
            self._net, self._fn, self._params = skeleton, None, None
            self._install(None, device, replica_fn=module_forward(skeleton),
                          replica_params=module_tensors(net))
        else:
            def predict_fn(x):
                return net(list(x) if isinstance(x, tuple) else x)

            self._net, self._fn, self._params = net, None, None
            self._install(predict_fn, device, replica_fn=module_forward(net),
                          replica_params=module_tensors(net))
        if self._decode_capacity is not None:
            old, self._decode_engine = self._decode_engine, engine
            if old is not None:
                # after the swap: the old engine's streams drain on it
                old.close()
        return self

    def _build_decode_engine(self, net, device):
        """The warmed decode engine when ``decode_capacity`` is set and
        ``net`` is a generation-capable LM; publishes nothing.  Under a
        mesh its members are carved from ``device``'s platform."""
        if self._decode_capacity is None:
            return None
        hyper = getattr(net, "hyper", None)
        if (not callable(getattr(net, "generate", None))
                or not isinstance(hyper, dict)
                or "n_layers" not in hyper):
            raise ValueError(
                "decode_capacity needs a generation-capable language "
                f"model (TransformerLM-like), got {type(net).__name__}")
        draft = self._decode_draft
        if isinstance(draft, tuple):  # the reference's (params, hyper)
            draft = draft[0]
        engine = DecodeEngine(
            net, capacity=self._decode_capacity,
            max_len=self._decode_max_len,
            prompt_buckets=self._decode_prompt_buckets,
            eos_id=self._decode_eos_id,
            prefix_pool=self._decode_prefix_pool, draft=draft,
            spec_tokens=self._decode_spec_tokens, mesh=self._mesh,
            devices=(self._replica_devices(device)
                     if self._mesh is not None else None),
            store_tag=self.store_tag)
        engine.warmup()
        return engine

    def load_tf(self, path: Optional[str] = None, net=None,
                input_names=None, output_names=None):
        """Serve a frozen TF graph or an imported keras model (reference
        ``loadTF``): ``path`` loads an export folder or a ``.pb`` as a
        :class:`~analytics_zoo_tpu_torch.pipeline.api.tfgraph.TFNet`
        (the port's codec: no tensorflow), or pass one as ``net`` (from
        ``Net.load_keras`` / ``Net.from_tf_keras``).  The graph runs on
        the handle's device; its random nodes, if any, draw from a
        generator seeded 0 each call (the JAX package pins its key)."""
        from ..api.tfgraph.net import TFNet
        device = resolve_device(self._device)
        if net is None:
            if path is None:
                raise ValueError("load_tf: pass path= (export folder / "
                                 ".pb) or net= (an existing TFNet)")
            net = TFNet(path=path, input_names=input_names,
                        output_names=output_names, device=device)
        params = {k: v.detach() for k, v in net.params().items()}
        graph = net.fn

        def run(p, x):
            xs = x if isinstance(x, (tuple, list)) else (x,)
            dev = xs[0].device if isinstance(xs[0], torch.Tensor) else device
            gen = torch.Generator(dev).manual_seed(0)
            with torch.no_grad():
                out = graph(p, *xs, rng=gen, device=dev)
            return out[0] if len(out) == 1 else out

        return self.load_fn(run, params)

    def load_graph(self, graph, params, state=None):
        """Serve a prebuilt graph (a port model or ``GraphModule``) with
        an explicit weight tree: ``params`` and ``state`` keyed by layer
        as the JAX package's trees (host numpy, say, as the weight
        pager keeps a cold deployment).  They are copied into the graph,
        placed on the handle's device once, and the graph serves there
        as :meth:`load_keras_net` serves a net."""
        from ...models.jax_params import from_jax_params
        device = resolve_device(self._device)
        graph = graph.to(device)
        from_jax_params(graph, params, state)
        self._quantize_flag = False
        return self._serve_net(graph, False, device)

    def load_fn(self, fn, params):
        """Serve a torch callable ``fn(params, x)`` over ``params`` (a
        dict, list or tuple tree of tensors or numpy arrays), placed once
        on the handle's device (``"cuda"`` unless asked otherwise; a
        tensor already there is not copied).  Under a mesh (bucketed) the
        tree stays on the host and only each member's blocks go to the
        devices; an ``fn`` that carries its module as ``fn.module`` (as
        :func:`module_forward` makes it) is gathered a layer at a time,
        any other ``fn`` its whole tree a dispatch.  The counterpart of
        the JAX package's ``load_jax``."""
        device = resolve_device(self._device)
        placed = place_tree(params,
                            "cpu" if self._sharded(False) else device)
        self._quantize_flag = False
        self._net, self._fn, self._params = None, fn, placed

        def predict_fn(x):
            return fn(placed, x)

        self._install(predict_fn, device, replica_fn=fn,
                      replica_params=placed)
        return self

    def _replica_devices(self, device) -> List[torch.device]:
        """The replicas' devices: the request (``"all"``, an int clamped
        to the devices of ``device``'s platform, or a device list).
        Under a mesh, the device list or else every device of the
        platform, to carve into groups."""
        req = self._replicas_req
        if isinstance(req, (list, tuple)):
            if not req:
                raise ValueError("replicas needs at least one device")
            return [_norm_device(d) for d in req]
        avail = available_devices(device)
        if self._mesh is not None:
            return avail
        if isinstance(req, str):
            if req.lower() != "all":
                raise ValueError(
                    f'replicas must be "all", an int or a list of '
                    f"devices, got {req!r}")
            return avail
        n = int(req)
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        return avail[:n]

    def _install(self, predict_fn, device, replica_fn=None,
                 replica_params=None):
        """Build the predict path for ``predict_fn`` on ``device``
        (replicated over ``replica_fn``/``replica_params`` when
        ``replicas`` asks for more than one) and publish it; the old
        coalescer is closed after, so its queued requests drain on the
        old path while new traffic takes the new one.  The concurrency
        semaphore is per replica, and REUSED while the capacity is
        unchanged, so old-path drains and new-path traffic share one
        budget.  ``predict_fn`` is None for a sharded net, whose groups
        serve every dispatch."""
        old_coalescer = self._coalescer
        cache = coalescer = replica_set = None
        # a quantized handle runs each batch at its own shape, as the
        # JAX package's does
        if self._bucketing and not self._quantize_flag:
            devs = self._replica_devices(device)
            if self._mesh is not None and replica_fn is not None:
                # sharded serving: the spec decides how many groups the
                # devices carve into; one build, every other group a
                # placement
                from ...serving.shardgroup import ShardGroupSet
                replica_set = ShardGroupSet(replica_fn, replica_params,
                                            self._mesh, devices=devs)
            elif len(devs) > 1 and replica_fn is not None:
                replica_set = ReplicaSet(replica_fn, replica_params,
                                         devices=devs)
            cache = BucketedExecutableCache(
                predict_fn, max_batch=self.max_batch_size,
                buckets=self._buckets, growth=self._bucket_growth,
                device=device, replica_set=replica_set)
        cap = self.concurrent_num * (
            replica_set.n if replica_set is not None else 1)
        if cap != self._sem_capacity:
            self._semaphore = threading.Semaphore(cap)
            self._sem_capacity = cap
        if cache is not None and self._coalescing:
            coalescer = RequestCoalescer(
                cache, max_wait_ms=self.max_wait_ms,
                semaphore=self._semaphore,
                pipeline_depth=min(2, self.concurrent_num),
                hedging=self._hedging,
                hedge_quantile=self._hedge_quantile,
                hedge_min_ms=self._hedge_min_ms)
        self._fastpath = (predict_fn, cache, coalescer, device)
        self._cache = cache
        self._coalescer = coalescer
        if old_coalescer is not None:
            old_coalescer.close()

    def _net_weights(self) -> dict:
        """The served net's weights by name: its tensors, or, sharded,
        the first group's blocks assembled on the host."""
        if self._sharded(self._quantize_flag):
            return self._replica_set().host_params()
        return module_tensors(self._net)

    def _replica_set(self) -> Optional[ReplicaSet]:
        fastpath = self._fastpath
        if fastpath is None:
            return None
        cache = fastpath[1]
        return cache.replica_set if cache is not None else None

    @property
    def n_replicas(self) -> int:
        """Total replica count (1 on the single-device path)."""
        rs = self._replica_set()
        return rs.n if rs is not None else 1

    @property
    def active_replicas(self) -> int:
        """Replicas currently in the scheduled (elastic) set."""
        rs = self._replica_set()
        return rs.n_active if rs is not None else 1

    def placement_complete(self) -> bool:
        """True when every replica holds every placed signature (the
        pager's install guard); a handle without replicas is complete
        once loaded."""
        if self._fastpath is None:
            return False
        rs = self._replica_set()
        return rs.placement_complete() if rs is not None else True

    def set_active_replicas(self, n: int) -> int:
        """Resize the scheduled replica set (the autoscaler's lever):
        joining replicas are primed on every placed signature BEFORE they
        take traffic, so a scale-up never serves cold and never builds.
        Returns the active count; 1 on the single-device path."""
        if self._fastpath is None:
            raise RuntimeError("InferenceModel: no model loaded")
        rs = self._replica_set()
        return rs.set_active(n) if rs is not None else 1

    # ---- serving fast path surface ----
    def warmup(self, sample_shapes, dtypes=None) -> float:
        """Run every ladder bucket once for the given per-sample input
        shape(s) (a list of shapes for a model of several inputs,
        ``dtypes`` element-wise); returns wall seconds."""
        if self._fastpath is None:
            raise RuntimeError("InferenceModel: no model loaded")
        if self._cache is None:
            raise RuntimeError(
                "warmup needs the bucketed path (bucketing=True)")
        with execstore.tag_builds(self.store_tag):
            return self._cache.warmup(sample_shapes, dtypes)

    def serving_stats(self) -> dict:
        """Per-bucket hit/miss/build-time counters, coalescer dispatch
        counts, with replicas their per-replica counters and health (and
        hedge outcomes when hedging), and with an engine its decode
        counters."""
        out = {"buckets": (), "hits": {}, "misses": {},
               "build_time_s": {}, "dispatches": 0,
               "coalesced_requests": 0, "coalescer_pending": 0,
               "replicas": 1}
        fastpath = self._fastpath
        if fastpath is None:
            return out
        _, cache, coalescer, _ = fastpath
        if cache is not None:
            out["buckets"] = cache.buckets
            out.update(cache.stats.snapshot())
            if cache.replica_set is not None:
                out.update(cache.replica_set.stats())
        if coalescer is not None:
            out["dispatches"] = coalescer.dispatches
            out["coalesced_requests"] = coalescer.coalesced_requests
            out["coalescer_pending"] = coalescer.pending
            if coalescer.hedging:
                out["hedges"] = coalescer.hedge_stats()
        engine = self._decode_engine
        if engine is not None:
            out["decode"] = engine.stats()
        return out

    # ---- continuous-batching generation ----
    @property
    def decode_engine(self) -> Optional[DecodeEngine]:
        """The attached engine (None unless built with
        ``decode_capacity`` and loaded with an LM)."""
        return self._decode_engine

    def _require_engine(self) -> DecodeEngine:
        engine = self._decode_engine
        if engine is None:
            raise RuntimeError(
                "no decode engine: construct the InferenceModel with "
                "decode_capacity= and load a generation-capable LM")
        return engine

    def generate(self, prompt_ids, max_new_tokens,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed=0):
        """Continuous-batching decode of each prompt (a (B, L) array or a
        list of ragged 1-D rows) beside every other live request; returns
        each row's continuation (1-D int32, EOS included when hit).
        ``max_new_tokens`` and ``seed`` may be per row."""
        return self._require_engine().generate(
            prompt_ids, max_new_tokens, eos_id=eos_id, timeout=timeout,
            span=_trace.current_span(), temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed)

    def generate_stream(self, prompt_ids, max_new_tokens: int,
                        eos_id: Optional[int] = None,
                        temperature: float = 0.0,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None, seed: int = 0):
        """Streaming single-prompt decode: a
        :class:`~.decode.TokenStream` at once; iterate it, or
        ``.result()`` for the whole continuation."""
        return self._require_engine().submit(
            prompt_ids, max_new_tokens, eos_id=eos_id,
            span=_trace.current_span(), temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed)

    def close(self):
        """Stop the coalescer and decode dispatcher threads."""
        if self._coalescer is not None:
            self._coalescer.close()
        if self._decode_engine is not None:
            self._decode_engine.close()

    def reload(self, model_path: str, weight_path: Optional[str] = None,
               quantize: Optional[bool] = None):
        """Hot-swap the served model from a saved one; a quantized handle
        stays quantized unless ``quantize=False``."""
        return self.load(model_path, weight_path, quantize=quantize)

    # ---- prediction ----
    def predict(self, inputs) -> Any:
        """One batch array, a JTensor, a list of per-sample inputs, or a
        tuple (or list of input-lists) for a model of several inputs;
        returns predictions in the matching container type."""
        fastpath = self._fastpath  # one read: consistent under reload()
        if fastpath is None:
            raise RuntimeError("InferenceModel: no model loaded")
        predict_fn, cache, coalescer, device = fastpath
        # the whole cost of tracing when off is this one read; every
        # phase call below checks span is None
        span = _trace.current_span()
        batched, single, jtensor = self._normalize(inputs)
        if cache is None:
            with self._semaphore, torch.no_grad():
                if span is not None:
                    span.phase_start("device_put")
                xb = to_device(batched, device)
                _profile.note_transfer("h2d")
                if span is not None:
                    span.phase_start("execute")
                dev = predict_fn(xb)
            out = fetch_rows(dev, _rows(batched))
            if span is not None:
                span.phase_end()
        else:
            out = None
            if (coalescer is not None and not coalescer.closed
                    and _rows(batched) <= cache.max_batch):
                try:
                    out = coalescer.submit(batched, span=span).result()
                except CoalescerClosedError:
                    out = None  # closed between the check and the submit
            if out is None:
                out = cache.run(batched, sem=self._semaphore, span=span)
        if jtensor:
            tensors = [JTensor.from_ndarray(o) for o in out]
            return tensors[0] if single else tensors
        return out[0] if single else out

    def _normalize(self, inputs):
        jtensor = False
        single = False
        if isinstance(inputs, JTensor):
            inputs, jtensor, single = [inputs], True, True
        if isinstance(inputs, np.ndarray):
            return _canonical(inputs), False, False
        if isinstance(inputs, tuple):
            return tuple(
                _canonical(a) if isinstance(a, np.ndarray) else _to_ndarray(a)
                for a in inputs), False, False
        if isinstance(inputs, list):
            if inputs and isinstance(inputs[0], JTensor):
                jtensor = True
                arrs = [_to_ndarray(t) for t in inputs]
                return np.stack(arrs), single, jtensor
            if inputs and isinstance(inputs[0], (list, tuple)):
                n_inputs = len(inputs[0])
                return tuple(
                    np.stack([_to_ndarray(sample[i]) for sample in inputs])
                    for i in range(n_inputs)), single, jtensor
            arrs = [_to_ndarray(t) for t in inputs]
            return np.stack(arrs), single, jtensor
        return _to_ndarray(inputs), False, False

    def __repr__(self):
        return (f"InferenceModel(concurrent={self.concurrent_num}, "
                f"loaded={self._fastpath is not None})")


class AbstractInferenceModel(InferenceModel):
    """Name-parity alias for the POJO-style entry class."""
