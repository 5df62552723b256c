"""Serving metrics: the primitives of the port's
``observability.metrics`` (imported back here so ``serving.metrics`` /
``serving.Counters`` read as in the JAX package), plus the control-plane
-> Prometheus bridge, with the JAX package's family names and labels.

The bridge is a scrape-time collector: it walks one
``ModelRegistry.metrics()`` snapshot into exposition families with
per-model / per-version / per-bucket labels, so wiring the whole
control plane into a :class:`~..observability.metrics.MetricsRegistry`
is one line::

    mreg.register_collector(registry_collector(model_registry))
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

from ..observability.metrics import (Counters, Family, LatencyWindow,
                                     summary_family)

__all__ = ["Counters", "LatencyWindow", "registry_collector",
           "registry_families"]

_ADMISSION_GAUGES = ("queue_depth", "running", "queue_high_water",
                     "max_queue", "max_concurrency")
_ADMISSION_COUNTERS = ("admitted", "completed", "errors",
                       "shed_overload", "shed_deadline",
                       "shed_draining", "shed_evicted",
                       "deadline_lapsed")
_HEDGE_OUTCOMES = ("fired", "primary_won", "hedge_won",
                   "skipped_no_replica")


def registry_families(snapshot: Dict[str, Any]) -> List[Family]:
    """One ``ModelRegistry.metrics()`` snapshot as Prometheus families
    (per-model/version/bucket labels — see module docstring)."""
    model_gauges: Dict[str, List] = {
        "zoo_model_active_version": [],
        "zoo_model_canary_fraction": [],
        "zoo_coalescer_pending": [],
    }
    model_counters: Dict[str, List] = {"zoo_model_swap_total": []}
    admission: Dict[str, List] = {
        **{f"zoo_admission_{g}": [] for g in _ADMISSION_GAUGES},
        **{f"zoo_admission_{c}_total": [] for c in _ADMISSION_COUNTERS},
    }
    version_counters: Dict[str, List] = {
        "zoo_model_requests_total": [],
        "zoo_model_errors_total": [],
    }
    version_gauges: Dict[str, List] = {"zoo_model_uptime_seconds": [],
                                       "zoo_model_version_state": []}
    bucket_counters: Dict[str, List] = {
        "zoo_bucket_hits_total": [],
        "zoo_bucket_misses_total": [],
        "zoo_bucket_compile_seconds_total": [],
    }
    replica_counters: Dict[str, List] = {
        "zoo_replica_dispatches_total": [],
        "zoo_replica_bucket_dispatches_total": [],
        "zoo_group_dispatches_total": [],
    }
    replica_gauges: Dict[str, List] = {
        "zoo_replica_unhealthy": [],
        "zoo_model_replicas": [],
        "zoo_model_replicas_active": [],
        "zoo_model_groups": [],
    }
    # elastic serving: per-class admission + hedge outcomes
    class_counters: Dict[str, List] = {
        "zoo_shed_total": [],
        "zoo_class_admitted_total": [],
        "zoo_hedge_total": [],
    }
    class_gauges: Dict[str, List] = {"zoo_class_weight": []}
    coalescer_counters: Dict[str, List] = {
        "zoo_coalescer_dispatches_total": [],
        "zoo_coalesced_requests_total": [],
    }
    # continuous-batching decode: per-token/step counters + the live
    # slot-occupancy gauge (capacity alongside, so occupancy reads as
    # a fraction without a dashboard join).  Decode engine v2 adds the
    # sampled-token counter, the prefix-pool hit/miss pair (their
    # ratio is the shared-prefix win), and the speculative
    # proposed/accepted pair (their ratio is the acceptance rate the
    # spec bench gates on) — exported whenever a decode engine is
    # live, zeros until the feature serves traffic, so dashboards and
    # alerts can pre-wire at deploy
    decode_counters: Dict[str, List] = {
        "zoo_decode_tokens_total": [],
        "zoo_decode_steps_total": [],
        "zoo_decode_sampled_tokens_total": [],
        "zoo_decode_prefix_hits_total": [],
        "zoo_decode_prefix_misses_total": [],
        "zoo_decode_spec_proposed_total": [],
        "zoo_decode_spec_accepted_total": [],
    }
    decode_gauges: Dict[str, List] = {
        "zoo_decode_slot_occupancy": [],
        "zoo_decode_slot_capacity": [],
    }
    # weight pager (serving density): residency per model plus the
    # fault/eviction outcome counters — exported for every PAGED model
    # (zeros until the pager acts) so density dashboards pre-wire
    pager_gauges: Dict[str, List] = {"zoo_model_resident": []}
    pager_counters: Dict[str, List] = {
        "zoo_pager_faults_total": [],
        "zoo_pager_evictions_total": [],
    }
    # ONE summary family for every (model, version): emitting a Family
    # per version would render duplicate # TYPE blocks for the same
    # name, which real Prometheus parsers reject outright
    latency_samples: List = []

    for model, m in sorted(snapshot.items()):
        ml = {"model": model}
        if m.get("active_version") is not None:
            model_gauges["zoo_model_active_version"].append(
                (ml, m["active_version"]))
        model_counters["zoo_model_swap_total"].append(
            (ml, m.get("swap_count", 0)))
        model_gauges["zoo_model_canary_fraction"].append(
            (ml, m.get("canary_fraction", 0.0)))
        adm = m.get("admission", {})
        for g in _ADMISSION_GAUGES:
            if g in adm:
                admission[f"zoo_admission_{g}"].append((ml, adm[g]))
        for c in _ADMISSION_COUNTERS:
            if c in adm:
                admission[f"zoo_admission_{c}_total"].append(
                    (ml, adm[c]))
        # per-priority-class admission: the shed counter is the
        # overload-ordering contract ("lowest class sheds first") made
        # observable, labeled by class; classes export even at zero so
        # dashboards/alerts can pre-wire on deploy
        for cname, cstats in sorted(adm.get("classes", {}).items()):
            cl = {"model": model, "class": cname}
            class_counters["zoo_shed_total"].append(
                (cl, cstats.get("shed", 0)))
            class_counters["zoo_class_admitted_total"].append(
                (cl, cstats.get("admitted", 0)))
            class_gauges["zoo_class_weight"].append(
                (cl, cstats.get("weight", 0.0)))
        for version, stats in sorted(m.get("versions", {}).items()):
            # counters/summaries carry ONLY immutable labels: adding
            # the mutable state would fork the series on every
            # canary promote / hot-swap and break rate() continuity
            # exactly at the event being monitored.  State rides a
            # separate info-style gauge instead.
            vl = {"model": model, "version": str(version)}
            version_counters["zoo_model_requests_total"].append(
                (vl, stats.get("requests", 0)))
            version_counters["zoo_model_errors_total"].append(
                (vl, stats.get("errors", 0)))
            version_gauges["zoo_model_version_state"].append(
                ({**vl, "state": str(stats.get("state", ""))}, 1))
            if stats.get("uptime_s") is not None:
                version_gauges["zoo_model_uptime_seconds"].append(
                    (vl, stats["uptime_s"]))
            lat = summary_family(
                "zoo_model_latency_seconds",
                "request latency over the sliding window",
                vl, stats.get("latency", {}))
            if lat is not None:
                latency_samples.extend(lat.samples)
        serving = m.get("serving", {})
        for prom_name, key in (("zoo_bucket_hits_total", "hits"),
                               ("zoo_bucket_misses_total", "misses"),
                               # a bucket's first run is its build
                               ("zoo_bucket_compile_seconds_total",
                                "build_time_s")):
            for bucket, v in sorted(serving.get(key, {}).items()):
                bucket_counters[prom_name].append(
                    ({"model": model, "bucket": str(bucket)}, v))
        for prom_name, key in (
                ("zoo_coalescer_dispatches_total", "dispatches"),
                ("zoo_coalesced_requests_total", "coalesced_requests")):
            if key in serving:
                coalescer_counters[prom_name].append(
                    (ml, serving[key]))
        if "coalescer_pending" in serving:
            model_gauges["zoo_coalescer_pending"].append(
                (ml, serving["coalescer_pending"]))
        pager = m.get("pager")
        if pager:
            pager_gauges["zoo_model_resident"].append(
                (ml, 1 if pager.get("resident") else 0))
            for outcome, key in (("ok", "fault_ok"),
                                 ("timeout", "fault_timeout"),
                                 ("error", "fault_error")):
                pager_counters["zoo_pager_faults_total"].append(
                    ({"model": model, "outcome": outcome},
                     pager.get(key, 0)))
            for reason, key in (("idle", "evict_idle"),
                                ("pressure", "evict_pressure")):
                pager_counters["zoo_pager_evictions_total"].append(
                    ({"model": model, "reason": reason},
                     pager.get(key, 0)))
        dec = serving.get("decode")
        if dec:
            for prom_name, key in (
                    ("zoo_decode_tokens_total", "tokens"),
                    ("zoo_decode_steps_total", "steps"),
                    ("zoo_decode_sampled_tokens_total",
                     "sampled_tokens"),
                    ("zoo_decode_prefix_hits_total", "prefix_hits"),
                    ("zoo_decode_prefix_misses_total",
                     "prefix_misses"),
                    ("zoo_decode_spec_proposed_total",
                     "spec_proposed"),
                    ("zoo_decode_spec_accepted_total",
                     "spec_accepted")):
                decode_counters[prom_name].append(
                    (ml, dec.get(key, 0)))
            decode_gauges["zoo_decode_slot_occupancy"].append(
                (ml, dec.get("slots_active", 0)))
            decode_gauges["zoo_decode_slot_capacity"].append(
                (ml, dec.get("capacity", 0)))
        # device-parallel serving: per-replica dispatch counters (and
        # their per-bucket breakdown — the bucket metrics' replica
        # label) plus the health gauge
        # request hedging: outcome-labeled counters (fired /
        # primary_won / hedge_won / skipped_no_replica)
        for outcome in _HEDGE_OUTCOMES:
            v = serving.get("hedges", {}).get(outcome)
            if v is not None:
                class_counters["zoo_hedge_total"].append(
                    ({"model": model, "outcome": outcome}, v))
        if serving.get("replica_dispatches"):
            replica_gauges["zoo_model_replicas"].append(
                (ml, serving.get("replicas", 1)))
            if "replicas_active" in serving:
                replica_gauges["zoo_model_replicas_active"].append(
                    (ml, serving["replicas_active"]))
            for rep, v in sorted(serving["replica_dispatches"].items()):
                replica_counters["zoo_replica_dispatches_total"].append(
                    ({"model": model, "replica": str(rep)}, v))
            for rep, sick in sorted(
                    serving.get("replica_unhealthy", {}).items()):
                replica_gauges["zoo_replica_unhealthy"].append(
                    ({"model": model, "replica": str(rep)},
                     1 if sick else 0))
            for rep, per_bucket in sorted(
                    serving.get("replica_bucket_dispatches", {}).items()):
                for bucket, v in sorted(per_bucket.items()):
                    replica_counters[
                        "zoo_replica_bucket_dispatches_total"].append(
                        ({"model": model, "replica": str(rep),
                          "bucket": str(bucket)}, v))
        # sharded serving: replica GROUPS (pjit executables over
        # sub-meshes) export their own count + per-group dispatch
        # counters, keyed "group" so dashboards distinguish them from
        # single-device replicas
        if serving.get("groups"):
            replica_gauges["zoo_model_groups"].append(
                (ml, serving["groups"]))
            for grp, v in sorted(
                    serving.get("group_dispatches", {}).items()):
                replica_counters["zoo_group_dispatches_total"].append(
                    ({"model": model, "group": str(grp)}, v))

    help_text = {
        "zoo_model_active_version": "active (serving) version number",
        "zoo_model_swap_total": "completed hot-swaps",
        "zoo_model_canary_fraction":
            "fraction of traffic routed to the staged canary",
        "zoo_coalescer_pending":
            "submitted-but-unresolved coalesced requests",
        "zoo_model_requests_total": "served requests per version",
        "zoo_model_errors_total": "failed requests per version",
        "zoo_model_uptime_seconds":
            "seconds since this version deployed",
        "zoo_model_version_state":
            "info gauge: 1 for the version's current lifecycle state",
        "zoo_bucket_hits_total": "bucket executable cache hits",
        "zoo_bucket_misses_total":
            "bucket cache misses (compiles paid)",
        "zoo_bucket_compile_seconds_total":
            "compile wall seconds per bucket",
        "zoo_coalescer_dispatches_total": "coalesced device dispatches",
        "zoo_coalesced_requests_total":
            "requests served through coalesced dispatches",
        "zoo_model_replicas": "device replicas serving this model",
        "zoo_replica_dispatches_total":
            "device dispatches executed per replica",
        "zoo_replica_bucket_dispatches_total":
            "device dispatches per (replica, bucket)",
        "zoo_replica_unhealthy":
            "1 when the replica was marked unhealthy by a failed "
            "dispatch (restored to 0 by a successful health re-probe)",
        "zoo_model_replicas_active":
            "replicas in the scheduled (elastic) set",
        "zoo_model_groups":
            "sharded replica groups (pjit sub-mesh executables) "
            "serving this model",
        "zoo_group_dispatches_total":
            "device dispatches executed per replica group",
        "zoo_shed_total":
            "requests shed per priority class (all shed causes)",
        "zoo_class_admitted_total":
            "requests granted a slot per priority class",
        "zoo_class_weight": "configured fair-share weight per class",
        "zoo_hedge_total":
            "hedged dispatch outcomes (fired/primary_won/hedge_won/"
            "skipped_no_replica)",
        "zoo_decode_tokens_total":
            "tokens generated by the continuous-batching decode "
            "engine (prefill first tokens included)",
        "zoo_decode_steps_total":
            "slot-array decode steps dispatched",
        "zoo_decode_sampled_tokens_total":
            "tokens emitted by temperature > 0 (sampled) requests",
        "zoo_decode_prefix_hits_total":
            "admissions whose prefix-KV block was served from the "
            "on-device pool (prefill skipped for the prefix)",
        "zoo_decode_prefix_misses_total":
            "pool-eligible admissions that recomputed (and "
            "re-pooled) their prefix block",
        "zoo_decode_spec_proposed_total":
            "draft tokens proposed to the speculative verify step",
        "zoo_decode_spec_accepted_total":
            "draft proposals accepted by the target verify "
            "(accepted/proposed = acceptance rate)",
        "zoo_decode_slot_occupancy":
            "decode slots currently holding a live sequence",
        "zoo_decode_slot_capacity":
            "decode slots in the persistent step executable",
        "zoo_model_resident":
            "1 when the paged model's weights/executables are on-"
            "device (0 while cold/faulting/evicting)",
        "zoo_pager_faults_total":
            "cold-start fault-ins per paged model by request outcome "
            "(ok/timeout/error)",
        "zoo_pager_evictions_total":
            "pager demotions to cold per model by trigger "
            "(idle/pressure)",
    }
    out: List[Family] = []
    gauge_groups = (model_gauges, version_gauges, replica_gauges,
                    class_gauges, decode_gauges, pager_gauges,
                    {k: v for k, v in admission.items()
                     if not k.endswith("_total")})
    counter_groups = (model_counters, version_counters,
                      bucket_counters, coalescer_counters,
                      replica_counters, class_counters, decode_counters,
                      pager_counters,
                      {k: v for k, v in admission.items()
                       if k.endswith("_total")})
    for groups, mtype in ((gauge_groups, "gauge"),
                          (counter_groups, "counter")):
        for group in groups:
            for name, samples in group.items():
                if samples:
                    out.append(Family(
                        mtype, name,
                        help_text.get(name,
                                      name.replace("zoo_", "")
                                      .replace("_", " ")),
                        samples))
    if latency_samples:
        out.append(Family("summary", "zoo_model_latency_seconds",
                          "request latency over the sliding window",
                          latency_samples))
    return out


def registry_collector(model_registry) -> Callable[[], List[Family]]:
    """Scrape-time collector over a live ``ModelRegistry``."""
    return lambda: registry_families(model_registry.metrics())
