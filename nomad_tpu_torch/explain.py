"""Placement explainability: per-eval score decomposition and filter
attribution for the device scheduling path.

Port of `nomad_tpu/explain.py`: this package's own copy, with its own
process-wide ring, counters and opt-out, so recording here never
touches the JAX package's ring (and the reverse).

The device stack (`sched/cuda_stack.py`) collapses the per-node ranking
loop into one kernel launch, which keeps only the winner and the walk's
pull count.  The stack's capture rebuilds the serial iterator chain's
`AllocMetric` from the arrays the select already computed; this module
is the retention and vocabulary half of the layer:

* **Reason vocabulary.**  Every filter reason maps onto a fixed slug set
  (``reason_slug`` / ``dimension_slug``) shared with the serial chain's
  strings (sched/feasible.py FILTER_CONSTRAINT_*), so dashboards key on a
  bounded family of ``placement.filtered.<slug>`` counters; the server
  zero-registers the whole family at construction (``preregister``).
* **Retention ring.**  One process-wide ring of ``EXPLAIN_RING`` per-eval
  explanations, newest-wins per eval id, bounded, O(1) appends.
* **Opt-out, not opt-in.**  ``NOMAD_TPU_EXPLAIN=0`` turns capture and
  recording into no-ops (``EXPLAIN.set_enabled`` flips it at runtime).

Explanations are recorded for every eval the schedulers complete,
successful placements included.  The readers (the HTTP placement
endpoint, the CLI's ``eval explain``, the Server's explain query) are
not ported yet.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .sched.feasible import (
    FILTER_CLASS_INELIGIBLE,
    FILTER_CONSTRAINT_CSI_VOLUMES,
    FILTER_CONSTRAINT_DEVICES,
    FILTER_CONSTRAINT_DRIVERS,
    FILTER_CONSTRAINT_HOST_VOLUMES,
    FILTER_CONSTRAINT_NETWORK,
)
from .structs import CONSTRAINT_DISTINCT_HOSTS

# retained explanations (completed evals); an explanation is a few KB
# (top-K score meta + reason histograms), so the ring stays near 4 MB
EXPLAIN_RING = 1024

# fixed slug vocabulary for placement.filtered.<slug> counters: every
# reason string the stacks attribute folds into exactly one of these
PLACEMENT_FILTER_SLUGS = (
    "constraint",
    "class-ineligible",
    "missing-drivers",
    "missing-devices",
    "missing-host-volumes",
    "missing-csi-plugins",
    "missing-network",
    "distinct-hosts",
    "distinct-property",
    "other",
)

# fixed slug vocabulary for placement.exhausted.<slug> counters
# (BinPackIterator / allocs_fit dimension strings)
PLACEMENT_EXHAUST_SLUGS = (
    "cpu",
    "memory",
    "disk",
    "ports",
    "bandwidth",
    "devices",
    "other",
)

# the full zero-registered placement.* metric families; the server
# preregisters these at construction so prometheus scrapes export the
# whole family before the first eval (absence-of-series must mean
# absence-of-filtering, never "not emitted yet")
PLACEMENT_COUNTERS = (
    ("placement.explained",)
    + tuple(f"placement.filtered.{s}" for s in PLACEMENT_FILTER_SLUGS)
    + tuple(f"placement.exhausted.{s}" for s in PLACEMENT_EXHAUST_SLUGS)
)
PLACEMENT_GAUGES = (
    "placement.score_spread",
    "placement.winner_margin",
)


def reason_slug(reason: str) -> str:
    """Fold a filter-reason string (serial-chain vocabulary) into its
    fixed counter slug."""
    if reason == FILTER_CLASS_INELIGIBLE:
        return "class-ineligible"
    if reason == FILTER_CONSTRAINT_DRIVERS:
        return "missing-drivers"
    if reason == FILTER_CONSTRAINT_DEVICES:
        return "missing-devices"
    if reason == FILTER_CONSTRAINT_HOST_VOLUMES:
        return "missing-host-volumes"
    if reason == FILTER_CONSTRAINT_CSI_VOLUMES:
        return "missing-csi-plugins"
    if reason == FILTER_CONSTRAINT_NETWORK:
        return "missing-network"
    if reason == CONSTRAINT_DISTINCT_HOSTS:
        return "distinct-hosts"
    if reason.startswith("distinct_property") or reason.startswith(
        "missing property"
    ):
        return "distinct-property"
    # "<ltarget> <operand> <rtarget>" — every remaining serial-chain
    # reason is a concrete constraint rendering
    if " " in reason:
        return "constraint"
    return "other"


def dimension_slug(dimension: str) -> str:
    """Fold an exhaustion-dimension string (allocs_fit / binpack
    vocabulary) into its fixed counter slug."""
    if dimension in ("cpu", "memory", "disk"):
        return dimension
    if "port" in dimension:
        return "ports"
    if "device" in dimension:
        return "devices"
    if "bandwidth" in dimension:
        return "bandwidth"
    return "other"


def preregister(metrics) -> None:
    """Zero-register the placement.* families on a telemetry store."""
    metrics.preregister(
        counters=PLACEMENT_COUNTERS, gauges=PLACEMENT_GAUGES
    )


def alloc_metric_to_api(metric, winner_node_id: str = "") -> Dict:
    """Full Nomad-API-shaped AllocMetric payload (ScoreMetaData trimmed
    to top-K on this read, winner always retained)."""
    return {
        "NodesEvaluated": metric.nodes_evaluated,
        "NodesFiltered": metric.nodes_filtered,
        "NodesAvailable": dict(metric.nodes_available),
        "ClassFiltered": dict(metric.class_filtered),
        "ConstraintFiltered": dict(metric.constraint_filtered),
        "NodesExhausted": metric.nodes_exhausted,
        "ClassExhausted": dict(metric.class_exhausted),
        "DimensionExhausted": dict(metric.dimension_exhausted),
        "QuotaExhausted": list(metric.quota_exhausted),
        "ScoreMetaData": [
            {
                "NodeID": m.node_id,
                "Scores": dict(m.scores),
                "NormScore": m.norm_score,
            }
            for m in metric.top_score_meta(
                winner_node_id=winner_node_id
            )
        ],
        "AllocationTime": metric.allocation_time_s,
        "CoalescedFailures": metric.coalesced_failures,
    }


class ExplainRecorder:
    """Bounded per-eval placement-explanation store (trace-ring
    retention discipline: deque ring + newest-per-eval-id index)."""

    def __init__(self, ring: int = EXPLAIN_RING) -> None:
        self._lock = threading.Lock()
        self._ring: deque = deque()
        self._ring_cap = ring
        self._by_id: Dict[str, Dict] = {}
        self.enabled = os.environ.get("NOMAD_TPU_EXPLAIN", "1") != "0"

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    # -- building ------------------------------------------------------

    def build_record(self, ev, scheduler) -> Optional[Dict]:
        """Assemble one eval's placement explanation from a completed
        scheduler run: per-TG winner + full AllocMetric breakdown for
        placed groups, failed-TG metrics for the rest.  Returns None
        when disabled or the run produced nothing explainable."""
        if not self.enabled:
            return None
        plan = getattr(scheduler, "plan", None)
        failed = getattr(scheduler, "failed_tg_allocs", None) or {}
        groups: Dict[str, Dict] = {}
        if plan is not None:
            for allocs in plan.node_allocation.values():
                for alloc in allocs:
                    if alloc.eval_id != ev.id or alloc.metrics is None:
                        continue
                    g = groups.setdefault(
                        alloc.task_group,
                        {"placed": 0, "placements": []},
                    )
                    g["placed"] += 1
                    g["placements"].append(
                        {
                            "Name": alloc.name,
                            "NodeID": alloc.node_id,
                            "NodeName": alloc.node_name,
                            "NormScore": (
                                alloc.metrics.node_norm_score(
                                    alloc.node_id
                                )
                            ),
                        }
                    )
                    # the group's freshest full breakdown: highest
                    # select sequence wins (plan collections iterate
                    # in node-insertion order, which is NOT placement
                    # order; earlier metrics stay reachable via the
                    # per-alloc API)
                    prior = g.get("metric")
                    if (
                        prior is None
                        or alloc.metrics.seq >= prior.seq
                    ):
                        g["metric"] = alloc.metrics
                        g["winner"] = alloc.node_id
        for tg, metric in failed.items():
            g = groups.setdefault(tg, {"placed": 0, "placements": []})
            g["failed"] = True
            g["metric"] = metric
            g.setdefault("winner", "")
        if not groups:
            return None
        from .trace import TRACE

        task_groups = {}
        for tg, g in groups.items():
            metric = g.get("metric")
            entry = {
                "Placed": g["placed"],
                "Failed": bool(g.get("failed")),
                "Winner": g.get("winner", ""),
                "Placements": g["placements"],
                "Metric": (
                    alloc_metric_to_api(
                        metric, winner_node_id=g.get("winner", "")
                    )
                    if metric is not None
                    else None
                ),
            }
            if metric is not None:
                # bin-pack imbalance over the UNTRIMMED score meta —
                # the serialized ScoreMetaData is top-K and would
                # measure only the spread among the best few nodes
                norms = sorted(
                    (m.norm_score for m in metric.score_meta),
                    reverse=True,
                )
                if len(norms) >= 2:
                    entry["ScoreSpread"] = norms[0] - norms[-1]
                    entry["WinnerMargin"] = norms[0] - norms[1]
            task_groups[tg] = entry
        return {
            "EvalID": ev.id,
            "JobID": ev.job_id,
            "Namespace": ev.namespace,
            "Type": ev.type,
            "TriggeredBy": ev.triggered_by,
            "TraceID": TRACE.trace_id_of(ev.id),
            "RecordedAt": time.time(),
            "TaskGroups": task_groups,
        }

    # -- recording -----------------------------------------------------

    def publish(self, record: Optional[Dict], metrics=None) -> None:
        """Retain a built record and emit its cluster-shape telemetry.
        Accepts None (disabled / nothing explainable) so call sites
        stay one line."""
        if record is None or not self.enabled:
            return
        eval_id = record["EvalID"]
        with self._lock:
            prior = self._by_id.get(eval_id)
            if prior is not None:
                # newest-wins per eval id: a redelivered eval's stale
                # explanation must not linger in /v1/placements next
                # to its replacement
                try:
                    self._ring.remove(prior)
                except ValueError:
                    pass
            self._by_id[eval_id] = record
            self._ring.append(record)
            while len(self._ring) > self._ring_cap:
                evicted = self._ring.popleft()
                if self._by_id.get(evicted["EvalID"]) is evicted:
                    del self._by_id[evicted["EvalID"]]
        # cross-link: the eval's trace now points at its explanation
        from .trace import TRACE

        TRACE.annotate(eval_id, placement=f"/v1/evaluation/{eval_id}/placement")
        if metrics is not None:
            self._emit(record, metrics)

    def annotate(self, eval_id: str, **fields) -> None:
        """Merge extra keys into an eval's retained record (no-op when
        the eval has no record — e.g. a discarded speculation).  The
        storm solver tags committed records with its round and
        assignment score this way, AFTER the commit decided which
        replay actually published."""
        if not self.enabled:
            return
        with self._lock:
            record = self._by_id.get(eval_id)
            if record is not None:
                record.update(fields)

    def record_eval(self, ev, scheduler, metrics=None) -> None:
        """build_record + publish in one call (the serial paths)."""
        if not self.enabled:
            return
        self.publish(self.build_record(ev, scheduler), metrics=metrics)

    def _emit(self, record: Dict, metrics) -> None:
        """Cluster-shape telemetry from one explanation: constraint
        pressure (``placement.filtered.<reason>`` /
        ``placement.exhausted.<dim>`` counters) and bin-pack imbalance
        (``placement.score_spread`` / ``placement.winner_margin``
        gauges) — trends dashboards can't see in latency metrics."""
        metrics.incr("placement.explained")
        for tg in record["TaskGroups"].values():
            m = tg.get("Metric")
            if m is None:
                continue
            for reason, n in m["ConstraintFiltered"].items():
                metrics.incr(
                    f"placement.filtered.{reason_slug(reason)}",
                    float(n),
                )
            for dim, n in m["DimensionExhausted"].items():
                metrics.incr(
                    f"placement.exhausted.{dimension_slug(dim)}",
                    float(n),
                )
            if "ScoreSpread" in tg:
                metrics.set_gauge(
                    "placement.score_spread", tg["ScoreSpread"]
                )
                metrics.set_gauge(
                    "placement.winner_margin", tg["WinnerMargin"]
                )

    # -- reads ---------------------------------------------------------

    def get(self, eval_id: str) -> Optional[Dict]:
        with self._lock:
            return self._by_id.get(eval_id)

    def recent(self, limit: int = 64) -> List[Dict]:
        with self._lock:
            candidates = list(self._ring)
        return list(reversed(candidates))[: max(1, limit)]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_id.clear()


EXPLAIN = ExplainRecorder()

__all__ = [
    "EXPLAIN",
    "EXPLAIN_RING",
    "ExplainRecorder",
    "FILTER_CLASS_INELIGIBLE",
    "FILTER_CONSTRAINT_NETWORK",
    "PLACEMENT_COUNTERS",
    "PLACEMENT_EXHAUST_SLUGS",
    "PLACEMENT_FILTER_SLUGS",
    "PLACEMENT_GAUGES",
    "alloc_metric_to_api",
    "dimension_slug",
    "preregister",
    "reason_slug",
]
