"""Policy-weighted scoring: host-side weight-tensor assembly.

The score kernel (ops/score.py) accepts an optional ``PolicyTerms``
pytree — a per-(TG, node) throughput weight vector, a migration
stickiness vector, and per-policy scalar coefficients — fused into the
one broadcasted score pass.  This module is the host half: it resolves
a job's ``PolicySpec`` against the ``NOMAD_TPU_POLICY*`` knobs,
normalizes the Gavel-style throughput-by-node-class table ONCE (so the
serial rank iterator and the vectorized kernel consume float-identical
values), assembles arena-shaped numpy tensors from replicated state
(node classes via the existing interned ``node.class`` column, sticky
nodes via the job's live allocs), and caches the throughput tensor
keyed by (table epoch, job version, topo generation) so warm assembly
is O(1) like every other column.

Everything here reads only replicated state — the job spec, the node
table, and the alloc index — so fan-out followers assemble identical
tensors from their own store with zero new RPCs.

Two concrete policies ship end to end:

* **heterogeneity-aware throughput** — ``spec.throughput`` maps node
  class -> relative throughput (any positive scale); the assembler
  normalizes by the table max and the kernel appends
  ``coef * tput_norm[node]`` to the score mean for EVERY candidate
  (zeros included: an unknown class pulls the mean down).
* **migration / reschedule cost** — when this TG has live allocs
  (older than ``min_runtime_s``), every node NOT currently hosting one
  pays a ``-migration_coefficient`` penalty, appended only where
  non-zero (the node-reschedule-penalty convention: the incumbent's
  score mean is untouched, movers are dragged down), so drains and
  mass replans prefer in-place replacement over churn.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Set, Tuple

import numpy as np

from ..state.node_table import MISSING

# zero-registered at Server construction (the same absence-of-series
# contract as storm.* / mesh.*: no policy.* series must mean "no
# policy-weighted select ever ran", never "not exported")
POLICY_COUNTERS = (
    "policy.assemblies",
    "policy.cache_hits",
    "policy.cache_misses",
    "policy.evals",
    "policy.storm_evals",
)
POLICY_GAUGES = (
    "policy.cache_size",
)


def policy_enabled() -> bool:
    """NOMAD_TPU_POLICY=0 disables the policy layer entirely (jobs
    carrying a PolicySpec score as policy-less).  Default on — inert
    without a job-level spec."""
    return os.environ.get("NOMAD_TPU_POLICY", "1") != "0"


def _coef_override(knob: str) -> Optional[float]:
    raw = os.environ.get(knob, "")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


class ResolvedPolicy(NamedTuple):
    """A job's PolicySpec after knob resolution and normalization.
    ``tput_norm`` is the throughput table divided by its max — computed
    exactly once here so the serial oracle's per-node dict lookup and
    the vectorized tensor gather see float-identical values (the
    division happens on one side only, never twice)."""

    tput_norm: Tuple[Tuple[str, float], ...]  # hashable normalized table
    has_tput: bool
    tput_coef: float
    mig_coef: float
    min_runtime_s: float

    def tput_value(self, node_class: str) -> float:
        for cls, v in self.tput_norm:
            if cls == node_class:
                return v
        return 0.0


def resolve(job) -> Optional[ResolvedPolicy]:
    """The job's effective policy, or None when the layer is off, the
    job carries no spec, or the spec is inert."""
    spec = getattr(job, "policy", None)
    if spec is None or not policy_enabled():
        return None
    tput_coef = _coef_override("NOMAD_TPU_POLICY_TPUT_COEF")
    if tput_coef is None:
        tput_coef = float(spec.throughput_coefficient)
    mig_coef = _coef_override("NOMAD_TPU_POLICY_MIG_COEF")
    if mig_coef is None:
        mig_coef = float(spec.migration_coefficient)
    table = dict(spec.throughput or {})
    norm: Tuple[Tuple[str, float], ...] = ()
    if table:
        maxv = max(table.values())
        if maxv > 0:
            norm = tuple(
                sorted((cls, float(v) / maxv) for cls, v in table.items())
            )
    has_tput = bool(norm)
    if not has_tput and mig_coef == 0.0:
        return None
    return ResolvedPolicy(
        tput_norm=norm,
        has_tput=has_tput,
        tput_coef=tput_coef,
        mig_coef=mig_coef,
        min_runtime_s=float(spec.min_runtime_s),
    )


# ---------------------------------------------------------------------------
# tensor assembly
# ---------------------------------------------------------------------------


def _cache_capacity() -> int:
    try:
        return max(1, int(os.environ.get("NOMAD_TPU_POLICY_CACHE", "64")))
    except ValueError:
        return 64


class _TputCache:
    """LRU of assembled throughput tensors keyed by everything that can
    change one: the table identity (epoch survives snapshot-restore
    table swaps), the job's policy version, the topology generation
    (node joins / class re-fingerprints), the arena capacity (grows
    reshape the tensor) and the dtype (f64 parity path vs f32 device
    mirror)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, np.ndarray]" = OrderedDict()

    def get(self, key: tuple) -> Optional[np.ndarray]:
        with self._lock:
            tensor = self._entries.get(key)
            if tensor is not None:
                self._entries.move_to_end(key)
            return tensor

    def put(self, key: tuple, tensor: np.ndarray) -> None:
        with self._lock:
            self._entries[key] = tensor
            self._entries.move_to_end(key)
            cap = _cache_capacity()
            while len(self._entries) > cap:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_TPUT_CACHE = _TputCache()


def tput_tensor(
    resolved: ResolvedPolicy,
    job,
    table,
    dtype=np.float64,
    metrics=None,
) -> np.ndarray:
    """Arena-shaped normalized-throughput vector for this job's policy:
    ``out[row] = tput_norm[node.class]`` (0 for vacant rows and unknown
    classes).  Cached keyed by (table epoch, job version, topo
    generation): warm assembly is a dict hit; a cold one is one
    interner-sized python loop plus one vectorized gather."""
    key = (
        table.epoch,
        job.namespace,
        job.id,
        job.version,
        resolved.tput_norm,
        resolved.has_tput,
        table.topo_generation,
        table.capacity,
        np.dtype(dtype).str,
    )
    cached = _TPUT_CACHE.get(key)
    if cached is not None:
        if metrics is not None:
            metrics.incr("policy.cache_hits")
        return cached
    col = table.column("node.class")
    # per-code lookup table, then one gather over the arena codes;
    # MISSING (vacant row / classless node) maps to 0.0
    lookup = dict(resolved.tput_norm)
    code_values = np.array(
        [lookup.get(v, 0.0) for v in col.interner.values] + [0.0],
        dtype=dtype,
    )
    tensor = code_values[np.where(col.codes == MISSING, -1, col.codes)]
    tensor = np.ascontiguousarray(tensor, dtype=dtype)
    _TPUT_CACHE.put(key, tensor)
    if metrics is not None:
        metrics.incr("policy.cache_misses")
        metrics.incr("policy.assemblies")
        metrics.set_gauge("policy.cache_size", float(len(_TPUT_CACHE)))
    return tensor


def clear_tput_cache() -> None:
    """Test hook."""
    _TPUT_CACHE.clear()


def sticky_node_ids(
    resolved: ResolvedPolicy,
    job,
    tg_name: str,
    state,
    now: Optional[float] = None,
) -> Set[str]:
    """Node ids currently hosting a live (non-terminal) alloc of this
    job+TG older than ``min_runtime_s`` — the migration-cost policy's
    stickiness set.  Both the serial PolicyIterator and the vectorized
    tensor derive from THIS set so membership is identical."""
    if resolved.mig_coef == 0.0:
        return set()
    cutoff = None
    if resolved.min_runtime_s > 0.0:
        cutoff = (time.time() if now is None else now) - resolved.min_runtime_s
    out: Set[str] = set()
    for alloc in state.allocs_by_job(job.namespace, job.id):
        if alloc.task_group != tg_name or alloc.terminal_status():
            continue
        if cutoff is not None and alloc.create_time > cutoff:
            continue
        if alloc.node_id:
            out.add(alloc.node_id)
    return out


def migration_vector(
    sticky: Set[str],
    table,
    dtype=np.float64,
) -> np.ndarray:
    """Arena-shaped migration-cost vector from a sticky-node-id set:
    ``-1`` on every row EXCEPT the sticky ones, all-zero when the set
    is empty (fresh placement — no incumbent, no cost).  The kernel
    multiplies by ``mig_coef`` and appends only where non-zero, so the
    incumbent's score mean is untouched while every other node pays
    the reschedule penalty — the ``node-reschedule-penalty`` shape.
    A positive bonus on the incumbent would backfire under Nomad's
    mean-of-components scoring: any bonus below the node's other
    component mean LOWERS it."""
    if not sticky:
        return np.zeros(table.capacity, dtype=dtype)
    mig = np.full(table.capacity, -1.0, dtype=dtype)
    for node_id in sticky:
        row = table.row_of.get(node_id)
        if row is not None:
            mig[row] = 0.0
    return mig
