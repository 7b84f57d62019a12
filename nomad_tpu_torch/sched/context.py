"""Per-evaluation scratch state (reference scheduler/context.go).

`EvalContext` carries the in-flight plan, placement metrics, the
proposed-allocation view (state allocs minus plan evictions/preemptions
plus plan placements, context.go:120 ProposedAllocs), computed-class
eligibility memoization (context.go:190 EvalEligibility), operator caches
and the seeded RNG that replaces the reference's global `rand` so both the
oracle chain and the TPU kernel walk nodes in the same shuffled order
(SURVEY.md section 7.3 determinism note).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, TYPE_CHECKING

from ..structs import (
    Allocation,
    AllocMetric,
    Job,
    Plan,
    escaped_constraints,
)
from ..structs.node_class import escaped_constraints as _escaped

if TYPE_CHECKING:  # pragma: no cover
    from ..state.store import StateSnapshot

# Computed-class feasibility states (reference context.go:167-186)
CLASS_UNKNOWN = 0
CLASS_INELIGIBLE = 1
CLASS_ELIGIBLE = 2
CLASS_ESCAPED = 3


class EvalEligibility:
    """Tracks per-computed-class feasibility over an evaluation
    (reference context.go:190)."""

    def __init__(self) -> None:
        self.job: Dict[str, int] = {}
        self.job_escaped = False
        self.task_groups: Dict[str, Dict[str, int]] = {}
        self.tg_escaped: Dict[str, bool] = {}
        self.quota_reached = ""

    def set_job(self, job: Job) -> None:
        escaped = bool(_escaped(job.constraints))
        for tg in job.task_groups:
            constraints = list(tg.constraints)
            for task in tg.tasks:
                constraints.extend(task.constraints)
            self.tg_escaped[tg.name] = bool(_escaped(constraints))
        self.job_escaped = escaped

    def has_escaped(self) -> bool:
        return self.job_escaped or any(self.tg_escaped.values())

    def job_status(self, klass: str) -> int:
        if self.job_escaped:
            return CLASS_ESCAPED
        if not klass:
            return CLASS_ESCAPED
        return self.job.get(klass, CLASS_UNKNOWN)

    def set_job_eligibility(self, eligible: bool, klass: str) -> None:
        self.job[klass] = CLASS_ELIGIBLE if eligible else CLASS_INELIGIBLE

    def task_group_status(self, tg: str, klass: str) -> int:
        if self.tg_escaped.get(tg, False):
            return CLASS_ESCAPED
        if not klass:
            return CLASS_ESCAPED
        return self.task_groups.get(tg, {}).get(klass, CLASS_UNKNOWN)

    def set_task_group_eligibility(
        self, eligible: bool, tg: str, klass: str
    ) -> None:
        self.task_groups.setdefault(tg, {})[klass] = (
            CLASS_ELIGIBLE if eligible else CLASS_INELIGIBLE
        )

    def get_classes(self) -> Dict[str, bool]:
        """Flatten job+tg eligibility into class -> eligible, for blocked
        evals (reference context.go GetClasses)."""
        out: Dict[str, bool] = {}
        for klass, status in self.job.items():
            if status == CLASS_ELIGIBLE:
                out[klass] = True
            elif status == CLASS_INELIGIBLE:
                out[klass] = False
        elig: Dict[str, bool] = {}
        for tg_classes in self.task_groups.values():
            for klass, status in tg_classes.items():
                if status == CLASS_ELIGIBLE:
                    elig[klass] = True
                elif status == CLASS_INELIGIBLE and klass not in out:
                    out.setdefault(klass, False)
        out.update(elig)
        return out


class EvalContext:
    def __init__(
        self,
        state: "StateSnapshot",
        plan: Plan,
        seed: Optional[int] = None,
        speculative: bool = False,
    ) -> None:
        self.state = state
        self.plan = plan
        self._metric_seq = 0
        self.metrics = AllocMetric()
        self.eligibility = EvalEligibility()
        self.regex_cache: Dict = {}
        self.version_cache: Dict = {}
        self.rng = random.Random(seed)
        # speculative replay mode (BatchWorker optimistic parallel
        # replay): this context is pinned to a wave snapshot and runs
        # concurrently with other evals' replays, so stack paths whose
        # read set can't be conflict-checked per node (preemption
        # passthrough walks EVERY candidate) must deviate to the
        # serial path instead of answering from possibly-stale state
        self.speculative = speculative

    def reset(self) -> None:
        """Called between placements (reference context.go:116 Reset)."""
        self._metric_seq += 1
        self.metrics = AllocMetric(seq=self._metric_seq)

    def proposed_allocs(self, node_id: str) -> List[Allocation]:
        """(reference context.go:120 ProposedAllocs)"""
        proposed = self.state.allocs_by_node_terminal(node_id, False)

        update = self.plan.node_update.get(node_id)
        if update:
            drop = {a.id for a in update}
            proposed = [a for a in proposed if a.id not in drop]

        preempted = self.plan.node_preemptions.get(node_id)
        if preempted:
            drop = {a.id for a in preempted}
            proposed = [a for a in proposed if a.id not in drop]

        by_id = {a.id: a for a in proposed}
        for alloc in self.plan.node_allocation.get(node_id, ()):
            by_id[alloc.id] = alloc
        return list(by_id.values())


__all__ = [
    "EvalContext",
    "EvalEligibility",
    "CLASS_UNKNOWN",
    "CLASS_INELIGIBLE",
    "CLASS_ELIGIBLE",
    "CLASS_ESCAPED",
    "escaped_constraints",
]
