"""Allocation set algebra for the reconciler
(reference scheduler/reconcile_util.go).
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..structs import (
    ALLOC_CLIENT_STATUS_COMPLETE,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_LOST,
    ALLOC_DESIRED_EVICT,
    ALLOC_DESIRED_STOP,
    Allocation,
    Deployment,
    Job,
    Node,
    TaskGroup,
    alloc_name,
)

# AllocSet: dict alloc_id -> Allocation


@dataclass
class AllocStopResult:
    alloc: Allocation
    client_status: str = ""
    status_description: str = ""
    followup_eval_id: str = ""


@dataclass
class AllocPlaceResult:
    name: str = ""
    canary: bool = False
    task_group: Optional[TaskGroup] = None
    previous_alloc: Optional[Allocation] = None
    reschedule: bool = False
    downgrade_non_canary: bool = False
    min_job_version: int = 0

    def stop_previous_alloc(self) -> Tuple[bool, str]:
        return False, ""

    def is_rescheduling(self) -> bool:
        return self.reschedule


@dataclass
class AllocDestructiveResult:
    place_name: str = ""
    place_task_group: Optional[TaskGroup] = None
    stop_alloc: Optional[Allocation] = None
    stop_status_description: str = ""

    @property
    def name(self) -> str:
        return self.place_name

    @property
    def task_group(self) -> Optional[TaskGroup]:
        return self.place_task_group

    @property
    def previous_alloc(self) -> Optional[Allocation]:
        return self.stop_alloc

    @property
    def canary(self) -> bool:
        return False

    def stop_previous_alloc(self) -> Tuple[bool, str]:
        return True, self.stop_status_description

    def is_rescheduling(self) -> bool:
        return False


@dataclass
class DelayedRescheduleInfo:
    alloc_id: str
    alloc: Allocation
    reschedule_time: float


def new_alloc_matrix(
    job: Optional[Job], allocs: List[Allocation]
) -> Dict[str, Dict[str, Allocation]]:
    """Group -> {alloc id -> alloc}, in CANONICAL group order: the
    job's task_group order first, then orphaned groups sorted by name.
    The reference iterates this matrix in Go map order (random), which
    makes multi-group placement order — and, because the stack's walk
    offset persists across groups, placement OUTCOMES — nondeterministic
    across runs.  A deterministic order is required for this build's
    bit-identity contract (sequential vs batched paths, and test
    reproducibility across servers whose alloc ids differ)."""
    m: Dict[str, Dict[str, Allocation]] = {}
    if job is not None:
        for tg in job.task_groups:
            m.setdefault(tg.name, {})
    for alloc in sorted(allocs, key=lambda a: a.id):
        m.setdefault(alloc.task_group, {})[alloc.id] = alloc
    # orphaned groups (allocs of groups no longer in the job) were
    # appended in sorted-alloc order above; re-key them into name
    # order for full determinism
    if job is not None:
        job_names = [tg.name for tg in job.task_groups]
        orphans = sorted(
            name for name in m if name not in job_names
        )
        if orphans:
            m = {
                **{n: m[n] for n in job_names},
                **{n: m[n] for n in orphans},
            }
    return m


def name_order(allocs: Dict[str, Allocation]) -> List[Allocation]:
    return sorted(allocs.values(), key=lambda a: a.index())


def difference(
    a: Dict[str, Allocation], *others: Dict[str, Allocation]
) -> Dict[str, Allocation]:
    out = {}
    for k, v in a.items():
        if any(k in other for other in others):
            continue
        out[k] = v
    return out


def union(*sets: Dict[str, Allocation]) -> Dict[str, Allocation]:
    out: Dict[str, Allocation] = {}
    for s in sets:
        out.update(s)
    return out


def from_keys(
    a: Dict[str, Allocation], keys: List[str]
) -> Dict[str, Allocation]:
    return {k: a[k] for k in keys if k in a}


def filter_by_terminal(
    a: Dict[str, Allocation]
) -> Dict[str, Allocation]:
    return {k: v for k, v in a.items() if not v.terminal_status()}


def filter_by_tainted(
    a: Dict[str, Allocation], tainted: Dict[str, Optional[Node]]
) -> Tuple[
    Dict[str, Allocation], Dict[str, Allocation], Dict[str, Allocation]
]:
    """(untainted, migrate, lost)
    (reference reconcile_util.go:filterByTainted)."""
    untainted: Dict[str, Allocation] = {}
    migrate: Dict[str, Allocation] = {}
    lost: Dict[str, Allocation] = {}
    for alloc in a.values():
        if alloc.terminal_status():
            untainted[alloc.id] = alloc
            continue
        if alloc.desired_transition.should_migrate():
            migrate[alloc.id] = alloc
            continue
        if alloc.node_id not in tainted:
            untainted[alloc.id] = alloc
            continue
        node = tainted[alloc.node_id]
        if node is None or node.terminal_status():
            lost[alloc.id] = alloc
            continue
        untainted[alloc.id] = alloc
    return untainted, migrate, lost


def should_filter(alloc: Allocation, is_batch: bool) -> Tuple[bool, bool]:
    """(untainted, ignore) (reference reconcile_util.go:shouldFilter)."""
    if is_batch:
        if alloc.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            if alloc.ran_successfully():
                return True, False
            return False, True
        if alloc.client_status != ALLOC_CLIENT_STATUS_FAILED:
            return True, False
        return False, False

    if alloc.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
        return False, True
    if alloc.client_status in (
        ALLOC_CLIENT_STATUS_COMPLETE,
        ALLOC_CLIENT_STATUS_LOST,
    ):
        return False, True
    return False, False


RESCHEDULE_WINDOW_S = 1.0  # (reference reconcile.go:24)


def update_by_reschedulable(
    alloc: Allocation,
    now: float,
    eval_id: str,
    deployment: Optional[Deployment],
) -> Tuple[bool, bool, float]:
    """(reschedule_now, reschedule_later, reschedule_time)
    (reference reconcile_util.go:updateByReschedulable)."""
    if (
        deployment is not None
        and alloc.deployment_id == deployment.id
        and deployment.active()
        and not bool(alloc.desired_transition.reschedule)
    ):
        return False, False, 0.0

    reschedule_now = False
    if alloc.desired_transition.should_force_reschedule():
        reschedule_now = True

    reschedule_time, eligible = alloc.next_reschedule_time()
    if eligible and (
        alloc.followup_eval_id == eval_id
        or reschedule_time - now <= RESCHEDULE_WINDOW_S
    ):
        return True, False, reschedule_time
    if eligible and not alloc.followup_eval_id:
        return reschedule_now, True, reschedule_time
    return reschedule_now, False, reschedule_time


def filter_by_rescheduleable(
    a: Dict[str, Allocation],
    is_batch: bool,
    now: float,
    eval_id: str,
    deployment: Optional[Deployment],
) -> Tuple[
    Dict[str, Allocation],
    Dict[str, Allocation],
    List[DelayedRescheduleInfo],
]:
    """(untainted, reschedule_now, reschedule_later)."""
    untainted: Dict[str, Allocation] = {}
    reschedule_now: Dict[str, Allocation] = {}
    reschedule_later: List[DelayedRescheduleInfo] = []

    for alloc in a.values():
        if alloc.next_allocation and alloc.terminal_status():
            continue
        is_untainted, ignore = should_filter(alloc, is_batch)
        if is_untainted:
            untainted[alloc.id] = alloc
        if is_untainted or ignore:
            continue
        now_eligible, later_eligible, when = update_by_reschedulable(
            alloc, now, eval_id, deployment
        )
        if not now_eligible:
            untainted[alloc.id] = alloc
            if later_eligible:
                reschedule_later.append(
                    DelayedRescheduleInfo(alloc.id, alloc, when)
                )
        else:
            reschedule_now[alloc.id] = alloc
    return untainted, reschedule_now, reschedule_later


def filter_by_deployment(
    a: Dict[str, Allocation], deployment_id: str
) -> Tuple[Dict[str, Allocation], Dict[str, Allocation]]:
    match = {
        k: v for k, v in a.items() if v.deployment_id == deployment_id
    }
    nonmatch = {
        k: v for k, v in a.items() if v.deployment_id != deployment_id
    }
    return match, nonmatch


def delay_by_stop_after_client_disconnect(
    a: Dict[str, Allocation]
) -> List[DelayedRescheduleInfo]:
    now = _time.time()
    later = []
    for alloc in a.values():
        if not alloc.should_client_stop():
            continue
        t = alloc.wait_client_stop()
        if t > now:
            later.append(DelayedRescheduleInfo(alloc.id, alloc, t))
    return later


class AllocNameIndex:
    """Index-based alloc name chooser
    (reference reconcile_util.go:allocNameIndex, backed by a bitmap there;
    a Python set of used indexes has the same semantics)."""

    def __init__(
        self, job_id: str, task_group: str, count: int,
        existing: Dict[str, Allocation],
    ) -> None:
        self.job_id = job_id
        self.task_group = task_group
        self.count = count
        self.used: Set[int] = set()
        for alloc in existing.values():
            idx = alloc.index()
            if idx >= 0:
                self.used.add(idx)

    def _name(self, idx: int) -> str:
        return alloc_name(self.job_id, self.task_group, idx)

    def highest(self, n: int) -> Set[str]:
        out: Set[str] = set()
        for idx in sorted(self.used, reverse=True):
            if len(out) >= n:
                break
            self.used.discard(idx)
            out.add(self._name(idx))
        return out

    def unset_index(self, idx: int) -> None:
        self.used.discard(idx)

    def next(self, n: int) -> List[str]:
        out: List[str] = []
        for idx in range(self.count):
            if len(out) == n:
                return out
            if idx not in self.used:
                out.append(self._name(idx))
                self.used.add(idx)
        i = 0
        while len(out) < n:
            out.append(self._name(i))
            self.used.add(i)
            i += 1
        return out

    def next_canaries(
        self,
        n: int,
        existing: Dict[str, Allocation],
        destructive: Dict[str, Allocation],
    ) -> List[str]:
        next_names: List[str] = []
        existing_names = {a.name for a in existing.values()}

        destructive_idx = {
            a.index() for a in destructive.values() if a.index() >= 0
        }
        for idx in range(self.count):
            if idx in destructive_idx:
                name = self._name(idx)
                if name not in existing_names:
                    next_names.append(name)
                    self.used.add(idx)
                    if len(next_names) == n:
                        return next_names
        for idx in range(self.count):
            if idx not in self.used:
                name = self._name(idx)
                if name not in existing_names:
                    next_names.append(name)
                    self.used.add(idx)
                    if len(next_names) == n:
                        return next_names
        i = self.count
        while len(next_names) < n:
            next_names.append(self._name(i))
            i += 1
        return next_names
