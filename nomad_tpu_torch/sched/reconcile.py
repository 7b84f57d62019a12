"""The allocation reconciler: desired-vs-actual diff for service/batch jobs
(reference scheduler/reconcile.go).

Given the job spec, existing allocations, tainted nodes and the active
deployment, computes the sets of placements, stops, in-place updates,
destructive updates, deployment mutations and delayed follow-up evals.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..structs import (
    ALLOC_CLIENT_STATUS_LOST,
    Allocation,
    Deployment,
    DEPLOYMENT_STATUS_CANCELLED,
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    DeploymentState,
    DeploymentStatusUpdate,
    DesiredUpdates,
    Evaluation,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_RETRY_FAILED_ALLOC,
    Job,
    Node,
    TaskGroup,
)
from .reconcile_util import (
    AllocDestructiveResult,
    AllocNameIndex,
    AllocPlaceResult,
    AllocStopResult,
    DelayedRescheduleInfo,
    delay_by_stop_after_client_disconnect,
    difference,
    filter_by_deployment,
    filter_by_rescheduleable,
    filter_by_tainted,
    filter_by_terminal,
    from_keys,
    name_order,
    new_alloc_matrix,
    union,
)

# status descriptions (reference scheduler/util.go + generic_sched.go)
ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_UPDATING = "alloc is being updated due to job update"
ALLOC_LOST = "alloc is lost since its node is down"
ALLOC_IN_PLACE = "alloc updating in-place"
ALLOC_NODE_TAINTED = "alloc not needed as node is tainted"
ALLOC_RESCHEDULED = "alloc was rescheduled because it failed"
BLOCKED_EVAL_MAX_PLAN_DESC = (
    "created due to placement conflicts"
)
BLOCKED_EVAL_FAILED_PLACEMENTS = (
    "created to place remaining allocations"
)
RESCHEDULING_FOLLOWUP_EVAL_DESC = (
    "created for delayed rescheduling"
)

BATCHED_FAILED_ALLOC_WINDOW_S = 5.0  # (reference reconcile.go:19)

# allocUpdateFn signature: (existing, new_job, new_tg) ->
#   (ignore, destructive, updated_alloc)
AllocUpdateFn = Callable[
    [Allocation, Job, TaskGroup],
    Tuple[bool, bool, Optional[Allocation]],
]


@dataclass
class ReconcileResults:
    """(reference reconcile.go:90 reconcileResults)"""

    deployment: Optional[Deployment] = None
    deployment_updates: List[DeploymentStatusUpdate] = field(
        default_factory=list
    )
    place: List[AllocPlaceResult] = field(default_factory=list)
    destructive_update: List[AllocDestructiveResult] = field(
        default_factory=list
    )
    inplace_update: List[Allocation] = field(default_factory=list)
    stop: List[AllocStopResult] = field(default_factory=list)
    attribute_updates: Dict[str, Allocation] = field(default_factory=dict)
    desired_tg_updates: Dict[str, DesiredUpdates] = field(
        default_factory=dict
    )
    desired_followup_evals: Dict[str, List[Evaluation]] = field(
        default_factory=dict
    )

    def changes(self) -> int:
        return len(self.place) + len(self.inplace_update) + len(self.stop)


class AllocReconciler:
    def __init__(
        self,
        alloc_update_fn: AllocUpdateFn,
        batch: bool,
        job_id: str,
        job: Optional[Job],
        deployment: Optional[Deployment],
        existing_allocs: List[Allocation],
        tainted_nodes: Dict[str, Optional[Node]],
        eval_id: str,
        now: Optional[float] = None,
    ) -> None:
        self.alloc_update_fn = alloc_update_fn
        self.batch = batch
        self.job_id = job_id
        self.job = job
        self.deployment = deployment
        self.old_deployment: Optional[Deployment] = None
        self.deployment_paused = False
        self.deployment_failed = False
        self.tainted_nodes = tainted_nodes
        self.existing_allocs = existing_allocs
        self.eval_id = eval_id
        self.now = now if now is not None else _time.time()
        self.result = ReconcileResults()

    # ------------------------------------------------------------------

    def compute(self) -> ReconcileResults:
        m = new_alloc_matrix(self.job, self.existing_allocs)
        self._cancel_deployments()

        if self.job is None or self.job.stopped():
            self._handle_stop(m)
            return self.result

        if self.deployment is not None:
            self.deployment_paused = (
                self.deployment.status == DEPLOYMENT_STATUS_PAUSED
            )
            self.deployment_failed = (
                self.deployment.status == DEPLOYMENT_STATUS_FAILED
            )

        complete = True
        for group, allocs in m.items():
            group_complete = self._compute_group(group, allocs)
            complete = complete and group_complete

        if self.deployment is not None and complete:
            self.result.deployment_updates.append(
                DeploymentStatusUpdate(
                    deployment_id=self.deployment.id,
                    status=DEPLOYMENT_STATUS_SUCCESSFUL,
                    status_description="Deployment completed successfully",
                )
            )

        d = self.result.deployment
        if d is not None and d.requires_promotion():
            if d.has_auto_promote():
                d.status_description = (
                    "Deployment is running pending automatic promotion"
                )
            else:
                d.status_description = (
                    "Deployment is running but requires promotion"
                )
        return self.result

    # ------------------------------------------------------------------

    def _cancel_deployments(self) -> None:
        if self.job is None or self.job.stopped():
            if self.deployment is not None and self.deployment.active():
                self.result.deployment_updates.append(
                    DeploymentStatusUpdate(
                        deployment_id=self.deployment.id,
                        status=DEPLOYMENT_STATUS_CANCELLED,
                        status_description=(
                            "Cancelled because job is stopped"
                        ),
                    )
                )
            self.old_deployment = self.deployment
            self.deployment = None
            return

        d = self.deployment
        if d is None:
            return
        if (
            d.job_create_index != self.job.create_index
            or d.job_version != self.job.version
        ):
            if d.active():
                self.result.deployment_updates.append(
                    DeploymentStatusUpdate(
                        deployment_id=d.id,
                        status=DEPLOYMENT_STATUS_CANCELLED,
                        status_description=(
                            "Cancelled due to newer version of job"
                        ),
                    )
                )
            self.old_deployment = d
            self.deployment = None
        elif d.status == DEPLOYMENT_STATUS_SUCCESSFUL:
            self.old_deployment = d
            self.deployment = None

    def _handle_stop(self, m: Dict[str, Dict[str, Allocation]]) -> None:
        for group, allocs in m.items():
            allocs = filter_by_terminal(allocs)
            untainted, migrate, lost = filter_by_tainted(
                allocs, self.tainted_nodes
            )
            self._mark_stop(untainted, "", ALLOC_NOT_NEEDED)
            self._mark_stop(migrate, "", ALLOC_NOT_NEEDED)
            self._mark_stop(lost, ALLOC_CLIENT_STATUS_LOST, ALLOC_LOST)
            desired = DesiredUpdates(stop=len(allocs))
            self.result.desired_tg_updates[group] = desired

    def _mark_stop(
        self,
        allocs: Dict[str, Allocation],
        client_status: str,
        description: str,
    ) -> None:
        for alloc in allocs.values():
            self.result.stop.append(
                AllocStopResult(
                    alloc=alloc,
                    client_status=client_status,
                    status_description=description,
                )
            )

    def _mark_delayed(
        self,
        allocs: Dict[str, Allocation],
        client_status: str,
        description: str,
        followup_evals: Dict[str, str],
    ) -> None:
        for alloc in allocs.values():
            self.result.stop.append(
                AllocStopResult(
                    alloc=alloc,
                    client_status=client_status,
                    status_description=description,
                    followup_eval_id=followup_evals.get(alloc.id, ""),
                )
            )

    # ------------------------------------------------------------------

    def _compute_group(
        self, group: str, all_allocs: Dict[str, Allocation]
    ) -> bool:
        desired = DesiredUpdates()
        self.result.desired_tg_updates[group] = desired

        tg = self.job.lookup_task_group(group)
        if tg is None:
            untainted, migrate, lost = filter_by_tainted(
                all_allocs, self.tainted_nodes
            )
            self._mark_stop(untainted, "", ALLOC_NOT_NEEDED)
            self._mark_stop(migrate, "", ALLOC_NOT_NEEDED)
            self._mark_stop(lost, ALLOC_CLIENT_STATUS_LOST, ALLOC_LOST)
            desired.stop = len(untainted) + len(migrate) + len(lost)
            return True

        dstate: Optional[DeploymentState] = None
        existing_deployment = False
        if self.deployment is not None:
            dstate = self.deployment.task_groups.get(group)
            existing_deployment = dstate is not None
        if not existing_deployment:
            dstate = DeploymentState()
            if tg.update is not None and not tg.update.is_empty():
                dstate.auto_revert = tg.update.auto_revert
                dstate.auto_promote = tg.update.auto_promote
                dstate.progress_deadline_s = tg.update.progress_deadline_s

        all_allocs, ignore = self._filter_old_terminal_allocs(all_allocs)
        desired.ignore += len(ignore)

        canaries, all_allocs = self._handle_group_canaries(
            all_allocs, desired
        )

        untainted, migrate, lost = filter_by_tainted(
            all_allocs, self.tainted_nodes
        )

        untainted, reschedule_now, reschedule_later = (
            filter_by_rescheduleable(
                untainted, self.batch, self.now, self.eval_id,
                self.deployment,
            )
        )

        lost_later = delay_by_stop_after_client_disconnect(lost)
        lost_later_evals = self._handle_delayed_lost(
            lost_later, all_allocs, tg.name
        )

        self._handle_delayed_reschedules(
            reschedule_later, all_allocs, tg.name
        )

        name_index = AllocNameIndex(
            self.job_id, group, tg.count,
            union(untainted, migrate, reschedule_now),
        )

        canary_state = (
            dstate is not None
            and dstate.desired_canaries != 0
            and not dstate.promoted
        )
        stop = self._compute_stop(
            tg, name_index, untainted, migrate, lost, canaries,
            canary_state, lost_later_evals,
        )
        desired.stop += len(stop)
        untainted = difference(untainted, stop)

        ignore_set, inplace, destructive = self._compute_updates(
            tg, untainted
        )
        desired.ignore += len(ignore_set)
        desired.in_place_update += len(inplace)
        if not existing_deployment:
            dstate.desired_total += len(destructive) + len(inplace)

        if canary_state:
            untainted = difference(untainted, canaries)

        strategy = tg.update
        canaries_promoted = dstate is not None and dstate.promoted
        require_canary = (
            len(destructive) != 0
            and strategy is not None
            and len(canaries) < strategy.canary
            and not canaries_promoted
        )
        if require_canary:
            dstate.desired_canaries = strategy.canary
        if (
            require_canary
            and not self.deployment_paused
            and not self.deployment_failed
        ):
            number = strategy.canary - len(canaries)
            desired.canary += number
            for name in name_index.next_canaries(
                number, canaries, destructive
            ):
                self.result.place.append(
                    AllocPlaceResult(
                        name=name, canary=True, task_group=tg
                    )
                )

        canary_state = (
            dstate is not None
            and dstate.desired_canaries != 0
            and not dstate.promoted
        )
        limit = self._compute_limit(
            tg, untainted, destructive, migrate, canary_state
        )

        place: List[AllocPlaceResult] = []
        if not lost_later:
            place = self._compute_placements(
                tg, name_index, untainted, migrate, reschedule_now,
                canary_state,
            )
            if not existing_deployment:
                dstate.desired_total += len(place)

        deployment_place_ready = (
            not self.deployment_paused
            and not self.deployment_failed
            and not canary_state
        )

        if deployment_place_ready:
            desired.place += len(place)
            self.result.place.extend(place)
            self._mark_stop(reschedule_now, "", ALLOC_RESCHEDULED)
            desired.stop += len(reschedule_now)
            limit -= min(len(place), limit)
        else:
            if lost:
                allowed = min(len(lost), len(place))
                desired.place += allowed
                self.result.place.extend(place[:allowed])
            if reschedule_now:
                for p in place:
                    prev = p.previous_alloc
                    if p.is_rescheduling() and not (
                        self.deployment_failed
                        and prev is not None
                        and self.deployment is not None
                        and self.deployment.id == prev.deployment_id
                    ):
                        self.result.place.append(p)
                        desired.place += 1
                        self.result.stop.append(
                            AllocStopResult(
                                alloc=prev,
                                status_description=ALLOC_RESCHEDULED,
                            )
                        )
                        desired.stop += 1

        if deployment_place_ready:
            n = min(len(destructive), limit)
            desired.destructive_update += n
            desired.ignore += len(destructive) - n
            for alloc in name_order(destructive)[:n]:
                self.result.destructive_update.append(
                    AllocDestructiveResult(
                        place_name=alloc.name,
                        place_task_group=tg,
                        stop_alloc=alloc,
                        stop_status_description=ALLOC_UPDATING,
                    )
                )
        else:
            desired.ignore += len(destructive)

        desired.migrate += len(migrate)
        for alloc in name_order(migrate):
            is_canary = (
                alloc.deployment_status is not None
                and alloc.deployment_status.canary
            )
            self.result.stop.append(
                AllocStopResult(
                    alloc=alloc, status_description=ALLOC_MIGRATING
                )
            )
            self.result.place.append(
                AllocPlaceResult(
                    name=alloc.name,
                    canary=is_canary,
                    task_group=tg,
                    previous_alloc=alloc,
                    downgrade_non_canary=canary_state and not is_canary,
                    min_job_version=(
                        alloc.job.version if alloc.job else 0
                    ),
                )
            )

        # deployment creation (reference reconcile.go:545)
        updating_spec = bool(destructive) or bool(
            self.result.inplace_update
        )
        had_running = any(
            alloc.job is not None
            and alloc.job.version == self.job.version
            and alloc.job.create_index == self.job.create_index
            for alloc in all_allocs.values()
        )
        if (
            not existing_deployment
            and strategy is not None
            and not strategy.is_empty()
            and dstate.desired_total != 0
            and (not had_running or updating_spec)
        ):
            if self.deployment is None:
                self.deployment = Deployment(
                    namespace=self.job.namespace,
                    job_id=self.job.id,
                    job_version=self.job.version,
                    job_modify_index=self.job.modify_index,
                    job_create_index=self.job.create_index,
                    status=DEPLOYMENT_STATUS_RUNNING,
                )
                self.result.deployment = self.deployment
            self.deployment.task_groups[group] = dstate

        deployment_complete = (
            len(destructive)
            + len(inplace)
            + len(place)
            + len(migrate)
            + len(reschedule_now)
            + len(reschedule_later)
            == 0
            and not require_canary
        )
        if deployment_complete and self.deployment is not None:
            ds = self.deployment.task_groups.get(group)
            if ds is not None:
                if ds.healthy_allocs < max(
                    ds.desired_total, ds.desired_canaries
                ) or (ds.desired_canaries > 0 and not ds.promoted):
                    deployment_complete = False
        return deployment_complete

    # ------------------------------------------------------------------

    def _filter_old_terminal_allocs(
        self, all_allocs: Dict[str, Allocation]
    ) -> Tuple[Dict[str, Allocation], Dict[str, Allocation]]:
        if not self.batch:
            return all_allocs, {}
        filtered = dict(all_allocs)
        ignored: Dict[str, Allocation] = {}
        for aid, alloc in list(filtered.items()):
            older = alloc.job is not None and (
                alloc.job.version < self.job.version
                or alloc.job.create_index < self.job.create_index
            )
            if older and alloc.terminal_status():
                del filtered[aid]
                ignored[aid] = alloc
        return filtered, ignored

    def _handle_group_canaries(
        self,
        all_allocs: Dict[str, Allocation],
        desired: DesiredUpdates,
    ) -> Tuple[Dict[str, Allocation], Dict[str, Allocation]]:
        stop_ids: List[str] = []
        if self.old_deployment is not None:
            for ds in self.old_deployment.task_groups.values():
                if not ds.promoted:
                    stop_ids.extend(ds.placed_canaries)
        if (
            self.deployment is not None
            and self.deployment.status == DEPLOYMENT_STATUS_FAILED
        ):
            for ds in self.deployment.task_groups.values():
                if not ds.promoted:
                    stop_ids.extend(ds.placed_canaries)

        stop_set = from_keys(all_allocs, stop_ids)
        self._mark_stop(stop_set, "", ALLOC_NOT_NEEDED)
        desired.stop += len(stop_set)
        all_allocs = difference(all_allocs, stop_set)

        canaries: Dict[str, Allocation] = {}
        if self.deployment is not None:
            canary_ids: List[str] = []
            for ds in self.deployment.task_groups.values():
                canary_ids.extend(ds.placed_canaries)
            canaries = from_keys(all_allocs, canary_ids)
            untainted, migrate, lost = filter_by_tainted(
                canaries, self.tainted_nodes
            )
            self._mark_stop(migrate, "", ALLOC_MIGRATING)
            self._mark_stop(lost, ALLOC_CLIENT_STATUS_LOST, ALLOC_LOST)
            canaries = untainted
            all_allocs = difference(all_allocs, migrate, lost)
        return canaries, all_allocs

    def _compute_limit(
        self,
        tg: TaskGroup,
        untainted: Dict[str, Allocation],
        destructive: Dict[str, Allocation],
        migrate: Dict[str, Allocation],
        canary_state: bool,
    ) -> int:
        """(reference reconcile.go:668 computeLimit)"""
        if (
            tg.update is None
            or tg.update.is_empty()
            or len(destructive) + len(migrate) == 0
        ):
            return tg.count
        if self.deployment_paused or self.deployment_failed:
            return 0
        if canary_state:
            return 0
        limit = tg.update.max_parallel
        if self.deployment is not None:
            part_of, _ = filter_by_deployment(
                untainted, self.deployment.id
            )
            for alloc in part_of.values():
                if (
                    alloc.deployment_status is not None
                    and alloc.deployment_status.is_unhealthy()
                ):
                    return 0
                if (
                    alloc.deployment_status is None
                    or not alloc.deployment_status.is_healthy()
                ):
                    limit -= 1
        return max(0, limit)

    def _compute_placements(
        self,
        tg: TaskGroup,
        name_index: AllocNameIndex,
        untainted: Dict[str, Allocation],
        migrate: Dict[str, Allocation],
        reschedule: Dict[str, Allocation],
        canary_state: bool,
    ) -> List[AllocPlaceResult]:
        place: List[AllocPlaceResult] = []
        for alloc in reschedule.values():
            is_canary = (
                alloc.deployment_status is not None
                and alloc.deployment_status.canary
            )
            place.append(
                AllocPlaceResult(
                    name=alloc.name,
                    task_group=tg,
                    previous_alloc=alloc,
                    reschedule=True,
                    canary=is_canary,
                    downgrade_non_canary=canary_state and not is_canary,
                    min_job_version=(
                        alloc.job.version if alloc.job else 0
                    ),
                )
            )
        existing = len(untainted) + len(migrate) + len(reschedule)
        if existing < tg.count:
            for name in name_index.next(tg.count - existing):
                place.append(
                    AllocPlaceResult(
                        name=name,
                        task_group=tg,
                        downgrade_non_canary=canary_state,
                    )
                )
        return place

    def _compute_stop(
        self,
        tg: TaskGroup,
        name_index: AllocNameIndex,
        untainted: Dict[str, Allocation],
        migrate: Dict[str, Allocation],
        lost: Dict[str, Allocation],
        canaries: Dict[str, Allocation],
        canary_state: bool,
        followup_evals: Dict[str, str],
    ) -> Dict[str, Allocation]:
        stop: Dict[str, Allocation] = dict(lost)
        self._mark_delayed(
            lost, ALLOC_CLIENT_STATUS_LOST, ALLOC_LOST, followup_evals
        )

        if canary_state:
            untainted = difference(untainted, canaries)

        remove = len(untainted) + len(migrate) - tg.count
        if remove <= 0:
            return stop

        untainted = filter_by_terminal(untainted)

        if not canary_state and canaries:
            canary_names = {a.name for a in canaries.values()}
            for aid, alloc in list(
                difference(untainted, canaries).items()
            ):
                if alloc.name in canary_names:
                    stop[aid] = alloc
                    self.result.stop.append(
                        AllocStopResult(
                            alloc=alloc,
                            status_description=ALLOC_NOT_NEEDED,
                        )
                    )
                    del untainted[aid]
                    remove -= 1
                    if remove == 0:
                        return stop

        if migrate:
            migrate_index = AllocNameIndex(
                self.job_id, tg.name, tg.count, migrate
            )
            remove_names = migrate_index.highest(remove)
            for aid, alloc in list(migrate.items()):
                if alloc.name not in remove_names:
                    continue
                self.result.stop.append(
                    AllocStopResult(
                        alloc=alloc,
                        status_description=ALLOC_NOT_NEEDED,
                    )
                )
                del migrate[aid]
                stop[aid] = alloc
                name_index.unset_index(alloc.index())
                remove -= 1
                if remove == 0:
                    return stop

        remove_names = name_index.highest(remove)
        for aid, alloc in list(untainted.items()):
            if alloc.name in remove_names:
                stop[aid] = alloc
                self.result.stop.append(
                    AllocStopResult(
                        alloc=alloc,
                        status_description=ALLOC_NOT_NEEDED,
                    )
                )
                del untainted[aid]
                remove -= 1
                if remove == 0:
                    return stop

        for aid, alloc in list(untainted.items()):
            stop[aid] = alloc
            self.result.stop.append(
                AllocStopResult(
                    alloc=alloc, status_description=ALLOC_NOT_NEEDED
                )
            )
            del untainted[aid]
            remove -= 1
            if remove == 0:
                return stop
        return stop

    def _compute_updates(
        self, tg: TaskGroup, untainted: Dict[str, Allocation]
    ) -> Tuple[
        Dict[str, Allocation],
        Dict[str, Allocation],
        Dict[str, Allocation],
    ]:
        ignore: Dict[str, Allocation] = {}
        inplace: Dict[str, Allocation] = {}
        destructive: Dict[str, Allocation] = {}
        for alloc in untainted.values():
            ignore_change, destructive_change, updated = (
                self.alloc_update_fn(alloc, self.job, tg)
            )
            if ignore_change:
                ignore[alloc.id] = alloc
            elif destructive_change:
                destructive[alloc.id] = alloc
            else:
                inplace[alloc.id] = alloc
                if updated is not None:
                    self.result.inplace_update.append(updated)
        return ignore, inplace, destructive

    # ------------------------------------------------------------------

    def _handle_delayed_reschedules(
        self,
        reschedule_later: List[DelayedRescheduleInfo],
        all_allocs: Dict[str, Allocation],
        tg_name: str,
    ) -> None:
        mapping = self._handle_delayed_lost(
            reschedule_later, all_allocs, tg_name
        )
        for alloc_id, eval_id in mapping.items():
            existing = all_allocs.get(alloc_id)
            if existing is None:
                continue
            from dataclasses import replace as _replace

            updated = _replace(existing)
            updated.followup_eval_id = eval_id
            self.result.attribute_updates[updated.id] = updated

    def _handle_delayed_lost(
        self,
        reschedule_later: List[DelayedRescheduleInfo],
        all_allocs: Dict[str, Allocation],
        tg_name: str,
    ) -> Dict[str, str]:
        """Batch delayed reschedules into follow-up evals within a 5s
        window (reference reconcile.go:869 handleDelayedLost)."""
        if not reschedule_later:
            return {}
        reschedule_later = sorted(
            reschedule_later, key=lambda i: i.reschedule_time
        )
        evals: List[Evaluation] = []
        next_time = reschedule_later[0].reschedule_time
        mapping: Dict[str, str] = {}
        ev = Evaluation(
            namespace=self.job.namespace,
            priority=self.job.priority,
            type=self.job.type,
            triggered_by=EVAL_TRIGGER_RETRY_FAILED_ALLOC,
            job_id=self.job.id,
            job_modify_index=self.job.modify_index,
            status=EVAL_STATUS_PENDING,
            status_description=RESCHEDULING_FOLLOWUP_EVAL_DESC,
            wait_until=next_time,
        )
        evals.append(ev)
        for info in reschedule_later:
            if info.reschedule_time - next_time < (
                BATCHED_FAILED_ALLOC_WINDOW_S
            ):
                mapping[info.alloc_id] = ev.id
            else:
                next_time = info.reschedule_time
                ev = Evaluation(
                    namespace=self.job.namespace,
                    priority=self.job.priority,
                    type=self.job.type,
                    triggered_by=EVAL_TRIGGER_RETRY_FAILED_ALLOC,
                    job_id=self.job.id,
                    job_modify_index=self.job.modify_index,
                    status=EVAL_STATUS_PENDING,
                    wait_until=next_time,
                )
                evals.append(ev)
                mapping[info.alloc_id] = ev.id
        self.result.desired_followup_evals[tg_name] = evals
        return mapping
