"""Generic (service/batch) scheduler (reference scheduler/generic_sched.go).

`Process(eval)` runs the retry loop (5 service / 2 batch attempts),
reconciles desired vs actual state, computes placements through a Stack —
either the oracle iterator chain or the CUDA device stack — and submits
the plan, creating blocked/follow-up evals on failure.
"""
from __future__ import annotations

import time as _time
from dataclasses import replace as _replace
from typing import Dict, List, Optional

from ..structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_RUN,
    AllocatedResources,
    AllocatedSharedResources,
    Allocation,
    AllocMetric,
    Evaluation,
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_COMPLETE,
    EVAL_TRIGGER_MAX_PLANS,
    JOB_TYPE_BATCH,
    Job,
    Node,
    Plan,
    PlanResult,
    RescheduleEvent,
    RescheduleTracker,
    TaskGroup,
)
from ..device import resolve_device
from .context import EvalContext
from .reconcile import (
    AllocReconciler,
    BLOCKED_EVAL_FAILED_PLACEMENTS,
    BLOCKED_EVAL_MAX_PLAN_DESC,
)
from .scheduler import SetStatusError
from .stack import GenericStack, SelectOptions
from .util import (
    adjust_queued_allocations,
    generic_alloc_update_fn,
    progress_made,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2
MAX_PAST_RESCHEDULE_EVENTS = 5

SUPPORTED_TRIGGERS = {
    "job-register",
    "job-deregister",
    "node-drain",
    "node-update",
    "alloc-stop",
    "rolling-update",
    "queued-allocs",
    "periodic-job",
    "max-plan-attempts",
    "deployment-watcher",
    "alloc-failure",
    "failed-follow-up",
    "preemption",
    "job-scaling",
}


class GenericScheduler:
    def __init__(
        self, state, planner, batch: bool, use_device: bool = True,
        seed: Optional[int] = None, speculative: bool = False,
        device=None,
    ) -> None:
        self.state = state
        self.planner = planner
        self.batch = batch
        self.seed = seed
        # snapshot-pinned, side-effect-free replay mode: `state` is an
        # immutable wave snapshot and `planner` a capturing facade (the
        # BatchWorker's speculative planner) — the flag flows into the
        # EvalContext so stacks can refuse paths that read beyond the
        # conflict-checkable set
        self.speculative = speculative
        # the device stack runs on `device` (None = the CUDA card, which
        # must exist; "cpu" = the plain twins).  Resolved up front so a
        # missing card fails at construction, not mid-eval
        self.use_device = use_device
        self.device = resolve_device(device) if use_device else None

        self.eval: Optional[Evaluation] = None
        self.job: Optional[Job] = None
        self.plan: Optional[Plan] = None
        self.plan_result: Optional[PlanResult] = None
        self.ctx: Optional[EvalContext] = None
        self.stack = None
        self.deployment = None
        self.blocked: Optional[Evaluation] = None
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}
        self.queued_allocs: Dict[str, int] = {}
        self.followup_evals: List[Evaluation] = []

    # ------------------------------------------------------------------

    def process(self, evaluation: Evaluation) -> None:
        self.eval = evaluation
        if evaluation.triggered_by not in SUPPORTED_TRIGGERS:
            desc = (
                f"scheduler cannot handle '{evaluation.triggered_by}' "
                "evaluation reason"
            )
            set_status(
                self.planner, evaluation, None, self.blocked,
                self.failed_tg_allocs, "failed", desc,
                self.queued_allocs, self._deployment_id(),
            )
            return

        limit = (
            MAX_BATCH_SCHEDULE_ATTEMPTS
            if self.batch
            else MAX_SERVICE_SCHEDULE_ATTEMPTS
        )
        try:
            retry_max(
                limit,
                self._process_once,
                lambda: progress_made(self.plan_result),
            )
        except SetStatusError as err:
            # no forward progress: block to retry when resources free up
            self._create_blocked_eval(plan_failure=True)
            set_status(
                self.planner, self.eval, None, self.blocked,
                self.failed_tg_allocs, err.eval_status, str(err),
                self.queued_allocs, self._deployment_id(),
            )
            return

        if (
            self.eval.status == EVAL_STATUS_BLOCKED
            and self.failed_tg_allocs
        ):
            e = self.ctx.eligibility
            new_eval = _replace(self.eval)
            new_eval.escaped_computed_class = e.has_escaped()
            new_eval.class_eligibility = e.get_classes()
            new_eval.quota_limit_reached = e.quota_reached
            self.planner.reblock_eval(new_eval)
            return

        set_status(
            self.planner, self.eval, None, self.blocked,
            self.failed_tg_allocs, EVAL_STATUS_COMPLETE, "",
            self.queued_allocs, self._deployment_id(),
        )

    def _deployment_id(self) -> str:
        return self.deployment.id if self.deployment is not None else ""

    def _create_blocked_eval(self, plan_failure: bool) -> None:
        e = self.ctx.eligibility if self.ctx is not None else None
        escaped = e.has_escaped() if e else False
        class_eligibility = {}
        if e and not escaped:
            class_eligibility = e.get_classes()
        self.blocked = self.eval.create_blocked_eval(
            class_eligibility, escaped, e.quota_reached if e else ""
        )
        if plan_failure:
            self.blocked.triggered_by = EVAL_TRIGGER_MAX_PLANS
            self.blocked.status_description = BLOCKED_EVAL_MAX_PLAN_DESC
        else:
            self.blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS
        self.planner.create_eval(self.blocked)

    # ------------------------------------------------------------------

    def _process_once(self) -> bool:
        """(reference generic_sched.go:216 process)"""
        self.job = self.state.job_by_id(
            self.eval.namespace, self.eval.job_id
        )
        self.queued_allocs = {}
        self.followup_evals = []

        self.plan = self.eval.make_plan(self.job)

        if not self.batch:
            self.deployment = self.state.latest_deployment_by_job(
                self.eval.namespace, self.eval.job_id
            )

        self.failed_tg_allocs = {}
        self.ctx = EvalContext(
            self.state, self.plan, seed=self.seed,
            speculative=self.speculative,
        )
        self.stack = self._make_stack()
        if self.job is not None and not self.job.stopped():
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        delay_instead = (
            bool(self.followup_evals) and self.eval.wait_until == 0.0
        )

        if (
            self.eval.status != EVAL_STATUS_BLOCKED
            and self.failed_tg_allocs
            and self.blocked is None
            and not delay_instead
        ):
            self._create_blocked_eval(plan_failure=False)

        if self.plan.is_no_op() and not self.eval.annotate_plan:
            return True

        if delay_instead:
            for followup in self.followup_evals:
                followup.previous_eval = self.eval.id
                self.planner.create_eval(followup)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(result, self.queued_allocs)

        if new_state is not None:
            self.state = new_state
            return False

        full_commit, _expected, _actual = result.full_commit(self.plan)
        if not full_commit:
            return False
        return True

    def _make_stack(self):
        if self.use_device:
            from .cuda_stack import CudaGenericStack

            return CudaGenericStack(self.batch, self.ctx, self.device)
        return GenericStack(self.batch, self.ctx)

    # ------------------------------------------------------------------

    def _compute_job_allocs(self) -> None:
        """(reference generic_sched.go:332 computeJobAllocs)"""
        allocs = self.state.allocs_by_job(
            self.eval.namespace, self.eval.job_id
        )
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

        reconciler = AllocReconciler(
            generic_alloc_update_fn(self.ctx, self.stack, self.eval.id),
            self.batch,
            self.eval.job_id,
            self.job,
            self.deployment,
            allocs,
            tainted,
            self.eval.id,
        )
        results = reconciler.compute()

        if self.eval.annotate_plan:
            self.plan.annotations = {
                "desired_tg_updates": results.desired_tg_updates
            }

        self.plan.deployment = results.deployment
        self.plan.deployment_updates = results.deployment_updates

        for evals in results.desired_followup_evals.values():
            self.followup_evals.extend(evals)

        if results.deployment is not None:
            self.deployment = results.deployment

        for stop in results.stop:
            self.plan.append_stopped_alloc(
                stop.alloc, stop.status_description, stop.client_status
            )
            if stop.followup_eval_id:
                self.plan.node_update[stop.alloc.node_id][-1].followup_eval_id = (
                    stop.followup_eval_id
                )

        deployment_id = self._deployment_id()
        for update in results.inplace_update:
            if update.deployment_id != deployment_id:
                update.deployment_id = deployment_id
                update.deployment_status = None
            self.plan.append_alloc(update)

        for update in results.attribute_updates.values():
            self.plan.append_alloc(update)

        if not results.place and not results.destructive_update:
            if self.job is not None:
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return

        for p in results.place:
            self.queued_allocs[p.task_group.name] = (
                self.queued_allocs.get(p.task_group.name, 0) + 1
            )
        for d in results.destructive_update:
            self.queued_allocs[d.place_task_group.name] = (
                self.queued_allocs.get(d.place_task_group.name, 0) + 1
            )

        self._compute_placements(
            list(results.destructive_update), list(results.place)
        )

    # ------------------------------------------------------------------

    def _compute_placements(self, destructive, place) -> None:
        """(reference generic_sched.go:468 computePlacements)"""
        nodes, by_dc = ready_nodes_in_dcs(
            self.state, self.job.datacenters
        )
        deployment_id = ""
        if self.deployment is not None and self.deployment.active():
            deployment_id = self.deployment.id

        self.stack.set_nodes(nodes)
        now = _time.time()

        for results in (destructive, place):
            for missing in results:
                tg = missing.task_group

                # coalesce failures per task group
                metric = self.failed_tg_allocs.get(tg.name)
                if metric is not None:
                    metric.coalesced_failures += 1
                    continue

                preferred_node = self._find_preferred_node(missing)

                stop_prev, stop_prev_desc = missing.stop_previous_alloc()
                prev_allocation = missing.previous_alloc
                if stop_prev:
                    self.plan.append_stopped_alloc(
                        prev_allocation, stop_prev_desc
                    )

                select_options = get_select_options(
                    prev_allocation, preferred_node
                )
                t_select = _time.monotonic()
                option = self._select_next_option(tg, select_options)
                # real per-TG allocation latency, reported by the plan
                # API and /v1/evaluation/<id>/placement (reference
                # structs.go AllocMetric.AllocationTime)
                self.ctx.metrics.allocation_time_s = (
                    _time.monotonic() - t_select
                )

                self.ctx.metrics.nodes_available = by_dc

                if option is not None:
                    resources = AllocatedResources(
                        tasks=option.task_resources,
                        shared=AllocatedSharedResources(
                            disk_mb=tg.ephemeral_disk.size_mb
                        ),
                    )
                    if option.alloc_resources is not None:
                        resources.shared.networks = (
                            option.alloc_resources.networks
                        )
                        resources.shared.ports = (
                            option.alloc_resources.ports
                        )
                    alloc = Allocation(
                        namespace=self.job.namespace,
                        eval_id=self.eval.id,
                        name=missing.name,
                        job_id=self.job.id,
                        job=self.job,
                        task_group=tg.name,
                        metrics=self.ctx.metrics,
                        node_id=option.node.id,
                        node_name=option.node.name,
                        deployment_id=deployment_id,
                        allocated_resources=resources,
                        desired_status=ALLOC_DESIRED_RUN,
                        client_status=ALLOC_CLIENT_STATUS_PENDING,
                    )
                    if prev_allocation is not None:
                        alloc.previous_allocation = prev_allocation.id
                        if missing.is_rescheduling():
                            update_reschedule_tracker(
                                alloc, prev_allocation, now
                            )
                    if missing.canary and self.deployment is not None:
                        from ..structs import AllocDeploymentStatus

                        alloc.deployment_status = AllocDeploymentStatus(
                            canary=True
                        )
                    self._handle_preemptions(option, alloc)
                    self.plan.append_alloc(alloc)
                else:
                    self.failed_tg_allocs[tg.name] = self.ctx.metrics
                    if stop_prev:
                        updates = self.plan.node_update.get(
                            prev_allocation.node_id, []
                        )
                        self.plan.node_update[prev_allocation.node_id] = [
                            a for a in updates if a.id != prev_allocation.id
                        ]

    def _find_preferred_node(self, place) -> Optional[Node]:
        prev = place.previous_alloc
        if prev is not None and place.task_group.ephemeral_disk.sticky:
            node = self.state.node_by_id(prev.node_id)
            if node is not None and node.ready():
                return node
        return None

    def _select_next_option(self, tg: TaskGroup, select_options):
        option = self.stack.select(tg, select_options)
        config = self.state.scheduler_config()
        if self.job.type == JOB_TYPE_BATCH:
            enable_preemption = (
                config.preemption_config.batch_scheduler_enabled
            )
        else:
            enable_preemption = (
                config.preemption_config.service_scheduler_enabled
            )
        if option is None and enable_preemption:
            select_options.preempt = True
            option = self.stack.select(tg, select_options)
        return option

    def _handle_preemptions(self, option, alloc: Allocation) -> None:
        if option.preempted_allocs is None:
            return
        preempted_ids = []
        for stop in option.preempted_allocs:
            self.plan.append_preempted_alloc(stop, alloc.id)
            preempted_ids.append(stop.id)


def get_select_options(
    prev_allocation: Optional[Allocation],
    preferred_node: Optional[Node],
) -> SelectOptions:
    """(reference generic_sched.go:642 getSelectOptions)"""
    options = SelectOptions()
    if prev_allocation is not None:
        penalty = set()
        if prev_allocation.client_status == ALLOC_CLIENT_STATUS_FAILED:
            penalty.add(prev_allocation.node_id)
        if prev_allocation.reschedule_tracker is not None:
            for event in prev_allocation.reschedule_tracker.events:
                penalty.add(event.prev_node_id)
        options.penalty_node_ids = penalty
    if preferred_node is not None:
        options.preferred_nodes = [preferred_node]
    return options


def update_reschedule_tracker(
    alloc: Allocation, prev: Allocation, now: float
) -> None:
    """(reference generic_sched.go:666 updateRescheduleTracker)"""
    policy = prev.reschedule_policy()
    events: List[RescheduleEvent] = []
    if prev.reschedule_tracker is not None:
        if policy is not None and policy.attempts > 0:
            interval = policy.interval_s
            for event in prev.reschedule_tracker.events:
                if interval > 0 and now - event.reschedule_time <= interval:
                    events.append(event)
        else:
            events = list(
                prev.reschedule_tracker.events[-MAX_PAST_RESCHEDULE_EVENTS:]
            )
    next_delay = prev.next_delay()
    events.append(
        RescheduleEvent(
            reschedule_time=now,
            prev_alloc_id=prev.id,
            prev_node_id=prev.node_id,
            delay_s=next_delay,
        )
    )
    alloc.reschedule_tracker = RescheduleTracker(events=events)


def ServiceScheduler(state, planner, **kwargs) -> GenericScheduler:
    return GenericScheduler(state, planner, batch=False, **kwargs)


def BatchScheduler(state, planner, **kwargs) -> GenericScheduler:
    return GenericScheduler(state, planner, batch=True, **kwargs)
