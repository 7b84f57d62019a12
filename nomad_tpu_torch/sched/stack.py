"""Placement stacks (reference scheduler/stack.go).

`GenericStack` wires the oracle iterator chain in the reference's exact
order (stack.go:321 NewGenericStack): shuffled source -> feasibility
wrapper (job constraints; drivers, tg constraints, host volumes, devices,
network; CSI availability) -> distinct hosts/property -> binpack ->
job-anti-affinity -> rescheduling penalty -> node affinity -> spread ->
preemption scoring -> normalization -> limit -> max score.

`TPUGenericStack` (tpu_stack.py) implements the same `select` surface on
the vectorized kernel; either can back the generic/system schedulers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..structs import Job, Node, TaskGroup
from .context import EvalContext
from .feasible import (
    ConstraintChecker,
    CSIVolumeChecker,
    DeviceChecker,
    DistinctHostsIterator,
    DistinctPropertyIterator,
    DriverChecker,
    FeasibilityWrapper,
    HostVolumeChecker,
    NetworkChecker,
    StaticIterator,
    new_random_iterator,
    shuffle_nodes,
)
from .rank import (
    BinPackIterator,
    FeasibleRankIterator,
    JobAntiAffinityIterator,
    NodeAffinityIterator,
    NodeReschedulingPenaltyIterator,
    PolicyIterator,
    PreemptionScoringIterator,
    RankedNode,
    ScoreNormalizationIterator,
)
from .select import LimitIterator, MaxScoreIterator
from .spread import SpreadIterator

# (reference stack.go:10-18)
SKIP_SCORE_THRESHOLD = 0.0
MAX_SKIP = 3


@dataclass
class SelectOptions:
    """(reference stack.go:34)"""

    penalty_node_ids: Set[str] = field(default_factory=set)
    preferred_nodes: List[Node] = field(default_factory=list)
    preempt: bool = False


def task_group_constraints(tg: TaskGroup):
    """Merge task-group + task constraints and collect drivers
    (reference scheduler/util.go taskGroupConstraints)."""
    constraints = list(tg.constraints)
    drivers = set()
    for task in tg.tasks:
        drivers.add(task.driver)
        constraints.extend(task.constraints)
    return constraints, drivers


def compute_visit_limit(n_nodes: int, batch: bool) -> int:
    """Power-of-two-choices limit: 2 for batch, max(2, ceil(log2 N)) for
    service (reference stack.go:77-89)."""
    limit = 2
    if not batch and n_nodes > 0:
        log_limit = int(math.ceil(math.log2(n_nodes)))
        if log_limit > limit:
            limit = log_limit
    return limit


class GenericStack:
    def __init__(self, batch: bool, ctx: EvalContext) -> None:
        self.batch = batch
        self.ctx = ctx
        self.job_version: Optional[int] = None

        self.source = StaticIterator(ctx, [])

        self.job_constraint = ConstraintChecker(ctx, [])
        self.task_group_drivers = DriverChecker(ctx)
        self.task_group_constraint = ConstraintChecker(ctx, [])
        self.task_group_devices = DeviceChecker(ctx)
        self.task_group_host_volumes = HostVolumeChecker(ctx)
        self.task_group_csi_volumes = CSIVolumeChecker(ctx)
        self.task_group_network = NetworkChecker(ctx)

        self.wrapped_checks = FeasibilityWrapper(
            ctx,
            self.source,
            job_checkers=[self.job_constraint],
            tg_checkers=[
                self.task_group_drivers,
                self.task_group_constraint,
                self.task_group_host_volumes,
                self.task_group_devices,
                self.task_group_network,
            ],
            tg_available=[self.task_group_csi_volumes],
        )
        self.distinct_hosts_constraint = DistinctHostsIterator(
            ctx, self.wrapped_checks
        )
        self.distinct_property_constraint = DistinctPropertyIterator(
            ctx, self.distinct_hosts_constraint
        )
        rank_source = FeasibleRankIterator(
            ctx, self.distinct_property_constraint
        )
        algorithm = (
            ctx.state.scheduler_config().effective_scheduler_algorithm()
        )
        self.bin_pack = BinPackIterator(ctx, rank_source, False, 0, algorithm)
        self.job_anti_aff = JobAntiAffinityIterator(ctx, self.bin_pack, "")
        self.node_rescheduling_penalty = NodeReschedulingPenaltyIterator(
            ctx, self.job_anti_aff
        )
        self.node_affinity = NodeAffinityIterator(
            ctx, self.node_rescheduling_penalty
        )
        self.spread = SpreadIterator(ctx, self.node_affinity)
        # policy-weighted scoring appends AFTER spread so the terms
        # land last in the left-to-right float sum, matching the
        # kernel's fusion point (ops/score.py PolicyTerms)
        self.policy = PolicyIterator(ctx, self.spread)
        preemption_scorer = PreemptionScoringIterator(ctx, self.policy)
        self.score_norm = ScoreNormalizationIterator(ctx, preemption_scorer)
        self.limit = LimitIterator(
            ctx, self.score_norm, 2, SKIP_SCORE_THRESHOLD, MAX_SKIP
        )
        self.max_score = MaxScoreIterator(ctx, self.limit)

    def set_nodes(self, base_nodes: List[Node]) -> None:
        nodes = list(base_nodes)
        shuffle_nodes(self.ctx.rng, nodes)
        self.source.set_nodes(nodes)
        self.limit.set_limit(compute_visit_limit(len(nodes), self.batch))

    def set_job(self, job: Job) -> None:
        if self.job_version is not None and self.job_version == job.version:
            return
        self.job_version = job.version
        self.job_constraint.set_constraints(job.constraints)
        self.task_group_csi_volumes.set_namespace(job.namespace)
        self.distinct_hosts_constraint.set_job(job)
        self.distinct_property_constraint.set_job(job)
        self.bin_pack.set_job(job)
        self.job_anti_aff.set_job(job)
        self.node_affinity.set_job(job)
        self.spread.set_job(job)
        self.policy.set_job(job)
        self.ctx.eligibility.set_job(job)

    def select(
        self, tg: TaskGroup, options: Optional[SelectOptions] = None
    ) -> Optional[RankedNode]:
        # preferred-node pass (sticky ephemeral disk, stack.go:119)
        if options is not None and options.preferred_nodes:
            original_nodes = self.source.nodes
            self.source.set_nodes(list(options.preferred_nodes))
            options_new = SelectOptions(
                penalty_node_ids=options.penalty_node_ids,
                preferred_nodes=[],
                preempt=options.preempt,
            )
            option = self.select(tg, options_new)
            self.source.set_nodes(original_nodes)
            if option is not None:
                return option
            return self.select(tg, options_new)

        self.max_score.reset()
        self.ctx.reset()

        constraints, drivers = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(drivers)
        self.task_group_constraint.set_constraints(constraints)
        self.task_group_devices.set_task_group(tg)
        self.task_group_host_volumes.set_volumes(tg.volumes)
        self.task_group_csi_volumes.set_volumes(tg.volumes)
        if tg.networks:
            self.task_group_network.set_network(tg.networks[0])
        self.distinct_hosts_constraint.set_task_group(tg)
        self.distinct_property_constraint.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)
        self.bin_pack.set_task_group(tg)
        if options is not None:
            self.bin_pack.evict = options.preempt
            self.node_rescheduling_penalty.set_penalty_nodes(
                options.penalty_node_ids
            )
        self.job_anti_aff.set_task_group(tg)
        self.node_affinity.set_task_group(tg)
        self.spread.set_task_group(tg)
        self.policy.set_task_group(tg)

        # policy joins affinity/spread in the "scoring is not purely
        # random" unlimited-walk rule: weighted scores must survey the
        # whole candidate set (tpu_stack and storm staging apply the
        # same rule so the kernel walk stays bit-identical)
        if (
            self.node_affinity.has_affinities()
            or self.spread.has_spreads()
            or self.policy.has_policy()
        ):
            self.limit.set_limit(2**31 - 1)

        return self.max_score.next()


class SystemStack:
    """Linear source, no spread/affinity/limit; preemption on by default
    per scheduler config (reference stack.go:182-318)."""

    def __init__(self, ctx: EvalContext) -> None:
        self.ctx = ctx
        self.source = StaticIterator(ctx, [])

        self.job_constraint = ConstraintChecker(ctx, [])
        self.task_group_drivers = DriverChecker(ctx)
        self.task_group_constraint = ConstraintChecker(ctx, [])
        self.task_group_devices = DeviceChecker(ctx)
        self.task_group_host_volumes = HostVolumeChecker(ctx)
        self.task_group_csi_volumes = CSIVolumeChecker(ctx)
        self.task_group_network = NetworkChecker(ctx)

        self.wrapped_checks = FeasibilityWrapper(
            ctx,
            self.source,
            job_checkers=[self.job_constraint],
            tg_checkers=[
                self.task_group_drivers,
                self.task_group_constraint,
                self.task_group_host_volumes,
                self.task_group_devices,
                self.task_group_network,
            ],
            tg_available=[self.task_group_csi_volumes],
        )
        self.distinct_property_constraint = DistinctPropertyIterator(
            ctx, self.wrapped_checks
        )
        rank_source = FeasibleRankIterator(
            ctx, self.distinct_property_constraint
        )
        config = ctx.state.scheduler_config()
        enable_preemption = (
            config.preemption_config.system_scheduler_enabled
        )
        algorithm = config.effective_scheduler_algorithm()
        self.bin_pack = BinPackIterator(
            ctx, rank_source, enable_preemption, 0, algorithm
        )
        preemption_scorer = PreemptionScoringIterator(ctx, self.bin_pack)
        self.score_norm = ScoreNormalizationIterator(ctx, preemption_scorer)

    def set_nodes(self, base_nodes: List[Node]) -> None:
        self.source.set_nodes(list(base_nodes))

    def set_job(self, job: Job) -> None:
        self.job_constraint.set_constraints(job.constraints)
        self.task_group_csi_volumes.set_namespace(job.namespace)
        self.distinct_property_constraint.set_job(job)
        self.bin_pack.set_job(job)
        self.ctx.eligibility.set_job(job)

    def select(
        self, tg: TaskGroup, options: Optional[SelectOptions] = None
    ) -> Optional[RankedNode]:
        self.ctx.reset()

        constraints, drivers = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(drivers)
        self.task_group_constraint.set_constraints(constraints)
        self.task_group_devices.set_task_group(tg)
        self.task_group_host_volumes.set_volumes(tg.volumes)
        self.task_group_csi_volumes.set_volumes(tg.volumes)
        if tg.networks:
            self.task_group_network.set_network(tg.networks[0])
        self.distinct_property_constraint.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)
        self.bin_pack.set_task_group(tg)

        return self.score_norm.next()
