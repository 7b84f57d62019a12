"""Ranking iterators: the host-side oracle scoring chain
(reference scheduler/rank.go).

Score-append semantics matter for parity with the vectorized kernel: each
iterator appends to ``RankedNode.scores`` only under specific conditions
(binpack always; device affinity only when device affinities exist;
job-anti-affinity only on collisions; rescheduling penalty only on penalty
nodes; node affinity only when the total is non-zero; spread only when the
boost is non-zero; preemption only when allocs would be preempted) and the
final score is the *mean of appended scores* (rank.go:696
ScoreNormalizationIterator).  The kernel reproduces exactly this
sum/count arithmetic (ops/score.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..structs import (
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Allocation,
    Job,
    NetworkIndex,
    NetworkResource,
    Node,
    TaskGroup,
    allocs_fit,
    remove_allocs,
    score_fit_binpack,
    score_fit_spread,
    SCHEDULER_ALGORITHM_SPREAD,
)
from ..structs.funcs import (
    BINPACK_MAX_FIT_SCORE,
    net_priority,
    preemption_score,
)
from .context import EvalContext
from .device import DeviceAllocator
from .feasible import resolve_target
from .operators import check_affinity
from .preemption import Preemptor


@dataclass
class RankedNode:
    """(reference rank.go:19)"""

    node: Node
    final_score: float = 0.0
    scores: List[float] = field(default_factory=list)
    task_resources: Dict[str, AllocatedTaskResources] = field(
        default_factory=dict
    )
    alloc_resources: Optional[AllocatedSharedResources] = None
    proposed: Optional[List[Allocation]] = None
    preempted_allocs: Optional[List[Allocation]] = None

    def proposed_allocs(self, ctx: EvalContext) -> List[Allocation]:
        if self.proposed is None:
            self.proposed = ctx.proposed_allocs(self.node.id)
        return self.proposed

    def set_task_resources(
        self, task, resources: AllocatedTaskResources
    ) -> None:
        self.task_resources[task.name] = resources


class FeasibleRankIterator:
    """(reference rank.go:76)"""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        return RankedNode(node=option)

    def reset(self) -> None:
        self.source.reset()


class StaticRankIterator:
    """Fixed list of ranked nodes; testing aid (reference rank.go:105)."""

    def __init__(self, ctx: EvalContext, nodes: List[RankedNode]) -> None:
        self.ctx = ctx
        self.nodes = nodes
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[RankedNode]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        option = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        return option

    def reset(self) -> None:
        self.seen = 0


class BinPackIterator:
    """Resource fitting + fitness scoring, with optional preemption
    (reference rank.go:149)."""

    def __init__(
        self,
        ctx: EvalContext,
        source,
        evict: bool,
        priority: int,
        algorithm: str,
    ) -> None:
        self.ctx = ctx
        self.source = source
        self.evict = evict
        self.priority = priority
        self.job_ns_id: Tuple[str, str] = ("", "")
        self.task_group: Optional[TaskGroup] = None
        self.score_fit = (
            score_fit_spread
            if algorithm == SCHEDULER_ALGORITHM_SPREAD
            else score_fit_binpack
        )

    def set_job(self, job: Job) -> None:
        self.priority = job.priority
        self.job_ns_id = job.namespaced_id()

    def set_task_group(self, tg: TaskGroup) -> None:
        self.task_group = tg

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None:
                return None

            tg = self.task_group
            proposed = option.proposed_allocs(self.ctx)

            net_idx = NetworkIndex()
            net_idx.set_node(option.node)
            net_idx.add_allocs(proposed)

            dev_allocator = DeviceAllocator(self.ctx, option.node)
            dev_allocator.add_allocs(proposed)

            total_device_affinity_weight = 0.0
            sum_matching_affinities = 0.0

            total = AllocatedResources(
                shared=AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb
                )
            )

            allocs_to_preempt: List[Allocation] = []
            preemptor = Preemptor(self.priority, self.job_ns_id)
            preemptor.set_node(option.node)
            current_preemptions = [
                alloc
                for allocs in self.ctx.plan.node_preemptions.values()
                for alloc in allocs
            ]
            preemptor.set_preemptions(current_preemptions)

            # group-level network ask (reference rank.go:240)
            if tg.networks:
                ask = tg.networks[0].copy()
                offer = net_idx.assign_ports(ask)
                if offer is None:
                    if not self.evict:
                        self.ctx.metrics.exhausted_node(
                            option.node, "network: port collision"
                        )
                        continue
                    preemptor.set_candidates(proposed)
                    net_preemptions = preemptor.preempt_for_network(
                        ask, net_idx
                    )
                    if net_preemptions is None:
                        continue
                    allocs_to_preempt.extend(net_preemptions)
                    proposed = remove_allocs(proposed, net_preemptions)
                    net_idx = NetworkIndex()
                    net_idx.set_node(option.node)
                    net_idx.add_allocs(proposed)
                    offer = net_idx.assign_ports(ask)
                    if offer is None:
                        continue
                net_idx.add_reserved_ports(offer)
                nw_res = NetworkResource(
                    mode=ask.mode, mbits=ask.mbits
                )
                total.shared.networks = [nw_res]
                total.shared.ports = offer
                option.alloc_resources = AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb,
                    networks=[nw_res],
                    ports=offer,
                )

            exhausted = False
            for task in tg.tasks:
                task_resources = AllocatedTaskResources(
                    cpu=task.resources.cpu,
                    memory_mb=task.resources.memory_mb,
                )

                # task-level network ask (reference rank.go:302)
                if task.resources.networks:
                    ask = task.resources.networks[0].copy()
                    offer_net = net_idx.assign_network(ask)
                    if offer_net is None:
                        if not self.evict:
                            self.ctx.metrics.exhausted_node(
                                option.node, "network: port collision"
                            )
                            exhausted = True
                            break
                        preemptor.set_candidates(proposed)
                        net_preemptions = preemptor.preempt_for_network(
                            ask, net_idx
                        )
                        if net_preemptions is None:
                            exhausted = True
                            break
                        allocs_to_preempt.extend(net_preemptions)
                        proposed = remove_allocs(proposed, net_preemptions)
                        net_idx = NetworkIndex()
                        net_idx.set_node(option.node)
                        net_idx.add_allocs(proposed)
                        offer_net = net_idx.assign_network(ask)
                        if offer_net is None:
                            exhausted = True
                            break
                    net_idx.add_reserved(offer_net)
                    task_resources.networks = [offer_net]

                # device asks (reference rank.go:360)
                for req in task.resources.devices:
                    offer_dev, sum_affinities, err = (
                        dev_allocator.assign_device(req)
                    )
                    if offer_dev is None:
                        if not self.evict:
                            self.ctx.metrics.exhausted_node(
                                option.node, f"devices: {err}"
                            )
                            exhausted = True
                            break
                        preemptor.set_candidates(proposed)
                        device_preemptions = preemptor.preempt_for_device(
                            req, dev_allocator
                        )
                        if device_preemptions is None:
                            exhausted = True
                            break
                        allocs_to_preempt.extend(device_preemptions)
                        proposed = remove_allocs(proposed, allocs_to_preempt)
                        dev_allocator = DeviceAllocator(self.ctx, option.node)
                        dev_allocator.add_allocs(proposed)
                        offer_dev, sum_affinities, err = (
                            dev_allocator.assign_device(req)
                        )
                        if offer_dev is None:
                            exhausted = True
                            break
                    dev_allocator.add_reserved(offer_dev)
                    task_resources.devices.append(offer_dev)
                    if req.affinities:
                        for aff in req.affinities:
                            total_device_affinity_weight += abs(
                                float(aff.weight)
                            )
                        sum_matching_affinities += sum_affinities
                if exhausted:
                    break

                option.set_task_resources(task, task_resources)
                total.tasks[task.name] = task_resources
            if exhausted:
                continue

            current = proposed
            probe = Allocation(allocated_resources=total)
            proposed = proposed + [probe]

            fit, dim, util = allocs_fit(option.node, proposed, net_idx, False)
            if not fit:
                if not self.evict:
                    self.ctx.metrics.exhausted_node(option.node, dim)
                    continue
                preemptor.set_candidates(current)
                preempted = preemptor.preempt_for_task_group(total)
                allocs_to_preempt.extend(preempted)
                if not preempted:
                    self.ctx.metrics.exhausted_node(option.node, dim)
                    continue
            if allocs_to_preempt:
                option.preempted_allocs = allocs_to_preempt

            fitness = self.score_fit(option.node, util)
            normalized = fitness / BINPACK_MAX_FIT_SCORE
            option.scores.append(normalized)
            self.ctx.metrics.score_node(option.node, "binpack", normalized)

            if total_device_affinity_weight != 0:
                sum_matching_affinities /= total_device_affinity_weight
                option.scores.append(sum_matching_affinities)
                self.ctx.metrics.score_node(
                    option.node, "devices", sum_matching_affinities
                )
            return option

    def reset(self) -> None:
        self.source.reset()


class JobAntiAffinityIterator:
    """Penalty for co-locating allocs of the same job+group
    (reference rank.go:474): -(collisions+1)/desired_count, appended only
    when collisions > 0."""

    def __init__(self, ctx: EvalContext, source, job_id: str) -> None:
        self.ctx = ctx
        self.source = source
        self.job_id = job_id
        self.task_group = ""
        self.desired_count = 0

    def set_job(self, job: Job) -> None:
        self.job_id = job.id

    def set_task_group(self, tg: TaskGroup) -> None:
        self.task_group = tg.name
        self.desired_count = tg.count

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None:
                return None
            proposed = option.proposed_allocs(self.ctx)
            collisions = sum(
                1
                for alloc in proposed
                if alloc.job_id == self.job_id
                and alloc.task_group == self.task_group
            )
            if collisions > 0:
                penalty = -1.0 * float(collisions + 1) / float(
                    self.desired_count
                )
                option.scores.append(penalty)
                self.ctx.metrics.score_node(
                    option.node, "job-anti-affinity", penalty
                )
            else:
                self.ctx.metrics.score_node(
                    option.node, "job-anti-affinity", 0
                )
            return option

    def reset(self) -> None:
        self.source.reset()


class NodeReschedulingPenaltyIterator:
    """-1 on nodes where a previous attempt of the alloc failed
    (reference rank.go:544)."""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source
        self.penalty_nodes: set = set()

    def set_penalty_nodes(self, penalty_nodes) -> None:
        self.penalty_nodes = set(penalty_nodes or ())

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        if option.node.id in self.penalty_nodes:
            option.scores.append(-1.0)
            self.ctx.metrics.score_node(
                option.node, "node-reschedule-penalty", -1
            )
        else:
            self.ctx.metrics.score_node(
                option.node, "node-reschedule-penalty", 0
            )
        return option

    def reset(self) -> None:
        self.penalty_nodes = set()
        self.source.reset()


class NodeAffinityIterator:
    """Weighted affinity score: sum(matched weights)/sum(|weights|),
    appended only when non-zero (reference rank.go:589)."""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source
        self.job_affinities: List = []
        self.affinities: List = []

    def set_job(self, job: Job) -> None:
        self.job_affinities = list(job.affinities)

    def set_task_group(self, tg: TaskGroup) -> None:
        if self.job_affinities:
            self.affinities.extend(self.job_affinities)
        if tg.affinities:
            self.affinities.extend(tg.affinities)
        for task in tg.tasks:
            if task.affinities:
                self.affinities.extend(task.affinities)

    def has_affinities(self) -> bool:
        return bool(self.affinities)

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        if not self.has_affinities():
            self.ctx.metrics.score_node(option.node, "node-affinity", 0)
            return option
        sum_weight = sum(abs(float(a.weight)) for a in self.affinities)
        total = 0.0
        for aff in self.affinities:
            if self._matches(aff, option.node):
                total += float(aff.weight)
        norm_score = total / sum_weight
        if total != 0.0:
            option.scores.append(norm_score)
            self.ctx.metrics.score_node(
                option.node, "node-affinity", norm_score
            )
        return option

    def _matches(self, affinity, node: Node) -> bool:
        lval, lok = resolve_target(affinity.ltarget, node)
        rval, rok = resolve_target(affinity.rtarget, node)
        return check_affinity(
            affinity.operand,
            lval,
            rval,
            lok,
            rok,
            self.ctx.regex_cache,
            self.ctx.version_cache,
        )

    def reset(self) -> None:
        self.source.reset()
        self.affinities = []


class ScoreNormalizationIterator:
    """final_score = mean(scores) (reference rank.go:679)."""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or not option.scores:
            return option
        option.final_score = sum(option.scores) / float(len(option.scores))
        self.ctx.metrics.score_node(
            option.node, "normalized-score", option.final_score
        )
        return option

    def reset(self) -> None:
        self.source.reset()


class PolicyIterator:
    """Policy-weighted scoring, the serial oracle half (sched/policy.py
    holds the shared resolution/assembly; ops/score.py the fused kernel
    terms).  Sits between SpreadIterator and PreemptionScoringIterator
    so the policy terms append LAST among the soft scores — the same
    left-to-right float-sum position the kernel fuses them at.

    Append conventions mirror the kernel bit-for-bit: the throughput
    term appends for EVERY node when the policy carries a throughput
    table (zeros included — binpack convention); the migration term is
    a penalty on non-incumbent nodes, appended only where non-zero
    (node-reschedule-penalty convention, recorded as 0 elsewhere like
    job-anti-affinity)."""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source
        self.job: Optional[Job] = None
        self.resolved = None
        self.tg_name = ""
        self.sticky: set = set()

    def set_job(self, job: Job) -> None:
        from .policy import resolve

        self.job = job
        self.resolved = resolve(job)

    def set_task_group(self, tg: TaskGroup) -> None:
        from .policy import sticky_node_ids

        self.tg_name = tg.name
        if self.resolved is not None:
            self.sticky = sticky_node_ids(
                self.resolved, self.job, tg.name, self.ctx.state
            )
        else:
            self.sticky = set()

    def has_policy(self) -> bool:
        return self.resolved is not None

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or self.resolved is None:
            return option
        pol = self.resolved
        if pol.has_tput:
            value = pol.tput_coef * pol.tput_value(
                option.node.node_class
            )
            option.scores.append(value)
            self.ctx.metrics.score_node(
                option.node, "policy.throughput", value
            )
        # penalty shape (see policy.migration_vector): non-incumbent
        # nodes pay -coef, the incumbent's mean stays untouched; inert
        # when the TG has no live allocs
        mig = 0.0
        if self.sticky:
            mig = pol.mig_coef * (
                0.0 if option.node.id in self.sticky else -1.0
            )
        if mig != 0.0:
            option.scores.append(mig)
            self.ctx.metrics.score_node(
                option.node, "policy.migration", mig
            )
        elif pol.mig_coef != 0.0:
            self.ctx.metrics.score_node(
                option.node, "policy.migration", 0
            )
        return option

    def reset(self) -> None:
        self.source.reset()


class PreemptionScoringIterator:
    """Logistic net-priority score when the placement would preempt
    (reference rank.go:714)."""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or option.preempted_allocs is None:
            return option
        priorities = [
            alloc.job.priority
            for alloc in option.preempted_allocs
            if alloc.job is not None
        ]
        netp = net_priority(priorities)
        score = preemption_score(netp)
        option.scores.append(score)
        self.ctx.metrics.score_node(option.node, "preemption", score)
        return option

    def reset(self) -> None:
        self.source.reset()
