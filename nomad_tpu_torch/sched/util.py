"""Scheduler helpers (reference scheduler/util.go)."""
from __future__ import annotations

from dataclasses import replace as _replace
from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

from ..structs import (
    ALLOC_CLIENT_STATUS_LOST,
    ALLOC_DESIRED_STOP,
    Allocation,
    AllocMetric,
    AllocatedResources,
    AllocatedSharedResources,
    Evaluation,
    EVAL_STATUS_FAILED,
    Job,
    Node,
    NODE_STATUS_DOWN,
    NODE_STATUS_READY,
    NODE_SCHED_ELIGIBLE,
    PlanResult,
    TaskGroup,
)
from .scheduler import SetStatusError

if TYPE_CHECKING:  # pragma: no cover
    from ..state.store import StateSnapshot
    from .context import EvalContext

ALLOC_IN_PLACE = "alloc updating in-place"


def ready_nodes_in_dcs(
    state: "StateSnapshot", datacenters: List[str]
) -> Tuple[List[Node], Dict[str, int]]:
    """(reference util.go:233 readyNodesInDCs)

    The scan is O(cluster); at 10k nodes it costs ~10ms of pure Python
    per evaluation, dwarfing the actual scheduling math.  Snapshots
    delegate node reads to the live store (mutation is serialized behind
    the plan applier), so the result is memoized on the store keyed by
    the nodes-table modify index + datacenter set; every caller —
    oracle scheduler, simulation pre-pass, prescore assembly — shares
    the hit.  Callers receive fresh list/dict copies (the stack shuffles
    its node list in place)."""
    store = getattr(state, "_store", None)
    if store is not None:
        key = (store.table_index("nodes"), tuple(datacenters))
        cache = getattr(store, "_ready_nodes_cache", None)
        if cache is None:
            cache = {}
            store._ready_nodes_cache = cache
        hit = cache.get(key)
        if hit is not None:
            return list(hit[0]), dict(hit[1])

    dc_map = {dc: 0 for dc in datacenters}
    out: List[Node] = []
    for node in state.nodes():
        if node.status != NODE_STATUS_READY:
            continue
        if node.drain:
            continue
        if node.scheduling_eligibility != NODE_SCHED_ELIGIBLE:
            continue
        if node.datacenter not in dc_map:
            continue
        out.append(node)
        dc_map[node.datacenter] += 1
    if store is not None:
        try:
            stale = bool(cache) and next(iter(cache))[0] != key[0]
        except (StopIteration, RuntimeError):
            # concurrent clear/insert from another scheduler thread
            stale = False
        if stale:
            cache.clear()
        cache[key] = (out, dc_map)
        return list(out), dict(dc_map)
    return out, dc_map


def tainted_nodes(
    state: "StateSnapshot", allocs: List[Allocation]
) -> Dict[str, Optional[Node]]:
    """Nodes (by id) whose allocs should migrate: down, draining, or gone
    (reference util.go:312 taintedNodes)."""
    out: Dict[str, Optional[Node]] = {}
    for alloc in allocs:
        if alloc.node_id in out:
            continue
        node = state.node_by_id(alloc.node_id)
        if node is None:
            out[alloc.node_id] = None
            continue
        if node.status == NODE_STATUS_DOWN or node.drain:
            out[alloc.node_id] = node
    return out


def retry_max(max_attempts: int, cb, reset=None) -> None:
    """(reference util.go:277 retryMax)"""
    attempts = 0
    while attempts < max_attempts:
        done = cb()
        if done:
            return
        if reset is not None and reset():
            attempts = 0
        else:
            attempts += 1
    raise SetStatusError(
        f"maximum attempts reached ({max_attempts})", EVAL_STATUS_FAILED
    )


def progress_made(result: Optional[PlanResult]) -> bool:
    """(reference util.go:303 progressMade)"""
    return result is not None and (
        bool(result.node_update)
        or bool(result.node_allocation)
        or result.deployment is not None
        or bool(result.deployment_updates)
    )


def update_non_terminal_allocs_to_lost(
    plan, tainted: Dict[str, Optional[Node]], allocs: List[Allocation]
) -> None:
    """Mark pending/running allocs on down nodes as lost
    (reference generic_sched.go:350 updateNonTerminalAllocsToLost)."""
    for alloc in allocs:
        node = tainted.get(alloc.node_id)
        if alloc.node_id not in tainted:
            continue
        if node is not None and node.status != NODE_STATUS_DOWN:
            continue
        if alloc.desired_status == ALLOC_DESIRED_STOP and alloc.client_status in (
            "running",
            "pending",
        ):
            plan.append_stopped_alloc(
                alloc,
                "alloc is lost since its node is down",
                ALLOC_CLIENT_STATUS_LOST,
            )


def _network_ports_map(net) -> Dict[str, int]:
    m = {}
    for p in net.reserved_ports:
        m[p.label] = p.value
    for p in net.dynamic_ports:
        m[p.label] = -1
    return m


def networks_updated(nets_a, nets_b) -> bool:
    if len(nets_a) != len(nets_b):
        return True
    for an, bn in zip(nets_a, nets_b):
        if an.mode != bn.mode or an.mbits != bn.mbits:
            return True
        if _network_ports_map(an) != _network_ports_map(bn):
            return True
    return False


def tasks_updated(job_a: Job, job_b: Job, task_group: str) -> bool:
    """In-place vs destructive diff (reference util.go:351 tasksUpdated)."""
    a = job_a.lookup_task_group(task_group)
    b = job_b.lookup_task_group(task_group)
    if a is None or b is None:
        return True
    if len(a.tasks) != len(b.tasks):
        return True
    if a.ephemeral_disk != b.ephemeral_disk:
        return True
    if networks_updated(a.networks, b.networks):
        return True
    if list(job_a.affinities) + list(a.affinities) != list(
        job_b.affinities
    ) + list(b.affinities):
        return True
    if list(job_a.spreads) + list(a.spreads) != list(job_b.spreads) + list(
        b.spreads
    ):
        return True
    b_tasks = {t.name: t for t in b.tasks}
    for at in a.tasks:
        bt = b_tasks.get(at.name)
        if bt is None:
            return True
        if at.driver != bt.driver:
            return True
        if at.config != bt.config:
            return True
        if at.env != bt.env:
            return True
        if at.artifacts != bt.artifacts:
            return True
        if at.templates != bt.templates:
            return True
        if at.meta != bt.meta:
            return True
        if networks_updated(at.resources.networks, bt.resources.networks):
            return True
        if (
            at.resources.cpu != bt.resources.cpu
            or at.resources.memory_mb != bt.resources.memory_mb
            or at.resources.devices != bt.resources.devices
        ):
            return True
    return False


class AllocTuple:
    """(reference util.go:14 allocTuple)"""

    __slots__ = ("name", "task_group", "alloc")

    def __init__(self, name, task_group, alloc=None):
        self.name = name
        self.task_group = task_group
        self.alloc = alloc


class DiffResult:
    def __init__(self):
        self.place: List[AllocTuple] = []
        self.update: List[AllocTuple] = []
        self.migrate: List[AllocTuple] = []
        self.stop: List[AllocTuple] = []
        self.ignore: List[AllocTuple] = []
        self.lost: List[AllocTuple] = []

    def append(self, other: "DiffResult") -> None:
        self.place.extend(other.place)
        self.update.extend(other.update)
        self.migrate.extend(other.migrate)
        self.stop.extend(other.stop)
        self.ignore.extend(other.ignore)
        self.lost.extend(other.lost)


def materialize_task_groups(job: Job) -> Dict[str, TaskGroup]:
    """Expand tg.count into named alloc slots
    (reference util.go:21 materializeTaskGroups)."""
    out: Dict[str, TaskGroup] = {}
    if job.stopped():
        return out
    for tg in job.task_groups:
        for i in range(tg.count):
            out[f"{job.id}.{tg.name}[{i}]"] = tg
    return out


def diff_system_allocs_for_node(
    job: Job,
    node_id: str,
    eligible_nodes: Dict[str, Node],
    tainted: Dict[str, Optional[Node]],
    required: Dict[str, TaskGroup],
    allocs: List[Allocation],
    terminal_allocs: Dict[str, Allocation],
) -> DiffResult:
    """(reference util.go:70 diffSystemAllocsForNode)"""
    from ..structs import JOB_TYPE_BATCH

    result = DiffResult()
    existing = set()
    for exist in allocs:
        name = exist.name
        existing.add(name)
        tg = required.get(name)
        if tg is None:
            result.stop.append(AllocTuple(name, tg, exist))
            continue
        if (
            not exist.terminal_status()
            and exist.desired_transition.should_migrate()
        ):
            result.migrate.append(AllocTuple(name, tg, exist))
            continue
        if exist.node_id in tainted:
            node = tainted[exist.node_id]
            if (
                exist.job is not None
                and exist.job.type == JOB_TYPE_BATCH
                and exist.ran_successfully()
            ):
                result.ignore.append(AllocTuple(name, tg, exist))
                continue
            if not exist.terminal_status() and (
                node is None or node.terminal_status()
            ):
                result.lost.append(AllocTuple(name, tg, exist))
            else:
                result.ignore.append(AllocTuple(name, tg, exist))
            continue
        if node_id not in eligible_nodes:
            result.ignore.append(AllocTuple(name, tg, exist))
            continue
        if (
            exist.job is not None
            and job.job_modify_index != exist.job.job_modify_index
        ):
            result.update.append(AllocTuple(name, tg, exist))
            continue
        result.ignore.append(AllocTuple(name, tg, exist))

    for name, tg in required.items():
        if name in existing:
            continue
        if node_id in tainted:
            continue
        if node_id not in eligible_nodes:
            continue
        tup = AllocTuple(name, tg, terminal_allocs.get(name))
        if tup.alloc is None or tup.alloc.node_id != node_id:
            tup.alloc = Allocation(node_id=node_id)
        result.place.append(tup)
    return result


def diff_system_allocs(
    job: Job,
    nodes: List[Node],
    tainted: Dict[str, Optional[Node]],
    allocs: List[Allocation],
    terminal_allocs: Dict[str, Allocation],
) -> DiffResult:
    """(reference util.go:201 diffSystemAllocs)"""
    node_allocs: Dict[str, List[Allocation]] = {}
    for alloc in allocs:
        node_allocs.setdefault(alloc.node_id, []).append(alloc)
    eligible = {}
    for node in nodes:
        node_allocs.setdefault(node.id, [])
        eligible[node.id] = node
    required = materialize_task_groups(job)
    result = DiffResult()
    for node_id, nallocs in node_allocs.items():
        result.append(
            diff_system_allocs_for_node(
                job, node_id, eligible, tainted, required, nallocs,
                terminal_allocs,
            )
        )
    return result


def evict_and_place(
    ctx: "EvalContext",
    diff: DiffResult,
    allocs: List[AllocTuple],
    desc: str,
    limit_box: List[int],
) -> bool:
    """Evict each alloc and add to the place set, bounded by limit; returns
    True if the limit was reached (reference util.go evictAndPlace)."""
    n = len(allocs)
    for i in range(n):
        if limit_box[0] <= 0:
            return True
        a = allocs[i]
        ctx.plan.append_stopped_alloc(a.alloc, desc)
        diff.place.append(a)
        limit_box[0] -= 1
    return False


def inplace_update(
    ctx: "EvalContext",
    evaluation: Evaluation,
    job: Job,
    stack,
    updates: List[AllocTuple],
) -> Tuple[List[AllocTuple], List[AllocTuple]]:
    """Attempt in-place updates; returns (destructive, inplace)
    (reference util.go:556 inplaceUpdate)."""
    inplace_count = 0
    destructive: List[AllocTuple] = []
    inplace: List[AllocTuple] = []
    for update in updates:
        existing = update.alloc
        if existing.job is not None and tasks_updated(
            job, existing.job, update.task_group.name
        ):
            destructive.append(update)
            continue
        node = ctx.state.node_by_id(existing.node_id)
        if node is None:
            destructive.append(update)
            continue
        stack.set_nodes([node])
        ctx.plan.append_stopped_alloc(existing, ALLOC_IN_PLACE)
        option = stack.select(update.task_group, None)
        node_updates = ctx.plan.node_update.get(existing.node_id, [])
        ctx.plan.node_update[existing.node_id] = [
            a for a in node_updates if a.id != existing.id
        ]
        if not ctx.plan.node_update[existing.node_id]:
            del ctx.plan.node_update[existing.node_id]
        if option is None:
            destructive.append(update)
            continue
        new_alloc = _replace(existing)
        new_alloc.eval_id = evaluation.id
        new_alloc.allocated_resources = AllocatedResources(
            tasks=option.task_resources,
            shared=AllocatedSharedResources(
                disk_mb=update.task_group.ephemeral_disk.size_mb
            ),
        )
        if existing.allocated_resources is not None:
            new_alloc.allocated_resources.shared.networks = (
                existing.allocated_resources.shared.networks
            )
            new_alloc.allocated_resources.shared.ports = (
                existing.allocated_resources.shared.ports
            )
        ctx.plan.append_alloc(new_alloc)
        inplace.append(update)
        inplace_count += 1
    return destructive, inplace


def generic_alloc_update_fn(ctx: "EvalContext", stack, eval_id: str):
    """Factory for the reconciler's inplace/destructive decision
    (reference util.go:849 genericAllocUpdateFn)."""

    def update_fn(
        existing: Allocation, new_job: Job, new_tg: TaskGroup
    ) -> Tuple[bool, bool, Optional[Allocation]]:
        if (
            existing.job is not None
            and existing.job.job_modify_index == new_job.job_modify_index
        ):
            return True, False, None
        if existing.job is not None and tasks_updated(
            new_job, existing.job, new_tg.name
        ):
            return False, True, None
        if existing.terminal_status():
            return True, False, None

        node = ctx.state.node_by_id(existing.node_id)
        if node is None:
            return False, True, None

        stack.set_nodes([node])
        ctx.plan.append_stopped_alloc(existing, ALLOC_IN_PLACE)
        option = stack.select(new_tg, None)
        # pop the staged eviction
        updates = ctx.plan.node_update.get(existing.node_id, [])
        ctx.plan.node_update[existing.node_id] = [
            a for a in updates if a.id != existing.id
        ]
        if not ctx.plan.node_update[existing.node_id]:
            del ctx.plan.node_update[existing.node_id]

        if option is None:
            return False, True, None

        # restore network/device offers from the existing allocation
        for task_name, resources in option.task_resources.items():
            if existing.allocated_resources is not None:
                tr = existing.allocated_resources.tasks.get(task_name)
                if tr is not None:
                    resources.networks = tr.networks
                    resources.devices = tr.devices

        new_alloc = _replace(existing)
        new_alloc.eval_id = eval_id
        new_alloc.allocated_resources = AllocatedResources(
            tasks=option.task_resources,
            shared=AllocatedSharedResources(
                disk_mb=new_tg.ephemeral_disk.size_mb
            ),
        )
        if existing.allocated_resources is not None:
            new_alloc.allocated_resources.shared.networks = (
                existing.allocated_resources.shared.networks
            )
            new_alloc.allocated_resources.shared.ports = (
                existing.allocated_resources.shared.ports
            )
        new_alloc.metrics = existing.metrics
        return False, False, new_alloc

    return update_fn


def set_status(
    planner,
    evaluation: Evaluation,
    next_eval: Optional[Evaluation],
    spawned_blocked: Optional[Evaluation],
    tg_metrics: Optional[Dict[str, AllocMetric]],
    status: str,
    description: str,
    queued_allocs: Optional[Dict[str, int]],
    deployment_id: str,
) -> None:
    """(reference util.go:530 setStatus)"""
    new_eval = _replace(evaluation)
    new_eval.status = status
    new_eval.status_description = description
    new_eval.deployment_id = deployment_id
    new_eval.failed_tg_allocs = tg_metrics or {}
    if next_eval is not None:
        new_eval.next_eval = next_eval.id
    if spawned_blocked is not None:
        new_eval.blocked_eval = spawned_blocked.id
    if queued_allocs is not None:
        new_eval.queued_allocations = dict(queued_allocs)
    planner.update_eval(new_eval)


def adjust_queued_allocations(
    result: Optional[PlanResult], queued: Dict[str, int]
) -> None:
    """Decrement queued counts by successfully-placed allocs
    (reference util.go adjustQueuedAllocations)."""
    if result is None:
        return
    for allocs in result.node_allocation.values():
        for alloc in allocs:
            # only count newly created allocs (create index matches the
            # plan-apply index), not in-place updates
            if alloc.create_index != result.alloc_index:
                continue
            if alloc.task_group in queued:
                queued[alloc.task_group] -= 1
