"""Preemption candidate selection (reference scheduler/preemption.go).

The greedy pick with cross-alloc dependencies is inherently sequential
(preemption.go:218-251) and stays on the host, but its inner scan —
`basicResourceDistance` + the max_parallel penalty over every remaining
candidate, re-evaluated per pick — is pure arithmetic over a (k x 3)
candidate resource matrix and runs vectorized
(`preemption_distances`).  The TPU select path evaluates preemption
only for nodes whose vectorized fit mask failed AND whose preemptible
resource sum covers the shortfall (tpu_stack._preempt_select), so the
per-node greedy runs on a small surviving set instead of the whole
walk being delegated to a shadow oracle.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..structs import (
    AllocatedResources,
    Allocation,
    ComparableResources,
    Node,
    PREEMPTION_PRIORITY_DELTA,
)

# Penalty applied when an alloc's task group has hit its migrate-stanza
# max_parallel in the current preemption set (reference preemption.go:13).
MAX_PARALLEL_PENALTY = 50.0


def basic_resource_distance(
    ask: ComparableResources, used: ComparableResources
) -> float:
    """Euclidean distance in (cpu, mem, disk) ask-relative coordinates
    (reference preemption.go:608 basicResourceDistance)."""
    mem_coord = cpu_coord = disk_coord = 0.0
    if ask.memory_mb > 0:
        mem_coord = (ask.memory_mb - used.memory_mb) / float(ask.memory_mb)
    if ask.cpu > 0:
        cpu_coord = (ask.cpu - used.cpu) / float(ask.cpu)
    if ask.disk_mb > 0:
        disk_coord = (ask.disk_mb - used.disk_mb) / float(ask.disk_mb)
    return math.sqrt(mem_coord**2 + cpu_coord**2 + disk_coord**2)


def score_for_task_group(
    ask: ComparableResources,
    used: ComparableResources,
    max_parallel: int,
    num_preempted: int,
) -> float:
    penalty = 0.0
    if max_parallel > 0 and num_preempted >= max_parallel:
        penalty = float((num_preempted + 1) - max_parallel) * MAX_PARALLEL_PENALTY
    return basic_resource_distance(ask, used) + penalty


def preemption_distances(
    needed: ComparableResources,
    res_matrix: np.ndarray,  # f64[k, 3] candidate (cpu, mem, disk)
    max_parallel: np.ndarray,  # i64[k]
    num_preempted: np.ndarray,  # i64[k]
) -> np.ndarray:
    """Vectorized `score_for_task_group` over k candidates: the
    distance arithmetic of preemption.go:608 + the max_parallel penalty
    of preemption.go:773, one fused pass instead of a Python loop per
    candidate per pick."""
    coords = np.zeros_like(res_matrix)
    ask = np.asarray(
        [needed.cpu, needed.memory_mb, needed.disk_mb], dtype=np.float64
    )
    nz = ask > 0
    coords[:, nz] = (ask[nz] - res_matrix[:, nz]) / ask[nz]
    dist = np.sqrt(np.sum(coords * coords, axis=1))
    over = (max_parallel > 0) & (num_preempted >= max_parallel)
    penalty = np.where(
        over,
        (num_preempted + 1 - max_parallel) * MAX_PARALLEL_PENALTY,
        0.0,
    )
    return dist + penalty


class Preemptor:
    """(reference preemption.go:96)"""

    def __init__(self, job_priority: int, job_ns_id: Tuple[str, str]) -> None:
        self.job_priority = job_priority
        self.job_ns_id = job_ns_id
        self.current_preemptions: Dict[Tuple[str, str, str], int] = {}
        self.alloc_resources: Dict[str, ComparableResources] = {}
        self.alloc_max_parallel: Dict[str, int] = {}
        self.current_allocs: List[Allocation] = []
        self.node_remaining: Optional[ComparableResources] = None

    def set_node(self, node: Node) -> None:
        remaining = node.comparable_resources()
        remaining.subtract(node.comparable_reserved_resources())
        self.node_remaining = remaining

    def set_candidates(self, allocs: List[Allocation]) -> None:
        self.current_allocs = []
        for alloc in allocs:
            if (alloc.namespace, alloc.job_id) == (
                self.job_ns_id[0],
                self.job_ns_id[1],
            ):
                continue
            max_parallel = 0
            if alloc.job is not None:
                tg = alloc.job.lookup_task_group(alloc.task_group)
                if tg is not None and tg.migrate is not None:
                    max_parallel = tg.migrate.max_parallel
            self.alloc_max_parallel[alloc.id] = max_parallel
            self.alloc_resources[alloc.id] = alloc.comparable_resources()
            self.current_allocs.append(alloc)

    def set_preemptions(self, allocs: List[Allocation]) -> None:
        self.current_preemptions = {}
        for alloc in allocs:
            key = (alloc.namespace, alloc.job_id, alloc.task_group)
            self.current_preemptions[key] = (
                self.current_preemptions.get(key, 0) + 1
            )

    def _num_preemptions(self, alloc: Allocation) -> int:
        return self.current_preemptions.get(
            (alloc.namespace, alloc.job_id, alloc.task_group), 0
        )

    def preempt_for_task_group(
        self, ask: AllocatedResources
    ) -> List[Allocation]:
        """Greedy distance-based preemption for CPU/mem/disk
        (reference preemption.go:198 PreemptForTaskGroup)."""
        needed = ask.comparable()
        asked = ask.comparable()

        node_remaining = ComparableResources(
            self.node_remaining.cpu,
            self.node_remaining.memory_mb,
            self.node_remaining.disk_mb,
            self.node_remaining.network_mbits,
        )
        for alloc in self.current_allocs:
            node_remaining.subtract(self.alloc_resources[alloc.id])

        groups = self._filter_and_group(self.current_allocs)

        best: List[Allocation] = []
        met = False
        available = ComparableResources(
            node_remaining.cpu,
            node_remaining.memory_mb,
            node_remaining.disk_mb,
            node_remaining.network_mbits,
        )

        for _priority, allocs in groups:
            allocs = list(allocs)
            # candidate resource matrix + penalty inputs, built once per
            # priority group; the greedy loop scores every remaining
            # candidate in one vectorized pass per pick
            res = np.asarray(
                [
                    [
                        self.alloc_resources[a.id].cpu,
                        self.alloc_resources[a.id].memory_mb,
                        self.alloc_resources[a.id].disk_mb,
                    ]
                    for a in allocs
                ],
                dtype=np.float64,
            ).reshape(len(allocs), 3)
            maxp = np.asarray(
                [self.alloc_max_parallel[a.id] for a in allocs],
                dtype=np.int64,
            )
            # current_preemptions is fixed for the duration of the
            # greedy loop (set_preemptions is the only mutator)
            nump = np.asarray(
                [self._num_preemptions(a) for a in allocs],
                dtype=np.int64,
            )
            alive = np.ones(len(allocs), dtype=bool)
            while alive.any() and not met:
                distances = preemption_distances(
                    needed, res, maxp, nump
                )
                distances[~alive] = math.inf
                best_index = int(np.argmin(distances))
                alive[best_index] = False
                closest = allocs[best_index]
                closest_resources = self.alloc_resources[closest.id]
                available.add(closest_resources)
                met, _dim = available.superset(asked)
                best.append(closest)
                needed.subtract(closest_resources)
            if met:
                break

        if not met:
            return []
        return self._filter_superset(best, node_remaining, asked)

    def preempt_for_network(self, ask, net_idx) -> Optional[List[Allocation]]:
        """Network preemption: not yet vectorized; conservative None keeps
        the node exhausted rather than mis-preempting
        (reference preemption.go:270 PreemptForNetwork)."""
        return None

    def preempt_for_device(self, ask, allocator) -> Optional[List[Allocation]]:
        """Device preemption (reference preemption.go:472): pick lowest
        net-priority preemptible allocs holding matching instances."""
        needed = ask.count
        candidates: List[Tuple[Allocation, int]] = []
        for alloc in self.current_allocs:
            if alloc.job is None:
                continue
            if self.job_priority - alloc.job.priority < PREEMPTION_PRIORITY_DELTA:
                continue
            held = 0
            ar = alloc.allocated_resources
            if ar is None:
                continue
            for tr in ar.tasks.values():
                for dev in tr.devices:
                    probe = "/".join(
                        x for x in (dev.vendor, dev.type, dev.name) if x
                    )
                    from ..structs import DeviceIdTuple

                    if DeviceIdTuple(dev.vendor, dev.type, dev.name).matches(
                        ask.name
                    ):
                        held += len(dev.device_ids)
            if held > 0:
                candidates.append((alloc, held))
        if not candidates:
            return None
        candidates.sort(key=lambda c: (-c[1], c[0].job.priority))
        chosen: List[Allocation] = []
        freed = 0
        for alloc, held in candidates:
            if freed >= needed:
                break
            chosen.append(alloc)
            freed += held
        if freed < needed:
            return None
        return chosen

    def _filter_and_group(
        self, current: List[Allocation]
    ) -> List[Tuple[int, List[Allocation]]]:
        """(reference preemption.go:666 filterAndGroupPreemptibleAllocs)"""
        by_priority: Dict[int, List[Allocation]] = {}
        for alloc in current:
            if alloc.job is None:
                continue
            if (
                self.job_priority - alloc.job.priority
                < PREEMPTION_PRIORITY_DELTA
            ):
                continue
            by_priority.setdefault(alloc.job.priority, []).append(alloc)
        return sorted(by_priority.items(), key=lambda kv: kv[0])

    def _filter_superset(
        self,
        best: List[Allocation],
        node_remaining: ComparableResources,
        asked: ComparableResources,
    ) -> List[Allocation]:
        """(reference preemption.go:702 filterSuperset)"""
        best = sorted(
            best,
            key=lambda a: basic_resource_distance(
                asked, self.alloc_resources[a.id]
            ),
            reverse=True,
        )
        available = ComparableResources(
            node_remaining.cpu,
            node_remaining.memory_mb,
            node_remaining.disk_mb,
            node_remaining.network_mbits,
        )
        filtered: List[Allocation] = []
        for alloc in best:
            filtered.append(alloc)
            available.add(self.alloc_resources[alloc.id])
            met, _dim = available.superset(asked)
            if met:
                break
        return filtered
