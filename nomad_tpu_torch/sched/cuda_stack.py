"""CUDA placement stack: the device backend behind the same `Stack`
surface as the oracle chain (reference scheduler/stack.go).

Port of `TPUGenericStack` in `nomad_tpu/sched/tpu_stack.py`.  The
division of labor is the same:

* **Device (ops/score.py K1, ops/batch.py K2)** — fit masks and every
  scoring term over all candidate nodes at once, plus the exact
  emulation of the reference's shuffled limited walk.  A task group
  with count > 1 pre-computes its whole placement loop in one K2
  launch (the look-ahead); count-1 selects and look-ahead misses run
  one K1 launch each.  Each launch costs one device->host copy of an
  int32[2] (or int32[2, P]) result.
* **Host, once per (job, task group)** — constraint compilation to LUT
  masks (ops/constraints.py), affinity vectors, spread desired counts.
* **Host, once per placement** — plan-delta vectors (proposed usage,
  anti-affinity collisions, distinct_hosts), spread use counts and
  distinct_property masks, and exact port/device assignment for the
  single winning node via the oracle BinPackIterator (rank.py).  A
  winner that fails exact verification is masked and the kernel runs
  again.

Scores are float64: placements stay bit-identical to the host oracle.

Not in this slice (each raises or is absent, and is queued in
ROADMAP.md): preemption-mode selects (`options.preempt` raises
NotImplementedError), policy-weighted scoring (a job with a resolved
policy raises NotImplementedError), the placement-explain capture, and
the system stack.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..ops.batch import BatchInputs, plan_picks_full, pow2_bucket
from ..ops.constraints import MaskCompiler
from ..ops.score import NO_NODE, ScoreInputs, score_and_select_packed
from ..structs import (
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY,
    Job,
    Node,
    TaskGroup,
)
from .context import EvalContext
from .propertyset import PropertySet
from .rank import BinPackIterator, RankedNode
from .stack import SelectOptions, compute_visit_limit, task_group_constraints
from .feasible import (
    FILTER_CONSTRAINT_DEVICES,
    FILTER_CONSTRAINT_DRIVERS,
    FILTER_CONSTRAINT_HOST_VOLUMES,
    FILTER_CONSTRAINT_NETWORK,
)

INT32_MAX = 2**31 - 1
LOOKAHEAD_MAX = 128  # picks pre-computed per launch

_LA_MISS = object()  # look-ahead cache miss sentinel


class _SingleNodeSource:
    """Feeds exactly one RankedNode into a BinPackIterator."""

    def __init__(self, ranked: RankedNode) -> None:
        self.ranked = ranked
        self.done = False

    def next(self) -> Optional[RankedNode]:
        if self.done:
            return None
        self.done = True
        return self.ranked

    def reset(self) -> None:
        self.done = False


class CudaGenericStack:
    def __init__(
        self, batch: bool, ctx: EvalContext, device: torch.device
    ) -> None:
        self.batch = batch
        self.ctx = ctx
        self.device = device
        self.table = ctx.state.node_table
        self.compiler = MaskCompiler(self.table)
        self.job: Optional[Job] = None
        self.nodes: List[Node] = []
        self.shuffled_nodes: List[Node] = []
        self.candidate_rows: np.ndarray = np.zeros(0, dtype=np.int32)
        self.perm: np.ndarray = np.zeros(0, dtype=np.int32)
        self.limit = 2
        self._static_mask_cache: Dict[Tuple, Tuple] = {}
        self._affinity_cache: Dict[Tuple, Tuple[np.ndarray, float]] = {}
        self._spread_psets: Dict[str, List[PropertySet]] = {}
        self._spread_info: Dict[str, Dict] = {}
        self._sum_spread_weights = 0
        self._extra_excluded_rows: Set[int] = set()
        # rotating pull offset: the reference StaticIterator keeps its
        # position across selects (feasible.go:75) so consecutive
        # placements continue round-robin through the shuffled list
        self._offset = 0
        # look-ahead pick cache: one K2 launch pre-computes the whole
        # placement loop of a task group
        self._la_rows: Optional[List[int]] = None
        self._la_pulls: List[int] = []
        self._la_idx = 0
        self._la_key: Optional[Tuple] = None
        self._la_counts: Tuple[int, int, int] = (0, 0, 0)
        self._la_generation = -1

    # ------------------------------------------------------------------

    def _t(self, arr) -> torch.Tensor:
        """numpy column -> tensor on the stack's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def set_nodes(self, base_nodes: List[Node]) -> None:
        nodes = list(base_nodes)
        from .feasible import shuffle_nodes

        shuffle_nodes(self.ctx.rng, nodes)
        self.nodes = base_nodes
        self.shuffled_nodes = nodes
        rows = [
            self.table.row_of[n.id]
            for n in nodes
            if n.id in self.table.row_of
        ]
        self.candidate_rows = np.asarray(rows, dtype=np.int32)
        # perm must be a full arena permutation: candidates first, in the
        # shuffled visit order
        present = set(rows)
        perm = rows + [
            r for r in range(self.table.capacity) if r not in present
        ]
        self.perm = np.asarray(perm, dtype=np.int32)
        self.limit = compute_visit_limit(len(nodes), self.batch)
        self._offset = 0
        self._la_rows = None

    def set_job(self, job: Job) -> None:
        if self.job is not None and self.job.version == job.version:
            return
        from .policy import resolve

        if resolve(job) is not None:
            raise NotImplementedError(
                "policy-weighted scoring is not ported to the CUDA stack yet"
            )
        self.job = job
        self.ctx.eligibility.set_job(job)
        self._la_rows = None
        self._static_mask_cache.clear()
        self._affinity_cache.clear()
        self._spread_psets.clear()
        self._spread_info.clear()
        self._sum_spread_weights = 0

    # ------------------------------------------------------------------

    def select(
        self, tg: TaskGroup, options: Optional[SelectOptions] = None
    ) -> Optional[RankedNode]:
        # preferred nodes (sticky ephemeral disk): the oracle tries the
        # preferred node first (stack.py SetNodes + select)
        if options is not None and options.preferred_nodes:
            original_rows = self.candidate_rows
            original_perm = self.perm
            preferred_rows = [
                self.table.row_of[n.id]
                for n in options.preferred_nodes
                if n.id in self.table.row_of
            ]
            self.candidate_rows = np.asarray(
                preferred_rows, dtype=np.int32
            )
            present = set(preferred_rows)
            self.perm = np.asarray(
                preferred_rows
                + [
                    r
                    for r in range(self.table.capacity)
                    if r not in present
                ],
                dtype=np.int32,
            )
            options_new = SelectOptions(
                penalty_node_ids=options.penalty_node_ids,
                preferred_nodes=[],
                preempt=options.preempt,
            )
            self._offset = 0
            option = self.select(tg, options_new)
            # the reference resets the source offset when restoring the
            # original node set (stack.go:119-133 SetNodes)
            self.candidate_rows = original_rows
            self.perm = original_perm
            self._offset = 0
            if option is not None:
                return option
            return self.select(tg, options_new)

        if options is not None and options.preempt:
            raise NotImplementedError(
                "preemption-mode selects are not ported to the CUDA stack yet"
            )

        self.ctx.reset()
        self._extra_excluded_rows = set()
        out = self._lookahead_serve(tg, options)
        if out is not _LA_MISS:
            return out
        return self._select_vectorized(tg, options)

    # ------------------------------------------------------------------

    def _plan_counts(self) -> Tuple[int, int, int]:
        p = self.ctx.plan
        return (
            sum(len(v) for v in p.node_update.values()),
            sum(len(v) for v in p.node_allocation.values()),
            sum(len(v) for v in p.node_preemptions.values()),
        )

    def _lookahead_serve(self, tg: TaskGroup, options):
        """Answer a select from the pre-computed pick cache when the
        scheduler's state advanced exactly as the kernel modelled it:
        same task group and job version, plan grown only by our own
        placements, plain select options.  Each served winner still
        passes exact host verification."""
        if self._la_rows is None:
            return _LA_MISS
        if options is not None and (
            options.penalty_node_ids
            or options.preferred_nodes
            or options.preempt
        ):
            self._la_rows = None
            return _LA_MISS
        if self._la_key != (
            tg.name, self.job.version if self.job else None
        ):
            self._la_rows = None
            return _LA_MISS
        if self.table.generation != self._la_generation:
            self._la_rows = None
            return _LA_MISS
        nu, na, npre = self._plan_counts()
        enu, ena, enpre = self._la_counts
        if nu != enu or npre != enpre or na != ena + self._la_idx:
            self._la_rows = None
            return _LA_MISS
        if self._la_idx >= len(self._la_rows):
            self._la_rows = None
            return _LA_MISS
        row = self._la_rows[self._la_idx]
        pulls = self._la_pulls[self._la_idx]
        n_cand = len(self.candidate_rows)
        if row == NO_NODE:
            self._la_idx += 1
            if n_cand:
                self._offset = (self._offset + pulls) % n_cand
            self._populate_class_eligibility(
                tg, self._static_feasibility(tg)
            )
            self._la_rows = None  # scheduler coalesces after a failure
            return None
        node_id = self.table.node_ids[row]
        option = self._verify_winner(node_id, tg)
        if option is None:
            # count-mask admitted a node exact assignment rejects:
            # poison it and relaunch from current state
            self._extra_excluded_rows.add(row)
            self._la_rows = None
            return _LA_MISS
        self._la_idx += 1
        if n_cand:
            self._offset = (self._offset + pulls) % n_cand
        return option

    # ------------------------------------------------------------------

    def _select_vectorized(
        self, tg: TaskGroup, options: Optional[SelectOptions]
    ) -> Optional[RankedNode]:
        C = self.table.capacity

        _checks, static_mask = self._static_checks(tg)

        candidate_mask = np.zeros(C, dtype=bool)
        candidate_mask[self.candidate_rows] = True

        d_cpu, d_mem, d_disk, collisions, job_rows, job_tg_rows = (
            self._plan_adjusted_state(tg)
        )

        mask = candidate_mask & static_mask & self.table.active
        csi_mask = self._csi_feasibility(tg)
        if csi_mask is not None:
            mask &= csi_mask
        if self._extra_excluded_rows:
            mask[list(self._extra_excluded_rows)] = False

        # distinct_hosts (feasible.go:470)
        job_distinct = any(
            c.operand == CONSTRAINT_DISTINCT_HOSTS
            for c in self.job.constraints
        )
        tg_distinct = any(
            c.operand == CONSTRAINT_DISTINCT_HOSTS for c in tg.constraints
        )
        dh_rows: Set[int] = set()
        if job_distinct:
            dh_rows = {int(r) for r in job_rows}
        elif tg_distinct:
            dh_rows = {int(r) for r in job_tg_rows}
        if dh_rows:
            mask[list(dh_rows)] = False

        # distinct_property (feasible.go:569)
        mask &= self._distinct_property_mask(tg)

        penalty = np.zeros(C, dtype=bool)
        if options is not None and options.penalty_node_ids:
            for node_id in options.penalty_node_ids:
                row = self.table.row_of.get(node_id)
                if row is not None:
                    penalty[row] = True

        affinity_vec = self._affinity_vector(tg)
        spread_vec, has_spreads = self._spread_vector(tg)

        has_affinities = bool(
            list(self.job.affinities)
            or list(tg.affinities)
            or any(t.affinities for t in tg.tasks)
        )
        # affinities and spreads survey every candidate (stack.py select)
        limit = (
            INT32_MAX if (has_affinities or has_spreads) else self.limit
        )

        ask_cpu = float(sum(t.resources.cpu for t in tg.tasks))
        ask_mem = float(sum(t.resources.memory_mb for t in tg.tasks))
        ask_disk = float(tg.ephemeral_disk.size_mb)

        # rotate the candidate portion of the perm by the accumulated
        # pull offset (StaticIterator round-robin continuation)
        n_cand = len(self.candidate_rows)
        cand = self.perm[:n_cand]
        rest = self.perm[n_cand:]
        off = self._offset % n_cand if n_cand else 0
        rotated = np.concatenate(
            [cand[off:], cand[:off], rest]
        ).astype(np.int32)

        spread_fit = (
            self.ctx.state.scheduler_config().effective_scheduler_algorithm()
            == "spread"
        )
        cpu_total = self._t(self.table.cpu_total)
        mem_total = self._t(self.table.mem_total)
        disk_total = self._t(self.table.disk_total)
        # look-ahead: when the remaining placement loop is plain (no
        # penalties/spreads/distinct_property), pre-compute the whole
        # pick sequence in ONE launch; subsequent selects answer from
        # the cache (generic_sched.go:468 computePlacements loop)
        use_lookahead = (
            tg.count > 1
            and n_cand > 1
            and not has_spreads
            and (options is None or not options.penalty_node_ids)
            and not any(
                c.operand == CONSTRAINT_DISTINCT_PROPERTY
                for c in list(self.job.constraints) + list(tg.constraints)
            )
        )
        if use_lookahead:
            P = min(LOOKAHEAD_MAX, int(tg.count))
            binp = BatchInputs(
                feasible=self._t(mask),
                base_cpu_used=self._t(self.table.cpu_used + d_cpu),
                base_mem_used=self._t(self.table.mem_used + d_mem),
                base_disk_used=self._t(self.table.disk_used + d_disk),
                base_collisions=self._t(collisions),
                penalty=self._t(penalty),
                affinity_score=self._t(affinity_vec),
                perm=self._t(rotated),
                ask_cpu=ask_cpu,
                ask_mem=ask_mem,
                ask_disk=ask_disk,
                desired_count=int(tg.count),
                limit=int(limit),
                distinct_hosts=bool(job_distinct or tg_distinct),
            )
            # one device->host copy for the whole pick sequence
            packed = plan_picks_full(
                cpu_total, mem_total, disk_total, binp, n_cand,
                pow2_bucket(P), spread_fit=spread_fit,
            ).cpu().numpy()
            self._la_rows = [int(r) for r in packed[0, :P]]
            self._la_pulls = [int(p) for p in packed[1, :P]]
            self._la_idx = 0
            self._la_key = (tg.name, self.job.version)
            self._la_counts = self._plan_counts()
            self._la_generation = self.table.generation
            out = self._lookahead_serve(tg, options)
            if out is not _LA_MISS:
                return out
            # first pick failed exact verification: rebuild with the
            # poisoned row excluded
            return self._select_vectorized(tg, options)

        inputs = ScoreInputs(
            cpu_total=cpu_total,
            mem_total=mem_total,
            disk_total=disk_total,
            cpu_used=self._t(self.table.cpu_used + d_cpu),
            mem_used=self._t(self.table.mem_used + d_mem),
            disk_used=self._t(self.table.disk_used + d_disk),
            feasible=self._t(mask),
            collisions=self._t(collisions),
            penalty=self._t(penalty),
            affinity_score=self._t(affinity_vec),
            spread_boost=self._t(spread_vec),
            perm=self._t(rotated),
            ask_cpu=ask_cpu,
            ask_mem=ask_mem,
            ask_disk=ask_disk,
            desired_count=int(tg.count),
            limit=int(limit),
            n_candidates=n_cand,
        )

        while True:
            # one device->host copy per select
            packed = score_and_select_packed(
                inputs, spread_fit=spread_fit
            ).cpu().numpy()
            chosen_row, pulls = int(packed[0]), int(packed[1])
            if chosen_row == NO_NODE:
                if n_cand:
                    self._offset = (self._offset + pulls) % n_cand
                self._populate_class_eligibility(tg, static_mask)
                return None
            node_id = self.table.node_ids[chosen_row]
            option = self._verify_winner(node_id, tg)
            if option is not None:
                if n_cand:
                    self._offset = (self._offset + pulls) % n_cand
                return option
            # count-mask admitted a node exact assignment rejects
            # (e.g. specific port collision): exclude and re-run; the
            # rejected node becomes an infeasible pull, exactly as if
            # binpack had exhausted it mid-walk
            self._extra_excluded_rows.add(chosen_row)
            mask = mask.copy()
            mask[chosen_row] = False
            inputs = inputs._replace(feasible=self._t(mask))

    # ------------------------------------------------------------------

    def _verify_winner(
        self, node_id: str, tg: TaskGroup
    ) -> Optional[RankedNode]:
        """Exact port/device assignment + fit for the winning node via the
        oracle binpack step (rank.py BinPackIterator)."""
        node = self.ctx.state.node_by_id(node_id)
        if node is None:
            return None
        ranked = RankedNode(node=node)
        source = _SingleNodeSource(ranked)
        algorithm = (
            self.ctx.state.scheduler_config().effective_scheduler_algorithm()
        )
        binpack = BinPackIterator(
            self.ctx, source, False, self.job.priority, algorithm
        )
        binpack.set_job(self.job)
        binpack.set_task_group(tg)
        return binpack.next()

    # ------------------------------------------------------------------

    def _csi_feasibility(self, tg: TaskGroup) -> Optional[np.ndarray]:
        """Dynamic CSI mask (reference feasible.go:194): resolve each
        requested volume to its plugin column; a missing/unclaimable
        volume rules out every node.  Not cached — claims move with
        every plan apply."""
        reqs = [r for r in tg.volumes.values() if r.type == "csi"]
        if not reqs:
            return None
        out = np.ones(self.table.capacity, dtype=bool)
        for req in reqs:
            vol = self.ctx.state.csi_volume_by_id(
                self.job.namespace, req.source
            )
            if vol is None or not vol.claimable(req.read_only):
                out[:] = False
                return out
            col = self.table.column(f"csi.{vol.plugin_id}")
            out &= col.codes != -1
        return out

    def _static_checks(self, tg: TaskGroup):
        """Ordered ``(mask, label, level)`` triples in the serial
        FeasibilityWrapper's exact checker order (stack.py
        GenericStack: job constraints; then drivers, tg+task
        constraints, host volumes, devices, network), plus the
        combined AND with node eligibility folded in."""
        key = (self.job.id, self.job.version, tg.name, self.table.generation)
        cached = self._static_mask_cache.get(key)
        if cached is not None:
            return cached
        C = self.table.capacity
        checks: List[Tuple[np.ndarray, str, str]] = []

        for constraint in self.job.constraints:
            m = self.compiler.constraint_mask(constraint)
            if m is not None:
                checks.append((m, str(constraint), "job"))

        constraints, drivers = task_group_constraints(tg)
        if drivers:
            driver_mask = np.ones(C, dtype=bool)
            for driver in drivers:
                col = self.table.column(f"driver.{driver}")
                driver_mask &= col.codes != -1
            checks.append(
                (driver_mask, FILTER_CONSTRAINT_DRIVERS, "tg")
            )
        for constraint in constraints:
            m = self.compiler.constraint_mask(constraint)
            if m is not None:
                checks.append((m, str(constraint), "tg"))
        for name, req in tg.volumes.items():
            if req.type == "host":
                col = self.table.column(f"hostvol.{req.source}")
                if req.read_only:
                    m = col.codes != -1
                else:
                    rw_code = col.interner.lookup("rw")
                    m = col.codes == rw_code
                checks.append(
                    (m, FILTER_CONSTRAINT_HOST_VOLUMES, "tg")
                )
            # csi is handled dynamically in select(): volume records
            # and claim capacity change without a table-generation bump
        device_reqs = [
            req for task in tg.tasks for req in task.resources.devices
        ]
        dev_mask = self.compiler.device_feasibility(device_reqs)
        if dev_mask is not None:
            checks.append((dev_mask, FILTER_CONSTRAINT_DEVICES, "tg"))
        if tg.networks:
            mode = tg.networks[0].mode or "host"
            if mode != "host":
                col = self.table.column(f"netmode.{mode}")
                checks.append(
                    (col.codes != -1, FILTER_CONSTRAINT_NETWORK, "tg")
                )

        combined = self.table.eligible.copy()
        for m, _label, _level in checks:
            combined &= m
        cached = (checks, combined)
        self._static_mask_cache[key] = cached
        return cached

    def _static_feasibility(self, tg: TaskGroup) -> np.ndarray:
        return self._static_checks(tg)[1]

    # ------------------------------------------------------------------

    def _plan_adjusted_state(self, tg: TaskGroup):
        """Proposed-alloc deltas relative to the store's live usage
        columns, plus job/job+tg proposed rows and collision counts
        (mirrors context.go:120 ProposedAllocs applied columnarly)."""
        C = self.table.capacity
        d_cpu = np.zeros(C, dtype=np.float64)
        d_mem = np.zeros(C, dtype=np.float64)
        d_disk = np.zeros(C, dtype=np.float64)
        collisions = np.zeros(C, dtype=np.int32)
        job_rows: Set[int] = set()
        job_tg_rows: Set[int] = set()

        plan = self.ctx.plan
        state = self.ctx.state
        removed_ids: Set[str] = set()

        for node_id, allocs in plan.node_update.items():
            row = self.table.row_of.get(node_id)
            for alloc in allocs:
                removed_ids.add(alloc.id)
                if row is None:
                    continue
                existing = state.alloc_by_id(alloc.id)
                if existing is not None and not existing.terminal_status():
                    res = existing.comparable_resources()
                    d_cpu[row] -= res.cpu
                    d_mem[row] -= res.memory_mb
                    d_disk[row] -= res.disk_mb
        for node_id, allocs in plan.node_preemptions.items():
            row = self.table.row_of.get(node_id)
            for alloc in allocs:
                removed_ids.add(alloc.id)
                if row is None:
                    continue
                existing = state.alloc_by_id(alloc.id)
                if existing is not None and not existing.terminal_status():
                    res = existing.comparable_resources()
                    d_cpu[row] -= res.cpu
                    d_mem[row] -= res.memory_mb
                    d_disk[row] -= res.disk_mb
        plan_alloc_ids: Set[str] = set()
        for node_id, allocs in plan.node_allocation.items():
            row = self.table.row_of.get(node_id)
            if row is None:
                continue
            for alloc in allocs:
                plan_alloc_ids.add(alloc.id)
                res = alloc.comparable_resources()
                d_cpu[row] += res.cpu
                d_mem[row] += res.memory_mb
                d_disk[row] += res.disk_mb
                existing = state.alloc_by_id(alloc.id)
                if (
                    existing is not None
                    and not existing.terminal_status()
                    and alloc.id not in removed_ids
                ):
                    # in-place replacement: the old version's usage is in
                    # the base columns; back it out
                    old = existing.comparable_resources()
                    d_cpu[row] -= old.cpu
                    d_mem[row] -= old.memory_mb
                    d_disk[row] -= old.disk_mb
                if alloc.job_id == self.job.id:
                    job_rows.add(row)
                    if alloc.task_group == tg.name:
                        job_tg_rows.add(row)
                        collisions[row] += 1

        # existing state allocs of this job
        for alloc in state.allocs_by_job(
            self.job.namespace, self.job.id
        ):
            if alloc.terminal_status():
                continue
            if alloc.id in removed_ids or alloc.id in plan_alloc_ids:
                continue
            row = self.table.row_of.get(alloc.node_id)
            if row is None:
                continue
            job_rows.add(row)
            if alloc.task_group == tg.name:
                job_tg_rows.add(row)
                collisions[row] += 1
        return d_cpu, d_mem, d_disk, collisions, job_rows, job_tg_rows

    # ------------------------------------------------------------------

    def _affinity_vector(self, tg: TaskGroup) -> np.ndarray:
        key = (tg.name, self.table.generation)
        cached = self._affinity_cache.get(key)
        if cached is None:
            affinities = (
                list(self.job.affinities)
                + list(tg.affinities)
                + [a for t in tg.tasks for a in t.affinities]
            )
            total, sum_weight = self.compiler.affinity_score_vector(
                affinities
            )
            vec = (
                total / sum_weight
                if sum_weight
                else np.zeros(self.table.capacity)
            )
            cached = (vec, sum_weight)
            self._affinity_cache[key] = cached
        return cached[0]

    # ------------------------------------------------------------------

    def _spread_vector(self, tg: TaskGroup) -> Tuple[np.ndarray, bool]:
        """Total spread boost per node (spread.py semantics, vectorized
        per select because use counts track the accumulating plan)."""
        C = self.table.capacity
        combined = list(tg.spreads) + list(self.job.spreads)
        if not combined:
            return np.zeros(C, dtype=np.float64), False

        if tg.name not in self._spread_psets:
            psets = []
            # job-level spreads first, then tg-level (spread.go:79-92)
            for spread in list(self.job.spreads) + list(tg.spreads):
                pset = PropertySet(self.ctx, self.job)
                pset.set_target_attribute(spread.attribute, tg.name)
                psets.append(pset)
            self._spread_psets[tg.name] = psets
            from .spread import compute_spread_info

            info, sum_weights = compute_spread_info(combined, tg.count)
            self._spread_info[tg.name] = info
            self._sum_spread_weights = sum_weights
        else:
            for pset in self._spread_psets[tg.name]:
                pset.populate_proposed()

        total = np.zeros(C, dtype=np.float64)
        info = self._spread_info[tg.name]
        for pset in self._spread_psets[tg.name]:
            attr_info = info.get(pset.target_attribute)
            if attr_info is None:
                continue
            desired_counts = attr_info["desired_counts"]
            combined_use = pset.get_combined_use_map()
            if desired_counts:
                weight_frac = float(attr_info["weight"]) / float(
                    self._sum_spread_weights
                )
                total += self.compiler.spread_boost_vector(
                    pset.target_attribute,
                    weight_frac,
                    desired_counts,
                    combined_use,
                )
            else:
                total += self.compiler.spread_boost_vector(
                    pset.target_attribute, None, None, combined_use
                )
        return total, True

    # ------------------------------------------------------------------

    def _distinct_property_mask(self, tg: TaskGroup) -> np.ndarray:
        """Distinct-property feasibility mask (feasible.go:569): a node
        is out once its property value has been used `allowed` times by
        the job's live and proposed allocs."""
        C = self.table.capacity
        mask = np.ones(C, dtype=bool)
        constraints = [
            (c, "")
            for c in self.job.constraints
            if c.operand == CONSTRAINT_DISTINCT_PROPERTY
        ] + [
            (c, tg.name)
            for c in tg.constraints
            if c.operand == CONSTRAINT_DISTINCT_PROPERTY
        ]
        if not constraints:
            return mask
        from .feasible import target_column_key

        for constraint, scope in constraints:
            pset = PropertySet(self.ctx, self.job)
            pset.set_constraint(constraint, scope)
            key = target_column_key(constraint.ltarget)
            if not key:
                continue
            col = self.table.column(key)
            combined = pset.get_combined_use_map()
            allowed = pset.allowed_count
            lut = np.ones(len(col.interner.values) + 1, dtype=bool)
            for i, value in enumerate(col.interner.values):
                lut[i] = combined.get(value, 0) < allowed
            lut[-1] = False  # missing property fails
            mask &= lut[col.codes]
        return mask

    # ------------------------------------------------------------------

    def _populate_class_eligibility(
        self, tg: TaskGroup, static_mask: np.ndarray
    ) -> None:
        """After a failed placement, record which computed classes passed
        the feasibility layer so blocked evals unblock correctly
        (context.go:190 EvalEligibility; mask-derived here)."""
        elig = self.ctx.eligibility
        col = self.table.column("node.computed_class")
        candidate_mask = np.zeros(self.table.capacity, dtype=bool)
        candidate_mask[self.candidate_rows] = True
        active = candidate_mask & self.table.active & self.table.eligible
        for code, klass in enumerate(col.interner.values):
            rows = (col.codes == code) & active
            if not rows.any():
                continue
            ok = bool((rows & static_mask).any())
            if not elig.job_escaped:
                elig.set_job_eligibility(ok, klass)
            if not elig.tg_escaped.get(tg.name, False):
                elig.set_task_group_eligibility(ok, tg.name, klass)
