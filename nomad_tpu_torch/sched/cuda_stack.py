"""CUDA placement stack: the device backend behind the same `Stack`
surface as the oracle chain (reference scheduler/stack.go).

Port of `TPUGenericStack` in `nomad_tpu/sched/tpu_stack.py`.  The
division of labor is the same:

* **Device (ops/score.py K1 and K6, ops/batch.py K2)** — fit masks and
  every scoring term over all candidate nodes at once, plus the exact
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

Preemption mode (`options.preempt`) scores on the host: the fitting
nodes with the same vector arithmetic in numpy (which, unlike the
compiled K1 program, does not fuse `fitness / 18 + anti` into an fma),
and only nodes whose fit failed and whose preemptible allocs cover the
shortfall get the exact per-node evaluation (oracle BinPackIterator
with evict=True).  Their exact scores — binpack after eviction plus
the logistic net-priority term — are spliced into the score vector,
and kernel K6 (`csrc/walk_only.cu`) walks it.

The explain capture rebuilds the serial chain's whole AllocMetric
(nodes evaluated, filter and exhaustion attribution, the per-node score
decomposition) from the arrays each select already computed, whenever
`explain.EXPLAIN.enabled` (the default; ``NOMAD_TPU_EXPLAIN=0`` turns it
off).

A job whose PolicySpec resolves (`sched/policy.py`) is scored with the
policy terms: the throughput and migration vectors, pre-scaled on the
host, ride into K1 (`ops.score.PolicyTerms`) and into the preemption
scores, the walk surveys every candidate, and the capture records the
`policy.throughput` and `policy.migration` components.

Scores are float64: placements stay bit-identical to the host oracle.
A failure of a kernel's build, launch or fetch raises
`device.DeviceFault`.

Not in the port yet (queued in ROADMAP.md): the system stack.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..device import DeviceFault
from ..explain import EXPLAIN
from ..ops.batch import BatchInputs, plan_picks_full, pow2_bucket
from ..ops.constraints import MaskCompiler
from ..ops.score import (
    NO_NODE,
    PolicyTerms,
    ScoreInputs,
    score_and_select_packed,
    walk_only,
)
from ..structs import (
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY,
    Job,
    Node,
    NodeScoreMeta,
    TaskGroup,
)
from .context import (
    CLASS_ELIGIBLE,
    CLASS_ESCAPED,
    CLASS_INELIGIBLE,
    CLASS_UNKNOWN,
    EvalContext,
)
from .propertyset import PropertySet
from .rank import BinPackIterator, RankedNode
from .stack import SelectOptions, compute_visit_limit, task_group_constraints
from .feasible import (
    FILTER_CLASS_INELIGIBLE,
    FILTER_CONSTRAINT_CSI_VOLUMES,
    FILTER_CONSTRAINT_DEVICES,
    FILTER_CONSTRAINT_DRIVERS,
    FILTER_CONSTRAINT_HOST_VOLUMES,
    FILTER_CONSTRAINT_NETWORK,
)

INT32_MAX = 2**31 - 1
LOOKAHEAD_MAX = 128  # picks pre-computed per launch

_LA_MISS = object()  # look-ahead cache miss sentinel


def _asks(tg: TaskGroup) -> Tuple[float, float, float]:
    """The task group's cpu, memory and disk ask."""
    return (
        float(sum(t.resources.cpu for t in tg.tasks)),
        float(sum(t.resources.memory_mb for t in tg.tasks)),
        float(tg.ephemeral_disk.size_mb),
    )


def _on_device(what: str, fn):
    """Run one kernel call and its fetch; a failure is a DeviceFault."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001
        raise DeviceFault(f"{what} failed on the device") from exc


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
        # explain capture's shadow of the FeasibilityWrapper's
        # computed-class memoization.  Deliberately NOT the shared
        # EvalEligibility: that feeds blocked-eval unblocking, and an
        # observability layer must never change scheduler behavior
        # with its opt-out flag
        self._explain_job_elig: Dict[str, int] = {}
        self._explain_tg_elig: Dict[str, Dict[str, int]] = {}

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
        self.job = job
        self.ctx.eligibility.set_job(job)
        self._la_rows = None
        self._static_mask_cache.clear()
        self._affinity_cache.clear()
        self._spread_psets.clear()
        self._spread_info.clear()
        self._sum_spread_weights = 0
        self._explain_job_elig.clear()
        self._explain_tg_elig.clear()

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
            return self._preempt_select(tg, options)

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

    def _policy_state(self, tg: TaskGroup, dtype=np.float64):
        """The job's resolved policy plus arena-shaped, PRE-SCALED term
        vectors (sched/policy.py, ops/score.py PolicyTerms): ``(resolved,
        tput_term[C] | None, mig_term[C] | None)``, or None.  An inert
        group stays None.  The throughput tensor is cached keyed by
        (table epoch, job version, topo generation); the stickiness
        vector is rebuilt per select from the job's live allocs."""
        from .policy import (
            migration_vector,
            resolve,
            sticky_node_ids,
            tput_tensor,
        )

        pol = resolve(self.job)
        if pol is None:
            return None
        tput_term = None
        if pol.has_tput:
            tput_term = pol.tput_coef * tput_tensor(
                pol, self.job, self.table, dtype=dtype
            )
        sticky = sticky_node_ids(pol, self.job, tg.name, self.ctx.state)
        mig_term = None
        if sticky:
            mig_term = pol.mig_coef * migration_vector(
                sticky, self.table, dtype=dtype
            )
        return pol, tput_term, mig_term

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
            self._capture_lookahead(tg, pulls)
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
            # poison it and relaunch from current state.  No explain
            # capture here: the rejection's exhaustion was recorded by
            # the verify chain, and the relaunch's walk captures this
            # placement's full metrics with the row poisoned
            self._extra_excluded_rows.add(row)
            self._la_rows = None
            return _LA_MISS
        self._capture_lookahead(tg, pulls)
        self._la_idx += 1
        if n_cand:
            self._offset = (self._offset + pulls) % n_cand
        return option

    # ------------------------------------------------------------------

    def _preempt_select(self, tg, options):
        """Preemption-mode select.

        The normal-fit mask and scores come from the plain path's
        vector arithmetic, computed here in numpy; only nodes whose fit
        FAILED and whose preemptible resource sum covers the shortfall
        get the exact per-node evaluation (oracle BinPackIterator with
        evict=True).  Their exact scores — binpack after eviction plus
        the logistic net-priority term (rank.go:714) — are spliced into
        the score vector, and kernel K6 runs the same limited walk as
        the plain path over it, so decisions stay bit-identical to the
        sequential chain.

        The scores are numpy's: ``fitness / 18.0 + anti`` is a division
        and an add, each rounded (the compiled K1 program fuses them
        into one fma), and a spliced row is ``np.mean`` of its terms.
        K1's arithmetic would move the last bits and with them the walk.

        Between re-walks the score and feasibility vectors stay on the
        device; only the row that changed is written.

        Known edge divergence (kept from the JAX package): a node whose
        cpu/mem/disk fit but whose ports/devices are exhausted by
        preemptible allocs initially carries its non-evict score in the
        walk; the verify-retry loop corrects it to the evict score only
        if it wins a round.  If the corrected (higher) score would have
        beaten the winner, the oracle can pick it where this path does
        not — detecting such nodes up front would need the exact
        per-node evaluation for every port-constrained node."""
        from ..structs import PREEMPTION_PRIORITY_DELTA
        from ..structs.funcs import net_priority as _net_priority
        from ..structs.funcs import preemption_score

        C = self.table.capacity
        self.ctx.reset()
        checks, static_mask = self._static_checks(tg)
        candidate_mask = np.zeros(C, dtype=bool)
        candidate_mask[self.candidate_rows] = True
        d_cpu, d_mem, d_disk, collisions, job_rows, job_tg_rows = (
            self._plan_adjusted_state(tg)
        )
        mask = candidate_mask & static_mask & self.table.active
        csi_mask = self._csi_feasibility(tg)
        if csi_mask is not None:
            mask &= csi_mask
        # NOTE: _extra_excluded_rows (exact non-evict rejections from
        # the preceding plain select) are deliberately NOT applied —
        # the oracle's preempt pass re-evaluates those nodes with
        # eviction, and so does the verify-retry loop below
        distinct_hosts, dh_rows = self._distinct_hosts(
            tg, job_rows, job_tg_rows
        )
        if dh_rows:
            mask[list(dh_rows)] = False
        dp_mask, dp_psets = self._distinct_property_state(tg)
        mask &= dp_mask

        penalty = np.zeros(C, dtype=bool)
        if options is not None and options.penalty_node_ids:
            for node_id in options.penalty_node_ids:
                row = self.table.row_of.get(node_id)
                if row is not None:
                    penalty[row] = True
        affinity_vec = self._affinity_vector(tg)
        spread_vec, has_spreads = self._spread_vector(tg)
        has_affinities = self._has_affinities(tg)
        policy_state = self._policy_state(tg)
        limit = (
            INT32_MAX
            if (has_affinities or has_spreads or policy_state is not None)
            else self.limit
        )
        ask_cpu, ask_mem, ask_disk = _asks(tg)

        used_cpu = self.table.cpu_used + d_cpu
        used_mem = self.table.mem_used + d_mem
        used_disk = self.table.disk_used + d_disk
        fit = (
            (used_cpu + ask_cpu <= self.table.cpu_total)
            & (used_mem + ask_mem <= self.table.mem_total)
            & (used_disk + ask_disk <= self.table.disk_total)
        )

        scores = np.full(C, -np.inf)
        feasible = mask & fit
        preempt_options: dict = {}
        # rows the exact evict chain already evaluated (its metric side
        # effects — exhaustion dims, binpack/preemption scores — land
        # on ctx.metrics through the shared BinPackIterator, so the
        # explain capture must not count them twice)
        evict_checked: Set[int] = set()
        spread_fit = self._spread_fit()
        fitness = self._fitness(used_cpu, used_mem, ask_cpu, ask_mem,
                                spread_fit)
        # policy term vectors (the serial PolicyIterator sits between
        # spread and preemption scoring, so these append after spread
        # and before the preemption term everywhere below)
        tput_term = mig_term = None
        if policy_state is not None:
            _pol, tput_term, mig_term = policy_state

        def combine(row, first_terms):
            terms = list(first_terms)
            if collisions[row] > 0:
                terms.append(
                    -(float(collisions[row]) + 1.0) / float(tg.count)
                )
            if penalty[row]:
                terms.append(-1.0)
            if affinity_vec[row] != 0.0:
                terms.append(float(affinity_vec[row]))
            if spread_vec[row] != 0.0:
                terms.append(float(spread_vec[row]))
            if tput_term is not None:
                terms.append(float(tput_term[row]))
            if mig_term is not None and mig_term[row] != 0.0:
                terms.append(float(mig_term[row]))
            return terms

        def splice(row, option) -> float:
            """The exact score of an evict option: the single-node
            chain's appended scores (binpack after eviction, device
            affinity), the shared soft terms and the logistic
            preemption term, mean-combined."""
            terms = combine(row, list(option.scores))
            netp = _net_priority(
                [
                    a.job.priority
                    for a in option.preempted_allocs
                    if a.job is not None
                ]
            )
            pre_score = preemption_score(netp)
            option.scores.append(pre_score)
            terms.append(pre_score)
            self.ctx.metrics.score_node(
                option.node, "preemption", pre_score
            )
            return float(np.mean(terms))

        # mean-combine for fitting nodes, in the plain path's term order
        # and append conditions
        has_coll = collisions > 0
        anti_v = np.where(
            has_coll,
            -(collisions.astype(np.float64) + 1.0) / float(tg.count),
            0.0,
        )
        has_aff = affinity_vec != 0.0
        has_spread = spread_vec != 0.0
        sum_v = (
            fitness / 18.0
            + anti_v
            - penalty.astype(np.float64)
            + np.where(has_aff, affinity_vec, 0.0)
            + np.where(has_spread, spread_vec, 0.0)
        )
        count_v = (
            1.0
            + has_coll.astype(np.float64)
            + penalty.astype(np.float64)
            + has_aff.astype(np.float64)
            + has_spread.astype(np.float64)
        )
        if tput_term is not None:
            sum_v = sum_v + tput_term
            count_v = count_v + 1.0
        if mig_term is not None:
            has_mig = mig_term != 0.0
            sum_v = sum_v + np.where(has_mig, mig_term, 0.0)
            count_v = count_v + has_mig.astype(np.float64)
        scores[feasible] = (sum_v / count_v)[feasible]

        # preemption evaluation for masked nodes that did NOT fit, in
        # row order.  A cheap shortfall pre-filter first: a node whose
        # preemptible allocs (priority <= job.priority - delta, other
        # jobs) cannot cover the resource shortfall can never preempt
        # its way to feasibility (preemption.go:666
        # filterAndGroupPreemptibleAllocs criteria)
        for row in np.nonzero(mask & ~fit)[0]:
            node_id = self.table.node_ids[row]
            short_cpu = used_cpu[row] + ask_cpu - self.table.cpu_total[row]
            short_mem = used_mem[row] + ask_mem - self.table.mem_total[row]
            short_disk = (
                used_disk[row] + ask_disk - self.table.disk_total[row]
            )
            pre_cpu = pre_mem = pre_disk = 0.0
            for alloc in self.ctx.proposed_allocs(node_id):
                if alloc.job is None:
                    continue
                if (alloc.namespace, alloc.job_id) == (
                    self.job.namespace, self.job.id,
                ):
                    continue
                if (
                    self.job.priority - alloc.job.priority
                    < PREEMPTION_PRIORITY_DELTA
                ):
                    continue
                r = alloc.comparable_resources()
                pre_cpu += r.cpu
                pre_mem += r.memory_mb
                pre_disk += r.disk_mb
            if (
                pre_cpu < short_cpu
                or pre_mem < short_mem
                or pre_disk < short_disk
            ):
                continue  # provably cannot free enough
            evict_checked.add(int(row))
            option = self._verify_winner(node_id, tg, evict=True)
            if option is None or option.preempted_allocs is None:
                continue  # no viable preemption set: stays infeasible
            scores[row] = splice(row, option)
            feasible[row] = True
            preempt_options[int(row)] = option

        # the same limited walk as the plain path (K6), with the plain
        # path's poison-and-rerun loop: a fitting winner that fails
        # exact verification (ports/devices) gets the evict=True
        # evaluation — the oracle's binpack in preempt mode can
        # device/port-preempt such a node — before being masked out
        n_cand = len(self.candidate_rows)
        rotated = self._rotated(n_cand)
        feasible_d = self._t(feasible)
        scores_d = self._t(scores)
        perm_d = self._t(rotated)

        def capture(pulls: int) -> None:
            if not EXPLAIN.enabled:
                return
            self._capture_explain(
                tg, rotated, pulls,
                feasible_mask=mask,
                used=(used_cpu, used_mem, used_disk),
                asks=(ask_cpu, ask_mem, ask_disk),
                collisions=collisions,
                penalty=penalty,
                affinity_vec=affinity_vec,
                spread_vec=spread_vec,
                has_affinities=has_affinities,
                has_spreads=has_spreads,
                spread_fit=spread_fit,
                checks=checks,
                csi_mask=csi_mask,
                dh_rows=dh_rows,
                dp_mask=dp_mask,
                dp_psets=dp_psets,
                skip_rows={
                    r for r in evict_checked
                    if r not in preempt_options
                },
                preempt_scored={
                    r: float(scores[r]) for r in preempt_options
                },
                policy_state=policy_state,
            )

        while True:
            chosen_row, _best, _n, pulls = _on_device(
                "the preemption walk (K6)",
                # the count is not read: K6's prefix walk skips it
                lambda: walk_only(feasible_d, scores_d, perm_d, limit,
                                  n_cand, False),
            )
            if chosen_row == NO_NODE:
                if n_cand:
                    self._offset = (self._offset + pulls) % n_cand
                capture(pulls)
                self._populate_class_eligibility(tg, static_mask)
                return None
            if chosen_row in preempt_options:
                if n_cand:
                    self._offset = (self._offset + pulls) % n_cand
                capture(pulls)
                return preempt_options[chosen_row]
            node_id = self.table.node_ids[chosen_row]
            option = self._verify_winner(node_id, tg)
            if option is not None:
                if n_cand:
                    self._offset = (self._offset + pulls) % n_cand
                capture(pulls)
                return option
            # exact-only dimensions failed: try with eviction
            evict_checked.add(chosen_row)
            option = self._verify_winner(node_id, tg, evict=True)
            if option is not None and option.preempted_allocs:
                scores[chosen_row] = splice(chosen_row, option)
                scores_d[chosen_row] = float(scores[chosen_row])
                preempt_options[chosen_row] = option
                continue  # re-walk with the corrected score
            feasible[chosen_row] = False
            scores[chosen_row] = -np.inf
            feasible_d[chosen_row] = False
            scores_d[chosen_row] = -float("inf")

    # ------------------------------------------------------------------

    def _select_vectorized(
        self, tg: TaskGroup, options: Optional[SelectOptions]
    ) -> Optional[RankedNode]:
        C = self.table.capacity

        checks, static_mask = self._static_checks(tg)

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
        distinct_hosts, dh_rows = self._distinct_hosts(
            tg, job_rows, job_tg_rows
        )
        if dh_rows:
            mask[list(dh_rows)] = False

        # distinct_property (feasible.go:569)
        dp_mask, dp_psets = self._distinct_property_state(tg)
        mask &= dp_mask

        penalty = np.zeros(C, dtype=bool)
        if options is not None and options.penalty_node_ids:
            for node_id in options.penalty_node_ids:
                row = self.table.row_of.get(node_id)
                if row is not None:
                    penalty[row] = True

        affinity_vec = self._affinity_vector(tg)
        spread_vec, has_spreads = self._spread_vector(tg)

        has_affinities = self._has_affinities(tg)
        policy_state = self._policy_state(tg)
        # affinities, spreads and a resolved policy survey every
        # candidate (stack.py select)
        limit = (
            INT32_MAX
            if (has_affinities or has_spreads or policy_state is not None)
            else self.limit
        )

        ask_cpu, ask_mem, ask_disk = _asks(tg)

        # rotate the candidate portion of the perm by the accumulated
        # pull offset (StaticIterator round-robin continuation)
        n_cand = len(self.candidate_rows)
        rotated = self._rotated(n_cand)

        spread_fit = self._spread_fit()
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
            and policy_state is None
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
                distinct_hosts=distinct_hosts,
            )
            # one device->host copy for the whole pick sequence
            packed = _on_device("the look-ahead pick scan (K2)", lambda: (
                plan_picks_full(
                    cpu_total, mem_total, disk_total, binp, n_cand,
                    pow2_bucket(P), spread_fit=spread_fit,
                ).cpu().numpy()
            ))
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

        used_cpu = self.table.cpu_used + d_cpu
        used_mem = self.table.mem_used + d_mem
        used_disk = self.table.disk_used + d_disk
        policy_terms = None
        if policy_state is not None:
            _pol, tput_term, mig_term = policy_state
            # both groups inert (armed coefficient, no live allocs yet):
            # no PolicyTerms at all, as policy-off (the unlimited walk
            # above still applies)
            if tput_term is not None or mig_term is not None:
                policy_terms = PolicyTerms(
                    tput_term=None if tput_term is None else self._t(tput_term),
                    has_tput=None if tput_term is None else 1.0,
                    mig_term=None if mig_term is None else self._t(mig_term),
                )
        inputs = ScoreInputs(
            cpu_total=cpu_total,
            mem_total=mem_total,
            disk_total=disk_total,
            cpu_used=self._t(used_cpu),
            mem_used=self._t(used_mem),
            disk_used=self._t(used_disk),
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
            policy=policy_terms,
        )

        def capture(pulls: int) -> None:
            if not EXPLAIN.enabled:
                return
            self._capture_explain(
                tg, rotated, pulls,
                feasible_mask=mask,
                used=(used_cpu, used_mem, used_disk),
                asks=(ask_cpu, ask_mem, ask_disk),
                collisions=collisions,
                penalty=penalty,
                affinity_vec=affinity_vec,
                spread_vec=spread_vec,
                has_affinities=has_affinities,
                has_spreads=has_spreads,
                spread_fit=spread_fit,
                checks=checks,
                csi_mask=csi_mask,
                dh_rows=dh_rows,
                dp_mask=dp_mask,
                dp_psets=dp_psets,
                skip_rows=self._extra_excluded_rows,
                policy_state=policy_state,
            )

        while True:
            # one device->host copy per select
            packed = _on_device("the select (K1)", lambda: (
                score_and_select_packed(
                    inputs, spread_fit=spread_fit
                ).cpu().numpy()
            ))
            chosen_row, pulls = int(packed[0]), int(packed[1])
            if chosen_row == NO_NODE:
                if n_cand:
                    self._offset = (self._offset + pulls) % n_cand
                capture(pulls)
                self._populate_class_eligibility(tg, static_mask)
                return None
            node_id = self.table.node_ids[chosen_row]
            option = self._verify_winner(node_id, tg)
            if option is not None:
                if n_cand:
                    self._offset = (self._offset + pulls) % n_cand
                capture(pulls)
                return option
            # count-mask admitted a node exact assignment rejects
            # (e.g. specific port collision): exclude and re-run; the
            # rejected node becomes an infeasible pull, exactly as if
            # binpack had exhausted it mid-walk
            self._extra_excluded_rows.add(chosen_row)
            mask = mask.copy()
            mask[chosen_row] = False
            inputs = inputs._replace(feasible=self._t(mask))

    def _distinct_hosts(
        self, tg: TaskGroup, job_rows, job_tg_rows
    ) -> Tuple[bool, Set[int]]:
        """distinct_hosts (feasible.go:470): whether the job or the group
        sets it, and the rows it rules out (the job's rows when the job
        sets it, else the group's)."""
        if any(
            c.operand == CONSTRAINT_DISTINCT_HOSTS
            for c in self.job.constraints
        ):
            return True, {int(r) for r in job_rows}
        if any(c.operand == CONSTRAINT_DISTINCT_HOSTS for c in tg.constraints):
            return True, {int(r) for r in job_tg_rows}
        return False, set()

    def _has_affinities(self, tg: TaskGroup) -> bool:
        return bool(
            list(self.job.affinities)
            or list(tg.affinities)
            or any(t.affinities for t in tg.tasks)
        )

    def _spread_fit(self) -> bool:
        return (
            self.ctx.state.scheduler_config().effective_scheduler_algorithm()
            == "spread"
        )

    def _fitness(self, used_cpu, used_mem, ask_cpu, ask_mem,
                 spread_fit: bool) -> np.ndarray:
        """Every node's binpack fitness in [0, 18] in numpy (canonical
        f32-rounded pow), as the preemption scores and the explain
        capture compute it."""
        from ..structs.funcs import pow10_np

        safe_cpu = np.where(
            self.table.cpu_total > 0, self.table.cpu_total, 1.0
        )
        safe_mem = np.where(
            self.table.mem_total > 0, self.table.mem_total, 1.0
        )
        free_cpu = 1.0 - (used_cpu + ask_cpu) / safe_cpu
        free_mem = 1.0 - (used_mem + ask_mem) / safe_mem
        base = pow10_np(free_cpu) + pow10_np(free_mem)
        if spread_fit:
            return np.clip(base - 2.0, 0.0, 18.0)
        return np.clip(20.0 - base, 0.0, 18.0)

    def _rotated(self, n_cand: int) -> np.ndarray:
        """The walk order of this select: the candidate part of the perm
        rotated by the accumulated pull offset, the vacant rows after."""
        cand = self.perm[:n_cand]
        rest = self.perm[n_cand:]
        off = self._offset % n_cand if n_cand else 0
        return np.concatenate([cand[off:], cand[:off], rest]).astype(
            np.int32
        )

    # ------------------------------------------------------------------

    def _verify_winner(
        self, node_id: str, tg: TaskGroup, evict: bool = False
    ) -> Optional[RankedNode]:
        """Exact port/device assignment + fit for the winning node via the
        oracle binpack step (rank.py BinPackIterator); with evict=True
        the chain also runs the exact preemption evaluation and attaches
        preempted_allocs."""
        node = self.ctx.state.node_by_id(node_id)
        if node is None:
            return None
        ranked = RankedNode(node=node)
        source = _SingleNodeSource(ranked)
        algorithm = (
            self.ctx.state.scheduler_config().effective_scheduler_algorithm()
        )
        binpack = BinPackIterator(
            self.ctx, source, evict, self.job.priority, algorithm
        )
        binpack.set_job(self.job)
        binpack.set_task_group(tg)
        return binpack.next()

    # -- placement explainability --------------------------------------

    def _capture_lookahead(self, tg: TaskGroup, pulls: int) -> None:
        """Explain capture for a pick served from the look-ahead cache,
        so the cache keeps its one launch per group with the recorder
        on.  The serve-path consistency checks (same job version, table
        generation, plan advanced exactly as the kernel modelled it)
        guarantee a host-side recompute of the plan-adjusted state sees
        what the kernel's chained carry saw for this pick; the serve
        preconditions (no penalties, spreads or distinct_property) zero
        the terms the cache does not model."""
        if not EXPLAIN.enabled:
            return
        C = self.table.capacity
        checks, static_mask = self._static_checks(tg)
        candidate_mask = np.zeros(C, dtype=bool)
        candidate_mask[self.candidate_rows] = True
        d_cpu, d_mem, d_disk, collisions, job_rows, job_tg_rows = (
            self._plan_adjusted_state(tg)
        )
        mask = candidate_mask & static_mask & self.table.active
        csi_mask = self._csi_feasibility(tg)
        if csi_mask is not None:
            mask &= csi_mask
        distinct_hosts, dh_rows = self._distinct_hosts(
            tg, job_rows, job_tg_rows
        )
        if dh_rows:
            mask[list(dh_rows)] = False
        rotated = self._rotated(len(self.candidate_rows))
        affinity_vec = self._affinity_vector(tg)
        has_affinities = self._has_affinities(tg)
        spread_fit = self._spread_fit()
        self._capture_explain(
            tg, rotated, int(pulls),
            feasible_mask=mask,
            used=(
                self.table.cpu_used + d_cpu,
                self.table.mem_used + d_mem,
                self.table.disk_used + d_disk,
            ),
            asks=_asks(tg),
            collisions=collisions,
            penalty=np.zeros(C, dtype=bool),
            affinity_vec=affinity_vec,
            spread_vec=np.zeros(C, dtype=np.float64),
            has_affinities=has_affinities,
            has_spreads=False,
            spread_fit=spread_fit,
            checks=checks,
            csi_mask=csi_mask,
            dh_rows=dh_rows,
            dp_mask=np.ones(C, dtype=bool),
            dp_psets=[],
            skip_rows=self._extra_excluded_rows,
        )

    def _capture_explain(
        self, tg: TaskGroup, rotated: np.ndarray, pulls: int, *,
        feasible_mask, used, asks, collisions, penalty,
        affinity_vec, spread_vec, has_affinities, has_spreads,
        spread_fit, checks, csi_mask, dh_rows, dp_mask, dp_psets,
        skip_rows=frozenset(), preempt_scored=None, policy_state=None,
    ) -> None:
        """Rebuild the serial iterator chain's AllocMetric from the
        arrays this select already computed: the walk's `pulls` bounds
        the evaluated prefix exactly as the reference's StaticIterator
        would have, every feasible node in it gets the per-component
        score decomposition, fit failures get their first exhausted
        dimension (cpu, memory, disk), and masked nodes get first-failure
        attribution in FeasibilityWrapper checker order — including the
        wrapper's computed-class memoization ("computed class
        ineligible" after the first node of a known-bad class).

        ``skip_rows`` are rows whose metric side effects the exact
        verification chain already recorded (poisoned winners, evict
        re-evaluations); ``preempt_scored`` maps rows whose score was
        spliced in by the preemption evaluation to their final
        normalized score; ``policy_state`` is the select's
        `_policy_state` (the `policy.*` components)."""
        metrics = self.ctx.metrics
        metrics.nodes_evaluated += int(pulls)
        if pulls <= 0:
            return
        evaluated = rotated[: int(pulls)]
        used_cpu, used_mem, used_disk = used
        ask_cpu, ask_mem, ask_disk = asks
        fit = (
            (used_cpu + ask_cpu <= self.table.cpu_total)
            & (used_mem + ask_mem <= self.table.mem_total)
            & (used_disk + ask_disk <= self.table.disk_total)
        )
        fitness = self._fitness(used_cpu, used_mem, ask_cpu, ask_mem,
                                spread_fit)
        preempt_scored = preempt_scored or {}
        state = self.ctx.state
        desired = float(tg.count)
        pol = tput_term = mig_term = None
        if policy_state is not None:
            pol, tput_term, mig_term = policy_state
        # direct NodeScoreMeta writes through a node-id index, starting
        # from the entries the exact verify chain already recorded (the
        # winner): an unlimited walk scores every candidate
        meta_by_id = {m.node_id: m for m in metrics.score_meta}

        def meta_for(node_id: str) -> NodeScoreMeta:
            m = meta_by_id.get(node_id)
            if m is None:
                m = NodeScoreMeta(node_id=node_id)
                metrics.score_meta.append(m)
                meta_by_id[node_id] = m
            return m

        for r in (int(x) for x in evaluated):
            if r in skip_rows:
                continue
            node = state.node_by_id(self.table.node_ids[r])
            if node is None:
                continue
            if r in preempt_scored:
                # binpack/devices/preemption terms were recorded by the
                # exact evict chain; add the shared soft terms and the
                # spliced normalized score
                meta = meta_for(node.id)
                self._record_soft_terms(meta.scores, r, collisions,
                                        penalty, affinity_vec,
                                        spread_vec, has_affinities,
                                        has_spreads, desired, terms=None,
                                        pol=pol, tput_term=tput_term,
                                        mig_term=mig_term)
                meta.scores["normalized-score"] = preempt_scored[r]
                meta.norm_score = preempt_scored[r]
                continue
            if feasible_mask[r] and fit[r]:
                terms = [float(fitness[r]) / 18.0]
                meta = meta_for(node.id)
                meta.scores["binpack"] = terms[0]
                self._record_soft_terms(meta.scores, r, collisions,
                                        penalty, affinity_vec,
                                        spread_vec, has_affinities,
                                        has_spreads, desired, terms=terms,
                                        pol=pol, tput_term=tput_term,
                                        mig_term=mig_term)
                norm = sum(terms) / float(len(terms))
                meta.scores["normalized-score"] = norm
                meta.norm_score = norm
                continue
            if feasible_mask[r] and not fit[r]:
                # resource exhaustion: first dimension in the serial
                # superset order (structs.ComparableResources)
                if used_cpu[r] + ask_cpu > self.table.cpu_total[r]:
                    dim = "cpu"
                elif used_mem[r] + ask_mem > self.table.mem_total[r]:
                    dim = "memory"
                else:
                    dim = "disk"
                metrics.exhausted_node(node, dim)
                continue
            self._attribute_filter(
                node, r, tg, checks, csi_mask, dh_rows, dp_mask,
                dp_psets,
            )

    def _record_soft_terms(
        self, scores, r, collisions, penalty, affinity_vec,
        spread_vec, has_affinities, has_spreads, desired, terms,
        pol=None, tput_term=None, mig_term=None,
    ) -> None:
        """Record the rank chain's soft score components into one node's
        scores dict under the serial iterators' append/record conditions
        (rank.py: anti-affinity and reschedule-penalty record 0 when
        inert; affinity/spread record only non-zero; the policy terms as
        PolicyIterator records them).  Appends the
        appended terms to ``terms`` when given (the normalization mean
        divides by the append count, not the record count)."""
        coll = int(collisions[r])
        if coll > 0:
            anti = -1.0 * float(coll + 1) / desired
            if terms is not None:
                terms.append(anti)
            scores["job-anti-affinity"] = anti
        else:
            scores["job-anti-affinity"] = 0
        if penalty[r]:
            if terms is not None:
                terms.append(-1.0)
            scores["node-reschedule-penalty"] = -1
        else:
            scores["node-reschedule-penalty"] = 0
        if not has_affinities:
            scores["node-affinity"] = 0
        elif affinity_vec[r] != 0.0:
            aff = float(affinity_vec[r])
            if terms is not None:
                terms.append(aff)
            scores["node-affinity"] = aff
        if has_spreads and spread_vec[r] != 0.0:
            sp = float(spread_vec[r])
            if terms is not None:
                terms.append(sp)
            scores["allocation-spread"] = sp
        # policy components as rank.py PolicyIterator records them:
        # throughput records (and appends) for every node when the table
        # is present; migration appends only non-zero and records 0 when
        # the coefficient is armed but this node is not sticky
        if pol is not None:
            if tput_term is not None:
                tv = float(tput_term[r])
                if terms is not None:
                    terms.append(tv)
                scores["policy.throughput"] = tv
            mv = 0.0 if mig_term is None else float(mig_term[r])
            if mv != 0.0:
                if terms is not None:
                    terms.append(mv)
                scores["policy.migration"] = mv
            elif pol.mig_coef != 0.0:
                scores["policy.migration"] = 0

    def _explain_job_status(self, klass: str) -> int:
        """The wrapper's job-level class status, answered from the
        capture's shadow memoization (escape flags still come from the
        shared eligibility: they are facts of the job spec)."""
        if self.ctx.eligibility.job_escaped or not klass:
            return CLASS_ESCAPED
        return self._explain_job_elig.get(klass, CLASS_UNKNOWN)

    def _explain_tg_status(self, tg_name: str, klass: str) -> int:
        if self.ctx.eligibility.tg_escaped.get(tg_name, False) or (
            not klass
        ):
            return CLASS_ESCAPED
        return self._explain_tg_elig.get(tg_name, {}).get(
            klass, CLASS_UNKNOWN
        )

    def _attribute_filter(
        self, node, row, tg, checks, csi_mask, dh_rows, dp_mask,
        dp_psets,
    ) -> None:
        """Name the reason a masked node was masked, walking the same
        checker order (and computed-class memoization) the serial
        FeasibilityWrapper would, with the serial chain's reason
        strings.  Memoization runs on a shadow state private to the
        capture: the real EvalEligibility drives blocked-eval unblocking
        and must not change with the explain opt-out."""
        metrics = self.ctx.metrics
        klass = node.computed_class
        status = self._explain_job_status(klass)
        if status == CLASS_INELIGIBLE:
            metrics.filter_node(node, FILTER_CLASS_INELIGIBLE)
            return
        job_escaped = status == CLASS_ESCAPED
        job_unknown = status == CLASS_UNKNOWN
        for mask, label, level in checks:
            if level != "job":
                continue
            if not mask[row]:
                if not job_escaped:
                    self._explain_job_elig[klass] = CLASS_INELIGIBLE
                metrics.filter_node(node, label)
                return
        if not job_escaped and job_unknown:
            self._explain_job_elig[klass] = CLASS_ELIGIBLE
        status = self._explain_tg_status(tg.name, klass)
        if status == CLASS_INELIGIBLE:
            metrics.filter_node(node, FILTER_CLASS_INELIGIBLE)
            return
        if status != CLASS_ELIGIBLE:
            tg_escaped = status == CLASS_ESCAPED
            tg_unknown = status == CLASS_UNKNOWN
            for mask, label, level in checks:
                if level != "tg":
                    continue
                if not mask[row]:
                    if not tg_escaped:
                        self._explain_tg_elig.setdefault(
                            tg.name, {}
                        )[klass] = CLASS_INELIGIBLE
                    metrics.filter_node(node, label)
                    return
            if not tg_escaped and tg_unknown:
                self._explain_tg_elig.setdefault(tg.name, {})[
                    klass
                ] = CLASS_ELIGIBLE
        if csi_mask is not None and not csi_mask[row]:
            metrics.filter_node(node, FILTER_CONSTRAINT_CSI_VOLUMES)
            return
        if row in dh_rows:
            metrics.filter_node(node, CONSTRAINT_DISTINCT_HOSTS)
            return
        if dp_psets and not dp_mask[row]:
            for pset in dp_psets:
                ok, reason = pset.satisfies_distinct_properties(
                    node, tg.name
                )
                if not ok:
                    metrics.filter_node(node, reason)
                    return
            metrics.filter_node(node, CONSTRAINT_DISTINCT_PROPERTY)
            return
        # masked by a factor the serial source list never contains
        # (vacant arena row, node deactivated mid-snapshot): nothing
        # the serial chain would have named — leave unattributed

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

    def _distinct_property_state(
        self, tg: TaskGroup
    ) -> Tuple[np.ndarray, List[PropertySet]]:
        """Distinct-property feasibility mask (feasible.go:569) plus the
        property sets behind it: a node is out once its property value
        has been used `allowed` times by the job's live and proposed
        allocs.  The mask drives the kernel; the psets let the explain
        capture render the serial chain's per-node reason string
        (propertyset.py satisfies_distinct_properties)."""
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
            return mask, []
        from .feasible import target_column_key

        psets: List[PropertySet] = []
        for constraint, scope in constraints:
            pset = PropertySet(self.ctx, self.job)
            pset.set_constraint(constraint, scope)
            psets.append(pset)
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
        return mask, psets

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
