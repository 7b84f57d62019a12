"""Storm coalescing: stage a family backlog as ONE assignment problem,
and decompose the converged solve back into per-eval prescored plans.
Port of `nomad_tpu/sched/storm.py`.

The batch worker detects a storm (a contiguous broker prefix of pending
evals sharing a job family, see eval_broker.job_family) and hands it
here.  ``build_storm_problem`` runs the chunk assembler's own host
staging (simulation pre-pass output, candidate layout, static
feasibility and affinity masks, the recorded serial walk order) but
flattens every pending placement of every member into one (alloc rows
x node arena) problem for ``ops/solve.py``.  ``decompose`` maps the
solved assignment back to each eval's ``(rows, pulls)`` pick list,
which replays through the prescored machinery in broker FIFO order.
Members the solver cannot cover keep ``rows=None`` and take the
sequential path inside the same in-order commit.

Eligibility is narrow (one task group; no ports, devices, distinct
constraints, spreads or staged evictions): the solver's capacity model
covers cpu, memory and disk only.  A member whose job resolves a
PolicySpec stages pre-scaled policy term rows into the same solve (a
weighted storm); policy-less members of a mixed storm carry all-zero
rows.  On a node mesh, ``stage_for_mesh`` places the staged inputs for
the node-sharded solve (`ops/solve.py storm_assignment_sharded`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..structs import (
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY,
)
from .stack import compute_visit_limit

# one solve covers at most this many pending-alloc rows; members past
# the budget keep rows=None and take the sequential path
MAX_STORM_ROWS = 1024
_INT32_MAX = 2**31 - 1


@dataclass
class StormMember:
    """One storm eval's journey through the solve: gate reason (None =
    solvable), its row slice in the flattened problem, and the
    decomposed per-pick plan."""

    ev: object
    token: str
    job: object = None
    sim: object = None
    reason: Optional[str] = None  # non-None = sequential fallback
    row0: int = 0
    row1: int = 0
    # filled by decompose() for solved members
    rows: Optional[List[int]] = None
    pulls: Optional[List[int]] = None
    solver_round: int = -1
    assignment_score: float = 0.0
    divergent_rows: int = 0
    # leadership generation the storm solved under
    leader_gen: int = 0


@dataclass
class StormProblem:
    """Flattened (rows x nodes) assignment problem + row bookkeeping."""

    inputs: object  # ops.solve.StormInputs with numpy leaves
    members: List[StormMember] = field(default_factory=list)
    n_rows: int = 0  # real rows (before padding)
    n_evals: int = 0  # solvable members contributing rows
    spread_fit: bool = False
    max_rounds: int = 1


def storm_gate(worker, member: StormMember) -> Optional[str]:
    """Why this member cannot ride the solver (None = it can).  Every
    reason is a trace event and a fallback counter, never a dropped
    eval."""
    job, sim = member.job, member.sim
    if sim is None:
        return member.reason or "simulate"
    if len(sim.tgs) > 1:
        return "multi_tg"
    if any(sim.asked_ports):
        return "ports"
    if any(d for d in sim.asked_devices):
        return "devices"
    if any(r >= 0 for r in sim.evict_rows):
        # destructive evictions interleave with placements in the
        # serial chain; the solver's flat capacity model cannot
        return "evictions"
    tg = sim.tgs[0] if sim.tgs else job.task_groups[0]
    for c in (
        list(job.constraints)
        + list(tg.constraints)
        + [c for t in tg.tasks for c in t.constraints]
    ):
        if c.operand in (
            CONSTRAINT_DISTINCT_HOSTS,
            CONSTRAINT_DISTINCT_PROPERTY,
        ):
            # a hard constraint the flat score matrix does not encode
            return "distinct"
    if list(job.spreads) or list(tg.spreads):
        # spread boosts evolve per pick through the chain carry; the
        # solver scores once against the baseline
        return "spread"
    return None


def build_storm_problem(
    worker, snap, members: List[StormMember]
) -> Optional[StormProblem]:
    """Stage the solvable members' pending placements into one
    ``StormInputs`` of numpy arrays.  Returns None when no member is
    solvable.  Mutates each member's ``reason``/row slice in place."""
    from ..ops.batch import pow2_bucket
    from ..ops.solve import StormInputs, pad_axis
    from ..raft import chaos as _chaos
    from ..trace import TRACE
    from .policy import (
        migration_vector,
        resolve,
        sticky_node_ids,
        tput_tensor,
    )

    # chaos seam: deterministic revoke-while-staging races (a no-op
    # in the port, which has no hook registry)
    _chaos.fire("storm_staged")

    table = snap.node_table
    C = table.capacity
    dtype = np.asarray(table.cpu_total).dtype

    feas_e: List[np.ndarray] = []
    aff_e: List[np.ndarray] = []
    coll_e: List[np.ndarray] = []
    perm_e: List[np.ndarray] = []
    limit_e: List[int] = []
    ncand_e: List[int] = []
    # policy-weighted rows (sched/policy.py): PRE-SCALED term rows
    # (ops/score.py PolicyTerms) staged per eval so a mixed storm fuses
    # weighted and unweighted members into ONE solve; policy-less evals
    # carry all-zero rows, which add float-exactly nothing
    pol_tput_e: List[np.ndarray] = []
    pol_has_e: List[float] = []
    pol_mig_e: List[np.ndarray] = []
    any_policy = False
    metrics = getattr(getattr(worker, "server", None), "metrics", None)
    eval_of: List[int] = []
    ask_rows: List[Tuple[float, float, float]] = []
    desired_rows: List[int] = []
    penalty_rows: List[np.ndarray] = []
    pre: Dict[int, List[float]] = {}

    n_evals = 0
    n_rows = 0
    for member in members:
        if member.reason is None:
            member.reason = storm_gate(worker, member)
        if member.reason is None and (
            n_rows + member.sim.placements > MAX_STORM_ROWS
        ):
            member.reason = "row_budget"
        if member.reason is not None:
            continue
        ev, job, sim = member.ev, member.job, member.sim
        tg = sim.tgs[0] if sim.tgs else job.task_groups[0]
        # the chunk assembler's own walk-order staging, so a solved
        # member replays through the identical PrescoredStack contract
        rows, _rest, n_cand, _order, perm = (
            worker._stage_walk_order(snap, job, sim)
        )
        perm = perm.astype(np.int32)
        feasible, aff_vec = worker._static_vectors(snap, job, tg, rows)
        has_aff = bool(
            list(job.affinities)
            or list(tg.affinities)
            or any(t.affinities for t in tg.tasks)
        )
        pol = resolve(job)
        if pol is not None:
            # the per-eval select's own assembly: the cached throughput
            # tensor and the live-alloc stickiness vector, pre-scaled by
            # the coefficients here so the kernel adds the rows as-is
            with TRACE.span(ev.id, "batch_worker.policy_assemble"):
                tput_term = (
                    pol.tput_coef
                    * tput_tensor(
                        pol, job, table, dtype=dtype, metrics=metrics
                    )
                    if pol.has_tput
                    else np.zeros(C, dtype=dtype)
                )
                sticky = sticky_node_ids(pol, job, tg.name, snap)
                mig_term = (
                    pol.mig_coef
                    * migration_vector(sticky, table, dtype=dtype)
                    if sticky
                    else np.zeros(C, dtype=dtype)
                )
            any_policy = True
            if metrics is not None:
                metrics.incr("policy.storm_evals")
            pol_tput_e.append(tput_term)
            pol_has_e.append(1.0 if pol.has_tput else 0.0)
            pol_mig_e.append(mig_term)
        else:
            pol_tput_e.append(np.zeros(C, dtype=dtype))
            pol_has_e.append(0.0)
            pol_mig_e.append(np.zeros(C, dtype=dtype))
        limit = (
            _INT32_MAX
            # a resolved policy joins affinity in the unlimited-walk
            # rule (stack.py select)
            if has_aff or pol is not None
            else compute_visit_limit(n_cand, ev.type == "batch")
        )
        e_i = n_evals
        feas_e.append(feasible.astype(bool))
        aff_e.append(np.asarray(aff_vec, dtype=dtype))
        coll = (
            sim.base_collisions[0]
            if sim.base_collisions is not None
            else np.zeros(C, dtype=np.int32)
        )
        coll_e.append(coll.astype(np.int32))
        perm_e.append(perm)
        limit_e.append(int(limit))
        ncand_e.append(int(n_cand))
        ask = (
            float(sum(t.resources.cpu for t in tg.tasks)),
            float(sum(t.resources.memory_mb for t in tg.tasks)),
            float(tg.ephemeral_disk.size_mb),
        )
        member.row0 = n_rows
        for pick in range(sim.placements):
            eval_of.append(e_i)
            ask_rows.append(ask)
            desired_rows.append(int(tg.count))
            pen = np.zeros(C, dtype=bool)
            if pick < len(sim.penalties):
                for node_id in sim.penalties[pick]:
                    row = table.row_of.get(node_id)
                    if row is not None:
                        pen[row] = True
            penalty_rows.append(pen)
            n_rows += 1
        member.row1 = n_rows
        n_evals += 1
        # staged pre-placement deltas (stops, in-place updates) of
        # every solvable member apply up front: the solver sees the
        # storm's own freed or shifted capacity, one snapshot earlier
        # than the chain carry would
        for row, delta in sim.pre.items():
            acc = pre.setdefault(row, [0.0, 0.0, 0.0])
            acc[0] += delta[0]
            acc[1] += delta[1]
            acc[2] += delta[2]

    if n_evals == 0:
        return None

    E = pow2_bucket(max(1, n_evals), floor=4)
    A = pow2_bucket(max(1, n_rows), floor=8)
    pre_cpu = np.zeros(C, dtype=dtype)
    pre_mem = np.zeros(C, dtype=dtype)
    pre_disk = np.zeros(C, dtype=dtype)
    for row, delta in pre.items():
        pre_cpu[row] = delta[0]
        pre_mem[row] = delta[1]
        pre_disk[row] = delta[2]

    inputs = StormInputs(
        feasible=pad_axis(np.stack(feas_e), E, False),
        affinity=pad_axis(np.stack(aff_e), E, 0),
        collisions=pad_axis(np.stack(coll_e), E, 0),
        perm=pad_axis(np.stack(perm_e), E, 0),
        limit=pad_axis(np.asarray(limit_e, dtype=np.int32), E, 1),
        n_cand=pad_axis(np.asarray(ncand_e, dtype=np.int32), E, 1),
        eval_of=pad_axis(
            np.asarray(eval_of or [0], dtype=np.int32), A, 0
        ),
        penalty=pad_axis(
            np.stack(penalty_rows) if penalty_rows
            else np.zeros((1, C), dtype=bool),
            A, False,
        ),
        ask=pad_axis(
            np.asarray(ask_rows or [(0.0, 0.0, 0.0)], dtype=dtype), A, 0
        ),
        desired=pad_axis(
            np.asarray(desired_rows or [1], dtype=np.int32), A, 1
        ),
        real=pad_axis(np.ones(n_rows, dtype=bool), A, False)
        if n_rows
        else np.zeros(A, dtype=bool),
        pre_cpu=pre_cpu,
        pre_mem=pre_mem,
        pre_disk=pre_disk,
        # None (not zeros) when no member carries a policy: the
        # unweighted solve stays the policy-off kernel
        policy_tput_term=pad_axis(np.stack(pol_tput_e), E, 0)
        if any_policy
        else None,
        policy_has_tput=pad_axis(np.asarray(pol_has_e, dtype=dtype), E, 0)
        if any_policy
        else None,
        policy_mig_term=pad_axis(np.stack(pol_mig_e), E, 0)
        if any_policy
        else None,
    )
    spread_fit = (
        snap.scheduler_config().effective_scheduler_algorithm()
        == "spread"
    )
    return StormProblem(
        inputs=inputs,
        members=members,
        n_rows=n_rows,
        n_evals=n_evals,
        spread_fit=spread_fit,
        max_rounds=A,
    )


def stage_for_mesh(inputs, mesh):
    """Place one storm's staged ``StormInputs`` (host numpy) on the node
    mesh for the sharded solve, as `ops/solve.py storm_in_specs` lays
    them out: the node-indexed leaves (the [E, C] / [A, C] masks, the
    policy rows and the ``pre_*`` columns) as `Sharded` (`NodeMesh
    .shard`, each process only its own shards), the per-eval and per-row
    leaves whole on the mesh's device.  The arena must tile over the
    mesh (the caller's gate, as ``mesh_capable``)."""
    from ..ops.solve import place_storm_inputs

    return place_storm_inputs(inputs, mesh)


def decompose(problem: StormProblem, out) -> int:
    """Map the converged assignment (the solve's six outputs as numpy)
    back onto the members: fill each solved member's ``(rows, pulls)``
    pick lists, tag it with the solver round and assignment score, and
    mark members with any unassigned row as ``unsolved`` fallbacks.
    Returns the number of assigned rows.

    ``out=None`` (a zero-row storm: the solve never ran) solves only the
    trivial members — zero-placement evals commit with an empty pick
    list; everything else falls back."""
    solved_rows = 0
    if out is None:
        for member in problem.members:
            if member.reason is not None:
                continue
            if member.row0 == member.row1:
                member.rows = []
                member.pulls = []
                member.solver_round = 0
            else:
                member.reason = "unsolved"
        return 0
    assigned, pulls, acc_round, score, greedy, _rounds = out
    for member in problem.members:
        if member.reason is not None:
            continue
        r0, r1 = member.row0, member.row1
        rows = [int(r) for r in assigned[r0:r1]]
        if any(r < 0 for r in rows):
            # an unassignable row (nothing feasible fits, or the round
            # budget ran out): the sequential path owns this eval — a
            # solver "no node" must never pass for the scheduler's
            # exhaustion verdict
            member.reason = "unsolved"
            continue
        member.rows = rows
        member.pulls = [int(p) for p in pulls[r0:r1]]
        member.solver_round = int(
            max([int(r) for r in acc_round[r0:r1]], default=-1)
        )
        member.assignment_score = float(np.sum(score[r0:r1]))
        member.divergent_rows = int(
            np.sum(assigned[r0:r1] != greedy[r0:r1])
        )
        solved_rows += r1 - r0
    return solved_rows
