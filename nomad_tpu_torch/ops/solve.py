"""Global storm assignment: one device solve for a whole backlog of
pending evals of one job family.  Port of `nomad_tpu/ops/solve.py`.

The JAX program `storm_assignment` (there `:113-314`) becomes kernel
K5, `csrc/storm_solve.cu`.  This module keeps:

* `StormInputs`, the host-staged inputs, as a NamedTuple of tensors;
* `storm_assignment_twin`, a plain-PyTorch copy of the JAX program
  that is bit-exact against it under x64 on the CPU;
* `storm_assignment_cuda`, the K5 wrapper, and `storm_assignment`,
  which runs the twin for CPU tensors and K5 for CUDA tensors;
* the node-sharded solve, below.

What is solved (see the JAX module for the long form): every (alloc
row, node) pair is scored with the serial chain's own score; each row's
warm start is its serial limited walk; then an auction of bidding
rounds resolves contention.  Each unassigned row bids its best value
(score - node price, ties spread by a fixed jitter) among the nodes
whose remaining capacity fits its ask, round 0 bidding the walk winner
when it still fits; each node accepts the best-value prefix of its
bidders that cannot overcommit it, debits the accepted asks and raises
its price.  The loop ends when a round accepts nobody or the round
budget is spent; rows left unassigned return NO_NODE.

A weighted storm (a member whose job resolves a PolicySpec) stages
three more per-eval inputs, pre-scaled on the host: the throughput and
migration term rows and the throughput count, which the score pass
gathers by each row's eval; policy-less evals in a mixed storm carry
all-zero rows, which add nothing float-exactly.

The node-sharded solve (`storm_assignment_sharded`, JAX `:354`) is
kernel K14, `csrc/storm_sharded.cu`: the same auction with the node axis
split over a `parallel.mesh` node mesh.  On a `VirtualMesh` (every shard
in this process on one card) its score stage a shard, the gather and the
walk are launched, then the rounds and the epilogue are one cooperative
launch: K5's rounds (`csrc/storm_round.cuh`) over the shards, the
exchanges and the progress flag in device memory.  On a `DistMesh` K14
runs in stages launched per shard, with the mesh's exchanges between
them where the JAX program's collectives fall (`_drive_storm`):

  score     per shard, every (row, local node) score and feasibility,
            the shard's free capacity; the mesh gathers both [A, S]
            matrices (the one full gather of the solve);
  walk      per process, each row's warm start over the gathered matrix;

then each round

  bid       per shard, the local max of value + jitter and the lowest
            global node id reaching it; pmax;
  cand      per shard, that id where the max is global; pmin;
  read      per shard, ownership reads of the row's value at its best
            node (and, in round 0, at its walk winner): the owner's
            value, 0.0 elsewhere; psum;
  bids      per process, each row's bid;
  budget    per shard, the max-ask budget m of the rows' bid nodes it
            owns; psum;
  accept    per process, the [A, A] rank and acceptance, and the round's
            progress flag, which the host reads;
  debit     per shard, the accepted asks in ascending row order and the
            prices of the nodes it owns;

and an epilogue (the score's ownership read, psum, then pulls, score
and rounds).  The twin (`storm_assignment_sharded_twin`) runs these
stages in torch on any mesh.  Every exchange is exact, so the
result is bit-equal to the JAX program at the same D and, but for the
sign of a zero score at D > 1, to the single-device solve.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .batch import ordered_index_add
from .score import (
    MAX_SKIP,
    NO_NODE,
    SKIP_THRESHOLD,
    PolicyTerms,
    ScoreInputs,
    score_vectors,
)

# per-acceptance price increment and the tie-spreading jitter scale
# (the JAX module's values; the jitter only picks WHICH of the tied-max
# nodes a row bids, never the bid's value)
PRICE_EPS = 0.01
TIE_JITTER = 1e-6
# the Knuth-hash lattice of the jitter, as int32 multipliers
JITTER_ROW = -1640531527
JITTER_NODE = 40503


class StormInputs(NamedTuple):
    """Host-staged inputs of one storm solve.  ``E`` evals contribute
    ``A`` pending-alloc rows over the ``C``-row node arena; per-eval
    vectors are gathered per row through ``eval_of``."""

    feasible: torch.Tensor  # bool[E, C] static feasibility per eval
    affinity: torch.Tensor  # f[E, C] normalized affinity score
    collisions: torch.Tensor  # i32[E, C] anti-affinity base counts
    perm: torch.Tensor  # i32[E, C] recorded serial walk order
    limit: torch.Tensor  # i32[E] visit limit (INT32_MAX = unlimited)
    n_cand: torch.Tensor  # i32[E] real candidates at perm's front
    eval_of: torch.Tensor  # i32[A] row -> eval index
    penalty: torch.Tensor  # bool[A, C] reschedule-penalty nodes
    ask: torch.Tensor  # f[A, 3] cpu/mem/disk ask per row
    desired: torch.Tensor  # i32[A] tg.count per row
    real: torch.Tensor  # bool[A] padding rows are never assigned
    pre_cpu: torch.Tensor  # f[C] staged pre-placement usage deltas
    pre_mem: torch.Tensor  # f[C]
    pre_disk: torch.Tensor  # f[C]
    # policy-weighted scoring: all three None for an unweighted storm;
    # a weighted one stages pre-scaled per-eval rows (ops/score.py
    # PolicyTerms), all-zero for the policy-less evals of a mixed storm
    policy_tput_term: Optional[torch.Tensor] = None  # f[E, C] coef * tput
    policy_has_tput: Optional[torch.Tensor] = None  # f[E] 0/1 flag
    policy_mig_term: Optional[torch.Tensor] = None  # f[E, C] coef * mig


class StormOut(NamedTuple):
    """The six outputs of a solve, on the inputs' device."""

    assigned: torch.Tensor  # i32[A] arena row per alloc row, NO_NODE unsolved
    pulls: torch.Tensor  # i32[A] walk pulls when the greedy pick held,
    #                      the candidate count otherwise
    accept_round: torch.Tensor  # i32[A] auction round (-1 = unsolved)
    score: torch.Tensor  # f[A] the assignment's score matrix entry
    greedy: torch.Tensor  # i32[A] the warm-start walk winner
    rounds: torch.Tensor  # i32 scalar: auction rounds run


_POLICY = ("policy_tput_term", "policy_has_tput", "policy_mig_term")
_FLOATS = ("affinity", "ask", "pre_cpu", "pre_mem", "pre_disk") + _POLICY
_BOOLS = ("feasible", "penalty", "real")


def _check(inp: StormInputs, cols) -> torch.device:
    """Device, type and shape checks shared by the twin and K5."""
    weighted = [getattr(inp, f) is not None for f in _POLICY]
    if any(weighted) and not all(weighted):
        raise ValueError(
            "a weighted storm stages all three policy fields, or none"
        )
    if len(cols) != 6:
        raise ValueError("cols must be the six node columns")
    dev = cols[0].device
    dtype = cols[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"node columns must be f32 or f64, got {dtype}")
    C = cols[0].shape[0]
    for t in cols:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (C,):
            raise ValueError(f"node columns must be {dtype}[{C}] on {dev}")
    E, A = inp.feasible.shape[0], inp.ask.shape[0]
    shapes = {
        "feasible": (E, C), "affinity": (E, C), "collisions": (E, C),
        "perm": (E, C), "limit": (E,), "n_cand": (E,), "eval_of": (A,),
        "penalty": (A, C), "ask": (A, 3), "desired": (A,), "real": (A,),
        "pre_cpu": (C,), "pre_mem": (C,), "pre_disk": (C,),
    }
    if all(weighted):
        shapes.update(policy_tput_term=(E, C), policy_has_tput=(E,),
                      policy_mig_term=(E, C))
    for name, shape in shapes.items():
        t = getattr(inp, name)
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        want = (dtype if name in _FLOATS else
                torch.bool if name in _BOOLS else torch.int32)
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if A == 0 or E == 0 or C == 0:
        raise ValueError("a storm needs at least one row, eval and node")
    return dev


def _walk_rows(feasible, scores, perm, limit, n_candidates):
    """`limited_walk_argmax` (ops/score.py) for every row at once, as
    the JAX program vmaps it: each row walks its own perm.  Returns
    (chosen_row i32[A], pulls i32[A])."""
    i32 = torch.int32
    dev = scores.device
    perm_l = perm.long()
    s = torch.gather(scores, 1, perm_l)
    f = torch.gather(feasible, 1, perm_l)

    bad = f & (s <= SKIP_THRESHOLD)
    bad_rank = torch.cumsum(bad.to(i32), 1, dtype=i32)
    diverted = bad & (bad_rank <= MAX_SKIP)
    nd = f & ~diverted
    nd_cum = torch.cumsum(nd.to(i32), 1, dtype=i32)
    nd_count = nd_cum[:, -1:]
    nd_rank = nd_cum - 1
    n_div = torch.sum(diverted.to(i32), 1, keepdim=True, dtype=i32)
    div_rank = torch.cumsum(diverted.to(i32), 1, dtype=i32) - 1
    div_order = torch.where(
        (n_div == 2) & (nd_count > 0), 1 - div_rank, div_rank
    )
    emit_order = torch.where(nd, nd_rank, nd_count + div_order)
    emitted = f & (emit_order < limit[:, None])

    neg_inf = torch.full((), -float("inf"), dtype=s.dtype, device=dev)
    masked = torch.where(emitted, s, neg_inf)
    best = torch.amax(masked, 1, keepdim=True)
    candidates = emitted & (masked == best)
    order_key = torch.where(
        candidates, emit_order,
        torch.full((), 2**31 - 1, dtype=i32, device=dev),
    )
    win_pos = torch.argmin(order_key, 1)
    chosen = torch.gather(perm, 1, win_pos[:, None])[:, 0]
    chosen = torch.where(
        torch.any(emitted, 1), chosen,
        torch.full((), NO_NODE, dtype=i32, device=dev),
    )
    limit_reached = nd_count[:, 0] >= limit
    lth_pos = torch.argmax((nd_cum >= limit[:, None]).to(i32), 1).to(i32)
    pulls = torch.where(limit_reached, lth_pos + 1, n_candidates)
    return chosen, pulls.to(i32)


def storm_jitter(A: int, C: int, dtype, device) -> torch.Tensor:
    """The fixed per-(row, node) tie-spreading perturbation: the int32
    Knuth-hash lattice (row * -1640531527 + node * 40503) & 0xFFFF,
    scaled to [0, TIE_JITTER).  The int32 wraparound is taken in int64
    and masked: the low 16 bits agree."""
    return _jitter_at(torch.arange(A, device=device),
                      torch.arange(C, device=device), dtype)


def _jitter_at(rows: torch.Tensor, nodes: torch.Tensor, dtype) -> torch.Tensor:
    """`storm_jitter` at the given row ids [R] and global node ids [N]."""
    h = (rows.long()[:, None] * JITTER_ROW
         + nodes.long()[None, :] * JITTER_NODE) & 0xFFFF
    return h.to(dtype) / 65536.0 * torch.tensor(
        TIE_JITTER, dtype=dtype, device=rows.device
    )


def storm_scores(inp: StormInputs, cols, spread_fit: bool):
    """The broadcast [A, C] score matrix and its feasibility (padding
    rows masked out), through the serial chain's own `score_vectors`
    with the policy rows gathered by eval, and the six node columns
    with the staged pre-placement deltas added.  Returns (feas, scores,
    si)."""
    cpu_t, mem_t, disk_t, cpu_u, mem_u, disk_u = cols
    dtype = cpu_t.dtype
    cpu_u = cpu_u + inp.pre_cpu
    mem_u = mem_u + inp.pre_mem
    disk_u = disk_u + inp.pre_disk
    eo = inp.eval_of.long()
    si = ScoreInputs(
        cpu_total=cpu_t, mem_total=mem_t, disk_total=disk_t,
        cpu_used=cpu_u, mem_used=mem_u, disk_used=disk_u,
        feasible=inp.feasible[eo],
        collisions=inp.collisions[eo],
        penalty=inp.penalty,
        affinity_score=inp.affinity[eo],
        spread_boost=torch.zeros((), dtype=dtype, device=cpu_t.device),
        perm=inp.perm[eo],
        ask_cpu=inp.ask[:, 0:1],
        ask_mem=inp.ask[:, 1:2],
        ask_disk=inp.ask[:, 2:3],
        desired_count=inp.desired[:, None],
        limit=inp.limit[eo],
        n_candidates=inp.n_cand[eo],
        policy=(
            None
            if inp.policy_tput_term is None
            else PolicyTerms(
                tput_term=inp.policy_tput_term[eo],
                has_tput=inp.policy_has_tput[eo][:, None],
                mig_term=inp.policy_mig_term[eo],
            )
        ),
    )
    feas, scores = score_vectors(si, spread_fit)
    return feas & inp.real[:, None], scores, si


def storm_assignment_twin(inp: StormInputs, cols, spread_fit: bool,
                          max_rounds: int) -> StormOut:
    """Plain twin of the JAX `storm_assignment`, op for op: the same
    broadcast score matrix, per-row warm-start walk, int32 jitter
    lattice and auction rounds (`storm_auction_twin`, a Python loop with
    the JAX `cond`).  Three steps of a round are written in another form
    that gives the same bits:
    the per-node max ask is a scatter-max over the bidders (a max is
    exact in any order), the nodes that received a bid come from their
    bidders, and the debit `free - acc_oh.T @ ask` adds each node's
    accepted asks in ascending row order and subtracts the sum once.
    XLA's dot may add in another order; with whole-valued asks (Nomad's
    MHz and MB) every order gives the same sum."""
    _check(inp, cols)
    cpu_t, mem_t, disk_t = cols[:3]
    dtype = cpu_t.dtype
    dev = cpu_t.device
    i32 = torch.int32
    C = cpu_t.shape[0]

    feas, scores, si = storm_scores(inp, cols, spread_fit)
    rows0, pulls0 = _walk_rows(feas, scores, si.perm, si.limit,
                               si.n_candidates)
    free = torch.stack([cpu_t - si.cpu_used, mem_t - si.mem_used,
                        disk_t - si.disk_used], dim=1)
    assigned, acc_round, rnd = storm_auction_twin(
        feas, scores, rows0, inp.ask, inp.real, free, max_rounds)
    solved = assigned >= 0
    kept_walk = solved & (assigned == rows0)
    pulls = torch.where(kept_walk, pulls0, si.n_candidates).to(i32)
    score = torch.where(
        solved,
        torch.gather(
            scores, 1, torch.clamp(assigned, 0, C - 1).long()[:, None]
        )[:, 0],
        torch.zeros((), dtype=dtype, device=dev),
    )
    return StormOut(assigned, pulls, acc_round, score, rows0,
                    torch.tensor(rnd, dtype=i32, device=dev))


def storm_auction_twin(feas, scores, rows0, ask, real, free,
                       max_rounds: int, state: bool = False):
    """The JAX program's auction rounds (its `while_loop` over `body`) on
    the [A, C] feasibility and score matrices, the warm start rows0, the
    asks [A, 3], the real-row mask and the nodes' free capacity [C, 3]:
    returns (assigned, accept_round, rounds), and with `state` the final
    free capacity and prices after them."""
    dtype = scores.dtype
    dev = scores.device
    i32 = torch.int32
    A, C = scores.shape
    neg_inf = torch.full((), -float("inf"), dtype=dtype, device=dev)
    row_ids = torch.arange(A, dtype=i32, device=dev)
    jitter = storm_jitter(A, C, dtype, dev)
    rows0_c = torch.clamp(rows0, 0, C - 1).long()
    eps = torch.tensor(PRICE_EPS, dtype=dtype, device=dev)
    tiny = torch.tensor(1e-9, dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    assigned = torch.full((A,), NO_NODE, dtype=i32, device=dev)
    price = torch.zeros(C, dtype=dtype, device=dev)
    acc_round = torch.full((A,), -1, dtype=i32, device=dev)
    rnd = 0
    progress = True
    while rnd < max_rounds and progress:
        unass = (assigned == NO_NODE) & real
        # an assigned or padding row's values are all -inf: its argmax
        # is node 0 and it makes no bid, so only the unassigned rows
        # are scanned (the same result, far less work in late rounds)
        u = torch.nonzero(unass)[:, 0]
        au = ask[u]
        fits = (
            (free[None, :, 0] >= au[:, 0:1])
            & (free[None, :, 1] >= au[:, 1:2])
            & (free[None, :, 2] >= au[:, 2:3])
        )
        ok = feas[u] & fits
        value = torch.where(ok, scores[u] - price[None, :], neg_inf)
        best_c = torch.zeros(A, dtype=torch.int64, device=dev)
        best_v = neg_inf.expand(A).clone()
        walk_v = neg_inf.expand(A).clone()
        best_c[u] = torch.argmax(value + jitter[u], dim=1)
        best_v[u] = torch.gather(value, 1, best_c[u][:, None])[:, 0]
        walk_v[u] = torch.gather(value, 1, rows0_c[u][:, None])[:, 0]
        use_walk = (rnd == 0) & (rows0 >= 0) & (walk_v > neg_inf)
        bid_c = torch.where(use_walk, rows0_c, best_c)
        bid_v = torch.where(use_walk, walk_v, best_v)
        has_bid = bid_v > neg_inf
        same = (
            (bid_c[:, None] == bid_c[None, :])
            & has_bid[:, None] & has_bid[None, :]
        )
        better = (bid_v[None, :] > bid_v[:, None]) | (
            (bid_v[None, :] == bid_v[:, None])
            & (row_ids[None, :] < row_ids[:, None])
        )
        rank = torch.sum(same & better, dim=1, dtype=i32)
        bidders = torch.nonzero(has_bid)[:, 0]
        maxask = torch.zeros((C, 3), dtype=dtype, device=dev)
        maxask.scatter_reduce_(
            0, bid_c[bidders][:, None].expand(-1, 3), ask[bidders], "amax"
        )
        m = torch.amin(
            torch.where(
                maxask > 0,
                torch.floor(free / torch.maximum(maxask, tiny)),
                inf,
            ),
            dim=1,
        )
        accepted = has_bid & ((rank == 0) | (rank.to(dtype) < m[bid_c]))
        assigned = torch.where(accepted, bid_c.to(i32), assigned)
        acc_round = torch.where(
            accepted, torch.full((), rnd, dtype=i32, device=dev), acc_round
        )
        acc = torch.nonzero(accepted)[:, 0]  # ascending row order
        debit = torch.stack([
            ordered_index_add(
                torch.zeros(C, dtype=dtype, device=dev), bid_c[acc],
                ask[acc, d],
            )
            for d in range(3)
        ], dim=1)
        free = free - debit
        got_bid = torch.zeros(C, dtype=torch.bool, device=dev)
        got_bid[bid_c[bidders]] = True
        price = price + torch.where(got_bid, eps, torch.zeros_like(eps))
        rnd += 1
        progress = bool(torch.any(accepted))

    if state:
        return assigned, acc_round, rnd, free, price
    return assigned, acc_round, rnd


def storm_assignment_cuda(inp: StormInputs, cols, spread_fit: bool,
                          max_rounds: int, stamps=None,
                          _max_blocks: int = 0) -> StormOut:
    """Launch K5 on the current stream of the tensors' CUDA device:
    the score matrix, the warm-start walks and the auction (one
    cooperative launch whose round loop stays on the card).  Returns
    the six outputs as device tensors; nothing is synchronised.
    `stamps` (int64 on the card, `_cuda.storm_stamp_len(max_rounds)`
    long, or None on every path) takes the kernels' timer stamps.
    `launches` counts solves, `blocks` is the last auction's grid;
    `_max_blocks` caps it (the card tests set it; 0: as many 1,024-thread
    blocks as the card holds)."""
    from . import _cuda

    dev = _check(inp, cols)
    if dev.type != "cuda":
        raise ValueError(f"storm_assignment_cuda needs CUDA tensors, got {dev}")
    if max_rounds < 0:
        raise ValueError(f"max_rounds must be >= 0, got {max_rounds}")
    cols = tuple(c.contiguous() for c in cols)
    inp = StormInputs(*(None if t is None else t.contiguous() for t in inp))
    out, blocks = _cuda.launch_storm_solve(
        inp, cols, spread_fit=spread_fit, max_rounds=max_rounds,
        stamps=stamps, max_blocks=_max_blocks)
    storm_assignment_cuda.launches += 1
    storm_assignment_cuda.blocks = blocks
    return StormOut(*out)


storm_assignment_cuda.launches = 0
storm_assignment_cuda.blocks = 0


def storm_assignment(inp: StormInputs, cols, spread_fit: bool,
                     max_rounds: int) -> StormOut:
    """Solve one storm.  The twin for CPU columns, K5 for CUDA columns;
    ``cols`` is the six node columns (cpu/mem/disk totals, then used)
    and every input lies on their device."""
    dev = cols[0].device
    if dev.type == "cpu":
        return storm_assignment_twin(inp, cols, spread_fit, max_rounds)
    if dev.type == "cuda":
        return storm_assignment_cuda(inp, cols, spread_fit, max_rounds)
    raise ValueError(f"no storm solver for device {dev}")


# ---------------------------------------------------------------------------
# the node-sharded solve: shared driver, stages as K14 or the twin
# ---------------------------------------------------------------------------

# how a `StormInputs` leaf lies on a node mesh (`storm_in_specs`)
SHARD_ROWS = "rows"  # [E, C] / [A, C]: sharded along the node axis 1
SHARD_COL = "col"  # [C]: sharded along axis 0
REPLICATED = "replicated"  # per-eval / per-row: whole on every process


def storm_in_specs(weighted: bool = False) -> StormInputs:
    """The node-sharded solve's layout of `StormInputs` (the JAX
    `storm_in_specs`, `ops/solve.py:327`): node-indexed leaves are
    sharded (`SHARD_ROWS` for the [E, C] / [A, C] masks and policy rows,
    `SHARD_COL` for the [C] pre-placement columns), the per-eval and
    per-row leaves `REPLICATED`; the policy leaves are None (absent) for
    an unweighted storm.  The one definition that `stage_for_mesh` and
    the solve share."""
    return StormInputs(
        feasible=SHARD_ROWS, affinity=SHARD_ROWS, collisions=SHARD_ROWS,
        perm=REPLICATED, limit=REPLICATED, n_cand=REPLICATED,
        eval_of=REPLICATED, penalty=SHARD_ROWS, ask=REPLICATED,
        desired=REPLICATED, real=REPLICATED, pre_cpu=SHARD_COL,
        pre_mem=SHARD_COL, pre_disk=SHARD_COL,
        policy_tput_term=SHARD_ROWS if weighted else None,
        policy_has_tput=REPLICATED if weighted else None,
        policy_mig_term=SHARD_ROWS if weighted else None,
    )


def place_storm_inputs(inp: StormInputs, mesh) -> StormInputs:
    """Each leaf of `inp` on the mesh as `storm_in_specs` lays it out:
    node-indexed leaves as `Sharded` (`NodeMesh.shard`; one that already
    is passes through), the others whole on the mesh's device.  Leaves
    keep their types (numpy bool, int32, float as staged)."""
    from ..parallel.mesh import Sharded

    weighted = inp.policy_tput_term is not None
    out = []
    for leaf, spec in zip(inp, storm_in_specs(weighted)):
        if leaf is None or spec is None:
            out.append(None)
        elif isinstance(leaf, Sharded):
            out.append(mesh.shard(leaf))
        else:
            t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
                np.ascontiguousarray(leaf))
            if spec == REPLICATED:
                out.append(t.to(mesh.device))
            else:
                out.append(mesh.shard(t, axis=1 if spec == SHARD_ROWS else 0))
    return StormInputs(*out)


class _StormShard:
    """One local shard's node columns, node-indexed inputs and scratch."""

    def __init__(self, s: int, lo: int, size: int) -> None:
        self.s, self.lo, self.size = s, lo, size


class _Storm:
    """Every tensor of one sharded solve on the mesh's device: the
    shards' own, and the replicated ones once per process."""


def prepare_sharded_storm(mesh, inp: StormInputs, cols,
                          spread_fit: bool, max_rounds: int) -> _Storm:
    """One solve's inputs on the mesh (`place_storm_inputs`; the six
    node columns `Sharded` or whole [C]), checked for device, type and
    shape, with the state, exchange buffers and scratch the stages use.
    `Sharded` columns (the sharded usage mirror) are read in place."""
    from ..parallel.mesh import Sharded

    weighted = [getattr(inp, f) is not None for f in _POLICY]
    if any(weighted) and not all(weighted):
        raise ValueError(
            "a weighted storm stages all three policy fields, or none")
    if len(cols) != 6:
        raise ValueError("cols must be the six node columns")
    if max_rounds < 0:
        raise ValueError(f"max_rounds must be >= 0, got {max_rounds}")
    dev = mesh.device
    cols = tuple(mesh.shard(c) for c in cols)
    dtype = cols[0].shards[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"node columns must be f32 or f64, got {dtype}")
    S = int(cols[0].shards[0].shape[0])
    C = S * mesh.n_shards
    mesh.shard_size(C)
    inp = place_storm_inputs(inp, mesh)
    E, A = int(inp.perm.shape[0]), int(inp.ask.shape[0])
    if A == 0 or E == 0 or C == 0:
        raise ValueError("a storm needs at least one row, eval and node")
    lead = {"feasible": E, "affinity": E, "collisions": E, "penalty": A,
            "policy_tput_term": E, "policy_mig_term": E}
    whole = {"perm": (E, C), "limit": (E,), "n_cand": (E,), "eval_of": (A,),
             "ask": (A, 3), "desired": (A,), "real": (A,),
             "policy_has_tput": (E,)}
    specs = storm_in_specs(all(weighted))
    for name, spec in zip(StormInputs._fields, specs):
        leaf = getattr(inp, name)
        if spec is None:
            continue
        want = (dtype if name in _FLOATS else
                torch.bool if name in _BOOLS else torch.int32)
        parts = leaf.shards if isinstance(leaf, Sharded) else (leaf,)
        shape = (whole[name] if spec == REPLICATED else
                 (lead[name], S) if spec == SHARD_ROWS else (S,))
        for t in parts:
            if t.device != dev or t.dtype != want or tuple(t.shape) != shape:
                raise ValueError(
                    f"{name} must be {want}{list(shape)} on {dev}, got "
                    f"{t.dtype}{list(t.shape)} on {t.device}")
    for c in cols:
        for t in c.shards:
            if (t.device != dev or t.dtype != dtype or tuple(t.shape) != (S,)
                    or not t.is_contiguous()):
                raise ValueError(
                    f"node columns must be contiguous {dtype}[{S}] shards "
                    f"on {dev}")

    st = _Storm()
    st.mesh, st.dtype, st.E, st.A, st.C, st.S = mesh, dtype, E, A, C, S
    st.D, st.spread_fit, st.max_rounds = mesh.n_shards, bool(spread_fit), int(max_rounds)
    st.weighted = all(weighted)
    st.perm, st.limit, st.n_cand = inp.perm, inp.limit, inp.n_cand
    st.eval_of, st.ask, st.desired, st.real = (inp.eval_of, inp.ask,
                                                inp.desired, inp.real)
    st.has_tput = inp.policy_has_tput
    i32, u8 = torch.int32, torch.uint8
    st.shards = []
    for i, s in enumerate(mesh.local_shards):
        sh = _StormShard(s, s * S, S)
        sh.tot = tuple(c.shards[i] for c in cols[:3])
        sh.used = tuple(c.shards[i] for c in cols[3:])
        sh.pre = tuple(x.shards[i] for x in (inp.pre_cpu, inp.pre_mem,
                                             inp.pre_disk))
        sh.feasible = inp.feasible.shards[i]
        sh.affinity = inp.affinity.shards[i]
        sh.collisions = inp.collisions.shards[i]
        sh.penalty = inp.penalty.shards[i]
        sh.tput = inp.policy_tput_term.shards[i] if st.weighted else None
        sh.mig = inp.policy_mig_term.shards[i] if st.weighted else None
        sh.scores = torch.zeros((A, S), dtype=dtype, device=dev)
        sh.feas = torch.zeros((A, S), dtype=u8, device=dev)
        sh.free = torch.zeros((S, 3), dtype=dtype, device=dev)
        sh.price = torch.zeros(S, dtype=dtype, device=dev)
        sh.rec_max = torch.zeros(A, dtype=dtype, device=dev)
        sh.rec_idx = torch.zeros(A, dtype=i32, device=dev)
        sh.cand = torch.zeros(A, dtype=i32, device=dev)
        sh.terms = torch.zeros((2, A), dtype=dtype, device=dev)
        sh.m_term = torch.zeros(A, dtype=dtype, device=dev)
        sh.score_term = torch.zeros(A, dtype=dtype, device=dev)
        st.shards.append(sh)
    D = st.D
    st.scores_g = torch.zeros((D, A, S), dtype=dtype, device=dev)
    st.feas_g = torch.zeros((D, A, S), dtype=u8, device=dev)
    st.s_walk = torch.zeros((A, C), dtype=dtype, device=dev)
    st.f_walk = torch.zeros((A, C), dtype=u8, device=dev)
    st.gmax = torch.zeros(A, dtype=dtype, device=dev)
    st.best_c = torch.zeros(A, dtype=i32, device=dev)
    st.reads = torch.zeros((2, A), dtype=dtype, device=dev)
    st.m_at_bid = torch.zeros(A, dtype=dtype, device=dev)
    st.score_read = torch.zeros(A, dtype=dtype, device=dev)
    st.rows0 = torch.zeros(A, dtype=i32, device=dev)
    st.pulls0 = torch.zeros(A, dtype=i32, device=dev)
    st.bid_c = torch.zeros(A, dtype=i32, device=dev)
    st.bid_v = torch.zeros(A, dtype=dtype, device=dev)
    st.has_bid = torch.zeros(A, dtype=i32, device=dev)
    st.accepted = torch.zeros(A, dtype=i32, device=dev)
    st.assigned = torch.full((A,), NO_NODE, dtype=i32, device=dev)
    st.acc_round = torch.full((A,), -1, dtype=i32, device=dev)
    st.progress = torch.zeros(max(1, st.max_rounds), dtype=i32, device=dev)
    st.out_pulls = torch.zeros(A, dtype=i32, device=dev)
    st.out_score = torch.zeros(A, dtype=dtype, device=dev)
    st.out_rounds = torch.zeros(1, dtype=i32, device=dev)
    return st


def _storm_prologue(st: _Storm, stages) -> None:
    """The score stage a shard, the solve's one full gather (the warm
    start walks the global permuted order) and the walk."""
    mesh = st.mesh
    for sh in st.shards:
        stages.score(st, sh)
    mesh.gather([sh.scores for sh in st.shards], out=st.scores_g)
    mesh.gather([sh.feas for sh in st.shards], out=st.feas_g)
    stages.walk(st)


def _read_progress(st: _Storm, rnd: int) -> bool:
    """The host's read of round `rnd`'s progress flag (replicated math:
    every process of a `DistMesh` reads the same value)."""
    return bool(int(st.progress[rnd]))


def _storm_rounds(st: _Storm, stages) -> int:
    """The auction rounds with the mesh's exchanges between the stages,
    and the epilogue; returns the rounds run.  The host reads one
    progress flag a round."""
    mesh = st.mesh
    shards = st.shards
    rnd = 0
    while rnd < st.max_rounds:
        for sh in shards:
            stages.bid(st, sh, rnd)
        mesh.pmax([sh.rec_max for sh in shards], out=st.gmax)
        for sh in shards:
            stages.cand(st, sh)
        mesh.pmin([sh.cand for sh in shards], out=st.best_c)
        for sh in shards:
            stages.read(st, sh, rnd)
        mesh.psum([sh.terms for sh in shards], out=st.reads)
        stages.bids(st, rnd)
        for sh in shards:
            stages.budget(st, sh)
        mesh.psum([sh.m_term for sh in shards], out=st.m_at_bid)
        stages.accept(st, rnd)
        for sh in shards:
            stages.debit(st, sh)
        rnd += 1
        if not _read_progress(st, rnd - 1):
            break
    for sh in shards:
        stages.epi_read(st, sh)
    mesh.psum([sh.score_term for sh in shards], out=st.score_read)
    stages.finish(st, rnd)
    return rnd


def _drive_storm(st: _Storm, stages) -> int:
    """The launch sequence of one staged sharded solve, the same for K14
    on a `DistMesh` and for its twin, with the mesh's exchanges between
    the stages; returns the rounds run."""
    _storm_prologue(st, stages)
    return _storm_rounds(st, stages)


def storm_stage_launches(mesh, rounds: int) -> int:
    """Kernel launches of one K14 solve of `rounds` auction rounds in
    this process.  On a `VirtualMesh`: a score stage a shard, the walk,
    and one cooperative launch for the rounds and the epilogue.  On any
    other mesh (its exchanges cross processes): a score and an epilogue
    read per shard, the walk and the finish once; a round five stages per
    shard (bid, cand, read, budget, debit) and two per process (bids,
    accept)."""
    from ..parallel.mesh import VirtualMesh

    d = len(mesh.local_shards)
    if isinstance(mesh, VirtualMesh):
        return d + 2
    return 2 * d + 2 + rounds * (5 * d + 2)


# -- the twin's stages --------------------------------------------------------


def _owner_read(st: _Storm, sh: _StormShard, arr: torch.Tensor,
                gidx: torch.Tensor) -> torch.Tensor:
    """The ownership read of the JAX program: row a's entry of the
    shard's [A, S] `arr` at global node gidx[a] where this shard owns
    it, else +0.0 (psum-reduced over the shards: one owner)."""
    loc = gidx.long() - sh.lo
    mine = (loc >= 0) & (loc < sh.size)
    safe = torch.clamp(loc, 0, sh.size - 1)
    v = torch.gather(arr, 1, safe[:, None])[:, 0]
    return torch.where(mine, v, torch.zeros_like(v))


class _StormTwinStages:
    """K14's stages in plain torch, on the solve's tensors."""

    @staticmethod
    def _unass(st: _Storm) -> torch.Tensor:
        return (st.assigned == NO_NODE) & st.real

    @staticmethod
    def _value(st: _Storm, sh: _StormShard, rows: torch.Tensor) -> torch.Tensor:
        """value_l of the given unassigned rows: score - price where the
        node is feasible and its free capacity fits the ask, else -inf."""
        ask = st.ask[rows]
        fits = ((sh.free[None, :, 0] >= ask[:, 0:1])
                & (sh.free[None, :, 1] >= ask[:, 1:2])
                & (sh.free[None, :, 2] >= ask[:, 2:3]))
        ok = (sh.feas[rows] != 0) & fits
        return torch.where(ok, sh.scores[rows] - sh.price[None, :],
                           torch.full((), -float("inf"), dtype=st.dtype,
                                      device=ok.device))

    @staticmethod
    def score(st: _Storm, sh: _StormShard) -> None:
        eo = st.eval_of.long()
        cpu_t, mem_t, disk_t = sh.tot
        cpu_u, mem_u, disk_u = (u + p for u, p in zip(sh.used, sh.pre))
        si = ScoreInputs(
            cpu_total=cpu_t, mem_total=mem_t, disk_total=disk_t,
            cpu_used=cpu_u, mem_used=mem_u, disk_used=disk_u,
            feasible=sh.feasible[eo], collisions=sh.collisions[eo],
            penalty=sh.penalty, affinity_score=sh.affinity[eo],
            spread_boost=torch.zeros((), dtype=st.dtype, device=cpu_t.device),
            perm=None, ask_cpu=st.ask[:, 0:1], ask_mem=st.ask[:, 1:2],
            ask_disk=st.ask[:, 2:3], desired_count=st.desired[:, None],
            limit=None, n_candidates=None,
            policy=None if not st.weighted else PolicyTerms(
                tput_term=sh.tput[eo], has_tput=st.has_tput[eo][:, None],
                mig_term=sh.mig[eo]),
        )
        feas, scores = score_vectors(si, st.spread_fit)
        sh.scores.copy_(scores)
        sh.feas.copy_((feas & st.real[:, None]).to(torch.uint8))
        sh.free.copy_(torch.stack([cpu_t - cpu_u, mem_t - mem_u,
                                   disk_t - disk_u], dim=1))
        sh.price.zero_()

    @staticmethod
    def walk(st: _Storm) -> None:
        eo = st.eval_of.long()
        A, C = st.A, st.C
        scores = st.scores_g.permute(1, 0, 2).reshape(A, C)
        feas = st.feas_g.permute(1, 0, 2).reshape(A, C) != 0
        rows0, pulls0 = _walk_rows(feas, scores, st.perm[eo], st.limit[eo],
                                   st.n_cand[eo])
        st.rows0.copy_(rows0)
        st.pulls0.copy_(pulls0)
        st.assigned.fill_(NO_NODE)
        st.acc_round.fill_(-1)
        st.progress.zero_()

    @staticmethod
    def bid(st: _Storm, sh: _StormShard, rnd: int) -> None:
        # an assigned or padding row's values are all -inf: its local max
        # is -inf at the shard's first node, and only the unassigned rows
        # are scanned
        sh.rec_max.fill_(-float("inf"))
        sh.rec_idx.fill_(sh.lo)
        u = torch.nonzero(_StormTwinStages._unass(st))[:, 0]
        if u.numel() == 0:
            return
        nodes = sh.lo + torch.arange(sh.size, device=u.device)
        jv = _StormTwinStages._value(st, sh, u) + _jitter_at(u, nodes, st.dtype)
        best = torch.amax(jv, dim=1)
        first = torch.argmax((jv == best[:, None]).to(torch.uint8), dim=1)
        sh.rec_max[u] = best
        sh.rec_idx[u] = (sh.lo + first).to(torch.int32)

    @staticmethod
    def cand(st: _Storm, sh: _StormShard) -> None:
        sh.cand.copy_(torch.where(
            sh.rec_max == st.gmax, sh.rec_idx,
            torch.full((), 2**31 - 1, dtype=torch.int32,
                       device=sh.cand.device)))

    @staticmethod
    def _value_at(st: _Storm, sh: _StormShard, gidx: torch.Tensor) -> torch.Tensor:
        """The ownership read of value_l at global node gidx[a] for every
        row (an assigned or padding row's value is -inf): the owner's
        value, +0.0 elsewhere."""
        raw = gidx.long() - sh.lo
        mine = (raw >= 0) & (raw < sh.size)
        loc = torch.clamp(raw, 0, sh.size - 1)
        rows = torch.arange(st.A, device=gidx.device)
        free = sh.free[loc]
        ok = ((sh.feas[rows, loc] != 0) & _StormTwinStages._unass(st)
              & (free[:, 0] >= st.ask[:, 0]) & (free[:, 1] >= st.ask[:, 1])
              & (free[:, 2] >= st.ask[:, 2]))
        value = torch.where(ok, sh.scores[rows, loc] - sh.price[loc],
                            torch.full((), -float("inf"), dtype=st.dtype,
                                       device=ok.device))
        return torch.where(mine, value, torch.zeros_like(value))

    @staticmethod
    def read(st: _Storm, sh: _StormShard, rnd: int) -> None:
        sh.terms[0].copy_(_StormTwinStages._value_at(st, sh, st.best_c))
        if rnd == 0:
            rows0_c = torch.clamp(st.rows0, 0, st.C - 1)
            sh.terms[1].copy_(_StormTwinStages._value_at(st, sh, rows0_c))
        else:  # only round 0 bids the walk winner
            sh.terms[1].zero_()

    @staticmethod
    def bids(st: _Storm, rnd: int) -> None:
        neg_inf = torch.full((), -float("inf"), dtype=st.dtype,
                             device=st.bid_v.device)
        best_v, walk_v = st.reads[0], st.reads[1]
        rows0_c = torch.clamp(st.rows0, 0, st.C - 1)
        use_walk = (rnd == 0) & (st.rows0 >= 0) & (walk_v > neg_inf)
        st.bid_c.copy_(torch.where(use_walk, rows0_c, st.best_c))
        st.bid_v.copy_(torch.where(use_walk, walk_v, best_v))
        st.has_bid.copy_((st.bid_v > neg_inf).to(torch.int32))

    @staticmethod
    def budget(st: _Storm, sh: _StormShard) -> None:
        dev = sh.free.device
        loc = st.bid_c.long() - sh.lo
        bidders = torch.nonzero((st.has_bid != 0) & (loc >= 0)
                                & (loc < sh.size))[:, 0]
        maxask = torch.zeros((sh.size, 3), dtype=st.dtype, device=dev)
        maxask.scatter_reduce_(0, loc[bidders][:, None].expand(-1, 3),
                               st.ask[bidders], "amax")
        tiny = torch.tensor(1e-9, dtype=st.dtype, device=dev)
        m = torch.amin(torch.where(
            maxask > 0, torch.floor(sh.free / torch.maximum(maxask, tiny)),
            torch.tensor(float("inf"), dtype=st.dtype, device=dev)), dim=1)
        raw = st.bid_c.long() - sh.lo
        mine = (raw >= 0) & (raw < sh.size)
        at = m[torch.clamp(raw, 0, sh.size - 1)]
        sh.m_term.copy_(torch.where(mine, at, torch.zeros_like(at)))

    @staticmethod
    def accept(st: _Storm, rnd: int) -> None:
        has = st.has_bid != 0
        c, v = st.bid_c, st.bid_v
        rows = torch.arange(st.A, dtype=torch.int32, device=c.device)
        same = (c[:, None] == c[None, :]) & has[:, None] & has[None, :]
        better = (v[None, :] > v[:, None]) | (
            (v[None, :] == v[:, None]) & (rows[None, :] < rows[:, None]))
        rank = torch.sum(same & better, dim=1, dtype=torch.int32)
        acc = has & ((rank == 0) | (rank.to(st.dtype) < st.m_at_bid))
        st.assigned.copy_(torch.where(acc, c, st.assigned))
        st.acc_round.copy_(torch.where(
            acc, torch.full((), rnd, dtype=torch.int32, device=c.device),
            st.acc_round))
        st.accepted.copy_(acc.to(torch.int32))
        st.progress[rnd] = int(bool(acc.any()))

    @staticmethod
    def debit(st: _Storm, sh: _StormShard) -> None:
        dev = sh.free.device
        loc = st.bid_c.long() - sh.lo
        mine = (loc >= 0) & (loc < sh.size)
        acc = torch.nonzero((st.accepted != 0) & mine)[:, 0]  # ascending rows
        debit = torch.stack([
            ordered_index_add(torch.zeros(sh.size, dtype=st.dtype, device=dev),
                              loc[acc], st.ask[acc, d])
            for d in range(3)], dim=1)
        sh.free.copy_(sh.free - debit)
        got = torch.zeros(sh.size, dtype=torch.bool, device=dev)
        got[loc[torch.nonzero((st.has_bid != 0) & mine)[:, 0]]] = True
        eps = torch.tensor(PRICE_EPS, dtype=st.dtype, device=dev)
        sh.price.copy_(sh.price + torch.where(got, eps, torch.zeros_like(eps)))

    @staticmethod
    def epi_read(st: _Storm, sh: _StormShard) -> None:
        sh.score_term.copy_(_owner_read(
            st, sh, sh.scores, torch.clamp(st.assigned, 0, st.C - 1)))

    @staticmethod
    def finish(st: _Storm, rounds: int) -> None:
        solved = st.assigned >= 0
        kept = solved & (st.assigned == st.rows0)
        st.out_pulls.copy_(torch.where(
            kept, st.pulls0, st.n_cand[st.eval_of.long()]))
        st.out_score.copy_(torch.where(
            solved, st.score_read, torch.zeros((), dtype=st.dtype,
                                               device=solved.device)))
        st.out_rounds.fill_(rounds)


def _out(st: _Storm) -> StormOut:
    return StormOut(st.assigned, st.out_pulls, st.acc_round, st.out_score,
                    st.rows0, st.out_rounds[0])


def storm_assignment_sharded_twin(mesh, spread_fit: bool, max_rounds: int,
                                  weighted: bool = False):
    """`storm_assignment_sharded` with the plain-torch stages on any mesh
    (the card checks hold K14 against it)."""
    return _sharded_runner(mesh, spread_fit, max_rounds, weighted, False)


def storm_assignment_sharded_cuda(st: _Storm, stamps=None,
                                  _max_blocks: int = 0) -> StormOut:
    """K14 over a prepared solve on the current stream; nothing is
    synchronised.  The mesh's kind picks the launches: on a `VirtualMesh`
    (every shard in this process on one card) the score stages, the
    gather and the walk, then ONE cooperative launch for the rounds and
    the epilogue, its exchanges and its progress flag in device memory
    (no host read a round); on a `DistMesh` the stages one by one with
    the mesh's collectives between them and one host read of the
    progress flag a round.  Any failure, a cooperative launch the card
    cannot hold included, raises `DeviceFault`: nothing falls back to the
    other launch path or to the twin.  `launches` counts kernel launches,
    `blocks` the last cooperative grid.  `stamps` (int64 on the card,
    `_cuda.storm_stamp_len(max_rounds)` long, or None on every path)
    takes the kernels' timer stamps; `_max_blocks` caps the cooperative
    grid (the card tests set it; 0: as the card holds)."""
    from ..device.core import DeviceFault
    from ..parallel.mesh import VirtualMesh
    from . import _cuda

    if st.mesh.device.type != "cuda":
        raise ValueError(f"K14 needs a mesh on the card, got {st.mesh.device}")
    try:
        if isinstance(st.mesh, VirtualMesh):
            # the shard count is checked before anything is built
            coop = _cuda.StormShardedCoop(st, stamps, _max_blocks)
            stages = _cuda.StormShardedStages(st, stamps)
            _storm_prologue(st, stages)
            coop.launch()
            storm_assignment_sharded_cuda.blocks = coop.blocks
            launched = stages.launched + 1
        else:
            stages = _cuda.StormShardedStages(st, stamps)
            _drive_storm(st, stages)
            launched = stages.launched
    except DeviceFault:
        raise
    except Exception as exc:  # a build, bind or launch failure
        raise DeviceFault(f"K14 storm_sharded failed: {exc}") from exc
    storm_assignment_sharded_cuda.launches += launched
    return _out(st)


storm_assignment_sharded_cuda.launches = 0
storm_assignment_sharded_cuda.blocks = 0


def _sharded_runner(mesh, spread_fit: bool, max_rounds: int, weighted: bool,
                    kernel: Optional[bool]):
    def run(inp: StormInputs, cols) -> StormOut:
        if (inp.policy_tput_term is not None) != bool(weighted):
            raise ValueError(
                f"a {'weighted' if weighted else 'unweighted'} solve was "
                f"given {'no ' if weighted else ''}policy rows")
        st = prepare_sharded_storm(mesh, inp, cols, spread_fit, max_rounds)
        use_kernel = (mesh.device.type == "cuda") if kernel is None else kernel
        if use_kernel:
            return storm_assignment_sharded_cuda(st)
        _drive_storm(st, _StormTwinStages)
        return _out(st)

    return run


def storm_assignment_sharded(mesh, spread_fit: bool, max_rounds: int,
                             weighted: bool = False):
    """The node-sharded storm solve (JAX `ops/solve.py:354
    storm_assignment_sharded`): returns ``run(inp, cols) -> StormOut``,
    bit-equal in all six outputs to the JAX program on a mesh of the same
    D (and so to `storm_assignment`, but for the sign of a zero score: an
    ownership read adds +0.0 from every other shard).  ``inp`` is laid
    out as `stage_for_mesh` (sched/storm.py) places it (node-indexed
    leaves `Sharded`; anything else is placed here), ``cols`` the six
    node columns, `Sharded` (the sharded usage mirror, read in place) or
    whole.  K14 when the mesh is on the card, the twin when it is on the
    CPU; nothing falls back from one to the other.  The arena must tile
    over the mesh (C % D == 0)."""
    return _sharded_runner(mesh, spread_fit, max_rounds, weighted, None)


def pad_axis(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad ``arr``'s leading axis out to ``n`` rows of ``fill``."""
    if arr.shape[0] == n:
        return arr
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out
