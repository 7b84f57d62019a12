"""Global storm assignment: one device solve for a whole backlog of
pending evals of one job family.  Port of `nomad_tpu/ops/solve.py`.

The JAX program `storm_assignment` (there `:113-314`) becomes kernel
K5, `csrc/storm_solve.cu`.  This module keeps:

* `StormInputs`, the host-staged inputs, as a NamedTuple of tensors;
* `storm_assignment_twin`, a plain-PyTorch copy of the JAX program
  that is bit-exact against it under x64 on the CPU;
* `storm_assignment_cuda`, the K5 wrapper, and `storm_assignment`,
  which runs the twin for CPU tensors and K5 for CUDA tensors.

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

Not ported: the node-sharded multi-device solve
(`storm_assignment_sharded`, `storm_in_specs`).
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
    rows = torch.arange(A, dtype=torch.int64, device=device)
    nodes = torch.arange(C, dtype=torch.int64, device=device)
    h = (rows[:, None] * JITTER_ROW + nodes[None, :] * JITTER_NODE) & 0xFFFF
    return h.to(dtype) / 65536.0 * torch.tensor(
        TIE_JITTER, dtype=dtype, device=device
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
    lattice and auction rounds (a Python loop with the JAX `cond`).
    Three steps are written in another form that gives the same bits:
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
    A = inp.ask.shape[0]
    C = cpu_t.shape[0]

    feas, scores, si = storm_scores(inp, cols, spread_fit)
    rows0, pulls0 = _walk_rows(feas, scores, si.perm, si.limit,
                               si.n_candidates)

    neg_inf = torch.full((), -float("inf"), dtype=dtype, device=dev)
    row_ids = torch.arange(A, dtype=i32, device=dev)
    jitter = storm_jitter(A, C, dtype, dev)
    free = torch.stack([cpu_t - si.cpu_used, mem_t - si.mem_used,
                        disk_t - si.disk_used], dim=1)
    rows0_c = torch.clamp(rows0, 0, C - 1).long()
    eps = torch.tensor(PRICE_EPS, dtype=dtype, device=dev)
    tiny = torch.tensor(1e-9, dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    ask = inp.ask

    assigned = torch.full((A,), NO_NODE, dtype=i32, device=dev)
    price = torch.zeros(C, dtype=dtype, device=dev)
    acc_round = torch.full((A,), -1, dtype=i32, device=dev)
    rnd = 0
    progress = True
    while rnd < max_rounds and progress:
        unass = (assigned == NO_NODE) & inp.real
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


def storm_assignment_cuda(inp: StormInputs, cols, spread_fit: bool,
                          max_rounds: int) -> StormOut:
    """Launch K5 on the current stream of the tensors' CUDA device:
    the score matrix, the warm-start walks and the auction (one
    cooperative launch whose round loop stays on the card).  Returns
    the six outputs as device tensors; nothing is synchronised."""
    from . import _cuda

    dev = _check(inp, cols)
    if dev.type != "cuda":
        raise ValueError(f"storm_assignment_cuda needs CUDA tensors, got {dev}")
    if max_rounds < 0:
        raise ValueError(f"max_rounds must be >= 0, got {max_rounds}")
    cols = tuple(c.contiguous() for c in cols)
    inp = StormInputs(*(None if t is None else t.contiguous() for t in inp))
    out = _cuda.launch_storm_solve(inp, cols, spread_fit=spread_fit,
                                   max_rounds=max_rounds)
    storm_assignment_cuda.launches += 1
    return StormOut(*out)


storm_assignment_cuda.launches = 0


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


def pad_axis(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad ``arr``'s leading axis out to ``n`` rows of ``fill``."""
    if arr.shape[0] == n:
        return arr
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out
