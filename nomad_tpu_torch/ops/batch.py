"""The look-ahead scan and the chained planner: the pick programs of
`nomad_tpu/ops/batch.py`.

Two JAX programs of that module become hand-written CUDA kernels here:

* `plan_picks_full` (there `:766`) -> kernel K2, `csrc/plan_picks.cu`:
  P sequential picks of one task group, behind the per-eval device
  stack's count > 1 selects;
* `chained_plan_picks_cols` (there `:905`, built from `_run_picks`
  `:347`, `_walk` `:281`, `_rotated_prefix` `:268` and
  `spread_contribution` `:155`) -> kernel K3, `csrc/chained_picks.cu`:
  E evals x P picks in one launch, serially equivalent, with the usage,
  static-port and device-instance carries threaded from eval to eval;
* `patch_rows` (there `:1091`) -> kernel K4, the one-shard case of K13
  in `csrc/patch_rows_mesh.cu`: the scatter that keeps the batch
  worker's device usage mirror current, its three usage columns in one
  launch a delta flush (`RowPatch` over plain columns);
* `batch_plan_picks_shared` (there `:1331`, a vmap of `plan_picks`
  `:735`) -> kernel K7, `csrc/batch_picks.cu`: E independent evals x P
  picks over one shared snapshot, behind the bridge's ScoreBatch;
* `chained_plan_picks` (there `:801`) and `chained_plan_picks_shared`
  (`:1262`) -> kernel K9, `csrc/chained_batch.cu`: the chain over
  per-eval BatchInputs, or over shared columns (stride 0), behind the
  benchmark's kernel-only `kernel-chained` rate;
* `batch_plan_picks` (there `:1391`, a vmap of `plan_picks`) -> kernel
  K10, `csrc/batch_plan.cu`: E independent evals over their own
  BatchInputs, behind the kernel-only `kernel-batch` rate;
* `patch_rows_sharded` (there `:1130`) -> kernel K13 and
  `patch_rows_hostlocal` (there `:1183`, with `hostlocal_staging`
  `:1234`) -> kernel K15, both `csrc/patch_rows_mesh.cu` with K4: the
  delta flush of a node-sharded usage mirror, from one replicated
  staging (one process) or from each process's own shard-local staging
  rows (a world of several).

Each pick scores every node against the usage and collision columns
carried from the earlier picks, runs the rotated limited walk, and
scatters the winner's deltas: the placement loop of one eval
(generic_sched.go:468 computePlacements).  The twins keep every
per-pick column in PERMUTED space, as the JAX program does, so the
walk's rotation by the carried offset is closed-form prefix
arithmetic.  The node-space carry handed to the next eval is rebuilt
the way the JAX program rebuilds it (pre-deltas, then every pick's ask
in pick order, then every applied eviction in pick order): in floating
point that order is part of the result.

The JAX module's donated variants (`chained_plan_picks_cols_donated`,
`patch_rows_donated`) have no counterpart: K3 writes its carry-out into
fresh tensors from PyTorch's caching allocator, whose blocks are reused
only in stream order, and K4 patches the mirror in place on the
worker's stream, behind every launch that reads it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .score import (
    INT32_MAX,
    INV_18,
    MAX_SKIP,
    NO_NODE,
    SKIP_THRESHOLD,
    Scalar,
    _host_float,
    _host_int,
    _pow10,
    _scalar,
    fma,
)


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Next power of two >= n: launch-shape bucketing, kept so that pick
    counts match the JAX package's."""
    v = max(floor, 1)
    while v < n:
        v *= 2
    return v


class BatchInputs(NamedTuple):
    """Per-eval inputs; node columns (totals) are passed beside them."""

    feasible: torch.Tensor  # bool[C] static feasibility for this (job, tg)
    base_cpu_used: torch.Tensor  # f[C] usage at snapshot
    base_mem_used: torch.Tensor  # f[C]
    base_disk_used: torch.Tensor  # f[C]
    base_collisions: torch.Tensor  # i32[C] existing same-job+tg allocs
    penalty: torch.Tensor  # bool[C]
    affinity_score: torch.Tensor  # f[C]
    perm: torch.Tensor  # i32[C] shuffled walk order
    ask_cpu: Scalar  # f scalar
    ask_mem: Scalar  # f scalar
    ask_disk: Scalar  # f scalar
    desired_count: Scalar  # i32
    limit: Scalar  # i32
    distinct_hosts: Scalar  # bool scalar


def _rotated_prefix(cs, c_off, total, in_wrap, is_tail):
    """Inclusive count of set entries at-or-before each position in
    *walk order*, from the inclusive permuted-order cumsum `cs`.  Walk
    order is the permuted order rotated left by `offset` within the
    candidate region; `in_wrap` marks positions < offset, `is_tail` the
    padding region past n_candidates (never rotated, walks last, and
    carries no set entries)."""
    pre = torch.where(in_wrap, cs + (total - c_off), cs - c_off)
    return torch.where(is_tail, total, pre)


def _walk_rows(s_p, f_p, offset, limit, n_candidates):
    """The rotating limited walk in permuted space (see ops/score.py for
    the semantics), for E independent walks at once: s_p and f_p are
    [E, n], offset and limit i32[E], n_candidates an int or 0-d int32
    tensor shared by the rows.  Each row's walk order is its permuted
    order rotated left by its offset within the candidate region; the
    tail past n_candidates walks last, in place.  Integer prefix
    arithmetic and exact comparisons only.  Returns (win_pos,
    any_emitted, pulls), each [E], win_pos indexing the permuted
    arrays.  Like the JAX program it assumes no feasible entry in the
    tail (every caller ANDs the mask with the candidate set)."""
    n = s_p.shape[1]
    dev = s_p.device
    i32 = torch.int32
    pos = torch.arange(n, dtype=i32, device=dev)[None, :]
    off = offset[:, None]
    is_tail = pos >= n_candidates
    in_wrap = pos < off
    # walk position of each permuted index (tail walks last, in place)
    wp = torch.where(
        is_tail, pos, torch.remainder(pos - off + n_candidates, n_candidates)
    )
    zero = torch.zeros((), dtype=i32, device=dev)
    off_idx = torch.clamp(off - 1, min=0).long()

    def rot(b):
        cs = torch.cumsum(b.to(i32), 1, dtype=i32)
        total = cs[:, -1:]
        c_off = torch.where(off > 0, torch.gather(cs, 1, off_idx), zero)
        return _rotated_prefix(cs, c_off, total, in_wrap, is_tail), total

    bad = f_p & (s_p <= SKIP_THRESHOLD)
    bad_rank, _ = rot(bad)
    diverted = bad & (bad_rank <= MAX_SKIP)
    nd = f_p & ~diverted
    nd_incl, nd_count = rot(nd)
    div_incl, n_div = rot(diverted)
    div_rank = div_incl - 1
    div_order = torch.where(
        (n_div == 2) & (nd_count > 0), 1 - div_rank, div_rank
    )
    emit_order = torch.where(nd, nd_incl - 1, nd_count + div_order)
    lim = limit[:, None]
    emitted = f_p & (emit_order < lim)

    neg_inf = torch.full((), -float("inf"), dtype=s_p.dtype, device=dev)
    masked = torch.where(emitted, s_p, neg_inf)
    best = masked.amax(dim=1, keepdim=True)
    candidates = emitted & (masked == best)
    big = torch.full((), INT32_MAX, dtype=i32, device=dev)
    win = torch.argmin(torch.where(candidates, emit_order, big), dim=1)
    any_emitted = emitted.any(dim=1)

    limit_reached = nd_count[:, 0] >= limit
    lth_wp = torch.where(nd & (nd_incl == lim), wp, big).amin(dim=1)
    pulls = torch.where(limit_reached, lth_wp + 1, n_candidates)
    return win, any_emitted, pulls


def _walk(s_p, f_p, offset, limit, n_candidates):
    """One walk of `_walk_rows`: s_p and f_p are [n]; offset, limit and
    n_candidates 0-d int32 tensors.  Returns 0-d (win_pos, any_emitted,
    pulls)."""
    win, any_emitted, pulls = _walk_rows(
        s_p[None], f_p[None], offset.reshape(1), limit.reshape(1),
        n_candidates,
    )
    return win[0], any_emitted[0], pulls[0]


class SpreadInputs(NamedTuple):
    """Spread state for the in-kernel carry (reference spread.go:163).
    S stanzas x (V+1) value slots per eval; slot V is the penalty slot
    (missing attribute, or a value with no target) scoring a flat -1.
    The per-pick used count is propertySet.GetCombinedUseMap:
    max(0, existing + proposed - cleared'), with `proposed` growing by
    the eval's placements and `cleared` by its applied evictions (see
    the JAX module for the long form)."""

    codes: torch.Tensor  # i32[S, C] value slot per node (V = penalty)
    desired: torch.Tensor  # f[S, V+1] desired count per slot
    used0: torch.Tensor  # f[S, V+1] existing (live) use at snapshot
    proposed0: torch.Tensor  # f[S, V+1] plan placements staged pre-pick
    cleared0: torch.Tensor  # f[S, V+1] pre-staged plan stops per slot
    weight: torch.Tensor  # f[S] weight / sum(|weights|)
    active: torch.Tensor  # bool[S] (padding rows are inert)
    even: Optional[torch.Tensor] = None  # bool[S] even-spread stanzas
    group: Optional[torch.Tensor] = None  # i32[S] owning group slot


class TGInputs(NamedTuple):
    """Per-pick task-group routing: pick k uses group slot tg_idx[k]'s
    feasibility, affinity and collision rows and its own ask, count and
    limit, while the walk offset and usage columns stay one carry."""

    tg_idx: torch.Tensor  # i32[P] group slot per pick
    feasible: torch.Tensor  # bool[T, C]
    affinity: torch.Tensor  # f[T, C]
    coll0: torch.Tensor  # i32[T, C] anti-affinity base per group
    ask_cpu: torch.Tensor  # f[P]
    ask_mem: torch.Tensor  # f[P]
    ask_disk: torch.Tensor  # f[P]
    desired_count: torch.Tensor  # i32[P]
    limit: torch.Tensor  # i32[P]


class PortInputs(NamedTuple):
    """Static host-port occupancy: a port-collided node is skipped like
    an infeasible one (rank.go network path `continue`); occupancy
    chains across evals."""

    ask: torch.Tensor  # bool[T, Q] port slots each group's ask needs
    used0: torch.Tensor  # bool[Q, C] occupied at snapshot


class DeviceInputs(NamedTuple):
    """Device-instance accounting: a pick is feasible only where every
    asked signature has enough free instances; free counts chain across
    evals."""

    ask: torch.Tensor  # i32[T, D] instances needed per signature
    free0: torch.Tensor  # i32[D, C] free instances at snapshot


class StepDeltas(NamedTuple):
    """Per-pick plan mutations (leading axis E when chained): a
    destructive update's eviction applied just before pick k, and the
    reschedule penalty rows of pick k only."""

    evict_rows: torch.Tensor  # i32[P] node row stopped before pick k (-1 none)
    evict_cpu: torch.Tensor  # f[P] signed usage delta (negative)
    evict_mem: torch.Tensor  # f[P]
    evict_disk: torch.Tensor  # f[P]
    evict_coll: torch.Tensor  # i32[P] anti-affinity collision delta
    penalty_rows: torch.Tensor  # i32[P, K] penalized node rows (-1 pad)


class PreDeltas(NamedTuple):
    """Per-eval usage deltas applied to the chained columns before the
    eval's first pick (lost/stopped allocs, in-place updates).  Rows
    are padded with row 0 / delta 0."""

    rows: torch.Tensor  # i32[R]
    cpu: torch.Tensor  # f[R] signed deltas
    mem: torch.Tensor  # f[R]
    disk: torch.Tensor  # f[R]


class ChainInputs(NamedTuple):
    """Per-eval inputs of the chained launch (leading axis E).  The
    shared node columns are not repeated per eval: the usage chains
    through the carry and the totals are passed beside."""

    feasible: torch.Tensor  # bool[E, T, C]
    perm: torch.Tensor  # i32[E, C]
    ask_cpu: torch.Tensor  # f[E, P]
    ask_mem: torch.Tensor  # f[E, P]
    ask_disk: torch.Tensor  # f[E, P]
    desired_count: torch.Tensor  # i32[E, P]
    limit: torch.Tensor  # i32[E, P]
    distinct_hosts: torch.Tensor  # bool[E]
    tg_idx: torch.Tensor  # i32[E, P]


def ordered_index_add(col: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """`col.at[idx].add(vals)` as XLA's scatter computes it: the
    updates are applied one after another in index order, so a row
    that appears twice gets (col + v0) + v1.  Returns a new tensor.
    Rounds of distinct rows keep it vectorised."""
    out = col.clone()
    idx = idx.long().reshape(-1)
    vals = vals.to(col.dtype).reshape(-1)
    if idx.numel() == 0:
        return out
    order = torch.argsort(idx, stable=True)
    sidx = idx[order]
    svals = vals[order]
    n = sidx.numel()
    pos = torch.arange(n, device=idx.device)
    start = torch.ones(n, dtype=torch.bool, device=idx.device)
    start[1:] = sidx[1:] != sidx[:-1]
    run_start = torch.cummax(torch.where(start, pos, 0), 0).values
    rank = pos - run_start
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        rows = sidx[sel]
        out[rows] = out[rows] + svals[sel]
    return out


def spread_contribution(codes_p, desired_node, penalty_node, safe_desired,
                        existing, prop, clr, weight, active, even):
    """Per-node spread boost of one pick: the twin of the JAX
    module's `spread_contribution` (GetCombinedUseMap with the
    PopulateProposed cleared-decrement quirk, percent and even modes).
    `codes_p` is [S, n] in the caller's layout; the carries are
    [S, V+1].  The S terms are added in stanza order starting from
    zero, as the compiled reduction adds them."""
    dtype = existing.dtype
    clr_adj = clr - ((prop > 0) & (clr > 1)).to(dtype)
    combined = torch.clamp_min(existing + prop - clr_adj, 0.0)
    used_node = torch.gather(combined, 1, codes_p.long())
    frac = (desired_node - (used_node + 1.0)) / safe_desired
    pct_contrib = frac * weight[:, None]
    neg_one = torch.full((), -1.0, dtype=dtype, device=existing.device)
    pct_full = torch.where(penalty_node, neg_one, pct_contrib)
    if even is not None:
        V1 = combined.shape[-1]
        value_slot = torch.arange(V1, device=existing.device) < (V1 - 1)
        present = ((existing + prop) > 0) & value_slot
        has_map = present.any(dim=-1)
        big = torch.full((), float("inf"), dtype=dtype,
                         device=existing.device)
        min_b = torch.where(present, combined, big).amin(dim=-1)[:, None]
        max_b = torch.where(present, combined, -big).amax(dim=-1)[:, None]
        safe_min = torch.where(min_b > 0, min_b, torch.ones_like(min_b))
        delta_boost = torch.where(
            min_b == 0.0, neg_one, (min_b - used_node) / safe_min
        )
        even_val = torch.where(
            used_node != min_b,
            delta_boost,
            torch.where(
                min_b == max_b,
                neg_one,
                torch.where(
                    min_b == 0.0, -neg_one, (max_b - min_b) / safe_min
                ),
            ),
        )
        even_full = torch.where(
            has_map[:, None],
            torch.where(penalty_node, neg_one, even_val),
            torch.zeros((), dtype=dtype, device=existing.device),
        )
        contrib = torch.where(even[:, None], even_full, pct_full)
    else:
        contrib = pct_full
    contrib = torch.where(
        active[:, None], contrib,
        torch.zeros((), dtype=dtype, device=existing.device),
    )
    total = torch.zeros_like(contrib[0])
    for s in range(contrib.shape[0]):
        total = total + contrib[s]
    return total


def _run_picks(cpu_total, mem_total, disk_total, used0, perm, tg: TGInputs,
               distinct_hosts, n_candidates, n_picks: int, spread_fit: bool,
               wanted=None, spread: Optional[SpreadInputs] = None,
               deltas: Optional[StepDeltas] = None, port_ask=None,
               port_used=None, dev_ask=None, dev_free=None, dev_aff=None,
               dev_aff_on=None, occ_extra=None, dh_tg=None, penalty=None):
    """Plain twin of the JAX `_run_picks`: P picks of one eval with
    per-pick group routing, spread, step deltas, static ports, device
    instances, device affinity, distinct_hosts at job (`distinct_hosts`
    plus `occ_extra`) and group (`dh_tg`) level, and the static penalty
    column (bool[C] node space, or None for none), which the pick's
    penalty rows add to.  `used0` holds the node-space usage columns at
    the eval's start.

    Returns (rows i32[P], pulls i32[P], (cpu, mem, disk) node-space
    usage after the eval, ports bool[Q, C] or None, devs i32[D, C] or
    None)."""
    dtype = cpu_total.dtype
    dev = cpu_total.device
    i32 = torch.int32
    C = cpu_total.shape[0]
    permi = perm.long()
    n_cand = _scalar(n_candidates, i32, dev)
    wanted = n_picks if wanted is None else _host_int(wanted)
    distinct_hosts = bool(_host_int(distinct_hosts))
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    zero_i = torch.zeros((), dtype=i32, device=dev)
    no_node = torch.full((), NO_NODE, dtype=i32, device=dev)
    tg_idx = [int(t) for t in tg.tg_idx.tolist()]
    T = tg.feasible.shape[0]

    cpu_total_p = cpu_total[permi]
    mem_total_p = mem_total[permi]
    disk_total_p = disk_total[permi]
    feas_tp = tg.feasible[:, permi]
    aff_tp = tg.affinity[:, permi]
    ports_on = port_ask is not None
    devs_on = dev_ask is not None
    dev_aff_p = dev_aff[:, permi] if dev_aff is not None else None
    occ_extra_p = occ_extra[permi] if occ_extra is not None else None
    penalty_p = (penalty[permi] if penalty is not None
                 else torch.zeros(C, dtype=torch.bool, device=dev))
    safe_cpu = torch.where(cpu_total_p > 0, cpu_total_p, one)
    safe_mem = torch.where(mem_total_p > 0, mem_total_p, one)
    if spread is not None:
        V1 = spread.desired.shape[1]
        codes_sp = spread.codes[:, permi]
        desired_node = torch.gather(spread.desired.to(dtype), 1,
                                    codes_sp.long())
        penalty_node = codes_sp == (V1 - 1)
        safe_desired = torch.where(desired_node != 0, desired_node, one)
        spread_existing = spread.used0.to(dtype)
        spread_prop = spread.proposed0.to(dtype)
        spread_clr = spread.cleared0.to(dtype)

    cpu_used = used0[0][permi]
    mem_used = used0[1][permi]
    disk_used = used0[2][permi]
    collisions = tg.coll0[:, permi].clone()
    ports_c = port_used[:, permi] if ports_on else None
    devs_c = dev_free[:, permi] if devs_on else None
    offset = torch.zeros((), dtype=i32, device=dev)
    dead = [False] * T
    rows, pulls_out, eapps = [], [], []
    for k in range(n_picks):
        t = tg_idx[k]
        active = (k < wanted) and not dead[t]
        penalty_vec = penalty_p
        app = False
        if deltas is not None:
            erow = int(deltas.evict_rows[k])
            app = active and erow >= 0
            if app:
                # argmax(perm == erow): the evicted row's position
                epos = int(torch.nonzero(perm == erow)[0, 0])
                cpu_used[epos] = cpu_used[epos] + deltas.evict_cpu[k].to(dtype)
                mem_used[epos] = mem_used[epos] + deltas.evict_mem[k].to(dtype)
                disk_used[epos] = (
                    disk_used[epos] + deltas.evict_disk[k].to(dtype)
                )
                collisions[t, epos] = collisions[t, epos] + deltas.evict_coll[k]
            prow = deltas.penalty_rows[k]
            penalty_vec = penalty_p | (perm[:, None] == prow[None, :]).any(dim=1)
            if spread is not None and app:
                # the evicted alloc's value slot gains one cleared use,
                # in the picking group's slots only
                slot = spread.codes[:, erow].long()
                hit = torch.nn.functional.one_hot(slot, V1).to(dtype)
                if spread.group is not None:
                    hit = hit * (spread.group == t).to(dtype)[:, None]
                spread_clr = spread_clr + hit
        ask_cpu_k = tg.ask_cpu[k].to(dtype)
        ask_mem_k = tg.ask_mem[k].to(dtype)
        ask_disk_k = tg.ask_disk[k].to(dtype)
        coll_t = collisions[t]
        cpu_after = cpu_used + ask_cpu_k
        mem_after = mem_used + ask_mem_k
        disk_after = disk_used + ask_disk_k
        fit = (
            (cpu_after <= cpu_total_p)
            & (mem_after <= mem_total_p)
            & (disk_after <= disk_total_p)
        )
        occupancy = collisions.sum(dim=0, dtype=i32)
        if occ_extra_p is not None:
            occupancy = occupancy + occ_extra_p
        feasible = feas_tp[t] & fit
        if distinct_hosts:
            feasible = feasible & ~(occupancy > 0)
        if dh_tg is not None and bool(dh_tg[t]):
            feasible = feasible & ~(coll_t > 0)
        if ports_on:
            collide = (ports_c & port_ask[t][:, None]).any(dim=0)
            feasible = feasible & ~collide
        if devs_on:
            ask_t_dev = dev_ask[t]
            feasible = feasible & (
                (ask_t_dev[:, None] == 0) | (devs_c >= ask_t_dev[:, None])
            ).all(dim=0)

        free_cpu = 1.0 - cpu_after / safe_cpu
        free_mem = 1.0 - mem_after / safe_mem
        base = _pow10(free_cpu, dtype) + _pow10(free_mem, dtype)
        if spread_fit:
            fitness = torch.clamp(base - 2.0, 0.0, 18.0)
        else:
            fitness = torch.clamp(20.0 - base, 0.0, 18.0)
        count = torch.ones_like(fitness)
        has_coll = coll_t > 0
        desired = tg.desired_count[k].to(dtype)
        anti = torch.where(has_coll, -(coll_t.to(dtype) + 1.0) / desired, zero)
        # binpack plus anti-affinity, fused as XLA fuses it (score.py)
        score_sum = fma(fitness, INV_18, anti)
        count = count + has_coll.to(dtype)
        score_sum = score_sum - penalty_vec.to(dtype)
        count = count + penalty_vec.to(dtype)
        aff_k = aff_tp[t]
        has_aff = aff_k != 0.0
        score_sum = score_sum + torch.where(has_aff, aff_k, zero)
        count = count + has_aff.to(dtype)
        if dev_aff_p is not None:
            d_on = bool(dev_aff_on[t])
            score_sum = score_sum + (dev_aff_p[t] if d_on else zero)
            count = count + (one if d_on else zero)
        if spread is not None:
            slot_active = spread.active
            if spread.group is not None:
                slot_active = slot_active & (spread.group == t)
            spread_total = spread_contribution(
                codes_sp, desired_node, penalty_node, safe_desired,
                spread_existing, spread_prop, spread_clr,
                spread.weight.to(dtype), slot_active, spread.even,
            )
            score_sum = score_sum + spread_total
            count = count + (spread_total != 0.0).to(dtype)
        final = score_sum / count

        limit = _scalar(tg.limit[k], i32, dev)
        win, any_emitted, step_pulls = _walk(
            final, feasible, offset, limit, n_cand
        )
        ok = active and bool(any_emitted)
        if active and not ok:
            dead[t] = True
        eapps.append(app)
        if ok:
            w = int(win)
            rows.append(perm[w].to(i32))
            cpu_used[w] = cpu_used[w] + ask_cpu_k
            mem_used[w] = mem_used[w] + ask_mem_k
            disk_used[w] = disk_used[w] + ask_disk_k
            collisions[t, w] = collisions[t, w] + 1
            if ports_on:
                ports_c[:, w] = ports_c[:, w] | port_ask[t]
            if devs_on:
                devs_c[:, w] = devs_c[:, w] - dev_ask[t]
            if spread is not None:
                hit = torch.nn.functional.one_hot(
                    codes_sp[:, w].long(), V1
                ).to(dtype)
                if spread.group is not None:
                    hit = hit * (spread.group == t).to(dtype)[:, None]
                spread_prop = spread_prop + hit
        else:
            rows.append(no_node)
        pulls = step_pulls.to(i32) if active else zero_i
        pulls_out.append(pulls)
        offset = torch.remainder(offset + pulls, n_cand)
    rows = torch.stack(rows).to(i32)
    pulls = torch.stack(pulls_out).to(i32)

    # the node-space carry, rebuilt as the JAX program rebuilds it:
    # every pick's ask in pick order (0 at row 0 for a failed pick),
    # then every applied eviction in pick order
    ok_rows = rows != NO_NODE
    safe_rows = torch.where(ok_rows, rows, zero_i)
    used = []
    for col, ask in zip(used0, (tg.ask_cpu, tg.ask_mem, tg.ask_disk)):
        used.append(ordered_index_add(
            col, safe_rows, torch.where(ok_rows, ask.to(dtype), zero)
        ))
    if deltas is not None:
        eapp = torch.tensor(eapps, dtype=torch.bool, device=dev)
        safe_er = torch.where(eapp, deltas.evict_rows.to(i32), zero_i)
        for i, dvals in enumerate(
            (deltas.evict_cpu, deltas.evict_mem, deltas.evict_disk)
        ):
            used[i] = ordered_index_add(
                used[i], safe_er, torch.where(eapp, dvals.to(dtype), zero)
            )
    ports_out = devs_out = None
    tg_rows = tg.tg_idx.long()
    if ports_on:
        ports_out = port_used.clone()
        for k in torch.nonzero(ok_rows).flatten().tolist():
            r = int(rows[k])
            ports_out[:, r] = ports_out[:, r] | port_ask[tg_rows[k]]
    if devs_on:
        devs_out = dev_free.clone()
        for k in torch.nonzero(ok_rows).flatten().tolist():
            r = int(rows[k])
            devs_out[:, r] = devs_out[:, r] - dev_ask[tg_rows[k]]
    return rows, pulls, tuple(used), ports_out, devs_out


def run_picks(cpu_total, mem_total, disk_total, inp: BatchInputs,
              n_candidates, n_picks: int, spread_fit: bool):
    """Plain twin of `_run_picks` as `plan_picks_full` calls it: one
    group (T=1), the static penalty column, no spread, deltas, ports or
    devices.  Returns (rows i32[P], pulls i32[P])."""
    dtype = cpu_total.dtype
    dev = cpu_total.device
    i32 = torch.int32
    tg = TGInputs(
        tg_idx=torch.zeros(n_picks, dtype=i32, device=dev),
        feasible=inp.feasible[None],
        affinity=inp.affinity_score[None],
        coll0=inp.base_collisions[None],
        ask_cpu=_scalar(inp.ask_cpu, dtype, dev).expand(n_picks),
        ask_mem=_scalar(inp.ask_mem, dtype, dev).expand(n_picks),
        ask_disk=_scalar(inp.ask_disk, dtype, dev).expand(n_picks),
        desired_count=_scalar(inp.desired_count, i32, dev).expand(n_picks),
        limit=_scalar(inp.limit, i32, dev).expand(n_picks),
    )
    rows, pulls, _used, _p, _d = _run_picks(
        cpu_total, mem_total, disk_total,
        (inp.base_cpu_used, inp.base_mem_used, inp.base_disk_used),
        inp.perm, tg, inp.distinct_hosts, n_candidates, n_picks,
        spread_fit, penalty=inp.penalty,
    )
    return rows, pulls


def _check_batch(cpu_total, mem_total, disk_total, inp: BatchInputs):
    dev = cpu_total.device
    dtype = cpu_total.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"columns must be f32 or f64, got {dtype}")
    C = cpu_total.shape[0] if cpu_total.dim() == 1 else -1
    named = {
        "cpu_total": cpu_total, "mem_total": mem_total,
        "disk_total": disk_total,
    }
    for name in ("feasible", "base_cpu_used", "base_mem_used",
                 "base_disk_used", "base_collisions", "penalty",
                 "affinity_score", "perm"):
        named[name] = getattr(inp, name)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cpu_total on {dev}")
        if t.dim() != 1 or t.shape[0] != C:
            raise ValueError(f"{name} must have shape [{C}], got {tuple(t.shape)}")
    for name in ("cpu_total", "mem_total", "disk_total", "base_cpu_used",
                 "base_mem_used", "base_disk_used", "affinity_score"):
        if named[name].dtype != dtype:
            raise TypeError(f"{name} must be {dtype}")
    for name in ("feasible", "penalty"):
        if named[name].dtype != torch.bool:
            raise TypeError(f"{name} must be bool")
    for name in ("base_collisions", "perm"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    return dev, named


def plan_picks_cuda(cpu_total, mem_total, disk_total, inp: BatchInputs,
                    n_candidates, n_picks: int, spread_fit: bool = False):
    """Launch K2 on the tensors' CUDA device (current stream).  Returns
    the i32[2, P] [rows; pulls] tensor on the device; nothing is
    synchronised."""
    from . import _cuda

    dev, named = _check_batch(cpu_total, mem_total, disk_total, inp)
    if dev.type != "cuda":
        raise ValueError(f"plan_picks_cuda needs CUDA tensors, got {dev}")
    C = cpu_total.shape[0]
    n_cand = _host_int(n_candidates)
    limit = _host_int(inp.limit)
    if not 1 <= n_cand <= C:
        raise ValueError(f"n_candidates {n_cand} outside [1, {C}]")
    if limit < 1:
        raise ValueError(f"limit must be >= 1, got {limit}")
    if n_picks < 1:
        raise ValueError(f"n_picks must be >= 1, got {n_picks}")
    cols = {n: t.contiguous() for n, t in named.items()}
    out = torch.empty((2, n_picks), dtype=torch.int32, device=dev)
    # the score cache: written only where a pick scores
    scores = torch.empty(n_cand, dtype=cpu_total.dtype, device=dev)
    _cuda.launch_plan_picks(
        cols,
        _cuda.pick_carry("plan_picks", 1, n_cand, n_picks, cpu_total.dtype,
                         dev),
        scores, out,
        ask=(
            _host_float(inp.ask_cpu),
            _host_float(inp.ask_mem),
            _host_float(inp.ask_disk),
        ),
        desired=_host_int(inp.desired_count),
        limit=limit,
        n_candidates=n_cand,
        n_picks=n_picks,
        distinct_hosts=bool(
            inp.distinct_hosts.item()
            if isinstance(inp.distinct_hosts, torch.Tensor)
            else inp.distinct_hosts
        ),
        spread_fit=spread_fit,
    )
    plan_picks_cuda.launches += 1
    return out


plan_picks_cuda.launches = 0


def plan_picks_full(cpu_total, mem_total, disk_total, inp: BatchInputs,
                    n_candidates, n_picks: int, spread_fit: bool = False):
    """P sequential placements of one group, returned stacked as ONE
    i32[2, P] tensor ([rows; pulls], NO_NODE where placement failed) so
    the host pays a single device->host copy.  Starting rotation is
    folded into `inp.perm` by the caller.  K2 for CUDA tensors, the
    twin for CPU tensors."""
    dev, _named = _check_batch(cpu_total, mem_total, disk_total, inp)
    if dev.type == "cpu":
        rows, pulls = run_picks(
            cpu_total, mem_total, disk_total, inp, n_candidates,
            n_picks, spread_fit,
        )
        return torch.stack([rows, pulls])
    return plan_picks_cuda(
        cpu_total, mem_total, disk_total, inp, n_candidates, n_picks,
        spread_fit,
    )


# ---------------------------------------------------------------------------
# E independent evals over one shared snapshot (K7)
# ---------------------------------------------------------------------------


def plan_picks(cpu_total, mem_total, disk_total, inp: BatchInputs,
               n_candidates, n_picks: int, spread_fit: bool = False):
    """P sequential placements of one eval, rows only (i32[P], NO_NODE
    where placement failed): the twin of the JAX `plan_picks`, which is
    `run_picks` with every pick wanted."""
    return run_picks(cpu_total, mem_total, disk_total, inp, n_candidates,
                     n_picks, spread_fit)[0]


# the tensor arguments of batch_plan_picks_shared, in order: node
# columns [C], feasible [C], perms [E, C], per-eval values [E]
_SHARED_COLUMNS = ("cpu_total", "mem_total", "disk_total", "base_cpu_used",
                   "base_mem_used", "base_disk_used")
_SHARED_PER_EVAL = ("ask_cpu", "ask_mem", "ask_disk", "desired_count",
                    "limit")
_SHARED_ARGS = _SHARED_COLUMNS + ("feasible", "perms") + _SHARED_PER_EVAL


def _check_shared(named, n_candidates, n_picks: int):
    """Device, type and shape checks of a shared-snapshot batch, its
    tensors keyed by `_SHARED_ARGS`; returns (device, E, C, n_cand)."""
    dev = named["cpu_total"].device
    dtype = named["cpu_total"].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"columns must be f32 or f64, got {dtype}")
    C = named["cpu_total"].shape[0]
    perms = named["perms"]
    E = perms.shape[0] if perms.dim() == 2 else -1
    want = {name: (C,) for name in _SHARED_COLUMNS}
    want.update(feasible=(C,), perms=(E, C))
    want.update({name: (E,) for name in _SHARED_PER_EVAL})
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cpu_total on {dev}")
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} must have shape {want[name]}, got {tuple(t.shape)}"
            )
    for name in (*_SHARED_COLUMNS, "ask_cpu", "ask_mem", "ask_disk"):
        if named[name].dtype != dtype:
            raise TypeError(f"{name} must be {dtype}")
    if named["feasible"].dtype != torch.bool:
        raise TypeError("feasible must be bool")
    for name in ("perms", "desired_count", "limit"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    n_cand = _host_int(n_candidates)
    if not 1 <= n_cand <= C:
        raise ValueError(f"n_candidates {n_cand} outside [1, {C}]")
    if n_picks < 1:
        raise ValueError(f"n_picks must be >= 1, got {n_picks}")
    return dev, E, C, n_cand


def batch_plan_picks_shared_twin(cpu_total, mem_total, disk_total, feasible,
                                 base_cpu_used, base_mem_used,
                                 base_disk_used, perms, ask_cpu, ask_mem,
                                 ask_disk, desired_count, limit,
                                 n_candidates, n_picks: int,
                                 spread_fit: bool = False):
    """Plain twin of the JAX `batch_plan_picks_shared`: E independent
    `plan_picks` over the shared columns, eval k with its own walk order
    perms[k], asks, count and limit; no collisions, penalty or affinity,
    distinct_hosts off.  Every eval runs all P picks (an eval whose
    count is below P included).  Returns i32[E, P].

    The evals run side by side as the rows of [E, n_cand] tensors: each
    pick is `run_picks`' step on every eval at once, over the candidate
    region only (the walk's tail is never feasible and never rotates).
    The zero penalty and affinity terms are left out:
    they add +-0, which changes at most the sign of a zero score, and
    no comparison sees that sign."""
    dev, E, _C, n = _check_shared(
        dict(zip(_SHARED_ARGS, (cpu_total, mem_total, disk_total,
                                base_cpu_used, base_mem_used, base_disk_used,
                                feasible, perms, ask_cpu, ask_mem, ask_disk,
                                desired_count, limit))),
        n_candidates, n_picks,
    )
    dtype = cpu_total.dtype
    i32 = torch.int32
    rows = torch.full((E, n_picks), NO_NODE, dtype=i32, device=dev)
    if E == 0:
        return rows
    perm = perms[:, :n].long()
    cpu_total_p = cpu_total[perm]
    mem_total_p = mem_total[perm]
    disk_total_p = disk_total[perm]
    feas_p = feasible[perm]
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    safe_cpu = torch.where(cpu_total_p > 0, cpu_total_p, one)
    safe_mem = torch.where(mem_total_p > 0, mem_total_p, one)
    cpu_used = base_cpu_used[perm]
    mem_used = base_mem_used[perm]
    disk_used = base_disk_used[perm]
    coll = torch.zeros((E, n), dtype=i32, device=dev)
    asks = [a[:, None] for a in (ask_cpu, ask_mem, ask_disk)]
    desired = desired_count.to(dtype)[:, None]
    offset = torch.zeros(E, dtype=i32, device=dev)
    dead = torch.zeros(E, dtype=torch.bool, device=dev)
    for k in range(n_picks):
        cpu_after = cpu_used + asks[0]
        mem_after = mem_used + asks[1]
        disk_after = disk_used + asks[2]
        fit = (
            (cpu_after <= cpu_total_p)
            & (mem_after <= mem_total_p)
            & (disk_after <= disk_total_p)
        )
        feas = feas_p & fit
        free_cpu = 1.0 - cpu_after / safe_cpu
        free_mem = 1.0 - mem_after / safe_mem
        base = _pow10(free_cpu, dtype) + _pow10(free_mem, dtype)
        if spread_fit:
            fitness = torch.clamp(base - 2.0, 0.0, 18.0)
        else:
            fitness = torch.clamp(20.0 - base, 0.0, 18.0)
        has_coll = coll > 0
        anti = torch.where(has_coll, -(coll.to(dtype) + 1.0) / desired, zero)
        # binpack plus anti-affinity, fused as XLA fuses it (score.py)
        final = fma(fitness, INV_18, anti) / (1.0 + has_coll.to(dtype))
        win, any_emitted, step_pulls = _walk_rows(final, feas, offset,
                                                  limit, n)
        active = ~dead
        ok = active & any_emitted
        dead = dead | (active & ~any_emitted)
        e_ok = torch.nonzero(ok).flatten()
        w = win[e_ok]
        rows[e_ok, k] = perm[e_ok, w].to(i32)
        cpu_used[e_ok, w] = cpu_used[e_ok, w] + ask_cpu[e_ok]
        mem_used[e_ok, w] = mem_used[e_ok, w] + ask_mem[e_ok]
        disk_used[e_ok, w] = disk_used[e_ok, w] + ask_disk[e_ok]
        coll[e_ok, w] = coll[e_ok, w] + 1
        offset = torch.remainder(
            offset + torch.where(active, step_pulls.to(i32), 0), n
        )
        if bool(dead.all()):
            break  # every later pick is inert: rows stay NO_NODE
    return rows


def batch_plan_picks_shared_cuda(cpu_total, mem_total, disk_total, feasible,
                                 base_cpu_used, base_mem_used,
                                 base_disk_used, perms, ask_cpu, ask_mem,
                                 ask_disk, desired_count, limit,
                                 n_candidates, n_picks: int,
                                 spread_fit: bool = False):
    """Launch K7 on the tensors' CUDA device (current stream): one block
    per eval.  Returns the i32[E, P] rows on the device; nothing is
    synchronised."""
    from . import _cuda

    named = dict(zip(_SHARED_ARGS, (cpu_total, mem_total, disk_total,
                                    base_cpu_used, base_mem_used,
                                    base_disk_used, feasible, perms, ask_cpu,
                                    ask_mem, ask_disk, desired_count, limit)))
    dev, E, _C, n_cand = _check_shared(named, n_candidates, n_picks)
    if dev.type != "cuda":
        raise ValueError(
            f"batch_plan_picks_shared_cuda needs CUDA tensors, got {dev}"
        )
    if E < 1:
        raise ValueError("batch_plan_picks_shared_cuda needs E >= 1")
    if int(limit.min()) < 1:
        raise ValueError("limit must be >= 1")
    named = {n: t.contiguous() for n, t in named.items()}
    out = torch.empty((E, n_picks), dtype=torch.int32, device=dev)
    # the evals' score caches: written only where a pick scores
    scores = torch.empty((E, n_cand), dtype=cpu_total.dtype, device=dev)
    _cuda.launch_batch_picks(
        named,
        _cuda.pick_carry("batch_picks", E, n_cand, n_picks, cpu_total.dtype,
                         dev),
        scores, out,
        n_candidates=n_cand, n_picks=n_picks, spread_fit=spread_fit,
    )
    batch_plan_picks_shared_cuda.launches += 1
    return out


batch_plan_picks_shared_cuda.launches = 0


def batch_plan_picks_shared(cpu_total, mem_total, disk_total, feasible,
                            base_cpu_used, base_mem_used, base_disk_used,
                            perms, ask_cpu, ask_mem, ask_disk, desired_count,
                            limit, n_candidates, n_picks: int,
                            spread_fit: bool = False):
    """Batched planner for evals that all score against one snapshot
    (fresh jobs, no penalties or affinities): the node columns are
    shared, only the E x C walk orders and the per-eval scalars vary.
    Returns i32[E, P] rows (NO_NODE where a pick failed).  K7 for CUDA
    tensors, the twin for CPU tensors; no evals, no launch."""
    args = (cpu_total, mem_total, disk_total, feasible, base_cpu_used,
            base_mem_used, base_disk_used, perms, ask_cpu, ask_mem,
            ask_disk, desired_count, limit, n_candidates, n_picks,
            spread_fit)
    if cpu_total.device.type == "cpu":
        return batch_plan_picks_shared_twin(*args)
    if perms.shape[0] == 0:
        return torch.empty((0, n_picks), dtype=torch.int32,
                           device=cpu_total.device)
    return batch_plan_picks_shared_cuda(*args)


# ---------------------------------------------------------------------------
# the chained planner (K3) and the mirror patch (K4)
# ---------------------------------------------------------------------------

_FLOAT, _INT, _BOOL = "f", "i", "b"
_CHAIN_KINDS = {
    "feasible": _BOOL, "perm": _INT, "ask_cpu": _FLOAT, "ask_mem": _FLOAT,
    "ask_disk": _FLOAT, "desired_count": _INT, "limit": _INT,
    "distinct_hosts": _BOOL, "tg_idx": _INT,
}
_SPREAD_KINDS = {
    "codes": _INT, "desired": _FLOAT, "used0": _FLOAT, "proposed0": _FLOAT,
    "cleared0": _FLOAT, "weight": _FLOAT, "active": _BOOL, "even": _BOOL,
    "group": _INT,
}
_DELTA_KINDS = {
    "evict_rows": _INT, "evict_cpu": _FLOAT, "evict_mem": _FLOAT,
    "evict_disk": _FLOAT, "evict_coll": _INT, "penalty_rows": _INT,
}
_PRE_KINDS = {"rows": _INT, "cpu": _FLOAT, "mem": _FLOAT, "disk": _FLOAT}
_OPTIONAL_KINDS = {
    "coll0": _INT, "affinity": _FLOAT, "port_ask": _BOOL,
    "port_used0": _BOOL, "dev_ask": _INT, "dev_free0": _INT,
    "dev_aff": _FLOAT, "dev_aff_on": _BOOL, "occ0": _INT, "dh_tg": _BOOL,
    "penalty": _BOOL,
}


def _as_tensor(x, kind: str, dtype, dev) -> torch.Tensor:
    """numpy array, number or tensor -> contiguous tensor of the kind's
    type on `dev`.  Host data bound for the card goes through pinned
    memory from PyTorch's caching host allocator, which hands a block
    out again only after the copy that reads it has completed."""
    want = {_FLOAT: dtype, _INT: torch.int32, _BOOL: torch.bool}[kind]
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=want).contiguous()
    t = torch.from_numpy(np.ascontiguousarray(x)).to(want)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _tuple_as(x, cls, kinds, dtype, dev):
    if x is None:
        return None
    return cls(*[
        None if getattr(x, f) is None
        else _as_tensor(getattr(x, f), kinds[f], dtype, dev)
        for f in cls._fields
    ])


def prepare_chain(cpu_total, mem_total, disk_total, used0_cpu, used0_mem,
                  used0_disk, batch, n_candidates, n_picks: int,
                  spread_fit: bool = False, wanted=None, spread=None,
                  deltas=None, pre=None, **optional) -> dict:
    """Every input of `chained_plan_picks_cols` as a tensor on
    cpu_total's device and checked for shape: the one layout both the
    twin and K3 read."""
    dev = cpu_total.device
    dtype = cpu_total.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"columns must be f32 or f64, got {dtype}")
    C = cpu_total.shape[0]
    b = _tuple_as(batch, ChainInputs, _CHAIN_KINDS, dtype, dev)
    E, T, _c = b.feasible.shape
    P = int(n_picks)
    if isinstance(n_candidates, torch.Tensor):
        n_candidates = n_candidates.cpu().numpy()
    nc_host = np.array(
        np.broadcast_to(np.asarray(n_candidates, np.int32), (E,))
    )
    if E and (nc_host.min() < 1 or nc_host.max() > C):
        raise ValueError(f"n_candidates outside [1, {C}]")
    limit = batch.limit
    if E and int(limit.min()) < 1:
        raise ValueError("limit must be >= 1")
    nc = _as_tensor(nc_host, _INT, dtype, dev)
    if wanted is None:
        wanted = np.full(E, P, np.int32)
    p = dict(
        cols=tuple(
            _as_tensor(c, _FLOAT, dtype, dev)
            for c in (cpu_total, mem_total, disk_total,
                      used0_cpu, used0_mem, used0_disk)
        ),
        batch=b, n_cand=nc, wanted=_as_tensor(wanted, _INT, dtype, dev),
        spread=_tuple_as(spread, SpreadInputs, _SPREAD_KINDS, dtype, dev),
        deltas=_tuple_as(deltas, StepDeltas, _DELTA_KINDS, dtype, dev),
        pre=_tuple_as(pre, PreDeltas, _PRE_KINDS, dtype, dev),
        E=E, T=T, P=P, C=C, spread_fit=bool(spread_fit),
    )
    for name, kind in _OPTIONAL_KINDS.items():
        x = optional.pop(name, None)
        p[name] = None if x is None else _as_tensor(x, kind, dtype, dev)
    if optional:
        raise TypeError(f"unknown inputs {sorted(optional)}")
    if (p["port_ask"] is None) != (p["port_used0"] is None):
        raise ValueError("port_ask and port_used0 go together")
    if (p["dev_ask"] is None) != (p["dev_free0"] is None):
        raise ValueError("dev_ask and dev_free0 go together")
    if (p["dev_aff"] is None) != (p["dev_aff_on"] is None):
        raise ValueError("dev_aff and dev_aff_on go together")
    shapes = {
        "perm": (b.perm, (E, C)), "tg_idx": (b.tg_idx, (E, P)),
        "ask_cpu": (b.ask_cpu, (E, P)), "limit": (b.limit, (E, P)),
        "distinct_hosts": (b.distinct_hosts, (E,)),
        "coll0": (p["coll0"], (E, T, C)), "affinity": (p["affinity"], (E, T, C)),
        "dev_aff": (p["dev_aff"], (E, T, C)), "occ0": (p["occ0"], (E, C)),
        "penalty": (p["penalty"], (E, C)),
        "dh_tg": (p["dh_tg"], (E, T)), "dev_aff_on": (p["dev_aff_on"], (E, T)),
    }
    for c in p["cols"]:
        shapes.setdefault("columns", (c, (C,)))
        if tuple(c.shape) != (C,):
            raise ValueError(f"node columns must have shape [{C}]")
    if p["deltas"] is not None:
        shapes["evict_rows"] = (p["deltas"].evict_rows, (E, P))
    for name, (t, shape) in shapes.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must have shape {shape}, got {tuple(t.shape)}"
            )
    return p


def _eval_slice(x, e: int):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[e]
    return type(x)(*[None if f is None else f[e] for f in x])


def chained_picks_twin(p: dict):
    """Plain twin of `chained_plan_picks_cols` over prepared inputs:
    the eval loop of the JAX scan, each eval's pre-deltas applied to
    the node-space carry before its picks.  Returns (rows i32[E, P],
    pulls i32[E, P], ((cpu, mem, disk), ports, devs))."""
    cols = p["cols"]
    b = p["batch"]
    E, T, C, P = p["E"], p["T"], p["C"], p["P"]
    dev = cols[0].device
    dtype = cols[0].dtype
    zeros_ti = torch.zeros((T, C), dtype=torch.int32, device=dev)
    zeros_tf = torch.zeros((T, C), dtype=dtype, device=dev)
    used = cols[3:6]
    ports, devs = p["port_used0"], p["dev_free0"]
    rows_out, pulls_out = [], []
    for e in range(E):
        pre = _eval_slice(p["pre"], e)
        if pre is not None:
            used = tuple(
                ordered_index_add(u, pre.rows, d)
                for u, d in zip(used, (pre.cpu, pre.mem, pre.disk))
            )
        tg = TGInputs(
            tg_idx=b.tg_idx[e], feasible=b.feasible[e],
            affinity=(p["affinity"][e] if p["affinity"] is not None
                      else zeros_tf),
            coll0=p["coll0"][e] if p["coll0"] is not None else zeros_ti,
            ask_cpu=b.ask_cpu[e], ask_mem=b.ask_mem[e],
            ask_disk=b.ask_disk[e], desired_count=b.desired_count[e],
            limit=b.limit[e],
        )
        rows, pulls, used, ports_n, devs_n = _run_picks(
            cols[0], cols[1], cols[2], used, b.perm[e], tg,
            b.distinct_hosts[e], p["n_cand"][e], P, p["spread_fit"],
            wanted=p["wanted"][e], spread=_eval_slice(p["spread"], e),
            deltas=_eval_slice(p["deltas"], e),
            port_ask=_eval_slice(p["port_ask"], e), port_used=ports,
            dev_ask=_eval_slice(p["dev_ask"], e), dev_free=devs,
            dev_aff=_eval_slice(p["dev_aff"], e),
            dev_aff_on=_eval_slice(p["dev_aff_on"], e),
            occ_extra=_eval_slice(p["occ0"], e),
            dh_tg=_eval_slice(p["dh_tg"], e),
            penalty=_eval_slice(p["penalty"], e),
        )
        if ports is not None:
            ports = ports_n
        if devs is not None:
            devs = devs_n
        rows_out.append(rows)
        pulls_out.append(pulls)
    return (torch.stack(rows_out), torch.stack(pulls_out),
            (used, ports, devs))


def chained_picks_cuda(p: dict, _max_blocks: int = 0):
    """Launch K3 on the current stream over prepared CUDA inputs: one
    cooperative launch over the card.  Returns the same triple as the
    twin; the carry-out lives in fresh tensors.  Nothing is
    synchronised.  `_max_blocks` caps the grid (the card tests set it;
    0: as many blocks as the card holds at once); `blocks` is the last
    launch's grid.  A failed build or launch, a grid the card cannot
    hold included, raises `DeviceFault`."""
    from . import _cuda

    dev = p["cols"][0].device
    if dev.type != "cuda":
        raise ValueError(f"chained_picks_cuda needs CUDA tensors, got {dev}")
    if p["penalty"] is not None:
        raise ValueError("K3 takes no static penalty column (K9 does)")
    E, P, C = p["E"], p["P"], p["C"]
    dtype = p["cols"][0].dtype
    used_out = tuple(torch.empty_like(c) for c in p["cols"][3:6])
    ports_out = (torch.empty_like(p["port_used0"])
                 if p["port_used0"] is not None else None)
    devs_out = (torch.empty_like(p["dev_free0"])
                if p["dev_free0"] is not None else None)
    rows = torch.empty((E, P), dtype=torch.int32, device=dev)
    pulls = torch.empty((E, P), dtype=torch.int32, device=dev)
    scratch = _cuda.chained_scratch(p, dtype, dev)
    try:
        chained_picks_cuda.blocks = _cuda.launch_chained_picks(
            p, used_out, ports_out, devs_out, rows, pulls, scratch,
            _max_blocks)
    except RuntimeError as exc:  # a build, bind or launch failure
        from ..device.core import DeviceFault

        raise DeviceFault(f"K3 chained_picks failed: {exc}") from exc
    chained_picks_cuda.launches += 1
    return rows, pulls, (used_out, ports_out, devs_out)


chained_picks_cuda.launches = 0
chained_picks_cuda.blocks = 0


def chained_plan_picks_cols(cpu_total, mem_total, disk_total, used0_cpu,
                            used0_mem, used0_disk, batch: ChainInputs,
                            n_candidates, n_picks: int,
                            spread_fit: bool = False, wanted=None,
                            coll0=None, affinity=None, spread=None,
                            deltas=None, pre=None, port_ask=None,
                            port_used0=None, dev_ask=None, dev_free0=None,
                            dev_aff=None, dev_aff_on=None, occ0=None,
                            dh_tg=None, return_carry: bool = False):
    """E evals x P picks, serially equivalent: eval k scores against
    the usage, port and device state left by evals 0..k-1, as the JAX
    program of the same name.  Inputs may be numpy arrays or tensors;
    they are moved to cpu_total's device.  K3 for a CUDA cpu_total, the
    twin for a CPU one.  Returns (rows i32[E, P], pulls i32[E, P]) and,
    with return_carry, the carry ((cpu, mem, disk), ports or None,
    devs or None): a chain cut at an eval boundary whose carry-out
    feeds the next launch equals the single launch."""
    p = prepare_chain(
        cpu_total, mem_total, disk_total, used0_cpu, used0_mem, used0_disk,
        batch, n_candidates, n_picks, spread_fit=spread_fit, wanted=wanted,
        spread=spread, deltas=deltas, pre=pre, coll0=coll0,
        affinity=affinity, port_ask=port_ask, port_used0=port_used0,
        dev_ask=dev_ask, dev_free0=dev_free0, dev_aff=dev_aff,
        dev_aff_on=dev_aff_on, occ0=occ0, dh_tg=dh_tg,
    )
    if p["cols"][0].device.type == "cpu":
        rows, pulls, carry = chained_picks_twin(p)
    else:
        rows, pulls, carry = chained_picks_cuda(p)
    if return_carry:
        return rows, pulls, carry
    return rows, pulls


# ---------------------------------------------------------------------------
# per-eval BatchInputs: the chained planner (K9) and the independent one
# (K10)
# ---------------------------------------------------------------------------

_BATCHED_KINDS = {
    "feasible": _BOOL, "base_cpu_used": _FLOAT, "base_mem_used": _FLOAT,
    "base_disk_used": _FLOAT, "base_collisions": _INT, "penalty": _BOOL,
    "affinity_score": _FLOAT, "perm": _INT, "ask_cpu": _FLOAT,
    "ask_mem": _FLOAT, "ask_disk": _FLOAT, "desired_count": _INT,
    "limit": _INT, "distinct_hosts": _BOOL,
}
_BATCHED_SCALARS = ("ask_cpu", "ask_mem", "ask_disk", "desired_count",
                    "limit", "distinct_hosts")


def prepare_batched(cpu_total, mem_total, disk_total, batch: BatchInputs,
                    n_candidates, n_picks: int, spread_fit: bool = False,
                    wanted=None, spread=None, deltas=None,
                    pre=None) -> dict:
    """Every input of `chained_plan_picks` and `batch_plan_picks` as a
    contiguous tensor on cpu_total's device, checked for shape: the
    BatchInputs fields with a leading E ([E, C] columns, [E] scalars),
    `n_candidates` (a scalar or [E]) and `wanted` (default P) as
    int32 [E], and the optional per-eval spread, deltas and pre-deltas.
    Inputs may be numpy arrays or tensors."""
    dev = cpu_total.device
    dtype = cpu_total.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"columns must be f32 or f64, got {dtype}")
    C = cpu_total.shape[0]
    P = int(n_picks)
    if P < 1:
        raise ValueError(f"n_picks must be >= 1, got {P}")
    b = _tuple_as(batch, BatchInputs, _BATCHED_KINDS, dtype, dev)
    E = b.perm.shape[0]
    for name in BatchInputs._fields:
        t = getattr(b, name)
        want = (E,) if name in _BATCHED_SCALARS else (E, C)
        if tuple(t.shape) != want:
            raise ValueError(
                f"{name} must have shape {want}, got {tuple(t.shape)}"
            )
    if isinstance(n_candidates, torch.Tensor):
        n_candidates = n_candidates.cpu().numpy()
    nc_host = np.array(
        np.broadcast_to(np.asarray(n_candidates, np.int32), (E,))
    )
    if E and (nc_host.min() < 1 or nc_host.max() > C):
        raise ValueError(f"n_candidates outside [1, {C}]")
    # on the limits as given: host inputs need no device reduction
    lim = batch.limit
    if E and int(lim.min() if isinstance(lim, torch.Tensor)
                 else np.min(lim)) < 1:
        raise ValueError("limit must be >= 1")
    if wanted is None:
        wanted = np.full(E, P, np.int32)
    q = dict(
        cols=tuple(_as_tensor(c, _FLOAT, dtype, dev)
                   for c in (cpu_total, mem_total, disk_total)),
        batch=b, n_cand=_as_tensor(nc_host, _INT, dtype, dev),
        wanted=_as_tensor(wanted, _INT, dtype, dev),
        spread=_tuple_as(spread, SpreadInputs, _SPREAD_KINDS, dtype, dev),
        deltas=_tuple_as(deltas, StepDeltas, _DELTA_KINDS, dtype, dev),
        pre=_tuple_as(pre, PreDeltas, _PRE_KINDS, dtype, dev),
        E=E, P=P, C=C, spread_fit=bool(spread_fit),
    )
    if tuple(q["wanted"].shape) != (E,):
        raise ValueError(f"wanted must have shape ({E},)")
    if q["deltas"] is not None and (
            tuple(q["deltas"].evict_rows.shape) != (E, P)):
        raise ValueError(f"deltas.evict_rows must have shape ({E}, {P})")
    return q


def batched_as_chain(q: dict) -> dict:
    """The chained planner's inputs in `prepare_chain`'s layout: one
    group, each eval's scalars repeated for its P picks, the chain
    starting from eval 0's base usage (the JAX program reads only
    base_*_used[0])."""
    b = q["batch"]
    E, P = q["E"], q["P"]
    dev = b.perm.device

    def per_pick(x):
        return x[:, None].expand(E, P)

    chain = ChainInputs(
        feasible=b.feasible[:, None], perm=b.perm,
        ask_cpu=per_pick(b.ask_cpu), ask_mem=per_pick(b.ask_mem),
        ask_disk=per_pick(b.ask_disk),
        desired_count=per_pick(b.desired_count), limit=per_pick(b.limit),
        distinct_hosts=b.distinct_hosts,
        tg_idx=torch.zeros((E, P), dtype=torch.int32, device=dev),
    )
    return prepare_chain(
        *q["cols"], b.base_cpu_used[0], b.base_mem_used[0],
        b.base_disk_used[0], chain, q["n_cand"], P,
        spread_fit=q["spread_fit"], wanted=q["wanted"], spread=q["spread"],
        deltas=q["deltas"], pre=q["pre"], coll0=b.base_collisions[:, None],
        affinity=b.affinity_score[:, None], penalty=b.penalty,
    )


def chained_plan_rows_twin(q: dict):
    """K9's twin over `prepare_batched` inputs: K3's twin over the
    per-eval inputs as one group, with the static penalty column beside
    the pick's penalty rows.  Returns rows i32[E, P]."""
    if q["E"] == 0:
        return torch.empty((0, q["P"]), dtype=torch.int32,
                           device=q["cols"][0].device)
    return chained_picks_twin(batched_as_chain(q))[0]


def chained_plan_picks_twin(cpu_total, mem_total, disk_total,
                            batch: BatchInputs, n_candidates, n_picks: int,
                            spread_fit: bool = False, wanted=None,
                            spread=None, deltas=None, pre=None):
    """Plain twin of the JAX `chained_plan_picks`.  Returns rows
    i32[E, P]."""
    return chained_plan_rows_twin(prepare_batched(
        cpu_total, mem_total, disk_total, batch, n_candidates, n_picks,
        spread_fit, wanted, spread, deltas, pre))


def _launch_chained_batch(q: dict, feasible, collisions, penalty, affinity,
                          used0, distinct_hosts, wanted):
    """K9 on the current stream over prepared inputs, with the given
    feasibility ([E, C], or [C] shared), optional per-eval columns, the
    chain's starting usage and the per-eval flags.  Returns (rows,
    pulls), each i32[E, P]: a pick's pulls are the walk positions it
    reached."""
    from . import _cuda

    dev = q["cols"][0].device
    if dev.type != "cuda":
        raise ValueError(f"K9 needs CUDA tensors, got {dev}")
    if q["E"] < 1:
        raise ValueError("K9 needs E >= 1")
    E, P, C = q["E"], q["P"], q["C"]
    dtype = q["cols"][0].dtype
    rows = torch.empty((E, P), dtype=torch.int32, device=dev)
    pulls = torch.empty((E, P), dtype=torch.int32, device=dev)
    used_out = tuple(torch.empty_like(u) for u in used0)
    b = q["batch"]
    named = dict(
        cpu_total=q["cols"][0], mem_total=q["cols"][1],
        disk_total=q["cols"][2], cpu_in=used0[0], mem_in=used0[1],
        disk_in=used0[2], cpu_out=used_out[0], mem_out=used_out[1],
        disk_out=used_out[2], feasible=feasible, perm=b.perm,
        ask_cpu=b.ask_cpu, ask_mem=b.ask_mem, ask_disk=b.ask_disk,
        desired=b.desired_count, limit=b.limit,
        distinct_hosts=distinct_hosts, n_cand=q["n_cand"], wanted=wanted,
        collisions=collisions, penalty=penalty, affinity=affinity,
        out_rows=rows, out_pulls=pulls,
    )
    _cuda.launch_chained_batch(named, q["spread"], q["deltas"], q["pre"],
                               E=E, P=P, C=C, feas_shared=feasible.dim() == 1,
                               spread_fit=q["spread_fit"], dtype=dtype)
    return rows, pulls


def launch_chained_plan(q: dict):
    """K9 over `prepare_batched` inputs on their CUDA device (current
    stream), the chain starting from eval 0's base usage.  Returns
    (rows, pulls), each i32[E, P]; nothing is synchronised."""
    b = q["batch"]
    out = _launch_chained_batch(
        q, b.feasible, b.base_collisions, b.penalty, b.affinity_score,
        (b.base_cpu_used[0], b.base_mem_used[0], b.base_disk_used[0]),
        b.distinct_hosts, q["wanted"],
    )
    chained_plan_picks_cuda.launches += 1
    return out


def chained_plan_picks_cuda(cpu_total, mem_total, disk_total,
                            batch: BatchInputs, n_candidates, n_picks: int,
                            spread_fit: bool = False, wanted=None,
                            spread=None, deltas=None, pre=None):
    """Launch K9 on the tensors' CUDA device (current stream) over
    per-eval inputs.  Returns the i32[E, P] rows on the device; nothing
    is synchronised."""
    return launch_chained_plan(prepare_batched(
        cpu_total, mem_total, disk_total, batch, n_candidates, n_picks,
        spread_fit, wanted, spread, deltas, pre))[0]


chained_plan_picks_cuda.launches = 0


def chained_plan_rows(q: dict):
    """`chained_plan_picks` over `prepare_batched` inputs: K9 on a CUDA
    device, the twin on the CPU.  Returns rows i32[E, P]."""
    if q["cols"][0].device.type == "cpu":
        return chained_plan_rows_twin(q)
    return launch_chained_plan(q)[0]


def chained_plan_picks(cpu_total, mem_total, disk_total, batch: BatchInputs,
                       n_candidates, n_picks: int, spread_fit: bool = False,
                       wanted=None, spread=None, deltas=None, pre=None):
    """E evals x P picks in one launch, serially equivalent: a scan over
    the evals carries the usage columns forward from eval 0's base
    usage, so eval k scores against the state left by evals 0..k-1,
    each with its own feasibility, collisions, penalty, affinity, walk
    order and scalars, and optional per-eval spread, step deltas,
    pre-deltas and `wanted` (picks past it are inert).  Returns rows
    i32[E, P] (NO_NODE where a pick failed).  K9 for a CUDA cpu_total,
    the twin for a CPU one."""
    return chained_plan_rows(prepare_batched(
        cpu_total, mem_total, disk_total, batch, n_candidates, n_picks,
        spread_fit, wanted, spread, deltas, pre))


def _shared_as_batched(cpu_total, feasible, base_cpu_used, base_mem_used,
                       base_disk_used, perms, ask_cpu, ask_mem, ask_disk,
                       desired_count, limit) -> BatchInputs:
    """The shared-column chain as per-eval BatchInputs: every eval the
    same feasibility and usage, collisions, penalty and affinity zero,
    distinct_hosts off."""
    E, C = perms.shape
    dev = cpu_total.device

    def rep(x):
        return torch.as_tensor(x, device=dev)[None].expand(E, C)

    return BatchInputs(
        feasible=rep(feasible), base_cpu_used=rep(base_cpu_used),
        base_mem_used=rep(base_mem_used), base_disk_used=rep(base_disk_used),
        base_collisions=torch.zeros((E, C), dtype=torch.int32, device=dev),
        penalty=torch.zeros((E, C), dtype=torch.bool, device=dev),
        affinity_score=torch.zeros((E, C), dtype=cpu_total.dtype,
                                   device=dev),
        perm=perms, ask_cpu=ask_cpu, ask_mem=ask_mem, ask_disk=ask_disk,
        desired_count=desired_count, limit=limit,
        distinct_hosts=torch.zeros(E, dtype=torch.bool, device=dev),
    )


def chained_plan_picks_shared_twin(cpu_total, mem_total, disk_total,
                                   feasible, base_cpu_used, base_mem_used,
                                   base_disk_used, perms, ask_cpu, ask_mem,
                                   ask_disk, desired_count, limit,
                                   n_candidates, n_picks: int,
                                   spread_fit: bool = False):
    """Plain twin of the JAX `chained_plan_picks_shared`: the chain over
    shared [C] columns with each eval's `wanted` its desired count.
    Returns rows i32[E, P]."""
    batch = _shared_as_batched(cpu_total, feasible, base_cpu_used,
                               base_mem_used, base_disk_used, perms, ask_cpu,
                               ask_mem, ask_disk, desired_count, limit)
    return chained_plan_picks_twin(cpu_total, mem_total, disk_total, batch,
                                   n_candidates, n_picks, spread_fit,
                                   wanted=desired_count)


def chained_plan_picks_shared_cuda(cpu_total, mem_total, disk_total,
                                   feasible, base_cpu_used, base_mem_used,
                                   base_disk_used, perms, ask_cpu, ask_mem,
                                   ask_disk, desired_count, limit,
                                   n_candidates, n_picks: int,
                                   spread_fit: bool = False):
    """Launch K9 in its shared mode (one [C] feasibility column at eval
    stride 0, no collisions, penalty or affinity) on the tensors' CUDA
    device.  Returns the i32[E, P] rows on the device; nothing is
    synchronised."""
    named = dict(zip(_SHARED_ARGS, (cpu_total, mem_total, disk_total,
                                    base_cpu_used, base_mem_used,
                                    base_disk_used, feasible, perms, ask_cpu,
                                    ask_mem, ask_disk, desired_count, limit)))
    dev, E, C, n_cand = _check_shared(named, n_candidates, n_picks)
    if E < 1:
        raise ValueError("chained_plan_picks_shared_cuda needs E >= 1")
    if int(limit.min()) < 1:
        raise ValueError("limit must be >= 1")
    named = {n: t.contiguous() for n, t in named.items()}
    # only the per-eval scalars and walk orders are per eval: no [E, C]
    # copy of a shared column is made
    batch = BatchInputs(
        feasible=None, base_cpu_used=None, base_mem_used=None,
        base_disk_used=None, base_collisions=None, penalty=None,
        affinity_score=None, perm=named["perms"], ask_cpu=named["ask_cpu"],
        ask_mem=named["ask_mem"], ask_disk=named["ask_disk"],
        desired_count=named["desired_count"], limit=named["limit"],
        distinct_hosts=torch.zeros(E, dtype=torch.bool, device=dev),
    )
    q = dict(
        cols=(named["cpu_total"], named["mem_total"], named["disk_total"]),
        batch=batch,
        n_cand=torch.full((E,), n_cand, dtype=torch.int32, device=dev),
        spread=None, deltas=None, pre=None, E=E, P=int(n_picks), C=C,
        spread_fit=bool(spread_fit),
    )
    rows, _pulls = _launch_chained_batch(
        q, named["feasible"], None, None, None,
        (named["base_cpu_used"], named["base_mem_used"],
         named["base_disk_used"]),
        batch.distinct_hosts, named["desired_count"],
    )
    chained_plan_picks_shared_cuda.launches += 1
    return rows


chained_plan_picks_shared_cuda.launches = 0


def chained_plan_picks_shared(cpu_total, mem_total, disk_total, feasible,
                              base_cpu_used, base_mem_used, base_disk_used,
                              perms, ask_cpu, ask_mem, ask_disk,
                              desired_count, limit, n_candidates,
                              n_picks: int, spread_fit: bool = False):
    """Serially equivalent chain with shared node columns: only the
    E x C walk orders and the per-eval scalars vary, the usage chains
    across evals, and each eval wants `desired_count` picks (the surplus
    ones are inert).  Returns i32[E, P] rows.  K9 (shared mode) for CUDA
    tensors, the twin for CPU tensors."""
    args = (cpu_total, mem_total, disk_total, feasible, base_cpu_used,
            base_mem_used, base_disk_used, perms, ask_cpu, ask_mem,
            ask_disk, desired_count, limit, n_candidates, n_picks,
            spread_fit)
    if cpu_total.device.type == "cpu":
        return chained_plan_picks_shared_twin(*args)
    return chained_plan_picks_shared_cuda(*args)


def batch_plan_twin(q: dict):
    """K10's twin over `prepare_batched` inputs: E independent
    `plan_picks`, each over its own BatchInputs (its own base usage,
    feasibility, collisions, penalty, affinity and walk order) and its
    own spread, every pick wanted.  Returns (rows, pulls), each
    i32[E, P], as K10's `launch_batch_plan`."""
    b = q["batch"]
    E, P = q["E"], q["P"]
    dev = q["cols"][0].device
    rows, pulls = [], []
    for e in range(E):
        tg = TGInputs(
            tg_idx=torch.zeros(P, dtype=torch.int32, device=dev),
            feasible=b.feasible[e][None], affinity=b.affinity_score[e][None],
            coll0=b.base_collisions[e][None],
            ask_cpu=b.ask_cpu[e].expand(P), ask_mem=b.ask_mem[e].expand(P),
            ask_disk=b.ask_disk[e].expand(P),
            desired_count=b.desired_count[e].expand(P),
            limit=b.limit[e].expand(P),
        )
        r, n, _used, _ports, _devs = _run_picks(
            *q["cols"],
            (b.base_cpu_used[e], b.base_mem_used[e], b.base_disk_used[e]),
            b.perm[e], tg, b.distinct_hosts[e], q["n_cand"][e], P,
            q["spread_fit"], spread=_eval_slice(q["spread"], e),
            penalty=b.penalty[e],
        )
        rows.append(r)
        pulls.append(n.to(torch.int32))
    if not rows:
        empty = torch.empty((0, P), dtype=torch.int32, device=dev)
        return empty, empty
    return torch.stack(rows), torch.stack(pulls)


def batch_plan_rows_twin(q: dict):
    """K10's twin over `prepare_batched` inputs (`batch_plan_twin`):
    rows i32[E, P]."""
    return batch_plan_twin(q)[0]


def batch_plan_picks_twin(cpu_total, mem_total, disk_total,
                          batch: BatchInputs, n_candidates, n_picks: int,
                          spread_fit: bool = False, spread=None):
    """Plain twin of the JAX `batch_plan_picks`.  Returns rows
    i32[E, P]."""
    return batch_plan_rows_twin(prepare_batched(
        cpu_total, mem_total, disk_total, batch, n_candidates, n_picks,
        spread_fit, spread=spread))


def launch_batch_plan(q: dict):
    """K10 over `prepare_batched` inputs on their CUDA device (current
    stream): one block per eval.  Returns (rows, pulls), each
    i32[E, P]: a pick's pulls are the walk positions it reached;
    nothing is synchronised."""
    from . import _cuda

    dev = q["cols"][0].device
    if dev.type != "cuda":
        raise ValueError(f"K10 needs CUDA tensors, got {dev}")
    if q["E"] < 1:
        raise ValueError("K10 needs E >= 1")
    E, P = q["E"], q["P"]
    rows = torch.empty((E, P), dtype=torch.int32, device=dev)
    pulls = torch.empty((E, P), dtype=torch.int32, device=dev)
    _cuda.launch_batch_plan(q, rows, pulls)
    batch_plan_picks_cuda.launches += 1
    return rows, pulls


def batch_plan_blocks_at_once(C: int, P: int, dtype, device) -> int:
    """The most K10 blocks (one an eval) the card holds at once for a
    C-row arena and P picks; a launch of more evals runs in waves."""
    from . import _cuda

    return _cuda.plan_blocks_at_once(C, P, dtype, device)


def batch_plan_picks_cuda(cpu_total, mem_total, disk_total,
                          batch: BatchInputs, n_candidates, n_picks: int,
                          spread_fit: bool = False, spread=None):
    """Launch K10 on the tensors' CUDA device (current stream).  Returns
    the i32[E, P] rows on the device; nothing is synchronised."""
    return launch_batch_plan(prepare_batched(
        cpu_total, mem_total, disk_total, batch, n_candidates, n_picks,
        spread_fit, spread=spread))[0]


batch_plan_picks_cuda.launches = 0


def batch_plan_rows(q: dict):
    """`batch_plan_picks` over `prepare_batched` inputs: K10 on a CUDA
    device, the twin on the CPU.  Returns rows i32[E, P]."""
    if q["cols"][0].device.type == "cpu":
        return batch_plan_rows_twin(q)
    return launch_batch_plan(q)[0]


def batch_plan_picks(cpu_total, mem_total, disk_total, batch: BatchInputs,
                     n_candidates, n_picks: int, spread_fit: bool = False,
                     spread=None):
    """E independent evals x P picks in one launch, each over its own
    BatchInputs and optional spread; `n_candidates` is a scalar or one
    per eval.  Returns rows i32[E, P] (NO_NODE where a pick failed).
    K10 for a CUDA cpu_total, the twin for a CPU one."""
    return batch_plan_rows(prepare_batched(
        cpu_total, mem_total, disk_total, batch, n_candidates, n_picks,
        spread_fit, spread=spread))


def _check_patch(col, idx, vals):
    if col.dim() != 1 or idx.dim() != 1 or vals.shape != idx.shape:
        raise ValueError("patch_rows needs col[C], idx[W], vals[W]")
    if idx.dtype != torch.int32:
        raise TypeError("idx must be int32")
    if vals.dtype != col.dtype:
        raise TypeError(f"vals must be {col.dtype}")
    if idx.device != col.device or vals.device != col.device:
        raise ValueError("col, idx and vals must share a device")


def patch_rows_twin(col, idx, vals):
    """`col[idx] = vals` in place, indices outside [0, C) dropped
    (padding uses idx == C).  Returns col."""
    _check_patch(col, idx, vals)
    keep = (idx >= 0) & (idx < col.shape[0])
    col[idx[keep].long()] = vals[keep]
    return col


def patch_rows_cuda(col, idx, vals):
    """K4 on the current stream: the same scatter, one thread per
    staged index, as the K = 1 case of the flush's launch (K13 over one
    shard of C rows, bound on every call).  `launches` counts K4's
    launches, the flushes' included.  A failed build or launch raises
    `DeviceFault`.  Returns col."""
    _check_patch(col, idx, vals)
    if col.device.type != "cuda":
        raise ValueError(f"patch_rows_cuda needs CUDA tensors, got {col.device}")
    if not col.is_contiguous():
        raise ValueError("patch_rows_cuda patches a contiguous column")
    bound = _bind_row_patch(_OneShard(col.device), (_Plain((col,)),), "K4")
    idx, vals = idx.contiguous(), vals.contiguous()
    _launch_row_patch(bound, "K4", idx.data_ptr(), vals.data_ptr(),
                      idx.shape[0])
    return col


patch_rows_cuda.launches = 0


def patch_rows(col, idx, vals):
    """Scatter-patch dirty rows into a persistent usage column in
    place: ``col[idx] = vals`` with indices outside [0, C) dropped.
    The delta-sync primitive of the batch worker's device mirror.  K4
    for a CUDA column, the twin for a CPU one."""
    if col.device.type == "cpu":
        return patch_rows_twin(col, idx, vals)
    return patch_rows_cuda(col, idx, vals)


def _check_patch_sharded(mesh, col, idx, vals):
    shards = col.shards
    if len(shards) != len(mesh.local_shards):
        raise ValueError("a Sharded column of another mesh")
    for t in shards:
        _check_patch(t, idx, vals)


def patch_rows_sharded_twin(mesh, col, idx, vals):
    """`patch_rows` on a node-sharded column (`parallel.mesh.Sharded`):
    every shard receives the replicated (idx, vals) staging and stores
    only the rows in its own range [lo, lo + size); padding (idx == C)
    is dropped on every shard.  In place; returns col."""
    _check_patch_sharded(mesh, col, idx, vals)
    for s, t in zip(mesh.local_shards, col.shards):
        size = t.shape[0]
        local = idx.long() - s * size
        keep = (local >= 0) & (local < size)
        t[local[keep]] = vals[keep]
    return col


def _check_patch_cols(mesh, cols, idx, vals, hostlocal: bool):
    """K Sharded columns of `mesh` (the same shard size, dtype and
    device) and a staging of idx i32 [W] (replicated global rows) or
    [L, w] (`hostlocal`: one row of shard-local rows a local shard) with
    vals [K, *idx.shape] of the columns' dtype, on their device."""
    n_local = len(mesh.local_shards)
    if not cols:
        raise ValueError("a row patch needs at least one column")
    first = cols[0].shards[0] if cols[0].shards else None
    for col in cols:
        if len(col.shards) != n_local:
            raise ValueError("a Sharded column of another mesh")
        for t in col.shards:
            if t.dim() != 1 or t.shape[0] != first.shape[0]:
                raise ValueError("the shards of a column are [C // D] each")
            if t.dtype != first.dtype:
                raise TypeError(f"the columns must all be {first.dtype}")
            if t.device != first.device:
                raise ValueError("the columns must share a device")
    if idx is None:
        return
    if hostlocal:
        if idx.dim() != 2 or idx.shape[0] != n_local:
            raise ValueError(f"patch_rows_hostlocal needs idx and vals stacks "
                             f"of [{n_local}, w]: one row per local shard")
    elif idx.dim() != 1:
        raise ValueError("patch_rows_sharded needs a replicated idx[W]")
    if tuple(vals.shape) != (len(cols),) + tuple(idx.shape):
        raise ValueError(f"vals must be [{len(cols)}, *{tuple(idx.shape)}]: "
                         "one staging row a column")
    if idx.dtype != torch.int32:
        raise TypeError("idx must be int32")
    if vals.dtype != first.dtype:
        raise TypeError(f"vals must be {first.dtype}")
    if idx.device != first.device or vals.device != first.device:
        raise ValueError("col, idx and vals must share a device")


def patch_rows_sharded_cols_twin(mesh, cols, idx, vals):
    """`patch_rows_sharded_twin` of K columns from one replicated
    staging: column k stores ``vals[k]`` at `idx` (vals [K, W]).  In
    place; returns cols."""
    _check_patch_cols(mesh, cols, idx, vals, hostlocal=False)
    for col, v in zip(cols, vals):
        patch_rows_sharded_twin(mesh, col, idx, v)
    return cols


class _OneShard:
    """The unsharded mirror as a mesh of one shard of C rows: K4 is K13's
    case of one shard (``first`` 0, size C)."""

    n_shards = 1
    local_shards = (0,)

    def __init__(self, device) -> None:
        self.device = device


class _Plain(NamedTuple):
    """A plain [C] column as the one shard of a `_OneShard` mesh (the
    duck of `parallel.mesh.Sharded`)."""

    shards: tuple


# the launch counter and error name of each row-patch kernel
_ROW_PATCH = {"K4": "K4 patch_rows", "K13": "K13 patch_rows_sharded",
              "K15": "K15 patch_rows_hostlocal"}


def _bind_row_patch(mesh, cols, kernel: str):
    """`kernel` (K4, K13 or K15) bound to the checked columns' shards on
    the card: the [K][L] shard-pointer table built once
    (`_cuda.RowPatchLaunch`).  A failed build or bind raises
    `DeviceFault`."""
    from ..device.core import DeviceFault
    from . import _cuda

    if mesh.device.type != "cuda":
        raise ValueError(f"{_ROW_PATCH[kernel]} needs a mesh on the card, "
                         f"got {mesh.device}")
    for col in cols:
        for t in col.shards:
            if not t.is_contiguous():
                raise ValueError("a row patch stores into contiguous shards")
    try:
        return _cuda.RowPatchLaunch([col.shards for col in cols],
                                    mesh.local_shards[0], kernel == "K15")
    except RuntimeError as exc:  # a build, bind or table failure
        raise DeviceFault(f"{_ROW_PATCH[kernel]} failed: {exc}") from exc


def _launch_row_patch(bound, kernel: str, idx_ptr: int, vals_ptr: int,
                      width: int) -> None:
    """One launch of a bound K4/K13/K15 on a staging on the card, counted
    on `patch_rows_cuda`, `patch_rows_sharded_cuda` or
    `patch_rows_hostlocal_cuda`.  A refused launch raises
    `DeviceFault`."""
    try:
        bound(idx_ptr, vals_ptr, width)
    except RuntimeError as exc:
        from ..device.core import DeviceFault

        raise DeviceFault(f"{_ROW_PATCH[kernel]} failed: {exc}") from exc
    if kernel == "K4":
        patch_rows_cuda.launches += 1
    elif kernel == "K13":
        patch_rows_sharded_cuda.launches += 1
    else:
        patch_rows_hostlocal_cuda.launches += 1


class RowPatch:
    """The delta flush of K columns of a usage mirror, bound once: the
    columns are checked here, and on the card the kernel's [K][L]
    shard-pointer table is built here, so a flush only writes the
    staging and launches.  The columns are `Sharded` tensors of `mesh`
    or, with ``mesh=None``, plain [C] tensors of the unsharded mirror
    (K4, the one-shard case: one launch for every column).  On a mesh,
    ``hostlocal=False`` takes a replicated staging of global rows (K13,
    one launch for every local shard and column), ``hostlocal=True``
    this process's [L, w] rows of `hostlocal_staging` (K15).  A mirror
    rebuilds its RowPatch whenever it replaces its column tensors (a
    full resync, a bulk upload).  On the CPU a call runs the twins.

    `flush` stages one delta (indices and K value rows in one buffer,
    pinned for the card), moves it with one copy and stores it with one
    launch.  The class counts the flushes and the staging copies; the
    launches count on `patch_rows_cuda` (K4), `patch_rows_sharded_cuda`
    (K13) and `patch_rows_hostlocal_cuda` (K15).  A failed build or
    launch raises `DeviceFault`."""

    flushes = 0  # delta flushes staged through `flush`
    copies = 0  # their staging buffers moved to the mirror's device

    def __init__(self, mesh, cols, hostlocal: bool = False) -> None:
        cols = tuple(cols)
        self.cols = cols
        self.hostlocal = hostlocal
        if mesh is None:
            # the unsharded mirror: each column the one shard of C rows
            if hostlocal:
                raise ValueError("an unsharded mirror takes a replicated "
                                 "staging, not a host-local one")
            if not cols or not all(isinstance(t, torch.Tensor) for t in cols):
                raise ValueError("an unsharded row patch takes [C] tensors")
            mesh = _OneShard(cols[0].device)
            cols = tuple(_Plain((t,)) for t in cols)
            self.kernel = "K4"
        else:
            self.kernel = "K15" if hostlocal else "K13"
        _check_patch_cols(mesh, cols, None, None, hostlocal)
        self.mesh = mesh
        self._shard_cols = cols
        self.dtype = cols[0].shards[0].dtype
        self._shape_k = (len(cols),)
        # the staging's leading dims: [W], or [L, w] for hostlocal
        self._idx_lead = (len(mesh.local_shards),) if hostlocal else ()
        self._np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        self._dev = cols[0].shards[0].get_device()
        self._launch = None
        if mesh.device.type != "cpu":
            self._launch = _bind_row_patch(mesh, cols, self.kernel)

    def __call__(self, idx, vals):
        """Store the staging (idx [W] or [L, w] int32, vals [K, *idx])
        into the columns in place, one launch on the card; returns the
        columns."""
        mesh, cols = self.mesh, self._shard_cols
        if self._launch is None:
            if self.hostlocal:
                patch_rows_hostlocal_cols_twin(mesh, cols, idx, vals)
            elif self.kernel == "K4":
                _check_patch_cols(mesh, cols, idx, vals, False)
                for col, v in zip(self.cols, vals):
                    patch_rows_twin(col, idx, v)
            else:
                patch_rows_sharded_cols_twin(mesh, cols, idx, vals)
            return self.cols
        if (idx.dtype is not torch.int32 or vals.dtype is not self.dtype
                or vals.shape != self._shape_k + idx.shape
                or idx.dim() == 0 or idx.shape[:-1] != self._idx_lead
                or idx.get_device() != self._dev
                or vals.get_device() != self._dev):
            _check_patch_cols(mesh, cols, idx, vals, self.hostlocal)
        if not (idx.is_contiguous() and vals.is_contiguous()):
            idx, vals = idx.contiguous(), vals.contiguous()
        self.launch(idx.data_ptr(), vals.data_ptr(), idx.shape[-1])
        return self.cols

    def launch(self, idx_ptr: int, vals_ptr: int, width: int) -> None:
        """The launch a flush makes, unchecked: a staging already on the
        card at these addresses (idx int32 [W] or [L, W], then vals
        [K, *idx] of the columns' dtype, contiguous).  Card only."""
        _launch_row_patch(self._launch, self.kernel, idx_ptr, vals_ptr, width)

    def flush(self, rows: np.ndarray, row_vals, capacity: int) -> int:
        """One delta flush: `rows` the sorted global dirty rows (int32)
        and `row_vals` the K columns' new values at them (``row_vals[k][j]``
        for ``rows[j]``).  The staging is the replicated one (idx [W]
        padded with `capacity`, W the pow2 bucket, floor 8, of the dirty
        count: 4 W + K W itemsize bytes, as many as an index upload and
        K value uploads of width W) or, hostlocal, this process's rows of `hostlocal_staging`
        ([L, w], padding the shard size; a shard's sorted rows are one
        slice of `rows`); its indices and its K value rows [K, *idx]
        share one buffer, the values 8-byte aligned after the indices,
        pinned when bound for the card.  One copy (non_blocking, on the
        current stream) moves it to the mirror's device, one launch
        stores it.  Returns the staged bytes."""
        mesh = self.mesh
        rows = np.asarray(rows, dtype=np.int32)
        vals = np.asarray(row_vals)
        n_rows = len(rows)
        if self.hostlocal:
            size = capacity // mesh.n_shards
            cut = np.searchsorted(rows, np.arange(mesh.n_shards + 1) * size)
            width = pow2_bucket(max(1, int(np.diff(cut).max())), floor=8)
            shape = (len(mesh.local_shards), width)
        else:
            width = pow2_bucket(n_rows, floor=8)
            shape = (width,)
        n = shape[0] * width if self.hostlocal else width
        off = -(-4 * n // 8) * 8
        nbytes = off + len(self.cols) * n * self.dtype.itemsize
        buf = torch.empty(nbytes, dtype=torch.uint8,
                          pin_memory=mesh.device.type == "cuda")
        host = buf.numpy()
        idx_h = host[:4 * n].view(np.int32).reshape(shape)
        vals_h = host[off:].view(self._np_dtype).reshape(self._shape_k + shape)
        if self.hostlocal:
            idx_h.fill(size)
            vals_h.fill(0)
            for i, d in enumerate(mesh.local_shards):
                a, b = cut[d], cut[d + 1]
                idx_h[i, :b - a] = rows[a:b] - d * size
                vals_h[:, i, :b - a] = vals[:, a:b]
        else:
            idx_h[:n_rows] = rows
            idx_h[n_rows:] = capacity
            vals_h[:, :n_rows] = vals
            vals_h[:, n_rows:] = 0
        dev = buf.to(mesh.device, non_blocking=True)
        RowPatch.copies += 1
        if self._launch is not None:
            ptr = dev.data_ptr()
            self.launch(ptr, ptr + off, width)
        else:
            self(dev[:4 * n].view(torch.int32).view(shape),
                 dev[off:].view(self.dtype).view(self._shape_k + shape))
        RowPatch.flushes += 1
        return nbytes


def patch_rows_sharded_cuda(mesh, col, idx, vals):
    """K13 on the current stream for one column: the K = 1 case of the
    flush's launch, one launch for every local shard (one thread a
    staged row derives its shard from its global index).  `launches`
    counts kernel launches.  A failed build or launch raises
    `DeviceFault`.  Returns col."""
    _check_patch_cols(mesh, (col,), idx, vals.unsqueeze(0), hostlocal=False)
    bound = _bind_row_patch(mesh, (col,), "K13")
    idx, vals = idx.contiguous(), vals.contiguous()
    _launch_row_patch(bound, "K13", idx.data_ptr(), vals.data_ptr(),
                      idx.shape[0])
    return col


patch_rows_sharded_cuda.launches = 0


def patch_rows_sharded(mesh, col, idx, vals):
    """The delta-sync primitive of a node-sharded usage mirror: each
    shard of `col` (a `Sharded` column of `mesh`) stores the staged rows
    in its range, in place.  K13 on a mesh on the card, the twin on the
    CPU."""
    if mesh.device.type == "cpu":
        return patch_rows_sharded_twin(mesh, col, idx, vals)
    return patch_rows_sharded_cuda(mesh, col, idx, vals)


def hostlocal_staging(mesh, idx: np.ndarray, capacity: int):
    """The index staging of `patch_rows_hostlocal` for a dirty-row set
    (`idx`, sorted global rows): ``(idx_stack [D, w] i32 shard-local,
    per_dev, w)``, where ``per_dev[d]`` is the slice of `idx` in shard
    d (the caller gathers each column's values with it), w the pow2
    bucket (floor 8) of the largest per-shard count and padding the
    shard size.  Every process computes the same stack from the shared
    dirty log and ships only its own shards' rows."""
    n_dev = int(mesh.n_shards)
    size = int(capacity) // n_dev
    idx = np.asarray(idx)
    per_dev = [idx[(idx >= d * size) & (idx < (d + 1) * size)]
               for d in range(n_dev)]
    w = pow2_bucket(max(1, max(len(s) for s in per_dev)), floor=8)
    idx_stack = np.full((n_dev, w), size, np.int32)
    for d, sel in enumerate(per_dev):
        idx_stack[d, :len(sel)] = sel - d * size
    return idx_stack, per_dev, w


def _check_patch_hostlocal(mesh, col, idx_stack, vals_stack):
    if len(col.shards) != len(mesh.local_shards):
        raise ValueError("a Sharded column of another mesh")
    if vals_stack.shape != idx_stack.shape:
        raise ValueError(f"patch_rows_hostlocal needs idx and vals stacks of "
                         f"[{len(mesh.local_shards)}, w]: one row per local "
                         "shard")
    _check_patch_cols(mesh, (col,), idx_stack, vals_stack.unsqueeze(0),
                      hostlocal=True)


def patch_rows_hostlocal_twin(mesh, col, idx_stack, vals_stack):
    """`patch_rows_hostlocal` in plain torch: local shard l stores row l
    of the staging (``shard[idx] = vals``, indices shard-local), and
    indices outside [0, size) (padding is the shard size) are dropped.
    In place; returns col."""
    _check_patch_hostlocal(mesh, col, idx_stack, vals_stack)
    for l, t in enumerate(col.shards):
        idx = idx_stack[l]
        keep = (idx >= 0) & (idx < t.shape[0])
        t[idx[keep].long()] = vals_stack[l][keep]
    return col


def patch_rows_hostlocal_cols_twin(mesh, cols, idx_stack, vals_stack):
    """`patch_rows_hostlocal_twin` of K columns from one staging: column
    k stores ``vals_stack[k]`` ([K, L, w]).  In place; returns cols."""
    _check_patch_cols(mesh, cols, idx_stack, vals_stack, hostlocal=True)
    for col, v in zip(cols, vals_stack):
        patch_rows_hostlocal_twin(mesh, col, idx_stack, v)
    return cols


def patch_rows_hostlocal_cuda(mesh, col, idx_stack, vals_stack):
    """K15 on the current stream for one column: the K = 1 case of the
    flush's launch, one launch for all of this process's shards.
    `launches` counts kernel launches.  A failed build or launch raises
    `DeviceFault`.  Returns col."""
    _check_patch_hostlocal(mesh, col, idx_stack, vals_stack)
    bound = _bind_row_patch(mesh, (col,), "K15")
    idx, vals = idx_stack.contiguous(), vals_stack.contiguous()
    _launch_row_patch(bound, "K15", idx.data_ptr(), vals.data_ptr(),
                      idx.shape[1])
    return col


patch_rows_hostlocal_cuda.launches = 0


def patch_rows_hostlocal(mesh, col, idx_stack, vals_stack):
    """The delta-sync primitive of a node-sharded usage mirror in a world
    of several processes: `col` (a `Sharded` column of `mesh`) takes
    this process's rows of the `hostlocal_staging` stack, ``[L, w]``
    indices (shard-local, i32) and values, row l for local shard l, in
    place.  Padding (the shard size) is dropped.  Bit-identical to
    `patch_rows_sharded` on the same dirty set.  K15 on a mesh on the
    card, the twin on the CPU."""
    if mesh.device.type == "cpu":
        return patch_rows_hostlocal_twin(mesh, col, idx_stack, vals_stack)
    return patch_rows_hostlocal_cuda(mesh, col, idx_stack, vals_stack)
