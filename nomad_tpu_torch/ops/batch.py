"""The look-ahead scan: P sequential picks of one task group.

Port of the single-group half of `nomad_tpu/ops/batch.py`.  The JAX
program `plan_picks_full` (there `:766`, built from `_run_picks` `:347`,
`_walk` `:281` and `_rotated_prefix` `:268`) becomes kernel K2,
`csrc/plan_picks.cu`.  `plan_picks_full` passes `_run_picks` no spread
stanzas, step deltas, ports or devices, so only the single-group step
(T=1) is ported; the chained E x P variant (`chained_plan_picks_cols`)
reuses this step in the next slice.

Each pick scores every node against the usage and collision columns
carried from the earlier picks, runs the rotated limited walk, and
scatters the winner's deltas: the placement loop of one task group
(generic_sched.go:468 computePlacements) in one launch.  The twin keeps
every per-pick column in PERMUTED space, as the JAX program does, so
the walk's rotation by the carried offset is closed-form prefix
arithmetic.
"""
from __future__ import annotations

from typing import NamedTuple

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


def _walk(s_p, f_p, offset, limit, n_candidates):
    """The rotating limited walk in permuted space (see ops/score.py for
    the semantics).  `offset`, `limit` and `n_candidates` are 0-d int32
    tensors.  Returns (win_pos, any_emitted, pulls), win_pos indexing
    the permuted arrays.  Like the JAX program it assumes no feasible
    entry in the tail (every caller ANDs the mask with the candidate
    set)."""
    n = s_p.shape[0]
    dev = s_p.device
    i32 = torch.int32
    pos = torch.arange(n, dtype=i32, device=dev)
    is_tail = pos >= n_candidates
    in_wrap = pos < offset
    # walk position of each permuted index (tail walks last, in place)
    wp = torch.where(
        is_tail, pos, torch.remainder(pos - offset + n_candidates, n_candidates)
    )
    zero = torch.zeros((), dtype=i32, device=dev)
    off_idx = torch.clamp(offset - 1, min=0).long()

    def rot(b):
        cs = torch.cumsum(b.to(i32), 0, dtype=i32)
        total = cs[-1]
        c_off = torch.where(offset > 0, cs[off_idx], zero)
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
    emitted = f_p & (emit_order < limit)

    neg_inf = torch.full((), -float("inf"), dtype=s_p.dtype, device=dev)
    masked = torch.where(emitted, s_p, neg_inf)
    best = torch.max(masked)
    candidates = emitted & (masked == best)
    big = torch.full((), INT32_MAX, dtype=i32, device=dev)
    order_key = torch.where(candidates, emit_order, big)
    win = torch.argmin(order_key)
    any_emitted = torch.any(emitted)

    limit_reached = nd_count >= limit
    lth_wp = torch.min(torch.where(nd & (nd_incl == limit), wp, big))
    pulls = torch.where(limit_reached, lth_wp + 1, n_candidates)
    return win, any_emitted, pulls


def run_picks(cpu_total, mem_total, disk_total, inp: BatchInputs,
              n_candidates, n_picks: int, spread_fit: bool):
    """Plain twin of the single-group `_run_picks` as `plan_picks_full`
    calls it.  Returns (rows i32[P], pulls i32[P])."""
    dtype = cpu_total.dtype
    dev = cpu_total.device
    i32 = torch.int32
    perm = inp.perm.long()
    n_cand = _scalar(n_candidates, i32, dev)
    ask_cpu = _scalar(inp.ask_cpu, dtype, dev)
    ask_mem = _scalar(inp.ask_mem, dtype, dev)
    ask_disk = _scalar(inp.ask_disk, dtype, dev)
    desired = _scalar(inp.desired_count, i32, dev).to(dtype)
    limit = _scalar(inp.limit, i32, dev)
    distinct_hosts = _scalar(inp.distinct_hosts, torch.bool, dev)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    cpu_total_p = cpu_total[perm]
    mem_total_p = mem_total[perm]
    disk_total_p = disk_total[perm]
    feas_p = inp.feasible[perm]
    penalty_p = inp.penalty[perm]
    aff_p = inp.affinity_score[perm]
    safe_cpu = torch.where(cpu_total_p > 0, cpu_total_p, one)
    safe_mem = torch.where(mem_total_p > 0, mem_total_p, one)

    cpu_used = inp.base_cpu_used[perm]
    mem_used = inp.base_mem_used[perm]
    disk_used = inp.base_disk_used[perm]
    collisions = inp.base_collisions[perm]
    offset = torch.zeros((), dtype=i32, device=dev)
    dead = torch.zeros((), dtype=torch.bool, device=dev)
    rows, pulls_out = [], []
    for _k in range(n_picks):
        active = ~dead
        cpu_after = cpu_used + ask_cpu
        mem_after = mem_used + ask_mem
        disk_after = disk_used + ask_disk
        fit = (
            (cpu_after <= cpu_total_p)
            & (mem_after <= mem_total_p)
            & (disk_after <= disk_total_p)
        )
        feasible = feas_p & fit & ~(distinct_hosts & (collisions > 0))

        free_cpu = 1.0 - cpu_after / safe_cpu
        free_mem = 1.0 - mem_after / safe_mem
        base = _pow10(free_cpu, dtype) + _pow10(free_mem, dtype)
        if spread_fit:
            fitness = torch.clamp(base - 2.0, 0.0, 18.0)
        else:
            fitness = torch.clamp(20.0 - base, 0.0, 18.0)
        count = torch.ones_like(fitness)

        has_coll = collisions > 0
        anti = torch.where(
            has_coll, -(collisions.to(dtype) + 1.0) / desired, zero
        )
        # binpack plus anti-affinity, fused as XLA fuses it (score.py)
        score_sum = fma(fitness, INV_18, anti)
        count = count + has_coll.to(dtype)
        score_sum = score_sum - penalty_p.to(dtype)
        count = count + penalty_p.to(dtype)
        has_aff = aff_p != 0.0
        score_sum = score_sum + torch.where(has_aff, aff_p, zero)
        count = count + has_aff.to(dtype)
        final = score_sum / count

        win, any_emitted, step_pulls = _walk(
            final, feasible, offset, limit, n_cand
        )
        ok = active & any_emitted
        dead = dead | (active & ~any_emitted)
        row = torch.where(
            ok, inp.perm[win], torch.full((), NO_NODE, dtype=i32, device=dev)
        )
        pulls = torch.where(active, step_pulls, torch.zeros((), dtype=i32, device=dev))
        safe_win = torch.where(ok, win, torch.zeros_like(win))
        cpu_used = cpu_used.index_add(0, safe_win[None], torch.where(ok, ask_cpu, zero)[None])
        mem_used = mem_used.index_add(0, safe_win[None], torch.where(ok, ask_mem, zero)[None])
        disk_used = disk_used.index_add(0, safe_win[None], torch.where(ok, ask_disk, zero)[None])
        collisions = collisions.index_add(
            0, safe_win[None], ok.to(i32)[None]
        )
        offset = torch.remainder(offset + pulls, n_cand)
        rows.append(row)
        pulls_out.append(pulls)
    return torch.stack(rows).to(i32), torch.stack(pulls_out).to(i32)


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
    dtype = cpu_total.dtype
    # permuted-space columns, carries and per-pick walk scratch: 8
    # floats, one int and two bytes per candidate (~1.2 MB in f64 at
    # 16k candidates), resident in L2
    f_scratch = torch.empty((8, n_cand), dtype=dtype, device=dev)
    i_scratch = torch.empty(n_cand, dtype=torch.int32, device=dev)
    b_scratch = torch.empty((2, n_cand), dtype=torch.uint8, device=dev)
    out = torch.empty((2, n_picks), dtype=torch.int32, device=dev)
    _cuda.launch_plan_picks(
        cols, f_scratch, i_scratch, b_scratch, out,
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
