"""One select: score every candidate node, then the shuffled limited walk.

Port of `nomad_tpu/ops/score.py`.  The JAX program
`score_and_select_packed` (there `:268`, built from `_score_vectors`
`:110`, `_limited_walk_argmax` `:186` and `_pow10` `:69`) becomes kernel
K1, `csrc/score_select.cu`.  This module keeps:

* `ScoreInputs`, the arena-shaped inputs, as a NamedTuple of tensors
  (scalars may be Python numbers or 0-d tensors);
* `PolicyTerms`, the optional policy-weighted terms (a throughput
  term and a migration term, pre-scaled by the host) that K1 adds
  after the spread term;
* the plain-PyTorch twins `score_vectors`, `limited_walk_argmax`,
  `score_and_select_twin` and `score_all_twin`, which repeat the JAX
  arithmetic op for op so that they are bit-exact against it under x64;
* `score_all`, every node's (feasible, final) with no walk (the JAX
  program `score_all`, there `:282`): kernel K11, `csrc/score_all.cu`,
  for CUDA tensors, its twin for CPU tensors;
* the public wrappers `score_and_select` and `score_and_select_packed`,
  which launch K1 for CUDA tensors and run the twin for CPU tensors;
* `walk_only`, the walk alone over a host-built score vector (the
  preemption-mode select's walk, the JAX package's
  `nomad_tpu/sched/tpu_stack.py:95 _walk_only`): kernel K6,
  `csrc/walk_only.cu`, for CUDA tensors, and its twin
  `limited_walk_argmax` for CPU tensors.

Semantics (see the JAX module for the long form): each term of the
score appends to a (sum, count) pair under the reference's append
conditions and the final score is sum/count; the walk visits feasible
nodes in `perm` order, diverts the first up to three nodes scoring <= 0,
replays them only when the source runs dry before `limit` emissions
(two diverted nodes replay reversed when a good node was emitted), and
the winner is the strict maximum, earliest emitted first.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

MAX_SKIP = 3  # (reference stack.go:17)
SKIP_THRESHOLD = 0.0  # (reference stack.go:13)
NO_NODE = -1
INT32_MAX = 2**31 - 1
# The JAX programs write `fitness / 18.0 + anti`.  XLA compiles that as
# fma(fitness, RN(1/18), anti): a division by a constant becomes a
# multiplication by its reciprocal, and the CPU backend contracts the
# multiply into the following add.  Either step can move the last bit,
# so the port computes the same fused form (`fma` below; the kernels
# call the hardware fma) to keep its scores bit-identical.
INV_18 = 1.0 / 18.0

Scalar = Union[int, float, torch.Tensor]

_INT_VIEW = {torch.float64: torch.int64, torch.float32: torch.int32}
_SPLITTER = {torch.float64: 134217729.0, torch.float32: 4097.0}  # 2^s + 1


def _two_sum(a, b):
    """s = RN(a + b) and the exact error a + b - s (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """p = RN(a * b) and the exact error a * b - p (Dekker, with
    Veltkamp splitting; exact for the score's magnitudes)."""
    split = _SPLITTER[a.dtype]

    def halves(x):
        t = x * split
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd_sum(a, b):
    """a + b rounded to odd: exact sums stay, inexact ones take the
    neighbour with an odd last bit."""
    s, e = _two_sum(a, b)
    bits = s.view(_INT_VIEW[s.dtype])
    step = torch.where((e > 0) == (s > 0), 1, -1).to(bits.dtype)
    fix = (e != 0) & ((bits & 1) == 0)
    return torch.where(fix, bits + step, bits).view(s.dtype)


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded a * b + c from separately rounded operations
    (Boldo and Melquiond's emulation through rounding to odd), so the
    plain twin matches a fused multiply-add on every device."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _round_to_odd_sum(tl, ul)


def _pow10(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Canonical 10^x for fitness scoring: the f64 pow rounded through
    float32, then widened to the working dtype (see structs/funcs.py
    _pow10).  In f64 this is the JAX program's arithmetic exactly; in
    f32 the pow is still taken in f64 so that every implementation
    (host oracle, CPU twin, CUDA kernel) rounds the same value."""
    raw = torch.pow(10.0, x.to(torch.float64))
    return raw.to(torch.float32).to(dtype)


class PolicyTerms(NamedTuple):
    """Policy-weighted terms of one select (Gavel-style throughput by
    node class and migration stickiness, `sched/policy.py`), PRE-SCALED
    by their coefficients on the host, as in the JAX package's
    `PolicyTerms`.  Each group is optional: a None group is absent and
    costs nothing.  Shapes broadcast like `feasible` ([C] for a select,
    [A, C] after the storm's per-row gather); `has_tput` like
    `desired_count` (a scalar, or [A, 1]).

    `tput_term` (coef * normalized throughput) is added for every node
    and counts `has_tput`; `mig_term` (coef * -1 off the incumbent
    nodes, 0 on them) is added for every node and counts only where it
    is non-zero.  Both adds are unconditional, as in the JAX program."""

    tput_term: Optional[torch.Tensor] = None  # f[C]
    has_tput: Optional[Scalar] = None  # f 0/1 flag paired with tput_term
    mig_term: Optional[torch.Tensor] = None  # f[C]


class ScoreInputs(NamedTuple):
    """Arena-shaped kernel inputs.  All float columns share one dtype
    (f64 on the main path, f32 allowed); `perm` is the rotated visit
    order for this select; `n_candidates` the number of real candidates
    at its front."""

    cpu_total: torch.Tensor  # [C] node capacity minus node-reserved
    mem_total: torch.Tensor  # [C]
    disk_total: torch.Tensor  # [C]
    cpu_used: torch.Tensor  # [C] proposed usage (state + plan deltas)
    mem_used: torch.Tensor  # [C]
    disk_used: torch.Tensor  # [C]
    feasible: torch.Tensor  # bool[C] all static+dynamic feasibility masks
    collisions: torch.Tensor  # i32[C] proposed allocs of same job+tg
    penalty: torch.Tensor  # bool[C] rescheduling penalty nodes
    affinity_score: torch.Tensor  # f[C] normalized affinity score
    spread_boost: torch.Tensor  # f[C] total spread boost
    perm: torch.Tensor  # i32[C] walk order: perm[i] = row at position i
    ask_cpu: Scalar  # f scalar
    ask_mem: Scalar  # f scalar
    ask_disk: Scalar  # f scalar
    desired_count: Scalar  # i32 scalar (tg.count)
    limit: Scalar  # i32 scalar (visit limit; INT32_MAX = unlimited)
    n_candidates: Scalar  # i32 scalar
    # policy-weighted scoring: None for a job without a resolved policy
    policy: Optional[PolicyTerms] = None


_COLUMNS = (
    "cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
    "disk_used", "feasible", "collisions", "penalty", "affinity_score",
    "spread_boost", "perm",
)
_FLOAT_COLUMNS = (
    "cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
    "disk_used", "affinity_score", "spread_boost",
)


def _scalar(value: Scalar, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=dtype, device=device)


def score_vectors(inp: ScoreInputs, spread_fit: bool = False):
    """Plain twin of `_score_vectors`.  Returns (feasible_after_fit
    bool[C], final_scores f[C])."""
    dtype = inp.cpu_total.dtype
    dev = inp.cpu_total.device
    ask_cpu = _scalar(inp.ask_cpu, dtype, dev)
    ask_mem = _scalar(inp.ask_mem, dtype, dev)
    ask_disk = _scalar(inp.ask_disk, dtype, dev)
    desired = _scalar(inp.desired_count, torch.int32, dev).to(dtype)

    cpu_after = inp.cpu_used + ask_cpu
    mem_after = inp.mem_used + ask_mem
    disk_after = inp.disk_used + ask_disk

    fit = (
        (cpu_after <= inp.cpu_total)
        & (mem_after <= inp.mem_total)
        & (disk_after <= inp.disk_total)
    )
    feasible = inp.feasible & fit

    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    safe_cpu_total = torch.where(inp.cpu_total > 0, inp.cpu_total, one)
    safe_mem_total = torch.where(inp.mem_total > 0, inp.mem_total, one)
    free_cpu = 1.0 - cpu_after / safe_cpu_total
    free_mem = 1.0 - mem_after / safe_mem_total
    base = _pow10(free_cpu, dtype) + _pow10(free_mem, dtype)
    if spread_fit:
        fitness = torch.clamp(base - 2.0, 0.0, 18.0)
    else:
        fitness = torch.clamp(20.0 - base, 0.0, 18.0)
    count = torch.ones_like(fitness)

    has_collision = inp.collisions > 0
    anti = torch.where(
        has_collision,
        -(inp.collisions.to(dtype) + 1.0) / desired,
        zero,
    )
    # binpack (fitness / 18) plus anti-affinity, fused as XLA fuses it
    score_sum = fma(fitness, INV_18, anti)
    count = count + has_collision.to(dtype)

    score_sum = score_sum - inp.penalty.to(dtype)
    count = count + inp.penalty.to(dtype)

    has_aff = inp.affinity_score != 0.0
    score_sum = score_sum + torch.where(has_aff, inp.affinity_score, zero)
    count = count + has_aff.to(dtype)

    has_spread = inp.spread_boost != 0.0
    score_sum = score_sum + torch.where(has_spread, inp.spread_boost, zero)
    count = count + has_spread.to(dtype)

    # policy terms last (the serial PolicyIterator sits after spread):
    # each present group is one unconditional add into the sum, with
    # only the count predicated
    pol = inp.policy
    if pol is not None:
        if pol.tput_term is not None:
            has_tput = pol.has_tput
            if not isinstance(has_tput, torch.Tensor):
                has_tput = _scalar(has_tput, dtype, dev)
            score_sum = score_sum + pol.tput_term
            count = count + has_tput
        if pol.mig_term is not None:
            score_sum = score_sum + pol.mig_term
            count = count + (pol.mig_term != 0.0).to(dtype)

    final = score_sum / count
    return feasible, final


def limited_walk_argmax(feasible, scores, perm, limit, n_candidates):
    """Plain twin of `_limited_walk_argmax`: LimitIterator +
    MaxScoreIterator over all nodes at once.  Returns (chosen_row i32,
    best f, feasible_count i32, pulls i32) as 0-d tensors."""
    dev = scores.device
    i32 = torch.int32
    limit = _scalar(limit, i32, dev)
    n_candidates = _scalar(n_candidates, i32, dev)
    perm_l = perm.long()
    s = scores[perm_l]
    f = feasible[perm_l]

    bad = f & (s <= SKIP_THRESHOLD)
    bad_rank = torch.cumsum(bad.to(i32), 0, dtype=i32)
    diverted = bad & (bad_rank <= MAX_SKIP)
    nd = f & ~diverted
    nd_cum = torch.cumsum(nd.to(i32), 0, dtype=i32)
    nd_count = nd_cum[-1]
    nd_rank = nd_cum - 1
    n_div = torch.sum(diverted.to(i32), dtype=i32)
    div_rank = torch.cumsum(diverted.to(i32), 0, dtype=i32) - 1
    # two-diverted replay reversal, only when a good node was emitted
    # before the replay (see the JAX module)
    div_order = torch.where(
        (n_div == 2) & (nd_count > 0), 1 - div_rank, div_rank
    )
    emit_order = torch.where(nd, nd_rank, nd_count + div_order)
    emitted = f & (emit_order < limit)

    neg_inf = torch.full((), -float("inf"), dtype=s.dtype, device=dev)
    masked = torch.where(emitted, s, neg_inf)
    best = torch.max(masked)
    candidates = emitted & (masked == best)
    order_key = torch.where(
        candidates, emit_order, torch.full((), INT32_MAX, dtype=i32, device=dev)
    )
    # argmin/argmax return the first index on ties
    win_pos = torch.argmin(order_key)
    chosen_row = perm[win_pos]
    any_emitted = torch.any(emitted)
    chosen_row = torch.where(
        any_emitted, chosen_row, torch.full((), NO_NODE, dtype=i32, device=dev)
    )

    limit_reached = nd_count >= limit
    lth_pos = torch.argmax((nd_cum >= limit).to(i32)).to(i32)
    pulls = torch.where(limit_reached, lth_pos + 1, n_candidates)
    return chosen_row, best, torch.sum(f.to(i32), dtype=i32), pulls


def score_and_select_twin(inp: ScoreInputs, spread_fit: bool = False):
    """Plain twin of `score_and_select`: (chosen_row, chosen_score,
    feasible_count, pulls); chosen_row == -1 when no feasible node was
    emitted."""
    feasible, final = score_vectors(inp, spread_fit)
    return limited_walk_argmax(
        feasible, final, inp.perm, inp.limit, inp.n_candidates
    )


def score_all_twin(inp: ScoreInputs, spread_fit: bool = False):
    """Plain twin of the JAX `score_all`: (feasible_after_fit bool[C],
    final_scores f[C]) with no walk, policy terms included."""
    return score_vectors(inp, spread_fit)


def score_all_cuda(inp: ScoreInputs, spread_fit: bool = False):
    """Launch K11 on the tensors' CUDA device (current stream): one
    thread per node.  Returns (feasible bool[C], final f[C]) on the
    device; nothing is synchronised."""
    from . import _cuda

    dev = _check_inputs(inp)
    if dev.type != "cuda":
        raise ValueError(f"score_all_cuda needs CUDA tensors, got {dev}")
    C = inp.cpu_total.shape[0]
    if C < 1:
        raise ValueError("score_all_cuda needs C >= 1")
    cols = {n: getattr(inp, n).contiguous() for n in _COLUMNS}
    feasible = torch.empty(C, dtype=torch.bool, device=dev)
    final = torch.empty(C, dtype=inp.cpu_total.dtype, device=dev)
    pol = inp.policy or PolicyTerms()
    _cuda.launch_score_all(
        cols, feasible, final,
        tput_term=None if pol.tput_term is None else pol.tput_term.contiguous(),
        has_tput=0.0 if pol.has_tput is None else _host_float(pol.has_tput),
        mig_term=None if pol.mig_term is None else pol.mig_term.contiguous(),
        ask=(
            _host_float(inp.ask_cpu),
            _host_float(inp.ask_mem),
            _host_float(inp.ask_disk),
        ),
        desired=_host_int(inp.desired_count),
        spread_fit=spread_fit,
    )
    score_all_cuda.launches += 1
    return feasible, final


score_all_cuda.launches = 0


def score_all(inp: ScoreInputs, spread_fit: bool = False):
    """Scores and feasibility of every node, no walk (the JAX package's
    `score_all`, for the system stack and diagnostics): K11 for CUDA
    tensors, the twin for CPU tensors."""
    dev = _check_inputs(inp)
    if dev.type == "cpu":
        return score_all_twin(inp, spread_fit)
    return score_all_cuda(inp, spread_fit)


def _check_policy(pol, C: int, dtype, dev) -> None:
    if not isinstance(pol, PolicyTerms):
        raise TypeError(f"policy must be PolicyTerms, got {type(pol).__name__}")
    for name in ("tput_term", "mig_term"):
        t = getattr(pol, name)
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"policy.{name} must be a tensor on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"policy.{name} must be {dtype}")
        if t.dim() != 1 or t.shape[0] != C:
            raise ValueError(
                f"policy.{name} must have shape [{C}], got {tuple(t.shape)}"
            )
    if (pol.tput_term is None) != (pol.has_tput is None):
        raise ValueError("policy.has_tput must come with policy.tput_term")


def _check_inputs(inp: ScoreInputs) -> torch.device:
    dev = inp.cpu_total.device
    dtype = inp.cpu_total.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"score columns must be f32 or f64, got {dtype}")
    C = inp.cpu_total.shape[0] if inp.cpu_total.dim() == 1 else -1
    for name in _COLUMNS:
        t = getattr(inp, name)
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(
                f"{name} is on {t.device}, cpu_total on {dev}"
            )
        if t.dim() != 1 or t.shape[0] != C:
            raise ValueError(f"{name} must have shape [{C}], got {tuple(t.shape)}")
    for name in _FLOAT_COLUMNS:
        if getattr(inp, name).dtype != dtype:
            raise TypeError(f"{name} must be {dtype}")
    for name in ("feasible", "penalty"):
        if getattr(inp, name).dtype != torch.bool:
            raise TypeError(f"{name} must be bool")
    for name in ("collisions", "perm"):
        if getattr(inp, name).dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if inp.policy is not None:
        _check_policy(inp.policy, C, dtype, dev)
    return dev


def _host_int(value: Scalar) -> int:
    return int(value.item()) if isinstance(value, torch.Tensor) else int(value)


def _host_float(value: Scalar) -> float:
    return float(value.item()) if isinstance(value, torch.Tensor) else float(value)


class K1Out(NamedTuple):
    """K1's device outputs.  `out_i` holds the row, the pulls, the
    feasible count (-1 where the prefix walk ran without `count`) and
    the walked positions (`walked`).  The walk scratch holds what the
    kernel scored, in walk order: for w < walked, `flags_walk[w]` is
    1 | 2 * bad where position w is feasible (0 elsewhere), and
    `scores_walk[w]` its score where feasible; checks compare those
    bit for bit with the twin's.  `route` is the launch shape the
    kernel's rule took: "grid" where limit >= n_candidates, else
    "prefix"."""

    out_i: torch.Tensor  # i32[4]: row, pulls, feasible_count, walked
    best: torch.Tensor  # f[1]
    scores_walk: torch.Tensor  # f[C]
    flags_walk: torch.Tensor  # u8[C]
    route: str


def score_select_cuda(inp: ScoreInputs, spread_fit: bool = False,
                      count: bool = True) -> K1Out:
    """Launch K1 on the tensors' CUDA device (current stream); nothing
    is synchronised.  K1 takes its prefix walk where the walk may stop
    early (limit < n_candidates) and its grid where it consumes the
    region.  `count=False` lets the prefix walk skip the feasible count
    (out_i[2] is then -1)."""
    from . import _cuda

    dev = _check_inputs(inp)
    if dev.type != "cuda":
        raise ValueError(f"score_select_cuda needs CUDA tensors, got {dev}")
    C = inp.cpu_total.shape[0]
    limit = _host_int(inp.limit)
    n_cand = _host_int(inp.n_candidates)
    if limit < 1:
        raise ValueError(f"limit must be >= 1, got {limit}")
    if not 0 <= n_cand <= C:
        raise ValueError(f"n_candidates {n_cand} outside [0, {C}]")
    cols = {n: getattr(inp, n).contiguous() for n in _COLUMNS}
    dtype = inp.cpu_total.dtype
    s_scratch = torch.empty(C, dtype=dtype, device=dev)
    f_scratch = torch.empty(C, dtype=torch.uint8, device=dev)
    out_i = torch.empty(4, dtype=torch.int32, device=dev)
    out_best = torch.empty(1, dtype=dtype, device=dev)
    pol = inp.policy or PolicyTerms()
    took = _cuda.launch_score_select(
        cols, s_scratch, f_scratch, out_i, out_best,
        tput_term=None if pol.tput_term is None else pol.tput_term.contiguous(),
        has_tput=0.0 if pol.has_tput is None else _host_float(pol.has_tput),
        mig_term=None if pol.mig_term is None else pol.mig_term.contiguous(),
        ask=(
            _host_float(inp.ask_cpu),
            _host_float(inp.ask_mem),
            _host_float(inp.ask_disk),
        ),
        desired=_host_int(inp.desired_count),
        limit=limit,
        n_candidates=n_cand,
        spread_fit=spread_fit,
        count=count,
    )
    score_select_cuda.launches += 1
    return K1Out(out_i, out_best, s_scratch, f_scratch, took)


score_select_cuda.launches = 0


def score_and_select(inp: ScoreInputs, spread_fit: bool = False):
    """(chosen_row, chosen_score, feasible_count, pulls) as 0-d tensors
    on the inputs' device: K1 for CUDA tensors, the twin for CPU
    tensors."""
    dev = _check_inputs(inp)
    if dev.type == "cpu":
        return score_and_select_twin(inp, spread_fit)
    out = score_select_cuda(inp, spread_fit)
    return out.out_i[0], out.best[0], out.out_i[2], out.out_i[1]


def score_and_select_packed(inp: ScoreInputs, spread_fit: bool = False):
    """score_and_select packed into ONE i32[2] tensor ([chosen_row,
    pulls]) so the host pays a single device->host copy per select; the
    kernel skips the feasible count, which this select does not read."""
    dev = _check_inputs(inp)
    if dev.type == "cpu":
        row, _best, _n, pulls = score_and_select_twin(inp, spread_fit)
        return torch.stack([row.to(torch.int32), pulls.to(torch.int32)])
    return score_select_cuda(inp, spread_fit, count=False).out_i[:2]


def _check_walk(feasible, scores, perm) -> torch.device:
    dev = scores.device
    if scores.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scores must be f32 or f64, got {scores.dtype}")
    if feasible.dtype != torch.bool:
        raise TypeError(f"feasible must be bool, got {feasible.dtype}")
    if perm.dtype != torch.int32:
        raise TypeError(f"perm must be int32, got {perm.dtype}")
    C = scores.shape[0] if scores.dim() == 1 else -1
    for name, t in (("feasible", feasible), ("perm", perm)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, scores on {dev}")
        if t.dim() != 1 or t.shape[0] != C:
            raise ValueError(
                f"{name} must have shape [{C}], got {tuple(t.shape)}"
            )
    return dev


def walk_only_cuda(feasible, scores, perm, limit, n_candidates,
                   count: bool = True):
    """Launch K6 on the tensors' CUDA device (current stream): the
    limited walk over a host-built score vector.  Returns the int64[4]
    result buffer ([row, feasible_count, pulls, bits of best]) on the
    card; nothing is synchronised.  K6 takes its prefix walk where the
    walk may stop early (limit < n_candidates) and its grid where it
    consumes the region; `count=False` lets the prefix walk skip the
    feasible count ([1] is then -1; the grid always counts).
    `walk_only_cuda.route` is the shape the last launch took ("prefix"
    or "grid")."""
    from . import _cuda

    dev = _check_walk(feasible, scores, perm)
    if dev.type != "cuda":
        raise ValueError(f"walk_only_cuda needs CUDA tensors, got {dev}")
    C = scores.shape[0]
    limit = _host_int(limit)
    n_cand = _host_int(n_candidates)
    if C < 1:
        raise ValueError("walk_only_cuda needs at least one position")
    if limit < 1:
        raise ValueError(f"limit must be >= 1, got {limit}")
    if not 0 <= n_cand <= C:
        raise ValueError(f"n_candidates {n_cand} outside [0, {C}]")
    out = torch.empty(4, dtype=torch.int64, device=dev)
    walk_only_cuda.route = _cuda.launch_walk_only(
        feasible.contiguous(), scores.contiguous(), perm.contiguous(), out,
        limit=limit, n_candidates=n_cand, count=count,
    )
    walk_only_cuda.launches += 1
    return out


walk_only_cuda.launches = 0
walk_only_cuda.route = ""


def unpack_walk(buf: torch.Tensor, dtype: torch.dtype):
    """K6's int64[4] result (on the host) as (chosen_row, best,
    feasible_count, pulls) Python numbers."""
    raw = buf.numpy()
    if dtype == torch.float64:
        best = float(raw[3:4].view(np.float64)[0])
    else:
        best = float(raw[3:4].astype(np.uint32).view(np.float32)[0])
    return int(raw[0]), best, int(raw[1]), int(raw[2])


def walk_only(feasible, scores, perm, limit, n_candidates,
              count: bool = True):
    """(chosen_row, best, feasible_count, pulls) as Python numbers: K6
    for CUDA tensors, fetched with one device->host copy; the twin
    `limited_walk_argmax` for CPU tensors.  `count=False` is for a
    caller that does not read the feasible count (the preemption loop):
    K6's prefix walk then skips it and gives -1 (its grid and the twin
    give the count)."""
    dev = _check_walk(feasible, scores, perm)
    if dev.type == "cpu":
        row, best, n, pulls = limited_walk_argmax(
            feasible, scores, perm, limit, n_candidates
        )
        return int(row), float(best), int(n), int(pulls)
    buf = walk_only_cuda(feasible, scores, perm, limit, n_candidates, count)
    return unpack_walk(buf.cpu(), scores.dtype)


def make_perm(rng, rows, capacity: int) -> np.ndarray:
    """Walk order matching the oracle's seeded Fisher-Yates shuffle
    (sched/feasible.py shuffle_nodes) applied to the same candidate list:
    perm[i] = arena row visited at walk position i.  Arena rows not in the
    candidate list are appended at the end; they are masked infeasible and
    can never win, but keep the perm a full permutation of the arena."""
    rows = list(rows)
    for i in range(len(rows) - 1, 0, -1):
        j = rng.randint(0, i)
        rows[i], rows[j] = rows[j], rows[i]
    present = set(rows)
    rows.extend(r for r in range(capacity) if r not in present)
    return np.asarray(rows, dtype=np.int32)
