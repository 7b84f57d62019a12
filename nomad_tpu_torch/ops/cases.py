"""Seeded edge-case inputs for kernels K1 (one select) and K2 (the pick
scan), as numpy dicts keyed by the JAX programs' field names.

Both the CPU tests (port twin against the JAX programs) and
`chip_smoke.py` (kernel against twin on the card) draw from here, so
every case the card checks is one the CPU suite also checks at a
smaller width.  numpy only; `state/convert.py` turns a case into
tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

INT32_MAX = 2**31 - 1

# (n_bad, n_good): bad nodes score <= 0 (penalty and negative affinity)
# and are diverted up to three at a time; 4 bad means one bad node is
# emitted in order.  (0, 0) is the all-infeasible walk.
SCORE_SCENARIOS: Dict[str, Tuple[int, int]] = {
    "div0": (0, 40),
    "div1": (1, 40),
    "div2": (2, 40),
    "div4": (4, 40),
    "div1_nogood": (1, 0),
    "div2_nogood": (2, 0),
    "div4_nogood": (4, 0),
    "all_infeasible": (0, 0),
    "mixed": (-1, -1),  # every term at random: collisions, penalty,
                        # affinity, spread boost, ties, overfull nodes
}

ASK = (500.0, 256.0, 300.0)


def _capacity(rng, C):
    cpu_total = rng.choice([2000.0, 4000.0, 8000.0, 16000.0], C)
    mem_total = rng.choice([4096.0, 8192.0, 16384.0], C)
    disk_total = rng.choice([50000.0, 100000.0], C)
    # used leaves room for the ask on every node (good nodes stay
    # strictly inside capacity, so binpack > 0 and scores stay > 0)
    cpu_used = np.floor(
        rng.uniform(0.05, 0.85, C) * (cpu_total - ASK[0]) / 100.0
    ) * 100.0
    mem_used = np.floor(
        rng.uniform(0.05, 0.85, C) * (mem_total - ASK[1]) / 64.0
    ) * 64.0
    disk_used = np.floor(rng.uniform(0.0, 0.5, C) * disk_total)
    return cpu_total, mem_total, disk_total, cpu_used, mem_used, disk_used


def _tie_groups(rng, rows, cols, n_groups=4):
    """Copy one node's totals and usage onto a few others so their
    scores tie: the winner must be the earliest emitted."""
    rows = np.asarray(rows)
    if len(rows) < 2:
        return
    for _ in range(n_groups):
        src, *dst = rng.choice(rows, size=min(4, len(rows)), replace=False)
        for col in cols:
            col[dst] = col[src]


def score_case(seed: int, C: int, n_cand: int, scenario: str,
               limit: int, desired: int = 10) -> Dict:
    """One K1 input.  Candidates are the first `n_cand` walk positions
    of a random permutation; the rest are vacant arena rows."""
    rng = np.random.default_rng(seed)
    n_bad, n_good = SCORE_SCENARIOS[scenario]
    (cpu_total, mem_total, disk_total,
     cpu_used, mem_used, disk_used) = _capacity(rng, C)
    perm = rng.permutation(C).astype(np.int32)
    cand = perm[:n_cand]
    feasible = np.zeros(C, dtype=bool)
    collisions = np.zeros(C, dtype=np.int32)
    penalty = np.zeros(C, dtype=bool)
    affinity = np.zeros(C, dtype=np.float64)
    spread = np.zeros(C, dtype=np.float64)
    if scenario == "mixed":
        feasible[cand] = rng.random(n_cand) < 0.7
        collisions[cand] = rng.integers(0, 4, n_cand) * (
            rng.random(n_cand) < 0.3
        )
        penalty[cand] = rng.random(n_cand) < 0.05
        affinity[cand] = np.where(
            rng.random(n_cand) < 0.3, rng.uniform(-1.0, 1.0, n_cand), 0.0
        )
        spread[cand] = np.where(
            rng.random(n_cand) < 0.3, rng.uniform(-1.0, 1.0, n_cand), 0.0
        )
        # overfull: fails the fit mask although statically feasible
        over = rng.choice(cand, size=max(1, n_cand // 20), replace=False)
        cpu_used[over] = cpu_total[over]
        # zero totals exercise the safe-divisor path
        zero = rng.choice(cand, size=max(1, n_cand // 50), replace=False)
        cpu_total[zero] = 0.0
        _tie_groups(
            rng, cand[feasible[cand]],
            [cpu_total, mem_total, disk_total, cpu_used, mem_used,
             disk_used, collisions, penalty, affinity, spread],
        )
    else:
        picked = rng.choice(cand, size=n_bad + n_good, replace=False)
        bad, good = picked[:n_bad], picked[n_bad:]
        feasible[picked] = True
        penalty[bad] = True
        affinity[bad] = -1.0
        affinity[good] = np.where(
            rng.random(len(good)) < 0.3, rng.uniform(0.1, 1.0, len(good)), 0.0
        )
        spread[good] = np.where(
            rng.random(len(good)) < 0.3, rng.uniform(0.0, 0.5, len(good)), 0.0
        )
        _tie_groups(
            rng, good,
            [cpu_total, mem_total, disk_total, cpu_used, mem_used,
             disk_used, affinity, spread],
        )
    return dict(
        cpu_total=cpu_total, mem_total=mem_total, disk_total=disk_total,
        cpu_used=cpu_used, mem_used=mem_used, disk_used=disk_used,
        feasible=feasible, collisions=collisions, penalty=penalty,
        affinity_score=affinity, spread_boost=spread, perm=perm,
        ask_cpu=ASK[0], ask_mem=ASK[1], ask_disk=ASK[2],
        desired_count=desired, limit=limit, n_candidates=n_cand,
    )


# (distinct_hosts, tight): tight gives the group room for a few picks
# only, so it runs out of room part way and the rest are inert
BATCH_SCENARIOS: Dict[str, Tuple[bool, bool]] = {
    "plain": (False, False),
    "distinct_hosts": (True, False),
    "out_of_room": (False, True),
    "distinct_out_of_room": (True, True),
}


def batch_case(seed: int, C: int, n_cand: int, scenario: str,
               limit: int, n_picks: int) -> Tuple[Dict, Dict]:
    """One K2 input: (node columns {cpu_total, mem_total, disk_total},
    BatchInputs fields).  Only candidate rows are feasible (the walk's
    tail carries nothing), some carry collisions from the job's live
    allocs, a few are penalized or have affinity."""
    rng = np.random.default_rng(seed)
    distinct_hosts, tight = BATCH_SCENARIOS[scenario]
    (cpu_total, mem_total, disk_total,
     cpu_used, mem_used, disk_used) = _capacity(rng, C)
    perm = rng.permutation(C).astype(np.int32)
    cand = perm[:n_cand]
    feasible = np.zeros(C, dtype=bool)
    feasible[cand] = rng.random(n_cand) < 0.8
    collisions = np.zeros(C, dtype=np.int32)
    collisions[cand] = rng.integers(0, 3, n_cand) * (rng.random(n_cand) < 0.2)
    penalty = np.zeros(C, dtype=bool)
    penalty[cand] = rng.random(n_cand) < 0.03
    affinity = np.zeros(C, dtype=np.float64)
    affinity[cand] = np.where(
        rng.random(n_cand) < 0.2, rng.uniform(-0.5, 1.0, n_cand), 0.0
    )
    if tight:
        # room for about n_picks / 4 asks in all
        roomy = rng.choice(cand, size=max(1, n_picks // 8), replace=False)
        cpu_used[cand] = cpu_total[cand] - ASK[0] / 2
        cpu_used[roomy] = cpu_total[roomy] - 2 * ASK[0]
    _tie_groups(
        rng, cand[feasible[cand]],
        [cpu_total, mem_total, disk_total, cpu_used, mem_used, disk_used,
         collisions, penalty, affinity],
    )
    cols = dict(cpu_total=cpu_total, mem_total=mem_total,
                disk_total=disk_total)
    inp = dict(
        feasible=feasible, base_cpu_used=cpu_used, base_mem_used=mem_used,
        base_disk_used=disk_used, base_collisions=collisions,
        penalty=penalty, affinity_score=affinity, perm=perm,
        ask_cpu=ASK[0], ask_mem=ASK[1], ask_disk=ASK[2],
        desired_count=n_picks, limit=limit, distinct_hosts=distinct_hosts,
    )
    return cols, inp
