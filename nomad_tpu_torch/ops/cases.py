"""Seeded edge-case inputs for the kernels — K1 (one select, with and
without policy terms) and K11 (its scores alone), K2 (the pick scan), K3
(the chained planner), K5 (the storm solve, unweighted and weighted), K6
(the walk alone), K7 (E independent pick scans over one snapshot), and
K9/K10 (the chained and independent planners over per-eval
BatchInputs) — as numpy dicts keyed by the JAX programs' field names.

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


def _policy_rows(rng, n: int, C: int, tput, mig):
    """Pre-scaled policy term rows, as `sched/policy.py` stages them
    (coef * the normalized throughput of the node's class; coef * -1 off
    a few incumbent nodes, 0 on them): (tput_term [n, C], has_tput [n],
    mig_term [n, C]), rows of zeros where `tput`/`mig` [n] is False.
    Node classes are three with a throughput table plus an unknown one
    (0), and a quarter of the coefficients are negative, so the rows
    hold -0.0 where a negative coefficient meets a 0."""
    table = rng.uniform(0.5, 4.0, 3)
    norm = np.concatenate([table / table.max(), [0.0]])
    cls = rng.integers(0, 4, C)
    sign = np.where(rng.random((2, n)) < 0.25, -1.0, 1.0)
    tput_coef = sign[0] * rng.uniform(0.25, 2.0, n)
    mig_coef = sign[1] * rng.uniform(0.1, 1.0, n)
    tput_term = np.zeros((n, C))
    mig_term = np.zeros((n, C))
    for i in range(n):
        if tput[i]:
            tput_term[i] = tput_coef[i] * norm[cls]
        if mig[i]:
            vec = np.full(C, -1.0)
            vec[rng.choice(C, size=max(1, C // 64), replace=False)] = 0.0
            mig_term[i] = mig_coef[i] * vec
    return tput_term, np.asarray(tput, np.float64), mig_term


# K1's launch shapes at their edges (csrc/score_select.cu: its rule sends
# limit >= n_candidates to the grid, a lower limit to the prefix walk):
# (scenario, limit, n_candidates, or None for the caller's).  To the
# grid: a whole-region select; a few candidates at the front of a large
# arena; two diverted nodes behind good ones and alone; four bad nodes
# and no good one (three diverted, one emitted); a limit equal to the
# candidates, every one feasible and good ("all_good"), so the limit-th
# non-diverted position ends the walk in a later block.  To the prefix
# walk: a limited walk that runs long (40 feasible nodes, limit 14); a
# few candidates, limited; four bad nodes; two diverted nodes behind
# fewer good ones than the limit and alone, so the walk consumes the
# region; a limit one below the candidates, every one good.
SELECT_EDGES: Dict[str, Tuple[str, int, object]] = {
    "whole_region": ("mixed", INT32_MAX, None),
    "few_cand_whole": ("mixed", INT32_MAX, 300),
    "two_diverted": ("div2", INT32_MAX, None),
    "two_diverted_alone": ("div2_nogood", INT32_MAX, None),
    "all_bad_whole": ("div4_nogood", INT32_MAX, None),
    "limit_is_cands": ("all_good", 300, 300),
    "long_limited": ("div0", 14, None),
    "few_cand_limited": ("mixed", 14, 300),
    "all_bad": ("div4_nogood", 14, None),
    "two_diverted_limited": ("div2", 64, None),
    "two_diverted_alone_limited": ("div2_nogood", 14, None),
    "limit_below_cands": ("all_good", 299, 300),
}


def select_edge_case(seed: int, C: int, n_cand: int, edge: str) -> Dict:
    """One K1 input at a launch-shape edge (`SELECT_EDGES`)."""
    scenario, limit, n = SELECT_EDGES[edge]
    n = n_cand if n is None else n
    if scenario != "all_good":
        return score_case(seed, C, n, scenario, limit)
    # every candidate statically feasible; each fits and scores > 0
    case = score_case(seed, C, n, "all_infeasible", limit)
    case["feasible"][case["perm"][:n]] = True
    return case


# K1 with a policy: which groups the select carries.  "inert" is a
# policy job whose groups are both inert (armed coefficients, no live
# allocs yet): no PolicyTerms, but the unlimited walk all the same.
POLICY_SCORE_SCENARIOS: Dict[str, Tuple[bool, bool]] = {
    "tput": (True, False),
    "mig": (False, True),
    "both": (True, True),
    "inert": (False, False),
}


def policy_score_case(seed: int, C: int, n_cand: int, scenario: str,
                      limit: int) -> Dict:
    """One K1 input of a policy-weighted select: `score_case`'s "mixed"
    scenario plus a "policy" entry {tput_term, has_tput, mig_term}
    (None for an absent group; the entry itself None for "inert")."""
    case = score_case(seed, C, n_cand, "mixed", limit)
    rng = np.random.default_rng(seed + 1)
    has_t, has_m = POLICY_SCORE_SCENARIOS[scenario]
    tput, has, mig = _policy_rows(rng, 1, C, [has_t], [has_m])
    case["policy"] = None if not (has_t or has_m) else dict(
        tput_term=tput[0] if has_t else None,
        has_tput=float(has[0]) if has_t else None,
        mig_term=mig[0] if has_m else None,
    )
    return case


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


# ---------------------------------------------------------------------------
# chained scenarios (kernel K3): each option of the chained planner on its
# own and in combination
# ---------------------------------------------------------------------------

CHAIN_OPTIONS = (
    "groups",      # T = 2: per-pick group routing, per-group asks/limits
    "spread_pct",  # percent-target spread stanzas
    "spread_even",  # even spread stanzas
    "evict",       # step evictions, penalty rows and pre-deltas
    "ports",       # static ports, most candidates already taken
    "devices",     # device asks, device affinity
    "occ_dh",      # occ0 (pickless groups) and group-level distinct_hosts
    "wanted",      # wanted < P
    "tight",       # little room: picks fail part way through an eval
    "few_cand",    # n_candidates well below C, varying per eval
    "job_dh",      # job-level distinct_hosts
)
CHAIN_SCENARIOS: Dict[str, Tuple[str, ...]] = {
    "plain": (),
    **{opt: (opt,) for opt in CHAIN_OPTIONS},
    "spread_mixed_groups": ("groups", "spread_pct", "spread_even"),
    "evict_spread": ("evict", "spread_pct", "wanted"),
    "ports_devices_groups": ("groups", "ports", "devices", "occ_dh"),
    "everything": CHAIN_OPTIONS,
    # T = 128 group slots (a job of 65-128 task groups), the picks
    # spread over them in group order; little room, so groups fail
    "wide_groups": ("wide_groups", "tight"),
}
MAX_PENALTY_NODES = 8


def chain_case(seed: int, C: int, n_cand: int, scenario: str, E: int,
               P: int) -> Tuple[Dict, Dict]:
    """One K3 input: (node columns {cpu_total, mem_total, disk_total,
    used0_cpu, used0_mem, used0_disk}, keyword inputs of
    chained_plan_picks_cols as numpy, NamedTuple fields as dicts).
    Usage and asks carry fractional parts, so the order in which the
    carry adds them shows in the last bits."""
    return _chain_case(seed, C, n_cand, set(CHAIN_SCENARIOS[scenario]), E,
                       P)


def _chain_case(seed: int, C: int, n_cand: int, opts, E: int,
                P: int) -> Tuple[Dict, Dict]:
    rng = np.random.default_rng(seed)
    T = 128 if "wide_groups" in opts else 2 if "groups" in opts else 1
    cpu_total, mem_total, disk_total, cpu_used, mem_used, disk_used = (
        _capacity(rng, C)
    )
    cpu_used = cpu_used + rng.uniform(0.0, 1.0, C)
    mem_used = mem_used + rng.uniform(0.0, 1.0, C)
    n_cands = np.full(E, n_cand, np.int32)
    if "few_cand" in opts:
        n_cands = rng.integers(max(2, n_cand // 8), n_cand + 1, E).astype(
            np.int32
        )
    perm = np.stack([rng.permutation(C) for _ in range(E)]).astype(np.int32)
    roomy = None
    if "tight" in opts:
        # no room for any ask but on a few candidates of each eval,
        # which take one to four picks each
        cpu_used = cpu_total - 0.4 * ASK[0]
        roomy = np.unique(np.concatenate([
            rng.choice(perm[e, : n_cands[e]], size=max(1, P // 4))
            for e in range(E)
        ]))
        cpu_used[roomy] = (
            cpu_total[roomy] - rng.uniform(1.0, 4.0, len(roomy)) * ASK[0]
        )
    feasible = np.zeros((E, T, C), dtype=bool)
    for e in range(E):
        cand = perm[e, : n_cands[e]]
        for t in range(T):
            feasible[e, t, cand] = rng.random(n_cands[e]) < 0.85
    ask = np.empty((3, E, P))
    ask_t = rng.uniform(0.5, 1.5, (3, E, T)) * np.asarray(ASK)[:, None, None]
    ask_t = np.round(ask_t, 1) + 0.05
    if T == 2:
        tg_idx = (np.arange(P)[None, :] >= rng.integers(1, P, E)[:, None])
        tg_idx = tg_idx.astype(np.int32)
    elif T > 2:
        tg_idx = np.sort(rng.integers(0, T, (E, P)), axis=1).astype(np.int32)
    else:
        tg_idx = np.zeros((E, P), np.int32)
    for i in range(3):
        ask[i] = np.take_along_axis(ask_t[i], tg_idx, axis=1)
    desired_t = rng.integers(1, 2 * P, (E, T))
    limit_t = np.where(
        rng.random((E, T)) < 0.5, INT32_MAX, rng.integers(2, 20, (E, T))
    )
    if "unlimited" in opts:  # (K9's long walks only) every limit INT32_MAX
        limit_t[:] = INT32_MAX
    batch = dict(
        feasible=feasible, perm=perm, ask_cpu=ask[0], ask_mem=ask[1],
        ask_disk=ask[2],
        desired_count=np.take_along_axis(desired_t, tg_idx, 1).astype(np.int32),
        limit=np.take_along_axis(limit_t, tg_idx, 1).astype(np.int32),
        distinct_hosts=(
            rng.random(E) < 0.5 if "job_dh" in opts else np.zeros(E, bool)
        ),
        tg_idx=tg_idx,
    )
    wanted = np.full(E, P, np.int32)
    if "wanted" in opts:
        wanted = rng.integers(0, P + 1, E).astype(np.int32)
    coll0 = np.zeros((E, T, C), np.int32)
    affinity = np.zeros((E, T, C))
    for e in range(E):
        cand = perm[e, : n_cands[e]]
        for t in range(T):
            coll0[e, t, cand] = rng.integers(0, 3, len(cand)) * (
                rng.random(len(cand)) < 0.1
            )
            affinity[e, t, cand] = np.where(
                rng.random(len(cand)) < 0.2,
                rng.uniform(-0.5, 1.0, len(cand)), 0.0,
            )
    kw = dict(
        batch=batch, n_candidates=n_cands, n_picks=P, wanted=wanted,
        coll0=coll0, affinity=affinity,
    )
    # ties: copy a few nodes' capacity and usage onto others
    _tie_groups(rng, perm[0, : n_cands[0]],
                [cpu_total, mem_total, disk_total, cpu_used, mem_used,
                 disk_used])
    if "spread_pct" in opts or "spread_even" in opts:
        S, V1 = 4, 8
        modes = []
        if "spread_pct" in opts:
            modes += [False, False]
        if "spread_even" in opts:
            modes += [True, True]
        codes = np.zeros((E, S, C), np.int32)
        desired = np.zeros((E, S, V1))
        used0 = np.zeros((E, S, V1))
        prop0 = np.zeros((E, S, V1))
        clr0 = np.zeros((E, S, V1))
        weight = np.zeros((E, S))
        active = np.zeros((E, S), bool)
        even = np.zeros((E, S), bool)
        group = np.zeros((E, S), np.int32)
        for e in range(E):
            for s, ev_mode in enumerate(modes[:S]):
                nv = rng.integers(2, V1)
                # a few nodes lack the attribute: the penalty slot
                c = rng.integers(0, nv, C)
                c[rng.random(C) < 0.05] = V1 - 1
                codes[e, s] = c
                if not ev_mode:
                    desired[e, s, :nv] = rng.integers(0, 3 * P, nv)
                    weight[e, s] = rng.choice([0.25, 1.0 / 3.0, 0.5, 0.7])
                used0[e, s, :nv] = rng.integers(0, 4, nv) * (
                    rng.random(nv) < 0.7
                )
                prop0[e, s, :nv] = rng.integers(0, 2, nv) * (
                    rng.random(nv) < 0.3
                )
                clr0[e, s, :nv] = rng.integers(0, 3, nv) * (
                    rng.random(nv) < 0.3
                )
                active[e, s] = True
                even[e, s] = ev_mode
                group[e, s] = s % T
        kw["spread"] = dict(
            codes=codes, desired=desired, used0=used0, proposed0=prop0,
            cleared0=clr0, weight=weight, active=active,
            even=even if even.any() else None,
            group=group if T > 1 else None,
        )
    if "evict" in opts:
        K = MAX_PENALTY_NODES
        evict_rows = np.full((E, P), -1, np.int32)
        hit = rng.random((E, P)) < 0.3
        evict_rows[hit] = rng.integers(0, C, hit.sum())
        # some evictions land on a candidate the eval will pick again
        evict_rows[:, 0] = perm[:, 0]
        evict = -rng.uniform(0.5, 1.0, (3, E, P)) * np.asarray(ASK)[:, None, None]
        evict = np.where(evict_rows[None] >= 0, np.round(evict, 2), 0.0)
        evict_coll = np.where(
            evict_rows >= 0, -(rng.random((E, P)) < 0.5).astype(np.int32), 0
        ).astype(np.int32)
        penalty_rows = np.full((E, P, K), -1, np.int32)
        for e in range(E):
            for k in range(P):
                n_pen = rng.integers(0, 4)
                penalty_rows[e, k, :n_pen] = perm[e, rng.integers(
                    0, n_cands[e], n_pen)]
        kw["deltas"] = dict(
            evict_rows=evict_rows, evict_cpu=evict[0], evict_mem=evict[1],
            evict_disk=evict[2], evict_coll=evict_coll,
            penalty_rows=penalty_rows,
        )
        R = 16
        pre_rows = np.zeros((E, R), np.int32)
        pre = np.zeros((3, E, R))
        for e in range(E):
            n_pre = rng.integers(1, R)
            pre_rows[e, :n_pre] = np.sort(
                rng.choice(C, n_pre, replace=False)
            )
            pre[:, e, :n_pre] = np.round(
                rng.uniform(-1.0, 0.3, (3, n_pre))
                * np.asarray(ASK)[:, None], 3
            )
        kw["pre"] = dict(rows=pre_rows, cpu=pre[0], mem=pre[1], disk=pre[2])
    if "ports" in opts:
        Q = 4
        port_ask = rng.random((E, T, Q)) < 0.5
        port_ask[:, :, 0] = True
        port_used0 = rng.random((Q, C)) < 0.5
        # port 0 is taken almost everywhere: the picks exhaust it
        port_used0[0] = rng.random(C) < 0.98
        if roomy is not None:
            port_used0[0, roomy] = False
        kw["port_ask"] = port_ask
        kw["port_used0"] = port_used0
    if "devices" in opts:
        D = 2
        kw["dev_ask"] = rng.integers(0, 3, (E, T, D)).astype(np.int32)
        kw["dev_free0"] = rng.integers(0, 5, (D, C)).astype(np.int32)
        if roomy is not None:
            kw["dev_free0"][:, roomy] = 4
        kw["dev_aff"] = np.where(
            rng.random((E, T, C)) < 0.5, rng.uniform(0.0, 1.0, (E, T, C)),
            0.0,
        )
        kw["dev_aff_on"] = rng.random((E, T)) < 0.7
    if "occ_dh" in opts:
        kw["occ0"] = (rng.random((E, C)) < 0.1).astype(np.int32)
        kw["dh_tg"] = rng.random((E, T)) < 0.5
    cols = dict(
        cpu_total=cpu_total, mem_total=mem_total, disk_total=disk_total,
        used0_cpu=cpu_used, used0_mem=mem_used, used0_disk=disk_used,
    )
    return cols, kw


# ---------------------------------------------------------------------------
# per-eval BatchInputs (kernels K9 and K10): the chained and the
# independent planner of the benchmark's kernel-only phase
# ---------------------------------------------------------------------------

# chain_case's single-group options, on their own and together
BATCHED_SCENARIOS: Dict[str, Tuple[str, ...]] = {
    "plain": (),
    "spread": ("spread_pct", "spread_even"),
    "evict_spread": ("evict", "spread_pct", "wanted"),
    "tight": ("tight",),
    "few_cand": ("few_cand",),
    "job_dh": ("job_dh",),
    "everything": ("spread_pct", "spread_even", "evict", "wanted", "tight",
                   "few_cand", "job_dh"),
    # long walks: every pick consumes its region, with the score cache
    # (step deltas and pre-deltas, no spread) and without it (spread too)
    "unlimited_evict": ("evict", "unlimited"),
    "unlimited_spread_evict": ("spread_pct", "spread_even", "evict",
                               "unlimited"),
}


def batched_case(seed: int, C: int, n_cand: int, scenario: str, E: int,
                 P: int) -> Tuple[Dict, Dict]:
    """One K9/K10 input: (node columns {cpu_total, mem_total,
    disk_total}, keyword inputs of `chained_plan_picks` as numpy:
    `batch` (BatchInputs fields with a leading E: [E, C] columns, [E]
    scalars), `n_candidates` [E], `n_picks`, `wanted` [E] and the
    optional `spread`, `deltas` and `pre` dicts).  It is `chain_case`
    with one group, plus a static penalty column per eval and a base
    usage per eval: row 0 is the chain's start, the other rows differ
    from it (the chained planner must not read them; the independent
    one scores each eval against its own)."""
    cols, kw = _chain_case(seed, C, n_cand, set(BATCHED_SCENARIOS[scenario]),
                           E, P)
    rng = np.random.default_rng(seed + 1)
    b = kw.pop("batch")
    perm = b["perm"]
    n_cands = kw["n_candidates"]
    penalty = np.zeros((E, C), dtype=bool)
    base = {}
    for name, col in (("cpu", "used0_cpu"), ("mem", "used0_mem"),
                      ("disk", "used0_disk")):
        used = np.repeat(cols.pop(col)[None], E, axis=0)
        used[1:] += np.round(rng.uniform(0.0, 50.0, (E - 1, C)), 2)
        base[f"base_{name}_used"] = used
    for e in range(E):
        cand = perm[e, : n_cands[e]]
        penalty[e, cand] = rng.random(len(cand)) < 0.05
    kw["batch"] = dict(
        feasible=b["feasible"][:, 0], **base,
        base_collisions=kw.pop("coll0")[:, 0], penalty=penalty,
        affinity_score=kw.pop("affinity")[:, 0], perm=perm,
        ask_cpu=b["ask_cpu"][:, 0].copy(), ask_mem=b["ask_mem"][:, 0].copy(),
        ask_disk=b["ask_disk"][:, 0].copy(),
        desired_count=b["desired_count"][:, 0].copy(),
        limit=b["limit"][:, 0].copy(), distinct_hosts=b["distinct_hosts"],
    )
    return cols, kw


def batched_cache_case(seed: int, C: int, n_cand: int, E: int,
                       P: int) -> Tuple[Dict, Dict]:
    """A `batched_case` "unlimited_evict" whose every eval meets each
    rule of K9's score cache on its long walks: each pick's first
    penalty row is a position the walks have scored; a full node (scored
    infeasible) is emptied by the eviction before pick 3 and has the
    best affinity, so under worst fit (spread_fit) it wins pick 3, which
    a stale cache would miss."""
    cols, kw = batched_case(seed, C, n_cand, "unlimited_evict", E, P)
    b, dl = kw["batch"], kw["deltas"]
    for e in range(E):
        dl["penalty_rows"][e, 1:, 0] = b["perm"][e, 5]
        r = int(b["perm"][e, 7])
        b["feasible"][e, r] = True
        b["affinity_score"][e] = np.minimum(b["affinity_score"][e], 0.5)
        b["affinity_score"][e, r] = 1.0
        b["base_collisions"][e, r] = 0
        b["penalty"][e, r] = False
        for col in ("cpu", "mem"):
            b[f"base_{col}_used"][0, r] = cols[f"{col}_total"][r]
            dl[f"evict_{col}"][e, 3] = -cols[f"{col}_total"][r]
        dl["evict_rows"][e, 3] = r
    return cols, kw


def tiled_batched(q: Dict, tiles: int) -> Dict:
    """`ops.batch.prepare_batched` inputs with every per-eval tensor
    repeated `tiles` times along the eval axis (the node columns
    shared): K10's rows and pulls for them are its rows and pulls for
    `q`, repeated, however many of the evals' blocks run at once."""
    def tile(x):
        if x is None or x.dim() == 0:
            return x
        return x.repeat(tiles, *([1] * (x.dim() - 1))).contiguous()

    spread = q["spread"]
    return dict(q, E=q["E"] * tiles, n_cand=tile(q["n_cand"]),
                wanted=tile(q["wanted"]),
                batch=type(q["batch"])(*map(tile, q["batch"])),
                spread=None if spread is None
                else type(spread)(*map(tile, spread)))


# storm solver (K5) scenarios; each case carries its own round budget
STORM_SCENARIOS = (
    "uncontended",  # room for every row: the warm start is the answer
    "dogpile",  # one shared walk order over a few tight nodes
    "infeasible_rows",  # evals with no feasible node, rows too big
    "padding_rows",  # a padded tail of rows that are never assigned
    "one_row",  # A = 1: the degenerate storm is the serial walk
    "round_budget1",  # the dogpile cut after one round
    "round_budget2",  # ... and after two: rows end unsolved
    "ties",  # identical nodes, so the jitter picks among them
    "penalty_affinity_collisions",  # every per-row score term
    "pre_deltas",  # fractional usage and staged pre-placement deltas
)
_STORM_ASKS = ((500.0, 256.0, 300.0), (1000.0, 1024.0, 300.0),
               (2000.0, 4096.0, 500.0))


def storm_case(seed: int, E: int, A: int, C: int, scenario: str):
    """One K5 input as numpy, f64: (node columns {cpu_total, mem_total,
    disk_total, cpu_used, mem_used, disk_used}, StormInputs fields,
    max_rounds).  Rows are spread over the evals in order, each eval's
    rows sharing its ask, count, walk order and visit limit, as the
    batch worker stages a storm.  Asks are whole MHz and MB, as
    Nomad's are, except in `pre_deltas`, whose fractional asks make
    the order of the per-node debit's additions visible."""
    rng = np.random.default_rng(seed)
    if scenario == "one_row":
        E = A = 1
    E = max(1, min(E, A))
    contended = scenario in ("dogpile", "round_budget1", "round_budget2",
                             "ties")
    cpu_total = rng.choice([4000.0, 8000.0, 16000.0], C)
    mem_total = rng.choice([8192.0, 16384.0, 32768.0], C)
    disk_total = rng.choice([50000.0, 100000.0], C)
    cpu_used = np.floor(rng.uniform(0.0, 0.6, C) * cpu_total / 100.0) * 100.0
    mem_used = np.floor(rng.uniform(0.0, 0.6, C) * mem_total / 64.0) * 64.0
    disk_used = np.floor(rng.uniform(0.0, 0.3, C) * disk_total)
    pre = np.zeros((3, C))
    if scenario == "uncontended":
        cpu_used = np.floor(cpu_used / 4.0 / 100.0) * 100.0
        mem_used = np.floor(mem_used / 4.0 / 64.0) * 64.0
    if scenario == "ties":
        cpu_total[:] = 4000.0
        mem_total[:] = 8192.0
        disk_total[:] = 50000.0
        cpu_used[:] = 0.0
        mem_used[:] = 0.0
        disk_used[:] = 0.0
    if scenario == "pre_deltas":
        cpu_used += rng.uniform(0.0, 1.0, C)
        mem_used += rng.uniform(0.0, 1.0, C)
        disk_used += rng.uniform(0.0, 1.0, C)
        hit = rng.random(C) < 0.2
        pre[:, hit] = rng.uniform(-300.0, 300.0, (3, int(hit.sum())))

    n_cand = np.full(E, C, np.int32)
    if scenario not in ("dogpile", "round_budget1", "round_budget2"):
        n_cand = rng.integers(max(1, C // 2), C + 1, E).astype(np.int32)
    if contended and scenario != "ties":
        perm = np.tile(rng.permutation(C).astype(np.int32), (E, 1))
    else:
        perm = np.stack([rng.permutation(C) for _ in range(E)]).astype(
            np.int32
        )
    feasible = np.zeros((E, C), dtype=bool)
    for e in range(E):
        cand = perm[e, : n_cand[e]]
        feasible[e, cand] = rng.random(n_cand[e]) < 0.9
    limit = np.where(
        rng.random(E) < 0.3, INT32_MAX, rng.choice([2, 3, 14], E)
    ).astype(np.int32)
    ask_e = np.asarray(_STORM_ASKS)[rng.integers(0, 3, E)]
    if scenario == "uncontended":
        ask_e[:] = _STORM_ASKS[0]
    desired_e = rng.integers(1, 12, E).astype(np.int32)
    if contended:
        # identical nodes, each with room for a few asks: every row's
        # walk picks the same node first, then the jitter spreads the
        # rows over the rest, round after round
        n_tight = max(2, A // 2)
        tight = (perm[0, : min(C, n_tight)] if scenario != "ties"
                 else rng.choice(C, min(C, n_tight), replace=False))
        feasible[:, :] = False
        feasible[:, tight] = True
        ask_e[:] = (1000.0, 1024.0, 300.0)
        cpu_total[tight] = 4000.0
        mem_total[tight] = 8192.0
        disk_total[tight] = 50000.0
        cpu_used[tight] = 4000.0 - 1000.0 * (2 if scenario == "ties" else 3)
        mem_used[tight] = 0.0
        disk_used[tight] = 0.0
        if scenario == "ties":
            cpu_used[:] = cpu_used[tight[0]]
            mem_used[:] = 0.0
            disk_used[:] = 0.0
        limit[:] = 2
    affinity = np.zeros((E, C))
    collisions = np.zeros((E, C), np.int32)
    if scenario == "penalty_affinity_collisions":
        affinity = np.where(rng.random((E, C)) < 0.3,
                            rng.uniform(-1.0, 1.0, (E, C)), 0.0)
        collisions = (rng.integers(0, 4, (E, C))
                      * (rng.random((E, C)) < 0.3)).astype(np.int32)
    if scenario == "infeasible_rows":
        feasible[rng.random(E) < 0.3] = False
        big = rng.random(E) < 0.2
        ask_e[big, 0] = 1e6

    if scenario == "pre_deltas":
        # fractional asks: the debit's order of additions could show
        ask_e = ask_e * rng.uniform(0.5, 1.0, (E, 1)) + rng.uniform(
            0.0, 1.0, (E, 3)
        )
    eval_of = (np.arange(A) * E // A).astype(np.int32)
    ask = ask_e[eval_of].astype(np.float64)
    desired = desired_e[eval_of]
    penalty = np.zeros((A, C), dtype=bool)
    if scenario == "penalty_affinity_collisions":
        penalty = rng.random((A, C)) < 0.05
    real = np.ones(A, dtype=bool)
    if scenario == "padding_rows":
        n_real = max(1, (3 * A) // 4)
        real[n_real:] = False
        eval_of[n_real:] = 0
        ask[n_real:] = 0.0
        desired[n_real:] = 1
    max_rounds = A
    if scenario == "round_budget1":
        max_rounds = 1
    elif scenario == "round_budget2":
        max_rounds = 2
    cols = dict(cpu_total=cpu_total, mem_total=mem_total,
                disk_total=disk_total, cpu_used=cpu_used,
                mem_used=mem_used, disk_used=disk_used)
    inputs = dict(
        feasible=feasible, affinity=affinity, collisions=collisions,
        perm=perm, limit=limit, n_cand=n_cand, eval_of=eval_of,
        penalty=penalty, ask=ask, desired=desired.astype(np.int32),
        real=real, pre_cpu=pre[0], pre_mem=pre[1], pre_disk=pre[2],
    )
    return cols, inputs, max_rounds


# K5 with policy rows: (the base storm scenario, how evals carry
# policy groups).  "weighted": every eval has a throughput row, half a
# migration row; "mixed": each eval none, one or both groups at random
# (the policy-less ones carry zero rows); "dogpile" the contended shape
# with mixed rows.
POLICY_STORM_SCENARIOS: Dict[str, Tuple[str, str]] = {
    "weighted": ("penalty_affinity_collisions", "weighted"),
    "mixed": ("uncontended", "mixed"),
    "dogpile": ("dogpile", "mixed"),
}


def policy_storm_case(seed: int, E: int, A: int, C: int, scenario: str):
    """One weighted K5 input: `storm_case` of the base scenario with the
    three policy fields added to its StormInputs fields."""
    base, kind = POLICY_STORM_SCENARIOS[scenario]
    cols, inputs, max_rounds = storm_case(seed, E, A, C, base)
    E = inputs["feasible"].shape[0]
    rng = np.random.default_rng(seed + 1)
    if kind == "weighted":
        tput = np.ones(E, bool)
        mig = rng.random(E) < 0.5
    else:
        tput = rng.random(E) < 0.5
        mig = rng.random(E) < 0.5
    t, h, m = _policy_rows(rng, E, C, tput, mig)
    inputs.update(policy_tput_term=t, policy_has_tput=h, policy_mig_term=m)
    return cols, inputs, max_rounds


# K6 (the walk over a host-built score vector).  (n_bad, n_good): bad
# nodes score <= 0 and are diverted up to three at a time; "spliced"
# mixes in rows scored as the preemption path splices them (the mean
# of a binpack term and the logistic preemption term, often <= 0);
# "all_neg_inf" has no feasible node and every score -inf.
WALK_SCENARIOS: Dict[str, Tuple[int, int]] = {
    "div0": (0, 40),
    "div1": (1, 40),
    "div2": (2, 40),
    "div4": (4, 40),
    "div2_nogood": (2, 0),
    "spliced": (-1, -1),
    "all_neg_inf": (0, 0),
    "tail": (-1, -1),
}


def walk_case(seed: int, C: int, scenario: str, limit: int,
              dtype=np.float64) -> Dict:
    """One K6 input: `feasible` bool[C], `scores` [C] in `dtype` (-inf
    where infeasible, as the preemption path stages them), the walk
    order `perm` (candidates first), `limit` and `n_candidates`.
    "tail" has six good candidates and up to twelve feasible positions
    past n_candidates, one of them scoring -0.0 (bad): a limit of 14
    stops inside the tail, which the walk reaches as the JAX walk does."""
    rng = np.random.default_rng(seed)
    n_cand = max(1, (4 * C) // 5)
    perm = rng.permutation(C).astype(np.int32)
    cand = perm[:n_cand]
    feasible = np.zeros(C, dtype=bool)
    scores = np.full(C, -np.inf)
    if scenario == "spliced":
        feasible[cand] = rng.random(n_cand) < 0.6
        scores[cand] = rng.uniform(0.05, 1.0, n_cand)
        spliced = cand[rng.random(n_cand) < 0.15]
        binpack = rng.uniform(0.0, 1.0, len(spliced))
        netp = rng.choice([20.0, 40.0, 60.0], len(spliced))
        pre = 1.0 / (1.0 + np.exp(0.0048 * (netp - 2048.0))) - 1.0
        feasible[spliced] = True
        scores[spliced] = (binpack + pre) / 2.0
        # ties: the earliest emitted must win
        good = cand[feasible[cand] & (scores[cand] > 0)]
        if len(good) >= 4:
            src, *dst = rng.choice(good, size=4, replace=False)
            scores[dst] = scores[src]
    elif scenario == "tail":
        keep = rng.choice(cand, min(6, n_cand), replace=False)
        feasible[keep] = True
        scores[keep] = rng.uniform(0.05, 1.0, len(keep))
        tail = rng.choice(perm[n_cand:], min(12, C - n_cand), replace=False)
        feasible[tail] = True
        scores[tail] = rng.uniform(0.05, 1.0, len(tail))
        scores[tail[:1]] = -0.0
    elif scenario != "all_neg_inf":
        n_bad, n_good = WALK_SCENARIOS[scenario]
        n_good = min(n_good, n_cand - n_bad)
        picked = rng.choice(cand, size=n_bad + n_good, replace=False)
        bad, good = picked[:n_bad], picked[n_bad:]
        feasible[picked] = True
        scores[bad] = rng.uniform(-1.0, 0.0, n_bad)
        scores[good] = rng.uniform(0.05, 1.0, n_good)
    scores[~feasible] = -np.inf
    return dict(
        feasible=feasible, scores=scores.astype(dtype), perm=perm,
        limit=limit, n_candidates=n_cand,
    )


# ---------------------------------------------------------------------------
# shared-snapshot batches (kernel K7): E independent evals x P picks, as
# the bridge's ScoreBatch stages them
# ---------------------------------------------------------------------------

# mixed: fractional usage and asks, counts 1..P, a limit per eval, a few
#   zero-capacity nodes;
# bridge: whole MHz/MB usage and the bridge's ask ranges, one limit;
# tight: room for a few asks only, so evals fail part way and go inert;
# fit_nowhere: asks larger than every node, every row NO_NODE;
# ties: groups of identical nodes, the earliest emitted must win
BATCH_SHARED_SCENARIOS = ("mixed", "bridge", "tight", "fit_nowhere", "ties")


def service_limit(n_cand: int) -> int:
    """The bridge's visit limit, max(2, ceil(log2 n_cand))."""
    return max(2, int(np.ceil(np.log2(max(n_cand, 1)))))


def batch_shared_case(seed: int, C: int, n_cand: int, scenario: str,
                      E: int, P: int) -> Dict:
    """One K7 input: the keyword arguments of `batch_plan_picks_shared`
    as numpy (f64 columns and asks, bool feasible, int32 perms, counts
    and limits, int n_candidates and n_picks).  As the bridge stages
    them, the feasible rows are an ascending subset of the arena (holes
    between them), each eval's perm walks them in its own shuffled
    order and then lists every other row ascending, so no feasible
    entry lies in the walk's tail; the evals' counts are 1..P with at
    least one at P."""
    rng = np.random.default_rng(seed)
    (cpu_total, mem_total, disk_total,
     cpu_used, mem_used, disk_used) = _capacity(rng, C)
    base = np.sort(rng.choice(C, size=n_cand, replace=False)).astype(np.int32)
    rest = np.setdiff1d(np.arange(C, dtype=np.int32), base)
    perms = np.empty((E, C), dtype=np.int32)
    for k in range(E):
        perms[k, :n_cand] = base[rng.permutation(n_cand)]
        perms[k, n_cand:] = rest
    feasible = np.zeros(C, dtype=bool)
    feasible[base] = True
    counts = rng.integers(1, P + 1, E).astype(np.int32)
    counts[rng.integers(E)] = P
    limit = np.full(E, service_limit(n_cand), np.int32)
    if scenario == "bridge":
        asks = np.stack([
            rng.integers(100, 2001, E), rng.integers(128, 2049, E),
            np.full(E, 300),
        ], axis=1).astype(np.float64)
    else:
        asks = np.stack([
            rng.uniform(100.0, 2000.0, E), rng.uniform(128.0, 2048.0, E),
            rng.uniform(100.0, 400.0, E),
        ], axis=1)
        # fractional usage: the order and rounding of every operation
        # shows in the last bits
        cpu_used = cpu_used + rng.uniform(0.0, 1.0, C)
        mem_used = mem_used + rng.uniform(0.0, 1.0, C)
        disk_used = disk_used + rng.uniform(0.0, 1.0, C)
        limit = rng.choice(
            np.array([2, service_limit(n_cand), INT32_MAX], np.int32), E
        )
    if scenario == "mixed":
        zero = rng.choice(C, size=max(1, C // 64), replace=False)
        cpu_total[zero] = 0.0
    elif scenario == "tight":
        # room for one ask on n_cand / 32 nodes and none elsewhere
        asks[:, 0] = rng.uniform(1300.0, 2000.0, E)
        roomy = rng.choice(base, size=max(1, n_cand // 32), replace=False)
        cpu_used[base] = np.maximum(cpu_total[base] - 50.0, 0.0)
        cpu_used[roomy] = np.maximum(cpu_total[roomy] - 2590.0, 0.0)
    elif scenario == "fit_nowhere":
        asks[:, 0] = cpu_total.max() + rng.uniform(1.0, 100.0, E)
    elif scenario == "ties":
        _tie_groups(rng, base, [cpu_total, mem_total, disk_total, cpu_used,
                                mem_used, disk_used], n_groups=8)
    return dict(
        cpu_total=cpu_total, mem_total=mem_total, disk_total=disk_total,
        feasible=feasible, base_cpu_used=cpu_used, base_mem_used=mem_used,
        base_disk_used=disk_used, perms=perms, ask_cpu=asks[:, 0].copy(),
        ask_mem=asks[:, 1].copy(), ask_disk=asks[:, 2].copy(),
        desired_count=counts, limit=limit, n_candidates=n_cand,
        n_picks=P,
    )


# -- K12: the node-sharded chained planner ----------------------------------

SHARDED_CHAIN_SCENARIOS = ("plain", "everything", "spread_percent",
                           "spread_even")


def sharded_chain_case(seed: int, C: int, n_cand: int, scenario: str,
                       E: int, P: int) -> dict:
    """Inputs of the sharded chained planner (JAX
    `parallel/mesh.py sharded_chained_plan`, K12) in its per-eval scalar
    layout, as numpy: ``cols`` (cpu_total, mem_total, disk_total,
    used_cpu, used_mem, used_disk), ``per_eval`` (feasible [E, C], perm,
    ask_cpu, ask_mem, ask_disk, desired_count, limits, wanted,
    n_candidates, distinct_hosts, coll0, affinity), ``deltas`` (the
    StepDeltas fields), ``pre`` (PreDeltas), ``spread`` (SpreadInputs
    fields, or None) and ``spread_even``.

    "plain" has no deltas; "everything" adds evictions, penalty rows,
    pre-deltas, distinct_hosts, collisions, affinity and evals whose
    `wanted` stops early (one wants nothing); "spread_percent" and
    "spread_even" add two spread stanzas (the second even-mode in the
    latter) with evictions that clear value slots."""
    if scenario not in SHARDED_CHAIN_SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}")
    rng = np.random.default_rng(seed)
    K, R, S, V1 = 4, 2, 2, 5
    cols = (
        rng.choice([4000.0, 8000.0, 16000.0], C),
        rng.choice([8192.0, 16384.0, 32768.0], C),
        np.full(C, 100_000.0),
        rng.integers(0, 3000, C).astype(np.float64),
        rng.integers(0, 6000, C).astype(np.float64),
        rng.integers(0, 500, C).astype(np.float64),
    )
    feasible = np.zeros((E, C), dtype=bool)
    perms = np.zeros((E, C), np.int32)
    for e in range(E):
        feasible[e, :n_cand] = rng.random(n_cand) > 0.1
        perms[e] = np.concatenate(
            [rng.permutation(n_cand), np.arange(n_cand, C)])
    everything = scenario == "everything"
    spread = scenario.startswith("spread")
    coll0 = np.zeros((E, C), np.int32)
    affinity = np.zeros((E, C))
    dh = np.zeros(E, bool)
    wanted = np.full(E, P, np.int32)
    limits = np.full(E, 2 + P // 2, np.int32)
    if everything:
        coll0 = (rng.random((E, C)) > 0.9).astype(np.int32)
        affinity = np.where(rng.random((E, C)) > 0.8,
                            rng.choice([0.35, -0.5], (E, C)), 0.0)
        dh[1::3] = True
        wanted = rng.integers(1, P + 1, E).astype(np.int32)
        wanted[E // 2] = 0
    if spread:
        limits = np.full(E, 2**31 - 1, np.int32)  # spreads lift the limit
    evicting = everything or spread
    ev_rows = np.full((E, P), -1, np.int32)
    pen_rows = np.full((E, P, K), -1, np.int32)
    if evicting:
        ev_rows = np.where(rng.random((E, P)) > 0.6,
                           rng.integers(0, n_cand, (E, P)), -1).astype(np.int32)
    if everything:
        pen_rows = np.where(rng.random((E, P, K)) > 0.8,
                            rng.integers(0, n_cand, (E, P, K)),
                            -1).astype(np.int32)
    deltas = dict(
        evict_rows=ev_rows,
        evict_cpu=np.full((E, P), -500.0),
        evict_mem=np.full((E, P), -256.0),
        evict_disk=np.full((E, P), -30.0),
        evict_coll=np.where(ev_rows >= 0, -1, 0).astype(np.int32)
        if everything else np.zeros((E, P), np.int32),
        penalty_rows=pen_rows,
    )
    pre = dict(rows=np.zeros((E, R), np.int32), cpu=np.zeros((E, R)),
               mem=np.zeros((E, R)), disk=np.zeros((E, R)))
    if everything:
        pre = dict(rows=rng.integers(0, n_cand, (E, R)).astype(np.int32),
                   cpu=np.full((E, R), -100.0), mem=np.full((E, R), -128.0),
                   disk=np.full((E, R), 7.0))
    per_eval = dict(
        feasible=feasible, perm=perms,
        ask_cpu=rng.choice([300.0, 500.0, 1200.0], E),
        ask_mem=rng.choice([256.0, 512.0, 2048.0], E),
        ask_disk=np.full(E, 300.0),
        desired_count=rng.integers(2, 8, E).astype(np.int32),
        limits=limits, wanted=wanted,
        n_candidates=np.full(E, n_cand, np.int32),
        distinct_hosts=dh, coll0=coll0, affinity=affinity,
    )
    sp = None
    if spread:
        even = np.zeros((E, S), dtype=bool)
        if scenario == "spread_even":
            even[:, 1] = True
        sp = dict(
            codes=rng.integers(0, V1, (E, S, C)).astype(np.int32),
            desired=rng.integers(1, 5, (E, S, V1)).astype(np.float64),
            used0=rng.integers(0, 3, (E, S, V1)).astype(np.float64),
            proposed0=rng.integers(0, 2, (E, S, V1)).astype(np.float64),
            cleared0=rng.integers(0, 2, (E, S, V1)).astype(np.float64),
            weight=np.full((E, S), 0.5),
            active=np.ones((E, S), dtype=bool),
            even=even,
        )
    return dict(cols=cols, per_eval=per_eval, deltas=deltas, pre=pre,
                spread=sp, spread_even=scenario == "spread_even")


SHARDED_PER_EVAL = ("feasible", "perm", "ask_cpu", "ask_mem", "ask_disk",
                    "desired_count", "limits", "wanted", "n_candidates",
                    "distinct_hosts", "coll0", "affinity")
