"""K2's and K7's prefix walk (`csrc/picks.cuh`), on the CPU.

* `prefix_walk` is a plain model of how the pick body walks one pick:
  in steps of `first` positions (a pick's first step), each next one
  twice as long up to `threads` x `wide`, position base + r * threads +
  t on thread t; the running feasible and bad counts carried across
  steps; a position's
  emit order feasible-before minus min(bad-before, MAX_SKIP); the first
  MAX_SKIP bad positions set aside as diverted; each thread's best
  (score, emit order, walk position) over the non-diverted positions
  with order < limit, reduced at the end; the stop after the step in
  which the non-diverted count reaches the limit (pulls = the limit-th
  position + 1), else the whole region (pulls = n_cand) with the
  diverted positions given their orders from the totals, reversed when
  two were diverted behind a good node.  It is held exactly against the
  JAX `_walk` (`nomad_tpu/ops/batch.py:281`) with hypothesis, over
  fixed steps of 1, 32, 256 and 1,024 positions and the kernels' growing
  ones: fewer candidates than the first step, as many, one more, and
  around the second step's end, limit 1 and beyond the candidates,
  ties, 0-4 bad positions, every offset.
* `prefix_picks` is the same model of a whole eval: P picks, each a
  prefix walk that scores only the positions it reaches, over the node
  columns read through `perm` and the carry (a bitmap of the positions
  earlier picks won, and a list of their usage and collisions updated
  as x = x + ask in pick order; the positions scored and not won since,
  whose feasibility and score later picks read back instead of
  rescoring them); after the first failed pick the rest are inert.  It is held against the JAX `plan_picks_full` (K2: rows and
  pulls) over `BATCH_SCENARIOS` and the JAX `batch_plan_picks_shared`
  (K7: rows) over `BATCH_SHARED_SCENARIOS`, under x64, and in f32
  against the port's twins.  Cases include a node that wins twice and
  a group that dies part way.
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from nomad_tpu.ops import batch as jbatch
from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops.cases import (
    BATCH_SCENARIOS,
    BATCH_SHARED_SCENARIOS,
    INT32_MAX,
    batch_case,
    batch_shared_case,
)
from nomad_tpu_torch.ops.score import INV_18, MAX_SKIP, NO_NODE, _pow10, fma
from nomad_tpu_torch.state.convert import (
    batch_inputs_from_numpy,
    batch_shared_inputs_from_numpy,
)


def _better(s, ord_, bs, bord):
    return s > bs or (s == bs and ord_ < bord)


def _steps(n_cand: int, threads: int, first: int, wide: int):
    """The walk's steps, (base, width), until the region is covered:
    `first` positions, then twice as many a step up to threads x wide."""
    base, width = 0, min(first, threads * wide)
    while base < n_cand:
        yield base, width
        base += width
        width = min(2 * width, threads * wide)


def prefix_walk(score_at, limit: int, n_cand: int, threads: int,
                first: int, wide: int):
    """One pick's prefix walk over walk positions [0, n_cand).
    `score_at(ws, record)` gives the scores and feasibility of a step's
    walk positions `ws` (the only positions read); `record` is set on
    steps of `threads` positions or more, whose scores the pick body
    keeps.  Returns (win_w
    or -1, pulls, positions scored)."""
    feas_run = bad_run = 0
    best = {}  # thread -> (score, order, walk position)
    div = [None] * MAX_SKIP  # the diverted positions' (score, w)
    lth = None
    stopped = False
    scored = 0
    for base, width in _steps(n_cand, threads, first, wide):
        ws = list(range(base, min(base + width, n_cand)))
        s, f = score_at(ws, width >= threads)
        scored += len(ws)
        feas_before = bad_before = 0  # within the step, in walk order
        for j, w in enumerate(ws):
            bad = f[j] and s[j] <= 0.0
            if f[j]:
                fb = feas_run + feas_before
                bb = bad_run + bad_before
                if bad and bb < MAX_SKIP:
                    div[bb] = (s[j], w)
                else:
                    ord_ = fb - min(bb, MAX_SKIP)
                    t = (w - base) % threads
                    cur = best.get(t, (-np.inf, INT32_MAX, -1))
                    if ord_ < limit and _better(s[j], ord_, cur[0], cur[1]):
                        best[t] = (s[j], ord_, w)
                    if ord_ + 1 == limit:
                        lth = w
            feas_before += bool(f[j])
            bad_before += bool(bad)
        feas_run += feas_before
        bad_run += bad_before
        if feas_run - min(bad_run, MAX_SKIP) >= limit:
            stopped = True
            break
    # the block's reduction over the threads' bests
    win = (-np.inf, INT32_MAX, -1)
    for t in sorted(best):
        if _better(best[t][0], best[t][1], win[0], win[1]):
            win = best[t]
    if stopped:
        pulls = lth + 1
    else:
        pulls = n_cand
        nd_count = feas_run - min(bad_run, MAX_SKIP)
        n_div = min(bad_run, MAX_SKIP)
        reverse = n_div == 2 and nd_count > 0
        for r in range(n_div):
            ord_ = nd_count + (1 - r if reverse else r)
            if ord_ < limit and _better(div[r][0], ord_, win[0], win[1]):
                win = (div[r][0], ord_, div[r][1])
    return (win[2] if win[1] != INT32_MAX else -1), pulls, scored


# -- the stepped walk against the JAX _walk ----------------------------------

_jax_walk = jax.jit(jbatch._walk)

# (threads, first, wide): fixed steps of S positions, and growing ones
# as the kernels walk
SCHEDULES = [(1, 1, 1), (32, 32, 1), (256, 256, 1), (1024, 1024, 1),
             (32, 32, 8), (256, 128, 8), (512, 1, 8)]


@st.composite
def walks(draw, first: int):
    # around the first step's end and the second's
    n_cand = draw(st.sampled_from(sorted({
        max(1, first - 1), first, first + 1, 3 * first, 3 * first + 1,
        1, 2, 5, 37, 300, 2500})))
    tail = draw(st.sampled_from([0, 3]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    # good scores from a few values (ties), then 0-4 bad ones among the
    # feasible positions
    good = np.array(draw(st.lists(st.sampled_from(
        [0.125, 0.5, 0.75, 1.0]), min_size=1, max_size=4)))
    scores = rng.choice(good, n_cand + tail)
    feasible = rng.random(n_cand + tail) < draw(
        st.sampled_from([0.05, 0.6, 1.0]))
    feasible[n_cand:] = False  # the padding past the candidates
    feas_idx = np.flatnonzero(feasible)
    n_bad = min(draw(st.integers(0, 4)), len(feas_idx))
    bad_at = rng.choice(feas_idx, n_bad, replace=False)
    scores[bad_at] = rng.choice([-1.0, -0.25, 0.0], n_bad)
    offset = draw(st.integers(0, n_cand - 1))
    limit = draw(st.sampled_from([1, 2, 3, 4, 14, max(1, n_cand // 3),
                                  n_cand, n_cand + 5]))
    return scores, feasible, offset, limit, n_cand


def _check_walk(scores, feasible, offset, limit, n_cand, threads, first,
                wide):
    win, any_e, pulls = _jax_walk(jnp.asarray(scores), jnp.asarray(feasible),
                                  jnp.int32(offset), jnp.int32(limit),
                                  jnp.int32(n_cand))
    # walk position w is permuted position (w + offset) mod n_cand
    order = (np.arange(n_cand) + offset) % n_cand
    s_w, f_w = scores[order], feasible[order]
    win_w, pulls_m, scored = prefix_walk(
        lambda ws, _: (s_w[ws].tolist(), f_w[ws].tolist()), limit, n_cand,
        threads, first, wide)
    assert (win_w >= 0) == bool(any_e)
    assert pulls_m == int(pulls)
    if win_w >= 0:
        assert (win_w + offset) % n_cand == int(win)
    # the walk scores no position past the step that holds its last pull
    assert scored >= pulls_m
    last = next(b + width for b, width in _steps(n_cand, threads, first, wide)
                if b + width >= pulls_m)
    assert scored == min(last, n_cand)


@pytest.mark.parametrize("threads,first,wide", SCHEDULES)
@settings(max_examples=50, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_prefix_walk_matches_jax_walk(threads, first, wide, data):
    case = data.draw(walks(first))
    _check_walk(*case, threads, first, wide)


@pytest.mark.parametrize("threads,first,wide",
                         [(1, 1, 1), (2, 1, 1), (2, 1, 3), (32, 32, 1)])
@pytest.mark.parametrize("limit", [1, 2, 3, 6, 100])
def test_prefix_walk_every_offset_with_two_diverted(threads, first, wide,
                                                    limit):
    """Two bad positions and a good one of seven: every offset (the wrap
    included) against the JAX walk, the reversed replay of the two
    diverted positions where the whole region is walked."""
    n_cand = 7
    scores = np.array([0.5, -0.25, 0.75, 0.5, 0.0, 0.125, 0.5, 1.0])
    feasible = np.array([False, True, False, True, True, False, False,
                         False])
    for offset in range(n_cand):
        _check_walk(scores, feasible, offset, limit, n_cand, threads, first,
                    wide)


# -- the whole pick loop with the carry --------------------------------------


def _score_positions(rows, used, coll, pen, aff, totals, ask, desired,
                     spread_fit, dtype):
    """score_node over a step's rows (torch, `dtype`): the kernel's
    arithmetic a position."""
    cpu_total, mem_total = totals[0][rows], totals[1][rows]
    one = torch.ones((), dtype=dtype)
    zero = torch.zeros((), dtype=dtype)
    cpu_after = used[0] + ask[0]
    mem_after = used[1] + ask[1]
    safe_cpu = torch.where(cpu_total > 0, cpu_total, one)
    safe_mem = torch.where(mem_total > 0, mem_total, one)
    base = (_pow10(1.0 - cpu_after / safe_cpu, dtype)
            + _pow10(1.0 - mem_after / safe_mem, dtype))
    fitness = torch.clamp(base - 2.0 if spread_fit else 20.0 - base,
                          0.0, 18.0)
    has_coll = coll > 0
    anti = torch.where(has_coll, -(coll.to(dtype) + 1.0) / desired, zero)
    score_sum = fma(fitness, INV_18, anti)
    count = one + has_coll.to(dtype)
    score_sum = score_sum - pen.to(dtype)
    count = count + pen.to(dtype)
    has_aff = aff != 0.0
    score_sum = score_sum + torch.where(has_aff, aff, zero)
    count = count + has_aff.to(dtype)
    return score_sum / count


def prefix_picks(cols, perm, n_cand: int, n_picks: int, ask, desired: int,
                 limit: int, distinct_hosts: bool, spread_fit: bool,
                 threads: int, first: int, wide: int, dtype):
    """One eval's P picks as the pick body runs them.  `cols` holds node
    columns as `dtype` tensors (cpu/mem/disk total and used, feasible,
    collisions, penalty, affinity).  Returns (rows, pulls, the positions
    each pick scored)."""
    totals = (cols["cpu_total"], cols["mem_total"], cols["disk_total"])
    ask = [torch.tensor(a, dtype=dtype) for a in ask]
    desired_t = torch.tensor(float(desired), dtype=dtype)
    won = np.zeros(n_cand, dtype=bool)  # the bitmap
    entries = {}  # position -> [cpu, mem, disk, coll], first-won order
    known = np.zeros(n_cand, dtype=bool)  # scored, not won since
    feas = np.zeros(n_cand, dtype=bool)
    cache = [0.0] * n_cand  # the score cache (written where feasible)
    offset, rows, pulls, scored = 0, [], [], []

    def score_at(ws, record):
        ps_all = [(w + offset) % n_cand for w in ws]
        fresh = [p for p in ps_all if not known[p]]
        s_new, f_new = score_fresh(fresh) if fresh else ([], [])
        got = dict(zip(fresh, zip(s_new, f_new)))
        if record:
            for p, (s_p, f_p) in got.items():
                # the bits are only ever set here, as the kernel's are
                known[p] = True
                feas[p] |= f_p
                if f_p:
                    cache[p] = s_p
        out = [got[p] if p in got else
               (cache[p] if feas[p] else 0.0, bool(feas[p])) for p in ps_all]
        return [o[0] for o in out], [o[1] for o in out]

    def score_fresh(ps):
        r = perm[ps].long()
        used = [cols[k][r].clone() for k in ("cpu_used", "mem_used",
                                             "disk_used")]
        coll = cols["collisions"][r].clone()
        for j, p in enumerate(ps):
            if won[p]:
                e = entries[p]
                for i in range(3):
                    used[i][j] = e[i]
                coll[j] = e[3]
        after = [u + a for u, a in zip(used, ask)]
        fit = ((after[0] <= totals[0][r]) & (after[1] <= totals[1][r])
               & (after[2] <= totals[2][r]))
        f = cols["feasible"][r] & fit
        if distinct_hosts:
            f = f & ~(coll > 0)
        s = _score_positions(r, used, coll, cols["penalty"][r],
                             cols["affinity"][r], totals, ask, desired_t,
                             spread_fit, dtype)
        return s.tolist(), f.tolist()

    for _k in range(n_picks):
        win_w, n_pulls, n_scored = prefix_walk(score_at, limit, n_cand,
                                               threads, first, wide)
        scored.append(n_scored)
        if win_w < 0:
            pulls.append(n_pulls)
            rows += [NO_NODE] * (n_picks - len(rows))
            pulls += [0] * (n_picks - len(pulls))
            break
        p = (win_w + offset) % n_cand
        row = int(perm[p])
        rows.append(row)
        if not won[p]:
            won[p] = True
            entries[p] = [cols["cpu_used"][row], cols["mem_used"][row],
                          cols["disk_used"][row],
                          cols["collisions"][row]]
        e = entries[p]
        for i in range(3):
            e[i] = e[i] + ask[i]  # x = x + ask, in pick order
        e[3] = e[3] + 1
        # its usage changed: rescored when next reached
        known[p] = feas[p] = False
        pulls.append(n_pulls)
        offset = (offset + n_pulls) % n_cand
    return np.array(rows, np.int32), np.array(pulls, np.int32), scored


C, N_CAND = 256, 200
PICK_SCHEDULES = [(32, 32, 1), (32, 32, 4), (256, 128, 8)]


def _k2_cols(cols, inp, dtype):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in cols.items()}
    for k in ("base_cpu_used", "base_mem_used", "base_disk_used"):
        t[k.split("_", 1)[1]] = torch.from_numpy(inp[k]).to(dtype)
    t["feasible"] = torch.from_numpy(inp["feasible"])
    t["collisions"] = torch.from_numpy(inp["base_collisions"])
    t["penalty"] = torch.from_numpy(inp["penalty"])
    t["affinity"] = torch.from_numpy(inp["affinity_score"]).to(dtype)
    return t


def _k2_jax(cols, inp, n_picks, spread_fit):
    f = np.float64
    binp = jbatch.BatchInputs(
        feasible=inp["feasible"], base_cpu_used=inp["base_cpu_used"],
        base_mem_used=inp["base_mem_used"],
        base_disk_used=inp["base_disk_used"],
        base_collisions=inp["base_collisions"], penalty=inp["penalty"],
        affinity_score=inp["affinity_score"], perm=inp["perm"],
        ask_cpu=f(inp["ask_cpu"]), ask_mem=f(inp["ask_mem"]),
        ask_disk=f(inp["ask_disk"]),
        desired_count=np.int32(inp["desired_count"]),
        limit=np.int32(inp["limit"]),
        distinct_hosts=np.bool_(inp["distinct_hosts"]),
    )
    return np.asarray(jbatch.plan_picks_full(
        cols["cpu_total"], cols["mem_total"], cols["disk_total"], binp,
        np.int32(N_CAND), n_picks, spread_fit=spread_fit))


def _k2_model(cols, inp, n_picks, spread_fit, threads, first, wide, dtype):
    return prefix_picks(
        _k2_cols(cols, inp, dtype), torch.from_numpy(inp["perm"]), N_CAND,
        n_picks, (inp["ask_cpu"], inp["ask_mem"], inp["ask_disk"]),
        inp["desired_count"], inp["limit"], inp["distinct_hosts"],
        spread_fit, threads, first, wide, dtype)


@pytest.mark.parametrize("threads,first,wide", PICK_SCHEDULES)
@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("limit", [2, 14, INT32_MAX])
@pytest.mark.parametrize("n_picks", [1, 16, 128])
@pytest.mark.parametrize("scenario", sorted(BATCH_SCENARIOS))
def test_prefix_picks_match_jax_plan_picks_full(scenario, n_picks, limit,
                                                spread_fit, threads, first,
                                                wide):
    seed = 2400 + 10 * sorted(BATCH_SCENARIOS).index(scenario) + n_picks
    cols, inp = batch_case(seed, C, N_CAND, scenario, limit, n_picks)
    rows, pulls, scored = _k2_model(cols, inp, n_picks, spread_fit, threads,
                                    first, wide, torch.float64)
    want = _k2_jax(cols, inp, n_picks, spread_fit)
    np.testing.assert_array_equal(np.stack([rows, pulls]), want)
    # a pick that stops scores at most the step holding its last pull
    for n_scored, n_pulls in zip(scored, pulls):
        assert n_scored >= n_pulls or n_pulls == 0


@pytest.mark.parametrize("threads,first,wide", PICK_SCHEDULES)
@pytest.mark.parametrize("scenario", sorted(BATCH_SCENARIOS))
def test_prefix_picks_match_the_f32_twin(scenario, threads, first, wide):
    cols, inp = batch_case(2500 + sorted(BATCH_SCENARIOS).index(scenario), C,
                           N_CAND, scenario, 14, 16)
    rows, pulls, _ = _k2_model(cols, inp, 16, False, threads, first, wide,
                               torch.float32)
    t = {k: torch.from_numpy(v).float() for k, v in cols.items()}
    want = tbatch.run_picks(t["cpu_total"], t["mem_total"], t["disk_total"],
                            batch_inputs_from_numpy(inp, "cpu",
                                                    dtype=torch.float32),
                            N_CAND, 16, False)
    np.testing.assert_array_equal(rows, want[0].numpy())
    np.testing.assert_array_equal(pulls, want[1].numpy())


def test_a_node_wins_twice_and_a_group_dies_part_way():
    """Few candidates and many picks: nodes win again (their carry
    entries take a second ask), then the group runs out of room and the
    rest of its picks are inert."""
    rng = np.random.default_rng(31)
    n_cand, n_picks = 6, 24
    cols, inp = batch_case(2600, C, N_CAND, "plain", 2, n_picks)
    perm = inp["perm"]
    inp["feasible"][:] = False
    inp["feasible"][perm[:n_cand]] = True
    inp["base_collisions"][:] = 0
    # room for two to four asks on each candidate
    inp["base_cpu_used"][perm[:n_cand]] = (
        cols["cpu_total"][perm[:n_cand]]
        - rng.uniform(2.0, 4.5, n_cand) * inp["ask_cpu"])
    t = _k2_cols(cols, inp, torch.float64)
    rows, pulls, _ = prefix_picks(
        t, torch.from_numpy(perm), n_cand, n_picks,
        (inp["ask_cpu"], inp["ask_mem"], inp["ask_disk"]),
        inp["desired_count"], 2, False, False, 32, 32, 4, torch.float64)
    placed = rows[rows >= 0]
    assert len(placed) > len(set(placed.tolist()))  # a node won twice
    fail = np.flatnonzero(rows == NO_NODE)
    assert len(fail) and (rows[fail[0]:] == NO_NODE).all()
    assert (pulls[fail[0] + 1:] == 0).all()
    binp = jbatch.BatchInputs(
        feasible=inp["feasible"], base_cpu_used=inp["base_cpu_used"],
        base_mem_used=inp["base_mem_used"],
        base_disk_used=inp["base_disk_used"],
        base_collisions=inp["base_collisions"], penalty=inp["penalty"],
        affinity_score=inp["affinity_score"], perm=perm,
        ask_cpu=np.float64(inp["ask_cpu"]), ask_mem=np.float64(inp["ask_mem"]),
        ask_disk=np.float64(inp["ask_disk"]),
        desired_count=np.int32(inp["desired_count"]), limit=np.int32(2),
        distinct_hosts=np.bool_(False),
    )
    want = np.asarray(jbatch.plan_picks_full(
        cols["cpu_total"], cols["mem_total"], cols["disk_total"], binp,
        np.int32(n_cand), n_picks))
    np.testing.assert_array_equal(np.stack([rows, pulls]), want)


_SHARED_ARGS = ("cpu_total", "mem_total", "disk_total", "feasible",
                "base_cpu_used", "base_mem_used", "base_disk_used", "perms",
                "ask_cpu", "ask_mem", "ask_disk", "desired_count", "limit")


def _k7_model(case, threads, first, wide, dtype):
    zeros = np.zeros(C)
    cols = {k: torch.from_numpy(case[k]).to(dtype)
            for k in ("cpu_total", "mem_total", "disk_total")}
    for k in ("cpu", "mem", "disk"):
        cols[f"{k}_used"] = torch.from_numpy(case[f"base_{k}_used"]).to(dtype)
    cols["feasible"] = torch.from_numpy(case["feasible"])
    cols["collisions"] = torch.zeros(C, dtype=torch.int32)
    cols["penalty"] = torch.zeros(C, dtype=torch.bool)
    cols["affinity"] = torch.from_numpy(zeros).to(dtype)
    out = []
    for e in range(case["perms"].shape[0]):
        ask = [torch.tensor(case[k][e]).to(dtype).item()
               for k in ("ask_cpu", "ask_mem", "ask_disk")]
        rows, _pulls, _ = prefix_picks(
            cols, torch.from_numpy(case["perms"][e]), case["n_candidates"],
            case["n_picks"], ask, int(case["desired_count"][e]),
            int(case["limit"][e]), False, False, threads, first, wide, dtype)
        out.append(rows)
    return np.stack(out)


@pytest.mark.parametrize("threads,first,wide", PICK_SCHEDULES)
@pytest.mark.parametrize("n_cand", [5, 200, C])
@pytest.mark.parametrize("scenario", BATCH_SHARED_SCENARIOS)
def test_prefix_picks_match_jax_batch_plan_picks_shared(scenario, n_cand,
                                                        threads, first, wide):
    E, P = 4, 10
    seed = 4600 + 10 * BATCH_SHARED_SCENARIOS.index(scenario) + n_cand
    case = batch_shared_case(seed, C, n_cand, scenario, E, P)
    want = np.asarray(jbatch.batch_plan_picks_shared(
        *[case[k] for k in _SHARED_ARGS], np.int32(n_cand), P))
    got = _k7_model(case, threads, first, wide, torch.float64)
    np.testing.assert_array_equal(got, want)
    f32 = tbatch.batch_plan_picks_shared_twin(
        **batch_shared_inputs_from_numpy(case, "cpu", torch.float32))
    np.testing.assert_array_equal(_k7_model(case, threads, first, wide,
                                            torch.float32), f32.numpy())
