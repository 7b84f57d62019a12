"""The prefix walk (`csrc/picks.cuh`) and the whole-region grid
(`csrc/walk_grid.cuh`) of kernels K1, K2, K6, K7, K9 and K10, on the CPU.

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
* `select_prefix` and `select_grid` are K1's two launch shapes over the
  JAX `score_all`'s walk columns; `grid_walk` is the grid of
  `walk_grid.cuh` over a source, which K1's (the walk scratch) and K6's
  (`walk_only_grid`: the given vectors through perm) models share.
  `walk_only_prefix` is K6's prefix walk, with and without the count.
  Both of K6's shapes are held against the JAX `_walk_only`
  (`nomad_tpu/sched/tpu_stack.py:95`) over `walk_case` vectors, a
  feasible tail past n_candidates and every rotation of a small arena.
* `prefix_eval` is K9's eval body (`chained_prefix.cuh`), a generator
  that yields after each pick: `chained_prefix` runs the evals in order
  over the chain's carry (K9), `batch_plan_prefix` runs them as K10's
  concurrent blocks, interleaved pick by pick, each over its own base
  usage and with its own slice of the score cache and spread state.
  K10's is held against the JAX `batch_plan_picks`
  (`nomad_tpu/ops/batch.py:1391`; rows) and the port's twin (pulls).
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from nomad_tpu.ops import batch as jbatch
from nomad_tpu.ops import score as jscore
from nomad_tpu.sched.tpu_stack import _walk_only
from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops.cases import (
    BATCH_SCENARIOS,
    BATCH_SHARED_SCENARIOS,
    BATCHED_SCENARIOS,
    INT32_MAX,
    POLICY_SCORE_SCENARIOS,
    SCORE_SCENARIOS,
    SELECT_EDGES,
    WALK_SCENARIOS,
    batch_case,
    batch_shared_case,
    batched_cache_case,
    batched_case,
    policy_score_case,
    score_case,
    select_edge_case,
    walk_case,
)
from nomad_tpu_torch.ops.score import INV_18, MAX_SKIP, NO_NODE, _pow10, fma
from nomad_tpu_torch.state.convert import (
    batch_inputs_from_numpy,
    batch_shared_inputs_from_numpy,
    batched_case_to_torch,
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
                first: int, wide: int, n_dry=None):
    """One pick's prefix walk over walk positions [0, n_cand).
    `score_at(ws, record)` gives the scores and feasibility of a step's
    walk positions `ws` (the only positions read); `record` is set on
    steps of `threads` positions or more, whose scores the pick body
    keeps.  A walk that does not stop pulls `n_dry` (default n_cand; K1
    walks all C positions and pulls its n_candidates).  Returns (win_w
    or -1, pulls, positions scored, the winner's score or -inf)."""
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
        pulls = n_cand if n_dry is None else n_dry
        nd_count = feas_run - min(bad_run, MAX_SKIP)
        n_div = min(bad_run, MAX_SKIP)
        reverse = n_div == 2 and nd_count > 0
        for r in range(n_div):
            ord_ = nd_count + (1 - r if reverse else r)
            if ord_ < limit and _better(div[r][0], ord_, win[0], win[1]):
                win = (div[r][0], ord_, div[r][1])
    return (win[2] if win[1] != INT32_MAX else -1), pulls, scored, win[0]


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
    win_w, pulls_m, scored, _best = prefix_walk(
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
                     spread_fit, dtype, spread=None):
    """score_node over a step's rows (torch, `dtype`): the kernel's
    arithmetic a position, with the spread boost where given."""
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
    if spread is not None:
        score_sum = score_sum + spread
        count = count + (spread != 0.0).to(dtype)
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
        win_w, n_pulls, n_scored, _best = prefix_walk(
            score_at, limit, n_cand, threads, first, wide)
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


# -- K1's two launch shapes (csrc/score_select.cu) --------------------------


def _jax_select_inputs(case):
    f = np.float64
    pol = case.get("policy")
    policy = None if pol is None else jscore.PolicyTerms(
        tput_term=pol["tput_term"],
        has_tput=None if pol["has_tput"] is None
        else np.asarray(pol["has_tput"], f),
        mig_term=pol["mig_term"],
    )
    return jscore.ScoreInputs(
        cpu_total=case["cpu_total"], mem_total=case["mem_total"],
        disk_total=case["disk_total"], cpu_used=case["cpu_used"],
        mem_used=case["mem_used"], disk_used=case["disk_used"],
        feasible=case["feasible"], collisions=case["collisions"],
        penalty=case["penalty"], affinity_score=case["affinity_score"],
        spread_boost=case["spread_boost"], perm=case["perm"],
        ask_cpu=f(case["ask_cpu"]), ask_mem=f(case["ask_mem"]),
        ask_disk=f(case["ask_disk"]),
        desired_count=np.int32(case["desired_count"]),
        limit=np.int32(case["limit"]),
        n_candidates=np.int32(case["n_candidates"]), policy=policy,
    )


def _walk_columns(jin, perm, spread_fit):
    """Every walk position's feasibility and score: the JAX `score_all`
    read through the walk order."""
    feas, scores = jscore.score_all(jin, spread_fit=spread_fit)
    return np.asarray(feas)[perm], np.asarray(scores)[perm]


def select_prefix(f_w, s_w, perm, limit, n_cand, threads, first, wide):
    """K1's prefix walk: one pick over all C walk positions, no rotation,
    pulls n_candidates where the walk is dry; then the sweep of the
    positions it did not walk for the feasible count.  Returns (row,
    best, feasible_count, pulls, positions walked)."""
    C = len(f_w)
    win_w, pulls, walked, best = prefix_walk(
        lambda ws, _: (s_w[ws].tolist(), f_w[ws].tolist()), limit, C,
        threads, first, wide, n_dry=n_cand)
    count = int(f_w[:walked].sum()) + int(f_w[walked:].sum())
    row = int(perm[win_w]) if win_w >= 0 else NO_NODE
    return row, best, count, pulls, walked


def _better_sw(s, w, bs, bw):
    return s > bs or (s == bs and w < bw)


def grid_walk(flags_at, score_at, C, limit, n_dry, nb):
    """The grid of `csrc/walk_grid.cuh` (K1's and K6's whole-region
    shape) over walk positions [0, C): nb blocks, block b the positions
    [b * span, (b + 1) * span); each block's summary (feasible and bad
    counts, its first MAX_SKIP bad positions, its best (score, position)
    over the rest); the combine in block order, with the rescan of the
    block that holds the limit-th non-diverted position.  The source:
    `flags_at(w)` gives position w's (feasible, bad), `score_at(w)` the
    score of a feasible one; the rescan reads a score only where the
    position competes.  Returns (win_w or -1, best, feasible_count,
    pulls)."""
    span = -(-C // nb)
    none = INT32_MAX
    sums = []
    for b in range(nb):
        lo = min(b * span, C)
        hi = min(lo + span, C)
        nf = nbad = 0
        bads = []
        bs, bw = -np.inf, none
        for w in range(lo, hi):
            f, bad = flags_at(w)
            if not f:
                continue
            nf += 1
            s = score_at(w)
            if bad:
                nbad += 1
                if len(bads) < MAX_SKIP:
                    bads.append((s, w))
                    continue
            if _better_sw(s, w, bs, bw):
                bs, bw = s, w
        sums.append((nf, nbad, bs, bw, bads))
    f_tot = sum(x[0] for x in sums)
    b_tot = sum(x[1] for x in sums)
    nd_count = f_tot - min(b_tot, MAX_SKIP)
    stop = nd_count >= limit
    div = [None] * MAX_SKIP
    bs, bw = -np.inf, none
    held = None
    fb = bb = 0
    for b, (nf, nbad, s_b, w_b, bads) in enumerate(sums):
        fa, ba = fb + nf, bb + nbad
        nd_before = fb - min(bb, MAX_SKIP)
        nd_after = fa - min(ba, MAX_SKIP)
        all_in = not stop or nd_after < limit
        for j, (s, w) in enumerate(bads):
            if bb + j < MAX_SKIP:
                div[bb + j] = (s, w)
            elif all_in and _better_sw(s, w, bs, bw):
                bs, bw = s, w
        if all_in:
            if w_b != none and _better_sw(s_b, w_b, bs, bw):
                bs, bw = s_b, w_b
        elif nd_before < limit:
            held = (b, fb, bb)
        fb, bb = fa, ba
    lth = -1
    if stop:
        b, run_f, run_b = held
        for w in range(b * span, min(b * span + span, C)):
            f, bad = flags_at(w)
            if not f:
                continue
            if not (bad and run_b < MAX_SKIP):
                ord_ = run_f - min(run_b, MAX_SKIP)
                if ord_ < limit:
                    s = score_at(w)
                    if _better_sw(s, w, bs, bw):
                        bs, bw = s, w
                if ord_ + 1 == limit:
                    lth = w
            run_f += 1
            run_b += bad
    best_ord = -1 if bw != none else INT32_MAX
    win = bw if bw != none else -1
    if not stop:
        n_div = min(b_tot, MAX_SKIP)
        reverse = n_div == 2 and nd_count > 0
        for r in range(n_div):
            ord_ = nd_count + (1 - r if reverse else r)
            if ord_ < limit and _better(div[r][0], ord_, bs, best_ord):
                bs, best_ord, win = div[r][0], ord_, div[r][1]
    return win, bs, f_tot, (lth + 1 if stop else n_dry)


def select_grid(f_w, s_w, perm, limit, n_cand, nb):
    """K1's grid: `grid_walk` over the walk scratch (the flags and
    scores its first pass wrote in walk order).  Returns (row, best,
    feasible_count, pulls)."""
    win, best, count, pulls = grid_walk(
        lambda w: (bool(f_w[w]), bool(f_w[w] and s_w[w] <= 0.0)),
        lambda w: s_w[w], len(f_w), limit, n_cand, nb)
    return (int(perm[win]) if win >= 0 else NO_NODE), best, count, pulls


SELECT_SHAPES = [(256, 64, 2), (32, 8, 2), (8, 1, 4)]
SELECT_GRIDS = [1, 3, 8, 64]


def _same_select(got, want):
    row, best, count, pulls = got[:4]
    assert row == int(want[0])
    assert np.float64(best).view(np.int64) == np.float64(want[1]).view(
        np.int64)
    assert count == int(want[2])
    assert pulls == int(want[3])


def _check_select_shapes(case, spread_fit=False):
    jin = _jax_select_inputs(case)
    want = [np.asarray(x) for x in jscore.score_and_select(
        jin, spread_fit=spread_fit)]
    perm = case["perm"]
    f_w, s_w = _walk_columns(jin, perm, spread_fit)
    limit, n_cand = int(case["limit"]), int(case["n_candidates"])
    for shape in SELECT_SHAPES:
        got = select_prefix(f_w, s_w, perm, limit, n_cand, *shape)
        _same_select(got, want)
        if got[3] < n_cand:  # a walk that stopped: at most its steps
            assert got[4] >= got[3]
    for nb in SELECT_GRIDS:
        _same_select(select_grid(f_w, s_w, perm, limit, n_cand, nb), want)


def _all_bad(case):
    """Every feasible candidate scores <= 0: penalised, affinity -1."""
    case["penalty"][:] = True
    case["affinity_score"][:] = -1.0
    return case


@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("limit", [2, 14, INT32_MAX])
@pytest.mark.parametrize("n_cand", [200, 60])
@pytest.mark.parametrize("scenario", sorted(SCORE_SCENARIOS) + ["all_bad"])
def test_select_shapes_match_jax_score_and_select(scenario, n_cand, limit,
                                                  spread_fit):
    """K1's prefix walk (three block shapes) and its grid (1-64 blocks)
    against the JAX `score_and_select` on a 256-row arena: fewer
    candidates than rows, limits that stop early and the unlimited
    walk, 0-4 bad nodes with and without good ones (two diverted
    replayed reversed behind a good node), all of them bad."""
    seed = 2800 + (sorted(SCORE_SCENARIOS) + ["all_bad"]).index(scenario)
    if scenario == "all_bad":
        case = _all_bad(score_case(seed, C, n_cand, "mixed", limit))
    else:
        case = score_case(seed, C, n_cand, scenario, limit)
    _check_select_shapes(case, spread_fit)


@pytest.mark.parametrize("limit", [2, 14, INT32_MAX])
@pytest.mark.parametrize("scenario", sorted(POLICY_SCORE_SCENARIOS))
def test_select_shapes_match_jax_with_policy_terms(scenario, limit):
    seed = 2900 + sorted(POLICY_SCORE_SCENARIOS).index(scenario)
    _check_select_shapes(policy_score_case(seed, C, 200, scenario, limit))


@pytest.mark.parametrize("edge", sorted(SELECT_EDGES))
def test_select_edges_match_jax_score_and_select(edge):
    """K1's launch-shape edges (`SELECT_EDGES`, which chip_smoke.py and
    the card tests run on the shape K1's rule takes) on a 1,024-row
    arena: both shapes' models against the JAX `score_and_select`, among
    them a limit equal to the candidates, every one feasible and good,
    whose limit-th position ends the grid's walk in a later block."""
    _check_select_shapes(select_edge_case(
        2950 + sorted(SELECT_EDGES).index(edge), 1024, 600, edge))


# -- K6's given-score walk in K1's two shapes (csrc/walk_only.cu) ----------


def walk_only_prefix(feasible, scores, perm, limit, n_cand, threads, first,
                     wide, count):
    """K6's prefix walk: one pick over all C walk positions, no rotation,
    each step reading only its positions' perm entries, then those rows'
    feasibility and (where feasible) score as given; pulls n_candidates
    where the walk is dry.  With `count` the positions it did not walk
    are then swept for feasibility alone; without it the count is -1.
    Returns (row, best, feasible_count, pulls, positions walked)."""
    C = len(perm)
    walked_feasible = [0]

    def step(ws, _record):
        rows = perm[ws]
        f = feasible[rows]
        walked_feasible[0] += int(f.sum())
        return np.where(f, scores[rows], 0.0).tolist(), f.tolist()

    win_w, pulls, walked, best = prefix_walk(step, limit, C, threads, first,
                                             wide, n_dry=n_cand)
    n = (walked_feasible[0] + int(feasible[perm[walked:]].sum()) if count
         else -1)
    row = int(perm[win_w]) if win_w >= 0 else NO_NODE
    return row, best, n, pulls, walked


def walk_only_grid(feasible, scores, perm, limit, n_cand, nb):
    """K6's grid: `grid_walk` whose source reads the given vectors
    through perm in every pass (no scratch).  Returns (row, best,
    feasible_count, pulls)."""
    def flags_at(w):
        r = perm[w]
        return bool(feasible[r]), bool(feasible[r] and scores[r] <= 0.0)

    win, best, count, pulls = grid_walk(
        flags_at, lambda w: scores[perm[w]], len(perm), limit, n_cand, nb)
    return (int(perm[win]) if win >= 0 else NO_NODE), best, count, pulls


_jax_walk_only = jax.jit(_walk_only)
WALK_GRIDS = [1, 3, 128]


def _same_walk_only(got, want, count=True):
    row, best, n, pulls = got[:4]
    assert row == int(want[0])
    assert np.asarray(best, want[1].dtype).tobytes() == want[1].tobytes()
    assert n == (int(want[2]) if count else -1)
    assert pulls == int(want[3])


def _check_walk_only(case, grids=WALK_GRIDS):
    """Both of K6's shapes against the JAX `_walk_only`: the prefix walk
    at every schedule of `SCHEDULES`, with the count and without it, and
    the grid over `grids` blocks."""
    feasible, scores, perm = case["feasible"], case["scores"], case["perm"]
    limit, n_cand = int(case["limit"]), int(case["n_candidates"])
    want = [np.asarray(x) for x in _jax_walk_only(
        feasible, scores, perm, np.int32(limit), np.int32(n_cand))]
    for shape in SCHEDULES:
        for count in (True, False):
            got = walk_only_prefix(feasible, scores, perm, limit, n_cand,
                                   *shape, count)
            _same_walk_only(got, want, count)
            if got[3] < n_cand:  # a walk that stopped: at most its steps
                assert got[4] >= got[3]
    for nb in grids:
        _same_walk_only(walk_only_grid(feasible, scores, perm, limit, n_cand,
                                       nb), want)


WALK_C = 256
WALK_LIMITS = [1, 2, 14, "n_cand", INT32_MAX]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("limit", WALK_LIMITS)
@pytest.mark.parametrize("scenario", sorted(WALK_SCENARIOS))
def test_walk_only_shapes_match_jax_walk_only(scenario, limit, dtype):
    """K6's prefix walk (every schedule, count on and off) and its grid
    (1, 3 and 128 blocks) against the JAX `_walk_only` over `walk_case`
    vectors: spliced scores, limit 1, a limit equal to the candidates
    and beyond them, 0-4 bad positions (two diverted behind good nodes),
    none feasible, a feasible tail past n_candidates."""
    seed = 3100 + sorted(WALK_SCENARIOS).index(scenario)
    n_cand = (4 * WALK_C) // 5
    lim = n_cand if limit == "n_cand" else limit
    _check_walk_only(walk_case(seed, WALK_C, scenario, lim, dtype))


@pytest.mark.parametrize("limit", [1, 2, 3, 14, INT32_MAX])
@pytest.mark.parametrize("scenario", ["div2", "div4", "spliced", "tail"])
def test_walk_only_shapes_at_every_offset(scenario, limit):
    """A 37-position arena at every rotation of its candidates (the
    stack's walk order at each pull offset, the vacant rows after): two
    bad positions behind a good node and the reversed replay, the
    diverted positions at each place of the wrap, the tail."""
    seed = 3200 + ["div2", "div4", "spliced", "tail"].index(scenario)
    case = walk_case(seed, 37, scenario, limit)
    perm, n_cand = case["perm"], int(case["n_candidates"])
    for off in range(n_cand):
        rotated = np.concatenate([perm[off:n_cand], perm[:off],
                                  perm[n_cand:]]).astype(np.int32)
        _check_walk_only(dict(case, perm=rotated), grids=[1, 3, 37])


def test_walk_only_two_diverted_behind_a_good_node():
    """Two bad positions behind one good one, limit beyond the region:
    the walk consumes it and the diverted pair is replayed reversed; a
    third bad position after them competes as non-diverted."""
    C = 40
    perm = np.random.default_rng(3300).permutation(C).astype(np.int32)
    feasible = np.zeros(C, bool)
    scores = np.full(C, -np.inf)
    for w, s in ((3, 0.5), (7, -0.25), (9, -0.0), (20, -0.5)):
        feasible[perm[w]] = True
        scores[perm[w]] = s
    for limit in (1, 2, 3, 4, 5, INT32_MAX):
        _check_walk_only(dict(feasible=feasible, scores=scores, perm=perm,
                              limit=limit, n_candidates=32),
                         grids=[1, 2, 3, 40])


# -- K9's chain of prefix walks (csrc/chained_prefix.cuh) -------------------


def _spread_totals(sp, e, prop, clr, dtype):
    """Every row's spread boost (node layout) at the pick's state: the
    twin's `spread_contribution` over the eval's codes."""
    codes = torch.from_numpy(sp["codes"][e]).long()
    desired = torch.from_numpy(sp["desired"][e]).to(dtype)
    V1 = desired.shape[1]
    desired_node = torch.gather(desired, 1, codes)
    safe = torch.where(desired_node != 0, desired_node,
                       torch.ones((), dtype=dtype))
    even = sp.get("even")
    return tbatch.spread_contribution(
        codes, desired_node, codes == V1 - 1, safe,
        torch.from_numpy(sp["used0"][e]).to(dtype), prop, clr,
        torch.from_numpy(sp["weight"][e]).to(dtype),
        torch.from_numpy(sp["active"][e]),
        None if even is None else torch.from_numpy(even[e]))


def prefix_eval(e, cols, kw, threads, first, wide, dtype, spread_fit,
                usage, slot, pos_of, stats, rows_out, pulls_out):
    """Eval e as `run_chain_eval` runs it (one group), a generator that
    yields once its start is done and after each pick, so that a caller
    can interleave evals as concurrent blocks run them.  `usage(row)`
    gives a row's node-space usage (K9: the chain's carry; K10: the
    eval's own base); `slot` holds the block's state, which the eval's
    start resets: its score cache by walk position (off with spread;
    written only on steps of `threads` positions or more; cleared at a
    won position and, through `pos_of`, at an evicted row; cleared at
    the pick's penalty rows when it opens, which its steps then score
    afresh and do not record) and its spread state.  `pos_of` (K9 only:
    None in the per-eval mode, which has no evictions or penalty rows)
    maps a recorded row to its walk position, outlives the eval and is
    trusted only where the eval's walk order maps it back.  Entries (a
    row's usage and collisions this eval) are made at a row's first
    eviction or win and updated in pick order.  Writes rows_out[e] and
    pulls_out[e]."""
    b = kw["batch"]
    P = kw["n_picks"]
    sp, dl = kw.get("spread"), kw.get("deltas")
    totals = tuple(torch.from_numpy(cols[k]).to(dtype)
                   for k in ("cpu_total", "mem_total", "disk_total"))

    def scal(x):
        return torch.tensor(x, dtype=dtype)

    ask = [scal(b[f"ask_{k}"][e]) for k in ("cpu", "mem", "disk")]
    desired = scal(float(b["desired_count"][e]))
    perm = b["perm"][e]
    n_cand, limit = int(kw["n_candidates"][e]), int(b["limit"][e])
    dh = bool(b["distinct_hosts"][e])
    feas = torch.from_numpy(b["feasible"][e])
    coll0 = b["base_collisions"][e]
    static_pen = b["penalty"][e]
    aff = torch.from_numpy(b["affinity_score"][e]).to(dtype)
    entries = {}
    cache_on = sp is None
    # the block's state starts over with the eval
    slot["known"] = {}
    if sp is not None:
        V1 = sp["desired"].shape[2]
        codes = sp["codes"][e]
        slot["prop"] = torch.from_numpy(sp["proposed0"][e]).to(dtype)
        slot["clr"] = torch.from_numpy(sp["cleared0"][e]).to(dtype)
    yield

    def entry(row):
        if row not in entries:
            entries[row] = [*usage(row), int(coll0[row])]
        return entries[row]

    def forget(row):
        p = pos_of.get(row, -1)
        return (0 <= p < n_cand and int(perm[p]) == row
                and slot["known"].pop(p, None) is not None)

    def bump(key, row):
        slot[key] = slot[key] + torch.nn.functional.one_hot(
            torch.from_numpy(codes[:, row]).long(), V1).to(dtype)

    offset, dead = 0, False
    for k in range(P):
        if k >= int(kw["wanted"][e]) or dead:
            continue
        pen_rows = set()
        if dl is not None:
            erow = int(dl["evict_rows"][e, k])
            if erow >= 0:
                ent = entry(erow)
                for i, name in enumerate(("cpu", "mem", "disk")):
                    ent[i] = ent[i] + scal(dl[f"evict_{name}"][e, k])
                ent[3] = ent[3] + int(dl["evict_coll"][e, k])
                stats["cleared"] += forget(erow)
                if sp is not None:
                    bump("clr", erow)
            pen_rows = {int(r) for r in dl["penalty_rows"][e, k] if r >= 0}
            stats["bypassed"] += sum(forget(r) for r in pen_rows)
        spread_tot = (_spread_totals(sp, e, slot["prop"], slot["clr"], dtype)
                      if sp is not None else None)

        def score_fresh(rws, pen_rows=pen_rows, spread_tot=spread_tot):
            r = torch.tensor(rws, dtype=torch.long)
            used = [torch.stack([entries[x][i] if x in entries
                                 else usage(x)[i] for x in rws])
                    for i in range(3)]
            coll = torch.tensor([entries[x][3] if x in entries
                                 else int(coll0[x]) for x in rws],
                                dtype=torch.int32)
            pen = torch.tensor([bool(static_pen[x]) or x in pen_rows
                                for x in rws])
            after = [u + a for u, a in zip(used, ask)]
            f = (feas[r] & (after[0] <= totals[0][r])
                 & (after[1] <= totals[1][r]) & (after[2] <= totals[2][r]))
            if dh:
                f = f & ~(coll > 0)
            s = _score_positions(
                r, used, coll, pen, aff[r], totals, ask, desired,
                spread_fit, dtype,
                None if spread_tot is None else spread_tot[r])
            return s.tolist(), f.tolist()

        def score_at(ws, record, offset=offset, pen_rows=pen_rows,
                     score_fresh=score_fresh):
            known = slot["known"]
            ps = [(w + offset) % n_cand for w in ws]
            fresh = [p for p in ps if p not in known]
            stats["hits"] += len(ps) - len(fresh)
            rws = [int(perm[p]) for p in fresh]
            got = (dict(zip(fresh, zip(*score_fresh(rws))))
                   if fresh else {})
            if record and cache_on:
                for p, x in zip(fresh, rws):
                    if x not in pen_rows:
                        known[p] = got[p]
                        if pos_of is not None:
                            pos_of[x] = p
            out = [got[p] if p in got else known[p] for p in ps]
            return [o[0] for o in out], [o[1] for o in out]

        win_w, n_pulls, _, _ = prefix_walk(score_at, limit, n_cand,
                                           threads, first, wide)
        pulls_out[e, k] = n_pulls
        if win_w < 0:
            dead = True
        else:
            row = int(perm[(win_w + offset) % n_cand])
            rows_out[e, k] = row
            ent = entry(row)
            for i in range(3):
                ent[i] = ent[i] + ask[i]
            ent[3] = ent[3] + 1
            slot["known"].pop((win_w + offset) % n_cand, None)
            if sp is not None:
                bump("prop", row)
        offset = (offset + n_pulls) % n_cand
        yield


def chained_prefix(cols, kw, threads, first, wide, dtype, spread_fit=False):
    """K9's chain as the kernel runs it (one group, one block): the
    node-space carry (the carry-in overlaid by the rows rebuilt so far),
    and per eval its pre-deltas, then `prefix_eval` over the carry,
    then the carry rebuilt: asks in pick order, then the applied
    evictions.  Returns (rows, pulls, cache stats)."""
    b = kw["batch"]
    E, _C = b["perm"].shape
    P = kw["n_picks"]
    dl, pre = kw.get("deltas"), kw.get("pre")
    carry_in = [torch.from_numpy(b[f"base_{k}_used"][0]).to(dtype)
                for k in ("cpu", "mem", "disk")]
    dirty = {}  # row -> its node-space usage, where rebuilt

    def carry(row):
        return dirty.get(row) or [c[row] for c in carry_in]

    def add_carry(row, d):
        cur = carry(row)
        dirty[row] = [cur[i] + d[i] for i in range(3)]

    def scal(x):
        return torch.tensor(x, dtype=dtype)

    stats = {"hits": 0, "cleared": 0, "bypassed": 0}
    pos_of = {}  # row -> the walk position a step recorded it at
    slot = {}  # the block's state
    rows_out = np.full((E, P), NO_NODE, np.int32)
    pulls_out = np.zeros((E, P), np.int32)
    for e in range(E):
        if pre is not None:
            for r in range(pre["rows"].shape[1]):
                add_carry(int(pre["rows"][e, r]),
                          [scal(pre[k][e, r]) for k in ("cpu", "mem", "disk")])
        for _ in prefix_eval(e, cols, kw, threads, first, wide, dtype,
                             spread_fit, carry, slot, pos_of, stats,
                             rows_out, pulls_out):
            pass
        ask = [scal(b[f"ask_{k}"][e]) for k in ("cpu", "mem", "disk")]
        for k in range(P):
            if rows_out[e, k] >= 0:
                add_carry(int(rows_out[e, k]), ask)
        if dl is not None:
            for k in range(P):
                erow = int(dl["evict_rows"][e, k])
                if pulls_out[e, k] > 0 and erow >= 0:
                    add_carry(erow, [scal(dl[f"evict_{n}"][e, k])
                                     for n in ("cpu", "mem", "disk")])
    return rows_out, pulls_out, stats


def batch_plan_prefix(cols, kw, threads, first, wide, dtype,
                      spread_fit=False, slot_of=lambda e: e):
    """K10 as the kernel runs it: one block an eval, each `prefix_eval`
    in the per-eval mode (its own base usage, row e of base_*_used,
    nothing written to node space, no pre-deltas, evictions or penalty
    rows, every pick wanted), the blocks' picks interleaved pick by pick
    as concurrent blocks run them, eval e's state in slot `slot_of(e)`.
    Returns (rows, pulls, cache stats)."""
    b = kw["batch"]
    E, _C = b["perm"].shape
    P = kw["n_picks"]
    kw = dict(kw, deltas=None, pre=None, wanted=np.full(E, P, np.int32))
    base = [torch.from_numpy(b[f"base_{k}_used"]).to(dtype)
            for k in ("cpu", "mem", "disk")]
    stats = {"hits": 0, "cleared": 0, "bypassed": 0}
    slots = {}
    rows_out = np.full((E, P), NO_NODE, np.int32)
    pulls_out = np.zeros((E, P), np.int32)
    blocks = [prefix_eval(e, cols, kw, threads, first, wide, dtype,
                          spread_fit,
                          lambda row, e=e: [u[e, row] for u in base],
                          slots.setdefault(slot_of(e), {}), None, stats,
                          rows_out, pulls_out)
              for e in range(E)]
    while blocks:
        for blk in list(blocks):
            if next(blk, StopIteration) is StopIteration:
                blocks.remove(blk)
    return rows_out, pulls_out, stats


def _jax_chained(cols, kw, spread_fit=False):
    extra = {}
    for name, cls in (("spread", jbatch.SpreadInputs),
                      ("deltas", jbatch.StepDeltas),
                      ("pre", jbatch.PreDeltas)):
        if kw.get(name) is not None:
            extra[name] = cls(**kw[name])
    return np.asarray(jbatch.chained_plan_picks(
        cols["cpu_total"], cols["mem_total"], cols["disk_total"],
        jbatch.BatchInputs(**kw["batch"]), kw["n_candidates"],
        kw["n_picks"], spread_fit=spread_fit, wanted=kw["wanted"], **extra))


def _twin_pulls(cols, kw, dtype):
    args, kwargs = batched_case_to_torch(cols, kw, "cpu", dtype)
    q = tbatch.prepare_batched(*args, **kwargs)
    rows, pulls = tbatch.chained_picks_twin(tbatch.batched_as_chain(q))[:2]
    return rows.numpy(), pulls.numpy()


CHAIN_SHAPES = [(256, 64, 2), (32, 8, 2), (8, 2, 2)]


@pytest.mark.parametrize("threads,first,wide", CHAIN_SHAPES)
@pytest.mark.parametrize("scenario", sorted(BATCHED_SCENARIOS))
def test_chained_prefix_matches_jax_chained_plan_picks(scenario, threads,
                                                       first, wide):
    """The chain of prefix walks against the JAX `chained_plan_picks`
    (rows) and the port's twin (pulls), under x64: spread, step deltas,
    pre-deltas, `wanted`, distinct_hosts, little room, per-eval
    candidate counts, and long walks with and without the score cache."""
    E, P = 4, 12
    cols, kw = batched_case(
        2700 + 10 * sorted(BATCHED_SCENARIOS).index(scenario), C, N_CAND,
        scenario, E, P)
    rows, pulls, _ = chained_prefix(cols, kw, threads, first, wide,
                                    torch.float64)
    np.testing.assert_array_equal(rows, _jax_chained(cols, kw))
    np.testing.assert_array_equal(pulls, _twin_pulls(cols, kw,
                                                     torch.float64)[1])


@pytest.mark.parametrize("scenario", ["everything", "unlimited_evict",
                                      "unlimited_spread_evict"])
def test_chained_prefix_matches_the_f32_twin(scenario):
    E, P = 4, 12
    cols, kw = batched_case(
        2750 + sorted(BATCHED_SCENARIOS).index(scenario), C, N_CAND,
        scenario, E, P)
    rows, pulls, _ = chained_prefix(cols, kw, 32, 8, 2, torch.float32)
    want_rows, want_pulls = _twin_pulls(cols, kw, torch.float32)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(pulls, want_pulls)


def test_chained_prefix_cache_rules_are_exercised():
    """On long walks with step deltas the cache is read, an evicted row
    it held is cleared, and a penalty row it held is cleared for the
    pick: each rule met at least once, and the chain still equals the
    JAX program's."""
    E, P = 4, 12
    cols, kw = batched_cache_case(2790, C, N_CAND, E, P)
    rows, _pulls, stats = chained_prefix(cols, kw, 8, 2, 2, torch.float64,
                                         spread_fit=True)
    np.testing.assert_array_equal(rows, _jax_chained(cols, kw,
                                                     spread_fit=True))
    assert all(rows[e, 3] == kw["batch"]["perm"][e, 7] for e in range(E))
    assert stats["hits"] > 0 and stats["cleared"] > 0
    assert stats["bypassed"] > 0


def _shared_as_batched_case(case):
    """A `batch_shared_case` in `batched_case`'s layout: every eval the
    same feasibility and usage, no collisions, penalty or affinity,
    distinct_hosts off, each eval wanting its count."""
    E, C_ = case["perms"].shape
    rep = lambda x: np.repeat(np.asarray(x)[None], E, axis=0)  # noqa: E731
    batch = dict(
        feasible=rep(case["feasible"]),
        base_cpu_used=rep(case["base_cpu_used"]),
        base_mem_used=rep(case["base_mem_used"]),
        base_disk_used=rep(case["base_disk_used"]),
        base_collisions=np.zeros((E, C_), np.int32),
        penalty=np.zeros((E, C_), bool), affinity_score=np.zeros((E, C_)),
        perm=case["perms"], ask_cpu=case["ask_cpu"], ask_mem=case["ask_mem"],
        ask_disk=case["ask_disk"], desired_count=case["desired_count"],
        limit=case["limit"], distinct_hosts=np.zeros(E, bool))
    cols = {k: case[k] for k in ("cpu_total", "mem_total", "disk_total")}
    kw = dict(batch=batch,
              n_candidates=np.full(E, case["n_candidates"], np.int32),
              n_picks=case["n_picks"], wanted=case["desired_count"])
    return cols, kw


@pytest.mark.parametrize("threads,first,wide", CHAIN_SHAPES)
@pytest.mark.parametrize("scenario", BATCH_SHARED_SCENARIOS)
def test_chained_prefix_matches_jax_chained_plan_picks_shared(
        scenario, threads, first, wide):
    E, P = 4, 10
    case = batch_shared_case(
        4700 + 10 * BATCH_SHARED_SCENARIOS.index(scenario), C, N_CAND,
        scenario, E, P)
    want = np.asarray(jbatch.chained_plan_picks_shared(**case))
    cols, kw = _shared_as_batched_case(case)
    rows, _pulls, _ = chained_prefix(cols, kw, threads, first, wide,
                                     torch.float64)
    np.testing.assert_array_equal(rows, want)


# -- K10: K9's eval body one block an eval (csrc/batch_plan.cu) -------------


def _k10_n_cand(kw, mode):
    """n_candidates as `batch_plan_picks` takes it: one per eval, or one
    scalar (the least eval's region) for every eval."""
    nc = np.asarray(kw["n_candidates"], np.int32)
    return nc if mode == "per_eval" else np.int32(nc.min())


def _jax_batch_plan(cols, kw, n_cand, spread_fit=False):
    extra = ({} if kw.get("spread") is None
             else {"spread": jbatch.SpreadInputs(**kw["spread"])})
    return np.asarray(jbatch.batch_plan_picks(
        cols["cpu_total"], cols["mem_total"], cols["disk_total"],
        jbatch.BatchInputs(**kw["batch"]), n_cand, kw["n_picks"],
        spread_fit=spread_fit, **extra))


def _k10_twin(cols, kw, n_cand, dtype, spread_fit=False):
    """The port's plain twin of K10 on the CPU: `batch_plan_picks_twin`'s
    rows and `batch_plan_twin`'s pulls."""
    args, kwargs = batched_case_to_torch(cols, kw, "cpu", dtype)
    spread = kwargs.get("spread")
    rows = tbatch.batch_plan_picks_twin(*args[:4], n_cand, args[5],
                                        spread_fit, spread=spread)
    pulls = tbatch.batch_plan_twin(tbatch.prepare_batched(
        *args[:4], n_cand, args[5], spread_fit, spread=spread))[1]
    return rows.numpy(), pulls.numpy()


def _k10_model(cols, kw, n_cand, threads, first, wide, dtype,
               spread_fit=False):
    E = kw["batch"]["perm"].shape[0]
    kw = dict(kw, n_candidates=np.broadcast_to(n_cand, (E,)))
    return batch_plan_prefix(cols, kw, threads, first, wide, dtype,
                             spread_fit)


# n_candidates one per eval in every scenario, one scalar where every
# eval has the same candidate region: a scalar below an eval's region
# would put feasible entries in its walk's tail, which no caller does
K10_MODES = [(s, "per_eval") for s in sorted(BATCHED_SCENARIOS)] + [
    (s, "scalar") for s in sorted(BATCHED_SCENARIOS)
    if "few_cand" not in BATCHED_SCENARIOS[s]]


@pytest.mark.parametrize("threads,first,wide", CHAIN_SHAPES)
@pytest.mark.parametrize("scenario,n_cand_mode", K10_MODES)
def test_batch_plan_prefix_matches_jax_batch_plan_picks(scenario,
                                                        n_cand_mode, threads,
                                                        first, wide):
    """K10's blocks (the per-eval mode of K9's eval body, interleaved
    pick by pick) against the JAX `batch_plan_picks` (rows) and the
    port's twin (pulls), under x64: each eval over its own base usage,
    feasibility, collisions, penalty, affinity, distinct_hosts and
    spread, every pick wanted (the cases' step deltas, pre-deltas and
    `wanted` are the chain's, not K10's), n_candidates one per eval or
    one scalar, long walks with the score cache and without it."""
    E, P = 4, 12
    cols, kw = batched_case(
        2850 + 10 * sorted(BATCHED_SCENARIOS).index(scenario), C, N_CAND,
        scenario, E, P)
    n_cand = _k10_n_cand(kw, n_cand_mode)
    rows, pulls, _ = _k10_model(cols, kw, n_cand, threads, first, wide,
                                torch.float64)
    np.testing.assert_array_equal(rows, _jax_batch_plan(cols, kw, n_cand))
    np.testing.assert_array_equal(
        pulls, _k10_twin(cols, kw, n_cand, torch.float64)[1])


@pytest.mark.parametrize("scenario", ["everything", "spread",
                                      "unlimited_evict",
                                      "unlimited_spread_evict"])
def test_batch_plan_prefix_matches_the_f32_twin(scenario):
    E, P = 4, 12
    cols, kw = batched_case(
        2880 + sorted(BATCHED_SCENARIOS).index(scenario), C, N_CAND,
        scenario, E, P)
    n_cand = _k10_n_cand(kw, "per_eval")
    rows, pulls, _ = _k10_model(cols, kw, n_cand, 32, 8, 2, torch.float32)
    want_rows, want_pulls = _k10_twin(cols, kw, n_cand, torch.float32)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(pulls, want_pulls)


@pytest.mark.parametrize("spread_fit", [False, True])
def test_batch_plan_prefix_reads_its_score_cache(spread_fit):
    """The cache case (`batched_cache_case`, its step deltas dropped:
    K10 has none) on long walks: every eval's later picks read back
    what its earlier steps scored, and the rows still equal the JAX
    program's; 16 evals, so that the blocks' slices of the cache and the
    spread state are many."""
    E, P = 16, 12
    cols, kw = batched_cache_case(2890, C, N_CAND, E, P)
    n_cand = _k10_n_cand(kw, "per_eval")
    rows, pulls, stats = _k10_model(cols, kw, n_cand, 8, 2, 2,
                                    torch.float64, spread_fit)
    np.testing.assert_array_equal(
        rows, _jax_batch_plan(cols, kw, n_cand, spread_fit))
    np.testing.assert_array_equal(
        pulls, _k10_twin(cols, kw, n_cand, torch.float64, spread_fit)[1])
    assert stats["hits"] > 0


def test_batch_plan_prefix_blocks_keep_their_own_state():
    """Sixteen evals with spread, interleaved pick by pick: a block's
    spread state is its own.  Eval 0 alone gives the same rows as eval 0
    among the others (its slice is not another block's)."""
    E, P = 16, 6
    cols, kw = batched_case(2895, C, N_CAND, "spread", E, P)
    n_cand = _k10_n_cand(kw, "per_eval")
    rows, _, _ = _k10_model(cols, kw, n_cand, 32, 8, 2, torch.float64)
    np.testing.assert_array_equal(rows, _jax_batch_plan(cols, kw, n_cand))
    one = {k: v[:1] if isinstance(v, np.ndarray) and v.ndim and
           v.shape[0] == E else v for k, v in kw["batch"].items()}
    sp = {k: None if v is None else v[:1] for k, v in kw["spread"].items()}
    alone, _, _ = _k10_model(cols, dict(kw, batch=one, spread=sp), n_cand[:1],
                             32, 8, 2, torch.float64)
    np.testing.assert_array_equal(alone[0], rows[0])
