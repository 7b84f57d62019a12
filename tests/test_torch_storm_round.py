"""The storm auction's round as kernels K5 and K14 run it
(`nomad_tpu_torch/csrc/storm_round.cuh`), held against the JAX program.

`round_model` is a plain model of the cooperative kernels' rounds: the
bidding rows split into (row, chunk) items as phase B splits them for a
grid of `warps` warps and D node shards, each item's best (value +
jitter, value, node), the items reduced in order, the owner's read (its
value plus +0.0 from every other shard), the round-0 walk-winner rule;
then phase RD: the bidders compacted in row order and sorted by (node,
value descending, row) with -0.0 reading +0.0, each node segment's
largest ask and budget m, acceptance by place in the segment (the bound
max(1, m) as the kernel computes it), price += 0.01 on every node with
a bidder, the accepted rows sorted by (node, row) and each node's asks
summed in that order, and the next round's bidders (the bidders not
accepted: a row without a bid leaves the bidding for good).

It is held bit-equal in all six outputs to `nomad_tpu.ops.solve
.storm_assignment` on the CPU under x64 (D = 1; at D > 1 a zero score
reads +0.0), on `ops/cases.py storm_case` scenarios (ties, fractional
asks, one node with 1,024 bidders, A = 1, infeasible and padding rows,
round budgets of 1 and 2, A above 1,024) and on hypothesis-drawn
storms; and to `ops/solve.py storm_auction_twin` on drawn score
matrices with -0.0 and +0.0 bids and ties.

K14's launch paths with recording stand-ins that run the twin's stages:
on a VirtualMesh the score stages, the walk and one cooperative launch
for the rounds, with no read of the progress flag on the host; on a
gloo DistMesh the staged launches, one host read a round; more than
STORM_COOP_MAX_SHARDS shards raises before anything is built; a failed
cooperative launch raises DeviceFault with nothing run in its place.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from nomad_tpu.ops import solve as jsolve
from nomad_tpu_torch.device import DeviceFault
from nomad_tpu_torch.ops import _cuda
from nomad_tpu_torch.ops import solve as tsolve
from nomad_tpu_torch.ops.cases import storm_case
from nomad_tpu_torch.parallel.mesh import DistMesh, VirtualMesh
from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

COLS = ("cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
        "disk_used")
INT32_MAX = 2**31 - 1
WARPS = 132 * 32  # one 1,024-thread block a multiprocessor of an H100
MAX_SUB = 64  # storm_round.cuh kMaxSub


# -- the model -----------------------------------------------------------------


def chunks_a_shard(n_act: int, S: int, D: int, warps: int) -> int:
    """storm_round.cuh chunks_a_shard."""
    pairs = max(1, n_act * D)
    if pairs >= warps:
        return 1
    return max(1, min(min((warps + pairs - 1) // pairs, MAX_SUB // D),
                      S // 32))


def owner_psum(v, owner: int, D: int, f):
    """The psum of the owner's term, +0.0 from every other shard, in shard
    order from shard 0's."""
    zero = f(0.0)
    acc = v if owner == 0 else zero
    for d in range(1, D):
        acc = acc + (v if d == owner else zero)
    return acc


def _better(a, b) -> bool:
    """bid_better on (value + jitter, node) pairs."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def round_model(feas, scores, rows0, ask, real, free, max_rounds: int,
                D: int = 1, warps: int = WARPS, state: bool = False):
    """The cooperative kernels' rounds on numpy inputs (feas bool [A, C],
    scores [A, C], rows0 i32 [A], ask [A, 3], real bool [A], free [C,
    3]): returns (assigned, accept_round, rounds), and with `state` the
    nodes' final free capacity and prices."""
    f = scores.dtype.type
    A, C = scores.shape
    S = C // D
    neg_inf = f(-np.inf)
    jitter = tsolve.storm_jitter(A, C, torch.from_numpy(scores).dtype,
                                 "cpu").numpy()
    node_free = free.copy()
    price = np.zeros(C, scores.dtype)
    assigned = np.full(A, -1, np.int32)
    acc_round = np.full(A, -1, np.int32)
    active = [a for a in range(A) if real[a]]
    rnd = 0
    progress = True
    while rnd < max_rounds and progress:
        n_act = len(active)
        k = chunks_a_shard(n_act, S, D, warps)
        per_row = D * k
        chunk = -(-S // k)
        bids = []
        for i, row in enumerate(active):
            ok = feas[row] & (node_free >= ask[row]).all(axis=1)
            value = np.where(ok, scores[row] - price, neg_inf)
            vj = value + jitter[row]
            best = (neg_inf, INT32_MAX, neg_inf)
            for ch in range(per_row):
                s = ch // k
                g0 = s * S + (ch - s * k) * chunk
                g1 = min(s * S + S, g0 + chunk)
                if g0 >= g1:
                    item = (neg_inf, INT32_MAX, neg_inf)
                else:
                    g = g0 + int(np.argmax(vj[g0:g1]))
                    item = (vj[g], g, value[g])
                if _better(item, best):
                    best = item
            bid_c = best[1]
            bid_v = owner_psum(best[2], bid_c // S, D, f)
            if rnd == 0:
                w = min(max(int(rows0[row]), 0), C - 1)
                wv = owner_psum(value[w], w // S, D, f)
                if rows0[row] >= 0 and wv > neg_inf:
                    bid_c, bid_v = min(int(rows0[row]), C - 1), wv
            if bid_v > neg_inf:
                bids.append((i, row, bid_c, bid_v))
        # by (node, value descending (-0.0 reads +0.0), row)
        order = sorted(bids, key=lambda b: (b[2], -float(b[3] + f(0.0)), b[0]))
        accepted = []
        q = 0
        while q < len(order):
            node = order[q][2]
            seg = [b for b in order[q:] if b[2] == node]
            q += len(seg)
            mx = np.zeros(3, scores.dtype)
            for b in seg:
                mx = np.maximum(mx, ask[b[1]])
            m = f(np.inf)
            for d in range(3):
                if mx[d] > 0:
                    m = min(m, np.floor(node_free[node, d]
                                        / max(mx[d], f(1e-9))))
            size = len(seg)
            tau = size if m >= size else int(m) if m >= 1 else 1
            accepted += seg[:tau]
            price[node] = price[node] + f(0.01)
        for _i, row, node, _v in accepted:
            assigned[row] = node
            acc_round[row] = rnd
        for node in sorted({b[2] for b in accepted}):
            total = np.zeros(3, scores.dtype)
            for _i, row, _n, _v in sorted(b for b in accepted
                                          if b[2] == node):
                total = total + ask[row]
            node_free[node] = node_free[node] - total
        taken = {b[1] for b in accepted}
        active = [row for _i, row, _n, _v in bids if row not in taken]
        rnd += 1
        progress = len(bids) > 0
    if state:
        return assigned, acc_round, rnd, node_free, price
    return assigned, acc_round, rnd


def model_solve(cols, inp, max_rounds, D=1, warps=WARPS,
                dtype=torch.float64):
    """The six outputs through the twin's score matrix and warm start
    (`storm_scores`, `_walk_rows`) and `round_model`'s rounds."""
    tin = storm_inputs(inp, "cpu", dtype)
    tcols = storm_columns(cols, "cpu", dtype)
    feas, scores, si = tsolve.storm_scores(tin, tcols, False)
    rows0, pulls0 = tsolve._walk_rows(feas, scores, si.perm, si.limit,
                                      si.n_candidates)
    free = torch.stack([tcols[0] - si.cpu_used, tcols[1] - si.mem_used,
                        tcols[2] - si.disk_used], dim=1)
    scores_n = scores.numpy()
    assigned, acc_round, rounds = round_model(
        feas.numpy(), scores_n, rows0.numpy(), tin.ask.numpy(),
        tin.real.numpy(), free.numpy(), max_rounds, D, warps)
    C = scores_n.shape[1]
    S = C // D
    f = scores_n.dtype.type
    solved = assigned >= 0
    kept = solved & (assigned == rows0.numpy())
    pulls = np.where(kept, pulls0.numpy(), si.n_candidates.numpy())
    score = np.array([
        owner_psum(scores_n[a, assigned[a]], assigned[a] // S, D, f)
        if solved[a] else f(0.0) for a in range(len(assigned))],
        scores_n.dtype)
    return [assigned, pulls.astype(np.int32), acc_round, score,
            rows0.numpy(), np.int32(rounds)]


def run_jax(cols, inp, max_rounds, dtype=np.float64):
    jin = jsolve.StormInputs(**{
        k: v.astype(dtype) if v.dtype.kind == "f" else v
        for k, v in inp.items()})
    out = jsolve.storm_assignment(
        jin, tuple(cols[k].astype(dtype) for k in COLS), spread_fit=False,
        max_rounds=max_rounds)
    return [np.asarray(x) for x in out]


def assert_same(got, want, sign_of_zero=True):
    for name, g, w in zip(tsolve.StormOut._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype.kind == "f":
            if sign_of_zero:
                assert np.array_equal(g.view(np.int64 if g.dtype == np.float64
                                             else np.int32),
                                      w.view(np.int64 if w.dtype == np.float64
                                             else np.int32)), name
            else:
                assert np.array_equal(g, w), name
        else:
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), name


# -- the model against the JAX program ----------------------------------------

CASES = [
    # (scenario, E, A, C)
    ("ties", 8, 64, 128),
    ("pre_deltas", 8, 64, 128),  # fractional asks: the debit's order shows
    ("dogpile", 64, 1024, 128),  # round 0: one node, 1,024 bidders
    ("one_row", 1, 1, 64),
    ("infeasible_rows", 8, 64, 128),
    ("padding_rows", 8, 64, 128),
    ("round_budget1", 8, 64, 128),
    ("round_budget2", 8, 64, 128),
    ("penalty_affinity_collisions", 8, 64, 128),
    ("dogpile", 32, 1100, 64),  # above one block's 1,024 rows
    ("uncontended", 32, 1100, 64),
]


@pytest.mark.parametrize("warps", [WARPS, 3])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("scenario,E,A,C", CASES)
def test_round_model_matches_jax(scenario, E, A, C, D, warps):
    seed = 8100 + [c[0] for c in CASES].index(scenario) + A
    cols, inp, max_rounds = storm_case(seed, E, A, C, scenario)
    want = run_jax(cols, inp, max_rounds)
    got = model_solve(cols, inp, max_rounds, D, warps)
    assert_same(got, want, sign_of_zero=D == 1)
    if scenario == "dogpile" and A == 1024:
        assert int(want[5]) >= 3
        # round 0 put every row's bid on the walk's first node
        assert np.unique(want[4]).size == 1


def test_round_model_in_f32_matches_jax():
    cols, inp, max_rounds = storm_case(8200, 8, 64, 128, "pre_deltas")
    want = run_jax(cols, inp, max_rounds, np.float32)
    got = model_solve(cols, inp, max_rounds, dtype=torch.float32)
    assert_same(got, want)


def drawn_storm(seed, n_nodes, frac_asks, tight, feas_p, budget):
    """A random storm of 24 rows over 8 evals and 64 nodes: tight nodes
    with room for a few asks, identical nodes (ties), whole or fractional
    asks, infeasible evals and a round budget."""
    rng = np.random.default_rng(seed)
    E, A, C = 8, 24, 64
    cols = dict(
        cpu_total=np.full(C, 4000.0), mem_total=np.full(C, 8192.0),
        disk_total=np.full(C, 50000.0),
        cpu_used=rng.choice([0.0, 1000.0, 2000.0, 3000.0], C),
        mem_used=rng.choice([0.0, 4096.0], C), disk_used=np.zeros(C))
    if tight:
        cols["cpu_used"][:] = 3000.0
    ask_e = rng.choice([500.0, 1000.0, 2000.0], (E, 1)) * np.ones((E, 3))
    ask_e[:, 2] = 100.0
    if frac_asks:
        ask_e = ask_e * rng.uniform(0.5, 1.0, (E, 1)) + rng.uniform(
            0.0, 1.0, (E, 3))
    perm = np.stack([rng.permutation(C) for _ in range(E)]).astype(np.int32)
    feasible = rng.random((E, C)) < feas_p
    feasible[:, n_nodes:] = False
    eval_of = (np.arange(A) * E // A).astype(np.int32)
    inp = dict(
        feasible=feasible, affinity=np.zeros((E, C)),
        collisions=np.zeros((E, C), np.int32), perm=perm,
        limit=rng.choice([1, 2, INT32_MAX], E).astype(np.int32),
        n_cand=np.full(E, C, np.int32), eval_of=eval_of,
        penalty=np.zeros((A, C), bool), ask=ask_e[eval_of],
        desired=np.ones(A, np.int32), real=np.arange(A) < A - 2,
        pre_cpu=np.zeros(C), pre_mem=np.zeros(C), pre_disk=np.zeros(C))
    return cols, inp, budget


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), n_nodes=st.sampled_from([2, 8, 64]),
       frac_asks=st.booleans(), tight=st.booleans(),
       feas_p=st.sampled_from([0.3, 0.9, 1.0]),
       budget=st.sampled_from([1, 2, 24]), D=st.sampled_from([1, 4]),
       warps=st.sampled_from([1, 7, WARPS]))
def test_round_model_matches_jax_drawn(seed, n_nodes, frac_asks, tight,
                                       feas_p, budget, D, warps):
    cols, inp, max_rounds = drawn_storm(seed, n_nodes, frac_asks, tight,
                                        feas_p, budget)
    want = run_jax(cols, inp, max_rounds)
    got = model_solve(cols, inp, max_rounds, D, warps)
    assert_same(got, want, sign_of_zero=D == 1)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), A=st.integers(1, 40),
       C=st.sampled_from([4, 16, 64]), budget=st.sampled_from([1, 3, 60]),
       D=st.sampled_from([1, 2, 4]), warps=st.sampled_from([1, 5, WARPS]))
def test_round_model_matches_the_twin_on_signed_zero_bids(seed, A, C, budget,
                                                          D, warps):
    """Scores of -0.0, +0.0 and a few repeated values, so bids tie in
    value and in sign of zero; rows without any ok node; asks of 0.1, 0.7
    and 1.3, whose sums depend on their order: the model's (assigned,
    accept_round, rounds) and its nodes' final free capacity and prices
    (the debit's row order) equal `storm_auction_twin`'s bit for bit."""
    rng = np.random.default_rng(seed)
    scores = rng.choice([-0.0, 0.0, 0.0, 0.25, -0.5, 1.0], (A, C))
    feas = rng.random((A, C)) < 0.7
    feas[rng.random(A) < 0.1] = False
    ask = rng.choice([0.1, 0.7, 1.3], (A, 3))
    free = rng.choice([0.0, 2.0, 5.0, 9.5], (C, 3))
    rows0 = np.where(rng.random(A) < 0.3, -1,
                     rng.integers(0, C, A)).astype(np.int32)
    real = rng.random(A) < 0.95
    want = tsolve.storm_auction_twin(
        torch.from_numpy(feas), torch.from_numpy(scores),
        torch.from_numpy(rows0), torch.from_numpy(ask),
        torch.from_numpy(real), torch.from_numpy(free), budget, state=True)
    got = round_model(feas, scores, rows0, ask, real, free, budget, D, warps,
                      state=True)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())
    assert got[2] == want[2]
    for g, w in zip(got[3:], want[3:]):
        assert np.array_equal(g.view(np.int64), w.numpy().view(np.int64))


def test_debit_adds_a_node_s_asks_in_row_order():
    # three rows accepted onto one node in one round, with asks whose sum
    # depends on the order of the additions
    ask = np.array([[0.1, 1.0, 1.0], [0.2, 1.0, 1.0], [0.3, 1.0, 1.0]])
    assert ((ask[0] + ask[1]) + ask[2] != (ask[2] + ask[1]) + ask[0]).any()
    scores = np.array([[1.0], [1.0], [1.0]])
    feas = np.ones((3, 1), bool)
    free = np.array([[1.0, 10.0, 10.0]])
    rows0 = np.full(3, -1, np.int32)
    real = np.ones(3, bool)
    got = round_model(feas, scores, rows0, ask, real, free, 1, state=True)
    want = tsolve.storm_auction_twin(
        torch.from_numpy(feas), torch.from_numpy(scores),
        torch.from_numpy(rows0), torch.from_numpy(ask),
        torch.from_numpy(real), torch.from_numpy(free), 1, state=True)
    assert got[0].tolist() == want[0].tolist() == [0, 0, 0]
    expect = free[0] - ((ask[0] + ask[1]) + ask[2])
    assert not np.array_equal(expect, free[0] - ((ask[2] + ask[1]) + ask[0]))
    assert np.array_equal(got[3][0], expect)
    assert np.array_equal(want[3].numpy()[0], expect)


def test_bid_order_treats_signed_zeros_as_equal():
    # a node with a -0.0 bid from row 0 and a +0.0 bid from row 1: rank
    # goes to the lower row, as the JAX comparison (-0.0 == +0.0) does
    scores = np.array([[-0.0, -np.inf], [0.0, -np.inf]])
    feas = np.array([[True, False], [True, False]])
    ask = np.ones((2, 3))
    free = np.array([[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]])
    rows0 = np.array([-1, -1], np.int32)
    real = np.ones(2, bool)
    for first in (0, 1):
        s = scores if first == 0 else scores[::-1].copy()
        got = round_model(feas, s, rows0, ask, real, free, 4)
        want = tsolve.storm_auction_twin(
            torch.from_numpy(feas), torch.from_numpy(s),
            torch.from_numpy(rows0), torch.from_numpy(ask),
            torch.from_numpy(real), torch.from_numpy(free), 4)
        assert got[0].tolist() == want[0].tolist() == [0, -1]
        assert got[2] == want[2] == 2


# -- K14's launch paths, with stand-ins ----------------------------------------


class _Coop:
    """Stands in for `_cuda.StormShardedCoop`: records the solve, and its
    launch runs the twin's rounds and epilogue on it."""

    made = []
    read_progress = None  # the host read the twin's rounds use

    def __init__(self, st, stamps=None, max_blocks=0):
        if not 1 <= st.D <= _cuda.STORM_COOP_MAX_SHARDS:
            raise ValueError(f"a cooperative K14 solve takes 1 to "
                             f"{_cuda.STORM_COOP_MAX_SHARDS} shards, got "
                             f"{st.D}")
        self.st, self.max_blocks, self.blocks = st, max_blocks, 0
        _Coop.made.append(self)

    def launch(self):
        saved = tsolve._read_progress
        tsolve._read_progress = _Coop.read_progress
        try:
            tsolve._storm_rounds(self.st, tsolve._StormTwinStages)
        finally:
            tsolve._read_progress = saved
        self.blocks = self.max_blocks or 132


class _Stages(tsolve._StormTwinStages):
    """Stands in for `_cuda.StormShardedStages`: the twin's stages,
    counted as the staged launcher counts its launches."""

    made = []

    def __init__(self, st, stamps=None):
        self.launched = 0
        _Stages.made.append(self)

    def _count(name):
        def stage(self, *args):
            self.launched += 1
            getattr(tsolve._StormTwinStages, name)(*args)
        return stage

    score = _count("score")
    walk = _count("walk")
    bid = _count("bid")
    cand = _count("cand")
    read = _count("read")
    bids = _count("bids")
    budget = _count("budget")
    accept = _count("accept")
    debit = _count("debit")
    epi_read = _count("epi_read")
    finish = _count("finish")


@pytest.fixture
def stand_ins(monkeypatch):
    _Coop.made.clear()
    _Stages.made.clear()
    reads = []
    orig = tsolve._read_progress
    _Coop.read_progress = orig

    def counted(st, rnd):
        reads.append(rnd)
        return orig(st, rnd)

    monkeypatch.setattr(tsolve, "_read_progress", counted)
    monkeypatch.setattr(_cuda, "StormShardedCoop", _Coop)
    monkeypatch.setattr(_cuda, "StormShardedStages", _Stages)
    saved = (tsolve.storm_assignment_sharded_cuda.launches,
             tsolve.storm_assignment_sharded_cuda.blocks)
    yield reads
    (tsolve.storm_assignment_sharded_cuda.launches,
     tsolve.storm_assignment_sharded_cuda.blocks) = saved


def _solve_inputs():
    cols, inp, max_rounds = storm_case(8300, 16, 64, 256, "dogpile")
    return (storm_inputs(inp, "cpu"), storm_columns(cols, "cpu"),
            max_rounds)


def _as_card(mesh):
    # the launchers are stand-ins: the solve stays on the CPU, the mesh
    # only claims the card, as the wrapper checks
    mesh.device = torch.device("cuda")
    return mesh


def _twin_out(mesh_d):
    inp, cols, max_rounds = _solve_inputs()
    return tsolve.storm_assignment_sharded_twin(
        VirtualMesh(mesh_d, "cpu"), False, max_rounds)(inp, cols)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_virtual_mesh_solve_is_one_cooperative_launch(stand_ins, d):
    want = _twin_out(d)
    inp, cols, max_rounds = _solve_inputs()
    st = tsolve.prepare_sharded_storm(VirtualMesh(d, "cpu"), inp, cols,
                                      False, max_rounds)
    _as_card(st.mesh)
    before = tsolve.storm_assignment_sharded_cuda.launches
    stand_ins.clear()
    got = tsolve.storm_assignment_sharded_cuda(st, _max_blocks=5)
    assert len(_Coop.made) == 1 and _Coop.made[0].max_blocks == 5
    assert len(_Stages.made) == 1
    # the score stage a shard and the walk, then the one cooperative
    # launch; no host read of the progress flag
    assert _Stages.made[0].launched == d + 1
    assert stand_ins == []
    n = tsolve.storm_assignment_sharded_cuda.launches - before
    assert n == d + 2 == tsolve.storm_stage_launches(st.mesh, int(got.rounds))
    assert tsolve.storm_assignment_sharded_cuda.blocks == 5
    assert int(got.rounds) >= 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_dist_mesh_solve_keeps_the_staged_launches(stand_ins, tmp_path):
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        for per in (1, 2):
            want = _twin_out(per)
            inp, cols, max_rounds = _solve_inputs()
            mesh = DistMesh(device="cpu", shards_per_rank=per)
            st = tsolve.prepare_sharded_storm(mesh, inp, cols, False,
                                              max_rounds)
            _as_card(mesh)
            before = tsolve.storm_assignment_sharded_cuda.launches
            stand_ins.clear()
            got = tsolve.storm_assignment_sharded_cuda(st)
            rounds = int(got.rounds)
            assert _Coop.made == [] and len(_Stages.made) == 1
            staged = tsolve.storm_stage_launches(mesh, rounds)
            assert staged == 2 * per + 2 + rounds * (5 * per + 2)
            assert _Stages.made[0].launched == staged
            assert tsolve.storm_assignment_sharded_cuda.launches - before == staged
            # one host read of the progress flag a round
            assert stand_ins == list(range(rounds))
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            _Stages.made.clear()
    finally:
        dist.destroy_process_group()


def test_cooperative_solve_takes_at_most_coop_max_shards():
    # the shard table goes to the kernel by value: a mesh of more shards
    # raises before anything is built or launched
    d = _cuda.STORM_COOP_MAX_SHARDS + 1
    cols, inp, max_rounds = storm_case(8400, 4, 8, 4 * d, "uncontended")
    st = tsolve.prepare_sharded_storm(
        VirtualMesh(d, "cpu"), storm_inputs(inp, "cpu"),
        storm_columns(cols, "cpu"), False, max_rounds)
    _as_card(st.mesh)
    before = tsolve.storm_assignment_sharded_cuda.launches
    with pytest.raises(DeviceFault,
                       match=f"1 to {_cuda.STORM_COOP_MAX_SHARDS} shards"):
        tsolve.storm_assignment_sharded_cuda(st)
    assert tsolve.storm_assignment_sharded_cuda.launches == before
    assert bool((st.assigned == -1).all())
    assert bool((st.out_pulls == 0).all())


def test_failed_cooperative_launch_raises_without_a_fallback(stand_ins,
                                                             monkeypatch):
    def refused(self):
        raise RuntimeError("nk_storm_coop launch failed: too many blocks in "
                           "cooperative launch (720)")

    monkeypatch.setattr(_Coop, "launch", refused)
    inp, cols, max_rounds = _solve_inputs()
    st = tsolve.prepare_sharded_storm(VirtualMesh(4, "cpu"), inp, cols,
                                      False, max_rounds)
    _as_card(st.mesh)
    before = tsolve.storm_assignment_sharded_cuda.launches
    stand_ins.clear()
    with pytest.raises(DeviceFault, match="cooperative"):
        tsolve.storm_assignment_sharded_cuda(st, _max_blocks=100_000)
    assert tsolve.storm_assignment_sharded_cuda.launches == before
    # no round ran, staged or twin: no flag read, nothing assigned, no
    # epilogue
    assert stand_ins == []
    assert _Stages.made[0].launched == 4 + 1  # the scores and the walk
    assert bool((st.assigned == -1).all())
    assert bool((st.out_pulls == 0).all()) and int(st.out_rounds[0]) == 0


def test_round_scratch_and_chunks_are_sized_for_every_round():
    # chunks_a_shard keeps every round's items within parts(A, D) =
    # A * D + one per warp of the largest grid, for every bidding count
    for D in (1, 2, 8, 32):
        S = 16384 // D
        for warps in (1, 32, WARPS, 1024 * 32):
            for n_act in (0, 1, 2, 17, 511, 1024):
                k = chunks_a_shard(n_act, S, D, warps)
                assert 1 <= k and D * k <= max(D, MAX_SUB)
                assert n_act * D * k <= n_act * D + 1024 * 32
                assert math.ceil(S / k) * k >= S
