"""Kernels K1 (csrc/score_select.cu), K2 (csrc/plan_picks.cu), K3
(csrc/chained_picks.cu), K4 (csrc/patch_rows_mesh.cu, per column and as
the unsharded mirror's bound three-column flush), K5
(csrc/storm_solve.cu), K6 (csrc/walk_only.cu, on each launch shape, with
the count and without it), K7 (csrc/batch_picks.cu),
K8 (csrc/canary.cu, per call and as the supervisor's bound probe), K9 (csrc/chained_batch.cu, per-eval and shared),
K10 (csrc/batch_plan.cu, rows and pulls, also with E beyond the blocks
the card holds at once and its carry beyond shared memory), K11
(csrc/score_all.cu), K12
(csrc/sharded_chain.cu, the node-sharded chained planner on a
VirtualMesh of 1, 2, 4 and 8 shards), K13 (csrc/patch_rows_mesh.cu)
and K14 (csrc/storm_sharded.cu, the node-sharded storm solve on a
VirtualMesh of 1 and 8 shards, also equal to K5) and K15
(csrc/patch_rows_mesh.cu, the per-host flush's one launch over a
process's local shards, also equal to K13; both also on 16 and 64
local shards, the table's bound) against their plain twins,
the entry module's programs on (evals, nodes) meshes of 1 x 1,
1 x 8 and 2 x 4 (`sharded_score_and_select`, K11 + K6, equal to K1;
`sharded_batch_plan`, K10 an eval row, equal to K10; the dryrun equal to
its CPU run), on the card and on the CPU, at the main path's width (a
16,384-row arena with 10,000 candidates; K5 with 8 and 1,024 rows; K6 at
C in {8, 1024, 16384}; K7 with 1, 10,000 and 16,384 candidates and
(E, P) up to (256, 16) and (8, 64); K8 at n in {1, 8, 1024, 1500}; K9
and K10 at (E, P) in {(2, 16), (8, 64)} and the benchmark's (64, 10)).
K2 and K7 also at their prefix walk's edges, per block shape: regions
one short of a pick's first step, as long, one longer and one longer
than two steps, a node that wins twice, walks through the whole region,
and a carry beyond shared memory (540,000 candidates).
K1 also with each launch shape (its prefix walk and its grid) forced at
its edges (whole regions, a limited walk that runs long, few
candidates, two diverted nodes, all bad), the walk scratch held where
it was written.  K9 also on long walks with step deltas, pre-deltas and
spread (rows and pulls) and with its carry beyond shared memory.
K1, K5 and K11 also on their policy cases (throughput, migration, both
and inert selects; weighted, mixed and dogpile storms).  Exact equality
of every output, in f64 and in f32.

These tests need a CUDA device; without one they skip.  Run them on the
card with ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops import canary as tcanary
from nomad_tpu_torch.ops import score as tscore
from nomad_tpu_torch.ops import solve as tsolve
from nomad_tpu_torch.ops.cases import (
    BATCH_SCENARIOS,
    BATCH_SHARED_SCENARIOS,
    BATCHED_SCENARIOS,
    CHAIN_SCENARIOS,
    INT32_MAX,
    POLICY_SCORE_SCENARIOS,
    POLICY_STORM_SCENARIOS,
    SCORE_SCENARIOS,
    SELECT_EDGES,
    STORM_SCENARIOS,
    WALK_SCENARIOS,
    batch_case,
    batch_shared_case,
    batched_cache_case,
    batched_case,
    chain_case,
    policy_score_case,
    policy_storm_case,
    score_case,
    select_edge_case,
    storm_case,
    tiled_batched,
    walk_case,
)
from nomad_tpu_torch.state.convert import (
    batch_inputs_from_numpy,
    batch_shared_inputs_from_numpy,
    batched_case_to_torch,
    chain_case_to_torch,
    score_inputs_from_numpy,
    storm_columns,
    storm_inputs,
)

pytestmark = pytest.mark.gpu

C = 16384
N_CAND = 10000
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with -m gpu on the card")
    return torch.device("cuda")


def _bits(t):
    a = t.detach().cpu().numpy()
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _same_walk(out, on_cpu, spread_fit=False) -> int:
    """K1's walk scratch against the CPU twin: every position the kernel
    walked (all C on its grid) with the twin's feasibility and bad flag,
    and every feasible one with the twin's score bits.  Returns the
    walked positions."""
    walked = int(out.out_i[3])
    assert 1 <= walked <= on_cpu.perm.shape[0]
    if out.route == "grid":
        assert walked == on_cpu.perm.shape[0]
    feas, scores = tscore.score_vectors(on_cpu, spread_fit)
    perm = on_cpu.perm.long()[:walked]
    f = feas[perm]
    flags = out.flags_walk.cpu()[:walked]
    assert torch.equal((flags & 1).bool(), f)
    assert torch.equal((flags & 2).bool(), f & (scores[perm] <= 0))
    got = out.scores_walk.cpu()[:walked][f]
    assert (_bits(got) == _bits(scores[perm][f])).all()
    return walked


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("limit", [2, 14, INT32_MAX])
@pytest.mark.parametrize("scenario", sorted(SCORE_SCENARIOS))
def test_score_select_kernel_matches_twin(cuda, scenario, limit, spread_fit,
                                          dtype):
    case = score_case(
        3000 + sorted(SCORE_SCENARIOS).index(scenario), C, N_CAND,
        scenario, limit,
    )
    on_card = score_inputs_from_numpy(case, cuda, dtype=dtype)
    on_cpu = score_inputs_from_numpy(case, "cpu", dtype=dtype)
    before = tscore.score_select_cuda.launches
    kernel = tscore.score_and_select(on_card, spread_fit=spread_fit)
    torch.cuda.synchronize()
    assert tscore.score_select_cuda.launches == before + 1
    twin_card = tscore.score_and_select_twin(on_card, spread_fit=spread_fit)
    twin_cpu = tscore.score_and_select_twin(on_cpu, spread_fit=spread_fit)
    for k, tc, tp in zip(kernel, twin_card, twin_cpu):
        assert (_bits(k) == _bits(tc)).all()
        assert (_bits(k) == _bits(tp)).all()
    packed = tscore.score_and_select_packed(on_card, spread_fit=spread_fit)
    assert packed.cpu().tolist() == [int(kernel[0]), int(kernel[3])]
    # every score the kernel computed, not only the winner's (two pows a
    # node): the positions it walked (every node's score is held through
    # K11, test_score_all_kernel_matches_twin)
    _same_walk(tscore.score_select_cuda(on_card, spread_fit), on_cpu,
               spread_fit)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("limit", [14, INT32_MAX])
@pytest.mark.parametrize("scenario", sorted(POLICY_SCORE_SCENARIOS))
def test_score_select_policy_kernel_matches_twin(cuda, scenario, limit,
                                                 dtype):
    case = policy_score_case(
        3500 + sorted(POLICY_SCORE_SCENARIOS).index(scenario), C, N_CAND,
        scenario, limit,
    )
    on_card = score_inputs_from_numpy(case, cuda, dtype=dtype)
    on_cpu = score_inputs_from_numpy(case, "cpu", dtype=dtype)
    out = tscore.score_select_cuda(on_card)
    torch.cuda.synchronize()
    kernel = (out.out_i[0], out.best[0], out.out_i[2], out.out_i[1])
    twin_card = tscore.score_and_select_twin(on_card)
    twin_cpu = tscore.score_and_select_twin(on_cpu)
    for k, tc, tp in zip(kernel, twin_card, twin_cpu):
        assert (_bits(k) == _bits(tc)).all()
        assert (_bits(k) == _bits(tp)).all()
    _same_walk(out, on_cpu)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edge", sorted(SELECT_EDGES))
def test_score_select_launch_shapes_at_edges(cuda, edge, dtype):
    """K1 at the edges of `SELECT_EDGES`, each on the launch shape its
    rule takes (the grid where limit >= n_candidates, the prefix walk
    elsewhere): every output and every score it computed bit-equal to
    the twin on the card and on the CPU; one launch a call; the packed
    select's row and pulls without the feasible count."""
    case = select_edge_case(3700 + sorted(SELECT_EDGES).index(edge), C,
                            N_CAND, edge)
    on_card = score_inputs_from_numpy(case, cuda, dtype=dtype)
    on_cpu = score_inputs_from_numpy(case, "cpu", dtype=dtype)
    grid = case["limit"] >= case["n_candidates"]
    before = tscore.score_select_cuda.launches
    out = tscore.score_select_cuda(on_card)
    torch.cuda.synchronize()
    assert tscore.score_select_cuda.launches == before + 1
    assert out.route == ("grid" if grid else "prefix")
    kernel = (out.out_i[0], out.best[0], out.out_i[2], out.out_i[1])
    twin_card = tscore.score_and_select_twin(on_card)
    twin_cpu = tscore.score_and_select_twin(on_cpu)
    for k, tc, tp in zip(kernel, twin_card, twin_cpu):
        assert (_bits(k) == _bits(tc)).all()
        assert (_bits(k) == _bits(tp)).all()
    walked = _same_walk(out, on_cpu)
    if not grid and int(kernel[3]) < case["n_candidates"]:
        assert walked >= int(kernel[3])  # stopped after its limit-th
    quick = tscore.score_select_cuda(on_card, count=False)
    assert quick.out_i.cpu().tolist()[:2] == [int(kernel[0]), int(kernel[3])]
    assert int(quick.out_i[2]) == (int(kernel[2]) if grid else -1)


@pytest.mark.parametrize("edge", sorted(SELECT_EDGES))
def test_score_select_rule(cuda, edge):
    """K1's rule, read from what the kernel did: the grid (every
    position walked, the feasible count always given) where the limit
    reaches the candidates, the prefix walk (no count when not asked)
    elsewhere."""
    case = select_edge_case(3800, C, N_CAND, edge)
    out = tscore.score_select_cuda(score_inputs_from_numpy(case, cuda),
                                   count=False)
    got = out.out_i.cpu().tolist()
    if case["limit"] >= case["n_candidates"]:
        assert got[3] == C and got[2] >= 0
    else:
        assert got[2] == -1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("limit", [2, INT32_MAX])
@pytest.mark.parametrize("n_picks", [1, 16, 128])
@pytest.mark.parametrize("scenario", sorted(BATCH_SCENARIOS))
def test_plan_picks_kernel_matches_twin(cuda, scenario, n_picks, limit,
                                        dtype):
    cols, inp = batch_case(
        4000 + 10 * sorted(BATCH_SCENARIOS).index(scenario) + n_picks,
        C, N_CAND, scenario, limit, n_picks,
    )

    def run(dev, fn):
        t = {k: torch.from_numpy(v).to(dev, dtype) for k, v in cols.items()}
        return fn(
            t["cpu_total"], t["mem_total"], t["disk_total"],
            batch_inputs_from_numpy(inp, dev, dtype=dtype), N_CAND, n_picks,
            False,
        )

    before = tbatch.plan_picks_cuda.launches
    kernel = run(cuda, tbatch.plan_picks_full).cpu()
    assert tbatch.plan_picks_cuda.launches == before + 1
    twin_card = torch.stack(run(cuda, tbatch.run_picks)).cpu()
    twin_cpu = torch.stack(run("cpu", tbatch.run_picks))
    assert torch.equal(kernel, twin_card)
    assert torch.equal(kernel, twin_cpu)


def _same_chain(a, b):
    rows_a, pulls_a, (used_a, ports_a, devs_a) = a
    rows_b, pulls_b, (used_b, ports_b, devs_b) = b
    assert torch.equal(rows_a.cpu(), rows_b.cpu())
    assert torch.equal(pulls_a.cpu(), pulls_b.cpu())
    for x, y in zip(used_a, used_b):
        assert (_bits(x) == _bits(y)).all()
    for x, y in ((ports_a, ports_b), (devs_a, devs_b)):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,P", [(2, 16), (8, 64)])
@pytest.mark.parametrize("scenario", sorted(CHAIN_SCENARIOS))
def test_chained_picks_kernel_matches_twin(cuda, scenario, E, P, dtype):
    cols, kw = chain_case(
        5000 + sorted(CHAIN_SCENARIOS).index(scenario), C, N_CAND,
        scenario, E, P,
    )
    args, kwargs = chain_case_to_torch(cols, kw, cuda, dtype)
    before = tbatch.chained_picks_cuda.launches
    kernel = tbatch.chained_plan_picks_cols(*args, return_carry=True,
                                            **kwargs)
    torch.cuda.synchronize()
    assert tbatch.chained_picks_cuda.launches == before + 1
    twin_card = tbatch.chained_picks_twin(tbatch.prepare_chain(*args, **kwargs))
    args_cpu, kwargs_cpu = chain_case_to_torch(cols, kw, "cpu", dtype)
    twin_cpu = tbatch.chained_plan_picks_cols(*args_cpu, return_carry=True,
                                              **kwargs_cpu)
    _same_chain(kernel, twin_card)
    _same_chain(kernel, twin_cpu)


# K3 is one cooperative grid: its answer must not depend on the grid.
# Grids of one block, three blocks and the card's full grid; candidate
# regions wider and narrower than the grid (60 < 132 blocks); limit 1.
GRID_CAPS = (1, 3, 0)
GRID_SCENARIOS = ("plain", "evict_spread", "spread_mixed_groups", "tight",
                  "ports_devices_groups", "everything", "wide_groups")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["wide", "few", "limit1"])
@pytest.mark.parametrize("scenario", GRID_SCENARIOS)
def test_chained_picks_grid_matches_twin_at_any_grid(cuda, scenario, variant,
                                                     dtype):
    n_cand = 60 if variant == "few" else N_CAND
    cols, kw = chain_case(5600 + GRID_SCENARIOS.index(scenario), C, n_cand,
                          scenario, 2, 16)
    if variant == "limit1":
        kw["batch"]["limit"] = np.ones_like(kw["batch"]["limit"])
    args, kwargs = chain_case_to_torch(cols, kw, cuda, dtype)
    p = tbatch.prepare_chain(*args, **kwargs)
    twin_card = tbatch.chained_picks_twin(p)
    args_cpu, kwargs_cpu = chain_case_to_torch(cols, kw, "cpu", dtype)
    twin_cpu = tbatch.chained_plan_picks_cols(*args_cpu, return_carry=True,
                                              **kwargs_cpu)
    _same_chain(twin_card, twin_cpu)
    grids = set()
    for cap in GRID_CAPS:
        before = tbatch.chained_picks_cuda.launches
        kernel = tbatch.chained_picks_cuda(p, _max_blocks=cap)
        torch.cuda.synchronize()
        assert tbatch.chained_picks_cuda.launches == before + 1
        grids.add(tbatch.chained_picks_cuda.blocks)
        _same_chain(kernel, twin_card)
    # the full grid is more than one block and more than three
    assert len(grids) == 3 and min(grids) == 1 and max(grids) > 3
    if scenario == "tight":
        assert bool((twin_cpu[0] == -1).any())  # a group died


def test_chained_picks_grid_beyond_the_card_raises(cuda):
    from nomad_tpu_torch.device.core import DeviceFault

    cols, kw = chain_case(5700, C, N_CAND, "plain", 2, 4)
    args, kwargs = chain_case_to_torch(cols, kw, cuda)
    p = tbatch.prepare_chain(*args, **kwargs)
    tbatch.chained_picks_cuda(p)
    full = tbatch.chained_picks_cuda.blocks
    torch.cuda.synchronize()
    before = tbatch.chained_picks_cuda.launches
    # more blocks than the card holds at once: the cooperative launch is
    # refused, and nothing runs in its place
    with pytest.raises(DeviceFault):
        tbatch.chained_picks_cuda(p, _max_blocks=full + 1)
    with pytest.raises(DeviceFault):
        tbatch.chained_picks_cuda(p, _max_blocks=100_000)
    assert tbatch.chained_picks_cuda.launches == before
    # a refused launch leaves nothing behind: the next one runs
    _same_chain(tbatch.chained_picks_cuda(p), tbatch.chained_picks_twin(p))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [8, 1024, 16384])
def test_patch_rows_kernel_matches_twin(cuda, width, dtype):
    rng = np.random.default_rng(width)
    col = torch.from_numpy(rng.uniform(0.0, 1e4, C)).to(dtype)
    n = max(1, width - width // 4)
    idx = np.full(width, C, np.int32)  # padding: dropped
    idx[:n] = np.sort(rng.choice(C, n, replace=False))
    vals = torch.from_numpy(rng.uniform(0.0, 1e4, width)).to(dtype)
    idx = torch.from_numpy(idx)
    before = tbatch.patch_rows_cuda.launches
    on_card = tbatch.patch_rows(col.to(cuda), idx.to(cuda), vals.to(cuda))
    torch.cuda.synchronize()
    assert tbatch.patch_rows_cuda.launches == before + 1
    twin = tbatch.patch_rows_twin(col.clone(), idx, vals)
    assert (_bits(on_card) == _bits(twin)).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [8, 128, 1024, 2048])
def test_unsharded_flush_kernel_matches_twin_and_per_column(cuda, width, dtype):
    """The unsharded mirror's delta flush (`RowPatch` over three plain
    [C] columns): one staging copy and one K4 launch, bit-equal to the
    twin's flush and to three per-column K4 calls, padding dropped."""
    rng = np.random.default_rng(4400 + width)
    base = [torch.from_numpy(rng.uniform(0.0, 1e4, C)).to(dtype)
            for _ in range(3)]
    n = width - width // 4
    rows = np.sort(rng.choice(C, n, replace=False)).astype(np.int32)
    vals = rng.uniform(0.0, 1e4, (3, n))
    cols = tuple(b.to(cuda) for b in base)
    patch = tbatch.RowPatch(None, cols)
    steps = (tbatch.patch_rows_cuda.launches, tbatch.RowPatch.copies)
    nbytes = patch.flush(rows, tuple(vals), C)
    torch.cuda.synchronize()
    assert (tbatch.patch_rows_cuda.launches - steps[0],
            tbatch.RowPatch.copies - steps[1]) == (1, 1)
    assert nbytes == width * 4 + 3 * width * base[0].element_size()
    twin = tuple(b.clone() for b in base)
    tbatch.RowPatch(None, twin).flush(rows, tuple(vals), C)
    idx = np.full(width, C, np.int32)
    idx[:n] = rows
    idx = torch.from_numpy(idx).to(cuda)
    for got, want, b, v in zip(cols, twin, base, vals):
        padded = np.zeros(width)
        padded[:n] = v
        per_col = tbatch.patch_rows(b.to(cuda), idx,
                                    torch.from_numpy(padded).to(dtype).to(cuda))
        torch.cuda.synchronize()
        assert (_bits(got) == _bits(want)).all()
        assert (_bits(got) == _bits(per_col)).all()


def test_unsharded_flush_after_a_rebind_writes_the_new_tensors(cuda):
    """A bulk upload replaces the mirror's usage tensors and rebinds the
    patch: the next flush stores into the new tensors and leaves the old
    ones as they were."""
    rng = np.random.default_rng(4499)
    old = tuple(torch.zeros(C, dtype=torch.float64, device=cuda)
                for _ in range(3))
    rows = np.array([3, 77, 4096], np.int32)
    tbatch.RowPatch(None, old).flush(rows, tuple(np.ones((3, 3))), C)
    host = [rng.uniform(0.0, 1e4, C) for _ in range(3)]
    new = tuple(torch.from_numpy(h).to(cuda) for h in host)
    kept = [t.clone() for t in old]
    rows2 = np.array([5, 16383], np.int32)
    vals2 = rng.uniform(0.0, 1e4, (3, 2))
    tbatch.RowPatch(None, new).flush(rows2, tuple(vals2), C)
    torch.cuda.synchronize()
    for t, k in zip(old, kept):
        assert torch.equal(t, k)
    for t, h, v in zip(new, host, vals2):
        h = h.copy()
        h[rows2] = v
        assert (_bits(t) == _bits(torch.from_numpy(h))).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("A", [8, 1024])
@pytest.mark.parametrize("scenario", STORM_SCENARIOS)
def test_storm_solve_kernel_matches_twin(cuda, scenario, A, dtype):
    cols, inp, max_rounds = storm_case(
        4000 + STORM_SCENARIOS.index(scenario), A, A, C, scenario
    )
    card = (storm_inputs(inp, cuda, dtype), storm_columns(cols, cuda, dtype))
    before = tsolve.storm_assignment_cuda.launches
    kern = tsolve.storm_assignment(*card, False, max_rounds)
    torch.cuda.synchronize()
    assert tsolve.storm_assignment_cuda.launches == before + 1
    twin_card = tsolve.storm_assignment_twin(*card, False, max_rounds)
    twin_cpu = tsolve.storm_assignment_twin(
        storm_inputs(inp, "cpu", dtype), storm_columns(cols, "cpu", dtype),
        False, max_rounds,
    )
    for k, tc, tp in zip(kern, twin_card, twin_cpu):
        if k.dtype.is_floating_point:
            assert (_bits(k) == _bits(tc)).all()
            assert (_bits(k) == _bits(tp)).all()
        else:
            assert torch.equal(k.cpu(), tc.cpu())
            assert torch.equal(k.cpu(), tp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("A", [8, 1024])
@pytest.mark.parametrize("scenario", sorted(POLICY_STORM_SCENARIOS))
def test_storm_solve_policy_kernel_matches_twin(cuda, scenario, A, dtype):
    cols, inp, max_rounds = policy_storm_case(
        4050 + sorted(POLICY_STORM_SCENARIOS).index(scenario), A, A, C,
        scenario,
    )
    card = (storm_inputs(inp, cuda, dtype), storm_columns(cols, cuda, dtype))
    kern = tsolve.storm_assignment_cuda(*card, False, max_rounds)
    torch.cuda.synchronize()
    twin_card = tsolve.storm_assignment_twin(*card, False, max_rounds)
    twin_cpu = tsolve.storm_assignment_twin(
        storm_inputs(inp, "cpu", dtype), storm_columns(cols, "cpu", dtype),
        False, max_rounds,
    )
    for k, tc, tp in zip(kern, twin_card, twin_cpu):
        assert (_bits(k) == _bits(tc)).all()
        assert (_bits(k) == _bits(tp)).all()


def _same_storm_bits(kern, other):
    for k, o in zip(kern, other):
        assert k.dtype == o.dtype
        assert (_bits(k) == _bits(o)).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scenario", ["dogpile", "infeasible_rows",
                                      "padding_rows", "pre_deltas", "ties",
                                      "round_budget2"])
def test_storm_solve_kernel_above_one_block_of_rows(cuda, scenario, dtype):
    """A = 2,048 rows (twice the rows block 0 holds in shared memory, so
    the round's arrays live in device memory) on a 2,048-row arena: all
    six outputs bit-equal to the twin on the card and on the CPU."""
    A = width = 2048
    cols, inp, max_rounds = storm_case(4400 + STORM_SCENARIOS.index(scenario),
                                       A, A, width, scenario)
    card = (storm_inputs(inp, cuda, dtype), storm_columns(cols, cuda, dtype))
    kern = tsolve.storm_assignment_cuda(*card, False, max_rounds)
    torch.cuda.synchronize()
    _same_storm_bits(kern, tsolve.storm_assignment_twin(*card, False,
                                                        max_rounds))
    _same_storm_bits(kern, tsolve.storm_assignment_twin(
        storm_inputs(inp, "cpu", dtype), storm_columns(cols, "cpu", dtype),
        False, max_rounds))


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("scenario", ["dogpile", "penalty_affinity_collisions",
                                      "pre_deltas"])
def test_storm_solve_kernel_any_grid(cuda, scenario, blocks):
    """The auction's outputs do not depend on its grid: one block, three,
    and one a multiprocessor give the twin's bits (phase B's items and
    their reduction change with the grid, the bids do not)."""
    A = 1024
    cols, inp, max_rounds = storm_case(4500 + STORM_SCENARIOS.index(scenario),
                                       A, A, C, scenario)
    card = (storm_inputs(inp, cuda), storm_columns(cols, cuda))
    kern = tsolve.storm_assignment_cuda(*card, False, max_rounds,
                                        _max_blocks=blocks)
    torch.cuda.synchronize()
    assert tsolve.storm_assignment_cuda.blocks == blocks
    _same_storm_bits(kern, tsolve.storm_assignment_twin(*card, False,
                                                        max_rounds))


def test_storm_solve_kernel_stamps(cuda):
    """The stamp buffer: the stamps a round, the three kernels' starts and
    two barriers a round, in time order; the solve is unchanged."""
    from nomad_tpu_torch.ops import _cuda

    cols, inp, max_rounds = storm_case(4600, 1024, 1024, C, "dogpile")
    card = (storm_inputs(inp, cuda), storm_columns(cols, cuda))
    stamps = torch.zeros(_cuda.storm_stamp_len(max_rounds), dtype=torch.int64,
                         device=cuda)
    kern = tsolve.storm_assignment_cuda(*card, False, max_rounds,
                                        stamps=stamps)
    torch.cuda.synchronize()
    _same_storm_bits(kern, tsolve.storm_assignment_cuda(*card, False,
                                                        max_rounds))
    s = stamps.cpu().tolist()
    rounds = int(kern.rounds)
    assert s[0] == 2 and rounds >= 3
    used = s[1:5 + 2 * rounds]
    assert all(t > 0 for t in used)
    assert used == sorted(used)
    assert all(t == 0 for t in s[5 + 2 * rounds:])


def _walk_tensors(case, dev):
    return (torch.from_numpy(case["feasible"]).to(dev),
            torch.from_numpy(case["scores"]).to(dev),
            torch.from_numpy(case["perm"]).to(dev))


def _same_walk_only(cuda, case, dtype, limit, count=True) -> str:
    """One K6 launch against the twin on the card and on the CPU (row,
    best bits, pulls; the feasible count, or -1 where the prefix walk
    ran without it).  Returns the launch shape."""
    card = _walk_tensors(case, cuda)
    before = tscore.walk_only_cuda.launches
    buf = tscore.walk_only_cuda(*card, limit, case["n_candidates"], count)
    torch.cuda.synchronize()
    assert tscore.walk_only_cuda.launches == before + 1
    route = tscore.walk_only_cuda.route
    assert route == ("grid" if limit >= case["n_candidates"] else "prefix")
    row, best, n, pulls = tscore.unpack_walk(buf.cpu(), dtype)
    for twin in (
        tscore.limited_walk_argmax(*card, limit, case["n_candidates"]),
        tscore.limited_walk_argmax(*_walk_tensors(case, "cpu"), limit,
                                   case["n_candidates"]),
    ):
        assert (row, pulls) == (int(twin[0]), int(twin[3]))
        assert n == (int(twin[2]) if count or route == "grid" else -1)
        got = torch.tensor([best], dtype=dtype)
        assert (_bits(got) == _bits(twin[1].cpu().reshape(1))).all()
    return route


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("limit", [1, 2, 14, "n_cand", INT32_MAX])
@pytest.mark.parametrize("width", [8, 1024, 16384])
@pytest.mark.parametrize("scenario", sorted(WALK_SCENARIOS))
def test_walk_only_kernel_matches_twin(cuda, scenario, width, limit, dtype):
    """K6 on the shape its rule takes (its grid where the limit reaches
    the candidates, its prefix walk elsewhere), with the feasible count
    and without it (the preemption loop's call): every output bit-equal
    to the twin on the card and on the CPU; the stack's wrapper gives
    the same numbers."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    n_cand = max(1, (4 * width) // 5)
    lim = n_cand if limit == "n_cand" else limit
    case = walk_case(4100 + width + lim % 97, width, scenario, lim, np_dtype)
    for count in (True, False):
        _same_walk_only(cuda, case, dtype, lim, count)
    card = _walk_tensors(case, cuda)
    twin = tscore.limited_walk_argmax(*card, lim, n_cand)
    assert tscore.walk_only(*card, lim, n_cand)[::2] == (int(twin[0]),
                                                         int(twin[2]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scenario", ["div2", "spliced", "tail"])
def test_walk_only_kernel_at_every_offset(cuda, scenario, dtype):
    """A 37-row arena at every rotation of its candidates (the stack's
    walk order at each pull offset), limits 3 and unlimited: both
    shapes, the diverted positions at each place of the wrap."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    for limit in (3, INT32_MAX):
        case = walk_case(4400 + len(scenario), 37, scenario, limit, np_dtype)
        perm, n_cand = case["perm"], case["n_candidates"]
        for off in range(n_cand):
            rotated = np.concatenate([perm[off:n_cand], perm[:off],
                                      perm[n_cand:]]).astype(np.int32)
            _same_walk_only(cuda, dict(case, perm=rotated), dtype, limit,
                            count=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,P", [(1, 1), (64, 10), (256, 16), (8, 64)])
@pytest.mark.parametrize("n_cand", [1, N_CAND, C])
@pytest.mark.parametrize("scenario", BATCH_SHARED_SCENARIOS)
def test_batch_picks_kernel_matches_twin(cuda, scenario, n_cand, E, P,
                                         dtype):
    case = batch_shared_case(
        8000 + 10 * BATCH_SHARED_SCENARIOS.index(scenario) + E + P, C,
        n_cand, scenario, E, P,
    )
    on_card = batch_shared_inputs_from_numpy(case, cuda, dtype)
    before = tbatch.batch_plan_picks_shared_cuda.launches
    kernel = tbatch.batch_plan_picks_shared(**on_card).cpu()
    assert tbatch.batch_plan_picks_shared_cuda.launches == before + 1
    assert kernel.dtype == torch.int32 and tuple(kernel.shape) == (E, P)
    twin_card = tbatch.batch_plan_picks_shared_twin(**on_card).cpu()
    twin_cpu = tbatch.batch_plan_picks_shared_twin(
        **batch_shared_inputs_from_numpy(case, "cpu", dtype))
    assert torch.equal(kernel, twin_card)
    assert torch.equal(kernel, twin_cpu)


# K2's and K7's prefix walk (csrc/picks.cuh) at its edges: a pick's
# first step covers PICK_FIRST positions (`kPickFirst`) and each next
# step twice as many; a candidate region one short of the first step, as
# long, one longer, and one longer than two steps, with a limit whose
# walk crosses the first step; a node that wins again (few candidates,
# many picks); walks that run through the whole region
PICK_FIRST = 64
PICK_EDGES = ["step_below", "step_at", "step_above", "two_steps_above",
              "wins_twice", "whole_region"]


def _pick_edge(edge: str):
    """(n_cand, K2 scenario, K2 limit, P, K7 scenario) of an edge case."""
    step = {"step_below": PICK_FIRST - 1, "step_at": PICK_FIRST,
            "step_above": PICK_FIRST + 1,
            "two_steps_above": 3 * PICK_FIRST + 1}
    if edge in step:
        return step[edge], "plain", PICK_FIRST, 16, "mixed"
    if edge == "wins_twice":
        return 5, "plain", 2, 32, "bridge"
    return N_CAND, "out_of_room", INT32_MAX, 16, "tight"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edge", PICK_EDGES)
def test_plan_picks_prefix_walk_edges(cuda, edge, dtype):
    n_cand, scenario, limit, P, _ = _pick_edge(edge)
    cols, inp = batch_case(4500 + PICK_EDGES.index(edge), C, n_cand,
                           scenario, limit, P)

    def args(dev):
        t = {k: torch.from_numpy(v).to(dev, dtype) for k, v in cols.items()}
        return (t["cpu_total"], t["mem_total"], t["disk_total"],
                batch_inputs_from_numpy(inp, dev, dtype=dtype), n_cand, P,
                False)

    before = tbatch.plan_picks_cuda.launches
    kernel = tbatch.plan_picks_cuda(*args(cuda)).cpu()
    assert tbatch.plan_picks_cuda.launches == before + 1
    assert torch.equal(kernel, torch.stack(tbatch.run_picks(*args(cuda))).cpu())
    assert torch.equal(kernel, torch.stack(tbatch.run_picks(*args("cpu"))))
    rows, pulls = kernel[0], kernel[1]
    if edge == "wins_twice":
        placed = rows[rows >= 0].tolist()
        assert len(placed) > len(set(placed))
    elif edge == "whole_region":
        assert int(pulls[0]) == n_cand
    else:
        assert int(pulls[0]) > PICK_FIRST or n_cand <= PICK_FIRST


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edge", PICK_EDGES)
def test_batch_picks_prefix_walk_edges(cuda, edge, dtype):
    n_cand, _, _, P, scenario = _pick_edge(edge)
    E = 8
    case = batch_shared_case(8500 + PICK_EDGES.index(edge), C, n_cand,
                             scenario, E, P)
    if edge.startswith("step") or edge.startswith("two"):
        case["limit"][:] = PICK_FIRST  # the walk crosses the first step
    on_card = batch_shared_inputs_from_numpy(case, cuda, dtype)
    before = tbatch.batch_plan_picks_shared_cuda.launches
    kernel = tbatch.batch_plan_picks_shared_cuda(**on_card).cpu()
    assert tbatch.batch_plan_picks_shared_cuda.launches == before + 1
    assert torch.equal(kernel,
                       tbatch.batch_plan_picks_shared_twin(**on_card).cpu())
    assert torch.equal(kernel, tbatch.batch_plan_picks_shared_twin(
        **batch_shared_inputs_from_numpy(case, "cpu", dtype)))
    if edge == "wins_twice":
        assert any(len(set(r[r >= 0].tolist())) < int((r >= 0).sum())
                   for r in kernel)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pick_carry_beyond_shared_memory(cuda, dtype):
    """A candidate region whose bitmaps pass the shared-memory bound
    (540,000 positions): K2 and K7 keep the carry in the wrapper's global
    scratch, the same kernel, equal to the twins."""
    from nomad_tpu_torch.ops import _cuda

    big = 540_000
    for name in ("plan_picks", "batch_picks"):
        assert _cuda.pick_carry(name, 2, big, 8, dtype, cuda) is not None
    cols, inp = batch_case(4600, big, big, "plain", 14, 8)

    def args(dev):
        t = {k: torch.from_numpy(v).to(dev, dtype) for k, v in cols.items()}
        return (t["cpu_total"], t["mem_total"], t["disk_total"],
                batch_inputs_from_numpy(inp, dev, dtype=dtype), big, 8,
                False)

    kernel = tbatch.plan_picks_cuda(*args(cuda)).cpu()
    assert torch.equal(kernel, torch.stack(tbatch.run_picks(*args("cpu"))))
    case = batch_shared_case(8600, big, big, "mixed", 2, 8)
    kernel = tbatch.batch_plan_picks_shared_cuda(
        **batch_shared_inputs_from_numpy(case, cuda, dtype)).cpu()
    assert torch.equal(kernel, tbatch.batch_plan_picks_shared_twin(
        **batch_shared_inputs_from_numpy(case, "cpu", dtype)))


# every scenario at (2, 16) and (8, 64); the bench's (64, 10) with and
# without every option
BATCHED_CASES = [(s, E, P) for s in sorted(BATCHED_SCENARIOS)
                 for E, P in ((2, 16), (8, 64))] + [
    ("plain", 64, 10), ("everything", 64, 10),
    ("unlimited_spread_evict", 64, 10)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scenario,E,P", BATCHED_CASES)
def test_chained_batch_kernel_matches_twin(cuda, scenario, E, P, dtype):
    cols, kw = batched_case(
        5600 + sorted(BATCHED_SCENARIOS).index(scenario), C, N_CAND,
        scenario, E, P,
    )
    args, kwargs = batched_case_to_torch(cols, kw, cuda, dtype)
    before = tbatch.chained_plan_picks_cuda.launches
    kernel = tbatch.chained_plan_picks(*args, **kwargs).cpu()
    assert tbatch.chained_plan_picks_cuda.launches == before + 1
    assert kernel.dtype == torch.int32 and tuple(kernel.shape) == (E, P)
    twin_card = tbatch.chained_plan_picks_twin(*args, **kwargs).cpu()
    args_cpu, kwargs_cpu = batched_case_to_torch(cols, kw, "cpu", dtype)
    twin_cpu = tbatch.chained_plan_picks(*args_cpu, **kwargs_cpu)
    assert torch.equal(kernel, twin_card)
    assert torch.equal(kernel, twin_cpu)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,P", [(8, 16), (64, 10)])
@pytest.mark.parametrize("scenario", BATCH_SHARED_SCENARIOS)
def test_chained_shared_kernel_matches_twin(cuda, scenario, E, P, dtype):
    case = batch_shared_case(
        5700 + 10 * BATCH_SHARED_SCENARIOS.index(scenario) + E, C, N_CAND,
        scenario, E, P,
    )
    on_card = batch_shared_inputs_from_numpy(case, cuda, dtype)
    before = tbatch.chained_plan_picks_shared_cuda.launches
    kernel = tbatch.chained_plan_picks_shared(**on_card).cpu()
    assert tbatch.chained_plan_picks_shared_cuda.launches == before + 1
    twin_card = tbatch.chained_plan_picks_shared_twin(**on_card).cpu()
    twin_cpu = tbatch.chained_plan_picks_shared(
        **batch_shared_inputs_from_numpy(case, "cpu", dtype))
    assert torch.equal(kernel, twin_card)
    assert torch.equal(kernel, twin_cpu)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scenario", ["unlimited_evict",
                                      "unlimited_spread_evict", "everything"])
def test_chained_batch_pulls_match_twin(cuda, scenario, dtype):
    """K9's rows and pulls (the positions each prefix walk consumed)
    equal the twin's on long walks, with the score cache (step deltas,
    pre-deltas) and without it (spread too), in one launch."""
    cols, kw = batched_case(
        5650 + sorted(BATCHED_SCENARIOS).index(scenario), C, N_CAND,
        scenario, 8, 16)
    args, kwargs = batched_case_to_torch(cols, kw, cuda, dtype)
    q = tbatch.prepare_batched(*args, **kwargs)
    before = tbatch.chained_plan_picks_cuda.launches
    rows, pulls = tbatch.launch_chained_plan(q)
    assert tbatch.chained_plan_picks_cuda.launches == before + 1
    twin = tbatch.chained_picks_twin(tbatch.batched_as_chain(q))
    assert torch.equal(rows.cpu(), twin[0].cpu())
    assert torch.equal(pulls.cpu(), twin[1].cpu())
    if scenario.startswith("unlimited"):
        active = twin[1].cpu() > 0
        assert bool((pulls.cpu()[active] == q["n_cand"].cpu()[:, None]
                     .expand_as(pulls)[active]).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_chained_batch_cache_rules(cuda, dtype):
    """K9's score cache on long walks where each of its rules decides a
    pick (`batched_cache_case`: penalty rows it holds, an evicted row it
    holds that must win next), under worst fit: rows and pulls equal to
    the twin's on the card and the CPU."""
    cols, kw = batched_cache_case(5670, C, N_CAND, 8, 16)
    args, kwargs = batched_case_to_torch(cols, kw, cuda, dtype)
    q = tbatch.prepare_batched(*args, spread_fit=True, **kwargs)
    rows, pulls = tbatch.launch_chained_plan(q)
    twin = tbatch.chained_picks_twin(tbatch.batched_as_chain(q))
    assert torch.equal(rows.cpu(), twin[0].cpu())
    assert torch.equal(pulls.cpu(), twin[1].cpu())
    args_cpu, kwargs_cpu = batched_case_to_torch(cols, kw, "cpu", dtype)
    assert torch.equal(rows.cpu(), tbatch.chained_plan_picks(
        *args_cpu, spread_fit=True, **kwargs_cpu))
    assert all(int(rows[e, 3]) == int(kw["batch"]["perm"][e, 7])
               for e in range(8))


@pytest.mark.parametrize("dtype", DTYPES)
def test_chained_carry_beyond_shared_memory(cuda, dtype):
    """An arena whose row bitmaps pass the shared-memory bound (200,000
    rows): K9 keeps its carry in the wrapper's global scratch, the same
    kernel, equal to the twin."""
    big = 200_000
    cols, kw = batched_case(5660, big, 150_000, "unlimited_evict", 2, 8)
    args, kwargs = batched_case_to_torch(cols, kw, cuda, dtype)
    kernel = tbatch.chained_plan_picks_cuda(*args, **kwargs).cpu()
    args_cpu, kwargs_cpu = batched_case_to_torch(cols, kw, "cpu", dtype)
    assert torch.equal(kernel, tbatch.chained_plan_picks(*args_cpu,
                                                         **kwargs_cpu))


# n_candidates one scalar where every eval has the same candidate
# region, one per eval otherwise: a scalar below an eval's region would
# put feasible entries in its walk's tail, which no caller does and no
# kernel walks
K10_CASES = [(s, "scalar", E, P) for s in ("plain", "spread", "tight",
                                           "job_dh")
             for E, P in ((2, 16), (8, 64))] + [
    ("few_cand", "per_eval", 2, 16), ("few_cand", "per_eval", 8, 64),
    ("everything", "per_eval", 8, 64), ("plain", "scalar", 64, 10),
    ("everything", "per_eval", 64, 10),
    # long walks with the score cache (no spread) and without it
    ("unlimited_evict", "per_eval", 8, 16),
    ("unlimited_spread_evict", "per_eval", 8, 16)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scenario,n_cand_mode,E,P", K10_CASES)
def test_batch_plan_kernel_matches_twin(cuda, scenario, E, P, n_cand_mode,
                                        dtype):
    cols, kw = batched_case(
        5800 + sorted(BATCHED_SCENARIOS).index(scenario), C, N_CAND,
        scenario, E, P,
    )
    if n_cand_mode == "scalar":
        kw["n_candidates"] = int(kw["n_candidates"].min())

    def inputs(dev):
        args, kwargs = batched_case_to_torch(cols, kw, dev, dtype)
        return args, kwargs.get("spread")

    (args, spread) = inputs(cuda)
    before = tbatch.batch_plan_picks_cuda.launches
    kernel = tbatch.batch_plan_picks(*args, spread=spread).cpu()
    assert tbatch.batch_plan_picks_cuda.launches == before + 1
    assert kernel.dtype == torch.int32 and tuple(kernel.shape) == (E, P)
    twin_card = tbatch.batch_plan_picks_twin(*args, spread=spread).cpu()
    args_cpu, spread_cpu = inputs("cpu")
    twin_cpu = tbatch.batch_plan_picks(*args_cpu, spread=spread_cpu)
    assert torch.equal(kernel, twin_card)
    assert torch.equal(kernel, twin_cpu)
    # the pulls (the positions each prefix walk consumed)
    q = tbatch.prepare_batched(*args, spread=spread)
    pulls = tbatch.launch_batch_plan(q)[1].cpu()
    assert torch.equal(pulls, tbatch.batch_plan_twin(q)[1].cpu())
    assert torch.equal(pulls, tbatch.batch_plan_twin(
        tbatch.prepare_batched(*args_cpu, spread=spread_cpu))[1])


def _k10_q(cols, kw, dev, dtype):
    """K10's `prepare_batched` inputs for a `batched_case` (its spread
    kept; its step deltas, pre-deltas and `wanted` are the chain's)."""
    args, kwargs = batched_case_to_torch(cols, kw, dev, dtype)
    return tbatch.prepare_batched(*args, spread=kwargs.get("spread"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scenario", ["plain", "everything"])
def test_batch_plan_beyond_the_blocks_at_once(cuda, scenario, dtype):
    """E larger than the K10 blocks the card holds at once: the bench's
    64 evals tiled 20 times (1,280 blocks run in waves) give the tiled
    rows and pulls of the 64, which equal the twin's; no block reads
    another's carry, score cache or spread state."""
    E, P, tiles = 64, 10, 20
    cols, kw = batched_case(5880 + len(scenario), C, N_CAND, scenario, E, P)
    q = _k10_q(cols, kw, cuda, dtype)
    rows, pulls = (t.cpu() for t in tbatch.launch_batch_plan(q))
    twin = tbatch.batch_plan_twin(q)
    assert torch.equal(rows, twin[0].cpu())
    assert torch.equal(pulls, twin[1].cpu())
    big = tiled_batched(q, tiles)
    assert big["E"] > tbatch.batch_plan_blocks_at_once(C, P, dtype, cuda)
    big_rows, big_pulls = (t.cpu() for t in tbatch.launch_batch_plan(big))
    assert torch.equal(big_rows, rows.repeat(tiles, 1))
    assert torch.equal(big_pulls, pulls.repeat(tiles, 1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_plan_carry_beyond_shared_memory(cuda, dtype):
    """An arena whose row bitmaps pass the shared-memory bound (200,000
    rows): K10 keeps each block's carry in its slice of the wrapper's
    global scratch, the same kernel, equal to the twin."""
    cols, kw = batched_case(5890, 200_000, 150_000, "unlimited_evict", 2, 8)
    q = _k10_q(cols, kw, cuda, dtype)
    rows, pulls = tbatch.launch_batch_plan(q)
    twin = tbatch.batch_plan_twin(_k10_q(cols, kw, "cpu", dtype))
    assert torch.equal(rows.cpu(), twin[0])
    assert torch.equal(pulls.cpu(), twin[1])


def _score_all_cases():
    out = [("plain", s) for s in sorted(SCORE_SCENARIOS)]
    return out + [("policy", s) for s in sorted(POLICY_SCORE_SCENARIOS)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("kind,scenario", _score_all_cases())
def test_score_all_kernel_matches_twin(cuda, kind, scenario, spread_fit,
                                       dtype):
    make = score_case if kind == "plain" else policy_score_case
    case = make(5900 + len(scenario), C, N_CAND, scenario, 14)
    on_card = score_inputs_from_numpy(case, cuda, dtype=dtype)
    before = tscore.score_all_cuda.launches
    feas, final = tscore.score_all(on_card, spread_fit)
    torch.cuda.synchronize()
    assert tscore.score_all_cuda.launches == before + 1
    for twin in (tscore.score_all_twin(on_card, spread_fit),
                 tscore.score_all(score_inputs_from_numpy(case, "cpu",
                                                          dtype=dtype),
                                  spread_fit)):
        assert torch.equal(feas.cpu(), twin[0].cpu())
        assert (_bits(final) == _bits(twin[1])).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 8, 1024, 1500])
def test_canary_kernel_matches_twin(cuda, n, dtype):
    a = torch.from_numpy(np.random.default_rng(8800 + n).normal(size=n))
    a = a.to(dtype)
    before = tcanary.canary_cuda.launches
    out, total = tcanary.canary(a.to(cuda))
    torch.cuda.synchronize()
    assert tcanary.canary_cuda.launches == before + 1
    for twin_out, twin_total in (tcanary.canary_plain(a.to(cuda)),
                                 tcanary.canary_plain(a)):
        assert np.array_equal(_bits(out), _bits(twin_out))
        assert np.array_equal(_bits(total.reshape(1)),
                              _bits(twin_total.reshape(1)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_canary_kernel_answers_sixteen(cuda, dtype):
    out, total = tcanary.canary_cuda(torch.ones(8, dtype=dtype,
                                                device=cuda))
    assert float(total) == 16.0 and total.dtype == dtype
    assert torch.equal(out.cpu(), torch.full((8,), 2.0, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 8, 1024, 1500])
def test_bound_canary_probe_matches_twin(cuda, n, dtype):
    """K8 bound to mapped host memory: out and the sum bit-equal to the
    twin's, one launch a probe."""
    a = torch.from_numpy(np.random.default_rng(8800 + n).normal(size=n))
    a = a.to(dtype)
    probe = tcanary.CanaryProbe(cuda, values=a, dtype=dtype)
    try:
        before = tcanary.canary_cuda.launches
        total = probe.probe()
        assert tcanary.canary_cuda.launches == before + 1
        out = probe.out()
    finally:
        probe.close()
    want_out, want_total = tcanary.canary_plain(a)
    assert np.array_equal(_bits(torch.from_numpy(out)), _bits(want_out))
    assert np.array_equal(_bits(torch.tensor([total], dtype=dtype)),
                          _bits(want_total.reshape(1)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_bound_canary_probe_answers_sixteen_without_allocating(cuda, dtype):
    """The supervisor's probe on ones(8): 16.0 every time, one launch a
    probe, and no device allocation after the first."""
    probe = tcanary.CanaryProbe(cuda, dtype=dtype)
    try:
        assert probe.probe() == 16.0
        mem = torch.cuda.memory_allocated(cuda)
        before = tcanary.canary_cuda.launches
        assert [probe.probe() for _ in range(16)] == [16.0] * 16
        assert tcanary.canary_cuda.launches == before + 16
        assert torch.cuda.memory_allocated(cuda) == mem
        assert np.array_equal(probe.out(), np.full(8, 2.0))
    finally:
        probe.close()


def test_supervisor_binds_its_probe_once(cuda):
    from nomad_tpu_torch.device import DeviceSupervisor

    sup = DeviceSupervisor(expected=True, device=cuda, probe_interval_s=3600.0)
    sup.prepare()
    probe = sup._canary_probe
    assert probe is not None and probe.stream is sup._canary_stream
    before = tcanary.canary_cuda.launches
    assert all(sup.probe_once() for _ in range(4))
    assert tcanary.canary_cuda.launches == before + 4
    assert sup._canary_probe is probe
    sup.close()
    assert sup._canary_probe is None


def test_launch_rejects_cpu_and_mixed_devices(cuda):
    case = score_case(1, 256, 200, "div0", 2)
    inp = score_inputs_from_numpy(case, cuda)
    with pytest.raises(ValueError):
        tscore.score_and_select(inp._replace(perm=inp.perm.cpu()))
    cols, inp, max_rounds = storm_case(2, 4, 8, 256, "dogpile")
    sinp = storm_inputs(inp, cuda)
    with pytest.raises(ValueError):
        tsolve.storm_assignment(sinp._replace(perm=sinp.perm.cpu()),
                                storm_columns(cols, cuda), False, max_rounds)
    case = walk_case(3, 256, "div1", 2)
    feasible = torch.from_numpy(case["feasible"]).to(cuda)
    scores = torch.from_numpy(case["scores"]).to(cuda)
    with pytest.raises(ValueError):
        tscore.walk_only(feasible, scores, torch.from_numpy(case["perm"]),
                         2, case["n_candidates"])
    kw = batch_shared_inputs_from_numpy(
        batch_shared_case(4, 256, 200, "mixed", 2, 4), cuda)
    with pytest.raises(ValueError):
        tbatch.batch_plan_picks_shared(**dict(kw, perms=kw["perms"].cpu()))
    with pytest.raises(ValueError):
        tcanary.canary_cuda(torch.ones(8, dtype=torch.int32, device=cuda))


def test_new_launches_reject_cpu_and_mixed_devices(cuda):
    """K9, K10 and K11's wrappers launch only on CUDA tensors, and K11's
    refuses a column on another device."""
    cols, kw = batched_case(6, 256, 200, "plain", 2, 4)
    args, kwargs = batched_case_to_torch(cols, kw, "cpu")
    with pytest.raises(ValueError):
        tbatch.chained_plan_picks_cuda(*args, **kwargs)
    with pytest.raises(ValueError):
        tbatch.batch_plan_picks_cuda(*args)
    inp = score_inputs_from_numpy(score_case(7, 256, 200, "div0", 2), cuda)
    with pytest.raises(ValueError):
        tscore.score_all(inp._replace(feasible=inp.feasible.cpu()))
    with pytest.raises(ValueError):
        tscore.score_all_cuda(score_inputs_from_numpy(
            score_case(7, 256, 200, "div0", 2), "cpu"))


# -- K12 and K13: the node-sharded chain and mirror patch --------------------

SHARDED_C, SHARDED_N_CAND = 1024, 1000


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("scenario", ["plain", "everything", "spread_percent",
                                      "spread_even"])
def test_sharded_chain_kernel_matches_twin(cuda, scenario, d, dtype):
    from nomad_tpu_torch.ops.cases import sharded_chain_case
    from nomad_tpu_torch.parallel.mesh import (
        VirtualMesh,
        sharded_chained_plan,
        sharded_chained_plan_cuda,
        sharded_chained_plan_twin,
    )
    from nomad_tpu_torch.state.convert import sharded_case_args

    E, P = 6, 8
    case = sharded_chain_case(600 + d, SHARDED_C, SHARDED_N_CAND, scenario,
                              E, P)
    kw = dict(with_spread=case["spread"] is not None,
              spread_even=case["spread_even"], return_carry=True)
    outs = []
    for mesh, plan in ((VirtualMesh(d, cuda), sharded_chained_plan),
                       (VirtualMesh(d, cuda), sharded_chained_plan_twin),
                       (VirtualMesh(d, "cpu"), sharded_chained_plan_twin)):
        before = sharded_chained_plan_cuda.launches
        args = sharded_case_args(case, mesh.device, dtype)
        rows, pulls, carry = plan(mesh, P, **kw)(*args)
        outs.append((rows.cpu(), pulls.cpu(),
                     [mesh.unshard(c).cpu() for c in carry],
                     sharded_chained_plan_cuda.launches - before))
    kern, twin, twin_cpu = outs
    # one cooperative launch a chain on a VirtualMesh
    assert kern[3] == 1 and twin[3] == 0
    for other in (twin, twin_cpu):
        assert torch.equal(kern[0], other[0])
        assert torch.equal(kern[1], other[1])
        for a, b in zip(kern[2], other[2]):
            assert np.array_equal(_bits(a), _bits(b))
    assert bool((kern[0] >= 0).any())


def _sharded_outputs(c):
    from nomad_tpu_torch.parallel.mesh import Sharded

    return (c.rows.cpu(), c.pulls.cpu(),
            [c.mesh.unshard(Sharded(tuple(sh.use[i] for sh in c.shards))).cpu()
             for i in range(3)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("scenario", ["everything", "spread_even"])
def test_sharded_chain_kernel_at_any_grid(cuda, scenario, d, dtype):
    """The cooperative K12's answer does not depend on its grid: one
    block (it runs every shard's walk in turn), three, the full grid;
    a grid beyond what the card holds raises DeviceFault."""
    from nomad_tpu_torch.device.core import DeviceFault
    from nomad_tpu_torch.ops.cases import sharded_chain_case
    from nomad_tpu_torch.parallel.mesh import (
        VirtualMesh,
        prepare_sharded_chain,
        sharded_chain_twin,
        sharded_chained_plan_cuda,
    )
    from nomad_tpu_torch.state.convert import sharded_case_args

    case = sharded_chain_case(650 + d, SHARDED_C, SHARDED_N_CAND, scenario,
                              6, 8)
    kw = dict(with_spread=case["spread"] is not None,
              spread_even=case["spread_even"])

    def chain():
        mesh = VirtualMesh(d, cuda)
        return prepare_sharded_chain(
            mesh, 8, sharded_case_args(case, cuda, dtype), **kw)

    twin = chain()
    sharded_chain_twin(twin)
    want = _sharded_outputs(twin)
    for cap in (1, 3, 0):
        c = chain()
        sharded_chained_plan_cuda(c, _max_blocks=cap)
        torch.cuda.synchronize()
        got = _sharded_outputs(c)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for a, b in zip(got[2], want[2]):
            assert np.array_equal(_bits(a), _bits(b))
    c = chain()
    before = sharded_chained_plan_cuda.launches
    with pytest.raises(DeviceFault):
        sharded_chained_plan_cuda(c, _max_blocks=100_000)
    assert sharded_chained_plan_cuda.launches == before
    assert bool((c.rows.cpu() == -1).all())  # nothing ran in its place
    # a refused launch leaves nothing behind: the next one runs
    sharded_chained_plan_cuda(c)
    got = _sharded_outputs(c)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scenario", ["plain", "everything", "spread_percent",
                                      "spread_even"])
def test_sharded_chain_staged_on_a_dist_mesh_matches_twin(cuda, scenario,
                                                          dtype):
    """A DistMesh keeps the staged K12 (its exchanges are collectives):
    a one-rank NCCL group's mesh, its launches the staged count."""
    import torch.distributed as dist

    from nomad_tpu_torch.ops.cases import sharded_chain_case
    from nomad_tpu_torch.parallel.mesh import (
        VirtualMesh,
        make_mesh,
        sharded_chained_plan,
        sharded_chained_plan_cuda,
        sharded_chained_plan_twin,
        stage_launches,
    )
    from nomad_tpu_torch.parallel.multichip import nccl_group
    from nomad_tpu_torch.state.convert import sharded_case_args

    E, P = 6, 8
    case = sharded_chain_case(660, SHARDED_C, SHARDED_N_CAND, scenario, E, P)
    kw = dict(with_spread=case["spread"] is not None,
              spread_even=case["spread_even"], return_carry=True)
    made = nccl_group(torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh(1, eval_axis=1)
        outs = []
        for m, plan in ((mesh, sharded_chained_plan),
                        (VirtualMesh(1, "cpu"), sharded_chained_plan_twin)):
            before = sharded_chained_plan_cuda.launches
            rows, pulls, carry = plan(m, P, **kw)(
                *sharded_case_args(case, m.device, dtype))
            outs.append((rows.cpu(), pulls.cpu(),
                         [m.unshard(c_).cpu() for c_ in carry],
                         sharded_chained_plan_cuda.launches - before))
        kern, twin = outs
        assert kern[3] == stage_launches(mesh, E, P) > 1
        assert torch.equal(kern[0], twin[0]) and torch.equal(kern[1], twin[1])
        for a, b in zip(kern[2], twin[2]):
            assert np.array_equal(_bits(a), _bits(b))
    finally:
        if made:
            dist.destroy_process_group()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("width", [8, 1024, 16384])
def test_patch_rows_sharded_kernel_matches_twin(cuda, width, d, dtype):
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    rng = np.random.default_rng(width + d)
    col = torch.from_numpy(rng.uniform(0.0, 1e4, C)).to(dtype)
    n = max(1, width - width // 4)
    idx = np.full(width, C, np.int32)  # padding: dropped
    idx[:n] = np.sort(rng.choice(C, n, replace=False))
    idx = torch.from_numpy(idx)
    vals = torch.from_numpy(rng.uniform(0.0, 1e4, width)).to(dtype)
    mesh = VirtualMesh(d, cuda)
    before = tbatch.patch_rows_sharded_cuda.launches
    sh = tbatch.patch_rows_sharded(mesh, mesh.shard(col), idx.to(cuda),
                                   vals.to(cuda))
    assert tbatch.patch_rows_sharded_cuda.launches - before == 1  # all shards
    cmesh = VirtualMesh(d, "cpu")
    twin = tbatch.patch_rows_sharded_twin(cmesh, cmesh.shard(col), idx, vals)
    got = mesh.unshard(sh)
    assert np.array_equal(_bits(got), _bits(cmesh.unshard(twin)))
    whole = tbatch.patch_rows(col.clone().to(cuda), idx.to(cuda), vals.to(cuda))
    assert np.array_equal(_bits(got), _bits(whole))


# -- K15: the per-host flush of a sharded mirror --------------------------------

HOSTLOCAL_DIRTY = {
    "one_shard": [0],
    "several": [3, 8, 9, 17, 40, 63],
    "two_full_shards": list(range(24, 48)),
    "random20": "random20",
    "rows1024": "rows1024",
}


def _hostlocal_case(name: str, C: int, seed: int):
    rng = np.random.default_rng(seed)
    dirty = HOSTLOCAL_DIRTY[name]
    if dirty == "random20":
        dirty = rng.choice(C, 20, replace=False)
    elif dirty == "rows1024":
        dirty = rng.choice(C, min(1024, C), replace=False)
    idx = np.asarray(sorted(int(i) * C // 64 if C != 64 and name in (
        "one_shard", "several", "two_full_shards") else int(i)
        for i in dirty), np.int32)
    return idx, rng.uniform(0.0, 1e4, C), rng.uniform(0.0, 1e4, C)


def _shards_of(mesh, rank: int, per: int):
    """`mesh` seen as rank `rank` of a world of `per` shards a rank."""
    view = type("RankView", (), {})()
    view.n_shards, view.device = mesh.n_shards, mesh.device
    view.local_shards = tuple(range(rank * per, rank * per + per))
    return view


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(HOSTLOCAL_DIRTY))
@pytest.mark.parametrize("C", [64, 16384])
@pytest.mark.parametrize("d,per", [(2, 1), (4, 2), (8, 4), (8, 1)])
def test_patch_rows_hostlocal_kernel_matches_twin(cuda, d, per, C, name, dtype):
    """K15 stores each rank's own [L, w] shard-local staging rows into
    its L shards in one launch: every rank's result, put together, is
    bit-equal to the twin on the card and on the CPU and to K13 with
    the replicated staging."""
    from nomad_tpu_torch.parallel.mesh import Sharded, VirtualMesh

    idx, col_h, src = _hostlocal_case(name, C, d * 131 + per + C)
    mesh = VirtualMesh(d, cuda)
    stack, per_dev, w = tbatch.hostlocal_staging(mesh, idx, C)
    col = torch.from_numpy(col_h).to(dtype)
    full = mesh.shard(col)
    twin_cpu = VirtualMesh(d, "cpu").shard(col)
    for rank in range(d // per):
        local = list(range(rank * per, rank * per + per))
        view = _shards_of(mesh, rank, per)
        vals = np.zeros((per, w))
        for i, s in enumerate(local):
            vals[i, :len(per_dev[s])] = src[per_dev[s]]
        idx_l = torch.from_numpy(stack[local])
        vals_l = torch.from_numpy(vals).to(dtype)
        before = tbatch.patch_rows_hostlocal_cuda.launches
        tbatch.patch_rows_hostlocal(
            view, Sharded(tuple(full.shards[s] for s in local)),
            idx_l.to(cuda), vals_l.to(cuda))
        assert tbatch.patch_rows_hostlocal_cuda.launches - before == 1
        cview = _shards_of(VirtualMesh(d, "cpu"), rank, per)
        tbatch.patch_rows_hostlocal_twin(
            cview, Sharded(tuple(twin_cpu.shards[s] for s in local)),
            idx_l, vals_l)
    got = mesh.unshard(full)
    assert np.array_equal(_bits(got), _bits(torch.cat(twin_cpu.shards)))
    card_twin = mesh.shard(col)
    tbatch.patch_rows_hostlocal_twin(
        mesh, card_twin, torch.from_numpy(stack).to(cuda),
        torch.from_numpy(np.stack([
            np.pad(src[per_dev[s]], (0, w - len(per_dev[s])))
            for s in range(d)])).to(dtype).to(cuda))
    assert np.array_equal(_bits(got), _bits(mesh.unshard(card_twin)))
    width = tbatch.pow2_bucket(len(idx), floor=8)
    idx_p = np.full(width, C, np.int32)
    idx_p[:len(idx)] = idx
    vals_p = np.zeros(width)
    vals_p[:len(idx)] = src[idx]
    k13 = tbatch.patch_rows_sharded(
        mesh, mesh.shard(col), torch.from_numpy(idx_p).to(cuda),
        torch.from_numpy(vals_p).to(dtype).to(cuda))
    assert np.array_equal(_bits(got), _bits(mesh.unshard(k13)))
    want = col_h.copy()
    want[idx] = src[idx]
    assert np.array_equal(_bits(got), _bits(torch.from_numpy(want).to(dtype)))


def test_patch_rows_hostlocal_kernel_rejects_cpu_and_too_many_shards(cuda):
    from nomad_tpu_torch.ops import _cuda
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    mesh = VirtualMesh(2, cuda)
    col = mesh.shard(torch.zeros(64, dtype=torch.float64))
    idx = torch.full((2, 8), 32, dtype=torch.int32)
    vals = torch.zeros((2, 8), dtype=torch.float64)
    with pytest.raises(ValueError):
        tbatch.patch_rows_hostlocal_cuda(
            VirtualMesh(2, "cpu"),
            VirtualMesh(2, "cpu").shard(torch.zeros(64, dtype=torch.float64)),
            idx, vals)
    with pytest.raises(ValueError):  # a CPU staging for card shards
        tbatch.patch_rows_hostlocal_cuda(mesh, col, idx, vals)
    with pytest.raises(RuntimeError):
        _cuda.RowPatchLaunch(
            [[torch.zeros(1, dtype=torch.float64, device=cuda)] * 65], 0, True)


# -- K13/K15 stacked: the mirror's flush, three columns in one launch -------------


def _stacked(seed: int, width: int, dtype):
    """Three host columns [3, C] (numpy), sorted dirty rows (three
    quarters of W, over every shard) and their values [3, n]."""
    rng = np.random.default_rng(seed)
    n = max(1, width - width // 4)
    host = rng.uniform(0.0, 1e4, (3, C))
    rows = np.sort(rng.choice(C, n, replace=False)).astype(np.int32)
    vals = rng.uniform(0.0, 1e4, (3, n))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return host.astype(np_dtype), rows, vals.astype(np_dtype)


def _staging(kind, mesh, rows, vals, width):
    """The kernel's staging of a dirty set: replicated idx [W] (padding
    C, two negative rows) with vals [3, W], or this view's hostlocal
    [L, w] with [3, L, w] (a negative row in a padding slot)."""
    if kind == "sharded":
        idx = np.full(width, C, np.int32)
        idx[:len(rows)] = rows
        idx[len(rows)] = -1
        if len(rows) + 2 < width:
            idx[len(rows) + 1] = -C
        v = np.zeros((3, width), vals.dtype)
        v[:, :len(rows)] = vals
        return idx, v
    stack, per_dev, w = tbatch.hostlocal_staging(mesh, rows, C)
    local = list(mesh.local_shards)
    v = np.zeros((3, len(local), w), vals.dtype)
    for i, s in enumerate(local):
        pos = np.searchsorted(rows, per_dev[s])
        v[:, i, :len(pos)] = vals[:, pos]
        if len(pos) < w:
            stack[s, len(pos)] = -1
    return stack[local], v


@pytest.mark.parametrize("layout", ["clones", "views"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("width", [8, 1024, 16384])
@pytest.mark.parametrize("kind", ["sharded", "hostlocal"])
def test_stacked_patch_kernel_matches_twin(cuda, kind, width, d, dtype, layout):
    """K13 (replicated staging) and K15 (hostlocal staging) storing three
    columns of every local shard in ONE launch: bit-equal to the stacked
    twin on the card and on the CPU, and to the per-column kernel calls,
    on a VirtualMesh up to the table's 64 shards and (d = 4) on a rank
    of shards 2 and 3; a `RowPatch.flush` of the dirty set is one launch and one staging copy
    and equals a fresh upload."""
    from nomad_tpu_torch.parallel.mesh import Sharded, VirtualMesh, mesh_put

    host, rows, vals = _stacked(width * 7 + d, width, dtype)
    hostlocal = kind == "hostlocal"
    one_fn = tbatch.patch_rows_hostlocal if hostlocal else tbatch.patch_rows_sharded
    counter = (tbatch.patch_rows_hostlocal_cuda if hostlocal
               else tbatch.patch_rows_sharded_cuda)
    views = [(1, d)] + ([(1, 2)] if d == 4 else [])  # (rank, shards a rank)
    for rank, per in views:
        results = []
        for dev in (cuda, "cpu"):
            mesh = VirtualMesh(d, dev)
            if per != d:
                mesh.local_shards = tuple(range(rank * per, rank * per + per))
            idx, v = _staging(kind, mesh, rows, vals, width)
            it, vt = torch.from_numpy(idx), torch.from_numpy(v)

            def place(h):
                t = torch.from_numpy(h.copy())
                return mesh.shard(t) if layout == "clones" else mesh_put(mesh, t)

            cols = tuple(place(h) for h in host)
            before = counter.launches
            tbatch.RowPatch(mesh, cols, hostlocal=hostlocal)(
                it.to(mesh.device), vt.to(mesh.device))
            if dev == "cpu":
                assert counter.launches == before
            else:
                assert counter.launches - before == 1
                twin = tuple(place(h) for h in host)
                (tbatch.patch_rows_hostlocal_cols_twin if hostlocal
                 else tbatch.patch_rows_sharded_cols_twin)(
                    mesh, twin, it.to(cuda), vt.to(cuda))
                one = tuple(place(h) for h in host)
                for k, col in enumerate(one):
                    one_fn(mesh, col, it.to(cuda), vt[k].to(cuda))
                assert counter.launches - before == 4
                for other in (twin, one):
                    for a, b in zip(cols, other):
                        assert np.array_equal(_bits(torch.cat(a.shards)),
                                              _bits(torch.cat(b.shards)))
                flushed = tuple(place(h) for h in host)
                patch = tbatch.RowPatch(mesh, flushed, hostlocal=hostlocal)
                steps = (counter.launches, tbatch.RowPatch.copies)
                patch.flush(rows, tuple(vals), C)
                assert (counter.launches - steps[0],
                        tbatch.RowPatch.copies - steps[1]) == (1, 1)
                want = host.copy()
                want[:, rows] = vals
                fresh = tuple(place(h) for h in want)
                for a, b in zip(flushed, fresh):
                    assert np.array_equal(_bits(torch.cat(a.shards)),
                                          _bits(torch.cat(b.shards)))
            results.append(np.stack([torch.cat(c.shards).cpu().numpy()
                                     for c in cols]))
        assert np.array_equal(results[0].view(np.uint8),
                              results[1].view(np.uint8))


# -- K14: the node-sharded storm solve ------------------------------------------

K14_CASES = [("dogpile", 64, 1024), ("penalty_affinity_collisions", 64, 1024),
             ("infeasible_rows", 64, 1024), ("padding_rows", 64, 1024),
             ("pre_deltas", 64, 1024), ("policy_dogpile", 64, 1024),
             ("dogpile", 1024, C)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("scenario,A,width", K14_CASES)
def test_storm_sharded_kernel_matches_twin(cuda, scenario, A, width, d, dtype):
    """K14 against its twin on the card and on the CPU (all six outputs,
    bits), its launches against the stage count (on a VirtualMesh a
    score stage a shard, the walk and one cooperative launch), and K5 on
    the same inputs (bits at d = 1; equal values at d > 1, where a zero
    score reads +0.0 through the other shards)."""
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    weighted = scenario.startswith("policy_")
    make = policy_storm_case if weighted else storm_case
    cols, inp, max_rounds = make(900 + A, min(A, 64), A, width,
                                 scenario.replace("policy_", ""))
    outs = []
    for mesh, plan in ((VirtualMesh(d, cuda), tsolve.storm_assignment_sharded),
                       (VirtualMesh(d, cuda), tsolve.storm_assignment_sharded_twin),
                       (VirtualMesh(d, "cpu"), tsolve.storm_assignment_sharded_twin)):
        before = tsolve.storm_assignment_sharded_cuda.launches
        out = plan(mesh, False, max_rounds, weighted)(
            storm_inputs(inp, mesh.device, dtype),
            storm_columns(cols, mesh.device, dtype))
        torch.cuda.synchronize()
        outs.append(([x.cpu() for x in out],
                     tsolve.storm_assignment_sharded_cuda.launches - before))
    (kern, n), (twin, n_twin), (twin_cpu, _n) = outs
    assert n == tsolve.storm_stage_launches(VirtualMesh(d, cuda), int(kern[5]))
    assert n_twin == 0
    for other in (twin, twin_cpu):
        for a, b in zip(kern, other):
            assert np.array_equal(_bits(a), _bits(b))
    assert n == d + 2
    k5 = tsolve.storm_assignment_cuda(storm_inputs(inp, cuda, dtype),
                                      storm_columns(cols, cuda, dtype), False,
                                      max_rounds)
    for a, b in zip(kern, k5):
        assert torch.equal(a, b.cpu())
        if d == 1:
            assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 8])
def test_storm_sharded_kernel_above_one_block_of_rows(cuda, d, dtype):
    """K14's cooperative solve at A = 2,048 rows on a 2,048-row arena (the
    round's arrays in device memory) against its CPU twin and K5."""
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    cols, inp, max_rounds = storm_case(4700, 2048, 2048, 2048, "dogpile")
    kern = tsolve.storm_assignment_sharded(VirtualMesh(d, cuda), False,
                                           max_rounds)(
        storm_inputs(inp, cuda, dtype), storm_columns(cols, cuda, dtype))
    torch.cuda.synchronize()
    twin = tsolve.storm_assignment_sharded_twin(VirtualMesh(d, "cpu"), False,
                                                max_rounds)(
        storm_inputs(inp, "cpu", dtype), storm_columns(cols, "cpu", dtype))
    for a, b in zip(kern, twin):
        assert np.array_equal(_bits(a), _bits(b))
    k5 = tsolve.storm_assignment_cuda(storm_inputs(inp, cuda, dtype),
                                      storm_columns(cols, cuda, dtype), False,
                                      max_rounds)
    for a, b in zip(kern, k5):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("blocks", [1, 5])
def test_storm_sharded_kernel_any_grid(cuda, blocks):
    """K14's cooperative solve on a capped grid gives the twin's bits."""
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    cols, inp, max_rounds = storm_case(4800, 1024, 1024, C, "dogpile")
    st = tsolve.prepare_sharded_storm(
        VirtualMesh(8, cuda), storm_inputs(inp, cuda), storm_columns(cols, cuda),
        False, max_rounds)
    kern = [x.cpu() for x in tsolve.storm_assignment_sharded_cuda(
        st, _max_blocks=blocks)]
    torch.cuda.synchronize()
    assert tsolve.storm_assignment_sharded_cuda.blocks == blocks
    twin = tsolve.storm_assignment_sharded_twin(VirtualMesh(8, cuda), False,
                                                max_rounds)(
        storm_inputs(inp, cuda), storm_columns(cols, cuda))
    for a, b in zip(kern, twin):
        assert np.array_equal(_bits(a), _bits(b))


# -- the (evals, nodes) mesh programs: K11 + K6 and K10 -----------------------

EVAL_MESHES = [(1, 1), (1, 8), (2, 4)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_shape", EVAL_MESHES)
@pytest.mark.parametrize("scenario", sorted(SCORE_SCENARIOS))
def test_sharded_select_matches_k1(cuda, scenario, mesh_shape, dtype):
    """`sharded_score_and_select` (K11 a node shard, the all-gather, K6)
    bit-equal to K1 and to its twins on the card and the CPU, with one K11
    launch a node shard and one K6 launch a select."""
    from nomad_tpu_torch.parallel.mesh import (
        VirtualMesh,
        sharded_score_and_select,
        sharded_score_and_select_twin,
    )

    case = score_case(4100 + sorted(SCORE_SCENARIOS).index(scenario), C,
                      N_CAND, scenario, 14)
    on_card = score_inputs_from_numpy(case, cuda, dtype=dtype)
    evals, nodes = mesh_shape
    mesh = VirtualMesh(nodes, cuda, n_evals=evals)
    k11, k6 = tscore.score_all_cuda.launches, tscore.walk_only_cuda.launches
    got = sharded_score_and_select(mesh)(on_card)
    torch.cuda.synchronize()
    assert tscore.score_all_cuda.launches - k11 == nodes
    assert tscore.walk_only_cuda.launches - k6 == 1
    k1 = tscore.score_and_select(on_card)
    twin = sharded_score_and_select_twin(mesh)(on_card)
    cpu = sharded_score_and_select(VirtualMesh(nodes, "cpu", n_evals=evals))(
        score_inputs_from_numpy(case, "cpu", dtype=dtype))
    for other in (k1, twin, cpu):
        for a, b in zip(got, other):
            assert a.dtype == b.dtype and (_bits(a) == _bits(b)).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_shape", EVAL_MESHES)
def test_sharded_batch_plan_matches_k10(cuda, mesh_shape, dtype):
    """`sharded_batch_plan` (the node-axis all-gathers, K10 an eval row)
    equal to K10 on the whole batch and to its twin on the CPU, one K10
    launch an eval row."""
    from nomad_tpu_torch.parallel.mesh import VirtualMesh, sharded_batch_plan

    E, P = 16, 10
    cols, kw = batched_case(4200, C, N_CAND, "plain", E, P)
    n_cand = int(kw["n_candidates"].min())
    args, _kw = batched_case_to_torch(cols, kw, cuda, dtype)
    evals, nodes = mesh_shape
    before = tbatch.batch_plan_picks_cuda.launches
    got = sharded_batch_plan(VirtualMesh(nodes, cuda, n_evals=evals), n_cand,
                             P)(*args[:4])
    torch.cuda.synchronize()
    assert tbatch.batch_plan_picks_cuda.launches - before == evals
    k10 = tbatch.batch_plan_picks_cuda(*args[:4], n_cand, P)
    assert torch.equal(got, k10)
    cpu_args, _kw = batched_case_to_torch(cols, kw, "cpu", dtype)
    cpu = sharded_batch_plan(VirtualMesh(nodes, "cpu", n_evals=evals), n_cand,
                             P)(*cpu_args[:4])
    assert torch.equal(got.cpu(), cpu)


def test_entry_dryrun_on_the_card_equals_the_cpu(cuda):
    """`dryrun_multichip(8)` on the card gives the CPU run's select, rows
    and placements."""
    from nomad_tpu_torch.entry import dryrun_multichip

    card = dryrun_multichip(8)
    cpu = dryrun_multichip(8, "cpu")
    for a, b in zip(card["select"], cpu["select"]):
        assert (_bits(a) == _bits(b)).all()
    assert torch.equal(card["rows"], cpu["rows"])
    assert card["placements"] == cpu["placements"]


def test_entry_dryrun_on_a_cold_card(tmp_path):
    """`python -m nomad_tpu_torch.entry` in a fresh interpreter whose
    kernels are built from nothing (an empty build directory): the
    meshed Server's worker builds its kernels before its first guarded
    stage, so no watchdog trips on the nvcc time."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with -m gpu on the card")
    repo = Path(__file__).resolve().parent.parent
    script = (
        "import sys\n"
        "from pathlib import Path\n"
        "from nomad_tpu_torch.ops import _cuda\n"
        f"_cuda.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "from nomad_tpu_torch.entry import main\n"
        "sys.exit(main([]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-c", script], cwd=str(repo),
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "dryrun_multichip(8) ok" in out.stdout
    assert len(list(tmp_path.glob("lib*.so"))) >= 9
