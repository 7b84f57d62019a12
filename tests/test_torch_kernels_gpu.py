"""Kernels K1 (csrc/score_select.cu), K2 (csrc/plan_picks.cu), K3
(csrc/chained_picks.cu), K4 (csrc/patch_rows.cu), K5
(csrc/storm_solve.cu), K6 (csrc/walk_only.cu), K7 (csrc/batch_picks.cu),
K8 (csrc/canary.cu), K9 (csrc/chained_batch.cu, per-eval and shared),
K10 (csrc/batch_plan.cu), K11 (csrc/score_all.cu), K12
(csrc/sharded_chain.cu, the node-sharded chained planner on a
VirtualMesh of 1, 2, 4 and 8 shards), K13 (csrc/patch_rows_sharded.cu)
and K14 (csrc/storm_sharded.cu, the node-sharded storm solve on a
VirtualMesh of 1 and 8 shards, also equal to K5) and K15
(csrc/patch_rows_hostlocal.cu, the per-host flush's one launch over a
process's local shards, also equal to K13) against their plain twins,
the entry module's programs on (evals, nodes) meshes of 1 x 1,
1 x 8 and 2 x 4 (`sharded_score_and_select`, K11 + K6, equal to K1;
`sharded_batch_plan`, K10 an eval row, equal to K10; the dryrun equal to
its CPU run), on the card and on the CPU, at the main path's width (a
16,384-row arena with 10,000 candidates; K5 with 8 and 1,024 rows; K6 at
C in {8, 1024, 16384}; K7 with 1, 10,000 and 16,384 candidates and
(E, P) up to (256, 16) and (8, 64); K8 at n in {1, 8, 1024, 1500}; K9
and K10 at (E, P) in {(2, 16), (8, 64)} and the benchmark's (64, 10)).
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
    STORM_SCENARIOS,
    WALK_SCENARIOS,
    batch_case,
    batch_shared_case,
    batched_case,
    chain_case,
    policy_score_case,
    policy_storm_case,
    score_case,
    storm_case,
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
    # every node's score, not only the winner's (two pows per node)
    walk_scores = tscore.score_select_cuda(on_card, spread_fit).scores_walk
    _, cpu_scores = tscore.score_vectors(on_cpu, spread_fit)
    assert (_bits(walk_scores) == _bits(cpu_scores[on_cpu.perm.long()])).all()


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
    _, cpu_scores = tscore.score_vectors(on_cpu)
    assert (_bits(out.scores_walk)
            == _bits(cpu_scores[on_cpu.perm.long()])).all()


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("limit", [1, 2, 14, INT32_MAX])
@pytest.mark.parametrize("width", [8, 1024, 16384])
@pytest.mark.parametrize("scenario", sorted(WALK_SCENARIOS))
def test_walk_only_kernel_matches_twin(cuda, scenario, width, limit, dtype):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    case = walk_case(4100 + width + limit % 97, width, scenario, limit,
                     np_dtype)

    def tensors(dev):
        return (torch.from_numpy(case["feasible"]).to(dev),
                torch.from_numpy(case["scores"]).to(dev),
                torch.from_numpy(case["perm"]).to(dev))

    card = tensors(cuda)
    before = tscore.walk_only_cuda.launches
    buf = tscore.walk_only_cuda(*card, limit, case["n_candidates"])
    torch.cuda.synchronize()
    assert tscore.walk_only_cuda.launches == before + 1
    row, best, count, pulls = tscore.unpack_walk(buf.cpu(), dtype)
    for twin in (
        tscore.limited_walk_argmax(*card, limit, case["n_candidates"]),
        tscore.limited_walk_argmax(*tensors("cpu"), limit,
                                   case["n_candidates"]),
    ):
        assert (row, count, pulls) == (int(twin[0]), int(twin[2]),
                                       int(twin[3]))
        got = torch.tensor([best], dtype=dtype)
        assert (_bits(got) == _bits(twin[1].cpu().reshape(1))).all()
    # the stack's wrapper: one launch, the same numbers
    assert tscore.walk_only(*card, limit, case["n_candidates"])[::2] == (
        row, count)


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


# every scenario at (2, 16) and (8, 64); the bench's (64, 10) with and
# without every option
BATCHED_CASES = [(s, E, P) for s in sorted(BATCHED_SCENARIOS)
                 for E, P in ((2, 16), (8, 64))] + [
    ("plain", 64, 10), ("everything", 64, 10)]


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


# n_candidates one scalar where every eval has the same candidate
# region, one per eval otherwise: a scalar below an eval's region would
# put feasible entries in its walk's tail, which no caller does and no
# kernel walks
K10_CASES = [(s, "scalar", E, P) for s in ("plain", "spread", "tight",
                                           "job_dh")
             for E, P in ((2, 16), (8, 64))] + [
    ("few_cand", "per_eval", 2, 16), ("few_cand", "per_eval", 8, 64),
    ("everything", "per_eval", 8, 64), ("plain", "scalar", 64, 10),
    ("everything", "per_eval", 64, 10)]


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
    assert kern[3] > 0 and twin[3] == 0
    for other in (twin, twin_cpu):
        assert torch.equal(kern[0], other[0])
        assert torch.equal(kern[1], other[1])
        for a, b in zip(kern[2], other[2]):
            assert np.array_equal(_bits(a), _bits(b))
    assert bool((kern[0] >= 0).any())


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
    assert tbatch.patch_rows_sharded_cuda.launches - before == d
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
        _cuda.launch_patch_rows_hostlocal(
            [torch.zeros(1, dtype=torch.float64, device=cuda)] * 65,
            idx.to(cuda), vals.to(cuda))


# -- K14: the node-sharded storm solve ------------------------------------------

K14_CASES = [("dogpile", 64, 1024), ("penalty_affinity_collisions", 64, 1024),
             ("infeasible_rows", 64, 1024), ("padding_rows", 64, 1024),
             ("pre_deltas", 64, 1024), ("policy_dogpile", 64, 1024),
             ("dogpile", 1024, C)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("scenario,A,width", K14_CASES)
def test_storm_sharded_kernel_matches_twin(cuda, scenario, A, width, d, dtype):
    """K14 against its twin on the card and on the CPU (all six outputs,
    bits), its launches against the stage count, and K5 on the same
    inputs (equal values; a zero score's sign may differ at d > 1)."""
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
    k5 = tsolve.storm_assignment_cuda(storm_inputs(inp, cuda, dtype),
                                      storm_columns(cols, cuda, dtype), False,
                                      max_rounds)
    for a, b in zip(kern, k5):
        assert torch.equal(a, b.cpu())


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
