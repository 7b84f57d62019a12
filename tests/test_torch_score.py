"""Port parity: the plain twin of kernel K1 (one select) against the JAX
program it replaces, `nomad_tpu.ops.score.score_and_select`, and
`score_all`, on the same seeded numpy inputs.

Exact equality throughout (rows, pulls, feasible counts and the f64
scores): both sides run the same IEEE operations in the same order
under x64 on the CPU (including the one multiply-add that XLA fuses,
see `INV_18` in the port's ops/score.py), and 10^x is rounded through
float32 on both.
"""
import numpy as np
import pytest
import torch

from nomad_tpu.ops import score as jscore
from nomad_tpu_torch.ops import score as tscore
from nomad_tpu_torch.ops.cases import INT32_MAX, SCORE_SCENARIOS, score_case
from nomad_tpu_torch.state.convert import score_inputs_from_numpy

C = 256
N_CAND = 200
LIMITS = (2, 14, INT32_MAX)


def jax_inputs(case):
    f = np.float64
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
        n_candidates=np.int32(case["n_candidates"]),
    )


def _bits(x):
    return np.asarray(x, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("scenario", sorted(SCORE_SCENARIOS))
def test_score_and_select_matches_jax(scenario, limit, spread_fit):
    seed = 1000 + sorted(SCORE_SCENARIOS).index(scenario)
    case = score_case(seed, C, N_CAND, scenario, limit)
    j_row, j_best, j_n, j_pulls = (
        np.asarray(x)
        for x in jscore.score_and_select(
            jax_inputs(case), spread_fit=spread_fit
        )
    )
    inp = score_inputs_from_numpy(case, "cpu")
    t_row, t_best, t_n, t_pulls = (
        x.numpy() for x in tscore.score_and_select(inp, spread_fit=spread_fit)
    )
    assert int(t_row) == int(j_row)
    assert int(t_pulls) == int(j_pulls)
    assert int(t_n) == int(j_n)
    assert _bits(t_best) == _bits(j_best)
    packed = tscore.score_and_select_packed(inp, spread_fit=spread_fit)
    assert packed.dtype == torch.int32
    assert packed.tolist() == [int(j_row), int(j_pulls)]


@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("scenario", sorted(SCORE_SCENARIOS))
def test_score_all_matches_jax(scenario, spread_fit):
    case = score_case(7, C, N_CAND, scenario, 14)
    j_feas, j_scores = (
        np.asarray(x)
        for x in jscore.score_all(jax_inputs(case), spread_fit=spread_fit)
    )
    t_feas, t_scores = tscore.score_all(
        score_inputs_from_numpy(case, "cpu"), spread_fit=spread_fit
    )
    np.testing.assert_array_equal(t_feas.numpy(), j_feas)
    np.testing.assert_array_equal(_bits(t_scores.numpy()), _bits(j_scores))


@pytest.mark.parametrize("scenario", ["div0", "div2", "div4", "div4_nogood"])
def test_scenarios_divert_as_intended(scenario):
    """The control scenarios really produce the intended number of
    non-positive scores among feasible nodes (so the diverted-walk
    branches are exercised, not assumed)."""
    n_bad, n_good = SCORE_SCENARIOS[scenario]
    case = score_case(3, C, N_CAND, scenario, 14)
    feas, scores = tscore.score_all(score_inputs_from_numpy(case, "cpu"))
    assert int(feas.sum()) == n_bad + n_good
    assert int((feas & (scores <= 0)).sum()) == n_bad


def test_pow10_matches_jax_rounding():
    """The canonical 10^x (f64 pow rounded through f32) agrees with the
    JAX package's on 100,000 seeded inputs in [-1, 1]."""
    x = np.random.default_rng(5).uniform(-1.0, 1.0, 100_000)
    j = np.asarray(jscore._pow10(x, np.float64))
    t = tscore._pow10(torch.from_numpy(x), torch.float64).numpy()
    np.testing.assert_array_equal(_bits(t), _bits(j))


def test_f32_twin_runs_and_agrees_on_decisions_with_f64():
    """The f32 twin takes the same path (scores in f32, pow still taken
    in f64): on a control scenario it picks the same node."""
    case = score_case(11, C, N_CAND, "div2", 14)
    r64 = tscore.score_and_select(score_inputs_from_numpy(case, "cpu"))
    r32 = tscore.score_and_select(
        score_inputs_from_numpy(case, "cpu", dtype=torch.float32)
    )
    assert r32[1].dtype == torch.float32
    assert int(r32[0]) == int(r64[0])
    assert int(r32[3]) == int(r64[3])


def test_wrapper_rejects_bad_inputs():
    case = score_case(1, C, N_CAND, "div0", 2)
    inp = score_inputs_from_numpy(case, "cpu")
    with pytest.raises(TypeError):
        tscore.score_and_select(inp._replace(perm=inp.perm.long()))
    with pytest.raises(ValueError):
        tscore.score_and_select(inp._replace(feasible=inp.feasible[:10]))
    # a policy must be PolicyTerms (its parity: tests/test_torch_policy.py)
    with pytest.raises(TypeError):
        tscore.score_and_select(inp._replace(policy=object()))
    # a CPU tensor never reaches the kernel launcher
    with pytest.raises(ValueError):
        tscore.score_select_cuda(inp)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fma_emulation_is_correctly_rounded(dtype):
    """The twin's fused multiply-add equals the exactly rounded a*b + c
    (computed with rationals) on seeded inputs, including the score's
    own domain (fitness in [0, 18] times RN(1/18) plus anti-affinity)."""
    from fractions import Fraction

    rng = np.random.default_rng(9)
    n = 4000
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    a = np.concatenate([
        rng.uniform(0.0, 18.0, n // 2), rng.uniform(-1e3, 1e3, n // 2)
    ]).astype(np_dt)
    b = np.concatenate([
        np.full(n // 2, 1.0 / 18.0), rng.uniform(-1.0, 1.0, n // 2)
    ]).astype(np_dt)
    c = np.concatenate([
        -(rng.integers(1, 5, n // 2) + 1.0) / rng.integers(1, 200, n // 2),
        rng.uniform(-1e3, 1e3, n // 2),
    ]).astype(np_dt)
    # products that cancel c almost exactly stress the rounding
    c[: n // 8] = -(a[: n // 8].astype(np.float64) * b[: n // 8]).astype(np_dt)
    got = tscore.fma(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)
    ).numpy()
    # f32: the exact value rounds to f64 first; a double rounding could
    # only differ on an exact f32 midpoint, which these inputs avoid
    want = np.array(
        [
            np_dt(float(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))))
            for x, y, z in zip(a, b, c)
        ]
    )
    np.testing.assert_array_equal(got, want)
