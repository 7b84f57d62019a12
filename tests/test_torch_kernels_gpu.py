"""Kernels K1 (csrc/score_select.cu) and K2 (csrc/plan_picks.cu) against
their plain twins, on the card and on the CPU, at the main path's width
(a 16,384-row arena with 10,000 candidates).  Exact equality of every
output, in f64 and in f32.

These tests need a CUDA device; without one they skip.  Run them on the
card with ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops import score as tscore
from nomad_tpu_torch.ops.cases import (
    BATCH_SCENARIOS,
    INT32_MAX,
    SCORE_SCENARIOS,
    batch_case,
    score_case,
)
from nomad_tpu_torch.state.convert import (
    batch_inputs_from_numpy,
    score_inputs_from_numpy,
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


def test_launch_rejects_cpu_and_mixed_devices(cuda):
    case = score_case(1, 256, 200, "div0", 2)
    inp = score_inputs_from_numpy(case, cuda)
    with pytest.raises(ValueError):
        tscore.score_and_select(inp._replace(perm=inp.perm.cpu()))
