"""Port parity: the plain twin of kernel K2 (the look-ahead pick scan)
against the JAX program it replaces, `nomad_tpu.ops.batch.plan_picks_full`,
on the same seeded numpy inputs.  Exact rows and pulls.
"""
import numpy as np
import pytest
import torch

from nomad_tpu.ops import batch as jbatch
from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops.cases import BATCH_SCENARIOS, INT32_MAX, batch_case
from nomad_tpu_torch.state.convert import batch_inputs_from_numpy

C = 256
N_CAND = 200


def run_jax(cols, inp, n_cand, n_picks, spread_fit):
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
    return np.asarray(
        jbatch.plan_picks_full(
            cols["cpu_total"], cols["mem_total"], cols["disk_total"], binp,
            np.int32(n_cand), n_picks, spread_fit=spread_fit,
        )
    )


def run_port(cols, inp, n_cand, n_picks, spread_fit, dtype=torch.float64):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in cols.items()}
    return tbatch.plan_picks_full(
        t["cpu_total"], t["mem_total"], t["disk_total"],
        batch_inputs_from_numpy(inp, "cpu", dtype=dtype), n_cand, n_picks,
        spread_fit=spread_fit,
    ).numpy()


@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("limit", [2, INT32_MAX])
@pytest.mark.parametrize("n_picks", [1, 16, 128])
@pytest.mark.parametrize("scenario", sorted(BATCH_SCENARIOS))
def test_plan_picks_full_matches_jax(scenario, n_picks, limit, spread_fit):
    seed = 2000 + 10 * sorted(BATCH_SCENARIOS).index(scenario) + n_picks
    cols, inp = batch_case(seed, C, N_CAND, scenario, limit, n_picks)
    want = run_jax(cols, inp, N_CAND, n_picks, spread_fit)
    got = run_port(cols, inp, N_CAND, n_picks, spread_fit)
    assert got.dtype == np.int32 and got.shape == (2, n_picks)
    np.testing.assert_array_equal(got, want)


def test_out_of_room_goes_inert():
    """A group that runs out of room fails one pick and the rest are
    inert (-1 rows, 0 pulls), as the scheduler coalesces them."""
    cols, inp = batch_case(5, C, N_CAND, "out_of_room", 2, 128)
    got = run_port(cols, inp, N_CAND, 128, False)
    rows, pulls = got
    fail = int(np.argmax(rows == -1))
    assert 0 < fail < 127
    assert (rows[fail:] == -1).all()
    assert (pulls[fail + 1:] == 0).all()
    assert (rows[:fail] >= 0).all()


def test_distinct_hosts_never_repeats_a_node():
    cols, inp = batch_case(6, C, N_CAND, "distinct_hosts", 2, 16)
    rows = run_port(cols, inp, N_CAND, 16, False)[0]
    placed = rows[rows >= 0]
    assert len(placed) == len(set(placed.tolist()))
    assert not (inp["base_collisions"][placed] > 0).any()


def test_f32_twin_runs():
    cols, inp = batch_case(7, C, N_CAND, "plain", 2, 16)
    got = run_port(cols, inp, N_CAND, 16, False, dtype=torch.float32)
    assert got.shape == (2, 16) and (got[0] >= 0).all()


def test_pow2_bucket_matches_jax():
    for n in (0, 1, 2, 3, 10, 17, 128, 129):
        assert tbatch.pow2_bucket(n) == jbatch.pow2_bucket(n)
        assert tbatch.pow2_bucket(n, 8) == jbatch.pow2_bucket(n, 8)


def test_wrapper_rejects_bad_inputs():
    cols, inp = batch_case(1, C, N_CAND, "plain", 2, 4)
    t = {k: torch.from_numpy(v) for k, v in cols.items()}
    binp = batch_inputs_from_numpy(inp, "cpu")
    with pytest.raises(TypeError):
        tbatch.plan_picks_full(
            t["cpu_total"].float(), t["mem_total"], t["disk_total"], binp,
            N_CAND, 4,
        )
    with pytest.raises(ValueError):
        tbatch.plan_picks_cuda(
            t["cpu_total"], t["mem_total"], t["disk_total"], binp, N_CAND, 4
        )
