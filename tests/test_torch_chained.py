"""Port parity: the plain twin of kernel K3 (the chained E x P planner)
and of K4 (the usage-mirror patch) against the JAX programs they
replace, `nomad_tpu.ops.batch.chained_plan_picks_cols` and
`nomad_tpu.ops.batch.patch_rows`, on the same seeded numpy inputs.
Exact in f64: rows, pulls and every column of the carry-out.
"""
import numpy as np
import pytest
import torch

from nomad_tpu.ops import batch as jbatch
from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops.cases import (
    BATCH_SCENARIOS,
    CHAIN_SCENARIOS,
    batch_case,
    chain_case,
)
from nomad_tpu_torch.state.convert import (
    batch_inputs_from_numpy,
    chain_case_to_torch,
)

C = 256
N_CAND = 200

_JAX_TUPLES = {
    "spread": jbatch.SpreadInputs,
    "deltas": jbatch.StepDeltas,
    "pre": jbatch.PreDeltas,
}


def run_jax(cols, kw, spread_fit):
    b = jbatch.ChainInputs(**kw["batch"])
    extra = {}
    for name, value in kw.items():
        if name in ("batch", "n_candidates", "n_picks"):
            continue
        extra[name] = (
            _JAX_TUPLES[name](**value) if name in _JAX_TUPLES else value
        )
    rows, pulls, carry = jbatch.chained_plan_picks_cols(
        cols["cpu_total"], cols["mem_total"], cols["disk_total"],
        cols["used0_cpu"], cols["used0_mem"], cols["used0_disk"], b,
        kw["n_candidates"], kw["n_picks"], spread_fit=spread_fit,
        return_carry=True, **extra,
    )
    used, ports, devs = carry
    return (np.asarray(rows), np.asarray(pulls),
            [np.asarray(u) for u in used],
            None if ports is None else np.asarray(ports),
            None if devs is None else np.asarray(devs))


def run_port(cols, kw, spread_fit, dtype=torch.float64):
    args, kwargs = chain_case_to_torch(cols, kw, "cpu", dtype)
    rows, pulls, (used, ports, devs) = tbatch.chained_plan_picks_cols(
        *args, spread_fit=spread_fit, return_carry=True, **kwargs
    )
    return (rows.numpy(), pulls.numpy(), [u.numpy() for u in used],
            None if ports is None else ports.numpy(),
            None if devs is None else devs.numpy())


def assert_same(got, want):
    rows, pulls, used, ports, devs = got
    np.testing.assert_array_equal(rows, want[0])
    np.testing.assert_array_equal(pulls, want[1])
    assert rows.dtype == np.int32 and pulls.dtype == np.int32
    for u, w in zip(used, want[2]):
        # bit for bit: the carry's order of additions is part of it
        np.testing.assert_array_equal(u.view(np.int64), w.view(np.int64))
    for a, b in ((ports, want[3]), (devs, want[4])):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("E,P", [(2, 16), (3, 8)])
@pytest.mark.parametrize("scenario", sorted(CHAIN_SCENARIOS))
def test_chained_matches_jax(scenario, E, P, spread_fit):
    seed = 3000 + 17 * sorted(CHAIN_SCENARIOS).index(scenario) + E * P
    cols, kw = chain_case(seed, C, N_CAND, scenario, E, P)
    want = run_jax(cols, kw, spread_fit)
    got = run_port(cols, kw, spread_fit)
    assert_same(got, want)
    if scenario in ("tight", "everything", "wide_groups"):
        assert (want[0] == -1).any(), "the case should fail some picks"


def _cut(kw, e0, e1, carry):
    """The case's inputs for evals [e0, e1), chained on `carry`."""
    out = {}
    for name, value in kw.items():
        if name == "n_picks":
            out[name] = value
        elif name in ("port_used0", "dev_free0"):
            continue
        elif isinstance(value, dict):
            out[name] = {
                k: None if v is None else v[e0:e1] for k, v in value.items()
            }
        else:
            out[name] = value[e0:e1]
    used, ports, devs = carry
    cols = {"used0_cpu": used[0], "used0_mem": used[1],
            "used0_disk": used[2]}
    if ports is not None:
        out["port_used0"] = ports
    if devs is not None:
        out["dev_free0"] = devs
    return cols, out


@pytest.mark.parametrize("scenario", ["plain", "everything", "evict_spread"])
def test_chunks_equal_one_launch(scenario):
    E, P = 6, 8
    cols, kw = chain_case(4000 + len(scenario), C, N_CAND, scenario, E, P)
    whole = run_port(cols, kw, False)
    rows, pulls = [], []
    carry = ([cols["used0_cpu"], cols["used0_mem"], cols["used0_disk"]],
             kw.get("port_used0"), kw.get("dev_free0"))
    for e0 in range(0, E, 2):
        ccols, ckw = _cut(kw, e0, e0 + 2, carry)
        part = run_port({**cols, **ccols}, ckw, False)
        rows.append(part[0])
        pulls.append(part[1])
        carry = (part[2], part[3], part[4])
    assert_same(
        (np.concatenate(rows), np.concatenate(pulls)) + carry, whole
    )


@pytest.mark.parametrize("scenario", sorted(BATCH_SCENARIOS))
def test_single_group_chain_equals_k2_twin(scenario):
    """T = 1 and every option off: one eval of the chain is K2's pick
    scan on the same inputs."""
    P = 16
    cols, inp = batch_case(5000, C, N_CAND, scenario, 14, P)
    inp["penalty"][:] = False  # the chain's penalties come per pick
    t = {k: torch.from_numpy(v) for k, v in cols.items()}
    binp = batch_inputs_from_numpy(inp, "cpu")
    want = torch.stack(tbatch.run_picks(
        t["cpu_total"], t["mem_total"], t["disk_total"], binp, N_CAND, P,
        False,
    ))
    batch = tbatch.ChainInputs(
        feasible=binp.feasible[None, None], perm=binp.perm[None],
        ask_cpu=torch.full((1, P), binp.ask_cpu, dtype=torch.float64),
        ask_mem=torch.full((1, P), binp.ask_mem, dtype=torch.float64),
        ask_disk=torch.full((1, P), binp.ask_disk, dtype=torch.float64),
        desired_count=torch.full((1, P), binp.desired_count, dtype=torch.int32),
        limit=torch.full((1, P), binp.limit, dtype=torch.int32),
        distinct_hosts=torch.tensor([binp.distinct_hosts]),
        tg_idx=torch.zeros((1, P), dtype=torch.int32),
    )
    rows, pulls = tbatch.chained_plan_picks_cols(
        t["cpu_total"], t["mem_total"], t["disk_total"],
        binp.base_cpu_used, binp.base_mem_used, binp.base_disk_used,
        batch, N_CAND, P, coll0=binp.base_collisions[None, None],
        affinity=binp.affinity_score[None, None],
    )
    assert torch.equal(torch.stack([rows[0], pulls[0]]), want)


@pytest.mark.parametrize("width", [8, 64])
def test_patch_rows_matches_jax(width):
    rng = np.random.default_rng(width)
    col = rng.uniform(0.0, 1e4, C)
    n = width // 2 + 1
    idx = np.full(width, C, np.int32)  # padding: dropped
    idx[:n] = np.sort(rng.choice(C, n, replace=False))
    vals = rng.uniform(0.0, 1e4, width)
    want = np.asarray(jbatch.patch_rows(col, idx, vals))
    got = tbatch.patch_rows(
        torch.from_numpy(col.copy()), torch.from_numpy(idx),
        torch.from_numpy(vals),
    ).numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    # the padding slots' values went nowhere
    assert not np.isin(vals[n:], got).any()
