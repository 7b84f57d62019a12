"""Port parity of the benchmark's kernel-only programs and of the port's
bench itself.

* The plain twins of kernels K9 (`chained_plan_picks`, per-eval and
  shared) and K10 (`batch_plan_picks`) against the JAX programs they
  replace, `nomad_tpu.ops.batch.chained_plan_picks`,
  `chained_plan_picks_shared` and `batch_plan_picks`, on the same seeded
  numpy inputs (`ops/cases.py batched_case`, `batch_shared_case`): rows
  exactly equal, in f64.
* `nomad_tpu_torch.bench` on the CPU at a small size: its JSON line has
  the JAX bench's keys, the e2e parity is n of n, the kernel rates are
  above 0, and one kernel-only round's rows equal the JAX programs' on
  the bench's own inputs.
"""
import json

import numpy as np
import pytest
import torch

from nomad_tpu.ops import batch as jbatch
from nomad_tpu_torch import bench as tbench
from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops.cases import (
    BATCH_SHARED_SCENARIOS,
    BATCHED_SCENARIOS,
    batch_shared_case,
    batched_case,
)
from nomad_tpu_torch.state.convert import (
    batch_shared_inputs_from_numpy,
    batched_case_to_torch,
)

C = 128
N_CAND = 100
# (E, P, spread_fit): one eval of one pick, and four of eight both ways
SHAPES = [(1, 1, False), (4, 8, False), (4, 8, True)]

_JAX_TUPLES = {
    "spread": jbatch.SpreadInputs,
    "deltas": jbatch.StepDeltas,
    "pre": jbatch.PreDeltas,
}


def _jax_args(cols, kw, names=("spread", "deltas", "pre")):
    extra = {
        name: _JAX_TUPLES[name](**kw[name])
        for name in names if kw.get(name) is not None
    }
    return (cols["cpu_total"], cols["mem_total"], cols["disk_total"],
            jbatch.BatchInputs(**kw["batch"])), extra


def _seed(scenario, E, P):
    return 600 + 10 * sorted(BATCHED_SCENARIOS).index(scenario) + E + P


@pytest.mark.parametrize("E,P,spread_fit", SHAPES)
@pytest.mark.parametrize("scenario", sorted(BATCHED_SCENARIOS))
def test_chained_plan_picks_matches_jax(scenario, E, P, spread_fit):
    cols, kw = batched_case(_seed(scenario, E, P), C, N_CAND, scenario, E, P)
    jargs, jextra = _jax_args(cols, kw)
    want = np.asarray(jbatch.chained_plan_picks(
        *jargs, kw["n_candidates"], P, spread_fit=spread_fit,
        wanted=kw["wanted"], **jextra,
    ))
    args, kwargs = batched_case_to_torch(cols, kw, "cpu")
    got = tbatch.chained_plan_picks(*args, spread_fit=spread_fit, **kwargs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("E,P,spread_fit,n_cand_mode",
                         [s + ("per_eval",) for s in SHAPES]
                         + [(4, 8, False, "scalar")])
@pytest.mark.parametrize("scenario", ["plain", "spread", "tight",
                                      "few_cand", "job_dh"])
def test_batch_plan_picks_matches_jax(scenario, E, P, spread_fit,
                                      n_cand_mode):
    cols, kw = batched_case(_seed(scenario, E, P) + 1, C, N_CAND, scenario,
                            E, P)
    if n_cand_mode == "scalar":
        kw["n_candidates"] = int(kw["n_candidates"].min())
    jargs, jextra = _jax_args(cols, kw, names=("spread",))
    want = np.asarray(jbatch.batch_plan_picks(
        *jargs, kw["n_candidates"], P, spread_fit=spread_fit, **jextra,
    ))
    args, kwargs = batched_case_to_torch(cols, kw, "cpu")
    got = tbatch.batch_plan_picks(*args, spread_fit=spread_fit,
                                  spread=kwargs.get("spread"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("E,P,spread_fit", SHAPES)
@pytest.mark.parametrize("scenario", BATCH_SHARED_SCENARIOS)
def test_chained_plan_picks_shared_matches_jax(scenario, E, P, spread_fit):
    case = batch_shared_case(
        700 + 10 * BATCH_SHARED_SCENARIOS.index(scenario) + E + P, C,
        N_CAND, scenario, E, P,
    )
    want = np.asarray(jbatch.chained_plan_picks_shared(
        **case, spread_fit=spread_fit))
    got = tbatch.chained_plan_picks_shared(
        **batch_shared_inputs_from_numpy(case, "cpu"), spread_fit=spread_fit)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_chained_plan_picks_reads_only_the_first_base_usage(package):
    """`chained_plan_picks` starts its chain from eval 0's base usage:
    rows 1..E-1 of base_*_used change nothing, in both packages."""
    E, P = 4, 8
    cols, kw = batched_case(650, C, N_CAND, "evict_spread", E, P)
    other = dict(kw, batch=dict(kw["batch"]))
    rng = np.random.default_rng(651)
    for name in ("base_cpu_used", "base_mem_used", "base_disk_used"):
        col = kw["batch"][name].copy()
        col[1:] = rng.uniform(0.0, 1e5, col[1:].shape)
        other["batch"][name] = col

    def run(k):
        if package == "jax":
            jargs, jextra = _jax_args(cols, k)
            return np.asarray(jbatch.chained_plan_picks(
                *jargs, k["n_candidates"], P, wanted=k["wanted"], **jextra))
        args, kwargs = batched_case_to_torch(cols, k, "cpu")
        return tbatch.chained_plan_picks(*args, **kwargs).numpy()

    first = run(kw)
    assert (first >= 0).any()
    np.testing.assert_array_equal(run(other), first)


SMALL = {
    "BENCH_NODES": "200", "BENCH_ALLOCS": "1000", "BENCH_E2E_JOBS": "16",
    "BENCH_E2E_ORACLE_JOBS": "8", "BENCH_PACED_JOBS": "8",
    "BENCH_SWEEP_JOBS": "4", "BENCH_KERNEL_NODES": "200",
    "BENCH_KERNEL_E": "8",
}
KEYS = {
    "metric", "value", "unit", "vs_baseline", "p50_eval_latency_ms",
    "p99_eval_latency_ms", "latency_sweep", "oracle_e2e_placements_per_sec",
    "parity_identical_evals", "e2e_stage_times_s", "e2e_prescore_share",
    "e2e_replay_share", "replay_conflict_rate", "replay_counters",
    "kernel_batch_placements_per_sec", "kernel_chained_placements_per_sec",
    "e2e_jobs_fully_placed", "device", "multichip",
}


@pytest.fixture(scope="module")
def bench_line():
    """One small run of the port's bench on the CPU: (the JSON line,
    stderr)."""
    import contextlib
    import io
    import os

    saved = {k: os.environ.get(k) for k in SMALL}
    os.environ.update(SMALL)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = tbench.main(["--device", "cpu"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0, err.getvalue()
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0]), err.getvalue()


@pytest.mark.parametrize("field", ["keys", "parity", "placements",
                                   "kernel_rates", "sweep", "launches"])
def test_port_bench_on_cpu(bench_line, field):
    line, err = bench_line
    if field == "keys":
        assert set(line) == KEYS
        assert line["metric"] == "e2e_placements_per_sec_10k_nodes_binpack"
        assert line["unit"] == "placements/s"
        assert line["device"]["name"] == "cpu"
    elif field == "parity":
        assert line["parity_identical_evals"] == 8
        assert line["vs_baseline"] > 0
    elif field == "placements":
        assert line["e2e_jobs_fully_placed"] == 16
        assert line["value"] > 0 and line["oracle_e2e_placements_per_sec"] > 0
    elif field == "kernel_rates":
        assert line["kernel_batch_placements_per_sec"] > 0
        assert line["kernel_chained_placements_per_sec"] > 0
    elif field == "sweep":
        assert [p["offered_fraction"] for p in line["latency_sweep"]] == [
            0.25, 0.5, 0.75]
        assert all(p["n_evals"] == 4 and p["p99_trace_exemplars"] == []
                   for p in line["latency_sweep"])
    else:
        counts = [json.loads(x.split(" ", 1)[1]) for x in err.splitlines()
                  if x.startswith("BENCH_LAUNCHES ")]
        # on the CPU the twins run: no kernel was launched
        assert counts and set(counts[0].values()) == {0}


@pytest.mark.parametrize("program", ["batch", "chained"])
def test_kernel_only_rows_match_jax(program):
    """One kernel-only round (E = 8 evals of the bench's inputs on its
    200-node world) gives the JAX program's rows."""
    world = tbench.kernel_world(200)
    E = 8
    inp = tbench.kernel_inputs(world, E)
    perms = tbench.kernel_perms(world, list(range(E)))
    jfn, tfn = {
        "batch": (jbatch.batch_plan_picks, tbatch.batch_plan_picks),
        "chained": (jbatch.chained_plan_picks, tbatch.chained_plan_picks),
    }[program]
    want = np.asarray(jfn(
        *inp["cols"], jbatch.BatchInputs(perm=perms, **inp["shared"]),
        np.int32(inp["n_cand"]), tbench.TG_COUNT,
    ))
    cols = [torch.from_numpy(np.ascontiguousarray(c)) for c in inp["cols"]]
    got = tfn(*cols, tbatch.BatchInputs(perm=perms, **inp["shared"]),
              inp["n_cand"], tbench.TG_COUNT)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() == E * tbench.TG_COUNT
    # as the bench's timed loop runs it: prepared once, walk orders
    # swapped in
    q = tbatch.prepare_batched(
        *cols, tbatch.BatchInputs(perm=np.zeros_like(perms), **inp["shared"]),
        inp["n_cand"], tbench.TG_COUNT)
    rows_fn = {"batch": tbatch.batch_plan_rows,
               "chained": tbatch.chained_plan_rows}[program]
    got = rows_fn(dict(q, batch=q["batch"]._replace(
        perm=torch.from_numpy(perms))))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("program", ["batch", "chained"])
def test_kernel_launch_refuses_cpu_tensors(program):
    """The launch helpers behind the kernel-only loop run a kernel or
    raise: on CPU tensors they raise and count no launch."""
    world = tbench.kernel_world(50)
    inp = tbench.kernel_inputs(world, 2)
    cols = [torch.from_numpy(np.ascontiguousarray(c)) for c in inp["cols"]]
    q = tbatch.prepare_batched(
        *cols, tbatch.BatchInputs(perm=tbench.kernel_perms(world, [0, 1]),
                                  **inp["shared"]),
        inp["n_cand"], tbench.TG_COUNT)
    launch, wrapper = {
        "batch": (tbatch.launch_batch_plan, tbatch.batch_plan_picks_cuda),
        "chained": (tbatch.launch_chained_plan,
                    tbatch.chained_plan_picks_cuda),
    }[program]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        launch(q)
    assert wrapper.launches == before


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_port_bench_needs_the_card_unless_told_cpu(argv):
    """Without a card and without --device cpu the bench raises
    NoDeviceError before it builds anything."""
    from nomad_tpu_torch.device import NoDeviceError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoDeviceError):
        tbench.main(argv)
