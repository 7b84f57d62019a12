"""The port's multichip sweep (`nomad_tpu_torch/parallel/multichip.py`)
against the JAX package's (`nomad_tpu.parallel.multichip`), on the CPU.

The port's sweep at its defaults runs 1, 2, 4 and 8 shards of a
`VirtualMesh`, as the JAX sweep runs its virtual 8-device CPU mesh: the
points, their chunk launches and byte keys equal the JAX sweep's
(`multihost=False`), the keys the port has no source for
(`per_device_flops`, `flops_scaling_first_to_last`, `multihost`) are
absent, and the chain the sweep times decides the same rows as the JAX
runner.  Then the bench with its multichip block on, in a subprocess at
a small size."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nomad_tpu_torch.parallel import multichip as tmulti
from nomad_tpu_torch.parallel.mesh import VirtualMesh, sharded_chained_plan

REPO = Path(__file__).resolve().parent.parent
POINT_KEYS = ("n_devices", "chunk_width", "chunk_launches", "dirty_rows",
              "bytes_per_flush_delta", "bytes_per_flush_full")


@pytest.fixture(scope="module")
def sweeps():
    from nomad_tpu.parallel.multichip import multichip_sweep

    return (tmulti.multichip_sweep(device="cpu"),
            multichip_sweep(multihost=False))


def test_sweep_points_equal_the_jax_sweep(sweeps):
    port, jax_block = sweeps
    for key in ("arena_nodes", "evals", "picks"):
        assert port[key] == jax_block[key]
    assert [p["n_devices"] for p in port["points"]] == [1, 2, 4, 8]
    assert len(port["points"]) == len(jax_block["points"])
    for p, j in zip(port["points"], jax_block["points"]):
        assert {k: p[k] for k in POINT_KEYS} == {k: j[k] for k in POINT_KEYS}
        assert p["placements_per_sec"] > 0 and j["placements_per_sec"] > 0


def test_sweep_leaves_out_what_it_has_no_source_for(sweeps):
    port, jax_block = sweeps
    assert "flops_scaling_first_to_last" in jax_block
    for key in ("flops_scaling_first_to_last", "multihost"):
        assert key not in port
    for p in port["points"]:
        assert "per_device_flops" not in p
    assert port["mesh"] == "VirtualMesh"


def test_sweep_inputs_and_rows_equal_the_jax_sweep():
    from nomad_tpu.parallel import multichip as jmulti
    from nomad_tpu.parallel.mesh import make_mesh
    from nomad_tpu.parallel.mesh import sharded_chained_plan as jplan

    C, E, P, chunk = 256, 8, 4, 4
    cols, per_eval = tmulti._chain_inputs(C, E, P)
    jcols, jper = jmulti._chain_inputs(C, E, P)
    for a, b in zip(cols, jcols):
        assert np.array_equal(a, b)
    for a, b in zip(per_eval, jper):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
    assert tmulti._mirror_sync_bytes(C, 24) == jmulti._mirror_sync_bytes(C, 24)
    run = sharded_chained_plan(VirtualMesh(4, "cpu"), P, return_carry=True)
    jrun = jplan(make_mesh(4, eval_axis=1), P, return_carry=True)
    carry, jcarry = cols[3:6], jcols[3:6]
    for a in range(0, E, chunk):
        rows, _p, carry = run(*cols[:3], *carry,
                              *tmulti._slice_eval(per_eval, a, a + chunk))
        jrows, _jp, jcarry = jrun(*jcols[:3], *jcarry,
                                  *jmulti._slice_eval(jper, a, a + chunk))
        assert np.array_equal(rows.numpy(), np.asarray(jrows))


def test_sweep_chain_on_a_one_rank_dist_mesh(tmp_path):
    """chip_smoke.py's check of the multichip block, on the CPU: the
    sweep's chain (its inputs, chunking and carry) on a one-rank gloo
    `make_mesh(1)` equals the twin there, a VirtualMesh of 1, 2, 4 and 8
    shards, and K9's twin; the sweep's delta patch equals K4's twin."""
    import torch
    import torch.distributed as dist

    import chip_smoke
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.parallel.mesh import make_mesh, sharded_chained_plan_twin

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        got = chip_smoke.sweep_chain(mesh, sharded_chained_plan)
        chip_smoke._same_sharded(
            got, chip_smoke.sweep_chain(mesh, sharded_chained_plan_twin), "twin")
        for d in (1, 2, 4, 8):
            chip_smoke._same_sharded(got, chip_smoke._k12_sweep_cpu_twin(d),
                                     f"VirtualMesh {d}")
        rows, pulls = chip_smoke.k9_of(chip_smoke._sweep_case(), "cpu",
                                       torch.float64)
        assert torch.equal(got[0], rows) and torch.equal(got[1], pulls)
        assert int((rows >= 0).sum()) > 0
        col = tmulti._chain_inputs(tmulti.SWEEP_C, tmulti.SWEEP_E,
                                   tmulti.SWEEP_P)[0][3]
        idx, vals = tmulti.delta_patch_inputs(tmulti.SWEEP_C,
                                              tmulti.SWEEP_DIRTY, "cpu")
        patched = mesh.unshard(tbatch.patch_rows_sharded(
            mesh, mesh.shard(col), idx, vals))
        assert torch.equal(patched, tbatch.patch_rows(
            torch.from_numpy(col), idx, vals))
    finally:
        dist.destroy_process_group()


def test_bench_with_the_multichip_block():
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_NODES="60", BENCH_ALLOCS="300", BENCH_E2E_JOBS="4",
               BENCH_E2E_ORACLE_JOBS="2", BENCH_PACED_JOBS="2",
               BENCH_SWEEP_JOBS="1", BENCH_KERNEL_NODES="60",
               BENCH_KERNEL_E="2", BENCH_MULTICHIP="1", BENCH_PREFLIGHT_S="0")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.bench", "--device", "cpu"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    mc = line["multichip"]
    assert mc["mesh"] == "VirtualMesh"
    assert [p["n_devices"] for p in mc["points"]] == [1, 2, 4, 8]
    assert all(p["placements_per_sec"] > 0 for p in mc["points"])
    assert line["kernel_batch_placements_per_sec"] > 0
    assert line["parity_identical_evals"] == 2
    counts = [json.loads(x.split(" ", 1)[1]) for x in out.stderr.splitlines()
              if x.startswith("BENCH_LAUNCHES ")]
    # the CPU sweep runs the twins: no kernel launch is counted
    assert counts and counts[0]["sharded_chained_plan"] == 0
    assert counts[0]["patch_rows_sharded"] == 0


def test_bench_without_the_multichip_block():
    knobs = __import__("nomad_tpu_torch.bench", fromlist=["Knobs"]).Knobs
    assert knobs.from_env({"BENCH_MULTICHIP": "0"}).multichip is False
    assert knobs.from_env({}).multichip is True
