"""The multi-process half of the port's node mesh against the JAX
package (`nomad_tpu/parallel/mesh.py:56-232`, `ops/batch.py:1183-1252`):

* `hostlocal_staging` gives the JAX staging (stack, per-shard rows,
  width) for D in {1, 2, 4, 8} over several capacities;
* `patch_rows_hostlocal`'s twin (K15's plain version) gives, on the four
  dirty sets of the JAX package's test, the JAX `patch_rows_hostlocal`
  on its 8-device CPU mesh and the port's `patch_rows_sharded` (K13's
  twin), exactly, on a VirtualMesh and on 2 gloo ranks x 2 shards;
* a `DistMesh` of several shards a rank: K12's and K14's twins on 2
  ranks x 2 shards equal a `VirtualMesh(4)`, and its gathers stay in
  ascending shard order;
* `dist_config` and `distributed_init` raise on a malformed world, as in
  the JAX package's `test_dist_config_misconfig_raises`;
* the single-process distributed path (NOMAD_TPU_DIST=1 over one rank of
  four shards) is bit-identical to the plain mesh path
  (`test_single_process_dist_path_bit_identical`);
* a gloo mesh follows the card: without ``device=`` it raises
  `NoDeviceError` here, with ``"cpu"`` it builds; `mesh_put` uploads a
  process's own rows only."""
import copy
import os
import random
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks  # noqa: E402
from nomad_tpu_torch.ops import batch as tbatch  # noqa: E402
from nomad_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from nomad_tpu_torch.parallel.mesh import (  # noqa: E402
    DistMesh,
    VirtualMesh,
    make_mesh,
    mesh_put,
)

SPAWN_LIMIT_S = 60.0


def _jax_mesh(d):
    from nomad_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(d, eval_axis=1)


# -- the staging and the store -------------------------------------------------


@pytest.mark.parametrize("C", [64, 128, 1024])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_hostlocal_staging_equals_jax(d, C):
    from nomad_tpu.ops.batch import hostlocal_staging as jax_staging

    rng = np.random.default_rng(d * 7 + C)
    for n in (1, 5, C // 3, C):
        idx = np.sort(rng.choice(C, n, replace=False)).astype(np.int32)
        got = tbatch.hostlocal_staging(VirtualMesh(d, "cpu"), idx, C)
        want = jax_staging(_jax_mesh(d), idx, C)
        assert got[2] == want[2]
        assert got[0].dtype == np.int32
        np.testing.assert_array_equal(got[0], want[0])
        assert len(got[1]) == len(want[1]) == d
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)


def _replicated(idx, src, C):
    width = tbatch.pow2_bucket(len(idx), floor=8)
    idx_p = np.full(width, C, np.int32)
    idx_p[:len(idx)] = idx
    vals_p = np.zeros(width)
    vals_p[:len(idx)] = src[idx]
    return idx_p, vals_p


@pytest.mark.parametrize("case", range(4))
def test_patch_rows_hostlocal_twin_equals_jax_and_sharded(case):
    """One dirty set of the JAX test: the port's hostlocal twin on a
    VirtualMesh(8) equals the JAX program on its 8-device mesh, the
    port's `patch_rows_sharded` with the replicated staging, and the
    host oracle, exactly."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nomad_tpu.ops.batch import (
        hostlocal_staging as jax_staging,
        patch_rows_hostlocal as jax_patch,
    )

    C = torch_mesh_ranks.HOSTLOCAL_C
    col_host = np.random.default_rng(13).random(C)
    idx, src = torch_mesh_ranks.hostlocal_dirty_sets()[case]
    jmesh = _jax_mesh(8)
    sharding = NamedSharding(jmesh, P("nodes"))
    stack, per_dev, w = jax_staging(jmesh, idx, C)
    jvals = np.zeros((8, w))
    for d, sel in enumerate(per_dev):
        jvals[d, :len(sel)] = src[sel]
    want = np.asarray(jax_patch(jmesh)(
        jax.device_put(col_host, sharding), jax.device_put(stack, sharding),
        jax.device_put(jvals, sharding)))

    mesh = VirtualMesh(8, "cpu")
    got = torch_mesh_ranks.hostlocal_results(mesh, col_host)[case]
    np.testing.assert_array_equal(got.numpy(), want)
    idx_p, vals_p = _replicated(idx, src, C)
    k13 = tbatch.patch_rows_sharded(mesh, mesh.shard(col_host),
                                    torch.from_numpy(idx_p),
                                    torch.from_numpy(vals_p))
    np.testing.assert_array_equal(mesh.unshard(k13).numpy(), want)
    oracle = col_host.copy()
    oracle[idx] = src[idx]
    np.testing.assert_array_equal(want, oracle)


def test_patch_rows_hostlocal_checks_its_staging():
    mesh = VirtualMesh(2, "cpu")
    col = mesh.shard(torch.zeros(16, dtype=torch.float64))
    idx = torch.full((2, 8), 8, dtype=torch.int32)
    vals = torch.zeros((2, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="one row per local shard"):
        tbatch.patch_rows_hostlocal(mesh, col, idx[:1], vals[:1])
    with pytest.raises(TypeError):
        tbatch.patch_rows_hostlocal(mesh, col, idx.long(), vals)
    with pytest.raises(TypeError):
        tbatch.patch_rows_hostlocal(mesh, col, idx, vals.float())
    with pytest.raises(ValueError, match="on the card"):
        tbatch.patch_rows_hostlocal_cuda(mesh, col, idx, vals)
    # padding (the shard size) and negative rows are dropped
    idx[0, 0], idx[1, 0], idx[1, 1] = 3, -1, 7
    vals[0, 0], vals[1, 0], vals[1, 1] = 1.5, 9.0, 2.5
    tbatch.patch_rows_hostlocal(mesh, col, idx, vals)
    got = mesh.unshard(col)
    want = torch.zeros(16, dtype=torch.float64)
    want[3], want[15] = 1.5, 2.5
    assert torch.equal(got, want)


def test_mesh_put_uploads_only_its_own_rows():
    """`mesh_put` cuts this process's rows on the host: a rank of
    shards 2 and 3 of 4 uploads rows [C / 2, C) and nothing else, as
    contiguous views; `NodeMesh.shard` moves no other rows either."""
    C = 64
    col = np.arange(C, dtype=np.float64)
    view = VirtualMesh(4, "cpu")
    view.local_shards = (2, 3)
    uploaded = []

    def upload(block):
        uploaded.append(block.copy())
        return torch.from_numpy(block.copy())

    got = mesh_put(view, col, upload)
    assert len(uploaded) == 1 and uploaded[0].tolist() == list(range(32, 64))
    assert [t.tolist() for t in got.shards] == [list(range(32, 48)),
                                                list(range(48, 64))]
    assert all(t.is_contiguous() for t in got.shards)
    shard = view.shard(torch.from_numpy(col))
    assert [t.tolist() for t in shard.shards] == [t.tolist() for t in got.shards]
    # the default upload copies: the shards never alias the host column
    own = mesh_put(VirtualMesh(2, "cpu"), col)
    col[0] = -1.0
    assert own.shards[0][0] == 0.0


# -- the multi-process world's knobs ------------------------------------------


def test_dist_config_misconfig_raises(monkeypatch):
    """An opted-in world with malformed knobs raises, never degrades to
    one process; `distributed_init` raises the same, and on a group of
    another size."""
    import torch.distributed as dist

    monkeypatch.setenv("NOMAD_TPU_DIST", "1")
    monkeypatch.setenv("NOMAD_TPU_DIST_PROCS", "two")
    with pytest.raises(ValueError):
        tmesh.dist_config()
    with pytest.raises(ValueError):
        tmesh.distributed_init()
    monkeypatch.setenv("NOMAD_TPU_DIST_PROCS", "2")
    monkeypatch.setenv("NOMAD_TPU_DIST_ID", "2")
    with pytest.raises(ValueError):
        tmesh.dist_config()
    with pytest.raises(ValueError):
        tmesh.distributed_init()
    monkeypatch.setenv("NOMAD_TPU_DIST_ID", "1")
    cfg = tmesh.dist_config()
    assert (cfg.num_processes, cfg.process_id) == (2, 1)
    assert cfg.coordinator == "127.0.0.1:8476"
    # namespaced knobs win over the plain ones
    ns = "f1"
    monkeypatch.setenv("NOMAD_TPU_DIST_NS", ns)
    monkeypatch.setenv("_".join(("NOMAD_TPU_DIST_COORD", ns.upper())),
                       "127.0.0.1:9999")
    assert tmesh.dist_config().coordinator == "127.0.0.1:9999"
    monkeypatch.delenv("NOMAD_TPU_DIST_NS")
    # the documented off-switch: <= 1 keeps distributed init off
    monkeypatch.setenv("NOMAD_TPU_DIST_PROCS", "0")
    assert tmesh.dist_config().num_processes == 1
    assert tmesh.distributed_init() is False
    monkeypatch.setenv("NOMAD_TPU_DIST", "0")
    assert tmesh.dist_config() is None
    assert tmesh.distributed_init() is False
    # a group already made of another size than the knobs describe
    monkeypatch.setenv("NOMAD_TPU_DIST", "1")
    monkeypatch.setenv("NOMAD_TPU_DIST_PROCS", "2")
    monkeypatch.setenv("NOMAD_TPU_DIST_ID", "0")
    assert not dist.is_initialized()
    import tempfile

    init = os.path.join(tempfile.mkdtemp(), "init")
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="describes 2"):
            tmesh.distributed_init()
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv(tmesh.SHARDS_PER_RANK_ENV, "0")
    with pytest.raises(ValueError):
        tmesh.shards_per_rank()
    monkeypatch.setenv(tmesh.SHARDS_PER_RANK_ENV, "x")
    with pytest.raises(ValueError):
        tmesh.shards_per_rank()


def test_gloo_mesh_follows_the_card(tmp_path, monkeypatch):
    """A gloo `DistMesh`, `make_mesh` and the worker's mesh bring-up
    (NOMAD_TPU_MESH=1) resolve to the card unless asked for "cpu", and
    raise `NoDeviceError` without one; with "cpu" they build as before.
    A rank holds several shards with `shards_per_rank`."""
    import torch.distributed as dist

    from nomad_tpu_torch.device import NoDeviceError
    from nomad_tpu_torch.parallel.pod import build_worker_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        with pytest.raises(NoDeviceError):
            DistMesh()
        with pytest.raises(NoDeviceError):
            make_mesh(1)
        monkeypatch.setenv(tmesh.SHARDS_PER_RANK_ENV, "2")
        with pytest.raises(NoDeviceError):
            build_worker_mesh()
        mesh = DistMesh(device="cpu")
        assert (mesh.device.type, mesh.n_shards, mesh.local_shards) == (
            "cpu", 1, (0,))
        m4 = make_mesh(device="cpu", eval_axis=1, shards_per_rank=4)
        assert (m4.n_shards, m4.local_shards, m4.shards_per_rank) == (
            4, (0, 1, 2, 3), 4)
        assert tmesh.host_count(m4) == 1 and not tmesh.is_multihost(m4)
        assert tmesh.local_device_positions(m4) == [0, 1, 2, 3]
        worker_mesh = build_worker_mesh("cpu")
        assert (worker_mesh.n_shards, worker_mesh.device.type) == (2, "cpu")
        with pytest.raises(ValueError, match="shards asked of a group"):
            DistMesh(n_shards=3, device="cpu", shards_per_rank=2)
        with pytest.raises(ValueError, match="at least one shard"):
            DistMesh(device="cpu", shards_per_rank=0)
        # one rank of four shards computes what a VirtualMesh(4) does
        coll = m4.gather([torch.tensor([s, -s]) for s in range(4)])
        assert coll.tolist() == [[s, -s] for s in range(4)]
        flags = m4.gather([torch.tensor([s % 2 == 0]) for s in range(4)])
        assert flags.dtype == torch.bool and flags[:, 0].tolist() == [
            True, False, True, False]
        assert m4.psum([torch.tensor([1.5]) for _ in range(4)]).item() == 6.0
        for s in ("plain", "spread_even"):
            got = torch_mesh_ranks.chain_results(m4, s)
            want = torch_mesh_ranks.chain_results(VirtualMesh(4, "cpu"), s)
            for a, b in zip(got[:2], want[:2]):
                assert torch.equal(a, b)
            for a, b in zip(got[2], want[2]):
                assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    finally:
        dist.destroy_process_group()


# -- 2 gloo ranks x 2 shards -----------------------------------------------------


def _spawn(world, target, args_of, timeout=SPAWN_LIMIT_S):
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        assert not alive, f"{len(alive)} rank(s) outlived the {timeout} s limit"
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)


def test_two_ranks_of_two_shards_equal_a_virtual_mesh_of_four(tmp_path):
    """2 gloo ranks x 2 shards (`make_mesh(shards_per_rank=2)`): K12's
    twin over every sharded-chain scenario (two chunks, the carry
    threaded), K14's twin over the storm cases, the hostlocal flush of
    the four dirty sets and the gathers give, on each rank, what a
    VirtualMesh(4) gives; rank r holds shards 2r and 2r + 1; the ranks
    load neither JAX nor the JAX package."""
    from nomad_tpu_torch.ops.cases import SHARDED_CHAIN_SCENARIOS

    world, per = 2, 2
    init = tmp_path / "init"
    _spawn(world, torch_mesh_ranks.multi_shard_rank_main,
           lambda r: (r, world, str(init), str(tmp_path), per))
    mesh = VirtualMesh(4, "cpu")
    want = {s: torch_mesh_ranks.chain_results(mesh, s)
            for s in SHARDED_CHAIN_SCENARIOS}
    storm = torch_mesh_ranks.storm_results(mesh)
    col = np.random.default_rng(13).random(torch_mesh_ranks.HOSTLOCAL_C)
    hostlocal = torch_mesh_ranks.hostlocal_results(mesh, col)
    for rank in range(world):
        got = torch.load(tmp_path / f"multi{rank}.pt")
        assert got["loaded"] == []
        assert got["mesh"] == (1, 4, (2 * rank, 2 * rank + 1))
        for s in SHARDED_CHAIN_SCENARIOS:
            for a, b in zip(got[s][:2], want[s][:2]):
                assert torch.equal(a, b), (rank, s)
            for a, b in zip(got[s][2], want[s][2]):
                assert torch.equal(a.view(torch.int64), b.view(torch.int64))
        for key, outs in storm.items():
            for a, b in zip(got["storm"][key], outs):
                assert torch.equal(a, b), (rank, key)
        for a, b in zip(got["hostlocal"], hostlocal):
            assert torch.equal(a, b)
        assert got["gather"].tolist() == [[s, 10 * s] for s in range(4)]
        assert got["bool"][:, 0].tolist() == [True, False, True, False]
    # and the hostlocal flush equals the replicated staging (K13's twin)
    for (idx, src), patched in zip(torch_mesh_ranks.hostlocal_dirty_sets(),
                                   hostlocal):
        idx_p, vals_p = _replicated(idx, src, torch_mesh_ranks.HOSTLOCAL_C)
        k13 = tbatch.patch_rows_sharded(mesh, mesh.shard(col),
                                        torch.from_numpy(idx_p),
                                        torch.from_numpy(vals_p))
        assert torch.equal(mesh.unshard(k13), patched)


# -- the single-process distributed path -----------------------------------------


def _make_nodes(pkg, n, seed=0):
    rng = random.Random(seed)
    nodes = []
    for i in range(n):
        node = pkg.mock.node(id=f"dp-node-{seed}-{i}")
        node.node_resources.cpu = rng.choice([4000, 8000])
        node.node_resources.memory_mb = rng.choice([8192, 16384])
        node.computed_class = pkg.structs.compute_node_class(node)
        nodes.append(node)
    return nodes


def _make_jobs(pkg, n, seed=1):
    rng = random.Random(seed)
    jobs = []
    for i in range(n):
        job = pkg.mock.job(id=f"dp-{i}")
        job.task_groups[0].count = rng.randint(1, 4)
        job.task_groups[0].tasks[0].resources.cpu = rng.choice([200, 400])
        jobs.append(job)
    return jobs


def _outcomes(server, jobs):
    return sorted(
        (j.id, e.status, e.status_description,
         tuple(sorted(e.queued_allocations.items())))
        for j in jobs for e in server.store.evals_by_job("default", j.id))


def _metrics_view(server, jobs):
    """AllocMetrics from the port's explain ring, wall-clock fields
    stripped."""
    from nomad_tpu_torch.explain import EXPLAIN

    out = []
    for j in jobs:
        for ev in sorted(server.store.evals_by_job("default", j.id),
                         key=lambda e: e.create_index):
            rec = EXPLAIN.get(ev.id)
            if rec is None:
                out.append((j.id, None))
                continue
            tgs = {}
            for tg, entry in rec["TaskGroups"].items():
                metric = entry.get("Metric")
                if metric is not None:
                    metric = {k: v for k, v in metric.items()
                              if k != "AllocationTime"}
                tgs[tg] = (entry["Placed"], entry["Failed"], entry["Winner"],
                           metric)
            out.append((j.id, tgs))
    return out


def _run_server(jobs, nodes, mesh=None):
    from nomad_tpu_torch.server import Server

    server = Server(num_schedulers=1, seed=47, batch_pipeline=True,
                    heartbeat_ttl=1e9, device="cpu", mesh=mesh)
    for node in nodes:
        server.register_node(copy.deepcopy(node))
    server.start()
    try:
        worker = server.workers[0]
        assert worker._mesh is not None and worker._mesh_hosts == 1
        for job in jobs:
            server.register_job(copy.deepcopy(job))
        assert server.drain_to_idle(60)
        table = server.store.node_table
        # a warm sharded flush with a known dirty set: one process, so
        # the replicated closed form
        gen = worker._usage_cache_sharded["gen"]
        _, dirty = server.store.usage_delta_since(gen)
        worker._device_columns(table, sharded=True)
        staged = server.metrics.get_gauge("mesh.bytes_per_flush")
        if dirty:
            width = tbatch.pow2_bucket(len(dirty), floor=8)
            assert staged == width * 4 + 3 * width * 8
        else:
            assert staged == 0.0
        assert server.metrics.get_gauge("mesh.hosts") == 1.0
        assert worker.mesh_used > 0
        return (sorted((j.id, a.name, a.node_id) for j in jobs
                       for a in server.store.allocs_by_job("default", j.id)
                       if not a.terminal_status()),
                _outcomes(server, jobs), _metrics_view(server, jobs), staged)
    finally:
        server.stop()


def test_single_process_dist_path_bit_identical(monkeypatch, tmp_path):
    """One process, NOMAD_TPU_DIST=1 and NOMAD_TPU_MESH=1 over a
    one-rank gloo group of four shards (NOMAD_TPU_SHARDS_PER_RANK=4):
    placements, outcomes, AllocMetrics and mirror flush bytes equal the
    plain mesh path's (`Server(mesh=VirtualMesh(4, "cpu"))`)."""
    import types

    import torch.distributed as dist

    from nomad_tpu_torch import mock, structs

    pkg = types.SimpleNamespace(mock=mock, structs=structs)
    monkeypatch.setenv("NOMAD_TPU_REPLAY_STRICT", "1")
    jobs = _make_jobs(pkg, 8, seed=3)
    nodes = _make_nodes(pkg, 12, seed=5)
    monkeypatch.delenv("NOMAD_TPU_MESH", raising=False)
    base = _run_server(jobs, nodes, mesh=VirtualMesh(4, "cpu"))

    monkeypatch.setenv("NOMAD_TPU_MESH", "1")
    monkeypatch.setenv(tmesh.SHARDS_PER_RANK_ENV, "4")
    monkeypatch.setenv("NOMAD_TPU_DIST", "1")
    monkeypatch.setenv("NOMAD_TPU_DIST_PROCS", "1")
    monkeypatch.setenv("NOMAD_TPU_DIST_ID", "0")
    assert tmesh.distributed_init() is False  # one process: no world
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        got = _run_server(jobs, nodes)
    finally:
        dist.destroy_process_group()
    assert base[0] == got[0], "placements diverged"
    assert base[1] == got[1], "eval outcomes diverged"
    assert base[2] == got[2], "AllocMetrics diverged"
    assert base[3] == got[3], "mirror flush bytes diverged"
    assert base[0], "nothing placed"
