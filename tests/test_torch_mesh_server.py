"""The port's batched Server on the node mesh (NOMAD_TPU_MESH=1 in the
JAX package; ``Server(mesh=...)`` in the port) against the unsharded
port Server and the JAX mesh Server.

A 256-node world takes a job stream with spread jobs, then a storm of 64
dispatch children (NOMAD_TPU_STORM=1).  The port's meshed Server on a
`VirtualMesh(D, "cpu")`, D in {1, 2, 4, 8}, gives the placements, eval
outcomes and the storm's rows and rounds of the unsharded port Server,
and at D in {2, 4, 8} those of the JAX Server on its D-device mesh
(`NOMAD_TPU_MESH_DEVICES`, the conftest's virtual CPU devices).  The
mesh really ran (K12 chunks over the sharded mirror, K14's twin for the
storm), the warm mirror flush ships fewer bytes than a full one, K12
reads the sharded mirror's own shard tensors, and a trip mid-chain holds,
recovers with a full re-upload of the sharded mirror and places the same
allocs.  A mesh that cannot be built raises: nothing runs unsharded."""
import copy
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_server as ts  # noqa: E402
from nomad_tpu.server import Server as JaxServer  # noqa: E402
from nomad_tpu_torch.parallel.mesh import VirtualMesh  # noqa: E402
from nomad_tpu_torch.server import Server as TorchServer  # noqa: E402
from nomad_tpu_torch.server.batch_worker import (  # noqa: E402
    MESH_COUNTERS,
    MESH_GAUGES,
)

N_NODES = 256
STORM_CHILDREN = 64
DCS = ["dc1", "dc2", "dc3"]
COUNTS = (1, 2, 4, 8)
ENV = {"NOMAD_TPU_STORM": "1", "NOMAD_TPU_STORM_MIN": "8"}


def family(pkg):
    jobs = []
    for i in range(STORM_CHILDREN):
        job = pkg.mock.job(id=f"mfam/dispatch-{i:04d}")
        job.type = "batch"
        job.task_groups[0].count = 1
        job.task_groups[0].tasks[0].resources.cpu = 1500
        job.task_groups[0].tasks[0].resources.memory_mb = 2048
        jobs.append(job)
    return jobs


def stream(pkg):
    return ts.spread_jobs(pkg, False) + ts.plain_jobs(pkg, 10, 5)


def outcomes(server):
    return sorted((e.job_id, e.status, e.triggered_by)
                  for e in server.store.evals.values())


def run(pkg, server_cls, monkeypatch, record, **kw):
    """The stream, then the storm (registered under the broker's lock,
    so the idle worker dequeues it as one wave); returns (placements,
    eval outcomes, storm solves as (assigned rows, rounds), the
    server)."""
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    server = server_cls(num_schedulers=1, seed=11, batch_pipeline=True,
                        heartbeat_ttl=1e9, **kw)
    worker = server.workers[0]
    solves = []
    orig = type(worker)._storm_solve

    def keep(problem, snap):
        out = orig(worker, problem, snap)
        solves.append(([int(r) for r in out[0]], int(out[5])))
        return out

    worker._storm_solve = keep
    record(server)
    server.start()
    try:
        for node in ts.make_nodes(pkg, N_NODES, 3, dcs=DCS):
            server.register_node(copy.deepcopy(node))
        for job in stream(pkg):
            server.register_job(job)
        assert server.drain_to_idle(120)
        with server.broker._lock:  # re-entrant: enqueue takes it too
            for job in family(pkg):
                server.register_job(job)
        assert server.drain_to_idle(120)
        return ts.all_placements(server), outcomes(server), solves, server
    finally:
        server.stop()


_UNSHARDED = {}


def unsharded(monkeypatch):
    if "port" not in _UNSHARDED:
        monkeypatch.delenv("NOMAD_TPU_MESH", raising=False)
        _UNSHARDED["port"] = run(ts.TORCH, TorchServer, monkeypatch,
                                 lambda s: None, device="cpu")[:3]
    return _UNSHARDED["port"]


def run_jax_mesh(monkeypatch, d):
    monkeypatch.setenv("NOMAD_TPU_MESH", "1")
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", str(d))
    try:
        placed, outs, solves, server = run(ts.JAX, JaxServer, monkeypatch,
                                           lambda s: None)
    finally:
        monkeypatch.delenv("NOMAD_TPU_MESH")
        monkeypatch.delenv("NOMAD_TPU_MESH_DEVICES")
    worker = server.workers[0]
    assert worker._mesh is not None and worker.mesh_used > 0
    return placed, outs, solves


@pytest.mark.parametrize("d", COUNTS)
def test_meshed_server_matches_unsharded_and_jax(monkeypatch, d):
    want = unsharded(monkeypatch)
    registered = {}

    def record(server):
        registered["counters"] = {n: server.metrics.get_counter(n)
                                  for n in MESH_COUNTERS}
        registered["gauges"] = {n: server.metrics.get_gauge(n)
                                for n in MESH_GAUGES}

    monkeypatch.delenv("NOMAD_TPU_MESH", raising=False)
    got = run(ts.TORCH, TorchServer, monkeypatch, record, device="cpu",
              mesh=VirtualMesh(d, "cpu"))
    placed, outs, solves, server = got
    assert (placed, outs, solves) == want
    assert len(solves) == 1 and len(solves[0][0]) >= STORM_CHILDREN
    worker = server.workers[0]
    # the mesh really ran: K12 chunks, a storm on K14's twin
    assert worker.mesh_used > 0 and worker.mesh_storms > 0
    assert server.metrics.get_counter("mesh.launches") > 0
    assert worker.errors == 0 and worker.storm_solves > 0
    assert solves and all(rounds > 0 for _rows, rounds in solves)
    assert worker.timings["mesh_fetch"] > 0.0
    # every mesh.* name was there at construction, zero
    assert set(registered["counters"]) == set(MESH_COUNTERS)
    assert all(v == 0.0 for v in registered["counters"].values())
    assert set(registered["gauges"]) == set(MESH_GAUGES)
    assert server.metrics.get_gauge("mesh.hosts") == 1.0
    if d > 1:
        assert run_jax_mesh(monkeypatch, d) == want


def test_warm_flush_ships_fewer_bytes_and_k12_reads_the_mirror(monkeypatch):
    """A warm sharded sync ships O(dirty rows) bytes against a cold
    one's six columns, and K12's twin reads the sharded mirror's own
    shard tensors (no host copy): the totals in place, the used columns
    copied on the device into the chain's carry."""
    from nomad_tpu_torch.ops.batch import pow2_bucket
    from nomad_tpu_torch.parallel import mesh as tmesh

    chains = []
    orig = tmesh.prepare_sharded_chain

    def keep(mesh, n_picks, args, *a, **k):
        c = orig(mesh, n_picks, args, *a, **k)
        chains.append((args[:6], c))
        return c

    monkeypatch.setattr(tmesh, "prepare_sharded_chain", keep)
    mesh = VirtualMesh(4, "cpu")
    server = TorchServer(num_schedulers=1, seed=3, batch_pipeline=True,
                         heartbeat_ttl=1e9, device="cpu", mesh=mesh)
    server.start()
    try:
        for node in ts.make_nodes(ts.TORCH, 64, 2):
            server.register_node(node)
        worker = server.workers[0]
        table = server.store.node_table
        full = sum(c.nbytes for c in (
            table.cpu_total, table.mem_total, table.disk_total,
            table.cpu_used, table.mem_used, table.disk_used))
        worker._device_columns(table, sharded=True)
        assert server.metrics.get_gauge("mesh.bytes_per_flush") == full
        for job in ts.plain_jobs(ts.TORCH, 4, 8):
            server.register_job(job)
        assert server.drain_to_idle(60)
        _gen, dirty = server.store.usage_delta_since(
            worker._usage_cache_sharded["gen"])
        cols = worker._device_columns(table, sharded=True)
        staged = server.metrics.get_gauge("mesh.bytes_per_flush")
        assert staged < full / 2
        width = pow2_bucket(len(dirty), floor=8)
        # one i32 index staging, then three f64 value stagings
        assert staged == (0.0 if not dirty else width * 4 + 3 * width * 8)
        assert server.metrics.get_gauge("mesh.mirror_hit_rate") > 0.0
        assert worker.mesh_used > 0 and chains
        mirror = worker._usage_cache_sharded["cols"]
        assert cols is mirror
        for args, c in chains:
            if args[3] is not mirror[3]:
                continue  # a later chunk's carry
            for i, sh in enumerate(c.shards):
                for j in range(3):
                    assert sh.tot[j].data_ptr() == args[j].shards[i].data_ptr()
                    assert sh.use[j].data_ptr() != args[3 + j].shards[i].data_ptr()
        assert any(args[0] is mirror[0] for args, _c in chains)
    finally:
        server.stop()


# -- the supervisor on the mesh path ---------------------------------------

SUPERVISED = {
    "NOMAD_TPU_SUPERVISOR": "1",
    "NOMAD_TPU_WATCHDOG_MIN_S": "60",
    "NOMAD_TPU_WATCHDOG_MAX_S": "60",
    "NOMAD_TPU_INIT_GRACE_S": "60",
    "NOMAD_TPU_PROBE_INTERVAL_S": "3600",
}


def _placed(server, jobs):
    return {job.id: ts.placements(server, job.id) for job in jobs}


def _supervised(monkeypatch, mesh, seed=13):
    for key, value in SUPERVISED.items():
        monkeypatch.setenv(key, value)
    server = TorchServer(num_schedulers=1, seed=seed, batch_pipeline=True,
                         heartbeat_ttl=1e9, device="cpu", mesh=mesh)
    sup = server.device_supervisor
    assert sup.expected
    return server, sup


def test_trip_mid_chain_holds_recovers_and_reuploads(monkeypatch):
    """A trip while a mesh chain is in flight: the wave is nacked once
    and held, the sharded mirror and the carry are dropped (the mesh is
    down while LOST); after the canary passes, the first sync re-uploads
    the sharded mirror in full under the new epoch, and the held evals
    place as an unsharded run places them."""
    from nomad_tpu_torch.device import DeviceFault
    from nomad_tpu_torch.device.supervisor import HEALTHY, LOST

    nodes = ts.make_nodes(ts.TORCH, 64, 6)
    jobs = ts.plain_jobs(ts.TORCH, 12, 21, prefix="trip")
    ref = TorchServer(num_schedulers=1, seed=13, batch_pipeline=True,
                      heartbeat_ttl=1e9, device="cpu")
    want = ts.run_stream(ref, ts.TORCH, nodes, [lambda s, p: [
        s.register_job(copy.deepcopy(j)) for j in jobs]])

    mesh = VirtualMesh(4, "cpu")
    server, sup = _supervised(monkeypatch, mesh)
    worker = server.workers[0]
    launches = []
    orig_launch = worker._launch_chunk_mesh

    def tripping(asm, c0, c1, carry):
        handle = orig_launch(asm, c0, c1, carry)
        launches.append(c0)
        if len(launches) == 1:
            sup.trip("mesh_launch")  # LOST with the chain in flight
        return handle

    syncs = []
    orig_sync = worker._device_columns_sharded

    def recorded(table):
        cols = orig_sync(table)
        syncs.append((worker._usage_cache_sharded["key"][0],
                      server.metrics.get_gauge("mesh.bytes_per_flush")))
        return cols

    worker._launch_chunk_mesh = tripping
    worker._device_columns_sharded = recorded
    for node in nodes:
        server.register_node(copy.deepcopy(node))
    for job in jobs:
        server.register_job(copy.deepcopy(job))
    server.start()
    try:
        with pytest.raises(DeviceFault):
            server.drain_to_idle(30)
        assert sup.state() == LOST and sup.holding()
        assert launches == [0]
        # the hold is set before the trip's listeners flush, on the
        # tripping thread, so drain_to_idle may raise before the flush
        deadline = time.monotonic() + 10.0
        while worker._mesh is not None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert worker._mesh is None and worker._usage_cache_sharded is None
        assert all(p == [] for p in _placed(server, jobs).values())
        epoch_lost = sup.backend_epoch
        for _ in range(sup.recover_canaries):
            assert sup.probe_once()
        assert sup.state() == HEALTHY and not sup.holding()
        assert worker._mesh is mesh
        assert server.drain_to_idle(60)
        assert _placed(server, jobs) == want
        table = server.store.node_table
        full = float(sum(c.nbytes for c in (
            table.cpu_total, table.mem_total, table.disk_total,
            table.cpu_used, table.mem_used, table.disk_used)))
        after = [b for epoch, b in syncs if epoch == sup.backend_epoch]
        assert sup.backend_epoch == epoch_lost + 1
        assert after and after[0] == full  # in full, not a delta
        assert worker.mesh_used > 0 and worker.errors == 0
    finally:
        server.stop()


def test_mesh_that_cannot_come_back_stops_the_worker(monkeypatch):
    """No fallback after an incident either: a mesh that cannot be
    rebuilt when the canary passes makes the next flush a device fault;
    nothing is placed unsharded."""
    from nomad_tpu_torch.device import DeviceFault

    server, sup = _supervised(monkeypatch, VirtualMesh(2, "cpu"))
    worker = server.workers[0]
    server.start()
    try:
        for node in ts.make_nodes(ts.TORCH, 16, 7):
            server.register_node(node)
        sup.trip("manual")

        def gone():
            raise RuntimeError("the process group went away")

        worker._make_mesh = gone
        for _ in range(sup.recover_canaries):
            sup.probe_once()
        assert worker._mesh is None
        jobs = ts.plain_jobs(ts.TORCH, 3, 2, prefix="gone")
        for job in jobs:
            server.register_job(job)
        with pytest.raises(DeviceFault, match="mesh is down"):
            server.drain_to_idle(30)
        assert all(p == [] for p in _placed(server, jobs).values())
        assert worker.prescored == 0
    finally:
        server.stop()


# -- no fallback -------------------------------------------------------------


def test_mesh_without_a_usable_group_or_device_raises(monkeypatch, tmp_path):
    """NOMAD_TPU_MESH=1 without mesh= needs an initialised process group
    of more than one rank; a mesh on another device than the server's,
    or one given to the sequential pipeline, raises at construction."""
    import torch
    import torch.distributed as dist

    monkeypatch.setenv("NOMAD_TPU_MESH", "1")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed"):
        TorchServer(device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="more than one"):
            TorchServer(device="cpu")
    finally:
        dist.destroy_process_group()
    monkeypatch.delenv("NOMAD_TPU_MESH")
    elsewhere = VirtualMesh(2, "cpu")
    monkeypatch.setattr(elsewhere, "device", torch.device("meta"))
    with pytest.raises(ValueError, match="a mesh on meta"):
        TorchServer(device="cpu", mesh=elsewhere)
    with pytest.raises(ValueError, match="batch_pipeline"):
        TorchServer(device="cpu", batch_pipeline=False,
                    mesh=VirtualMesh(2, "cpu"))
