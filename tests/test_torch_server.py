"""Port parity: the port's batched `Server` (BatchWorker -> kernel K3's
twin -> prescored replay) against the JAX package's batched `Server`
and the port's sequential `Server`, on the scenarios of
tests/test_batch_pipeline.py at small sizes (8-24 nodes), on the CPU.
Placements (alloc name -> node) must be exactly equal.

Both packages build the same cluster from the same seeds through their
own `mock` and `structs` (node ids and names are fixed so nothing
random differs between them).
"""
import copy
import dataclasses
import random
import types

import pytest

import nomad_tpu.mock as jmock
import nomad_tpu.structs as jstructs
import nomad_tpu_torch.mock as tmock
import nomad_tpu_torch.structs as tstructs
from nomad_tpu.server import Server as JaxServer
from nomad_tpu_torch.device import NoDeviceError
from nomad_tpu_torch.server import Server as TorchServer

JAX = types.SimpleNamespace(mock=jmock, structs=jstructs)
TORCH = types.SimpleNamespace(mock=tmock, structs=tstructs)


def make_nodes(pkg, n, seed, dcs=None, gpus=0):
    rng = random.Random(seed)
    nodes = []
    for i in range(n):
        node = pkg.mock.node(id=f"node-{seed}-{i:03d}", name=f"n{i}")
        node.node_resources.cpu = rng.choice([4000, 8000])
        node.node_resources.memory_mb = rng.choice([8192, 16384])
        if dcs:
            node.datacenter = rng.choice(dcs)
        node.computed_class = pkg.structs.compute_node_class(node)
        nodes.append(node)
    for g in range(gpus):
        node = pkg.mock.nvidia_node(id=f"gpu-{seed}-{g}", name=f"g{g}")
        for dev in node.node_resources.devices:
            dev.instance_ids = [f"gpu-{seed}-{g}-{k}" for k in
                                range(len(dev.instance_ids))]
        nodes.append(node)
    return nodes


def plain_jobs(pkg, n, seed, prefix="job"):
    rng = random.Random(seed)
    jobs = []
    for i in range(n):
        job = pkg.mock.job(id=f"{prefix}-{i}")
        job.task_groups[0].count = rng.randint(1, 5)
        job.task_groups[0].tasks[0].resources.cpu = rng.choice([200, 500])
        jobs.append(job)
    return jobs


def spread_jobs(pkg, even):
    S = pkg.structs
    jobs = []
    for i in range(6):
        job = pkg.mock.job(id=f"spread-{i}",
                           datacenters=["dc1", "dc2", "dc3"])
        tg = job.task_groups[0]
        tg.count = 6 if not even else 2 + i % 3
        tg.tasks[0].resources.cpu = 300
        targets = () if even else (
            S.SpreadTarget(value="dc1", percent=50),
            S.SpreadTarget(value="dc2", percent=30),
        )
        job.spreads = [S.Spread(attribute="${node.datacenter}", weight=60,
                                targets=list(targets))]
        if i % 2:
            job.affinities = [S.Affinity(
                ltarget="${node.datacenter}", operand="=", rtarget="dc2",
                weight=40,
            )]
        jobs.append(job)
    return jobs + plain_jobs(pkg, 3, 9, prefix="plain")


def dh_job(pkg, count):
    job = pkg.mock.job(id="dh-job")
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].resources.cpu = 200
    job.constraints = list(job.constraints) + [
        pkg.structs.Constraint(operand="distinct_hosts")
    ]
    return job


def port_jobs(pkg):
    S = pkg.structs
    jobs = []
    for i in range(3):
        job = pkg.mock.job(id=f"port-{i}")
        tg = job.task_groups[0]
        tg.count = 3
        tg.tasks[0].resources.cpu = 200
        tg.networks = [S.NetworkResource(
            mode="host", reserved_ports=[S.Port(label="http", value=8080)],
        )]
        jobs.append(job)
    other = pkg.mock.job(id="port-other")
    other.task_groups[0].count = 2
    other.task_groups[0].networks = [S.NetworkResource(
        mode="host", reserved_ports=[S.Port(label="admin", value=9443)],
    )]
    plain = pkg.mock.job(id="port-plain")
    plain.task_groups[0].count = 2
    return jobs + [other, plain]


def gpu_jobs(pkg):
    def gpu_job(jid, count, gpus):
        job = pkg.mock.job(id=jid)
        tg = job.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = 100
        tg.tasks[0].resources.devices = [
            pkg.structs.RequestedDevice(name="gpu", count=gpus)
        ]
        return job

    jobs = [gpu_job(f"gpu-{i}", 2, 2) for i in range(3)]
    jobs.append(gpu_job("gpu-over", 1, 2))
    plain = pkg.mock.job(id="gpu-plain")
    plain.task_groups[0].count = 2
    return jobs + [plain]


def multi_group_jobs(pkg):
    S = pkg.structs

    def add_group(job, name, count, cpu, mem):
        tg0 = job.task_groups[0]
        job.task_groups.append(S.TaskGroup(
            name=name, count=count,
            restart_policy=tg0.restart_policy,
            reschedule_policy=tg0.reschedule_policy,
            tasks=[S.Task(
                name=f"{name}-task", driver="mock_driver",
                resources=dataclasses.replace(
                    tg0.tasks[0].resources, cpu=cpu, memory_mb=mem
                ),
            )],
            ephemeral_disk=tg0.ephemeral_disk,
        ))

    rng = random.Random(7)
    jobs = []
    for i in range(10):
        job = pkg.mock.job(id=f"mtg-{i}")
        job.task_groups[0].count = rng.randint(1, 4)
        job.task_groups[0].tasks[0].resources.cpu = rng.choice([200, 500])
        if i % 3 != 2:
            add_group(job, "api", rng.randint(1, 3), rng.choice([300, 700]),
                      512)
        if i % 4 == 1:
            add_group(job, "cache", 2, 250, 256)
        jobs.append(job)
    return jobs


def placements(server, job_id):
    return sorted(
        (a.name, a.node_id)
        for a in server.store.allocs_by_job("default", job_id)
        if not a.terminal_status()
    )


def all_placements(server):
    jobs = sorted({a.job_id for a in server.store.allocs.values()})
    return {j: placements(server, j) for j in jobs}


def run_stream(server, pkg, nodes, stages):
    """Register the nodes, then run each stage (a callable taking the
    server and the package) and drain after it."""
    server.start()
    try:
        for node in nodes:
            server.register_node(copy.deepcopy(node))
        for stage in stages:
            stage(server, pkg)
            assert server.drain_to_idle(60)
        return all_placements(server)
    finally:
        server.stop()


def register(make_jobs):
    def stage(server, pkg):
        for job in make_jobs(pkg):
            server.register_job(job)
    return stage


def churn_stage(server, pkg):
    jobs = reschedule_now(pkg)
    for i in (0, 2, 5):
        grown = jobs[i]
        grown.task_groups[0].count += 3
        server.register_job(grown)
    for k in range(2):
        nj = pkg.mock.job(id=f"churn-new-{k}")
        nj.task_groups[0].count = 2
        server.register_job(nj)


def node_down_stage(server, pkg):
    server.update_node_status("node-21-003", "down")


def fail_stage(server, pkg):
    victims = []
    for job_id in ("job-1", "job-4"):
        live = sorted(
            (a for a in server.store.allocs_by_job("default", job_id)
             if not a.terminal_status()),
            key=lambda a: a.name,
        )
        failed = copy.deepcopy(live[0])
        failed.client_status = "failed"
        victims.append(failed)
    for failed in victims:
        server.update_allocs_from_client([failed])


def reschedule_now(pkg):
    jobs = plain_jobs(pkg, 8, 22)
    for job in jobs:
        job.task_groups[0].reschedule_policy = pkg.structs.ReschedulePolicy(
            delay_s=0.0, unlimited=True
        )
    return jobs


SCENARIOS = {
    # name: (nodes(pkg), stages, seed)
    "binpack": (lambda p: make_nodes(p, 20, 0),
                [register(lambda p: plain_jobs(p, 8, 1))], 99),
    "spread_percent": (
        lambda p: make_nodes(p, 24, 5, dcs=["dc1", "dc2", "dc3"]),
        [register(lambda p: spread_jobs(p, even=False))], 42),
    "spread_even": (
        lambda p: make_nodes(p, 12, 3, dcs=["dc1", "dc2", "dc3"]),
        [register(lambda p: spread_jobs(p, even=True))], 42),
    "churn": (lambda p: make_nodes(p, 24, 21),
              [register(reschedule_now), churn_stage, node_down_stage,
               fail_stage], 77),
    "distinct_hosts": (lambda p: make_nodes(p, 12, 31),
                       [register(lambda p: [dh_job(p, 5)]),
                        register(lambda p: [dh_job(p, 9)])], 41),
    "static_ports": (lambda p: make_nodes(p, 10, 3),
                     [register(port_jobs)], 77),
    "device_asks": (lambda p: make_nodes(p, 8, 6, gpus=3),
                    [register(gpu_jobs)], 55),
    "multi_task_group": (lambda p: make_nodes(p, 24, 5),
                         [register(multi_group_jobs)], 41),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_batched_server_matches_jax_and_sequential(scenario):
    nodes_of, stages, seed = SCENARIOS[scenario]
    jax_server = JaxServer(num_schedulers=1, seed=seed, batch_pipeline=True,
                           heartbeat_ttl=1e9)
    want = run_stream(jax_server, JAX, nodes_of(JAX), stages)
    assert jax_server.workers[0].prescored > 0

    port = TorchServer(num_schedulers=1, seed=seed, batch_pipeline=True,
                       heartbeat_ttl=1e9, device="cpu")
    got = run_stream(port, TORCH, nodes_of(TORCH), stages)
    worker = port.workers[0]
    assert got == want
    assert worker.prescored > 0
    assert worker.errors == 0

    sequential = TorchServer(num_schedulers=1, seed=seed,
                             batch_pipeline=False, heartbeat_ttl=1e9,
                             device="cpu")
    cfg = sequential.store.get_scheduler_config()
    cfg.tpu_scheduler_enabled = True  # the per-eval device stack's twins
    sequential.store.set_scheduler_config(cfg)
    assert run_stream(sequential, TORCH, nodes_of(TORCH), stages) == want
    assert sequential.workers[0].errors == 0


def test_server_without_a_card_raises(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        TorchServer()
    with pytest.raises(NoDeviceError):
        TorchServer(batch_pipeline=False)


def test_mesh_without_a_mesh_or_group_raises(monkeypatch):
    """NOMAD_TPU_MESH=1 with neither the Server's mesh= nor an
    initialised torch.distributed group raises at construction: the
    batch worker never runs unsharded (or on the CPU) in its place."""
    monkeypatch.setenv("NOMAD_TPU_MESH", "1")
    with pytest.raises(RuntimeError, match="mesh="):
        TorchServer(device="cpu")


def _kernel_fault(*_args, **_kwargs):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("stage", [
    "nomad_tpu_torch.ops.batch.chained_picks_twin",  # K3's launch
    "nomad_tpu_torch.ops.batch.patch_rows_twin",     # K4's mirror patch
    "nomad_tpu_torch.server.batch_worker.BatchWorker._fetch",
])
def test_device_fault_stops_the_worker(monkeypatch, stage):
    """A failing device stage stops the batch worker and drain_to_idle
    raises it; the evals are not placed through the host oracle."""
    from nomad_tpu_torch.server.batch_worker import DeviceFault

    port = TorchServer(num_schedulers=1, seed=5, batch_pipeline=True,
                       heartbeat_ttl=1e9, device="cpu")
    port.start()
    try:
        for node in make_nodes(TORCH, 12, 4):
            port.register_node(node)
        for job in plain_jobs(TORCH, 3, 8):
            port.register_job(job)
        assert port.drain_to_idle(60)
        worker = port.workers[0]
        assert worker.prescored > 0 and worker.errors == 0
        prescored = worker.prescored

        monkeypatch.setattr(stage, _kernel_fault)
        for job in plain_jobs(TORCH, 3, 9, prefix="late"):
            port.register_job(job)
        with pytest.raises(DeviceFault) as info:
            port.drain_to_idle(60)
        assert isinstance(info.value.__cause__, RuntimeError)
        assert worker.fault is info.value
        assert worker.errors == 1
        assert worker.prescored == prescored
        assert worker.fallbacks == 0
        assert all(placements(port, f"late-{i}") == [] for i in range(3))
        worker._thread.join(5)
        assert not worker._thread.is_alive()
    finally:
        port.stop()


def policy_job(pkg):
    job = pkg.mock.job(id="policy-job")
    job.task_groups[0].count = 10
    job.policy = pkg.structs.PolicySpec(throughput={"a": 1, "b": 2})
    return job


def test_policy_job_stops_the_sequential_worker():
    """A policy-weighted job through the sequential Server with the
    per-eval device stack on: the port's CUDA stack (the twins here)
    places it as the JAX sequential Server's device stack does, with no
    worker error.  The batched Server sends the job to its host stack
    and places what the JAX batched Server places."""
    def sequential(server, pkg):
        cfg = server.store.get_scheduler_config()
        cfg.tpu_scheduler_enabled = True  # the per-eval device stack
        server.store.set_scheduler_config(cfg)
        return server

    stages = [register(lambda p: [policy_job(p)])]
    want = run_stream(
        sequential(JaxServer(num_schedulers=1, seed=13,
                             batch_pipeline=False, heartbeat_ttl=1e9), JAX),
        JAX, make_nodes(JAX, 8, 12), stages)
    seq = sequential(TorchServer(num_schedulers=1, seed=13,
                                 batch_pipeline=False, heartbeat_ttl=1e9,
                                 device="cpu"), TORCH)
    got = run_stream(seq, TORCH, make_nodes(TORCH, 8, 12), stages)
    assert got == want
    assert len(got["policy-job"]) == 10
    worker = seq.workers[0]
    assert worker.fault is None and worker.errors == 0
    assert seq.broker.stats["delivery_failures"] == 0

    want = run_stream(JaxServer(num_schedulers=1, seed=13,
                                batch_pipeline=True, heartbeat_ttl=1e9),
                      JAX, make_nodes(JAX, 8, 12), stages)
    port = TorchServer(num_schedulers=1, seed=13, batch_pipeline=True,
                       heartbeat_ttl=1e9, device="cpu")
    got = run_stream(port, TORCH, make_nodes(TORCH, 8, 12), stages)
    assert got == want
    assert len(got["policy-job"]) == 10
    assert port.workers[0].errors == 0
