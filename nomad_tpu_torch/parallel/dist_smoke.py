"""The multi-process smoke: proof that the node mesh works across
processes, as `nomad_tpu/parallel/dist_smoke.py` proves it for the JAX
package.

``python -m nomad_tpu_torch.parallel.dist_smoke`` spawns N local worker
processes (default 2), joins them into one gloo world through the
production ``NOMAD_TPU_DIST*`` knobs, gives each rank
``NOMAD_TPU_SHARDS_PER_RANK`` node shards (default 2: the port's
counterpart of the JAX launcher's ``--xla_force_host_platform_device_count``,
so the default world is 2 ranks x 2 shards), and drives every rank
through the real pipeline in lockstep: every process launches the same
sequence, each holding only its own shards.  The ranks run on the card
unless ``device="cpu"`` (``--device cpu``); ranks on one card share it,
each with its own CUDA context, and exchange over gloo through the host.
That is not multi-GPU scaling: it proves the protocol, not a speed.

Per rank, in order:

1. **World and mesh**: `distributed_init()` from the knobs, then a
   Server whose BatchWorker mesh spans every rank's shards
   (``_mesh_hosts == procs``), its kernels loaded before any stage.
2. **Chain**: single-group jobs through the worker's own
   ``_process_batch`` (assemble, K12 launches over the distributed mesh
   with the sharded carry threaded chunk to chunk, fetch, replay), zero
   lost evals.
3. **Per-host flush**: the dirty rows of the chain's commits, then a
   warm sharded mirror sync: the shard-local staging stored by K15
   (`patch_rows_hostlocal`) must stage exactly the closed-form O(dirty
   rows) bytes per host, below the full upload's.
4. **Storm**: a same-family backlog drained by the real
   ``_maybe_drain_storm`` and solved by K14 over the distributed mesh;
   then a kernel A/B: K14 on the mesh against K5 on one device (the
   twins on the CPU), all six outputs equal (the score's zeros compared
   by value: a sharded read adds +0.0 from the other shards), both
   timed.
5. **Cross-host parity**: digests of the placements all-gathered over
   the group must agree on every rank.

The workers are driven synchronously (the broker's consumer thread never
starts; `worker.start` is replaced after the kernels load), with every
eval enqueued before any dispatch, admission off and the latency budget
off, so every process issues the same collectives in the same order.
The JAX launcher's ``NOMAD_TPU_SYNC_COMPILE`` has no counterpart: the
port compiles nothing at run time.  A stage of one rank waits in a
collective for the other's, so the pinned knobs also set the stage
watchdog's floor (``NOMAD_TPU_WATCHDOG_MIN_S``) above one rank's pace.

`reference()` runs the same world through an unsharded Server driven
the same way, for the placements the meshed world must equal.
`launch_pod()` runs a pod instead of lockstep: a head Server
(``NOMAD_TPU_POD_PORT``, ``NOMAD_TPU_POD_CHECK=1``) drains the chain's
jobs, then the family as one wave, on its own threads while one peer
(`parallel/pod.py`) replays its stream; every chain and storm digest
must match.

The world size: ``NOMAD_TPU_SMOKE_NODES``, ``NOMAD_TPU_SMOKE_JOBS`` and
``NOMAD_TPU_SMOKE_FAMILY`` (defaults 12, 12, 16: a 16-row arena).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from .mesh import SHARDS_PER_RANK_ENV
from .pod import foreign_modules, launch_counts

SHARDS_PER_PROC = 2
CHAIN_NODES = 12  # -> capacity 16: tiles over 4 shards
CHAIN_JOBS = 12
FAMILY_JOBS = 16
KERNEL_E, KERNEL_A, KERNEL_C = 16, 64, 256
# a stage waits in a collective for the slowest rank: its watchdog's floor
RANK_WATCHDOG_MIN_S = 120
# the worker's knobs of every process of the drive (and of `reference`):
# storms on, and no timing-dependent admission or chunk-width planning
DRIVE_KNOBS = {
    "NOMAD_TPU_STORM": "1",
    "NOMAD_TPU_STORM_MIN": "8",
    "NOMAD_TPU_ADMIT": "0",
    "NOMAD_TPU_LATENCY_BUDGET_MS": "0",
}


def _world_knob(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, default)))
    except ValueError:
        return default


def smoke_world() -> dict:
    """The world-size knobs, defaulted to the tiny world:
    NOMAD_TPU_SMOKE_NODES (cluster size), NOMAD_TPU_SMOKE_JOBS (chain
    evals), NOMAD_TPU_SMOKE_FAMILY (storm family size)."""
    return {
        "nodes": _world_knob("NOMAD_TPU_SMOKE_NODES", CHAIN_NODES),
        "jobs": _world_knob("NOMAD_TPU_SMOKE_JOBS", CHAIN_JOBS),
        "family": _world_knob("NOMAD_TPU_SMOKE_FAMILY", FAMILY_JOBS),
    }


def _smoke_device():
    """NOMAD_TPU_SMOKE_DEVICE: "cpu" for the twins, else the card."""
    return os.environ.get("NOMAD_TPU_SMOKE_DEVICE") or None


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# the world and its drive (shared by the ranks, the pod head and reference)
# ---------------------------------------------------------------------------


def _digest(value) -> int:
    blob = json.dumps(value, sort_keys=True, default=str)
    return int.from_bytes(hashlib.sha256(blob.encode()).digest()[:8],
                          "big") % (2**62)


def _allgather(values) -> "np.ndarray":  # noqa: F821
    """[world, len(values)] int64 of every rank's `values` (gloo, on the
    host): the phase barrier of the lockstep drive."""
    import torch
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.int64)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy()


def _lockstep() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _assert_same_everywhere(tag: str, value) -> None:
    """All-gather a digest of `value` over the group and require every
    rank's to agree: the cross-host parity fence (and a barrier).  One
    process: nothing to compare."""
    if not _lockstep():
        return
    got = _allgather([_digest(value)])[:, 0]
    if not (got == got[0]).all():
        raise AssertionError(
            f"cross-host divergence in {tag}: digests {got.tolist()}")


def _make_nodes(n, seed=0):
    import random

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import compute_node_class

    rng = random.Random(seed)
    nodes = []
    for i in range(n):
        node = mock.node(id=f"dist-node-{seed}-{i:03d}")
        node.node_resources.cpu = rng.choice([4000, 8000])
        node.node_resources.memory_mb = rng.choice([8192, 16384])
        node.computed_class = compute_node_class(node)
        nodes.append(node)
    return nodes


def _make_jobs(n, prefix="dist", seed=1):
    import random

    from nomad_tpu_torch import mock

    rng = random.Random(seed)
    jobs = []
    for i in range(n):
        job = mock.job(id=f"{prefix}-{i:03d}")
        job.task_groups[0].count = rng.randint(1, 3)
        job.task_groups[0].tasks[0].resources.cpu = rng.choice([200, 400])
        jobs.append(job)
    return jobs


def _family_jobs(n, fam="distfam"):
    from nomad_tpu_torch import mock

    jobs = []
    for i in range(n):
        job = mock.job(id=f"{fam}/dispatch-{i:04d}")
        job.type = "batch"
        job.task_groups[0].count = 1
        job.task_groups[0].tasks[0].resources.cpu = 500
        job.task_groups[0].tasks[0].resources.memory_mb = 1024
        jobs.append(job)
    return jobs


def _drain_broker(server, worker, expect: int, timeout=60.0):
    """Wait until the quiescent broker holds `expect` ready evals, then
    dequeue them all (FIFO): the deterministic stand-in for the run()
    gulp, taken while the consumer thread is paused."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if server.broker.ready_count(worker.schedulers) >= expect:
            break
        time.sleep(0.02)
    members = []
    for _ in range(expect):
        ev, token = server.broker.dequeue(worker.schedulers, timeout=5.0)
        assert ev is not None, f"broker ran dry at {len(members)}/{expect}"
        members.append((ev, token))
    return members


def _settled(e) -> bool:
    """Processed to the end: terminal, or parked blocked for capacity."""
    return e.terminal_status() or e.should_block()


def _process(worker, batch) -> None:
    leftover = worker._process_batch(batch)
    for _ in range(8):
        if not leftover:
            break
        leftover = worker._process_batch(leftover)
    assert not leftover, f"{len(leftover)} evals stuck"


def _drain_residuals(server, worker, jobs, timeout=120.0):
    """Process late evals (blocked-eval requeues, re-evaluations) until
    every eval is settled and the broker is dry, in lockstep: each round
    all-gathers (ready, settled) so every rank dequeues the same batch
    in the same round."""
    deadline = time.monotonic() + timeout
    while True:
        ready = server.broker.ready_count(worker.schedulers)
        term = all(_settled(e) for job in jobs
                   for e in server.store.evals_by_job("default", job.id))
        agg = _allgather([ready, int(term)]) if _lockstep() else [[ready, int(term)]]
        max_ready = max(int(r[0]) for r in agg)
        if max_ready == 0 and all(int(r[1]) for r in agg):
            return
        assert time.monotonic() < deadline, (
            f"residual evals never settled: {[list(map(int, r)) for r in agg]}")
        if max_ready == 0:
            time.sleep(0.05)
            continue
        # the same evals exist on every rank (replicated state): wait
        # for this rank's copy, then process the same batch everywhere
        while (server.broker.ready_count(worker.schedulers) < max_ready
               and time.monotonic() < deadline):
            time.sleep(0.02)
        batch = []
        for _ in range(max_ready):
            ev, token = server.broker.dequeue(worker.schedulers, timeout=5.0)
            assert ev is not None, "residual eval vanished"
            batch.append((ev, token))
        _process(worker, batch)


def _placements(server, jobs):
    return sorted(
        (job.id, a.name, a.node_id)
        for job in jobs
        for a in server.store.allocs_by_job("default", job.id)
        if not a.terminal_status())


def _assert_zero_lost(server, jobs):
    for job in jobs:
        evs = server.store.evals_by_job("default", job.id)
        assert evs, f"no evals for {job.id}"
        bad = [(e.id, e.status, e.status_description)
               for e in evs if not _settled(e)]
        assert not bad, f"unsettled evals for {job.id}: {bad}"
    assert server.broker.failed() == []


def _new_server(device):
    from nomad_tpu_torch.server import Server

    # a long heartbeat TTL: this drive is synchronous, and the default
    # would mark the (clientless) nodes down in a slow phase
    return Server(num_schedulers=1, seed=29, batch_pipeline=True,
                  heartbeat_ttl=600.0, device=device)


def _start_synchronous(server, world):
    """The world's nodes and chain jobs registered, the Server started
    with its batch worker's kernels loaded and its consumer thread never
    started.  Returns (worker, chain jobs)."""
    worker = server.workers[0]
    worker._load_kernels()
    worker.start = lambda: None  # type: ignore[method-assign]
    for node in _make_nodes(world["nodes"], seed=5):
        server.register_node(node)
    chain_jobs = _make_jobs(world["jobs"], seed=7)
    for job in chain_jobs:
        server.register_job(job)
    server.start()
    return worker, chain_jobs


def _drive_chain(server, worker, chain_jobs) -> dict:
    members = _drain_broker(server, worker, len(chain_jobs))
    t0 = time.monotonic()
    _process(worker, members)
    dt = time.monotonic() - t0
    _drain_residuals(server, worker, chain_jobs)
    _assert_zero_lost(server, chain_jobs)
    placed = _placements(server, chain_jobs)
    assert placed, "chain placed nothing"
    _assert_same_everywhere("chain placements", placed)
    return {"evals": len(chain_jobs), "placements": len(placed),
            "placements_per_sec": round(len(placed) / dt, 1),
            "placed": placed}


def _drive_storm(server, worker, chain_jobs, n_family) -> dict:
    fam_jobs = _family_jobs(n_family)
    for job in fam_jobs:
        server.register_job(job)
    # the whole wave in, then ONE member dequeued and the real detector
    # left to drain the family prefix: every rank sees the same storm
    deadline = time.monotonic() + 60.0
    while (server.broker.ready_count(worker.schedulers) < n_family
           and time.monotonic() < deadline):
        time.sleep(0.02)
    ev0, token0 = server.broker.dequeue(worker.schedulers, timeout=5.0)
    assert ev0 is not None
    assert ev0.job_id.startswith("distfam/"), (
        f"stray eval {ev0.job_id} raced the storm phase")
    storm = worker._maybe_drain_storm(ev0, token0)
    assert storm is not None and len(storm) == n_family, (
        "storm detector missed the family backlog")
    leftover = worker._process_storm(storm)
    if leftover:
        _process(worker, leftover)
    assert worker.storm_solves >= 1, "storm solve never ran"
    _drain_residuals(server, worker, chain_jobs + fam_jobs)
    _assert_zero_lost(server, fam_jobs)
    placed = _placements(server, fam_jobs)
    _assert_same_everywhere("storm placements", placed)
    return {"members": n_family, "solves": worker.storm_solves,
            "fallbacks": worker.storm_fallbacks,
            "placements": len(placed),
            "solve_wall_s": round(worker.timings["storm_solve"], 4),
            "placed": placed}


def _kernel_storm_problem(E, A, C, device):
    import numpy as np

    from nomad_tpu_torch.state.convert import storm_inputs

    rng = np.random.default_rng(17)
    perm = np.tile(rng.permutation(C).astype(np.int32), (E, 1))
    inp = storm_inputs({
        "feasible": rng.random((E, C)) > 0.1,
        "affinity": np.where(rng.random((E, C)) > 0.8, rng.random((E, C)), 0.0),
        "collisions": (rng.random((E, C)) > 0.9).astype(np.int32),
        "perm": perm,
        "limit": np.full(E, 2, np.int32),
        "n_cand": np.full(E, C, np.int32),
        "eval_of": (np.arange(A) % E).astype(np.int32),
        "penalty": rng.random((A, C)) > 0.95,
        "ask": np.tile(np.asarray((1000.0, 100.0, 100.0)), (A, 1)),
        "desired": np.ones(A, np.int32),
        "real": np.ones(A, bool),
        "pre_cpu": np.zeros(C),
        "pre_mem": np.zeros(C),
        "pre_disk": np.zeros(C),
    }, device)
    cols = (np.full(C, 4000.0), np.full(C, 8192.0), np.full(C, 100000.0),
            rng.integers(0, 1000, C).astype(np.float64), np.zeros(C),
            np.zeros(C))
    return inp, cols


def _storm_ab(mesh, device) -> tuple:
    """K14 on the mesh against K5 on one device, same inputs: all six
    outputs equal (the score by value), both timed (best of 3)."""
    import torch

    from nomad_tpu_torch.ops.solve import (
        StormOut,
        storm_assignment,
        storm_assignment_sharded,
    )
    from nomad_tpu_torch.parallel.mesh import mesh_put
    from nomad_tpu_torch.sched.storm import stage_for_mesh

    inp, cols = _kernel_storm_problem(KERNEL_E, KERNEL_A, KERNEL_C,
                                      mesh.device)
    whole = tuple(torch.from_numpy(c).to(mesh.device) for c in cols)
    s_cols = tuple(mesh_put(mesh, c) for c in cols)
    fn = storm_assignment_sharded(mesh, False, KERNEL_A)
    s_inp = stage_for_mesh(inp, mesh)

    def single():
        return storm_assignment(inp, whole, spread_fit=False,
                                max_rounds=KERNEL_A)

    def sharded():
        return fn(s_inp, s_cols)

    def realized(f):
        return tuple(x.cpu() for x in f())

    a, b = realized(single), realized(sharded)
    for name, x, y in zip(StormOut._fields, a, b):
        assert torch.equal(x, y), (
            f"the sharded storm (K14) diverged from the single-device one "
            f"(K5) in {name}")

    def best_of(f, n=3):
        best = float("inf")
        for _ in range(n):
            t = time.perf_counter()
            realized(f)
            best = min(best, time.perf_counter() - t)
        return best

    row = {"rows": KERNEL_A, "arena": KERNEL_C, "rounds": int(a[5]),
           "bit_identical": True,
           "single_device_ms": round(best_of(single) * 1000.0, 3),
           "sharded_ms": round(best_of(sharded) * 1000.0, 3)}
    return row, a[0].tolist()


def run_worker() -> int:
    """One rank of the world.  Exits non-zero on any parity or liveness
    failure; rank 0 prints the result row."""
    assert os.environ.get("NOMAD_TPU_DIST") == "1", (
        "a rank needs the NOMAD_TPU_DIST* knobs (use the launcher)")
    from nomad_tpu_torch.ops.batch import pow2_bucket
    from nomad_tpu_torch.parallel.mesh import (
        distributed_init,
        local_device_count,
    )

    assert distributed_init(), "the distributed world did not form"
    import numpy as np
    import torch.distributed as dist

    rank, procs = dist.get_rank(), dist.get_world_size()
    world = smoke_world()
    server = _new_server(_smoke_device())
    worker = server.workers[0]
    mesh = worker._mesh
    assert mesh is not None, "no mesh on the distributed world"
    result = {"procs": procs, "devices_per_host": len(mesh.local_shards),
              "global_devices": mesh.n_shards, "world": world,
              "device": str(mesh.device),
              "pythonhashseed": os.environ.get("PYTHONHASHSEED")}
    try:
        worker, chain_jobs = _start_synchronous(server, world)
        assert worker._mesh_hosts == procs, (worker._mesh_hosts, procs)
        table = server.store.node_table
        assert table.capacity % mesh.n_shards == 0, (
            table.capacity, mesh.n_shards)

        # -- chain ----------------------------------------------------------
        result["chain"] = _drive_chain(server, worker, chain_jobs)
        assert worker.mesh_used > 0, "sharded launches never ran"
        result["chain"]["mesh_launches"] = worker.mesh_used

        # -- the per-host flush ---------------------------------------------
        n_dev = mesh.n_shards
        n_local = local_device_count(mesh)
        size = table.capacity // n_dev
        gen = worker._usage_cache_sharded["gen"]
        _, dirty = server.store.usage_delta_since(gen)
        worker._device_columns(table, sharded=True)
        staged = server.metrics.get_gauge("mesh.bytes_per_flush")
        full = sum(c.nbytes for c in (
            table.cpu_total, table.mem_total, table.disk_total,
            table.cpu_used, table.mem_used, table.disk_used)) * n_local // n_dev
        want = 0.0
        if dirty:
            idx = np.asarray(sorted(dirty), np.int32)
            per_dev = [int(((idx >= d * size) & (idx < (d + 1) * size)).sum())
                       for d in range(n_dev)]
            w = pow2_bucket(max(1, max(per_dev)), floor=8)
            want = n_local * w * 4 + 3 * n_local * w * 8
        assert staged == want, (staged, want)
        assert staged < full, (staged, full)
        result["flush"] = {
            "dirty_rows": len(dirty),
            "bytes_per_flush_delta_per_host": staged,
            "bytes_per_flush_closed_form": want,
            "bytes_per_flush_full_per_host": full,
        }

        # -- storm -----------------------------------------------------------
        result["storm"] = _drive_storm(server, worker, chain_jobs,
                                       world["family"])
        result["launches"] = launch_counts()
        # every rank's counts (a collective: every rank calls it)
        keys = sorted(result["launches"])
        result["launches_ranks"] = [
            dict(zip(keys, map(int, row))) for row in
            _allgather([result["launches"][k] for k in keys])]

        # -- the kernel A/B: K14 on the mesh against K5 ----------------------
        result["storm_kernel"], assigned = _storm_ab(mesh, mesh.device)
        _assert_same_everywhere("kernel assignment", assigned)
        result["launches_ab"] = {k: v - result["launches"][k]
                                 for k, v in launch_counts().items()}
        result["cross_host_parity"] = True
        result["zero_lost"] = True
        result["loaded"] = foreign_modules()
    finally:
        server.stop()
    if rank == 0:
        print("DIST_SMOKE_JSON " + json.dumps(result), flush=True)
    return 0


def reference(device="cpu", world: Optional[dict] = None) -> dict:
    """The same world through an unsharded Server on `device`, driven the
    same way (one process): the chain's and the storm's placements, which
    the meshed world must equal."""
    world = world or smoke_world()
    saved = {k: os.environ.get(k) for k in DRIVE_KNOBS}
    os.environ.update(DRIVE_KNOBS)  # read by the worker it builds
    try:
        server = _new_server(device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        worker, chain_jobs = _start_synchronous(server, world)
        assert worker._mesh is None
        chain = _drive_chain(server, worker, chain_jobs)
        storm = _drive_storm(server, worker, chain_jobs, world["family"])
    finally:
        server.stop()
    return {"chain": chain["placed"], "storm": storm["placed"]}


def run_pod_head() -> int:
    """Rank 0 of a pod: a Server whose worker heads the world
    (NOMAD_TPU_POD_PORT) drains the world's chain jobs, then its family
    as one storm, on its own threads, every chain and storm digest
    checked against the peers' (NOMAD_TPU_POD_CHECK=1).  Prints the
    result row."""
    world = smoke_world()
    server = _new_server(_smoke_device())
    worker = server.workers[0]
    pod = worker._pod
    assert pod is not None, "no pod head on rank 0"
    try:
        for node in _make_nodes(world["nodes"], seed=5):
            server.register_node(node)
        jobs = _make_jobs(world["jobs"], seed=7)
        for job in jobs:
            server.register_job(job)
        t0 = time.monotonic()
        server.start()
        assert server.drain_to_idle(600.0), "the pod head did not drain"
        dt = time.monotonic() - t0
        _assert_zero_lost(server, jobs)
        placed = _placements(server, jobs)
        # the family as one wave (under the broker's lock, so the idle
        # worker dequeues it whole): a storm solve, after a delta sync
        # of the chain's dirty rows, both streamed to the peer
        fam_jobs = _family_jobs(world["family"])
        with server.broker._lock:
            for job in fam_jobs:
                server.register_job(job)
        assert server.drain_to_idle(600.0), "the pod head's storm did not drain"
        _assert_zero_lost(server, fam_jobs)
        result = {"placed": placed, "placements": len(placed),
                  "placements_per_sec": round(len(placed) / dt, 1),
                  "storm_placed": _placements(server, fam_jobs),
                  "storm_solves": worker.storm_solves,
                  "mesh_storms": worker.mesh_storms,
                  "digests_checked": pod.checked, "sent": dict(pod.sent),
                  "mesh_launches": worker.mesh_used, "errors": worker.errors,
                  "hosts": worker._mesh_hosts, "launches": launch_counts(),
                  "loaded": foreign_modules()}
    finally:
        server.stop()  # closes the pod: the peer leaves on "bye"
    print("POD_HEAD_JSON " + json.dumps(result), flush=True)
    return 0


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


def _child_env(port: int, procs: int, rank: int, shards_per_proc: int,
               device, extra_env: Optional[dict]) -> dict:
    env = dict(os.environ)
    # a hermetic world: the parent's NOMAD_TPU_* knobs must not reshape
    # (or fail) the run; the children see only the pinned set
    for key in [k for k in env if k.startswith("NOMAD_TPU_")]:
        del env[key]
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    # one hash seed for every rank: set orders, and with them the order
    # among equal candidates, agree across the processes
    if not env.get("PYTHONHASHSEED", "").isdigit():
        env["PYTHONHASHSEED"] = "0"
    if device != "cpu":
        # every rank on the same card
        env.setdefault("CUDA_VISIBLE_DEVICES", "0")
    env.update(DRIVE_KNOBS)
    env.update({
        "NOMAD_TPU_DIST": "1",
        "NOMAD_TPU_DIST_COORD": f"127.0.0.1:{port}",
        "NOMAD_TPU_DIST_PROCS": str(procs),
        "NOMAD_TPU_DIST_ID": str(rank),
        SHARDS_PER_RANK_ENV: str(shards_per_proc),
        "NOMAD_TPU_MESH": "1",
        "NOMAD_TPU_BROKER_WATCHDOG": "1",
        "NOMAD_TPU_WATCHDOG_MIN_S": str(RANK_WATCHDOG_MIN_S),
        "NOMAD_TPU_SMOKE_DEVICE": "cpu" if device == "cpu" else "",
    })
    if device == "cpu":
        env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    if extra_env:
        env.update(extra_env)
    return env


def _run_children(children, timeout: float, what: str):
    """Start each (argv, env) child, wait for all within `timeout`, kill
    the rest.  Returns their outputs; raises RuntimeError with the log
    tails when one failed or the time ran out."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    log_dir = tempfile.mkdtemp(prefix=f"{what}_")
    procs: List[subprocess.Popen] = []
    outs = []
    try:
        for i, (argv, env) in enumerate(children):
            out = open(os.path.join(log_dir, f"p{i}.log"), "w+")
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=env, cwd=repo_root, stdout=out,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        rcs: List[Optional[int]] = [None] * len(procs)
        while time.monotonic() < deadline and any(rc is None for rc in rcs):
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if any(rc not in (None, 0) for rc in rcs):
                break  # one failed: the others would wait in a collective
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
    rcs = [p.returncode for p in procs]
    tails = []
    for out in outs:
        out.seek(0)
        tails.append(out.read())
        out.close()
    if any(rc != 0 for rc in rcs):
        detail = "\n".join(f"--- process {i} (rc={rcs[i]}) ---\n{t[-3000:]}"
                           for i, t in enumerate(tails))
        raise RuntimeError(
            f"{what} failed (rcs={rcs}, logs in {log_dir}):\n{detail}")
    return tails


def _row(tail: str, tag: str, what: str) -> dict:
    for line in tail.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise RuntimeError(f"{what} exited clean but printed no {tag} row")


def launch(procs: int = 2, shards_per_proc: int = SHARDS_PER_PROC,
           timeout: float = 420.0, device=None,
           extra_env: Optional[dict] = None) -> dict:
    """Spawn the lockstep world (`procs` ranks of `shards_per_proc`
    shards, on the card unless `device` is "cpu") and return rank 0's
    result row.  A rank's failure or a timeout raises RuntimeError with
    the ranks' log tails: a collective that never returns fails the
    run, it does not hang it."""
    port = _free_port()
    children = [
        (["-m", "nomad_tpu_torch.parallel.dist_smoke", "--worker"],
         _child_env(port, procs, rank, shards_per_proc, device, extra_env))
        for rank in range(procs)]
    tails = _run_children(children, timeout, "dist_smoke")
    return _row(tails[0], "DIST_SMOKE_JSON", "the distributed smoke")


def launch_pod(shards_per_proc: int = SHARDS_PER_PROC,
               timeout: float = 420.0, device=None,
               extra_env: Optional[dict] = None) -> dict:
    """Spawn a pod of two processes: rank 0 a head Server
    (NOMAD_TPU_POD_PORT, NOMAD_TPU_POD_CHECK=1) draining the world's
    chain jobs, rank 1 a peer (``python -m nomad_tpu_torch.parallel.pod``)
    replaying its stream.  Returns the head's row with the peer's under
    ``"peer"``; a failure or a timeout raises with both log tails."""
    port, head_port = _free_port(), _free_port()
    pod_env = {"NOMAD_TPU_POD_PORT": str(head_port),
               "NOMAD_TPU_POD_CHECK": "1"}
    pod_env.update(extra_env or {})
    peer_argv = ["-m", "nomad_tpu_torch.parallel.pod", "--head-port",
                 str(head_port)]
    if device == "cpu":
        peer_argv += ["--device", "cpu"]
    children = [
        (["-m", "nomad_tpu_torch.parallel.dist_smoke", "--pod-head"],
         _child_env(port, 2, 0, shards_per_proc, device, pod_env)),
        (peer_argv, _child_env(port, 2, 1, shards_per_proc, device, pod_env)),
    ]
    tails = _run_children(children, timeout, "pod")
    row = _row(tails[0], "POD_HEAD_JSON", "the pod head")
    row["peer"] = _row(tails[1], "POD_PEER_DONE", "the pod peer")
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="the multi-process node mesh smoke (spawned ranks)")
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--pod-head", action="store_true")
    parser.add_argument("--pod", action="store_true",
                        help="run a pod head and one peer instead")
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--shards-per-proc", type=int, default=SHARDS_PER_PROC)
    parser.add_argument("--timeout", type=float, default=420.0)
    parser.add_argument("--device", default=None,
                        help="cpu for the plain twins (default: the card)")
    args = parser.parse_args(argv)
    if args.worker:
        return run_worker()
    if args.pod_head:
        return run_pod_head()
    if args.pod:
        row = launch_pod(args.shards_per_proc, args.timeout, args.device)
        row.pop("placed")
        row.pop("storm_placed")
        print(json.dumps(row, indent=2))
        return 0
    result = launch(args.procs, args.shards_per_proc, args.timeout,
                    args.device)
    for key in ("chain", "storm"):
        result[key].pop("placed")
    print(json.dumps(result, indent=2))
    print(f"dist_smoke: OK: {result['procs']} processes x "
          f"{result['devices_per_host']} shards on {result['device']}, zero "
          "lost, cross-host parity held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
