"""The port's entry points, the counterpart of the JAX package's
`__graft_entry__.py`.

`entry(device=None)` returns the flagship step, one select through
`ops.score.score_and_select` (kernel K1 on the card), with example
arena-shaped inputs.

`dryrun_multichip(n, device=None)` builds the (evals, nodes) mesh that
the JAX `make_mesh(n)` builds, as a `VirtualMesh` on one device, and
runs on it: one node-sharded select (`sharded_score_and_select`: K11 a
shard, the all-gather, K6), one batched plan with the evals sharded over
the eval axis (`sharded_batch_plan`: the node-axis all-gathers, K10 an
eval row), and a batched `Server` whose worker shards its chained
prescore launches over a `VirtualMesh` of n node shards (K12 chunks over
the sharded usage mirror, K13 delta flushes).  It returns what it
computed, so that a run on the card and one on the CPU can be compared.

Both run on the card unless `device` names another; without a card they
raise `NoDeviceError`.  Command line (both, on the card unless
``--device cpu``)::

    python -m nomad_tpu_torch.entry [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .device import resolve_device


def _example_inputs(C: int = 1024, n_active: int = 1000, seed: int = 0,
                    device="cpu"):
    """The example select's `ScoreInputs` (f32 columns), from the same
    numpy draws, in the same order, as the JAX entry module's."""
    from .ops.score import ScoreInputs

    rng = np.random.default_rng(seed)
    cpu_total = np.zeros(C, np.float32)
    mem_total = np.zeros(C, np.float32)
    disk_total = np.zeros(C, np.float32)
    cpu_total[:n_active] = rng.choice([2000, 4000, 8000], n_active)
    mem_total[:n_active] = rng.choice([4096, 8192, 16384], n_active)
    disk_total[:n_active] = 100_000.0
    cpu_used = np.zeros(C, np.float32)
    mem_used = np.zeros(C, np.float32)
    cpu_used[:n_active] = rng.integers(0, 1500, n_active)
    mem_used[:n_active] = rng.integers(0, 2048, n_active)
    feasible = np.zeros(C, dtype=bool)
    feasible[:n_active] = True
    perm = np.concatenate(
        [rng.permutation(n_active), np.arange(n_active, C)]
    ).astype(np.int32)
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return ScoreInputs(
        cpu_total=t(cpu_total),
        mem_total=t(mem_total),
        disk_total=t(disk_total),
        cpu_used=t(cpu_used),
        mem_used=t(mem_used),
        disk_used=t(np.zeros(C, np.float32)),
        feasible=t(feasible),
        collisions=t(np.zeros(C, np.int32)),
        penalty=t(np.zeros(C, dtype=bool)),
        affinity_score=t(np.zeros(C, np.float32)),
        spread_boost=t(np.zeros(C, np.float32)),
        perm=t(perm),
        ask_cpu=500.0,
        ask_mem=256.0,
        ask_disk=300.0,
        desired_count=10,
        limit=10,
        n_candidates=n_active,
    )


def _example_batch(C: int, n_active: int, E: int, P: int):
    """The dryrun's batch of E evals (numpy `BatchInputs` fields with a
    leading E) and its node columns, from rng(2) as the JAX dryrun draws
    them."""
    from .ops.batch import BatchInputs

    rng = np.random.default_rng(2)

    def one_eval():
        feas = np.zeros(C, dtype=bool)
        feas[:n_active] = True
        used = np.zeros(C, np.float32)
        used[:n_active] = rng.integers(0, 1000, n_active)
        perm = np.concatenate(
            [rng.permutation(n_active), np.arange(n_active, C)]
        ).astype(np.int32)
        return BatchInputs(
            feasible=feas,
            base_cpu_used=used,
            base_mem_used=used.copy(),
            base_disk_used=np.zeros(C, np.float32),
            base_collisions=np.zeros(C, np.int32),
            penalty=np.zeros(C, dtype=bool),
            affinity_score=np.zeros(C, np.float32),
            perm=perm,
            ask_cpu=np.float32(500.0),
            ask_mem=np.float32(256.0),
            ask_disk=np.float32(300.0),
            desired_count=np.int32(P),
            limit=np.int32(9),
            distinct_hosts=np.bool_(False),
        )

    evals = [one_eval() for _ in range(E)]
    batch = BatchInputs(*[np.stack([getattr(e, f) for e in evals])
                          for f in BatchInputs._fields])
    cols = (np.full(C, 4000.0, np.float32), np.full(C, 8192.0, np.float32),
            np.full(C, 100_000.0, np.float32))
    return cols, batch


def entry(device=None):
    """(fn, example_args): the single-device step, one select (K1 on the
    card, its twin on the CPU), and its example inputs on `device`."""
    from .ops.score import score_and_select

    dev = resolve_device(device)

    def step(inp):
        return score_and_select(inp, spread_fit=False)

    return step, (_example_inputs(device=dev),)


DRYRUN_NODES = 12


def _check(cond: bool, what) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One batched multi-shard scheduling step on tiny shapes, on an
    (evals, nodes) `VirtualMesh` of `n_devices` shards on `device`: the
    node axis sharded, the eval axis data-parallel.  Returns ``{"axes":
    (evals, nodes), "select": (row, best, feasible_count, pulls),
    "rows": i32[E, P], "placements": {alloc name: node name},
    "worker": {...}}``, tensors on the CPU."""
    from . import mock
    from .parallel.mesh import (
        VirtualMesh,
        mesh_axes,
        sharded_batch_plan,
        sharded_score_and_select,
    )
    from .server import Server
    from .structs import Spread

    dev = resolve_device(device)
    eval_axis, node_axis = mesh_axes(n_devices)
    mesh = VirtualMesh(node_axis, dev, n_evals=eval_axis)

    # shapes divisible by the node axis
    C = 64 * node_axis
    n_active = C - 8
    E = 2 * eval_axis
    P_ = 3

    # single-placement: node-sharded scoring + replicated walk
    single = sharded_score_and_select(mesh)
    inp = _example_inputs(C=C, n_active=n_active, seed=1, device=dev)
    select = tuple(x.cpu() for x in single(inp))
    row, _score, feasible_count, _pulls = select
    _check(int(feasible_count) > 0 and int(row) >= 0, f"select {select}")

    # batched planner: E evals x P picks, evals sharded over the mesh
    cols, batch = _example_batch(C, n_active, E, P_)
    run = sharded_batch_plan(mesh, n_candidates=n_active, n_picks=P_)
    rows = run(*cols, batch).cpu()
    _check(tuple(rows.shape) == (E, P_) and bool((rows >= 0).all()),
           f"rows {rows.tolist()}")

    # the production worker path on the mesh: a real Server whose
    # BatchWorker shards its chained prescore launches over the node
    # axis, job stream -> broker -> sharded kernel -> prescored replay
    # -> plan applier -> committed allocs.  Fixed node names make runs
    # comparable; the nodes never heartbeat, so none may expire.
    server = Server(num_schedulers=1, seed=7, batch_pipeline=True,
                    heartbeat_ttl=1e9, device=dev,
                    mesh=VirtualMesh(n_devices, dev))
    placements = {}
    try:
        worker = server.workers[0]
        _check(worker._mesh is not None, "the worker has no mesh")
        server.start()
        for i in range(DRYRUN_NODES):
            name = f"dryrun-node-{i:02d}"
            server.register_node(mock.node(id=name, name=name))
        job = mock.job(id="dryrun-job")
        job.task_groups[0].count = 4
        server.register_job(job)
        _check(server.drain_to_idle(60), "the job did not drain")
        placed = _placed(server, "dryrun-job")
        _check(len(placed) == 4, f"placed {len(placed)}")
        _check(worker.prescored >= 1, (
            worker.prescored, worker.fallbacks, worker.errors))
        # a spread stream: the even-mode spread job routes through the
        # mesh too
        sjob = mock.job(id="dryrun-spread")
        sjob.task_groups[0].count = 4
        sjob.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
        mesh_used0 = worker.mesh_used
        server.register_job(sjob)
        _check(server.drain_to_idle(60), "the spread job did not drain")
        splaced = _placed(server, "dryrun-spread")
        _check(len(splaced) == 4, f"spread placed {len(splaced)}")
        _check(worker.mesh_used > mesh_used0, (
            "the spread stream did not run on the mesh",
            worker.mesh_used, mesh_used0))
        nodes = {n.id: n.name for n in server.store.nodes.values()}
        for a in placed + splaced:
            placements[a.name] = nodes[a.node_id]
        stats = {k: getattr(worker, k) for k in (
            "prescored", "fallbacks", "errors", "mesh_used")}
    finally:
        server.stop()
    return {"axes": (eval_axis, node_axis), "select": select, "rows": rows,
            "placements": placements, "worker": stats}


def _placed(server, job_id: str) -> list:
    return [a for a in server.store.allocs_by_job("default", job_id)
            if not a.terminal_status()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The port's entry step and its 8-shard dryrun.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry ok:", [tuple(o.shape) for o in out])
    dry = dryrun_multichip(8, args.device)
    print(f"dryrun_multichip(8) ok: axes {dry['axes']}, select "
          f"{[x.item() for x in dry['select']]}, rows {dry['rows'].tolist()}, "
          f"{len(dry['placements'])} placements, worker {dry['worker']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
