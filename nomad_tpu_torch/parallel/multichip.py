"""The sweep behind the bench's ``multichip`` block: the port of
`nomad_tpu/parallel/multichip.py`.

For each shard count the sweep builds an (evals = 1, nodes = d) mesh and
drives the sharded chained planner (`sharded_chained_plan(...,
return_carry=True)`, kernel K12 on the card) the way the batch worker's
mesh pipeline does: the eval axis split into chunk-wide launches whose
sharded usage carry threads chunk to chunk on the device.  Per point:

* ``placements_per_sec``: E evals x P picks over the wall clock of the
  chunked chain, best of `rounds` after one warm-up;
* ``bytes_per_flush_delta`` against ``bytes_per_flush_full``: the host
  to device staging bytes of one sharded-mirror delta sync (K13,
  `patch_rows_sharded`: an i32 index buffer and an f64 value buffer
  per used column, O(dirty rows)) against a full six-column upload
  (O(nodes)); one real delta patch runs on the point's mesh.

Where the counts come from, as in the JAX sweep (which runs 1, 2, 4 and
8 on its virtual CPU mesh and the real chip count on hardware): on the
CPU, 1, 2, 4 and 8 shards on a `VirtualMesh`; on the card, the real
card count through a `DistMesh` over an NCCL group of this process's
ranks, one here (the sweep makes a one-rank group when none exists).
NCCL puts no two ranks on one device, so D shards on one card are the
`VirtualMesh`'s; those are not multi-GPU scaling.

Left out: ``per_device_flops`` and ``flops_scaling_first_to_last`` are
XLA's compiled cost analysis, which the port has no source for; the
``multihost`` row spawns `dist_smoke.py`, which drives the batch
worker's mesh path (a later slice).
"""
from __future__ import annotations

import socket
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.batch import PreDeltas, StepDeltas, pow2_bucket


def _chain_inputs(C: int, E: int, P: int, seed: int = 3):
    """Synthetic single-group chained inputs in the sharded runner's
    per-eval scalar layout (the JAX sweep's, same draws)."""
    rng = np.random.default_rng(seed)
    n_cand = C - 8
    K, R = 2, 1
    perms = np.stack(
        [
            np.concatenate([rng.permutation(n_cand), np.arange(n_cand, C)])
            for _ in range(E)
        ]
    ).astype(np.int32)
    feas = np.zeros((E, C), dtype=bool)
    feas[:, :n_cand] = rng.random((E, n_cand)) > 0.1
    cols = (
        np.full(C, 8000.0),
        np.full(C, 16384.0),
        np.full(C, 100_000.0),
        rng.integers(0, 2000, C).astype(np.float64),
        rng.integers(0, 4096, C).astype(np.float64),
        np.zeros(C),
    )
    per_eval = (
        feas,
        perms,
        np.full(E, 500.0),
        np.full(E, 256.0),
        np.full(E, 300.0),
        np.full(E, P, np.int32),  # desired_count
        np.full(E, 9, np.int32),  # limit
        np.full(E, P, np.int32),  # wanted
        np.full(E, n_cand, np.int32),
        np.zeros(E, dtype=bool),  # distinct_hosts
        np.zeros((E, C), np.int32),  # coll0
        np.zeros((E, C)),  # affinity
        StepDeltas(
            evict_rows=np.full((E, P), -1, np.int32),
            evict_cpu=np.zeros((E, P)),
            evict_mem=np.zeros((E, P)),
            evict_disk=np.zeros((E, P)),
            evict_coll=np.zeros((E, P), np.int32),
            penalty_rows=np.full((E, P, K), -1, np.int32),
        ),
        PreDeltas(
            rows=np.zeros((E, R), np.int32),
            cpu=np.zeros((E, R)),
            mem=np.zeros((E, R)),
            disk=np.zeros((E, R)),
        ),
    )
    return cols, per_eval


def _slice_eval(per_eval, a: int, b: int):
    out: List[object] = []
    for x in per_eval:
        if isinstance(x, np.ndarray):
            out.append(x[a:b])
        else:
            out.append(type(x)(*[f[a:b] for f in x]))
    return tuple(out)


def _mirror_sync_bytes(C: int, dirty_rows: int) -> dict:
    """Staging bytes of one sharded-mirror sync: each of the three used
    columns stages its own pow2-padded i32 index buffer plus an f64
    value buffer on the delta path; the full path uploads six C-row f64
    columns (the JAX sweep's closed form)."""
    width = pow2_bucket(max(dirty_rows, 1), floor=8)
    return {
        "dirty_rows": dirty_rows,
        "bytes_per_flush_delta": 3 * (width * 4 + width * 8),
        "bytes_per_flush_full": 6 * C * 8,
    }


def chunked_chain(runner, cols, per_eval, chunk: int) -> tuple:
    """One chain of `_chain_inputs` through `runner` (a `return_carry`
    sharded_chained_plan) in launches of `chunk` evals, the sharded
    usage carry threaded launch to launch: (rows [E, P], pulls [E, P],
    the (cpu, mem, disk) carry as `Sharded`), on the mesh's device,
    unsynchronised."""
    E = per_eval[0].shape[0]
    carry = cols[3:6]
    rows, pulls = [], []
    for a in range(0, E, chunk):
        r, p, carry = runner(*cols[:3], *carry, *_slice_eval(per_eval, a, a + chunk))
        rows.append(r)
        pulls.append(p)
    return torch.cat(rows), torch.cat(pulls), carry


def delta_patch_inputs(C: int, dirty_rows: int, device) -> tuple:
    """The (idx, vals) of the sweep's one sharded delta patch: the first
    `dirty_rows` rows set to 0.0, the index buffer pow2-padded with the
    dropped row C."""
    width = pow2_bucket(dirty_rows, floor=8)
    idx = np.full(width, C, np.int32)
    idx[:dirty_rows] = np.arange(dirty_rows, dtype=np.int32)
    return (torch.from_numpy(idx).to(device),
            torch.zeros(width, dtype=torch.float64, device=device))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_group(device: torch.device) -> bool:
    """Make this process a one-rank NCCL group on `device` unless a
    `torch.distributed` group exists.  Returns True when it made one
    (the caller destroys it).  A failed init raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}",
        world_size=1, rank=0)
    return True


# the sweep's shape: arena rows, evals, picks, evals per launch, dirty
# rows of the mirror patch (the JAX sweep's defaults)
SWEEP_C, SWEEP_E, SWEEP_P, SWEEP_CHUNK, SWEEP_DIRTY = 1024, 16, 4, 8, 24


def multichip_sweep(
    device_counts: Optional[Sequence[int]] = None,
    C: int = SWEEP_C,
    E: int = SWEEP_E,
    P: int = SWEEP_P,
    chunk: int = SWEEP_CHUNK,
    dirty_rows: int = SWEEP_DIRTY,
    rounds: int = 3,
    device=None,
) -> dict:
    """Sweep the sharded chained pipeline over shard counts; returns the
    bench's ``multichip`` block.  `device` None is the card (a DistMesh
    over the NCCL group's ranks), "cpu" the VirtualMesh sweep."""
    import torch.distributed as dist

    from ..device import resolve_device
    from ..ops.batch import patch_rows_sharded
    from .mesh import VirtualMesh, make_mesh, sharded_chained_plan

    dev = resolve_device(device)
    made_group = dev.type == "cuda" and nccl_group(dev)
    try:
        if dev.type == "cuda":
            if device_counts is None:
                device_counts = [dist.get_world_size()]
            meshes = {int(d): make_mesh(int(d), eval_axis=1)
                      for d in device_counts}
            kind = f"DistMesh ({dist.get_backend()})"
        else:
            if device_counts is None:
                device_counts = [1, 2, 4, 8]
            meshes = {int(d): VirtualMesh(int(d), dev) for d in device_counts}
            kind = "VirtualMesh"
        points = []
        for d, mesh in meshes.items():
            runner = sharded_chained_plan(mesh, P, return_carry=True)
            cols, per_eval = _chain_inputs(C, E, P)

            def run_chain():
                out = chunked_chain(runner, cols, per_eval, chunk)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                return out

            run_chain()  # warm: the kernels' build, the caching allocator
            best = float("inf")
            for _ in range(rounds):
                t0 = time.perf_counter()
                run_chain()
                best = min(best, time.perf_counter() - t0)
            # one real sharded delta patch, to prove the path runs on
            # this mesh (the byte accounting itself is closed-form)
            patch_rows_sharded(mesh, mesh.shard(cols[3]),
                               *delta_patch_inputs(C, dirty_rows, dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            point = {
                "n_devices": int(d),
                "placements_per_sec": round((E * P) / best, 1),
                "chunk_width": chunk,
                "chunk_launches": -(-E // chunk),
            }
            point.update(_mirror_sync_bytes(C, dirty_rows))
            points.append(point)
    finally:
        if made_group:
            dist.destroy_process_group()
    return {
        "arena_nodes": C,
        "evals": E,
        "picks": P,
        "mesh": kind,
        "points": points,
    }
