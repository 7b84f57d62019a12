"""Benchmark of the port: placements/s on a simulated 10k-node /
100k-alloc cluster (binpack service placements), on the CUDA card.

    python -m nomad_tpu_torch.bench                 # on the card
    python -m nomad_tpu_torch.bench --device cpu    # the plain twins

The port of the JAX package's `bench.py` headline and kernel-only
microbench.  The HEADLINE number is measured through the real pipeline
on both sides: evals enqueued into the eval broker, drained by a
scheduling worker, plans verified and committed by the plan applier,
allocs written to state.  The two sides differ only in the worker:

  * e2e-oracle — the sequential Worker running the host iterator chain
                 (the "stock binpack" baseline);
  * e2e-cuda   — the BatchWorker: simulation pre-pass, chained
                 (evals x nodes x picks) launches of kernel K3 against
                 the device usage mirror kept by K4, prescored replay
                 (serially equivalent, bit-identical plans).

Both servers process the same job stream; the common prefix of the two
placement streams must be identical (the serial-equivalence contract),
and `vs_baseline` is 0.0 when it is not, so a correctness regression can
never read as a gain.  Latency percentiles come from a paced-arrival
phase at 80 % of the measured eval rate, then a sweep at 0.25, 0.5 and
0.75 of it.

The kernel-only numbers time the chained planner (kernel K9,
`chained_plan_picks`) and the independent one (kernel K10,
`batch_plan_picks`) on a nodes-only world, with everything that does
not change between launches on the card before the timed loop and only
the per-eval walk orders made and copied in it.

The ``multichip`` block (`BENCH_MULTICHIP`, on by default) is the
JAX bench's `bench_multichip`: `parallel/multichip.py multichip_sweep`
drives the node-sharded chained planner (kernel K12) chunk by chunk with
its sharded usage carry, and one sharded mirror patch (kernel K13), at
each shard count: on the card through a `DistMesh` over an NCCL group
(one rank: the card count), on the CPU on a `VirtualMesh` of 1, 2, 4
and 8 shards.  Its ``per_device_flops`` and
``flops_scaling_first_to_last`` (XLA's cost analysis) have no source in
the port, and its ``multihost`` row waits for `dist_smoke.py`, which
drives the batch worker's mesh path: both are left out.  A failed sweep
fails the bench.

The main path computes in f64.  Nothing here catches a device failure:
a failed build, launch or a `DeviceFault` ends the run non-zero.

Prints ONE JSON line on stdout, with the JAX bench's keys where the
port has their source; the flight recorder's keys
(`e2e_trace_stage_times_s`, `trace_overhead_pct`, p99 exemplars) wait
for `trace.py`, the explain A/B and the other blocks for their modules
(README).  The kernels' launch counts go to stderr as one line,
``BENCH_LAUNCHES {...}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import random
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import mock
from .structs import (
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Allocation,
    alloc_name,
    compute_node_class,
)

TG_COUNT = 10  # placements per eval
SWEEP_FRACTIONS = (0.25, 0.5, 0.75)  # offered load / measured eval rate
BATCH_ROUNDS = 3
SEED_BASE = 1000
METRIC = "e2e_placements_per_sec_10k_nodes_binpack"


@dataclass(frozen=True)
class Knobs:
    """The bench's sizes, from the JAX bench's BENCH_* variables."""

    nodes: int = 10_000
    allocs: int = 100_000
    e2e_jobs: int = 384
    oracle_jobs: int = 48
    paced_jobs: int = 128
    sweep_jobs: int = 64  # jobs per offered-load point (3 points)
    kernel_nodes: int = 2_000
    kernel_e: int = 64
    multichip: bool = True  # BENCH_MULTICHIP

    @classmethod
    def from_env(cls, env=os.environ) -> "Knobs":
        nodes = int(env.get("BENCH_NODES", 10_000))
        return cls(
            nodes=nodes,
            allocs=int(env.get("BENCH_ALLOCS", 100_000)),
            e2e_jobs=int(env.get("BENCH_E2E_JOBS", 384)),
            oracle_jobs=int(env.get("BENCH_E2E_ORACLE_JOBS", 48)),
            paced_jobs=int(env.get("BENCH_PACED_JOBS", 128)),
            sweep_jobs=int(env.get("BENCH_SWEEP_JOBS", 64)),
            kernel_nodes=int(env.get("BENCH_KERNEL_NODES", min(nodes, 2000))),
            kernel_e=int(env.get("BENCH_KERNEL_E", 64)),
            multichip=env.get("BENCH_MULTICHIP", "1") == "1",
        )


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def populate(store, n_nodes: int, n_allocs: int):
    """Fill a state store with the simulated cluster (the JAX bench's
    recipe: deterministic node ids, `random.Random(7)`)."""
    rng = random.Random(7)
    nodes = []
    t0 = time.time()
    for i in range(n_nodes):
        # deterministic ids so placement streams are comparable across
        # independently populated stores (oracle vs card server)
        n = mock.node(id=f"bench-node-{i:05d}")
        n.node_resources.cpu = rng.choice([8000, 16000, 32000])
        n.node_resources.memory_mb = rng.choice([16384, 32768, 65536])
        nodes.append(n)
    # one computed-class hash per spec bucket, not per node
    class_cache = {}
    for n in nodes:
        key = (n.node_resources.cpu, n.node_resources.memory_mb)
        if key not in class_cache:
            class_cache[key] = compute_node_class(n)
        n.computed_class = class_cache[key]
        store.upsert_node(n)
    log(f"  nodes in {time.time()-t0:.1f}s")

    t0 = time.time()
    filler_job = mock.job(id="filler")
    store.upsert_job(filler_job)
    allocs = []
    for i in range(n_allocs):
        node = nodes[rng.randrange(n_nodes)]
        allocs.append(
            Allocation(
                namespace="default",
                job_id="filler",
                job=filler_job,
                task_group="web",
                name=alloc_name("filler", "web", i),
                node_id=node.id,
                allocated_resources=AllocatedResources(
                    tasks={
                        "web": AllocatedTaskResources(
                            cpu=rng.choice([100, 200, 500]),
                            memory_mb=rng.choice([128, 256, 512]),
                        )
                    },
                    shared=AllocatedSharedResources(disk_mb=100),
                ),
                client_status="running",
            )
        )
    store.upsert_allocs(allocs)
    log(f"  allocs in {time.time()-t0:.1f}s")
    return nodes


def bench_job(i: int, prefix: str = "e2e"):
    job = mock.job(id=f"{prefix}-{i}")
    job.task_groups[0].count = TG_COUNT
    return job


def job_placements(store, job_id: str):
    return sorted(
        (a.name, a.node_id)
        for a in store.allocs_by_job("default", job_id)
        if not a.terminal_status()
    )


# ---------------------------------------------------------------------------
# end-to-end pipeline bench
# ---------------------------------------------------------------------------


def build_server(batch_pipeline: bool, device, knobs: Knobs):
    from .server import Server

    # huge heartbeat TTL: the simulated nodes never heartbeat, and a run
    # longer than the TTL would otherwise mass-expire them mid-stream
    server = Server(
        num_schedulers=1,
        seed=SEED_BASE,
        batch_pipeline=batch_pipeline,
        heartbeat_ttl=1e9,
        device=device,
    )
    log(
        f"building {knobs.nodes} nodes / {knobs.allocs} allocs "
        f"({'batched' if batch_pipeline else 'oracle'} server) ..."
    )
    populate(server.store, knobs.nodes, knobs.allocs)
    server.start()
    return server


def run_stream(server, n_jobs: int, label: str, prefix: str,
               paced_rate: Optional[float] = None):
    """Register n_jobs jobs, wait for the pipeline to drain, and return
    (placements_per_sec, sorted latencies_ms, placements_by_job).  With
    paced_rate (evals/s) the registrations are spaced, so the latencies
    are service latency rather than burst queueing delay.  A stream
    that does not drain raises: its numbers would be meaningless."""
    acks = {}
    submits = {}
    orig_ack = server.broker.ack

    def timed_ack(eval_id, token):
        orig_ack(eval_id, token)
        acks[eval_id] = time.time()

    server.broker.ack = timed_ack
    try:
        t0 = time.time()
        interval = 1.0 / paced_rate if paced_rate else 0.0
        next_t = time.time()
        for i in range(n_jobs):
            if interval:
                now = time.time()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t += interval
            ev = server.register_job(bench_job(i, prefix))
            submits[ev.id] = time.time()
        ok = server.drain_to_idle(timeout=max(120.0, n_jobs * 0.5))
        dt = time.time() - t0
    finally:
        server.broker.ack = orig_ack
    if not ok:
        raise RuntimeError(f"{label} did not drain to idle")
    placements = {}
    n_placed = 0
    for i in range(n_jobs):
        p = job_placements(server.store, f"{prefix}-{i}")
        placements[i] = p
        n_placed += len(p)
    lat = sorted(
        (acks[e] - submits[e]) * 1000.0 for e in acks if e in submits
    )
    rate = n_placed / dt if dt > 0 else 0.0
    log(
        f"{label}: {n_jobs} evals, {n_placed} placements in {dt:.2f}s "
        f"-> {rate:.1f} placements/s"
    )
    return rate, lat, placements


def pct(lat: List[float], q: float) -> float:
    if not lat:
        return 0.0
    return float(lat[min(len(lat) - 1, int(q * (len(lat) - 1)))])


def latency_sweep(server, eval_rate: float, sweep_jobs: int) -> List[Dict]:
    """Offered load against latency: three paced-arrival phases at
    SWEEP_FRACTIONS of the measured eval rate, each with its p50/p99
    service latency.  The port has no flight recorder yet, so no p99
    exemplar (a trace id) can be named: the list is empty."""
    out = []
    for s_i, frac in enumerate(SWEEP_FRACTIONS):
        offered = max(1.0, eval_rate * frac)
        _rate, lat, _p = run_stream(
            server, sweep_jobs,
            f"latency-sweep {frac:.2f}x ({offered:.1f} evals/s)",
            f"sweep{s_i}", paced_rate=offered,
        )
        p50, p99 = pct(lat, 0.50), pct(lat, 0.99)
        log(f"  sweep {frac:.2f}x: offered={offered:.1f}/s "
            f"p50={p50:.1f}ms p99={p99:.1f}ms")
        out.append({
            "offered_fraction": frac,
            "offered_evals_per_sec": round(offered, 2),
            "n_evals": len(lat),
            "p50_ms": round(p50, 1),
            "p99_ms": round(p99, 1),
            "p99_trace_exemplars": [],
        })
    return out


def bench_e2e(knobs: Knobs, device) -> Dict:
    # --- oracle side -----------------------------------------------------
    oracle = build_server(False, device, knobs)
    try:
        oracle_rate, _lat, oracle_p = run_stream(
            oracle, knobs.oracle_jobs, "e2e-oracle", "e2e"
        )
    finally:
        oracle.stop()
    del oracle

    # --- card side -------------------------------------------------------
    server = build_server(True, device, knobs)
    try:
        # warm-up: build the kernels and run the shapes outside the timed
        # region, then stop the warm jobs and drain, so the timed stream
        # starts from state equivalent to the oracle server's
        log("e2e-batched: warm-up ...")
        t0 = time.time()
        worker = server.workers[0]
        worker.warm_shapes()
        run_stream(server, 2, "  warmup", "warm")
        for i in range(2):
            server.deregister_job("default", f"warm-{i}")
        if not server.drain_to_idle(timeout=30):
            raise RuntimeError("the warm-up did not drain to idle")
        log(f"  warmup {time.time()-t0:.1f}s")
        for k in worker.timings:
            worker.timings[k] = 0.0

        rate, _lat, placements = run_stream(
            server, knobs.e2e_jobs, "e2e-batched", "e2e"
        )
        stats = dict(worker.timings)
        total_staged = sum(stats.values()) or 1.0
        log("e2e-batched stage times: " + ", ".join(
            f"{k}={v:.4f}s ({v/total_staged*100:.0f}%)"
            for k, v in stats.items())
            + f"; prescored={worker.prescored} fallbacks={worker.fallbacks}")
        prescore_share = (
            stats.get("assemble", 0.0) + stats.get("launch", 0.0)
            + stats.get("fetch", 0.0)
        ) / total_staged
        replay_share = stats.get("replay", 0.0) / total_staged
        replay_stats = {
            "speculative": worker.replay_speculative,
            "conflicts": worker.replay_conflicts,
            "serial_fallbacks": worker.replay_serial_fallbacks,
        }
        spec_total = worker.replay_speculative + worker.replay_conflicts
        conflict_rate = (
            worker.replay_conflicts / spec_total if spec_total else 0.0
        )

        # parity: the serially equivalent contract means the common
        # prefix of the two streams must be identical
        n_check = min(knobs.oracle_jobs, knobs.e2e_jobs)
        same = sum(
            1 for i in range(n_check) if oracle_p[i] == placements[i]
        )
        log(f"e2e decision check vs oracle: {same}/{n_check} evals "
            f"identical")

        # --- paced phase for service latency ----------------------------
        paced_rate = max(2.0, rate / TG_COUNT * 0.8)
        _r, lat, _p = run_stream(
            server, knobs.paced_jobs,
            f"e2e-batched-paced ({paced_rate:.0f} evals/s offered)",
            "paced", paced_rate=paced_rate,
        )
        p50, p99 = pct(lat, 0.50), pct(lat, 0.99)
        log(f"e2e-batched paced latency: p50={p50:.3f}ms p99={p99:.3f}ms "
            f"({len(lat)} evals)")
        sweep = latency_sweep(server, rate / TG_COUNT, knobs.sweep_jobs)
        errors = worker.errors
    finally:
        server.stop()
    if errors:
        raise RuntimeError(f"the batch worker counted {errors} errors")
    return dict(
        oracle_rate=oracle_rate, rate=rate, p50=p50, p99=p99, same=same,
        n_check=n_check, stage_times=stats, prescore_share=prescore_share,
        replay_share=replay_share, conflict_rate=conflict_rate,
        replay_stats=replay_stats, sweep=sweep, placements=placements,
    )


# ---------------------------------------------------------------------------
# kernel-only secondary numbers
# ---------------------------------------------------------------------------


def kernel_world(n_nodes: int) -> Dict:
    """The kernel-only phase's nodes-only world (`random.Random(7)`,
    no resident allocs) and what every launch shares: the node table's
    columns, the candidate rows, the rest of the arena, the static
    feasibility and the visit limit max(2, ceil(log2 n_cand))."""
    from .sched.util import ready_nodes_in_dcs
    from .state.store import StateStore

    store = StateStore()
    rng = random.Random(7)
    class_cache = {}
    for i in range(n_nodes):
        n = mock.node(id=f"kern-node-{i:05d}")
        n.node_resources.cpu = rng.choice([8000, 16000, 32000])
        n.node_resources.memory_mb = rng.choice([16384, 32768])
        key = (n.node_resources.cpu, n.node_resources.memory_mb)
        if key not in class_cache:
            class_cache[key] = compute_node_class(n)
        n.computed_class = class_cache[key]
        store.upsert_node(n)
    table = store.node_table
    C = table.capacity
    node_list, _ = ready_nodes_in_dcs(
        store.snapshot(), mock.job(id="shape-probe").datacenters
    )
    n_cand = len(node_list)
    base_rows = np.asarray([table.row_of[n.id] for n in node_list],
                           dtype=np.int32)
    present = set(base_rows.tolist())
    rest = np.asarray([r for r in range(C) if r not in present],
                      dtype=np.int32)
    feasible = np.zeros(C, dtype=bool)
    feasible[base_rows] = True
    feasible &= table.eligible & table.active
    return dict(
        table=table, C=C, n_cand=n_cand, base_rows=base_rows, rest=rest,
        feasible=feasible, limit=max(2, math.ceil(math.log2(n_cand))),
    )


def kernel_perms(world: Dict, eval_ids) -> np.ndarray:
    """Walk orders [E, C]: eval i's candidates in the order
    `shuffle_permutation(random.Random(SEED_BASE + i), n_cand)` gives,
    then the rest of the arena."""
    from .sched.feasible import shuffle_permutation

    n_cand = world["n_cand"]
    out = np.empty((len(eval_ids), world["C"]), dtype=np.int32)
    for k, i in enumerate(eval_ids):
        order = shuffle_permutation(random.Random(SEED_BASE + i), n_cand)
        out[k, :n_cand] = world["base_rows"][order]
        out[k, n_cand:] = world["rest"]
    return out


def kernel_inputs(world: Dict, E: int) -> Dict:
    """Everything a kernel-only launch shares, as numpy: the node
    columns and the per-eval BatchInputs fields but `perm` (the JAX
    bench's values: asks 500 MHz / 256 MB / 300 MB, count TG_COUNT, no
    collisions, penalty or affinity, distinct_hosts off, every eval on
    the same snapshot)."""
    t = world["table"]
    C = world["C"]
    return dict(
        cols=(t.cpu_total, t.mem_total, t.disk_total),
        shared=dict(
            feasible=np.broadcast_to(world["feasible"], (E, C)),
            base_cpu_used=np.broadcast_to(t.cpu_used, (E, C)),
            base_mem_used=np.broadcast_to(t.mem_used, (E, C)),
            base_disk_used=np.broadcast_to(t.disk_used, (E, C)),
            base_collisions=np.zeros((E, C), np.int32),
            penalty=np.zeros((E, C), dtype=bool),
            affinity_score=np.zeros((E, C)),
            ask_cpu=np.full(E, 500.0),
            ask_mem=np.full(E, 256.0),
            ask_disk=np.full(E, 300.0),
            desired_count=np.full(E, TG_COUNT, np.int32),
            limit=np.full(E, world["limit"], np.int32),
            distinct_hosts=np.zeros(E, dtype=bool),
        ),
        n_cand=world["n_cand"],
    )


def bench_kernel_only(knobs: Knobs, device) -> Dict[str, float]:
    """Time the warmed `batch_plan_picks` (independent evals, K10) and
    `chained_plan_picks` (the serially equivalent chain, K9) entry
    points: BATCH_ROUNDS launches of kernel_e evals each, every round
    with fresh walk orders made on the host and copied to the card."""
    import torch

    from .ops import batch as tbatch

    world = kernel_world(knobs.kernel_nodes)
    E = knobs.kernel_e
    log(f"kernel-only: {knobs.kernel_nodes}-node world, C={world['C']}, "
        f"{world['n_cand']} candidates, E={E}, limit {world['limit']}")
    inp = kernel_inputs(world, E)
    dtype = torch.float64
    # everything launch-invariant goes to the card once, before the
    # timed loop; only the walk orders vary per round
    cols = [torch.from_numpy(np.ascontiguousarray(c)).to(device, dtype)
            for c in inp["cols"]]
    # checked and prepared once: a round only swaps in its walk orders
    q = tbatch.prepare_batched(
        *cols,
        tbatch.BatchInputs(perm=np.zeros((E, world["C"]), np.int32),
                           **inp["shared"]),
        inp["n_cand"], TG_COUNT,
    )

    def launch(fn, ids):
        perms = torch.from_numpy(kernel_perms(world, ids))
        if device.type == "cuda":
            perms = perms.pin_memory().to(device, non_blocking=True)
        rows = fn(dict(q, batch=q["batch"]._replace(perm=perms)))
        return rows.cpu()

    results = {}
    for name, fn in (("kernel-batch", tbatch.batch_plan_rows),
                     ("kernel-chained", tbatch.chained_plan_rows)):
        launch(fn, list(range(E)))  # build and warm
        t0 = time.time()
        n_placed = 0
        for r in range(BATCH_ROUNDS):
            rows = launch(fn, list(range(r * E, (r + 1) * E)))
            n_placed += int((rows >= 0).sum())
        dt = time.time() - t0
        results[name] = n_placed / dt if dt > 0 else 0.0
        log(f"{name}: {n_placed} placements in {dt:.4f}s -> "
            f"{results[name]:.1f}/s")
    return results


def bench_multichip(device) -> Dict:
    """The ``multichip`` block: the sharded chained pipeline over shard
    counts (`parallel/multichip.py`).  Nothing is caught: a failed
    sweep ends the bench non-zero."""
    from .parallel.multichip import multichip_sweep

    t0 = time.time()
    block = multichip_sweep(device=device)
    for p in block["points"]:
        log(f"multichip d={p['n_devices']} ({block['mesh']}): "
            f"{p['placements_per_sec']} placements/s, "
            f"{p['bytes_per_flush_delta']}B delta vs "
            f"{p['bytes_per_flush_full']}B full per flush")
    log(f"multichip sweep in {time.time() - t0:.1f}s")
    return block


def _preflight(device) -> None:
    """Bounded device check before the world is built: the device
    supervisor's canary (kernel K8), retried until the card answers or
    BENCH_PREFLIGHT_S passes.  It takes no device lock (each process
    has its own CUDA context on a shared card)."""
    total_s = float(os.environ.get("BENCH_PREFLIGHT_S", 600))
    if total_s <= 0:
        return
    from .device.preflight import HEALTHY_STATES, run_preflight

    result = run_preflight(total_s=total_s, log=log, device=device)
    log(f"preflight: {json.dumps(result)}")
    if result["state"] not in HEALTHY_STATES:
        raise RuntimeError(f"preflight: {result['state']}: "
                           f"{result.get('error')}")


def launch_counts() -> Dict[str, int]:
    """Launches in this process of the bench path's kernels, K3 and K4
    (the batched Server), K9 and K10 (the kernel-only phase), K12 (its
    stage launches and its chunks) and K13 (the multichip block), and of
    the two programs no path calls, K9's shared mode and K11."""
    from .ops import batch as tbatch
    from .ops import score as tscore
    from .parallel.mesh import sharded_chained_plan_cuda

    return {
        "chained_picks": tbatch.chained_picks_cuda.launches,
        "patch_rows": tbatch.patch_rows_cuda.launches,
        "chained_plan_picks": tbatch.chained_plan_picks_cuda.launches,
        "batch_plan_picks": tbatch.batch_plan_picks_cuda.launches,
        "chained_plan_picks_shared":
            tbatch.chained_plan_picks_shared_cuda.launches,
        "score_all": tscore.score_all_cuda.launches,
        "sharded_chained_plan": sharded_chained_plan_cuda.launches,
        "sharded_chained_plan_chunks": sharded_chained_plan_cuda.chunks,
        "patch_rows_sharded": tbatch.patch_rows_sharded_cuda.launches,
    }


def run(knobs: Knobs, device) -> Dict:
    """The bench on `device`: the e2e headline with its latency phases,
    then the kernel-only rates.  Returns the JSON line's object."""
    from .device import device_report

    report = (device_report(device) if device.type == "cuda"
              else {"name": "cpu", "count": 0, "nvidia_smi": None})
    _preflight(device)
    e2e = bench_e2e(knobs, device)
    kernel = bench_kernel_only(knobs, device)
    multichip = bench_multichip(device) if knobs.multichip else None
    parity_ok = e2e["same"] == e2e["n_check"]
    if not parity_ok:
        log(f"PARITY FAILURE: {e2e['same']}/{e2e['n_check']} — zeroing "
            f"vs_baseline")
    oracle_rate, rate = e2e["oracle_rate"], e2e["rate"]
    out = {
        "metric": METRIC,
        "value": round(rate, 1),
        "unit": "placements/s",
        "vs_baseline": round(rate / oracle_rate, 2)
        if oracle_rate and parity_ok else 0.0,
        "p99_eval_latency_ms": round(e2e["p99"], 1),
        "p50_eval_latency_ms": round(e2e["p50"], 1),
        "latency_sweep": e2e["sweep"],
        "oracle_e2e_placements_per_sec": round(oracle_rate, 1),
        "parity_identical_evals": e2e["same"],
        "e2e_stage_times_s": {
            k: round(v, 3) for k, v in e2e["stage_times"].items()
        },
        "e2e_prescore_share": round(e2e["prescore_share"], 3),
        "e2e_replay_share": round(e2e["replay_share"], 3),
        "replay_conflict_rate": round(e2e["conflict_rate"], 3),
        "replay_counters": e2e["replay_stats"],
        "kernel_batch_placements_per_sec": round(
            kernel["kernel-batch"], 1),
        "kernel_chained_placements_per_sec": round(
            kernel["kernel-chained"], 1),
        # the jobs of the timed stream that got all TG_COUNT placements
        "e2e_jobs_fully_placed": sum(
            1 for p in e2e["placements"].values() if len(p) == TG_COUNT),
        "device": {"name": report["name"], "nvidia_smi": report["nvidia_smi"],
                   "count": report["count"]},
    }
    if multichip is not None:
        # the sharded hot path: placements/s and host->device bytes per
        # flush (delta vs full) against the shard count
        out["multichip"] = multichip
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.bench",
        description="placements/s of the port on a simulated cluster "
                    "(sizes from the BENCH_* environment variables)",
    )
    parser.add_argument(
        "--device", default=None,
        help="device to run on (default: the CUDA card; 'cpu' runs the "
             "plain twins)",
    )
    args = parser.parse_args(argv)
    from .device import resolve_device

    # resolved first: without a card and without --device cpu this
    # raises NoDeviceError before anything is built
    device = resolve_device(args.device)
    # the broker's opt-in notify watchdog bounds a timed wait that the
    # host's scheduler parks past its timeout
    os.environ.setdefault("NOMAD_TPU_BROKER_WATCHDOG", "1")
    out = run(Knobs.from_env(), device)
    log("BENCH_LAUNCHES " + json.dumps(launch_counts()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
