#!/usr/bin/env python3
"""End-to-end smoke of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Report the card (`torch.cuda.get_device_name`, nvidia-smi's
   name and power limit) and build the kernels of `nomad_tpu_torch/csrc`
   from source (one nvcc per file, in parallel).
2. Kernel K1 (one select, csrc/score_select.cu) against its plain twin,
   at a 16,384-row arena with 10,000 candidates, over the edge cases of
   `nomad_tpu_torch/ops/cases.py`, in f64 and f32: every output and
   every node's score must be bit-equal on the card and on the CPU.
   Also counts how often the card's f32-rounded 10^x differs from the
   CPU's on 10^6 seeded inputs.
3. Kernel K2 (the look-ahead pick scan, csrc/plan_picks.cu) against its
   twin, the same rule, for P in {1, 16, 128}.
4. The main path: a 10,000-node / 100,000-alloc cluster (the bench's
   seeded recipe) and a stream of 89 service jobs through the port's
   Harness + ServiceScheduler on the card.  The same stream, in fresh
   stores, goes through the port on the CPU (the twins) and through the
   port's host oracle; the three placement streams must be identical,
   and both kernels must have been launched by the card run.
5. Times each kernel and its twin on the card with CUDA events at the
   main path's shapes (>= 1,000 launches after warm-up).

Prints the kernels line, then the card's nvidia-smi line, then the
result line: {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, it prints no result and exits 2.
"""
from __future__ import annotations

import json
import random
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

N_NODES = 10_000
N_ALLOCS = 100_000
C_CHECK = 16_384
N_CAND_CHECK = 10_000
TIMING_LAUNCHES = 1_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM outside the tensor cores (f64 is slower)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# phase 2/3: kernels against their twins
# ---------------------------------------------------------------------------


def _bits(t):
    import numpy as np

    a = t.detach().cpu().numpy()
    if a.dtype == np.float64:
        return a.view(np.int64)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _max_abs(a, b) -> float:
    return float(
        (a.detach().cpu().double() - b.detach().cpu().double()).abs().max()
    )


def check_k1(cuda) -> dict:
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import INT32_MAX, SCORE_SCENARIOS, score_case
    from nomad_tpu_torch.state.convert import score_inputs_from_numpy

    n_cases = 0
    max_err = 0.0
    for dtype in (torch.float64, torch.float32):
        for si, scenario in enumerate(sorted(SCORE_SCENARIOS)):
            for limit in (2, 14, INT32_MAX):
                for spread_fit in (False, True):
                    case = score_case(
                        5000 + si, C_CHECK, N_CAND_CHECK, scenario, limit
                    )
                    card = score_inputs_from_numpy(case, cuda, dtype=dtype)
                    cpu = score_inputs_from_numpy(case, "cpu", dtype=dtype)
                    out = tscore.score_select_cuda(card, spread_fit)
                    torch.cuda.synchronize()
                    kern = (out.out_i[0], out.best[0], out.out_i[2],
                            out.out_i[1])
                    twin_card = tscore.score_and_select_twin(card, spread_fit)
                    twin_cpu = tscore.score_and_select_twin(cpu, spread_fit)
                    _, scores_cpu = tscore.score_vectors(cpu, spread_fit)
                    scores_cpu = scores_cpu[cpu.perm.long()]
                    tag = f"K1 {dtype} {scenario} limit={limit} spread_fit={spread_fit}"
                    for k, tc, tp in zip(kern, twin_card, twin_cpu):
                        check(bool((_bits(k) == _bits(tc)).all()),
                              f"{tag}: kernel != twin on card")
                        check(bool((_bits(k) == _bits(tp)).all()),
                              f"{tag}: kernel != twin on CPU")
                        max_err = max(max_err, _max_abs(k, tc))
                    check(bool((_bits(out.scores_walk) == _bits(scores_cpu)).all()),
                          f"{tag}: per-node scores differ from the CPU twin")
                    max_err = max(max_err, _max_abs(out.scores_walk, scores_cpu))
                    n_cases += 1
    # the card's f32-rounded 10^x against the CPU's
    x = torch.from_numpy(np.random.default_rng(17).uniform(-1.0, 1.0, 1_000_000))
    p_cpu = tscore._pow10(x, torch.float64)
    p_card = tscore._pow10(x.to(cuda), torch.float64).cpu()
    pow_mismatch = int((p_cpu != p_card).sum())
    print(f"K1: {n_cases} cases exact on card and CPU (f64 and f32), "
          f"max_abs_err={max_err}; torch.pow f32-rounded 10^x card vs CPU "
          f"mismatches: {pow_mismatch} of 1000000", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases,
            "pow_mismatch": pow_mismatch}


def check_k2(cuda) -> dict:
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import BATCH_SCENARIOS, INT32_MAX, batch_case
    from nomad_tpu_torch.state.convert import batch_inputs_from_numpy

    n_cases = 0
    max_err = 0.0
    for dtype in (torch.float64, torch.float32):
        for si, scenario in enumerate(sorted(BATCH_SCENARIOS)):
            for n_picks in (1, 16, 128):
                for limit in (2, INT32_MAX):
                    cols, inp = batch_case(
                        6000 + 10 * si + n_picks, C_CHECK, N_CAND_CHECK,
                        scenario, limit, n_picks,
                    )

                    def run(dev, fn):
                        t = {k: torch.from_numpy(v).to(dev, dtype)
                             for k, v in cols.items()}
                        return fn(
                            t["cpu_total"], t["mem_total"], t["disk_total"],
                            batch_inputs_from_numpy(inp, dev, dtype=dtype),
                            N_CAND_CHECK, n_picks, False,
                        )

                    kern = run(cuda, tbatch.plan_picks_cuda).cpu()
                    twin_card = torch.stack(run(cuda, tbatch.run_picks)).cpu()
                    twin_cpu = torch.stack(run("cpu", tbatch.run_picks))
                    tag = f"K2 {dtype} {scenario} P={n_picks} limit={limit}"
                    check(torch.equal(kern, twin_card), f"{tag}: kernel != twin on card")
                    check(torch.equal(kern, twin_cpu), f"{tag}: kernel != twin on CPU")
                    max_err = max(max_err, _max_abs(kern, twin_card))
                    n_cases += 1
    print(f"K2: {n_cases} cases exact on card and CPU (f64 and f32), "
          f"max_abs_err={max_err}", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def build_world(store, n_nodes: int = N_NODES, n_allocs: int = N_ALLOCS):
    """bench.py's seeded cluster (nodes with deterministic ids, 8/16/32
    cores and 16/32/64 GiB, then filler allocs of 100-500 MHz and
    128-512 MiB on random nodes), plus a datacenter (dc1-dc3) and a
    rack attribute drawn from a second seeded stream, so that spread and
    affinity stanzas have values to act on."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import (
        AllocatedResources,
        AllocatedSharedResources,
        AllocatedTaskResources,
        Allocation,
        alloc_name,
        compute_node_class,
    )

    rng = random.Random(7)
    topo = random.Random(11)
    nodes = []
    for i in range(n_nodes):
        n = mock.node(id=f"bench-node-{i:05d}")
        n.node_resources.cpu = rng.choice([8000, 16000, 32000])
        n.node_resources.memory_mb = rng.choice([16384, 32768, 65536])
        n.datacenter = topo.choice(["dc1", "dc2", "dc3"])
        n.attributes["rack"] = f"r{topo.randrange(10)}"
        nodes.append(n)
    class_cache = {}
    for n in nodes:
        key = (n.node_resources.cpu, n.node_resources.memory_mb,
               n.datacenter)
        if key not in class_cache:
            class_cache[key] = compute_node_class(n)
        n.computed_class = class_cache[key]
        store.upsert_node(n)
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


DCS = ["dc1", "dc2", "dc3"]


def job_stream():
    """(kind, job factory, seed) in submission order: 64 count-10
    service jobs (K2), 16 count-1 jobs (K1), 4 with a node affinity
    (unlimited walk), 4 with a spread stanza (per-pick K1) and one
    whose count cannot fit (a blocked eval)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Affinity, Spread, SpreadTarget

    def plain(i, count):
        def make():
            j = mock.job(id=f"smoke-{count}-{i:03d}", datacenters=DCS)
            j.task_groups[0].count = count
            return j
        return make

    def affinity(i):
        def make():
            j = mock.job(id=f"smoke-aff-{i}", datacenters=DCS)
            j.affinities = [Affinity("${attr.rack}", f"r{i}", "=", 50)]
            return j
        return make

    def spread(i):
        def make():
            j = mock.job(id=f"smoke-spread-{i}", datacenters=DCS)
            j.spreads = [
                Spread(
                    attribute="${node.datacenter}", weight=50,
                    targets=(SpreadTarget("dc1", 50), SpreadTarget("dc2", 30),
                             SpreadTarget("dc3", 20)),
                )
            ]
            return j
        return make

    def too_big():
        j = mock.job(id="smoke-too-big", datacenters=DCS)
        j.task_groups[0].count = 5
        j.task_groups[0].tasks[0].resources.cpu = 64000
        return j

    stream = [("count10", plain(i, 10)) for i in range(64)]
    stream += [("count1", plain(i, 1)) for i in range(16)]
    stream += [("affinity", affinity(i)) for i in range(4)]
    stream += [("spread", spread(i)) for i in range(4)]
    stream += [("blocked", too_big)]
    return [(kind, make, 100 + k) for k, (kind, make) in enumerate(stream)]


def run_stream(mode: str, n_nodes: int = N_NODES, n_allocs: int = N_ALLOCS,
               on_ready=None):
    """Build a fresh world and run the job stream through the port.
    mode: "cuda" (the kernels), "cpu" (the twins) or "oracle" (the host
    iterator chain).  Returns (placement stream, per-eval seconds,
    placements)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.sched.generic_sched import ServiceScheduler
    from nomad_tpu_torch.sched.testing import Harness

    h = Harness()
    t0 = time.perf_counter()
    build_world(h.store, n_nodes, n_allocs)
    log(f"  [{mode}] world built in {time.perf_counter() - t0:.1f}s")
    kwargs = {"use_device": False} if mode == "oracle" else {"device": mode}
    if on_ready is not None:
        on_ready()
    stream, seconds, placed = [], [], 0
    for kind, make, seed in job_stream():
        job = make()
        h.store.upsert_job(job)
        ev = mock.evaluation(job_id=job.id, id=f"eval-{job.id}")
        n_plans = len(h.plans)
        n_blocked = len(h.create_evals)
        t = time.perf_counter()
        h.process(ServiceScheduler, ev, seed=seed, **kwargs)
        if mode == "cuda":
            import torch

            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        allocs = sorted(
            (a.name, a.node_id)
            for p in h.plans[n_plans:]
            for v in p.node_allocation.values()
            for a in v
        )
        placed += len(allocs)
        stream.append((job.id, kind, allocs, len(h.create_evals) - n_blocked))
    log(f"  [{mode}] {len(stream)} evals in {sum(seconds):.1f}s")
    return stream, seconds, placed


def check_main_path(cuda, card: str) -> dict:
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import score as tscore

    def reset_counts():
        tscore.score_select_cuda.launches = 0
        tbatch.plan_picks_cuda.launches = 0

    # counts are zeroed after the world is built, just before the stream
    cuda_stream, seconds, placed = run_stream("cuda", on_ready=reset_counts)
    launches = {
        "score_select": tscore.score_select_cuda.launches,
        "plan_picks": tbatch.plan_picks_cuda.launches,
    }
    print(f"main path (cuda): launches {launches}", flush=True)
    check(launches["score_select"] > 0, "K1 was not launched on the main path")
    check(launches["plan_picks"] > 0, "K2 was not launched on the main path")
    cpu_stream, _, _ = run_stream("cpu")
    oracle_stream, _, _ = run_stream("oracle")
    for name, other in (("cpu twins", cpu_stream), ("host oracle", oracle_stream)):
        for a, b in zip(cuda_stream, other):
            check(a == b, f"placement stream diverged from the {name} at {a[0]}: {a} vs {b}")
        check(len(cuda_stream) == len(other), f"stream length differs from the {name}")
    blocked = sum(s[3] for s in cuda_stream)
    check(blocked >= 1, "the unplaceable job created no blocked eval")
    by_kind = {}
    for (job_id, kind, allocs, _b), dt in zip(cuda_stream, seconds):
        by_kind.setdefault(kind, []).append(len(allocs))
    check(all(n == 10 for n in by_kind["count10"]), "a count-10 job was not fully placed")
    check(all(n == 1 for n in by_kind["count1"]), "a count-1 job was not placed")
    check(by_kind["blocked"] == [0], "the unplaceable job placed something")
    total_s = sum(seconds)
    srt = sorted(seconds)
    p50 = statistics.median(srt)
    p99 = srt[min(len(srt) - 1, int(round(0.99 * (len(srt) - 1))))]
    rate = placed / total_s
    print(
        f"main path on {card}: {len(cuda_stream)} evals, {placed} placements, "
        f"{rate:.1f} placements/s, eval latency p50 {p50 * 1e3:.2f} ms "
        f"p99 {p99 * 1e3:.2f} ms (host clock, each eval ends in a device "
        f"sync); identical to the CPU twins and the host oracle",
        flush=True,
    )
    return {"launches": launches, "placements_per_s": rate,
            "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3, "placed": placed}


# ---------------------------------------------------------------------------
# phase 5: timings at the main path's shapes
# ---------------------------------------------------------------------------


def cuda_time_ms(fn, n: int = TIMING_LAUNCHES, warmup: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_kernels(cuda) -> dict:
    """K1 at the count-1 select's shape (16,384-row arena, 10,000
    candidates, limit 14 = ceil(log2 10,000)); K2 at the count-10
    look-ahead's (the same arena, P = pow2_bucket(10) = 16)."""
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import batch_case, score_case
    from nomad_tpu_torch.state.convert import (
        batch_inputs_from_numpy,
        score_inputs_from_numpy,
    )

    saved = (tscore.score_select_cuda.launches, tbatch.plan_picks_cuda.launches)
    k1 = score_inputs_from_numpy(
        score_case(7000, C_CHECK, N_CAND_CHECK, "mixed", 14), cuda
    )
    cols, inp = batch_case(7001, C_CHECK, N_CAND_CHECK, "plain", 14, 16)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in cols.items()}
    k2 = (t["cpu_total"], t["mem_total"], t["disk_total"],
          batch_inputs_from_numpy(inp, cuda), N_CAND_CHECK, 16, False)
    out = {
        "score_select": {
            "ms": cuda_time_ms(lambda: tscore.score_select_cuda(k1)),
            "plain_ms": cuda_time_ms(lambda: tscore.score_and_select_twin(k1)),
            # every input column read once (all C walk positions) and
            # 16 bytes written
            "bytes": C_CHECK * (8 * 8 + 2 * 1 + 2 * 4) + 16,
            # ~40 flops a node plus two pows (~40 each), f64
            "flops": C_CHECK * 120,
        },
        "plan_picks": {
            "ms": cuda_time_ms(lambda: tbatch.plan_picks_cuda(*k2)),
            "plain_ms": cuda_time_ms(
                lambda: tbatch.run_picks(*k2), n=TIMING_LAUNCHES, warmup=3
            ),
            # the candidate rows of every column read once (the tail is
            # never walked) and the [2, P] result written
            "bytes": N_CAND_CHECK * (7 * 8 + 2 * 1 + 2 * 4) + 2 * 16 * 4,
            "flops": 16 * N_CAND_CHECK * 120,
        },
    }
    tscore.score_select_cuda.launches, tbatch.plan_picks_cuda.launches = saved
    for v in out.values():
        t_bytes = v["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = v["flops"] / F32_FLOPS * 1e3
        v["bound_ms"] = max(t_bytes, t_ops)
        v["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not (HERE / "nomad_tpu_torch" / "csrc").is_dir():
        log("chip_smoke.py must run from a checkout of the repository "
            "(nomad_tpu_torch/ not found beside it)")
        return 2
    try:
        import torch
    except ImportError:
        log("PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    sys.path.insert(0, str(HERE))
    from nomad_tpu_torch.device import device_report, resolve_device
    from nomad_tpu_torch.ops import _cuda

    t_start = time.perf_counter()
    cuda = resolve_device(None)
    rep = device_report(cuda)
    smi = rep["nvidia_smi"] or "nvidia-smi unavailable"
    card = f"{rep['name']} ({smi})"
    print(f"device: {rep['name']}, count {rep['count']}, nvidia-smi: {smi}",
          flush=True)
    t0 = time.perf_counter()
    built = _cuda.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s (parallel nvcc): "
          + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in built.items()),
          flush=True)
    for k, v in built.items():
        for line in v["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k}: {line.strip()}")

    failures = []
    results = {}
    for name, fn in (("k1", lambda: check_k1(cuda)),
                     ("k2", lambda: check_k2(cuda)),
                     ("main", lambda: check_main_path(cuda, card)),
                     ("timing", lambda: time_kernels(cuda))):
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except SmokeFailure as e:
            failures.append(f"{name}: {e}")
            print(f"FAILED {name}: {e}", flush=True)
        log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
    if failures:
        print(f"chip_smoke failed: {failures}", flush=True)
        return 1

    launches = results["main"]["launches"]
    kernels = []
    for name, source, replaces, check_key in (
        ("score_select", "nomad_tpu_torch/csrc/score_select.cu",
         "nomad_tpu/ops/score.py:268", "k1"),
        ("plan_picks", "nomad_tpu_torch/csrc/plan_picks.cu",
         "nomad_tpu/ops/batch.py:766", "k2"),
    ):
        tm = results["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": results[check_key]["max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None,
        })
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
