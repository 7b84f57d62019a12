#!/usr/bin/env python3
"""End-to-end smoke of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Report the card (`torch.cuda.get_device_name`, nvidia-smi's
   name and power limit) and build the kernels of `nomad_tpu_torch/csrc`
   from source (one nvcc per file, in parallel).
2. Kernel K1 (one select, csrc/score_select.cu) against its plain twin,
   at a 16,384-row arena with 10,000 candidates, over the edge cases of
   `nomad_tpu_torch/ops/cases.py` and its policy cases (throughput,
   migration, both, inert; limit 14 and unlimited), in f64 and f32:
   every output, and the feasibility and score of every position the
   kernel walked (every node's score is held through K11), must be
   bit-equal on the card and on the CPU.  Then `SELECT_EDGES`, each on
   the launch shape K1's rule takes: to the grid whole regions, a few
   candidates at the front of the arena, two diverted nodes, all bad, a
   limit equal to the candidates (all good); to the prefix walk a
   limited walk over few feasible nodes, a few candidates, all bad, two
   diverted nodes behind fewer good ones than the limit, a limit one
   below the candidates.
   Also counts how often the card's f32-rounded 10^x differs from the
   CPU's on 10^6 seeded inputs.
3. Kernel K2 (the look-ahead pick scan, csrc/plan_picks.cu) against its
   twin, the same rule, for P in {1, 16, 128}.
4. The per-eval path: a 10,000-node / 100,000-alloc cluster (the
   bench's seeded recipe) and a stream of 89 service jobs through the
   port's Harness + ServiceScheduler on the card.  The same stream, in
   fresh stores, goes through the port on the CPU (the twins), and its
   first 32 evals through the port's host oracle; the placement streams
   and the AllocMetrics of the explain capture must be identical, and K1
   and K2 must have been launched by the card run.  The card run is
   repeated with the capture off (NOMAD_TPU_EXPLAIN=0) for its cost.
5. Times each kernel and its twin on the card with CUDA events at the
   main path's shapes (>= 1,000 launches after warm-up; K5 50, K7 200,
   K9 and K10 50; K15 at the multihost flush's shape), K1 also with
   policy terms and an unlimited walk and K5
   also on the weighted dogpile; K9, K9 shared and K10 at the bench's
   kernel-only shape (a 2,048-row arena, 2,000 candidates, E = 64,
   P = 10), K9 and K10 also at the 16,384-row arena, K11 at K1's shape
   with and without policy terms, K12 per chunk (E = 8, P = 10) at D = 1
   and 8 shards on the one card, K13 at W = 1,024, K14 on the storm
   phase's own problem at D = 1 and 8, the entry phase's two programs on
   its 2 x 4 mesh (the select also at 1 x 1 and 1 x 8); for K4, K13 and
   K15 also the nearest single PyTorch call (`index_copy_`).  K4, K8,
   K13 and K15 are timed as their paths launch them (bound once), beside
   the checked per-call entry point and the library call; the mirrors'
   three-column flush and the canary's probe also on the host clock,
   from staging to synchronize.  This phase runs last.
6. Kernel K3 (the chained E x P planner, csrc/chained_picks.cu) against
   its twin over every chained scenario of `ops/cases.py`, at a
   16,384-row arena with 10,000 candidates, (E, P) in {(2, 16),
   (8, 64)}, f64 and f32: rows, pulls and every carry-out column
   bit-equal to the twin on the card (f64 and f32) and on the CPU
   (f64); a chain cut into chunks equals the single launch.
7. Kernel K4 (the usage-mirror patch, the one-shard case of K13 in
   csrc/patch_rows_mesh.cu) against its twin at W in {8, 1024, 16384}
   with padding idx == C, bit-equal; then the unsharded mirror's bound
   three-column flush (`RowPatch` over plain columns) at W in {8, 128,
   1024, 2048}, f64 and f32, padding dropped: bit-equal to the twin's
   flush and to three per-column K4 calls, one launch and one staging
   copy a flush.
8. The main path: the port's batched `Server()` (BatchWorker, K3 and K4
   on the card) on the same 10,000-node / 100,000-alloc cluster after
   `warm_shapes()`, fed 416 jobs (384 count-10 service jobs, 16 with a
   percent spread on the datacenter and 16 with an even spread on the
   rack, after job 48).  The same stream goes through the port's
   sequential `Server(batch_pipeline=False)` on the card (with the
   explain capture off, as earlier versions ran it), and its first
   48 jobs through a sequential Server running the host oracle.  The
   placements must be identical, the batched worker must have prescored
   evals with no errors, and K3 and K4 must have been launched: each
   delta flush of the usage mirror one staging copy and one K4 launch.
k5. Kernel K5 (the global storm solve, csrc/storm_solve.cu) against its
   twin on the card and on the CPU for every storm scenario of
   `ops/cases.py` and its weighted ones (policy rows: weighted, mixed,
   and the dogpile at A = E = 1,024), f64 and f32, at a 16,384-row
   arena with A in {8, 1024} rows: all six outputs bit-equal; at least
   one full-width case, and the full-width weighted dogpile, run 3 or
   more auction rounds.
storm. The storm path: the port's batched `Server()` with
   NOMAD_TPU_STORM=1 on the same 10,000-node / 100,000-alloc cluster,
   fed 1,024 count-1 batch children of one dispatch parent registered
   before start (one restore wave).  The same stream through the port's
   Server on the CPU (the twins) must give the same placements and the
   same storm counters; every child is placed, 1,024 evals enter the
   storm path, no errors, and K5 was launched.  Then the same stream
   with NOMAD_TPU_STORM=0 on the card, for the record: placements/s of
   each mode and the score-sum delta.
k6. Kernel K6 (the walk alone over a host-built score vector,
   csrc/walk_only.cu) against its twin on the card and on the CPU for
   every walk scenario of `ops/cases.py` (a feasible tail past
   n_candidates among them), C in {8, 1024, 16384}, limits 1, 2, 14,
   n_candidates and unlimited, f64 and f32, each on the launch shape
   its rule takes (the prefix walk below the candidates, the grid
   otherwise), with the feasible count and without it: row, best,
   feasible count (-1 where the prefix walk ran without it) and pulls
   bit-equal; then every rotation of a 37-row arena's candidates.
preempt. Preemption-mode selects: the same 10,000-node / 100,000-alloc
   cluster (priority-50 filler allocs) with service preemption on, and
   10 count-1 priority-80 jobs that only a preemption can place, through
   the port's sequential `Server(batch_pipeline=False)` (the per-eval
   device stack) on the card, on the CPU twins and on the host oracle.
   Placements and preemption sets must be equal across the three,
   AllocMetrics and explain records equal to the CPU twins', the metric
   counts equal to the oracle's; no errors, preempt selects for at least
   three quarters of the jobs, and K6 launched.
policy. Policy-weighted scoring on the same cluster with a node class
   per node (three classes from a third seeded stream): 8 count-4
   service jobs with a throughput table (two also with an affinity and
   a spread, three with a migration coefficient, each of those followed
   by a destructive update) through the port's sequential
   `Server(batch_pipeline=False)` on the card (K1 with policy terms,
   every candidate walked and captured), on the CPU twins and, for its
   first 4 steps, on the host oracle: placements and AllocMetrics
   (every NodeScoreMeta, `policy.*` included) equal, migration
   replacements on their incumbent nodes, K1 launched, no errors.  Then
   the storm phase's 1,024 children with a PolicySpec (a weighted
   storm, one solve) on the card and on the CPU twins: placements and
   counters equal, every child staged with policy rows, K5 launched.
k7. Kernel K7 (E independent evals x P picks over one shared snapshot,
   csrc/batch_picks.cu) against its twin on the card and on the CPU for
   every `batch_shared` scenario of `ops/cases.py`, at a 16,384-row
   arena with 1, 10,000 and 16,384 candidates, (E, P) in {(1, 1), (64,
   10), (256, 16), (8, 64)}, f64 and f32: the [E, P] rows bit-equal
   (the CPU twin in f64, as in phase 6).
bridge. The Go bridge path: the port's batched `Server()` on the card
   over the same 10,000-node / 100,000-alloc cluster, with its
   `BridgeService` on localhost.  32 `ScoreBatch` calls of 64 seeded
   evals (count 1-10, cpu 100-2,000 MHz, memory 128-2,048 MB, disk 300
   MB), one of 256 evals and one of count 64 through the Python client
   (`wire.call`), and one through the C++ shim (`make -C native`,
   `NativeWire.call_json`): every answer equal to a port Server's on the
   CPU over the same world, the native answer to the Python one; p50/p99
   on the client clock.  Then four client threads of 16 calls each while
   the same Server drains the first 96 jobs of phase 8's stream: no
   error response, no worker error, placements equal to the same jobs
   drained on the CPU Server without the bridge; K7 launched once a
   call.  Last, the quiet calls again with the service's steps timed in
   place, for where a call's time goes.
k8. Kernel K8 (the device supervisor's canary, csrc/canary.cu: a + 1 and
   its sum) against its twin on the card and on the CPU, n in {1, 8,
   1024}, f64 and f32: out and the sum bit-equal; ones(8) gives exactly
   16.0.  The same through the bound probe (`ops.canary.CanaryProbe`:
   inputs, outputs and sum in mapped host memory, one launch a probe).
device. The device supervisor on the same 10,000-node / 100,000-alloc
   cluster: (1) the batched `Server()` on the card with a 0.5 s probe
   interval drains the first 96 jobs of phase 8's stream: HEALTHY
   throughout, at least 4 canaries (K8 launches) and no watchdog trip,
   placements equal to a port Server's on the CPU; probe latency
   p50/p99; an idle supervisor's probes after its first, in a process
   of its own: one K8 launch each, no device allocation, no copy (the
   profiler's events); (2) phase 8's 416 jobs with NOMAD_TPU_SUPERVISOR=0 and with
   the supervisor on: placements/s of each, placements equal; (3)
   NOMAD_TPU_FAULT=flaky:3: HEALTHY -> DEGRADED -> LOST -> RECOVERING
   -> HEALTHY with K8 answering once the injected failures end; the 96
   jobs registered while LOST stay in the broker and are placed on the
   card after the flip, equal to the CPU Server's; (4)
   NOMAD_TPU_FAULT=wedge_launch at a 0.5 s budget: drain_to_idle
   raises DeviceTimeout naming `launch` within 10 s, the state is LOST,
   no eval is lost or duplicated, stop() returns within 5 s; (5)
   `python -m nomad_tpu_torch.device.preflight` in a subprocess prints
   HEALTHY and exits 0.
k9. Kernel K9 (the chained planner over per-eval BatchInputs,
   csrc/chained_batch.cu) against its twin on the card and on the CPU,
   at a 16,384-row arena with 10,000 candidates, (E, P) in {(2, 16),
   (8, 64), (64, 10)}, f64 and f32, over `batched_case` scenarios with
   and without spread, step deltas, pre-deltas and `wanted`, and long
   walks (every limit unlimited) with step deltas and pre-deltas, with
   and without spread; and its
   shared mode (one [C] feasibility column) over `batch_shared_case`:
   the [E, P] rows bit-equal (the CPU twin in f64, as in phase 6).
k10. Kernel K10 (E independent evals over their own BatchInputs,
   csrc/batch_plan.cu) the same way, rows and pulls, with and without
   spread, n_candidates one scalar or one per eval; then the (64, 10)
   cases tiled to 1,280 evals, more blocks than the card holds at once
   (the tiled rows and pulls), and a 200,000-row arena whose carry
   lives in global scratch.
k11. Kernel K11 (every node's score and feasibility, no walk,
   csrc/score_all.cu) against its twin over every score and
   policy-score scenario of `ops/cases.py`, both fits, f64 and f32:
   every node's (feasible, final) bit-equal on the card and the CPU.
bench. `python -m nomad_tpu_torch.bench` in a subprocess at its
   defaults (10,000 nodes / 100,000 allocs; the e2e headline with its
   paced and swept latency phases, then the kernel-only rates of K10
   and K9): exit 0, one JSON line (printed here), parity 48 of 48, all
   384 jobs fully placed, both kernel rates above 0, and K9, K10, K3
   and K4 launched (the counts the bench prints on stderr).

k12. Kernel K12 (the node-sharded chained planner, csrc/sharded_chain.cu,
   its stages launched per shard with the mesh's exchanges between
   them) on a VirtualMesh of D shards on the card, D in {1, 2, 4, 8}
   (f64) and 8 (f32), over the four sharded-chain scenarios of
   `ops/cases.py` (plain; deltas, pre-deltas, distinct_hosts and
   affinity; spread percent; spread even) at the 16,384-row arena with
   10,000 candidates, E = 8, P = 16: rows, pulls and the three carry
   columns bit-equal to the twin on the card and (f64) on the CPU, rows
   and pulls equal to K9's on the same inputs; then E = 64, P = 10 at
   D = 1 and 8, cut into chunks of 8 evals with the carry threaded,
   equal to one launch, to the twins and to K9; then the bench's
   multichip chain (its own inputs: C = 1,024, E = 16 in launches of 8,
   P = 4, the carry threaded) on a DistMesh over this process's
   one-rank NCCL group, bit-equal to the twin on that mesh, to the CPU
   twin at D in {1, 2, 4, 8} and (rows, pulls) to K9.
k13. Kernel K13 (the sharded mirror patch, csrc/patch_rows_mesh.cu)
   at W in {8, 1024, 16384} with padding idx == C, D in {1, 2, 4, 8},
   f64 and f32: bit-equal to the twin and to K4 on the unsharded column;
   then the multichip block's delta patch on the NCCL DistMesh, bit-equal
   to the twin there and on the CPU and to K4.
bench (also): the bench's multichip block, a d = 1 point through a
   one-rank NCCL group: placements/s above 0, the closed form's bytes
   per flush, and K12 and K13 launched by the bench's process.
k14. Kernel K14 (the node-sharded storm solve, csrc/storm_sharded.cu,
   its stages launched per shard with the mesh's exchanges between
   them) on a VirtualMesh of D shards on the card, D in {1, 2, 4, 8},
   on phase k5's inputs (the dogpile at A = 8 and 1,024; f64 at every D,
   f32 and the weighted dogpile at D = 8): all six outputs bit-equal to
   its twin on the card and on the CPU, and equal to K5 on the same
   inputs; the full-width dogpile once on the one-rank NCCL DistMesh,
   equal to D = 1; its launches equal to the cases' stage counts.
mesh. The mesh path: the port's batched `Server(mesh=VirtualMesh(8,
   card))` (K12 chunks over the sharded usage mirror, K13 delta flushes)
   on the same 10,000-node / 100,000-alloc cluster drains the first 128
   jobs of phase 8's stream (two gulps, so the second flush patches the
   sharded mirror; eight spread jobs): placements equal to phase 8's card
   run.  Then the storm phase's 1,024 children through a
   meshed Server (K14): placements, storm rows, rounds and counters
   equal to the storm phase's K5 run.  K12, K13 and K14 launched, no
   errors.
k15. Kernel K15 (the per-host flush of a sharded mirror,
   csrc/patch_rows_mesh.cu: one launch stores a process's own
   shard-local staging rows into all of its L shards) on a VirtualMesh
   of D shards on the card seen as D / L processes, (D, L) in {(2, 1),
   (4, 1), (4, 2), (8, 1), (8, 2), (8, 4)}, arenas of 64 and 16,384
   rows, the JAX test's four dirty sets (spread over the arena) and
   1,024 rows, f64 and f32: bit-equal to its twin on the card and on the
   CPU, to K13 with the replicated staging on the same dirty set and to
   the host oracle; one launch a process.
entry. The entry module (`nomad_tpu_torch/entry.py`) and its programs
   on an (evals, nodes) mesh, each program checked before its path uses
   it: `sharded_score_and_select` (K11 a node shard, the all-gather, K6)
   on VirtualMeshes of 1 x 1, 1 x 8 and 2 x 4 on the card, every score
   scenario of `ops/cases.py` at the 16,384-row arena (10,000
   candidates, limit 14), f64 and f32, bit-equal to K1's select, to its
   twin on the card and to K1's twin on the CPU, once on the one-rank
   NCCL DistMesh; `sharded_batch_plan` (the node-axis all-gathers, K10
   an eval row) at E = 16, P = 10 on the same meshes, f64 and f32, rows
   equal to K10's on the whole batch and (f64) to its CPU twin.  Then
   `dryrun_multichip(8)` on the card (a 2 x 4 VirtualMesh: the select,
   the batched plan, a meshed batched Server placing a count-4 job and a
   count-4 spread job on 12 nodes), equal in select, rows and placements
   to the same call on the CPU; its K11, K6 and K10 launches counted.

multihost. The slice's path at full width on the one card, shared by
   processes that exchange over gloo through the host (not multi-GPU
   scaling): `parallel/dist_smoke.py launch` spawns 2 ranks x 2 shards
   over the 10,000-node world (a 16,384-row arena, 4,096 rows a shard;
   64 chain jobs, a 256-member storm family), each rank a batched Server
   driven in lockstep (K12 chunks, the per-host flush through K15, the
   storm through K14, K14 against K5 on one device, cross-host parity);
   beside it a pod over the same nodes and jobs (a head Server with
   NOMAD_TPU_POD_PORT and NOMAD_TPU_POD_CHECK=1 draining on its own
   threads, and one `parallel/pod.py` peer).  Zero lost, every digest
   equal, per-host delta bytes in their closed form and below the full
   upload, placements equal to the same world's unsharded run on the CPU
   (a helper's), and K12, K14 and K15 launched in every process (their
   counts reported by the processes themselves).  The bench phase runs
   its multichip block without the multihost row (BENCH_MULTIHOST=0):
   this phase runs that world at full width.

The references that the checks compare against run in helper
processes (this script with --helper NAME DIR, 1-3 torch threads
each), started before the kernels are built: the kernel checks' twins
on the CPU (twins-a: k5, k14; twins-b: k3, k7, k9, k10, k12, entry) and
on the card (card-twins: k3, k5, k9, k10, k12, k14), and the path
phases' runs on the CPU twins and the host oracle (host-a: phases 4 and
8, storm, preempt, and the bridge's and the device phase's CPU Servers;
host-b: phase policy, the entry phase's CPU dryrun and the multihost
phase's unsharded CPU run).  The storm runs on the CPU hold their wave's broker
lease longer than their drain may take (CPU_STORM_NACK_S): a slow
host's solve must not outlive the default 60 s lease and have the wave
redelivered mid-solve.  Each phase takes their
results as it needs them, and the device phase runs after every helper
has finished.  The script re-runs itself with one PYTHONHASHSEED (drawn
at random unless set) that every helper inherits, so set orders, and
with them the order among equal candidates, are the same in every
process.  Each world recipe (plain, with node
classes) is built once and every later store gets a restored copy
(`restore_tables`).  Each phase frees its Servers before
the next world is restored, so a restore sees one world on the heap.
The phase seconds are printed split into world builds, waits for the
helpers' results and the rest (the card), each with the seconds since
the script started.  Prints the kernels
line (18 programs: K1-K8, K9 and its shared mode, K10-K15, and the entry
path's sharded_score_and_select and sharded_batch_plan with the kernels
each launches), then the
card's nvidia-smi line, then the result line: {"ok": true, "device":
{...}}.  Without a CUDA device, or
outside a checkout of the repository, it prints no result and exits 2.
"""
from __future__ import annotations

import contextlib
import enum
import gc
import io
import json
import math
import os
import pickle
import random
import statistics
import subprocess
import sys
import time
import weakref
from pathlib import Path

HERE = Path(__file__).resolve().parent

N_NODES = 10_000
N_ALLOCS = 100_000
C_CHECK = 16_384
N_CAND_CHECK = 10_000
TIMING_LAUNCHES = 1_000
ORACLE_EVALS = 32  # phase 4's host-oracle pass covers this prefix
SERVER_JOBS = 416  # phase 8's stream
SERVER_ORACLE_JOBS = 48  # its prefix through the host oracle
STORM_JOBS = 1024  # the storm phase's dispatch children
STORM_DRAIN_S = 600.0  # how long a storm run may take to drain
CPU_STORM_NACK_S = 2 * STORM_DRAIN_S  # the CPU storm runs' broker lease
STORM_ROWS = (8, 1024)  # phase k5's A
CHAIN_SHAPES = ((2, 16), (8, 64))  # phase 6's (E, P)
PATCH_WIDTHS = (8, 1024, 16_384)  # phase 7's W
FLUSH_WIDTHS = (8, 128, 1024, 2048)  # phase 7's three-column flush W
WALK_WIDTHS = (8, 1024, 16_384)  # phase k6's C
PREEMPT_JOBS = 10  # the preempt phase's priority-80 jobs
POLICY_ORACLE_STEPS = 4  # the policy phase's host-oracle prefix
K7_SHAPES = ((1, 1), (64, 10), (256, 16), (8, 64))  # phase k7's (E, P)
K7_CANDS = (1, N_CAND_CHECK, C_CHECK)  # phase k7's n_cand
BRIDGE_CALLS = 32  # the bridge phase's quiet calls of BRIDGE_E evals
BRIDGE_E = 64
BRIDGE_THREADS = 4  # its concurrent clients, each making
BRIDGE_THREAD_CALLS = 16  # calls while the Server drains
BRIDGE_DRAIN_JOBS = 96  # the first jobs of phase 8's stream
K8_SIZES = (1, 8, 1024)  # phase k8's n
DEVICE_JOBS = 96  # the device phase's jobs: the first of phase 8's stream
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F64_FLOPS = 34e12  # H100 SXM f64 outside the tensor cores, data sheet
FLOPS_PER_CANDIDATE = 120  # ~40 flops of score plus two pows (~40 each)


class GcPauses:
    """Times the cyclic garbage collector's pauses through `gc.callbacks`:
    every collection stops every thread of the process, a guarded device
    stage's watchdog included.  Counts and times are kept per phase
    (`reset` between phases); the harness's own collections in
    `build_world` are set apart as `explicit`."""

    def __init__(self) -> None:
        self.explicit = False
        self.world_collect_s = 0.0
        self._t0 = None
        self.reset()

    def reset(self) -> None:
        self.counts = [0, 0, 0]
        self.total_s = 0.0
        self.max_s = 0.0
        self.max_gen = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        t0, self._t0 = self._t0, None
        if t0 is None or self.explicit:
            return
        dt = time.perf_counter() - t0
        gen = info["generation"]
        self.counts[gen] += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s, self.max_gen = dt, gen

    def summary(self) -> dict:
        return {"collections": list(self.counts), "total_s": self.total_s,
                "max_s": self.max_s, "max_gen": self.max_gen}


GC_PAUSES = GcPauses()


class HostSplit:
    """Host seconds of the running phase by kind: "world" (world builds),
    "wait" (waits for a helper process's result: a twin or a reference
    run); the rest of a phase is its card runs.  Nested spans count
    once, in the innermost kind."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.seconds = {"world": 0.0, "wait": 0.0}
        self._stack = []

    @contextlib.contextmanager
    def __call__(self, kind: str):
        t0 = time.perf_counter()
        self._stack.append(0.0)
        try:
            yield
        finally:
            inner = self._stack.pop()
            dt = time.perf_counter() - t0
            self.seconds[kind] += dt - inner
            if self._stack:
                self._stack[-1] += dt


SPLIT = HostSplit()


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


def _k1_walk_check(out, cpu, tag: str, spread_fit: bool = False) -> float:
    """K1's walk scratch against the CPU twin: every position the kernel
    walked (all C on its grid) with the twin's feasibility and bad flag,
    every feasible one with the twin's score bits (each node's score is
    held through K11 in phase k11).  Returns the max abs error."""
    import torch

    from nomad_tpu_torch.ops import score as tscore

    walked = int(out.out_i[3])
    C = cpu.perm.shape[0]
    check(1 <= walked <= C and (out.route == "prefix" or walked == C),
          f"{tag}: walked {walked} of {C}")
    feas, scores = tscore.score_vectors(cpu, spread_fit)
    perm = cpu.perm.long()[:walked]
    f = feas[perm]
    flags = out.flags_walk.cpu()[:walked]
    check(torch.equal((flags & 1).bool(), f)
          and torch.equal((flags & 2).bool(), f & (scores[perm] <= 0)),
          f"{tag}: walked feasibility differs from the CPU twin")
    got = out.scores_walk.cpu()[:walked][f]
    want = scores[perm][f]
    check(bool((_bits(got) == _bits(want)).all()),
          f"{tag}: walked scores differ from the CPU twin")
    return _max_abs(got, want) if want.numel() else 0.0


def check_k1(cuda) -> dict:
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import (
        INT32_MAX,
        SCORE_SCENARIOS,
        SELECT_EDGES,
        score_case,
        select_edge_case,
    )
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
                    tag = f"K1 {dtype} {scenario} limit={limit} spread_fit={spread_fit}"
                    for k, tc, tp in zip(kern, twin_card, twin_cpu):
                        check(bool((_bits(k) == _bits(tc)).all()),
                              f"{tag}: kernel != twin on card")
                        check(bool((_bits(k) == _bits(tp)).all()),
                              f"{tag}: kernel != twin on CPU")
                        max_err = max(max_err, _max_abs(k, tc))
                    max_err = max(max_err, _k1_walk_check(out, cpu, tag,
                                                          spread_fit))
                    n_cases += 1
    # the policy branch: throughput, migration, both and inert selects
    from nomad_tpu_torch.ops.cases import (
        POLICY_SCORE_SCENARIOS,
        policy_score_case,
    )

    n_policy = 0
    for dtype in (torch.float64, torch.float32):
        for si, scenario in enumerate(sorted(POLICY_SCORE_SCENARIOS)):
            for limit in (14, INT32_MAX):
                case = policy_score_case(
                    5100 + si, C_CHECK, N_CAND_CHECK, scenario, limit)
                card = score_inputs_from_numpy(case, cuda, dtype=dtype)
                cpu = score_inputs_from_numpy(case, "cpu", dtype=dtype)
                out = tscore.score_select_cuda(card)
                torch.cuda.synchronize()
                kern = (out.out_i[0], out.best[0], out.out_i[2], out.out_i[1])
                twin_card = tscore.score_and_select_twin(card)
                twin_cpu = tscore.score_and_select_twin(cpu)
                tag = f"K1 policy {dtype} {scenario} limit={limit}"
                for k, tc, tp in zip(kern, twin_card, twin_cpu):
                    check(bool((_bits(k) == _bits(tc)).all()),
                          f"{tag}: kernel != twin on card")
                    check(bool((_bits(k) == _bits(tp)).all()),
                          f"{tag}: kernel != twin on CPU")
                    max_err = max(max_err, _max_abs(k, tc))
                max_err = max(max_err, _k1_walk_check(out, cpu, tag))
                n_policy += 1
    n_cases += n_policy
    # the launch shapes at their edges, each on the shape the rule takes
    # (the grid iff limit >= n_candidates): whole regions in f64 and f32,
    # a limited walk over few feasible nodes, few candidates at the front
    # of the arena, two diverted nodes, all bad, a limit at and one below
    # the candidates; the path's packed form (no feasible count) gives
    # the same row and pulls
    n_edges = 0
    for dtype in (torch.float64, torch.float32):
        for ei, edge in enumerate(sorted(SELECT_EDGES)):
            case = select_edge_case(5200 + ei, C_CHECK, N_CAND_CHECK, edge)
            card = score_inputs_from_numpy(case, cuda, dtype=dtype)
            cpu = score_inputs_from_numpy(case, "cpu", dtype=dtype)
            twin_card = tscore.score_and_select_twin(card)
            twin_cpu = tscore.score_and_select_twin(cpu)
            shape = ("grid" if case["limit"] >= case["n_candidates"]
                     else "prefix")
            tag = f"K1 edge {dtype} {edge} ({shape})"
            before = tscore.score_select_cuda.launches
            out = tscore.score_select_cuda(card)
            quick = tscore.score_select_cuda(card, count=False)
            torch.cuda.synchronize()
            check(tscore.score_select_cuda.launches == before + 2,
                  f"{tag}: one launch a call")
            check(out.route == shape, f"{tag}: took {out.route}")
            kern = (out.out_i[0], out.best[0], out.out_i[2], out.out_i[1])
            for k, tc, tp in zip(kern, twin_card, twin_cpu):
                check(bool((_bits(k) == _bits(tc)).all()),
                      f"{tag}: kernel != twin on card")
                check(bool((_bits(k) == _bits(tp)).all()),
                      f"{tag}: kernel != twin on CPU")
                max_err = max(max_err, _max_abs(k, tc))
            check(quick.out_i.cpu().tolist()[:2]
                  == [int(kern[0]), int(kern[3])],
                  f"{tag}: the packed form differs")
            # the grid gives the count always; the prefix walk not unasked
            check(int(quick.out_i[2]) == (int(kern[2]) if shape == "grid"
                                          else -1),
                  f"{tag}: the packed form's count")
            max_err = max(max_err, _k1_walk_check(out, cpu, tag))
            n_edges += 1
    n_cases += n_edges
    # the card's f32-rounded 10^x against the CPU's
    x = torch.from_numpy(np.random.default_rng(17).uniform(-1.0, 1.0, 1_000_000))
    p_cpu = tscore._pow10(x, torch.float64)
    p_card = tscore._pow10(x.to(cuda), torch.float64).cpu()
    pow_mismatch = int((p_cpu != p_card).sum())
    print(f"K1: {n_cases} cases ({n_policy} with policy terms, {n_edges} "
          f"at the launch shapes' edges) exact on card and CPU (f64 and "
          f"f32; every walked position's feasibility and score), "
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


def build_world(store, n_nodes: int = N_NODES, n_allocs: int = N_ALLOCS,
                classes: bool = False):
    """bench.py's seeded cluster (nodes with deterministic ids, 8/16/32
    cores and 16/32/64 GiB, then filler allocs of 100-500 MHz and
    128-512 MiB on random nodes, here with fixed ids too), plus a datacenter (dc1-dc3) and a
    rack attribute drawn from a second seeded stream, so that spread and
    affinity stanzas have values to act on.  With `classes`, every node
    also gets one of NODE_CLASSES from a third seeded stream, for the
    throughput tables of policy-weighted jobs.

    Each recipe (size, classes or not) is built once, into a store of
    its own, and dumped (`dump_tables`); `store`, which must be fresh,
    then gets a restored copy (`restore_tables`): the same
    nodes, allocs, indexes, node-table rows and generations as a build
    into it (tests/test_torch_world.py), as new objects, for less host
    time.

    Earlier phases' Servers hold reference cycles, so their worlds stay
    on the heap until a full collection: one runs first and frees them.
    The build or restore itself runs with the cyclic collector off (only
    for its own speed); a second full collection then moves the new
    world into the oldest generation, where a Server that has run a
    while keeps its store, and times that collection.  The runs that
    follow have the collector on and the heap as a user's process has
    it."""
    with SPLIT("world"):
        _build_world(store, n_nodes, n_allocs, classes)


def _set_attributes(obj, state: dict) -> None:
    for name, value in state.items():
        object.__setattr__(obj, name, value)


class _TablePickler(pickle.Pickler):
    """Pickles the port's plain objects (structs, node table) so that a
    load sets their attributes one by one, as their constructors do,
    instead of filling a `__dict__` that the load would have to create:
    a restored world then holds as many collector-tracked objects as a
    built one, and full collections over it cost the same."""

    def reducer_override(self, obj):
        cls = type(obj)
        if (isinstance(obj, (type, enum.Enum))
                or not cls.__module__.startswith("nomad_tpu_torch.")
                or not hasattr(obj, "__dict__")
                or cls.__reduce_ex__ is not object.__reduce_ex__
                or cls.__reduce__ is not object.__reduce__
                or getattr(cls, "__getstate__", None)
                is not getattr(object, "__getstate__", None)
                or hasattr(cls, "__setstate__")):
            return NotImplemented
        return cls.__new__, (cls,), obj.__dict__, None, None, _set_attributes


# the store object's own machinery, which a restore keeps
STORE_RUNTIME_ATTRS = ("_lock", "_watch_cond", "_watchers", "_alloc_watchers")


def dump_tables(store) -> bytes:
    """Every table, secondary index, modify-index and the node-table
    mirror of a StateStore as one pickle, to give later stores copies of
    the same world (`restore_tables`) without building it again."""
    with store._lock:
        state = {k: v for k, v in store.__dict__.items()
                 if k not in STORE_RUNTIME_ATTRS}
        buf = io.BytesIO()
        _TablePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(state)
        return buf.getvalue()


def restore_tables(store, blob: bytes) -> None:
    """Replace a StateStore's data by a `dump_tables` blob's: the same
    nodes, jobs, allocs, evals, indexes, node-table rows and
    generations, as fresh objects.  The lock and the watchers stay; the
    alloc watchers get the wholesale-replacement delta (None), and the
    node table a new epoch (it is a new table)."""
    from nomad_tpu_torch.state.node_table import NodeTable

    state = pickle.loads(blob)
    with store._lock:
        store.__dict__.update(state)
        store.node_table.epoch = next(NodeTable._epochs)
        store._watch_cond.notify_all()
        watchers = list(store._alloc_watchers)
    for cb in watchers:
        cb(None)


# (n_nodes, n_allocs, classes) -> the recipe's dump_tables(store)
WORLDS: dict = {}


def _world_blob(n_nodes: int, n_allocs: int, classes: bool) -> bytes:
    from nomad_tpu_torch.state.store import StateStore

    key = (n_nodes, n_allocs, classes)
    if key not in WORLDS:
        t0 = time.perf_counter()
        own = StateStore()
        _fill_world(own, n_nodes, n_allocs, classes)
        built_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        WORLDS[key] = dump_tables(own)
        log(f"  world {key} built in {built_s:.2f} s, dumped in "
            f"{time.perf_counter() - t0:.2f} s ({len(WORLDS[key])} bytes)")
    return WORLDS[key]


def _build_world(store, n_nodes: int, n_allocs: int, classes: bool):
    if store.latest_index() != 0 or store.nodes or store.allocs:
        raise SmokeFailure("build_world restores into a fresh store only")
    GC_PAUSES.explicit = True
    try:
        t0 = time.perf_counter()
        freed = gc.collect()
        freed_s = time.perf_counter() - t0
        gc.disable()
        t0 = time.perf_counter()
        try:
            blob = _world_blob(n_nodes, n_allocs, classes)
            t1 = time.perf_counter()
            restore_tables(store, blob)
            restored_s = time.perf_counter() - t1
        finally:
            gc.enable()
        built_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gc.collect()
        full_s = time.perf_counter() - t0
    finally:
        GC_PAUSES.explicit = False
    GC_PAUSES.world_collect_s = max(GC_PAUSES.world_collect_s, full_s)
    log(f"  {freed} unreachable objects of earlier phases freed in "
        f"{freed_s:.3f} s; world of {n_nodes} nodes, {n_allocs} allocs ready in "
        f"{built_s:.2f} s (restored in {restored_s:.2f} s); a full collection over the live heap "
        f"({len(gc.get_objects())} tracked objects) took {full_s:.3f} s")


def _fill_world(store, n_nodes: int, n_allocs: int, classes: bool):
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
    klass = random.Random(13)
    nodes = []
    for i in range(n_nodes):
        # a fixed name too: an explain record names the node
        n = mock.node(id=f"bench-node-{i:05d}", name=f"bench-node-{i:05d}")
        n.node_resources.cpu = rng.choice([8000, 16000, 32000])
        n.node_resources.memory_mb = rng.choice([16384, 32768, 65536])
        n.datacenter = topo.choice(["dc1", "dc2", "dc3"])
        n.attributes["rack"] = f"r{topo.randrange(10)}"
        if classes:
            n.node_class = klass.choice(NODE_CLASSES)
        nodes.append(n)
    class_cache = {}
    for n in nodes:
        key = (n.node_resources.cpu, n.node_resources.memory_mb,
               n.datacenter, n.node_class)
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
                # fixed ids: a node's allocs are kept in a set of ids, so
                # random ids would order them differently in each run,
                # and a preemption choosing among equal allocs with them
                id=f"filler-{i:06d}",
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
# the policy phase's node classes and the throughput table of its jobs
# (relative throughput by class, Gavel-style)
NODE_CLASSES = ("h100", "a100", "cpu")
POLICY_TPUT = {"h100": 4.0, "a100": 2.5, "cpu": 1.0}


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


def metric_fields(m) -> dict:
    """Every AllocMetric field but the wall-clock allocation time."""
    import dataclasses

    d = dataclasses.asdict(m)
    d.pop("allocation_time_s")
    return d


def metric_summary(m) -> tuple:
    """The serial chain's view of an AllocMetric, which the device
    stack's capture must reproduce against the host oracle: the counts,
    the filter and exhaustion histograms, and every node's score
    decomposition (order aside).  In preemption mode the device stack's
    exact evict evaluations also record the nodes they evaluated outside
    the walk (as the JAX package's do), so there `score_meta` is left
    out: `preempt_summary`."""
    return preempt_summary(m) + (sorted(
        (s.node_id, tuple(sorted(s.scores.items())), s.norm_score)
        for s in m.score_meta),)


def preempt_summary(m) -> tuple:
    return (m.nodes_evaluated, m.nodes_filtered, m.nodes_exhausted,
            dict(m.constraint_filtered), dict(m.class_filtered),
            dict(m.dimension_exhausted), dict(m.nodes_available))


def run_stream(mode: str, n_nodes: int = N_NODES, n_allocs: int = N_ALLOCS,
               on_ready=None, limit=None):
    """Build a fresh world and run the job stream (its first `limit`
    evals, when given) through the port.  mode: "cuda" (the kernels),
    "cpu" (the twins) or "oracle" (the host iterator chain).  Returns
    (placement stream, per-eval seconds, placements, metrics), where
    metrics[i] holds eval i's AllocMetrics, one per placed alloc (by
    name) and one per failed task group, each as the digests of its
    `metric_fields` and `metric_summary` views: an unlimited walk
    captures a score entry for every node, and holding some 10^6 of
    them across the later runs would slow those runs' host work."""
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
    stream, seconds, placed, metrics, evaluated = [], [], 0, [], 0
    for kind, make, seed in job_stream()[:limit]:
        job = make()
        h.store.upsert_job(job)
        ev = mock.evaluation(job_id=job.id, id=f"eval-{job.id}")
        n_plans = len(h.plans)
        n_blocked = len(h.create_evals)
        t = time.perf_counter()
        sched = h.process(ServiceScheduler, ev, seed=seed, **kwargs)
        if mode == "cuda":
            import torch

            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        evaluated += sum(m.nodes_evaluated for m in sched.failed_tg_allocs.values())
        new = [a for p in h.plans[n_plans:]
               for v in p.node_allocation.values() for a in v]
        allocs = sorted((a.name, a.node_id) for a in new)
        evaluated += sum(a.metrics.nodes_evaluated for a in new)
        placed += len(allocs)
        stream.append((job.id, kind, allocs, len(h.create_evals) - n_blocked))
        metrics.append((
            {a.name: metric_digests(a.metrics) for a in new},
            {tg: metric_digests(m)
             for tg, m in sched.failed_tg_allocs.items()},
        ))
    log(f"  [{mode}] {len(stream)} evals in {sum(seconds):.1f}s, "
        f"{evaluated} evaluated nodes in the AllocMetrics")
    return stream, seconds, placed, metrics, evaluated


def metric_digests(m) -> tuple:
    """(digest of `metric_fields`, digest of `metric_summary`)."""
    import hashlib

    return tuple(hashlib.sha256(repr(view(m)).encode()).hexdigest()
                 for view in (metric_fields, metric_summary))


def same_metrics(a, b, view: int) -> bool:
    """Two runs' per-eval AllocMetric digests equal under view 0
    (`metric_fields`) or 1 (`metric_summary`)."""
    if len(a) != len(b):
        return False
    for (pa, fa), (pb, fb) in zip(a, b):
        for x, y in ((pa, pb), (fa, fb)):
            if {k: d[view] for k, d in x.items()} != {
                    k: d[view] for k, d in y.items()}:
                return False
    return True


def check_main_path(cuda, card: str) -> dict:
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import score as tscore

    def reset_counts():
        tscore.score_select_cuda.launches = 0
        tbatch.plan_picks_cuda.launches = 0

    from nomad_tpu_torch.explain import EXPLAIN

    # counts are zeroed after the world is built, just before the stream
    cuda_stream, seconds, placed, cuda_metrics, evaluated = run_stream(
        "cuda", on_ready=reset_counts)
    launches = {
        "score_select": tscore.score_select_cuda.launches,
        "plan_picks": tbatch.plan_picks_cuda.launches,
    }
    print(f"main path (cuda): launches {launches}", flush=True)
    check(launches["score_select"] > 0, "K1 was not launched on the main path")
    check(launches["plan_picks"] > 0, "K2 was not launched on the main path")
    # the same stream with the explain capture off (NOMAD_TPU_EXPLAIN=0):
    # the capture is host work, so its cost shows in placements/s
    EXPLAIN.set_enabled(False)
    try:
        off_stream, off_seconds, _, _, _ = run_stream("cuda")
    finally:
        EXPLAIN.set_enabled(True)
    check(off_stream == cuda_stream, "placements changed with the explain capture off")
    check(evaluated > 0, "the capture recorded no evaluated node")
    # the CPU twins' and the host oracle's runs, from helper host-a
    with SPLIT("wait"):
        cpu_stream, _, _, cpu_metrics, _ = HELPERS.get("main-cpu")
        oracle_stream, _, _, oracle_metrics, _ = HELPERS.get("main-oracle")
    for name, other in (("cpu twins", cpu_stream), ("host oracle", oracle_stream)):
        for a, b in zip(cuda_stream, other):
            check(a == b, f"placement stream diverged from the {name} at {a[0]}: {a} vs {b}")
    check(len(cuda_stream) == len(cpu_stream), "stream length differs from the cpu twins")
    check(len(oracle_stream) == ORACLE_EVALS, "the host oracle's prefix is short")
    check(same_metrics(cuda_metrics, cpu_metrics, 0),
          "AllocMetrics differ between the card and the CPU twins")
    check(same_metrics(cuda_metrics[:ORACLE_EVALS], oracle_metrics, 1),
          "AllocMetrics differ between the card and the host oracle")
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
    rate_off = placed / sum(off_seconds)
    print(
        f"main path on {card}: {len(cuda_stream)} evals, {placed} placements, "
        f"{rate:.1f} placements/s with the explain capture on, {rate_off:.1f} "
        f"with it off (NOMAD_TPU_EXPLAIN=0), eval latency p50 {p50 * 1e3:.2f} "
        f"ms p99 {p99 * 1e3:.2f} ms (host clock, each eval ends in a device "
        f"sync); placements and AllocMetrics identical to the CPU twins and, "
        f"on its first {ORACLE_EVALS} evals, the host oracle ({evaluated} "
        f"evaluated nodes captured on the card)",
        flush=True,
    )
    return {"launches": launches, "placements_per_s": rate,
            "placements_per_s_capture_off": rate_off,
            "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3, "placed": placed}


# ---------------------------------------------------------------------------
# phase 6/7: the chained planner and the mirror patch against their twins
# ---------------------------------------------------------------------------


def _same_chain(a, b, tag: str) -> float:
    rows_a, pulls_a, (used_a, ports_a, devs_a) = a
    rows_b, pulls_b, (used_b, ports_b, devs_b) = b
    check(bool((rows_a.cpu() == rows_b.cpu()).all()), f"{tag}: rows differ")
    check(bool((pulls_a.cpu() == pulls_b.cpu()).all()), f"{tag}: pulls differ")
    err = 0.0
    for x, y in zip(used_a, used_b):
        check(bool((_bits(x) == _bits(y)).all()), f"{tag}: usage carry differs")
        err = max(err, _max_abs(x, y))
    for x, y, what in ((ports_a, ports_b, "ports"), (devs_a, devs_b, "devices")):
        check((x is None) == (y is None), f"{tag}: {what} carry missing")
        if x is not None:
            check(bool((x.cpu() == y.cpu()).all()), f"{tag}: {what} carry differs")
    return err


def _slice_evals(x, e0: int, e1: int):
    """Evals [e0, e1) of a tensor or NamedTuple input of the chain."""
    if hasattr(x, "_fields"):
        return type(x)(*[None if f is None else f[e0:e1] for f in x])
    return x[e0:e1]


def check_k3(cuda) -> dict:
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import CHAIN_SCENARIOS, chain_case
    from nomad_tpu_torch.state.convert import chain_case_to_torch

    n_cases = 0
    max_err = 0.0
    failed_picks = 0
    for dtype in (torch.float64, torch.float32):
        for si, scenario in enumerate(sorted(CHAIN_SCENARIOS)):
            for E, P in CHAIN_SHAPES:
                cols, kw = chain_case(8000 + 10 * si + E, C_CHECK,
                                      N_CAND_CHECK, scenario, E, P)
                args, kwargs = chain_case_to_torch(cols, kw, cuda, dtype)
                kern = tbatch.chained_plan_picks_cols(
                    *args, return_carry=True, **kwargs)
                torch.cuda.synchronize()
                with SPLIT("wait"):
                    twin_card = HELPERS.get(
                        f"card-k3-{str(dtype)[6:]}-{scenario}-{E}-{P}")
                tag = f"K3 {dtype} {scenario} E={E} P={P}"
                max_err = max(max_err, _same_chain(kern, twin_card, tag + " (card twin)"))
                if dtype == torch.float64:
                    # the CPU twin in the main path's mode only: the
                    # card twin holds f32, and this keeps the phase
                    # inside the script's time limit
                    with SPLIT("wait"):
                        twin_cpu = HELPERS.get(f"k3-{scenario}-{E}-{P}")
                    max_err = max(max_err, _same_chain(kern, twin_cpu,
                                                       tag + " (CPU twin)"))
                failed_picks += int((kern[0] == -1).sum())
                n_cases += 1
    # a chain cut into chunks of two evals, each chained on the last
    # one's carry-out, equals the single launch
    n_cut = 0
    for scenario in ("plain", "evict_spread", "everything"):
        E, P = 8, 16
        cols, kw = chain_case(8500 + len(scenario), C_CHECK, N_CAND_CHECK,
                              scenario, E, P)
        args, kwargs = chain_case_to_torch(cols, kw, cuda)
        whole = tbatch.chained_plan_picks_cols(*args, return_carry=True,
                                               **kwargs)
        rows, pulls = [], []
        carry = (args[3:6], kwargs.get("port_used0"), kwargs.get("dev_free0"))
        for e0 in range(0, E, 2):
            part_kw = {}
            for name, value in kwargs.items():
                if name in ("port_used0", "dev_free0"):
                    continue
                part_kw[name] = _slice_evals(value, e0, e0 + 2)
            if carry[1] is not None:
                part_kw["port_used0"] = carry[1]
            if carry[2] is not None:
                part_kw["dev_free0"] = carry[2]
            part = tbatch.chained_plan_picks_cols(
                *args[:3], *carry[0],
                _slice_evals(args[6], e0, e0 + 2),
                args[7][e0:e0 + 2], P, return_carry=True, **part_kw)
            rows.append(part[0])
            pulls.append(part[1])
            carry = part[2]
        torch.cuda.synchronize()
        _same_chain((torch.cat(rows), torch.cat(pulls), carry), whole,
                    f"K3 chunked {scenario}")
        n_cut += 1
        # the cooperative grid's answer does not depend on its size
        full = tbatch.chained_picks_cuda.blocks
        p = tbatch.prepare_chain(*args, **kwargs)
        for cap in (1, 3):
            _same_chain(tbatch.chained_picks_cuda(p, _max_blocks=cap), whole,
                        f"K3 {scenario} on a grid of {cap} block(s)")
        check(full > 3, f"K3 ran on a grid of {full} blocks")
    print(f"K3: {n_cases} cases exact against the twin on the card (f64 and "
          f"f32) and on the CPU (f64; rows, "
          f"pulls and the carry-out), {failed_picks} failed picks among "
          f"them; {n_cut} chains cut into chunks equal the single launch and "
          f"the launches on grids of 1 and 3 blocks (the card's grid: {full} "
          f"blocks); max_abs_err={max_err}", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases}


def check_k4(cuda) -> dict:
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch

    n_cases = 0
    max_err = 0.0
    for dtype in (torch.float64, torch.float32):
        for width in PATCH_WIDTHS:
            rng = np.random.default_rng(width)
            col = torch.from_numpy(rng.uniform(0.0, 1e4, C_CHECK)).to(dtype)
            n = max(1, width - width // 4)
            idx = np.full(width, C_CHECK, np.int32)  # padding: dropped
            idx[:n] = np.sort(rng.choice(C_CHECK, n, replace=False))
            idx = torch.from_numpy(idx)
            vals = torch.from_numpy(rng.uniform(0.0, 1e4, width)).to(dtype)
            on_card = tbatch.patch_rows(col.to(cuda), idx.to(cuda),
                                        vals.to(cuda))
            torch.cuda.synchronize()
            twin = tbatch.patch_rows_twin(col.clone(), idx, vals)
            tag = f"K4 {dtype} W={width}"
            check(bool((_bits(on_card) == _bits(twin)).all()), f"{tag}: kernel != twin")
            max_err = max(max_err, _max_abs(on_card, twin))
            n_cases += 1
    # the unsharded mirror's delta flush: three columns, one staging
    # buffer, one copy, one bound launch (the W dirty rows' pow2 bucket)
    saved = (tbatch.patch_rows_cuda.launches, tbatch.RowPatch.flushes,
             tbatch.RowPatch.copies)
    n_flush = 0
    for dtype in (torch.float64, torch.float32):
        for width in FLUSH_WIDTHS:
            rng = np.random.default_rng(4400 + width)
            base = [torch.from_numpy(rng.uniform(0.0, 1e4, C_CHECK)).to(dtype)
                    for _ in range(3)]
            n = width - width // 4
            rows = np.sort(rng.choice(C_CHECK, n, replace=False)).astype(np.int32)
            vals = rng.uniform(0.0, 1e4, (3, n))
            cols = tuple(b.to(cuda) for b in base)
            patch = tbatch.RowPatch(None, cols)
            before = (tbatch.patch_rows_cuda.launches, tbatch.RowPatch.copies)
            nbytes = patch.flush(rows, tuple(vals), C_CHECK)
            torch.cuda.synchronize()
            steps = (tbatch.patch_rows_cuda.launches - before[0],
                     tbatch.RowPatch.copies - before[1])
            tag = f"K4 flush {dtype} W={width}"
            check(steps == (1, 1), f"{tag}: {steps} launches and copies, not one each")
            item = base[0].element_size()
            check(nbytes == width * 4 + 3 * width * item,
                  f"{tag}: staged {nbytes} bytes")
            twin = tuple(b.clone() for b in base)
            tbatch.RowPatch(None, twin).flush(rows, tuple(vals), C_CHECK)
            # the per-column calls the flush replaces, on the card
            idx = np.full(width, C_CHECK, np.int32)
            idx[:n] = rows
            idx_t = torch.from_numpy(idx).to(cuda)
            per_col = []
            for b, v in zip(base, vals):
                padded = np.zeros(width)
                padded[:n] = v
                per_col.append(tbatch.patch_rows(
                    b.to(cuda), idx_t, torch.from_numpy(padded).to(dtype).to(cuda)))
            torch.cuda.synchronize()
            for got, want, other in zip(cols, twin, per_col):
                check(bool((_bits(got) == _bits(want)).all()),
                      f"{tag}: the flush != the twin's flush")
                check(bool((_bits(got) == _bits(other)).all()),
                      f"{tag}: the flush != three per-column K4 calls")
                max_err = max(max_err, _max_abs(got, want))
            n_flush += 1
    (tbatch.patch_rows_cuda.launches, tbatch.RowPatch.flushes,
     tbatch.RowPatch.copies) = saved
    print(f"K4: {n_cases} cases exact (f64 and f32, padding dropped); the "
          f"bound three-column flush: {n_flush} cases (W in "
          f"{list(FLUSH_WIDTHS)}) bit-equal to the twin's flush and to the "
          f"per-column calls, one launch and one staging copy each; "
          f"max_abs_err={max_err}", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases, "flush_cases": n_flush}


# ---------------------------------------------------------------------------
# phase 8: the batched pipeline through the port's Server
# ---------------------------------------------------------------------------


def server_stream():
    """Phase 8's 416 jobs in submission order: bench.py's count-10
    service job (`bench_job`), placed over all three datacenters of the
    world, with 32 spread jobs after job 48 (every 11th job from there,
    alternating a percent spread on the datacenter and an even spread
    on the rack).  Spread jobs walk every node, so they stay out of the
    host oracle's prefix."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Spread, SpreadTarget

    spread_at = {SERVER_ORACLE_JOBS + 11 * k: k for k in range(32)}
    jobs = []
    for i in range(SERVER_JOBS):
        job = mock.job(id=f"e2e-{i:03d}", datacenters=DCS)
        job.task_groups[0].count = 10
        k = spread_at.get(i)
        if k is not None and k % 2 == 0:
            job.spreads = [Spread(
                attribute="${node.datacenter}", weight=50,
                targets=(SpreadTarget("dc1", 50), SpreadTarget("dc2", 30),
                         SpreadTarget("dc3", 20)),
            )]
        elif k is not None:
            job.spreads = [Spread(attribute="${attr.rack}", weight=50)]
        jobs.append(job)
    return jobs


def drive_server(server, jobs, label: str):
    """Register the jobs, wait for the pipeline to drain, and return
    (placements by job, eval latencies in ms (ack minus submit, as
    bench.py measures them), wall seconds, placements)."""
    acks, submits = {}, {}
    orig_ack = server.broker.ack

    def timed_ack(eval_id, token):
        orig_ack(eval_id, token)
        acks[eval_id] = time.time()

    server.broker.ack = timed_ack
    try:
        t0 = time.time()
        for job in jobs:
            ev = server.register_job(job)
            submits[ev.id] = time.time()
        ok = server.drain_to_idle(timeout=600.0)
        dt = time.time() - t0
    finally:
        server.broker.ack = orig_ack
    check(ok, f"{label}: the server did not drain")
    placements = {
        job.id: sorted(
            (a.name, a.node_id)
            for a in server.store.allocs_by_job("default", job.id)
            if not a.terminal_status()
        )
        for job in jobs
    }
    lat = sorted((acks[e] - submits[e]) * 1e3 for e in acks if e in submits)
    placed = sum(len(v) for v in placements.values())
    log(f"  [{label}] {len(jobs)} jobs, {placed} placements in {dt:.1f}s")
    return placements, lat, dt, placed


def new_server(batch_pipeline: bool, device=None):
    from nomad_tpu_torch.server import Server

    # huge heartbeat TTL: the simulated nodes never heartbeat
    server = Server(num_schedulers=1, seed=1, batch_pipeline=batch_pipeline,
                    heartbeat_ttl=1e9, device=device)
    t0 = time.perf_counter()
    build_world(server.store)
    log(f"  world built in {time.perf_counter() - t0:.1f}s")
    server.start()
    return server


def check_server(cuda, card: str) -> dict:
    from nomad_tpu_torch.ops import batch as tbatch

    jobs = server_stream()
    server = new_server(batch_pipeline=True)
    try:
        worker = server.workers[0]
        check(worker.device.type == "cuda", "the batched Server is not on the card")
        t0 = time.perf_counter()
        worker.warm_shapes()
        log(f"  warm_shapes {time.perf_counter() - t0:.1f}s")
        tbatch.chained_picks_cuda.launches = 0
        tbatch.patch_rows_cuda.launches = 0
        flushes0 = (tbatch.RowPatch.flushes, tbatch.RowPatch.copies)
        batched, lat, dt, placed = drive_server(server, server_stream(), "batched")
        launches = {
            "chained_picks": tbatch.chained_picks_cuda.launches,
            "patch_rows": tbatch.patch_rows_cuda.launches,
        }
        # the usage mirror's delta flushes and their staging copies
        flushes = (tbatch.RowPatch.flushes - flushes0[0],
                   tbatch.RowPatch.copies - flushes0[1])
        stats = {k: getattr(worker, k) for k in (
            "prescored", "fallbacks", "errors", "cold_shape_fallbacks",
            "preempt_passthroughs", "replay_speculative",
            "replay_conflicts", "replay_serial_fallbacks",
            "admission_admitted", "trips")}
        sup = server.device_supervisor.status()
        stats["supervisor"] = {k: sup[k] for k in (
            "enabled", "state", "watchdog_trips", "canary_ok", "budgets")}
        timings = dict(worker.timings)
    finally:
        server.stop()
    # a stopped Server keeps its world until nothing refers to it: drop
    # each one before the next world is built (build_world collects)
    del server, worker
    print(f"main path (batched Server, cuda): launches {launches}; {stats}; "
          f"timings (s) {json.dumps({k: round(v, 4) for k, v in timings.items()})}",
          flush=True)
    print(f"main path: {flushes[0]} delta flushes of the usage mirror, "
          f"{flushes[1]} staging copies and {launches['patch_rows']} K4 "
          f"launches: {flushes[1] / max(1, flushes[0]):.0f} copy and "
          f"{launches['patch_rows'] / max(1, flushes[0]):.0f} launch a flush",
          flush=True)
    check(stats["errors"] == 0, f"the batched worker counted {stats['errors']} errors")
    # the supervisor is live on the card and its guards never tripped
    check(stats["supervisor"]["enabled"] and stats["supervisor"]["state"] == "HEALTHY"
          and stats["supervisor"]["watchdog_trips"] == 0 and stats["trips"] == 0,
          f"phase 8's supervisor: {stats['supervisor']}")
    # the stream is deterministic and every eval of it is one K3 models:
    # each must be prescored, and no replay may leave the prescored rows
    check(stats["prescored"] == len(jobs),
          f"the batched worker prescored {stats['prescored']} of {len(jobs)} evals")
    check(stats["fallbacks"] == 0,
          f"the batched worker fell back to the exact path {stats['fallbacks']} times")
    check(stats["cold_shape_fallbacks"] == 0, "a chunk waited on a cold shape")
    check(launches["chained_picks"] > 0, "K3 was not launched on the main path")
    check(launches["patch_rows"] > 0, "K4 was not launched on the main path")
    check(flushes[0] > 0 and flushes[1] == flushes[0]
          and launches["patch_rows"] == flushes[0],
          f"the mirror's delta flushes were not one copy and one K4 launch "
          f"each: {flushes[0]} flushes, {flushes[1]} copies, "
          f"{launches['patch_rows']} launches")

    from nomad_tpu_torch.explain import EXPLAIN

    # the sequential comparison runs with the explain capture off, as the
    # port ran it before it had one, so its placements/s stays comparable
    # across versions; the capture's cost is measured in phase 4, and it
    # never changes a placement (phase 4 checks that)
    seq = new_server(batch_pipeline=False)
    EXPLAIN.set_enabled(False)
    try:
        cfg = seq.store.get_scheduler_config()
        cfg.tpu_scheduler_enabled = True  # the per-eval device stack
        seq.store.set_scheduler_config(cfg)
        sequential, seq_lat, seq_dt, _ = drive_server(seq, server_stream(),
                                                      "sequential")
        seq_errors = seq.workers[0].errors
    finally:
        EXPLAIN.set_enabled(True)
        seq.stop()
    del seq, cfg
    check(seq_errors == 0, f"the sequential worker counted {seq_errors} errors")
    with SPLIT("wait"):
        oracle = HELPERS.get("server-oracle")
    for job in jobs:
        check(batched[job.id] == sequential[job.id],
              f"batched and sequential Servers diverge at {job.id}")
    for job in jobs[:SERVER_ORACLE_JOBS]:
        check(batched[job.id] == oracle[job.id],
              f"batched Server and host oracle diverge at {job.id}")
    spread_ids = [j.id for j in jobs if j.spreads]
    check(len(spread_ids) == 32, "the stream has no 32 spread jobs")
    check(all(len(batched[j]) == 10 for j in spread_ids),
          "a spread job was not fully placed")

    def pct(v, q):
        return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]

    busy = profile_batched()
    rate = placed / dt
    print(
        f"main path (batched Server) on {card}: {len(jobs)} evals, {placed} "
        f"placements in {dt:.2f}s = {rate:.1f} placements/s, eval latency "
        f"(ack - submit) p50 {pct(lat, 0.5):.2f} ms p99 {pct(lat, 0.99):.2f} ms; "
        f"sequential Server on the card (explain capture off): "
        f"{placed / seq_dt:.1f} placements/s, "
        f"p50 {pct(seq_lat, 0.5):.2f} ms p99 {pct(seq_lat, 0.99):.2f} ms; "
        f"identical placements, and on the first {SERVER_ORACLE_JOBS} jobs "
        f"identical to the host oracle",
        flush=True,
    )
    return {"launches": launches, "placements_per_s": rate,
            "flushes": flushes[0],
            "p50_ms": pct(lat, 0.5), "p99_ms": pct(lat, 0.99),
            "seq_placements_per_s": placed / seq_dt, "stats": stats,
            "timings": timings, "wall_s": dt, "busy": busy,
            "placements": batched}


def server_oracle_reference() -> dict:
    """Phase 8's reference, run in a helper: the first
    SERVER_ORACLE_JOBS jobs of its stream through a sequential Server
    running the host oracle.  Placements by job."""
    server = new_server(batch_pipeline=False, device="cpu")
    try:
        server.workers[0].host_fallback = True
        placements, _, _, _ = drive_server(
            server, server_stream()[:SERVER_ORACLE_JOBS], "oracle")
    finally:
        server.stop()
    return placements


def device_cpu_reference() -> dict:
    """The device phase's reference, run in a helper: the first
    DEVICE_JOBS jobs of phase 8's stream through a batched Server on the
    CPU.  Placements by job."""
    server = new_server(batch_pipeline=True, device="cpu")
    try:
        placements, _, _, _ = drive_server(
            server, server_stream()[:DEVICE_JOBS], "steady, cpu")
    finally:
        server.stop()
    return placements


def profile_batched() -> dict:
    """The device's busy share on the batched main path: the same
    stream through a fresh batched Server under torch.profiler.  The
    profiler slows the host side, so the share is taken against the
    profiled run's own wall time; device time is the sum of every
    kernel's and copy's self time on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    server = new_server(batch_pipeline=True)
    try:
        server.workers[0].warm_shapes()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive_server(server, server_stream(), "profiled")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        server.stop()
    by_name = {}
    for e in prof.key_averages():
        dev_us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
        if dev_us:
            by_name[e.key] = (dev_us / 1e3, e.count)
    device_ms = sum(ms for ms, _n in by_name.values())
    check(device_ms > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"profiled batched run: wall {wall:.3f} s, device busy "
          f"{device_ms:.3f} ms = {device_ms / 1e3 / wall:.4f} of it; by "
          "name (ms, count): " + "; ".join(
              f"{k[:60]} {v[0]:.3f} x{v[1]}" for k, v in top), flush=True)
    return {"wall_s": wall, "device_ms": device_ms,
            "share": device_ms / 1e3 / wall}


# ---------------------------------------------------------------------------
# phase k5 / storm: the global storm solver
# ---------------------------------------------------------------------------


def check_k5(cuda) -> dict:
    import torch

    from nomad_tpu_torch.ops import solve as tsolve
    from nomad_tpu_torch.ops.cases import POLICY_STORM_SCENARIOS
    from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

    n_cases = 0
    max_err = 0.0
    rounds = {}
    before = tsolve.storm_assignment_cuda.launches
    for dtype in (torch.float64, torch.float32):
        for si, (scenario, make, scenario_tag) in enumerate(_k5_scenarios()):
            for A in STORM_ROWS:
                cols, inp, max_rounds = make(
                    9500 + 10 * si + A, A, A, C_CHECK, scenario)
                card = (storm_inputs(inp, cuda, dtype),
                        storm_columns(cols, cuda, dtype))
                kern = tsolve.storm_assignment_cuda(*card, False, max_rounds)
                torch.cuda.synchronize()
                with SPLIT("wait"):
                    twin_card = HELPERS.get(
                        f"card-k5-{str(dtype)[6:]}-{scenario_tag}-{A}")
                    twin_cpu = HELPERS.get(f"k5-{str(dtype)[6:]}-{scenario_tag}-{A}")
                tag = f"K5 {dtype} {scenario_tag} A={A}"
                for name, k, tc, tp in zip(tsolve.StormOut._fields, kern,
                                           twin_card, twin_cpu):
                    check(bool((_bits(k) == _bits(tc)).all()),
                          f"{tag}: {name} differs from the twin on the card")
                    check(bool((_bits(k) == _bits(tp)).all()),
                          f"{tag}: {name} differs from the twin on the CPU")
                    max_err = max(max_err, _max_abs(k, tp))
                rounds[f"{scenario_tag}/A={A}/{str(dtype)[6:]}"] = int(
                    kern.rounds)
                n_cases += 1
    full = [r for k, r in rounds.items() if f"A={STORM_ROWS[-1]}/" in k]
    check(max(full) >= 3, "no full-width K5 case ran 3 or more rounds")
    launched = tsolve.storm_assignment_cuda.launches - before
    check(launched == n_cases,
          f"K5 counted {launched} launches for {n_cases} solves")
    check(rounds[f"policy_dogpile/A={STORM_ROWS[-1]}/float64"] >= 3,
          "the full-width weighted dogpile ran fewer than 3 rounds")
    print(f"K5: {n_cases} cases ({2 * len(STORM_ROWS) * len(POLICY_STORM_SCENARIOS)}"
          f" weighted) exact on card and CPU (f64 and f32; all six "
          f"outputs), max_abs_err={max_err}; one solve a launch ({launched} "
          f"for {n_cases}), the rounds one cooperative auction of "
          f"{tsolve.storm_assignment_cuda.blocks} blocks of 1,024 threads; "
          f"auction rounds per case: "
          f"{json.dumps(rounds)}", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases, "rounds": rounds}


def storm_jobs(policy: bool = False):
    """The storm phase's stream: STORM_JOBS count-1 batch children of one
    dispatch parent, sized as bench.py's bench_storm sizes them (2000
    MHz, 4096 MB: about a quarter of a node each).  With `policy`, the
    parent (so every child) carries a PolicySpec with POLICY_TPUT."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import PolicySpec

    jobs = []
    for i in range(STORM_JOBS):
        job = mock.job(id=f"stormfam/dispatch-{i:04d}", datacenters=DCS)
        job.type = "batch"
        job.task_groups[0].count = 1
        job.task_groups[0].tasks[0].resources.cpu = 2000
        job.task_groups[0].tasks[0].resources.memory_mb = 4096
        if policy:
            job.policy = PolicySpec(throughput=dict(POLICY_TPUT))
        jobs.append(job)
    return jobs


def run_storm(device, storm_on: bool, label: str, on_start=None,
              policy: bool = False, mesh=None) -> dict:
    """The storm stream through a fresh batched Server: the jobs are
    registered before start, so the whole family lands in the broker as
    one restore wave (the shape a drain or dispatch burst leaves), then
    the server drains it.  Returns placements, counters and rates.
    With `policy`, the world has node classes and the family a
    throughput table (a weighted storm); with `mesh`, the batched
    Server runs on that node mesh (the storm through K14)."""
    import os

    from nomad_tpu_torch.server import Server

    knobs = {"NOMAD_TPU_STORM": "1" if storm_on else "0",
             "NOMAD_TPU_STORM_MIN": "8",
             "NOMAD_TPU_STORM_MAX": str(STORM_JOBS)}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    # the CPU twins solve the wave for tens of seconds (the card in a
    # few), while all of its evals stay delivered: past the broker's 60 s
    # nack timeout on a slower host, which would redeliver them mid-solve
    # and fail their commits; the CPU run's lease outlasts its drain
    lease = {"nack_timeout": CPU_STORM_NACK_S} if device == "cpu" else {}
    try:
        server = Server(num_schedulers=1, seed=1, batch_pipeline=True,
                        heartbeat_ttl=1e9, device=device, mesh=mesh, **lease)
        t0 = time.perf_counter()
        build_world(server.store, classes=policy)
        log(f"  [{label}] world built in {time.perf_counter() - t0:.1f}s")
        jobs = storm_jobs(policy)
        for job in jobs:
            server.register_job(job)
        if on_start is not None:
            on_start()
        t0 = time.time()
        server.start()
        try:
            ok = server.drain_to_idle(timeout=STORM_DRAIN_S)
            dt = time.time() - t0
            worker = server.workers[0]
            placements, score_sum = {}, 0.0
            for job in jobs:
                live = [a for a in server.store.allocs_by_job("default", job.id)
                        if not a.terminal_status()]
                placements[job.id] = sorted((a.name, a.node_id) for a in live)
                for a in live:
                    # bench_storm's quality sum: the winner's normalized
                    # score, else its binpack component
                    for sm in (a.metrics.score_meta if a.metrics else ()):
                        if sm.node_id == a.node_id:
                            score_sum += sm.scores.get(
                                "normalized-score",
                                sm.scores.get("binpack", sm.norm_score))
                            break
            lost = [e.id for job in jobs
                    for e in server.store.evals_by_job("default", job.id)
                    if not e.terminal_status()]
            lost += [e.id for e in server.broker.failed()]
            counters = {k: getattr(worker, f"storm_{k}") for k in (
                "solves", "evals", "rows", "fallbacks", "divergent")}
            counters["rounds"] = server.metrics.get_gauge("storm.rounds")
            counters["policy_storm_evals"] = server.metrics.get_counter(
                "policy.storm_evals")
            out = {
                "ok": ok, "seconds": dt, "placements": placements,
                "placed": sum(len(v) for v in placements.values()),
                "score_sum": score_sum, "lost": lost, "counters": counters,
                "errors": worker.errors, "prescored": worker.prescored,
                "timings": dict(worker.timings), "mesh_storms": worker.mesh_storms,
            }
        finally:
            server.stop()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"  [{label}] {out['placed']} placements in {out['seconds']:.1f}s, "
        f"storm {out['counters']}, errors {out['errors']}")
    return out


def check_storm(cuda, card: str) -> dict:
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import solve as tsolve

    def reset_counts():
        tsolve.storm_assignment_cuda.launches = 0
        tbatch.chained_picks_cuda.launches = 0
        tbatch.patch_rows_cuda.launches = 0

    # keep the card run's storm problem (the staged inputs and the
    # mirror columns K5 read) to time K5 on it afterwards
    from nomad_tpu_torch.server.batch_worker import BatchWorker

    solved = []
    orig_solve = BatchWorker._storm_solve

    def keep_problem(self, problem, snap):
        out = orig_solve(self, problem, snap)
        # no commit ran since the solve: the mirror is what K5 read
        cols = tuple(c.clone() for c in self._device_columns(snap.node_table))
        solved.append((problem, cols))
        return out

    BatchWorker._storm_solve = keep_problem
    try:
        on = run_storm(None, True, "storm on, cuda", on_start=reset_counts)
    finally:
        BatchWorker._storm_solve = orig_solve
    launches = {
        "storm_solve": tsolve.storm_assignment_cuda.launches,
        "chained_picks": tbatch.chained_picks_cuda.launches,
        "patch_rows": tbatch.patch_rows_cuda.launches,
    }
    off = run_storm(None, False, "storm off, cuda")
    with SPLIT("wait"):
        cpu = HELPERS.get("storm-cpu")
    for name, r in (("card", on), ("CPU", cpu), ("storm-off", off)):
        check(r["ok"], f"the {name} storm run did not drain")
        check(r["errors"] == 0, f"the {name} run counted {r['errors']} errors")
        check(not r["lost"], f"the {name} run lost evals: {r['lost'][:5]}")
    check(launches["storm_solve"] > 0, "K5 was not launched on the storm path")
    check(on["counters"]["solves"] >= 1, "no storm solve ran on the card")
    check(on["counters"]["evals"] == STORM_JOBS,
          f"{on['counters']['evals']} of {STORM_JOBS} evals entered the storm")
    check(on["counters"] == cpu["counters"],
          f"storm counters differ: card {on['counters']} CPU {cpu['counters']}")
    for job_id, placed in on["placements"].items():
        check(placed == cpu["placements"][job_id],
              f"card and CPU storm runs diverge at {job_id}")
    check(on["placed"] == STORM_JOBS, f"{on['placed']} of {STORM_JOBS} placed")
    rate_on = on["placed"] / on["seconds"]
    rate_off = off["placed"] / off["seconds"]
    # K5 alone on the path's own problem (the first solve of the run)
    import numpy as np
    import torch

    from nomad_tpu_torch.ops.solve import StormInputs

    problem, cols = solved[0]
    inp = StormInputs(*(None if x is None else
                        torch.from_numpy(np.asarray(x)).to(cuda)
                        for x in problem.inputs))
    path_args = (inp, cols, problem.spread_fit, problem.max_rounds)
    path = k5_work(inp, tsolve.storm_assignment_cuda(*path_args))
    path["ms"] = cuda_time_ms(
        lambda: tsolve.storm_assignment_cuda(*path_args), n=5, warmup=1)
    path["bound_ms"] = max(path["bytes"] / HBM_BYTES_PER_S,
                           path["flops"] / F64_FLOPS) * 1e3
    path["blocks"] = tsolve.storm_assignment_cuda.blocks
    path["stamps"] = storm_stamps(
        lambda **kw: tsolve.storm_assignment_cuda(*path_args, **kw), inp,
        problem.max_rounds, cuda)
    tsolve.storm_assignment_cuda.launches = launches["storm_solve"]
    print(
        f"storm path on {card}: {STORM_JOBS} dispatch children, K5 launches "
        f"{launches['storm_solve']} (K3 {launches['chained_picks']}, K4 "
        f"{launches['patch_rows']}), counters {json.dumps(on['counters'])}; "
        f"identical to the CPU twins in placements and counters; storm on "
        f"{rate_on:.1f} placements/s ({on['seconds']:.2f} s), K5 alone on "
        f"this run's problem (A={problem.inputs.ask.shape[0]}, "
        f"E={problem.inputs.feasible.shape[0]}, {path['rounds']} rounds) "
        f"{path['ms']:.4f} ms (bound {path['bound_ms']:.6f} ms; one "
        f"cooperative auction of {path['blocks']} blocks; stamps "
        f"{_stamps_line(path['stamps'])}), storm off "
        f"{rate_off:.1f} placements/s ({off['seconds']:.2f} s); score sum on "
        f"{on['score_sum']:.4f} off {off['score_sum']:.4f} delta "
        f"{on['score_sum'] - off['score_sum']:.4f}; timings on (s) "
        f"{json.dumps({k: round(v, 4) for k, v in on['timings'].items()})}; "
        f"timings off (s) "
        f"{json.dumps({k: round(v, 4) for k, v in off['timings'].items()})}",
        flush=True,
    )
    # the path's problem, for K14's timing on it
    STORM_PATH["problem"] = path_args
    return {"launches": launches, "rate_on": rate_on, "rate_off": rate_off,
            "counters": on["counters"], "timings_on": on["timings"],
            "timings_off": off["timings"], "k5_on_path": path,
            "score_delta": on["score_sum"] - off["score_sum"],
            "placements": on["placements"]}


# the storm path's problem (StormInputs and the mirror columns K5 read,
# on the card), kept by the storm phase for K14's timing
STORM_PATH: dict = {}


def k5_work(inp, out) -> dict:
    """The least work of one K5 solve: each input read once and each
    output written once (bytes), and the operations of the score matrix
    (FLOPS_PER_CANDIDATE a pair, as the walks' candidates are counted)
    plus, for each auction round the solve took, the bid scan of the
    rows still unassigned at its start (~12 operations a node) and
    their rank scan (~6 a bidder pair)."""
    E, C = inp.feasible.shape
    A = inp.ask.shape[0]
    f = inp.ask.element_size()
    # a weighted storm also reads its two [E, C] policy rows and [E] counts
    policy_bytes = (0 if inp.policy_tput_term is None
                    else 2 * E * C * f + E * f)
    rounds = int(out.rounds)
    acc = out.accept_round.cpu()
    real = int(inp.real.sum())
    unassigned = [real - int(((acc >= 0) & (acc < r)).sum())
                  for r in range(rounds)]
    return {
        "bytes": (9 * C * f + E * C * (1 + f + 4 + 4) + 2 * E * 4
                  + A * (4 + C + 3 * f + 4 + 1) + A * (4 * 4 + f) + 4
                  + policy_bytes),
        "flops": (A * C * FLOPS_PER_CANDIDATE
                  + sum(u * (12 * C + 6 * A) for u in unassigned)),
        "rounds": rounds,
    }


def storm_stamps(solve, inp, max_rounds: int, cuda) -> dict:
    """One more solve (`solve(stamps=...)`, K5 or K14) with the kernels'
    timer stamps, read as storm_timing.py reads them: microseconds of the
    score and walk passes and of each phase of a round, summed over the
    rounds, in all and by the rows unassigned when the round began."""
    import torch

    from nomad_tpu_torch.ops import _cuda
    from storm_timing import stamp_split

    stamps = torch.zeros(_cuda.storm_stamp_len(max_rounds), dtype=torch.int64,
                         device=cuda)
    out = solve(stamps=stamps)
    torch.cuda.synchronize()
    return stamp_split(stamps, inp, out)


def _stamps_line(split: dict) -> str:
    """A stamp split as one short phrase (ms)."""
    phases = ", ".join(f"{k} {v / 1e3:.3f}" for k, v in split["rounds"].items())
    return (f"score {split['score'] / 1e3:.3f} ms, walk "
            f"{split['walk'] / 1e3:.3f} ms, rounds {phases} ms")


def time_storm_kernel(cuda, policy: bool = False) -> dict:
    """K5 at the storm path's full width (A = E = 1,024 rows and evals,
    the 16,384-row arena, f64) on the `dogpile` case; with `policy`, the
    weighted dogpile (`policy_storm_case`, mixed policy rows)."""
    from nomad_tpu_torch.ops import solve as tsolve
    from nomad_tpu_torch.ops.cases import policy_storm_case, storm_case
    from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

    A = E = STORM_ROWS[-1]
    make = policy_storm_case if policy else storm_case
    cols, inp, max_rounds = make(9900, E, A, C_CHECK, "dogpile")
    args = (storm_inputs(inp, cuda), storm_columns(cols, cuda), False,
            max_rounds)
    out = {
        "ms": cuda_time_ms(lambda: tsolve.storm_assignment_cuda(*args),
                           n=50, warmup=3),
        "plain_ms": cuda_time_ms(lambda: tsolve.storm_assignment_twin(*args),
                                 n=5, warmup=1),
        "library_ms": None,
    }
    out.update(k5_work(args[0], tsolve.storm_assignment_cuda(*args)))
    out["blocks"] = tsolve.storm_assignment_cuda.blocks
    out["stamps"] = storm_stamps(
        lambda **kw: tsolve.storm_assignment_cuda(*args, **kw), args[0],
        max_rounds, cuda)
    return out


# ---------------------------------------------------------------------------
# phase k6 / preempt: preemption-mode selects
# ---------------------------------------------------------------------------


def check_k6(cuda) -> dict:
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import INT32_MAX, WALK_SCENARIOS, walk_case

    n_cases = 0
    max_err = 0.0
    routes = {"prefix": 0, "grid": 0}

    def one(case, dtype, np_dtype, limit, tag):
        nonlocal max_err

        def tensors(dev):
            return (torch.from_numpy(case["feasible"]).to(dev),
                    torch.from_numpy(case["scores"]).to(dev),
                    torch.from_numpy(case["perm"]).to(dev))

        card = tensors(cuda)
        n_cand = case["n_candidates"]
        twins = [(where, tscore.limited_walk_argmax(*args, limit, n_cand))
                 for where, args in (("card", card), ("CPU", tensors("cpu")))]
        for count in (True, False):
            buf = tscore.walk_only_cuda(*card, limit, n_cand, count)
            route = tscore.walk_only_cuda.route
            torch.cuda.synchronize()
            kern = tscore.unpack_walk(buf.cpu(), dtype)
            check(route == ("grid" if limit >= n_cand else "prefix"),
                  f"{tag}: K6 took its {route} against its rule")
            routes[route] += 1
            for where, twin in twins:
                want = (int(twin[0]), float(twin[1]),
                        int(twin[2]) if count or route == "grid" else -1,
                        int(twin[3]))
                check(kern[0::2] == want[0::2] and kern[3] == want[3],
                      f"{tag} count={count}: kernel != twin on {where}: "
                      f"{kern} vs {want}")
                b_k = np.asarray(kern[1], np_dtype)
                b_t = twin[1].cpu().numpy()
                check(b_k.tobytes() == b_t.tobytes(),
                      f"{tag}: best differs from the twin on {where}")
                if np.isfinite(b_k) and np.isfinite(b_t):
                    max_err = max(max_err, float(abs(b_k - b_t)))

    for dtype, np_dtype in ((torch.float64, np.float64),
                            (torch.float32, np.float32)):
        for si, scenario in enumerate(sorted(WALK_SCENARIOS)):
            for width in WALK_WIDTHS:
                n_cand = max(1, (4 * width) // 5)
                for limit in (1, 2, 14, n_cand, INT32_MAX):
                    case = walk_case(9700 + 10 * si + width % 7, width,
                                     scenario, limit, np_dtype)
                    one(case, dtype, np_dtype, limit,
                        f"K6 {dtype} {scenario} C={width} limit={limit}")
                    n_cases += 1
        # every rotation of the candidates, as the stack's pull offset
        # turns its walk order
        for scenario in ("div2", "tail"):
            case = walk_case(9790 + len(scenario), 37, scenario, 3, np_dtype)
            perm, n_cand = case["perm"], case["n_candidates"]
            for off in range(n_cand):
                rotated = np.concatenate([perm[off:n_cand], perm[:off],
                                          perm[n_cand:]]).astype(np.int32)
                for limit in (3, INT32_MAX):
                    one(dict(case, perm=rotated), dtype, np_dtype, limit,
                        f"K6 {dtype} {scenario} offset {off} limit={limit}")
                    n_cases += 1
    print(f"K6: {n_cases} cases exact on card and CPU (f64 and f32; row, best, "
          f"feasible count and pulls; each with and without the count; "
          f"launches by shape {routes}), max_abs_err={max_err}", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases, "routes": routes}


def preempt_jobs():
    """The preempt phase's stream: PREEMPT_JOBS count-1 service jobs at
    priority 80, each asking 31,500 MHz and 64,000 MB.  Only a 32,000
    MHz / 65,536 MB node (about one in nine) can hold one, and almost
    none has that much free beside the priority-50 filler allocs, so
    each eval's first select fails and the scheduler retries it in
    preemption mode."""
    from nomad_tpu_torch import mock

    jobs = []
    for i in range(PREEMPT_JOBS):
        job = mock.job(id=f"urgent-{i:03d}", datacenters=DCS)
        job.priority = 80
        job.task_groups[0].count = 1
        job.task_groups[0].tasks[0].resources.cpu = 31_500
        job.task_groups[0].tasks[0].resources.memory_mb = 64_000
        jobs.append(job)
    return jobs


def run_preempt(mode: str, n_nodes: int = N_NODES,
                n_allocs: int = N_ALLOCS, on_ready=None) -> dict:
    """The preempt stream through a fresh sequential Server (the per-eval
    device stack, service preemption on).  mode: "cuda" (the kernels),
    "cpu" (the twins) or "oracle" (the host iterator chain).  Returns
    placements, evictions, AllocMetrics and explain records by job, the
    worker's errors, and the preempt selects' count, exact evict
    evaluations and host seconds."""
    import copy

    from nomad_tpu_torch.explain import EXPLAIN
    from nomad_tpu_torch.sched.cuda_stack import CudaGenericStack
    from nomad_tpu_torch.server import Server

    server = Server(num_schedulers=1, seed=1, batch_pipeline=False,
                    heartbeat_ttl=1e9,
                    device=None if mode == "cuda" else "cpu")
    t0 = time.perf_counter()
    build_world(server.store, n_nodes, n_allocs)
    log(f"  [preempt {mode}] world built in {time.perf_counter() - t0:.1f}s")
    cfg = server.store.get_scheduler_config()
    cfg.tpu_scheduler_enabled = True  # the per-eval device stack
    cfg.preemption_config.service_scheduler_enabled = True
    server.store.set_scheduler_config(cfg)
    if mode == "oracle":
        server.workers[0].host_fallback = True
    stats = {"selects": 0, "evict_evals": 0, "select_seconds": 0.0}
    orig_select = CudaGenericStack._preempt_select
    orig_verify = CudaGenericStack._verify_winner

    def timed_select(stack, tg, options):
        t = time.perf_counter()
        try:
            return orig_select(stack, tg, options)
        finally:
            stats["selects"] += 1
            stats["select_seconds"] += time.perf_counter() - t

    def counted_verify(stack, node_id, tg, evict=False):
        stats["evict_evals"] += int(evict)
        return orig_verify(stack, node_id, tg, evict)

    CudaGenericStack._preempt_select = timed_select
    CudaGenericStack._verify_winner = counted_verify
    try:
        if on_ready is not None:
            on_ready()
        server.start()
        jobs = preempt_jobs()
        t0 = time.perf_counter()
        evals = {}
        for job in jobs:
            evals[job.id] = server.register_job(job).id
            check(server.drain_to_idle(timeout=300.0),
                  f"preempt {mode}: the server did not drain")
        dt = time.perf_counter() - t0
        out = {"placements": {}, "metrics": {}, "records": {},
               "seconds": dt, "errors": server.workers[0].errors}
        for job in jobs:
            live = [a for a in server.store.allocs_by_job("default", job.id)
                    if not a.terminal_status()]
            out["placements"][job.id] = sorted((a.name, a.node_id) for a in live)
            out["metrics"][job.id] = {a.name: a.metrics for a in live}
            rec = copy.deepcopy(EXPLAIN.get(evals[job.id]))
            if rec is not None:
                for key in ("EvalID", "TraceID", "RecordedAt"):
                    rec.pop(key)
                for tg in rec["TaskGroups"].values():
                    if tg["Metric"] is not None:
                        tg["Metric"].pop("AllocationTime")
            out["records"][job.id] = rec
        out["evicted"] = sorted(
            (a.name, a.node_id) for a in server.store.allocs.values()
            if a.desired_status == "evict")
    finally:
        CudaGenericStack._preempt_select = orig_select
        CudaGenericStack._verify_winner = orig_verify
        server.stop()
    out.update(stats)
    log(f"  [preempt {mode}] {sum(map(len, out['placements'].values()))} "
        f"placed, {len(out['evicted'])} evicted in {dt:.1f}s; "
        f"{stats['selects']} preempt selects, {stats['evict_evals']} evict "
        f"evaluations")
    return out


def check_preempt(cuda, card: str) -> dict:
    from nomad_tpu_torch.ops import score as tscore

    def reset_counts():
        tscore.walk_only_cuda.launches = 0

    on_card = run_preempt("cuda", on_ready=reset_counts)
    k6_launches = tscore.walk_only_cuda.launches
    with SPLIT("wait"):
        cpu = HELPERS.get("preempt-cpu")
        oracle = HELPERS.get("preempt-oracle")
    for name, r in (("card", on_card), ("CPU", cpu), ("oracle", oracle)):
        check(r["errors"] == 0, f"the {name} preempt run counted {r['errors']} errors")
    check(k6_launches > 0, "K6 was not launched on the preempt path")
    check(on_card["selects"] >= math.ceil(0.8 * PREEMPT_JOBS),
          f"only {on_card['selects']} selects took the preempt branch")
    check(on_card["placements"] == cpu["placements"],
          "preempt placements differ between the card and the CPU twins")
    check(on_card["placements"] == oracle["placements"],
          "preempt placements differ between the card and the host oracle")
    check(on_card["evicted"] == cpu["evicted"] == oracle["evicted"],
          "preemption sets differ between card, CPU twins and host oracle")
    check(len(on_card["evicted"]) > 0, "nothing was preempted")
    check(on_card["records"] == cpu["records"],
          "explain records differ between the card and the CPU twins")
    check(all(r is not None for r in on_card["records"].values()),
          "an eval of the preempt stream has no explain record")
    for job_id, by_name in on_card["metrics"].items():
        check({k: metric_fields(m) for k, m in by_name.items()}
              == {k: metric_fields(m) for k, m in cpu["metrics"][job_id].items()},
              f"AllocMetrics differ between the card and the CPU twins at {job_id}")
        check({k: preempt_summary(m) for k, m in by_name.items()}
              == {k: preempt_summary(m)
                  for k, m in oracle["metrics"][job_id].items()},
              f"AllocMetrics differ between the card and the host oracle at {job_id}")
    placed = sum(map(len, on_card["placements"].values()))
    ms = on_card["select_seconds"] / max(1, on_card["selects"]) * 1e3
    print(
        f"preempt path on {card}: {PREEMPT_JOBS} priority-80 jobs, {placed} "
        f"placed, {len(on_card['evicted'])} allocs preempted; "
        f"{on_card['selects']} preempt selects, "
        f"{on_card['evict_evals'] / max(1, on_card['selects']):.1f} exact evict "
        f"evaluations a select, K6 launches {k6_launches}, "
        f"{ms:.2f} ms a preempt select (host clock; CPU twins "
        f"{cpu['select_seconds'] / max(1, cpu['selects']) * 1e3:.2f} ms); stream "
        f"{on_card['seconds']:.2f} s on the card, {cpu['seconds']:.2f} s on "
        f"the CPU twins, {oracle['seconds']:.2f} s on the host oracle; "
        f"placements, preemption sets, AllocMetrics and explain records "
        f"equal to the CPU twins, placements, preemption sets and metric "
        f"counts equal to the host oracle",
        flush=True,
    )
    return {"launches": {"walk_only": k6_launches},
            "selects": on_card["selects"],
            "evict_evals": on_card["evict_evals"], "ms_per_select": ms,
            "stream_s": on_card["seconds"], "placed": placed,
            "evicted": len(on_card["evicted"])}


# ---------------------------------------------------------------------------
# phase policy: policy-weighted selects and the weighted storm
# ---------------------------------------------------------------------------


def policy_stream():
    """The policy phase's steps, in order: (job id, job factory).  Eight
    count-4 weighted service jobs: three with POLICY_TPUT alone, two
    with it beside a rack affinity and a datacenter spread, three with a
    migration coefficient (two beside the table, one alone), each of the
    last three followed by a destructive update (an env bump) whose
    replacements pay the migration term off their incumbent nodes.  The
    first POLICY_ORACLE_STEPS steps hold one job of each kind and one
    update, for the host oracle's shorter pass."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import (
        Affinity,
        PolicySpec,
        Spread,
        SpreadTarget,
    )

    def make(job_id, tput=True, mig=0.0, aff=False, env="1"):
        def build():
            j = mock.job(id=job_id, datacenters=DCS)
            j.task_groups[0].count = 4
            j.task_groups[0].tasks[0].env = {"V": env}
            j.policy = PolicySpec(
                throughput=dict(POLICY_TPUT) if tput else {},
                migration_coefficient=mig)
            if aff:
                j.affinities = [Affinity("${attr.rack}", "r3", "=", 50)]
                j.spreads = [Spread(
                    attribute="${node.datacenter}", weight=50,
                    targets=(SpreadTarget("dc1", 50),
                             SpreadTarget("dc2", 30)))]
            return j
        return build

    def mig(job_id, tput):
        return [(job_id, make(job_id, tput=tput, mig=0.5)),
                (job_id, make(job_id, tput=tput, mig=0.5, env="2"))]

    return ([("pol-tput-0", make("pol-tput-0")),
             ("pol-aff-0", make("pol-aff-0", aff=True))]
            + mig("pol-mig-0", True) + mig("pol-mig-1", False)
            + [(f"pol-tput-{i}", make(f"pol-tput-{i}")) for i in (1, 2)]
            + [("pol-aff-1", make("pol-aff-1", aff=True))]
            + mig("pol-mig-2", True))


def run_policy(mode: str, on_ready=None, limit=None) -> dict:
    """The policy stream through a fresh sequential Server (the per-eval
    device stack) on the world with node classes.  mode: "cuda" (the
    kernels), "cpu" (the twins) or "oracle" (the host iterator chain).
    Runs the first `limit` steps when given.  Returns, for every step,
    the job's live placements with each alloc's AllocMetric digests;
    the selects' count and host seconds; the placed count and the
    policy components seen."""
    from nomad_tpu_torch.sched.cuda_stack import CudaGenericStack
    from nomad_tpu_torch.server import Server

    server = Server(num_schedulers=1, seed=1, batch_pipeline=False,
                    heartbeat_ttl=1e9,
                    device=None if mode == "cuda" else "cpu")
    t0 = time.perf_counter()
    build_world(server.store, classes=True)
    log(f"  [policy {mode}] world built in {time.perf_counter() - t0:.1f}s")
    cfg = server.store.get_scheduler_config()
    cfg.tpu_scheduler_enabled = True  # the per-eval device stack
    server.store.set_scheduler_config(cfg)
    if mode == "oracle":
        server.workers[0].host_fallback = True
    stats = {"selects": 0, "select_seconds": 0.0}
    orig = CudaGenericStack._select_vectorized

    def timed(stack, tg, options):
        t = time.perf_counter()
        try:
            return orig(stack, tg, options)
        finally:
            stats["selects"] += 1
            stats["select_seconds"] += time.perf_counter() - t

    CudaGenericStack._select_vectorized = timed
    steps, placed, components = [], 0, set()
    try:
        if on_ready is not None:
            on_ready()
        server.start()
        t0 = time.perf_counter()
        for job_id, make in policy_stream()[:limit]:
            server.register_job(make())
            check(server.drain_to_idle(timeout=600.0),
                  f"policy {mode}: the server did not drain at {job_id}")
            live = sorted(
                (a for a in server.store.allocs_by_job("default", job_id)
                 if not a.terminal_status()), key=lambda a: a.name)
            placed += len(live)
            for a in live:
                for m in a.metrics.score_meta:
                    components.update(
                        k for k in m.scores if k.startswith("policy."))
            steps.append((job_id, [(a.name, a.node_id,
                                    metric_digests(a.metrics))
                                   for a in live]))
        seconds = time.perf_counter() - t0
        errors = server.workers[0].errors
        counters = {k: v for k, v in server.metrics.dump()["counters"].items()
                    if k.startswith("policy.")}
    finally:
        CudaGenericStack._select_vectorized = orig
        server.stop()
    out = dict(stats, steps=steps, placed=placed, seconds=seconds,
               errors=errors, components=sorted(components),
               counters=counters)
    log(f"  [policy {mode}] {placed} placed in {seconds:.1f}s, "
        f"{stats['selects']} vectorized selects, errors {errors}")
    return out


def check_policy(cuda, card: str) -> dict:
    """Phase policy: the weighted per-eval stream on the card, the CPU
    twins and the host oracle; then one weighted storm on the card and
    the CPU twins."""
    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops import solve as tsolve

    def reset_k1():
        tscore.score_select_cuda.launches = 0

    on_card = run_policy("cuda", on_ready=reset_k1)
    k1_launches = tscore.score_select_cuda.launches
    with SPLIT("wait"):
        cpu = HELPERS.get("policy-cpu")
        oracle = HELPERS.get("policy-oracle")
    for name, r in (("card", on_card), ("CPU", cpu), ("oracle", oracle)):
        check(r["errors"] == 0, f"the {name} policy run counted {r['errors']} errors")
    check(k1_launches > 0, "K1 was not launched on the policy path")
    n_steps = len(policy_stream())
    check(len(on_card["steps"]) == n_steps, "a policy step is missing")
    check(len(oracle["steps"]) == POLICY_ORACLE_STEPS,
          "the host oracle's policy prefix is short")
    check(on_card["placed"] == 4 * n_steps,
          f"{on_card['placed']} of {4 * n_steps} policy placements")
    check(on_card["components"] == ["policy.migration", "policy.throughput"],
          f"policy components on the card: {on_card['components']}")
    for (job_id, got), (_j, twin), (_o, orc) in zip(
            on_card["steps"], cpu["steps"], oracle["steps"]):
        check([g[:2] for g in got] == [t[:2] for t in twin],
              f"policy placements differ from the CPU twins at {job_id}")
        check([g[:2] for g in got] == [o[:2] for o in orc],
              f"policy placements differ from the host oracle at {job_id}")
        check([g[2][0] for g in got] == [t[2][0] for t in twin],
              f"AllocMetrics differ from the CPU twins at {job_id}")
        check([g[2][1] for g in got] == [o[2][1] for o in orc],
              f"AllocMetrics (score_meta included) differ from the host "
              f"oracle at {job_id}")
    # the migration replacements stay on their incumbent nodes
    by_step = {}
    for job_id, got in on_card["steps"]:
        by_step.setdefault(job_id, []).append(sorted(g[1] for g in got))
    held = {j: v[0] == v[1] for j, v in by_step.items() if len(v) == 2}
    check(all(held.values()), f"migration replacements moved: {held}")

    # one weighted storm at full width, card against the CPU twins
    def reset_k5():
        tsolve.storm_assignment_cuda.launches = 0

    # keep the card run's weighted problem (the staged inputs and the
    # mirror columns K5 read) to time K5 on it afterwards
    from nomad_tpu_torch.server.batch_worker import BatchWorker

    solved = []
    orig_solve = BatchWorker._storm_solve

    def keep_problem(self, problem, snap):
        out = orig_solve(self, problem, snap)
        cols = tuple(c.clone() for c in self._device_columns(snap.node_table))
        solved.append((problem, cols))
        return out

    BatchWorker._storm_solve = keep_problem
    try:
        storm = run_storm(None, True, "weighted storm, cuda",
                          on_start=reset_k5, policy=True)
    finally:
        BatchWorker._storm_solve = orig_solve
    k5_launches = tsolve.storm_assignment_cuda.launches
    with SPLIT("wait"):
        storm_cpu = HELPERS.get("policy-storm-cpu")
    for name, r in (("card", storm), ("CPU", storm_cpu)):
        check(r["ok"], f"the {name} weighted storm did not drain")
        check(r["errors"] == 0, f"the {name} weighted storm counted "
              f"{r['errors']} errors")
        check(not r["lost"], f"the {name} weighted storm lost evals")
    check(k5_launches > 0, "K5 was not launched on the weighted storm")
    check(storm["counters"]["policy_storm_evals"] == STORM_JOBS,
          f"{storm['counters']['policy_storm_evals']} of {STORM_JOBS} evals "
          f"were staged with policy rows")
    check(storm["counters"] == storm_cpu["counters"],
          f"weighted storm counters differ: card {storm['counters']} "
          f"CPU {storm_cpu['counters']}")
    for job_id, placed in storm["placements"].items():
        check(placed == storm_cpu["placements"][job_id],
              f"card and CPU weighted storms diverge at {job_id}")
    check(storm["placed"] == STORM_JOBS,
          f"{storm['placed']} of {STORM_JOBS} weighted storm placements")
    rate = on_card["placed"] / on_card["seconds"]
    ms_select = on_card["select_seconds"] / max(1, on_card["selects"]) * 1e3
    storm_rate = storm["placed"] / storm["seconds"]
    # K5 alone on the weighted storm's own problem
    import numpy as np
    import torch

    from nomad_tpu_torch.ops.solve import StormInputs

    problem, cols = solved[0]
    inp = StormInputs(*(None if x is None else
                        torch.from_numpy(np.asarray(x)).to(cuda)
                        for x in problem.inputs))
    path_args = (inp, cols, problem.spread_fit, problem.max_rounds)
    path = k5_work(inp, tsolve.storm_assignment_cuda(*path_args))
    path["ms"] = cuda_time_ms(
        lambda: tsolve.storm_assignment_cuda(*path_args), n=5, warmup=1)
    path["bound_ms"] = max(path["bytes"] / HBM_BYTES_PER_S,
                           path["flops"] / F64_FLOPS) * 1e3
    tsolve.storm_assignment_cuda.launches = k5_launches
    print(
        f"policy path on {card}: {n_steps} weighted evals ({on_card['placed']} "
        f"placements, {on_card['selects']} K1 selects over every candidate), "
        f"{rate:.2f} placements/s, {ms_select:.2f} ms a select (host clock, "
        f"capture on; CPU twins "
        f"{cpu['select_seconds'] / max(1, cpu['selects']) * 1e3:.2f} ms), "
        f"stream {on_card['seconds']:.2f} s on the card, {cpu['seconds']:.2f} "
        f"s on the CPU twins, {oracle['seconds']:.2f} s on the host oracle "
        f"(its first {POLICY_ORACLE_STEPS} steps); "
        f"K1 launches {k1_launches}; placements and AllocMetrics equal to "
        f"the CPU twins and, on its prefix, the host oracle (score_meta with "
        f"{on_card['components']}); migration replacements held "
        f"{sorted(held)}; policy counters {json.dumps(on_card['counters'])}, "
        f"worker.errors 0.  Weighted storm: {STORM_JOBS} children, K5 "
        f"launches {k5_launches}, counters {json.dumps(storm['counters'])}, "
        f"{storm_rate:.1f} placements/s ({storm['seconds']:.2f} s), "
        f"placements equal to the CPU twins; worker.errors 0; K5 alone on "
        f"this run's weighted problem (A={problem.inputs.ask.shape[0]}, "
        f"E={problem.inputs.feasible.shape[0]}, {path['rounds']} rounds) "
        f"{path['ms']:.4f} ms (bound {path['bound_ms']:.6f} ms); timings "
        f"(s) {json.dumps({k: round(v, 4) for k, v in storm['timings'].items()})}",
        flush=True,
    )
    return {"launches": {"score_select": k1_launches,
                         "storm_solve": k5_launches},
            "placements_per_s": rate, "ms_per_select": ms_select,
            "selects": on_card["selects"], "storm_rate": storm_rate,
            "k5_on_path": path,
            "storm_counters": storm["counters"],
            "counters": on_card["counters"]}


# ---------------------------------------------------------------------------
# phase k7 / bridge: the Go bridge path
# ---------------------------------------------------------------------------


def check_k7(cuda) -> dict:
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import BATCH_SHARED_SCENARIOS, batch_shared_case
    from nomad_tpu_torch.state.convert import batch_shared_inputs_from_numpy

    n_cases = 0
    max_err = 0.0
    placed = 0
    for dtype in (torch.float64, torch.float32):
        for si, scenario in enumerate(BATCH_SHARED_SCENARIOS):
            for n_cand in K7_CANDS:
                for E, P in K7_SHAPES:
                    case = batch_shared_case(9100 + 10 * si + E + P, C_CHECK,
                                             n_cand, scenario, E, P)
                    card = batch_shared_inputs_from_numpy(case, cuda, dtype)
                    kern = tbatch.batch_plan_picks_shared_cuda(**card).cpu()
                    twin_card = tbatch.batch_plan_picks_shared_twin(**card).cpu()
                    tag = (f"K7 {dtype} {scenario} n_cand={n_cand} E={E} "
                           f"P={P}")
                    check(tuple(kern.shape) == (E, P), f"{tag}: shape {tuple(kern.shape)}")
                    check(torch.equal(kern, twin_card), f"{tag}: kernel != twin on card")
                    if dtype == torch.float64:  # as in phase 6
                        with SPLIT("wait"):
                            twin_cpu = HELPERS.get(
                                f"k7-{scenario}-{n_cand}-{E}-{P}")
                        check(torch.equal(kern, twin_cpu), f"{tag}: kernel != twin on CPU")
                    max_err = max(max_err, _max_abs(kern, twin_card))
                    placed += int((kern >= 0).sum())
                    n_cases += 1
    check(placed > 0, "K7 placed nothing in any case")
    print(f"K7: {n_cases} cases exact against the twin on the card (f64 and "
          f"f32) and on the CPU (f64; E x P rows "
          f"bit-equal, {placed} placed picks), max_abs_err={max_err}",
          flush=True)
    return {"max_abs_err": max_err, "cases": n_cases}


def bridge_body(seed: int, n_evals: int, count=None) -> dict:
    """A ScoreBatch body of `n_evals` seeded evals: count 1-10 (or
    `count`), cpu 100-2,000 MHz, memory 128-2,048 MB, disk 300 MB."""
    rng = random.Random(seed)
    return {"evals": [
        {"eval_id": f"bridge-{seed}-{k}", "job_id": f"bridge-job-{seed}-{k}",
         "seed": rng.randrange(2**31),
         "count": count if count is not None else rng.randint(1, 10),
         "cpu": rng.randint(100, 2000), "memory_mb": rng.randint(128, 2048),
         "disk_mb": 300}
        for k in range(n_evals)
    ]}


def bridge_bodies() -> list:
    """The bridge phase's quiet calls: BRIDGE_CALLS of BRIDGE_E evals,
    one of 256 evals and one of count 64."""
    bodies = [bridge_body(9300 + i, BRIDGE_E) for i in range(BRIDGE_CALLS)]
    return bodies + [bridge_body(9400, 256), bridge_body(9401, BRIDGE_E, count=64)]


def bridge_cpu_reference() -> dict:
    """The bridge phase's reference, run in a helper: a port Server on
    the CPU over the same world answers the quiet calls through its
    BridgeService, then drains the first BRIDGE_DRAIN_JOBS jobs of
    phase 8's stream without the bridge."""
    import socket

    from nomad_tpu_torch.server.bridge_service import BridgeService

    server = new_server(batch_pipeline=True, device="cpu")
    svc = BridgeService(server)
    svc.start()
    try:
        sock = socket.create_connection(("127.0.0.1", svc.port))
        try:
            t0 = time.perf_counter()
            answers = [_score(sock, body)[0] for body in bridge_bodies()]
            seconds = time.perf_counter() - t0
        finally:
            sock.close()
        placements, _, _, _ = drive_server(
            server, server_stream()[:BRIDGE_DRAIN_JOBS], "drain, no bridge")
        errors = server.workers[0].errors
    finally:
        svc.stop()
        server.stop()
    return {"answers": answers, "seconds": seconds, "placements": placements,
            "errors": errors}


def build_native():
    """`make -C native` in this checkout, then the ctypes binding."""
    import subprocess

    from nomad_tpu_torch.wire import NativeWire

    proc = subprocess.run(["make", "-C", str(HERE / "native")],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"make -C native failed ({proc.returncode}): {proc.stdout}{proc.stderr}")
    return NativeWire()


def _score(sock, body) -> tuple:
    from nomad_tpu_torch import wire

    t0 = time.perf_counter()
    resp = wire.call(sock, "TPUScheduler.ScoreBatch", body)
    return resp, (time.perf_counter() - t0) * 1e3


def profile_score_batch(svc, bodies) -> dict:
    """Where a quiet ScoreBatch call's host-clock time goes: the same
    calls again with the service's three steps timed in place (the
    seeded permutations; the staging of the columns, perms and asks
    onto the card, synchronised; K7's launch, synchronised), the rest
    being the codec, the socket, the table copy, the perm fill and the
    answer's assembly.  Mean ms a call."""
    import socket

    import torch

    from nomad_tpu_torch.server import bridge_service as bs

    spent = {"permutations": 0.0, "staging": 0.0, "k7": 0.0}
    orig = (bs.shuffle_permutation, bs.batch_shared_inputs_from_numpy,
            bs.batch_plan_picks_shared)

    def timed(key, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.current_stream().synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return run

    bs.shuffle_permutation = timed("permutations", orig[0])
    bs.batch_shared_inputs_from_numpy = timed("staging", orig[1])
    bs.batch_plan_picks_shared = timed("k7", orig[2])
    sock = socket.create_connection(("127.0.0.1", svc.port))
    try:
        total = 0.0
        for body in bodies:
            _resp, ms = _score(sock, body)
            total += ms / 1e3
    finally:
        sock.close()
        (bs.shuffle_permutation, bs.batch_shared_inputs_from_numpy,
         bs.batch_plan_picks_shared) = orig
    out = {k: v / len(bodies) * 1e3 for k, v in spent.items()}
    out["call"] = total / len(bodies) * 1e3
    out["rest"] = out["call"] - sum(spent.values()) / len(bodies) * 1e3
    return out


def check_bridge(cuda, card: str) -> dict:
    """The Go bridge path: the port's batched Server on the card with its
    BridgeService on localhost, against a CPU Server's over the same
    world; then the same service under four client threads while the
    Server drains part of phase 8's stream."""
    import socket
    import threading

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.server.bridge_service import BridgeService

    native = build_native()
    card_server = new_server(batch_pipeline=True)
    card_svc = BridgeService(card_server)
    card_svc.start()
    try:
        check(card_server.device.type == "cuda", "the bridge's Server is not on the card")
        bodies = bridge_bodies()
        tbatch.batch_plan_picks_shared_cuda.launches = 0
        # 1. quiet server, one connection, the Python client
        sock = socket.create_connection(("127.0.0.1", card_svc.port))
        try:
            answers, lat = [], []
            for body in bodies:
                resp, ms = _score(sock, body)
                check("error" not in resp, f"bridge error response: {resp}")
                answers.append(resp)
                lat.append(ms)
        finally:
            sock.close()
        fd = native.connect("127.0.0.1", card_svc.port)
        try:
            t0 = time.perf_counter()
            native_resp = native.call_json(fd, "TPUScheduler.ScoreBatch", bodies[0])
            native_ms = (time.perf_counter() - t0) * 1e3
        finally:
            native.close(fd)
        check(native_resp == answers[0],
              "the native client's answer differs from the Python client's")
        quiet_launches = tbatch.batch_plan_picks_shared_cuda.launches
        table = card_server.store.node_table
        shape = (f"{int(table.eligible.sum()):,} eligible of a "
                 f"{table.capacity:,}-row arena")
        placed = sum(len(r["nodes"]) for a in answers for r in a["results"])
        asked = sum(e["count"] for b in bodies for e in b["evals"])

        # 2. four client threads while the Server drains 96 jobs
        card_server.workers[0].warm_shapes()
        errors, busy_lat = [], []

        def client(t: int) -> None:
            s = socket.create_connection(("127.0.0.1", card_svc.port))
            try:
                for i in range(BRIDGE_THREAD_CALLS):
                    resp, ms = _score(s, bridge_body(9500 + 100 * t + i, BRIDGE_E))
                    busy_lat.append(ms)
                    if "error" in resp:
                        errors.append(resp["error"])
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(f"{type(exc).__name__}: {exc}")
            finally:
                s.close()

        jobs = server_stream()[:BRIDGE_DRAIN_JOBS]
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(BRIDGE_THREADS)]
        for th in threads:
            th.start()
        with_bridge, _, drain_s, _ = drive_server(card_server, jobs, "bridge+drain")
        for th in threads:
            th.join(timeout=300.0)
        check(not any(th.is_alive() for th in threads),
              "a bridge client thread did not finish")
        launches = tbatch.batch_plan_picks_shared_cuda.launches
        worker_errors = card_server.workers[0].errors
        stages = profile_score_batch(card_svc, bodies[:BRIDGE_CALLS])
    finally:
        card_svc.stop()
        card_server.stop()
    del card_server, card_svc
    # the CPU Server's side, from helper host-a
    with SPLIT("wait"):
        ref = HELPERS.get("bridge-cpu")
    check(len(ref["answers"]) == len(answers), "the CPU Server answered "
          f"{len(ref['answers'])} of {len(answers)} calls")
    for resp, want in zip(answers, ref["answers"]):
        check(resp == want, "the card's ScoreBatch answer differs from the "
              "CPU Server's")
    cpu_s, without, cpu_errors = ref["seconds"], ref["placements"], ref["errors"]
    check(not errors, f"bridge errors under load: {errors[:3]}")
    check(worker_errors == 0 and cpu_errors == 0,
          f"the batched workers counted {worker_errors} and {cpu_errors} errors")
    check(with_bridge == without,
          "the Server's placements changed with the bridge answering beside it")
    n_calls = len(bodies) + 1 + BRIDGE_THREADS * BRIDGE_THREAD_CALLS
    check(quiet_launches == len(bodies) + 1,
          f"K7 launched {quiet_launches} times for {len(bodies) + 1} quiet calls")
    check(launches == n_calls, f"K7 launched {launches} times for {n_calls} calls")

    def pct(v, q):
        v = sorted(v)
        return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]

    q64 = lat[:BRIDGE_CALLS]
    print(
        f"bridge on {card}: {BRIDGE_CALLS} ScoreBatch calls of {BRIDGE_E} evals "
        f"({shape}): p50 {pct(q64, 0.5):.3f} ms "
        f"p99 {pct(q64, 0.99):.3f} ms on the client clock; E=256 "
        f"{lat[BRIDGE_CALLS]:.3f} ms, count 64 {lat[BRIDGE_CALLS + 1]:.3f} ms; "
        f"native client {native_ms:.3f} ms; {placed} nodes placed of {asked} "
        f"asked; every answer equal to the CPU Server's ({cpu_s:.2f} s for the "
        f"{len(bodies)} calls there) and the native client's to the Python "
        f"client's; under load ({BRIDGE_THREADS} threads x {BRIDGE_THREAD_CALLS} "
        f"calls while the Server drained {len(jobs)} jobs in {drain_s:.2f} s): "
        f"p50 {pct(busy_lat, 0.5):.3f} ms p99 {pct(busy_lat, 0.99):.3f} ms, no "
        f"error, placements equal to the drain without the bridge; K7 launches "
        f"{launches} for {n_calls} calls; a quiet {BRIDGE_E}-eval call, steps "
        f"timed in place (mean ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()),
        flush=True,
    )
    return {"launches": {"batch_picks": launches}, "stages": stages,
            "p50_ms": pct(q64, 0.5), "p99_ms": pct(q64, 0.99),
            "busy_p50_ms": pct(busy_lat, 0.5), "busy_p99_ms": pct(busy_lat, 0.99)}


# ---------------------------------------------------------------------------
# phases k8 and device: the canary kernel and the device supervisor
# ---------------------------------------------------------------------------


def check_k8(cuda) -> dict:
    """K8 against its twin on the card and on the CPU, n in K8_SIZES,
    f64 and f32, bit for bit; ones(8) answers exactly 16.0."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import canary as tcanary

    saved = tcanary.canary_cuda.launches
    cases = 0
    max_err = 0.0
    for dtype in (torch.float64, torch.float32):
        for n in K8_SIZES:
            a = torch.from_numpy(np.random.default_rng(8800 + n).normal(size=n))
            a = a.to(dtype)
            out, total = tcanary.canary_cuda(a.to(cuda))
            torch.cuda.synchronize()
            for where, (t_out, t_total) in (
                    ("card", tcanary.canary_plain(a.to(cuda))),
                    ("cpu", tcanary.canary_plain(a))):
                check(np.array_equal(_bits(out), _bits(t_out)),
                      f"K8 out differs from the twin on the {where} (n={n}, {dtype})")
                check(np.array_equal(_bits(total.reshape(1)),
                                     _bits(t_total.reshape(1))),
                      f"K8 sum differs from the twin on the {where} (n={n}, {dtype})")
                max_err = max(max_err, _max_abs(out, t_out),
                              _max_abs(total, t_total))
            cases += 1
        _out, total = tcanary.canary_cuda(torch.ones(8, dtype=dtype, device=cuda))
        check(float(total) == 16.0, f"K8 on ones(8) gave {float(total)}, not 16.0")
    # the supervisor's bound probe: the same kernel from mapped host memory
    bound = 0
    for dtype in (torch.float64, torch.float32):
        for n in K8_SIZES:
            a = torch.from_numpy(np.random.default_rng(8800 + n).normal(size=n))
            a = a.to(dtype)
            probe = tcanary.CanaryProbe(cuda, values=a, dtype=dtype)
            try:
                before = tcanary.canary_cuda.launches
                total = probe.probe()
                out = torch.from_numpy(probe.out())
                check(tcanary.canary_cuda.launches == before + 1,
                      f"the bound probe made {tcanary.canary_cuda.launches - before} launches")
            finally:
                probe.close()
            t_out, t_total = tcanary.canary_plain(a)
            check(np.array_equal(_bits(out), _bits(t_out)),
                  f"the bound K8's out differs from the twin (n={n}, {dtype})")
            check(np.array_equal(_bits(torch.tensor([total], dtype=dtype)),
                                 _bits(t_total.reshape(1))),
                  f"the bound K8's sum differs from the twin (n={n}, {dtype})")
            max_err = max(max_err, _max_abs(out, t_out),
                          abs(total - float(t_total)))
            bound += 1
        probe = tcanary.CanaryProbe(cuda, dtype=dtype)
        try:
            answers = [probe.probe() for _ in range(3)]
        finally:
            probe.close()
        check(answers == [16.0] * 3, f"the bound probe on ones(8) gave {answers}")
    tcanary.canary_cuda.launches = saved
    print(f"K8: {cases} cases bit-equal to the twin on the card and the CPU "
          f"(f64 and f32, n in {list(K8_SIZES)}; out and the sum in the "
          f"kernel's order); ones(8) -> 16.0; the bound probe (mapped host "
          f"memory, one launch) {bound} cases bit-equal to the twin, ones(8) "
          f"-> 16.0; max_abs_err={max_err}", flush=True)
    return {"max_abs_err": max_err}


# ---------------------------------------------------------------------------
# phases k9-k11: the benchmark's pick programs and the score pass
# ---------------------------------------------------------------------------

# without any option, and with all of them (spread, step deltas,
# pre-deltas, wanted, little room, per-eval candidate counts,
# distinct_hosts), and long walks with step deltas and pre-deltas, with
# the score cache and without it (spread); the twins on the card and CPU
# take most of the time
K9_SCENARIOS = ("plain", "everything", "unlimited_evict",
                "unlimited_spread_evict")
# (scenario, n_candidates as one scalar or one per eval)
K10_CASES = (("plain", "scalar"), ("everything", "per_eval"))
BATCHED_SHAPES = ((2, 16), (8, 64), (64, 10))  # phases k9/k10's (E, P)


def check_k9(cuda) -> dict:
    """K9 against its twin: per-eval BatchInputs (with and without
    spread, step deltas, pre-deltas and `wanted`) and the shared mode,
    bit-equal rows on the card (f64, f32) and on the CPU (f64)."""
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.state.convert import (
        batch_shared_inputs_from_numpy,
        batched_case_to_torch,
    )

    n_cases = placed = shared_cases = 0
    for dtype in (torch.float64, torch.float32):
        for scenario in K9_SCENARIOS:
            for E, P in BATCHED_SHAPES:
                cols, kw = _k9_batched_case(9300, scenario, E, P)
                args, kwargs = batched_case_to_torch(cols, kw, cuda, dtype)
                kern = tbatch.chained_plan_picks_cuda(*args, **kwargs).cpu()
                tag = f"K9 {dtype} {scenario} E={E} P={P}"
                check(tuple(kern.shape) == (E, P), f"{tag}: shape")
                with SPLIT("wait"):
                    twin_card = HELPERS.get(
                        f"card-k9-{str(dtype)[6:]}-{scenario}-{E}-{P}")
                check(torch.equal(kern, twin_card), f"{tag}: kernel != twin on card")
                if dtype == torch.float64:  # as in phase 6
                    with SPLIT("wait"):
                        twin_cpu = HELPERS.get(f"k9-{scenario}-{E}-{P}")
                    check(torch.equal(kern, twin_cpu), f"{tag}: kernel != twin on CPU")
                placed += int((kern >= 0).sum())
                n_cases += 1
        for scenario in ("mixed",):
            for E, P in K9_SHARED_SHAPES:
                case = _k9_shared_case(scenario, E, P)
                card = batch_shared_inputs_from_numpy(case, cuda, dtype)
                kern = tbatch.chained_plan_picks_shared_cuda(**card).cpu()
                tag = f"K9 shared {dtype} {scenario} E={E} P={P}"
                with SPLIT("wait"):
                    twin_card = HELPERS.get(
                        f"card-k9s-{str(dtype)[6:]}-{scenario}-{E}-{P}")
                check(torch.equal(kern, twin_card), f"{tag}: kernel != twin on card")
                if dtype == torch.float64:
                    with SPLIT("wait"):
                        twin_cpu = HELPERS.get(f"k9s-{scenario}-{E}-{P}")
                    check(torch.equal(kern, twin_cpu), f"{tag}: kernel != twin on CPU")
                placed += int((kern >= 0).sum())
                n_cases += 1
                shared_cases += 1
    check(placed > 0, "K9 placed nothing in any case")
    print(f"K9: {n_cases} cases exact against the twin on the card (f64 and "
          f"f32) and on the CPU (f64; E x P rows bit-equal, per-eval "
          f"{K9_SCENARIOS} and the shared mode, {placed} placed picks)",
          flush=True)
    return {"max_abs_err": 0.0, "cases": n_cases, "shared_cases": shared_cases}


K10_TILES = 20  # phase k10's (64, 10) cases tiled to 1,280 evals
K10_CARRY = (200_000, 150_000, 2, 8)  # a carry beyond shared memory: C, n, E, P


def check_k10(cuda) -> dict:
    """K10 against its twin: per-eval BatchInputs with and without
    spread, n_candidates one scalar or one per eval; bit-equal rows and
    pulls on the card (f64, f32) and on the CPU (f64).  Then the (64,
    10) cases tiled to more evals than the card holds blocks at once
    (waves: the tiled rows and pulls), and an arena whose carry lives
    in global scratch."""
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import tiled_batched

    n_cases = placed = 0
    waves = {}
    for dtype in (torch.float64, torch.float32):
        dt = str(dtype)[6:]
        for scenario, nc_mode in K10_CASES:
            for E, P in BATCHED_SHAPES:
                args, spread = _k10_inputs(scenario, nc_mode, E, P, cuda, dtype)
                q = tbatch.prepare_batched(*args, spread=spread)
                kern = torch.stack(tbatch.launch_batch_plan(q)).cpu()
                tag = f"K10 {dtype} {scenario} ({nc_mode}) E={E} P={P}"
                check(tuple(kern.shape) == (2, E, P), f"{tag}: shape")
                with SPLIT("wait"):
                    twin_card = HELPERS.get(
                        f"card-k10-{dt}-{scenario}-{nc_mode}-{E}-{P}")
                check(torch.equal(kern, twin_card),
                      f"{tag}: rows or pulls != twin on card")
                if dtype == torch.float64:  # as in phase 6
                    with SPLIT("wait"):
                        twin_cpu = HELPERS.get(f"k10-{scenario}-{nc_mode}-{E}-{P}")
                    check(torch.equal(kern, twin_cpu),
                          f"{tag}: rows or pulls != twin on CPU")
                placed += int((kern[0] >= 0).sum())
                n_cases += 1
                if (E, P) == BATCHED_SHAPES[-1]:
                    # the same evals tiled: blocks in waves, each on its
                    # own slice of the state
                    big = tiled_batched(q, K10_TILES)
                    at_once = tbatch.batch_plan_blocks_at_once(
                        q["C"], P, dtype, cuda)
                    check(big["E"] > at_once,
                          f"{tag}: {big['E']} evals fit the card at once "
                          f"({at_once})")
                    tiled = torch.stack(tbatch.launch_batch_plan(big)).cpu()
                    check(torch.equal(tiled, kern.repeat(1, K10_TILES, 1)),
                          f"{tag}: tiled to {big['E']} evals, rows or pulls "
                          f"!= the tiled {E}")
                    waves[f"{scenario}-{dt}"] = (big["E"], at_once)
                    n_cases += 1
        q = tbatch.prepare_batched(*_k10_carry_inputs(cuda, dtype))
        kern = torch.stack(tbatch.launch_batch_plan(q)).cpu()
        with SPLIT("wait"):
            check(torch.equal(kern, HELPERS.get(f"card-k10-carry-{dt}")),
                  f"K10 {dtype} carry in global scratch: != twin on card")
            if dtype == torch.float64:
                check(torch.equal(kern, HELPERS.get("k10-carry")),
                      f"K10 {dtype} carry in global scratch: != twin on CPU")
        placed += int((kern[0] >= 0).sum())
        n_cases += 1
    check(placed > 0, "K10 placed nothing in any case")
    print(f"K10: {n_cases} cases exact against the twin on the card (f64 and "
          f"f32) and on the CPU (f64; E x P rows and pulls bit-equal, "
          f"{K10_CASES}, {placed} placed picks); tiled (evals, blocks at "
          f"once) {waves}; the carry in global scratch at C = "
          f"{K10_CARRY[0]}", flush=True)
    return {"max_abs_err": 0.0, "cases": n_cases, "waves": waves}


def check_k11(cuda) -> dict:
    """K11 against its twin over every score and policy-score scenario
    (limit 14, both fits, f64 and f32): every node's feasibility and
    final score bit-equal on the card and on the CPU."""
    import torch

    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import (
        POLICY_SCORE_SCENARIOS,
        SCORE_SCENARIOS,
        policy_score_case,
        score_case,
    )
    from nomad_tpu_torch.state.convert import score_inputs_from_numpy

    cases = ([(score_case, s) for s in sorted(SCORE_SCENARIOS)]
             + [(policy_score_case, s) for s in sorted(POLICY_SCORE_SCENARIOS)])
    n_cases = 0
    max_err = 0.0
    for dtype in (torch.float64, torch.float32):
        for i, (make, scenario) in enumerate(cases):
            case = make(9500 + i, C_CHECK, N_CAND_CHECK, scenario, 14)
            card = score_inputs_from_numpy(case, cuda, dtype=dtype)
            cpu = score_inputs_from_numpy(case, "cpu", dtype=dtype)
            for spread_fit in (False, True):
                feas, final = tscore.score_all_cuda(card, spread_fit)
                tag = f"K11 {dtype} {make.__name__} {scenario} fit={spread_fit}"
                for where, twin in (
                        ("card", tscore.score_all_twin(card, spread_fit)),
                        ("CPU", tscore.score_all(cpu, spread_fit))):
                    check(torch.equal(feas.cpu(), twin[0].cpu()),
                          f"{tag}: feasibility != twin on {where}")
                    check(bool((_bits(final) == _bits(twin[1])).all()),
                          f"{tag}: scores != twin on {where}")
                    max_err = max(max_err, _max_abs(final, twin[1]))
                n_cases += 1
    print(f"K11: {n_cases} cases exact against the twin on the card and on "
          f"the CPU (f64 and f32; every node's feasibility and score "
          f"bit-equal, {C_CHECK} rows), max_abs_err={max_err}", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases}


# ---------------------------------------------------------------------------
# phase bench: the port's benchmark entry point at its defaults
# ---------------------------------------------------------------------------

BENCH_TIMEOUT_S = 420


def check_bench(cuda, card: str) -> dict:
    """`python -m nomad_tpu_torch.bench` in a subprocess at its defaults
    (10,000 nodes / 100,000 allocs, 48 oracle jobs, 384 batched, 128
    paced, 3 x 64 swept; the kernel-only phase on 2,000 nodes, E = 64;
    the multichip block): exit 0, one JSON line, parity 48 of 48, all
    384 jobs fully placed, both kernel rates above 0, a multichip point
    at d = 1 through the NCCL group with placements/s above 0 and the
    closed form's bytes per flush, and K9, K10, K3, K4, K12 and K13
    launched (the launch counts the bench prints on stderr)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    # the multichip block's multihost row is the multihost phase's world
    # at a toy size: that phase runs it at full width
    env["BENCH_MULTIHOST"] = "0"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch.bench"], cwd=str(HERE),
            env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise SmokeFailure(f"the bench ran past {BENCH_TIMEOUT_S} s: "
                           f"{(exc.stderr or '')[-2000:]}")
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines()[-40:]:
        log(f"  [bench] {line}")
    check(proc.returncode == 0,
          f"the bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 1, f"the bench printed {len(lines)} lines, not one")
    line = json.loads(lines[0])
    launches = [json.loads(x.split(" ", 1)[1]) for x in proc.stderr.splitlines()
                if x.startswith("BENCH_LAUNCHES ")]
    check(len(launches) == 1, "the bench printed no launch counts")
    launches = launches[0]
    print(f"bench line: {lines[0]}", flush=True)
    check(line["parity_identical_evals"] == 48,
          f"the bench's parity is {line['parity_identical_evals']} of 48")
    check(line["vs_baseline"] > 0, "the bench zeroed vs_baseline")
    check(line["e2e_jobs_fully_placed"] == 384,
          f"{line['e2e_jobs_fully_placed']} of the 384 jobs fully placed")
    check(line["kernel_batch_placements_per_sec"] > 0
          and line["kernel_chained_placements_per_sec"] > 0,
          "a kernel-only rate is 0")
    for name in ("chained_plan_picks", "batch_plan_picks", "chained_picks",
                 "patch_rows", "sharded_chained_plan", "patch_rows_sharded"):
        check(launches.get(name, 0) > 0, f"the bench launched no {name}")
    mc = line.get("multichip")
    check(mc is not None, "the bench printed no multichip block")
    check("multihost" not in mc, "the bench ran its multihost row")
    check(mc["mesh"] == "DistMesh (nccl)", f"the multichip mesh is {mc['mesh']}")
    check([p["n_devices"] for p in mc["points"]] == [1],
          f"multichip points {[p['n_devices'] for p in mc['points']]}, not d = 1")
    # the sweep's closed form: three pow2-padded i32 index and f64 value
    # buffers against six C-row f64 columns
    for p in mc["points"]:
        width = max(8, 1 << (p["dirty_rows"] - 1).bit_length())
        check(p["placements_per_sec"] > 0, "a multichip point placed nothing")
        check(p["bytes_per_flush_delta"] == 3 * width * (4 + 8)
              and p["bytes_per_flush_full"] == 6 * mc["arena_nodes"] * 8,
              f"multichip bytes per flush {p}")
        check(p["chunk_launches"] == -(-mc["evals"] // p["chunk_width"]),
              f"multichip chunk launches {p}")
        check("per_device_flops" not in p, "a multichip point claims XLA flops")
    check(launches["sharded_chained_plan_chunks"] >= 4 * mc["points"][0][
        "chunk_launches"], "the multichip sweep launched too few K12 chunks")
    print(f"bench on {card}: {line['value']} placements/s (oracle "
          f"{line['oracle_e2e_placements_per_sec']}, vs_baseline "
          f"{line['vs_baseline']}), p50 {line['p50_eval_latency_ms']} ms p99 "
          f"{line['p99_eval_latency_ms']} ms, kernel-only batch "
          f"{line['kernel_batch_placements_per_sec']} / chained "
          f"{line['kernel_chained_placements_per_sec']} placements/s; "
          f"multichip {json.dumps(mc)}; "
          f"launches {launches}; subprocess {wall:.1f} s", flush=True)
    return {"line": line, "launches": launches, "wall_s": wall}


@contextlib.contextmanager
def env_set(**values):
    """Set environment variables for one step, restoring them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def wait_for(cond, timeout: float, step: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _supervised_server():
    """A batched Server on the card, warmed, with its supervisor live."""
    server = new_server(batch_pipeline=True)
    sup = server.device_supervisor
    check(server.device.type == "cuda", "the device phase's Server is not on the card")
    check(sup.expected, "the supervisor of a Server on the card is not live")
    server.workers[0].warm_shapes()
    return server, sup


def _no_eval_lost(server, jobs, label: str) -> None:
    ids = {job.id for job in jobs}
    evs = [e for e in server.store.evals.values() if e.job_id in ids]
    check({e.job_id for e in evs} == ids, f"{label}: an eval is missing")
    for ev in evs:
        check(ev.status == "complete" or (
            ev.status == "pending" and server.broker.outstanding(ev.id) is None),
            f"{label}: eval of {ev.job_id} is {ev.status} and leased")
    check(server.broker.stats["delivery_failures"] == 0,
          f"{label}: the broker failed an eval at its delivery limit")
    for job in jobs:
        names = [a.name for a in server.store.allocs_by_job("default", job.id)
                 if not a.terminal_status()]
        check(len(names) == len(set(names)), f"{label}: {job.id} placed twice")


def idle_probes_main() -> int:
    """The device phase's idle probes, in a process of their own: a
    throwaway supervisor probes once, then 32 times back to back (one K8
    launch each, no device allocation), then 8 times under the profiler,
    whose events must hold their 8 kernels and no copy: the process's
    only profiler run (a later profiler run in the main process saw no
    kernels).  Prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(HERE))
    from nomad_tpu_torch.device import DeviceSupervisor
    from nomad_tpu_torch.ops import canary as tcanary

    cuda = torch.device("cuda", 0)
    sup = DeviceSupervisor(expected=True, device=cuda, probe_interval_s=3600.0)
    sup.prepare()
    try:
        first = sup.probe_once()
        mem0 = torch.cuda.memory_allocated(cuda)
        k0 = tcanary.canary_cuda.launches
        all_ok = all(sup.probe_once() for _ in range(32))
        launches = tcanary.canary_cuda.launches - k0
        mem1 = torch.cuda.memory_allocated(cuda)
        latency = sup.status()["probe_latency_ms"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                all_ok = sup.probe_once() and all_ok
            torch.cuda.synchronize()
    finally:
        sup.close()
    events = prof.key_averages()
    print(json.dumps({
        "first": first, "all_ok": all_ok, "launches": launches,
        "mem_before": mem0, "mem_after": mem1, "latency_ms": latency,
        "seen_kernels": sum(e.count for e in events
                            if "canary_kernel" in e.key),
        "seen_copies": sorted(e.key for e in events
                              if "memcpy" in e.key.lower() or e.key in (
                                  "aten::copy_", "aten::to", "aten::_to_copy")),
    }), flush=True)
    return 0


def check_device(cuda, card: str) -> dict:
    """The device supervisor on the card: steady state, the guard's cost,
    a flaky round trip, a wedged launch and the preflight."""
    from nomad_tpu_torch.device import DeviceTimeout
    from nomad_tpu_torch.device.supervisor import (
        DEGRADED, HEALTHY, LOST, RECOVERING)
    from nomad_tpu_torch.ops import canary as tcanary

    jobs = server_stream()[:DEVICE_JOBS]
    out = {}
    # (1) steady state: the probe thread launches K8 every 0.5 s
    with env_set(NOMAD_TPU_PROBE_INTERVAL_S="0.5"):
        tcanary.canary_cuda.launches = 0
        server, sup = _supervised_server()
        try:
            steady, _, steady_s, _ = drive_server(server, jobs, "steady, supervised")
            check(wait_for(lambda: sup.canary_ok >= 4, 10.0),
                  f"{sup.canary_ok} canaries passed, not 4")
            status = sup.status()
        finally:
            server.stop()
        launches = tcanary.canary_cuda.launches
    # once its threads have ended, a stopped Server is freed with its
    # store: no guarded stage's runner keeps it alive
    store_ref = weakref.ref(server.store)
    del server, sup
    check(wait_for(lambda: gc.collect() >= 0 and store_ref() is None, 10.0,
                   step=0.5),
          "a stopped supervised Server's store is still alive")
    check(status["state"] == HEALTHY and not status["history"],
          f"the supervisor left HEALTHY: {status['history']}")
    check(status["watchdog_trips"] == 0 and status["canary_fail"] == 0,
          f"steady state tripped {status['watchdog_trips']} watchdogs, failed "
          f"{status['canary_fail']} canaries")
    check(launches >= status["canary_ok"] >= 4,
          f"K8 launched {launches} times for {status['canary_ok']} canaries")
    # the same jobs on a CPU Server, from helper host-a
    with SPLIT("wait"):
        on_cpu = HELPERS.get("device-cpu")
    check(steady == on_cpu, "the supervised card Server and the CPU Server diverge")
    # the same probe on an idle process of its own (`idle_probes_main`)
    proc = subprocess.run(
        [sys.executable, str(HERE / "chip_smoke.py"), "--idle-probes"],
        cwd=str(HERE), capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and bool(lines),
          f"the idle probes exited {proc.returncode}: {proc.stderr[-1500:]}")
    idle = json.loads(lines[-1])
    check(idle["first"] and idle["all_ok"],
          f"an idle probe failed: {idle}")
    check(idle["launches"] == 32,
          f"32 idle probes made {idle['launches']} K8 launches")
    check(idle["mem_after"] == idle["mem_before"],
          f"32 idle probes changed the card's allocated bytes from "
          f"{idle['mem_before']} to {idle['mem_after']}")
    check(idle["seen_kernels"] >= 8 and not idle["seen_copies"],
          f"8 profiled probes: {idle['seen_kernels']} K8 kernels, copies "
          f"{idle['seen_copies']}")
    mem0 = idle["mem_before"]
    seen_kernels = idle["seen_kernels"]
    idle = idle["latency_ms"]
    probe = status["probe_latency_ms"]
    out["launches"] = {"canary": launches}
    out["probe_p50_ms"], out["probe_p99_ms"] = probe["p50"], probe["p99"]
    print(f"device (1) steady state on {card}: {len(jobs)} jobs in {steady_s:.2f} s, "
          f"HEALTHY throughout, {status['canary_ok']} canaries, K8 launches "
          f"{launches}, probe latency (a thread handoff, one bound K8 launch "
          f"reading and writing mapped host memory, the wait on the canary's "
          f"stream; host clock) p50 {probe['p50']:.3f} ms "
          f"p99 {probe['p99']:.3f} ms over {probe['count']} (beside the drain, "
          f"then idle); {idle['count']} probes of an idle process: p50 "
          f"{idle['p50']:.3f} ms p99 {idle['p99']:.3f} ms, after the first "
          f"one K8 launch each, no device allocation ({mem0} bytes before "
          f"and after), and under the profiler {seen_kernels} K8 kernels "
          f"and no copy for 8 probes; budgets "
          f"{json.dumps(status['budgets'])}; placements equal to the CPU "
          f"Server's", flush=True)

    # (2) the guard's cost: phase 8's stream once without it and once
    # with it; each guarded stage call counted, the time a call spends
    # in the guard beyond its stage's own summed (the handoff to the
    # stage's thread and back), and one guarded no-op stage timed alone
    rates = {}
    placed_by = {}
    guarded = 0
    waits = []
    for label in ("off", "on"):
        with env_set(NOMAD_TPU_SUPERVISOR="1" if label == "on" else "0"):
            server = new_server(batch_pipeline=True)
            try:
                server.workers[0].warm_shapes()
                sup = server.device_supervisor
                live = sup.expected
                calls = [0]
                wait = [0.0]
                guard = sup.guard

                def counted(stage, fn, eval_id=None):
                    calls[0] += 1
                    own = [0.0]

                    def timed():
                        t = time.perf_counter()
                        try:
                            return fn()
                        finally:
                            own[0] = time.perf_counter() - t

                    t = time.perf_counter()
                    try:
                        return guard(stage, timed, eval_id=eval_id)
                    finally:
                        wait[0] += time.perf_counter() - t - own[0]

                sup.guard = counted
                placements, _, dt, placed = drive_server(
                    server, server_stream(), f"supervisor {label}")
                trips = sup.watchdog_trips
                if label == "on":
                    guarded = calls[0]
                    waits.append(wait[0])
                    t0 = time.perf_counter()
                    for _ in range(1000):
                        guard("fetch", lambda: None)
                    guard_us = (time.perf_counter() - t0) * 1e3
            finally:
                server.stop()
            del server, sup, guard, counted
        check(live == (label == "on"), f"supervisor {label}: live={live}")
        check(trips == 0, f"supervisor {label}: {trips} watchdog trips")
        check(placed_by.setdefault(label, placements) == placements
              and placements == placed_by["off"],
              "the supervisor changed phase 8's placements")
        rates[label] = placed / dt
    out["rate_off"] = rates["off"]
    out["rate_on"] = rates["on"]
    out["guard_us"] = guard_us
    out["guard_wait_s"] = waits
    print(f"device (2) the guard's cost on {card}: {SERVER_JOBS} jobs off "
          f"{out['rate_off']:.1f}, on {out['rate_on']:.1f} placements/s; "
          f"{guarded} guarded stage calls in a run, "
          f"time in the guard beyond the stages' own (the handoffs) "
          + ", ".join(f"{w:.4f}" for w in waits)
          + f" s a run; one guarded no-op stage alone {guard_us:.1f} us "
          f"(host clock, 1000 calls); placements equal", flush=True)

    # (3) flaky:3: LOST and back, jobs held in the broker meanwhile
    with env_set(NOMAD_TPU_FAULT="flaky:3", NOMAD_TPU_PROBE_INTERVAL_S="1.0",
                 NOMAD_TPU_LOST_PROBES="2", NOMAD_TPU_RECOVER_CANARIES="3"):
        tcanary.canary_cuda.launches = 0
        server, sup = _supervised_server()
        try:
            worker = server.workers[0]
            check(wait_for(lambda: sup.state() == LOST, 15.0),
                  f"flaky:3 never reached LOST ({sup.state()})")
            t_lost = time.monotonic()
            for job in jobs:
                server.register_job(job)
            held = sup.holding()
            time.sleep(0.2)
            ready = server.broker.ready_count()
            placed_while_lost = sum(
                len(server.store.allocs_by_job("default", j.id)) for j in jobs)
            check(held and sup.holding(),
                  "the supervisor left LOST/RECOVERING while the jobs were registered")
            check(ready == len(jobs) and placed_while_lost == 0,
                  f"held jobs left the broker: {ready} ready, {placed_while_lost} placed")
            # HEALTHY is set before the restore's listeners flush; the
            # hold clears after them, and only then may drain_to_idle run
            check(wait_for(lambda: sup.state() == HEALTHY
                           and not sup.holding(), 20.0),
                  f"flaky:3 never recovered ({sup.state()})")
            resume_s = time.monotonic() - t_lost
            prescored0 = worker.prescored
            ok = server.drain_to_idle(600.0)
            history = [h["to"] for h in sup.status()["history"]]
            stats = dict(prescored=worker.prescored - prescored0, errors=worker.errors,
                         delivery_failures=server.broker.stats["delivery_failures"])
            k8_after = tcanary.canary_cuda.launches
            flaky = {job.id: sorted(
                (a.name, a.node_id)
                for a in server.store.allocs_by_job("default", job.id)
                if not a.terminal_status()) for job in jobs}
        finally:
            server.stop()
        del server, sup, worker
    check(ok, "the flaky Server did not drain after the flip")
    check(history == [DEGRADED, LOST, RECOVERING, HEALTHY],
          f"flaky:3 walked {history}")
    check(stats["prescored"] > 0 and stats["errors"] == 0
          and stats["delivery_failures"] == 0, f"flaky:3 after the flip: {stats}")
    check(k8_after >= 3, f"K8 launched {k8_after} times in the recovery, not 3")
    diff = [j for j in on_cpu if flaky.get(j) != on_cpu[j]]
    check(not diff, f"the held jobs' placements differ from the CPU Server's at "
          f"{diff[:3]}: {[flaky.get(j) for j in diff[:1]]} vs "
          f"{[on_cpu[j] for j in diff[:1]]}")
    out["resume_s"] = resume_s
    print(f"device (3) flaky:3 on {card}: {' -> '.join(['HEALTHY'] + history)}; "
          f"{len(jobs)} jobs registered while LOST stayed in the broker, placed "
          f"on the card after the flip ({stats['prescored']} prescored, "
          f"{resume_s:.2f} s from LOST to HEALTHY, K8 launches {k8_after}), equal "
          f"to the CPU Server's; delivery failures 0", flush=True)

    # (4) wedge_launch at a 0.5 s budget
    with env_set(NOMAD_TPU_FAULT="wedge_launch", NOMAD_TPU_WATCHDOG_MIN_S="0.5",
                 NOMAD_TPU_WATCHDOG_MAX_S="0.5", NOMAD_TPU_INIT_GRACE_S="0.5",
                 NOMAD_TPU_PROBE_INTERVAL_S="60"):
        server, sup = _supervised_server()
        stopped = False
        try:
            t0 = time.monotonic()
            wall0 = time.time()
            for job in jobs:
                server.register_job(job)
            raised = None
            try:
                server.drain_to_idle(10.0)
            except Exception as exc:  # noqa: BLE001 — judged below
                raised = exc
            detect_s = time.monotonic() - t0
            state = sup.state()
            lost_at = next((h["at"] for h in sup.status()["history"]
                            if h["to"] == LOST), None)
            check(isinstance(raised, DeviceTimeout),
                  f"wedge_launch: drain_to_idle raised {raised!r}, not DeviceTimeout")
            check(raised.stage == "launch", f"the wedge tripped {raised.stage}, not launch")
            check(detect_s < 10.0, f"the wedge took {detect_s:.2f} s to raise")
            check(state == LOST, f"after the wedge the state is {state}")
            # the supervisor holds (LOST) on the watchdog's thread, so
            # drain_to_idle may raise before the worker's thread, met by
            # the same trip, has nacked its gulp: wait for its leases
            # (bounded) before judging them
            wait_for(lambda: server.broker.stats["total_unacked"] == 0, 5.0)
            _no_eval_lost(server, jobs, "wedge_launch")
            t1 = time.monotonic()
            server.stop()
            stopped = True
            stop_s = time.monotonic() - t1
        finally:
            if not stopped:
                server.stop()
    check(stop_s < 5.0, f"stop() took {stop_s:.2f} s after the wedge")
    out["detect_s"] = detect_s
    print(f"device (4) wedge_launch on {card}: DeviceTimeout naming launch "
          f"{detect_s:.3f} s after the first register (LOST at "
          f"{lost_at - wall0:.3f} s), state LOST, every eval complete or back "
          f"in the broker, stop() in {stop_s:.3f} s", flush=True)

    # (5) the preflight in a process of its own
    env = dict(os.environ, PYTHONPATH=str(HERE))
    proc = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.device.preflight",
         "--budget-s", "60"],
        cwd=str(HERE), env=env, capture_output=True, text=True, timeout=180)
    line = next((l for l in proc.stdout.splitlines()
                 if l.startswith("DEVICE_PREFLIGHT ")), None)
    check(line is not None, f"the preflight printed no state line: {proc.stderr[-500:]}")
    verdict = json.loads(line.split(" ", 1)[1])
    check(proc.returncode == 0 and verdict["state"] == HEALTHY,
          f"the preflight said {verdict} (exit {proc.returncode})")
    print(f"device (5) preflight: {line} (exit 0)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5: timings at the main path's shapes
# ---------------------------------------------------------------------------


def device_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    from nomad_tpu_torch.device.core import nvidia_smi_line

    return nvidia_smi_line() or "nvidia-smi unavailable"


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


def cuda_time_once(fn):
    """One call of `fn` timed with CUDA events: (its result, ms)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_kernels(cuda) -> dict:
    """K1 at the count-1 select's shape (16,384-row arena, 10,000
    candidates, limit 14 = ceil(log2 10,000)) and at a weighted select's
    (both policy groups, unlimited walk); K2 at the count-10
    look-ahead's (the same arena, P = pow2_bucket(10) = 16); K5 on the
    dogpile unweighted and weighted."""
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import batch_case, score_case
    from nomad_tpu_torch.state.convert import (
        batch_inputs_from_numpy,
        score_inputs_from_numpy,
    )

    saved = (tscore.score_select_cuda.launches, tbatch.plan_picks_cuda.launches,
             tbatch.chained_picks_cuda.launches, tbatch.patch_rows_cuda.launches,
             tscore.walk_only_cuda.launches)
    k1 = score_inputs_from_numpy(
        score_case(7000, C_CHECK, N_CAND_CHECK, "mixed", 14), cuda
    )
    cols, inp = batch_case(7001, C_CHECK, N_CAND_CHECK, "plain", 14, 16)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in cols.items()}
    k2 = (t["cpu_total"], t["mem_total"], t["disk_total"],
          batch_inputs_from_numpy(inp, cuda), N_CAND_CHECK, 16, False)
    # the operations count the candidates the walks reach (their
    # pulls in this run), not every candidate: the walks stop early
    k1_pulls = int(tscore.score_select_cuda(k1).out_i[1])
    k2_pulls = int(tbatch.plan_picks_cuda(*k2)[1].sum())
    # the picks walk on from where the last stopped: the positions they
    # reach are the first k2_pulls of the rotation, at most the region
    k2_reached = min(k2_pulls, N_CAND_CHECK)
    out = {
        "score_select": {
            # as the stack's packed select launches it (no feasible count)
            "ms": cuda_time_ms(
                lambda: tscore.score_select_cuda(k1, count=False)),
            "plain_ms": cuda_time_ms(lambda: tscore.score_and_select_twin(k1),
                                     n=200, warmup=3),
            # the positions the walk must reach (its pulls): each one's
            # perm entry and row (eight f64 columns, feasibility and
            # penalty bytes, collisions int32) read once, 16 bytes
            # written
            "bytes": k1_pulls * (4 + 8 * 8 + 2 * 1 + 4) + 16,
            "pulls": k1_pulls,
            "flops": k1_pulls * FLOPS_PER_CANDIDATE,
        },
        "plan_picks": {
            "ms": cuda_time_ms(lambda: tbatch.plan_picks_cuda(*k2)),
            "plain_ms": cuda_time_ms(
                lambda: tbatch.run_picks(*k2), n=20, warmup=2
            ),
            # the reached positions' perm entries and rows (six columns,
            # affinity, feasibility, penalty, collisions) read once and
            # the [2, P] result written
            "bytes": k2_reached * (7 * 8 + 2 * 1 + 2 * 4) + 2 * 16 * 4,
            "pulls": k2_pulls,
            "flops": k2_pulls * FLOPS_PER_CANDIDATE,
        },
    }
    out["score_select_policy"] = time_policy_select(cuda)
    out.update(time_chain_kernels(cuda))
    from nomad_tpu_torch.ops import solve as tsolve

    saved_k5 = tsolve.storm_assignment_cuda.launches
    out["storm_solve"] = time_storm_kernel(cuda)
    out["storm_solve_policy"] = time_storm_kernel(cuda, policy=True)
    tsolve.storm_assignment_cuda.launches = saved_k5
    out["walk_only"] = time_walk_kernel(cuda)
    out["batch_picks"] = time_batch_kernel(cuda)
    out["canary"] = time_canary_kernel(cuda)
    (tscore.score_select_cuda.launches, tbatch.plan_picks_cuda.launches,
     tbatch.chained_picks_cuda.launches, tbatch.patch_rows_cuda.launches,
     tscore.walk_only_cuda.launches) = saved
    out.update(time_batched_kernels(cuda))
    out.update(time_sharded_kernels(cuda))
    out.update(time_storm_sharded(cuda))
    out.update(time_entry_programs(cuda))
    out["patch_rows_hostlocal"] = time_hostlocal_kernel(cuda)
    for v in list(out.values()) + [out["patch_rows_hostlocal"]["flush3"]]:
        v.setdefault("library_ms", None)
        _bound(v)
    print("timing shapes (bytes, walk reach in pulls, auction rounds, operations, "
          "bound ms): "
          + "; ".join(f"{k} {v['bytes']} B, {v.get('pulls', 0)} pulls, "
                      f"{v.get('rounds', 0)} rounds, "
                      f"{v['flops']} ops, {v['bound_ms']:.9f} ({v['bound_by']})"
                      for k, v in out.items()), flush=True)
    rows = []
    for k in ("chained_plan_picks", "chained_plan_picks_shared",
              "batch_plan_picks", "score_all", "score_all_policy"):
        for v in (out[k], out[k].get("arena16k")):
            if v is not None:
                rows.append(
                    f"{k} ({v.get('shape', 'select')}) {v['ms']:.6f} ms, twin "
                    f"{v['plain_ms']:.6f} ms, bound {v['bound_ms']:.9f} ms "
                    f"({v['bound_by']}; {v['bytes']} B, {v['pulls']} pulls)")
    print("K9-K11 timing (f64, CUDA events): " + "; ".join(rows), flush=True)
    print(f"K12 timing (f64, CUDA events; D shards of a VirtualMesh on "
          f"one card, not multi-GPU scaling) on {device_line()}: " + "; ".join(
              f"{k} ({v['shape']}) {v['ms']:.6f} ms, twin {v['plain_ms']:.6f} ms, "
              f"bound {v['bound_ms']:.9f} ms ({v['bound_by']}; {v['bytes']} B)"
              f", {v['launches_per_chunk']} launch(es) a timed chunk, a "
              f"grid of {v['blocks']} blocks"
              for k, v in out.items() if k.startswith("sharded_chained_plan_d")),
          flush=True)
    k4, k8 = out["patch_rows"], out["canary"]
    print(f"K4/K8 timing (f64, CUDA events; the launch as the path makes it, "
          f"bound once) on {device_line()}: K4 ({k4['shape']}) {k4['ms']:.6f} ms, "
          f"checked call {k4['call_ms']:.6f} ms, per-call entry point "
          f"{k4['wrapper_ms']:.6f} ms, twin {k4['plain_ms']:.6f} ms, index_copy_ "
          f"{k4['library_ms']:.6f} ms, bound {k4['bound_ms']:.9f} ms; the "
          f"mirror's flush ({out['patch_rows_flush3']['shape']}) one launch "
          f"{out['patch_rows_flush3']['ms']:.6f} ms, checked call "
          f"{out['patch_rows_flush3']['call_ms']:.6f} ms, 3 x index_copy_ "
          f"{out['patch_rows_flush3']['library_ms']:.6f} ms, on the host clock "
          f"(staging, copy, launch, synchronize) "
          f"{out['patch_rows_flush3']['flush_host_ms']:.6f} ms; K8 (ones(8)) "
          f"bound probe launch {k8['ms']:.6f} ms, per-call entry point "
          f"{k8['call_ms']:.6f} ms, twin {k8['plain_ms']:.6f} ms, "
          f"torch.add(a, 1).sum() {k8['library_ms']:.6f} ms, bound "
          f"{k8['bound_ms']:.9f} ms; the probe on the host clock (reset, "
          f"launch, event wait, read) {k8['probe_host_ms']:.6f} ms", flush=True)
    k15 = out["patch_rows_hostlocal"]
    print(f"K13/K15 timing (f64, CUDA events; one launch a call as a flush "
          f"launches it, bound once; index_copy_ the calls a plain port would make) "
          f"on {device_line()}: " + "; ".join(
              f"{k} ({v['shape']}) {v['ms']:.6f} ms, checked call "
              f"{v['call_ms']:.6f} ms"
              + (f", per-call entry point {v['wrapper_ms']:.6f} ms, twin "
                 f"{v['plain_ms']:.6f} ms" if "wrapper_ms" in v else "")
              + f", {v.get('library_calls', 1)} x index_copy_ "
              f"{v['library_ms']:.6f} ms, bound {v['bound_ms']:.9f} ms "
              f"({v['bound_by']}; {v['bytes']} B)"
              + (f"; the flush as the worker runs it (host clock, staging, "
                 f"copy and synchronize) {v['flush_host_ms']:.6f} ms"
                 if "flush_host_ms" in v else "")
              for k, v in (("patch_rows_sharded_d1", out["patch_rows_sharded_d1"]),
                           ("patch_rows_sharded_d8", out["patch_rows_sharded_d8"]),
                           ("patch_rows_sharded_flush3",
                            out["patch_rows_sharded_flush3"]),
                           ("patch_rows_hostlocal", k15),
                           ("patch_rows_hostlocal_flush3", k15["flush3"]))),
          flush=True)
    print(f"K14 timing (f64, CUDA events, the storm path's problem; D shards "
          f"of a VirtualMesh on one card) on {device_line()}: " + "; ".join(
              f"{k} ({v['shape']}, {v['rounds']} rounds, "
              f"{v['launches_per_solve']} launches, one cooperative auction of "
              f"{v['blocks']} blocks) {v['ms']:.6f} ms, twin "
              f"{v['plain_ms']:.6f} ms, bound {v['bound_ms']:.9f} ms "
              f"({v['bound_by']}; {v['bytes']} B, {v['flops']} ops); stamps "
              f"{_stamps_line(v['stamps'])}"
              for k, v in out.items() if k.startswith("storm_assignment_sharded")),
          flush=True)
    print(f"K5 timing (f64, CUDA events) on {device_line()}: " + "; ".join(
        f"{k} ({v['rounds']} rounds, one cooperative auction of {v['blocks']} "
        f"blocks) {v['ms']:.6f} ms, twin {v['plain_ms']:.6f} ms, bound "
        f"{v['bound_ms']:.9f} ms; stamps {_stamps_line(v['stamps'])}"
        for k, v in (("dogpile", out["storm_solve"]),
                     ("weighted dogpile", out["storm_solve_policy"]))),
          flush=True)
    # the kernels line's entries: one card shard (D = 1), eight beside
    for name in ("sharded_chained_plan", "patch_rows_sharded",
                 "storm_assignment_sharded"):
        out[name] = dict(out[f"{name}_d1"], d8=out[f"{name}_d8"])
    out["patch_rows_sharded"]["flush3"] = out["patch_rows_sharded_flush3"]
    out["patch_rows"]["flush3"] = out["patch_rows_flush3"]
    print("policy timing (f64, CUDA events): "
          + "; ".join(
              f"{k} {out[k]['ms']:.6f} ms (policy off {out[base]['ms']:.6f}), "
              f"twin {out[k]['plain_ms']:.6f} ms, bound "
              f"{out[k]['bound_ms']:.9f} ms ({out[k]['bound_by']})"
              + (f", {out[k]['rounds']} rounds" if "rounds" in out[k] else "")
              for k, base in (("score_select_policy", "score_select"),
                              ("storm_solve_policy", "storm_solve"))),
          flush=True)
    return out


def time_policy_select(cuda) -> dict:
    """K1 at the policy select's shape: the 16,384-row arena with 10,000
    candidates, f64, both policy groups (`policy_score_case` "both") and
    the unlimited walk (limit INT32_MAX) a weighted job takes."""
    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import INT32_MAX, policy_score_case
    from nomad_tpu_torch.state.convert import score_inputs_from_numpy

    k1 = score_inputs_from_numpy(
        policy_score_case(7002, C_CHECK, N_CAND_CHECK, "both", INT32_MAX),
        cuda)
    pulls = int(tscore.score_select_cuda(k1).out_i[1])
    return {
        # as the stack's packed select launches it (the grid, by K1's rule)
        "ms": cuda_time_ms(lambda: tscore.score_select_cuda(k1, count=False)),
        "plain_ms": cuda_time_ms(lambda: tscore.score_and_select_twin(k1),
                                 n=200, warmup=3),
        # every input column read once (all C walk positions: eight f64
        # columns and the two policy columns, two byte masks, two int32
        # columns) and 16 bytes written
        "bytes": C_CHECK * (10 * 8 + 2 * 1 + 2 * 4) + 16,
        "pulls": pulls,
        "flops": pulls * FLOPS_PER_CANDIDATE,
    }


def time_walk_kernel(cuda) -> dict:
    """K6 at the preempt path's shape: the 16,384-row arena with 13,107
    candidates, f64, a spliced score vector (`walk_case` "spliced") and
    the service visit limit ceil(log2 10,000) = 14, as the preemption
    loop launches it (no feasible count): the prefix walk; and unlimited
    (a group with affinities, spreads or policy terms): the grid.
    Beside each the twin on the card.  The bound counts each input byte
    once at the positions the walk must reach (feasible, score and perm
    entry of its pulls; the grid all C) plus the 32-byte result, and two
    comparisons a position."""
    import torch

    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import INT32_MAX, walk_case

    out = {}
    for key, seed, limit in (("prefix", 9800, 14), ("grid", 9801, INT32_MAX)):
        case = walk_case(seed, C_CHECK, "spliced", limit)
        args = (torch.from_numpy(case["feasible"]).to(cuda),
                torch.from_numpy(case["scores"]).to(cuda),
                torch.from_numpy(case["perm"]).to(cuda), limit,
                case["n_candidates"])
        pulls = int(tscore.walk_only_cuda(*args, False)[2])
        check(tscore.walk_only_cuda.route == key,
              f"K6 timing: the {key} case took the {tscore.walk_only_cuda.route}")
        reached = pulls if key == "prefix" else C_CHECK
        out[key] = {
            "ms": cuda_time_ms(lambda: tscore.walk_only_cuda(*args, False)),
            "plain_ms": cuda_time_ms(
                lambda: tscore.limited_walk_argmax(*args), n=200, warmup=3),
            "bytes": reached * (1 + 8 + 4) + 32,
            "flops": 2 * reached,
            "pulls": pulls,
            "library_ms": None,
        }
    entry = out.pop("prefix")
    _bound(out["grid"])
    entry["grid"] = out["grid"]
    return entry


def time_canary_kernel(cuda) -> dict:
    """K8 at the canary's shape: ones(8) in f64.  The launch as the
    supervisor's probe makes it (`CanaryProbe`, bound once: its inputs,
    outputs and sum in mapped host memory, so the time includes the
    kernel's reads and writes across the bus), the checked per-call
    entry point on device tensors (`canary_cuda`, which allocates the
    outputs every call), the twin on the card and the one PyTorch call
    that computes the same sum (`torch.add(a, 1).sum()`).  Then the
    probe as the supervisor runs it, on the host clock (mean of 1,000:
    the sum reset, the launch, an event and its wait, the read).  The
    bound counts the 8 values read and the 8 values and the sum written
    (136 bytes) and 15 additions."""
    import torch

    from nomad_tpu_torch.ops import canary as tcanary

    saved = tcanary.canary_cuda.launches
    a = torch.ones(8, dtype=torch.float64, device=cuda)
    probe = tcanary.CanaryProbe(cuda)
    try:
        out = {
            "ms": cuda_time_ms(probe.launch),
            "call_ms": cuda_time_ms(lambda: tcanary.canary_cuda(a)),
            "plain_ms": cuda_time_ms(lambda: tcanary.canary_plain(a)),
            "library_ms": cuda_time_ms(lambda: torch.add(a, 1).sum()),
            "bytes": 8 * 8 + 8 * 8 + 8,
            "flops": 8 + 7,
            "shape": "n=8 f64",
        }
        for _ in range(20):
            probe.probe()
        reps = 1000
        t0 = time.perf_counter()
        answers = {probe.probe() for _ in range(reps)}
        out["probe_host_ms"] = (time.perf_counter() - t0) / reps * 1e3
    finally:
        probe.close()
    check(answers == {16.0}, f"the timed probes answered {answers}")
    tcanary.canary_cuda.launches = saved
    return out


def time_batch_kernel(cuda) -> dict:
    """K7 at the bridge phase's call shape: E = 64 evals of the `bridge`
    case (counts 1-10, so P = 10), 10,000 candidates of the 16,384-row
    arena, f64; beside it the twin on the card.  The walks reach, in
    this run, the positions of each eval's picks (their pulls, read from
    K2, which runs K7's pick body one eval at a time): the bound counts
    those perm entries, the rows they name (six columns and the
    feasibility byte, each row once over all evals), the per-eval asks,
    counts and limits once, and the [E, P] rows written; the operations
    count the pulls."""
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import batch_shared_case
    from nomad_tpu_torch.state.convert import (
        batch_inputs_from_numpy,
        batch_shared_inputs_from_numpy,
    )

    import numpy as np

    E, P, n = BRIDGE_E, 10, N_CAND_CHECK
    case = batch_shared_case(9200, C_CHECK, n, "bridge", E, P)
    kw = batch_shared_inputs_from_numpy(case, cuda)
    saved = tbatch.batch_plan_picks_shared_cuda.launches
    pulls = 0
    reached = 0  # perm entries the walks read
    rows = []  # the rows they name
    for k in range(E):
        inp = batch_inputs_from_numpy(dict(
            feasible=case["feasible"], base_cpu_used=case["base_cpu_used"],
            base_mem_used=case["base_mem_used"],
            base_disk_used=case["base_disk_used"],
            base_collisions=np.zeros(C_CHECK, np.int32),
            penalty=np.zeros(C_CHECK, bool),
            affinity_score=np.zeros(C_CHECK), perm=case["perms"][k],
            ask_cpu=case["ask_cpu"][k], ask_mem=case["ask_mem"][k],
            ask_disk=case["ask_disk"][k],
            desired_count=case["desired_count"][k], limit=case["limit"][k],
            distinct_hosts=False,
        ), cuda)
        eval_pulls = int(tbatch.plan_picks_cuda(
            kw["cpu_total"], kw["mem_total"], kw["disk_total"], inp, n, P
        )[1].sum())
        pulls += eval_pulls
        # the picks walk on from where the last stopped
        reached += min(eval_pulls, n)
        rows.append(case["perms"][k][:min(eval_pulls, n)])
    n_rows = len(np.unique(np.concatenate(rows)))
    out = {
        "ms": cuda_time_ms(lambda: tbatch.batch_plan_picks_shared_cuda(**kw),
                           n=200, warmup=5),
        "plain_ms": cuda_time_ms(
            lambda: tbatch.batch_plan_picks_shared_twin(**kw), n=20, warmup=2
        ),
        "bytes": (n_rows * (6 * 8 + 1) + reached * 4 + E * (3 * 8 + 2 * 4)
                  + E * P * 4),
        "pulls": pulls,
        "flops": pulls * FLOPS_PER_CANDIDATE,
        "library_ms": None,
    }
    tbatch.batch_plan_picks_shared_cuda.launches = saved
    return out


def _batched_on_cpu(args) -> tuple:
    """`chained_plan_picks` arguments with every tensor moved to the
    CPU (the twin's f64 run there)."""
    import torch

    return tuple(
        a.cpu() if isinstance(a, torch.Tensor)
        else type(a)(*[f.cpu() for f in a]) if isinstance(a, tuple) else a
        for a in args)


def _candidate_bytes(q, per_node: int, per_row: int, pulls=None) -> int:
    """Bytes of a K9/K10 launch's candidate region: `per_node` bytes at
    each arena row that some eval's first n_cand walk positions hold
    (the node columns), `per_row` bytes at each eval's own n_cand
    positions (its per-eval columns and perm), and each eval's scalars
    (three asks, count, limit, distinct_hosts) and its P rows written.
    The tail past n_cand carries no set entries and is not read.  With
    the launch's [E, P] `pulls`, only the positions its picks reach
    count: eval e's walks cover the first min(sum of its pulls, n_cand)
    positions of its walk order."""
    import torch

    n = q["n_cand"].tolist()
    if pulls is not None:
        n = [min(int(r), c) for r, c in zip(pulls.sum(dim=1).tolist(), n)]
    perm = q["batch"].perm
    union = torch.unique(torch.cat(
        [perm[e, :n[e]] for e in range(q["E"])])).numel()
    return (union * per_node + sum(n) * per_row
            + q["E"] * (3 * 8 + 2 * 4 + 1 + q["P"] * 4))


def _time_k9_k10(args, label: str) -> dict:
    """K9 and K10 over one set of `chained_plan_picks` arguments (f64):
    first each kernel's rows held bit-equal to its twin on the card and
    on the CPU (and K9's pulls to its twin's), then both timed beside
    their twins on the card.  The bound's bytes count the candidate
    region (`_candidate_bytes`); its operations the walk positions the
    picks reach in this run, the pulls each kernel writes.  Kernels and
    twins are timed over the prepared inputs, without the wrappers'
    checks; a twin's time is that of its one call on the card."""
    import torch

    from nomad_tpu_torch.ops import batch as tbatch

    q = tbatch.prepare_batched(*args)
    cpu_args = _batched_on_cpu(args)
    k9_rows, k9_pulls = (t.cpu() for t in tbatch.launch_chained_plan(q))
    # each twin's one timed call on the card is also its check there
    k9_twin, k9_plain_ms = cuda_time_once(
        lambda: tbatch.chained_picks_twin(tbatch.batched_as_chain(q)))
    twin_rows, twin_pulls = k9_twin[:2]
    check(torch.equal(k9_rows, twin_rows.cpu()),
          f"K9 at the {label} shape: kernel != twin on card")
    check(torch.equal(k9_pulls, twin_pulls.cpu()),
          f"K9 at the {label} shape: pulls != twin's on card")
    check(torch.equal(k9_rows, tbatch.chained_plan_picks(*cpu_args)),
          f"K9 at the {label} shape: kernel != twin on CPU")
    k10_rows, k10_pulls = (t.cpu() for t in tbatch.launch_batch_plan(q))
    k10_twin, k10_plain_ms = cuda_time_once(lambda: tbatch.batch_plan_twin(q))
    check(torch.equal(k10_rows, k10_twin[0].cpu()),
          f"K10 at the {label} shape: kernel != twin on card")
    check(torch.equal(k10_pulls, k10_twin[1].cpu()),
          f"K10 at the {label} shape: pulls != twin's on card")
    check(torch.equal(k10_rows, tbatch.batch_plan_picks(*cpu_args)),
          f"K10 at the {label} shape: kernel != twin on CPU")
    print(f"K9/K10 at the {label} shape: rows bit-equal to the twins on "
          f"the card and the CPU ({int((k9_rows >= 0).sum())} / "
          f"{int((k10_rows >= 0).sum())} placed picks)", flush=True)
    # per candidate position: feasibility and penalty bytes, perm and
    # collisions int32, affinity f64
    per_row = 1 + 1 + 4 + 4 + 8
    k9_reach = int(k9_pulls.sum())
    k10_reach = int(k10_pulls.sum())
    return {
        "chained_plan_picks": {
            "ms": cuda_time_ms(lambda: tbatch.launch_chained_plan(q),
                               n=50, warmup=3),
            "plain_ms": k9_plain_ms,
            # at the rows its picks reach: totals and eval 0's base usage
            # (the chain reads no other row)
            "bytes": _candidate_bytes(q, 6 * 8, per_row, k9_pulls),
            "pulls": k9_reach,
            "flops": k9_reach * FLOPS_PER_CANDIDATE,
            "shape": label,
        },
        "batch_plan_picks": {
            "ms": cuda_time_ms(lambda: tbatch.launch_batch_plan(q),
                               n=50, warmup=3),
            "plain_ms": k10_plain_ms,
            # at the rows its picks reach: totals, and every eval's own
            # base usage
            "bytes": _candidate_bytes(q, 3 * 8, per_row + 3 * 8, k10_pulls),
            "pulls": k10_reach,
            "flops": k10_reach * FLOPS_PER_CANDIDATE,
            "shape": label,
        },
        "rows": (k9_rows, k9_pulls),
    }


def time_batched_kernels(cuda) -> dict:
    """K9, K9 shared and K10 at the benchmark's kernel-only shape (its
    2,000-node world: a 2,048-row arena, 2,000 candidates, E = 64 evals
    of P = 10 picks, the bench's own inputs and walk orders), K9 and K10
    also at the 16,384-row arena (a `batched_case` "plain" of 10,000
    candidates, E = 64, P = 10); K11 at K1's select shape (16,384 rows,
    `score_case` "mixed") and with both policy groups.  K9 and K10 are
    held bit-equal to their twins on the card and the CPU at both shapes
    first, K9 shared at the bench's.  Each is timed beside its twin on
    the card; no single PyTorch call computes any of them."""
    import numpy as np
    import torch

    from nomad_tpu_torch import bench as tbench
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import batched_case, policy_score_case, score_case
    from nomad_tpu_torch.state.convert import (
        batched_case_to_torch,
        score_inputs_from_numpy,
    )

    saved = (tbatch.chained_plan_picks_cuda.launches,
             tbatch.chained_plan_picks_shared_cuda.launches,
             tbatch.batch_plan_picks_cuda.launches,
             tscore.score_all_cuda.launches)
    f8 = 8
    E = 64
    world = tbench.kernel_world(2000)
    inp = tbench.kernel_inputs(world, E)
    cols = [torch.from_numpy(np.ascontiguousarray(c)).to(cuda)
            for c in inp["cols"]]
    perms = tbench.kernel_perms(world, list(range(E)))
    batch = tbatch.prepare_batched(
        *cols, tbatch.BatchInputs(perm=perms, **inp["shared"]),
        inp["n_cand"], tbench.TG_COUNT)["batch"]
    bench_args = (*cols, batch, inp["n_cand"], tbench.TG_COUNT)
    out = _time_k9_k10(bench_args, "bench")
    k9_rows, k9_pulls = out.pop("rows")
    b = batch
    shared = dict(
        cpu_total=cols[0], mem_total=cols[1], disk_total=cols[2],
        feasible=b.feasible[0].contiguous(),
        base_cpu_used=b.base_cpu_used[0].contiguous(),
        base_mem_used=b.base_mem_used[0].contiguous(),
        base_disk_used=b.base_disk_used[0].contiguous(), perms=b.perm,
        ask_cpu=b.ask_cpu, ask_mem=b.ask_mem, ask_disk=b.ask_disk,
        desired_count=b.desired_count, limit=b.limit,
        n_candidates=inp["n_cand"], n_picks=tbench.TG_COUNT,
    )
    # every eval wants its count, P = 10: the same walks as K9's
    rows = tbatch.chained_plan_picks_shared_cuda(**shared).cpu()
    twin, shared_plain_ms = cuda_time_once(
        lambda: tbatch.chained_plan_picks_shared_twin(**shared))
    check(torch.equal(rows, twin.cpu()),
          "K9 shared at the bench shape: kernel != twin on card")
    check(torch.equal(rows, tbatch.chained_plan_picks_shared(
        **{k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in shared.items()})),
          "K9 shared at the bench shape: kernel != twin on CPU")
    check(torch.equal(rows, k9_rows),
          "K9 shared at the bench shape: rows != K9's per-eval rows")
    out["chained_plan_picks_shared"] = {
        "ms": cuda_time_ms(
            lambda: tbatch.chained_plan_picks_shared_cuda(**shared),
            n=50, warmup=3),
        "plain_ms": shared_plain_ms,
        # at the rows the picks reach: totals, usage and the feasibility
        # byte once; each eval's reached perm entries, scalars and rows
        "bytes": _candidate_bytes(
            tbatch.prepare_batched(*bench_args), 6 * f8 + 1, 4, k9_pulls),
        "pulls": out["chained_plan_picks"]["pulls"],
        "flops": out["chained_plan_picks"]["flops"],
        "shape": "bench",
    }
    cols16, kw16 = batched_case(9600, C_CHECK, N_CAND_CHECK, "plain", E, 10)
    args16, _kw = batched_case_to_torch(cols16, kw16, cuda)
    timed16 = _time_k9_k10(args16, "arena16k")
    timed16.pop("rows")
    for name, entry in timed16.items():
        out[name]["arena16k"] = entry
    for key, case in (
            ("score_all", score_case(7000, C_CHECK, N_CAND_CHECK, "mixed", 14)),
            ("score_all_policy", policy_score_case(
                7002, C_CHECK, N_CAND_CHECK, "both", 14))):
        k11 = score_inputs_from_numpy(case, cuda)
        n_cols = 10 if key == "score_all_policy" else 8
        out[key] = {
            "ms": cuda_time_ms(lambda: tscore.score_all_cuda(k11)),
            "plain_ms": cuda_time_ms(lambda: tscore.score_all_twin(k11),
                                     n=200, warmup=3),
            # every column read once (f64 columns, feasibility and
            # penalty bytes, collisions int32; perm is not read) and a
            # byte and a score written a node
            "bytes": C_CHECK * (n_cols * f8 + 2 + 4) + C_CHECK * (1 + f8),
            "pulls": C_CHECK,
            "flops": C_CHECK * FLOPS_PER_CANDIDATE,
        }
    (tbatch.chained_plan_picks_cuda.launches,
     tbatch.chained_plan_picks_shared_cuda.launches,
     tbatch.batch_plan_picks_cuda.launches,
     tscore.score_all_cuda.launches) = saved
    for v in list(out.values()):
        v["library_ms"] = None
        if "arena16k" in v:
            _bound(v["arena16k"])
    return out


def _bound(v: dict) -> None:
    """The least time of an entry: bytes over the card's memory rate or
    operations over its f64 rate, whichever is larger."""
    t_bytes = v["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = v["flops"] / F64_FLOPS * 1e3  # every timed launch is f64
    v["bound_ms"] = max(t_bytes, t_ops)
    v["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def time_chain_kernels(cuda) -> dict:
    """K3 at the batched main path's launch shape: one chunk of the
    widest bucket (E = 8) with P = 16 picks over the 16,384-row arena
    and 10,000 candidates; K4 at W = 128 staged rows (the pow2 bucket
    of one such chunk's 80 placements) into a 16,384-row column, beside
    `index_copy_` of the valid prefix (the nearest single PyTorch
    call): the launch as the mirror's flush makes it (bound once,
    unchecked), the bound patch's checked call and the per-column entry
    point, which binds on every call; then the three-column flush
    (`time_mirror_flush`)."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import chain_case
    from nomad_tpu_torch.state.convert import chain_case_to_torch

    E, P = 8, 16
    cols, kw = chain_case(9000, C_CHECK, N_CAND_CHECK, "plain", E, P)
    args, kwargs = chain_case_to_torch(cols, kw, cuda)
    prepared = tbatch.prepare_chain(*args, **kwargs)
    W = 128
    rng = np.random.default_rng(9001)
    n = 80
    idx = np.full(W, C_CHECK, np.int32)
    idx[:n] = np.sort(rng.choice(C_CHECK, n, replace=False))
    col = torch.from_numpy(rng.uniform(0.0, 1e4, C_CHECK)).to(cuda)
    idx_t = torch.from_numpy(idx).to(cuda)
    idx_valid = idx_t[:n].long()
    vals = torch.from_numpy(rng.uniform(0.0, 1e4, W)).to(cuda)
    vals_valid = vals[:n].contiguous()
    vals1 = vals.unsqueeze(0)
    patch = tbatch.RowPatch(None, (col,))
    ptrs = (idx_t.data_ptr(), vals1.data_ptr(), W)
    f8 = 8
    k3_pulls = int(tbatch.chained_picks_cuda(prepared)[1].sum())
    return {
        "chained_picks": {
            # ~2-8 ms a launch, the twin ~50-200x that: 100 and 10 launches
            "ms": cuda_time_ms(lambda: tbatch.chained_picks_cuda(prepared),
                               n=100, warmup=5),
            "blocks": tbatch.chained_picks_cuda.blocks,
            "plain_ms": cuda_time_ms(
                lambda: tbatch.chained_picks_twin(prepared), n=10, warmup=1
            ),
            # inputs read once: totals and usage (6 columns), the
            # feasibility bytes and walk order of every eval, the
            # per-pick asks/counts/limits, the collision and affinity
            # bases; outputs written once: usage carry-out and rows/pulls
            "bytes": (6 * C_CHECK * f8 + E * C_CHECK * (1 + 4)
                      + E * P * (3 * f8 + 3 * 4) + E * C_CHECK * (4 + f8)
                      + 3 * C_CHECK * f8 + 2 * E * P * 4),
            # the candidates the E x P walks reach in this run
            "pulls": k3_pulls,
            "flops": k3_pulls * FLOPS_PER_CANDIDATE,
            "library_ms": None,
        },
        "patch_rows": {
            # the launch as a flush makes it: bound once, the staging's
            # addresses and width
            "ms": cuda_time_ms(lambda: patch.launch(*ptrs)),
            # the bound patch's checked call on staging tensors
            "call_ms": cuda_time_ms(lambda: patch(idx_t, vals1)),
            # the per-column entry point, which binds on every call
            "wrapper_ms": cuda_time_ms(
                lambda: tbatch.patch_rows_cuda(col, idx_t, vals)),
            "plain_ms": cuda_time_ms(
                lambda: tbatch.patch_rows_twin(col, idx_t, vals)
            ),
            "library_ms": cuda_time_ms(
                lambda: col.index_copy_(0, idx_valid, vals_valid)
            ),
            # idx and vals read once, the valid rows written once
            "bytes": W * (4 + f8) + n * f8,
            "flops": 0,
            "shape": f"W={W} C={C_CHECK}",
        },
        "patch_rows_flush3": time_mirror_flush(cuda, W, n),
    }


def time_mirror_flush(cuda, W: int, n: int) -> dict:
    """The unsharded mirror's three-column delta flush at the main path's
    shape (n dirty rows of the 16,384-row arena, W their pow2 bucket),
    into three [C] columns.  Kernel only (CUDA events): one launch of a
    bound `RowPatch` over the plain columns beside the three
    `index_copy_` calls a plain port would make.  Then the flush as the
    worker runs it (host clock, mean of 200): from the sorted dirty rows
    and their values to a synchronized patched mirror, staging and copy
    included."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch

    saved = (tbatch.patch_rows_cuda.launches, tbatch.RowPatch.flushes,
             tbatch.RowPatch.copies)
    rng = np.random.default_rng(9004)
    C = C_CHECK
    rows = np.sort(rng.choice(C, n, replace=False)).astype(np.int32)
    cols = tuple(torch.from_numpy(rng.uniform(0.0, 1e4, C)).to(cuda)
                 for _ in range(3))
    vals = rng.uniform(0.0, 1e4, (3, n))
    patch = tbatch.RowPatch(None, cols)
    idx = np.full(W, C, np.int32)
    idx[:n] = rows
    v = np.zeros((3, W))
    v[:, :n] = vals
    idx_t = torch.from_numpy(idx).to(cuda)
    v_t = torch.from_numpy(v).to(cuda)
    lib_idx = torch.from_numpy(rows.astype(np.int64)).to(cuda)
    lib_vals = torch.from_numpy(vals).to(cuda)

    def library():
        for c, lv in zip(cols, lib_vals):
            c.index_copy_(0, lib_idx, lv)

    ptrs = (idx_t.data_ptr(), v_t.data_ptr(), W)
    out = {
        "ms": cuda_time_ms(lambda: patch.launch(*ptrs), n=200),
        "call_ms": cuda_time_ms(lambda: patch(idx_t, v_t), n=200),
        "library_ms": cuda_time_ms(library, n=200),
        "library_calls": 3,
        # the staged indices and the three value rows read once, the dirty
        # rows of the three columns written once
        "bytes": W * 4 + 3 * W * 8 + 3 * n * 8,
        "flops": 0,
        "shape": f"K=3 W={W} C={C} (unsharded, K4), {n} dirty rows",
    }
    row_vals = tuple(vals)
    before = (tbatch.patch_rows_cuda.launches, tbatch.RowPatch.flushes,
              tbatch.RowPatch.copies)
    for _ in range(20):
        patch.flush(rows, row_vals, C)
    torch.cuda.synchronize()
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        patch.flush(rows, row_vals, C)
        torch.cuda.synchronize()
    out["flush_host_ms"] = (time.perf_counter() - t0) / reps * 1e3
    steps = (tbatch.patch_rows_cuda.launches - before[0],
             tbatch.RowPatch.flushes - before[1],
             tbatch.RowPatch.copies - before[2])
    check(steps == (20 + reps,) * 3,
          f"the timed unsharded flushes were not one launch and one copy each: {steps}")
    for c, want in zip(cols, torch.from_numpy(vals)):
        check(bool((c.cpu()[torch.from_numpy(rows.astype(np.int64))] == want).all()),
              "the timed unsharded flush did not store its rows")
    (tbatch.patch_rows_cuda.launches, tbatch.RowPatch.flushes,
     tbatch.RowPatch.copies) = saved
    return out


# ---------------------------------------------------------------------------


# the phases that drive a path through the entry points a user calls
# ---------------------------------------------------------------------------
# phases k12/k13: the node-sharded chain and mirror patch
# ---------------------------------------------------------------------------

K12_COUNTS = (1, 2, 4, 8)  # phase k12's shard counts (a VirtualMesh on the card)
K12_SHAPE = (8, 16)  # its per-count cases' (E, P)
K12_FULL = (64, 10, 8)  # the full-width run's E, P and chunk width
K12_TIMING = (8, 10)  # the timed chunk's (E, P)


def _k12_case(scenario: str, E: int, P: int) -> dict:
    from nomad_tpu_torch.ops.cases import (
        SHARDED_CHAIN_SCENARIOS,
        sharded_chain_case,
    )

    si = SHARDED_CHAIN_SCENARIOS.index(scenario)
    return sharded_chain_case(9700 + 10 * si + E, C_CHECK, N_CAND_CHECK,
                              scenario, E, P)


def _k12_slice(args, e0: int, e1: int) -> tuple:
    """Evals [e0, e1) of the runner's per-eval arguments."""
    return tuple(_slice_evals(x, e0, e1) for x in args[6:])


def k12_run(mesh, plan, case, dtype, chunk=None) -> tuple:
    """(rows, pulls, (cpu, mem, disk) carry), all on the CPU, of one
    chain of `case` through `plan` (the dispatching runner or the twin)
    on `mesh`; with `chunk`, cut into launches of `chunk` evals with the
    carry threaded."""
    import torch

    from nomad_tpu_torch.state.convert import sharded_case_args

    args = sharded_case_args(case, mesh.device, dtype)
    E, P = case["deltas"]["evict_rows"].shape
    run = plan(mesh, P, with_spread=case["spread"] is not None,
               spread_even=case["spread_even"], return_carry=True)
    chunk = chunk or E
    carry, rows, pulls = args[3:6], [], []
    for e0 in range(0, E, chunk):
        r, p, carry = run(*args[:3], *carry, *_k12_slice(args, e0, e0 + chunk))
        rows.append(r.cpu())
        pulls.append(p.cpu())
    return (torch.cat(rows), torch.cat(pulls),
            tuple(mesh.unshard(c).cpu() for c in carry))


def k9_of(case, dev, dtype) -> tuple:
    """K9's (rows, pulls) on the card, or its twin's on the CPU, over a
    sharded chain case: the same inputs as per-eval BatchInputs (every
    eval's base usage the chain's start, no static penalty column)."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.state.convert import (
        batched_inputs_from_numpy,
        pre_deltas_from_numpy,
        spread_inputs_from_numpy,
        step_deltas_from_numpy,
    )

    pe, cols = case["per_eval"], case["cols"]
    E, C = pe["perm"].shape
    P = case["deltas"]["evict_rows"].shape[1]

    def rep(c):
        return np.broadcast_to(c, (E, C))

    batch = dict(
        feasible=pe["feasible"], base_cpu_used=rep(cols[3]),
        base_mem_used=rep(cols[4]), base_disk_used=rep(cols[5]),
        base_collisions=pe["coll0"], penalty=np.zeros((E, C), bool),
        affinity_score=pe["affinity"], perm=pe["perm"],
        ask_cpu=pe["ask_cpu"], ask_mem=pe["ask_mem"], ask_disk=pe["ask_disk"],
        desired_count=pe["desired_count"], limit=pe["limits"],
        distinct_hosts=pe["distinct_hosts"])
    spread = None
    if case["spread"] is not None:
        spread = spread_inputs_from_numpy(case["spread"], dev, dtype)
        if not case["spread_even"]:
            spread = spread._replace(even=None)
    q = tbatch.prepare_batched(
        *[torch.as_tensor(c).to(dtype).to(dev) for c in cols[:3]],
        batched_inputs_from_numpy(batch, dev, dtype), pe["n_candidates"], P,
        wanted=pe["wanted"], spread=spread,
        deltas=step_deltas_from_numpy(case["deltas"], dev, dtype),
        pre=pre_deltas_from_numpy(case["pre"], dev, dtype))
    if torch.device(dev).type == "cpu":
        rows, pulls, _carry = tbatch.chained_picks_twin(tbatch.batched_as_chain(q))
    else:
        rows, pulls = tbatch.launch_chained_plan(q)
    return rows.cpu(), pulls.cpu()


def _same_sharded(a, b, tag: str) -> float:
    """Rows, pulls and the three carry columns bit-equal."""
    check(bool((a[0] == b[0]).all()), f"{tag}: rows differ")
    check(bool((a[1] == b[1]).all()), f"{tag}: pulls differ")
    err = 0.0
    for x, y in zip(a[2], b[2]):
        check(bool((_bits(x) == _bits(y)).all()), f"{tag}: usage carry differs")
        err = max(err, _max_abs(x, y))
    return err


def _k12_cpu_twin(scenario: str, E: int, P: int, d: int, chunk=None):
    """The CPU twin (f64) of a phase-k12 chain, run in the twin process."""
    import torch

    from nomad_tpu_torch.parallel.mesh import VirtualMesh, sharded_chained_plan_twin

    return k12_run(VirtualMesh(d, "cpu"), sharded_chained_plan_twin,
                   _k12_case(scenario, E, P), torch.float64, chunk)


# this process's one-rank NCCL group and its DistMesh, as the bench's
# multichip block builds them: made at first use, destroyed at exit
NCCL: dict = {}


def nccl_mesh(cuda):
    from nomad_tpu_torch.parallel.mesh import make_mesh
    from nomad_tpu_torch.parallel.multichip import nccl_group

    if "mesh" not in NCCL:
        NCCL["made"] = nccl_group(cuda)
        NCCL["mesh"] = make_mesh(1, eval_axis=1)
    return NCCL["mesh"]


def close_nccl() -> None:
    if NCCL.pop("made", False):
        import torch.distributed as dist

        dist.destroy_process_group()
    NCCL.clear()


def _sweep_case() -> dict:
    """The multichip sweep's chain inputs (`_chain_inputs` at the
    sweep's shape) as a sharded-chain case, for `k9_of`."""
    from nomad_tpu_torch.ops.cases import SHARDED_PER_EVAL
    from nomad_tpu_torch.parallel import multichip as tmulti

    cols, pe = tmulti._chain_inputs(tmulti.SWEEP_C, tmulti.SWEEP_E,
                                    tmulti.SWEEP_P)
    return dict(cols=cols, per_eval=dict(zip(SHARDED_PER_EVAL, pe[:12])),
                deltas=pe[12]._asdict(), pre=pe[13]._asdict(), spread=None,
                spread_even=False)


def sweep_chain(mesh, plan) -> tuple:
    """(rows, pulls, (cpu, mem, disk) carry), all on the CPU, of the
    multichip sweep's chain through `plan` (the dispatching runner or
    the twin) on `mesh`: its own inputs, launch by launch of its chunk
    width with the carry threaded (`multichip.chunked_chain`)."""
    from nomad_tpu_torch.parallel import multichip as tmulti

    cols, per_eval = tmulti._chain_inputs(tmulti.SWEEP_C, tmulti.SWEEP_E,
                                          tmulti.SWEEP_P)
    rows, pulls, carry = tmulti.chunked_chain(
        plan(mesh, tmulti.SWEEP_P, return_carry=True), cols, per_eval,
        tmulti.SWEEP_CHUNK)
    return (rows.cpu(), pulls.cpu(),
            tuple(mesh.unshard(c).cpu() for c in carry))


def _k12_sweep_cpu_twin(d: int):
    """The CPU twin of the sweep's chain on a VirtualMesh of d shards."""
    from nomad_tpu_torch.parallel.mesh import VirtualMesh, sharded_chained_plan_twin

    return sweep_chain(VirtualMesh(d, "cpu"), sharded_chained_plan_twin)


def _k12_params():
    from nomad_tpu_torch.ops.cases import SHARDED_CHAIN_SCENARIOS

    for scenario in SHARDED_CHAIN_SCENARIOS:
        for d in K12_COUNTS:
            yield f"k12-{scenario}-{d}", (scenario, *K12_SHAPE, d)
    E, P, chunk = K12_FULL
    for d in (1, 8):
        yield f"k12-full-{d}", ("everything", E, P, d, chunk)


def check_sweep_chain(cuda) -> tuple:
    """The bench's multichip block on the card: the sweep's own inputs,
    chunking and carry through a DistMesh over a one-rank NCCL group
    (its exchanges NCCL all-gathers), K12 bit-equal to the twin on that
    mesh, to the CPU twin on a VirtualMesh of 1, 2, 4 and 8 shards, and
    (rows, pulls) to K9.  Returns (max_abs_err, placed picks)."""
    import torch

    from nomad_tpu_torch.parallel import multichip as tmulti
    from nomad_tpu_torch.parallel.mesh import (
        sharded_chained_plan,
        sharded_chained_plan_twin,
    )

    mesh = nccl_mesh(cuda)
    tag = (f"K12 multichip sweep C={tmulti.SWEEP_C} E={tmulti.SWEEP_E} "
           f"P={tmulti.SWEEP_P} in chunks of {tmulti.SWEEP_CHUNK} on the NCCL "
           f"DistMesh")
    kern = sweep_chain(mesh, sharded_chained_plan)
    twin = sweep_chain(mesh, sharded_chained_plan_twin)
    err = _same_sharded(kern, twin, tag + " (card twin)")
    for d in K12_COUNTS:
        with SPLIT("wait"):
            cpu = HELPERS.get(f"k12-sweep-{d}")
        err = max(err, _same_sharded(
            kern, cpu, f"{tag} (CPU twin, VirtualMesh D={d})"))
    k9 = k9_of(_sweep_case(), cuda, torch.float64)
    check(torch.equal(kern[0], k9[0]) and torch.equal(kern[1], k9[1]),
          f"{tag}: rows or pulls differ from K9's")
    placed = int((kern[0] >= 0).sum())
    check(placed > 0, f"{tag}: nothing placed")
    return err, placed


def check_k12(cuda) -> dict:
    """K12 against its twin on a VirtualMesh of D shards on the card, D
    in {1, 2, 4, 8} (f64) and 8 (f32), over the four sharded-chain
    scenarios at the 16,384-row arena with 10,000 candidates, E = 8,
    P = 16: rows, pulls and the three carry columns bit-equal to the
    card twin and (f64) to the CPU twin, rows and pulls equal to K9's on
    the same inputs.  Then the full-width run, E = 64, P = 10, at D = 1
    and 8: cut into chunks of 8 evals with the carry threaded, equal to
    one launch, to the twins and to K9.  Then the bench's multichip
    block as it runs on the card: the sweep's chain (C = 1,024, E = 16
    in launches of 8, P = 4, its carry threaded) on the DistMesh over a
    one-rank NCCL group, bit-equal to the card twin on that mesh, to
    the CPU twin on a VirtualMesh of 1, 2, 4 and 8 shards, and (rows,
    pulls) to K9."""
    import torch

    from nomad_tpu_torch.ops.cases import SHARDED_CHAIN_SCENARIOS
    from nomad_tpu_torch.parallel import multichip as tmulti
    from nomad_tpu_torch.parallel.mesh import (
        VirtualMesh,
        sharded_chained_plan,
        sharded_chained_plan_cuda,
        stage_launches,
    )

    n_cases = placed = 0
    max_err = 0.0
    chains = 0
    chunks0 = sharded_chained_plan_cuda.chunks
    launches0 = sharded_chained_plan_cuda.launches
    for scenario in SHARDED_CHAIN_SCENARIOS:
        case = _k12_case(scenario, *K12_SHAPE)
        for dtype, counts in ((torch.float64, K12_COUNTS), (torch.float32, (8,))):
            k9 = k9_of(case, cuda, dtype)
            for d in counts:
                tag = f"K12 {dtype} {scenario} D={d}"
                kern = k12_run(VirtualMesh(d, cuda), sharded_chained_plan, case, dtype)
                chains += 1
                with SPLIT("wait"):
                    twin = HELPERS.get(f"card-k12-{str(dtype)[6:]}-{scenario}-{d}")
                max_err = max(max_err, _same_sharded(kern, twin, tag + " (card twin)"))
                if dtype == torch.float64:
                    with SPLIT("wait"):
                        cpu = HELPERS.get(f"k12-{scenario}-{d}")
                    max_err = max(max_err, _same_sharded(kern, cpu, tag + " (CPU twin)"))
                check(torch.equal(kern[0], k9[0]) and torch.equal(kern[1], k9[1]),
                      f"{tag}: rows or pulls differ from K9's")
                placed += int((kern[0] >= 0).sum())
                n_cases += 1
    E, P, chunk = K12_FULL
    case = _k12_case("everything", E, P)
    k9 = k9_of(case, cuda, torch.float64)
    for d in (1, 8):
        tag = f"K12 full width E={E} P={P} D={d}"
        one = k12_run(VirtualMesh(d, cuda), sharded_chained_plan, case,
                      torch.float64)
        cut = k12_run(VirtualMesh(d, cuda), sharded_chained_plan, case,
                      torch.float64, chunk)
        chains += 1 + E // chunk
        _same_sharded(cut, one, tag + " (chunks of 8 against one launch)")
        with SPLIT("wait"):
            twin = HELPERS.get(f"card-k12-full-{d}")
            cpu = HELPERS.get(f"k12-full-{d}")
        max_err = max(max_err, _same_sharded(cut, twin, tag + " (card twin)"))
        max_err = max(max_err, _same_sharded(cut, cpu, tag + " (CPU twin)"))
        check(torch.equal(cut[0], k9[0]) and torch.equal(cut[1], k9[1]),
              f"{tag}: rows or pulls differ from K9's")
        placed += int((cut[0] >= 0).sum())
        n_cases += 1
    # a VirtualMesh chain is one cooperative launch
    virtual = sharded_chained_plan_cuda.launches - launches0
    check(virtual == chains, f"K12 made {virtual} launches for {chains} chains "
          f"on a VirtualMesh (one cooperative launch a chain)")
    staged0 = sharded_chained_plan_cuda.launches
    err, sweep_placed = check_sweep_chain(cuda)
    sweep_chains = -(-tmulti.SWEEP_E // tmulti.SWEEP_CHUNK)
    chains += sweep_chains
    # the NCCL DistMesh keeps the staged launches
    staged = sharded_chained_plan_cuda.launches - staged0
    want_staged = sweep_chains * stage_launches(
        nccl_mesh(cuda), tmulti.SWEEP_CHUNK, tmulti.SWEEP_P)
    check(staged == want_staged, f"K12 made {staged} staged launches on the "
          f"NCCL DistMesh for {want_staged}")
    max_err = max(max_err, err)
    placed += sweep_placed
    n_cases += 1
    launched = sharded_chained_plan_cuda.chunks - chunks0
    check(launched == chains, f"K12 launched {launched} chains for {chains}")
    check(placed > 0, "K12 placed nothing in any case")
    print(f"K12: {n_cases} cases exact against the twin on the card (f64 at D "
          f"in {K12_COUNTS}, f32 at D = 8) and on the CPU (f64; rows, pulls "
          f"and the three carry columns), rows and pulls equal to K9's; the "
          f"full-width chain (E = {E}, P = {P}) in chunks of {chunk} equal "
          f"to one launch at D = 1 and 8; the multichip sweep's chain on "
          f"the one-rank NCCL DistMesh equal to the card twin there, to the "
          f"CPU twin at D in {K12_COUNTS} and to K9 ({sweep_placed} placed); "
          f"{placed} placed picks; {virtual} cooperative launches for as many "
          f"VirtualMesh chains, {staged} staged launches for the NCCL "
          f"DistMesh's {sweep_chains}; max_abs_err={max_err}", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases, "chains": chains}


def check_k13(cuda) -> dict:
    """K13 against its twin at W in {8, 1024, 16384} with padding
    idx == C, D in {1, 2, 4, 8}, f64 and f32: every shard bit-equal to
    the twin's, and the whole column to K4's on the unsharded column,
    one launch a call for all D shards.  The stacked form (the mirror's
    flush: three columns, a negative row beside the padding, shards as
    views of one block) in one launch, bit-equal to its twin on the card
    and on the CPU and to the three per-column calls, on the VirtualMesh
    and, at D = 4, on a rank of shards 2 and 3.  Then the multichip
    block's delta patch (the sweep's column, 24 dirty rows in a W = 32
    staging) on the DistMesh over a one-rank NCCL group: bit-equal to
    the twin there, on the CPU, and to K4."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.parallel.mesh import VirtualMesh, mesh_put

    n_cases = 0
    n_stacked = 0
    max_err = 0.0
    want = 0
    launches0 = tbatch.patch_rows_sharded_cuda.launches
    for dtype in (torch.float64, torch.float32):
        for width in PATCH_WIDTHS:
            rng = np.random.default_rng(width + 13)
            col = torch.from_numpy(rng.uniform(0.0, 1e4, C_CHECK)).to(dtype)
            n = max(1, width - width // 4)
            idx = np.full(width, C_CHECK, np.int32)  # padding: dropped
            idx[:n] = np.sort(rng.choice(C_CHECK, n, replace=False))
            idx = torch.from_numpy(idx)
            vals = torch.from_numpy(rng.uniform(0.0, 1e4, width)).to(dtype)
            whole = tbatch.patch_rows(col.clone().to(cuda), idx.to(cuda),
                                      vals.to(cuda)).cpu()
            # the stacked form's three columns and staging: the same rows,
            # one of the padding slots a negative row
            cols3 = torch.from_numpy(rng.uniform(0.0, 1e4, (3, C_CHECK))).to(dtype)
            idx3 = idx.clone()
            idx3[n] = -1
            vals3 = torch.from_numpy(rng.uniform(0.0, 1e4, (3, width))).to(dtype)
            for d in K12_COUNTS:
                mesh = VirtualMesh(d, cuda)
                sh = tbatch.patch_rows_sharded(mesh, mesh.shard(col),
                                               idx.to(cuda), vals.to(cuda))
                want += 1
                got = mesh.unshard(sh).cpu()
                cmesh = VirtualMesh(d, "cpu")
                twin = cmesh.unshard(tbatch.patch_rows_sharded_twin(
                    cmesh, cmesh.shard(col), idx, vals))
                tag = f"K13 {dtype} W={width} D={d}"
                check(bool((_bits(got) == _bits(twin)).all()), f"{tag}: kernel != twin")
                check(bool((_bits(got) == _bits(whole)).all()),
                      f"{tag}: kernel != K4 on the unsharded column")
                max_err = max(max_err, _max_abs(got, twin))
                n_cases += 1
                views = [(mesh, cmesh)]
                if d == 4:
                    rank, crank = VirtualMesh(4, cuda), VirtualMesh(4, "cpu")
                    rank.local_shards = crank.local_shards = (2, 3)
                    views.append((rank, crank))
                for m, cm in views:
                    def place(mm):
                        # the host columns as `mm`'s shards, views of one
                        # upload a column (the mirror's layout)
                        return tuple(mesh_put(mm, c) for c in cols3)

                    stacked = place(m)
                    tbatch.RowPatch(m, stacked)(idx3.to(cuda), vals3.to(cuda))
                    card_twin = tbatch.patch_rows_sharded_cols_twin(
                        m, place(m), idx3.to(cuda), vals3.to(cuda))
                    cpu_twin = tbatch.patch_rows_sharded_cols_twin(
                        cm, place(cm), idx3, vals3)
                    per_col = place(m)
                    for k, c in enumerate(per_col):
                        tbatch.patch_rows_sharded(m, c, idx3.to(cuda),
                                                  vals3[k].to(cuda))
                    want += 4
                    tag3 = f"K13 stacked {dtype} W={width} D={d} shards {m.local_shards}"
                    for k in range(3):
                        got3 = torch.cat(stacked[k].shards).cpu()
                        for other, what in ((card_twin, "the card twin"),
                                            (cpu_twin, "the CPU twin"),
                                            (per_col, "the per-column calls")):
                            check(bool((_bits(got3) == _bits(
                                torch.cat(other[k].shards).cpu())).all()),
                                  f"{tag3} column {k}: kernel != {what}")
                        max_err = max(max_err, _max_abs(
                            got3, torch.cat(cpu_twin[k].shards)))
                    n_stacked += 1
    # the multichip block's delta patch on the NCCL DistMesh: the
    # sweep's column and staging
    from nomad_tpu_torch.parallel import multichip as tmulti

    mesh = nccl_mesh(cuda)
    col = tmulti._chain_inputs(tmulti.SWEEP_C, tmulti.SWEEP_E,
                               tmulti.SWEEP_P)[0][3]
    idx, vals = tmulti.delta_patch_inputs(tmulti.SWEEP_C, tmulti.SWEEP_DIRTY,
                                          cuda)
    got = mesh.unshard(tbatch.patch_rows_sharded(
        mesh, mesh.shard(col), idx, vals)).cpu()
    twin = mesh.unshard(tbatch.patch_rows_sharded_twin(
        mesh, mesh.shard(col), idx, vals)).cpu()
    cmesh = VirtualMesh(1, "cpu")
    cpu = cmesh.unshard(tbatch.patch_rows_sharded_twin(
        cmesh, cmesh.shard(col), idx.cpu(), vals.cpu()))
    whole = tbatch.patch_rows(torch.from_numpy(col).to(cuda), idx, vals).cpu()
    tag = f"K13 multichip patch W={idx.shape[0]} on the NCCL DistMesh"
    check(bool((_bits(got) == _bits(twin)).all()), f"{tag}: kernel != card twin")
    check(bool((_bits(got) == _bits(cpu)).all()), f"{tag}: kernel != CPU twin")
    check(bool((_bits(got) == _bits(whole)).all()),
          f"{tag}: kernel != K4 on the unsharded column")
    max_err = max(max_err, _max_abs(got, twin))
    n_cases += 1
    launched = tbatch.patch_rows_sharded_cuda.launches - launches0
    want += 1
    check(launched == want, f"K13 launched {launched} times for {want} calls "
          f"(one a call, whatever the shards and columns)")
    print(f"K13: {n_cases} cases exact (f64 and f32, D in {K12_COUNTS}, "
          f"padding dropped; one launch a call) against the twin and K4 on "
          f"the unsharded column; {n_stacked} stacked cases (three columns "
          f"in one launch, a negative row and padding dropped, the "
          f"VirtualMesh and a rank of shards 2-3 of 4) against the card and "
          f"CPU twins and the per-column calls; and the multichip block's "
          f"patch on the one-rank NCCL DistMesh against the card and CPU "
          f"twins and K4, max_abs_err={max_err}", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases + n_stacked,
            "launches": launched}


def time_sharded_kernels(cuda) -> dict:
    """K12 per chunk (E = 8, P = 10, the "plain" chain at the 16,384-row
    arena with 10,000 candidates) at D = 1 and D = 8 shards of a
    VirtualMesh on the card, timed over a prepared chain (the runner's
    staging outside the timing; the launch's argument blocks filled in
    each call, as for each chunk on the path; the usage carry reset
    before each run), its launches counted over the timed chunks;
    K13 at W = 1,024 at D = 1 (beside `index_copy_` into the shard, the
    nearest single PyTorch call) and D = 8.  The D-shard times are one
    card holding D shards, not multi-GPU scaling."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.parallel.mesh import (
        VirtualMesh,
        prepare_sharded_chain,
        sharded_chain_twin,
        sharded_chained_plan_cuda,
        stage_launches,
    )
    from nomad_tpu_torch.state.convert import sharded_case_args

    saved = (sharded_chained_plan_cuda.launches, sharded_chained_plan_cuda.chunks,
             tbatch.patch_rows_sharded_cuda.launches)
    E, P = K12_TIMING
    case = _k12_case("plain", E, P)
    out = {}
    for d in (1, 8):
        mesh = VirtualMesh(d, cuda)
        c = prepare_sharded_chain(mesh, P, sharded_case_args(case, cuda))
        start = [tuple(t.clone() for t in sh.use) for sh in c.shards]

        def reset():
            for sh, cols in zip(c.shards, start):
                for t, t0 in zip(sh.use, cols):
                    t.copy_(t0)

        def kernel():
            reset()
            sharded_chained_plan_cuda(c)

        def twin():
            reset()
            sharded_chain_twin(c)

        # every shard's columns and the gathered [C] vectors of the
        # candidate region per pick: score reads 7 f64 columns, the
        # collision i32 and the feasibility byte, writes the f64 score and
        # the feasibility byte; the walk reads the permutation (i32) and
        # the gathered score and feasibility at it
        per_row = 7 * 8 + 4 + 1 + 8 + 1 + 4 + 8 + 1
        # the launches of the timed chunks, counted as they run
        launches0 = sharded_chained_plan_cuda.launches
        chunks0 = sharded_chained_plan_cuda.chunks
        ms = cuda_time_ms(kernel, n=10, warmup=2)
        launches_per_chunk = ((sharded_chained_plan_cuda.launches - launches0)
                              / (sharded_chained_plan_cuda.chunks - chunks0))
        check(launches_per_chunk == stage_launches(mesh, E, P),
              f"K12 made {launches_per_chunk} launches a timed chunk at "
              f"D = {d}, for {stage_launches(mesh, E, P)}")
        out[f"sharded_chained_plan_d{d}"] = {
            "ms": ms,
            "plain_ms": cuda_time_ms(twin, n=2, warmup=1),
            "bytes": E * P * N_CAND_CHECK * per_row,
            "flops": E * P * N_CAND_CHECK * FLOPS_PER_CANDIDATE,
            "launches_per_chunk": launches_per_chunk,
            "blocks": sharded_chained_plan_cuda.blocks,
            "shape": f"E={E} P={P} D={d}",
        }
    width = 1024
    rng = np.random.default_rng(7013)
    col = torch.from_numpy(rng.uniform(0.0, 1e4, C_CHECK)).to(cuda)
    idx = np.full(width, C_CHECK, np.int32)
    n = width - width // 4
    idx[:n] = np.sort(rng.choice(C_CHECK, n, replace=False))
    idx_t = torch.from_numpy(idx).to(cuda)
    vals = torch.from_numpy(rng.uniform(0.0, 1e4, width)).to(cuda)
    vals1 = vals.unsqueeze(0)
    for d in (1, 8):
        mesh = VirtualMesh(d, cuda)
        sh = mesh.shard(col)
        size = C_CHECK // d
        # the calls a plain port would make: index_copy_ into each shard
        # of the rows it owns
        own = []
        for s_, t in enumerate(sh.shards):
            mine = (idx[:n] >= s_ * size) & (idx[:n] < (s_ + 1) * size)
            own.append((t, torch.from_numpy(idx[:n][mine] - s_ * size).long().to(cuda),
                        vals[:n][torch.from_numpy(mine).to(cuda)]))

        def library():
            for t, i, v in own:
                t.index_copy_(0, i, v)

        patch = tbatch.RowPatch(mesh, (sh,))
        ptrs = (idx_t.data_ptr(), vals1.data_ptr(), width)
        out[f"patch_rows_sharded_d{d}"] = {
            # the launch as a flush makes it: bound once, the staging's
            # addresses and width
            "ms": cuda_time_ms(lambda: patch.launch(*ptrs), n=200),
            # the bound patch's checked call on staging tensors
            "call_ms": cuda_time_ms(lambda: patch(idx_t, vals1), n=200),
            # the per-column entry point, which binds on every call
            "wrapper_ms": cuda_time_ms(lambda: tbatch.patch_rows_sharded_cuda(
                mesh, sh, idx_t, vals), n=200),
            "plain_ms": cuda_time_ms(lambda: tbatch.patch_rows_sharded_twin(
                mesh, sh, idx_t, vals), n=50, warmup=3),
            "library_ms": cuda_time_ms(library, n=200),
            "library_calls": d,
            # the W indices read once; the staged rows read and stored
            "bytes": width * 4 + n * (8 + 8),
            "flops": 0,
            "shape": f"W={width} D={d}",
        }
    out["patch_rows_sharded_flush3"] = time_flush3(cuda, hostlocal=False)
    (sharded_chained_plan_cuda.launches, sharded_chained_plan_cuda.chunks,
     tbatch.patch_rows_sharded_cuda.launches) = saved
    return out


# ---------------------------------------------------------------------------
# phase k14 / mesh: the node-sharded storm solve and the meshed Server
# ---------------------------------------------------------------------------

K14_COUNTS = (1, 2, 4, 8)  # phase k14's shard counts (a VirtualMesh on the card)
MESH_SHARDS = 8  # the mesh phase's VirtualMesh on the card
MESH_JOBS = 128  # its prefix of phase 8's stream: two gulps, eight spread jobs


def _k5_index(tag: str) -> int:
    return [t for _s, _make, t in _k5_scenarios()].index(tag)


def _k14_params():
    """Phase k14's cases on phase k5's inputs: (key, (dtype name, k5
    scenario index, A, D)): the dogpile at A = 8 and 1,024 in f64 at every
    D, at D = 8 also in f32 and the weighted dogpile."""
    dog, pdog = _k5_index("dogpile"), _k5_index("policy_dogpile")
    for d in K14_COUNTS:
        for A in STORM_ROWS:
            yield f"k14-float64-dogpile-{A}-{d}", ("float64", dog, A, d)
    yield (f"k14-float32-dogpile-{STORM_ROWS[-1]}-8",
           ("float32", dog, STORM_ROWS[-1], 8))
    yield (f"k14-float64-policy_dogpile-{STORM_ROWS[-1]}-8",
           ("float64", pdog, STORM_ROWS[-1], 8))


def _k14_inputs(dtype_name: str, si: int, A: int, dev):
    """Phase k5's case `si` at A rows on `dev`: (StormInputs, columns,
    max_rounds, weighted)."""
    import torch

    from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

    dtype = getattr(torch, dtype_name)
    scenario, make, _tag = _k5_scenarios()[si]
    cols, inp, max_rounds = make(9500 + 10 * si + A, A, A, C_CHECK, scenario)
    return (storm_inputs(inp, dev, dtype), storm_columns(cols, dev, dtype),
            max_rounds, "policy_tput_term" in inp)


def k14_run(mesh, plan, dtype_name: str, si: int, A: int):
    """The six outputs (on the CPU) of one phase-k14 case through `plan`
    (the dispatching solve or the twin) on `mesh`."""
    inp, cols, max_rounds, weighted = _k14_inputs(dtype_name, si, A,
                                                  mesh.device)
    return _to_cpu(plan(mesh, False, max_rounds, weighted)(inp, cols))


def _k14_cpu(dtype_name: str, si: int, A: int, d: int):
    from nomad_tpu_torch.ops.solve import storm_assignment_sharded_twin
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    return k14_run(VirtualMesh(d, "cpu"), storm_assignment_sharded_twin,
                   dtype_name, si, A)


def _k14_card(dtype_name: str, si: int, A: int, d: int):
    from nomad_tpu_torch.ops.solve import storm_assignment_sharded_twin
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    return k14_run(VirtualMesh(d, _card()), storm_assignment_sharded_twin,
                   dtype_name, si, A)


def _same_storm(kern, other, tag: str, sign_of_zero: bool = True) -> float:
    """All six outputs bit-equal; without `sign_of_zero` the score only
    equal in value (the sharded read adds +0.0 from the other shards)."""
    from nomad_tpu_torch.ops import solve as tsolve

    for name, k, o in zip(tsolve.StormOut._fields, kern, other):
        if name == "score" and not sign_of_zero:
            check(bool((k == o.cpu()).all()), f"{tag}: {name} differs")
        else:
            check(bool((_bits(k) == _bits(o)).all()), f"{tag}: {name} differs")
    return _max_abs(kern[3], other[3])


def check_k14(cuda) -> dict:
    """K14 on a VirtualMesh of D shards on the card, D in {1, 2, 4, 8},
    on phase k5's inputs (the dogpile at A = 8 and 1,024 rows over the
    16,384-row arena; f64 at every D, f32 and the weighted dogpile at
    D = 8): all six outputs bit-equal to its twin on the card and on the
    CPU, and equal to K5 on the same inputs (bits but for a zero score's
    sign at D > 1).  Then the full-width dogpile once on the DistMesh over
    the one-rank NCCL group, bit-equal to D = 1.  Returns the launches
    these runs must have made (their stage counts)."""
    from nomad_tpu_torch.ops import solve as tsolve
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    n_cases = expected = 0
    max_err = 0.0
    rounds = {}
    d1 = {}
    per_solve = {}
    for key, (dt, si, A, d) in _k14_params():
        mesh = VirtualMesh(d, cuda)
        before = tsolve.storm_assignment_sharded_cuda.launches
        kern = k14_run(mesh, tsolve.storm_assignment_sharded, dt, si, A)
        n = tsolve.storm_assignment_sharded_cuda.launches - before
        # a score stage a shard, the walk, one cooperative launch
        check(n == tsolve.storm_stage_launches(mesh, int(kern.rounds)) == d + 2,
              f"K14 {key}: {n} launches a solve on a VirtualMesh of {d}")
        per_solve[f"virtual_d{d}"] = n
        expected += n
        inp, cols, max_rounds, _w = _k14_inputs(dt, si, A, cuda)
        k5 = _to_cpu(tsolve.storm_assignment_cuda(inp, cols, False, max_rounds))
        with SPLIT("wait"):
            twin = HELPERS.get(f"card-{key}")
            cpu = HELPERS.get(key)
        tag = f"K14 {key}"
        max_err = max(max_err, _same_storm(kern, twin, tag + " (card twin)"),
                      _same_storm(kern, cpu, tag + " (CPU twin)"),
                      _same_storm(kern, k5, tag + " (K5)", sign_of_zero=d == 1))
        rounds[key] = int(kern.rounds)
        if d == 1:
            d1[(dt, si, A)] = kern
        n_cases += 1
    dt, si, A = "float64", _k5_index("dogpile"), STORM_ROWS[-1]
    nccl = nccl_mesh(cuda)
    before = tsolve.storm_assignment_sharded_cuda.launches
    kern = k14_run(nccl, tsolve.storm_assignment_sharded, dt, si, A)
    n = tsolve.storm_assignment_sharded_cuda.launches - before
    # staged: the host launches the stages and reads the flag every round
    check(n == tsolve.storm_stage_launches(nccl, int(kern.rounds)),
          f"K14 on the NCCL DistMesh: {n} launches a solve")
    per_solve["nccl_distmesh"] = n
    expected += n
    max_err = max(max_err, _same_storm(
        kern, d1[(dt, si, A)], f"K14 dogpile A={A} on the NCCL DistMesh"))
    n_cases += 1
    full = [r for k, r in rounds.items() if f"-{STORM_ROWS[-1]}-" in k]
    check(min(full) >= 3, "a full-width K14 case ran fewer than 3 rounds")
    print(f"K14: {n_cases} cases exact against the twin on the card and the "
          f"CPU (all six outputs) and equal to K5, at D in {K14_COUNTS} (f64; "
          f"f32 and weighted at D = 8) and on the one-rank NCCL DistMesh; "
          f"rounds {json.dumps(rounds)}; {expected} launches; a solve's "
          f"launches (on a VirtualMesh a score stage a shard, the walk and "
          f"one cooperative launch, no host read a round; staged on the "
          f"DistMesh) {json.dumps(per_solve)}; max_abs_err={max_err}",
          flush=True)
    return {"max_abs_err": max_err, "cases": n_cases, "launches": expected,
            "rounds": rounds, "launches_per_solve": per_solve}


def time_storm_sharded(cuda) -> dict:
    """K14 on the storm path's own problem (the storm phase's solve: A =
    E = 1,024 rows and evals over the 16,384-row arena, f64) at D = 1 and
    D = 8 shards of a VirtualMesh on the card, over a prepared solve (the
    placement and scratch outside the timing), beside its twin on the
    card.  The bound is K5's work plus the exchanges' bytes: the gathered
    [A, C] scores and feasibility, and each round's pmax, pmin and two
    psums of [A]-long records from every shard, and the epilogue's."""
    from nomad_tpu_torch.ops import solve as tsolve
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    check("problem" in STORM_PATH, "the storm phase kept no problem to time")
    inp, cols, spread_fit, max_rounds = STORM_PATH["problem"]
    saved = tsolve.storm_assignment_sharded_cuda.launches
    out = {}
    for d in (1, 8):
        mesh = VirtualMesh(d, cuda)
        st = tsolve.prepare_sharded_storm(mesh, inp, cols, spread_fit,
                                          max_rounds)
        before = tsolve.storm_assignment_sharded_cuda.launches
        res = tsolve.storm_assignment_sharded_cuda(st)
        launched = tsolve.storm_assignment_sharded_cuda.launches - before
        rounds = int(res.rounds)
        check(launched == tsolve.storm_stage_launches(mesh, rounds),
              f"K14 at D = {d}: {launched} launches a solve")
        work = k5_work(inp, res)
        A, C = st.A, st.C
        f = 8
        exchange = (A * C * (f + 1) + rounds * d * A * (f + 4 + 2 * f + f)
                    + d * A * f)
        out[f"storm_assignment_sharded_d{d}"] = {
            "ms": cuda_time_ms(
                lambda: tsolve.storm_assignment_sharded_cuda(st), n=3,
                warmup=1),
            "plain_ms": cuda_time_ms(
                lambda: tsolve._drive_storm(st, tsolve._StormTwinStages), n=1,
                warmup=0),
            "bytes": work["bytes"] + exchange,
            "flops": work["flops"],
            "rounds": rounds,
            "launches_per_solve": launched,
            "blocks": tsolve.storm_assignment_sharded_cuda.blocks,
            "stamps": storm_stamps(
                lambda **kw: tsolve.storm_assignment_sharded_cuda(st, **kw),
                inp, max_rounds, cuda),
            "shape": f"A={A} E={st.E} C={C} D={d}",
        }
    tsolve.storm_assignment_sharded_cuda.launches = saved
    return out


def check_mesh(cuda, card: str, results: dict) -> dict:
    """The mesh path: a batched Server on a VirtualMesh of MESH_SHARDS
    shards on the card (K12 chunks over the sharded mirror, K13 delta
    flushes) drains the first MESH_JOBS jobs of phase 8's stream, spread
    jobs among them, and places them as phase 8's card run did; then the
    storm's 1,024 children through a meshed Server (K14) give the storm
    phase's K5 run's placements, rows and rounds.  The counts of K12,
    K13 and K14 are set to 0 before and read after."""
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import solve as tsolve
    from nomad_tpu_torch.parallel.mesh import VirtualMesh, sharded_chained_plan_cuda
    from nomad_tpu_torch.server import Server

    check("server" in results and "storm" in results,
          "the mesh phase needs phase 8's and the storm phase's card runs")
    counted = {"sharded_chained_plan": sharded_chained_plan_cuda,
               "patch_rows_sharded": tbatch.patch_rows_sharded_cuda,
               "storm_assignment_sharded": tsolve.storm_assignment_sharded_cuda}
    for w in counted.values():
        w.launches = 0
    sharded_chained_plan_cuda.chunks = 0
    tbatch.RowPatch.flushes = tbatch.RowPatch.copies = 0
    jobs = server_stream()[:MESH_JOBS]
    server = Server(num_schedulers=1, seed=1, batch_pipeline=True,
                    heartbeat_ttl=1e9, device=cuda,
                    mesh=VirtualMesh(MESH_SHARDS, cuda))
    try:
        t0 = time.perf_counter()
        build_world(server.store)
        log(f"  world built in {time.perf_counter() - t0:.1f}s")
        server.start()
        worker = server.workers[0]
        worker.warm_shapes()
        placed_by_job, lat, dt, placed = drive_server(server, jobs, "mesh")
        stats = {k: getattr(worker, k) for k in (
            "prescored", "fallbacks", "errors", "mesh_used", "trips")}
        stats["mesh_launches"] = server.metrics.get_counter("mesh.launches")
        stats["bytes_per_flush"] = server.metrics.get_gauge("mesh.bytes_per_flush")
        stats["mirror_hit_rate"] = server.metrics.get_gauge("mesh.mirror_hit_rate")
        timings = dict(worker.timings)
    finally:
        server.stop()
    del server, worker
    storm = run_storm(cuda, True, "storm on the mesh",
                      mesh=VirtualMesh(MESH_SHARDS, cuda))
    launches = {k: w.launches for k, w in counted.items()}
    flushes = {"flushes": tbatch.RowPatch.flushes,
               "copies": tbatch.RowPatch.copies}
    # every K13 launch of the path is a delta flush's one launch, and each
    # flush moved one staging buffer
    check(flushes["flushes"] > 0
          and launches["patch_rows_sharded"] == flushes["flushes"]
          == flushes["copies"],
          f"a delta flush is not one K13 launch and one staging copy: "
          f"{launches['patch_rows_sharded']} launches for {flushes}")
    check(stats["errors"] == 0 and storm["errors"] == 0,
          f"the meshed workers counted errors: {stats['errors']}, "
          f"{storm['errors']}")
    check(stats["mesh_used"] > 0 and stats["mesh_launches"] > 0,
          f"the meshed Server never ran on the mesh: {stats}")
    check(stats["prescored"] == len(jobs),
          f"the meshed worker prescored {stats['prescored']} of {len(jobs)}")
    spread = [j.id for j in jobs if j.spreads]
    check(len(spread) >= 2, "the mesh phase's prefix has no spread jobs")
    want = results["server"]["placements"]
    for job in jobs:
        check(placed_by_job[job.id] == want[job.id],
              f"the meshed Server and phase 8's card run diverge at {job.id}")
    on = results["storm"]
    check(storm["ok"] and not storm["lost"], "the meshed storm did not drain")
    check(storm["mesh_storms"] > 0, "no storm was solved on the mesh")
    check(storm["counters"] == on["counters"],
          f"storm counters differ: mesh {storm['counters']} K5 {on['counters']}")
    for job_id, p in storm["placements"].items():
        check(p == on["placements"][job_id],
              f"the meshed and the K5 storm runs diverge at {job_id}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the mesh path")
    # each meshed storm solve: a score stage a shard, the walk and one
    # cooperative launch for its rounds
    k14_per_solve = launches["storm_assignment_sharded"] / storm["mesh_storms"]
    check(k14_per_solve == MESH_SHARDS + 2,
          f"the meshed storm made {launches['storm_assignment_sharded']} K14 "
          f"launches for {storm['mesh_storms']} solves")
    # a chunk on the VirtualMesh is one cooperative K12 launch (the
    # storm run's Server may dispatch chunks of its own beside the
    # chain run's)
    chunks = sharded_chained_plan_cuda.chunks
    check(launches["sharded_chained_plan"] == chunks >= stats["mesh_launches"],
          f"the mesh path made {launches['sharded_chained_plan']} K12 launches "
          f"for {chunks} chunks ({stats['mesh_launches']} dispatched by the "
          f"chain run)")
    rate = placed / dt
    storm_rate = storm["placed"] / storm["seconds"]
    print(f"mesh path on {card}: VirtualMesh of {MESH_SHARDS} shards on the "
          f"card; {len(jobs)} evals of phase 8's stream ({len(spread)} "
          f"spread), {placed} placements in {dt:.2f}s = {rate:.1f} "
          f"placements/s, identical to phase 8's card run; {json.dumps(stats)}; "
          f"storm of {STORM_JOBS} children on the mesh {storm_rate:.1f} "
          f"placements/s ({storm['seconds']:.2f} s), counters "
          f"{json.dumps(storm['counters'])} identical to the K5 run "
          f"({storm['mesh_storms']} K14 solves, {k14_per_solve:.0f} launches "
          f"a solve); launches "
          f"{json.dumps(launches)}; delta flushes and their staging copies "
          f"{json.dumps(flushes)} (one K13 launch a flush); timings (s) "
          f"{json.dumps({k: round(v, 4) for k, v in timings.items()})}; storm "
          f"timings (s) "
          f"{json.dumps({k: round(v, 4) for k, v in storm['timings'].items()})}",
          flush=True)
    return {"launches": launches, "flushes": flushes, "stats": stats,
            "chunks": chunks, "placements_per_s": rate,
            "storm_placements_per_s": storm_rate, "timings": timings,
            "storm_timings": storm["timings"]}


# ---------------------------------------------------------------------------
# phase k15 / multihost: the per-host flush and the multi-process node mesh
# ---------------------------------------------------------------------------

# phase k15's meshes: (D shards, L shards a process), each process's L
# shards patched by one K15 launch
K15_SHAPES = ((2, 1), (4, 1), (4, 2), (8, 1), (8, 2), (8, 4))
K15_ARENAS = (64, C_CHECK)
# the JAX package's four dirty sets (tests/test_dist_mesh.py), spread over
# the arena, and 1,024 rows
K15_SETS = ("one_shard", "several", "two_full_shards", "random20", "rows1024")
# the multihost phase's world: BASELINE.json's 10,000 nodes (a 16,384-row
# arena, 4,096 rows a shard), 64 chain jobs and a 256-member storm family,
# run by MULTIHOST_PROCS processes of MULTIHOST_SHARDS shards on the card
MULTIHOST_WORLD = {"NOMAD_TPU_SMOKE_NODES": "10000",
                   "NOMAD_TPU_SMOKE_JOBS": "64",
                   "NOMAD_TPU_SMOKE_FAMILY": "256"}
MULTIHOST_PROCS, MULTIHOST_SHARDS = 2, 2
MULTIHOST_TIMEOUT_S = 300.0
K15_TIMING = (2, 8, 4096)  # the path's flush: L shards, w, shard rows


def _k15_dirty(name: str, C: int, seed: int):
    """(sorted i32 rows, new values f64[C]) of one of K15_SETS."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fixed = {"one_shard": [0], "several": [3, 8, 9, 17, 40, 63],
             "two_full_shards": list(range(24, 48))}
    if name in fixed:
        rows = [r * (C // 64) for r in fixed[name]]
    elif name == "random20":
        rows = rng.choice(C, 20, replace=False)
    else:
        rows = rng.choice(C, min(1024, C), replace=False)
    return np.asarray(sorted(int(r) for r in rows), np.int32), rng.uniform(
        0.0, 1e4, C)


class _RankView:
    """A VirtualMesh seen as one process of a world of L shards a
    process: the shards `local`, on the mesh's device."""

    def __init__(self, mesh, local) -> None:
        self.n_shards, self.device = mesh.n_shards, mesh.device
        self.local_shards = tuple(local)


def _k15_run(mesh, col, idx, src, per: int, patch):
    """`patch` (K15 or its twin) of the dirty set into a fresh placement
    of `col` on `mesh`, one call a process of `per` shards with its own
    staging rows; the whole column back on the host."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.parallel.mesh import Sharded, mesh_put

    C = col.shape[0]
    stack, per_dev, w = tbatch.hostlocal_staging(mesh, idx, C)
    full = mesh_put(mesh, col.numpy())
    for r in range(mesh.n_shards // per):
        local = list(range(r * per, r * per + per))
        vals = np.zeros((per, w))
        for i, d in enumerate(local):
            vals[i, :len(per_dev[d])] = src[per_dev[d]]
        patch(_RankView(mesh, local), Sharded(tuple(full.shards[d] for d in local)),
              torch.from_numpy(stack[local]).to(mesh.device),
              torch.from_numpy(vals).to(col.dtype).to(mesh.device))
    return mesh.unshard(full).cpu()


def _k15_run_cols(mesh, cols, idx, srcs, per: int, patch):
    """`_k15_run` for the stacked form: `patch` (a K15 `RowPatch` call
    or the stacked twin) of three columns [3, C] with their sources [3, C], one
    call a process; the columns put together [3, C] on the host."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.parallel.mesh import Sharded, mesh_put

    C = cols.shape[1]
    stack, per_dev, w = tbatch.hostlocal_staging(mesh, idx, C)
    full = [mesh_put(mesh, c.numpy()) for c in cols]
    for r in range(mesh.n_shards // per):
        local = list(range(r * per, r * per + per))
        vals = np.zeros((len(cols), per, w))
        for i, d in enumerate(local):
            vals[:, i, :len(per_dev[d])] = srcs[:, per_dev[d]]
        patch(_RankView(mesh, local),
              tuple(Sharded(tuple(f.shards[d] for d in local)) for f in full),
              torch.from_numpy(stack[local]).to(mesh.device),
              torch.from_numpy(vals).to(cols.dtype).to(mesh.device))
    return torch.stack([mesh.unshard(f).cpu() for f in full])


def check_k15(cuda) -> dict:
    """K15 against its twin on the card and on the CPU at every
    (D, L) of K15_SHAPES, C in {64, 16,384}, the JAX test's four dirty
    sets and 1,024 rows, f64 and f32: each process's L shards take its
    own staging rows in one launch, and the column put together is
    bit-equal to the twins', to K13's with the replicated staging and to
    the host oracle's.  The stacked form (three columns in the same one
    launch a process): bit-equal to its CPU twin and to the host oracle,
    its first column to the per-column launch's."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    n_cases = 0
    n_stacked = 0
    max_err = 0.0
    launches0 = tbatch.patch_rows_hostlocal_cuda.launches
    want_launches = 0
    for dtype in (torch.float64, torch.float32):
        for C in K15_ARENAS:
            for si, name in enumerate(K15_SETS):
                idx, src = _k15_dirty(name, C, 1500 + 10 * si + C)
                col = torch.from_numpy(
                    np.random.default_rng(C + si).uniform(0.0, 1e4, C)).to(dtype)
                oracle = col.clone()
                oracle[torch.from_numpy(idx).long()] = torch.from_numpy(
                    src[idx]).to(dtype)
                width = max(8, 1 << (len(idx) - 1).bit_length())
                idx_p = np.full(width, C, np.int32)
                idx_p[:len(idx)] = idx
                vals_p = np.zeros(width)
                vals_p[:len(idx)] = src[idx]
                for d, per in K15_SHAPES:
                    mesh = VirtualMesh(d, cuda)
                    got = _k15_run(mesh, col, idx, src, per,
                                   tbatch.patch_rows_hostlocal_cuda)
                    want_launches += d // per
                    card_twin = _k15_run(mesh, col, idx, src, per,
                                         tbatch.patch_rows_hostlocal_twin)
                    cmesh = VirtualMesh(d, "cpu")
                    cpu_twin = _k15_run(cmesh, col, idx, src, per,
                                        tbatch.patch_rows_hostlocal_twin)
                    k13 = mesh.unshard(tbatch.patch_rows_sharded_cuda(
                        mesh, mesh.shard(col), torch.from_numpy(idx_p).to(cuda),
                        torch.from_numpy(vals_p).to(dtype).to(cuda))).cpu()
                    tag = f"K15 {dtype} C={C} {name} D={d} L={per}"
                    for other, what in ((card_twin, "the card twin"),
                                        (cpu_twin, "the CPU twin"),
                                        (k13, "K13 on the same dirty set"),
                                        (oracle, "the host oracle")):
                        check(bool((_bits(got) == _bits(other)).all()),
                              f"{tag}: kernel != {what}")
                    max_err = max(max_err, _max_abs(got, cpu_twin))
                    n_cases += 1
                    # the stacked form: the column and two more
                    cols3 = torch.stack([col, col * 0.5 + 1.0, col + 7.0])
                    srcs = np.stack([src, src * 2.0, src + 3.0])
                    got3 = _k15_run_cols(
                        mesh, cols3, idx, srcs, per,
                        lambda m, c, i, v: tbatch.RowPatch(
                            m, c, hostlocal=True)(i, v))
                    want_launches += d // per
                    twin3 = _k15_run_cols(
                        cmesh, cols3, idx, srcs, per,
                        tbatch.patch_rows_hostlocal_cols_twin)
                    oracle3 = cols3.clone()
                    oracle3[:, torch.from_numpy(idx).long()] = torch.from_numpy(
                        srcs[:, idx]).to(dtype)
                    check(bool((_bits(got3) == _bits(twin3)).all()),
                          f"{tag} stacked: kernel != the CPU twin")
                    check(bool((_bits(got3) == _bits(oracle3)).all()),
                          f"{tag} stacked: kernel != the host oracle")
                    check(bool((_bits(got3[0]) == _bits(got)).all()),
                          f"{tag} stacked: column 0 != the per-column launch")
                    max_err = max(max_err, _max_abs(got3, twin3))
                    n_stacked += 1
    launched = tbatch.patch_rows_hostlocal_cuda.launches - launches0
    check(launched == want_launches,
          f"K15 launched {launched} times for {want_launches} processes")
    print(f"K15: {n_cases} cases exact (f64 and f32, (D, L) in {K15_SHAPES}, "
          f"C in {K15_ARENAS}, {len(K15_SETS)} dirty sets; one launch a "
          f"process) against the card and CPU twins, K13 with the replicated "
          f"staging and the host oracle; {n_stacked} stacked cases (three "
          f"columns, the same one launch a process) against the CPU twin and "
          f"the host oracle, max_abs_err={max_err}", flush=True)
    return {"max_abs_err": max_err, "cases": n_cases, "launches": launched}


def multihost_reference() -> dict:
    """The multihost phase's world through an unsharded Server on the CPU
    twins, driven as the ranks drive it (a helper's job)."""
    from nomad_tpu_torch.parallel import dist_smoke

    world = {"nodes": int(MULTIHOST_WORLD["NOMAD_TPU_SMOKE_NODES"]),
             "jobs": int(MULTIHOST_WORLD["NOMAD_TPU_SMOKE_JOBS"]),
             "family": int(MULTIHOST_WORLD["NOMAD_TPU_SMOKE_FAMILY"])}
    return dist_smoke.reference("cpu", world)


def _rows(placed) -> list:
    return [list(p) for p in placed]


def check_multihost(cuda, card: str) -> dict:
    """The slice's path at full width on one card shared by processes
    exchanging over gloo: `dist_smoke.launch` (2 ranks x 2 shards, the
    10,000-node world: chain, per-host flush, storm, K14-K5 A/B, parity)
    and, at the same time, a pod (a head Server with
    NOMAD_TPU_POD_CHECK=1 and one peer) over the same nodes and jobs.
    Zero lost, cross-host parity, the storm equal to K5, the per-host
    delta bytes in their closed form and below the full bytes, every pod
    digest equal, placements equal to the unsharded CPU run (a helper's),
    and K12, K14 and K15 launched in every process."""
    from concurrent.futures import ThreadPoolExecutor

    from nomad_tpu_torch.parallel import dist_smoke

    def timed(fn, **kw):
        t0 = time.perf_counter()
        try:
            return fn(**kw), time.perf_counter() - t0
        except RuntimeError as exc:
            raise SmokeFailure(str(exc)[-4000:]) from exc

    common = dict(shards_per_proc=MULTIHOST_SHARDS, timeout=MULTIHOST_TIMEOUT_S,
                  extra_env=MULTIHOST_WORLD)
    with ThreadPoolExecutor(2) as pool:
        lock = pool.submit(timed, dist_smoke.launch, procs=MULTIHOST_PROCS,
                           **common)
        pod = pool.submit(timed, dist_smoke.launch_pod, **common)
        row, t_lock = lock.result()
        prow, t_pod = pod.result()
    with SPLIT("wait"):
        ref = HELPERS.get("multihost-cpu")
    check(row["procs"] == MULTIHOST_PROCS
          and row["global_devices"] == MULTIHOST_PROCS * MULTIHOST_SHARDS,
          f"the world is {row['procs']} x {row['devices_per_host']}")
    check(row["device"].startswith("cuda"), f"the ranks ran on {row['device']}")
    check(row["zero_lost"] and row["cross_host_parity"],
          "a rank lost an eval or diverged")
    check(row["storm_kernel"]["bit_identical"], "K14 on the mesh != K5")
    flush = row["flush"]
    check(flush["dirty_rows"] > 0, "the flush phase had no dirty rows")
    check(flush["bytes_per_flush_delta_per_host"]
          == flush["bytes_per_flush_closed_form"],
          f"per-host delta bytes off their closed form: {flush}")
    check(flush["bytes_per_flush_delta_per_host"]
          < flush["bytes_per_flush_full_per_host"],
          f"the delta flush is not below the full one: {flush}")
    check(_rows(ref["chain"]) == row["chain"]["placed"],
          "the world's chain placements != the unsharded CPU run's")
    check(_rows(ref["storm"]) == row["storm"]["placed"],
          "the world's storm placements != the unsharded CPU run's")
    check(row["loaded"] == [] and prow["loaded"] == []
          and prow["peer"]["loaded"] == [], "a process loaded JAX")
    check(prow["errors"] == 0 and prow["hosts"] == 2, f"the pod head: {prow}")
    check(prow["digests_checked"] == prow["sent"]["chain"]
          + prow["sent"].get("storm", 0) and prow["digests_checked"] > 0,
          f"pod digests {prow['digests_checked']} for {prow['sent']}")
    check(prow["peer"]["ops"] == prow["sent"],
          f"the peer replayed {prow['peer']['ops']} of {prow['sent']}")
    check(_rows(ref["chain"]) == prow["placed"],
          "the pod's chain placements != the unsharded CPU run's")
    check(_rows(ref["storm"]) == prow["storm_placed"],
          "the pod's storm placements != the unsharded CPU run's")
    procs = row["launches_ranks"] + [prow["launches"], prow["peer"]["launches"]]
    names = ("sharded_chained_plan", "storm_assignment_sharded",
             "patch_rows_hostlocal")
    for name in names:
        check(all(p[name] > 0 for p in procs),
              f"{name} was not launched in every process: "
              f"{[p[name] for p in procs]}")
    # every process's K15 launches are its delta flushes, one staging copy
    # each; the ranks' explicit flush is one of each
    flushes = row["flushes_ranks"] + [prow["flushes"], prow["peer"]["flushes"]]
    for p, f in zip(procs, flushes):
        check(p["patch_rows_hostlocal"] == f["flushes"] == f["copies"],
              f"a per-host flush is not one K15 launch and one staging copy: "
              f"{p['patch_rows_hostlocal']} launches for {f}")
    check((flush["launches"], flush["copies"], flush["flushes"]) == (1, 1, 1),
          f"the ranks' delta flush: {flush}")
    launches = {name: sum(p[name] for p in procs) for name in names}
    for k in ("chain", "storm"):
        row[k].pop("placed")
    print(f"multihost on {card}: {MULTIHOST_PROCS} processes x "
          f"{MULTIHOST_SHARDS} shards on one card over gloo (not multi-GPU "
          f"scaling), world {json.dumps(row['world'])}: {t_lock:.1f} s; "
          f"chain {json.dumps(row['chain'])}, flush {json.dumps(flush)}, "
          f"storm {json.dumps(row['storm'])}, K14 vs K5 "
          f"{json.dumps(row['storm_kernel'])}; pod (head + 1 peer, beside it) "
          f"{t_pod:.1f} s: {prow['placements']} + {len(prow['storm_placed'])} "
          f"placements, {prow['digests_checked']} digests equal, sent "
          f"{json.dumps(prow['sent'])}; placements equal to the unsharded CPU "
          f"run; launches by process "
          f"{json.dumps(procs)}, delta flushes and staging copies by process "
          f"{json.dumps(flushes)}", flush=True)
    return {"launches": launches, "launches_by_process": procs,
            "flushes_by_process": flushes,
            "seconds": {"world": t_lock, "pod": t_pod}, "row": row,
            "pod": {k: v for k, v in prow.items()
                    if k not in ("placed", "storm_placed")}}


def time_hostlocal_kernel(cuda) -> dict:
    """K15 at the multihost path's flush shape (K15_TIMING: L = 2 local
    shards of 4,096 rows, w = 8, three quarters of each staging row
    dirty), the shards views of one upload as the mirror holds them,
    launched as a flush launches it (a bound `RowPatch`); beside it the
    per-column entry point, the twin on the card and `index_copy_` into
    that block (one call, the same rows)."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.parallel.mesh import Sharded, VirtualMesh

    saved = tbatch.patch_rows_hostlocal_cuda.launches
    L, w, size = K15_TIMING
    rng = np.random.default_rng(7015)
    block = torch.from_numpy(rng.uniform(0.0, 1e4, L * size)).to(cuda)
    col = Sharded(tuple(block.narrow(0, l * size, size) for l in range(L)))
    n = w - w // 4
    idx = np.full((L, w), size, np.int32)  # padding: the shard size
    for l in range(L):
        idx[l, :n] = np.sort(rng.choice(size, n, replace=False))
    vals = rng.uniform(0.0, 1e4, (L, w))
    idx_t = torch.from_numpy(idx).to(cuda)
    vals_t = torch.from_numpy(vals).to(cuda)
    vals1 = vals_t.unsqueeze(0)
    view = _RankView(VirtualMesh(2 * L, cuda), range(L))
    flat_idx = torch.from_numpy(np.concatenate(
        [idx[l, :n].astype(np.int64) + l * size for l in range(L)])).to(cuda)
    flat_vals = torch.from_numpy(np.concatenate(
        [vals[l, :n] for l in range(L)])).to(cuda)
    patch = tbatch.RowPatch(view, (col,), hostlocal=True)
    ptrs = (idx_t.data_ptr(), vals1.data_ptr(), w)
    out = {
        "ms": cuda_time_ms(lambda: patch.launch(*ptrs), n=200),
        "call_ms": cuda_time_ms(lambda: patch(idx_t, vals1), n=200),
        "wrapper_ms": cuda_time_ms(lambda: tbatch.patch_rows_hostlocal_cuda(
            view, col, idx_t, vals_t), n=200),
        "plain_ms": cuda_time_ms(lambda: tbatch.patch_rows_hostlocal_twin(
            view, col, idx_t, vals_t), n=50, warmup=3),
        "library_ms": cuda_time_ms(
            lambda: block.index_copy_(0, flat_idx, flat_vals), n=200),
        # the [L, w] indices and values read once, the dirty rows stored
        "bytes": L * w * (4 + 8) + L * n * 8,
        "flops": 0,
        "shape": f"L={L} w={w} shard={size}",
    }
    out["flush3"] = time_flush3(cuda, hostlocal=True)
    tbatch.patch_rows_hostlocal_cuda.launches = saved
    return out


FLUSH_TIMING_ROWS = 768  # the mesh flush's dirty rows: W = 1,024


def time_flush3(cuda, hostlocal: bool) -> dict:
    """The mirror's three-column delta flush at the mesh phase's shape (a
    VirtualMesh of 8 shards over the 16,384-row arena, FLUSH_TIMING_ROWS
    dirty rows, the replicated staging: K13) or the multihost flush's
    (a process of L = 2 of 4 shards, 4,096 rows a shard, six dirty rows a
    shard: w = 8, K15); the columns views of one block a column, as the
    mirror holds them.  Kernel only (CUDA events): one launch of a bound
    `RowPatch` beside the three `index_copy_` calls a plain port would
    make into the same blocks.  Then the flush as the worker runs it
    (host clock, mean of 200): from the sorted dirty rows and their
    values to a synchronized patched mirror, staging and copy included."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.parallel.mesh import Sharded, VirtualMesh

    counter = (tbatch.patch_rows_hostlocal_cuda if hostlocal
               else tbatch.patch_rows_sharded_cuda)
    saved = (counter.launches, tbatch.RowPatch.flushes, tbatch.RowPatch.copies)
    rng = np.random.default_rng(7016 + hostlocal)
    if hostlocal:
        L, w, size = K15_TIMING
        mesh = _RankView(VirtualMesh(2 * L, cuda), range(L))
        C = 2 * L * size
        rows = np.concatenate([d * size + np.sort(rng.choice(size, w - 2,
                                                             replace=False))
                               for d in range(2 * L)]).astype(np.int32)
    else:
        L, C = 8, C_CHECK
        mesh = VirtualMesh(L, cuda)
        size = C // L
        rows = np.sort(rng.choice(C, FLUSH_TIMING_ROWS, replace=False)
                       ).astype(np.int32)
    blocks = [torch.from_numpy(rng.uniform(0.0, 1e4, L * size)).to(cuda)
              for _ in range(3)]
    cols = tuple(Sharded(tuple(b.narrow(0, l * size, size) for l in range(L)))
                 for b in blocks)
    vals = rng.uniform(0.0, 1e4, (3, len(rows)))
    patch = tbatch.RowPatch(mesh, cols, hostlocal=hostlocal)
    # the staging as the flush builds it, on the card
    if hostlocal:
        stack, per_dev, w = tbatch.hostlocal_staging(mesh, rows, C)
        local = list(mesh.local_shards)
        idx = stack[local]
        v = np.zeros((3, L, w))
        for i, d in enumerate(local):
            v[:, i, :len(per_dev[d])] = vals[:, np.searchsorted(rows, per_dev[d])]
        mine = np.concatenate([per_dev[d] for d in local])
    else:
        W = tbatch.pow2_bucket(len(rows), floor=8)
        idx = np.full(W, C, np.int32)
        idx[:len(rows)] = rows
        v = np.zeros((3, W))
        v[:, :len(rows)] = vals
        mine = rows
    idx_t = torch.from_numpy(idx).to(cuda)
    v_t = torch.from_numpy(v).to(cuda)
    first = mesh.local_shards[0] * size
    lib_idx = torch.from_numpy(mine.astype(np.int64) - first).to(cuda)
    lib_vals = torch.from_numpy(vals[:, np.searchsorted(rows, mine)]).to(cuda)

    def library():
        for b, lv in zip(blocks, lib_vals):
            b.index_copy_(0, lib_idx, lv)

    ptrs = (idx_t.data_ptr(), v_t.data_ptr(), idx.shape[-1])
    out = {
        "ms": cuda_time_ms(lambda: patch.launch(*ptrs), n=200),
        "call_ms": cuda_time_ms(lambda: patch(idx_t, v_t), n=200),
        "library_ms": cuda_time_ms(library, n=200),
        "library_calls": 3,
        # the staged indices read once, the owned rows' three values read
        # and stored
        "bytes": idx.size * 4 + len(mine) * 3 * (8 + 8),
        "flops": 0,
        "shape": (f"K=3 L={L} w={idx.shape[-1]} shard={size} "
                  f"({'hostlocal, K15' if hostlocal else 'replicated, K13'}), "
                  f"{len(mine)} dirty rows of this process"),
    }
    row_vals = tuple(vals)
    before = (counter.launches, tbatch.RowPatch.flushes, tbatch.RowPatch.copies)
    for _ in range(20):
        patch.flush(rows, row_vals, C)
    torch.cuda.synchronize()
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        patch.flush(rows, row_vals, C)
        torch.cuda.synchronize()
    out["flush_host_ms"] = (time.perf_counter() - t0) / reps * 1e3
    steps = (counter.launches - before[0], tbatch.RowPatch.flushes - before[1],
             tbatch.RowPatch.copies - before[2])
    check(steps == (20 + reps,) * 3,
          f"the timed flushes were not one launch and one copy each: {steps}")
    want = torch.from_numpy(vals)
    for b, v_ in zip(blocks, want):
        check(bool((b.cpu()[torch.from_numpy(mine.astype(np.int64) - first)]
                    == v_[torch.from_numpy(np.searchsorted(rows, mine))]).all()),
              "the timed flush did not store its rows")
    counter.launches, tbatch.RowPatch.flushes, tbatch.RowPatch.copies = saved
    return out


# ---------------------------------------------------------------------------
# phase entry: the entry module and its programs on an (evals, nodes) mesh
# ---------------------------------------------------------------------------

ENTRY_MESHES = ((1, 1), (1, 8), (2, 4))  # the checks' (evals, nodes) meshes
ENTRY_E, ENTRY_P = 16, 10  # the batched planner's check and timing shape
ENTRY_DRYRUN = 8  # dryrun_multichip's device count: a 2 x 4 mesh


def _entry_select_case(scenario: str):
    from nomad_tpu_torch.ops.cases import SCORE_SCENARIOS, score_case

    return score_case(9800 + sorted(SCORE_SCENARIOS).index(scenario), C_CHECK,
                      N_CAND_CHECK, scenario, 14)


def _entry_batch_args(dev, dtype):
    """The batched planner's inputs: a `batched_case` "plain" of ENTRY_E
    evals at the 16,384-row arena, n_candidates one scalar (the JAX
    program's is static): (node columns, BatchInputs, n_candidates)."""
    from nomad_tpu_torch.state.convert import batched_case_to_torch

    cols, kw = _k9_batched_case(9900, "plain", ENTRY_E, ENTRY_P)
    n_cand = int(kw["n_candidates"].min())
    args, _kw = batched_case_to_torch(cols, kw, dev, dtype)
    return args[:3], args[3], n_cand


def _entry_batch_cpu():
    """The batched planner's CPU twin (f64) on a 2 x 4 VirtualMesh."""
    import torch

    from nomad_tpu_torch.parallel.mesh import VirtualMesh, sharded_batch_plan

    cols, batch, n_cand = _entry_batch_args("cpu", torch.float64)
    return sharded_batch_plan(VirtualMesh(4, "cpu", n_evals=2), n_cand,
                              ENTRY_P)(*cols, batch)


def _entry_dryrun_cpu():
    from nomad_tpu_torch.entry import dryrun_multichip

    return dryrun_multichip(ENTRY_DRYRUN, "cpu")


def _select_key(out) -> tuple:
    """(row, dtype, bits of best, feasible count, pulls) of a select."""
    row, best, n, pulls = out
    return int(row), str(best.dtype), int(_bits(best)), int(n), int(pulls)


def check_entry(cuda, card: str) -> dict:
    """The entry module's programs, checked before its path uses them,
    then the path.  `sharded_score_and_select` (K11 a shard, the
    all-gather, K6) on VirtualMeshes of (evals, nodes) in ENTRY_MESHES on
    the card, over every score scenario at the 16,384-row arena (10,000
    candidates, limit 14), f64 and f32: (row, best, feasible count,
    pulls) bit-equal to K1's single select, to the program's twin on
    the card and to K1's twin on the CPU; once on the one-rank NCCL
    DistMesh.  `sharded_batch_plan` (the node-axis all-gathers, K10 an
    eval row) at E = ENTRY_E, P = ENTRY_P on the same meshes, f64 and
    f32: rows equal to K10's on the whole batch and (f64) to the
    program's CPU twin from a helper.  Then `dryrun_multichip(8)` on the
    card, its K11, K6, K10, K12 and K13 counts set to 0 just before and
    read just after: its select, rows and placements (by node name)
    equal to the same call on the CPU (a helper's), and K11 launched
    once a node shard, K6 once, K10 once an eval row."""
    import torch

    from nomad_tpu_torch.entry import dryrun_multichip
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import SCORE_SCENARIOS
    from nomad_tpu_torch.parallel.mesh import (
        VirtualMesh,
        mesh_axes,
        sharded_batch_plan,
        sharded_chained_plan_cuda,
        sharded_score_and_select,
        sharded_score_and_select_twin,
    )
    from nomad_tpu_torch.state.convert import score_inputs_from_numpy

    max_err = 0.0
    selects = plans = placed = 0
    for dtype in (torch.float64, torch.float32):
        for scenario in sorted(SCORE_SCENARIOS):
            case = _entry_select_case(scenario)
            inp = score_inputs_from_numpy(case, cuda, dtype=dtype)
            k1 = tscore.score_select_cuda(inp)
            want = (k1.out_i[0], k1.best[0], k1.out_i[2], k1.out_i[1])
            key = _select_key(want)
            tag = f"sharded_score_and_select {dtype} {scenario}"
            cpu = tscore.score_and_select_twin(
                score_inputs_from_numpy(case, "cpu", dtype=dtype))
            check(_select_key(cpu) == key, f"{tag}: K1 != its twin on CPU")
            for evals, nodes in ENTRY_MESHES:
                mesh = VirtualMesh(nodes, cuda, n_evals=evals)
                got = sharded_score_and_select(mesh)(inp)
                where = f"{tag} on {evals} x {nodes}"
                check(_select_key(got) == key, f"{where}: != K1 on the card")
                twin = sharded_score_and_select_twin(mesh)(inp)
                check(_select_key(twin) == key, f"{where}: != its twin on card")
                d = float(got[1]) - float(want[1])
                if math.isfinite(d):
                    max_err = max(max_err, abs(d))
                selects += 1
            if dtype == torch.float64 and scenario == "mixed":
                got = sharded_score_and_select(nccl_mesh(cuda))(inp)
                check(_select_key(got) == key,
                      f"{tag} on the NCCL DistMesh: != K1 on the card")
                selects += 1
    for dtype in (torch.float64, torch.float32):
        cols, batch, n_cand = _entry_batch_args(cuda, dtype)
        k10 = tbatch.batch_plan_picks_cuda(*cols, batch, n_cand, ENTRY_P).cpu()
        cpu = None
        if dtype == torch.float64:
            with SPLIT("wait"):
                cpu = HELPERS.get("entry-k10")
        for evals, nodes in ENTRY_MESHES:
            mesh = VirtualMesh(nodes, cuda, n_evals=evals)
            rows = sharded_batch_plan(mesh, n_cand, ENTRY_P)(*cols, batch).cpu()
            where = f"sharded_batch_plan {dtype} on {evals} x {nodes}"
            check(tuple(rows.shape) == (ENTRY_E, ENTRY_P), f"{where}: shape")
            check(torch.equal(rows, k10), f"{where}: != K10 on the card")
            if cpu is not None:
                check(torch.equal(rows, cpu), f"{where}: != its twin on CPU")
            placed += int((rows >= 0).sum())
            plans += 1
    check(placed > 0, "sharded_batch_plan placed nothing")
    print(f"entry programs: sharded_score_and_select {selects} runs on "
          f"(evals, nodes) {list(ENTRY_MESHES)} and the NCCL DistMesh, every "
          f"one bit-equal to K1 and to the twins ({len(SCORE_SCENARIOS)} "
          f"scenarios, f64 and f32, {C_CHECK} rows); sharded_batch_plan "
          f"{plans} runs at E = {ENTRY_E}, P = {ENTRY_P}, rows equal to K10 "
          f"and the CPU twin ({placed} placed picks)", flush=True)

    counted = {"score_all": tscore.score_all_cuda,
               "walk_only": tscore.walk_only_cuda,
               "batch_plan_picks": tbatch.batch_plan_picks_cuda,
               "sharded_chained_plan": sharded_chained_plan_cuda,
               "patch_rows_sharded": tbatch.patch_rows_sharded_cuda}
    for w in counted.values():
        w.launches = 0
    t0 = time.perf_counter()
    dry = dryrun_multichip(ENTRY_DRYRUN)
    dry_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counted.items()}
    evals, nodes = mesh_axes(ENTRY_DRYRUN)
    with SPLIT("wait"):
        ref = HELPERS.get("entry-dryrun-cpu")
    check(tuple(dry["axes"]) == tuple(ref["axes"]) == (evals, nodes),
          f"the dryrun's mesh {dry['axes']}")
    check(_select_key(dry["select"]) == _select_key(ref["select"]),
          "the dryrun's select differs between the card and the CPU")
    check(torch.equal(dry["rows"], ref["rows"]),
          "the dryrun's rows differ between the card and the CPU")
    check(dry["placements"] == ref["placements"],
          f"the dryrun's placements differ: card {dry['placements']}, CPU "
          f"{ref['placements']}")
    check(dry["worker"]["errors"] == 0, f"the dryrun's worker: {dry['worker']}")
    for name, want in (("score_all", nodes), ("walk_only", 1),
                       ("batch_plan_picks", evals)):
        check(launches[name] == want,
              f"{name}: {launches[name]} launches on the entry path, {want} "
              "expected")
    check(launches["sharded_chained_plan"] > 0,
          "K12 was not launched by the dryrun's meshed Server")
    print(f"entry path on {card}: dryrun_multichip({ENTRY_DRYRUN}) on a "
          f"{evals} x {nodes} VirtualMesh in {dry_s:.2f} s, select "
          f"{_select_key(dry['select'])}, rows {dry['rows'].tolist()}, "
          f"{len(dry['placements'])} placements, worker "
          f"{json.dumps(dry['worker'])}: equal to the CPU run; launches "
          f"{json.dumps(launches)}", flush=True)
    return {"max_abs_err": max_err, "launches": launches, "dryrun_s": dry_s,
            "selects": selects, "plans": plans}


def time_entry_programs(cuda) -> dict:
    """`sharded_score_and_select` on K1's timing case (the 16,384-row
    arena, `mixed`, limit 14, f64) and `sharded_batch_plan` on the check's
    batch (E = ENTRY_E, P = ENTRY_P, f64), each on the 2 x 4 VirtualMesh
    of the dryrun, timed with CUDA events beside its twin on the card;
    the select also at 1 x 1 and 1 x 8.  Each call's K11, K6 and K10
    launches are counted.  Bounds: the inputs read once and the outputs
    written once (for the select every column at all C positions, as
    K1's; for the planner the candidate region, as K10's), the
    operations of the walk positions this run reaches; the bytes the
    all-gathers move are beside them."""
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.parallel.mesh import (
        VirtualMesh,
        sharded_batch_plan,
        sharded_batch_plan_twin,
        sharded_score_and_select,
        sharded_score_and_select_twin,
    )
    from nomad_tpu_torch.state.convert import score_inputs_from_numpy

    wrappers = (tscore.score_all_cuda, tscore.walk_only_cuda,
                tbatch.batch_plan_picks_cuda)
    saved = tuple(w.launches for w in wrappers)

    def launched(fn) -> dict:
        before = [w.launches for w in wrappers]
        out = fn()
        torch.cuda.synchronize()
        counts = {n: w.launches - b for n, w, b in zip(
            ("score_all", "walk_only", "batch_plan_picks"), wrappers, before)}
        return out, {k: v for k, v in counts.items() if v}

    f8 = 8
    inp = score_inputs_from_numpy(_entry_select_case("mixed"), cuda)
    shapes = {}
    for evals, nodes in ENTRY_MESHES:
        run = sharded_score_and_select(VirtualMesh(nodes, cuda, n_evals=evals))
        shapes[(evals, nodes)] = run
    mesh = VirtualMesh(4, cuda, n_evals=2)
    run = shapes[(2, 4)]
    out, per_call = launched(lambda: run(inp))
    pulls = int(out[3])
    select = {
        "ms": cuda_time_ms(lambda: run(inp), n=200, warmup=5),
        "plain_ms": cuda_time_ms(
            lambda: sharded_score_and_select_twin(mesh)(inp), n=20, warmup=2),
        # every input column read once (all C walk positions) and 16
        # bytes written, as K1's
        "bytes": C_CHECK * (8 * f8 + 2 * 1 + 2 * 4) + 16,
        # the all-gathered scores and feasibility: written, then walked
        "exchange_bytes": 2 * C_CHECK * (f8 + 1),
        "pulls": pulls,
        "flops": pulls * FLOPS_PER_CANDIDATE,
        "shape": f"C = {C_CHECK:,}, mixed, limit 14, 2 x 4",
        "launches_per_call": per_call,
    }
    for (evals, nodes), r in shapes.items():
        if (evals, nodes) != (2, 4):
            select[f"ms_{evals}x{nodes}"] = cuda_time_ms(
                lambda: r(inp), n=200, warmup=5)
    cols, batch, n_cand = _entry_batch_args(cuda, torch.float64)
    plan = sharded_batch_plan(mesh, n_cand, ENTRY_P)
    q = tbatch.prepare_batched(*cols, batch, n_cand, ENTRY_P)
    reach = int(tbatch.launch_batch_plan(q)[1].sum())
    rows, per_plan = launched(lambda: plan(*cols, batch))
    _twin, twin_ms = cuda_time_once(
        lambda: sharded_batch_plan_twin(mesh, n_cand, ENTRY_P)(*cols, batch))
    check(torch.equal(rows.cpu(), _twin.cpu()),
          "sharded_batch_plan at its timing shape: != its twin on card")
    batched = {
        "ms": cuda_time_ms(lambda: plan(*cols, batch), n=50, warmup=3),
        "plain_ms": twin_ms,
        # K10's: the candidate region, its per-eval columns and perm
        "bytes": _candidate_bytes(q, 3 * f8, (1 + 1 + 4 + 4 + 8) + 3 * f8),
        # the all-gathered [E, C] fields of each eval row: written, read
        "exchange_bytes": 2 * C_CHECK * (
            3 * f8 + ENTRY_E * (1 + 3 * f8 + 4 + 1 + f8 + 4)),
        "pulls": reach,
        "flops": reach * FLOPS_PER_CANDIDATE,
        "shape": f"C = {C_CHECK:,}, E = {ENTRY_E}, P = {ENTRY_P}, 2 x 4",
        "launches_per_call": per_plan,
        "k10_ms": cuda_time_ms(lambda: tbatch.launch_batch_plan(q), n=50,
                               warmup=3),
    }
    for w, n in zip(wrappers, saved):
        w.launches = n
    print(f"entry programs' timing (f64, CUDA events, 2 x 4 VirtualMesh on "
          f"one card) on {device_line()}: sharded_score_and_select "
          f"{select['ms']:.6f} ms (1 x 1 {select['ms_1x1']:.6f}, 1 x 8 "
          f"{select['ms_1x8']:.6f}), twin {select['plain_ms']:.6f} ms, "
          f"{json.dumps(per_call)} a call, {pulls} pulls; sharded_batch_plan "
          f"{batched['ms']:.6f} ms (K10 alone on the whole batch "
          f"{batched['k10_ms']:.6f}), twin {twin_ms:.6f} ms, "
          f"{json.dumps(per_plan)} a call, {reach} pulls", flush=True)
    return {"sharded_score_and_select": select, "sharded_batch_plan": batched}


# ---------------------------------------------------------------------------
# the helper processes: the twins and reference runs the checks compare
# against, computed beside the card phases
# ---------------------------------------------------------------------------

HELPER_WAIT_S = 900.0  # how long a phase waits for one helper result
HELPER_DIR = HERE / "build" / "chip_smoke_helpers"
# every helper process, in the order they start, and its torch threads
HELPER_THREADS = {"card-twins": 1, "twins-a": 2, "twins-b": 2, "host-a": 3,
                  "host-b": 3}


def _to_cpu(x):
    """A twin's result (tensors in tuples and NamedTuples) on the CPU."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _card():
    from nomad_tpu_torch.device import resolve_device

    return resolve_device(None)


def _k3_cpu(si: int, scenario: str, E: int, P: int):
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import chain_case
    from nomad_tpu_torch.state.convert import chain_case_to_torch

    cols, kw = chain_case(8000 + 10 * si + E, C_CHECK, N_CAND_CHECK, scenario,
                          E, P)
    cargs, ckwargs = chain_case_to_torch(cols, kw, "cpu", torch.float64)
    return tbatch.chained_plan_picks_cols(*cargs, return_carry=True, **ckwargs)


def _k5_scenarios():
    from nomad_tpu_torch.ops.cases import (
        POLICY_STORM_SCENARIOS,
        STORM_SCENARIOS,
        policy_storm_case,
        storm_case,
    )

    # the unweighted scenarios, then the weighted ones (policy rows)
    return [(s, storm_case, s) for s in STORM_SCENARIOS] + [
        (s, policy_storm_case, f"policy_{s}")
        for s in sorted(POLICY_STORM_SCENARIOS)]


def _k5_cpu(dtype_name: str, si: int, A: int):
    import torch

    from nomad_tpu_torch.ops import solve as tsolve
    from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

    dtype = getattr(torch, dtype_name)
    scenario, make, _tag = _k5_scenarios()[si]
    cols, inp, max_rounds = make(9500 + 10 * si + A, A, A, C_CHECK, scenario)
    return tsolve.storm_assignment_twin(storm_inputs(inp, "cpu", dtype),
                                        storm_columns(cols, "cpu", dtype),
                                        False, max_rounds)


def _k7_cpu(si: int, scenario: str, n_cand: int, E: int, P: int):
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import batch_shared_case
    from nomad_tpu_torch.state.convert import batch_shared_inputs_from_numpy

    case = batch_shared_case(9100 + 10 * si + E + P, C_CHECK, n_cand, scenario,
                             E, P)
    return tbatch.batch_plan_picks_shared_twin(
        **batch_shared_inputs_from_numpy(case, "cpu", torch.float64))


def _k9_batched_case(base: int, scenario: str, E: int, P: int):
    from nomad_tpu_torch.ops.cases import BATCHED_SCENARIOS, batched_case

    return batched_case(base + 10 * sorted(BATCHED_SCENARIOS).index(scenario) + E,
                        C_CHECK, N_CAND_CHECK, scenario, E, P)


def _k9_cpu(scenario: str, E: int, P: int):
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.state.convert import batched_case_to_torch

    cols, kw = _k9_batched_case(9300, scenario, E, P)
    cargs, ckw = batched_case_to_torch(cols, kw, "cpu", torch.float64)
    return tbatch.chained_plan_picks(*cargs, **ckw)


def _k9_shared_case(scenario: str, E: int, P: int):
    from nomad_tpu_torch.ops.cases import batch_shared_case

    return batch_shared_case(9350 + E + len(scenario), C_CHECK, N_CAND_CHECK,
                             scenario, E, P)


def _k9_shared_cpu(scenario: str, E: int, P: int):
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.state.convert import batch_shared_inputs_from_numpy

    return tbatch.chained_plan_picks_shared(**batch_shared_inputs_from_numpy(
        _k9_shared_case(scenario, E, P), "cpu", torch.float64))


def _k10_inputs(scenario: str, nc_mode: str, E: int, P: int, dev, dtype):
    from nomad_tpu_torch.state.convert import batched_case_to_torch

    cols, kw = _k9_batched_case(9400, scenario, E, P)
    if nc_mode == "scalar":
        kw["n_candidates"] = int(kw["n_candidates"].min())
    args, kwargs = batched_case_to_torch(cols, kw, dev, dtype)
    return args, kwargs.get("spread")


def _k10_carry_inputs(dev, dtype):
    """Phase k10's arena whose carry passes shared memory (`K10_CARRY`):
    `prepare_batched` arguments."""
    from nomad_tpu_torch.ops.cases import batched_case
    from nomad_tpu_torch.state.convert import batched_case_to_torch

    C, n, E, P = K10_CARRY
    cols, kw = batched_case(9450, C, n, "unlimited_evict", E, P)
    return batched_case_to_torch(cols, kw, dev, dtype)[0]


def _k10_twin(args, spread=None):
    """K10's twin over `batch_plan_picks` arguments: rows and pulls,
    [2, E, P] on the CPU."""
    import torch

    from nomad_tpu_torch.ops import batch as tbatch

    q = tbatch.prepare_batched(*args, spread=spread)
    return torch.stack(tbatch.batch_plan_twin(q)).cpu()


def _k10_cpu(scenario: str, nc_mode: str, E: int, P: int):
    import torch

    return _k10_twin(*_k10_inputs(scenario, nc_mode, E, P, "cpu",
                                  torch.float64))


def _k10_carry_cpu():
    import torch

    return _k10_twin(_k10_carry_inputs("cpu", torch.float64))


K9_SHARED_SHAPES = ((8, 16), (64, 10))  # phase k9's shared-mode (E, P)


def twin_jobs():
    """Every CPU twin (f64, and both dtypes for K5) that the phases k3,
    k5, k7, k9, k10, k12, k14 and entry hold their kernels against, in
    the order the phases ask for them: (key, function, arguments)."""
    from nomad_tpu_torch.ops.cases import BATCH_SHARED_SCENARIOS, CHAIN_SCENARIOS

    for si, scenario in enumerate(sorted(CHAIN_SCENARIOS)):
        for E, P in CHAIN_SHAPES:
            yield f"k3-{scenario}-{E}-{P}", _k3_cpu, (si, scenario, E, P)
    for dtype_name in ("float64", "float32"):
        for si, (_s, _make, tag) in enumerate(_k5_scenarios()):
            for A in STORM_ROWS:
                yield f"k5-{dtype_name}-{tag}-{A}", _k5_cpu, (dtype_name, si, A)
    for si, scenario in enumerate(BATCH_SHARED_SCENARIOS):
        for n_cand in K7_CANDS:
            for E, P in K7_SHAPES:
                yield (f"k7-{scenario}-{n_cand}-{E}-{P}", _k7_cpu,
                       (si, scenario, n_cand, E, P))
    for scenario in K9_SCENARIOS:
        for E, P in BATCHED_SHAPES:
            yield f"k9-{scenario}-{E}-{P}", _k9_cpu, (scenario, E, P)
    for E, P in K9_SHARED_SHAPES:
        yield f"k9s-mixed-{E}-{P}", _k9_shared_cpu, ("mixed", E, P)
    for scenario, nc_mode in K10_CASES:
        for E, P in BATCHED_SHAPES:
            yield (f"k10-{scenario}-{nc_mode}-{E}-{P}", _k10_cpu,
                   (scenario, nc_mode, E, P))
    yield "k10-carry", _k10_carry_cpu, ()
    for key, args in _k12_params():
        yield key, _k12_cpu_twin, args
    for d in K12_COUNTS:
        yield f"k12-sweep-{d}", _k12_sweep_cpu_twin, (d,)
    for key, args in _k14_params():
        yield key, _k14_cpu, args
    yield "entry-k10", _entry_batch_cpu, ()


def _k3_card(dtype_name: str, si: int, scenario: str, E: int, P: int):
    """Phase k3's twin on the card (the same inputs as its kernel run)."""
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import chain_case
    from nomad_tpu_torch.state.convert import chain_case_to_torch

    cols, kw = chain_case(8000 + 10 * si + E, C_CHECK, N_CAND_CHECK, scenario,
                          E, P)
    args, kwargs = chain_case_to_torch(cols, kw, _card(),
                                       getattr(torch, dtype_name))
    return _to_cpu(tbatch.chained_picks_twin(tbatch.prepare_chain(*args, **kwargs)))


def _k5_card(dtype_name: str, si: int, A: int):
    import torch

    from nomad_tpu_torch.ops import solve as tsolve
    from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

    dtype = getattr(torch, dtype_name)
    scenario, make, _tag = _k5_scenarios()[si]
    cols, inp, max_rounds = make(9500 + 10 * si + A, A, A, C_CHECK, scenario)
    card = _card()
    return _to_cpu(tsolve.storm_assignment_twin(
        storm_inputs(inp, card, dtype), storm_columns(cols, card, dtype), False,
        max_rounds))


def _k9_card(dtype_name: str, scenario: str, E: int, P: int):
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.state.convert import batched_case_to_torch

    cols, kw = _k9_batched_case(9300, scenario, E, P)
    args, kwargs = batched_case_to_torch(cols, kw, _card(),
                                         getattr(torch, dtype_name))
    return tbatch.chained_plan_picks_twin(*args, **kwargs).cpu()


def _k9_shared_card(dtype_name: str, scenario: str, E: int, P: int):
    import torch

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.state.convert import batch_shared_inputs_from_numpy

    return tbatch.chained_plan_picks_shared_twin(**batch_shared_inputs_from_numpy(
        _k9_shared_case(scenario, E, P), _card(),
        getattr(torch, dtype_name))).cpu()


def _k10_card(dtype_name: str, scenario: str, nc_mode: str, E: int, P: int):
    import torch

    return _k10_twin(*_k10_inputs(scenario, nc_mode, E, P, _card(),
                                  getattr(torch, dtype_name)))


def _k10_carry_card(dtype_name: str):
    import torch

    return _k10_twin(_k10_carry_inputs(_card(), getattr(torch, dtype_name)))


def _k12_card(dtype_name: str, scenario: str, E: int, P: int, d: int,
              chunk=None):
    """Phase k12's twin on a VirtualMesh of d shards on the card."""
    import torch

    from nomad_tpu_torch.parallel.mesh import VirtualMesh, sharded_chained_plan_twin

    return k12_run(VirtualMesh(d, _card()), sharded_chained_plan_twin,
                   _k12_case(scenario, E, P), getattr(torch, dtype_name), chunk)


def card_twin_jobs():
    """Every twin on the card that the phases k3, k5, k9, k10, k12 and k14
    hold their kernels against (f64 and f32), in the order they ask for
    them: (key, function, arguments)."""
    from nomad_tpu_torch.ops.cases import CHAIN_SCENARIOS, SHARDED_CHAIN_SCENARIOS

    both = ("float64", "float32")
    for dt in both:
        for si, scenario in enumerate(sorted(CHAIN_SCENARIOS)):
            for E, P in CHAIN_SHAPES:
                yield (f"card-k3-{dt}-{scenario}-{E}-{P}", _k3_card,
                       (dt, si, scenario, E, P))
    for dt in both:
        for si, (_s, _make, tag) in enumerate(_k5_scenarios()):
            for A in STORM_ROWS:
                yield f"card-k5-{dt}-{tag}-{A}", _k5_card, (dt, si, A)
    for dt in both:
        for scenario in K9_SCENARIOS:
            for E, P in BATCHED_SHAPES:
                yield (f"card-k9-{dt}-{scenario}-{E}-{P}", _k9_card,
                       (dt, scenario, E, P))
        for E, P in K9_SHARED_SHAPES:
            yield (f"card-k9s-{dt}-mixed-{E}-{P}", _k9_shared_card,
                   (dt, "mixed", E, P))
    for dt in both:
        for scenario, nc_mode in K10_CASES:
            for E, P in BATCHED_SHAPES:
                yield (f"card-k10-{dt}-{scenario}-{nc_mode}-{E}-{P}", _k10_card,
                       (dt, scenario, nc_mode, E, P))
        yield f"card-k10-carry-{dt}", _k10_carry_card, (dt,)
    for scenario in SHARDED_CHAIN_SCENARIOS:
        for dt, counts in (("float64", K12_COUNTS), ("float32", (8,))):
            for d in counts:
                yield (f"card-k12-{dt}-{scenario}-{d}", _k12_card,
                       (dt, scenario, *K12_SHAPE, d))
    E, P, chunk = K12_FULL
    for d in (1, 8):
        yield (f"card-k12-full-{d}", _k12_card,
               ("float64", "everything", E, P, d, chunk))
    for key, args in _k14_params():
        yield f"card-{key}", _k14_card, args


def host_jobs(name: str):
    """The path phases' reference runs, in the order they ask for them:
    host-a the CPU twins' and the host oracle's runs of phases 4 and 8,
    the storm, preempt, bridge and device phases; host-b the policy
    phase's and the entry phase's CPU dryrun."""
    if name == "host-a":
        yield "main-cpu", run_stream, ("cpu",)
        yield ("main-oracle", run_stream,
               ("oracle", N_NODES, N_ALLOCS, None, ORACLE_EVALS))
        yield "server-oracle", server_oracle_reference, ()
        yield "storm-cpu", run_storm, ("cpu", True, "storm on, cpu")
        yield "preempt-cpu", run_preempt, ("cpu",)
        yield "preempt-oracle", run_preempt, ("oracle",)
        yield "bridge-cpu", bridge_cpu_reference, ()
        yield "device-cpu", device_cpu_reference, ()
    else:
        yield "policy-cpu", run_policy, ("cpu",)
        yield "policy-oracle", run_policy, ("oracle", None, POLICY_ORACLE_STEPS)
        yield ("policy-storm-cpu", run_storm,
               ("cpu", True, "weighted storm, cpu", None, True))
        yield "entry-dryrun-cpu", _entry_dryrun_cpu, ()
        yield "multihost-cpu", multihost_reference, ()


def helper_jobs(name: str) -> list:
    """The jobs of helper `name`: (key, function, arguments)."""
    if name == "card-twins":
        return list(card_twin_jobs())
    if name in ("twins-a", "twins-b"):
        # twins-a: the storm solves' (K5's and K14's)
        storm = name == "twins-a"
        return [j for j in twin_jobs()
                if j[0].startswith(("k5-", "k14-")) == storm]
    if name in ("host-a", "host-b"):
        return list(host_jobs(name))
    raise ValueError(f"no helper {name}")


def helper_main(name: str, out_dir: str) -> int:
    """A helper process: every job of `helper_jobs(name)` in order, each
    result saved as <key>.pt (written under a temporary name, then
    renamed), then DONE with its seconds.  Its references are twins and
    host runs: a kernel build or launch here is a failure."""
    sys.path.insert(0, str(HERE))
    import torch

    from nomad_tpu_torch.ops import _cuda

    def no_kernels(*_args, **_kwargs):
        raise SmokeFailure(f"helper {name} reached a kernel")

    _cuda.build_all = _cuda.library = no_kernels
    torch.set_num_threads(HELPER_THREADS[name])
    out = Path(out_dir)
    t_all = time.perf_counter()
    for key, fn, args in helper_jobs(name):
        t0 = time.perf_counter()
        result = fn(*args)
        tmp = out / f"{key}.pt.tmp"
        torch.save(result, tmp)
        os.replace(tmp, out / f"{key}.pt")
        log(f"{name} {key}: {time.perf_counter() - t0:.2f} s")
    (out / "DONE").write_text(f"{time.perf_counter() - t_all:.1f}\n")
    return 0


class Helper:
    """One helper process, started at the top of the script with its
    torch threads capped, while the card phases run; a phase takes each
    result from it when it needs it (`get`)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.dir = HELPER_DIR / name
        self.proc = None
        self.log_file = None

    def start(self) -> None:
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        threads = str(HELPER_THREADS[self.name])
        env = dict(os.environ, OMP_NUM_THREADS=threads, MKL_NUM_THREADS=threads)
        self.log_file = open(self.dir / "log.txt", "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--helper", self.name,
             str(self.dir)], cwd=str(HERE), env=env,
            stdout=self.log_file, stderr=subprocess.STDOUT)

    def _tail(self) -> str:
        try:
            return (self.dir / "log.txt").read_text()[-2000:]
        except OSError:
            return ""

    def get(self, key: str):
        import torch

        path = self.dir / f"{key}.pt"
        deadline = time.monotonic() + HELPER_WAIT_S
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                raise SmokeFailure(
                    f"helper {self.name} exited {self.proc.returncode} before "
                    f"{key}: {self._tail()}")
            if time.monotonic() > deadline:
                raise SmokeFailure(f"no result {key} from helper {self.name} "
                                   f"within {HELPER_WAIT_S} s")
            time.sleep(0.05)
        return torch.load(path, weights_only=False)

    def wait(self, timeout: float) -> None:
        """Until the process has ended; a failure if it failed or is
        still running after `timeout` seconds."""
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"helper {self.name} still running after "
                               f"{timeout} s") from None
        if rc != 0:
            raise SmokeFailure(f"helper {self.name} exited {rc}: {self._tail()}")

    def finished_s(self):
        """The process's own seconds once it is done, else None."""
        done = self.dir / "DONE"
        return float(done.read_text()) if done.exists() else None

    def stop(self) -> None:
        if self.proc is not None:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait(30)
        if self.log_file is not None:
            self.log_file.close()


class Helpers:
    """Every helper process, and which of them computes each result."""

    def __init__(self) -> None:
        self.procs = {}
        self.owner = {}

    def start(self) -> None:
        for name in HELPER_THREADS:
            helper = self.procs[name] = Helper(name)
            helper.start()
            for key, _fn, _args in helper_jobs(name):
                self.owner[key] = helper

    def get(self, key: str):
        if key not in self.owner:
            raise SmokeFailure(f"no helper computes {key}")
        return self.owner[key].get(key)

    def wait_all(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        for helper in self.procs.values():
            helper.wait(max(0.0, deadline - time.monotonic()))

    def seconds(self) -> dict:
        return {name: h.finished_s() for name, h in self.procs.items()}

    def stop(self) -> None:
        for helper in self.procs.values():
            helper.stop()


HELPERS = Helpers()


PATH_PHASES = ("main", "server", "storm", "preempt", "policy", "bridge",
               "mesh", "entry", "device", "multihost", "bench")


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--helper":
        return helper_main(sys.argv[2], sys.argv[3])
    if sys.argv[1:] == ["--idle-probes"]:
        return idle_probes_main()
    if not os.environ.get("PYTHONHASHSEED", "").isdigit():
        # one hash seed for this process and every helper it starts
        os.environ["PYTHONHASHSEED"] = str(random.randrange(1, 2**32))
        os.execv(sys.executable, [sys.executable, str(Path(__file__).resolve()),
                                  *sys.argv[1:]])
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

    t_start = time.perf_counter()
    cuda = resolve_device(None)
    rep = device_report(cuda)
    smi = rep["nvidia_smi"] or "nvidia-smi unavailable"
    card = f"{rep['name']} ({smi})"
    print(f"device: {rep['name']}, count {rep['count']}, nvidia-smi: {smi}; "
          f"PYTHONHASHSEED {os.environ['PYTHONHASHSEED']}", flush=True)
    # the twins and reference runs of the checks run beside the card phases
    HELPERS.start()
    try:
        return _build_and_run(cuda, card, smi, t_start)
    finally:
        close_nccl()
        HELPERS.stop()


def _build_and_run(cuda, card, smi, t_start) -> int:
    from nomad_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s (parallel nvcc): "
          + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in built.items()),
          flush=True)
    for k, v in built.items():
        for line in v["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k}: {line.strip()}")

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops import solve as tsolve
    from nomad_tpu_torch.parallel.mesh import sharded_chained_plan_cuda

    import torch

    # K9 shared, which no path of either package calls; K11, which only
    # the entry path calls (a stage of sharded_score_and_select); K12-K14,
    # whose path is the mesh phase's (K12 and K13 also the bench's
    # multichip block); and K15, whose path (the multihost phase's) runs
    # in processes of its own: their counts are set to 0 before every
    # phase and read after it
    uncalled = {"chained_plan_picks_shared": tbatch.chained_plan_picks_shared_cuda,
                "score_all": tscore.score_all_cuda,
                "sharded_chained_plan": sharded_chained_plan_cuda,
                "patch_rows_sharded": tbatch.patch_rows_sharded_cuda,
                "storm_assignment_sharded": tsolve.storm_assignment_sharded_cuda,
                "patch_rows_hostlocal": tbatch.patch_rows_hostlocal_cuda}
    uncalled_by_phase = {}
    failures = []
    results = {}
    pauses = {}
    split = {}
    gc.callbacks.append(GC_PAUSES)
    for name, fn in (("k1", lambda: check_k1(cuda)),
                     ("k2", lambda: check_k2(cuda)),
                     ("main", lambda: check_main_path(cuda, card)),
                     ("k3", lambda: check_k3(cuda)),
                     ("k4", lambda: check_k4(cuda)),
                     ("server", lambda: check_server(cuda, card)),
                     ("k5", lambda: check_k5(cuda)),
                     ("storm", lambda: check_storm(cuda, card)),
                     ("k6", lambda: check_k6(cuda)),
                     ("preempt", lambda: check_preempt(cuda, card)),
                     ("policy", lambda: check_policy(cuda, card)),
                     ("k7", lambda: check_k7(cuda)),
                     ("bridge", lambda: check_bridge(cuda, card)),
                     ("k8", lambda: check_k8(cuda)),
                     ("k9", lambda: check_k9(cuda)),
                     ("k10", lambda: check_k10(cuda)),
                     ("k11", lambda: check_k11(cuda)),
                     ("k12", lambda: check_k12(cuda)),
                     ("k13", lambda: check_k13(cuda)),
                     ("k14", lambda: check_k14(cuda)),
                     ("k15", lambda: check_k15(cuda)),
                     ("mesh", lambda: check_mesh(cuda, card, results)),
                     ("entry", lambda: check_entry(cuda, card)),
                     ("device", lambda: check_device(cuda, card)),
                     ("multihost", lambda: check_multihost(cuda, card)),
                     ("bench", lambda: check_bench(cuda, card)),
                     ("timing", lambda: time_kernels(cuda))):
        t0 = time.perf_counter()
        GC_PAUSES.reset()
        SPLIT.reset()
        for wrapper in uncalled.values():
            wrapper.launches = 0
        try:
            if name == "device":
                # the supervisor's watchdogs run with no helper beside them
                with SPLIT("wait"):
                    HELPERS.wait_all(HELPER_WAIT_S)
            results[name] = fn()
        except SmokeFailure as e:
            failures.append(f"{name}: {e}")
            print(f"FAILED {name}: {e}", flush=True)
            log(f"FAILED {name}: {e}")
        uncalled_by_phase[name] = {k: w.launches for k, w in uncalled.items()}
        pauses[name] = GC_PAUSES.summary()
        total = time.perf_counter() - t0
        split[name] = dict(SPLIT.seconds, total=total, card=total - sum(
            SPLIT.seconds.values()))
        log(f"phase {name}: {total:.1f}s, ending {time.perf_counter() - t_start:.1f}s "
            f"after the start; host seconds by kind "
            f"{json.dumps(split[name])}; collector "
            f"pauses inside it {json.dumps(pauses[name])}")
    gc.callbacks.remove(GC_PAUSES)
    print(f"phase seconds (host clock; world builds, waits for the helper "
          f"processes, the rest on the card): "
          f"{json.dumps(split)}", flush=True)
    worst = max(pauses, key=lambda k: pauses[k]["max_s"])
    print(f"collector pauses (host clock, gc.callbacks; the harness's own "
          f"collections between worlds left out): longest {pauses[worst]['max_s']:.3f} s "
          f"(generation {pauses[worst]['max_gen']}, phase {worst}), "
          f"{sum(p['total_s'] for p in pauses.values()):.2f} s in all; one "
          f"full collection over a live world at most "
          f"{GC_PAUSES.world_collect_s:.3f} s; by phase {json.dumps(pauses)}",
          flush=True)
    print(f"the helper processes (torch threads {json.dumps(HELPER_THREADS)}) "
          f"took {json.dumps(HELPERS.seconds())} s of their own beside the "
          f"card phases", flush=True)
    # each check of K9 shared and K11 launched its kernel once a case;
    # K12-K14 as their checks' reads, K14's against its cases' stage counts
    checked = {"chained_plan_picks_shared": uncalled_by_phase["k9"][
                   "chained_plan_picks_shared"],
               "score_all": uncalled_by_phase["k11"]["score_all"],
               "sharded_chained_plan": uncalled_by_phase["k12"][
                   "sharded_chained_plan"],
               "patch_rows_sharded": uncalled_by_phase["k13"][
                   "patch_rows_sharded"],
               "storm_assignment_sharded": uncalled_by_phase["k14"][
                   "storm_assignment_sharded"],
               "patch_rows_hostlocal": uncalled_by_phase["k15"][
                   "patch_rows_hostlocal"]}
    if not failures:
        for name, want in (("chained_plan_picks_shared",
                            results["k9"]["shared_cases"]),
                           ("score_all", results["k11"]["cases"]),
                           ("storm_assignment_sharded",
                            results["k14"]["launches"]),
                           ("patch_rows_sharded", results["k13"]["launches"]),
                           ("patch_rows_hostlocal",
                            results["k15"]["launches"])):
            if checked[name] != want:
                failures.append(f"{name}: {checked[name]} launches in its "
                                f"check phase for {want} expected")
        # the mesh path's own counts, set to 0 before it and read after
        for name, n in results["mesh"]["launches"].items():
            if uncalled_by_phase["mesh"][name] != n:
                failures.append(f"{name}: the mesh phase read {n} launches, "
                                f"the phase loop {uncalled_by_phase['mesh'][name]}")
    if failures:
        # on both streams: a caller may keep only the end of one of them
        print(f"chip_smoke failed: {failures}", flush=True)
        log(f"chip_smoke failed: {failures}")
        return 1

    launches = dict(results["main"]["launches"])
    launches.update(results["server"]["launches"])
    launches["storm_solve"] = results["storm"]["launches"]["storm_solve"]
    launches["walk_only"] = results["preempt"]["launches"]["walk_only"]
    launches["batch_picks"] = results["bridge"]["launches"]["batch_picks"]
    launches["canary"] = results["device"]["launches"]["canary"]
    # the bench's path (its own process, counts from 0): K9 and K10
    for name in ("chained_plan_picks", "batch_plan_picks"):
        launches[name] = results["bench"]["launches"][name]
    # K9 shared and K11: their counts read over every path's phase (the
    # bench's from its own process); K12-K14: the mesh path's
    for name in uncalled:
        launches[name] = results["bench"]["launches"].get(name, 0) + sum(
            uncalled_by_phase[p][name] for p in PATH_PHASES)
    launches.update(results["mesh"]["launches"])
    # K15's path runs in the multihost phase's processes: their counts
    multihost = results["multihost"]["launches"]
    launches["patch_rows_hostlocal"] = multihost["patch_rows_hostlocal"]
    # the kernels redesigned as one cooperative launch a chunk
    redesigned = {"chained_picks": "redesigned, PR 16",
                  "sharded_chained_plan": "redesigned, PR 16"}
    # the storm auction, one cooperative launch a solve since its redesign
    redesigned.update(dict.fromkeys(
        ("storm_solve", "storm_assignment_sharded"),
        "redesigned: one cooperative launch a solve"))
    # the shared pick body: each pick scores only the positions it reaches
    redesigned.update(dict.fromkeys(
        ("plan_picks", "batch_picks"),
        "redesigned: a prefix walk a pick, a position scored once an eval "
        "until it is won"))
    redesigned["score_select"] = (
        "redesigned: two launch shapes by its rule, a prefix walk where the "
        "limit lies below the candidates, else one cooperative grid whose "
        "per-block summaries one warp combines")
    redesigned["walk_only"] = (
        "redesigned: K1's two launch shapes by its rule over the given "
        "vectors, a prefix walk where the limit lies below the candidates, "
        "else the shared cooperative grid")
    redesigned["batch_plan_picks"] = (
        "redesigned: one 256-thread block an eval running K9's eval body "
        "in its per-eval mode, a prefix walk a pick")
    redesigned.update(dict.fromkeys(
        ("chained_plan_picks", "chained_plan_picks_shared"),
        "redesigned: a prefix walk a pick through the eval's perm, no "
        "gather of the region, the node-space carry overlaid by the eval's "
        "entries"))
    kernels = []
    for name, source, replaces, check_key in (
        ("score_select", "nomad_tpu_torch/csrc/score_select.cu",
         "nomad_tpu/ops/score.py:268", "k1"),
        ("plan_picks", "nomad_tpu_torch/csrc/plan_picks.cu",
         "nomad_tpu/ops/batch.py:766", "k2"),
        ("chained_picks", "nomad_tpu_torch/csrc/chained_picks.cu",
         "nomad_tpu/ops/batch.py:905", "k3"),
        ("patch_rows", "nomad_tpu_torch/csrc/patch_rows_mesh.cu",
         "nomad_tpu/ops/batch.py:1091", "k4"),
        ("storm_solve", "nomad_tpu_torch/csrc/storm_solve.cu",
         "nomad_tpu/ops/solve.py:113", "k5"),
        ("walk_only", "nomad_tpu_torch/csrc/walk_only.cu",
         "nomad_tpu/sched/tpu_stack.py:95", "k6"),
        ("batch_picks", "nomad_tpu_torch/csrc/batch_picks.cu",
         "nomad_tpu/ops/batch.py:1331", "k7"),
        ("canary", "nomad_tpu_torch/csrc/canary.cu",
         "nomad_tpu/device/supervisor.py:494", "k8"),
        ("chained_plan_picks", "nomad_tpu_torch/csrc/chained_batch.cu",
         "nomad_tpu/ops/batch.py:801", "k9"),
        ("chained_plan_picks_shared", "nomad_tpu_torch/csrc/chained_batch.cu",
         "nomad_tpu/ops/batch.py:1262", "k9"),
        ("batch_plan_picks", "nomad_tpu_torch/csrc/batch_plan.cu",
         "nomad_tpu/ops/batch.py:1391", "k10"),
        ("score_all", "nomad_tpu_torch/csrc/score_all.cu",
         "nomad_tpu/ops/score.py:282", "k11"),
        ("sharded_chained_plan", "nomad_tpu_torch/csrc/sharded_chain.cu",
         "nomad_tpu/parallel/mesh.py:484", "k12"),
        ("patch_rows_sharded", "nomad_tpu_torch/csrc/patch_rows_mesh.cu",
         "nomad_tpu/ops/batch.py:1130", "k13"),
        ("storm_assignment_sharded", "nomad_tpu_torch/csrc/storm_sharded.cu",
         "nomad_tpu/ops/solve.py:354", "k14"),
        ("patch_rows_hostlocal", "nomad_tpu_torch/csrc/patch_rows_mesh.cu",
         "nomad_tpu/ops/batch.py:1183", "k15"),
    ):
        tm = results["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": results[check_key]["max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
        })
        if name in redesigned:
            kernels[-1]["status"] = redesigned[name]
        if "blocks" in tm:
            # a cooperative launch's grid (1,024-thread blocks)
            kernels[-1]["blocks"] = tm["blocks"]
        # the policy path's own count, beside the main path's
        if name in results["policy"]["launches"]:
            kernels[-1]["launches_policy"] = results["policy"]["launches"][name]
        if name in checked:
            kernels[-1]["launches_check"] = checked[name]
        if "arena16k" in tm:
            kernels[-1]["arena16k"] = {k: tm["arena16k"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")}
        if name == "score_select":
            # K1's grid shape: the policy path's unlimited select
            kernels[-1]["policy_grid"] = {
                k: results["timing"]["score_select_policy"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")}
        if name == "walk_only":
            # K6's grid shape: an unlimited preemption walk
            kernels[-1]["grid"] = {k: tm["grid"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")}
        if "d8" in tm:
            # eight shards of a VirtualMesh on the one card
            kernels[-1]["d8"] = {k: tm["d8"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for k in ("call_ms", "wrapper_ms", "probe_host_ms"):
            if k in tm:
                # K4/K13/K15: the bound patch's checked call, the per-call
                # entry point (the kernel's "ms" is the flush's launch);
                # K8: the per-call entry point, the probe on the host
                # clock (its "ms" is the bound probe's launch)
                kernels[-1][k] = tm[k]
        if "flush3" in tm:
            # the mirror's three-column flush: the kernel's one launch, the
            # three index_copy_ calls, and the flush on the host clock
            kernels[-1]["flush3"] = {k: tm["flush3"][k] for k in (
                "ms", "library_ms", "bound_ms", "bound_by", "flush_host_ms",
                "shape")}
        if name in ("sharded_chained_plan", "patch_rows_sharded"):
            kernels[-1]["launches_bench"] = results["bench"]["launches"][name]
        if name == "sharded_chained_plan":
            kernels[-1]["chunks"] = results["bench"]["launches"][
                "sharded_chained_plan_chunks"]
            kernels[-1]["chunks_mesh"] = results["mesh"]["chunks"]
            kernels[-1]["launches_per_chunk"] = {
                "d1": tm["launches_per_chunk"],
                "d8": tm["d8"]["launches_per_chunk"]}
        if name in multihost:
            # the multihost path's processes (2 ranks, a pod head, a peer)
            kernels[-1]["launches_multihost"] = multihost[name]
        if name == "patch_rows_hostlocal":
            kernels[-1]["shape"] = tm["shape"]
        if name == "storm_assignment_sharded":
            kernels[-1]["rounds"] = tm["rounds"]
            kernels[-1]["launches_per_solve"] = {
                "d1": tm["launches_per_solve"],
                "d8": tm["d8"]["launches_per_solve"]}
    # the entry path's two programs, each with the kernels it launches:
    # their counts in the dryrun, set to 0 just before it
    dry = results["entry"]["launches"]
    for name, replaces, parts in (
        ("sharded_score_and_select", "nomad_tpu/parallel/mesh.py:278",
         (("score_all", "nomad_tpu_torch/csrc/score_all.cu"),
          ("walk_only", "nomad_tpu_torch/csrc/walk_only.cu"))),
        ("sharded_batch_plan", "nomad_tpu/parallel/mesh.py:793",
         (("batch_plan_picks", "nomad_tpu_torch/csrc/batch_plan.cu"),)),
    ):
        tm = results["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": parts[0][1],
            "replaces": replaces, "launches": sum(dry[k] for k, _ in parts),
            "max_abs_err": results["entry"]["max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
            "kernels": {k: {"source": src, "launches": dry[k],
                            "launches_per_call": tm["launches_per_call"].get(k, 0)}
                        for k, src in parts},
            "shape": tm["shape"], "exchange_bytes": tm["exchange_bytes"],
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
