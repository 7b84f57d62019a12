"""Batched evaluation pipeline: the production integration of the
(evals x nodes x picks) kernel.  Port of
`nomad_tpu/server/batch_worker.py`.

The per-eval device path pays one device round trip per placement.  The
BatchWorker instead:

1. drains up to E compatible evals from the broker in one gulp,
2. runs a host-side *simulation pre-pass* per eval — the same
   reconciler the scheduler will run (reference generic_sched.go:332
   computeJobAllocs) — predicting the stops, in-place updates,
   destructive evictions, reschedule penalties and placement count,
3. *prescores* the run through a three-stage pipeline — assemble
   (host numpy staging into a chunk-aligned arena), launch
   (non-blocking `chained_plan_picks_cols` dispatches of
   chunk-wide slices, each chained on the previous chunk's
   device-resident carry), fetch (wait on the chunk's event) — so chunk N
   executes on device while the host replays chunk N-1.  The chunk
   width is adapted per flush from the measured launch EWMAs
   (CHUNK_BUCKETS width ladder: wide under backlog, narrow
   when latency-bound), and the chain stays OPEN while it is in
   flight: evals dequeued while chunk N launches or replays are
   gated, simulated against the chain snapshot and assembled into
   chunk N+1 of the *same* chain (continuous micro-batching — see
   docs/ARCHITECTURE.md "Continuous micro-batching";
   NOMAD_TPU_ADMIT=0 restores the flush-boundary gulp loop).  Every
   eval's
   full pick sequence runs with in-kernel plan-delta accumulation
   (pre-placement usage deltas, per-pick destructive evictions,
   per-pick penalty rows, failure coalescing) and the same seeded
   visit orders the sequential path would use; the shared usage
   columns come from a persistent device mirror delta-patched via the
   store's dirty-row log (see docs/ARCHITECTURE.md "Prescore
   pipeline"),
4. runs each eval through the ordinary GenericScheduler so all control
   flow (reconciler, blocked evals, retries, plan bookkeeping, status
   writes) stays in one implementation — but with a `PrescoredStack`
   whose `select` answers from the precomputed rows after exact host
   verification (fit) of each winner; in-place update probes delegate
   to an inner oracle stack,
5. falls back to the normal scheduler for any eval whose shape deviates
   from what was prescored (networks, devices, sticky disk, multi
   task groups, preemption retries, option mismatches, verification
   mismatches), re-prescoring the rest of the run on a fresh snapshot
   whenever a deviation or failed pick makes the chained state suspect.

Because the kernel reproduces the sequential selection exactly
(ops/batch.py), prescored evals produce bit-identical plans; the
fallback guarantees correctness for everything else.

The port's device layer: the usage mirror is a set of torch tensors on
the worker's device, patched in place through kernel K4
(`ops.batch.patch_rows`); each chunk launches kernel K3
(`ops.batch.chained_plan_picks_cols`) and copies its rows and pulls
into pinned host memory behind an event.  Every launch, patch and copy
of one worker runs on one CUDA stream, so chunk N+1 reads chunk N's
carry in order, and the fetch is the only point at which the host
waits on the card.  On a CPU device the same code runs the twins
synchronously.  A failure of the prescore pipeline itself (assembly,
the mirror patch, a launch, a fetch) raises DeviceFault: the worker
nacks its leases and stops, and Server.drain_to_idle re-raises it.  It
never demotes a chain to the host oracle, which stays for the evals
the kernel does not model.

The global storm solver (NOMAD_TPU_STORM=1) coalesces a backlog of one
job family into a single (alloc rows x nodes) assignment solve, kernel
K5 (`ops.solve.storm_assignment`), on the same stream and against the
same K4-patched mirror; its members replay through the same prescored
machinery.  A failure of the storm's staging, solve or fetch raises
DeviceFault as well, and so does a failure of the per-eval device stack
(K1, K2, K6) under an eval that takes the sequential path.  Every
replay records its placement explanation in the port's explain ring
(a speculative replay's only when it commits).

The assemble, launch, fetch and storm_solve stages run under the
server's device supervisor (`device/supervisor.py`): a stage that
outlives its watchdog budget raises DeviceTimeout, the worker nacks
its leases once and HOLDS (it does not stop) while the supervisor is
LOST or RECOVERING; the supervisor's transition listener flushes the
usage mirror and the host-assembly caches, so the held evals are
placed on the card against a fresh mirror once the canary passes
again.  A policy-weighted eval (its job resolves a PolicySpec) ends
the chunk prefix and takes the per-eval path, whose stack fuses the
policy terms into K1; storms stay eligible, with policy rows staged
into the K5 solve.

The node-sharded mesh path: with the Server's ``mesh=`` (a
`parallel.mesh.VirtualMesh` of D shards on the worker's device, or a
`DistMesh`), or with NOMAD_TPU_MESH=1 and the `DistMesh` of the
torch.distributed group (joined first from the NOMAD_TPU_DIST* knobs,
NOMAD_TPU_SHARDS_PER_RANK shards a rank), the worker keeps a sharded
usage mirror on the mesh, runs every arena that tiles over the mesh (one
task group, no ports or devices, C % D == 0) as a chain of K12 chunks
threading a sharded carry, and solves storms with K14
(`ops.solve.storm_assignment_sharded`).  Other arenas take the K3 path,
as the JAX package routes them.  A mesh that cannot be built raises at
construction: nothing runs unsharded in its place.

A mesh over several processes (``mesh.hosts`` > 1) keeps each process's
mirror shards only: a full or bulk sync uploads this host's rows alone
(`parallel.mesh.mesh_put`), and a delta flush builds the shard-local
staging (`ops.batch.hostlocal_staging`) and stores it with one K15 launch
a column (`patch_rows_hostlocal`), so a warm flush costs each host
O(its dirty rows) bytes.  Every process must launch the same chunks in
the same order: in lockstep, as `parallel/dist_smoke.py` drives them, or
behind a pod head (NOMAD_TPU_POD_PORT, `parallel/pod.py`) that streams
each mirror sync, chain launch and storm solve to its peers before it
runs it.
"""
from __future__ import annotations

import contextlib
import logging
import random
import threading
from collections import deque
from dataclasses import dataclass, field
from dataclasses import replace as _dc_replace
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

LOG = logging.getLogger("nomad_tpu.server.batch_worker")

import numpy as np

import torch

from ..ops.batch import (
    ChainInputs,
    PreDeltas,
    SpreadInputs,
    StepDeltas,
    chained_plan_picks_cols,
    patch_rows,
    pow2_bucket as _pow2,
)
from ..ops.constraints import MaskCompiler
from ..sched.feasible import shuffle_permutation
from ..sched.generic_sched import GenericScheduler
from ..sched.rank import BinPackIterator, RankedNode
from ..sched.stack import GenericStack, compute_visit_limit
from ..sched.cuda_stack import _SingleNodeSource
from ..sched.util import ready_nodes_in_dcs
from ..structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    CONSTRAINT_DISTINCT_HOSTS,
    Evaluation,
    Job,
    TaskGroup,
)
from ..decisions import DECISIONS
from ..device import DeviceFault, DeviceLost, DeviceTimeout
from ..device.supervisor import HEALTHY
from ..explain import EXPLAIN
from ..raft import NotLeaderError
from ..raft import chaos as _chaos
from ..trace import TRACE
from .worker import Worker

BATCH_MAX = 64
BATCH_WAIT_S = 0.005
MAX_PENALTY_NODES = 8  # per-pick penalty row slots in StepDeltas
MAX_PRE_ROWS = 512  # pre-placement delta rows before falling back
# eval-axis widths of one pipelined prescore launch: every run is
# sliced into chunks chained through the kernel's carry output, so
# production launches share a SMALL set of eval-axis widths
# (padding waste is < one chunk per run instead of up to
# BATCH_MAX - 1) and chunk N's device time overlaps chunk N-1's host
# replay.  The width is chosen per flush from the measured launch
# EWMAs (_plan_chunk_width): the widest bucket under backlog (fewer
# dispatches), a narrow one when latency-bound (the first replay —
# and the first mid-chain admission point — arrives after ONE chunk's
# device time, not eight evals' worth).
CHUNK_BUCKETS = (2, 4, 8)
# widest chunk bucket, kept under its historical name: the assembly
# arena and warm_shapes use it as the default eval-axis alignment
PIPELINE_CHUNK = CHUNK_BUCKETS[-1]
# continuous micro-batching counters, zero-registered at Server
# construction (tools/check_stage_accounting.py check 10): every
# `admission.*` name the worker emits must appear here, so dashboards
# can tell "admission never engaged" from "admission not exported"
ADMISSION_COUNTERS = (
    "admission.admitted",
    "admission.deferred",
    "admission.chains",
)
# sharded (mesh) hot-path metrics, zero-registered at Server
# construction: every `mesh.*` name the worker emits must appear here,
# so dashboards can tell "mesh never engaged" from "mesh not exported".
# mesh.launches counts sharded chunk dispatches; the gauges carry the
# sharded mirror's sync cost (host->device bytes of the LAST mirror
# sync — O(dirty rows) on the warm path), the chunk width mesh flushes
# ran at, the processes the mesh spans (1: single host) and the
# sharded mirror's delta-hit rate
MESH_COUNTERS = ("mesh.launches",)
MESH_GAUGES = (
    "mesh.bytes_per_flush",
    "mesh.chunk_width",
    "mesh.hosts",
    "mesh.mirror_hit_rate",
)
# global storm solver (NOMAD_TPU_STORM=1) metrics, zero-registered at
# Server construction: every `storm.*` name the worker emits must
# appear here, so dashboards can tell "storm mode never engaged" from
# "storm not exported".  Counters: solver launches, evals entering the
# storm path, alloc rows the solver assigned, members that fell back
# to the sequential path, and rows whose global assignment diverged
# from the greedy serial walk.  Gauges: the last solve's auction
# rounds-to-converge and the family backlog the detector drained.
STORM_COUNTERS = (
    "storm.solves",
    "storm.evals",
    "storm.rows",
    "storm.fallbacks",
    "storm.divergent",
)
STORM_GAUGES = (
    "storm.rounds",
    "storm.backlog",
)
# optimistic parallel replay: below this many prescored evals in a run
# the speculative-wave dispatch overhead beats the win
REPLAY_MIN_WAVE = 2
# upper bound on retained dequeue timestamps: entries normally pop on
# ack/nack, but an eval that dies between dequeue and either would
# otherwise leak its stamp forever
DEQ_TS_MAX = 1024


class _Deviation(Exception):
    """The eval's control flow left the prescored fast path."""


class _SpecAbort(Exception):
    """Speculative replay left the provably-serial-equivalent path
    (e.g. its plan did not verify as a clean full commit against the
    wave snapshot); the eval must replay serially."""


_LRU_MISS = object()


class _LRUCache:
    """Bounded mapping with least-recently-used eviction: get()
    refreshes recency, put() evicts the coldest entry past capacity.
    Replaces the clear-all-on-overflow host-assembly caches, where a
    single one-off job spec used to evict every warm entry; stale-
    generation entries (generations are part of each key) now simply
    age out instead of forcing a flush."""

    __slots__ = ("cap", "_d")

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self._d: dict = {}

    def get(self, key):
        value = self._d.pop(key, _LRU_MISS)
        if value is _LRU_MISS:
            return None
        self._d[key] = value  # re-insert: now most recent
        return value

    def put(self, key, value) -> None:
        self._d.pop(key, None)
        self._d[key] = value
        while len(self._d) > self.cap:
            del self._d[next(iter(self._d))]

    def __len__(self) -> int:
        return len(self._d)


def _count_values(snap, attribute: str, allocs) -> Dict[str, int]:
    """Allocs per attribute value of their node — shared with
    PropertySet so the batch path's spread bookkeeping can never
    desynchronize from the sequential scheduler's."""
    from ..sched.propertyset import count_values_by_property

    return count_values_by_property(snap, attribute, allocs)


@dataclass
class _Sim:
    """Predicted pre-placement outcome of one eval (the simulation
    pre-pass's mirror of computeJobAllocs up to the select calls)."""

    placements: int
    penalties: List[FrozenSet[str]] = field(default_factory=list)
    # pre-placement usage deltas: row -> [cpu, mem, disk]
    pre: Dict[int, List[float]] = field(default_factory=dict)
    # per-pick destructive evictions (aligned with placements)
    evict_rows: List[int] = field(default_factory=list)
    evict_res: List[Tuple[float, float, float]] = field(
        default_factory=list
    )
    evict_coll: List[int] = field(default_factory=list)
    # task-group routing: the ordered distinct groups this eval
    # places, and each pick's slot into that list (the sequential
    # path iterates groups within one eval — generic_sched.go:468)
    tgs: List[TaskGroup] = field(default_factory=list)
    pick_tg: List[int] = field(default_factory=list)
    # anti-affinity base per group slot: [T, C] (None when all zero)
    base_collisions: Optional[np.ndarray] = None
    # distinct_hosts occupancy from job groups placing NOTHING this
    # eval: their live allocs block nodes but have no T-axis slot
    occ_extra: Optional[np.ndarray] = None
    # static host ports asked per group slot (kernel collision mask)
    asked_ports: List[FrozenSet[int]] = field(default_factory=list)
    # host ports freed by this eval's staged stops/evictions — if any
    # intersects an asked port in the run, the chain past that point
    # is gated to the sequential path (the kernel carry is monotone)
    released_ports: FrozenSet[int] = frozenset()
    # device asks per group slot: matched-code-set -> instance count
    # (ops/batch.py DeviceInputs; pooled counting is exact only for
    # identical-or-disjoint sets — overlap gates in _flush_run)
    asked_devices: List[Dict[FrozenSet[int], int]] = field(
        default_factory=list
    )
    # (vendor, type, name) keys of device instances this eval's
    # staged stops/evictions would free
    released_device_keys: FrozenSet[tuple] = frozenset()
    # the shuffled walk order the sequential stack would use for the
    # placement set_nodes — captured from the sim ctx's rng AFTER the
    # reconciler's single-node probes consumed their draws
    order: Optional[np.ndarray] = None
    # replay-time passthrough state (preemption retries): the order
    # actually used by the prescore (only when rng-aligned) + its
    # candidate count
    replay_order: Optional[np.ndarray] = None
    replay_n_cand: int = 0
    # propertyset state per (group, spread attribute): value -> count
    spread_existing: Dict[tuple, Dict[str, int]] = field(
        default_factory=dict
    )
    spread_cleared: Dict[tuple, Dict[str, int]] = field(
        default_factory=dict
    )
    spread_proposed: Dict[tuple, Dict[str, int]] = field(
        default_factory=dict
    )


@dataclass
class _Assembled:
    """One admitted chain's kernel inputs, staged host-side by
    ``_assemble`` (the pipeline's first stage).  Every per-eval array
    carries a leading eval axis of ``E`` rows — ``E_real`` real evals
    padded up to a multiple of ``chunk`` with inert rows
    (wanted=0, n_cand=1) — so the launch stage can slice
    ``chunk``-wide slices."""

    E_real: int
    E: int
    P: int
    T: int
    stacked: ChainInputs
    n_cands: np.ndarray  # i32[E]
    wanted: np.ndarray  # i32[E]
    spread_fit: bool
    coll0: Optional[np.ndarray]
    affinity: Optional[np.ndarray]
    spread: Optional[object]  # SpreadInputs
    deltas: StepDeltas
    pre: PreDeltas
    port_ask: Optional[np.ndarray]
    port_used0: Optional[np.ndarray]
    dev_ask: Optional[np.ndarray]
    dev_free0: Optional[np.ndarray]
    dev_aff: Optional[np.ndarray]
    dev_aff_on: Optional[np.ndarray]
    occ0: Optional[np.ndarray]
    dh_tg: Optional[np.ndarray]
    # the shared node columns every launch reads: the delta-patched
    # device mirror
    dev_cols: Optional[tuple] = None
    # eval-axis width this arena's E was aligned to (one launch =
    # one `chunk`-wide slice); chosen per flush by _plan_chunk_width
    chunk: int = PIPELINE_CHUNK
    # the arena runs on the node mesh (K12 chunks over the sharded
    # mirror); dev_cols is then the sharded mirror
    use_mesh: bool = False


class _AdmissionQueue:
    """Mid-chain eval intake for the continuous micro-batching
    pipeline: while a chunk chain is in flight, the worker polls the
    broker through one of these (non-blocking) and admits gate-clean
    evals as new chunks of the SAME chain.

    FIFO discipline is absolute — the chain commits its members in
    dequeue order, so an eval that fails an admission gate cannot be
    skipped over: it is parked on ``deferred`` (the worker holds its
    broker lease) and the queue CLOSES, guaranteeing no later dequeue
    jumps the serial order.  The caller processes ``deferred`` as the
    next gulp once the chain completes."""

    __slots__ = ("worker", "deferred", "closed", "admitted_any")

    def __init__(self, worker) -> None:
        self.worker = worker
        self.deferred: List[Tuple[Evaluation, str]] = []
        self.closed = False
        self.admitted_any = False

    def poll(self, limit: int) -> List[Tuple[Evaluation, str]]:
        """Dequeue up to ``limit`` already-queued evals without
        waiting (an empty broker ends the round, never blocks the
        chain)."""
        out: List[Tuple[Evaluation, str]] = []
        if self.closed or limit <= 0:
            return out
        worker = self.worker
        broker = worker.server.broker
        while len(out) < limit:
            try:
                ev, token = broker.dequeue(
                    worker.schedulers, timeout=0.0
                )
            except Exception:  # noqa: BLE001 — intake is best-effort
                break
            if ev is None:
                break
            worker._note_dequeue(ev)
            out.append((ev, token))
        return out

    def defer(self, ev: Evaluation, token: str) -> None:
        self.deferred.append((ev, token))
        self.closed = True


class _DoneFuture:
    """Pre-resolved future for storm-wave members that skip
    speculation (solver fallbacks, or parallel replay off)."""

    def __init__(self, value=None) -> None:
        self._value = value

    def done(self) -> bool:
        return True

    def result(self):
        return self._value


class _SpecPlanner:
    """Capturing Planner facade for speculative replay (phase A of the
    optimistic parallel replay — see docs/ARCHITECTURE.md "Optimistic
    parallel replay").  ``submit_plan`` verifies the plan against the
    shared wave snapshot (reusing ``plan_apply.evaluate_plan``, the
    same per-node check the applier runs) but commits NOTHING; every
    planner side effect — plan submit, eval status writes,
    blocked/follow-up eval creation — is recorded in call order and
    replayed verbatim by the in-order commit phase.  A plan whose
    speculative verification is not a clean full commit aborts the
    speculation: the serial path owns partial commits and their
    refresh/retry control flow."""

    def __init__(self, snap) -> None:
        self.snap = snap
        self.ops: List[tuple] = []
        # nodes the captured plans would mutate — part of the
        # speculation's conflict read set
        self.touched: Set[str] = set()

    def submit_plan(self, plan):
        from .plan_apply import evaluate_plan

        plan.snapshot_index = self.snap.index
        result, full = evaluate_plan(self.snap, plan)
        if not full:
            raise _SpecAbort("speculative verification was partial")
        self.touched.update(plan.node_update)
        self.touched.update(plan.node_allocation)
        self.touched.update(plan.node_preemptions)
        self.ops.append(("submit", plan))
        return result, None

    def update_eval(self, ev) -> None:
        self.ops.append(("update_eval", ev))

    def create_eval(self, ev) -> None:
        self.ops.append(("create_eval", ev))

    def reblock_eval(self, ev) -> None:
        self.ops.append(("reblock_eval", ev))


@dataclass
class _Speculation:
    """One eval's captured speculative replay, awaiting its in-order
    conflict check + commit."""

    ops: List[tuple]
    # two-tier read set (see docs/ARCHITECTURE.md "Optimistic
    # parallel replay").  strict_nodes: nodes hosting the job's
    # allocs at speculation time — the reconciler, tainted scan and
    # in-place update probes read them as real control-flow inputs,
    # so ANY touch past the wave baseline conflicts.  plan_nodes:
    # nodes the captured plans mutate — their reads are the winner
    # verification whose fit the kernel chain already modeled for
    # every earlier chain member, so touches the wave's OWN committed
    # plans account for are expected; only an unexpected (external)
    # touch conflicts.
    strict_nodes: Set[str]
    plan_nodes: Set[str]
    # the _replay_one contract: False = a prescored pick failed, the
    # chained state past this eval is suspect
    clean: bool
    # non-node reads the per-node ledger can't cover, re-checked at
    # commit time: the job version the replay ran against, the
    # scheduler-config table index, and (service evals) the absence
    # of a deployment
    job_fence: tuple = ()
    config_index: int = -1
    check_deployment: bool = False
    # placement explanation built on the pool thread, published only
    # if this speculation commits (a discarded speculation's replay
    # never happened as far as the explain ring is concerned)
    explain: Optional[Dict] = None


class PrescoredStack:
    """Stack whose select() replays a precomputed pick sequence.

    In-place update probes (generic_alloc_update_fn's single-node
    set_nodes + select, reference util.go:849) delegate to an inner
    oracle GenericStack, so the update/destructive decision is exact;
    full-node-set selects answer from the kernel rows after exact
    verification of each winner.

    Multi-task-group evals: the pick sequence carries each pick's
    group name (computePlacements iterates groups within one eval).
    Failure coalescing is per group — after a group's first failed
    pick the scheduler stops selecting for it, so the cursor silently
    consumes that group's remaining picks when another group selects."""

    def __init__(self, ctx, job: Job, pick_tgs: List[str],
                 rows: List[int], table,
                 penalties: List[FrozenSet[str]],
                 inner: GenericStack,
                 evict_rows: Optional[List[int]] = None,
                 pulls: Optional[List[int]] = None,
                 n_cand: int = 0,
                 order=None,
                 batch: bool = False) -> None:
        self.ctx = ctx
        self.job = job
        self.pick_tgs = pick_tgs
        self.rows = rows
        self.table = table
        self.penalties = penalties
        self.inner = inner
        self.evict_rows = evict_rows or []
        self.cursor = 0
        self.probing = False
        self.saw_failed_row = False
        self.failed_tgs: set = set()
        # preemption-retry passthrough state: the kernel's
        # per-pick source-pull counts let the host reconstruct the
        # sequential walk offset at any pick, so a preempt retry can
        # seed the inner oracle EXACTLY where the sequential stack
        # would be and hand the rest of the eval to it
        self.pulls = pulls
        self.n_cand = n_cand
        self.order = order
        self.batch = batch
        self.passthrough = False
        self.entered_passthrough = False
        self._all_nodes: Optional[list] = None

    def set_nodes(self, nodes) -> None:
        # single-node set_nodes comes from inplace-update probing;
        # answer those exactly through the inner oracle stack
        if len(nodes) <= 1:
            self.probing = True
            self.inner.set_nodes(nodes)
        else:
            self.probing = False
            # kept for preemption passthrough: this is the exact list
            # the sequential stack would shuffle
            self._all_nodes = list(nodes)

    def set_job(self, job: Job) -> None:
        if job.id != self.job.id or job.version != self.job.version:
            raise _Deviation("job changed")
        self.inner.set_job(job)

    def _enter_passthrough(self) -> None:
        """Seed the inner oracle with the sequential stack's EXACT
        state at this pick — shuffled node list (the recorded
        permutation, not a fresh rng draw) and rotating walk offset
        (running sum of the kernel's per-pick source pulls) — then
        hand the remainder of the eval to it.  Preemption-mode selects
        and every later pick replay bit-identically through the real
        iterator chain (rank.py evict path), so kernel-prescored evals
        need no preemption-retry carve-out."""
        nodes = self._all_nodes
        if (
            self.pulls is None
            or self.order is None
            or nodes is None
            or len(nodes) != self.n_cand
            or self.n_cand == 0
        ):
            raise _Deviation(
                "preemption retry needs the sequential path"
            )
        shuffled = [nodes[i] for i in self.order]
        # bypass GenericStack.set_nodes: it would draw a fresh
        # shuffle from the replay rng; the sequential order is the
        # recorded one
        self.inner.source.set_nodes(shuffled)
        self.inner.source.offset = int(
            sum(self.pulls[: self.cursor])
        ) % self.n_cand
        self.inner.limit.set_limit(
            compute_visit_limit(len(shuffled), self.batch)
        )
        self.passthrough = True
        self.entered_passthrough = True

    def select(self, tg: TaskGroup, options=None) -> Optional[RankedNode]:
        if self.probing:
            return self.inner.select(tg, options)
        if self.passthrough:
            # everything after the first preemption retry runs on the
            # exact oracle (its walk offset was seeded below); the
            # chain past this eval is already marked suspect
            return self.inner.select(tg, options)
        if options is not None and options.preempt:
            if getattr(self.ctx, "speculative", False):
                # the passthrough's oracle walk reads EVERY candidate
                # node — a read set the per-node conflict ledger can't
                # cover — so a speculative replay hands preemption
                # retries to the serial path
                raise _Deviation(
                    "preemption retry needs the serial replay"
                )
            self._enter_passthrough()
            return self.inner.select(tg, options)
        if options is not None and options.preferred_nodes:
            raise _Deviation("preferred nodes need the sequential path")
        # per-placement metric scope, like the serial chain's select
        # (GenericStack.select -> ctx.reset): each placement's
        # AllocMetric describes that placement, not the whole eval
        self.ctx.reset()
        # skip picks of groups the scheduler has coalesced (their
        # first failure means no further selects for that group)
        while (
            self.cursor < len(self.pick_tgs)
            and self.pick_tgs[self.cursor] in self.failed_tgs
        ):
            self.cursor += 1
        if self.cursor >= len(self.rows):
            raise _Deviation("prescored picks exhausted")
        if tg.name != self.pick_tgs[self.cursor]:
            raise _Deviation("unexpected task group")
        expected = (
            self.penalties[self.cursor]
            if self.cursor < len(self.penalties)
            else frozenset()
        )
        got = frozenset(
            options.penalty_node_ids
        ) if options is not None and options.penalty_node_ids else (
            frozenset()
        )
        if got != expected:
            raise _Deviation("penalty set mismatch")
        row = self.rows[self.cursor]
        pick = self.cursor
        self.cursor += 1
        if self.pulls is not None and pick < len(self.pulls):
            # the chained kernel's per-pick source-pull count is
            # exactly how many nodes the serial StaticIterator would
            # have evaluated for this placement — recorded
            # unconditionally so FailedTGAllocs on /v1/evaluation and
            # the plan API report the same NodesEvaluated the serial
            # path would, with or without the explain layer
            self.ctx.metrics.nodes_evaluated += int(self.pulls[pick])
        if row < 0:
            # prescored failure: the chain's state past this eval is
            # suspect (the caller re-prescores).  Within THIS eval the
            # kernel's per-group dead carry keeps the other groups'
            # remaining picks exact — UNLESS the failed pick staged a
            # destructive eviction, which the sequential path pops
            # back out of the plan (generic_sched.py:402) while the
            # kernel kept its delta applied
            self.saw_failed_row = True
            self.failed_tgs.add(tg.name)
            staged_evict = (
                pick < len(self.evict_rows)
                and self.evict_rows[pick] >= 0
            )
            more_other_tg = any(
                t not in self.failed_tgs
                for t in self.pick_tgs[self.cursor:]
            )
            if staged_evict and more_other_tg:
                raise _Deviation(
                    "failed pick staged an eviction; remaining "
                    "groups' rows are suspect"
                )
            return None
        node_id = self.table.node_ids[row]
        node = self.ctx.state.node_by_id(node_id)
        if node is None:
            raise _Deviation("node vanished")
        ranked = RankedNode(node=node)
        source = _SingleNodeSource(ranked)
        algorithm = (
            self.ctx.state.scheduler_config().effective_scheduler_algorithm()
        )
        binpack = BinPackIterator(
            self.ctx, source, False, self.job.priority, algorithm
        )
        binpack.set_job(self.job)
        binpack.set_task_group(tg)
        option = binpack.next()
        if option is None:
            raise _Deviation("winner failed exact verification")
        return option


class BatchWorker(Worker):
    """Worker that drains and prescores evals in batches."""

    def __init__(self, server, mesh=None, **kwargs) -> None:
        import os as _os

        super().__init__(server, **kwargs)
        # every K3 launch, K4 patch and D2H copy of this worker runs
        # on this one stream, so chunk N+1 reads chunk N's carry and a
        # patch lands behind every launch that reads the old values.
        # None on the CPU, where the twins run synchronously.
        self.stream = (
            torch.cuda.Stream(self.device)
            if self.device.type == "cuda"
            else None
        )
        # the server's device supervisor: the assemble/launch/fetch/
        # storm_solve stages run under its watchdog guards, and its
        # epoch keys the usage mirror.  On LOST (and on the restore)
        # the transition listener flushes the mirror and the
        # host-assembly caches, so no launch reads pre-incident state
        self.supervisor = getattr(server, "device_supervisor", None)
        self._backend_epoch = (
            self.supervisor.backend_epoch
            if self.supervisor is not None
            else 0
        )
        # watchdog trips this worker met (each nacked its leases once)
        self.trips = 0
        # fallback evals are the shapes batching didn't cover: the
        # exact host stack beats per-pick device round trips there
        self.host_fallback = True
        # tunable per deployment: larger launches amortize dispatch
        # (throughput), smaller ones cut per-eval service latency.
        # Clamped to [1, BATCH_MAX]: the prescore eval-axis buckets
        # top out at BATCH_MAX, so a
        # larger value would only overflow the stacked inputs and
        # demote every big batch to the sequential path
        try:
            requested = int(
                _os.environ.get("NOMAD_TPU_BATCH_MAX", BATCH_MAX)
            )
        except ValueError:
            LOG.warning(
                "invalid NOMAD_TPU_BATCH_MAX=%r; using %d",
                _os.environ.get("NOMAD_TPU_BATCH_MAX"),
                BATCH_MAX,
            )
            requested = BATCH_MAX
        self.batch_max = max(1, min(BATCH_MAX, requested))
        self.prescored = 0
        self.fallbacks = 0
        # the kernels are built by nvcc ahead of the first launch and
        # compile nothing per shape, so no launch waits on a compile:
        # this stays 0 (kept for the metric's consumers)
        self.cold_shape_fallbacks = 0
        self.preempt_passthroughs = 0
        # optimistic parallel replay (the same optimistic-concurrency
        # shape as the plan applier): prescored evals replay
        # speculatively on a thread pool against the shared wave
        # snapshot, then commit in queue order behind a per-node
        # conflict check — an eval whose read set was mutated by an
        # earlier-committed plan (or an external writer) is discarded
        # and re-replayed serially, so the committed outcome is
        # bit-identical to the serial worker loop.
        # NOMAD_TPU_PARALLEL_REPLAY=0 restores the serial replay loop.
        self.parallel_replay = (
            _os.environ.get("NOMAD_TPU_PARALLEL_REPLAY", "1") != "0"
        )
        # strict mode: ALL read nodes conflict on any touch, own-wave
        # commits included — full bit-identity of alloc score metrics
        # on wave-contended nodes, at the cost of serializing every
        # contended eval (the relaxed default keeps decisions, plans
        # and eval outcomes bit-identical; only contended-node score
        # metrics may reflect the wave snapshot)
        self.replay_strict = (
            _os.environ.get("NOMAD_TPU_REPLAY_STRICT") == "1"
        )
        # node-touch counts of the last serial replay's committed
        # plan (None = unknown writes), merged into the wave's
        # expected-touch ledger so serial fallbacks don't poison the
        # relaxed conflict check for later wave members
        self._last_replay_touches: Optional[Dict[str, int]] = None
        try:
            self.replay_workers: Optional[int] = (
                int(_os.environ.get("NOMAD_TPU_REPLAY_WORKERS", "0"))
                or None
            )
        except ValueError:
            self.replay_workers = None
        self._replay_pool = None  # lazy EvaluatePool
        self.replay_speculative = 0  # speculations committed
        self.replay_conflicts = 0  # speculations discarded on conflict
        self.replay_serial_fallbacks = 0  # wave evals replayed serially
        # dequeue timestamps for the per-eval service-latency samples
        self._deq_ts: Dict[str, float] = {}
        # adaptive batch sizing: close the loop from
        # MEASURED launch/replay latency instead of a fixed gulp size.
        # When the backlog shows the worker is keeping up, cap the
        # batch so the last eval's estimated end-to-end time stays
        # within the budget; under saturation queueing dominates and
        # the full batch maximizes throughput.  0 disables.
        try:
            self.latency_budget_ms = float(
                _os.environ.get("NOMAD_TPU_LATENCY_BUDGET_MS", 250.0)
            )
        except ValueError:
            self.latency_budget_ms = 250.0
        # per-chunk launch cost (dispatch + the blocking fetch wait),
        # keyed by chunk WIDTH bucket (CHUNK_BUCKETS) — the adaptive
        # gulp cap and the per-flush chunk-width policy both read it
        # ("storm" keys the storm solver's own bucket)
        self._launch_ewma: Dict[object, float] = {}  # chunk width -> ms
        # first measured warm launch, used as the default estimate for
        # buckets with no samples yet
        self._launch_ewma_seed: Optional[float] = None
        self._replay_ewma_ms = 5.0
        # decision-ledger dedup: chunk width / adaptive cap are
        # per-gulp hot paths, so they ledger only when the CHOICE
        # changes — a steady-state 64-wide drain is one record, not
        # ten thousand (which would evict every other site's flight
        # data from the bounded ring)
        self._last_chunk_width = 0
        self._last_adaptive_cap = 0
        # continuous micro-batching (NOMAD_TPU_ADMIT=0 restores the
        # flush-boundary gulp loop): evals dequeued while a chunk
        # chain is in flight are admitted into that chain's next chunk
        # when the admission gates prove they would see exactly the
        # state a fresh gulp would
        self.admit_enabled = (
            _os.environ.get("NOMAD_TPU_ADMIT", "1") != "0"
        )
        # global storm solver (NOMAD_TPU_STORM=1): when the broker
        # holds a backlog of >= storm_min pending evals of ONE job
        # family, the family prefix is drained atomically and solved
        # as a single (pending-allocs x nodes) assignment on the
        # device (kernel K5) instead of walking the per-eval chunk
        # chain.  Serial equivalence is explicitly relaxed behind this
        # flag (the win is storm throughput + global placement
        # quality); every member still commits through the
        # _commit_wave conflict fences in broker FIFO order, with
        # unsolvable or conflicted members taking the sequential path
        # — zero evals lost.
        self.storm_enabled = (
            _os.environ.get("NOMAD_TPU_STORM") == "1"
        )
        try:
            self.storm_min = max(
                1, int(_os.environ.get("NOMAD_TPU_STORM_MIN", "16"))
            )
        except ValueError:
            self.storm_min = 16
        try:
            self.storm_max = int(
                _os.environ.get("NOMAD_TPU_STORM_MAX", "256")
            )
        except ValueError:
            self.storm_max = 256
        self.storm_max = max(self.storm_min, min(self.storm_max, 1024))
        try:
            # 0 = auto: the solve's padded row bucket (the auction
            # assigns at least one row per round, so the bucket is
            # the convergence bound)
            self.storm_rounds = int(
                _os.environ.get("NOMAD_TPU_STORM_ROUNDS", "0")
            )
        except ValueError:
            self.storm_rounds = 0
        self.storm_solves = 0
        self.storm_evals = 0
        self.storm_rows = 0
        self.storm_fallbacks = 0
        self.storm_divergent = 0
        self.admission_admitted = 0
        self.admission_deferred = 0
        self.admission_chains = 0
        # evals dequeued mid-chain but gated out of it: processed as
        # the next gulp (run() drains this after every batch) so FIFO
        # order with their chain is preserved
        self._deferred: List[Tuple[Evaluation, str]] = []
        # broker leases taken by mid-chain admission this batch:
        # run()'s crash handler nacks these too (they are in neither
        # the original gulp nor _deferred), so a crash between
        # admission and ack can't strand a lease — and with it every
        # later same-job eval — until the broker's nack timeout
        self._admitted_live: List[Tuple[Evaluation, str]] = []
        # the admission queue of the chain in flight (None between
        # chains): its parked leases are nacked if the chain aborts
        self._admission_live: Optional[_AdmissionQueue] = None
        # host-assembly caches keyed by the node table's topology
        # generation (usage churn does NOT invalidate them): candidate
        # row layout per datacenter set, static feasibility /
        # affinity vectors per job signature, and node-level reserved-
        # port columns per port.  Bounded LRUs: a one-off job spec
        # evicts only the coldest entry, never the whole warm set
        self._cand_cache = _LRUCache(64)
        self._mask_cache = _LRUCache(256)
        self._port_col_cache = _LRUCache(256)
        self._dev_codes_cache = _LRUCache(256)
        self._dev_aff_cache = _LRUCache(64)
        # snapshot-delta input cache: device-resident mirror of the
        # node table's totals + usage columns, patched per flush from
        # the store's dirty-row log (store.usage_delta_since) instead
        # of re-shipping all C rows.  {"key": (topo_gen, C),
        # "gen": usage generation synced, "cols": 6 device tensors}
        self._usage_cache: Optional[dict] = None
        # serializes mirror syncs: warm_shapes (on its caller's
        # thread) and the worker thread both call _device_columns, and
        # two interleaved delta syncs could record a generation whose
        # rows one of them never patched
        self._usage_cache_lock = threading.Lock()
        self._input_cache_hits = 0
        self._input_cache_misses = 0
        # pipelined prescore: how many chunk launches may be in flight
        # before the host blocks on the oldest one's fetch.  1 degrades
        # to launch->fetch->replay per chunk (no overlap); 0/negative
        # clamps to 1
        try:
            self.pipeline_depth = max(
                1,
                int(
                    _os.environ.get("NOMAD_TPU_PIPELINE_DEPTH", 2)
                ),
            )
        except ValueError:
            self.pipeline_depth = 2
        # node-axis mesh: the Server's ``mesh=``, or with
        # NOMAD_TPU_MESH=1 the DistMesh of the torch.distributed group.
        # Asked for and not buildable, it raises here: the worker never
        # runs unsharded in its place
        self._mesh_given = mesh
        self._mesh_requested = (
            mesh is not None or _os.environ.get("NOMAD_TPU_MESH") == "1"
        )
        self._mesh = None
        # sharded runners per (picks, spread_fit, spread, even)
        self._sharded_runners: Dict[tuple, object] = {}
        # the sharded usage mirror: the six columns as Sharded tensors
        # on the mesh, patched per shard through K13.  Same layout as
        # _usage_cache, keyed also by the mesh width
        self._usage_cache_sharded: Optional[dict] = None
        self._mesh_mirror_hits = 0
        self._mesh_mirror_misses = 0
        # the processes the mesh spans (1: one process) and, on rank 0
        # of a world of several with NOMAD_TPU_POD_PORT, the pod head's
        # operation stream to its peers (parallel/pod.py)
        self._mesh_hosts = 1
        self._pod = None
        # arenas (and storms) that ran on the mesh
        self.mesh_used = 0
        self.mesh_storms = 0
        # first measured warm mesh flush: the default estimate of mesh
        # launch-cost buckets with no samples yet
        self._mesh_ewma_seed: Optional[float] = None
        if self._mesh_requested:
            self._mesh = self._make_mesh()
        # stage timings (seconds, cumulative) — surfaced through
        # /v1/metrics so a production operator can see where batch time
        # goes and whether the fast path is actually being taken.  The
        # old opaque "prescore" stage is split into its pipeline
        # stages: assemble (host numpy input staging), launch
        # (non-blocking device dispatch) and fetch (time blocked
        # waiting on device results — the part replay overlap hides)
        self.timings = {
            "simulate": 0.0,
            "assemble": 0.0,
            "admit": 0.0,
            "launch": 0.0,
            "fetch": 0.0,
            "mesh_launch": 0.0,
            "mesh_fetch": 0.0,
            "storm_stage": 0.0,
            "storm_solve": 0.0,
            "storm_decompose": 0.0,
            "replay": 0.0,
            "sequential": 0.0,
        }
        # happens-before sanitizer (NOMAD_TPU_TSAN=1): instruments
        # as family "Worker" — the flowgraph collapses BatchWorker
        # onto its root class, and the SHARED_STATE_ALLOWLIST keys
        # by that family
        from ..tsan import maybe_instrument

        maybe_instrument(self, "Worker")
        # after the caches exist: a transition firing mid-construction
        # must see a fully-initialized worker
        if self.supervisor is not None:
            self.supervisor.subscribe(self._on_device_transition)


    def _observe(
        self, stage: str, dt: float,
        exemplar: Optional[str] = None,
    ) -> None:
        self.timings[stage] += dt
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            # exemplar = the eval id (trace id) this sample belongs
            # to, so a slow p99 sample on /v1/metrics links straight
            # to /v1/traces/<id>
            metrics.add_sample(
                f"batch_worker.{stage}", dt * 1000.0,
                exemplar=exemplar,
            )

    def _observe_chunk(
        self, stage: str, run, base: int, c0: int, c1_real: int,
        t0: float, dt: float, **attrs,
    ) -> None:
        """Observe a chunk-wide stage interval and attribute it to
        every member eval's trace: first member as the metrics
        exemplar, and a per-member span carrying its chain position
        plus the membership count (so trace aggregations can divide
        the shared dt back out to match the timings accounting).
        ``base`` is the run index of the chunk's arena's eval 0."""
        chunk_evs = [run[base + e][0] for e in range(c0, c1_real)]
        self._observe(
            stage, dt,
            exemplar=chunk_evs[0].id if chunk_evs else None,
        )
        for pos, c_ev in enumerate(chunk_evs):
            TRACE.add_span(
                c_ev.id, f"batch_worker.{stage}", t0, dt,
                chain_pos=c0 + pos, members=len(chunk_evs), **attrs,
            )

    def _sample_eval_latency(self, ev: Evaluation) -> None:
        """Per-eval service latency (dequeue -> processed), the
        north-star p50/p99 exported via /v1/metrics so an operator
        sees it without running the bench."""
        import time as _time

        t0 = self._deq_ts.pop(ev.id, None)
        if t0 is None:
            return
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.add_sample(
                "batch_worker.eval_latency_ms",
                (_time.monotonic() - t0) * 1000.0,
                exemplar=ev.id,
            )

    def _count(self, name: str) -> None:
        """Bump a pipeline counter both on the worker and in /v1/metrics
        (prescore rate and fallback/error visibility)."""
        setattr(self, name, getattr(self, name) + 1)
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.incr(f"batch_worker.{name}")

    def _count_replay(self, kind: str) -> None:
        """Optimistic-replay counters, exported under the `replay.`
        namespace on /v1/metrics (speculative | conflicts |
        serial_fallbacks)."""
        attr = f"replay_{kind}"
        setattr(self, attr, getattr(self, attr) + 1)
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.incr(f"replay.{kind}")

    def _count_admission(self, kind: str) -> None:
        """Continuous micro-batching counters, exported under the
        `admission.` namespace on /v1/metrics (admitted | deferred |
        chains; the family is zero-registered at Server construction
        from ADMISSION_COUNTERS)."""
        attr = f"admission_{kind}"
        setattr(self, attr, getattr(self, attr) + 1)
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.incr(f"admission.{kind}")

    def _count_storm(self, kind: str, n: int = 1) -> None:
        """Global-storm-solver counters, exported under the `storm.`
        namespace on /v1/metrics (solves | evals | rows | fallbacks |
        divergent; the family is zero-registered at Server
        construction from STORM_COUNTERS)."""
        attr = f"storm_{kind}"
        setattr(self, attr, getattr(self, attr) + n)
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.incr(f"storm.{kind}", float(n))

    def _record_decision(self, site: str, action: str, **kw) -> None:
        """Ledger hook: every adaptive decision of this worker goes
        through here, with the leadership generation it ran under.
        The port's ledger is a no-op for now (decisions.py)."""
        inputs = dict(kw.pop("inputs", None) or {})
        inputs.setdefault("leader_gen", self._leader_gen())
        DECISIONS.record(
            site,
            action,
            inputs=inputs,
            metrics=getattr(self.server, "metrics", None),
            **kw,
        )

    def _count_policy(self, kind: str) -> None:
        """Policy-weighted-scoring counters, exported under the
        `policy.` namespace on /v1/metrics (the family is
        zero-registered at Server construction from
        sched/policy.py POLICY_COUNTERS)."""
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.incr(f"policy.{kind}")

    def _export_adaptive_gauges(self) -> None:
        """The adaptive-cap inputs as /v1/metrics gauges, so an
        operator can see WHY `_adaptive_cap` picked a gulp size (the
        launch EWMA per chunk width and the per-eval replay EWMA are
        the whole decision)."""
        metrics = getattr(self.server, "metrics", None)
        if metrics is None:
            return
        metrics.set_gauge(
            "batch_worker.replay_ewma_ms", self._replay_ewma_ms
        )
        for bucket, ms in self._launch_ewma.items():
            # mesh buckets are ("mesh", width) tuples -> .m<width>;
            # the storm solver's dedicated bucket -> .storm
            if isinstance(bucket, tuple):
                suffix = f"m{bucket[1]}"
            elif bucket == "storm":
                suffix = "storm"
            else:
                suffix = f"e{bucket}"
            metrics.set_gauge(
                f"batch_worker.launch_ewma_ms.{suffix}", ms
            )

    def _replay_pool_instance(self):
        """Lazy speculative-replay pool (the plan applier's
        EvaluatePool shape, sized cores/2 unless
        NOMAD_TPU_REPLAY_WORKERS overrides); its width is the
        `batch_worker.replay_parallelism` gauge.

        Re-created when the previous pool was shut down: leadership
        can be re-established on the same server (revoke -> establish
        on re-election), and the new generation's waves must not
        submit into the dead pool — this exact shape stranded every
        wave (and three-struck its evals into the failed queue) in
        the chaos smoke before the check existed."""
        if self._replay_pool is None or self._replay_pool.closed:
            from .plan_apply import EvaluatePool

            self._replay_pool = EvaluatePool(
                self.replay_workers,
                thread_name_prefix="replay-spec",
            )
            metrics = getattr(self.server, "metrics", None)
            if metrics is not None:
                metrics.set_gauge(
                    "batch_worker.replay_parallelism",
                    self._replay_pool.workers,
                )
        return self._replay_pool

    def stop(self) -> None:
        super().stop()
        if self._replay_pool is not None:
            self._replay_pool.shutdown()
        if self._pod is not None:
            # the peers leave their loop on the service's "bye"
            self._pod.close()
            self._pod = None

    # -- device supervisor integration ---------------------------------

    def _guard_device(
        self, stage: str, fn, what: str, exemplar: Optional[str] = None
    ):
        """Run a pipeline stage under the supervisor's watchdog (a
        passthrough without one, or while it expects no card).  A
        DeviceFault (the supervisor's, or the stage's own) propagates;
        any other failure of the stage becomes a DeviceFault naming
        ``what``: the prescore pipeline never demotes to the host
        oracle."""
        sup = self.supervisor
        try:
            if sup is None:
                return fn()
            return sup.guard(stage, fn, eval_id=exemplar)
        except DeviceFault:
            raise
        except Exception as exc:  # noqa: BLE001
            raise DeviceFault(what) from exc

    def _on_device_transition(
        self, old: str, new: str, reason: str
    ) -> None:
        """LOST (or the restore flip): flush every cache that holds, or
        is keyed by, device state, so no launch after the incident
        reads pre-incident buffers.  The epoch also keys the usage
        mirror, so a racing in-flight sync re-syncs rather than reusing
        a pre-flip entry."""
        epoch = self.supervisor.backend_epoch
        if epoch == self._backend_epoch:
            return
        self._backend_epoch = epoch
        # the device usage mirror.  Deliberately NOT under
        # _usage_cache_lock: an abandoned sacrificial assemble thread
        # may be parked inside _device_columns_locked HOLDING it (a
        # wedged upload never returned), and this listener may run on
        # the very thread the watchdog just protected.  The bare
        # assignment is atomic, and a late holder can at worst publish
        # a dict keyed by the OLD epoch, which the next lookup misses
        # and fully resyncs
        self._usage_cache = None
        # ... and REPLACE the lock itself, so post-incident syncs never
        # queue behind that abandoned holder
        self._usage_cache_lock = threading.Lock()
        # the sharded mirror's shards live on the mesh: same flush, so
        # the first sync after the restore re-uploads it in full (the
        # new epoch keys it), never as a delta
        self._usage_cache_sharded = None
        # host-assembly caches hold no device state; flushing them keeps
        # the post-incident world observably cold (one rebuild each)
        self._cand_cache = _LRUCache(64)
        self._mask_cache = _LRUCache(256)
        self._port_col_cache = _LRUCache(256)
        self._dev_codes_cache = _LRUCache(256)
        self._dev_aff_cache = _LRUCache(64)
        # rebind rather than clear(): this listener runs on the
        # supervisor's thread while the worker may iterate them
        self._sharded_runners = {}
        self._mesh_ewma_seed = None
        if self._mesh_requested:
            if new == HEALTHY:
                # the canary passed: the mesh comes back before the hold
                # clears, so the held evals are placed on it
                self._mesh = self._make_mesh()
            else:
                # LOST: no launch may reach the mesh until the restore
                self._mesh = None
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.set_gauge("batch_worker.backend_epoch", float(epoch))

    def start(self) -> None:
        self._load_kernels()
        super().start()

    def _kernel_libraries(self) -> List[str]:
        """The kernel libraries of this worker's guarded stages: K3 and K4,
        K5 for storms, and on a mesh K12-K15."""
        names = ["chained_picks", "patch_rows", "storm_solve"]
        if self._mesh_requested:
            names += ["sharded_chain", "patch_rows_sharded", "storm_sharded",
                      "patch_rows_hostlocal"]
        return names

    def _load_kernels(self) -> None:
        """On the card, build and load the kernels of the guarded stages
        before any stage runs: an nvcc build takes seconds, and inside a
        stage it would outlast the watchdog's budget and trip a healthy
        card."""
        if self.device.type == "cuda":
            from ..ops import _cuda

            _cuda.load(self._kernel_libraries())

    # -- the node mesh -------------------------------------------------

    def _make_mesh(self):
        """The mesh this worker shards over: the Server's ``mesh=``, or
        (NOMAD_TPU_MESH=1 without one) `parallel.pod.build_worker_mesh`:
        the NOMAD_TPU_DIST* world joined first (`distributed_init`), then
        ``make_mesh(eval_axis=1)`` over every rank's
        NOMAD_TPU_SHARDS_PER_RANK shards, capped by
        NOMAD_TPU_MESH_DEVICES, on the worker's device.  The JAX worker
        runs unsharded when its mesh cannot be built; the port raises
        instead: a missing group, a mesh of one shard, a mesh whose
        device is not the worker's, or a pod of an undeclared width.
        Sets ``_mesh_hosts`` (the ``mesh.hosts`` gauge) and, over
        several processes, attaches the pod head (`_attach_pod`)."""
        from ..parallel.mesh import host_count
        from ..parallel.pod import build_worker_mesh

        mesh = self._mesh_given
        if mesh is None:
            mesh = build_worker_mesh(self.device)
        if mesh.device != self.device:
            raise ValueError(
                f"a mesh on {mesh.device} for a worker on {self.device}"
            )
        self._mesh_hosts = host_count(mesh)
        if self._mesh_hosts > 1:
            self._attach_pod(mesh)
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.set_gauge("mesh.hosts", float(self._mesh_hosts))
        return mesh

    def _attach_pod(self, mesh) -> None:
        """Pod-head mode: with NOMAD_TPU_POD_PORT set, rank 0 of a world
        of several processes serves the mesh-operation stream its peers
        replay (`parallel/pod.py`).  Idempotent: a mesh rebuilt after a
        supervisor incident spans the same world, and the connected
        peers keep following (the first sync after it is a full one).
        A mesh whose width is not in `MESH_FANOUT_WIDTHS` raises: the
        worker stops rather than head an undeclared pod."""
        import os as _os

        if self._pod is not None:
            return
        port = _os.environ.get("NOMAD_TPU_POD_PORT")
        if not port:
            return
        import torch.distributed as dist

        if dist.get_rank() != 0:
            return
        from ..parallel.pod import MESH_FANOUT_WIDTHS, PodService

        if mesh.n_shards not in MESH_FANOUT_WIDTHS:
            raise RuntimeError(
                f"undeclared fan-out pod width {mesh.n_shards} (declared: "
                f"{MESH_FANOUT_WIDTHS})"
            )
        self._pod = PodService(int(port), n_peers=dist.get_world_size() - 1)

    def _live_mesh(self):
        """The mesh, for a stage about to use it.  Asked for and absent
        is the supervisor's fault while it holds (the mesh was dropped
        on LOST), else a device fault (it could not be rebuilt); never
        a reason to run unsharded."""
        if self._mesh is None and self._mesh_requested:
            sup = self.supervisor
            if sup is not None and sup.holding():
                raise sup.fault()
            raise DeviceFault("the node mesh is down")
        return self._mesh

    def _sharded_runner(self, n_picks: int, spread_fit: bool,
                        with_spread: bool = False,
                        spread_even: bool = False):
        key = (n_picks, spread_fit, with_spread, spread_even)
        runner = self._sharded_runners.get(key)
        if runner is None:
            from ..parallel.mesh import sharded_chained_plan

            # return_carry=True always: every mesh launch is a chunk of
            # a (possibly length-1) chain, and the sharded usage carry
            # threads chunk -> chunk on the device
            runner = sharded_chained_plan(
                self._mesh, n_picks, spread_fit,
                with_spread=with_spread, spread_even=spread_even,
                return_carry=True,
            )
            self._sharded_runners[key] = runner
        return runner

    def _met_supervisor_fault(self, exc: DeviceFault) -> None:
        """A guarded stage raised the supervisor's fault: a watchdog
        trip, or LOST reached mid-chain.  The caller has nacked the
        leases; the worker holds from here until the card recovers,
        and a trip waits for drain_to_idle to raise it."""
        if isinstance(exc, DeviceTimeout):
            self._count("trips")
            self.tripped = exc
        LOG.warning("device supervisor fault; worker holds: %s", exc)

    # ------------------------------------------------------------------

    def _chunk_buckets(self) -> tuple:
        """The chunk-width ladder, clamped to the
        operator's batch ceiling (a NOMAD_TPU_BATCH_MAX below the
        widest bucket must never mint launches wider than a gulp can
        be)."""
        buckets = tuple(
            w for w in CHUNK_BUCKETS if w <= self.batch_max
        )
        return buckets or (self.batch_max,)

    @staticmethod
    def _ewma_key(width: int, mesh: bool, storm: bool = False):
        """Launch-EWMA bucket key: mesh dispatches get their own buckets
        (a sharded chunk costs nothing like a K3 chunk of the same
        width), and storm solves one bucket of their own."""
        if storm:
            return "storm"
        return ("mesh", width) if mesh else width

    def _launch_cost_ms(self, width: int, mesh: bool = False) -> float:
        """Estimated cost of one ``width``-wide chunk launch (dispatch
        + blocking fetch): the measured EWMA for that bucket, the
        first warm launch observed for buckets with no samples yet,
        or 50 ms before anything has been measured.  Mesh launches
        read (and seed) only mesh buckets."""
        seed = self._mesh_ewma_seed if mesh else self._launch_ewma_seed
        default = seed if seed is not None else 50.0
        return self._launch_ewma.get(self._ewma_key(width, mesh), default)

    def _note_launch_cost(self, width: int, ms: float, mesh: bool = False,
                          storm: bool = False) -> None:
        """Feed one chunk's measured device-path cost into the
        adaptive sizing loop (and seed the default estimate from the
        first warm measurement).  A sample an order of magnitude past
        the latency budget is a one-off stall (the first launch's
        kernel build), not a launch cost — averaging it in would
        collapse the cap/width policy to the smallest bucket for
        hundreds of flushes, so it is dropped.  A storm solve feeds
        only its own bucket (exported as ``launch_ewma_ms.storm``): a
        whole-backlog assignment solve is not a chunk launch, and its
        wall time must not plan chunk flushes."""
        ceiling = 20.0 * max(self.latency_budget_ms, 50.0)
        if ms > ceiling:
            return
        if storm:
            pass  # the storm bucket seeds itself
        elif mesh:
            if self._mesh_ewma_seed is None:
                self._mesh_ewma_seed = ms
        elif self._launch_ewma_seed is None:
            self._launch_ewma_seed = ms
        key = self._ewma_key(width, mesh, storm)
        prev = self._launch_ewma.get(key)
        self._launch_ewma[key] = (
            ms if prev is None else 0.8 * prev + 0.2 * ms
        )

    def _plan_chunk_width(self, n_evals: int, backlog: int,
                          mesh: bool = False) -> int:
        """Chunk width for a flush of ``n_evals`` given the backlog.

        Saturated (or latency budget off): the widest bucket — fewer
        dispatches, queueing dominates latency anyway.  Keeping up:
        the smallest bucket covering the flush in one launch (a 1-2
        eval interactive flush must not pay an 8-wide kernel), and for
        bigger flushes the widest bucket UNLESS its measured launch
        cost alone would eat over half the latency budget — then one
        bucket narrower, so the first replay (and the first mid-chain
        admission point) lands after a fraction of the budget instead
        of all of it."""
        buckets = self._chunk_buckets()
        widest = buckets[-1]
        if self.latency_budget_ms <= 0 or backlog >= self.batch_max:
            return widest
        for w in buckets:
            if n_evals <= w:
                return w
        if len(buckets) > 1 and self._launch_cost_ms(
            widest, mesh=mesh
        ) > (self.latency_budget_ms / 2.0):
            return buckets[-2]
        return widest

    def _chunk_width(self, n_evals: int, mesh: bool = False) -> int:
        """Per-flush chunk width (reads the live backlog), exported as
        the ``batch_worker.chunk_width`` gauge.  ``mesh`` flushes plan
        from the mesh launch-cost buckets."""
        try:
            backlog = self.server.broker.ready_count(self.schedulers)
        except Exception:  # noqa: BLE001 — sizing is best-effort
            backlog = self.batch_max
        width = self._plan_chunk_width(n_evals, backlog, mesh=mesh)
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.set_gauge("batch_worker.chunk_width", width)
        if DECISIONS.enabled and width != self._last_chunk_width:
            self._last_chunk_width = width
            buckets = self._chunk_buckets()
            self._record_decision(
                "chunk_width",
                f"width={width}",
                inputs={
                    "n_evals": n_evals,
                    "backlog": backlog,
                    "budget_ms": self.latency_budget_ms,
                    "launch_cost_ms": round(
                        self._launch_cost_ms(width, mesh=mesh), 3
                    ),
                    "mesh": mesh,
                },
                alternatives=[f"width={w}" for w in buckets],
            )
        return width

    def _adaptive_cap(self) -> int:
        """Batch size for this gulp, from measured latency + backlog.

        Keeping up (backlog < a full batch): pick the LARGEST
        candidate whose estimated last-eval latency — chunk launches
        at that gulp size (the live chunk-width ladder's cost EWMAs)
        plus per-eval replay EWMA x evals ahead — fits the budget; the
        smallest candidate when none does.  Saturated: the full batch
        (queueing dominates latency anyway, amortizing the launch
        maximizes drain rate).  Candidates are the chunk-size buckets
        themselves plus the operator ceiling, so the cap can drop all
        the way to a 2-eval gulp when even one narrow launch barely
        fits the budget."""
        if self.latency_budget_ms <= 0:
            return self.batch_max
        try:
            backlog = self.server.broker.ready_count(self.schedulers)
        except Exception:  # noqa: BLE001 — sizing is best-effort
            return self.batch_max
        if backlog >= self.batch_max:
            return self.batch_max
        # gulp-size candidates, derived from the live chunk-width
        # ladder and never above the operator's configured ceiling
        candidates = sorted(
            set(self._chunk_buckets()) | {self.batch_max}
        )
        cap = candidates[0]
        for c in candidates:
            width = self._plan_chunk_width(c, backlog)
            launches = -(-c // width)
            est = launches * self._launch_cost_ms(width) + min(
                c, backlog + 1
            ) * self._replay_ewma_ms
            if est <= self.latency_budget_ms:
                cap = c
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.set_gauge("batch_worker.adaptive_cap", cap)
        if DECISIONS.enabled and cap != self._last_adaptive_cap:
            self._last_adaptive_cap = cap
            self._record_decision(
                "adaptive_cap",
                f"cap={cap}",
                inputs={
                    "backlog": backlog,
                    "budget_ms": self.latency_budget_ms,
                    "replay_ewma_ms": round(self._replay_ewma_ms, 3),
                },
                alternatives=[f"cap={c}" for c in candidates],
            )
        return cap

    def _note_dequeue(self, ev: Evaluation) -> None:
        """Stamp an eval's dequeue time for the service-latency
        sample, shedding oldest-first past DEQ_TS_MAX — entries
        normally pop on ack (_sample_eval_latency) or nack
        (_nack_quietly), but an eval that crashes between dequeue and
        either must not leak its stamp forever."""
        import time as _time

        while len(self._deq_ts) >= DEQ_TS_MAX:
            self._deq_ts.pop(next(iter(self._deq_ts)))
        self._deq_ts[ev.id] = _time.monotonic()
        # explain/trace audit: every record of this delivery names the
        # leadership generation it ran under, so a post-failover
        # operator can tell which leader's pipeline produced it
        TRACE.annotate(ev.id, leader_gen=self._leader_gen())

    # -- leadership fence ----------------------------------------------

    def _leader_gen(self) -> int:
        """The server's current leadership generation (0 for bare
        test harnesses that never call establish_leadership)."""
        return getattr(self.server, "_leadership_gen", 0)

    def _count_leadership(self, kind: str) -> None:
        """Leadership-failover counters, exported under the
        `leadership.` namespace on /v1/metrics (the family is
        zero-registered at Server construction from
        LEADERSHIP_COUNTERS)."""
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.incr(f"leadership.{kind}")

    def _check_leadership(self, gen: int) -> None:
        """The hot path's leadership fence: a wave or chunk chain
        captured ``gen`` when it started,
        and may only commit while the server still holds THAT
        leadership.  Raises NotLeaderError (handled by run(): every
        outstanding lease is nacked for redelivery, nothing commits)
        when leadership was revoked or re-established at a newer
        generation mid-flight."""
        srv = self.server
        if (
            getattr(srv, "_leader_established", True)
            and getattr(srv, "_leadership_gen", gen) == gen
        ):
            return
        self._count_leadership("stale_wave_fenced")
        raise NotLeaderError(None)

    def run(self) -> None:
        import time as _time

        # evals dequeued mid-chain by the admission queue but gated
        # out of the chain: they hold broker leases and must be
        # processed NEXT, before any fresh dequeue, to keep FIFO order
        leftover: List[Tuple[Evaluation, str]] = []
        while not self._stop.is_set() and self._current_generation():
            batch = leftover
            leftover = []
            if not batch:
                if self._paused.is_set() or self._held():
                    # honor Worker.set_pause (leaders park half their
                    # workers; benches stage backlogs behind it) and
                    # the device supervisor's hold (LOST, RECOVERING).
                    # Checked only between gulps: a leftover batch
                    # still holds broker leases and must finish first
                    # (a held one meets guard's fault and is nacked).
                    self._stop.wait(0.05)
                    continue
                ev, token = self.server.broker.dequeue(
                    self.schedulers, timeout=0.1
                )
                if ev is None:
                    continue
                if self._held():
                    # the hold began while this dequeue waited: hand
                    # the eval back untouched (head of the queue, no
                    # delivery counted)
                    try:
                        self.server.broker.release(ev.id, token)
                    except ValueError:
                        pass
                    continue
                self._note_dequeue(ev)
                # storm detection at the gulp boundary: a backlog of
                # pending evals sharing this eval's job family above
                # the trigger threshold is drained atomically and
                # solved as ONE global assignment instead of feeding
                # the per-eval chunk chain
                if self.storm_enabled:
                    storm = self._maybe_drain_storm(ev, token)
                    if storm is not None:
                        try:
                            leftover = self._process_storm(storm)
                        except NotLeaderError:
                            # leadership revoked mid-storm: nothing
                            # committed past the fence — nack every
                            # member lease for redelivery
                            self._count_leadership("chain_aborts")
                            self._abandon_leases(storm)
                            leftover = []
                        except (DeviceTimeout, DeviceLost) as exc:
                            # the supervisor's fault: nack once, hold
                            self._abandon_leases(storm)
                            self._met_supervisor_fault(exc)
                            leftover = []
                        except DeviceFault as exc:
                            # the solve failed on the device: stop here,
                            # leases nacked, and leave the fault for
                            # drain_to_idle to raise
                            self._count("errors")
                            LOG.error("storm solve failed; worker stops",
                                      exc_info=True)
                            self.fault = exc
                            self._abandon_leases(storm)
                            self._stop.set()
                            return
                        except Exception:  # noqa: BLE001
                            self._count("errors")
                            LOG.exception("storm processing crashed")
                            # the members were coalesced into a storm
                            # that never committed, and will reappear
                            # via lease redelivery
                            for s_ev, _tok in storm:
                                TRACE.event(
                                    s_ev.id, "storm.fallback",
                                    reason="storm_crash",
                                )
                            self._abandon_leases(storm)
                            leftover = []
                        continue
                batch = [(ev, token)]
                cap = self._adaptive_cap()
                # ONE fill deadline for the whole gulp: the old
                # per-dequeue timeout waited up to cap x BATCH_WAIT_S
                # on an empty queue, holding a lone interactive eval
                # hostage to batch-fill timeouts.  Anything that
                # arrives after the deadline is picked up mid-chain by
                # the admission queue instead.
                deadline = _time.monotonic() + BATCH_WAIT_S
                while len(batch) < cap:
                    wait = deadline - _time.monotonic()
                    if wait <= 0:
                        break
                    ev, token = self.server.broker.dequeue(
                        self.schedulers, timeout=wait
                    )
                    if ev is None:
                        break
                    self._note_dequeue(ev)
                    batch.append((ev, token))
                # chaos seam: deterministic revoke-during-gulp races
                # (no-op unless a test armed the hook)
                _chaos.fire("gulp_filled")
            for pos, (b_ev, _tok) in enumerate(batch):
                TRACE.event(
                    b_ev.id, "batch_worker.gulp",
                    size=len(batch), pos=pos,
                )
            try:
                leftover = self._process_batch(batch)
            except NotLeaderError:
                # leadership revoked with this gulp in flight: the
                # chain was dropped via its abandon path and no wave
                # member past the fence committed — nack every lease
                # (original gulp, deferred AND admitted) for
                # redelivery under the next leadership
                self._count_leadership("chain_aborts")
                self._abandon_leases(batch)
                leftover = []
            except (DeviceTimeout, DeviceLost) as exc:
                # the supervisor's fault (a watchdog trip, or LOST
                # reached mid-chain): nothing of the chain past the
                # fault committed — nack every lease once, then hold
                self._abandon_leases(batch)
                self._met_supervisor_fault(exc)
                leftover = []
            except DeviceFault as exc:
                # the device path failed: stop here, leases nacked,
                # and leave the fault for drain_to_idle to raise
                self._count("errors")
                LOG.error("prescore pipeline failed; worker stops",
                          exc_info=True)
                self.fault = exc
                self._abandon_leases(batch)
                self._stop.set()
                return
            except Exception:  # noqa: BLE001
                # a crash here would silently kill the worker thread and
                # strand every queued eval — log, nack, keep running
                self._count("errors")
                LOG.exception("batch processing crashed")
                self._abandon_leases(batch)
                leftover = []

    def _abandon_leases(
        self, held: List[Tuple[Evaluation, str]]
    ) -> None:
        """Nack every broker lease this worker still holds after an
        aborted gulp: the evals handed in, plus everything the
        admission queue dequeued mid-chain — parked (deferred) or
        already admitted into the dropped chain (_nack_quietly
        tolerates leases the flush managed to ack/nack, and leases a
        leadership revoke already flushed wholesale)."""
        for ev, token in held:
            self._nack_quietly(ev, token)
        deferred, self._deferred = self._deferred, []
        admitted, self._admitted_live = self._admitted_live, []
        live, self._admission_live = self._admission_live, None
        parked = list(live.deferred) if live is not None else []
        for ev, token in deferred + admitted + parked:
            self._nack_quietly(ev, token)

    # ------------------------------------------------------------------

    def _process_batch(
        self, batch: List[Tuple[Evaluation, str]]
    ) -> List[Tuple[Evaluation, str]]:
        """Process the drained evals in queue order, prescoring each
        contiguous run of batchable evals in one chained kernel launch
        so the outcome is exactly what the serial worker loop would
        produce.  Returns the evals the admission queue dequeued
        mid-chain but gated out — the caller must process them as the
        next gulp (before dequeuing anything newer)."""
        run: List[Tuple[Evaluation, str, Job]] = []
        for ev, token in batch:
            job = self.store.job_by_id(ev.namespace, ev.job_id)
            if self._batchable(ev, job):
                run.append((ev, token, job))
                continue
            self._flush_run(run)
            run = []
            self._process_sequential(ev, token)
        # only the batch's FINAL flush may admit mid-chain arrivals: a
        # mid-batch flush has evals of this gulp still queued behind
        # it, and an admitted (newer) eval would commit ahead of them
        self._flush_run(run, admit=True)
        self._export_adaptive_gauges()
        # normal completion: every admitted eval was acked, nacked or
        # deferred inside the flush — the crash ledger is void
        self._admitted_live = []
        deferred, self._deferred = self._deferred, []
        return deferred

    def _flush_run(self, run, admit: bool = False) -> None:
        import time as _time

        from ..sched.policy import resolve as _policy_resolve

        idx = 0
        while idx < len(run):
            snap = self.store.snapshot()
            # global conflict fence for the optimistic replay wave:
            # the ready-node-set generation at wave start (the
            # per-node baseline is captured with the wave below)
            wave_readiness = self.store.readiness_generation()
            # leadership fence: the generation this chain runs under —
            # a revoke (or a newer establish) mid-chain aborts the
            # chain through the same drop path a backend flip uses,
            # and _commit_wave re-checks it before every member commit
            wave_gen = self._leader_gen()
            # simulate the longest prefix we can model in the kernel
            t0 = _time.monotonic()
            sims: List[_Sim] = []
            j = idx
            while j < len(run):
                ev, _token, job = run[j]
                if job is not None and _policy_resolve(job) is not None:
                    # the chunk chain's carry does not model policy
                    # terms; a weighted eval ends the prefix and runs
                    # the single-eval vectorized select (the sequential
                    # path -> cuda_stack fuses PolicyTerms into K1).
                    # Storms stay eligible: build_storm_problem stages
                    # policy rows into the solve itself
                    if j == idx:
                        self._count_policy("evals")
                    break
                try:
                    with TRACE.span(ev.id, "batch_worker.simulate"):
                        sim = self._simulate(snap, ev, job)
                except Exception:  # noqa: BLE001
                    # a broken simulation falls back to the exact path,
                    # but silently eating it would demote the fast path
                    # to 0% prescore with no signal — count and log
                    self._count("errors")
                    LOG.warning(
                        "simulate failed for eval %s", ev.id,
                        exc_info=True,
                    )
                    sim = None
                if sim is None:
                    break
                sims.append(sim)
                j += 1
            sim_exemplar = run[idx][0].id
            self._observe("simulate", _time.monotonic() - t0, exemplar=sim_exemplar)
            # port/device chain gates: the kernel's occupancy carries
            # are monotone (placements occupy/consume; releases are
            # not modeled) and device pooling is exact only for
            # identical-or-disjoint ask signatures.  An eval whose
            # staged releases hit a port/device asked at-or-after it,
            # or whose device signatures overlap earlier ones without
            # matching, ends the chain — committed state rebuilds the
            # carries exactly for the next chain.
            cut = len(sims)
            table_ = snap.node_table
            any_dev = any(
                cs for s in sims for d in s.asked_devices for cs in d
            )
            key_codes: Dict[tuple, set] = {}
            if any_dev:
                # one scan of the sig interner per flush (not per
                # eval): (vendor, type, name) -> codes
                for code, sig in table_._device_sig_meta.items():
                    key_codes.setdefault(
                        (sig[0], sig[1], sig[2]), set()
                    ).add(code)
            suffix_asks: set = set()
            suffix_dev_codes: set = set()
            for i2 in range(len(sims) - 1, -1, -1):
                s2 = sims[i2]
                own = (
                    set().union(*s2.asked_ports)
                    if s2.asked_ports
                    else set()
                )
                own_dev_sets = {
                    cs
                    for d in s2.asked_devices
                    for cs in d
                }
                own_dev_codes = (
                    set().union(*own_dev_sets)
                    if own_dev_sets
                    else set()
                )
                rel = s2.released_ports
                if rel and rel & own:
                    cut = i2  # its own picks see the stale mask
                elif rel and rel & suffix_asks:
                    cut = i2 + 1  # keep it; later evals re-chain
                if s2.released_device_keys and (
                    own_dev_codes or suffix_dev_codes
                ):
                    rel_codes = set()
                    for key in s2.released_device_keys:
                        rel_codes |= key_codes.get(key, set())
                    if rel_codes & own_dev_codes:
                        cut = min(cut, i2)
                    elif rel_codes & suffix_dev_codes:
                        cut = min(cut, i2 + 1)
                suffix_asks |= own
                suffix_dev_codes |= own_dev_codes
            # forward device gates: pooled free-count accounting is
            # exact only when (a) distinct signatures in one chain are
            # pairwise identical-or-disjoint, (b) every asked code's
            # (vendor, type, name) key is unambiguous (one code — an
            # attr-changed re-registration mints a second code whose
            # key-granularity reservations can't be attributed), and
            # (c) no node carries TWO groups of one signature (the
            # sequential allocator must satisfy a request from a
            # SINGLE group — device.py — so a pooled per-node count
            # would over-admit)
            seen_sets: set = set()
            for i2 in range(min(cut, len(sims))):
                eval_sets = {
                    cs
                    for d in sims[i2].asked_devices
                    for cs in d
                }
                bad = any(
                    cs & other
                    for cs in eval_sets
                    for other in (seen_sets | eval_sets)
                    if other != cs
                )
                if not bad:
                    for cs in eval_sets - seen_sets:
                        keys = {
                            table_.device_sig_key(c) for c in cs
                        }
                        if any(
                            len(key_codes.get(k, ())) > 1
                            for k in keys
                        ):
                            bad = True
                            break
                        for _row, groups in (
                            table_.device_groups.items()
                        ):
                            if (
                                sum(
                                    1
                                    for code, _n in groups
                                    if code in cs
                                )
                                > 1
                            ):
                                bad = True
                                break
                        if bad:
                            break
                if bad:
                    cut = min(cut, i2)
                    break
                seen_sets |= eval_sets
            if cut < len(sims):
                sims = sims[:cut]
                j = idx + cut
            if not sims:
                self._process_sequential(run[idx][0], run[idx][1])
                idx += 1
                continue
            # ---- prescore pipeline: assemble -> launch -> fetch ----
            t0 = _time.monotonic()
            # adaptive micro-batch width for this flush, from the
            # measured launch EWMAs + live backlog.  On a mesh worker
            # the width plans from the mesh cost buckets
            chunk_w = self._chunk_width(
                len(sims), mesh=self._mesh is not None
            )
            asm = self._guard_device(
                "assemble",
                lambda: self._assemble(
                    snap, run[idx:j], sims, chunk=chunk_w
                ),
                f"prescore assembly failed for {len(sims)} evals",
                exemplar=run[idx][0].id,
            )
            asm_dt = _time.monotonic() - t0
            self._observe(
                "assemble", asm_dt, exemplar=run[idx][0].id
            )
            # run-wide stage, attributed to every member eval: the
            # `members` attr lets aggregations divide the shared dt
            # back out so trace-derived stage sums match the
            # batch_worker.timings accounting
            for m_ev, _t, _jb in run[idx:j]:
                TRACE.add_span(
                    m_ev.id, "batch_worker.assemble", t0, asm_dt,
                    members=len(sims),
                )
            k = idx
            rescore = False
            # optimistic parallel replay: big-enough runs replay
            # speculatively on the pool as each chunk's rows land
            # (overlapping later fetches), then commit in queue order
            # behind the conflict check (_commit_wave)
            wave = None
            spec_pool = None
            wave_base: Dict[str, int] = {}
            # in-order commit state threaded across the incremental
            # wave drains (job ledger + expected-touch accounting)
            wave_state = {"job_ledger": set(), "expect": {}}
            chain_base: Optional[Dict[str, int]] = None
            if self.parallel_replay and asm.E_real >= REPLAY_MIN_WAVE:
                wave = deque()
                spec_pool = self._replay_pool_instance()
                # touch-count baseline, captured before any
                # speculation reads (launches haven't fetched yet)
                wave_base = self.store.node_touch_counts()
                chain_base = wave_base
            # chunked double-buffered launches: chunk N executes
            # on device while the host replays chunk N-1's picks,
            # and chunk N+1 chains on N's device-resident carry
            # without a host round trip.  Splitting the eval scan
            # at chunk boundaries is bit-identical to one launch.
            # Each descriptor is (arena, slice start/end, run
            # index of the arena's eval 0) — admitted chunks bring
            # their own arena, chained on the live carry.
            # Mesh arenas (asm.use_mesh) run the same pipeline: the
            # launch dispatches K12's chunk and the sharded usage carry
            # threads chunk -> chunk on the device (the mesh_launch /
            # mesh_fetch stages).
            chunks = [
                (asm, s, s + asm.chunk, idx)
                for s in range(0, asm.E, asm.chunk)
            ]
            if asm.use_mesh:
                metrics = getattr(self.server, "metrics", None)
                if metrics is not None:
                    metrics.set_gauge("mesh.chunk_width", asm.chunk)
            # continuous micro-batching: while this chain is in
            # flight, evals the broker receives are admitted as
            # new chunks of the SAME chain — but only when the
            # chain covers the whole remaining gulp (nothing
            # queued behind it to leapfrog), no eval was already
            # deferred this batch, and the chain carries no
            # port/device occupancy (an admitted arena cannot
            # splice into those slot axes)
            admission = None
            chain_jobs: Set[tuple] = set()
            if (
                admit
                and self.admit_enabled
                and j == len(run)
                and not self._deferred
                and asm.port_ask is None
                and asm.dev_ask is None
            ):
                admission = _AdmissionQueue(self)
                # reachable from _abandon_leases while the chain runs:
                # a fault mid-chain must nack the leases it deferred
                self._admission_live = admission
                chain_jobs = {
                    (r_ev.namespace, r_ev.job_id)
                    for r_ev, _t, _jb in run[idx:j]
                }
                if chain_base is None:
                    # touch-count baseline for the admission
                    # strict-node gate (the wave captured it
                    # already when parallel replay is on)
                    chain_base = self.store.node_touch_counts()
            pending = deque()
            carry = None
            ci = 0
            while (ci < len(chunks) or pending) and not rescore:
                try:
                    self._check_leadership(wave_gen)
                except NotLeaderError:
                    # leadership left mid-chain: drop the
                    # in-flight launches (they finish on the
                    # worker's stream; nothing reads their rows),
                    # then re-raise — run() nacks every lease;
                    # NOTHING of this chain commits, sequential
                    # fallback included
                    LOG.info(
                        "leadership revoked mid-chain; dropping "
                        "%d in-flight chunk(s)", len(pending),
                    )
                    pending.clear()
                    raise
                while ci < len(chunks) and len(pending) < self.pipeline_depth:
                    casm, c0, c1, base = chunks[ci]
                    # mesh chunks time, trace and guard under their own
                    # stage names (their own cost and watchdog budget)
                    launch_stage = (
                        "mesh_launch" if casm.use_mesh else "launch"
                    )
                    t0 = _time.monotonic()
                    handle = self._guard_device(
                        launch_stage,
                        lambda: self._launch_chunk(casm, c0, c1, carry),
                        "prescore launch failed",
                        exemplar=run[idx][0].id,
                    )
                    dt = _time.monotonic() - t0
                    self._observe_chunk(
                        launch_stage, run, base, c0,
                        min(c1, casm.E_real), t0, dt, chunk=ci,
                    )
                    carry = handle[2]
                    pending.append((chunks[ci], handle, dt))
                    ci += 1
                    # chaos seam: deterministic revoke-mid-launch
                    # races (no-op unless a test armed the hook)
                    _chaos.fire("chunk_launched")
                if admission is not None and not rescore:
                    # poll while the oldest chunk executes on
                    # device; an admitted group becomes the
                    # chain's next chunk(s) and the launch loop
                    # above dispatches it next iteration
                    new_chunks, j = self._admit_into_chain(
                        admission, snap, run, sims, idx, j,
                        chain_jobs, chain_base, wave_readiness,
                        asm, chunk_w,
                    )
                    if new_chunks:
                        chunks.extend(new_chunks)
                        continue
                if not pending:
                    break
                (casm, c0, c1, base), handle, launch_dt = (
                    pending.popleft()
                )
                fetch_stage = "mesh_fetch" if casm.use_mesh else "fetch"
                t0 = _time.monotonic()
                rows_arr, pulls_arr = self._guard_device(
                    fetch_stage, lambda: self._fetch(handle),
                    "prescore fetch failed", exemplar=run[idx][0].id,
                )
                dt = _time.monotonic() - t0
                self._observe_chunk(
                    fetch_stage, run, base, c0,
                    min(c1, casm.E_real), t0, dt,
                )
                # feed the adaptive sizing loop: this chunk's
                # blocking device-path cost (dispatch + the fetch
                # wait replay overlap didn't hide), keyed by its
                # width bucket — mesh dispatches into their own
                self._note_launch_cost(
                    c1 - c0, (launch_dt + dt) * 1000.0,
                    mesh=casm.use_mesh,
                )
                for e in range(c0, min(c1, casm.E_real)):
                    if rescore:
                        break
                    ev, token, job = run[base + e]
                    sim = sims[base + e - idx]
                    rows = [
                        int(r)
                        for r in rows_arr[
                            e - c0, : sim.placements
                        ]
                    ]
                    pulls = [
                        int(p)
                        for p in pulls_arr[
                            e - c0, : sim.placements
                        ]
                    ]
                    if wave is not None:
                        wave.append((
                            ev, token, job, sim, rows, pulls,
                            spec_pool.submit(
                                self._speculate_one, snap,
                                wave_readiness, ev, job, sim,
                                rows, pulls,
                            ),
                        ))
                        continue
                    ok = self._replay_one(
                        ev, token, job, sim, rows, pulls
                    )
                    k += 1
                    if not ok:
                        rescore = True
                if wave is not None and wave and not rescore:
                    # continuous commit: drain the READY prefix of
                    # the wave in order, so these evals ack now —
                    # not when the (possibly admission-extended)
                    # chain finally ends.  Blocking only happens
                    # in the final drain below.
                    try:
                        k, rescore = self._commit_wave(
                            wave, k, wave_base, wave_readiness,
                            state=wave_state, drain_all=False,
                            leader_gen=wave_gen,
                        )
                    except NotLeaderError:
                        pending.clear()
                        raise
            self._admission_live = None
            if admission is not None and admission.deferred:
                # gated-out arrivals: the worker holds their
                # leases; run() processes them as the next gulp
                self._deferred.extend(admission.deferred)
            if wave and not rescore:
                # final drain: block on whatever speculations are
                # still running (a rescore above discards the rest —
                # the outer loop re-prescores them on fresh state)
                k, rescore = self._commit_wave(
                    wave, k, wave_base, wave_readiness,
                    state=wave_state, drain_all=True,
                    leader_gen=wave_gen,
                )
            if not rescore:
                # evals no fetched chunk replayed take the exact
                # sequential path, preserving queue order
                while k < j:
                    ev, token, _job = run[k]
                    self._process_sequential(ev, token)
                    k += 1
            idx = k

    # -- continuous micro-batching (mid-chain admission) ---------------

    def _admission_gates(
        self, snap, ev: Evaluation, job: Optional[Job],
        chain_jobs: Set[tuple], chain_base: Dict[str, int],
        wave_readiness: int,
    ) -> Optional[str]:
        """Serial-equivalence gates for admitting ``ev`` into an
        in-flight chain.  Returns a defer reason, or None when the
        eval would see EXACTLY the state a fresh gulp would: its
        simulation runs against the chain snapshot, so every
        reconciler input it reads there must be provably identical to
        what a fresh snapshot would show — the usage columns evolve
        inside the kernel carry (which models every earlier chain
        member's deltas exactly), and everything the carry does NOT
        model is fenced here, mirroring the optimistic replay wave's
        conflict vocabulary.

        Note what does NOT need a fence: job versions and deployment
        state.  ``StateSnapshot`` is a live delegating view (mutation
        is serialized behind the plan applier), so the admitted
        eval's simulation reads the CURRENT job/deployment — exactly
        what a fresh gulp's simulation would — and drift between
        simulation and replay is caught by the replay's ``set_job``
        deviation, the same way it is for gulped evals."""
        if not self._batchable(ev, job):
            return "unbatchable"
        if (ev.namespace, ev.job_id) in chain_jobs:
            # a chain member of the same job is ahead of this eval:
            # its commit changes allocs_by_job, the reconciler's
            # primary input (the broker serializes same-job evals,
            # but an ack mid-chain releases the next one)
            return "job_in_chain"
        if self.store.readiness_generation() != wave_readiness:
            # the ready-node set moved since the chain started: one
            # candidate world per chain is an assumption of the
            # serial-equivalence argument (and of the wave's
            # commit-time readiness fence)
            return "readiness"
        count = self.store.node_touch_count
        for alloc in snap.allocs_by_job(ev.namespace, ev.job_id):
            if count(alloc.node_id) != chain_base.get(
                alloc.node_id, 0
            ):
                # a node hosting this job's allocs was written since
                # the chain baseline (by a chain commit or an external
                # writer): the reconciler/tainted-scan/in-place probes
                # read it as a control-flow input — and in wave mode
                # the commit-time strict-node fence would discard the
                # speculation anyway; defer instead of churning
                return "strict_node"
        return None

    def _admit_into_chain(
        self, admission: _AdmissionQueue, snap, run, sims,
        idx: int, j: int, chain_jobs: Set[tuple],
        chain_base: Dict[str, int], wave_readiness: int,
        asm0: _Assembled, chunk_w: int,
    ) -> Tuple[list, int]:
        """One admission round: poll the broker for evals that arrived
        while the chain is in flight, gate them, simulate the admitted
        prefix against the chain snapshot and assemble it into new
        chunk descriptor(s) chained on the live carry.  Appends
        admitted members to ``run``/``sims`` (keeping the replay
        loop's indexing contract) and returns (new descriptors,
        updated j).  A gate failure defers the eval AND closes the
        queue — FIFO with the chain is absolute."""
        import time as _time

        budget = self.batch_max - (j - idx)
        polled = admission.poll(min(budget, chunk_w))
        if not polled:
            return [], j
        t0 = _time.monotonic()
        admitted: List[Tuple[Evaluation, str, Job]] = []
        adm_sims: List[_Sim] = []
        for ev, token in polled:
            if admission.closed:
                # an earlier poll member was deferred: everything
                # after it defers too (no leapfrogging)
                admission.deferred.append((ev, token))
                self._count_admission("deferred")
                TRACE.event(
                    ev.id, "batch_worker.admit_deferred",
                    reason="queue_closed",
                )
                self._record_decision(
                    "admission_defer", "defer",
                    outcome="queue_closed", trace_id=ev.id,
                )
                continue
            job = self.store.job_by_id(ev.namespace, ev.job_id)
            reason = self._admission_gates(
                snap, ev, job, chain_jobs, chain_base,
                wave_readiness,
            )
            sim = None
            if reason is None:
                try:
                    sim = self._simulate(snap, ev, job)
                except Exception:  # noqa: BLE001
                    self._count("errors")
                    LOG.warning(
                        "admission simulate failed for eval %s",
                        ev.id, exc_info=True,
                    )
                if sim is None:
                    reason = "simulate"
                elif sim.asked_ports and any(sim.asked_ports):
                    # the chain's kernel carries no port-slot axis
                    # (admission is disabled on chains that have one)
                    reason = "ports"
                elif any(d for d in sim.asked_devices):
                    reason = "devices"
            if reason is not None:
                admission.defer(ev, token)
                self._count_admission("deferred")
                TRACE.event(
                    ev.id, "batch_worker.admit_deferred",
                    reason=reason,
                )
                self._record_decision(
                    "admission_defer", "defer",
                    inputs={
                        "wave_readiness": wave_readiness,
                        "chunk_w": chunk_w,
                    },
                    outcome=reason, trace_id=ev.id,
                )
                continue
            admitted.append((ev, token, job))
            adm_sims.append(sim)
        if not admitted:
            return [], j
        # same snapshot, same chunk width, same backend path (sharded
        # or not) and SAME device-column mirror as the chain head: the
        # chain's carry already holds every earlier member's deltas,
        # and a mid-chain re-sync would patch rows the admitted arena's
        # snapshot never saw
        try:
            asm2 = self._guard_device(
                "assemble",
                lambda: self._assemble(
                    snap, admitted, adm_sims, chunk=chunk_w,
                    shared_cols=asm0.dev_cols, mesh=asm0.use_mesh,
                ),
                f"admission assembly failed for {len(admitted)} evals",
                exemplar=admitted[0][0].id,
            )
        except BaseException:
            # the chain aborts here: park the group's leases ahead of
            # the gated ones (it was dequeued first), where the abort
            # path nacks them
            admission.deferred[0:0] = [
                (ev, token) for ev, token, _job in admitted
            ]
            raise
        if (
            asm2.port_ask is not None or asm2.dev_ask is not None
            or asm2.use_mesh != asm0.use_mesh
        ):
            # unreachable port/dev arenas are gated per-sim above;
            # defensive — defer the whole admitted group, INSERTED
            # AHEAD of any evals this round already gate-deferred:
            # the admitted group was dequeued first, and the deferred
            # list is replayed as the next gulp in list order, so
            # appending would leapfrog the serial order
            admission.closed = True
            admission.deferred[0:0] = [
                (ev, token) for ev, token, _job in admitted
            ]
            for ev, _token, _job in admitted:
                self._count_admission("deferred")
                TRACE.event(
                    ev.id, "batch_worker.admit_deferred",
                    reason="assembly",
                )
                self._record_decision(
                    "admission_defer", "defer_group",
                    inputs={"group": len(admitted)},
                    outcome="assembly", trace_id=ev.id,
                )
            return [], j
        if not admission.admitted_any:
            # first successful admission into THIS chain
            admission.admitted_any = True
            self._count_admission("chains")
        base = len(run)  # == j: the chain covers the whole gulp
        for (ev, token, job), sim in zip(admitted, adm_sims):
            run.append((ev, token, job))
            sims.append(sim)
            chain_jobs.add((ev.namespace, ev.job_id))
            self._admitted_live.append((ev, token))
        dt = _time.monotonic() - t0
        self._observe("admit", dt, exemplar=admitted[0][0].id)
        for pos, (ev, _token, _job) in enumerate(admitted):
            TRACE.add_span(
                ev.id, "batch_worker.admit", t0, dt,
                chain_pos=base - idx + pos,
                members=len(admitted),
            )
            self._count_admission("admitted")
        descriptors = [
            (asm2, s, s + asm2.chunk, base)
            for s in range(0, asm2.E, asm2.chunk)
        ]
        return descriptors, base + len(admitted)

    def _replay_one(
        self, ev, token, job, sim: _Sim,
        rows: List[int], pulls: Optional[List[int]],
    ) -> bool:
        """Replay one prescored eval; returns False when the chained
        state past it is suspect (failed pick, deviation, or replay
        error) and the caller must re-prescore the remainder."""
        import time as _time

        # None = unknown writes until a clean prescored replay records
        # its committed plan's touches (the wave commit loop reads it)
        self._last_replay_touches = None
        if rows is None:
            # storm wave member the solver could not cover: the full
            # sequential path owns it.  True (not the chain's
            # "suspect" False): storm rows are computed from the
            # baseline + the solver's capacity model, not a
            # sequential carry, so a fallback commit does not
            # invalidate later members' rows — their own conflict
            # fences see this commit's writes as unexpected touches
            # and serialize exactly the members it actually affected.
            self._process_sequential(ev, token)
            return True
        t0 = _time.monotonic()
        try:
            clean = self._process_prescored(
                ev, token, job, rows, sim, pulls=pulls
            )
            replay_dt = _time.monotonic() - t0
            self._observe("replay", replay_dt, exemplar=ev.id)
            TRACE.add_span(
                ev.id, "batch_worker.replay", t0, replay_dt,
                mode="serial", clean=clean,
            )
            self._replay_ewma_ms = (
                0.8 * self._replay_ewma_ms
                + 0.2 * replay_dt * 1000.0
            )
            self._count("prescored")
            self._sample_eval_latency(ev)
            EXPLAIN.annotate(ev.id, LeaderGen=self._leader_gen())
            # a failed prescored pick means the chained state past
            # this eval is suspect — re-prescore
            return clean
        except _Deviation as dev:
            self._count("fallbacks")
            TRACE.event(
                ev.id, "batch_worker.fallback",
                reason="deviation", detail=str(dev),
            )
            self._process_sequential(ev, token)
            return False
        except Exception:  # noqa: BLE001
            self._count("errors")
            LOG.warning(
                "prescored replay failed for eval %s", ev.id,
                exc_info=True,
            )
            TRACE.event(
                ev.id, "batch_worker.fallback", reason="error"
            )
            self._nack_quietly(ev, token)
            return False

    # -- global storm solver (NOMAD_TPU_STORM=1) ------------------------

    def _maybe_drain_storm(self, ev, token):
        """Detect a storm at the gulp boundary: when the broker's
        ready prefix continues ``ev``'s job family for at least
        ``storm_min`` members total, drain that prefix atomically
        (never leapfrogging unrelated evals) and return the FIFO
        member list.  None = no storm; nothing was dequeued."""
        import time as _time

        from .eval_broker import job_family

        family = job_family(ev)
        if not family[1]:
            return None
        try:
            drained = self.server.broker.drain_family(
                self.schedulers,
                family,
                max_n=self.storm_max - 1,
                min_n=max(0, self.storm_min - 1),
            )
        except Exception:  # noqa: BLE001 — detection is best-effort
            LOG.warning("storm drain failed", exc_info=True)
            return None
        if len(drained) + 1 < self.storm_min:
            return None
        for d_ev, _tok in drained:
            self._note_dequeue(d_ev)
        members = [(ev, token)] + drained
        # settle beats: a storm ARRIVES as a wave (drain loop, restore
        # scan, dispatch burst), so keep absorbing the family prefix
        # while it is still growing — one empty BATCH_WAIT_S beat ends
        # the hunt.  Unrelated evals still fence the walk
        # (drain_family never leapfrogs), so FIFO fairness holds.
        waited = False
        while len(members) < self.storm_max:
            try:
                more = self.server.broker.drain_family(
                    self.schedulers,
                    family,
                    max_n=self.storm_max - len(members),
                )
            except Exception:  # noqa: BLE001 — growth is optional;
                # the members already leased MUST still be processed
                LOG.warning(
                    "storm settle drain failed", exc_info=True
                )
                break
            if more:
                for d_ev, _tok in more:
                    self._note_dequeue(d_ev)
                members.extend(more)
                waited = False
                continue
            if waited:
                break
            _time.sleep(BATCH_WAIT_S)
            waited = True
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.set_gauge("storm.backlog", float(len(members)))
        for pos, (s_ev, _tok) in enumerate(members):
            TRACE.event(
                s_ev.id, "batch_worker.storm_gulp",
                size=len(members), pos=pos,
                family=f"{family[0]}/{family[1]}",
            )
        return members

    def _process_storm(
        self, members: List[Tuple[Evaluation, str]]
    ) -> List[Tuple[Evaluation, str]]:
        """Coalesce one family storm into a single global
        (pending-allocs x candidate-nodes) assignment solve (kernel
        K5), then decompose the converged assignment into per-eval
        prescored plans that commit in broker FIFO order through the
        existing ``_commit_wave`` conflict fences.  A member the
        solver does not cover — ineligible shape, row budget,
        unassignable row, or a commit-time conflict cascade — takes
        the sequential path or re-enters the batch path, as in the JAX
        package, so zero evals are lost.  A failure of the staging,
        the solve or its fetch raises DeviceFault (the JAX package
        instead demotes the whole storm to the sequential path).
        Returns leftover evals under the ``_process_batch``
        contract."""
        import time as _time

        from ..sched.storm import StormMember, build_storm_problem, decompose

        self._count_storm("evals", len(members))
        snap = self.store.snapshot()
        wave_readiness = self.store.readiness_generation()
        wave_base = self.store.node_touch_counts()
        # leadership fence: the generation this storm solves under —
        # checked after the solve and again before every member commit
        wave_gen = self._leader_gen()

        # simulation pre-pass, FIFO order (the same host mirror of
        # computeJobAllocs the chunk chain runs)
        t0 = _time.monotonic()
        storm_members: List[StormMember] = []
        for ev, token in members:
            job = self.store.job_by_id(ev.namespace, ev.job_id)
            member = StormMember(
                ev=ev, token=token, job=job, leader_gen=wave_gen
            )
            if not self._batchable(ev, job):
                member.reason = "unbatchable"
            else:
                try:
                    with TRACE.span(ev.id, "batch_worker.simulate"):
                        member.sim = self._simulate(snap, ev, job)
                except Exception:  # noqa: BLE001
                    self._count("errors")
                    LOG.warning(
                        "storm simulate failed for eval %s", ev.id,
                        exc_info=True,
                    )
                if member.sim is None:
                    member.reason = "simulate"
            storm_members.append(member)
        self._observe(
            "simulate", _time.monotonic() - t0, exemplar=members[0][0].id
        )

        # stage + solve: one device call for the whole backlog
        t1 = _time.monotonic()
        try:
            problem = build_storm_problem(self, snap, storm_members)
        except Exception as exc:  # noqa: BLE001
            raise DeviceFault(
                f"storm staging failed for {len(members)} evals"
            ) from exc
        self._observe(
            "storm_stage", _time.monotonic() - t1,
            exemplar=members[0][0].id,
        )
        out = None
        if problem is not None and problem.n_rows > 0:
            t1 = _time.monotonic()
            out = self._guard_device(
                "storm_solve",
                lambda: self._storm_solve(problem, snap),
                f"storm solve failed for {problem.n_rows} rows",
                exemplar=members[0][0].id,
            )
            dt = _time.monotonic() - t1
            solver_members = [
                m for m in storm_members if m.reason is None
            ]
            self._observe(
                "storm_solve", dt, exemplar=members[0][0].id
            )
            for pos, m in enumerate(solver_members):
                TRACE.add_span(
                    m.ev.id, "batch_worker.storm_solve", t1, dt,
                    chain_pos=pos, members=len(solver_members),
                    rows=problem.n_rows,
                )
            # solver wall time feeds its OWN EWMA bucket
            # (launch_ewma_ms.storm) — never the chunk-width buckets
            # the adaptive gulp policy plans flushes from
            self._note_launch_cost(0, dt * 1000.0, storm=True)
        # chaos seam: deterministic revoke-mid-solve races (a no-op in
        # the port)
        _chaos.fire("storm_solved")
        # leadership fence: a revoke mid-solve discards the solve
        # result BEFORE decompose; run()'s NotLeaderError handler
        # nacks every member lease for redelivery
        self._check_leadership(wave_gen)
        if problem is not None:
            t2 = _time.monotonic()
            solved_rows = decompose(problem, out)
            dt2 = _time.monotonic() - t2
            self._observe(
                "storm_decompose", dt2, exemplar=members[0][0].id
            )
            if out is not None:
                rounds = int(out[5])
                self._count_storm("solves")
                self._count_storm("rows", solved_rows)
                divergent = sum(
                    m.divergent_rows
                    for m in storm_members
                    if m.rows is not None
                )
                if divergent:
                    self._count_storm("divergent", divergent)
                metrics = getattr(self.server, "metrics", None)
                if metrics is not None:
                    metrics.set_gauge("storm.rounds", float(rounds))
                for m in storm_members:
                    if m.rows is not None:
                        TRACE.add_span(
                            m.ev.id,
                            "batch_worker.storm_decompose",
                            t2, dt2, rows=len(m.rows),
                            round=m.solver_round,
                            divergent=m.divergent_rows,
                        )

        # in-order commit through the existing conflict fences:
        # solved members speculate on the replay pool (or replay
        # their solver rows serially when parallel replay is off);
        # fallback members ride the same wave with rows=None so FIFO
        # order with their solved siblings is preserved
        spec_pool = (
            self._replay_pool_instance()
            if self.parallel_replay
            else None
        )
        wave = deque()
        for m in storm_members:
            if m.rows is not None:
                fut = (
                    spec_pool.submit(
                        self._speculate_one, snap, wave_readiness,
                        m.ev, m.job, m.sim, m.rows, m.pulls,
                    )
                    if spec_pool is not None
                    else _DoneFuture(None)
                )
                wave.append((
                    m.ev, m.token, m.job, m.sim, m.rows, m.pulls,
                    fut,
                ))
            else:
                self._count_storm("fallbacks")
                TRACE.event(
                    m.ev.id, "storm.fallback",
                    reason=m.reason or "solver",
                )
                wave.append((
                    m.ev, m.token, m.job, m.sim, None, None,
                    _DoneFuture(None),
                ))
        wave_state = {"job_ledger": set(), "expect": {}}
        self._commit_wave(
            wave, 0, wave_base, wave_readiness,
            state=wave_state, drain_all=True, leader_gen=wave_gen,
        )
        leftover: List[Tuple[Evaluation, str]] = []
        if wave:
            # a mid-wave rescore abandoned the remaining members'
            # speculations; their leases are still held — re-feed
            # them through the normal batch path (chunk chain or
            # sequential), never dropping one.  Solver-placed members
            # in the remainder are DEMOTED (rows cleared) so the
            # trace audit never tags their eventual chunk-chain
            # placements as solver output, and the fallback counter
            # counts each member once.
            remaining = [
                (r_ev, r_token)
                for (r_ev, r_token, *_rest) in wave
            ]
            remaining_ids = {r_ev.id for r_ev, _rt in remaining}
            demoted = 0
            for m in storm_members:
                if m.ev.id in remaining_ids and m.rows is not None:
                    m.rows = None
                    m.pulls = None
                    demoted += 1
                    TRACE.event(
                        m.ev.id, "storm.fallback",
                        reason="rescore",
                    )
            if demoted:
                self._count_storm("fallbacks", demoted)
            leftover = self._process_batch(remaining)
        # explain-ring audit trail: every committed member whose
        # placements came from the solver carries the solver round,
        # aggregate assignment score and greedy-walk divergence, so an
        # explanation shows why the global solve differed from the
        # serial walk
        for m in storm_members:
            if m.rows is None:
                continue
            EXPLAIN.annotate(
                m.ev.id,
                Storm={
                    "Round": m.solver_round,
                    "AssignmentScore": round(m.assignment_score, 6),
                    "DivergentRows": m.divergent_rows,
                    "Rows": len(m.rows),
                    "LeaderGen": m.leader_gen,
                },
            )
            TRACE.annotate(
                m.ev.id, outcome_detail="storm",
                storm_round=m.solver_round,
            )
        self._export_adaptive_gauges()
        return leftover

    def _storm_solve(self, problem, snap):
        """One storm assignment solve against the device-resident
        usage mirror, returning the six outputs as numpy.  ``snap`` is
        the SAME snapshot the problem was staged against — the solve's
        arena row indices are only meaningful against that table.  On
        the card the staged inputs go up through pinned memory, K5
        runs and the outputs come back, all on the worker's one
        stream behind every K4 patch of the mirror; on the CPU the
        twin runs.

        On a mesh worker whose arena tiles over the mesh the solve runs
        node-sharded (K14) over the same mesh and sharded usage mirror
        as the chunk chain: the node-indexed inputs are placed by
        `sched.storm.stage_for_mesh`, each shard scores and auctions its
        own nodes, and the answer equals the single-device solve."""
        from ..ops.solve import (
            StormInputs,
            storm_assignment,
            storm_assignment_sharded,
        )
        from ..sched.storm import stage_for_mesh

        max_rounds = problem.max_rounds
        if self.storm_rounds > 0:
            max_rounds = min(max_rounds, self.storm_rounds)
        table = snap.node_table
        mesh = self._live_mesh()
        sharded = mesh is not None and table.capacity % mesh.n_shards == 0
        cols = self._device_columns(table, sharded=sharded)
        with self._on_stream():
            inp = StormInputs(*(
                None if leaf is None else self._upload(np.asarray(leaf))
                for leaf in problem.inputs
            ))
            pod = self._pod if sharded else None
            if pod is not None:
                # the storm inputs are host numpy: the peers stage them
                # on the mesh themselves and solve over their own mirror
                # shards (synced by the _device_columns call above)
                pod.send("storm", tuple(problem.inputs),
                         problem.spread_fit, max_rounds)
            if sharded:
                out = storm_assignment_sharded(
                    mesh, problem.spread_fit, max_rounds,
                    weighted=inp.policy_tput_term is not None,
                )(stage_for_mesh(inp, mesh), cols)
                self._count("mesh_storms")
            else:
                out = storm_assignment(
                    inp, cols, spread_fit=problem.spread_fit,
                    max_rounds=max_rounds,
                )
            # .cpu() waits on the worker's stream: the solve's fetch
            host_out = tuple(x.cpu().numpy() for x in out)
            if pod is not None and pod.check:
                from ..parallel.pod import result_digest

                pod.check_results(result_digest(*host_out))
            return host_out

    # -- optimistic parallel replay ------------------------------------

    def _speculate_one(
        self, snap, wave_readiness: int, ev, job, sim: _Sim,
        rows: List[int], pulls: Optional[List[int]],
    ) -> Optional[_Speculation]:
        """Phase A (pool thread): replay one prescored eval against
        the shared wave snapshot with every side effect captured
        instead of applied.  Returns None when the eval must replay
        serially — unsupported shape (active deployment, CSI
        volumes), a deviation, or any error."""
        try:
            # span runs on the pool thread, so the trace records WHICH
            # replay-spec thread carried this eval (straggler
            # attribution across the wave)
            with TRACE.span(
                ev.id, "replay.speculate", speculative=True
            ):
                return self._speculate_inner(
                    snap, wave_readiness, ev, job, sim, rows, pulls
                )
        except (_Deviation, _SpecAbort) as exc:
            TRACE.event(
                ev.id, "replay.serial_required",
                reason="deviation", detail=str(exc),
            )
            return None
        except Exception:  # noqa: BLE001 — the serial path recovers
            LOG.debug(
                "speculative replay failed for eval %s", ev.id,
                exc_info=True,
            )
            TRACE.event(
                ev.id, "replay.serial_required", reason="error"
            )
            return None

    def _speculate_inner(
        self, snap, wave_readiness: int, ev, job, sim: _Sim,
        rows: List[int], pulls: Optional[List[int]],
    ) -> Optional[_Speculation]:
        batch = ev.type == "batch"
        if not batch and snap.latest_deployment_by_job(
            ev.namespace, ev.job_id
        ) is not None:
            # deployment state is written by the watcher thread —
            # a read the per-node conflict ledger can't cover
            TRACE.event(
                ev.id, "replay.serial_required", reason="deployment"
            )
            return None
        for tg in job.task_groups:
            for req in tg.volumes.values():
                if req.type == "csi":
                    # claim races linearize at the applier; the
                    # serial path owns them
                    TRACE.event(
                        ev.id, "replay.serial_required", reason="csi"
                    )
                    return None
        if self.store.readiness_generation() != wave_readiness:
            TRACE.event(
                ev.id, "replay.serial_required", reason="readiness"
            )
            return None
        # strict read set: nodes hosting the job's allocs — the
        # reconciler, tainted-node scan and in-place update probes
        # read them as real control-flow inputs, so any touch
        # (even an own-wave commit) invalidates the speculation
        strict_nodes = {
            a.node_id
            for a in snap.allocs_by_job(ev.namespace, ev.job_id)
        }
        # non-node fences, captured BEFORE the replay reads them:
        # a job/config/deployment write between here and the
        # commit check makes the commit check disagree and
        # conflict; one between here and the replay's own read
        # makes set_job deviate.  Either way the serial path wins.
        job_now = snap.job_by_id(ev.namespace, ev.job_id)
        job_fence = (
            getattr(job_now, "version", -1),
            getattr(job_now, "modify_index", -1),
        )
        config_index = self.store.table_index("scheduler_config")
        # the broker's eval object must not see speculative writes
        spec_ev = _dc_replace(ev)
        spec_ev.snapshot_index = snap.index
        planner = _SpecPlanner(snap)
        scheduler, made = self._prescored_scheduler(
            snap, planner, spec_ev, job, rows, sim, pulls,
            speculative=True,
        )
        scheduler.process(spec_ev)
        return _Speculation(
            explain=EXPLAIN.build_record(spec_ev, scheduler),
            ops=planner.ops,
            strict_nodes=strict_nodes,
            # relaxed read set: the plan-touched nodes — their
            # reads (winner verification, plan evaluation) check
            # fit the kernel chain already modeled for every
            # earlier chain member, so own-wave touches there are
            # expected, not conflicts
            plan_nodes=set(planner.touched),
            clean=not (made and made[0].saw_failed_row),
            job_fence=job_fence,
            config_index=config_index,
            check_deployment=not batch,
        )

    @staticmethod
    def _merge_touches(
        expect: Dict[str, int], touches: Dict[str, int]
    ) -> None:
        for node_id, count in touches.items():
            expect[node_id] = expect.get(node_id, 0) + count

    @staticmethod
    def _plan_touches(node_update, node_allocation,
                      node_preemptions) -> Dict[str, int]:
        """node_id -> how many alloc writes committing these plan
        collections performs (each alloc upsert bumps its node's
        touch count once — store._upsert_allocs_locked)."""
        touches: Dict[str, int] = {}
        for coll in (node_update, node_allocation, node_preemptions):
            for node_id, allocs in coll.items():
                touches[node_id] = touches.get(node_id, 0) + len(
                    allocs
                )
        return touches

    def _commit_wave(
        self, wave, k: int, wave_base: Dict[str, int],
        wave_readiness: int, state: Optional[dict] = None,
        drain_all: bool = True, leader_gen: Optional[int] = None,
    ) -> Tuple[int, bool]:
        """Phase B: walk the wave in queue order, committing each
        eval's speculation when its read set survived every
        earlier-committed plan (and external writers), and
        re-replaying it serially otherwise.  ``wave_base`` is the
        per-node touch-count baseline captured before any speculation
        read; ``wave_expect`` accumulates the touches the wave's own
        commits perform, so kernel-modeled self-conflicts don't
        demote the whole wave.  Returns (next unhandled run index,
        rescore); rescore=True means a replay marked the chained
        state suspect — exactly the serial loop's contract, so the
        caller re-prescores the remainder and the discarded
        speculations past it are never applied.

        ``wave`` is a deque consumed from the front.  With
        ``drain_all=False`` the walk stops at the first member whose
        speculation is still running — the continuous micro-batching
        loop drains the READY prefix after every chunk fetch, so an
        eval's ack lands one chunk after its rows do instead of at
        the end of the (possibly admission-extended) chain.
        ``state`` carries the in-order commit's job ledger and
        expected-touch accounting across those incremental drains."""
        import time as _time

        if state is None:
            state = {"job_ledger": set(), "expect": {}}
        job_ledger: Set[tuple] = state["job_ledger"]
        wave_expect: Dict[str, int] = state["expect"]
        rescore = False
        while wave:
            # chaos seam: deterministic revoke between speculation and
            # commit (no-op unless a test armed the hook)
            _chaos.fire("pre_commit_wave")
            if leader_gen is not None:
                # the leadership fence, checked before EVERY member
                # commit exactly where the backend epoch would be: a
                # deposed leader's speculations are discarded, their
                # leases nacked by run()'s NotLeaderError handler,
                # and the remaining wave members' leases with them
                self._check_leadership(leader_gen)
            fut = wave[0][6]
            if not drain_all and not fut.done():
                break
            ev, token, job, sim, rows, pulls, fut = wave.popleft()
            t0 = _time.monotonic()
            try:
                spec = fut.result()
            except Exception:  # noqa: BLE001 — speculation-only work
                spec = None
            # the in-order commit's serialization wait: time this eval
            # spent parked behind earlier wave members (plus any
            # remainder of its own speculation)
            wait_dt = _time.monotonic() - t0
            TRACE.add_span(
                ev.id, "replay.commit_wait", t0, wait_dt,
                speculated=spec is not None,
            )
            ok: Optional[bool] = None
            committed = False
            if spec is not None:
                t_c = _time.monotonic()
                try:
                    ok = self._commit_speculation(
                        spec, ev, token, wave_base, wave_expect,
                        wave_readiness, job_ledger,
                        leader_gen=leader_gen,
                    )
                    committed = ok is not None
                except NotLeaderError:
                    # the plan applier (or the replicated FSM fence)
                    # rejected the commit: leadership is gone — nack
                    # this lease and abort the whole wave; run()'s
                    # handler nacks the rest
                    self._nack_quietly(ev, token)
                    raise
                except Exception:  # noqa: BLE001
                    self._count("errors")
                    LOG.warning(
                        "speculative commit failed for eval %s",
                        ev.id, exc_info=True,
                    )
                    self._nack_quietly(ev, token)
                    job_ledger.add((ev.namespace, ev.job_id))
                    ok = False  # chain past this eval is suspect
                if committed:
                    TRACE.add_span(
                        ev.id, "replay.commit", t_c,
                        _time.monotonic() - t_c, clean=bool(ok),
                    )
            if committed:
                dt = _time.monotonic() - t0
                self._observe("replay", dt, exemplar=ev.id)
                self._replay_ewma_ms = (
                    0.8 * self._replay_ewma_ms + 0.2 * dt * 1000.0
                )
            if ok is None:
                # not speculated, or the speculation lost its race:
                # replay serially against the updated state (the
                # serial loop's own snapshot/fallback semantics)
                if spec is not None:
                    self._count_replay("conflicts")
                self._count_replay("serial_fallbacks")
                TRACE.event(
                    ev.id, "replay.serial_fallback",
                    reason=(
                        "conflict" if spec is not None
                        else "unspeculated"
                    ),
                )
                job_ledger.add((ev.namespace, ev.job_id))
                ok = self._replay_one(ev, token, job, sim, rows, pulls)
                # whitelist the serial commit's touches for later
                # relaxed checks; None (unknown writes: deviation or
                # error paths) leaves them unexpected, so overlapping
                # later evals conflict — conservative
                if self._last_replay_touches is not None:
                    self._merge_touches(
                        wave_expect, self._last_replay_touches
                    )
            k += 1
            if not ok:
                rescore = True
                break
        return k, rescore

    def _commit_speculation(
        self, spec: _Speculation, ev, token,
        wave_base: Dict[str, int], wave_expect: Dict[str, int],
        wave_readiness: int, job_ledger: Set[tuple],
        leader_gen: Optional[int] = None,
    ) -> Optional[bool]:
        """Commit one speculative replay: conflict check, then replay
        the captured transcript verbatim through the real planner
        surface.  Returns the `_replay_one`-style ok flag, or None
        when the speculation conflicts and must be discarded."""
        key = (ev.namespace, ev.job_id)
        if key in job_ledger:
            # an earlier wave member of the SAME job committed: its
            # allocs/evals are reads this reconciler pass depended on
            TRACE.event(
                ev.id, "replay.conflict", fence="job_ledger"
            )
            return None
        if self.store.readiness_generation() != wave_readiness:
            # the ready-node set moved: candidate scans (and the
            # nodes_available placement metrics) are stale
            TRACE.event(
                ev.id, "replay.conflict", fence="readiness"
            )
            return None
        # per-node conflict check against the touch-count ledger:
        # strict nodes accept NO touch past the baseline; plan nodes
        # accept exactly the touches this wave's own commits account
        # for (kernel-modeled), so only external writes conflict
        count = self.store.node_touch_count
        for node_id in spec.strict_nodes:
            if count(node_id) != wave_base.get(node_id, 0):
                TRACE.event(
                    ev.id, "replay.conflict",
                    fence="strict_node", node=node_id,
                )
                return None
        for node_id in spec.plan_nodes:
            expected = wave_base.get(node_id, 0) + (
                0
                if self.replay_strict
                else wave_expect.get(node_id, 0)
            )
            if count(node_id) != expected:
                TRACE.event(
                    ev.id, "replay.conflict",
                    fence="plan_node", node=node_id,
                )
                return None
        # non-node fences (reads the per-node ledger can't cover)
        job_now = self.store.job_by_id(ev.namespace, ev.job_id)
        if (
            getattr(job_now, "version", -1),
            getattr(job_now, "modify_index", -1),
        ) != spec.job_fence:
            TRACE.event(
                ev.id, "replay.conflict", fence="job_version"
            )
            return None
        if (
            self.store.table_index("scheduler_config")
            != spec.config_index
        ):
            TRACE.event(
                ev.id, "replay.conflict", fence="scheduler_config"
            )
            return None
        if spec.check_deployment and (
            self.store.latest_deployment_by_job(
                ev.namespace, ev.job_id
            )
            is not None
        ):
            TRACE.event(
                ev.id, "replay.conflict", fence="deployment"
            )
            return None
        if leader_gen is not None:
            # last host-side leadership fence before any captured op
            # is applied (the replicated FSM fence backstops the
            # check-to-apply window on a cluster server)
            self._check_leadership(leader_gen)
        commit_index = self.store.latest_index()
        # the serial loop stamps each replay's fresh snapshot index on
        # the eval's status writes; the commit point is that replay's
        # moment in the serial order
        ev.snapshot_index = commit_index
        # plan submits apply FIRST (a transcript holds at most one —
        # process() runs a single pass in speculation): if the applier
        # partially commits despite the conflict check (external race
        # between check and apply), NO other captured op has been
        # applied yet, so the sequential recovery below re-runs the
        # eval without duplicating blocked/follow-up evals.  Eval
        # writes that preceded the submit in capture order land after
        # it instead — safe, because BlockedEvals.block's
        # missed-unblock check requeues a late-registered blocked
        # eval past any capacity change our own commit triggered.
        ordered = sorted(
            spec.ops, key=lambda op: 0 if op[0] == "submit" else 1
        )
        for op, payload in ordered:
            if op == "submit":
                if leader_gen is not None:
                    # stamp the WAVE's captured generation, not the
                    # submit-time one: a straggler thread committing
                    # after this server was re-elected must carry the
                    # deposed generation so the replicated FSM fence
                    # rejects it (propose-time stamping would launder
                    # the stale plan under the new term)
                    payload.leader_gen = leader_gen
                result, refreshed = self.submit_plan(payload)
                if refreshed is not None or not result.is_full_commit(
                    payload
                ):
                    # the conflict guard missed a race (external
                    # writer between check and apply): the plan
                    # partially committed, so the captured transcript
                    # past this point is invalid.  Recover like the
                    # serial partial-commit path — the real scheduler
                    # on refreshed state sees the committed subset and
                    # finishes the eval — and mark the chain suspect.
                    LOG.warning(
                        "speculative commit for eval %s was partial;"
                        " recovering via the sequential path", ev.id,
                    )
                    self._count_replay("serial_fallbacks")
                    TRACE.event(
                        ev.id, "replay.serial_fallback",
                        reason="partial_commit",
                    )
                    job_ledger.add(key)
                    self._process_sequential(ev, token)
                    return False
                # a full commit wrote exactly the plan's collections:
                # record those touches as expected for later relaxed
                # conflict checks in this wave
                self._merge_touches(
                    wave_expect,
                    self._plan_touches(
                        payload.node_update,
                        payload.node_allocation,
                        payload.node_preemptions,
                    ),
                )
            else:
                if getattr(payload, "id", None) == ev.id:
                    payload.snapshot_index = commit_index
                if op == "update_eval":
                    self.update_eval(payload)
                elif op == "create_eval":
                    self.create_eval(payload)
                else:
                    self.reblock_eval(payload)
        job_ledger.add(key)
        self.evals_processed += 1
        TRACE.annotate(ev.id, outcome="speculative")
        EXPLAIN.publish(
            spec.explain, getattr(self.server, "metrics", None)
        )
        if leader_gen is not None:
            # the published explanation names the leadership
            # generation whose wave committed it
            EXPLAIN.annotate(ev.id, LeaderGen=leader_gen)
        self.server.broker.ack(ev.id, token)
        self._count("prescored")
        self._count_replay("speculative")
        self._sample_eval_latency(ev)
        return spec.clean

    def _process_sequential(self, ev, token) -> None:
        import time as _time

        # set before processing: process_eval acks (finishing the
        # trace) inside, and the annotated outcome must be there first
        TRACE.annotate(ev.id, outcome="sequential")
        t0 = _time.monotonic()
        try:
            self.process_eval(ev, token)
        except DeviceFault:
            # the per-eval device stack failed: fatal to the worker
            # (run() nacks the gulp's leases and stops)
            raise
        except Exception:  # noqa: BLE001
            # nacked for redelivery, and counted: a failure here must
            # not loop as silent redeliveries
            self._count("errors")
            LOG.warning(
                "sequential processing failed for eval %s", ev.id,
                exc_info=True,
            )
            self._nack_quietly(ev, token)
        dt = _time.monotonic() - t0
        self._observe("sequential", dt, exemplar=ev.id)
        TRACE.add_span(ev.id, "batch_worker.sequential", t0, dt)
        self._sample_eval_latency(ev)
        # failover forensics: every explain record names the
        # leadership generation whose pipeline produced it
        EXPLAIN.annotate(ev.id, LeaderGen=self._leader_gen())

    def _nack_quietly(self, ev, token) -> None:
        self._deq_ts.pop(ev.id, None)
        try:
            self.server.broker.nack(ev.id, token)
        except ValueError:
            pass

    # ------------------------------------------------------------------

    def _batchable(self, ev: Evaluation, job: Optional[Job]) -> bool:
        if job is None or job.stopped():
            return False
        if ev.type not in ("service", "batch"):
            return False
        # multi-task-group jobs run in-kernel in full: per-pick
        # group routing (TGInputs), distinct_hosts in both scopes
        # (occ_extra + dh_tg), and GROUP-scoped spread slots routed by
        # SpreadInputs.group
        for tg in job.task_groups:
            # both spread modes run in-kernel: percent targets via the
            # desired/used carry, even mode (no targets) via min/max
            # over the observed use map (ops/batch.py even_full)
            # host-mode DYNAMIC-port asks are batchable: binpack never
            # skips a node for a dynamic-only ask (the per-node range
            # is thousands of ports), so the sequential walk window is
            # port-independent and the kernel's port-blind scoring
            # stays bit-identical; the winner's exact BinPack
            # verification (PrescoredStack.select) still assigns the
            # real ports.
            # Reserved/static ports run in-kernel as a walk-slot-
            # neutral collision mask (ops/batch.py PortInputs): a
            # port-collided node is skipped by binpack WITHOUT
            # consuming a limit slot (rank.py continue) — identical
            # to infeasibility in the walk arithmetic.  Exceptions
            # that stay sequential: static asks INSIDE the dynamic
            # range (an in-chain dynamic assignment could collide
            # invisibly, and a non-winner divergence would shift the
            # walk window past what winner verification can catch)
            # and port releases intersecting asked ports (gated in
            # _flush_run).  Non-host modes gate on NetworkChecker
            # feasibility the kernel doesn't model.
            from ..structs.network import MIN_DYNAMIC_PORT

            for nw in list(tg.networks) + [
                n for t in tg.tasks for n in t.resources.networks
            ]:
                if (nw.mode or "host") != "host":
                    return False
                for p in nw.reserved_ports:
                    if p.value >= MIN_DYNAMIC_PORT:
                        return False
            # device asks run in-kernel: capacity-count masks over a
            # chained free-instance carry (ops/batch.py DeviceInputs);
            # overlapping ask signatures and instance releases gate
            # per-batch in _flush_run.  Device AFFINITIES run
            # in-kernel too: under the chain gates each node has
            # at most ONE group matching an ask, so the allocator's
            # match fraction (rank.go:460) is a STATIC per-node score
            # column (_device_affinity_column)
            for t in tg.tasks:
                for req in t.resources.devices:
                    # count<=0 is rejected by the sequential
                    # allocator on every node (device.py invalid
                    # request) — the kernel would treat it as
                    # trivially satisfiable and deviate every time
                    if req.count <= 0:
                        return False
            # distinct_hosts IS batchable for single-TG jobs: the
            # kernel's collision carry equals the proposed-allocs-
            # per-node count, so the mask is exact
            if tg.ephemeral_disk.sticky:
                return False
        return True

    # ------------------------------------------------------------------

    def _simulate(self, snap, ev: Evaluation,
                  job: Job) -> Optional[_Sim]:
        """Host-side mirror of computeJobAllocs up to (not including)
        the select calls (reference generic_sched.go:332): runs the
        real reconciler on the prescore snapshot and extracts the plan
        mutations the kernel must model.  Returns None when the eval's
        shape cannot be prescored."""
        from ..sched.context import EvalContext
        from ..sched.reconcile import AllocReconciler
        from ..sched.util import (
            generic_alloc_update_fn,
            tainted_nodes,
            update_non_terminal_allocs_to_lost,
        )

        batch = ev.type == "batch"
        plan = ev.make_plan(job)
        deployment = None
        if not batch:
            deployment = snap.latest_deployment_by_job(
                ev.namespace, ev.job_id
            )
        ctx = EvalContext(snap, plan, seed=self.seed)
        stack = GenericStack(batch, ctx)
        stack.set_job(job)

        allocs = snap.allocs_by_job(ev.namespace, ev.job_id)
        tainted = tainted_nodes(snap, allocs)
        update_non_terminal_allocs_to_lost(plan, tainted, allocs)

        reconciler = AllocReconciler(
            generic_alloc_update_fn(ctx, stack, ev.id),
            batch,
            ev.job_id,
            job,
            deployment,
            allocs,
            tainted,
            ev.id,
        )
        results = reconciler.compute()
        for stop in results.stop:
            plan.append_stopped_alloc(
                stop.alloc, stop.status_description, stop.client_status
            )

        sim = _Sim(placements=0)
        table = snap.node_table

        # spread propertyset bookkeeping, GROUP-scoped like the
        # sequential SpreadIterator (propertyset.py:151 filters each
        # pset to one task group; job-level stanzas get one pset PER
        # group).  State is keyed (group, attribute); single-group
        # jobs collapse to the historical shape.
        for g in job.task_groups:
            g_spreads = list(g.spreads) + list(job.spreads)
            if not g_spreads:
                continue
            # existing = the job's live allocs of THIS group per
            # attribute value; cleared = staged stops (terminal ones
            # included, matching _filter(stopping,
            # filter_terminal=False)); proposed = in-place/attribute
            # updates entering plan.node_allocation before any select
            # (generic_sched.py:287-294)
            live = [
                a
                for a in allocs
                if not a.terminal_status()
                and a.task_group == g.name
            ]
            stopping = [
                a
                for stops in plan.node_update.values()
                for a in stops
                if a.task_group == g.name
            ]
            staged = [
                a
                for a in list(results.inplace_update)
                + list(results.attribute_updates.values())
                if a.task_group == g.name
                and not a.terminal_status()
            ]
            for sp in g_spreads:
                key = (g.name, sp.attribute)
                sim.spread_existing[key] = _count_values(
                    snap, sp.attribute, live
                )
                sim.spread_cleared[key] = _count_values(
                    snap, sp.attribute, stopping
                )
                sim.spread_proposed[key] = _count_values(
                    snap, sp.attribute, staged
                )
            # even-mode guard: the oracle's min/max loop reproduces the
            # reference's zero-reset idiom (spread.py:162 "if min_count
            # == 0 or v < min_count"), whose result depends on map
            # iteration order once a use-map value sits at count 0.
            # That only happens when cleared zeroes a present value —
            # so evals whose even stanzas start with a zeroed value, or
            # that stage destructive evictions (cleared can grow
            # mid-chain), take the exact sequential path.
            from ..sched.spread import compute_spread_info as _csi

            infos, _w = _csi(g_spreads, g.count)
            has_even = any(
                not infos[sp.attribute]["desired_counts"]
                for sp in g_spreads
            )
            if has_even:
                if results.destructive_update:
                    return None
                for sp in g_spreads:
                    if infos[sp.attribute]["desired_counts"]:
                        continue
                    key = (g.name, sp.attribute)
                    ex = sim.spread_existing[key]
                    pr = sim.spread_proposed[key]
                    cl = sim.spread_cleared[key]
                    for value in set(ex) | set(pr):
                        raw = ex.get(value, 0) + pr.get(value, 0)
                        if raw > 0 and raw - cl.get(value, 0) <= 0:
                            return None

        def add_pre(node_id: str, c: float, m: float, d: float) -> None:
            row = table.row_of.get(node_id)
            if row is None:
                return
            acc = sim.pre.setdefault(row, [0.0, 0.0, 0.0])
            acc[0] += c
            acc[1] += m
            acc[2] += d

        evicted_ids = set()
        for node_id, stops in plan.node_update.items():
            for a in stops:
                if a.id in evicted_ids:
                    continue
                evicted_ids.add(a.id)
                orig = snap.alloc_by_id(a.id)
                if orig is None or orig.terminal_status():
                    continue  # not counted in usage columns
                r = orig.comparable_resources()
                add_pre(node_id, -r.cpu, -r.memory_mb, -r.disk_mb)

        for update in list(results.inplace_update) + list(
            results.attribute_updates.values()
        ):
            orig = snap.alloc_by_id(update.id)
            if orig is None or orig.terminal_status():
                continue
            old = orig.comparable_resources()
            new = update.comparable_resources()
            add_pre(
                update.node_id,
                new.cpu - old.cpu,
                new.memory_mb - old.memory_mb,
                new.disk_mb - old.disk_mb,
            )

        if len(sim.pre) > MAX_PRE_ROWS:
            return None

        placements = list(results.destructive_update) + list(
            results.place
        )
        # ordered distinct groups this eval places (pick k routes to
        # group slot pick_tg[k] in the kernel)
        tg_slot: Dict[str, int] = {}
        for missing in placements:
            name = missing.task_group.name
            if name not in tg_slot:
                tg_slot[name] = len(sim.tgs)
                sim.tgs.append(missing.task_group)
            sim.pick_tg.append(tg_slot[name])

        # anti-affinity base: proposed same-job+group allocs per node
        # at pre-placement time (rank.go:474 collision count), one row
        # per group slot
        coll = np.zeros(
            (max(1, len(sim.tgs)), table.capacity), dtype=np.int32
        )
        occ_extra = np.zeros(table.capacity, dtype=np.int32)
        for a in allocs:
            if a.terminal_status() or a.id in evicted_ids:
                continue
            if a.job_id != job.id:
                continue
            slot = tg_slot.get(a.task_group)
            row = table.row_of.get(a.node_id)
            if row is None:
                continue
            if slot is not None:
                coll[slot, row] += 1
            else:
                # a group placing nothing this eval: its allocs still
                # occupy the node for distinct_hosts (the sequential
                # DistinctHostsIterator counts ALL proposed job
                # allocs, feasible.go:470)
                occ_extra[row] += 1
        sim.base_collisions = coll
        # ship the extra occupancy ONLY when a job-level
        # distinct_hosts will read it: ordinary multi-TG scale-ups
        # must not stage an input the kernel would ignore
        job_level_dh = any(
            c.operand == CONSTRAINT_DISTINCT_HOSTS
            for c in job.constraints
        )
        sim.occ_extra = (
            occ_extra
            if job_level_dh and occ_extra.any()
            else None
        )

        for missing in placements:
            p_tg = missing.task_group
            prev = missing.previous_alloc
            if prev is not None and p_tg.ephemeral_disk.sticky:
                return None  # preferred-node path

            stop_prev, _desc = missing.stop_previous_alloc()
            e_row, e_res, e_coll = -1, (0.0, 0.0, 0.0), 0
            if stop_prev and prev is not None and (
                prev.id not in evicted_ids
            ):
                evicted_ids.add(prev.id)
                orig = snap.alloc_by_id(prev.id)
                if orig is not None and not orig.terminal_status():
                    row = table.row_of.get(prev.node_id)
                    if row is not None:
                        r = orig.comparable_resources()
                        e_row = row
                        e_res = (
                            -float(r.cpu),
                            -float(r.memory_mb),
                            -float(r.disk_mb),
                        )
                        if (
                            prev.job_id == job.id
                            and prev.task_group == p_tg.name
                        ):
                            e_coll = -1
            sim.evict_rows.append(e_row)
            sim.evict_res.append(e_res)
            sim.evict_coll.append(e_coll)

            pen = set()
            if prev is not None:
                if prev.client_status == ALLOC_CLIENT_STATUS_FAILED:
                    pen.add(prev.node_id)
                if prev.reschedule_tracker is not None:
                    for event in prev.reschedule_tracker.events:
                        pen.add(event.prev_node_id)
            if len(pen) > MAX_PENALTY_NODES:
                return None
            sim.penalties.append(frozenset(pen))

        if len(placements) > 64:
            return None  # over the largest supported pick bucket
        sim.placements = len(placements)

        # static-port bookkeeping for the kernel's collision mask:
        # asked ports per group slot, and ports this eval's staged
        # stops/evictions would free (gated in _flush_run — the
        # kernel's occupancy carry is monotone)
        for g in sim.tgs:
            ports = set()
            # mirror the binpack ask EXACTLY: only tg.networks[0] and
            # each task's networks[0] are ever assigned (rank.py
            # group/task network paths); extra declared networks are
            # ignored by the sequential scheduler and must not
            # over-constrain the kernel mask
            asks = []
            if g.networks:
                asks.append(g.networks[0])
            for t in g.tasks:
                if t.resources.networks:
                    asks.append(t.resources.networks[0])
            for nw in asks:
                for p in nw.reserved_ports:
                    if p.value:
                        ports.add(p.value)
            sim.asked_ports.append(frozenset(ports))
            # device asks: matched-code sets per request (constraint
            # filtering included), counts pooled per set
            dev_asks: Dict[FrozenSet[int], int] = {}
            reqs = [
                req for t in g.tasks for req in t.resources.devices
            ]
            if reqs:
                for req in reqs:
                    codes = self._device_request_codes(table, req)
                    dev_asks[codes] = dev_asks.get(codes, 0) + int(
                        req.count
                    )
            sim.asked_devices.append(dev_asks)
        released = set()
        released_dev = set()
        for aid in evicted_ids:
            orig = snap.alloc_by_id(aid)
            if (
                orig is None
                or orig.terminal_status()
                or orig.allocated_resources is None
            ):
                continue
            for p in orig.allocated_resources.shared.ports:
                if p.value:
                    released.add(p.value)
            for tr in orig.allocated_resources.tasks.values():
                for net in tr.networks:
                    for p in net.reserved_ports:
                        if p.value:
                            released.add(p.value)
                for dv in tr.devices:
                    released_dev.add(
                        (dv.vendor, dv.type, dv.name)
                    )
        sim.released_ports = frozenset(released)
        sim.released_device_keys = frozenset(released_dev)
        # the stateful ctx rng has now consumed exactly the draws the
        # sequential path would have (one per in-place probe's
        # set_nodes); the next draw is the placement shuffle
        nodes, _by_dc = ready_nodes_in_dcs(snap, job.datacenters)
        sim.order = shuffle_permutation(ctx.rng, len(nodes))
        return sim

    # ------------------------------------------------------------------

    def _inert_inputs(self, table, P: int = 16,
                      T: int = 1) -> ChainInputs:
        """A single inert eval in the stacked layout (E axis absent):
        wanted=0 makes every pick step a no-op, so the chained carry
        passes through unchanged.  Used by warm_shapes; production
        padding rows are built directly in _prescore."""
        C = table.capacity
        return ChainInputs(
            feasible=np.zeros((T, C), dtype=bool),
            perm=np.arange(C, dtype=np.int32),
            ask_cpu=np.zeros(P),
            ask_mem=np.zeros(P),
            ask_disk=np.zeros(P),
            desired_count=np.ones(P, np.int32),
            limit=np.ones(P, np.int32),
            distinct_hosts=np.bool_(False),
            tg_idx=np.zeros(P, np.int32),
        )

    def warm_shapes(
        self, e_buckets=None, p_buckets=(16,),
        t_buckets=(1, 2),
    ) -> None:
        """Get the first production batches off the build and upload
        path (the bench and server startup call this outside any timed
        region): on the card, build or load the K3 and K4 libraries,
        sync the device usage mirror, and launch each chunk bucket once
        with inert evals (wanted=0).  The kernels are built by nvcc
        ahead of time and compile nothing per shape, so one launch per
        (width, picks, groups) bucket is all a warm-up needs.  The
        default eval-axis buckets are the live chunk-width ladder
        (``_chunk_buckets``)."""
        self._load_kernels()
        table = self.store.node_table
        dev_cols = self._device_columns(table)
        if e_buckets is None:
            e_buckets = self._chunk_buckets()
        for e in e_buckets:
            for p in p_buckets:
                for t in t_buckets:
                    inert = self._inert_inputs(
                        table, P=int(p), T=int(t)
                    )
                    stacked = ChainInputs(
                        *[
                            np.stack([getattr(inert, f)] * e)
                            for f in ChainInputs._fields
                        ]
                    )
                    with self._on_stream():
                        chained_plan_picks_cols(
                            *dev_cols, stacked,
                            np.full(e, 1, np.int32), int(p),
                            wanted=np.zeros(e, np.int32),
                            deltas=self._zero_deltas(e, p),
                            pre=self._zero_pre(e),
                            return_carry=True,
                        )
        if self.stream is not None:
            self.stream.synchronize()

    @staticmethod
    def _zero_deltas(E: int, P: int) -> StepDeltas:
        return StepDeltas(
            evict_rows=np.full((E, P), -1, np.int32),
            evict_cpu=np.zeros((E, P)),
            evict_mem=np.zeros((E, P)),
            evict_disk=np.zeros((E, P)),
            evict_coll=np.zeros((E, P), np.int32),
            penalty_rows=np.full(
                (E, P, MAX_PENALTY_NODES), -1, np.int32
            ),
        )

    @staticmethod
    def _zero_pre(E: int, R: int = 1) -> PreDeltas:
        return PreDeltas(
            rows=np.zeros((E, R), np.int32),
            cpu=np.zeros((E, R)),
            mem=np.zeros((E, R)),
            disk=np.zeros((E, R)),
        )

    # -- host-assembly caches ------------------------------------------

    def _candidates(self, snap, datacenters) -> tuple:
        """(nodes, rows, rest) for a datacenter set, cached per node-
        topology generation — usage-only changes (every plan commit)
        keep the cache warm."""
        table = snap.node_table
        gen = table.topo_generation
        key = (gen, tuple(datacenters))
        hit = self._cand_cache.get(key)
        if hit is not None:
            return hit
        nodes, _by_dc = ready_nodes_in_dcs(snap, datacenters)
        rows = np.asarray(
            [table.row_of[n.id] for n in nodes], dtype=np.int32
        )
        present = np.zeros(table.capacity, dtype=bool)
        present[rows] = True
        rest = np.nonzero(~present)[0].astype(np.int32)
        out = (nodes, rows, rest)
        self._cand_cache.put(key, out)
        return out

    def _stage_walk_order(self, snap, job, sim):
        """The per-eval walk-order staging of the chunk assembler
        (`_assemble`): candidate layout, the recorded serial shuffle
        when rng-aligned (seed-keyed fallback otherwise), the
        arena-order perm, and the replay passthrough mirror.
        Returns ``(rows, rest, n_cand, order, perm)``."""
        nodes, rows, rest = self._candidates(
            snap, job.datacenters
        )
        n_cand = len(nodes)
        rng_aligned = (
            sim.order is not None and len(sim.order) == n_cand
        )
        if rng_aligned:
            order = sim.order
        else:
            order = shuffle_permutation(
                random.Random(self.seed), n_cand
            )
        perm = np.concatenate([rows[order], rest])
        # passthrough needs the rng-aligned order (the one the
        # sequential shuffle would produce); a fallback shuffle
        # keeps prescoring valid but gates preempt retries
        sim.replay_order = order if rng_aligned else None
        sim.replay_n_cand = n_cand
        return rows, rest, n_cand, order, perm

    @staticmethod
    def _job_signature(job: Job, tg: TaskGroup) -> tuple:
        cons = tuple(
            (c.ltarget, c.operand, c.rtarget)
            for c in list(job.constraints)
            + list(tg.constraints)
            + [c for t in tg.tasks for c in t.constraints]
        )
        affs = tuple(
            (a.ltarget, a.operand, a.rtarget, a.weight)
            for a in list(job.affinities)
            + list(tg.affinities)
            + [a for t in tg.tasks for a in t.affinities]
        )
        drivers = tuple(sorted({t.driver for t in tg.tasks}))
        return (cons, affs, drivers, tuple(job.datacenters))

    def _static_vectors(
        self, snap, job: Job, tg: TaskGroup, rows: np.ndarray
    ) -> tuple:
        """(feasible bool[C], affinity f[C]) for a job spec, cached per
        (topology generation, job signature)."""
        table = snap.node_table
        gen = table.topo_generation
        key = (gen,) + self._job_signature(job, tg)
        hit = self._mask_cache.get(key)
        if hit is not None:
            return hit
        # bounded LRU: one (bool[C], f64[C]) pair per distinct job
        # spec, capped so thousands of one-off specs on a long-lived
        # stable topology can't accumulate hundreds of MB
        compiler = MaskCompiler(table)
        feasible = np.zeros(table.capacity, dtype=bool)
        feasible[rows] = True
        feasible &= table.active & table.eligible
        for constraint in list(job.constraints) + list(
            tg.constraints
        ) + [c for t in tg.tasks for c in t.constraints]:
            m = compiler.constraint_mask(constraint)
            if m is not None:
                feasible &= m
        for task in tg.tasks:
            col = table.column(f"driver.{task.driver}")
            feasible = feasible & (col.codes != -1)
        affinities = (
            list(job.affinities)
            + list(tg.affinities)
            + [a for t in tg.tasks for a in t.affinities]
        )
        total, sum_w = compiler.affinity_score_vector(affinities)
        aff_vec = (
            total / sum_w if sum_w else np.zeros(table.capacity)
        )
        out = (feasible, aff_vec)
        self._mask_cache.put(key, out)
        return out

    def _device_affinity_column(
        self, table, compiler, tg
    ) -> Tuple[Optional[np.ndarray], bool]:
        """Static per-node device-affinity score for a task group's
        device asks (reference rank.go:443-461: per req the allocator
        returns the chosen group's matched affinity weights; the node
        score appends sum(matched)/sum(|weights|)).

        Exactness rests on the _flush_run chain gates: admitted
        batches guarantee each node carries at most ONE group matching
        any ask signature, so the "best group" choice is degenerate
        and the score is independent of instance consumption — nodes
        whose unique group runs out of instances become infeasible via
        the DeviceInputs mask, never mis-scored."""
        reqs = [
            req
            for t in tg.tasks
            for req in t.resources.devices
            if req.affinities
        ]
        if not reqs:
            return None, False
        # static per (device inventory, group ask): cached like the
        # sibling _dev_codes_cache — the hot _prescore loop must not
        # re-walk device_groups x affinities per eval per flush
        ask_sig = tuple(
            (
                req.name,
                tuple(
                    (c.ltarget, c.operand, c.rtarget)
                    for c in req.constraints
                ),
                tuple(
                    (a.ltarget, a.operand, a.rtarget, a.weight)
                    for a in req.affinities
                ),
            )
            for req in reqs
        )
        cache_key = (table.topo_generation, ask_sig)
        hit = self._dev_aff_cache.get(cache_key)
        if hit is not None:
            return hit
        from ..sched.device import matched_affinity_weight
        from ..structs import NodeDeviceResource

        total_w = 0.0
        col = np.zeros(table.capacity)
        for req in reqs:
            total_w += sum(
                abs(float(a.weight)) for a in req.affinities
            )
            codes = self._device_request_codes(table, req)
            if not codes:
                continue
            matched: Dict[int, float] = {}
            for code in codes:
                sig = table._device_sig_meta[code]
                group = NodeDeviceResource(
                    vendor=sig[0], type=sig[1], name=sig[2],
                    attributes=dict(sig[3]),
                )
                _tw, s = matched_affinity_weight(
                    group, req.affinities,
                    compiler.regex_cache, compiler.version_cache,
                )
                matched[code] = s
            for row, groups in table.device_groups.items():
                for code, _cnt in groups:
                    if code in codes:
                        col[row] += matched[code]
                        break
        out = (
            (col / total_w, True) if total_w else (None, False)
        )
        self._dev_aff_cache.put(cache_key, out)
        return out

    def _device_request_codes(self, table, req) -> FrozenSet[int]:
        """Matched device-sig codes for a request (name + constraint
        filtering), cached by the sig interner's length — it is
        append-only, so a grown interner only ever ADDS candidate
        codes (avoids an O(sigs) scan per request per eval)."""
        cons_sig = tuple(
            (c.ltarget, c.operand, c.rtarget)
            for c in req.constraints
        )
        key = (len(table.device_sigs), req.name, cons_sig)
        hit = self._dev_codes_cache.get(key)
        if hit is not None:
            return hit
        compiler = MaskCompiler(table)
        codes = frozenset(
            code
            for code in range(len(table.device_sigs))
            if table.device_sig_matches(code, req.name)
            and compiler._device_sig_meets_constraints(code, req)
        )
        self._dev_codes_cache.put(key, codes)
        return codes

    def _node_reserved_port_column(self, snap, port: int) -> np.ndarray:
        """bool[C]: nodes whose OWN reservations hold `port` (node
        networks' reserved_ports + reserved_resources.reserved_ports —
        the node half of NetworkIndex.set_node).  Cached per topology
        generation; alloc churn never touches node reservations."""
        table = snap.node_table
        gen = table.topo_generation
        key = (gen, port)
        hit = self._port_col_cache.get(key)
        if hit is not None:
            return hit
        col = np.zeros(table.capacity, dtype=bool)
        for node_id, row in table.row_of.items():
            node = snap.node_by_id(node_id)
            if node is None:
                continue
            if port in node.reserved_resources.reserved_ports:
                col[row] = True
                continue
            # NetworkIndex reserves each net's ports under that net's
            # OWN ip, but assign_ports only consults the DEFAULT ip
            # (node_ips[0] — the first network's) — a secondary
            # network's reservation never collides in the sequential
            # path, so it must not collide here either
            nets = node.node_resources.networks
            default_ip = (
                (nets[0].ip or "0.0.0.0") if nets else "0.0.0.0"
            )
            for net in nets:
                if (net.ip or "0.0.0.0") != default_ip:
                    continue
                if any(p.value == port for p in net.reserved_ports):
                    col[row] = True
                    break
        self._port_col_cache.put(key, col)
        return col

    # -- snapshot-delta input cache ------------------------------------

    def _on_stream(self):
        """Context that puts device work on the worker's stream (a
        no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a tensor of its own on the worker's device.
        Bound for the card it goes through pinned memory from
        PyTorch's caching host allocator, which hands a block out
        again only after the copy that reads it has completed, so a
        staging buffer is never rewritten under an in-flight copy.  On
        the CPU it is copied: the store's columns keep changing."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.stream is None:
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _device_columns(self, table, sharded: bool = False) -> tuple:
        """The six shared node columns (cpu/mem/disk totals + used) as
        tensors on the worker's device — the persistent padded arena
        the pipelined prescore launches read instead of re-shipping
        all C rows per flush.  Totals re-upload only on topology
        changes; usage columns are patched in place through kernel K4
        from the store's dirty-row log (store.usage_delta_since):
        between consecutive flushes only the rows the interleaved plan
        commits touched are scattered in.  Patching SETs the current
        host values (never accumulated deltas), so the mirror is
        bit-identical to a fresh upload.  The patch runs on the
        worker's stream behind every launch already enqueued, so no
        launch reads a row it did not expect.  Hit rate is exported as
        the ``batch_worker.input_cache_hit_rate`` gauge.

        ``sharded=True`` returns the sharded twin: the same columns as
        `Sharded` tensors on the node mesh, patched per shard through
        K13 (`ops.batch.patch_rows_sharded`), so a warm mesh flush ships
        O(dirty rows) bytes; those bytes are the ``mesh.bytes_per_flush``
        gauge and the delta-hit rate ``mesh.mirror_hit_rate``."""
        with self._usage_cache_lock, self._on_stream():
            if sharded:
                return self._device_columns_sharded(table)
            return self._device_columns_locked(table)

    def _device_columns_sharded(self, table) -> tuple:
        """The sharded usage mirror (see ``_device_columns``): keyed as
        the plain one plus the mesh width, so the first sync after a
        supervisor incident (a new epoch) or a rebuilt mesh re-uploads
        it in full.  Uploads go through the worker's pinned staging,
        each process's own rows only (`parallel.mesh.mesh_put`).

        Over several processes every byte figure is this host's: a full
        or bulk sync uploads its n_local / n_dev of the columns, and a
        delta builds the shard-local [D, w] staging from the shared dirty
        log (`hostlocal_staging`), ships only its own shards' rows (the
        index staging once for all three columns) and stores them with
        one K15 launch a column; a pod head streams each sync to its
        peers first."""
        from ..ops.batch import (
            hostlocal_staging,
            patch_rows_hostlocal,
            patch_rows_sharded,
        )
        from ..parallel.mesh import mesh_put

        mesh = self._live_mesh()
        key = (
            self._backend_epoch, table.epoch, table.topo_generation,
            table.capacity, "sharded", mesh.n_shards,
        )
        multihost = self._mesh_hosts > 1
        pod = self._pod if multihost else None
        n_dev = mesh.n_shards
        local = list(mesh.local_shards)
        n_local = len(local)

        def put(col):
            return mesh_put(mesh, col, self._upload)

        def per_host(nbytes: int) -> int:
            return nbytes * n_local // n_dev if multihost else nbytes

        cache = self._usage_cache_sharded
        hit = False
        bytes_up = 0
        host_used = (table.cpu_used, table.mem_used, table.disk_used)
        if cache is None or cache["key"] != key:
            # topology changed, a new epoch or a new mesh: full resync
            gen, _rows = self.store.usage_delta_since(-1)
            host_cols = (
                table.cpu_total, table.mem_total, table.disk_total,
            ) + host_used
            if pod is not None:
                # the peers rebuild their shards from the same columns
                # before any launch can read them (FIFO)
                pod.send("mirror_full", host_cols)
            cols = tuple(put(col) for col in host_cols)
            bytes_up = per_host(sum(col.nbytes for col in host_cols))
            cache = {"key": key, "gen": gen, "cols": cols}
            self._usage_cache_sharded = cache
        else:
            gen, rows = self.store.usage_delta_since(cache["gen"])
            cols = cache["cols"]
            if len(rows) > max(64, table.capacity // 8):
                # wide churn: one bulk upload beats many scatters
                if pod is not None:
                    pod.send("mirror_bulk", host_used)
                cols = cols[:3] + tuple(put(col) for col in host_used)
                bytes_up = per_host(sum(col.nbytes for col in host_used))
            elif rows and multihost:
                idx = np.asarray(sorted(rows), dtype=np.int32)
                if pod is not None:
                    # the sorted dirty rows and their three value columns
                    # once: each peer gathers its own shards' rows
                    pod.send("mirror_delta", idx,
                             tuple(src[idx] for src in host_used),
                             table.capacity)
                idx_stack, per_dev, width = hostlocal_staging(
                    mesh, idx, table.capacity)
                # this host's staging rows only; the index staging ships
                # once for all three value columns
                idx_dev = self._upload(idx_stack[local])
                bytes_up += n_local * width * 4
                for col, src in zip(cols[3:], host_used):
                    vals = np.zeros((n_local, width), dtype=src.dtype)
                    for i, d in enumerate(local):
                        sel = per_dev[d]
                        vals[i, :len(sel)] = src[sel]
                    bytes_up += vals.nbytes
                    patch_rows_hostlocal(mesh, col, idx_dev,
                                         self._upload(vals))
                hit = True
            elif rows:
                idx = np.asarray(sorted(rows), dtype=np.int32)
                # one replicated staging for every shard, padded to a
                # pow2 bucket; padding indexes C (dropped on every shard)
                width = _pow2(len(idx), floor=8)
                idx_p = np.full(width, table.capacity, np.int32)
                idx_p[: len(idx)] = idx
                idx_dev = self._upload(idx_p)
                bytes_up += idx_p.nbytes
                for col, src in zip(cols[3:], host_used):
                    vals = np.zeros(width, dtype=src.dtype)
                    vals[: len(idx)] = src[idx]
                    bytes_up += vals.nbytes
                    patch_rows_sharded(mesh, col, idx_dev,
                                       self._upload(vals))
                hit = True
            else:
                hit = True  # nothing changed since the last sync
            cache["cols"] = cols
            cache["gen"] = gen
        if hit:
            self._mesh_mirror_hits += 1
        else:
            self._mesh_mirror_misses += 1
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.set_gauge("mesh.bytes_per_flush", float(bytes_up))
            total = self._mesh_mirror_hits + self._mesh_mirror_misses
            metrics.set_gauge(
                "mesh.mirror_hit_rate",
                self._mesh_mirror_hits / total if total else 0.0,
            )
        return cache["cols"]

    def _device_columns_locked(self, table) -> tuple:
        # table.epoch: a snapshot restore swaps in a FRESH NodeTable
        # whose restarted generations could collide with the cached
        # key and leave pre-restore usage on device permanently
        # _backend_epoch: a supervisor incident flushes the mirror, and
        # a sync still in flight from before it must not republish
        key = (
            self._backend_epoch, table.epoch, table.topo_generation,
            table.capacity,
        )
        cache = self._usage_cache
        hit = False
        bytes_up = 0
        if cache is None or cache["key"] != key:
            # topology changed (join/leave/re-fingerprint/arena
            # growth): rows may have been reassigned — full resync
            gen, _rows = self.store.usage_delta_since(-1)
            host_cols = (
                table.cpu_total,
                table.mem_total,
                table.disk_total,
                table.cpu_used,
                table.mem_used,
                table.disk_used,
            )
            cols = tuple(self._upload(col) for col in host_cols)
            bytes_up = sum(col.nbytes for col in host_cols)
            cache = {"key": key, "gen": gen, "cols": cols}
            self._usage_cache = cache
        else:
            gen, rows = self.store.usage_delta_since(cache["gen"])
            cols = cache["cols"]
            host_used = (table.cpu_used, table.mem_used, table.disk_used)
            if len(rows) > max(64, table.capacity // 8):
                # wide churn: one bulk upload beats many scatters
                cols = cols[:3] + tuple(
                    self._upload(col) for col in host_used
                )
                bytes_up = sum(col.nbytes for col in host_used)
            elif rows:
                idx = np.asarray(sorted(rows), dtype=np.int32)
                # pad the row axis to a pow2 bucket; padding indexes C
                # (out of range -> dropped by the patch)
                width = _pow2(len(idx), floor=8)
                idx_p = np.full(width, table.capacity, np.int32)
                idx_p[: len(idx)] = idx
                idx_dev = self._upload(idx_p)
                bytes_up += idx_p.nbytes
                for col, src in zip(cols[3:], host_used):
                    vals = np.zeros(width, dtype=src.dtype)
                    vals[: len(idx)] = src[idx]
                    bytes_up += vals.nbytes
                    patch_rows(col, idx_dev, self._upload(vals))
                hit = True
            else:
                hit = True  # nothing changed since the last sync
            cache["cols"] = cols
            cache["gen"] = gen
        if hit:
            self._input_cache_hits += 1
        else:
            self._input_cache_misses += 1
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            total = self._input_cache_hits + self._input_cache_misses
            metrics.set_gauge(
                "batch_worker.input_cache_hit_rate",
                self._input_cache_hits / total if total else 0.0,
            )
            metrics.set_gauge(
                "batch_worker.mirror_sync_bytes", float(bytes_up)
            )
        return cache["cols"]

    # ------------------------------------------------------------------

    def _assemble(
        self, snap, prescorable, sims: List[_Sim],
        chunk: int = PIPELINE_CHUNK,
        shared_cols: Optional[tuple] = None,
        mesh: Optional[bool] = None,
    ) -> _Assembled:
        """Stage 1 of the prescore pipeline: pure host-side numpy input
        staging for one admitted chain (no device work).  The result is
        launched chunk-by-chunk by ``_launch_chunk`` and fetched
        lazily, so device execution overlaps the host's replay of
        earlier chunks.

        ``chunk`` aligns the eval axis (one launch = one chunk-wide
        slice).  A mid-chain admission arena passes the chain head's
        device mirror as ``shared_cols`` instead of syncing it
        again, and ``mesh`` pins the head's backend path: None lets
        the arena take the sharded path whenever its shapes qualify,
        False forces K3, True allows the sharded path only (the caller
        defers an arena whose ``use_mesh`` comes back False)."""
        table = snap.node_table
        C = table.capacity
        compiler = MaskCompiler(table)

        # per-eval assembly in group-routed form: feasibility/affinity/
        # collision bases per group slot [T, C], asks/limits per pick
        per_eval: List[dict] = []
        n_cands: List[int] = []
        # per eval: list of (codes, desired, used0, weight_frac) or None
        spread_per_eval: List[Optional[list]] = []
        max_picks = 1
        max_tgs = 1
        for (ev, _token, job), sim in zip(prescorable, sims):
            rows, rest, n_cand, order, perm = (
                self._stage_walk_order(snap, job, sim)
            )
            tgs = sim.tgs or [job.task_groups[0]]
            tg = tgs[0]
            max_tgs = max(max_tgs, len(tgs))
            feas_t = []
            aff_t = []
            has_aff_t = []
            dev_aff_t = []
            dev_aff_on_t = []
            for g in tgs:
                feasible_g, aff_vec_g = self._static_vectors(
                    snap, job, g, rows
                )
                feas_t.append(feasible_g)
                aff_t.append(aff_vec_g)
                daff_col, daff_on = self._device_affinity_column(
                    table, compiler, g
                )
                dev_aff_t.append(daff_col)
                dev_aff_on_t.append(daff_on)
                has_aff_t.append(
                    bool(
                        list(job.affinities)
                        or list(g.affinities)
                        or any(t.affinities for t in g.tasks)
                    )
                )
            has_aff_any = any(has_aff_t)

            # percent-target spreads -> in-kernel carry inputs.  The
            # info map is attribute-keyed (shared compute_spread_info,
            # spread.go:232): when job- and group-level stanzas share
            # an attribute, every pset scores with the overwrite
            # winner's desired/weight — exactly like SpreadIterator.
            # kernel stanzas per (group slot, pset), group-scoped
            # like the sequential SpreadIterator: each placing group
            # gets its OWN slots for the job-level stanzas plus its
            # group-level ones, with per-group desired counts
            # (percent x THAT group's count) and per-group weight
            # normalization (spread.py _compute_spread_info)
            eval_spreads = None
            for g_i, g in enumerate(tgs):
                g_spreads = list(g.spreads) + list(job.spreads)
                if not g_spreads:
                    continue
                from ..sched.spread import compute_spread_info

                info, spread_sum_w = compute_spread_info(
                    g_spreads, g.count
                )
                spread_sum_w = spread_sum_w or 1
                if eval_spreads is None:
                    eval_spreads = []
                # job-level first, then group-level (spread.py
                # set_task_group ordering)
                for sp in list(job.spreads) + list(g.spreads):
                    attr_info = info[sp.attribute]
                    # mode follows the MERGED per-attribute info like
                    # the sequential SpreadIterator ("if not
                    # desired_counts"): duplicate attributes with
                    # mixed target presence score in the overwrite
                    # winner's mode on BOTH paths
                    even = not attr_info["desired_counts"]
                    key = (g.name, sp.attribute)
                    codes, desired, used0, prop0, cleared0 = (
                        compiler.spread_kernel_inputs(
                            sp.attribute,
                            None
                            if even
                            else attr_info["desired_counts"],
                            sim.spread_existing.get(key, {}),
                            sim.spread_cleared.get(key, {}),
                            sim.spread_proposed.get(key, {}),
                        )
                    )
                    eval_spreads.append(
                        (codes, desired, used0, prop0, cleared0,
                         # even boosts are UNWEIGHTED (spread.py adds
                         # even_spread_score_boost without the weight
                         # fraction)
                         0.0
                         if even
                         else float(attr_info["weight"])
                         / float(spread_sum_w),
                         even,
                         g_i)
                    )
            spread_per_eval.append(eval_spreads)

            # distinct_hosts scopes (feasible.py _satisfies): JOB-
            # level blocks on any job alloc; GROUP-level only on the
            # picking group's own.  Single-group jobs merge (group ==
            # job there, and it keeps the historical trace shape);
            # multi-group jobs split into the job-wide scalar and a
            # per-group dh_tg vector
            job_dh = any(
                c.operand == CONSTRAINT_DISTINCT_HOSTS
                for c in job.constraints
            )
            tg_dh = [
                any(
                    c.operand == CONSTRAINT_DISTINCT_HOSTS
                    for c in g.constraints
                )
                for g in tgs
            ]
            if len(tgs) == 1:
                distinct_hosts = job_dh or tg_dh[0]
                dh_tg_vec = None
            else:
                distinct_hosts = job_dh
                # job-wide blocking subsumes group-level
                dh_tg_vec = (
                    np.asarray(tg_dh, dtype=bool)
                    if any(tg_dh) and not job_dh
                    else None
                )
            base_limit = compute_visit_limit(
                n_cand, ev.type == "batch"
            )
            # per-group visit limits: affinities (or spreads) lift the
            # walk cap for that group's selects (stack.py limit rules)
            # per-group limit lift (stack.py select: affinities or
            # spreads disable the log2 visit cap); job-level spreads
            # lift EVERY group's limit, group-level only their own
            limits_t = [
                2**31 - 1
                if has_aff_t[s_i]
                or list(job.spreads)
                or list(tgs[s_i].spreads)
                else base_limit
                for s_i in range(len(tgs))
            ]

            max_picks = max(max_picks, sim.placements)
            n_cands.append(n_cand)
            pick_tg = sim.pick_tg or [0] * sim.placements
            per_eval.append(
                dict(
                    feasible=np.stack(feas_t),  # [T, C]
                    affinity=(
                        np.stack(aff_t) if has_aff_any else None
                    ),
                    dev_aff=(
                        np.stack(
                            [
                                c
                                if c is not None
                                else np.zeros(C)
                                for c in dev_aff_t
                            ]
                        )
                        if any(dev_aff_on_t)
                        else None
                    ),
                    dev_aff_on=list(dev_aff_on_t),
                    occ0=sim.occ_extra,
                    dh_tg=dh_tg_vec,
                    coll0=(
                        sim.base_collisions
                        if sim.base_collisions is not None
                        and sim.base_collisions.any()
                        else None
                    ),
                    perm=perm,
                    pick_tg=pick_tg,
                    ask_cpu=[
                        float(
                            sum(
                                t.resources.cpu
                                for t in tgs[s].tasks
                            )
                        )
                        for s in pick_tg
                    ],
                    ask_mem=[
                        float(
                            sum(
                                t.resources.memory_mb
                                for t in tgs[s].tasks
                            )
                        )
                        for s in pick_tg
                    ],
                    ask_disk=[
                        float(tgs[s].ephemeral_disk.size_mb)
                        for s in pick_tg
                    ],
                    desired_count=[
                        int(tgs[s].count) for s in pick_tg
                    ],
                    limit=[int(limits_t[s]) for s in pick_tg],
                    distinct_hosts=bool(distinct_hosts),
                )
            )

        # bucket the launch shapes: the pick, eval and group axes pad
        # to fixed buckets, and deltas/pre ship always (zero-filled
        # when absent); coll0/affinity/spread stay optional, and spread
        # batches bucket their (S, V1) axes to powers of two below
        E_real = len(per_eval)
        # the eval axis pads to the next multiple of the flush's chunk
        # width: every launch is a chunk-wide slice of this arena, so
        # the device sees ONE compiled program per (width, pick)
        # bucket regardless of run length (padding waste < one chunk
        # per run)
        E = -(-E_real // chunk) * chunk
        P = 16 if max_picks <= 16 else _pow2(max_picks)
        T = _pow2(max_tgs)
        K = MAX_PENALTY_NODES
        if E > E_real:
            n_cands.extend([1] * (E - E_real))
            spread_per_eval.extend([None] * (E - E_real))

        # stack into the kernel layout, padding the T and P axes
        def _pad_picks(vals, fill, dtype):
            out = np.full((E, P), fill, dtype)
            for k, e in enumerate(per_eval):
                v = vals(e)
                out[k, : len(v)] = v
            return out

        feasible_s = np.zeros((E, T, C), dtype=bool)
        for k, e in enumerate(per_eval):
            feasible_s[k, : e["feasible"].shape[0]] = e["feasible"]
        perm_s = np.tile(
            np.arange(C, dtype=np.int32), (E, 1)
        )
        for k, e in enumerate(per_eval):
            perm_s[k] = e["perm"]
        stacked = ChainInputs(
            feasible=feasible_s,
            perm=perm_s,
            ask_cpu=_pad_picks(lambda e: e["ask_cpu"], 0.0, float),
            ask_mem=_pad_picks(lambda e: e["ask_mem"], 0.0, float),
            ask_disk=_pad_picks(lambda e: e["ask_disk"], 0.0, float),
            desired_count=_pad_picks(
                lambda e: e["desired_count"], 1, np.int32
            ),
            limit=_pad_picks(lambda e: e["limit"], 1, np.int32),
            distinct_hosts=np.array(
                [e["distinct_hosts"] for e in per_eval]
                + [False] * (E - E_real),
                dtype=bool,
            ),
            tg_idx=_pad_picks(lambda e: e["pick_tg"], 0, np.int32),
        )
        coll0 = None
        if any(e["coll0"] is not None for e in per_eval):
            coll0 = np.zeros((E, T, C), np.int32)
            for k, e in enumerate(per_eval):
                if e["coll0"] is not None:
                    coll0[k, : e["coll0"].shape[0]] = e["coll0"]
        affinity = None
        if any(e["affinity"] is not None for e in per_eval):
            affinity = np.zeros((E, T, C))
            for k, e in enumerate(per_eval):
                if e["affinity"] is not None:
                    affinity[k, : e["affinity"].shape[0]] = (
                        e["affinity"]
                    )
        occ0 = None
        if any(e["occ0"] is not None for e in per_eval):
            occ0 = np.zeros((E, C), np.int32)
            for k, e in enumerate(per_eval):
                if e["occ0"] is not None:
                    occ0[k] = e["occ0"]
        dh_tg = None
        if any(e["dh_tg"] is not None for e in per_eval):
            dh_tg = np.zeros((E, T), dtype=bool)
            for k, e in enumerate(per_eval):
                if e["dh_tg"] is not None:
                    dh_tg[k, : len(e["dh_tg"])] = e["dh_tg"]
        dev_aff = None
        dev_aff_on = None
        if any(e["dev_aff"] is not None for e in per_eval):
            dev_aff = np.zeros((E, T, C))
            dev_aff_on = np.zeros((E, T), dtype=bool)
            for k, e in enumerate(per_eval):
                if e["dev_aff"] is not None:
                    dev_aff[k, : e["dev_aff"].shape[0]] = e["dev_aff"]
                dev_aff_on[k, : len(e["dev_aff_on"])] = e[
                    "dev_aff_on"
                ]

        # static-port collision inputs: slot axis Q enumerates the
        # distinct asked ports across the batch; occupancy at the
        # snapshot comes from the store's live-port index plus node-
        # level reservations (ops/batch.py PortInputs)
        all_ports = sorted(
            {p for s in sims for fs in s.asked_ports for p in fs}
        )
        port_ask_arr = None
        port_used0 = None
        if all_ports:
            Q = _pow2(len(all_ports), floor=2)
            slot = {p: q for q, p in enumerate(all_ports)}
            port_ask_arr = np.zeros((E, T, Q), dtype=bool)
            for k, s in enumerate(sims):
                for t_i, fs in enumerate(s.asked_ports):
                    for p in fs:
                        port_ask_arr[k, t_i, slot[p]] = True
            port_used0 = np.zeros((Q, C), dtype=bool)
            for p, q in slot.items():
                for node_id, cnt in snap.live_port_nodes(
                    p
                ).items():
                    if cnt > 0:
                        row = table.row_of.get(node_id)
                        if row is not None:
                            port_used0[q, row] = True
                port_used0[q] |= self._node_reserved_port_column(
                    snap, p
                )

        # device-capacity inputs: slot axis D enumerates the batch's
        # distinct matched-code sets (identical-or-disjoint per the
        # _flush_run gate); free counts = group totals minus live
        # reservations (ops/batch.py DeviceInputs)
        all_dev_sets = sorted(
            {
                cs
                for s in sims
                for d in s.asked_devices
                for cs in d
            },
            key=sorted,
        )
        dev_ask_arr = None
        dev_free0 = None
        if all_dev_sets:
            D = _pow2(len(all_dev_sets), floor=1)
            dslot = {cs: di for di, cs in enumerate(all_dev_sets)}
            dev_ask_arr = np.zeros((E, T, D), np.int32)
            for k, s in enumerate(sims):
                for t_i, asks in enumerate(s.asked_devices):
                    for cs, count in asks.items():
                        dev_ask_arr[k, t_i, dslot[cs]] = count
            dev_free0 = np.zeros((D, C), np.int32)
            for cs, di in dslot.items():
                has_cs = np.zeros(C, dtype=bool)
                for row, groups in table.device_groups.items():
                    for code, count in groups:
                        if code in cs:
                            dev_free0[di, row] += count
                            has_cs[row] = True
                # live reservations from the unified table index —
                # subtracted ONLY on rows that actually carry a cs
                # group (a key-granularity reservation on a node
                # whose group code is outside the set must not drive
                # the pool negative and poison unrelated picks)
                keys = {
                    table.device_sig_key(code) for code in cs
                }
                for (row, key), count in (
                    table.device_used.items()
                ):
                    if key in keys and has_cs[row]:
                        dev_free0[di, row] -= count

        deltas = self._zero_deltas(E, P)
        for k, sim in enumerate(sims):
            for p, row in enumerate(sim.evict_rows):
                deltas.evict_rows[k, p] = row
                (
                    deltas.evict_cpu[k, p],
                    deltas.evict_mem[k, p],
                    deltas.evict_disk[k, p],
                ) = sim.evict_res[p]
                deltas.evict_coll[k, p] = sim.evict_coll[p]
            for p, pen in enumerate(sim.penalties):
                for i, nid in enumerate(sorted(pen)):
                    deltas.penalty_rows[k, p, i] = table.row_of.get(
                        nid, -1
                    )

        R = _pow2(max((len(s.pre) for s in sims), default=1), floor=1)
        pre = self._zero_pre(E, R)
        for k, sim in enumerate(sims):
            for i, (row, acc) in enumerate(sorted(sim.pre.items())):
                pre.rows[k, i] = row
                pre.cpu[k, i], pre.mem[k, i], pre.disk[k, i] = acc

        spread_stack = None
        if any(s for s in spread_per_eval):
            S = _pow2(max(len(s or ()) for s in spread_per_eval))
            V1 = _pow2(
                max(
                    (
                        len(d)
                        for s in spread_per_eval
                        for (_c, d, _u, _p, _cl, _w, _e, _g) in (
                            s or ()
                        )
                    ),
                    default=1,
                ),
                floor=2,
            )
            s_codes = np.zeros((E, S, C), np.int32)
            s_desired = np.zeros((E, S, V1))
            s_used0 = np.zeros((E, S, V1))
            s_prop0 = np.zeros((E, S, V1))
            s_cleared0 = np.zeros((E, S, V1))
            s_weight = np.zeros((E, S))
            s_active = np.zeros((E, S), dtype=bool)
            s_even = np.zeros((E, S), dtype=bool)
            s_group = np.zeros((E, S), np.int32)
            multi_group_spread = False
            for k, s in enumerate(spread_per_eval):
                for j, (
                    c, d, u, p0, cl, w, ev_mode, g_i
                ) in enumerate(s or ()):
                    # this eval's penalty slot moves to the shared
                    # V1-1 slot under padding
                    pen = len(d) - 1
                    s_codes[k, j] = np.where(c == pen, V1 - 1, c)
                    s_desired[k, j, : pen] = d[:-1]
                    s_used0[k, j, : pen] = u[:-1]
                    s_prop0[k, j, : pen] = p0[:-1]
                    s_cleared0[k, j, : pen] = cl[:-1]
                    s_weight[k, j] = w
                    s_active[k, j] = True
                    s_even[k, j] = ev_mode
                    s_group[k, j] = g_i
                    if g_i:
                        multi_group_spread = True
            spread_stack = SpreadInputs(
                codes=s_codes,
                desired=s_desired,
                used0=s_used0,
                proposed0=s_prop0,
                cleared0=s_cleared0,
                weight=s_weight,
                active=s_active,
                # None keeps percent-only workloads on the cheaper
                # kernel path (the even math never traces)
                even=s_even if s_even.any() else None,
                # group routing only traces when a multi-group
                # spread eval is actually in the batch
                group=s_group if multi_group_spread else None,
            )
        spread_fit = (
            snap.scheduler_config().effective_scheduler_algorithm()
            == "spread"
        )
        wanted = np.zeros(E, np.int32)
        wanted[:E_real] = [s.placements for s in sims]
        # K12 covers the single-group scalar layout (T = 1, no port or
        # device slot axes, no per-group vectors), and the node axis
        # must tile over the mesh; other arenas take K3, as the JAX
        # package routes them.  Mid-chain admission arenas qualify
        # exactly like chain heads
        live = self._live_mesh()
        mesh_capable = (
            live is not None
            and T == 1
            and port_ask_arr is None
            and dev_ask_arr is None
            and dev_aff is None
            and occ0 is None
            and dh_tg is None
            and C % live.n_shards == 0
        )
        use_mesh = mesh_capable if mesh is None else (
            bool(mesh) and mesh_capable
        )
        return _Assembled(
            E_real=E_real,
            E=E,
            P=int(P),
            T=int(T),
            stacked=stacked,
            n_cands=np.asarray(n_cands, np.int32),
            wanted=wanted,
            spread_fit=spread_fit,
            coll0=coll0,
            affinity=affinity,
            spread=spread_stack,
            deltas=deltas,
            pre=pre,
            port_ask=port_ask_arr,
            port_used0=port_used0,
            dev_ask=dev_ask_arr,
            dev_free0=dev_free0,
            dev_aff=dev_aff,
            dev_aff_on=dev_aff_on,
            occ0=occ0,
            dh_tg=dh_tg,
            # the persistent delta-patched device mirror every launch
            # reads — the SHARDED mirror for mesh arenas (a mid-chain
            # admission arena reuses the chain head's)
            dev_cols=(
                shared_cols
                if shared_cols is not None
                else self._device_columns(table, sharded=use_mesh)
            ),
            chunk=chunk,
            use_mesh=use_mesh,
        )

    # -- launch + fetch (pipeline stages 2 and 3) ----------------------

    @staticmethod
    def _chunk_slice(x, c0: int, c1: int):
        """Slice the leading eval axis of an optional array or
        NamedTuple-of-arrays input (fields may be None, e.g.
        SpreadInputs.even)."""
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            return x[c0:c1]
        return type(x)(
            *[None if f is None else f[c0:c1] for f in x]
        )

    def _launch_chunk(self, asm: _Assembled, c0: int, c1: int, carry):
        """Stage 2: dispatch one chunk-wide slice of the run, chained
        on ``carry`` (the previous chunk's device carry-out; None =
        chain start, which reads the device usage mirror and the
        host-built occupancy arenas).  On the card this is
        NON-blocking: K3 and the copy of its rows and pulls into
        pinned host memory are enqueued on the worker's stream behind
        an event, which ``_fetch`` waits on.  Returns (rows, pulls,
        carry-out, event or None).  Mesh arenas dispatch K12's chunk
        (``_launch_chunk_mesh``) with the same handle layout."""
        if asm.use_mesh:
            return self._launch_chunk_mesh(asm, c0, c1, carry)
        sl = self._chunk_slice
        cols = asm.dev_cols
        if carry is None:
            used = cols[3:6]
            ports = asm.port_used0
            devs = asm.dev_free0
        else:
            used, ports, devs = carry
        with self._on_stream():
            rows, pulls, carry_out = chained_plan_picks_cols(
                cols[0], cols[1], cols[2], used[0], used[1], used[2],
                sl(asm.stacked, c0, c1), asm.n_cands[c0:c1], asm.P,
                spread_fit=asm.spread_fit,
                wanted=asm.wanted[c0:c1],
                coll0=sl(asm.coll0, c0, c1),
                affinity=sl(asm.affinity, c0, c1),
                spread=sl(asm.spread, c0, c1),
                deltas=sl(asm.deltas, c0, c1),
                pre=sl(asm.pre, c0, c1),
                port_ask=sl(asm.port_ask, c0, c1),
                port_used0=ports,
                dev_ask=sl(asm.dev_ask, c0, c1),
                dev_free0=devs,
                dev_aff=sl(asm.dev_aff, c0, c1),
                dev_aff_on=sl(asm.dev_aff_on, c0, c1),
                occ0=sl(asm.occ0, c0, c1),
                dh_tg=sl(asm.dh_tg, c0, c1),
                return_carry=True,
            )
            return self._fetchable(rows, pulls, carry_out)

    def _fetchable(self, rows, pulls, carry_out):
        """A launch's handle: on the card its rows and pulls copied into
        pinned host memory behind an event on the worker's stream (call
        inside ``_on_stream``); on the CPU the tensors themselves."""
        if self.stream is None:
            return rows, pulls, carry_out, None
        host = torch.empty(
            (2,) + tuple(rows.shape), dtype=torch.int32,
            pin_memory=True,
        )
        host[0].copy_(rows, non_blocking=True)
        host[1].copy_(pulls, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self.stream)
        return host[0], host[1], carry_out, done

    def _launch_chunk_mesh(self, asm: _Assembled, c0: int, c1: int, carry):
        """Stage 2, sharded: one chunk-wide slice through K12
        (`parallel.mesh.sharded_chained_plan`).  The chain start reads
        the sharded usage mirror in place; later chunks chain on the
        previous launch's sharded carry, which never leaves the device.
        Single-group arenas only (``asm.use_mesh`` gates the layout):
        the T = 1 slices are the runner's per-eval scalar layout."""
        self._live_mesh()
        cols = asm.dev_cols
        used = cols[3:6] if carry is None else carry[0]
        st = asm.stacked
        E = c1 - c0
        C = st.perm.shape[1]
        spread_arg = self._chunk_slice(asm.spread, c0, c1)
        runner = self._sharded_runner(
            asm.P, asm.spread_fit,
            with_spread=spread_arg is not None,
            spread_even=(
                spread_arg is not None and spread_arg.even is not None
            ),
        )
        args = tuple(cols[:3]) + tuple(used) + (
            st.feasible[c0:c1, 0],
            st.perm[c0:c1],
            st.ask_cpu[c0:c1, 0],
            st.ask_mem[c0:c1, 0],
            st.ask_disk[c0:c1, 0],
            st.desired_count[c0:c1, 0],
            st.limit[c0:c1, 0],
            asm.wanted[c0:c1],
            asm.n_cands[c0:c1],
            st.distinct_hosts[c0:c1],
            asm.coll0[c0:c1, 0]
            if asm.coll0 is not None
            else np.zeros((E, C), np.int32),
            asm.affinity[c0:c1, 0]
            if asm.affinity is not None
            else np.zeros((E, C)),
            self._chunk_slice(asm.deltas, c0, c1),
            self._chunk_slice(asm.pre, c0, c1),
        )
        if spread_arg is not None:
            args = args + (spread_arg,)
        pod = self._pod
        if pod is not None:
            # the peers rebuild this launch from the host arguments and
            # their own mirror or carry, which track ours message for
            # message; the send comes first, so the collectives run in
            # the stream's order on every member
            pod.send(
                "chain",
                {
                    "n_picks": asm.P,
                    "spread_fit": asm.spread_fit,
                    "with_spread": spread_arg is not None,
                    "spread_even": (
                        spread_arg is not None
                        and spread_arg.even is not None
                    ),
                    "used": "mirror" if carry is None else "carry",
                },
                args[6:],
            )
        with self._on_stream():
            rows, pulls, used_out = runner(*args)
            if pod is not None and pod.check:
                from ..parallel.pod import result_digest

                pod.check_results(result_digest(rows, pulls))
            handle = self._fetchable(rows, pulls, (used_out, None, None))
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.incr("mesh.launches")
        if c0 == 0:
            # once per arena: "mesh used" against "mesh skipped"
            self._count("mesh_used")
        return handle

    def _fetch(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Stage 3: wait for a chunk's rows and pulls — the only point
        the host blocks on the device."""
        rows, pulls, _carry, done = handle
        if done is not None:
            done.synchronize()
        return rows.numpy(), pulls.numpy()

    # ------------------------------------------------------------------

    def _prescored_scheduler(
        self, snap, planner, ev: Evaluation, job: Job,
        rows: List[int], sim: _Sim, pulls: Optional[List[int]],
        speculative: bool = False,
    ):
        """The replay scheduler: a GenericScheduler whose stack
        replays the prescored pick rows.  Shared by the serial replay
        path (planner = this worker) and the speculative wave
        (planner = a capturing _SpecPlanner pinned to the wave
        snapshot).  Returns (scheduler, made); made[0] is the
        PrescoredStack once the scheduler built it."""
        made: list = []
        pick_tgs = [
            sim.tgs[s].name for s in sim.pick_tg
        ] if sim.pick_tg else []
        batch = ev.type == "batch"
        sched = GenericScheduler(
            snap, planner, batch=batch, use_device=False,
            seed=self.seed, speculative=speculative,
        )

        def make_stack():
            if made:
                # a plan-submit retry re-runs _process_once against
                # refreshed state; the prescored rows are stale there
                raise _Deviation("scheduler retry")
            inner = GenericStack(batch, sched.ctx)
            stack = PrescoredStack(
                sched.ctx, job, pick_tgs, rows,
                snap.node_table, sim.penalties, inner,
                evict_rows=sim.evict_rows,
                pulls=pulls,
                n_cand=getattr(sim, "replay_n_cand", 0),
                order=getattr(sim, "replay_order", None),
                batch=batch,
            )
            made.append(stack)
            return stack

        sched._make_stack = make_stack
        return sched, made

    def _process_prescored(
        self, ev: Evaluation, token: str, job: Job,
        rows: List[int], sim: _Sim,
        pulls: Optional[List[int]] = None,
    ) -> bool:
        """Replay one prescored eval through the real scheduler.
        Returns False when the chained kernel state past this eval is
        suspect (a prescored pick failed)."""
        snap = self.store.snapshot_min_index(
            max(ev.modify_index, ev.snapshot_index), timeout=5.0
        )
        ev.snapshot_index = snap.index
        scheduler, made = self._prescored_scheduler(
            snap, self, ev, job, rows, sim, pulls
        )
        scheduler.process(ev)
        # record the committed plan's node touches for the optimistic
        # replay wave's expected-touch ledger ({} = no-op plan)
        result = scheduler.plan_result
        self._last_replay_touches = (
            self._plan_touches(
                result.node_update,
                result.node_allocation,
                result.node_preemptions,
            )
            if result is not None
            else {}
        )
        self.evals_processed += 1
        TRACE.annotate(ev.id, outcome="prescored")
        EXPLAIN.record_eval(
            ev, scheduler, getattr(self.server, "metrics", None)
        )
        self.server.broker.ack(ev.id, token)
        if made and made[0].entered_passthrough:
            self._count("preempt_passthroughs")
        return not (made and made[0].saw_failed_row)
