"""The control plane in one process (reference nomad/server.go +
nomad/leader.go), trimmed to what the scheduling pipeline needs.

Wires the state store, eval broker, blocked-evals tracker, plan queue,
the serialized plan applier, N scheduling workers and the node
heartbeat monitor, and exposes the write-path operations that feed the
pipeline: job register/deregister -> eval, node register/heartbeat/
status -> node evals, alloc stop and client-reported failure ->
reschedule eval.

Port of `nomad_tpu/server/server.py`.  `batch_pipeline=True` (the
default) builds `BatchWorker`s, which prescore evals through kernel K3
on the server's device; `batch_pipeline=False` builds sequential
`Worker`s, which run the per-eval device stack (`CudaGenericStack`)
when the scheduler config enables it.  `device=None` means the CUDA
card and raises `NoDeviceError` without one; `device="cpu"` runs the
plain-PyTorch twins.  `mesh=` (a `parallel.mesh.VirtualMesh` of D
shards on the server's device, or a `DistMesh`) puts the batch workers
on the node-sharded path (K12-K14); so does NOMAD_TPU_MESH=1, over the
initialised torch.distributed group.  The device supervisor (`device/supervisor.py`)
is built before the workers and runs while the server leads: live for
a server on the card (or with NOMAD_TPU_SUPERVISOR=1 or an armed
NOMAD_TPU_FAULT), idle for a CPU server otherwise.  While it holds the
pipeline (LOST, RECOVERING) every worker holds and `drain_to_idle`
raises its fault.  Not ported yet (ROADMAP.md): ACLs, overload
control, fan-out, federation, SLOs, the service catalog, deployment
watcher, drainer, periodic dispatcher, volume watcher, keyring, the
other client RPCs, connect sidecar injection, multiregion
interpolation and `plan_job`.
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from dataclasses import replace as _replace
from typing import Dict, List, Optional

from ..device import resolve_device
from ..state.store import StateStore
from ..structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_DESIRED_STOP,
    Allocation,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_ALLOC_STOP,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_UPDATE,
    Evaluation,
    Job,
    JOB_TYPE_CORE,
    JOB_TYPE_SERVICE,
    Node,
    NodeEvent,
    NODE_STATUS_DOWN,
    NODE_STATUS_READY,
)
from ..telemetry import Metrics
from .blocked_evals import BlockedEvals
from .eval_broker import BROKER_COUNTERS, EvalBroker
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .worker import Worker

LOG = logging.getLogger("nomad_tpu_torch.server")

DEFAULT_HEARTBEAT_TTL = 30.0
# how long drain_to_idle waits, while the device supervisor holds, for
# the workers met by a trip to nack their leases and record it
HOLD_SETTLE_S = 3.0

# leadership failover telemetry, zero-registered at construction
LEADERSHIP_COUNTERS = (
    "leadership.establishes",
    "leadership.revokes",
    "leadership.unacked_on_revoke",
    "leadership.chain_aborts",
    "leadership.plan_rejected",
    "leadership.stale_wave_fenced",
)
LEADERSHIP_GAUGES = ("leadership.generation", "leadership.is_leader")


class Server:
    def __init__(
        self,
        num_schedulers: int = 1,
        heartbeat_ttl: float = DEFAULT_HEARTBEAT_TTL,
        seed: Optional[int] = None,
        nack_timeout: float = 60.0,
        # the batched pipeline is the default scheduling path; it
        # falls back per eval to the exact sequential scheduler for
        # shapes the kernel doesn't model, with prescore-rate +
        # fallback counters in the metrics
        batch_pipeline: bool = True,
        store: Optional[StateStore] = None,
        device=None,
        device_config=None,
        mesh=None,
    ) -> None:
        # resolved first: a server meant for the card fails here, at
        # construction, when there is none
        self.device = resolve_device(device)
        self.store = store if store is not None else StateStore()
        self.metrics = Metrics()
        # placement explainability: zero-register the placement.*
        # counter/gauge families so dashboards see the whole reason
        # vocabulary from process start (absence-of-series must mean
        # absence-of-filtering, not "no eval explained yet")
        from ..explain import preregister as _preregister_placement

        _preregister_placement(self.metrics)
        # the device supervisor owns the card's liveness (canary
        # probes, stage watchdogs, the hold on LOST) for every worker.
        # Built BEFORE the workers so they can subscribe to its
        # transitions; idle (no thread) for a CPU server unless forced
        # with NOMAD_TPU_SUPERVISOR=1 or an armed NOMAD_TPU_FAULT
        from ..device import DeviceSupervisor

        self.device_supervisor = DeviceSupervisor(
            metrics=self.metrics, config=device_config, device=self.device
        )
        self.broker = EvalBroker(nack_timeout=nack_timeout)
        # lost-eval accounting: the broker is constructed without a
        # telemetry handle, so wire ours in and zero-register its
        # family
        self.broker.metrics = self.metrics
        self.metrics.preregister(counters=BROKER_COUNTERS)
        self.blocked = BlockedEvals(self.broker)
        self.plan_queue = PlanQueue()
        self.applier = PlanApplier(
            self.store, self.plan_queue, self.blocked, self.metrics,
            # in-flight plans of a deposed leadership respond
            # NotLeaderError (the worker converts it to
            # nack-for-redelivery) instead of committing
            leader_check=lambda: self._leader_established,
        )
        self.metrics.preregister(
            counters=LEADERSHIP_COUNTERS, gauges=LEADERSHIP_GAUGES
        )
        # policy-weighted scoring: zero-register the policy.* family
        # (absence-of-series must mean "no policy-weighted select ever
        # ran", not "not exported").  Outside the batch_pipeline gate:
        # weighted assembly runs in both pipeline modes
        from ..sched.policy import POLICY_COUNTERS, POLICY_GAUGES

        self.metrics.preregister(
            counters=POLICY_COUNTERS, gauges=POLICY_GAUGES
        )
        if mesh is not None and not batch_pipeline:
            raise ValueError(
                "mesh= shards the batch workers: it needs batch_pipeline=True"
            )
        if batch_pipeline:
            from .batch_worker import (
                ADMISSION_COUNTERS,
                MESH_COUNTERS,
                MESH_GAUGES,
                STORM_COUNTERS,
                STORM_GAUGES,
                BatchWorker,
            )

            # sharded hot path: zero-register the mesh.* family
            # (absence-of-series must mean "mesh never engaged", not
            # "not exported"); before the workers, which set mesh.hosts
            self.metrics.preregister(
                counters=MESH_COUNTERS, gauges=MESH_GAUGES
            )
            self.workers: List[Worker] = [
                BatchWorker(self, seed=seed, mesh=mesh)
                for _ in range(num_schedulers)
            ]
            # continuous micro-batching: zero-register the admission.*
            # counter family
            self.metrics.preregister(counters=ADMISSION_COUNTERS)
            # global storm solver: zero-register the storm.* family
            # (absence-of-series must mean "no storm ever coalesced" —
            # NOMAD_TPU_STORM off or backlog under the trigger — not
            # "not exported") and expose the mode flag
            self.metrics.preregister(
                counters=STORM_COUNTERS, gauges=STORM_GAUGES
            )
            self.metrics.set_gauge(
                "batch_worker.storm_enabled",
                1.0 if any(
                    getattr(w, "storm_enabled", False)
                    for w in self.workers
                ) else 0.0,
            )
            self.metrics.set_gauge(
                "batch_worker.parallel_replay_enabled",
                1.0 if any(
                    getattr(w, "parallel_replay", False)
                    for w in self.workers
                ) else 0.0,
            )
            self.metrics.set_gauge(
                "batch_worker.admit_enabled",
                1.0 if any(
                    getattr(w, "admit_enabled", False)
                    for w in self.workers
                ) else 0.0,
            )
        else:
            self.workers = [
                Worker(self, seed=seed) for _ in range(num_schedulers)
            ]
        self.metrics.set_gauge(
            "server.batch_pipeline", 1.0 if batch_pipeline else 0.0
        )
        self.heartbeat_ttl = heartbeat_ttl
        # node id -> monotonic expiry deadline.  ONE sweeper thread
        # serves every TTL (a thread per node at 10k nodes would be
        # 10k live threads)
        self._heartbeat_deadlines: Dict[str, float] = {}
        # mass node-death gather: node id -> monotonic instant its TTL
        # expiry was detected.  A sweep that detects a correlated wave
        # (>= _wave_min expiries) holds the down transition briefly so
        # a rack death whose heartbeat phases straddle sweep
        # boundaries still commits as ONE batched transition.  A
        # heartbeat arriving mid-gather pulls its node back out.
        self._down_wave: Dict[str, float] = {}
        self._wave_counter = itertools.count(1)
        try:
            self._wave_min = max(
                1,
                int(os.environ.get("NOMAD_TPU_OVERLOAD_WAVE_MIN", "8")),
            )
        except ValueError:
            self._wave_min = 8
        raw_gather = os.environ.get(
            "NOMAD_TPU_OVERLOAD_WAVE_GATHER_S", "auto"
        )
        try:
            self._wave_gather_s = max(0.0, float(raw_gather))
        except ValueError:
            self._wave_gather_s = min(
                10.0, max(2.5, heartbeat_ttl / 3.0)
            )
        self._heartbeat_sweeper: Optional[threading.Thread] = None
        self._sweeper_lock = threading.Lock()
        self._running = False
        self._leader_established = False
        # leadership generation: bumped on every establish.  The
        # batched hot path captures it at wave/chain start and fences
        # commits on it — a wave speculated under a deposed
        # leadership can never commit.
        self._leadership_gen = 0
        self._leader_lock = threading.Lock()

    # -- lifecycle (reference leader.go:222 establishLeadership) -------

    def start(self) -> None:
        """Single-process mode: this server is always the leader."""
        self._running = True
        self.establish_leadership()

    def stop(self) -> None:
        self._running = False
        self.revoke_leadership()
        self._heartbeat_deadlines.clear()
        # the canary's bound probe (its host block); start() binds anew
        self.device_supervisor.close()

    def establish_leadership(self, gen: Optional[int] = None) -> None:
        """Enable the leader-only services (reference leader.go:222):
        eval broker, blocked evals, plan queue/applier, scheduling
        workers, heartbeat timers; then restore evals from state."""
        with self._leader_lock:
            if self._leader_established:
                return
            self._leadership_gen = (
                gen if gen is not None else self._leadership_gen + 1
            )
            # flipped BEFORE any service starts: the applier's
            # leader_check and the workers' leadership fences read it
            self._leader_established = True
            self.metrics.incr("leadership.establishes")
            self.metrics.set_gauge(
                "leadership.generation", float(self._leadership_gen)
            )
            self.metrics.set_gauge("leadership.is_leader", 1.0)
            self.broker.set_enabled(True)
            self.blocked.set_enabled(True)
            self.plan_queue.set_enabled(True)
            self.applier.start()
            # device supervision runs while this server schedules (a
            # no-op when it expects no card: no probe thread starts).
            # On the card this loads K8 first, so no parked canary
            # thread ever holds the kernels' build lock
            self.device_supervisor.start()
            for worker in self.workers:
                worker.start()
            # re-arm heartbeat TTLs for every known node (reference
            # heartbeat.go initializeHeartbeatTimers on leadership)
            for node in self.store.iter_nodes():
                if node.status != NODE_STATUS_DOWN:
                    self._reset_heartbeat(node.id)
            self._ensure_sweeper()
            self.restore_evals()

    def revoke_leadership(self) -> None:
        """Disable leader-only services (reference leader.go
        revokeLeadership).  ``_leader_established`` flips FIRST, so
        every in-flight wave/chain commit hits the leadership fence
        before any queue is torn down; the broker flush then unacks
        every outstanding token for the next leader."""
        with self._leader_lock:
            if not self._leader_established:
                return
            self._leader_established = False
            self.metrics.incr("leadership.revokes")
            self.metrics.set_gauge("leadership.is_leader", 0.0)
            # first: releases every sacrificial thread parked on an
            # injected wedge
            self.device_supervisor.stop()
            for worker in self.workers:
                worker.stop()
            self.applier.stop()
            self._heartbeat_deadlines.clear()
            self._down_wave.clear()
            self.plan_queue.set_enabled(False)
            self.blocked.set_enabled(False)
            outstanding = self.broker.unacked_count()
            if outstanding:
                self.metrics.incr(
                    "leadership.unacked_on_revoke", float(outstanding)
                )
            self.broker.set_enabled(False)

    def restore_evals(self) -> None:
        """Re-enqueue non-terminal evals from state after (re)start
        (reference leader.go:352 restoreEvals)."""
        for ev in list(self.store.evals.values()):
            if ev.should_enqueue():
                self.broker.enqueue(ev)
            elif ev.should_block():
                self.blocked.block(ev)

    # -- eval routing (reference fsm.go:715) ----------------------------

    def on_eval_update(self, ev: Evaluation) -> None:
        if ev.should_enqueue():
            self.broker.enqueue(ev)
        elif ev.should_block():
            self.blocked.block(ev)

    # -- job API (reference nomad/job_endpoint.go Register:349) ---------

    def register_job(self, job: Job) -> Optional[Evaluation]:
        self._validate_job(job)
        self.store.upsert_job(job)
        if job.is_periodic() or job.is_parameterized():
            # launched by the periodic dispatcher / dispatch call,
            # neither of which is ported yet
            return None
        ev = Evaluation(
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
            job_id=job.id,
            job_modify_index=job.modify_index,
            status=EVAL_STATUS_PENDING,
        )
        self.store.upsert_evals([ev])
        self.on_eval_update(ev)
        return ev

    def deregister_job(
        self, namespace: str, job_id: str, purge: bool = False
    ) -> Optional[Evaluation]:
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            return None
        if purge:
            self.store.delete_job(namespace, job_id)
        else:
            job.stop = True
            self.store.upsert_job(job)
        self.blocked.untrack(namespace, job_id)
        ev = Evaluation(
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_DEREGISTER,
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
        )
        self.store.upsert_evals([ev])
        self.on_eval_update(ev)
        return ev

    def stop_alloc(self, alloc_id: str) -> Optional[Evaluation]:
        """User-initiated alloc stop: desired=stop + reschedule eval
        (reference alloc_endpoint.go Alloc.Stop)."""
        alloc = self.store.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(alloc_id)
        stopped = _replace(alloc)
        stopped.desired_status = ALLOC_DESIRED_STOP
        self.store.upsert_allocs([stopped])
        ev = Evaluation(
            namespace=alloc.namespace,
            priority=alloc.job.priority if alloc.job else 50,
            type=alloc.job.type if alloc.job else "service",
            triggered_by=EVAL_TRIGGER_ALLOC_STOP,
            job_id=alloc.job_id,
            status=EVAL_STATUS_PENDING,
        )
        self.store.upsert_evals([ev])
        self.on_eval_update(ev)
        return ev

    def _validate_job(self, job: Job) -> None:
        if not job.id:
            raise ValueError("missing job ID")
        if not job.task_groups:
            raise ValueError("job requires at least one task group")
        names = set()
        for tg in job.task_groups:
            if tg.name in names:
                raise ValueError(f"duplicate task group {tg.name!r}")
            names.add(tg.name)
            if tg.count < 0:
                raise ValueError("task group count must be >= 0")
            if not tg.tasks and job.type != JOB_TYPE_CORE:
                raise ValueError(
                    f"task group {tg.name!r} requires at least one task"
                )
        if job.type not in ("service", "batch"):
            # the port registers the service and batch schedulers only
            raise ValueError(f"invalid job type {job.type!r}")
        if (
            job.namespace != "default"
            and self.store.namespace_by_name(job.namespace) is None
        ):
            raise ValueError(
                f"namespace {job.namespace!r} does not exist"
            )

    # -- node API (reference nomad/node_endpoint.go) --------------------

    def register_node(self, node: Node) -> None:
        first_seen = self.store.node_by_id(node.id) is None
        if node.status == "initializing":
            node.status = NODE_STATUS_READY
        self.store.upsert_node(node)
        self._emit_node_event(
            node.id,
            "Node registered" if first_seen else "Node re-registered",
        )
        self._reset_heartbeat(node.id)
        self.blocked.unblock(
            node.computed_class, self.store.latest_index()
        )
        self._create_node_evals(node.id)

    def heartbeat(self, node_id: str) -> None:
        """(reference nomad/heartbeat.go resetHeartbeatTimer)"""
        node = self.store.node_by_id(node_id)
        if node is None:
            raise KeyError(node_id)
        if node.status == NODE_STATUS_DOWN:
            self.update_node_status(node_id, NODE_STATUS_READY)
        self._reset_heartbeat(node_id)

    def _reset_heartbeat(self, node_id: str) -> None:
        # TTL deadlines are a leader-only service
        if not (self._running and self._leader_established):
            self._heartbeat_deadlines.pop(node_id, None)
            self._down_wave.pop(node_id, None)
            return
        self._heartbeat_deadlines[node_id] = (
            time.monotonic() + self.heartbeat_ttl
        )
        # a node heartbeating while its expiry sits in a gathering
        # down-wave was never dead: pull it back out
        self._down_wave.pop(node_id, None)
        self._ensure_sweeper()

    def _ensure_sweeper(self) -> None:
        """(Re)spawn the heartbeat sweeper if it is missing or died."""
        if not (self._running and self._leader_established):
            return
        with self._sweeper_lock:
            if self._heartbeat_sweeper is None or not (
                self._heartbeat_sweeper.is_alive()
            ):
                self._heartbeat_sweeper = threading.Thread(
                    target=self._sweep_heartbeats,
                    name="heartbeat-sweeper",
                    daemon=True,
                )
                self._heartbeat_sweeper.start()

    def _sweep_heartbeats(self) -> None:
        while self._running:
            interval = max(
                0.02, min(0.5, self.heartbeat_ttl / 5.0)
            )
            time.sleep(interval)
            if not self._leader_established:
                self._down_wave.clear()
                continue
            try:
                self._sweep_once(interval)
            except Exception:  # noqa: BLE001 — TTL enforcement must
                # survive any single sweep's failure
                LOG.exception("heartbeat sweep failed")

    def _sweep_once(self, interval: float) -> None:
        """One sweep: collect every TTL expiry, fold it into the
        pending down-wave, and commit the wave as ONE batched
        transition when it has settled (or after one extra sweep when
        it is below the mass-death gather threshold)."""
        now = time.monotonic()
        expired = [
            node_id
            for node_id, deadline in list(
                self._heartbeat_deadlines.items()
            )
            if deadline <= now
        ]
        for node_id in expired:
            current = self._heartbeat_deadlines.get(node_id)
            if current is None or current > now:
                continue  # heartbeated (refreshed) since the scan
            self._heartbeat_deadlines.pop(node_id, None)
            self._down_wave[node_id] = now
        if not self._down_wave:
            return
        stamps = list(self._down_wave.values())
        wave_started = min(stamps)
        last_new = max(stamps)
        if len(self._down_wave) >= self._wave_min:
            settle_s = max(interval, min(2.0, self._wave_gather_s))
        else:
            settle_s = interval
        if (
            now - last_new < settle_s
            and now - wave_started < self._wave_gather_s
        ):
            return
        wave = list(self._down_wave.keys())
        self._down_wave.clear()
        self._heartbeats_expired(wave)

    def _heartbeats_expired(self, node_ids: List[str]) -> None:
        """Missed TTLs: the whole wave goes down in ONE batched state
        transition, and its replan evals are enqueued as one family
        (reference heartbeat.go:135 invalidateHeartbeat, batched)."""
        node_ids = [
            node_id
            for node_id in node_ids
            # a member whose deadline was re-armed between the wave
            # snapshot and this commit heartbeated through the race
            # window — it was never dead
            if node_id not in self._heartbeat_deadlines
            and (node := self.store.node_by_id(node_id)) is not None
            and node.status != NODE_STATUS_DOWN
        ]
        if not node_ids:
            return
        self.store.update_node_statuses(
            node_ids,
            NODE_STATUS_DOWN,
            message="Node heartbeat missed",
        )
        wave_n = next(self._wave_counter)
        self._create_node_evals_batch(
            node_ids, family_hint=f"node-down:w{wave_n}"
        )

    def _emit_node_event(
        self, node_id: str, message: str, subsystem: str = "Cluster"
    ) -> None:
        """(reference node_endpoint.go emitting NodeEvents)"""
        try:
            self.store.upsert_node_events(
                node_id,
                [NodeEvent(message=message, subsystem=subsystem)],
            )
        except KeyError:
            pass

    def update_node_status(self, node_id: str, status: str) -> None:
        prev = self.store.node_by_id(node_id)
        prev_status = prev.status if prev is not None else ""
        self.store.update_node_status(node_id, status)
        if status != prev_status:
            self._emit_node_event(
                node_id,
                (
                    "Node heartbeat missed"
                    if status == NODE_STATUS_DOWN
                    else f"Node status changed to {status}"
                ),
            )
        node = self.store.node_by_id(node_id)
        if status == NODE_STATUS_READY:
            self._reset_heartbeat(node_id)
            self.blocked.unblock(
                node.computed_class, self.store.latest_index()
            )
        self._create_node_evals(node_id)

    def _create_node_evals(self, node_id: str) -> List[Evaluation]:
        """One eval per job with allocs on the node (reference
        node_endpoint.go:1316 createNodeEvals; system jobs are not
        registered in the port)."""
        return self._create_node_evals_batch([node_id])

    def _create_node_evals_batch(
        self, node_ids: List[str], family_hint: str = ""
    ) -> List[Evaluation]:
        """The wave form of ``_create_node_evals``: ONE eval per
        affected (namespace, job) across the whole node wave,
        persisted in one upsert and stamped with the wave's
        ``family_hint``."""
        evals = []
        seen_jobs = set()
        for node_id in node_ids:
            for alloc in self.store.allocs_by_node(node_id):
                key = (alloc.namespace, alloc.job_id)
                if key in seen_jobs:
                    continue
                seen_jobs.add(key)
                job = self.store.job_by_id(*key)
                evals.append(
                    Evaluation(
                        namespace=alloc.namespace,
                        priority=job.priority if job else 50,
                        type=(
                            job.type if job is not None
                            else JOB_TYPE_SERVICE
                        ),
                        triggered_by=EVAL_TRIGGER_NODE_UPDATE,
                        job_id=alloc.job_id,
                        node_id=node_id,
                        family_hint=family_hint,
                        status=EVAL_STATUS_PENDING,
                    )
                )
        if evals:
            self.store.upsert_evals(evals)
            if family_hint:
                # the whole wave lands in ONE broker lock acquisition
                self.broker.enqueue_all(
                    [ev for ev in evals if ev.should_enqueue()]
                )
                for ev in evals:
                    if not ev.should_enqueue():
                        self.on_eval_update(ev)
            else:
                for ev in evals:
                    self.on_eval_update(ev)
        return evals

    # -- client-side alloc updates (reference node_endpoint.go:1065) ----

    def update_allocs_from_client(self, updates: List[Allocation]) -> None:
        """Client pushes alloc status changes; terminal transitions free
        capacity and may trigger reschedule evals."""
        self.store.upsert_allocs(updates)
        evals = []
        seen = set()
        for alloc in updates:
            if not alloc.terminal_status():
                continue
            node = self.store.node_by_id(alloc.node_id)
            if node is not None:
                self.blocked.unblock(
                    node.computed_class, self.store.latest_index()
                )
            key = (alloc.namespace, alloc.job_id)
            if key in seen:
                continue
            job = self.store.job_by_id(*key)
            if job is None or job.stopped():
                continue
            if alloc.client_status == ALLOC_CLIENT_STATUS_FAILED:
                seen.add(key)
                evals.append(
                    Evaluation(
                        namespace=alloc.namespace,
                        priority=job.priority,
                        type=job.type,
                        triggered_by="alloc-failure",
                        job_id=alloc.job_id,
                        status=EVAL_STATUS_PENDING,
                    )
                )
        if evals:
            self.store.upsert_evals(evals)
            for ev in evals:
                self.on_eval_update(ev)

    # -- helpers ---------------------------------------------------------

    def drain_to_idle(self, timeout: float = 10.0) -> bool:
        """Wait until no evals are in flight (test/bench helper).
        Raises the fault of a worker that stopped on one, a watchdog
        trip a worker met (once), and the device supervisor's fault
        while it holds the pipeline (LOST, RECOVERING): held evals stay
        in the broker, and waiting on them would only time out.  While
        it holds, the raise waits (at most HOLD_SETTLE_S) until the
        workers met by the trip have nacked their leases and recorded
        it (`_held_fault`)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for worker in self.workers:
                if worker.fault is not None:
                    raise worker.fault
                tripped = worker.tripped
                if tripped is not None:
                    worker.tripped = None
                    raise tripped
            if self.device_supervisor.holding():
                raise self._held_fault(deadline)
            if (
                self.broker.ready_count() == 0
                and self.broker.stats["total_unacked"] == 0
                and self.plan_queue.stats["depth"] == 0
            ):
                return True
            time.sleep(0.01)
        return False

    def _held_fault(self, deadline: float) -> BaseException:
        """What drain_to_idle raises while the supervisor holds.  The
        watchdog's thread sets LOST before the worker that met the trip
        has nacked its gulp, so first wait (until HOLD_SETTLE_S or the
        caller's deadline) for the broker's unacked leases to reach 0,
        then for each worker's `settling` lock, held from its nack to
        its record of the trip.  A trip a worker recorded is raised
        (once) before the supervisor's fault; past the bound the
        supervisor's fault is raised as it stands."""
        settle = min(deadline, time.monotonic() + HOLD_SETTLE_S)
        while (self.broker.stats["total_unacked"]
               and time.monotonic() < settle):
            time.sleep(0.01)
        for worker in self.workers:
            lock = getattr(worker, "settling", None)
            if lock is not None and lock.acquire(
                    timeout=max(0.0, settle - time.monotonic())):
                lock.release()
            tripped = worker.tripped
            if tripped is not None:
                worker.tripped = None
                return tripped
        return self.device_supervisor.fault()
