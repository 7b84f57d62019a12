"""Evaluation broker (reference nomad/eval_broker.go).

Leader-only priority-queue broker with at-least-once delivery: ack/nack
with nack-timeout redelivery, a delivery limit that shunts poison evals to
a failed queue, per-JobID dedup ("evaluations for a given job are not run
in parallel", structs.go:9535 — while one eval of a job is outstanding,
later ones wait in a per-job pending heap), and delayed evals (wait_until)
held in a time heap.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..structs import Evaluation, new_id
from ..trace import TRACE

DEFAULT_NACK_TIMEOUT = 60.0
DEFAULT_DELIVERY_LIMIT = 3
FAILED_QUEUE = "_failed"

# exported once the server wires its Metrics handle in (the broker is
# constructed before telemetry): a delivery-exhausted eval parked in
# the failed queue is the zero-lost-evals SLO's only burn signal, so
# absence of the series must mean "nothing lost", not "not exported"
# — Server zero-registers the family at construction
BROKER_COUNTERS = ("broker.delivery_failures",)

# job-id separators that mark a parent's spawned children: a dispatch
# or periodic storm is hundreds of sibling jobs under one parent
_FAMILY_SEPARATORS = ("/dispatch-", "/periodic-")


def job_family(ev: Evaluation) -> Tuple[str, str]:
    """The (namespace, parent job id) an eval's job belongs to.

    Dispatch and periodic children (``parent/dispatch-x``,
    ``parent/periodic-ts``) collapse onto their parent, so a mass
    dispatch, a drain stopping hundreds of children, or a scale-up
    wave all read as ONE family — the unit the batch worker's storm
    detector coalesces into a single global assignment solve.  The
    broker's one-outstanding-eval-per-job rule is untouched: family
    members are sibling *jobs*, each with its own dedup key.

    An explicit ``family_hint`` on the eval overrides the job-id
    derivation: the heartbeat sweeper stamps every replan eval of one
    mass node-death wave with the wave's hint, so a 500-node rack
    death — evals across MANY unrelated jobs — still coalesces into
    one storm family (and one global assignment solve) instead of
    hundreds of per-job chunk-chain walks."""
    hint = getattr(ev, "family_hint", "")
    if hint:
        return (ev.namespace, hint)
    job_id = ev.job_id or ""
    for sep in _FAMILY_SEPARATORS:
        i = job_id.find(sep)
        if i >= 0:
            job_id = job_id[:i]
            break
    return (ev.namespace, job_id)


class _ReadyQueue:
    """Priority heap: highest priority first, then FIFO by create index."""

    def __init__(self) -> None:
        self.heap: List[Tuple[int, int, Evaluation]] = []
        self._counter = itertools.count()
        # negative keys for evals handed back to the head (release)
        self._front = itertools.count(1)

    def push(self, ev: Evaluation, front: bool = False) -> None:
        order = -next(self._front) if front else next(self._counter)
        heapq.heappush(self.heap, (-ev.priority, order, ev))

    def pop(self) -> Optional[Evaluation]:
        if not self.heap:
            return None
        return heapq.heappop(self.heap)[2]

    def peek_priority(self) -> Optional[int]:
        if not self.heap:
            return None
        return -self.heap[0][0]

    def __len__(self) -> int:
        return len(self.heap)


class EvalBroker:
    def __init__(
        self,
        nack_timeout: float = DEFAULT_NACK_TIMEOUT,
        delivery_limit: int = DEFAULT_DELIVERY_LIMIT,
    ) -> None:
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        self._lock = threading.Condition()
        self._enabled = False

        self._ready: Dict[str, _ReadyQueue] = {}
        # eval id -> (eval, token, monotonic redelivery deadline).
        # ONE sweeper thread redelivers expired deliveries — a
        # threading.Timer per dequeue is an OS thread per in-flight
        # eval, which under load is thousands of short-lived threads
        self._unack: Dict[str, Tuple[Evaluation, str, float]] = {}
        # (namespace, job_id) -> outstanding eval id
        self._job_evals: Dict[Tuple[str, str], str] = {}
        # (namespace, job_id) -> heap of waiting evals (priority desc,
        # create_index asc) -- reference eval_broker.go:117
        self._pending: Dict[Tuple[str, str], List] = {}
        self._pending_counter = itertools.count()
        # eval id -> monotonic instant it became READY (insertion
        # order == enqueue order, so the first entry is the oldest):
        # feeds oldest_pending_age(), the overload ladder's queueing-
        # delay signal.  Redelivered evals re-stamp — age measures
        # time-in-ready, not time-since-first-submit
        self._ready_ts: Dict[str, float] = {}
        # delayed evals: (wait_until, n, eval)
        self._delayed: List[Tuple[float, int, Evaluation]] = []
        self._delivery_count: Dict[str, int] = {}
        # eval id -> peer server address for leases granted over the
        # cluster transport (follower scheduling fan-out).  Remote
        # leases live in _unack like any other delivery — the same
        # nack-timeout sweeper reclaims a dead follower's leases —
        # this map only attributes them per server for the stats
        # surface and post-mortem accounting.
        self._remote_leases: Dict[str, str] = {}
        self._ticker: Optional[threading.Thread] = None
        self.ticks = 0
        # tiny event ring for post-mortem debugging (eval id prefix,
        # action, monotonic ts) — cheap, and invaluable when an eval
        # "disappears" between enqueue and ack
        self.events: "deque" = deque(maxlen=128)
        self.stats = {
            "total_ready": 0,
            "total_unacked": 0,
            "total_blocked": 0,
            "total_waiting": 0,
            "total_remote_unacked": 0,
            "delivery_failures": 0,
        }
        # the owning server's Metrics handle (set post-construction;
        # None on bare brokers in unit tests)
        self.metrics = None
        # happens-before sanitizer (NOMAD_TPU_TSAN=1)
        from ..tsan import maybe_instrument

        maybe_instrument(self, "EvalBroker")

    # ------------------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        import os

        with self._lock:
            self._enabled = enabled
            if not enabled:
                self._flush_locked()
            self._lock.notify_all()
            if enabled:
                self._ensure_ticker_locked()

    def _ensure_ticker_locked(self) -> None:
        # the redelivery sweeper: expires unacked deliveries past
        # their nack deadline and promotes delayed evals.  Re-armed
        # from EVERY lease-taking path (set_enabled, dequeue,
        # drain_family), not just enable — a drained storm family's
        # shadow-heap members must never depend on the storm path
        # settling for their redelivery, even if the sweeper thread
        # died.  With NOMAD_TPU_BROKER_WATCHDOG=1 it also
        # notify_all()s every tick — a workaround for thread
        # schedulers that park timed Condition waits far past their
        # timeout (a 5ms wait observed sleeping 10s+ with the GIL
        # free, no lock holder, and no clock step).
        if self._ticker is None or not self._ticker.is_alive():
            self._ticker = threading.Thread(
                target=self._tick, name="broker-sweeper", daemon=True
            )
            self._ticker.start()

    def _tick(self) -> None:
        import os

        watchdog = os.environ.get("NOMAD_TPU_BROKER_WATCHDOG") == "1"
        while True:
            time.sleep(0.05)
            expired: List[Tuple[str, str]] = []
            with self._lock:
                self.ticks += 1
                if not self._enabled and not self._unack:
                    self._ticker = None
                    return
                now = time.monotonic()
                expired = [
                    (eval_id, token)
                    for eval_id, (_ev, token, deadline) in (
                        self._unack.items()
                    )
                    if deadline <= now
                ]
                self._promote_delayed_locked()
                if watchdog:
                    self._lock.notify_all()
            for eval_id, token in expired:
                try:
                    self.nack(eval_id, token)
                except ValueError:
                    pass  # acked/nacked concurrently

    @property
    def enabled(self) -> bool:
        return self._enabled

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        # callers already hold self._lock (re-entry would be legal —
        # a bare Condition wraps an RLock — just pointless work);
        # set_enabled flushes mid-critical-section through this
        self._ready.clear()
        self._ready_ts.clear()
        # in-flight traces must not dangle as "in flight" forever in
        # /v1/traces after a leadership revoke: every unacked delivery
        # dies with this flush, so settle its trace with an explicit
        # `revoked` outcome (the next leadership's redelivery begins a
        # fresh generation)
        for eval_id in self._unack:
            TRACE.finish(eval_id, "revoked")
        self._unack.clear()
        self._job_evals.clear()
        self._pending.clear()
        self._delayed.clear()
        self._delivery_count.clear()
        # the stats must follow the queues they describe: a stale
        # total_blocked after a flush pinned pending_depth() above
        # the overload threshold forever (mode never recovered), and
        # a stale total_unacked would wedge drain_to_idle
        self.stats["total_ready"] = 0
        self.stats["total_unacked"] = 0
        self.stats["total_blocked"] = 0
        self.stats["total_waiting"] = 0
        # remote leases die with the flush like every other token: a
        # follower's next ack/nack gets a token mismatch and the
        # next leader's restore_evals re-enqueues the evals
        self._remote_leases.clear()
        self.stats["total_remote_unacked"] = 0

    # ------------------------------------------------------------------

    def enqueue(self, ev: Evaluation) -> None:
        with self._lock:
            self._enqueue_locked(ev, ev.type)
            self._lock.notify_all()

    def enqueue_all(self, evals: List[Evaluation]) -> None:
        with self._lock:
            for ev in evals:
                self._enqueue_locked(ev, ev.type)
            self._lock.notify_all()

    def _enqueue_locked(
        self, ev: Evaluation, queue: str, front: bool = False
    ) -> None:
        self.events.append((time.monotonic(), "enq", ev.id[:6], queue))
        if not self._enabled:
            return
        if ev.id in self._unack or any(
            ev.id == q_ev.id
            for q in self._ready.values()
            for _, _, q_ev in q.heap
        ):
            return
        if ev.wait_until and ev.wait_until > time.time():
            heapq.heappush(
                self._delayed,
                (ev.wait_until, next(self._pending_counter), ev),
            )
            self.stats["total_waiting"] += 1
            return
        job_key = (ev.namespace, ev.job_id)
        if queue != FAILED_QUEUE and ev.job_id:
            outstanding = self._job_evals.get(job_key)
            if outstanding and outstanding != ev.id:
                heapq.heappush(
                    self._pending.setdefault(job_key, []),
                    (-ev.priority, next(self._pending_counter), ev),
                )
                self.stats["total_blocked"] += 1
                return
            self._job_evals[job_key] = ev.id
        self._ready.setdefault(queue, _ReadyQueue()).push(ev, front)
        if queue != FAILED_QUEUE:
            self._ready_ts[ev.id] = time.monotonic()
        self.stats["total_ready"] += 1

    # ------------------------------------------------------------------

    def dequeue(
        self, schedulers: List[str], timeout: Optional[float] = None
    ) -> Tuple[Optional[Evaluation], str]:
        """Blocking dequeue across the given scheduler queues; returns
        (eval, token) or (None, "") on timeout/disable."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._lock:
            while True:
                self._promote_delayed_locked()
                ev = self._pop_ready_locked(schedulers)
                if ev is not None:
                    token = new_id()
                    self._unack[ev.id] = (
                        ev, token, time.monotonic() + self.nack_timeout,
                    )
                    self._ensure_ticker_locked()
                    self.stats["total_unacked"] += 1
                    self.events.append((time.monotonic(), "deq", ev.id[:6], token[:6]))
                    # flight recorder: the dequeue is the trace root —
                    # every downstream span (pipeline stages, replay,
                    # plan apply, store commit) attaches to it by
                    # eval id
                    TRACE.begin(
                        ev.id,
                        queue=ev.type,
                        priority=ev.priority,
                        namespace=ev.namespace,
                        job_id=ev.job_id,
                        triggered_by=ev.triggered_by,
                    )
                    return ev, token
                if not self._enabled:
                    return None, ""
                wait = 0.05
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None, ""
                    wait = min(wait, remaining)
                self._lock.wait(wait)

    def _pop_ready_locked(self, schedulers) -> Optional[Evaluation]:
        best_queue = None
        best_priority = None
        for name in schedulers:
            q = self._ready.get(name)
            if q is None or not len(q):
                continue
            p = q.peek_priority()
            if best_priority is None or p > best_priority:
                best_priority = p
                best_queue = q
        if best_queue is None:
            return None
        self.stats["total_ready"] -= 1
        ev = best_queue.pop()
        if ev is not None:
            self._ready_ts.pop(ev.id, None)
        return ev

    def drain_family(
        self,
        schedulers: List[str],
        family: Tuple[str, str],
        max_n: int,
        min_n: int = 1,
    ) -> List[Tuple[Evaluation, str]]:
        """Atomically dequeue the contiguous pop-order prefix of ready
        evals whose :func:`job_family` equals ``family`` — never
        leapfrogging an unrelated eval: the walk stops at the first
        ready eval of another family (or at ``max_n``).

        All-or-nothing below ``min_n``: when the prefix is shorter
        than ``min_n`` NOTHING is dequeued and ``[]`` is returned, so
        a storm probe that doesn't meet its trigger threshold leaves
        the queue byte-identical (re-pushing popped evals would mint
        fresh FIFO counters and reorder them within their priority
        class).  Each drained eval gets the full ``dequeue``
        bookkeeping — unack token, redelivery deadline, trace root —
        so ack/nack (and nack-timeout redelivery) work unchanged.

        This replaces the storm path's previous shape of N racing
        ``dequeue()`` calls, which interleaved with other consumers
        and could split one family's backlog across gulps."""
        with self._lock:
            self._promote_delayed_locked()
            # cheap rejection before any copying: when the pop-order
            # head is already another family the drainable prefix is
            # empty, and storm probes run at EVERY gulp boundary —
            # an O(ready backlog) shadow copy per dequeue would be
            # quadratic under mixed traffic
            head = None
            head_priority = None
            for name in schedulers:
                q = self._ready.get(name)
                if q is None or not len(q):
                    continue
                p = q.peek_priority()
                if head_priority is None or p > head_priority:
                    head_priority = p
                    head = q.heap[0][2]
            if head is None or job_family(head) != family:
                return []
            # phase 1: measure the prefix on shadow heaps (list copies
            # preserve the heap invariant) so a too-short prefix pops
            # nothing real
            shadows = {
                name: list(q.heap)
                for name, q in self._ready.items()
                if name in schedulers and len(q)
            }
            count = 0
            while count < max_n:
                best_name = None
                best_priority = None
                for name in schedulers:
                    heap = shadows.get(name)
                    if not heap:
                        continue
                    p = -heap[0][0]
                    if best_priority is None or p > best_priority:
                        best_priority = p
                        best_name = name
                if best_name is None:
                    break
                ev = heapq.heappop(shadows[best_name])[2]
                if job_family(ev) != family:
                    break
                count += 1
            if count < min_n:
                return []
            out: List[Tuple[Evaluation, str]] = []
            # the members' redelivery must not depend on the storm
            # path settling: the sweeper is (re)armed with the leases
            self._ensure_ticker_locked()
            for _ in range(count):
                ev = self._pop_ready_locked(schedulers)
                token = new_id()
                self._unack[ev.id] = (
                    ev, token, time.monotonic() + self.nack_timeout,
                )
                self.stats["total_unacked"] += 1
                self.events.append(
                    (time.monotonic(), "deq", ev.id[:6], token[:6])
                )
                TRACE.begin(
                    ev.id,
                    queue=ev.type,
                    priority=ev.priority,
                    namespace=ev.namespace,
                    job_id=ev.job_id,
                    triggered_by=ev.triggered_by,
                )
                out.append((ev, token))
            return out

    def dequeue_remote(
        self,
        schedulers: List[str],
        timeout: Optional[float] = None,
        max_n: int = 1,
        peer: str = "",
    ) -> List[Tuple[Evaluation, str]]:
        """Lease up to ``max_n`` ready evals for a REMOTE scheduling
        server (follower fan-out): one blocking dequeue, then a
        non-blocking sweep to fill the batch — one RPC round trip
        amortizes over the whole lease batch.

        Each lease gets the full ``dequeue`` bookkeeping (unack
        token, redelivery deadline, trace root), PLUS per-server
        attribution in ``_remote_leases`` so the stats surface can
        say which peer holds what.  The nack-timeout sweeper is
        re-armed HERE as well (the ``_ensure_ticker_locked`` pattern
        every lease-taking path follows): a follower that dies
        holding leases must never depend on any other path having
        armed the sweeper for its redelivery — a dead sweeper here
        would wedge ``drain_to_idle`` forever."""
        out: List[Tuple[Evaluation, str]] = []
        ev, token = self.dequeue(schedulers, timeout=timeout)
        if ev is None:
            return out
        out.append((ev, token))
        while len(out) < max_n:
            ev, token = self.dequeue(schedulers, timeout=0.0)
            if ev is None:
                break
            out.append((ev, token))
        self._track_remote(out, peer)
        return out

    def drain_family_remote(
        self,
        schedulers: List[str],
        family: Tuple[str, str],
        max_n: int,
        min_n: int = 1,
        peer: str = "",
    ) -> List[Tuple[Evaluation, str]]:
        """``drain_family`` on behalf of a remote server: the drain is
        atomic HERE, so a family gulp always lands whole on the one
        server that pulled the trigger eval — a storm solve is never
        split across followers."""
        out = self.drain_family(schedulers, family, max_n, min_n)
        self._track_remote(out, peer)
        return out

    def _track_remote(
        self, leases: List[Tuple[Evaluation, str]], peer: str
    ) -> None:
        if not leases:
            return
        with self._lock:
            # re-arm the redelivery sweeper from the remote path too:
            # these leases' redelivery must survive a follower death
            # even if every local lease-taking path has gone idle
            self._ensure_ticker_locked()
            for ev, token in leases:
                # the dequeue and this attribution are separate lock
                # acquisitions: a revoke flush (or a racing sweeper
                # nack) in between already invalidated the token, and
                # recording it anyway would leave a permanent orphan
                # in the per-peer accounting (nothing pops an entry
                # whose ack/nack can only raise).  Only a lease still
                # live under ITS token is attributed.
                entry = self._unack.get(ev.id)
                if entry is not None and entry[1] == token:
                    self._remote_leases[ev.id] = peer
            self.stats["total_remote_unacked"] = len(
                self._remote_leases
            )

    def remote_unacked_count(self) -> int:
        """Leases currently held by remote servers (subset of
        ``unacked_count``: every one also lives in ``_unack`` under
        the same nack-timeout)."""
        with self._lock:
            return len(self._remote_leases)

    def remote_lease_stats(self) -> Dict[str, int]:
        """Outstanding remote leases per peer server — which follower
        holds how much in-flight scheduling work right now."""
        with self._lock:
            out: Dict[str, int] = {}
            for peer in self._remote_leases.values():
                out[peer] = out.get(peer, 0) + 1
            return out

    def _promote_delayed_locked(self) -> None:
        now = time.time()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, ev = heapq.heappop(self._delayed)
            self.stats["total_waiting"] -= 1
            self._enqueue_locked(ev, ev.type)

    # ------------------------------------------------------------------

    def ack(self, eval_id: str, token: str) -> None:
        with self._lock:
            entry = self._unack.get(eval_id)
            if entry is None or entry[1] != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            ev, _, _deadline = entry
            del self._unack[eval_id]
            self.stats["total_unacked"] -= 1
            if self._remote_leases.pop(eval_id, None) is not None:
                self.stats["total_remote_unacked"] = len(
                    self._remote_leases
                )
            self.events.append((time.monotonic(), "ack", eval_id[:6], ""))
            TRACE.finish(eval_id, "ack")
            self._delivery_count.pop(eval_id, None)
            job_key = (ev.namespace, ev.job_id)
            if self._job_evals.get(job_key) == eval_id:
                del self._job_evals[job_key]
                pending = self._pending.get(job_key)
                if pending:
                    _, _, nxt = heapq.heappop(pending)
                    if not pending:
                        del self._pending[job_key]
                    self.stats["total_blocked"] -= 1
                    self._enqueue_locked(nxt, nxt.type)
            self._lock.notify_all()

    def nack(self, eval_id: str, token: str) -> None:
        with self._lock:
            entry = self._unack.get(eval_id)
            if entry is None or entry[1] != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            ev, _, _deadline = entry
            del self._unack[eval_id]
            self.stats["total_unacked"] -= 1
            if self._remote_leases.pop(eval_id, None) is not None:
                self.stats["total_remote_unacked"] = len(
                    self._remote_leases
                )
            self.events.append((time.monotonic(), "nack", eval_id[:6], ""))
            TRACE.finish(eval_id, "nack")
            job_key = (ev.namespace, ev.job_id)
            if self._job_evals.get(job_key) == eval_id:
                del self._job_evals[job_key]
            count = self._delivery_count.get(eval_id, 0) + 1
            self._delivery_count[eval_id] = count
            if count >= self.delivery_limit:
                self.stats["delivery_failures"] += 1
                if self.metrics is not None:
                    self.metrics.incr("broker.delivery_failures")
                self._enqueue_locked(ev, FAILED_QUEUE)
            else:
                self._enqueue_locked(ev, ev.type)
            self._lock.notify_all()

    def release(self, eval_id: str, token: str) -> None:
        """Hand a lease back untouched, as if it had never been
        dequeued: the eval returns to the HEAD of its queue (within its
        priority) and no delivery is counted.  For a worker that finds,
        after its dequeue returned, that the device supervisor holds
        the pipeline — a nack would move the eval behind every later
        one and burn one of its deliveries."""
        with self._lock:
            entry = self._unack.get(eval_id)
            if entry is None or entry[1] != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            ev = entry[0]
            del self._unack[eval_id]
            self.stats["total_unacked"] -= 1
            if self._remote_leases.pop(eval_id, None) is not None:
                self.stats["total_remote_unacked"] = len(
                    self._remote_leases
                )
            self.events.append(
                (time.monotonic(), "release", eval_id[:6], "")
            )
            job_key = (ev.namespace, ev.job_id)
            if self._job_evals.get(job_key) == eval_id:
                del self._job_evals[job_key]
            self._enqueue_locked(ev, ev.type, front=True)
            self._lock.notify_all()

    # ------------------------------------------------------------------

    def outstanding(self, eval_id: str) -> Optional[str]:
        entry = self._unack.get(eval_id)
        return entry[1] if entry else None

    def unacked_count(self) -> int:
        """Outstanding deliveries: normal dequeues, drain_family
        shadow-heap members AND remote (fan-out RPC) leases — all
        live in ``_unack`` and are swept by the same nack-timeout
        redelivery, so a dead follower's leases count here until the
        sweeper reclaims them.  The leadership revoke path reads this
        just before the disable flush to report how much in-flight
        work the failover unacked."""
        with self._lock:
            return len(self._unack)

    def pending_depth(self) -> int:
        """Backlog the broker has accepted but no worker has started:
        ready evals (failed queue excluded — poison evals are parked,
        not pending) plus the per-job pending heaps.  The overload
        ladder's depth signal."""
        with self._lock:
            ready = sum(
                len(q)
                for name, q in self._ready.items()
                if name != FAILED_QUEUE
            )
            return ready + self.stats["total_blocked"]

    def oldest_pending_age(self) -> float:
        """Seconds the oldest READY eval has been waiting for a
        worker — the commit-wave lag the next accepted request will
        inherit before its eval even starts.  0.0 when nothing is
        ready.  O(1): ``_ready_ts`` is insertion-ordered and enqueue
        stamps are monotone, so the first entry is the oldest."""
        with self._lock:
            for ts in self._ready_ts.values():
                return max(0.0, time.monotonic() - ts)
            return 0.0

    def ready_count(self, schedulers=None) -> int:
        """Ready evals, optionally filtered to scheduler types — the
        BatchWorker's adaptive batch sizing reads this as the backlog
        signal (saturated: batch for throughput; keeping up: batch
        for latency)."""
        with self._lock:
            return sum(
                len(q)
                for name, q in self._ready.items()
                if schedulers is None or name in schedulers
            )

    def failed(self) -> List[Evaluation]:
        q = self._ready.get(FAILED_QUEUE)
        return [e for _, _, e in q.heap] if q else []
