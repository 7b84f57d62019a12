"""Pipelined plan applier (reference nomad/plan_apply.go).

Plans dequeue in priority order, every touched node is re-verified
against current state (evaluateNodePlan:629 re-runs AllocsFit), and the
feasible subset commits through the store's plan-results write path
(partial commits set a refresh index so the submitting worker retries on
fresh state).  Two reference mechanisms are reproduced:

* **Pipelining** (plan_apply.go:45-70): a verifier thread checks plan
  N+1 against an *optimistic* view — base state plus the results of
  plans that are verified but whose (possibly raft-replicated) apply is
  still in flight — while a second thread commits plan N.  Commits stay
  strictly ordered; only verification overlaps the apply latency, which
  matters exactly when the store is a raft facade with real replication
  RTTs (server/cluster.py).  If an apply fails, the overlay epoch bumps
  and any staged result is re-verified against real state before it may
  commit, so optimism never leaks into the log.
* **EvaluatePool** (plan_apply_pool.go:18): per-node verification fans
  out across a thread pool (size cores/2) when a plan touches enough
  nodes to pay for the dispatch.
"""
from __future__ import annotations

import os
import queue as _queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from ..raft import NotLeaderError
from ..state.store import StateStore
from ..trace import TRACE
from ..structs import (
    Allocation,
    NetworkIndex,
    Node,
    Plan,
    PlanResult,
    allocs_fit,
)


def _csi_requests(store, alloc: Allocation):
    """(request, (namespace, source)) pairs for an alloc's CSI volume
    requests — the one shared lookup walk behind both optimistic and
    commit-time claim verification."""
    job = alloc.job or store.job_by_id(alloc.namespace, alloc.job_id)
    tg = job.lookup_task_group(alloc.task_group) if job else None
    for req in tg.volumes.values() if tg else ():
        if req.type == "csi":
            yield req, (alloc.namespace, req.source)


def _claim_verdict(vol, alloc: Allocation, read_only: bool) -> str:
    """'held' if the alloc already claims the volume, 'free' if a new
    claim would fit, 'full' otherwise.  Single source of truth for the
    claim rules both verification passes apply."""
    if vol is None:
        return "full"
    if alloc.id in vol.read_claims or alloc.id in vol.write_claims:
        return "held"
    return "free" if vol.claimable(read_only) else "full"


class OptimisticState:
    """Base store + verified-but-uncommitted PlanResults, the view the
    verifier uses while earlier applies are in flight (reference
    plan_apply.go:45-70 — the leader's optimistic snapshot carries plan
    N's results while plan N's raft future is outstanding).

    Every overlay is applied idempotently by alloc id, so a result that
    commits mid-verification (and thus shows up in both the base store
    and the overlay) is counted once.
    """

    def __init__(self, store: StateStore, results: List[PlanResult]) -> None:
        self._store = store
        self._results = results

    def __getattr__(self, name):
        return getattr(self._store, name)

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        by_id = {a.id: a for a in self._store.allocs_by_node(node_id)}
        for result in self._results:
            for alloc in result.node_update.get(node_id, ()):
                by_id[alloc.id] = alloc
            for alloc in result.node_preemptions.get(node_id, ()):
                by_id[alloc.id] = alloc
            for alloc in result.node_allocation.get(node_id, ()):
                by_id[alloc.id] = alloc
        return list(by_id.values())

    def csi_volume_by_id(self, namespace: str, volume_id: str):
        vol = self._store.csi_volume_by_id(namespace, volume_id)
        if vol is None or not self._results:
            return vol
        import copy

        vol = copy.deepcopy(vol)
        for result in self._results:
            for node_allocs in result.node_allocation.values():
                for alloc in node_allocs:
                    for req, key in _csi_requests(self._store, alloc):
                        if key != (namespace, volume_id):
                            continue
                        if _claim_verdict(
                            vol, alloc, req.read_only
                        ) == "free":
                            vol.claim(
                                alloc.id, alloc.node_id, req.read_only
                            )
        return vol


class EvaluatePool:
    """Per-node plan verification fan-out (reference
    plan_apply_pool.go:18 EvaluatePool, sized cores/2).

    The same pool shape backs the BatchWorker's optimistic parallel
    replay: ``submit`` exposes the raw executor so a wave of
    speculative eval replays can fan out across it without a second
    thread-pool implementation."""

    # below this many nodes the dispatch overhead beats the win
    MIN_FANOUT = 4

    def __init__(
        self, workers: Optional[int] = None,
        thread_name_prefix: str = "plan-eval",
    ) -> None:
        self.workers = workers or max(1, (os.cpu_count() or 2) // 2)
        self.closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers,
            thread_name_prefix=thread_name_prefix,
        )

    def submit(self, fn, *args, **kwargs):
        """Schedule arbitrary work on the pool; returns the Future."""
        return self._pool.submit(fn, *args, **kwargs)

    def evaluate_nodes(
        self, store, plan: Plan, node_ids: List[str]
    ) -> Dict[str, Tuple[bool, str]]:
        if len(node_ids) < self.MIN_FANOUT:
            return {
                nid: evaluate_node_plan(store, plan, nid)
                for nid in node_ids
            }
        futures = {
            nid: self._pool.submit(evaluate_node_plan, store, plan, nid)
            for nid in node_ids
        }
        return {nid: fut.result() for nid, fut in futures.items()}

    def shutdown(self) -> None:
        self.closed = True
        self._pool.shutdown(wait=False)


def evaluate_node_plan(
    store: StateStore, plan: Plan, node_id: str
) -> Tuple[bool, str]:
    """Whether the plan's changes to one node fit
    (reference plan_apply.go:629 evaluateNodePlan)."""
    # evict-only plans always fit: they only remove things
    # (reference plan_apply.go:631)
    if not plan.node_allocation.get(node_id):
        return True, ""

    node = store.node_by_id(node_id)
    if node is None:
        return False, "node does not exist"
    if node.status != "ready":
        return False, "node is not ready for placements"
    if node.scheduling_eligibility != "eligible":
        return False, "node is not eligible"
    if node.drain:
        return False, "node is draining"

    proposed = [
        a
        for a in store.allocs_by_node(node_id)
        if not a.terminal_status()
    ]
    remove_ids = {a.id for a in plan.node_update.get(node_id, ())}
    remove_ids |= {a.id for a in plan.node_preemptions.get(node_id, ())}
    proposed = [a for a in proposed if a.id not in remove_ids]
    by_id = {a.id: a for a in proposed}
    for alloc in plan.node_allocation.get(node_id, ()):
        by_id[alloc.id] = alloc
    fit, dim, _util = allocs_fit(node, list(by_id.values()))
    return fit, dim


def evaluate_plan(
    store: StateStore, plan: Plan, pool: Optional[EvaluatePool] = None
) -> Tuple[PlanResult, bool]:
    """Verify the plan per node; returns (result, fully_committed)
    (reference plan_apply.go:400 evaluatePlan).  With a pool, per-node
    checks fan out concurrently (plan_apply.go:437
    evaluatePlanPlacements + EvaluatePool)."""
    result = PlanResult(
        node_update={},
        node_allocation={},
        node_preemptions={},
        deployment=plan.deployment,
        deployment_updates=list(plan.deployment_updates),
    )
    node_ids = (
        set(plan.node_update)
        | set(plan.node_allocation)
        | set(plan.node_preemptions)
    )
    verdicts: Optional[Dict[str, Tuple[bool, str]]] = None
    if pool is not None and not plan.all_at_once:
        verdicts = pool.evaluate_nodes(store, plan, sorted(node_ids))
    partial = False
    for node_id in sorted(node_ids):
        fit, _reason = (
            verdicts[node_id]
            if verdicts is not None
            else evaluate_node_plan(store, plan, node_id)
        )
        if fit:
            if plan.node_update.get(node_id):
                result.node_update[node_id] = plan.node_update[node_id]
            if plan.node_allocation.get(node_id):
                result.node_allocation[node_id] = plan.node_allocation[
                    node_id
                ]
            if plan.node_preemptions.get(node_id):
                result.node_preemptions[node_id] = plan.node_preemptions[
                    node_id
                ]
        else:
            partial = True
            if plan.all_at_once:
                # reject everything (reference plan_apply.go:514)
                result.node_update = {}
                result.node_allocation = {}
                result.node_preemptions = {}
                result.deployment = None
                result.deployment_updates = []
                break
    if not _verify_csi_claims(store, result):
        partial = True
    if partial:
        result.refresh_index = store.latest_index()
        # a partial commit must not carry deployment mutations computed
        # against the full plan (reference plan_apply.go:447)
        result.deployment = None
        result.deployment_updates = []
    return result, not partial


def _verify_csi_claims(store: StateStore, result: PlanResult) -> bool:
    """Drop placements whose CSI volume claims cannot all be satisfied
    (the applier is the claim's linearization point: feasibility ran
    against claim-free snapshots, so two optimistic placements can race
    for the last writer slot — the loser is rejected here and its eval
    refreshed, exactly like a node-capacity conflict)."""
    import copy

    sim: Dict[Tuple[str, str], object] = {}
    ok = True
    for node_id in sorted(result.node_allocation):
        kept = []
        for alloc in result.node_allocation[node_id]:
            fits = True
            claimed = []
            for req, key in _csi_requests(store, alloc):
                vol = sim.get(key)
                if vol is None:
                    vol = store.csi_volume_by_id(*key)
                    if vol is not None:
                        vol = copy.deepcopy(vol)
                        sim[key] = vol
                verdict = _claim_verdict(vol, alloc, req.read_only)
                if verdict == "full":
                    fits = False
                    break
                if verdict == "free":
                    claimed.append((vol, req.read_only))
            if fits:
                for vol, read_only in claimed:
                    vol.claim(alloc.id, alloc.node_id, read_only)
                kept.append(alloc)
            else:
                ok = False
        if len(kept) != len(result.node_allocation[node_id]):
            if kept:
                result.node_allocation[node_id] = kept
            else:
                del result.node_allocation[node_id]
    return ok


class PlanApplier:
    """Verifier + committer pipeline with capacity-change fanout to
    blocked evals.  Commits are strictly serialized and ordered; the
    verifier runs one (or two, counting the staged slot) plans ahead
    against an `OptimisticState` overlay."""

    def __init__(
        self,
        store: StateStore,
        plan_queue,
        blocked=None,
        metrics=None,
        pool: Optional[EvaluatePool] = None,
        leader_check: Optional[Callable[[], bool]] = None,
    ) -> None:
        self.store = store
        self.plan_queue = plan_queue
        self.blocked = blocked
        self.metrics = metrics
        self.pool = pool if pool is not None else EvaluatePool()
        # leadership fence: when set and False, in-flight plans are
        # rejected with NotLeaderError instead of committing — the
        # submitting worker converts that to nack-for-redelivery, so
        # the eval is re-run by whoever holds leadership next
        # (reference plan_apply.go: the applier only runs on the
        # leader; here the check closes the revoke race window)
        self._leader_check = leader_check
        # _stop and _staged are REPLACED on every start(): a committer
        # from a previous leadership term that outlived stop()'s join
        # timeout (e.g. blocked >2s in a raft apply) keeps its own
        # generation's event+queue and can never race the new threads
        # for staged plans or observe the cleared stop flag
        self._stop = threading.Event()
        self._verify_thread: Optional[threading.Thread] = None
        self._commit_thread: Optional[threading.Thread] = None
        # staged slot between verify and commit: depth 1 keeps at most
        # two optimistic results outstanding (one staged, one verifying)
        self._staged: _queue.Queue = _queue.Queue(maxsize=1)
        self._lock = threading.Lock()
        self._inflight: List[PlanResult] = []
        self._epoch = 0  # bumped when an apply fails
        self.applied = 0
        self.overlap_verifies = 0  # verifications that ran on an overlay

    def start(self) -> None:
        # re-entrant after stop() (leadership can be re-established,
        # reference leader.go:222): fresh stop event + staged queue per
        # generation, fresh pool, no stale staged results
        self._flush_staged()
        self._stop = threading.Event()
        self._staged = _queue.Queue(maxsize=1)
        if self.pool.closed:
            self.pool = EvaluatePool(self.pool.workers)
        with self._lock:
            self._inflight = []
        self._verify_thread = threading.Thread(
            target=self._verify_loop,
            args=(self._stop, self._staged),
            name="plan-verifier",
            daemon=True,
        )
        self._commit_thread = threading.Thread(
            target=self._commit_loop,
            args=(self._stop, self._staged),
            name="plan-applier",
            daemon=True,
        )
        self._verify_thread.start()
        self._commit_thread.start()

    def stop(self) -> None:
        self._stop.set()
        for t in (self._verify_thread, self._commit_thread):
            if t is not None:
                t.join(timeout=2.0)
        self._flush_staged()
        self.pool.shutdown()

    def _flush_staged(self) -> None:
        while True:
            try:
                pending, _r, _f, _e = self._staged.get_nowait()
                pending.respond(None, NotLeaderError(None))
            except _queue.Empty:
                return

    # ------------------------------------------------------------------
    # stage 1: verification (overlapped with stage-2 commits)
    # ------------------------------------------------------------------

    def _not_leader(self) -> bool:
        return self._leader_check is not None and not self._leader_check()

    def _reject_not_leader(self, pending) -> None:
        if self.metrics is not None:
            self.metrics.incr("leadership.plan_rejected")
        if pending.plan.eval_id:
            TRACE.event(pending.plan.eval_id, "plan.not_leader")
        pending.respond(None, NotLeaderError(None))

    def _verify_loop(self, stop: threading.Event,
                     staged_q: _queue.Queue) -> None:
        while not stop.is_set():
            pending = self.plan_queue.dequeue(timeout=0.1)
            if pending is None:
                continue
            if self._not_leader():
                # leadership revoked with this plan in flight: reject
                # before any verification work — the worker nacks the
                # eval for redelivery under the next leadership
                self._reject_not_leader(pending)
                continue
            import time as _time

            start = _time.monotonic()
            with self._lock:
                overlay = list(self._inflight)
                epoch = self._epoch
            state = (
                OptimisticState(self.store, overlay)
                if overlay
                else self.store
            )
            try:
                result, full = evaluate_plan(state, pending.plan, self.pool)
            except Exception as exc:  # noqa: BLE001
                pending.respond(None, exc)
                continue
            if overlay:
                self.overlap_verifies += 1
                if self.metrics is not None:
                    self.metrics.incr("plan.overlap_verify")
            verify_dt = _time.monotonic() - start
            if self.metrics is not None:
                # (reference plan_apply.go:401 plan.evaluate timing)
                self.metrics.add_sample(
                    "plan.evaluate", verify_dt * 1000.0,
                    exemplar=pending.plan.eval_id or None,
                )
            # flight recorder: the verification interval on the
            # submitting eval's trace (applier-thread attribution)
            if pending.plan.eval_id:
                TRACE.add_span(
                    pending.plan.eval_id, "plan.evaluate",
                    start, verify_dt,
                    overlay=bool(overlay), full=full,
                )
            with self._lock:
                self._inflight.append(result)
            # blocks while the committer still holds an earlier plan:
            # that wait IS the pipeline bubble the overlap hides
            staged = False
            while not stop.is_set():
                try:
                    staged_q.put(
                        (pending, result, full, epoch), timeout=0.1
                    )
                    staged = True
                    break
                except _queue.Full:
                    continue
            if not staged:
                # shutdown raced the hand-off: fail fast like every
                # other flush path instead of leaving the submitter
                # to hit its wait timeout
                with self._lock:
                    self._remove_inflight_locked(result)
                pending.respond(None, NotLeaderError(None))

    # ------------------------------------------------------------------
    # stage 2: ordered commit
    # ------------------------------------------------------------------

    def _commit_loop(self, stop: threading.Event,
                     staged_q: _queue.Queue) -> None:
        while not stop.is_set():
            try:
                pending, result, full, epoch = staged_q.get(
                    timeout=0.1
                )
            except _queue.Empty:
                continue
            if self._not_leader():
                # staged between verify and commit when leadership
                # moved: the optimistic result must never reach the
                # store (a new leader owns that state now)
                with self._lock:
                    self._remove_inflight_locked(result)
                self._reject_not_leader(pending)
                continue
            try:
                with self._lock:
                    stale = epoch != self._epoch
                if stale:
                    # an earlier apply failed after this plan was
                    # verified optimistically: re-verify on real state
                    result2, full = evaluate_plan(
                        self.store, pending.plan, self.pool
                    )
                    with self._lock:
                        for i, r in enumerate(self._inflight):
                            if r is result:
                                self._inflight[i] = result2
                                break
                        # the re-verification may have changed this
                        # result's effect, so verifications that used
                        # the old one are invalid too: bump the epoch
                        # so they also re-verify before committing
                        self._epoch += 1
                    result = result2
                self._commit(pending.plan, result, full)
                with self._lock:
                    self._remove_inflight_locked(result)
                pending.respond(result, None)
            except Exception as exc:  # noqa: BLE001
                # bump + remove under ONE lock acquisition, so the
                # verifier can never snapshot the new epoch together
                # with an overlay still containing the failed result
                with self._lock:
                    self._epoch += 1
                    self._remove_inflight_locked(result)
                pending.respond(None, exc)

    def _remove_inflight_locked(self, result: PlanResult) -> None:
        for i, r in enumerate(self._inflight):
            if r is result:
                del self._inflight[i]
                break

    def _commit(self, plan: Plan, result: PlanResult, full: bool) -> None:
        import time as _time

        start = _time.monotonic()
        if (
            result.node_update
            or result.node_allocation
            or result.node_preemptions
            or result.deployment is not None
            or result.deployment_updates
        ):
            # the producing wave's captured generation, passed only
            # when stamped (so store facades without the kwarg keep
            # working for unstamped plans): the replicated fence must
            # judge the plan by the leadership it RAN under, not by
            # whoever leads when it reaches the store
            gen = getattr(plan, "leader_gen", None)
            if gen is not None:
                index = self.store.upsert_plan_results(
                    result, plan.eval_id, leader_gen=gen
                )
            else:
                index = self.store.upsert_plan_results(
                    result, plan.eval_id
                )
            result.alloc_index = index
            self.applied += 1
            self._notify_capacity_change(result, index)
            # flight recorder: the commit interval + committed index
            # close the eval's write path (dequeue -> ... -> commit)
            if plan.eval_id:
                TRACE.add_span(
                    plan.eval_id, "plan.apply", start,
                    _time.monotonic() - start, index=index,
                )
        if self.metrics is not None:
            # (reference plan_apply.go:185 plan.evaluate/apply timings)
            self.metrics.add_sample(
                "plan.apply", (_time.monotonic() - start) * 1000.0,
                exemplar=plan.eval_id or None,
            )
            self.metrics.incr("plan.applied")
            if not full:
                self.metrics.incr("plan.partial_commit")

    def apply(self, plan: Plan) -> PlanResult:
        """Synchronous verify+commit (test/tooling path; production
        traffic flows through the two pipeline threads)."""
        result, full = evaluate_plan(self.store, plan, self.pool)
        self._commit(plan, result, full)
        return result

    def _notify_capacity_change(self, result: PlanResult, index: int) -> None:
        """Stopped/preempted allocs free capacity: unblock their node
        classes (reference blocked_evals.go:watchCapacity wiring in
        nomad/plan_apply.go + state store)."""
        if self.blocked is None:
            return
        freed_nodes = set(result.node_update) | set(result.node_preemptions)
        for node_id in freed_nodes:
            node = self.store.node_by_id(node_id)
            if node is not None:
                self.blocked.unblock(node.computed_class, index)
