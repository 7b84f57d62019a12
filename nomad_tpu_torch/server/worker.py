"""Scheduling worker (reference nomad/worker.go).

Each worker loops: dequeue an eval from the broker, fence the state at
the eval's modify index (snapshot_min_index, worker.go:228), run the
registered scheduler for the eval type on the server's device, and
ack/nack.  The worker is the
scheduler's `Planner`: plans go to the plan queue and the worker blocks
for the applier's verdict; a partial commit hands back a refreshed
snapshot so the scheduler retries against fresh state (worker.go:277-339
SubmitPlan / RefreshIndex).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from ..device import DeviceFault
from ..explain import EXPLAIN
from ..raft import NotLeaderError
from ..sched import new_scheduler
from ..state.store import StateSnapshot, StateStore
from ..structs import Evaluation, Plan, PlanResult
from ..trace import TRACE


class Worker:
    def __init__(
        self,
        server,
        schedulers: Optional[List[str]] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.server = server
        self.store: StateStore = server.store
        # the port registers the service and batch schedulers only
        self.schedulers = schedulers or ["service", "batch"]
        self.seed = seed
        # where the device stack runs: the server's resolved device
        # (the CUDA card, or the CPU when the server was built with
        # device="cpu")
        self.device = server.device
        # when True, sequential eval processing uses the exact host
        # stack even with the device scheduler enabled.  The BatchWorker
        # sets it: its fallbacks are precisely the shapes where
        # batching didn't apply, and a per-select device round trip
        # per pick loses to the host oracle there (decisions are
        # bit-identical either way)
        self.host_fallback = False
        # evals whose processing raised (each was nacked for
        # redelivery): a device fault must show here, not loop as
        # silent redeliveries
        self.errors = 0
        # the DeviceFault that stopped this worker;
        # Server.drain_to_idle raises it
        self.fault: Optional[BaseException] = None
        # the watchdog trip this worker met and drain_to_idle has not
        # raised yet (the batch worker's guarded stages; the worker
        # holds afterwards instead of stopping)
        self.tripped: Optional[DeviceFault] = None
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.evals_processed = 0
        # cumulative wall seconds this worker spent BLOCKED on the
        # serialized commit plane (plan-queue verdicts, and for
        # follower fan-out workers the remote submit RPC + local-
        # apply catch-up).  Kept separate from the planning-stage
        # timings: the fan-out bench reports planning busy-time net
        # of commit waits, since commit is the part that stays
        # serialized by design while planning scales with servers.
        self.plan_wait_s = 0.0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        # leadership can be re-established on the same server (revoke
        # -> establish): the previous generation's thread must not
        # race the new one for the worker's shared pipeline state.
        # Post-revoke threads exit fast (the leadership fence aborts
        # open chains and the broker is disabled), so the join is
        # pro-forma — but a straggler that outlives it (e.g. blocked
        # in a 10s plan wait) is fenced by _current_generation(): the
        # moment self._thread points at the new thread, the old one's
        # next loop check exits it regardless of the cleared _stop.
        prev = self._thread
        if prev is not None and prev.is_alive():
            prev.join(timeout=5.0)
        # the thread name carries the owning server's address (when
        # it has one — cluster servers do) so per-thread accounting
        # (/proc/self/task/*/stat, py-spy, the fan-out bench's
        # planning-CPU attribution) can tell one server's workers
        # from another's inside a multi-server test process
        addr = getattr(self.server, "addr", "")
        thread = threading.Thread(
            target=self.run,
            name=f"worker@{addr}" if addr else "worker",
            daemon=True,
        )
        self._thread = thread
        self._stop.clear()
        thread.start()

    def _current_generation(self) -> bool:
        """Whether the calling thread is this worker's CURRENT run()
        thread.  True as well for direct run() calls outside start()
        (test harnesses)."""
        current = self._thread
        return current is None or current is threading.current_thread()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def set_pause(self, paused: bool) -> None:
        """Leaders pause half their workers to favor broker/plan work
        (reference leader.go establishLeadership)."""
        if paused:
            self._paused.set()
        else:
            self._paused.clear()

    def _held(self) -> bool:
        """True while the server's device supervisor holds every worker
        (the card is LOST or RECOVERING).  Separate from set_pause:
        leadership's un-pause must not release a held worker."""
        sup = getattr(self.server, "device_supervisor", None)
        return sup is not None and sup.holding()

    def run(self) -> None:
        while not self._stop.is_set() and self._current_generation():
            if self._paused.is_set() or self._held():
                self._stop.wait(0.05)
                continue
            ev, token = self.server.broker.dequeue(
                self.schedulers, timeout=0.1
            )
            if ev is None:
                continue
            if self._held():
                # the hold began while this dequeue waited: hand the
                # eval back untouched (its place at the head, no
                # delivery counted) rather than run it on a card the
                # supervisor has lost
                try:
                    self.server.broker.release(ev.id, token)
                except ValueError:
                    pass
                continue
            try:
                self.process_eval(ev, token)
            except DeviceFault as exc:
                # the per-eval device stack failed (a kernel's build,
                # launch or fetch): stop here, the eval
                # nacked once, and leave the fault for drain_to_idle to
                # raise — redelivering it would only fail it again
                self.errors += 1
                self.fault = exc
                self._stop.set()
                try:
                    self.server.broker.nack(ev.id, token)
                except ValueError:
                    pass
                return
            except Exception:  # noqa: BLE001
                self.errors += 1
                try:
                    self.server.broker.nack(ev.id, token)
                except ValueError:
                    pass

    # -- one eval ------------------------------------------------------

    def process_eval(self, ev: Evaluation, token: str) -> None:
        try:
            snap = self.store.snapshot_min_index(
                max(ev.modify_index, ev.snapshot_index), timeout=5.0
            )
        except TimeoutError:
            self.server.broker.nack(ev.id, token)
            return
        # stamp the state fence, so a later Block() can tell whether a
        # capacity change arrived after this scheduling pass (reference
        # worker.go:277 attaches SnapshotIndex to submitted plans)
        ev.snapshot_index = snap.index
        self._eval_token = token
        self._pending_evals: List[Evaluation] = []
        metrics = getattr(self.server, "metrics", None)
        use_device = (
            self.store.get_scheduler_config().tpu_scheduler_enabled
            and not self.host_fallback
        )
        scheduler = new_scheduler(
            ev.type, snap, self, seed=self.seed,
            use_device=use_device,
            device=self.device if use_device else None,
        )
        import time as _time

        start = _time.monotonic()
        try:
            with TRACE.span(
                ev.id, "worker.invoke_scheduler",
                type=ev.type,
                speculative=getattr(scheduler, "speculative", False),
            ):
                scheduler.process(ev)
        except NotLeaderError:
            # leadership moved while this eval was in flight (the plan
            # applier rejected the plan, or the replicated fence
            # tripped): nack for redelivery — the next leader's broker
            # re-runs it against restored state.  Not an error.
            try:
                self.server.broker.nack(ev.id, token)
            except ValueError:
                pass  # the revoke flush already unacked the lease
            return
        except Exception:  # noqa: BLE001
            self.server.broker.nack(ev.id, token)
            raise
        if metrics is not None:
            # (reference worker.go:245 invoke_scheduler timing)
            metrics.add_sample(
                f"worker.invoke_scheduler_{ev.type}",
                (_time.monotonic() - start) * 1000.0,
            )
            metrics.incr("worker.evals_processed")
        # placement explainability: retain this eval's per-TG score
        # decomposition + filter attribution
        EXPLAIN.record_eval(ev, scheduler, metrics)
        self.evals_processed += 1
        self.server.broker.ack(ev.id, token)

    # -- Planner interface (scheduler.go:112) --------------------------

    def submit_plan(
        self, plan: Plan
    ) -> Tuple[PlanResult, Optional[StateSnapshot]]:
        import time as _time

        if getattr(plan, "leader_gen", None) is None:
            # serial paths stamp the current generation at submit
            # time (their plans cannot straggle across a leadership
            # change: the plan queue flush kills them on revoke);
            # wave commits stamp their captured generation upstream
            plan.leader_gen = getattr(
                self.server, "_leadership_gen", None
            )
        plan.snapshot_index = self.store.latest_index()
        t0 = _time.monotonic()
        try:
            pending = self.server.plan_queue.enqueue(plan)
            result = pending.wait(timeout=10.0)
            if result is None:
                raise RuntimeError("plan rejected")
            if result.refresh_index:
                snap = self.store.snapshot_min_index(
                    result.refresh_index
                )
                return result, snap
            return result, None
        finally:
            self.plan_wait_s += _time.monotonic() - t0

    def update_eval(self, ev: Evaluation) -> None:
        self.store.upsert_evals([ev])
        self.server.on_eval_update(ev)

    def create_eval(self, ev: Evaluation) -> None:
        self.store.upsert_evals([ev])
        self.server.on_eval_update(ev)

    def reblock_eval(self, ev: Evaluation) -> None:
        self.store.upsert_evals([ev])
        self.server.blocked.block(ev)
