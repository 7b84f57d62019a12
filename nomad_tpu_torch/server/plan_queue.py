"""Plan queue (reference nomad/plan_queue.go): priority heap of pending
plans awaiting the serialized applier; each entry carries a future the
submitting worker blocks on.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import List, Optional, Tuple

from ..raft import NotLeaderError
from ..structs import Plan, PlanResult


class PendingPlan:
    def __init__(self, plan: Plan) -> None:
        self.plan = plan
        self._event = threading.Event()
        self._result: Optional[PlanResult] = None
        self._error: Optional[Exception] = None

    def respond(
        self, result: Optional[PlanResult], error: Optional[Exception]
    ) -> None:
        self._result = result
        self._error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> PlanResult:
        if not self._event.wait(timeout):
            raise TimeoutError("plan apply timed out")
        if self._error is not None:
            raise self._error
        return self._result


class PlanQueue:
    def __init__(self) -> None:
        self._lock = threading.Condition()
        self._enabled = False
        self._heap: List[Tuple[int, int, PendingPlan]] = []
        self._counter = itertools.count()
        self.stats = {"depth": 0}

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                self.flush()
            self._lock.notify_all()

    def flush(self) -> None:
        # the queue only runs on a leader: a flush IS a leadership
        # (or lifecycle) boundary, and pending submitters must nack
        # their evals for redelivery rather than fail them
        for _, _, pending in self._heap:
            pending.respond(None, NotLeaderError(None))
        self._heap = []
        self.stats["depth"] = 0

    def enqueue(self, plan: Plan) -> PendingPlan:
        with self._lock:
            if not self._enabled:
                raise NotLeaderError(None)
            pending = PendingPlan(plan)
            heapq.heappush(
                self._heap,
                (-plan.priority, next(self._counter), pending),
            )
            self.stats["depth"] += 1
            self._lock.notify_all()
            return pending

    def dequeue(self, timeout: Optional[float] = None) -> Optional[PendingPlan]:
        with self._lock:
            if not self._heap:
                self._lock.wait(timeout)
            if not self._heap:
                return None
            _, _, pending = heapq.heappop(self._heap)
            self.stats["depth"] -= 1
            return pending
