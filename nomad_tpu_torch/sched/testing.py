"""Scheduler test harness (reference scheduler/testing.go:43 Harness).

A real StateStore plus an in-memory Planner that records plans/evals and
applies plans directly via `upsert_plan_results`.  This is the fixture the
whole differential-parity suite is built on (SURVEY.md section 4.2).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..state.store import StateSnapshot, StateStore
from ..structs import (
    Evaluation,
    Plan,
    PlanResult,
)


class Harness:
    def __init__(self, store: Optional[StateStore] = None) -> None:
        self.store = store or StateStore()
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.create_evals: List[Evaluation] = []
        self.reblock_evals: List[Evaluation] = []
        self.reject_plan = False
        # reject but still apply: exercises the refresh/retry path
        self.reject_and_apply = False

    # -- Planner interface ---------------------------------------------

    def submit_plan(
        self, plan: Plan
    ) -> Tuple[PlanResult, Optional[StateSnapshot]]:
        self.plans.append(plan)
        if self.reject_plan and not self.reject_and_apply:
            return PlanResult(), self.store.snapshot()

        result = PlanResult(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            node_preemptions=plan.node_preemptions,
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
            alloc_index=self.store.latest_index() + 1,
        )
        index = self.store.upsert_plan_results(result, plan.eval_id)
        result.alloc_index = index
        if self.reject_and_apply:
            return result, self.store.snapshot()
        return result, None

    def update_eval(self, evaluation: Evaluation) -> None:
        self.evals.append(evaluation)

    def create_eval(self, evaluation: Evaluation) -> None:
        self.create_evals.append(evaluation)

    def reblock_eval(self, evaluation: Evaluation) -> None:
        self.reblock_evals.append(evaluation)

    # -- helpers --------------------------------------------------------

    def snapshot(self) -> StateSnapshot:
        return self.store.snapshot()

    def process(self, factory, evaluation: Evaluation, **kwargs) -> None:
        scheduler = factory(self.snapshot(), self, **kwargs)
        scheduler.process(evaluation)
        return scheduler
