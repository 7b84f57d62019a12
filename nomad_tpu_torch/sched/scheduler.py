"""Scheduler registry and interfaces (reference scheduler/scheduler.go).

`BUILTIN_SCHEDULERS` maps eval type -> factory (scheduler.go:23).  It is
this package's own registry, never the JAX package's.  The device
backend is not a separate type here — the generic schedulers take a
``use_device`` flag (default on) selecting between the oracle stack and
the CUDA stack, and a ``device`` that the CUDA stack runs on.  This
slice registers the service and batch schedulers only.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Protocol, TYPE_CHECKING

from ..structs import Evaluation, Plan, PlanResult

if TYPE_CHECKING:  # pragma: no cover
    from ..state.store import StateSnapshot

SCHEDULER_VERSION = 1


class SchedulerError(Exception):
    pass


class SetStatusError(SchedulerError):
    """Raised when a scheduler fails and the eval should be marked failed
    (reference scheduler.go SetStatusError)."""

    def __init__(self, err: str, eval_status: str) -> None:
        super().__init__(err)
        self.eval_status = eval_status


class Planner(Protocol):
    """The scheduler's only write path
    (reference scheduler/scheduler.go:112)."""

    def submit_plan(self, plan: Plan) -> "tuple[PlanResult, StateSnapshot]":
        ...

    def update_eval(self, evaluation: Evaluation) -> None:
        ...

    def create_eval(self, evaluation: Evaluation) -> None:
        ...

    def reblock_eval(self, evaluation: Evaluation) -> None:
        ...


BUILTIN_SCHEDULERS: Dict[str, Callable] = {}


def register_scheduler(name: str, factory: Callable) -> None:
    BUILTIN_SCHEDULERS[name] = factory


def new_scheduler(
    name: str,
    state: "StateSnapshot",
    planner: Planner,
    device=None,
    **kwargs,
):
    """Build the scheduler registered under ``name``.  ``device`` is
    where its device stack runs: ``None`` means the CUDA card (and
    raises without one), ``"cpu"`` the plain-PyTorch twins."""
    factory = BUILTIN_SCHEDULERS.get(name)
    if factory is None:
        raise SchedulerError(f"unknown scheduler {name!r}")
    return factory(state, planner, device=device, **kwargs)


def _register_builtins() -> None:
    from .generic_sched import BatchScheduler, ServiceScheduler

    register_scheduler("service", ServiceScheduler)
    register_scheduler("batch", BatchScheduler)


_register_builtins()
