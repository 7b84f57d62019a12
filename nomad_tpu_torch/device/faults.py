"""Deterministic device fault injection.  Port of
`nomad_tpu/device/faults.py`, with the same kinds and hook points.

Every DeviceSupervisor transition must be testable on a CPU-only box —
the whole point of the supervisor is surviving failure modes that only
real (wedged) hardware exhibits.  ``NOMAD_TPU_FAULT`` arms a fault plan
that the supervisor's guard/canary paths consult at well-defined
points:

  wedge_launch      the launch stage AND the canary block forever (a
                    wedged device: calls never return) — drives
                    watchdog trips and keeps the device LOST
  slow_fetch        the fetch stage sleeps past its watchdog budget but
                    eventually completes (a device stalling under
                    contention) — trips the deadline monitor while the
                    sacrificial thread finishes harmlessly
  init_block        the canary blocks forever (device init hangs).  A
                    parked canary blocks every later attempt too (the
                    supervisor's single-flight canary) — use ``flaky``
                    for recoverable-failure scenarios
  flaky[:N]         the first N canary calls fail fast (default 3 —
                    exactly enough to walk HEALTHY -> DEGRADED -> LOST
                    with the default thresholds), then succeed, driving
                    the LOST -> RECOVERING -> HEALTHY round trip

Kinds compose as a comma list (``wedge_launch,flaky:2``).  Wedges park
on a shared stop event instead of a raw sleep so supervisor shutdown
releases every abandoned sacrificial thread promptly.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

# how long a "forever" wedge parks before giving up and erroring out
# (bounded only so abandoned threads cannot outlive long processes)
WEDGE_S = 3600.0
FAULT_ENV = "NOMAD_TPU_FAULT"
KNOWN_KINDS = ("wedge_launch", "slow_fetch", "init_block", "flaky")


class InjectedFault(Exception):
    """A deterministic injected failure (never raised in production)."""


class FaultPlan:
    """Parsed ``NOMAD_TPU_FAULT`` plan consulted by the supervisor."""

    def __init__(self, kinds: Optional[Dict[str, Optional[float]]] = None) -> None:
        self.kinds: Dict[str, Optional[float]] = dict(kinds or {})
        self._canary_calls = 0
        self._lock = threading.Lock()
        # wedges wait on this instead of sleeping so supervisor.stop()
        # releases every parked sacrificial thread
        self.stop_event = threading.Event()

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "FaultPlan":
        raw = (env if env is not None else os.environ).get(
            FAULT_ENV, ""
        ).strip()
        kinds: Dict[str, Optional[float]] = {}
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, param = part.partition(":")
            if name not in KNOWN_KINDS:
                # an unknown kind must be loud: a typo silently testing
                # nothing is worse than a crash in a test-only path
                raise ValueError(
                    f"unknown {FAULT_ENV} kind {name!r} "
                    f"(known: {', '.join(KNOWN_KINDS)})"
                )
            kinds[name] = float(param) if param else None
        return cls(kinds)

    @property
    def active(self) -> bool:
        return bool(self.kinds)

    def describe(self) -> List[str]:
        return [
            name if param is None else f"{name}:{param:g}"
            for name, param in sorted(self.kinds.items())
        ]

    def _wedge(self, what: str) -> None:
        """Park "forever" (until supervisor shutdown), then raise —
        the caller's sacrificial thread must never complete a wedged
        call successfully."""
        self.stop_event.wait(WEDGE_S)
        raise InjectedFault(f"injected wedge: {what}")

    # -- consultation points -------------------------------------------

    def stage_hook(self, stage: str, budget_s: float) -> None:
        """Called inside the sacrificial thread before the real stage
        work."""
        if stage == "launch" and "wedge_launch" in self.kinds:
            self._wedge("launch")
        if stage == "fetch" and "slow_fetch" in self.kinds:
            # slow, not wedged: outlive the budget, then finish — the
            # deadline monitor must trip even though the call would
            # eventually have returned
            param = self.kinds["slow_fetch"]
            self.stop_event.wait(
                param if param else budget_s * 1.5 + 0.1
            )

    def canary_hook(self) -> None:
        """Called inside the canary's sacrificial thread before the
        probe kernel runs."""
        with self._lock:
            self._canary_calls += 1
            n = self._canary_calls
        if "wedge_launch" in self.kinds:
            # a wedged device wedges its canaries too — the supervisor
            # must stay LOST rather than flap back onto a dead card
            self._wedge("canary")
        if "init_block" in self.kinds:
            self._wedge("canary init")
        if "flaky" in self.kinds:
            param = self.kinds["flaky"]
            limit = 3.0 if param is None else param
            if n <= limit:
                raise InjectedFault(f"injected flaky canary #{n}")
