"""Sacrificial-thread bounded calls + per-stage watchdog budgets.  Port
of `nomad_tpu/device/watchdog.py`.

A wedged device call does not raise — it *blocks*, indefinitely,
inside a C call no Python-level timeout can interrupt (a
``cudaEventSynchronize`` on a kernel that never finishes, a driver call
behind a hung context).  The only robust in-process containment is to
run the possibly-wedging call on a disposable thread and, when the
deadline passes, *abandon* the thread: the caller gets a
``DeviceTimeout`` and the sacrificial thread stays parked inside the
wedged call until process exit (it is a daemon).

Budgets come from an EWMA of the stage's own observed latency — a
launch that exceeds its historical cost by ``factor`` is wedged, not
slow — clamped to an operator-configurable [min, max] band so the first
launch (no history) and pathological EWMAs stay bounded.

The port's departures: ``DeviceTimeout`` is a ``DeviceFault``, so every
``except DeviceFault`` path of the workers meets a trip; and a deadline
does not count the time the cyclic garbage collector held the
interpreter during the call.  A full collection over a large store
stops the guarded stage with every other thread for seconds on a slow
host, and that pause is the host's, not the device's: counted, it
trips a healthy card.
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Dict, Optional

from .core import DeviceFault

_UNSET = object()


class DeviceTimeout(DeviceFault):
    """A guarded device call exceeded its watchdog budget."""

    def __init__(self, stage: str, budget_s: float) -> None:
        super().__init__(
            f"device stage {stage!r} exceeded its {budget_s:.2f}s "
            "watchdog budget (wedged device?)"
        )
        self.stage = stage
        self.budget_s = budget_s


# how often an idle runner checks that the thread it serves still lives
_IDLE_CHECK_S = 1.0

# the garbage collector's time in this process, kept by a `gc.callbacks`
# hook installed with the first guarded call: (seconds of the finished
# collections, the start of a running one or None), one tuple so that
# another thread reads both at once
_COLLECTOR = (0.0, None)
_COLLECTOR_HOOKED = False


def _on_collection(phase: str, _info: dict) -> None:
    global _COLLECTOR
    total, since = _COLLECTOR
    if phase == "start":
        _COLLECTOR = (total, time.monotonic())
    elif since is not None:
        _COLLECTOR = (total + time.monotonic() - since, None)


def collector_seconds() -> float:
    """Seconds spent in the garbage collector since the first call, a
    running collection's so far included: a waiter may run between the
    hooks at its start and at its end."""
    global _COLLECTOR_HOOKED
    if not _COLLECTOR_HOOKED:
        _COLLECTOR_HOOKED = True
        # first, so that the other hooks' time counts too
        gc.callbacks.insert(0, _on_collection)
    total, since = _COLLECTOR
    return total if since is None else total + time.monotonic() - since


class _Runner:
    """One reusable sacrificial worker thread.  A healthy guarded call
    costs an Event handoff, not a thread spawn — the disposable-thread
    property is only needed when a deadline actually trips, at which
    point the runner is marked dead (its thread may be parked inside a
    wedged call forever) and the caller mints a replacement.

    The port's departure: between calls the runner holds nothing of the
    last call (its callable's closure would keep a stopped Server and
    its whole store alive), and it exits once the thread it serves has
    ended, so a stopped Server leaves no parked runner behind."""

    __slots__ = ("_submit", "_box", "dead", "_thread", "_owner")

    def __init__(self, name: str) -> None:
        self._submit = threading.Event()
        self._box: Optional[dict] = None
        self.dead = False
        self._owner = threading.current_thread()
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            while not self._submit.wait(_IDLE_CHECK_S):
                if not self._owner.is_alive():
                    return
            self._submit.clear()
            box, self._box = self._box, None
            if box is None:
                continue
            try:
                box["result"] = box["fn"]()
            except BaseException as exc:  # noqa: BLE001 — re-raised
                box["error"] = exc
            finally:
                box["done"].set()
                box = None

    def call(self, fn: Callable, timeout_s: float, stage: str):
        box: dict = {"fn": fn, "done": threading.Event()}
        self._box = box
        t0 = time.monotonic()
        collected0 = collector_seconds()
        self._submit.set()
        wait_s = timeout_s
        while not box["done"].wait(wait_s):
            # the deadline moves by the collector's pauses since the call
            wait_s = (timeout_s + collector_seconds() - collected0
                      - (time.monotonic() - t0))
            if wait_s <= 0:
                # wedged mid-call: abandon this runner (never joined —
                # the thread may be stuck inside a blocked device call
                # forever)
                self.dead = True
                raise DeviceTimeout(stage, timeout_s)
        err = box.get("error", _UNSET)
        if err is not _UNSET:
            raise err
        return box.get("result")


_TLS = threading.local()


def bounded_call(
    fn: Callable, timeout_s: float, name: str = "device-bounded",
    stage: str = "call",
):
    """Run ``fn()`` on a sacrificial daemon thread, waiting at most
    ``timeout_s``.  On timeout the thread is abandoned (never joined)
    and ``DeviceTimeout`` is raised; otherwise the callable's result or
    exception propagates.

    The worker is per-calling-thread and REUSED across calls, so the
    hot pipeline path pays an Event handoff instead of a thread spawn;
    only a tripped deadline burns the thread (a new one is minted on
    the next call).  PyTorch's current stream is per thread: a callable
    that launches work enters its stream itself."""
    runner: Optional[_Runner] = getattr(_TLS, "runner", None)
    if runner is None or runner.dead:
        runner = _Runner(name)
        _TLS.runner = runner
    return runner.call(fn, timeout_s, stage)


class BudgetTracker:
    """Per-stage EWMA latency -> watchdog deadline.

    ``budget(stage)`` returns ``clamp(factor * ewma, min_s, max_s)``;
    with no history yet the floor applies (a cold first launch must not
    trip on its own kernel build)."""

    def __init__(
        self,
        factor: float = 20.0,
        min_s: float = 5.0,
        max_s: float = 120.0,
        alpha: float = 0.2,
    ) -> None:
        self.factor = factor
        self.min_s = min_s
        self.max_s = max(max_s, min_s)
        self.alpha = alpha
        self._ewma: Dict[str, float] = {}
        self._lock = threading.Lock()

    def note(self, stage: str, dt_s: float) -> None:
        with self._lock:
            prev = self._ewma.get(stage)
            self._ewma[stage] = (
                dt_s
                if prev is None
                else (1.0 - self.alpha) * prev + self.alpha * dt_s
            )

    def ewma(self, stage: str) -> Optional[float]:
        with self._lock:
            return self._ewma.get(stage)

    def budget(self, stage: str) -> float:
        with self._lock:
            ewma = self._ewma.get(stage)
        if ewma is None:
            return self.min_s
        return min(self.max_s, max(self.min_s, self.factor * ewma))

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            stages = dict(self._ewma)
        return {
            stage: {
                "ewma_s": round(ewma, 6),
                "budget_s": round(self.budget(stage), 6),
            }
            for stage, ewma in stages.items()
        }
