"""DeviceSupervisor: the card's liveness state machine.  Port of
`nomad_tpu/device/supervisor.py`.

One supervisor per server owns three jobs the batch pipeline must never
do inline:

1. **Health probes.**  A watchdog thread launches a tiny canary kernel
   (kernel K8, ``csrc/canary.cu``: ``a + 1`` on an 8-vector and its
   sum, bound once in ``prepare()`` to mapped pinned host memory and a
   CUDA stream of the canary's own, so a probe is one launch and a wait
   on that stream, on a sacrificial thread) on a configurable cadence,
   so a wedged card is *detected* as LOST instead of hanging whichever
   thread touches it next.

2. **Stage watchdogs.**  ``guard(stage, fn)`` wraps the batch worker's
   assemble/launch/fetch/storm_solve stages with deadline monitors; a
   stage that exceeds its EWMA-derived budget by a large factor trips
   the supervisor to LOST and raises ``DeviceTimeout`` (a
   ``DeviceFault``) into the worker.

3. **The HEALTHY -> DEGRADED -> LOST -> RECOVERING state machine**,
   with the JAX package's thresholds, counters, gauges, epochs and
   listeners.  In LOST the canary keeps probing the card; a success
   moves to RECOVERING, and after ``recover_canaries`` consecutive
   passes the supervisor flips back to HEALTHY, then runs the
   registered warm hooks.

The port's rule on LOST departs from the JAX package, which fails the
pipeline over to its CPU backend.  The port computes nothing on the
CPU:

* a watchdog trip raises ``DeviceTimeout``; the worker that met it
  nacks its leases once;
* while the state is LOST or RECOVERING, ``holding()`` is True: every
  worker of the Server holds (neither dequeues nor processes — nacking each
  dequeue would burn the broker's delivery limit and lose the eval),
  ``guard`` raises ``fault()`` without calling the stage, and
  ``Server.drain_to_idle`` raises ``fault()``;
* at the flip back to HEALTHY the listeners have flushed the workers'
  device state, the hold clears, and the held evals are placed on the
  card.

A sticky CUDA error (an illegal address, a launch failure: every later
CUDA call of the process fails) keeps the canary failing, so the
supervisor stays LOST, and the port does nothing about it: no
``cudaDeviceReset`` (PyTorch's tensors would dangle) and no retry on the
CPU.  Restarting the process is the recovery.

State is exported as the ``device.state`` gauge and ``status()``; the
incident trace and decision records go to the port's TRACE and
DECISIONS (no-op until those modules are ported).

Env knobs (equivalents in ``config.DeviceConfig``):

  NOMAD_TPU_SUPERVISOR         1 forces supervision on (0 off) even for
                               a CPU server — the fault-injection tests
                               run this way
  NOMAD_TPU_PROBE_INTERVAL_S   canary cadence (default 30)
  NOMAD_TPU_PROBE_TIMEOUT_S    canary deadline (default 10)
  NOMAD_TPU_INIT_GRACE_S       deadline floor until the FIRST canary
                               or guarded stage succeeds (default 600)
                               — a cold start (CUDA context, the
                               kernels' first loads) must not read as a
                               wedge
  NOMAD_TPU_WATCHDOG_FACTOR    budget = factor * stage EWMA (default 20)
  NOMAD_TPU_WATCHDOG_MIN_S     budget floor (default 5)
  NOMAD_TPU_WATCHDOG_MAX_S     budget ceiling (default 120)
  NOMAD_TPU_LOST_PROBES        consecutive canary failures past
                               DEGRADED before LOST (default 2)
  NOMAD_TPU_RECOVER_CANARIES   consecutive passes before flipping back
                               (default 3)
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

LOG = logging.getLogger("nomad_tpu_torch.device")

from ..telemetry import percentile as _percentile
from ..trace import TRACE
from .core import DeviceFault
from .faults import FAULT_ENV, FaultPlan
from .watchdog import BudgetTracker, DeviceTimeout, bounded_call

# -- states -----------------------------------------------------------

CPU_ONLY = "CPU_ONLY"  # no card expected; supervision idle
HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
LOST = "LOST"
RECOVERING = "RECOVERING"

# the device.state gauge encoding (the JAX package's)
STATE_CODES = {
    CPU_ONLY: 0,
    HEALTHY: 1,
    DEGRADED: 2,
    LOST: 3,
    RECOVERING: 4,
}

# in these states every worker holds and guard refuses the stage
_HELD_STATES = frozenset({LOST, RECOVERING})

# -- metric registry ---------------------------------------------------
# every device.* name the supervisor emits, zero-registered at start so
# prometheus_text() exports the whole family before the first incident
METRIC_COUNTERS = frozenset(
    {
        "device.failover",
        "device.recovered",
        "device.canary_ok",
        "device.canary_fail",
        "device.watchdog_trips",
        "device.probe_timeouts",
    }
)
METRIC_GAUGES = frozenset(
    {
        "device.state",
        "device.backend_epoch",
    }
)
METRIC_SAMPLES = frozenset(
    {
        "device.probe_latency_ms",
        # LOST transition to the restored HEALTHY flip
        "device.failover_resume_ms",
    }
)

# deadline for one post-recovery warm hook: generous, but bounded — a
# card that re-wedges mid-warm must not hang the probe thread that
# supervises it
REWARM_BUDGET_S = 600.0

# ring of recent probe latencies backing the status() percentiles
# (independent of any Metrics sink)
_PROBE_RING = 256
# transitions retained for status() history
_HISTORY = 64

_INCIDENT_SEQ = itertools.count(1)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        LOG.warning("invalid %s=%r; using %s", name, raw, default)
        return default


class DeviceLost(DeviceFault):
    """The supervisor holds the pipeline: the card is LOST or
    RECOVERING.  Raised by ``guard`` without calling the stage, and by
    ``Server.drain_to_idle``."""

    def __init__(self, state: str, last_error: Optional[str]) -> None:
        super().__init__(
            f"device {state}: the pipeline holds until the canary "
            f"passes again (last error: {last_error or 'none'})"
        )
        self.state = state
        self.last_error = last_error


class DeviceSupervisor:
    """Owns the card's liveness for one server process."""

    def __init__(
        self,
        metrics=None,
        config=None,
        canary: Optional[Callable[[], object]] = None,
        expected: Optional[bool] = None,
        probe_interval_s: Optional[float] = None,
        probe_timeout_s: Optional[float] = None,
        watchdog_factor: Optional[float] = None,
        watchdog_min_s: Optional[float] = None,
        watchdog_max_s: Optional[float] = None,
        lost_probes: Optional[int] = None,
        recover_canaries: Optional[int] = None,
        init_grace_s: Optional[float] = None,
        device=None,
    ) -> None:
        def opt(value, cfg_attr, env, default):
            if value is not None:
                return value
            if config is not None and getattr(
                config, cfg_attr, None
            ) is not None:
                return getattr(config, cfg_attr)
            return _env_float(env, default)

        self.metrics = metrics
        # the torch.device the canary probes (the server's resolved
        # device); None resolves to the CUDA card at probe time
        self.device = device
        self.faults = FaultPlan.from_env()
        self.probe_interval_s = float(
            opt(probe_interval_s, "probe_interval_s",
                "NOMAD_TPU_PROBE_INTERVAL_S", 30.0)
        )
        self.probe_timeout_s = float(
            opt(probe_timeout_s, "probe_timeout_s",
                "NOMAD_TPU_PROBE_TIMEOUT_S", 10.0)
        )
        self.lost_probes = max(1, int(
            opt(lost_probes, "lost_probes", "NOMAD_TPU_LOST_PROBES", 2)
        ))
        self.recover_canaries = max(1, int(
            opt(recover_canaries, "recover_canaries",
                "NOMAD_TPU_RECOVER_CANARIES", 3)
        ))
        # deadline floor until the card has answered ONCE: first
        # contact pays the CUDA context and the kernels' first loads,
        # which must not read as a wedge
        self.init_grace_s = float(
            opt(init_grace_s, "init_grace_s",
                "NOMAD_TPU_INIT_GRACE_S", 600.0)
        )
        self._device_ready = False
        self.budgets = BudgetTracker(
            factor=float(
                opt(watchdog_factor, "watchdog_factor",
                    "NOMAD_TPU_WATCHDOG_FACTOR", 20.0)
            ),
            min_s=float(
                opt(watchdog_min_s, "watchdog_min_s",
                    "NOMAD_TPU_WATCHDOG_MIN_S", 5.0)
            ),
            max_s=float(
                opt(watchdog_max_s, "watchdog_max_s",
                    "NOMAD_TPU_WATCHDOG_MAX_S", 120.0)
            ),
        )
        self._canary = canary or self._default_canary
        self.expected = (
            expected
            if expected is not None
            else self._accelerator_expected(device)
        )
        self._state = HEALTHY if self.expected else CPU_ONLY
        self.backend_epoch = 0
        # set while the state is LOST or RECOVERING: the workers'
        # run loops hold on it.  A flag of the supervisor's own —
        # leadership's Worker.set_pause must never release a worker the
        # supervisor holds
        self._hold = threading.Event()
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._listeners: List[Callable] = []
        self._warm_hooks: List[Callable] = []
        self._history: deque = deque(maxlen=_HISTORY)
        self._probe_ring: deque = deque(maxlen=_PROBE_RING)
        self._canary_fail_streak = 0
        self._recover_streak = 0
        # single-flight canary: while a canary is still in flight (a
        # parked call inside a wedged device), later probes report the
        # wedge instantly instead of stacking another thread behind it
        self._canary_lock = threading.Lock()
        self._canary_inflight = False
        self._canary_started = 0.0
        # generation counter orphans a parked attempt when the
        # relaunch window passes, so its eventual finally-clear can't
        # clobber a newer attempt's in-flight flag
        self._canary_gen = 0
        # the canary's own CUDA stream and K8 bound to it (an
        # ops.canary.CanaryProbe), made once in prepare(): it waits on
        # that stream alone, never behind the workers'; close() frees
        # the probe's host block
        self._canary_stream = None
        self._canary_probe = None
        self.failover_count = 0
        self.recovered_count = 0
        self.watchdog_trips = 0
        self.canary_ok = 0
        self.canary_fail = 0
        self.probe_timeouts = 0
        self.last_error: Optional[str] = None
        # the DeviceTimeout that opened the current LOST incident (None
        # when the canary opened it); fault() raises it
        self._trip_fault: Optional[DeviceTimeout] = None
        self._incident: Optional[str] = None
        self.last_incident: Optional[str] = None
        # detect-to-resume stopwatch: stamped at failover, read (and
        # cleared) when the restored flip samples
        # device.failover_resume_ms
        self._failover_at: Optional[float] = None
        # unhealthy-time accounting: cumulative seconds spent outside
        # HEALTHY/CPU_ONLY plus the live segment
        self._unhealthy_accum = 0.0
        self._unhealthy_since: Optional[float] = None
        self._since_wall = time.time()
        self._register_metrics()
        from ..tsan import maybe_instrument

        maybe_instrument(self, "DeviceSupervisor")

    # -- construction helpers ------------------------------------------

    @staticmethod
    def _accelerator_expected(device=None) -> bool:
        forced = os.environ.get("NOMAD_TPU_SUPERVISOR")
        if forced == "1":
            return True
        if forced == "0":
            return False
        if os.environ.get(FAULT_ENV, "").strip():
            # an armed fault plan simulates a card: the supervisor must
            # be live for the faults to mean anything
            return True
        if device is not None:
            return getattr(device, "type", str(device)) == "cuda"
        import torch

        return torch.cuda.is_available()

    def _register_metrics(self) -> None:
        metrics = self.metrics
        if metrics is None:
            return
        metrics.preregister(
            counters=METRIC_COUNTERS,
            gauges=METRIC_GAUGES,
            samples=METRIC_SAMPLES,
        )
        metrics.set_gauge("device.state", STATE_CODES[self._state])
        metrics.set_gauge("device.backend_epoch", 0.0)

    def _incr(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.incr(name)

    # -- lifecycle -----------------------------------------------------

    def prepare(self) -> None:
        """Load K8, make the canary's stream and bind the probe to it
        (`ops.canary.CanaryProbe` on ``ones(8)``, f64: its block of
        mapped host memory allocated once) before the first probe,
        outside any bounded call: the kernels' loader builds under one
        process-wide lock, which a parked canary thread must never
        hold.  A no-op unless the canary is K8 on a card."""
        if self._canary != self._default_canary:
            return
        dev = self._probe_device()
        if dev.type != "cuda":
            return
        import torch

        from ..ops.canary import CanaryProbe

        if self._canary_stream is None:
            self._canary_stream = torch.cuda.Stream(dev)
        if self._canary_probe is None:
            self._canary_probe = CanaryProbe(dev, stream=self._canary_stream)

    def start(self) -> None:
        """Start the probe thread (no-op when no card is expected —
        CPU-only test servers must stay thread-free)."""
        if not self.expected:
            return
        self.prepare()
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self.faults.stop_event.clear()
            self._thread = threading.Thread(
                target=self._probe_loop,
                name="device-supervisor",
                daemon=True,
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # release every sacrificial thread parked on an injected wedge
        self.faults.stop_event.set()

    def close(self) -> None:
        """Stop, and free the bound probe's host block (at once, or when
        an attempt still parked in it returns).  A later ``start()``
        binds a new one."""
        self.stop()
        probe, self._canary_probe = self._canary_probe, None
        if probe is not None:
            probe.close()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — supervision must survive
                LOG.exception("device probe crashed")

    # -- state queries -------------------------------------------------

    def state(self) -> str:
        return self._state

    def device_available(self) -> bool:
        """True when stages may run on the card."""
        return self.expected and self._state in (HEALTHY, DEGRADED)

    def holding(self) -> bool:
        """True while the workers must hold (LOST or RECOVERING)."""
        return self._hold.is_set()

    def fault(self) -> DeviceFault:
        """What a held pipeline raises: the watchdog trip that opened
        the incident, else a ``DeviceLost`` naming the state and the
        last error."""
        trip = self._trip_fault
        if trip is not None:
            return trip
        return DeviceLost(self._state, self.last_error)

    def subscribe(self, fn: Callable) -> None:
        """Register a transition listener ``fn(old_state, new_state,
        reason)`` (called synchronously on the transitioning thread,
        after the epoch bump)."""
        self._listeners.append(fn)

    def add_warm_hook(self, fn: Callable) -> None:
        """Register a warm hook run (best-effort, bounded) right after
        a recovered supervisor flips back to HEALTHY.  Idempotent:
        leadership re-establishment may re-register the same hooks."""
        if fn not in self._warm_hooks:
            self._warm_hooks.append(fn)

    # -- stage watchdogs -----------------------------------------------

    def _effective_budget(self, stage: str) -> float:
        """Stage deadline, floored to the init grace until the card
        has answered once."""
        budget = self.budgets.budget(stage)
        if not self._device_ready:
            return max(budget, self.init_grace_s)
        return budget

    def guard(
        self, stage: str, fn: Callable, eval_id: Optional[str] = None
    ):
        """Run one pipeline stage under a deadline monitor.  While no
        card is expected the call passes straight through; while the
        card is LOST or RECOVERING the stage is not called and
        ``fault()`` is raised."""
        if not self.expected:
            return fn()
        if self._state in _HELD_STATES:
            raise self.fault()
        budget = self._effective_budget(stage)

        def wrapped():
            self.faults.stage_hook(stage, budget)
            return fn()

        t0 = time.monotonic()
        try:
            result = bounded_call(
                wrapped, budget, name=f"device-{stage}", stage=stage
            )
        except DeviceTimeout as exc:
            self._watchdog_tripped(stage, budget, eval_id, exc)
            raise
        self._device_ready = True
        self.budgets.note(stage, time.monotonic() - t0)
        return result

    def _watchdog_tripped(
        self, stage: str, budget_s: float, eval_id: Optional[str],
        exc: Optional[DeviceTimeout] = None,
    ) -> None:
        self.watchdog_trips += 1
        self._incr("device.watchdog_trips")
        self.last_error = (
            f"watchdog: {stage} exceeded {budget_s:.2f}s budget"
        )
        if eval_id:
            # name the tripped watchdog on the eval that paid for it
            TRACE.event(
                eval_id, "device.watchdog_trip",
                stage=stage, budget_ms=budget_s * 1000.0,
            )
        LOG.warning(
            "device watchdog tripped: stage %s exceeded %.2fs budget",
            stage, budget_s,
        )
        from ..decisions import DECISIONS

        ewma = self.budgets.ewma(stage)
        DECISIONS.record(
            "watchdog_budget",
            "trip",
            inputs={
                "stage": stage,
                "budget_s": round(budget_s, 3),
                "ewma_s": round(ewma, 4) if ewma is not None else None,
                "factor": self.budgets.factor,
                "backend_epoch": self.backend_epoch,
            },
            alternatives=["keep_waiting"],
            outcome="lost",
            trace_id=eval_id or self._incident or "",
            metrics=self.metrics,
        )
        if self._state not in _HELD_STATES:
            self._trip_fault = exc or DeviceTimeout(stage, budget_s)
        self._transition(LOST, f"watchdog:{stage}", stage=stage)

    def trip(self, stage: str = "manual") -> None:
        """Operator/test surface: force a LOST transition as if a
        watchdog had tripped."""
        if not self.expected:
            return
        self._transition(LOST, f"watchdog:{stage}", stage=stage)

    # -- health probes -------------------------------------------------

    def _probe_device(self):
        if self.device is None:
            from .core import resolve_device

            self.device = resolve_device(None)
        return self.device

    def _default_canary(self):
        """One K8 probe, the counterpart of the JAX package's jitted
        ``a + 1`` canary on ``ones(8)`` (f64, the main path's mode),
        answering 16.0: the bound probe sets its sum to NaN, launches K8
        once on the canary's own stream, waits on that stream alone and
        reads the sum.  Small enough to be free, end-to-end enough (the
        kernel reads its inputs from host memory and writes the sum
        back across the bus) to catch a wedged card.  On a CPU device
        the twin runs (the fault-injection tests).

        A late write of an orphaned attempt cannot pass a later probe.
        Every attempt launches on the one canary stream, which runs its
        launches in order, and reads the sum only after its own event,
        recorded behind its own launch, has completed: so whatever it
        reads was stored by its own launch or by one that came after it
        (an orphan whose launch was enqueued late, which stores the same
        16.0 from the same inputs).  A launch that never runs leaves the
        event pending, so the attempt times out; one that runs without
        storing leaves the NaN, so it fails."""
        import torch

        from ..ops.canary import canary

        dev = self._probe_device()
        if dev.type != "cuda":
            _out, total = canary(torch.ones(8, dtype=torch.float64))
            return float(total)
        probe = self._canary_probe
        if probe is None:
            self.prepare()
            probe = self._canary_probe
        return probe.probe()

    def _canary_call(self):
        self.faults.canary_hook()
        return self._canary()

    def _canary_relaunch_s(self) -> float:
        """How long an in-flight (presumed wedged) canary attempt
        blocks new attempts.  Short enough that a card whose old parked
        call never returns is still re-probed, long enough that a
        persistent wedge leaks at most ~one abandoned thread per
        window instead of one per probe."""
        return max(60.0, 4.0 * self.probe_timeout_s)

    def _canary_bounded(self):
        """One bounded canary attempt, single-flight: while a previous
        attempt's sacrificial thread is still parked inside a wedged
        call, report the wedge immediately instead of stacking another
        thread behind it — until the relaunch window passes, after
        which the parked attempt is orphaned and a fresh probe runs."""
        now = time.monotonic()
        with self._canary_lock:
            if self._canary_inflight:
                if (
                    now - self._canary_started
                    < self._canary_relaunch_s()
                ):
                    raise DeviceTimeout(
                        "canary_inflight", self.probe_timeout_s
                    )
                # orphan the parked attempt: bump the generation so
                # its eventual finally-clear becomes a no-op
                self._canary_gen += 1
            self._canary_inflight = True
            self._canary_started = now
            gen = self._canary_gen

        def call():
            try:
                return self._canary_call()
            finally:
                with self._canary_lock:
                    if self._canary_gen == gen:
                        self._canary_inflight = False

        timeout = self.probe_timeout_s
        if not self._device_ready:
            timeout = max(timeout, self.init_grace_s)
        return bounded_call(
            call, timeout, name="device-canary", stage="canary"
        )

    def probe_once(self) -> bool:
        """Run one canary probe and feed the state machine.  Returns
        the probe verdict (True = the card answered in time)."""
        if not self.expected:
            return True
        t0 = time.monotonic()
        ok = False
        timed_out = False
        measured = True
        err: Optional[str] = None
        try:
            self._canary_bounded()
            ok = True
        except DeviceTimeout as exc:
            timed_out = True
            err = str(exc)
            # an instant still-in-flight verdict is wedge evidence,
            # not a latency measurement
            measured = exc.stage != "canary_inflight"
        except Exception as exc:  # noqa: BLE001 — any failure counts
            err = f"{type(exc).__name__}: {exc}"
        dt = time.monotonic() - t0
        if measured:
            with self._lock:
                # status() sorts this ring from other threads; appends
                # must not race its iteration
                self._probe_ring.append(dt * 1000.0)
            if self.metrics is not None:
                self.metrics.add_sample(
                    "device.probe_latency_ms", dt * 1000.0
                )
        incident = self._incident
        if incident is not None:
            TRACE.add_span(
                incident, "device.probe", t0, dt,
                ok=ok, timeout=timed_out,
            )
        if ok:
            self._note_canary_ok()
        else:
            self._note_canary_fail(err, timed_out)
        return ok

    def _note_canary_ok(self) -> None:
        self.canary_ok += 1
        self._incr("device.canary_ok")
        self._canary_fail_streak = 0
        self._device_ready = True
        state = self._state
        if state == DEGRADED:
            self._transition(HEALTHY, "canary_ok")
        elif state == LOST:
            self._recover_streak = 1
            self._transition(RECOVERING, "canary_ok")
        elif state == RECOVERING:
            self._recover_streak += 1
            if self._recover_streak >= self.recover_canaries:
                self._transition(
                    HEALTHY,
                    f"recovered after {self._recover_streak} canaries",
                )
                # warm AFTER the flip, under the post-restore epoch
                self._run_warm_hooks()

    def _note_canary_fail(
        self, err: Optional[str], timed_out: bool
    ) -> None:
        self.canary_fail += 1
        self._incr("device.canary_fail")
        self.last_error = err
        self._canary_fail_streak += 1
        state = self._state
        if timed_out:
            self.probe_timeouts += 1
            self._incr("device.probe_timeouts")
            # a canary that BLOCKS is a wedge, not a degradation — the
            # next pipeline launch would hang the same way
            if state not in (LOST,):
                self._transition(LOST, "probe_timeout")
            return
        if state == HEALTHY:
            self._transition(DEGRADED, f"canary_fail: {err}")
        elif state == DEGRADED:
            if self._canary_fail_streak >= 1 + self.lost_probes:
                self._transition(
                    LOST,
                    f"{self._canary_fail_streak} consecutive canary "
                    "failures",
                )
        elif state == RECOVERING:
            self._transition(LOST, f"canary_fail_in_recovery: {err}")

    def _run_warm_hooks(self) -> None:
        """Run the warm hooks for the just-restored card (best-effort:
        a warm failure only means the first post-recovery launches pay
        their loads)."""
        tid = self.last_incident
        for hook in self._warm_hooks:
            try:
                with TRACE.span(
                    tid or "", "device.rewarm"
                ) if tid else nullcontext():
                    # bounded: a card that re-wedges mid-warm must not
                    # hang the probe thread; the next canaries will
                    # re-detect it
                    bounded_call(
                        hook, REWARM_BUDGET_S,
                        name="device-rewarm", stage="rewarm",
                    )
            except Exception:  # noqa: BLE001
                LOG.exception("device warm hook failed")

    # -- transitions ---------------------------------------------------

    def _transition(
        self, new: str, reason: str, stage: Optional[str] = None
    ) -> None:
        with self._lock:
            old = self._state
            if old == new or old == CPU_ONLY:
                return
            self._state = new
            if new in _HELD_STATES:
                # at once: a worker between two gulps must not dequeue
                # again while the listeners below still run
                self._hold.set()
            now = time.monotonic()
            self._since_wall = time.time()
            # unhealthy-time accounting
            if old == HEALTHY and new != HEALTHY:
                self._unhealthy_since = now
            elif new == HEALTHY and self._unhealthy_since is not None:
                self._unhealthy_accum += now - self._unhealthy_since
                self._unhealthy_since = None
            failover = new == LOST and old in (HEALTHY, DEGRADED)
            restored = new == HEALTHY and old == RECOVERING
            if failover or restored:
                self.backend_epoch += 1
            failover_at = None
            if failover:
                self.failover_count += 1
                self._failover_at = now
            if restored:
                self.recovered_count += 1
                failover_at = self._failover_at
                self._failover_at = None
            self._history.append(
                {
                    "at": self._since_wall,
                    "from": old,
                    "to": new,
                    "reason": reason,
                }
            )
        LOG.warning(
            "device supervisor: %s -> %s (%s)", old, new, reason
        )
        if self.metrics is not None:
            self.metrics.set_gauge("device.state", STATE_CODES[new])
            self.metrics.set_gauge(
                "device.backend_epoch", float(self.backend_epoch)
            )
        if failover:
            self._incr("device.failover")
            self._open_incident(old, reason, stage)
        incident = self._incident
        if incident is not None:
            TRACE.event(
                incident, "device.state_change",
                state_from=old, state_to=new, reason=reason,
            )
        if failover or restored:
            # listeners flush their device-keyed state before any
            # further launch can read it (on LOST: before the workers
            # could be released; on restore: before hold clears)
            span_ctx = (
                TRACE.span(incident, "device.flush", to=new)
                if incident is not None
                else nullcontext()
            )
            with span_ctx:
                for listener in list(self._listeners):
                    try:
                        listener(old, new, reason)
                    except Exception:  # noqa: BLE001
                        LOG.exception(
                            "device transition listener failed"
                        )
        if new not in _HELD_STATES:
            # released only after the restore's flush above
            self._trip_fault = None
            self._hold.clear()
        if restored:
            self._incr("device.recovered")
            if failover_at is not None and self.metrics is not None:
                self.metrics.add_sample(
                    "device.failover_resume_ms",
                    (time.monotonic() - failover_at) * 1000.0,
                    exemplar=self._incident or "",
                )
            self._close_incident(reason)

    def _open_incident(
        self, old: str, reason: str, stage: Optional[str]
    ) -> None:
        tid = f"device:failover:{next(_INCIDENT_SEQ)}"
        self._incident = tid
        self.last_incident = tid
        TRACE.begin(tid, root_span="device.incident", kind="device")
        TRACE.event(
            tid, "device.failover",
            watchdog=stage or "", reason=reason, state_from=old,
        )

    def _close_incident(self, reason: str) -> None:
        tid = self._incident
        if tid is None:
            return
        TRACE.event(
            tid, "device.recover",
            reason=reason, canaries=self._recover_streak,
        )
        TRACE.finish(tid, "recovered")
        self._incident = None

    # -- status --------------------------------------------------------

    def time_degraded_s(self) -> float:
        accum = self._unhealthy_accum
        since = self._unhealthy_since
        if since is not None:
            accum += time.monotonic() - since
        return accum

    def status(self) -> Dict:
        """The supervisor's state in one consistent view (read under
        the lock: a torn view, state from before a failover and epoch
        from after, would mislead exactly the operator debugging it)."""
        with self._lock:
            ordered = sorted(self._probe_ring)
            return {
                "enabled": self.expected,
                "state": self._state,
                "state_code": STATE_CODES[self._state],
                "holding": self._hold.is_set(),
                "device": None if self.device is None else str(self.device),
                "backend_epoch": self.backend_epoch,
                # False until the card answered once; deadlines are
                # floored to init_grace_s while it is
                "device_ready": self._device_ready,
                "since": self._since_wall,
                "failover_count": self.failover_count,
                "recovered_count": self.recovered_count,
                "watchdog_trips": self.watchdog_trips,
                "canary_ok": self.canary_ok,
                "canary_fail": self.canary_fail,
                "probe_timeouts": self.probe_timeouts,
                "time_degraded_s": round(self.time_degraded_s(), 3),
                "probe_latency_ms": {
                    "count": len(ordered),
                    "p50": round(_percentile(ordered, 0.50), 3),
                    "p99": round(_percentile(ordered, 0.99), 3),
                },
                "budgets": self.budgets.snapshot(),
                "probe_interval_s": self.probe_interval_s,
                "probe_timeout_s": self.probe_timeout_s,
                "faults": self.faults.describe(),
                "last_error": self.last_error,
                "last_incident": self.last_incident,
                "history": list(self._history),
            }
