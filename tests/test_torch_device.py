"""The port's device supervisor (`nomad_tpu_torch/device/`) against the
JAX package's (`nomad_tpu/device/`), on the CPU.

Parity: `bounded_call`, `BudgetTracker`, `FaultPlan` parsing and the
state machine driven by the same scripted canary (ok / fail / timeout /
trip sequences, the same thresholds) give the same results, state
histories, counters and gauges in both packages.

The port's own rule on LOST (no CPU failover): a watchdog trip raises
`DeviceTimeout` from `drain_to_idle`; while the supervisor is LOST or
RECOVERING every worker holds and the evals stay in the broker; after
the flip back to HEALTHY they are placed, equal to an unfaulted run.
`NOMAD_TPU_SUPERVISOR=1` or an armed `NOMAD_TPU_FAULT` makes the
supervisor live on a `device="cpu"` Server, whose canary runs K8's twin.
"""
import gc
import json
import threading
import time
import types
import weakref

import numpy as np
import pytest
import torch

import nomad_tpu.device as jdevice
import nomad_tpu.device.supervisor as jsup
import nomad_tpu.device.watchdog as jwatchdog
import nomad_tpu.mock as jmock
import nomad_tpu.structs as jstructs
import nomad_tpu_torch.device as tdevice
import nomad_tpu_torch.device.supervisor as tsup
import nomad_tpu_torch.device.watchdog as twatchdog
import nomad_tpu_torch.mock as tmock
import nomad_tpu_torch.structs as tstructs
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.telemetry import Metrics as JaxMetrics
from nomad_tpu_torch.device import (
    CPU_ONLY,
    DEGRADED,
    HEALTHY,
    LOST,
    RECOVERING,
    DeviceFault,
    DeviceLost,
    DeviceTimeout,
)
from nomad_tpu_torch.ops import canary as tcanary
from nomad_tpu_torch.server import Server as TorchServer
from nomad_tpu_torch.telemetry import Metrics as TorchMetrics

JAX = types.SimpleNamespace(mock=jmock, structs=jstructs)
TORCH = types.SimpleNamespace(mock=tmock, structs=tstructs)


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def make_nodes(pkg, n, seed=0):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n):
        node = pkg.mock.node(id=f"dev-node-{seed}-{i:03d}", name=f"n{i}")
        node.node_resources.cpu = int(rng.choice([4000, 8000]))
        node.node_resources.memory_mb = int(rng.choice([8192, 16384]))
        node.computed_class = pkg.structs.compute_node_class(node)
        nodes.append(node)
    return nodes


def make_jobs(pkg, n, prefix, seed=1):
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n):
        job = pkg.mock.job(id=f"{prefix}-{i}")
        job.task_groups[0].count = int(rng.integers(1, 5))
        job.task_groups[0].tasks[0].resources.cpu = int(
            rng.choice([200, 500])
        )
        jobs.append(job)
    return jobs


def placements(server, job_id):
    return sorted(
        (a.name, a.node_id)
        for a in server.store.allocs_by_job("default", job_id)
        if not a.terminal_status()
    )


def run_unfaulted(server_cls, pkg, n_nodes, n_jobs, prefix, seed, **kw):
    """Placements of an unfaulted batched Server over the same world."""
    server = server_cls(num_schedulers=1, seed=seed, batch_pipeline=True,
                        heartbeat_ttl=1e9, **kw)
    server.start()
    try:
        for node in make_nodes(pkg, n_nodes):
            server.register_node(node)
        for job in make_jobs(pkg, n_jobs, prefix):
            server.register_job(job)
        assert server.drain_to_idle(60)
        return {f"{prefix}-{i}": placements(server, f"{prefix}-{i}")
                for i in range(n_jobs)}
    finally:
        server.stop()


def no_eval_lost(server, jobs):
    """Every eval of the jobs is complete or back in the broker (not
    leased), none was failed by the delivery limit, and no alloc was
    placed twice."""
    ids = {job.id for job in jobs}
    evs = [e for e in server.store.evals.values() if e.job_id in ids]
    assert {e.job_id for e in evs} == ids
    for ev in evs:
        assert ev.status == "complete" or (
            ev.status == "pending"
            and server.broker.outstanding(ev.id) is None
        ), (ev.job_id, ev.status)
    assert server.broker.stats["delivery_failures"] == 0
    for job in jobs:
        names = [name for name, _node in placements(server, job.id)]
        assert len(names) == len(set(names))
        assert len(names) <= job.task_groups[0].count


# -- watchdog primitives: parity ----------------------------------------


@pytest.mark.parametrize("mod", [jwatchdog, twatchdog],
                         ids=["jax", "torch"])
def test_bounded_call_passthrough_and_timeout(mod):
    assert mod.bounded_call(lambda: 41 + 1, 5.0) == 42
    with pytest.raises(ValueError):
        mod.bounded_call(lambda: (_ for _ in ()).throw(ValueError("x")), 5.0)
    t0 = time.monotonic()
    with pytest.raises(mod.DeviceTimeout) as exc:
        mod.bounded_call(lambda: time.sleep(30), 0.2, stage="fetch")
    assert time.monotonic() - t0 < 5.0
    assert exc.value.stage == "fetch"
    assert exc.value.budget_s == 0.2


def test_port_device_timeout_is_a_device_fault():
    """The port's departure: every `except DeviceFault` meets a trip."""
    assert issubclass(twatchdog.DeviceTimeout, DeviceFault)
    assert issubclass(DeviceLost, DeviceFault)
    assert tdevice.DeviceTimeout is twatchdog.DeviceTimeout


@pytest.mark.parametrize("mod", [jwatchdog, twatchdog],
                         ids=["jax", "torch"])
def test_bounded_call_reuses_runner_until_a_trip_burns_it(mod):
    assert mod.bounded_call(lambda: 1, 5.0) == 1
    runner1 = mod._TLS.runner
    assert mod.bounded_call(lambda: 2, 5.0) == 2
    assert mod._TLS.runner is runner1
    with pytest.raises(mod.DeviceTimeout):
        mod.bounded_call(lambda: time.sleep(30), 0.2)
    assert runner1.dead
    assert mod.bounded_call(lambda: 3, 5.0) == 3
    assert mod._TLS.runner is not runner1


def test_runner_holds_nothing_of_a_finished_call():
    """The port's departure: a runner parked between calls keeps no
    reference to the last call's callable or result (the JAX runner
    keeps both, and with them whatever the callable's closure holds)."""

    class Payload:
        pass

    held = Payload()
    ref = weakref.ref(held)
    assert twatchdog.bounded_call(lambda: held, 5.0) is held
    del held
    gc.collect()
    assert ref() is None


def test_runner_exits_when_its_thread_ends(monkeypatch):
    monkeypatch.setattr(twatchdog, "_IDLE_CHECK_S", 0.02)
    name = "device-runner-exit-probe"
    got = []
    owner = threading.Thread(
        target=lambda: got.append(twatchdog.bounded_call(lambda: 7, 5.0,
                                                         name=name)))
    owner.start()
    owner.join()
    assert got == [7]
    assert wait_until(lambda: not any(
        t.name == name for t in threading.enumerate()), 5.0)


def _holding_collection(seconds: float):
    """A gc callback that, once armed, holds the interpreter for about
    `seconds` at the start of the next collection, as a full collection
    over a large heap does (one C call: no other thread runs)."""
    n = 1_000_000
    t0 = time.perf_counter()
    sum(range(n))
    n = int(n * seconds / max(time.perf_counter() - t0, 1e-6))

    def hold(phase, _info):
        if phase == "start" and hold.armed:
            hold.armed = False
            sum(range(n))

    hold.armed = False
    return hold


@pytest.mark.parametrize("stuck", [False, True], ids=["finishes", "stuck"])
def test_collector_pause_does_not_count_against_the_budget(stuck):
    """The port's departure: a collection that holds the interpreter
    past a stage's budget does not trip a stage that finishes within
    the budget besides it; a stage that stays stuck still trips."""
    hold = _holding_collection(0.6)
    gc.callbacks.append(hold)

    def stage():
        hold.armed = True
        gc.collect()
        time.sleep(30 if stuck else 0.05)
        return "done"

    try:
        t0 = time.monotonic()
        if stuck:
            with pytest.raises(twatchdog.DeviceTimeout) as exc:
                twatchdog.bounded_call(stage, 0.3, stage="launch")
            assert exc.value.stage == "launch"
            assert time.monotonic() - t0 < 5.0
        else:
            assert twatchdog.bounded_call(stage, 0.3, stage="launch") == "done"
            # the collection itself outlasted the budget
            assert time.monotonic() - t0 > 0.3
    finally:
        gc.callbacks.remove(hold)


@pytest.mark.parametrize("batch_pipeline", [True, False],
                         ids=["batched", "sequential"])
def test_stopped_supervised_server_is_freed(monkeypatch, batch_pipeline):
    """A stopped Server whose supervisor guarded its stages leaves no
    thread behind and is freed with its store, not kept alive by the
    runner of its last guarded call."""
    monkeypatch.setattr(twatchdog, "_IDLE_CHECK_S", 0.02)
    before = set(threading.enumerate())
    server, sup = faulted_server(monkeypatch, None,
                                 batch_pipeline=batch_pipeline, env=NO_TRIP)
    try:
        for node in make_nodes(TORCH, 8):
            server.register_node(node)
        for job in make_jobs(TORCH, 4, "freed"):
            server.register_job(job)
        assert server.drain_to_idle(60)
        assert sum(len(placements(server, f"freed-{i}")) for i in range(4))
    finally:
        server.stop()
    refs = (weakref.ref(server), weakref.ref(server.store))
    del server, sup
    assert wait_until(
        lambda: set(threading.enumerate()) <= before, 10.0), [
        t.name for t in set(threading.enumerate()) - before]
    gc.collect()
    assert [r() for r in refs] == [None, None]


def test_budget_tracker_matches_jax():
    latencies = [("launch", 0.3), ("fetch", 0.01), ("launch", 100.0),
                 ("launch", 0.02), ("fetch", 0.5), ("assemble", 0.001),
                 ("launch", 0.04), ("fetch", 0.002)]
    for kw in ({}, {"factor": 10.0, "min_s": 1.0, "max_s": 5.0},
               {"factor": 3.0, "min_s": 0.0, "max_s": 0.5, "alpha": 0.5}):
        j = jwatchdog.BudgetTracker(**kw)
        t = twatchdog.BudgetTracker(**kw)
        assert t.budget("launch") == j.budget("launch")
        for stage, dt in latencies:
            j.note(stage, dt)
            t.note(stage, dt)
            for s in ("launch", "fetch", "assemble", "never"):
                assert t.budget(s) == j.budget(s)
                assert t.ewma(s) == j.ewma(s)
        assert t.snapshot() == j.snapshot()


@pytest.mark.parametrize("raw", [
    "", "wedge_launch", "wedge_launch,flaky:2", "slow_fetch:0.25",
    "init_block", "flaky", " flaky:5 , slow_fetch ",
])
def test_fault_plan_parsing_matches_jax(raw):
    env = {"NOMAD_TPU_FAULT": raw}
    j = jdevice.FaultPlan.from_env(env)
    t = tdevice.FaultPlan.from_env(env)
    assert t.kinds == j.kinds
    assert t.active == j.active
    assert t.describe() == j.describe()


@pytest.mark.parametrize("raw", ["typo_kind", "flaky:x", "wedge,flaky"])
def test_fault_plan_errors_match_jax(raw):
    env = {"NOMAD_TPU_FAULT": raw}
    with pytest.raises(ValueError) as j_err:
        jdevice.FaultPlan.from_env(env)
    with pytest.raises(ValueError) as t_err:
        tdevice.FaultPlan.from_env(env)
    assert str(t_err.value) == str(j_err.value)


# -- the state machine: parity on scripted canaries ------------------------


SCRIPTS = {
    # name: (steps, thresholds)
    "flaky": ("fail fail fail ok ok ok ok",
              dict(lost_probes=2, recover_canaries=2)),
    "timeout_wedge": ("ok timeout ok ok ok ok",
                      dict(lost_probes=2, recover_canaries=3)),
    "relapse": ("fail ok fail fail fail ok fail ok ok ok ok",
                dict(lost_probes=2, recover_canaries=3)),
    "trip": ("ok trip ok fail ok ok ok",
             dict(lost_probes=2, recover_canaries=3)),
    "hair_trigger": ("fail fail ok fail ok timeout ok",
                     dict(lost_probes=1, recover_canaries=1)),
}

COUNTERS = ("failover_count", "recovered_count", "watchdog_trips",
            "canary_ok", "canary_fail", "probe_timeouts", "backend_epoch")


def drive_script(mod, metrics, steps, thresholds):
    """Feed one supervisor the scripted canary: `ok` answers, `fail`
    raises, `timeout` blocks past the probe deadline (then is released
    and its parked call allowed to finish), `trip` forces LOST."""
    release = threading.Event()
    current = {"kind": "ok"}

    def canary():
        if current["kind"] == "fail":
            raise RuntimeError("scripted canary failure")
        if current["kind"] == "timeout":
            release.wait(10.0)
        return 16.0

    sup = mod.DeviceSupervisor(
        metrics=metrics, expected=True, canary=canary,
        probe_interval_s=3600.0, probe_timeout_s=0.5, init_grace_s=0.5,
        **thresholds,
    )
    states = []
    for kind in steps.split():
        if kind == "trip":
            sup.trip("launch")
        else:
            current["kind"] = kind
            release.clear()
            sup.probe_once()
            if kind == "timeout":
                release.set()
                assert wait_until(lambda: not sup._canary_inflight, 5.0)
        states.append(sup.state())
    sup.stop()
    return sup, states


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_state_walk_matches_jax(name):
    steps, thresholds = SCRIPTS[name]
    j_metrics, t_metrics = JaxMetrics(), TorchMetrics()
    j, j_states = drive_script(jsup, j_metrics, steps, thresholds)
    t, t_states = drive_script(tsup, t_metrics, steps, thresholds)
    assert t_states == j_states
    history = [(h["from"], h["to"], h["reason"])
               for h in j.status()["history"]]
    assert [(h["from"], h["to"], h["reason"])
            for h in t.status()["history"]] == history
    assert len(history) >= 3
    for attr in COUNTERS:
        assert getattr(t, attr) == getattr(j, attr), attr
    for name_ in sorted(jsup.METRIC_COUNTERS):
        assert t_metrics.get_counter(name_) == j_metrics.get_counter(name_)
    for name_ in sorted(jsup.METRIC_GAUGES):
        assert t_metrics.get_gauge(name_) == j_metrics.get_gauge(name_)
    assert (t_metrics.get_sample("device.probe_latency_ms")["count"]
            == j_metrics.get_sample("device.probe_latency_ms")["count"])
    # the port's hold follows the state; the JAX failover flag too
    assert t.holding() == (t.state() in (LOST, RECOVERING))
    assert t.holding() == j.failed_over()


def test_state_codes_and_metric_names_match_jax():
    assert tsup.STATE_CODES == jsup.STATE_CODES
    assert tsup.METRIC_COUNTERS == jsup.METRIC_COUNTERS
    assert tsup.METRIC_GAUGES == jsup.METRIC_GAUGES
    assert tsup.METRIC_SAMPLES == jsup.METRIC_SAMPLES
    for name in ("CPU_ONLY", "HEALTHY", "DEGRADED", "LOST", "RECOVERING"):
        assert getattr(tsup, name) == getattr(jsup, name)


def test_cpu_supervisor_is_inert(monkeypatch):
    monkeypatch.delenv("NOMAD_TPU_SUPERVISOR", raising=False)
    monkeypatch.delenv("NOMAD_TPU_FAULT", raising=False)
    sup = tdevice.DeviceSupervisor(metrics=TorchMetrics(),
                                   device=torch.device("cpu"))
    assert sup.state() == CPU_ONLY and not sup.expected
    assert sup.guard("launch", lambda: "ok") == "ok"
    sup.start()
    assert sup._thread is None
    sup.trip("manual")
    assert sup.state() == CPU_ONLY and not sup.holding()
    # a card is expected by default for a CUDA device, and forced off
    assert tdevice.DeviceSupervisor(device=torch.device("cuda")).expected
    monkeypatch.setenv("NOMAD_TPU_SUPERVISOR", "0")
    assert not tdevice.DeviceSupervisor(
        device=torch.device("cuda")).expected


def test_guard_refuses_while_held_and_names_the_trip():
    calls = []
    sup = tdevice.DeviceSupervisor(
        expected=True, canary=lambda: 16.0, probe_interval_s=3600.0,
        watchdog_min_s=0.3, watchdog_max_s=0.3, init_grace_s=0.3,
        recover_canaries=1,
    )
    assert sup.guard("fetch", lambda: calls.append(1) or 7) == 7
    with pytest.raises(DeviceTimeout) as trip:
        sup.guard("launch", lambda: time.sleep(5))
    assert sup.state() == LOST and sup.holding()
    # held: the stage is not called; the trip is what it raises
    with pytest.raises(DeviceTimeout) as again:
        sup.guard("fetch", lambda: calls.append(2))
    assert again.value is trip.value and sup.fault() is trip.value
    assert calls == [1]
    assert sup.probe_once() and sup.state() == RECOVERING
    assert sup.probe_once() and sup.state() == HEALTHY and not sup.holding()
    sup.trip("manual")
    with pytest.raises(DeviceLost) as lost:
        sup.guard("fetch", lambda: calls.append(3))
    assert lost.value.state == LOST and calls == [1]
    sup.stop()


def test_warm_hooks_run_after_restore_flip():
    order = []
    calls = {"n": 0}

    def canary():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("down")
        return 16.0

    sup = tdevice.DeviceSupervisor(
        metrics=TorchMetrics(), expected=True, canary=canary,
        probe_interval_s=3600.0, probe_timeout_s=2.0, lost_probes=1,
        recover_canaries=1,
    )
    sup.add_warm_hook(lambda: order.append(("warm", sup.holding())))
    sup.subscribe(lambda old, new, reason: order.append(("flip", new)))
    for want in (DEGRADED, LOST, RECOVERING, HEALTHY):
        sup.probe_once()
        assert sup.state() == want
    assert order == [("flip", LOST), ("flip", HEALTHY), ("warm", False)]


# -- the port's rule on LOST ------------------------------------------------


FAULT_BUDGET = {
    "NOMAD_TPU_WATCHDOG_MIN_S": "1.0",
    "NOMAD_TPU_WATCHDOG_MAX_S": "1.0",
    "NOMAD_TPU_INIT_GRACE_S": "1.0",
    "NOMAD_TPU_PROBE_INTERVAL_S": "3600",
}
# the probes are driven by hand and nothing is meant to trip
NO_TRIP = dict(FAULT_BUDGET, NOMAD_TPU_WATCHDOG_MIN_S="60",
               NOMAD_TPU_WATCHDOG_MAX_S="60", NOMAD_TPU_INIT_GRACE_S="60")


def faulted_server(monkeypatch, fault, batch_pipeline=True, seed=5,
                   env=FAULT_BUDGET):
    if fault:
        monkeypatch.setenv("NOMAD_TPU_FAULT", fault)
    else:
        monkeypatch.setenv("NOMAD_TPU_SUPERVISOR", "1")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    server = TorchServer(num_schedulers=1, seed=seed,
                         batch_pipeline=batch_pipeline, heartbeat_ttl=1e9,
                         device="cpu")
    server.start()
    sup = server.device_supervisor
    assert sup.expected and sup.state() == HEALTHY
    return server, sup


def test_wedge_launch_raises_device_timeout(monkeypatch):
    server, sup = faulted_server(monkeypatch, "wedge_launch")
    stopped = False
    try:
        for node in make_nodes(TORCH, 12):
            server.register_node(node)
        jobs = make_jobs(TORCH, 6, "wedge")
        for job in jobs:
            server.register_job(job)
        t0 = time.monotonic()
        with pytest.raises(DeviceTimeout) as info:
            server.drain_to_idle(30)
        assert time.monotonic() - t0 < 10.0
        assert info.value.stage == "launch"
        assert sup.state() == LOST and sup.watchdog_trips == 1
        worker = server.workers[0]
        assert worker.trips == 1 and worker.fault is None
        assert worker._thread.is_alive()  # held, not stopped
        # nothing committed, every eval back in the broker, once
        no_eval_lost(server, jobs)
        assert all(placements(server, f"wedge-{i}") == [] for i in range(6))
        assert server.broker.ready_count() == 6
        # still held: drain_to_idle raises the supervisor's fault
        with pytest.raises(DeviceTimeout):
            server.drain_to_idle(1)
        t0 = time.monotonic()
        server.stop()
        stopped = True
        assert time.monotonic() - t0 < 5.0
    finally:
        if not stopped:
            server.stop()


@pytest.mark.parametrize("nack", ["late", "never"])
def test_drain_raises_the_trip_once_its_gulp_is_back(monkeypatch, nack):
    """The watchdog's thread sets LOST before the worker met by the trip
    has nacked its gulp.  With that nack delayed 0.3 s, drain_to_idle
    still raises the trip only once all six evals are back in the broker
    and the worker has counted it; when the nack never comes, it raises
    the supervisor's fault within its bound all the same."""
    from nomad_tpu_torch.server import server as tserver
    from nomad_tpu_torch.server.batch_worker import BatchWorker

    release = threading.Event()
    through = BatchWorker._abandon_leases

    def delayed(self, held):
        if nack == "late":
            time.sleep(0.3)
        else:
            release.wait(30)
        return through(self, held)

    monkeypatch.setattr(BatchWorker, "_abandon_leases", delayed)
    server, sup = faulted_server(monkeypatch, "wedge_launch")
    try:
        for node in make_nodes(TORCH, 12):
            server.register_node(node)
        jobs = make_jobs(TORCH, 6, "settle")
        for job in jobs:
            server.register_job(job)
        worker = server.workers[0]
        t0 = time.monotonic()
        with pytest.raises(DeviceTimeout) as info:
            server.drain_to_idle(30)
        seen = (server.broker.ready_count(),
                server.broker.stats["total_unacked"], worker.trips)
        assert info.value.stage == "launch"
        assert sup.state() == LOST
        if nack == "late":
            assert seen == (6, 0, 1)
            assert time.monotonic() - t0 < 10.0
            no_eval_lost(server, jobs)
            # the trip was raised once: now the supervisor's fault
            with pytest.raises(DeviceTimeout):
                server.drain_to_idle(1)
        else:
            assert seen[1] > 0 and seen[2] == 0  # the gulp is still out
            assert time.monotonic() - t0 < 10.0 + tserver.HOLD_SETTLE_S
            release.set()
            assert wait_until(lambda: worker.trips == 1)
            assert wait_until(lambda: server.broker.ready_count() == 6)
            no_eval_lost(server, jobs)
    finally:
        release.set()
        server.stop()


def test_slow_fetch_trip_commits_nothing_then_recovers(monkeypatch):
    want = run_unfaulted(TorchServer, TORCH, 12, 6, "slow", 7,
                         device="cpu")
    server, sup = faulted_server(monkeypatch, "slow_fetch:2", seed=7)
    try:
        for node in make_nodes(TORCH, 12):
            server.register_node(node)
        jobs = make_jobs(TORCH, 6, "slow")
        for job in jobs:
            server.register_job(job)
        with pytest.raises(DeviceTimeout) as info:
            server.drain_to_idle(30)
        assert info.value.stage == "fetch"
        assert sup.state() == LOST
        assert any("watchdog:fetch" in h["reason"]
                   for h in sup.status()["history"])
        # the late sacrificial fetch finishes into a box nobody reads
        time.sleep(2.5)
        assert all(placements(server, f"slow-{i}") == [] for i in range(6))
        no_eval_lost(server, jobs)
        # the card answers again: the held evals are placed
        sup.faults.kinds.clear()
        for _ in range(sup.recover_canaries):
            assert sup.probe_once()
        assert sup.state() == HEALTHY and not sup.holding()
        assert server.drain_to_idle(60)
        assert {f"slow-{i}": placements(server, f"slow-{i}")
                for i in range(6)} == want
        assert server.workers[0].prescored > 0
        no_eval_lost(server, jobs)
    finally:
        server.stop()


def test_flaky_round_trip_places_held_evals(monkeypatch):
    """flaky:3 walks HEALTHY -> DEGRADED -> LOST; jobs registered while
    LOST stay in the broker (no dequeue, no nack); after RECOVERING ->
    HEALTHY (K8's twin answering) they are placed on the device path,
    equal to an unfaulted port run and to the JAX package's."""
    want_jax = run_unfaulted(JaxServer, JAX, 16, 8, "flaky", 3)
    want = run_unfaulted(TorchServer, TORCH, 16, 8, "flaky", 3,
                         device="cpu")
    assert want == want_jax
    env = dict(NO_TRIP, NOMAD_TPU_LOST_PROBES="2",
               NOMAD_TPU_RECOVER_CANARIES="2")
    server, sup = faulted_server(monkeypatch, "flaky:3", seed=3, env=env)
    try:
        for node in make_nodes(TORCH, 16):
            server.register_node(node)
        states = []
        for _ in range(3):
            assert not sup.probe_once()
            states.append(sup.state())
        assert states == [DEGRADED, DEGRADED, LOST]
        worker = server.workers[0]
        assert worker._backend_epoch == 1
        for job in make_jobs(TORCH, 8, "flaky"):
            server.register_job(job)
        time.sleep(0.3)
        assert server.broker.ready_count() == 8
        assert server.broker.stats["total_unacked"] == 0
        with pytest.raises(DeviceLost):
            server.drain_to_idle(1)
        assert sup.probe_once() and sup.state() == RECOVERING
        assert sup.holding()
        assert sup.probe_once() and sup.state() == HEALTHY
        assert worker._backend_epoch == 2
        assert server.drain_to_idle(60)
        got = {f"flaky-{i}": placements(server, f"flaky-{i}")
               for i in range(8)}
        assert got == want
        assert worker.prescored > 0 and worker.errors == 0
        assert server.broker.stats["delivery_failures"] == 0
        visited = [h["to"] for h in sup.status()["history"]]
        assert visited == [DEGRADED, LOST, RECOVERING, HEALTHY]
        assert server.metrics.get_gauge("device.state") == 1.0
        assert server.metrics.get_counter("device.failover") == 1.0
        assert server.metrics.get_counter("device.recovered") == 1.0
    finally:
        server.stop()


@pytest.mark.parametrize("batch_pipeline", [True, False],
                         ids=["batched", "sequential"])
def test_unpause_does_not_release_a_held_worker(monkeypatch,
                                                batch_pipeline):
    server, sup = faulted_server(monkeypatch, None,
                                 batch_pipeline=batch_pipeline, env=NO_TRIP)
    try:
        for node in make_nodes(TORCH, 8):
            server.register_node(node)
        sup.trip("manual")
        time.sleep(0.2)  # past the worker's 0.1 s dequeue wait
        worker = server.workers[0]
        worker.set_pause(True)
        worker.set_pause(False)  # leadership's un-pause
        job = make_jobs(TORCH, 1, "held")[0]
        server.register_job(job)
        time.sleep(0.3)
        assert server.broker.ready_count() == 1
        assert placements(server, "held-0") == []
        for _ in range(sup.recover_canaries):
            sup.probe_once()
        assert sup.state() == HEALTHY
        assert server.drain_to_idle(60)
        assert len(placements(server, "held-0")) == \
            job.task_groups[0].count
    finally:
        server.stop()


def test_lost_flushes_the_mirror_past_a_parked_lock_holder(monkeypatch):
    server, sup = faulted_server(monkeypatch, None, seed=2, env=NO_TRIP)
    try:
        worker = server.workers[0]
        for node in make_nodes(TORCH, 10):
            server.register_node(node)
        for job in make_jobs(TORCH, 4, "flush-a"):
            server.register_job(job)
        assert server.drain_to_idle(60)
        assert worker._usage_cache is not None
        assert worker._usage_cache["key"][0] == 0
        mask_cache = worker._mask_cache
        parked = worker._usage_cache_lock
        holding = threading.Event()
        release = threading.Event()

        def park():  # a wedged sacrificial thread inside the sync
            with parked:
                holding.set()
                release.wait(30)

        threading.Thread(target=park, daemon=True).start()
        assert holding.wait(5)
        try:
            t0 = time.monotonic()
            sup.trip("launch")
            assert time.monotonic() - t0 < 2.0
            assert sup.state() == LOST
            assert worker._backend_epoch == 1
            assert worker._usage_cache is None
            assert worker._usage_cache_lock is not parked
            assert worker._mask_cache is not mask_cache
            assert len(worker._mask_cache) == 0
            assert len(worker._cand_cache) == 0
            t0 = time.monotonic()
            cols = worker._device_columns(server.store.node_table)
            assert cols is not None and time.monotonic() - t0 < 5.0
            assert worker._usage_cache["key"][0] == 1
        finally:
            release.set()
        for _ in range(sup.recover_canaries):
            sup.probe_once()
        assert sup.state() == HEALTHY and worker._backend_epoch == 2
        for job in make_jobs(TORCH, 4, "flush-b", seed=4):
            server.register_job(job)
        assert server.drain_to_idle(60)
        assert worker._usage_cache["key"][0] == 2
        got = {j: placements(server, j) for j in
               [f"flush-a-{i}" for i in range(4)]
               + [f"flush-b-{i}" for i in range(4)]}
    finally:
        server.stop()
    ref = TorchServer(num_schedulers=1, seed=2, batch_pipeline=False,
                      heartbeat_ttl=1e9, device="cpu")
    ref.start()
    try:
        for node in make_nodes(TORCH, 10):
            ref.register_node(node)
        for job in make_jobs(TORCH, 4, "flush-a"):
            ref.register_job(job)
        assert ref.drain_to_idle(60)
        for job in make_jobs(TORCH, 4, "flush-b", seed=4):
            ref.register_job(job)
        assert ref.drain_to_idle(60)
        assert got == {j: placements(ref, j) for j in got}
    finally:
        ref.stop()


def test_device_metrics_preregistered(monkeypatch):
    monkeypatch.delenv("NOMAD_TPU_SUPERVISOR", raising=False)
    monkeypatch.delenv("NOMAD_TPU_FAULT", raising=False)
    server = TorchServer(num_schedulers=1, device="cpu")
    text = server.metrics.prometheus_text()
    for name in ("device_state", "device_backend_epoch", "device_failover",
                 "device_recovered", "device_canary_ok",
                 "device_canary_fail", "device_watchdog_trips",
                 "device_probe_timeouts", "device_probe_latency_ms_count",
                 "device_failover_resume_ms_count"):
        assert name in text, name
    dump = server.metrics.dump()
    assert dump["gauges"]["device.state"] == 0.0  # CPU_ONLY
    assert dump["counters"]["device.failover"] == 0.0
    assert server.device_supervisor.state() == CPU_ONLY
    monkeypatch.setenv("NOMAD_TPU_SUPERVISOR", "1")
    live = TorchServer(num_schedulers=1, device="cpu")
    assert live.metrics.get_gauge("device.state") == 1.0  # HEALTHY


# -- preflight ---------------------------------------------------------------


def _preflight_line(capsys):
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines()
                if l.startswith("DEVICE_PREFLIGHT "))
    return json.loads(line.split(" ", 1)[1])


def test_preflight_fatal_without_a_card(monkeypatch, capsys):
    from nomad_tpu_torch.device import preflight

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    result = preflight.run_preflight(total_s=30.0)
    assert result["state"] == preflight.FATAL
    assert "NoDeviceError" in result["error"]
    assert preflight.main(["--budget-s", "30"]) == 2
    assert _preflight_line(capsys)["state"] == preflight.FATAL


def test_preflight_skipped_healthy_and_unreachable(monkeypatch, capsys):
    from nomad_tpu_torch.device import preflight

    assert preflight.run_preflight(total_s=0)["state"] == preflight.SKIPPED
    assert preflight.main(["--budget-s", "0"]) == 0
    assert _preflight_line(capsys)["state"] == preflight.SKIPPED
    result = preflight.run_preflight(total_s=30.0, device="cpu")
    assert result["state"] == HEALTHY and result["attempts"] == 1
    assert preflight.main(["--budget-s", "30", "--device", "cpu"]) == 0
    assert _preflight_line(capsys)["state"] == HEALTHY
    monkeypatch.setenv("NOMAD_TPU_FAULT", "init_block")
    monkeypatch.setenv("NOMAD_TPU_PROBE_TIMEOUT_S", "0.2")
    t0 = time.monotonic()
    result = preflight.run_preflight(total_s=0.6, device="cpu")
    assert result["state"] == preflight.UNREACHABLE
    assert result["attempts"] >= 1
    assert time.monotonic() - t0 < 10.0
    assert preflight.main(["--budget-s", "0.6", "--device", "cpu"]) == 2


# -- the canary's twin ---------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_canary_plain_matches_the_jax_canary(dtype):
    import jax
    import jax.numpy as jnp

    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = float(jax.jit(lambda a: a + 1)(jnp.ones(8, jdt)).sum())
    out, total = tcanary.canary_plain(torch.ones(8, dtype=dtype))
    assert want == 16.0
    assert float(total) == want and total.dtype == dtype
    assert torch.equal(out, torch.full((8,), 2.0, dtype=dtype))
    # the JAX supervisor's own canary (x64 here)
    assert jsup.DeviceSupervisor(expected=True)._default_canary() == 16.0


@pytest.mark.parametrize("n", [1, 7, 8, 1024, 1500])
def test_canary_plain_sums_in_the_kernel_order(n):
    """The twin's sum is K8's order written out: partial sums of every
    T-th element, each from 0, then halving pairs (t, t + h)."""
    a = np.random.default_rng(n).normal(size=n)
    out, total = tcanary.canary_plain(torch.from_numpy(a))
    threads = tcanary.canary_threads(n)
    assert threads == min(1024, 1 << max(0, (n - 1).bit_length()))
    v = a + 1
    part = [0.0] * threads
    for i, x in enumerate(v):
        part[i % threads] = part[i % threads] + x
    while len(part) > 1:
        h = len(part) // 2
        part = [part[t] + part[t + h] for t in range(h)]
    assert np.array_equal(out.numpy(), v)
    assert float(total) == part[0]


def test_canary_dispatch_and_rejections():
    before = tcanary.canary_cuda.launches
    out, total = tcanary.canary(torch.ones(8, dtype=torch.float64))
    assert float(total) == 16.0
    assert tcanary.canary_cuda.launches == before  # the twin ran
    with pytest.raises(ValueError):
        tcanary.canary_cuda(torch.ones(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        tcanary.canary_plain(torch.ones(0, dtype=torch.float64))
    with pytest.raises(ValueError):
        tcanary.canary_plain(torch.ones(8, dtype=torch.int32))
    sup = tdevice.DeviceSupervisor(expected=True,
                                   device=torch.device("cpu"))
    assert sup._default_canary() == 16.0
    sup.prepare()  # a no-op off the card


def test_release_hands_a_lease_back_to_the_head():
    """A worker whose dequeue returned after the hold began hands the
    eval back with `EvalBroker.release`: it is first again and no
    delivery is counted (a nack would queue it behind later evals)."""
    from nomad_tpu_torch.server.eval_broker import EvalBroker

    broker = EvalBroker(nack_timeout=60.0)
    broker.set_enabled(True)
    evs = []
    for i in range(3):
        ev = tmock.evaluation(job_id=f"rel-{i}")
        evs.append(ev)
        broker.enqueue(ev)
    first, token = broker.dequeue(["service"], timeout=1.0)
    assert first.id == evs[0].id
    broker.release(first.id, token)
    with pytest.raises(ValueError):
        broker.release(first.id, token)
    assert broker.stats["total_unacked"] == 0
    order = [broker.dequeue(["service"], timeout=1.0) for _ in range(3)]
    assert [ev.id for ev, _tok in order] == [ev.id for ev in evs]
    again, token = order[0]
    broker.nack(again.id, token)
    assert broker._delivery_count[again.id] == 1
