"""Preemption-mode selects of the port's CUDA stack against the JAX
package.

The families of `tests/test_parity.py` (`test_preemption_parity`,
`test_preemption_parity_mixed_fleet`) plus an affinity (an unlimited
walk, ``limit == INT32_MAX``), a ``distinct_hosts`` job and fitting
winners that fail verification on a reserved port (each gets the evict
evaluation, then the walk runs again) run three ways from one world: the JAX package's
ServiceScheduler on its device stack (``use_tpu=True``), the port's on
``device="cpu"`` (the CUDA stack with the plain twins, K6's twin
included) and the port's host oracle chain (``use_device=False``).
Placements and preemption sets must be identical across all three, and
every AllocMetric field (but the wall-clock ``allocation_time_s``) equal
between the JAX stack and the port's.

Also K6's twin, `ops.score.limited_walk_argmax`, against the JAX
`_walk_only` on seeded vectors (`ops.cases.walk_case`), element for
element.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.api.codec import eval_to_dict
from nomad_tpu.sched import generic_sched as jgs
from nomad_tpu.sched.testing import Harness as JHarness
from nomad_tpu.sched.tpu_stack import _walk_only
from nomad_tpu.structs import (
    Affinity,
    Constraint,
    NetworkResource,
    Port,
    PreemptionConfig,
    SchedulerConfiguration,
    compute_node_class,
)
from nomad_tpu_torch import structs as tstructs
from nomad_tpu_torch.ops import score as tscore
from nomad_tpu_torch.ops.cases import INT32_MAX, WALK_SCENARIOS, walk_case
from nomad_tpu_torch.sched import cuda_stack as tcuda
from nomad_tpu_torch.sched import generic_sched as tgs
from nomad_tpu_torch.state.convert import dataclass_from_dict

from test_torch_sched import carry


def metric_fields(m):
    """Every AllocMetric field but the wall-clock allocation time."""
    d = dataclasses.asdict(m)
    d.pop("allocation_time_s")
    return d


def plan_view(h):
    """Placements, preemption set and per-alloc metrics of the last
    plan the harness computed."""
    plan = h.plans[-1]
    allocs = [a for v in plan.node_allocation.values() for a in v]
    placed = sorted((a.name, a.node_id) for a in allocs)
    preempted = sorted(
        a.id for v in plan.node_preemptions.values() for a in v
    )
    metrics = {a.name: metric_fields(a.metrics) for a in allocs}
    return placed, preempted, metrics


def three_way(jh, ev, seed):
    """The eval through the JAX device stack, the port's device stack
    on the CPU and the port's oracle chain, each on the same unmutated
    world; returns the three plan views and the port's scheduler."""
    th = carry(jh)
    oh = carry(jh)
    for h in (jh, th, oh):
        h.reject_plan = True
    jh.process(jgs.ServiceScheduler, ev, use_tpu=True, seed=seed)
    tev = dataclass_from_dict(tstructs.Evaluation, eval_to_dict(ev))
    sched = th.process(tgs.ServiceScheduler, tev, device="cpu", seed=seed)
    oh.process(tgs.ServiceScheduler, tev, use_device=False, seed=seed)
    return plan_view(jh), plan_view(th), plan_view(oh), sched


def enable_preemption(h):
    h.store.set_scheduler_config(
        SchedulerConfiguration(
            preemption_config=PreemptionConfig(
                service_scheduler_enabled=True
            )
        )
    )


def fleet(h, n, cpu=2000, mem=2048, prefix="pn", racks=3):
    nodes = []
    for i in range(n):
        node = jmock.node(id=f"{prefix}-{i:02d}")
        node.node_resources.cpu = cpu
        node.node_resources.memory_mb = mem
        node.attributes["rack"] = f"r{i % racks}"
        node.meta["pool"] = prefix
        node.computed_class = compute_node_class(node)
        h.store.upsert_node(node)
        nodes.append(node)
    return nodes


def occupy(h, job_id, priority, count, cpu, mem, seed, networks=None,
           pool=None):
    """Place `count` allocs of a job at `priority` with the host oracle
    (the plan is applied), on the nodes of `pool` when given."""
    job = jmock.job(id=job_id)
    job.priority = priority
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].resources.cpu = cpu
    job.task_groups[0].tasks[0].resources.memory_mb = mem
    if networks is not None:
        job.task_groups[0].networks = networks
    if pool is not None:
        job.constraints = [Constraint("${meta.pool}", pool, "=")]
    h.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id, priority=priority)
    h.process(jgs.ServiceScheduler, ev, use_tpu=False, seed=seed)
    return job


def high_job(h, job_id, count, cpu=1200, mem=1000, priority=80):
    job = jmock.job(id=job_id)
    job.priority = priority
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].resources.cpu = cpu
    job.task_groups[0].tasks[0].resources.memory_mb = mem
    return job


def submit(h, job):
    h.store.upsert_job(job)
    return jmock.evaluation(job_id=job.id, priority=job.priority)


def mixed_fleet(h):
    """test_parity.py's mixed fleet: 12 nodes, 5 filled at priority 20
    (preemptible by a priority-80 job), 4 at 75 (not preemptible), 3
    free."""
    fleet(h, 12)
    for tier, (pri, count) in enumerate(((20, 5), (75, 4))):
        occupy(h, f"occ-{tier}", pri, count, 1500, 1600, seed=tier)


class PreemptSpy:
    """Counts the port's preemption-mode selects and their exact evict
    evaluations, wrapping the stack's methods for one test."""

    def __init__(self, monkeypatch):
        self.selects = 0
        self.evict_evals = 0
        orig_select = tcuda.CudaGenericStack._preempt_select
        orig_verify = tcuda.CudaGenericStack._verify_winner

        def select(stack, tg, options):
            self.selects += 1
            return orig_select(stack, tg, options)

        def verify(stack, node_id, tg, evict=False):
            self.evict_evals += int(evict)
            return orig_verify(stack, node_id, tg, evict)

        monkeypatch.setattr(tcuda.CudaGenericStack, "_preempt_select", select)
        monkeypatch.setattr(tcuda.CudaGenericStack, "_verify_winner", verify)


def assert_three_way(jh, ev, seed, monkeypatch, min_preempted=1):
    spy = PreemptSpy(monkeypatch)
    j, t, o, _ = three_way(jh, ev, seed)
    assert t[0] == j[0], f"placements: jax={j[0]} port={t[0]}"
    assert t[0] == o[0], f"placements: oracle={o[0]} port={t[0]}"
    assert t[1] == j[1], "preemption sets differ from the JAX package"
    assert t[1] == o[1], "preemption sets differ from the host oracle"
    assert t[2] == j[2], "AllocMetrics differ from the JAX package"
    assert len(t[1]) >= min_preempted, "nothing was preempted"
    assert spy.selects >= 1, "no select took the preempt branch"
    return t, spy


def test_preemption_parity(monkeypatch):
    """test_parity.py:249: four full nodes of priority-20 allocs, a
    priority-80 job of two."""
    jh = JHarness()
    fleet(jh, 4)
    occupy(jh, "low", 20, 4, 1500, 1200, seed=5)
    enable_preemption(jh)
    ev = submit(jh, high_job(jh, "high", 2))
    t, _ = assert_three_way(jh, ev, 6, monkeypatch)
    assert len(t[0]) == 2


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_preemption_parity_mixed_fleet(monkeypatch, seed):
    """test_parity.py:303: several priority tiers, free nodes, and
    nodes the shortfall pre-filter must skip."""
    jh = JHarness()
    mixed_fleet(jh)
    enable_preemption(jh)
    ev = submit(jh, high_job(jh, "high", 6))
    t, spy = assert_three_way(jh, ev, seed, monkeypatch)
    assert len(t[0]) == 6
    assert spy.evict_evals >= 1


def test_preemption_with_affinity(monkeypatch):
    """A node affinity makes every preempt walk unlimited (limit ==
    INT32_MAX): pulls count every candidate."""
    jh = JHarness()
    mixed_fleet(jh)
    enable_preemption(jh)
    job = high_job(jh, "high-aff", 6)
    job.affinities = [Affinity("${attr.rack}", "r1", "=", 50)]
    ev = submit(jh, job)
    t, _ = assert_three_way(jh, ev, 12, monkeypatch)
    assert len(t[0]) == 6
    # an unlimited walk evaluates every candidate
    assert all(m["nodes_evaluated"] >= 12 for m in t[2].values())


def test_preemption_with_distinct_hosts(monkeypatch):
    """distinct_hosts masks the job's own rows in the preempt mask and
    the capture attributes them to the constraint."""
    jh = JHarness()
    mixed_fleet(jh)
    enable_preemption(jh)
    job = high_job(jh, "high-dh", 5)
    job.constraints = [Constraint(operand="distinct_hosts")]
    ev = submit(jh, job)
    t, _ = assert_three_way(jh, ev, 13, monkeypatch)
    assert len({node for _, node in t[0]}) == len(t[0]) == 5


@pytest.mark.parametrize("seed", [4, 5])
def test_preemption_rewalks_port_collision(monkeypatch, seed):
    """Four large nodes fit the job's cpu and memory, but a priority-20
    alloc on each holds the reserved port the job asks for; four small
    nodes are full of priority-20 allocs.  A large node that wins the
    walk fails exact verification on the port; its evict evaluation
    finds no network preemption (the oracle's Preemptor has none), so
    its row is masked on the card and the walk runs again, until a
    small node's spliced evict score wins."""
    jh = JHarness()
    port = [NetworkResource(reserved_ports=[Port("svc", 8080)])]
    fleet(jh, 4, cpu=4000, mem=4096, prefix="pp")
    occupy(jh, "port-low", 20, 4, 1500, 1024, seed=3, networks=port,
           pool="pp")
    fleet(jh, 4, cpu=2000, mem=2048, prefix="pc")
    occupy(jh, "cpu-low", 20, 4, 1500, 1200, seed=4, pool="pc")
    enable_preemption(jh)
    job = high_job(jh, "port-high", 1, cpu=1200, mem=512)
    job.task_groups[0].networks = port
    ev = submit(jh, job)
    walks = []
    orig = tscore.walk_only

    def counted(*args):
        walks.append(args)
        return orig(*args)

    monkeypatch.setattr(tcuda, "walk_only", counted)
    t, spy = assert_three_way(jh, ev, seed, monkeypatch)
    assert len(t[0]) == 1 and t[0][0][1].startswith("pc-")
    # port-collided winners were masked and the walk ran again
    assert len(walks) >= 2
    assert spy.evict_evals >= len(walks)


def test_preemption_blocked_metrics(monkeypatch):
    """Nothing is preemptible (every occupant within the priority
    delta): the preempt select fails, and the blocked eval's
    FailedTGAllocs metrics equal the JAX package's."""
    jh = JHarness()
    fleet(jh, 4)
    occupy(jh, "peer", 75, 4, 1500, 1200, seed=2)
    enable_preemption(jh)
    job = high_job(jh, "high-none", 1)
    ev = submit(jh, job)
    th = carry(jh)
    jh.reject_plan = th.reject_plan = True
    jsched = jh.process(jgs.ServiceScheduler, ev, use_tpu=True, seed=3)
    tev = dataclass_from_dict(tstructs.Evaluation, eval_to_dict(ev))
    tsched = th.process(tgs.ServiceScheduler, tev, device="cpu", seed=3)
    jf = {k: metric_fields(m) for k, m in jsched.failed_tg_allocs.items()}
    tf = {k: metric_fields(m) for k, m in tsched.failed_tg_allocs.items()}
    assert jf and tf == jf
    assert tf["web"]["nodes_evaluated"] > 0


# ---------------------------------------------------------------------------
# K6's twin against the JAX _walk_only
# ---------------------------------------------------------------------------


def _jax_walk(case):
    return [
        np.asarray(x)
        for x in _walk_only(
            jnp.asarray(case["feasible"]),
            jnp.asarray(case["scores"]),
            jnp.asarray(case["perm"]),
            jnp.asarray(case["limit"], jnp.int32),
            jnp.asarray(case["n_candidates"], jnp.int32),
        )
    ]


def _bits(x):
    x = np.asarray(x)
    if x.dtype == np.float64:
        return x.view(np.int64)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("C", [8, 1024, 16384])
@pytest.mark.parametrize("scenario", sorted(WALK_SCENARIOS))
def test_walk_twin_matches_jax_walk_only(scenario, C, dtype):
    for k, limit in enumerate((1, 2, 14, INT32_MAX)):
        case = walk_case(700 + 17 * k + C, C, scenario, limit, dtype)
        want = _jax_walk(case)
        got = tscore.limited_walk_argmax(
            torch.from_numpy(case["feasible"]),
            torch.from_numpy(case["scores"]),
            torch.from_numpy(case["perm"]),
            case["limit"],
            case["n_candidates"],
        )
        for name, w, g in zip(("row", "best", "count", "pulls"), want, got):
            assert _bits(g.numpy()) == _bits(w.astype(g.numpy().dtype)), (
                f"{scenario} C={C} limit={limit} {name}: "
                f"jax={w} port={g}"
            )
        # the stack's wrapper gives the same numbers on the CPU
        row, best, count, pulls = tscore.walk_only(
            torch.from_numpy(case["feasible"]),
            torch.from_numpy(case["scores"]),
            torch.from_numpy(case["perm"]),
            case["limit"], case["n_candidates"],
        )
        assert (row, count, pulls) == (int(want[0]), int(want[2]),
                                      int(want[3]))
        assert _bits(np.asarray(best, dtype)) == _bits(want[1])


def test_walk_cases_cover_the_edges():
    """The seeded cases reach what the walk must get right: one and two
    diverted nodes, a limit below and above the emitted count, the
    unlimited walk, and no node at all."""
    seen = set()
    for scenario in WALK_SCENARIOS:
        for limit in (2, INT32_MAX):
            case = walk_case(1, 1024, scenario, limit, np.float64)
            row, _best, count, pulls = (
                int(x) if i != 1 else float(x)
                for i, x in enumerate(_jax_walk(case))
            )
            f = case["feasible"][case["perm"]]
            s = case["scores"][case["perm"]]
            n_bad = int((f & (s <= 0)).sum())
            if row == -1:
                seen.add("no_node")
            if 1 <= n_bad <= 3:
                seen.add(f"diverted{min(n_bad, 2)}")
            if limit == INT32_MAX:
                assert pulls == case["n_candidates"]
                seen.add("unlimited")
            elif count > limit:
                seen.add("limit_below")
            else:
                seen.add("limit_above")
    assert {"no_node", "diverted1", "diverted2", "unlimited",
            "limit_below", "limit_above"} <= seen, seen


def test_preempt_select_device_fault(monkeypatch):
    """A failing walk (K6's build, launch or fetch) is a DeviceFault,
    never a fallback."""
    from nomad_tpu_torch.device import DeviceFault

    def broken(*args):
        raise RuntimeError("launch refused")

    jh = JHarness()
    fleet(jh, 4)
    occupy(jh, "low", 20, 4, 1500, 1200, seed=5)
    enable_preemption(jh)
    ev = submit(jh, high_job(jh, "high", 1))
    th = carry(jh)
    th.reject_plan = True
    monkeypatch.setattr(tcuda, "walk_only", broken)
    tev = dataclass_from_dict(tstructs.Evaluation, eval_to_dict(ev))
    with pytest.raises(DeviceFault):
        th.process(tgs.ServiceScheduler, tev, device="cpu", seed=6)


# ---------------------------------------------------------------------------
# the sequential Server with service preemption on
# ---------------------------------------------------------------------------


def _server_stream(server, pkg):
    """Eight full nodes of priority-20 fillers, then four priority-80
    jobs that can only land by preempting; returns placements, the
    evicted (name, node) pairs and the explain records of every eval."""
    import copy

    server.start()
    try:
        for i in range(8):
            node = pkg.mock.node(id=f"ps-{i:02d}", name=f"ps{i}")
            node.node_resources.cpu = 2000
            node.node_resources.memory_mb = 2048
            node.computed_class = pkg.structs.compute_node_class(node)
            server.register_node(copy.deepcopy(node))
        filler = pkg.mock.job(id="filler")
        filler.priority = 20
        filler.task_groups[0].count = 8
        filler.task_groups[0].tasks[0].resources.cpu = 1500
        filler.task_groups[0].tasks[0].resources.memory_mb = 1200
        server.register_job(filler)
        assert server.drain_to_idle(60)
        cfg = server.store.get_scheduler_config()
        cfg.preemption_config.service_scheduler_enabled = True
        server.store.set_scheduler_config(cfg)
        for k, count in enumerate((1, 1, 2, 1)):
            job = pkg.mock.job(id=f"urgent-{k}")
            job.priority = 80
            job.task_groups[0].count = count
            job.task_groups[0].tasks[0].resources.cpu = 1200
            job.task_groups[0].tasks[0].resources.memory_mb = 1000
            server.register_job(job)
            assert server.drain_to_idle(60)
        allocs = list(server.store.allocs.values())
        placed = sorted(
            (a.name, a.node_id) for a in allocs if not a.terminal_status()
        )
        evicted = sorted(
            (a.name, a.node_id) for a in allocs
            if a.desired_status == "evict"
        )
        from importlib import import_module

        ring = import_module(pkg.explain).EXPLAIN
        records = []
        for ev in server.store.evals.values():
            rec = ring.get(ev.id)
            if rec is None:
                continue
            rec = copy.deepcopy(rec)
            for key in ("EvalID", "TraceID", "RecordedAt"):
                rec.pop(key)
            for tg in rec["TaskGroups"].values():
                if tg["Metric"] is not None:
                    tg["Metric"].pop("AllocationTime")
            records.append(rec)
        records.sort(key=repr)
        return placed, evicted, records, server.workers[0]
    finally:
        server.stop()


def test_sequential_server_preempts_like_jax():
    import types

    import nomad_tpu.mock as jm
    import nomad_tpu.structs as js
    import nomad_tpu_torch.mock as tm
    from nomad_tpu.server import Server as JaxServer
    from nomad_tpu_torch.server import Server as TorchServer

    def make(cls, **kw):
        server = cls(num_schedulers=1, seed=17, batch_pipeline=False,
                     heartbeat_ttl=1e9, **kw)
        cfg = server.store.get_scheduler_config()
        cfg.tpu_scheduler_enabled = True  # the per-eval device stack
        server.store.set_scheduler_config(cfg)
        return server

    jax_pkg = types.SimpleNamespace(mock=jm, structs=js,
                                    explain="nomad_tpu.explain")
    port_pkg = types.SimpleNamespace(mock=tm, structs=tstructs,
                                     explain="nomad_tpu_torch.explain")
    want = _server_stream(make(JaxServer), jax_pkg)
    spy_calls = []
    orig = tcuda.CudaGenericStack._preempt_select

    def spy(stack, tg, options):
        spy_calls.append(tg.name)
        return orig(stack, tg, options)

    tcuda.CudaGenericStack._preempt_select = spy
    try:
        got = _server_stream(make(TorchServer, device="cpu"), port_pkg)
    finally:
        tcuda.CudaGenericStack._preempt_select = orig
    assert got[3].errors == 0
    assert got[0] == want[0], "placements differ"
    assert got[1] == want[1], "preemption sets differ"
    assert len(got[1]) >= 5
    assert got[2] == want[2], "explain records differ"
    assert len(got[2]) >= 5
    assert len(spy_calls) >= 5


def test_sequential_server_stops_on_a_walk_fault(monkeypatch):
    """A failing K6 walk under the sequential Server stops its worker:
    the eval is nacked, `errors` counts it and drain_to_idle raises the
    DeviceFault, never a host-oracle placement."""
    from nomad_tpu_torch import mock as tm
    from nomad_tpu_torch.device import DeviceFault
    from nomad_tpu_torch.server import Server as TorchServer

    def broken(*args):
        raise RuntimeError("launch refused")

    server = TorchServer(num_schedulers=1, seed=3, batch_pipeline=False,
                         heartbeat_ttl=1e9, device="cpu")
    cfg = server.store.get_scheduler_config()
    cfg.tpu_scheduler_enabled = True
    cfg.preemption_config.service_scheduler_enabled = True
    server.store.set_scheduler_config(cfg)
    server.start()
    try:
        for i in range(4):
            node = tm.node(id=f"wf-{i}")
            node.node_resources.cpu = 2000
            server.register_node(node)
        low = tm.job(id="wf-low")
        low.priority = 20
        low.task_groups[0].count = 4
        low.task_groups[0].tasks[0].resources.cpu = 1500
        server.register_job(low)
        assert server.drain_to_idle(60)
        monkeypatch.setattr(tcuda, "walk_only", broken)
        high = tm.job(id="wf-high")
        high.priority = 80
        high.task_groups[0].count = 1
        high.task_groups[0].tasks[0].resources.cpu = 1200
        server.register_job(high)
        with pytest.raises(DeviceFault):
            server.drain_to_idle(30)
        worker = server.workers[0]
        assert worker.errors == 1
        assert isinstance(worker.fault, DeviceFault)
        assert not [a for a in server.store.allocs_by_job("default", "wf-high")]
    finally:
        server.stop()
