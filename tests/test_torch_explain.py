"""Placement explainability in the port: the AllocMetric capture of the
CUDA stack and the port's own explain ring.

The port's per-eval stack rebuilds the serial chain's AllocMetric from
each select's arrays, as the JAX package's `TPUGenericStack` does.  The
families of `tests/test_placement_explain.py` run through the JAX
package's schedulers on its device stack (``use_tpu=True``) and through
the port's on ``device="cpu"``, from one world built in the JAX store
and carried across with `load_cluster`: every AllocMetric field but the
wall-clock ``allocation_time_s`` must be equal, for placed allocs and for
a blocked eval's FailedTGAllocs, with the capture on and off.  The
port's device stack must also agree with its own host oracle chain on
the serial chain's summary (the comparison the JAX package's tests make
between its two paths).

The port's ring, counters and opt-out are its own: recording in one
package's ring leaves the other's unchanged.
"""
import dataclasses

import pytest

from nomad_tpu import explain as jexplain
from nomad_tpu import mock as jmock
from nomad_tpu.api.codec import eval_to_dict
from nomad_tpu.sched import generic_sched as jgs
from nomad_tpu.sched.testing import Harness as JHarness
from nomad_tpu.structs import Constraint, compute_node_class
from nomad_tpu_torch import explain as texplain
from nomad_tpu_torch import structs as tstructs
from nomad_tpu_torch.sched import generic_sched as tgs
from nomad_tpu_torch.sched.feasible import (
    FILTER_CLASS_INELIGIBLE,
    FILTER_CONSTRAINT_CSI_VOLUMES,
    FILTER_CONSTRAINT_DEVICES,
    FILTER_CONSTRAINT_DRIVERS,
    FILTER_CONSTRAINT_HOST_VOLUMES,
    FILTER_CONSTRAINT_NETWORK,
)
from nomad_tpu_torch.state.convert import dataclass_from_dict

from test_torch_sched import carry, cluster


def metric_fields(m):
    """Every AllocMetric field but the wall-clock allocation time."""
    d = dataclasses.asdict(m)
    d.pop("allocation_time_s")
    return d


def summary(m, node_id=None):
    """The serial chain's summary that the JAX package's own tests hold
    its two paths to (test_placement_explain.py _placed_metrics)."""
    out = (
        m.nodes_evaluated, m.nodes_filtered, m.nodes_exhausted,
        dict(m.constraint_filtered), dict(m.class_filtered),
        dict(m.dimension_exhausted),
        sorted(
            (s.node_id, tuple(sorted(s.scores.items())), s.norm_score)
            for s in m.score_meta
        ),
    )
    if node_id is not None:
        out += (m.node_norm_score(node_id),)
    return out


def views(h, sched):
    """Placed allocs' metrics of the last plan and the failed groups'."""
    placed = {}
    if h.plans:
        for v in h.plans[-1].node_allocation.values():
            for a in v:
                placed[a.name] = (a.node_id, a.metrics)
    failed = dict(sched.failed_tg_allocs)
    return placed, failed


def run_all(jh, kind, ev, seed):
    """One eval through the JAX device stack, the port's device stack on
    the CPU and the port's host oracle, on the same unmutated world."""
    th = carry(jh)
    oh = carry(jh)
    for h in (jh, th, oh):
        h.reject_plan = True
    jf = jgs.BatchScheduler if kind == "batch" else jgs.ServiceScheduler
    tf = tgs.BatchScheduler if kind == "batch" else tgs.ServiceScheduler
    jn, tn, on = len(jh.plans), len(th.plans), len(oh.plans)
    js = jh.process(jf, ev, use_tpu=True, seed=seed)
    tev = dataclass_from_dict(tstructs.Evaluation, eval_to_dict(ev))
    ts = th.process(tf, tev, device="cpu", seed=seed)
    os_ = oh.process(tf, tev, use_device=False, seed=seed)
    out = []
    for h, s, n in ((jh, js, jn), (th, ts, tn), (oh, os_, on)):
        placed, failed = views(h, s)
        if len(h.plans) == n:
            placed = {}  # nothing was submitted by this run
        out.append((placed, failed))
    return out


def assert_metrics_equal(jax_view, port_view, oracle_view):
    (jp, jfail), (tp, tfail), (op, ofail) = jax_view, port_view, oracle_view
    assert sorted((k, v[0]) for k, v in tp.items()) == sorted(
        (k, v[0]) for k, v in jp.items()
    ), "placements differ from the JAX package"
    for name, (node_id, m) in tp.items():
        assert metric_fields(m) == metric_fields(jp[name][1]), name
        assert summary(m, node_id) == summary(op[name][1], node_id), name
    assert {k: metric_fields(m) for k, m in tfail.items()} == {
        k: metric_fields(m) for k, m in jfail.items()
    }
    assert {k: summary(m) for k, m in tfail.items()} == {
        k: summary(m) for k, m in ofail.items()
    }


def test_fault_probe_alloc_metric_matches_jax():
    """The fault this slice repairs: a count-3 service job on a 40-node
    cluster.  Every JAX alloc reports six evaluated nodes and six score
    entries; the port's must report the same, field for field (before
    the repair it reported 0 evaluated and only the winner's binpack)."""
    jh = JHarness()
    cluster(jh, 40, seed=3)
    job = jmock.job(id="probe", datacenters=["dc1", "dc2"])
    job.task_groups[0].count = 3
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    j, t, o = run_all(jh, "service", ev, 7)
    assert_metrics_equal(j, t, o)
    assert len(t[0]) == 3
    for _node, m in t[0].values():
        assert m.nodes_evaluated == 6
        assert len(m.score_meta) == 6


@pytest.mark.parametrize("trial", range(4))
def test_metric_parity_plain_service(trial):
    jh = JHarness()
    cluster(jh, 50, seed=trial)
    job = jmock.job(id=f"svc-{trial}", datacenters=["dc1", "dc2"])
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    j, t, o = run_all(jh, "service", ev, trial * 17 + 3)
    assert_metrics_equal(j, t, o)
    assert all(m.score_meta for _n, m in t[0].values())


@pytest.mark.parametrize("trial", range(4))
def test_metric_parity_constraint_filtering(trial):
    """Per-reason constraint_filtered totals, including the wrapper's
    computed-class memoization."""
    jh = JHarness()
    cluster(jh, 50, seed=trial + 200)
    job = jmock.job(id=f"cons-{trial}", datacenters=["dc1", "dc2"])
    job.constraints = [
        Constraint("${attr.kernel.name}", "linux", "="),
        Constraint("${attr.os.version}", "2[02].04", "regexp"),
    ]
    job.task_groups[0].constraints = [
        Constraint("${attr.nomad.version}", ">= 0.9", "version"),
        Constraint("${attr.rack}", "r4", "!="),
    ]
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    j, t, o = run_all(jh, "service", ev, trial * 7 + 1)
    assert_metrics_equal(j, t, o)
    assert any(m.nodes_filtered > 0 for _n, m in t[0].values())


def test_metric_parity_class_memoization():
    """Eight nodes of one computed class fail a job constraint: the
    first is filtered on the constraint, the rest as 'computed class
    ineligible'."""
    jh = JHarness()
    for i in range(8):
        n = jmock.node(id=f"memo-{i}")
        n.attributes["rack"] = "r9"
        n.computed_class = compute_node_class(n)
        jh.store.upsert_node(n)
    good = jmock.node(id="memo-good")
    good.attributes["rack"] = "r1"
    good.node_class = "good"
    good.computed_class = compute_node_class(good)
    jh.store.upsert_node(good)
    job = jmock.job(id="memo")
    job.task_groups[0].count = 1
    job.constraints = [Constraint("${attr.rack}", "r9", "!=")]
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    j, t, o = run_all(jh, "service", ev, 5)
    assert_metrics_equal(j, t, o)
    ((_node, m),) = t[0].values()
    if m.nodes_evaluated > 2:
        assert m.constraint_filtered.get(FILTER_CLASS_INELIGIBLE, 0) >= 1


@pytest.mark.parametrize("trial", range(3))
def test_metric_parity_batch_multi_count(trial):
    """Multi-count batch jobs serve picks from the look-ahead cache (one
    K2 launch per group); the serve-side capture must still match."""
    jh = JHarness()
    cluster(jh, 40, seed=trial + 100)
    job = jmock.batch_job(id=f"batch-{trial}", datacenters=["dc1", "dc2"])
    job.task_groups[0].count = 7
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id, type="batch")
    j, t, o = run_all(jh, "batch", ev, trial * 13 + 5)
    assert_metrics_equal(j, t, o)
    assert len(t[0]) == 7


def test_metric_parity_exhaustion_failure():
    """A job too big for every node: the blocked eval's FailedTGAllocs
    carry the full exhaustion histogram."""
    jh = JHarness()
    cluster(jh, 30, seed=7)
    job = jmock.job(id="huge", datacenters=["dc1", "dc2"])
    job.task_groups[0].tasks[0].resources.cpu = 100000
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    j, t, o = run_all(jh, "service", ev, 3)
    assert_metrics_equal(j, t, o)
    failed = t[1]["web"]
    assert failed.nodes_evaluated == 30
    assert failed.dimension_exhausted.get("cpu") == 30


def test_filter_totals_account_for_every_evaluated_node():
    """Filter-reason totals equal nodes_evaluated minus the scored and
    exhausted nodes."""
    jh = JHarness()
    cluster(jh, 50, seed=31)
    job = jmock.job(id="totals", datacenters=["dc1", "dc2"])
    job.constraints = [Constraint("${attr.rack}", "r[0-2]", "regexp")]
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    j, t, o = run_all(jh, "service", ev, 9)
    assert_metrics_equal(j, t, o)
    for _node, m in t[0].values():
        assert sum(m.constraint_filtered.values()) == m.nodes_filtered
        assert m.nodes_filtered + m.nodes_exhausted == (
            m.nodes_evaluated - len(m.score_meta)
        )


@pytest.fixture
def explain_off():
    """Both packages' capture off, restored afterwards."""
    saved = (jexplain.EXPLAIN.enabled, texplain.EXPLAIN.enabled)
    jexplain.EXPLAIN.set_enabled(False)
    texplain.EXPLAIN.set_enabled(False)
    try:
        yield
    finally:
        jexplain.EXPLAIN.set_enabled(saved[0])
        texplain.EXPLAIN.set_enabled(saved[1])


@pytest.mark.parametrize("kind", ["batch", "service_blocked"])
def test_explain_disabled_skips_capture(explain_off, kind):
    """NOMAD_TPU_EXPLAIN=0: decisions identical, and the metrics equal
    the JAX package's with its capture off too (nodes_evaluated stays 0
    on the device path's successful selects)."""
    jh = JHarness()
    cluster(jh, 40, seed=3)
    if kind == "batch":
        job = jmock.batch_job(id="off", datacenters=["dc1", "dc2"])
        job.task_groups[0].count = 5
    else:
        job = jmock.job(id="off-huge", datacenters=["dc1", "dc2"])
        job.task_groups[0].tasks[0].resources.cpu = 100000
    jh.store.upsert_job(job)
    ev = jmock.evaluation(
        job_id=job.id, type="batch" if kind == "batch" else "service"
    )
    (jp, jfail), (tp, tfail), (op, _ofail) = run_all(
        jh, "batch" if kind == "batch" else "service", ev, 21
    )
    assert sorted((k, v[0]) for k, v in tp.items()) == sorted(
        (k, v[0]) for k, v in op.items()
    )
    for name, (_node, m) in tp.items():
        assert metric_fields(m) == metric_fields(jp[name][1])
        assert m.nodes_evaluated == 0
    assert {k: metric_fields(m) for k, m in tfail.items()} == {
        k: metric_fields(m) for k, m in jfail.items()
    }
    if kind == "batch":
        assert len(tp) == 5
    else:
        assert tfail["web"].nodes_evaluated == 0


def test_explain_env_opt_out(monkeypatch):
    """NOMAD_TPU_EXPLAIN=0 disables a fresh recorder; any other value
    leaves it on."""
    monkeypatch.setenv("NOMAD_TPU_EXPLAIN", "0")
    assert not texplain.ExplainRecorder().enabled
    monkeypatch.setenv("NOMAD_TPU_EXPLAIN", "1")
    assert texplain.ExplainRecorder().enabled


def test_explain_ring_bounded():
    rec = texplain.ExplainRecorder(ring=8)
    rec.set_enabled(True)
    for i in range(20):
        rec.publish({"EvalID": f"e{i}", "TaskGroups": {}})
    assert len(rec.recent(limit=100)) == 8
    assert rec.get("e0") is None
    assert rec.get("e19") is not None
    # newest-wins per eval id: the superseded record leaves the listing
    rec.publish({"EvalID": "e19", "TaskGroups": {}, "v": 2})
    assert rec.get("e19")["v"] == 2
    listed = [r for r in rec.recent(limit=100) if r["EvalID"] == "e19"]
    assert len(listed) == 1 and listed[0]["v"] == 2


def test_reason_slugs_cover_serial_vocabulary():
    """Every serial-chain reason string folds into a non-'other' slug,
    every slug has a zero-registered counter, and the vocabulary equals
    the JAX package's."""
    cases = {
        FILTER_CLASS_INELIGIBLE: "class-ineligible",
        FILTER_CONSTRAINT_DRIVERS: "missing-drivers",
        FILTER_CONSTRAINT_DEVICES: "missing-devices",
        FILTER_CONSTRAINT_HOST_VOLUMES: "missing-host-volumes",
        FILTER_CONSTRAINT_CSI_VOLUMES: "missing-csi-plugins",
        FILTER_CONSTRAINT_NETWORK: "missing-network",
        "distinct_hosts": "distinct-hosts",
        "distinct_property: rack=r1 used by 2 allocs": "distinct-property",
        'missing property "${meta.rack}"': "distinct-property",
        "${attr.rack} = r4": "constraint",
    }
    for reason, slug in cases.items():
        assert texplain.reason_slug(reason) == slug, reason
        assert jexplain.reason_slug(reason) == slug, reason
        assert f"placement.filtered.{slug}" in texplain.PLACEMENT_COUNTERS
    for dim, slug in {
        "cpu": "cpu",
        "memory": "memory",
        "disk": "disk",
        "network: port collision": "ports",
        "devices: no instances available": "devices",
        "bandwidth exceeded": "bandwidth",
    }.items():
        assert texplain.dimension_slug(dim) == slug, dim
        assert f"placement.exhausted.{slug}" in texplain.PLACEMENT_COUNTERS
    assert texplain.PLACEMENT_COUNTERS == jexplain.PLACEMENT_COUNTERS
    assert texplain.PLACEMENT_GAUGES == jexplain.PLACEMENT_GAUGES


def test_rings_are_separate():
    """A record published in the port's ring leaves the JAX package's
    ring unchanged, and the reverse; the two recorders are distinct
    objects."""
    assert texplain.EXPLAIN is not jexplain.EXPLAIN
    before_j = [r["EvalID"] for r in jexplain.EXPLAIN.recent(limit=2000)]
    texplain.EXPLAIN.publish({"EvalID": "port-only-eval", "TaskGroups": {}})
    after_j = [r["EvalID"] for r in jexplain.EXPLAIN.recent(limit=2000)]
    assert after_j == before_j
    assert jexplain.EXPLAIN.get("port-only-eval") is None
    before_t = [r["EvalID"] for r in texplain.EXPLAIN.recent(limit=2000)]
    jexplain.EXPLAIN.publish({"EvalID": "jax-only-eval", "TaskGroups": {}})
    after_t = [r["EvalID"] for r in texplain.EXPLAIN.recent(limit=2000)]
    assert after_t == before_t
    assert texplain.EXPLAIN.get("jax-only-eval") is None
    assert texplain.EXPLAIN.get("port-only-eval") is not None


def test_server_preregisters_placement_family():
    """The port's Server zero-registers the whole placement.* family."""
    from nomad_tpu_torch.server import Server

    server = Server(batch_pipeline=False, device="cpu", seed=1,
                    heartbeat_ttl=1e9)
    counters = server.metrics.dump()["counters"]
    for name in texplain.PLACEMENT_COUNTERS:
        assert counters[name] == 0.0, name
