"""Port parity at the scheduler level: the `tests/test_parity.py`
families run through the JAX package's ServiceScheduler/BatchScheduler
on its device stack (``use_tpu=True``) and through the port's
schedulers on ``device="cpu"`` (the CUDA stack with the plain twins).

Both sides start from one world: it is built in the JAX package's
store (node ids given explicitly) and carried across with the port's
`load_cluster`.  Placements (sorted alloc name, node id) and stop sets
must be identical.
"""
import dataclasses
import random

import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.api.codec import (
    alloc_to_dict,
    eval_to_dict,
    job_to_dict,
    node_to_dict,
)
from nomad_tpu.sched import generic_sched as jgs
from nomad_tpu.sched.testing import Harness as JHarness
from nomad_tpu.structs import (
    Affinity,
    Constraint,
    SchedulerConfiguration,
    Spread,
    SpreadTarget,
    compute_node_class,
)
from nomad_tpu_torch import structs as tstructs
from nomad_tpu_torch.sched import generic_sched as tgs
from nomad_tpu_torch.sched.testing import Harness as THarness
from nomad_tpu_torch.state.convert import dataclass_from_dict, load_cluster


def cluster(h, n_nodes, seed, datacenters=("dc1", "dc2"), racks=5):
    """heterogeneous_cluster (tests/conftest.py) with explicit node ids."""
    rng = random.Random(seed)
    for i in range(n_nodes):
        n = jmock.node(id=f"node-{seed}-{i:03d}")
        n.node_resources.cpu = rng.choice([2000, 4000, 8000])
        n.node_resources.memory_mb = rng.choice([4096, 8192, 16384])
        n.datacenter = rng.choice(list(datacenters))
        n.attributes["rack"] = f"r{rng.randint(0, racks - 1)}"
        n.attributes["driver.docker"] = rng.choice(["1", "1", "1", "0"])
        n.attributes["os.version"] = rng.choice(["20.04", "22.04", "24.04"])
        n.computed_class = compute_node_class(n)
        h.store.upsert_node(n)


def carry(jh):
    """The JAX harness's world as a fresh port harness."""
    s = jh.store
    jobs = []
    for versions in s.job_versions.values():
        jobs.extend(job_to_dict(j) for j in reversed(versions))
    store = load_cluster(
        [node_to_dict(n) for n in s.nodes.values()],
        jobs,
        [alloc_to_dict(a) for a in s.allocs.values()],
        scheduler_config=dataclasses.asdict(s.snapshot().scheduler_config()),
    )
    return THarness(store=store)


def outcome(h):
    plan = h.plans[-1]
    placed = sorted(
        (a.name, a.node_id)
        for v in plan.node_allocation.values()
        for a in v
    )
    stops = sorted(
        (a.id, a.desired_status)
        for v in plan.node_update.values()
        for a in v
    )
    return placed, stops


def run_both(jh, kind, ev, seed):
    """One eval through each package against identical, unmutated
    state; returns (jax outcome, port outcome, jax harness, port
    harness)."""
    th = carry(jh)
    jh.reject_plan = True
    th.reject_plan = True
    jfactory = jgs.BatchScheduler if kind == "batch" else jgs.ServiceScheduler
    tfactory = tgs.BatchScheduler if kind == "batch" else tgs.ServiceScheduler
    jh.process(jfactory, ev, use_tpu=True, seed=seed)
    tev = dataclass_from_dict(tstructs.Evaluation, eval_to_dict(ev))
    th.process(tfactory, tev, device="cpu", seed=seed)
    return outcome(jh), outcome(th), jh, th


def assert_identical(jh, kind, ev, seed):
    j, t, _, _ = run_both(jh, kind, ev, seed)
    assert t[0] == j[0], f"placements diverged:\n jax={j[0]}\n port={t[0]}"
    assert t[1] == j[1], "stop sets diverged"
    return t[0]


@pytest.mark.parametrize("trial", range(3))
def test_service_binpack(trial):
    jh = JHarness()
    cluster(jh, 60, seed=trial)
    job = jmock.job(id=f"svc-{trial}", datacenters=["dc1", "dc2"])
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    assert len(assert_identical(jh, "service", ev, trial * 17 + 3)) == 10


@pytest.mark.parametrize("trial", range(2))
def test_batch(trial):
    jh = JHarness()
    cluster(jh, 40, seed=trial + 100)
    job = jmock.batch_job(id=f"batch-{trial}", datacenters=["dc1", "dc2"])
    job.task_groups[0].count = 7
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id, type="batch")
    assert len(assert_identical(jh, "batch", ev, trial * 13 + 5)) == 7


@pytest.mark.parametrize("trial", range(2))
def test_constraints(trial):
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
    assert_identical(jh, "service", ev, trial * 7 + 1)


@pytest.mark.parametrize("trial", range(2))
def test_spread_affinity(trial):
    jh = JHarness()
    cluster(jh, 60, seed=trial + 300, datacenters=("dc1", "dc2", "dc3"))
    job = jmock.job(id=f"spr-{trial}", datacenters=["dc1", "dc2", "dc3"])
    job.affinities = [
        Affinity("${attr.rack}", "r1", "=", 50),
        Affinity("${node.datacenter}", "dc3", "=", -30),
    ]
    job.spreads = [
        Spread(
            attribute="${node.datacenter}",
            weight=70,
            targets=(
                SpreadTarget("dc1", 50),
                SpreadTarget("dc2", 30),
                SpreadTarget("dc3", 20),
            ),
        )
    ]
    job.task_groups[0].count = 12
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    assert len(assert_identical(jh, "service", ev, trial * 11 + 9)) == 12


@pytest.mark.parametrize("trial", range(2))
def test_even_spread(trial):
    jh = JHarness()
    cluster(jh, 45, seed=trial + 400, datacenters=("dc1", "dc2", "dc3"))
    job = jmock.job(id=f"even-{trial}", datacenters=["dc1", "dc2", "dc3"])
    job.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
    job.task_groups[0].count = 9
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    assert_identical(jh, "service", ev, trial + 21)


def test_affinity_only_unlimited_walk():
    """A node affinity without spreads: the look-ahead runs with the
    unlimited walk (limit INT32_MAX)."""
    jh = JHarness()
    cluster(jh, 50, seed=450)
    job = jmock.job(id="aff", datacenters=["dc1", "dc2"])
    job.affinities = [Affinity("${attr.rack}", "r2", "=", 60)]
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    assert len(assert_identical(jh, "service", ev, 23)) == 10


@pytest.mark.parametrize("trial", range(2))
def test_distinct_hosts(trial):
    jh = JHarness()
    cluster(jh, 30, seed=trial + 500)
    job = jmock.job(id=f"dh-{trial}", datacenters=["dc1", "dc2"])
    job.constraints.append(Constraint(operand="distinct_hosts"))
    job.task_groups[0].count = 8
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    placements = assert_identical(jh, "service", ev, trial + 31)
    assert len({n for _, n in placements}) == 8


@pytest.mark.parametrize("trial", range(2))
def test_distinct_property(trial):
    jh = JHarness()
    cluster(jh, 40, seed=trial + 600, racks=6)
    job = jmock.job(id=f"dp-{trial}", datacenters=["dc1", "dc2"])
    job.constraints.append(
        Constraint("${attr.rack}", "2", "distinct_property")
    )
    job.task_groups[0].count = 6
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    assert_identical(jh, "service", ev, trial + 41)


def test_existing_allocs_and_scale_up():
    """Second eval on a placed job scaled up: anti-affinity collisions,
    proposed-usage deltas and in-place updates must match."""
    jh = JHarness()
    cluster(jh, 40, seed=700)
    job = jmock.job(id="scale", datacenters=["dc1", "dc2"])
    jh.store.upsert_job(job)
    jh.process(
        jgs.ServiceScheduler, jmock.evaluation(job_id=job.id),
        use_tpu=False, seed=1,
    )
    job2 = jmock.job(id="scale", datacenters=["dc1", "dc2"])
    job2.task_groups[0].count = 18
    jh.store.upsert_job(job2)
    ev2 = jmock.evaluation(job_id=job.id)
    placements = assert_identical(jh, "service", ev2, 2)
    assert len(placements) == 18


def test_exhaustion_creates_blocked_eval():
    jh = JHarness()
    for i in range(3):
        n = jmock.node(id=f"small-{i}")
        n.node_resources.cpu = 1000
        n.node_resources.memory_mb = 1024
        n.computed_class = compute_node_class(n)
        jh.store.upsert_node(n)
    job = jmock.job(id="big")
    job.task_groups[0].count = 20
    job.task_groups[0].tasks[0].resources.cpu = 400
    job.task_groups[0].tasks[0].resources.memory_mb = 300
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    j, t, jh2, th = run_both(jh, "service", ev, 3)
    assert t == j
    assert len(th.create_evals) == len(jh2.create_evals) >= 1
    assert th.create_evals[0].status == jh2.create_evals[0].status


def test_spread_algorithm():
    jh = JHarness()
    cluster(jh, 30, seed=800)
    jh.store.set_scheduler_config(
        SchedulerConfiguration(scheduler_algorithm="spread")
    )
    job = jmock.job(id="spreadalg", datacenters=["dc1", "dc2"])
    jh.store.upsert_job(job)
    ev = jmock.evaluation(job_id=job.id)
    assert_identical(jh, "service", ev, 4)


def test_no_card_means_no_device_scheduler():
    """Without a card, the default device is refused instead of
    silently running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    from nomad_tpu_torch.device import NoDeviceError
    from nomad_tpu_torch.sched import new_scheduler

    th = THarness()
    with pytest.raises(NoDeviceError):
        tgs.ServiceScheduler(th.snapshot(), th)
    with pytest.raises(NoDeviceError):
        new_scheduler("service", th.snapshot(), th)
    # the host oracle and the CPU twins need no card
    tgs.ServiceScheduler(th.snapshot(), th, use_device=False)
    new_scheduler("batch", th.snapshot(), th, device="cpu")


def test_alloc_metric_score_node_matches_jax():
    """The port's AllocMetric indexes score metadata by node id (the
    oracle's unlimited walk was quadratic without it); the recorded
    entries must equal the JAX package's linear-search version."""
    from nomad_tpu.structs import AllocMetric as JMetric

    rng = random.Random(4)
    nodes = [jmock.node(id=f"m-{i}") for i in range(40)]
    jm, tm = JMetric(), tstructs.AllocMetric()
    for step in range(600):
        n = rng.choice(nodes)
        name = rng.choice(["binpack", "job-anti-affinity", "normalized-score"])
        score = rng.uniform(-1, 1)
        jm.score_node(n, name, score)
        tm.score_node(n, name, score)
        if step == 300:
            # a list replaced behind the index's back is re-indexed
            jm.score_meta = jm.score_meta[::2]
            tm.score_meta = tm.score_meta[::2]
    want = [(m.node_id, m.scores, m.norm_score) for m in jm.score_meta]
    got = [(m.node_id, m.scores, m.norm_score) for m in tm.score_meta]
    assert got == want
