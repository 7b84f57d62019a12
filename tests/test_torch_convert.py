"""State carried across with `load_cluster`: the port's node arena must
equal the JAX package's node table column for column, and the wire
forms must round-trip through the port's decoder."""
import dataclasses
import random

import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.api.codec import alloc_to_dict, job_to_dict, node_to_dict
from nomad_tpu.sched.generic_sched import ServiceScheduler
from nomad_tpu.sched.testing import Harness
from nomad_tpu.structs import (
    Affinity,
    Constraint,
    NodeDeviceResource,
    Spread,
    SpreadTarget,
    compute_node_class,
)
from nomad_tpu_torch.state.convert import (
    alloc_from_dict,
    job_from_dict,
    load_cluster,
    node_from_dict,
)


def wire(value):
    """The JSON-safe form `_clean` gives (codec.py), for port objects."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            f.name: wire(getattr(value, f.name))
            for f in dataclasses.fields(value)
            if f.name not in ("job", "metrics")
        }
    if isinstance(value, dict):
        return {str(k): wire(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [wire(v) for v in value]
    if isinstance(value, bytes):
        import base64

        return base64.b64encode(value).decode()
    return value


def world(n_nodes=70, seed=3):
    """A JAX-side world: heterogeneous nodes (one drained, one with a
    device), a placed job and a second version of it."""
    h = Harness()
    rng = random.Random(seed)
    for i in range(n_nodes):
        n = jmock.node(id=f"conv-{i:03d}")
        n.node_resources.cpu = rng.choice([2000, 4000, 8000])
        n.node_resources.memory_mb = rng.choice([4096, 8192, 16384])
        n.datacenter = rng.choice(["dc1", "dc2"])
        n.attributes["rack"] = f"r{rng.randint(0, 4)}"
        n.meta["tier"] = rng.choice(["a", "b"])
        if i == 5:
            n.scheduling_eligibility = "ineligible"
        if i == 7:
            n.node_resources.devices = [
                NodeDeviceResource(vendor="nvidia", type="gpu", name="t4")
            ]
        n.computed_class = compute_node_class(n)
        h.store.upsert_node(n)
    job = jmock.job(id="conv-job", datacenters=["dc1", "dc2"])
    job.constraints.append(Constraint("${attr.rack}", "r4", "!="))
    job.affinities = [Affinity("${meta.tier}", "a", "=", 40)]
    job.spreads = [
        Spread(
            attribute="${node.datacenter}", weight=50,
            targets=(SpreadTarget("dc1", 60), SpreadTarget("dc2", 40)),
        )
    ]
    h.store.upsert_job(job)
    h.process(
        ServiceScheduler, jmock.evaluation(job_id=job.id),
        use_tpu=False, seed=1,
    )
    job2 = jmock.job(id="conv-job", datacenters=["dc1", "dc2"])
    job2.task_groups[0].count = 12
    h.store.upsert_job(job2)
    return h


def carried(h):
    s = h.store
    jobs = []
    for versions in s.job_versions.values():
        jobs.extend(job_to_dict(j) for j in reversed(versions))
    return load_cluster(
        [node_to_dict(n) for n in s.nodes.values()],
        jobs,
        [alloc_to_dict(a) for a in s.allocs.values()],
    )


def test_arena_columns_match_jax_node_table():
    h = world()
    store = carried(h)
    jt = h.store.node_table
    tt = store.node_table
    assert tt.capacity == jt.capacity
    assert tt.row_of == jt.row_of
    assert tt.node_ids == jt.node_ids
    for name in ("active", "eligible", "cpu_total", "mem_total",
                 "disk_total", "cpu_used", "mem_used", "disk_used"):
        np.testing.assert_array_equal(
            getattr(tt, name), getattr(jt, name), err_msg=name
        )
    assert set(tt.columns) == set(jt.columns)
    for key, col in jt.columns.items():
        tcol = tt.columns[key]
        # interned codes are per-store; compare the decoded values
        jv = [col.interner.values[c] if c >= 0 else None for c in col.codes]
        tv = [tcol.interner.values[c] if c >= 0 else None for c in tcol.codes]
        assert tv == jv, key


def test_wire_forms_round_trip():
    h = world()
    s = h.store
    for n in s.nodes.values():
        raw = node_to_dict(n)
        assert wire(node_from_dict(raw)) == raw
    for versions in s.job_versions.values():
        for j in versions:
            raw = job_to_dict(j)
            decoded = job_from_dict(raw)
            assert wire(decoded) == raw
    first = s.job_versions[("default", "conv-job")][-1]
    spread = job_from_dict(job_to_dict(first))
    assert isinstance(spread.spreads[0].targets, tuple)
    assert spread.spreads[0].targets[0].percent == 60
    for a in s.allocs.values():
        raw = alloc_to_dict(a)
        raw.pop("job_version")
        assert wire(alloc_from_dict(raw)) == raw


def test_load_cluster_keeps_versions_and_links_allocs():
    h = world()
    store = carried(h)
    job = store.job_by_id("default", "conv-job")
    assert job.version == h.store.job_by_id("default", "conv-job").version == 1
    allocs = store.allocs_by_job("default", "conv-job")
    assert len(allocs) == len(h.store.allocs_by_job("default", "conv-job"))
    assert all(a.job is not None and a.job.version == 0 for a in allocs)


@pytest.mark.parametrize("algorithm,service,batch,system,device", [
    ("binpack", False, False, True, False),
    ("spread", True, False, False, True),
    ("binpack", True, True, True, True),
])
def test_scheduler_config_round_trips(algorithm, service, batch, system,
                                      device):
    """The whole SchedulerConfiguration of a JAX store, preemption per
    scheduler type included, arrives in the port's store field for
    field."""
    from nomad_tpu.structs import PreemptionConfig, SchedulerConfiguration

    h = Harness()
    h.store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm=algorithm,
        preemption_config=PreemptionConfig(
            system_scheduler_enabled=system,
            batch_scheduler_enabled=batch,
            service_scheduler_enabled=service,
        ),
        tpu_scheduler_enabled=device,
    ))
    want = dataclasses.asdict(h.store.snapshot().scheduler_config())
    store = load_cluster([], [], [], scheduler_config=want)
    got = store.get_scheduler_config()
    assert dataclasses.asdict(got) == want
    assert got.preemption_config.service_scheduler_enabled is service
    assert got.effective_scheduler_algorithm() == algorithm
