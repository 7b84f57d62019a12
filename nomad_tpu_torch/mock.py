"""Canonical test fixtures (reference nomad/mock/mock.go)."""
from __future__ import annotations

import itertools
from typing import Optional

from .structs import (
    Affinity,
    Allocation,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Constraint,
    Evaluation,
    EVAL_TRIGGER_JOB_REGISTER,
    Job,
    JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSTEM,
    Node,
    NODE_STATUS_READY,
    NodeDeviceResource,
    NodeResources,
    NodeReservedResources,
    ReschedulePolicy,
    Resources,
    RestartPolicy,
    Task,
    TaskGroup,
    alloc_name,
    compute_node_class,
    new_id,
)

_counter = itertools.count()


def node(**overrides) -> Node:
    """(reference mock.go:13 Node)"""
    i = next(_counter)
    n = Node(
        name=f"node-{i}",
        datacenter="dc1",
        node_class="",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "nomad.version": "0.13.0",
            "driver.exec": "1",
            "driver.mock_driver": "1",
            "cpu.frequency": "2600",
            "cpu.numcores": "4",
        },
        node_resources=NodeResources(
            cpu=4000, memory_mb=8192, disk_mb=100 * 1024
        ),
        reserved_resources=NodeReservedResources(
            cpu=100, memory_mb=256, disk_mb=4 * 1024
        ),
        drivers={"exec": True, "mock_driver": True},
        status=NODE_STATUS_READY,
    )
    for key, value in overrides.items():
        setattr(n, key, value)
    n.computed_class = compute_node_class(n)
    return n


def csi_volume(plugin_id: str = "ebs0", **overrides):
    """(reference mock.go CSIVolume)"""
    from .structs import CSIVolume

    i = next(_counter)
    v = CSIVolume(
        id=f"vol-{i}",
        name=f"vol-{i}",
        plugin_id=plugin_id,
    )
    for key, value in overrides.items():
        setattr(v, key, value)
    return v


def nvidia_node(**overrides) -> Node:
    """(reference mock.go:114 NvidiaNode)"""
    n = node(**overrides)
    n.node_resources.devices = [
        NodeDeviceResource(
            vendor="nvidia",
            type="gpu",
            name="1080ti",
            instance_ids=[new_id() for _ in range(4)],
            attributes={
                "memory": "11169",
                "cuda_cores": "3584",
                "graphics_clock": "1480",
                "memory_bandwidth": "11",
            },
        )
    ]
    n.computed_class = compute_node_class(n)
    return n


def job(**overrides) -> Job:
    """(reference mock.go:175 Job)"""
    job_id = overrides.pop("id", new_id())
    j = Job(
        id=job_id,
        name="my-job",
        type=JOB_TYPE_SERVICE,
        priority=50,
        datacenters=["dc1"],
        constraints=[
            Constraint(
                ltarget="${attr.kernel.name}", rtarget="linux", operand="="
            )
        ],
        task_groups=[
            TaskGroup(
                name="web",
                count=10,
                restart_policy=RestartPolicy(
                    attempts=3, interval_s=600, delay_s=60, mode="delay"
                ),
                reschedule_policy=ReschedulePolicy(
                    attempts=2,
                    interval_s=600,
                    delay_s=5,
                    delay_function="constant",
                    max_delay_s=3600,
                    unlimited=False,
                ),
                tasks=[
                    Task(
                        name="web",
                        driver="exec",
                        config={"command": "/bin/date"},
                        env={"FOO": "bar"},
                        resources=Resources(cpu=500, memory_mb=256),
                    )
                ],
            )
        ],
        status="pending",
    )
    for key, value in overrides.items():
        setattr(j, key, value)
    return j


def batch_job(**overrides) -> Job:
    """(reference mock.go BatchJob)"""
    j = job(**overrides)
    j.type = JOB_TYPE_BATCH
    for tg in j.task_groups:
        tg.reschedule_policy = ReschedulePolicy(
            attempts=1,
            interval_s=24 * 3600,
            delay_s=5,
            delay_function="constant",
            unlimited=False,
        )
    return j


def system_job(**overrides) -> Job:
    """(reference mock.go:790 SystemJob)"""
    j = job(**overrides)
    j.type = JOB_TYPE_SYSTEM
    j.task_groups[0].count = 1
    for tg in j.task_groups:
        tg.reschedule_policy = None
    return j


def evaluation(**overrides) -> Evaluation:
    """(reference mock.go:865 Eval)"""
    e = Evaluation(
        priority=50,
        type=JOB_TYPE_SERVICE,
        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
    )
    for key, value in overrides.items():
        setattr(e, key, value)
    return e


def alloc(**overrides) -> Allocation:
    """(reference mock.go:894 Alloc)"""
    j = overrides.pop("job", None) or job()
    tg = j.task_groups[0]
    a = Allocation(
        namespace=j.namespace,
        eval_id=new_id(),
        node_id="12345678-abcd-efab-cdef-123456789abc",
        job_id=j.id,
        job=j,
        task_group=tg.name,
        name=alloc_name(j.id, tg.name, 0),
        allocated_resources=AllocatedResources(
            tasks={
                tg.tasks[0].name: AllocatedTaskResources(
                    cpu=500, memory_mb=256
                )
            },
            shared=AllocatedSharedResources(disk_mb=150),
        ),
        desired_status="run",
        client_status="pending",
    )
    for key, value in overrides.items():
        setattr(a, key, value)
    return a
