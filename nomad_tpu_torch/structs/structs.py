"""Core data model.

Semantically mirrors the reference's `nomad/structs/structs.go` (Job:3748,
TaskGroup:5495, Task:6152, Node:1720, Allocation:8519, Evaluation:9512,
Plan:9805) without being a field-for-field port: only the state the
scheduler, reconciler, plan applier and client runtime consume is modeled,
and collections are plain Python containers rather than msgpack-codec
structs.  IDs are strings (uuid4 hex by default).
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Constants (reference: nomad/structs/structs.go)
# ---------------------------------------------------------------------------

JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"
JOB_TYPE_CORE = "_core"

JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_DEAD = "dead"

DEFAULT_NAMESPACE = "default"
DEFAULT_REGION = "global"

JOB_DEFAULT_PRIORITY = 50
JOB_MAX_PRIORITY = 100

NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"

NODE_SCHED_ELIGIBLE = "eligible"
NODE_SCHED_INELIGIBLE = "ineligible"

ALLOC_DESIRED_RUN = "run"
ALLOC_DESIRED_STOP = "stop"
ALLOC_DESIRED_EVICT = "evict"

ALLOC_CLIENT_STATUS_PENDING = "pending"
ALLOC_CLIENT_STATUS_RUNNING = "running"
ALLOC_CLIENT_STATUS_COMPLETE = "complete"
ALLOC_CLIENT_STATUS_FAILED = "failed"
ALLOC_CLIENT_STATUS_LOST = "lost"

EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

EVAL_TRIGGER_JOB_REGISTER = "job-register"
EVAL_TRIGGER_JOB_DEREGISTER = "job-deregister"
EVAL_TRIGGER_PERIODIC = "periodic-job"
EVAL_TRIGGER_NODE_DRAIN = "node-drain"
EVAL_TRIGGER_NODE_UPDATE = "node-update"
EVAL_TRIGGER_ALLOC_STOP = "alloc-stop"
EVAL_TRIGGER_SCHEDULED = "scheduled"
EVAL_TRIGGER_ROLLING_UPDATE = "rolling-update"
EVAL_TRIGGER_DEPLOYMENT_WATCHER = "deployment-watcher"
EVAL_TRIGGER_FAILED_FOLLOW_UP = "failed-follow-up"
EVAL_TRIGGER_MAX_PLANS = "max-plan-attempts"
EVAL_TRIGGER_RETRY_FAILED_ALLOC = "alloc-failure"
EVAL_TRIGGER_QUEUED_ALLOCS = "queued-allocs"
EVAL_TRIGGER_PREEMPTION = "preemption"
EVAL_TRIGGER_SCALING = "job-scaling"

# Constraint operands (reference: structs.go Constraint*)
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_DISTINCT_PROPERTY = "distinct_property"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"
CONSTRAINT_SEMVER = "semver"
CONSTRAINT_SET_CONTAINS = "set_contains"
CONSTRAINT_SET_CONTAINS_ALL = "set_contains_all"
CONSTRAINT_SET_CONTAINS_ANY = "set_contains_any"
CONSTRAINT_ATTRIBUTE_IS_SET = "is_set"
CONSTRAINT_ATTRIBUTE_IS_NOT_SET = "is_not_set"

SCHEDULER_ALGORITHM_BINPACK = "binpack"
SCHEDULER_ALGORITHM_SPREAD = "spread"

# Deployment statuses (reference: structs.go Deployment*)
DEPLOYMENT_STATUS_RUNNING = "running"
DEPLOYMENT_STATUS_PAUSED = "paused"
DEPLOYMENT_STATUS_FAILED = "failed"
DEPLOYMENT_STATUS_SUCCESSFUL = "successful"
DEPLOYMENT_STATUS_CANCELLED = "cancelled"

# The maximum priority delta required before an alloc may be preempted
# (reference: scheduler/preemption.go:673).
PREEMPTION_PRIORITY_DELTA = 10


def new_id() -> str:
    return uuid.uuid4().hex


# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------


@dataclass
class Port:
    label: str = ""
    value: int = 0  # static port; 0 => dynamic
    to: int = 0
    host_network: str = "default"


@dataclass
class NetworkResource:
    """A network ask/offer (reference structs.go NetworkResource)."""

    mode: str = "host"
    device: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: List[Port] = field(default_factory=list)
    dynamic_ports: List[Port] = field(default_factory=list)

    def copy(self) -> "NetworkResource":
        return NetworkResource(
            mode=self.mode,
            device=self.device,
            ip=self.ip,
            mbits=self.mbits,
            reserved_ports=[replace(p) for p in self.reserved_ports],
            dynamic_ports=[replace(p) for p in self.dynamic_ports],
        )

    def port_labels(self) -> Dict[str, int]:
        out = {}
        for p in self.reserved_ports:
            out[p.label] = p.value
        for p in self.dynamic_ports:
            out[p.label] = p.value
        return out


@dataclass
class DeviceIdTuple:
    vendor: str = ""
    type: str = ""
    name: str = ""

    def matches(self, ask: str) -> bool:
        """Match an ask of the form "type", "vendor/type" or
        "vendor/type/name" (reference structs.go RequestedDevice.ID)."""
        parts = ask.split("/")
        if len(parts) == 1:
            return parts[0] == self.type
        if len(parts) == 2:
            return parts[0] == self.vendor and parts[1] == self.type
        return (
            parts[0] == self.vendor
            and parts[1] == self.type
            and "/".join(parts[2:]) == self.name
        )


@dataclass
class NodeDeviceResource:
    """A group of homogeneous device instances on a node."""

    vendor: str = ""
    type: str = ""
    name: str = ""
    instance_ids: List[str] = field(default_factory=list)
    attributes: Dict[str, Any] = field(default_factory=dict)

    def id(self) -> DeviceIdTuple:
        return DeviceIdTuple(self.vendor, self.type, self.name)


@dataclass
class RequestedDevice:
    """A task's device ask (reference structs.go RequestedDevice)."""

    name: str = ""  # "type", "vendor/type", or "vendor/type/name"
    count: int = 1
    constraints: List["Constraint"] = field(default_factory=list)
    affinities: List["Affinity"] = field(default_factory=list)


@dataclass
class AllocatedDeviceResource:
    vendor: str = ""
    type: str = ""
    name: str = ""
    device_ids: List[str] = field(default_factory=list)


@dataclass
class Resources:
    """A task's resource ask (reference structs.go Resources:2059)."""

    cpu: int = 100  # MHz shares
    memory_mb: int = 300
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[RequestedDevice] = field(default_factory=list)


@dataclass
class NodeReservedResources:
    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    reserved_ports: List[int] = field(default_factory=list)


@dataclass
class NodeResources:
    """Total resources on a node (reference structs.go NodeResources)."""

    cpu: int = 4000
    memory_mb: int = 8192
    disk_mb: int = 100 * 1024
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[NodeDeviceResource] = field(default_factory=list)


@dataclass
class AllocatedTaskResources:
    cpu: int = 0
    memory_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[AllocatedDeviceResource] = field(default_factory=list)


@dataclass
class AllocatedSharedResources:
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    ports: List["AssignedPortData"] = field(default_factory=list)


@dataclass
class AssignedPortData:
    label: str = ""
    value: int = 0
    to: int = 0
    host_ip: str = ""


@dataclass
class AllocatedResources:
    """Resources granted to an allocation, per task plus shared
    (reference structs.go AllocatedResources:2470)."""

    tasks: Dict[str, AllocatedTaskResources] = field(default_factory=dict)
    shared: AllocatedSharedResources = field(default_factory=AllocatedSharedResources)

    def comparable(self) -> "ComparableResources":
        c = ComparableResources()
        for tr in self.tasks.values():
            c.cpu += tr.cpu
            c.memory_mb += tr.memory_mb
            for net in tr.networks:
                c.network_mbits += net.mbits
        c.disk_mb = self.shared.disk_mb
        for net in self.shared.networks:
            c.network_mbits += net.mbits
        return c


@dataclass
class ComparableResources:
    """Flattened cpu/mem + shared disk used for fit checks and scoring
    (reference structs.go ComparableResources / funcs.go AllocsFit)."""

    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    network_mbits: int = 0

    def add(self, other: "ComparableResources") -> None:
        self.cpu += other.cpu
        self.memory_mb += other.memory_mb
        self.disk_mb += other.disk_mb
        self.network_mbits += other.network_mbits

    def subtract(self, other: "ComparableResources") -> None:
        self.cpu -= other.cpu
        self.memory_mb -= other.memory_mb
        self.disk_mb -= other.disk_mb
        self.network_mbits -= other.network_mbits

    def superset(self, other: "ComparableResources") -> Tuple[bool, str]:
        if self.cpu < other.cpu:
            return False, "cpu"
        if self.memory_mb < other.memory_mb:
            return False, "memory"
        if self.disk_mb < other.disk_mb:
            return False, "disk"
        return True, ""


# ---------------------------------------------------------------------------
# Constraints / affinities / spread
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Constraint:
    """(reference structs.go Constraint:7669)"""

    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="

    def __str__(self) -> str:
        return f"{self.ltarget} {self.operand} {self.rtarget}"


@dataclass(frozen=True)
class Affinity:
    """Weighted soft constraint, weight in [-100, 100]
    (reference structs.go Affinity:7791)."""

    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="
    weight: int = 50


@dataclass(frozen=True)
class SpreadTarget:
    value: str = ""
    percent: int = 0


@dataclass(frozen=True)
class Spread:
    """(reference structs.go Spread:7879)"""

    attribute: str = ""
    weight: int = 50
    targets: Tuple[SpreadTarget, ...] = ()


@dataclass
class PolicySpec:
    """Placement-policy weights riding the job: a Gavel-style
    throughput-by-node-class table (normalized to its max and folded
    into the score mean for every candidate) and a migration-cost
    coefficient (a reschedule penalty on every node EXCEPT those
    currently hosting this TG's live allocs — the incumbent's score
    mean is untouched, movers are dragged down — so drains and mass
    replans avoid unnecessary migrations).  Assembled into
    per-(TG, node) weight tensors by sched/policy.py and fused into
    the score kernel."""

    # node-class -> relative throughput (any positive scale; the
    # assembler normalizes by the table max).  Empty = no
    # heterogeneity term.
    throughput: Dict[str, float] = field(default_factory=dict)
    throughput_coefficient: float = 1.0
    # > 0 enables the migration-cost penalty term
    migration_coefficient: float = 0.0
    # only allocs running at least this long mark their node sticky
    # ("penalize moving LONG-RUNNING allocs"); 0 = all live allocs
    min_runtime_s: float = 0.0

    def active(self) -> bool:
        return bool(self.throughput) or self.migration_coefficient != 0.0


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class DrainStrategy:
    deadline_ns: int = 0
    ignore_system_jobs: bool = False
    force_deadline_unix: float = 0.0


@dataclass
class HostVolumeInfo:
    path: str = ""
    read_only: bool = False


@dataclass
class NodeEvent:
    """An entry in a node's event history (reference structs.go
    NodeEvent; emitted via UpsertNodeEventsType, fsm.go:247)."""

    message: str = ""
    subsystem: str = "Cluster"
    details: Dict[str, str] = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)
    create_index: int = 0


# retained events per node (reference structs.go maxNodeEvents = 10)
MAX_NODE_EVENTS = 10


@dataclass
class Node:
    """(reference structs.go Node:1720)"""

    id: str = field(default_factory=new_id)
    name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)
    node_resources: NodeResources = field(default_factory=NodeResources)
    reserved_resources: NodeReservedResources = field(
        default_factory=NodeReservedResources
    )
    # driver name -> healthy
    drivers: Dict[str, bool] = field(default_factory=dict)
    host_volumes: Dict[str, HostVolumeInfo] = field(default_factory=dict)
    # CSI plugin id -> healthy (node-stage plugins)
    csi_node_plugins: Dict[str, bool] = field(default_factory=dict)
    status: str = NODE_STATUS_INIT
    scheduling_eligibility: str = NODE_SCHED_ELIGIBLE
    drain: bool = False
    drain_strategy: Optional[DrainStrategy] = None
    computed_class: str = ""
    status_updated_at: float = 0.0
    events: List[NodeEvent] = field(default_factory=list)
    create_index: int = 0
    modify_index: int = 0

    def add_event(self, event: "NodeEvent") -> None:
        """Append to the bounded event history (reference
        state_store.go appendNodeEvents caps at maxNodeEvents)."""
        self.events.append(event)
        if len(self.events) > MAX_NODE_EVENTS:
            # the first (registration) event is always retained
            del self.events[1:len(self.events) - MAX_NODE_EVENTS + 1]

    def ready(self) -> bool:
        """(reference structs.go Node.Ready)"""
        return (
            self.status == NODE_STATUS_READY
            and not self.drain
            and self.scheduling_eligibility == NODE_SCHED_ELIGIBLE
        )

    def comparable_resources(self) -> ComparableResources:
        r = self.node_resources
        return ComparableResources(
            cpu=r.cpu, memory_mb=r.memory_mb, disk_mb=r.disk_mb
        )

    def comparable_reserved_resources(self) -> ComparableResources:
        r = self.reserved_resources
        return ComparableResources(
            cpu=r.cpu, memory_mb=r.memory_mb, disk_mb=r.disk_mb
        )

    def terminal_status(self) -> bool:
        return self.status == NODE_STATUS_DOWN


# ---------------------------------------------------------------------------
# Job / TaskGroup / Task
# ---------------------------------------------------------------------------


@dataclass
class RestartPolicy:
    attempts: int = 2
    interval_s: float = 1800.0
    delay_s: float = 15.0
    mode: str = "fail"  # fail | delay


@dataclass
class ReschedulePolicy:
    """(reference structs.go ReschedulePolicy:4144)"""

    attempts: int = 0
    interval_s: float = 0.0
    delay_s: float = 30.0
    delay_function: str = "exponential"  # constant | exponential | fibonacci
    max_delay_s: float = 3600.0
    unlimited: bool = True


@dataclass
class MigrateStrategy:
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0


@dataclass
class UpdateStrategy:
    """Rolling-update / deployment config
    (reference structs.go UpdateStrategy:4245)."""

    stagger_s: float = 30.0
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0
    progress_deadline_s: float = 600.0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0

    def is_empty(self) -> bool:
        return self.max_parallel == 0


@dataclass
class EphemeralDisk:
    sticky: bool = False
    size_mb: int = 300
    migrate: bool = False


@dataclass
class VolumeRequest:
    name: str = ""
    type: str = "host"  # host | csi
    source: str = ""
    read_only: bool = False


# CSI access/attachment modes (reference nomad/structs/csi.go)
CSI_ACCESS_SINGLE_NODE_READER = "single-node-reader-only"
CSI_ACCESS_SINGLE_NODE_WRITER = "single-node-writer"
CSI_ACCESS_MULTI_NODE_READER = "multi-node-reader-only"
CSI_ACCESS_MULTI_NODE_SINGLE_WRITER = "multi-node-single-writer"
CSI_ACCESS_MULTI_NODE_MULTI_WRITER = "multi-node-multi-writer"

CSI_ATTACHMENT_FILE_SYSTEM = "file-system"
CSI_ATTACHMENT_BLOCK_DEVICE = "block-device"

_CSI_SINGLE_NODE_MODES = (
    CSI_ACCESS_SINGLE_NODE_READER,
    CSI_ACCESS_SINGLE_NODE_WRITER,
)


@dataclass
class CSIVolume:
    """An externally-provisioned volume managed by a CSI plugin
    (reference nomad/structs/csi.go CSIVolume; state table
    nomad/state/schema.go csi_volumes).  Claims map alloc id -> node id
    so the watcher can release claims as allocs die."""

    id: str = ""
    namespace: str = DEFAULT_NAMESPACE
    name: str = ""
    external_id: str = ""
    plugin_id: str = ""
    access_mode: str = CSI_ACCESS_SINGLE_NODE_WRITER
    attachment_mode: str = CSI_ATTACHMENT_FILE_SYSTEM
    read_claims: Dict[str, str] = field(default_factory=dict)
    write_claims: Dict[str, str] = field(default_factory=dict)
    schedulable: bool = True
    secrets: Dict[str, str] = field(default_factory=dict)
    parameters: Dict[str, str] = field(default_factory=dict)
    context: Dict[str, str] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    def write_free(self) -> bool:
        """Can another writer claim this volume?
        (reference csi.go WriteFreeClaims)"""
        if self.access_mode in (
            CSI_ACCESS_SINGLE_NODE_READER,
            CSI_ACCESS_MULTI_NODE_READER,
        ):
            return False
        if self.access_mode == CSI_ACCESS_MULTI_NODE_MULTI_WRITER:
            return True
        return len(self.write_claims) == 0

    def claimable(self, read_only: bool) -> bool:
        if not self.schedulable:
            return False
        if read_only:
            # single-node modes serialize on one node; modeled as one
            # outstanding claim set like the reference's ReadFreeClaims
            if self.access_mode in _CSI_SINGLE_NODE_MODES:
                return not self.write_claims
            return True
        return self.write_free()

    def claim(self, alloc_id: str, node_id: str, read_only: bool) -> None:
        if read_only:
            self.read_claims[alloc_id] = node_id
        else:
            self.write_claims[alloc_id] = node_id

    def release(self, alloc_id: str) -> bool:
        hit = False
        if self.read_claims.pop(alloc_id, None) is not None:
            hit = True
        if self.write_claims.pop(alloc_id, None) is not None:
            hit = True
        return hit

    def in_use(self) -> bool:
        return bool(self.read_claims or self.write_claims)


@dataclass
class CSIPlugin:
    """Aggregated plugin health view, derived from node fingerprints
    (reference nomad/structs/csi.go CSIPlugin; the reference keeps a
    csi_plugins table, here it is computed from the node table)."""

    id: str = ""
    nodes_healthy: int = 0
    nodes_expected: int = 0
    node_ids: List[str] = field(default_factory=list)


@dataclass
class Lifecycle:
    hook: str = ""  # prestart | poststart | poststop
    sidecar: bool = False


@dataclass
class ConnectUpstream:
    """(reference structs.go ConsulUpstream)"""

    destination_name: str = ""
    local_bind_port: int = 0


@dataclass
class ConsulConnect:
    """Service-mesh stanza (reference structs.go ConsulConnect:
    sidecar_service + proxy upstreams; native mode skips the proxy)."""

    native: bool = False
    sidecar_service: bool = False
    upstreams: List[ConnectUpstream] = field(default_factory=list)


@dataclass
class Service:
    name: str = ""
    port_label: str = ""
    tags: List[str] = field(default_factory=list)
    checks: List[Dict[str, Any]] = field(default_factory=list)
    connect: Optional[ConsulConnect] = None


@dataclass
class Task:
    """(reference structs.go Task:6152)"""

    name: str = ""
    driver: str = "exec"
    config: Dict[str, Any] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    services: List[Service] = field(default_factory=list)
    lifecycle: Optional[Lifecycle] = None
    leader: bool = False
    kill_timeout_s: float = 5.0
    artifacts: List[Dict[str, Any]] = field(default_factory=list)
    templates: List[Dict[str, Any]] = field(default_factory=list)
    meta: Dict[str, str] = field(default_factory=dict)
    dispatch_payload_file: str = ""
    # LogConfig (reference structs.go LogConfig: MaxFiles,
    # MaxFileSizeMB; consumed by client/logmon)
    log_max_files: int = 10
    log_max_file_size_mb: int = 10


SCALING_POLICY_TYPE_HORIZONTAL = "horizontal"

# how many scaling events are retained per task group
# (reference structs.go JobTrackedScalingEvents)
JOB_TRACKED_SCALING_EVENTS = 20


@dataclass
class Namespace:
    """A job namespace (reference nomad/structs Namespace — OSS'd in
    1.0; the 0.13 CLI already ships the command family).  Jobs, CSI
    volumes, and ACL capabilities scope to one."""

    name: str = "default"
    description: str = ""
    create_index: int = 0
    modify_index: int = 0

    def validate(self) -> None:
        import re as _re

        if not _re.fullmatch(r"[a-zA-Z0-9-]{1,128}", self.name):
            raise ValueError(
                "invalid namespace name (alphanumeric + dashes, "
                "max 128 chars)"
            )


@dataclass
class ScalingPolicy:
    """Autoscaling bounds + opaque autoscaler policy attached to a task
    group (reference structs.go ScalingPolicy / scaling stanza;
    state table `scaling_policy`, nomad/state/schema.go:795)."""

    id: str = field(default_factory=new_id)
    type: str = SCALING_POLICY_TYPE_HORIZONTAL
    target: Dict[str, str] = field(default_factory=dict)
    min: int = 1
    max: int = 0
    policy: Dict[str, Any] = field(default_factory=dict)
    enabled: bool = True
    create_index: int = 0
    modify_index: int = 0

    def target_tuple(self) -> Tuple[str, str, str]:
        return (
            self.target.get("Namespace", ""),
            self.target.get("Job", ""),
            self.target.get("Group", ""),
        )

    def canonicalize_for(self, job: "Job", group: str) -> None:
        """Stamp the policy's target from its owning job/group
        (reference structs.go ScalingPolicy.TargetTaskGroup)."""
        self.target = {
            "Namespace": job.namespace,
            "Job": job.id,
            "Group": group,
        }


@dataclass
class ScalingEvent:
    """One scaling action or autoscaler status report
    (reference structs.go ScalingEvent)."""

    time: float = field(default_factory=time.time)
    count: Optional[int] = None
    previous_count: int = 0
    message: str = ""
    error: bool = False
    eval_id: Optional[str] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    create_index: int = 0


@dataclass
class TaskGroup:
    """(reference structs.go TaskGroup:5495)"""

    name: str = ""
    count: int = 1
    tasks: List[Task] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    networks: List[NetworkResource] = field(default_factory=list)
    volumes: Dict[str, VolumeRequest] = field(default_factory=dict)
    restart_policy: RestartPolicy = field(default_factory=RestartPolicy)
    reschedule_policy: Optional[ReschedulePolicy] = None
    migrate: Optional[MigrateStrategy] = None
    update: Optional[UpdateStrategy] = None
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    meta: Dict[str, str] = field(default_factory=dict)
    stop_after_client_disconnect_s: Optional[float] = None
    scaling: Optional[ScalingPolicy] = None


@dataclass
class Periodic:
    enabled: bool = True
    spec: str = ""  # cron spec
    prohibit_overlap: bool = False
    timezone: str = "UTC"


@dataclass
class MultiregionStrategy:
    """(reference structs.go MultiregionStrategy:4645)"""

    max_parallel: int = 0
    on_failure: str = ""  # "", fail_all, fail_local


@dataclass
class MultiregionRegion:
    """(reference structs.go MultiregionRegion:4650)"""

    name: str = ""
    count: int = 0
    datacenters: List[str] = field(default_factory=list)
    meta: Dict[str, str] = field(default_factory=dict)


@dataclass
class Multiregion:
    """Multi-region deployment spec (reference structs.go
    Multiregion:4597; the OSS deployment watcher carries the spec and
    runs the region-local rollout — cross-region coordination hooks
    live in deploymentwatcher/multiregion_oss.go and are no-ops)."""

    strategy: MultiregionStrategy = field(
        default_factory=MultiregionStrategy
    )
    regions: List[MultiregionRegion] = field(default_factory=list)

    def region(self, name: str) -> Optional[MultiregionRegion]:
        for r in self.regions:
            if r.name == name:
                return r
        return None


@dataclass
class Job:
    """(reference structs.go Job:3748)"""

    id: str = ""
    name: str = ""
    namespace: str = DEFAULT_NAMESPACE
    region: str = DEFAULT_REGION
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    datacenters: List[str] = field(default_factory=lambda: ["dc1"])
    task_groups: List[TaskGroup] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    periodic: Optional[Periodic] = None
    multiregion: Optional[Multiregion] = None
    parameterized: Optional[Dict[str, Any]] = None
    # dispatch input blob (reference structs.go Job.Payload, written to
    # tasks via DispatchPayloadConfig at structs.go DispatchPayload)
    payload: bytes = b""
    parent_id: str = ""
    all_at_once: bool = False
    update: Optional[UpdateStrategy] = None
    # placement-policy weights (heterogeneity throughput + migration
    # cost) consumed by the score kernel; None = policy-less
    policy: Optional[PolicySpec] = None
    meta: Dict[str, str] = field(default_factory=dict)
    stop: bool = False
    status: str = JOB_STATUS_PENDING
    version: int = 0
    stable: bool = False
    submit_time: float = field(default_factory=time.time)
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0

    def namespaced_id(self) -> Tuple[str, str]:
        return (self.namespace, self.id)

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def stopped(self) -> bool:
        return self.stop

    def is_periodic(self) -> bool:
        return self.periodic is not None

    def is_parameterized(self) -> bool:
        return self.parameterized is not None

    def required_signals(self) -> Dict[str, Dict[str, List[str]]]:
        return {}


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


@dataclass
class RescheduleEvent:
    reschedule_time: float = 0.0
    prev_alloc_id: str = ""
    prev_node_id: str = ""
    delay_s: float = 0.0


@dataclass
class RescheduleTracker:
    events: List[RescheduleEvent] = field(default_factory=list)


@dataclass
class DesiredTransition:
    migrate: Optional[bool] = None
    reschedule: Optional[bool] = None
    force_reschedule: Optional[bool] = None

    def should_migrate(self) -> bool:
        return bool(self.migrate)

    def should_force_reschedule(self) -> bool:
        return bool(self.force_reschedule)


@dataclass
class TaskState:
    state: str = "pending"  # pending | running | dead
    failed: bool = False
    restarts: int = 0
    started_at: float = 0.0
    finished_at: float = 0.0
    events: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class AllocDeploymentStatus:
    healthy: Optional[bool] = None
    timestamp: float = 0.0
    canary: bool = False

    def is_healthy(self) -> bool:
        return self.healthy is True

    def is_unhealthy(self) -> bool:
        return self.healthy is False


@dataclass
class Allocation:
    """(reference structs.go Allocation:8519)"""

    id: str = field(default_factory=new_id)
    namespace: str = DEFAULT_NAMESPACE
    eval_id: str = ""
    name: str = ""  # "<job>.<group>[<index>]"
    node_id: str = ""
    node_name: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    task_group: str = ""
    allocated_resources: Optional[AllocatedResources] = None
    desired_status: str = ALLOC_DESIRED_RUN
    desired_description: str = ""
    desired_transition: DesiredTransition = field(default_factory=DesiredTransition)
    client_status: str = ALLOC_CLIENT_STATUS_PENDING
    client_description: str = ""
    task_states: Dict[str, TaskState] = field(default_factory=dict)
    deployment_id: str = ""
    deployment_status: Optional[AllocDeploymentStatus] = None
    reschedule_tracker: Optional[RescheduleTracker] = None
    previous_allocation: str = ""
    next_allocation: str = ""
    followup_eval_id: str = ""
    preempted_by_allocation: str = ""
    metrics: Optional["AllocMetric"] = None
    create_time: float = field(default_factory=time.time)
    modify_time: float = field(default_factory=time.time)
    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0

    def terminal_status(self) -> bool:
        """Terminal by desired or client state
        (reference structs.go Allocation.TerminalStatus)."""
        if self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            return True
        return self.client_terminal_status()

    def client_terminal_status(self) -> bool:
        return self.client_status in (
            ALLOC_CLIENT_STATUS_COMPLETE,
            ALLOC_CLIENT_STATUS_FAILED,
            ALLOC_CLIENT_STATUS_LOST,
        )

    def comparable_resources(self) -> ComparableResources:
        if self.allocated_resources is None:
            return ComparableResources()
        return self.allocated_resources.comparable()

    def index(self) -> int:
        """Parse the instance index out of the alloc name."""
        l = self.name.rfind("[")
        r = self.name.rfind("]")
        if l == -1 or r == -1 or r < l:
            return -1
        return int(self.name[l + 1 : r])

    def job_namespaced_id(self) -> Tuple[str, str]:
        return (self.namespace, self.job_id)

    def ran_successfully(self) -> bool:
        return self.client_status == ALLOC_CLIENT_STATUS_COMPLETE

    def migrate_status(self) -> bool:
        return self.desired_transition.should_migrate()

    # -- rescheduling (reference structs.go Allocation.NextRescheduleTime,
    #    NextDelay, RescheduleEligible) --------------------------------------

    def reschedule_policy(self) -> Optional["ReschedulePolicy"]:
        if self.job is None:
            return None
        tg = self.job.lookup_task_group(self.task_group)
        if tg is None:
            return None
        return tg.reschedule_policy

    def last_event_time(self) -> float:
        last = 0.0
        for state in self.task_states.values():
            if state.finished_at > last:
                last = state.finished_at
        return last or self.modify_time

    def next_delay(self) -> float:
        """Delay before the next reschedule attempt, per the policy's delay
        function (constant | exponential | fibonacci), capped at max_delay
        (reference structs.go ReschedulePolicy/NextDelay)."""
        policy = self.reschedule_policy()
        if policy is None:
            return 0.0
        delay = policy.delay_s
        tracker = self.reschedule_tracker
        n_prev = len(tracker.events) if tracker else 0
        if policy.delay_function == "exponential":
            delay = policy.delay_s * (2**n_prev)
        elif policy.delay_function == "fibonacci":
            a, b = 0.0, policy.delay_s
            for _ in range(n_prev):
                a, b = b, a + b
            delay = b
        if policy.max_delay_s > 0:
            delay = min(delay, policy.max_delay_s)
        return delay

    def next_reschedule_time(self) -> Tuple[float, bool]:
        """Returns (reschedule_time, eligible)."""
        policy = self.reschedule_policy()
        fail_time = self.last_event_time()
        if (
            self.desired_status == ALLOC_DESIRED_STOP
            or self.client_status != ALLOC_CLIENT_STATUS_FAILED
            or fail_time == 0.0
            or policy is None
        ):
            return 0.0, False
        if policy.attempts == 0 and not policy.unlimited:
            return 0.0, False
        next_time = fail_time + self.next_delay()
        eligible = policy.unlimited or (
            policy.attempts > 0 and self.reschedule_tracker is None
        )
        if (
            policy.attempts > 0
            and self.reschedule_tracker is not None
            and self.reschedule_tracker.events
        ):
            attempted = 0
            for event in reversed(self.reschedule_tracker.events):
                if fail_time - event.reschedule_time < policy.interval_s:
                    attempted += 1
            eligible = attempted < policy.attempts
        return next_time, eligible

    def should_client_stop(self) -> bool:
        if self.job is None:
            return False
        tg = self.job.lookup_task_group(self.task_group)
        return (
            tg is not None
            and tg.stop_after_client_disconnect_s is not None
        )

    def wait_client_stop(self) -> float:
        tg = (
            self.job.lookup_task_group(self.task_group)
            if self.job is not None
            else None
        )
        timeout = (
            tg.stop_after_client_disconnect_s
            if tg is not None and tg.stop_after_client_disconnect_s
            else 0.0
        )
        return self.last_event_time() + timeout


def alloc_name(job_id: str, group: str, idx: int) -> str:
    return f"{job_id}.{group}[{idx}]"


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


@dataclass
class Evaluation:
    """(reference structs.go Evaluation:9512)"""

    id: str = field(default_factory=new_id)
    namespace: str = DEFAULT_NAMESPACE
    priority: int = JOB_DEFAULT_PRIORITY
    type: str = JOB_TYPE_SERVICE  # scheduler type
    triggered_by: str = EVAL_TRIGGER_JOB_REGISTER
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    deployment_id: str = ""
    status: str = EVAL_STATUS_PENDING
    status_description: str = ""
    wait_until: float = 0.0
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    failed_tg_allocs: Dict[str, "AllocMetric"] = field(default_factory=dict)
    class_eligibility: Dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    quota_limit_reached: str = ""
    annotate_plan: bool = False
    # storm-family override for the eval broker's job_family(): the
    # heartbeat sweeper stamps every replan eval of one mass
    # node-death wave with the wave's hint so evals across unrelated
    # jobs coalesce into ONE storm solve; "" = derive from job_id
    family_hint: str = ""
    queued_allocations: Dict[str, int] = field(default_factory=dict)
    leader_ack: str = ""
    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0
    modify_time: float = 0.0

    def terminal_status(self) -> bool:
        return self.status in (
            EVAL_STATUS_COMPLETE,
            EVAL_STATUS_FAILED,
            EVAL_STATUS_CANCELLED,
        )

    def should_enqueue(self) -> bool:
        return self.status == EVAL_STATUS_PENDING

    def should_block(self) -> bool:
        return self.status == EVAL_STATUS_BLOCKED

    def make_plan(self, job: Optional[Job]) -> "Plan":
        return Plan(
            eval_id=self.id,
            priority=self.priority,
            job=job,
        )

    def next_rolling_eval(self, wait_s: float) -> "Evaluation":
        return Evaluation(
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=EVAL_TRIGGER_ROLLING_UPDATE,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_PENDING,
            wait_until=time.time() + wait_s,
            previous_eval=self.id,
        )

    def create_blocked_eval(
        self,
        class_eligibility: Dict[str, bool],
        escaped: bool,
        quota_reached: str,
    ) -> "Evaluation":
        return Evaluation(
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=EVAL_TRIGGER_QUEUED_ALLOCS,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_BLOCKED,
            previous_eval=self.id,
            class_eligibility=dict(class_eligibility),
            escaped_computed_class=escaped,
            quota_limit_reached=quota_reached,
        )

    def create_failed_follow_up_eval(self, wait_s: float) -> "Evaluation":
        return Evaluation(
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=EVAL_TRIGGER_FAILED_FOLLOW_UP,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_PENDING,
            wait_until=time.time() + wait_s,
            previous_eval=self.id,
        )


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclass
class Plan:
    """The scheduler's proposed state mutation
    (reference structs.go Plan:9805)."""

    eval_id: str = ""
    eval_token: str = ""
    priority: int = JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    job: Optional[Job] = None
    # node id -> allocs to stop/evict on that node
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    # node id -> new/updated allocs on that node
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    # node id -> allocs preempted on that node
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    deployment: Optional["Deployment"] = None
    # deployment id -> status update
    deployment_updates: List["DeploymentStatusUpdate"] = field(default_factory=list)
    annotations: Optional[Dict[str, Any]] = None
    snapshot_index: int = 0
    # leadership generation the producing wave/chain captured when it
    # STARTED (not when the plan reaches the store): the replicated
    # FSM fence compares this against the committed leadership
    # barrier, so a straggler wave from a deposed generation is
    # rejected even if its server has since been re-elected
    leader_gen: Optional[int] = None

    def append_stopped_alloc(
        self, alloc: Allocation, desired_desc: str, client_status: str = ""
    ) -> None:
        """(reference structs.go Plan.AppendStoppedAlloc)"""
        new_alloc = replace(alloc)
        new_alloc.desired_status = ALLOC_DESIRED_STOP
        new_alloc.desired_description = desired_desc
        if client_status:
            new_alloc.client_status = client_status
        self.node_update.setdefault(alloc.node_id, []).append(new_alloc)

    def append_alloc(self, alloc: Allocation) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_preempted_alloc(
        self, alloc: Allocation, preempting_alloc_id: str
    ) -> None:
        new_alloc = replace(alloc)
        new_alloc.desired_status = ALLOC_DESIRED_EVICT
        new_alloc.preempted_by_allocation = preempting_alloc_id
        new_alloc.desired_description = (
            f"Preempted by alloc ID {preempting_alloc_id}"
        )
        self.node_preemptions.setdefault(alloc.node_id, []).append(new_alloc)

    def is_no_op(self) -> bool:
        return (
            not self.node_update
            and not self.node_allocation
            and self.deployment is None
            and not self.deployment_updates
        )


@dataclass
class AllocationDiff:
    """Minimal wire form of a stopped/preempted allocation: just the
    fields the FSM needs to apply the stop against its local copy
    (reference structs.go AllocationDiff + Plan.NormalizeAllocations,
    nomad/plan_apply.go:324-344 — stops/evictions replicate as diffs,
    not full Job-bearing alloc structs)."""

    id: str = ""
    desired_status: str = ""
    desired_description: str = ""
    client_status: str = ""
    followup_eval_id: str = ""
    preempted_by_allocation: str = ""


@dataclass
class PlanResult:
    """(reference structs.go PlanResult:9988)"""

    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    deployment: Optional["Deployment"] = None
    deployment_updates: List["DeploymentStatusUpdate"] = field(default_factory=list)
    refresh_index: int = 0
    alloc_index: int = 0
    # True when node_update/node_preemptions hold AllocationDiffs that
    # must be denormalized against state before applying
    normalized: bool = False

    def is_full_commit(self, plan: Plan) -> bool:
        expected = sum(len(v) for v in plan.node_allocation.values())
        actual = sum(len(v) for v in self.node_allocation.values())
        return expected == actual

    def full_commit(self, plan: Plan) -> Tuple[bool, int, int]:
        expected = sum(len(v) for v in plan.node_allocation.values())
        actual = sum(len(v) for v in self.node_allocation.values())
        return expected == actual, expected, actual


# ---------------------------------------------------------------------------
# Deployment
# ---------------------------------------------------------------------------


@dataclass
class DeploymentState:
    """Per-task-group deployment state
    (reference structs.go DeploymentState)."""

    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    placed_canaries: List[str] = field(default_factory=list)
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline_s: float = 0.0
    require_progress_by: float = 0.0


@dataclass
class Deployment:
    """(reference structs.go Deployment:8178)"""

    id: str = field(default_factory=new_id)
    namespace: str = DEFAULT_NAMESPACE
    job_id: str = ""
    job_version: int = 0
    job_modify_index: int = 0
    job_create_index: int = 0
    task_groups: Dict[str, DeploymentState] = field(default_factory=dict)
    status: str = DEPLOYMENT_STATUS_RUNNING
    status_description: str = "Deployment is running"
    create_index: int = 0
    modify_index: int = 0

    def active(self) -> bool:
        return self.status in (DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_PAUSED)

    def requires_promotion(self) -> bool:
        return any(
            s.desired_canaries > 0 and not s.promoted
            for s in self.task_groups.values()
        )

    def has_auto_promote(self) -> bool:
        return all(s.auto_promote for s in self.task_groups.values()) and bool(
            self.task_groups
        )


@dataclass
class DeploymentStatusUpdate:
    deployment_id: str = ""
    status: str = ""
    status_description: str = ""


@dataclass
class DesiredUpdates:
    """Per-task-group planned change counts, surfaced in `job plan`
    (reference structs.go DesiredUpdates)."""

    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0
    canary: int = 0
    preemptions: int = 0


# ---------------------------------------------------------------------------
# Placement metrics (reference structs.go AllocMetric:9184)
# ---------------------------------------------------------------------------


@dataclass
class NodeScoreMeta:
    node_id: str = ""
    scores: Dict[str, float] = field(default_factory=dict)
    norm_score: float = 0.0


@dataclass
class AllocMetric:
    # monotone per-eval select sequence (EvalContext.reset stamps it):
    # lets consumers pick the freshest placement's metric for a task
    # group without relying on plan-collection iteration order
    seq: int = 0
    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_available: Dict[str, int] = field(default_factory=dict)  # dc -> count
    class_filtered: Dict[str, int] = field(default_factory=dict)
    constraint_filtered: Dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: Dict[str, int] = field(default_factory=dict)
    dimension_exhausted: Dict[str, int] = field(default_factory=dict)
    quota_exhausted: List[str] = field(default_factory=list)
    scores: Dict[str, float] = field(default_factory=dict)
    score_meta: List[NodeScoreMeta] = field(default_factory=list)
    allocation_time_s: float = 0.0
    coalesced_failures: int = 0

    def evaluate_node(self) -> None:
        self.nodes_evaluated += 1

    def filter_node(self, node: Optional[Node], constraint: str) -> None:
        self.nodes_filtered += 1
        if node is not None and node.node_class:
            self.class_filtered[node.node_class] = (
                self.class_filtered.get(node.node_class, 0) + 1
            )
        if constraint:
            self.constraint_filtered[constraint] = (
                self.constraint_filtered.get(constraint, 0) + 1
            )

    def exhausted_node(self, node: Optional[Node], dimension: str) -> None:
        self.nodes_exhausted += 1
        if node is not None and node.node_class:
            self.class_exhausted[node.node_class] = (
                self.class_exhausted.get(node.node_class, 0) + 1
            )
        if dimension:
            self.dimension_exhausted[dimension] = (
                self.dimension_exhausted.get(dimension, 0) + 1
            )

    # ScoreMetaData entries kept on any read/serialization surface
    # (reference lib/kheap k=5)
    SCORE_META_TOP_K = 5

    def score_node(self, node: Node, name: str, score: float) -> None:
        # Top-K score metadata kept simple: record everything, trim on
        # read via top_score_meta (reference uses lib/kheap with k=5).
        # A node id -> list position index (not a dataclass field, so it
        # never reaches a wire form) replaces the linear search, which
        # made an unlimited walk quadratic in the node count; it is
        # checked on every use and rebuilt when the list was changed
        # behind its back, so the recorded entries are the same.
        cached = self.__dict__.get("_meta_pos")
        if (
            cached is None
            or cached[0] is not self.score_meta
            or cached[1] != len(self.score_meta)
        ):
            index: Dict[str, int] = {}
            for i, m in enumerate(self.score_meta):
                index.setdefault(m.node_id, i)
        else:
            index = cached[2]
        pos = index.get(node.id)
        if pos is not None and self.score_meta[pos].node_id == node.id:
            meta = self.score_meta[pos]
            meta.scores[name] = score
            if name == "normalized-score":
                meta.norm_score = score
        else:
            meta = NodeScoreMeta(node_id=node.id, scores={name: score})
            if name == "normalized-score":
                meta.norm_score = score
            index[node.id] = len(self.score_meta)
            self.score_meta.append(meta)
        self.__dict__["_meta_pos"] = (
            self.score_meta, len(self.score_meta), index
        )

    def max_normalized_score(self) -> float:
        if not self.score_meta:
            return 0.0
        return max(m.norm_score for m in self.score_meta)

    def node_norm_score(self, node_id: str) -> float:
        for meta in self.score_meta:
            if meta.node_id == node_id:
                return meta.norm_score
        return 0.0

    def top_score_meta(
        self, k: int = SCORE_META_TOP_K, winner_node_id: str = ""
    ) -> List["NodeScoreMeta"]:
        """The trim-on-read the score_node docstring promises: top-K
        entries by norm_score (stable: earlier-scored wins ties), with
        the actual winner always retained even when its normalized
        score was not among the K best (preemption splices and walk
        emission order can crown a non-maximal node).  The in-memory
        list stays complete; every serialization surface reads through
        here so score_meta can't ship 1k entries per eval."""
        if len(self.score_meta) <= k:
            return list(self.score_meta)
        ranked = sorted(
            range(len(self.score_meta)),
            key=lambda i: (-self.score_meta[i].norm_score, i),
        )
        keep = set(ranked[:k])
        if winner_node_id:
            for i, meta in enumerate(self.score_meta):
                if meta.node_id == winner_node_id and i not in keep:
                    # the winner displaces the weakest kept entry
                    keep.discard(ranked[k - 1])
                    keep.add(i)
                    break
        return [
            m for i, m in enumerate(self.score_meta) if i in keep
        ]


# ---------------------------------------------------------------------------
# Scheduler configuration (reference structs.go SchedulerConfiguration)
# ---------------------------------------------------------------------------


@dataclass
class PreemptionConfig:
    system_scheduler_enabled: bool = True
    batch_scheduler_enabled: bool = False
    service_scheduler_enabled: bool = False


@dataclass
class SchedulerConfiguration:
    scheduler_algorithm: str = SCHEDULER_ALGORITHM_BINPACK
    preemption_config: PreemptionConfig = field(default_factory=PreemptionConfig)
    # nomad-tpu extension: route service/batch/system evals through the
    # vectorized TPU scoring backend (SURVEY.md section 7.6 analog of the
    # reference's runtime-mutable scheduler config, stack.go:256,382).
    tpu_scheduler_enabled: bool = False

    def effective_scheduler_algorithm(self) -> str:
        return self.scheduler_algorithm or SCHEDULER_ALGORITHM_BINPACK
