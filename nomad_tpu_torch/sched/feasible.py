"""Feasibility checking: the host-side oracle chain.

A faithful re-expression of the reference's `scheduler/feasible.go`:
pull-based FeasibleIterators and FeasibilityCheckers, including the
computed-class memoization wrapper (feasible.go:994) that lets repeated
checks on identical node classes short-circuit.  The vectorized mask
equivalents live in `nomad_tpu/ops/constraints.py`.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from ..structs import (
    Constraint,
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY,
    Job,
    NetworkIndex,
    Node,
    TaskGroup,
    VolumeRequest,
)
from ..structs.device_accounting import DeviceAccounter
from .context import (
    CLASS_ELIGIBLE,
    CLASS_ESCAPED,
    CLASS_INELIGIBLE,
    CLASS_UNKNOWN,
    EvalContext,
)
from .operators import check_constraint
from .propertyset import PropertySet

FILTER_CONSTRAINT_DRIVERS = "missing drivers"
FILTER_CONSTRAINT_DEVICES = "missing devices"
FILTER_CONSTRAINT_HOST_VOLUMES = "missing compatible host volumes"
FILTER_CONSTRAINT_CSI_VOLUMES = "missing CSI plugins"
FILTER_CONSTRAINT_NETWORK = "missing network"
# the memoized-class short-circuit reason (FeasibilityWrapper)
FILTER_CLASS_INELIGIBLE = "computed class ineligible"


def resolve_target(target: str, node: Node) -> Tuple[Optional[str], bool]:
    """Interpolate a constraint target against a node
    (reference feasible.go:713 resolveTarget)."""
    if not target.startswith("${"):
        return target, True
    if target == "${node.unique.id}":
        return node.id, True
    if target == "${node.datacenter}":
        return node.datacenter, True
    if target == "${node.unique.name}":
        return node.name, True
    if target == "${node.class}":
        return node.node_class, True
    if target.startswith("${attr."):
        key = target[len("${attr.") : -1]
        val = node.attributes.get(key)
        return val, val is not None
    if target.startswith("${meta."):
        key = target[len("${meta.") : -1]
        val = node.meta.get(key)
        return val, val is not None
    return None, False


def target_column_key(target: str) -> Optional[str]:
    """Map a constraint target to a NodeTable column key; None for literal
    values, "" for unresolvable interpolations."""
    if not target.startswith("${"):
        return None
    if target == "${node.unique.id}":
        return "node.id"
    if target == "${node.datacenter}":
        return "node.datacenter"
    if target == "${node.unique.name}":
        return "node.name"
    if target == "${node.class}":
        return "node.class"
    if target.startswith("${attr."):
        return "attr." + target[len("${attr.") : -1]
    if target.startswith("${meta."):
        return "meta." + target[len("${meta.") : -1]
    return ""


# ---------------------------------------------------------------------------
# Source iterators
# ---------------------------------------------------------------------------


class StaticIterator:
    """Returns nodes in a fixed order (reference feasible.go:75); the
    "random" variant is the same iterator over a pre-shuffled list."""

    def __init__(self, ctx: EvalContext, nodes: List[Node]) -> None:
        self.ctx = ctx
        self.nodes = nodes
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[Node]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        option = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        self.ctx.metrics.evaluate_node()
        return option

    def reset(self) -> None:
        self.seen = 0

    def set_nodes(self, nodes: List[Node]) -> None:
        self.nodes = nodes
        self.offset = 0
        self.seen = 0


def new_random_iterator(ctx: EvalContext, nodes: List[Node]) -> StaticIterator:
    nodes = list(nodes)
    shuffle_nodes(ctx.rng, nodes)
    return StaticIterator(ctx, nodes)


def shuffle_nodes(rng, nodes: List[Node]) -> None:
    """Seeded shuffle (reference scheduler/util.go:338 shuffleNodes uses
    Fisher-Yates over the global rand).  Implemented as a numpy
    permutation keyed off the context RNG so (a) the oracle and the TPU
    kernel path derive the *identical* visit order from the same seed and
    (b) shuffling 10k+ nodes costs microseconds, not milliseconds."""
    order = shuffle_permutation(rng, len(nodes))
    nodes[:] = [nodes[i] for i in order]


def shuffle_permutation(rng, n: int) -> "np.ndarray":
    """The permutation `shuffle_nodes` applies, as indices."""
    import numpy as np

    seed = rng.randrange(2**32)
    return np.random.default_rng(seed).permutation(n)


# ---------------------------------------------------------------------------
# Checkers
# ---------------------------------------------------------------------------


class ConstraintChecker:
    """(reference feasible.go:674)"""

    def __init__(self, ctx: EvalContext, constraints: List[Constraint]) -> None:
        self.ctx = ctx
        self.constraints = constraints

    def set_constraints(self, constraints: List[Constraint]) -> None:
        self.constraints = constraints

    def feasible(self, option: Node) -> bool:
        for constraint in self.constraints:
            if not self._meets(constraint, option):
                self.ctx.metrics.filter_node(option, str(constraint))
                return False
        return True

    def _meets(self, constraint: Constraint, option: Node) -> bool:
        lval, lok = resolve_target(constraint.ltarget, option)
        rval, rok = resolve_target(constraint.rtarget, option)
        return check_constraint(
            constraint.operand,
            lval,
            rval,
            lok,
            rok,
            self.ctx.regex_cache,
            self.ctx.version_cache,
        )


class DriverChecker:
    """(reference feasible.go:398)"""

    def __init__(self, ctx: EvalContext, drivers: Iterable[str] = ()) -> None:
        self.ctx = ctx
        self.drivers = set(drivers)

    def set_drivers(self, drivers: Iterable[str]) -> None:
        self.drivers = set(drivers)

    def feasible(self, option: Node) -> bool:
        if self._has_drivers(option):
            return True
        self.ctx.metrics.filter_node(option, FILTER_CONSTRAINT_DRIVERS)
        return False

    def _has_drivers(self, option: Node) -> bool:
        for driver in self.drivers:
            if driver in option.drivers:
                if not option.drivers[driver]:
                    return False
                continue
            value = option.attributes.get(f"driver.{driver}")
            if value is None or value in ("", "0", "false", "False"):
                return False
        return True


class HostVolumeChecker:
    """(reference feasible.go:117)"""

    def __init__(self, ctx: EvalContext) -> None:
        self.ctx = ctx
        self.volumes: Dict[str, VolumeRequest] = {}

    def set_volumes(self, volumes: Dict[str, VolumeRequest]) -> None:
        self.volumes = {
            name: req for name, req in volumes.items() if req.type == "host"
        }

    def feasible(self, option: Node) -> bool:
        for req in self.volumes.values():
            vol = option.host_volumes.get(req.source)
            if vol is None:
                self.ctx.metrics.filter_node(
                    option, FILTER_CONSTRAINT_HOST_VOLUMES
                )
                return False
            if vol.read_only and not req.read_only:
                self.ctx.metrics.filter_node(
                    option, FILTER_CONSTRAINT_HOST_VOLUMES
                )
                return False
        return True


class CSIVolumeChecker:
    """CSI feasibility (reference feasible.go:194 CSIVolumeChecker):
    each requested volume must be registered, schedulable, have claim
    capacity for the requested access, and the node must run a healthy
    instance of the plugin backing it."""

    def __init__(self, ctx: EvalContext) -> None:
        self.ctx = ctx
        self.namespace = "default"
        self.requests: List[VolumeRequest] = []

    def set_namespace(self, namespace: str) -> None:
        self.namespace = namespace

    def set_volumes(self, volumes: Dict[str, VolumeRequest]) -> None:
        self.requests = [
            req for req in volumes.values() if req.type == "csi"
        ]

    def feasible(self, option: Node) -> bool:
        for req in self.requests:
            vol = self.ctx.state.csi_volume_by_id(
                self.namespace, req.source
            )
            if (
                vol is None
                or not vol.claimable(req.read_only)
                or not option.csi_node_plugins.get(vol.plugin_id, False)
            ):
                self.ctx.metrics.filter_node(
                    option, FILTER_CONSTRAINT_CSI_VOLUMES
                )
                return False
        return True


class NetworkChecker:
    """(reference feasible.go:319)"""

    def __init__(self, ctx: EvalContext) -> None:
        self.ctx = ctx
        self.network_mode = "host"

    def set_network(self, network) -> None:
        self.network_mode = network.mode or "host"

    def feasible(self, option: Node) -> bool:
        if self.network_mode in ("host", ""):
            return True
        for net in option.node_resources.networks:
            if (net.mode or "host") == self.network_mode:
                return True
        self.ctx.metrics.filter_node(option, FILTER_CONSTRAINT_NETWORK)
        return False


class DeviceChecker:
    """Whether a node can possibly satisfy the task group's device asks,
    counting instances and applying device-attribute constraints
    (reference feasible.go:1138)."""

    def __init__(self, ctx: EvalContext) -> None:
        self.ctx = ctx
        self.required: List = []

    def set_task_group(self, tg: TaskGroup) -> None:
        self.required = [
            req
            for task in tg.tasks
            for req in task.resources.devices
        ]

    def feasible(self, option: Node) -> bool:
        if not self.required:
            return True
        if self._has_devices(option):
            return True
        self.ctx.metrics.filter_node(option, FILTER_CONSTRAINT_DEVICES)
        return False

    def _has_devices(self, option: Node) -> bool:
        for req in self.required:
            available = 0
            for group in option.node_resources.devices:
                if not group.id().matches(req.name):
                    continue
                if not self._group_meets_constraints(group, req):
                    continue
                available += len(group.instance_ids)
            if available < req.count:
                return False
        return True

    def _group_meets_constraints(self, group, req) -> bool:
        for constraint in req.constraints:
            lval, lok = _resolve_device_target(
                constraint.ltarget, group
            )
            rval, rok = _resolve_device_target(constraint.rtarget, group)
            if not check_constraint(
                constraint.operand,
                lval,
                rval,
                lok,
                rok,
                self.ctx.regex_cache,
                self.ctx.version_cache,
            ):
                return False
        return True


def _resolve_device_target(target: str, group) -> Tuple[Optional[str], bool]:
    if not target.startswith("${"):
        return target, True
    if target.startswith("${device.attr."):
        key = target[len("${device.attr.") : -1]
        val = group.attributes.get(key)
        return (str(val), True) if val is not None else (None, False)
    if target == "${device.model}":
        return group.name, True
    if target == "${device.vendor}":
        return group.vendor, True
    if target == "${device.type}":
        return group.type, True
    return None, False


# ---------------------------------------------------------------------------
# Distinct hosts / distinct property iterators
# ---------------------------------------------------------------------------


class DistinctHostsIterator:
    """(reference feasible.go:470)"""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source
        self.job: Optional[Job] = None
        self.tg: Optional[TaskGroup] = None
        self.job_distinct = False
        self.tg_distinct = False

    def set_job(self, job: Job) -> None:
        self.job = job
        self.job_distinct = any(
            c.operand == CONSTRAINT_DISTINCT_HOSTS for c in job.constraints
        )

    def set_task_group(self, tg: TaskGroup) -> None:
        self.tg = tg
        self.tg_distinct = any(
            c.operand == CONSTRAINT_DISTINCT_HOSTS for c in tg.constraints
        )

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None or not (self.job_distinct or self.tg_distinct):
                return option
            if not self._satisfies(option):
                self.ctx.metrics.filter_node(option, CONSTRAINT_DISTINCT_HOSTS)
                continue
            return option

    def _satisfies(self, option: Node) -> bool:
        proposed = self.ctx.proposed_allocs(option.id)
        for alloc in proposed:
            job_collision = alloc.job_id == self.job.id
            task_collision = alloc.task_group == self.tg.name
            if (self.job_distinct and job_collision) or (
                job_collision and task_collision
            ):
                return False
        return True

    def reset(self) -> None:
        self.source.reset()


class DistinctPropertyIterator:
    """(reference feasible.go:569)"""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source
        self.job: Optional[Job] = None
        self.tg: Optional[TaskGroup] = None
        self.job_property_sets: List[PropertySet] = []
        self.group_property_sets: Dict[str, List[PropertySet]] = {}
        self.has_constraints = False

    def set_job(self, job: Job) -> None:
        self.job = job
        for c in job.constraints:
            if c.operand != CONSTRAINT_DISTINCT_PROPERTY:
                continue
            pset = PropertySet(self.ctx, job)
            pset.set_constraint(c, "")
            self.job_property_sets.append(pset)

    def set_task_group(self, tg: TaskGroup) -> None:
        self.tg = tg
        if tg.name not in self.group_property_sets:
            sets = []
            for c in tg.constraints:
                if c.operand != CONSTRAINT_DISTINCT_PROPERTY:
                    continue
                pset = PropertySet(self.ctx, self.job)
                pset.set_constraint(c, tg.name)
                sets.append(pset)
            self.group_property_sets[tg.name] = sets
        self.has_constraints = bool(
            self.job_property_sets or self.group_property_sets[tg.name]
        )

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None or not self.has_constraints:
                return option
            if not self._satisfies(option, self.job_property_sets):
                continue
            if not self._satisfies(
                option, self.group_property_sets.get(self.tg.name, [])
            ):
                continue
            return option

    def _satisfies(self, option: Node, sets: List[PropertySet]) -> bool:
        for ps in sets:
            ok, reason = ps.satisfies_distinct_properties(option, self.tg.name)
            if not ok:
                self.ctx.metrics.filter_node(option, reason)
                return False
        return True

    def reset(self) -> None:
        self.source.reset()
        for ps in self.job_property_sets:
            ps.populate_proposed()
        for sets in self.group_property_sets.values():
            for ps in sets:
                ps.populate_proposed()


# ---------------------------------------------------------------------------
# Feasibility wrapper with computed-class memoization
# ---------------------------------------------------------------------------


class FeasibilityWrapper:
    """(reference feasible.go:994; Next at :1026)"""

    def __init__(
        self,
        ctx: EvalContext,
        source,
        job_checkers: List,
        tg_checkers: List,
        tg_available: List,
    ) -> None:
        self.ctx = ctx
        self.source = source
        self.job_checkers = job_checkers
        self.tg_checkers = tg_checkers
        self.tg_available = tg_available
        self.tg = ""

    def set_task_group(self, tg: str) -> None:
        self.tg = tg

    def reset(self) -> None:
        self.source.reset()

    def next(self) -> Optional[Node]:
        elig = self.ctx.eligibility
        metrics = self.ctx.metrics
        while True:
            option = self.source.next()
            if option is None:
                return None

            job_escaped = job_unknown = False
            status = elig.job_status(option.computed_class)
            if status == CLASS_INELIGIBLE:
                metrics.filter_node(option, FILTER_CLASS_INELIGIBLE)
                continue
            elif status == CLASS_ESCAPED:
                job_escaped = True
            elif status == CLASS_UNKNOWN:
                job_unknown = True

            failed_job = False
            for check in self.job_checkers:
                if not check.feasible(option):
                    if not job_escaped:
                        elig.set_job_eligibility(False, option.computed_class)
                    failed_job = True
                    break
            if failed_job:
                continue

            if not job_escaped and job_unknown:
                elig.set_job_eligibility(True, option.computed_class)

            tg_escaped = tg_unknown = False
            status = elig.task_group_status(self.tg, option.computed_class)
            if status == CLASS_INELIGIBLE:
                metrics.filter_node(option, FILTER_CLASS_INELIGIBLE)
                continue
            elif status == CLASS_ELIGIBLE:
                if self._available(option):
                    return option
                # class matches but transiently unavailable: block
                return None
            elif status == CLASS_ESCAPED:
                tg_escaped = True
            elif status == CLASS_UNKNOWN:
                tg_unknown = True

            failed_tg = False
            for check in self.tg_checkers:
                if not check.feasible(option):
                    if not tg_escaped:
                        elig.set_task_group_eligibility(
                            False, self.tg, option.computed_class
                        )
                    failed_tg = True
                    break
            if failed_tg:
                continue

            if not tg_escaped and tg_unknown:
                elig.set_task_group_eligibility(
                    True, self.tg, option.computed_class
                )

            if not self._available(option):
                continue

            return option

    def _available(self, option: Node) -> bool:
        for check in self.tg_available:
            if not check.feasible(option):
                return False
        return True
