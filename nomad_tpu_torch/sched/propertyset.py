"""Property usage counting for distinct_property and spread
(reference scheduler/propertyset.go).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

from ..structs import Allocation, Constraint, Job, Node

if TYPE_CHECKING:  # pragma: no cover
    from .context import EvalContext


def get_property(node: Optional[Node], prop: str) -> Tuple[str, bool]:
    """(reference propertyset.go:getProperty)"""
    from .feasible import resolve_target

    if node is None or not prop:
        return "", False
    val, ok = resolve_target(prop, node)
    if not ok or not isinstance(val, str):
        return "", False
    return val, True


class PropertySet:
    def __init__(self, ctx: "EvalContext", job: Job) -> None:
        self.ctx = ctx
        self.job_id = job.id
        self.namespace = job.namespace
        self.task_group = ""
        self.target_attribute = ""
        self.allowed_count = 0
        self.error_building: Optional[str] = None
        self.existing_values: Dict[str, int] = {}
        self.proposed_values: Dict[str, int] = {}
        self.cleared_values: Dict[str, int] = {}

    # -- configuration ---------------------------------------------------

    def set_constraint(self, constraint: Constraint, task_group: str) -> None:
        """distinct_property: RTarget is the allowed count (default 1)
        (reference propertyset.go:setConstraint)."""
        if constraint.rtarget:
            try:
                allowed = int(constraint.rtarget)
            except ValueError:
                self.error_building = (
                    f"failed to convert RTarget {constraint.rtarget!r} to int"
                )
                return
        else:
            allowed = 1
        self._set_target(constraint.ltarget, allowed, task_group)

    def set_target_attribute(self, attribute: str, task_group: str) -> None:
        """Spread parameterization: no allowed count."""
        self._set_target(attribute, 0, task_group)

    def _set_target(self, attribute: str, allowed: int, task_group: str) -> None:
        if task_group:
            self.task_group = task_group
        self.target_attribute = attribute
        self.allowed_count = allowed
        self._populate_existing()
        self.populate_proposed()

    # -- population ------------------------------------------------------

    def _populate_existing(self) -> None:
        allocs = self.ctx.state.allocs_by_job(self.namespace, self.job_id)
        allocs = self._filter(allocs, filter_terminal=True)
        self._count(allocs, self.existing_values)

    def populate_proposed(self) -> None:
        """(reference propertyset.go:PopulateProposed)"""
        self.proposed_values = {}
        self.cleared_values = {}

        stopping: List[Allocation] = []
        for updates in self.ctx.plan.node_update.values():
            stopping.extend(updates)
        stopping = self._filter(stopping, filter_terminal=False)

        proposed: List[Allocation] = []
        for placements in self.ctx.plan.node_allocation.values():
            proposed.extend(placements)
        proposed = self._filter(proposed, filter_terminal=True)

        self._count(stopping, self.cleared_values)
        self._count(proposed, self.proposed_values)

        for value in list(self.proposed_values):
            current = self.cleared_values.get(value)
            if current is None:
                continue
            if current == 0:
                del self.cleared_values[value]
            elif current > 1:
                self.cleared_values[value] = current - 1

    # -- queries ---------------------------------------------------------

    def satisfies_distinct_properties(
        self, option: Node, tg: str
    ) -> Tuple[bool, str]:
        nvalue, error_msg, used = self.used_count(option, tg)
        if error_msg:
            return False, error_msg
        if used < self.allowed_count:
            return True, ""
        return (
            False,
            f"distinct_property: {self.target_attribute}={nvalue} "
            f"used by {used} allocs",
        )

    def used_count(self, option: Node, tg: str) -> Tuple[str, str, int]:
        if self.error_building:
            return "", self.error_building, 0
        nvalue, ok = get_property(option, self.target_attribute)
        if not ok:
            return (
                nvalue,
                f'missing property "{self.target_attribute}"',
                0,
            )
        combined = self.get_combined_use_map()
        return nvalue, "", combined.get(nvalue, 0)

    def get_combined_use_map(self) -> Dict[str, int]:
        combined: Dict[str, int] = {}
        for values in (self.existing_values, self.proposed_values):
            for value, count in values.items():
                combined[value] = combined.get(value, 0) + count
        for value, cleared in self.cleared_values.items():
            if value not in combined:
                continue
            combined[value] = max(0, combined[value] - cleared)
        return combined

    # -- helpers ---------------------------------------------------------

    def _filter(
        self, allocs: List[Allocation], filter_terminal: bool
    ) -> List[Allocation]:
        out = []
        for alloc in allocs:
            if filter_terminal and alloc.terminal_status():
                continue
            if self.task_group and alloc.task_group != self.task_group:
                continue
            out.append(alloc)
        return out

    def _count(
        self, allocs: List[Allocation], into: Dict[str, int]
    ) -> None:
        for value, n in count_values_by_property(
            self.ctx.state, self.target_attribute, allocs
        ).items():
            into[value] = into.get(value, 0) + n


def count_values_by_property(
    state, attribute: str, allocs: List[Allocation]
) -> Dict[str, int]:
    """Allocs per value of their node's property (reference
    propertyset.go _count) — the single counting implementation shared
    by PropertySet and the batch worker's in-kernel spread inputs."""
    out: Dict[str, int] = {}
    for alloc in allocs:
        node = state.node_by_id(alloc.node_id)
        value, ok = get_property(node, attribute)
        if not ok:
            continue
        out[value] = out.get(value, 0) + 1
    return out
