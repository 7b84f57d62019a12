"""Device instance assignment with affinity scoring
(reference scheduler/device.go).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..structs import (
    AllocatedDeviceResource,
    Allocation,
    Node,
    RequestedDevice,
)
from ..structs.device_accounting import DeviceAccounter
from .feasible import _resolve_device_target
from .operators import check_affinity


def matched_affinity_weight(
    group, affinities, regex_cache, version_cache
) -> Tuple[float, float]:
    """(total |weight|, matched weight sum) of a device ask's
    affinities against one device group (reference device.go:75-90) —
    THE single implementation, shared by the sequential allocator and
    the batch prescorer's static score column so the two can never
    desynchronize."""
    total = 0.0
    matched = 0.0
    for aff in affinities:
        lval, lok = _resolve_device_target(aff.ltarget, group)
        rval, rok = _resolve_device_target(aff.rtarget, group)
        total += abs(float(aff.weight))
        if check_affinity(
            aff.operand, lval, rval, lok, rok,
            regex_cache, version_cache,
        ):
            matched += float(aff.weight)
    return total, matched


class DeviceAllocator:
    def __init__(self, ctx, node: Node) -> None:
        self.ctx = ctx
        self.node = node
        self.accounter = DeviceAccounter(node)
        self._groups = {
            (g.vendor, g.type, g.name): g for g in node.node_resources.devices
        }

    def add_allocs(self, allocs: List[Allocation]) -> bool:
        return self.accounter.add_allocs(allocs)

    def add_reserved(self, offer: AllocatedDeviceResource) -> bool:
        return self.accounter.add_reserved(
            offer.vendor, offer.type, offer.name, offer.device_ids
        )

    def assign_device(
        self, ask: RequestedDevice
    ) -> Tuple[Optional[AllocatedDeviceResource], float, str]:
        """Pick the best feasible device group for the ask; returns
        (offer, sum_matched_affinity_weights, error)
        (reference device.go:32 AssignDevice)."""
        if not self._groups:
            return None, 0.0, "no devices available"
        if ask.count == 0:
            return None, 0.0, "invalid request of zero devices"

        offer: Optional[AllocatedDeviceResource] = None
        offer_score = 0.0
        matched_weights = 0.0

        for key, group in self._groups.items():
            free = self.accounter.free_instances(*key)
            if len(free) < ask.count:
                continue
            if not group.id().matches(ask.name):
                continue
            if not self._meets_constraints(group, ask):
                continue

            choice_score = 0.0
            sum_matched = 0.0
            if ask.affinities:
                total_weight, sum_matched = matched_affinity_weight(
                    group, ask.affinities,
                    self.ctx.regex_cache, self.ctx.version_cache,
                )
                choice_score = sum_matched
                if total_weight:
                    choice_score /= total_weight

            if offer is not None and choice_score < offer_score:
                continue

            offer_score = choice_score
            matched_weights = sum_matched
            offer = AllocatedDeviceResource(
                vendor=key[0],
                type=key[1],
                name=key[2],
                device_ids=free[: ask.count],
            )

        if offer is None:
            return None, 0.0, "no devices match request"
        return offer, matched_weights, ""

    def _meets_constraints(self, group, ask: RequestedDevice) -> bool:
        for constraint in ask.constraints:
            lval, lok = _resolve_device_target(constraint.ltarget, group)
            rval, rok = _resolve_device_target(constraint.rtarget, group)
            from .operators import check_constraint

            if not check_constraint(
                constraint.operand, lval, rval, lok, rok,
                self.ctx.regex_cache, self.ctx.version_cache,
            ):
                return False
        return True
