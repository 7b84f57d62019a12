"""Device instance accounting (reference nomad/structs/devices.go
DeviceAccounter): tracks which device instances on a node are in use and
detects oversubscription.
"""
from __future__ import annotations

from typing import Dict, List, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .structs import Allocation, Node


class DeviceAccounter:
    def __init__(self, node: "Node") -> None:
        # (vendor, type, name) -> {instance_id: used_count}
        self.devices: Dict[tuple, Dict[str, int]] = {}
        for group in node.node_resources.devices:
            key = (group.vendor, group.type, group.name)
            self.devices[key] = {iid: 0 for iid in group.instance_ids}

    def add_allocs(self, allocs: List["Allocation"]) -> bool:
        """Mark instances used by the allocations; returns True if any
        instance is used more than once or is unknown (collision)."""
        collide = False
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            ar = alloc.allocated_resources
            if ar is None:
                continue
            for tr in ar.tasks.values():
                for dev in tr.devices:
                    key = (dev.vendor, dev.type, dev.name)
                    group = self.devices.get(key)
                    if group is None:
                        collide = True
                        continue
                    for iid in dev.device_ids:
                        if iid not in group:
                            collide = True
                        else:
                            group[iid] += 1
                            if group[iid] > 1:
                                collide = True
        return collide

    def add_reserved(self, vendor: str, type_: str, name: str, ids: List[str]) -> bool:
        group = self.devices.get((vendor, type_, name))
        if group is None:
            return True
        collide = False
        for iid in ids:
            if iid not in group:
                collide = True
            else:
                group[iid] += 1
                if group[iid] > 1:
                    collide = True
        return collide

    def free_instances(self, vendor: str, type_: str, name: str) -> List[str]:
        group = self.devices.get((vendor, type_, name), {})
        return [iid for iid, used in group.items() if used == 0]
