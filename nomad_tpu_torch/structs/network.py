"""Per-node network port/bandwidth ledger.

Semantic equivalent of the reference's `nomad/structs/network.go:35
NetworkIndex`: tracks used ports per host IP, detects static-port
collisions, and offers port assignments for task-group network asks.

Differences from the reference, chosen deliberately:
  * dynamic ports are assigned deterministically (lowest free port in the
    dynamic range) instead of stochastically — placement *feasibility* is
    unchanged and determinism helps the differential test suite;
  * bandwidth overcommit always reports False, matching the reference where
    bandwidth accounting is deprecated (network.go:79 Overcommitted).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .structs import Allocation, NetworkResource, Node

MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 32000


@dataclass
class AssignedPort:
    label: str = ""
    value: int = 0
    to: int = 0
    host_ip: str = ""


class NetworkIndex:
    def __init__(self) -> None:
        # ip -> set of used port numbers
        self.used_ports: Dict[str, Set[int]] = {}
        self.avail_bandwidth: Dict[str, int] = {}
        self.used_bandwidth: Dict[str, int] = {}
        self.node_ips: List[str] = []

    # -- setup ------------------------------------------------------------

    def set_node(self, node: "Node") -> bool:
        """Register the node's networks; returns True on collision among the
        node's own reserved ports."""
        collide = False
        for net in node.node_resources.networks:
            if net.device:
                self.avail_bandwidth[net.device] = net.mbits
            ip = net.ip or "0.0.0.0"
            if ip not in self.node_ips:
                self.node_ips.append(ip)
            for port in net.reserved_ports:
                if self._reserve(ip, port.value):
                    collide = True
        if not self.node_ips:
            self.node_ips.append("0.0.0.0")
        for port in node.reserved_resources.reserved_ports:
            if self._reserve(self.node_ips[0], port):
                collide = True
        return collide

    def add_allocs(self, allocs: List["Allocation"]) -> bool:
        """Track ports used by existing (non-terminal) allocations."""
        collide = False
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            ar = alloc.allocated_resources
            if ar is None:
                continue
            for port in ar.shared.ports:
                if self._reserve(port.host_ip or self._default_ip(), port.value):
                    collide = True
            for net in ar.shared.networks:
                if self._add_reserved(net):
                    collide = True
            for tr in ar.tasks.values():
                for net in tr.networks:
                    if self._add_reserved(net):
                        collide = True
        return collide

    def add_reserved(self, net: "NetworkResource") -> bool:
        return self._add_reserved(net)

    def add_reserved_ports(self, ports: List[AssignedPort]) -> bool:
        collide = False
        for p in ports:
            if self._reserve(p.host_ip or self._default_ip(), p.value):
                collide = True
        return collide

    # -- queries ----------------------------------------------------------

    def overcommitted(self) -> bool:
        # Bandwidth accounting is deprecated in the reference
        # (network.go:79); feasibility is port-driven.
        return False

    # -- assignment -------------------------------------------------------

    def assign_ports(self, ask: "NetworkResource") -> Optional[List[AssignedPort]]:
        """Offer host ports for a group-level network ask; None if a static
        port is taken (reference network.go:316 AssignPorts)."""
        ip = self._default_ip()
        used = self.used_ports.setdefault(ip, set())
        offer: List[AssignedPort] = []
        staged: Set[int] = set()

        for port in ask.reserved_ports:
            if port.value in used or port.value in staged:
                return None
            staged.add(port.value)
            offer.append(
                AssignedPort(
                    label=port.label, value=port.value, to=port.to, host_ip=ip
                )
            )

        for port in ask.dynamic_ports:
            value = self._next_dynamic(used, staged)
            if value is None:
                return None
            staged.add(value)
            to = port.to if port.to else value
            offer.append(
                AssignedPort(label=port.label, value=value, to=to, host_ip=ip)
            )
        return offer

    def assign_network(self, ask: "NetworkResource") -> Optional["NetworkResource"]:
        """Offer an interface + ports for a task-level network ask
        (reference network.go:406 AssignNetwork)."""
        from .structs import NetworkResource, Port  # local to avoid cycle

        ip = self._default_ip()
        used = self.used_ports.setdefault(ip, set())
        staged: Set[int] = set()

        reserved: List[Port] = []
        for port in ask.reserved_ports:
            if port.value in used or port.value in staged:
                return None
            staged.add(port.value)
            reserved.append(
                Port(label=port.label, value=port.value, to=port.to)
            )

        dynamic: List[Port] = []
        for port in ask.dynamic_ports:
            value = self._next_dynamic(used, staged)
            if value is None:
                return None
            staged.add(value)
            dynamic.append(Port(label=port.label, value=value, to=port.to))

        offer = NetworkResource(
            mode=ask.mode,
            ip=ip,
            mbits=ask.mbits,
            reserved_ports=reserved,
            dynamic_ports=dynamic,
        )
        if ask.mbits:
            device = ask.device or (
                next(iter(self.avail_bandwidth)) if self.avail_bandwidth else ""
            )
            self.used_bandwidth[device] = (
                self.used_bandwidth.get(device, 0) + ask.mbits
            )
        return offer

    # -- internals --------------------------------------------------------

    def _default_ip(self) -> str:
        return self.node_ips[0] if self.node_ips else "0.0.0.0"

    def _reserve(self, ip: str, port: int) -> bool:
        if port <= 0:
            return False
        used = self.used_ports.setdefault(ip, set())
        if port in used:
            return True
        used.add(port)
        return False

    def _add_reserved(self, net: "NetworkResource") -> bool:
        collide = False
        ip = net.ip or self._default_ip()
        for port in list(net.reserved_ports) + list(net.dynamic_ports):
            if self._reserve(ip, port.value):
                collide = True
        if net.mbits and net.device:
            self.used_bandwidth[net.device] = (
                self.used_bandwidth.get(net.device, 0) + net.mbits
            )
        return collide

    @staticmethod
    def _next_dynamic(used: Set[int], staged: Set[int]) -> Optional[int]:
        for candidate in range(MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT):
            if candidate not in used and candidate not in staged:
                return candidate
        return None
