"""Computed node class: a hash identifying nodes with identical scheduling-
relevant attributes, used to memoize feasibility results per class
(reference nomad/structs/node_class.go:31 ComputeClass, :108
EscapedConstraints).
"""
from __future__ import annotations

import hashlib
import json
from typing import TYPE_CHECKING, Iterable, List

if TYPE_CHECKING:  # pragma: no cover
    from .structs import Constraint, Node

UNIQUE_NAMESPACE = "unique."


def is_unique_namespace(key: str) -> bool:
    return key.startswith(UNIQUE_NAMESPACE)


def compute_node_class(node: "Node") -> str:
    """Hash the node's non-unique scheduling-relevant fields: datacenter,
    class, attributes, meta (minus ``unique.*`` keys) and device inventory.
    """
    payload = {
        "datacenter": node.datacenter,
        "node_class": node.node_class,
        "attributes": {
            k: v
            for k, v in sorted(node.attributes.items())
            if not is_unique_namespace(k)
        },
        "meta": {
            k: v
            for k, v in sorted(node.meta.items())
            if not is_unique_namespace(k)
        },
        "devices": sorted(
            (
                d.vendor,
                d.type,
                d.name,
                tuple(
                    sorted(
                        (k, str(v))
                        for k, v in d.attributes.items()
                        if not is_unique_namespace(k)
                    )
                ),
            )
            for d in node.node_resources.devices
        ),
    }
    digest = hashlib.sha1(
        json.dumps(payload, sort_keys=True, default=str).encode()
    ).hexdigest()
    return f"v1:{digest[:16]}"


def _target_escapes(target: str) -> bool:
    return (
        target.startswith("${node.unique.")
        or target.startswith("${attr.unique.")
        or target.startswith("${meta.unique.")
    )


def constraint_escapes_class(constraint: "Constraint") -> bool:
    """Whether a constraint targets uniquely-identifying state and therefore
    must bypass computed-class memoization."""
    return _target_escapes(constraint.ltarget) or _target_escapes(
        constraint.rtarget
    )


def escaped_constraints(constraints: Iterable["Constraint"]) -> List["Constraint"]:
    return [c for c in constraints if constraint_escapes_class(c)]
