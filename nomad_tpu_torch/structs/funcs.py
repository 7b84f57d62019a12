"""Resource math: fit checks and fitness scoring.

Host-side reference implementations with the exact semantics of the
reference's `nomad/structs/funcs.go` (AllocsFit:103, ScoreFitBinPack:175,
ScoreFitSpread:202).  The vectorized device versions live in
`nomad_tpu/ops/score.py`; these scalar forms are the parity oracle and the
plan-applier recheck path.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .structs import (
    Allocation,
    ComparableResources,
    Node,
)
from .network import NetworkIndex

# Maximum possible bin-packing fitness score; used to normalize to [0, 1]
# (reference scheduler/rank.go:13).
BINPACK_MAX_FIT_SCORE = 18.0


def filter_terminal_allocs(
    allocs: List[Allocation],
) -> Tuple[List[Allocation], Dict[str, Allocation]]:
    """Split out terminal allocations, keeping only the latest terminal
    allocation per name (reference funcs.go:FilterTerminalAllocs)."""
    terminal: Dict[str, Allocation] = {}
    live: List[Allocation] = []
    for alloc in allocs:
        if alloc.terminal_status():
            prev = terminal.get(alloc.name)
            if prev is None or alloc.create_index > prev.create_index:
                terminal[alloc.name] = alloc
        else:
            live.append(alloc)
    return live, terminal


def remove_allocs(
    allocs: List[Allocation], remove: List[Allocation]
) -> List[Allocation]:
    """(reference funcs.go:RemoveAllocs)"""
    drop = {a.id for a in remove}
    return [a for a in allocs if a.id not in drop]


def allocs_fit(
    node: Node,
    allocs: List[Allocation],
    net_idx: Optional[NetworkIndex] = None,
    check_devices: bool = False,
) -> Tuple[bool, str, ComparableResources]:
    """Check whether a set of allocations fits on a node.

    Returns (fit, exhausted_dimension, used).  Terminal allocations are
    ignored (reference funcs.go:103 AllocsFit).
    """
    used = ComparableResources()
    for alloc in allocs:
        if alloc.terminal_status():
            continue
        used.add(alloc.comparable_resources())

    available = node.comparable_resources()
    available.subtract(node.comparable_reserved_resources())
    ok, dim = available.superset(used)
    if not ok:
        return False, dim, used

    if net_idx is None:
        net_idx = NetworkIndex()
        if net_idx.set_node(node) or net_idx.add_allocs(allocs):
            return False, "reserved port collision", used

    if net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    if check_devices:
        from .device_accounting import DeviceAccounter

        accounter = DeviceAccounter(node)
        if accounter.add_allocs(allocs):
            return False, "device oversubscribed", used

    return True, "", used


def compute_free_percentage(
    node: Node, util: ComparableResources
) -> Tuple[float, float]:
    """Free cpu/mem fractions after subtracting node-reserved resources
    (reference funcs.go:computeFreePercentage)."""
    res = node.comparable_resources()
    reserved = node.comparable_reserved_resources()
    node_cpu = float(res.cpu) - float(reserved.cpu)
    node_mem = float(res.memory_mb) - float(reserved.memory_mb)
    free_pct_cpu = 1.0 - (float(util.cpu) / node_cpu)
    free_pct_ram = 1.0 - (float(util.memory_mb) / node_mem)
    return free_pct_cpu, free_pct_ram


def _pow10(x: float) -> float:
    """Canonical 10^x for fitness scoring: the f64 result rounds
    through float32.

    libm (host) and XLA (kernel) disagree by 1 f64 ulp on ~5% of
    inputs, so raw-f64 exponentials make bit-identical host/accelerator
    decisions impossible in principle.  The framework therefore DEFINES
    the fitness exponential at float32 precision on every
    implementation — the two sides' 1-ulp f64 differences collapse to
    the same f32 value, and all downstream arithmetic stays exact f64.
    (Decision drift vs the reference's raw-f64 math is confined to
    scores closer than ~1e-7, where the reference's own ordering is
    implementation-defined anyway.)"""
    return float(np.float32(math.pow(10.0, x)))


def pow10_np(x: "np.ndarray") -> "np.ndarray":
    """Vectorized canonical 10^x (same f32 rounding as _pow10) for
    numpy score paths that must stay bit-identical to the scalar host
    and jnp kernel implementations."""
    return np.float32(np.power(10.0, x)).astype(np.float64)


def score_fit_binpack(node: Node, util: ComparableResources) -> float:
    """Bin-packing fitness in [0, 18]: ``20 - (10^freeCpu + 10^freeRam)``
    ("BestFit v3"; reference funcs.go:175 ScoreFitBinPack)."""
    free_cpu, free_ram = compute_free_percentage(node, util)
    total = _pow10(free_cpu) + _pow10(free_ram)
    score = 20.0 - total
    if score > 18.0:
        score = 18.0
    elif score < 0.0:
        score = 0.0
    return score


def score_fit_spread(node: Node, util: ComparableResources) -> float:
    """Worst-fit (spread) fitness in [0, 18]
    (reference funcs.go:202 ScoreFitSpread)."""
    free_cpu, free_ram = compute_free_percentage(node, util)
    total = _pow10(free_cpu) + _pow10(free_ram)
    score = total - 2.0
    if score > 18.0:
        score = 18.0
    elif score < 0.0:
        score = 0.0
    return score


def net_priority(priorities: List[int]) -> float:
    """Aggregate priority of a preempted-alloc set: max plus the ratio of
    sum to max (reference scheduler/rank.go:750 netPriority)."""
    if not priorities:
        return 0.0
    mx = float(max(priorities))
    sm = float(sum(priorities))
    return mx + (sm / mx)


def preemption_score(netp: float) -> float:
    """Logistic score in (0, 1); 0.5 at netPriority 2048
    (reference scheduler/rank.go:773 preemptionScore)."""
    rate = 0.0048
    origin = 2048.0
    return 1.0 / (1.0 + math.exp(rate * (netp - origin)))
