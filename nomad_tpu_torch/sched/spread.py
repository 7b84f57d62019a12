"""Spread scoring (reference scheduler/spread.go).

Boost per spread attribute: ``((desired - used) / desired) * weight/sum``
with target percents of tg.count (spread.go:163), or the even-spread
min/max-delta algorithm when no targets are given (spread.go:178); the
total is appended to the score list only when non-zero.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..structs import Job, Node, Spread, TaskGroup
from .context import EvalContext
from .propertyset import PropertySet, get_property
from .rank import RankedNode

IMPLICIT_TARGET = "*"


def compute_spread_info(spreads, total_count: int):
    """Attribute-keyed desired counts + weights (reference
    spread.go:232 computeSpreadInfo).  Later stanzas overwrite earlier
    ones per attribute — reference behavior when job- and group-level
    spreads share an attribute — while every stanza's weight counts
    toward the sum.  Returns (infos, sum_weights)."""
    infos: Dict[str, dict] = {}
    sum_weights = 0
    for spread in spreads:
        desired_counts: Dict[str, float] = {}
        sum_desired = 0.0
        for target in spread.targets:
            desired = (float(target.percent) / 100.0) * float(
                total_count
            )
            desired_counts[target.value] = desired
            sum_desired += desired
        if 0 < sum_desired < float(total_count):
            desired_counts[IMPLICIT_TARGET] = (
                float(total_count) - sum_desired
            )
        infos[spread.attribute] = {
            "weight": spread.weight,
            "desired_counts": desired_counts,
        }
        sum_weights += spread.weight
    return infos, sum_weights


class SpreadIterator:
    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source
        self.job: Optional[Job] = None
        self.tg: Optional[TaskGroup] = None
        self.job_spreads: List[Spread] = []
        self.tg_spread_info: Dict[str, Dict[str, dict]] = {}
        self.sum_spread_weights = 0
        self.has_spread = False
        self.group_property_sets: Dict[str, List[PropertySet]] = {}

    def reset(self) -> None:
        self.source.reset()
        for sets in self.group_property_sets.values():
            for ps in sets:
                ps.populate_proposed()

    def set_job(self, job: Job) -> None:
        self.job = job
        if job.spreads:
            self.job_spreads = list(job.spreads)

    def set_task_group(self, tg: TaskGroup) -> None:
        self.tg = tg
        if tg.name not in self.group_property_sets:
            sets: List[PropertySet] = []
            for spread in self.job_spreads:
                pset = PropertySet(self.ctx, self.job)
                pset.set_target_attribute(spread.attribute, tg.name)
                sets.append(pset)
            for spread in tg.spreads:
                pset = PropertySet(self.ctx, self.job)
                pset.set_target_attribute(spread.attribute, tg.name)
                sets.append(pset)
            self.group_property_sets[tg.name] = sets
        self.has_spread = bool(self.group_property_sets[tg.name])
        if tg.name not in self.tg_spread_info:
            self._compute_spread_info(tg)

    def has_spreads(self) -> bool:
        return self.has_spread

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None or not self.has_spreads():
                return option

            tg_name = self.tg.name
            property_sets = self.group_property_sets[tg_name]
            total_spread_score = 0.0
            for pset in property_sets:
                nvalue, error_msg, used_count = pset.used_count(
                    option.node, tg_name
                )
                # include this prospective placement (spread.go:123)
                used_count += 1
                if error_msg:
                    total_spread_score -= 1.0
                    continue
                spread_details = self.tg_spread_info[tg_name].get(
                    pset.target_attribute
                )
                if spread_details is None:
                    continue
                desired_counts = spread_details["desired_counts"]
                if not desired_counts:
                    total_spread_score += even_spread_score_boost(
                        pset, option.node
                    )
                else:
                    desired = desired_counts.get(nvalue)
                    if desired is None:
                        desired = desired_counts.get(IMPLICIT_TARGET)
                        if desired is None:
                            total_spread_score -= 1.0
                            continue
                    spread_weight = (
                        float(spread_details["weight"])
                        / float(self.sum_spread_weights)
                    )
                    boost = (
                        (desired - float(used_count)) / desired
                    ) * spread_weight
                    total_spread_score += boost

            if total_spread_score != 0.0:
                option.scores.append(total_spread_score)
                self.ctx.metrics.score_node(
                    option.node, "allocation-spread", total_spread_score
                )
            return option

    def _compute_spread_info(self, tg: TaskGroup) -> None:
        """(reference spread.go:232 computeSpreadInfo)"""
        combined = list(tg.spreads) + list(self.job_spreads)
        infos, sum_weights = compute_spread_info(combined, tg.count)
        self.sum_spread_weights += sum_weights
        self.tg_spread_info[tg.name] = infos


def even_spread_score_boost(pset: PropertySet, option: Node) -> float:
    """(reference spread.go:178 evenSpreadScoreBoost)"""
    combined_use = pset.get_combined_use_map()
    if not combined_use:
        return 0.0
    nvalue, ok = get_property(option, pset.target_attribute)
    if not ok:
        return -1.0
    current = combined_use.get(nvalue, 0)
    min_count = 0
    max_count = 0
    for value in combined_use.values():
        if min_count == 0 or value < min_count:
            min_count = value
        if max_count == 0 or value > max_count:
            max_count = value

    if min_count == 0:
        delta_boost = -1.0
    else:
        delta = min_count - current
        delta_boost = float(delta) / float(min_count)
    if current != min_count:
        return delta_boost
    elif min_count == max_count:
        return -1.0
    elif min_count == 0:
        return 1.0
    delta = max_count - min_count
    return float(delta) / float(min_count)
