"""Limit walk + max-score selection (reference scheduler/select.go).

The LimitIterator's skip machinery is the part of the reference the TPU
kernel must emulate exactly to stay bit-identical: it emits up to ``limit``
options, diverting up to ``max_skip`` options scoring <= threshold into a
side list that is replayed only if the source runs dry
(select.go:35 Next / :60 nextOption).  `ops/select_walk.py` implements the
same automaton over a vector of all scores.
"""
from __future__ import annotations

from typing import List, Optional

from .context import EvalContext
from .rank import RankedNode


class LimitIterator:
    def __init__(
        self,
        ctx: EvalContext,
        source,
        limit: int,
        score_threshold: float,
        max_skip: int,
    ) -> None:
        self.ctx = ctx
        self.source = source
        self.limit = limit
        self.max_skip = max_skip
        self.score_threshold = score_threshold
        self.seen = 0
        self.skipped_nodes: List[RankedNode] = []
        self.skipped_node_index = 0

    def set_limit(self, limit: int) -> None:
        self.limit = limit

    def next(self) -> Optional[RankedNode]:
        if self.seen == self.limit:
            return None
        option = self._next_option()
        if option is None:
            return None

        if len(self.skipped_nodes) < self.max_skip:
            while (
                option is not None
                and option.final_score <= self.score_threshold
                and len(self.skipped_nodes) < self.max_skip
            ):
                self.skipped_nodes.append(option)
                option = self.source.next()
        self.seen += 1
        if option is None:
            return self._next_option()
        return option

    def _next_option(self) -> Optional[RankedNode]:
        source_option = self.source.next()
        if source_option is None and self.skipped_node_index < len(
            self.skipped_nodes
        ):
            skipped = self.skipped_nodes[self.skipped_node_index]
            self.skipped_node_index += 1
            return skipped
        return source_option

    def reset(self) -> None:
        self.source.reset()
        self.seen = 0
        self.skipped_nodes = []
        self.skipped_node_index = 0


class MaxScoreIterator:
    """Consumes the stream and keeps the strict maximum, so the first
    option in walk order wins ties (reference select.go:94)."""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source
        self.max: Optional[RankedNode] = None

    def next(self) -> Optional[RankedNode]:
        if self.max is not None:
            return None
        while True:
            option = self.source.next()
            if option is None:
                return self.max
            if self.max is None or option.final_score > self.max.final_score:
                self.max = option

    def reset(self) -> None:
        self.source.reset()
        self.max = None
