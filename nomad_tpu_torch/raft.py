"""Stand-in for the parts of the JAX package's replication layer
(`nomad_tpu/raft/`) that the single-process server reads.

`NotLeaderError` is what the plan queue, the applier and the workers
raise and catch when leadership moves; `chaos.fire` is the race-hook
seam the batch worker calls at fixed points, a no-op here because the
port has no hook registry.  The replicated log itself is queued in
ROADMAP.md.
"""
from __future__ import annotations

from typing import Optional


class NotLeaderError(Exception):
    def __init__(self, leader: Optional[str]) -> None:
        super().__init__(f"not the leader (leader hint: {leader})")
        self.leader = leader


class _Chaos:
    @staticmethod
    def fire(name: str) -> None:
        return None


chaos = _Chaos()
