"""No-op stand-in for the JAX package's eval flight recorder
(`nomad_tpu/trace.py`).

The state store marks each plan commit with ``TRACE.event(eval_id,
"store.commit", ...)``.  The port has no recorder yet, so the event is
accepted and dropped; the real tracer is queued in ROADMAP.md.
"""
from __future__ import annotations


class _NullTracer:
    def event(self, eval_id, name, **attrs) -> None:
        return None


TRACE = _NullTracer()
