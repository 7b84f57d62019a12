"""No-op stand-in for the JAX package's eval flight recorder
(`nomad_tpu/trace.py`).

The state store, the broker, the plan applier and the workers mark
points and spans of an eval's life (``TRACE.event``, ``TRACE.span``,
``TRACE.add_span``, ``TRACE.annotate``, ``TRACE.begin``,
``TRACE.finish``) and the explain ring links to an eval's trace
(``TRACE.trace_id_of``).  The port has no recorder yet, so every call
is accepted and dropped (a trace id is ""); the real tracer is queued
in ROADMAP.md.
"""
from __future__ import annotations

from contextlib import contextmanager


class _NullTracer:
    enabled = False

    def event(self, eval_id, name, **attrs) -> None:
        return None

    def add_span(self, eval_id, name, t0, dt, **attrs) -> None:
        return None

    def annotate(self, eval_id, **attrs) -> None:
        return None

    def begin(self, eval_id, **attrs) -> None:
        return None

    def finish(self, eval_id, outcome) -> None:
        return None

    def trace_id_of(self, eval_id) -> str:
        """No trace is kept, so no explanation links to one."""
        return ""

    @contextmanager
    def span(self, eval_id, name, **attrs):
        yield


TRACE = _NullTracer()
