"""No-op stand-in for the JAX package's adaptive-decision ledger
(`nomad_tpu/decisions.py`).

The batch worker reports its adaptive choices (chunk width, gulp cap,
admission deferrals) through ``DECISIONS.record``.  The port has none
of the ledger's readers yet (no /v1/decisions, SLO engine or CLI), so
the ledger is off: ``enabled`` is False, which also lets the hot paths
skip building a record, and every call is accepted and dropped.  The
real ledger is queued in ROADMAP.md with its readers.
"""
from __future__ import annotations


class _NullLedger:
    enabled = False

    def record(self, site, action, **kw) -> None:
        return None


DECISIONS = _NullLedger()
