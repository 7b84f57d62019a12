"""No-op stand-in for the JAX package's happens-before sanitizer
(`nomad_tpu/tsan.py`).

The state store opts into access tracking at the end of its
constructor.  The port has no sanitizer yet, so the call does nothing;
the real one is queued in ROADMAP.md.
"""
from __future__ import annotations


def maybe_instrument(obj, family: str) -> None:
    return None
