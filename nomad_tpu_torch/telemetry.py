"""Telemetry: in-memory metrics with counters, gauges and timing samples.

Copy of `nomad_tpu/telemetry.py`'s `percentile`, `_Summary` and
`Metrics` (the store the server and the batch worker write into and
`dump()` reads); the metric-history ring and the cluster-scope
registries are not ported yet.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple



def percentile(ordered: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list — the single
    shared implementation (summary snapshots here, the device
    supervisor's probe-latency status) so /v1/metrics and /v1/device
    can never report different p99s for the same ring."""
    if not ordered:
        return 0.0
    idx = min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))
    return ordered[idx]


class _Summary:
    __slots__ = (
        "count", "total", "min", "max", "_ring", "_ring_ex",
        "_ring_pos",
    )

    # sliding window for percentile estimates: large enough for a
    # stable p99 over recent traffic, small enough to stay O(1) memory
    RING = 2048
    # exemplar trace ids reported per snapshot (the p99 ring entries)
    EXEMPLARS = 4

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        # -inf, not 0.0: an all-negative sample stream must report its
        # true (negative) max, mirroring min's +inf idiom
        self.max = float("-inf")
        self._ring: List[float] = []
        # exemplar per ring slot: the trace (eval) id that produced
        # the sample, or None — links a slow percentile to the eval
        # that caused it (/v1/traces/<id>)
        self._ring_ex: List[Optional[str]] = []
        self._ring_pos = 0

    def add(self, value: float, exemplar: Optional[str] = None) -> None:
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if len(self._ring) < self.RING:
            self._ring.append(value)
            self._ring_ex.append(exemplar)
        else:
            self._ring[self._ring_pos] = value
            self._ring_ex[self._ring_pos] = exemplar
            self._ring_pos = (self._ring_pos + 1) % self.RING

    def _percentile(self, ordered: List[float], q: float) -> float:
        return percentile(ordered, q)

    def _exemplars(self, p99: float) -> List[Dict]:
        """Trace refs of the ring entries at or above p99, slowest
        first — the samples an operator will want to explain.  A ref
        is whatever the caller passed (callers pass eval ids), and
        /v1/traces/<ref> resolves it — to the newest generation when
        the eval was redelivered."""
        tagged = sorted(
            (
                (v, ex)
                for v, ex in zip(self._ring, self._ring_ex)
                if ex is not None and v >= p99
            ),
            reverse=True,
        )
        return [
            {"value": v, "trace_id": ex}
            for v, ex in tagged[: self.EXEMPLARS]
        ]

    def snapshot(self) -> Dict:
        ordered = sorted(self._ring)
        p99 = self._percentile(ordered, 0.99)
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            # percentiles over the sliding window (last RING samples)
            "p50": self._percentile(ordered, 0.50),
            "p90": self._percentile(ordered, 0.90),
            "p99": p99,
            # trace exemplars for the slow tail (eval flight recorder)
            "exemplars": self._exemplars(p99),
        }


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._samples: Dict[str, _Summary] = defaultdict(_Summary)
        # happens-before sanitizer (NOMAD_TPU_TSAN=1)
        from .tsan import maybe_instrument

        maybe_instrument(self, "Metrics")

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def add_sample(
        self, name: str, value: float,
        exemplar: Optional[str] = None,
    ) -> None:
        with self._lock:
            self._samples[name].add(value, exemplar)

    def get_counter(self, name: str) -> float:
        """O(1) single-counter read (tests/operators polling one hot
        counter — e.g. the optimistic-replay `replay.*` family —
        shouldn't pay for a full dump() copy)."""
        with self._lock:
            return self._counters.get(name, 0.0)

    def get_gauge(self, name: str) -> Optional[float]:
        """O(1) single-gauge read; None when the gauge was never set."""
        with self._lock:
            return self._gauges.get(name)

    def get_sample(self, name: str) -> Optional[Dict]:
        """Snapshot of ONE summary (None when never sampled) without
        paying for a full dump() copy — the overload controller polls
        the flight-recorder latency p99 at mode-evaluation cadence."""
        with self._lock:
            summary = self._samples.get(name)
            return summary.snapshot() if summary is not None else None

    def preregister(
        self,
        counters=(),
        gauges=(),
        samples=(),
    ) -> None:
        """Zero-register metric names so they appear on /v1/metrics and
        prometheus scrapes from process start (a `device.failover`
        counter that only materializes DURING an incident would make
        absence-of-series indistinguishable from absence-of-failures
        on every dashboard)."""
        with self._lock:
            for name in counters:
                self._counters[name] += 0.0
            for name in gauges:
                self._gauges.setdefault(name, 0.0)
            for name in samples:
                self._samples[name]  # defaultdict materializes it

    @contextmanager
    def measure(self, name: str):
        """(reference go-metrics MeasureSince)"""
        start = time.monotonic()
        try:
            yield
        finally:
            self.add_sample(name, (time.monotonic() - start) * 1000.0)

    def dump(self) -> Dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "samples": {
                    k: s.snapshot() for k, s in self._samples.items()
                },
            }

    def dump_lean(self) -> Dict:
        """dump() without the per-summary exemplar scan — the history
        snapshotter's cadence payload (exemplar trace refs are a
        point-in-time debugging surface, not a time series)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "samples": {
                    k: {
                        "count": s.count,
                        "p50": percentile(sorted(s._ring), 0.50),
                        "p99": percentile(sorted(s._ring), 0.99),
                    }
                    for k, s in self._samples.items()
                },
            }

    def prometheus_text(self) -> str:
        lines: List[str] = []
        # esc() is lossy (both "." and "-" map to "_"), so two
        # distinct store names can collide into one scrape name —
        # which Prometheus rejects as a duplicate series.  First
        # occurrence (sorted order, counters < gauges < summaries)
        # wins; later collisions are skipped with a comment so the
        # scrape stays valid and the loss is visible.
        emitted: set = set()

        def esc(name: str) -> str:
            return name.replace(".", "_").replace("-", "_")

        def claim(name: str) -> Optional[str]:
            base = esc(name)
            if base in emitted:
                lines.append(
                    f"# collision: {name} already emitted as {base}"
                )
                return None
            emitted.add(base)
            return base

        with self._lock:
            for name, value in sorted(self._counters.items()):
                base = claim(name)
                if base is None:
                    continue
                lines.append(f"# TYPE {base} counter")
                lines.append(f"{base} {value}")
            for name, value in sorted(self._gauges.items()):
                base = claim(name)
                if base is None:
                    continue
                lines.append(f"# TYPE {base} gauge")
                lines.append(f"{base} {value}")
            for name, summary in sorted(self._samples.items()):
                base = claim(name)
                if base is None:
                    continue
                snap = summary.snapshot()
                lines.append(f"# TYPE {base} summary")
                lines.append(f"{base}_count {snap['count']}")
                lines.append(f"{base}_sum {snap['sum']}")
                for q, key in (
                    ("0.5", "p50"),
                    ("0.9", "p90"),
                    ("0.99", "p99"),
                ):
                    lines.append(
                        f'{base}{{quantile="{q}"}} {snap[key]}'
                    )
        return "\n".join(lines) + "\n"
