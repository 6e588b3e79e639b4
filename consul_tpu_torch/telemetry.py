"""Telemetry: counters, gauges and timers with an in-memory sink.

The port's own copy of ``consul_tpu/telemetry.py`` (the port imports
nothing of the JAX package): the ``armon/go-metrics`` in-memory sink of
the reference (SURVEY.md §5), exposed in the /v1/agent/metrics JSON
shape (Gauges/Counters/Samples).  ``obs.bridge`` replays a study's
in-scan metrics trace into it.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional


class _Sample:
    __slots__ = ("count", "total", "sumsq", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.sumsq = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.sumsq += value * value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def stddev(self) -> float:
        """go-metrics AggregateSample.Stddev (inmem.go): sample
        standard deviation, 0 below two observations."""
        if self.count < 2:
            return 0.0
        num = self.count * self.sumsq - self.total * self.total
        div = float(self.count * (self.count - 1))
        return math.sqrt(num / div) if num > 0 else 0.0

    def snapshot(self, name: str, labels: Optional[dict] = None) -> dict:
        """The reference InmemSink DisplayMetrics SampledValue shape
        (inmem_endpoint.go): aggregate stats + the Labels map."""
        mean = self.total / self.count if self.count else 0.0
        return {
            "Name": name,
            "Count": self.count,
            "Sum": round(self.total, 6),
            "Min": round(self.min, 6) if self.count else 0.0,
            "Max": round(self.max, 6) if self.count else 0.0,
            "Mean": round(mean, 6),
            "Stddev": round(self.stddev(), 6),
            "Labels": dict(labels or {}),
        }


def _key(name: str, labels: Optional[dict]) -> tuple:
    """Registry key: metric name + frozen label set (go-metrics keys
    its inmem intervals the same way — name x label values)."""
    if not labels:
        return (name, ())
    return (name, tuple(sorted((str(k), str(v))
                               for k, v in labels.items())))


class Metrics:
    """go-metrics InmemSink: aggregated counters/gauges/timers.

    ``labels`` (a str->str map, e.g. ``{"universe": "3"}`` from the
    per-universe sweep bridge) key separate series under the same
    metric name and come back in the snapshot's ``Labels`` maps —
    the reference DisplayMetrics shape."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[tuple, _Sample] = {}
        self._gauges: dict[tuple, float] = {}
        self._samples: dict[tuple, _Sample] = {}

    def incr_counter(self, name: str, value: float = 1.0,
                     labels: Optional[dict] = None) -> None:
        with self._lock:
            self._counters.setdefault(
                _key(name, labels), _Sample()
            ).add(value)

    def set_gauge(self, name: str, value: float,
                  labels: Optional[dict] = None) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def add_sample(self, name: str, value: float,
                   labels: Optional[dict] = None) -> None:
        with self._lock:
            self._samples.setdefault(
                _key(name, labels), _Sample()
            ).add(value)

    def measure_since(self, name: str, start: float) -> None:
        """metrics.MeasureSince: elapsed milliseconds since ``start``
        (a time.monotonic() value) as a timer sample."""
        self.add_sample(name, (time.monotonic() - start) * 1000.0)

    def snapshot(self) -> dict:
        """The /v1/agent/metrics JSON shape (agent_endpoint.go
        AgentMetrics -> InmemSink DisplayMetrics)."""
        with self._lock:
            return {
                "Timestamp": time.strftime("%Y-%m-%d %H:%M:%S +0000 UTC",
                                           time.gmtime()),
                # GaugeValue carries a Labels map in the reference
                # DisplayMetrics shape (inmem_endpoint.go) — emitted
                # (empty) so consumers see the exact JSON schema.
                "Gauges": [
                    {"Name": k[0], "Value": v, "Labels": dict(k[1])}
                    for k, v in sorted(self._gauges.items())
                ],
                "Counters": [
                    s.snapshot(k[0], dict(k[1]))
                    for k, s in sorted(self._counters.items())
                ],
                "Samples": [
                    s.snapshot(k[0], dict(k[1]))
                    for k, s in sorted(self._samples.items())
                ],
            }

    def get_counter(self, name: str,
                    labels: Optional[dict] = None) -> int:
        with self._lock:
            s = self._counters.get(_key(name, labels))
            return s.count if s else 0

    def get_gauge(self, name: str,
                  labels: Optional[dict] = None) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._samples.clear()


# Process-global registry (go-metrics global metrics, telemetry.go init).
_global = Metrics()


def metrics() -> Metrics:
    return _global


def set_global(m: Metrics) -> Metrics:
    global _global
    _global = m
    return m
