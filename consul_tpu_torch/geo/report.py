"""Host-side reduction of a geo study: per-segment convergence times
and per-link WAN transfer accounting (the port's copy of
``consul_tpu/geo/report.py``).

Times follow sim/metrics.py conventions: tick t's counters describe the
state AFTER tick t, so an event first visible at index t happened at
``(t + 1) * tick_ms`` simulated time.  Link counters are in UNITS (one
unit = ``msg_bytes`` WAN bytes); byte totals multiply through.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class GeoReport:
    """One geo/WAN study: the convergence curves of ``events``
    concurrent broadcast items over ``segments`` DCs, plus the
    per-directed-link WAN accounting census."""

    n: int
    segments: int
    events: int
    ticks: int
    tick_ms: float
    msg_bytes: int
    adaptive: bool
    per_segment: np.ndarray   # int32[ticks, S] — nodes holding ALL events
    offered: np.ndarray       # int32[ticks, S*S] — fresh units offered
    admitted: np.ndarray      # int32[ticks, S*S] — units through the cap
    queued: np.ndarray        # int32[ticks, S*S] — post-tick queue depth
    overflow: np.ndarray      # int32[ticks, S*S] — units dropped loudly
    # Cumulative admitted capacity spent on events the destination's
    # bridge set already held (counted at link exit, pre-loss-draw).
    wasted: np.ndarray        # int32[ticks]
    wall_s: float
    # Sharded runs only: outbox budget misses; 0 means the shards
    # exchanged every WAN message a single shard would have.
    shard_overflow: Optional[int] = None
    device: str = ""          # what the run ran on
    # telemetry=True studies only (consul_tpu_torch/obs): the [steps, M]
    # Consul-named metrics trace and its column names.
    metric_names: tuple = ()
    metrics_trace: Optional[np.ndarray] = None

    @property
    def seg_size(self) -> int:
        return self.n // self.segments

    @property
    def rounds_per_sec(self) -> float:
        return self.ticks / self.wall_s if self.wall_s > 0 else float("inf")

    def _first_tick_at(self, counts: np.ndarray, thresh: float):
        hit = np.nonzero(np.asarray(counts) >= thresh)[0]
        return int(hit[0]) if hit.size else None

    def time_to_ms(self, frac: float) -> Optional[float]:
        """Simulated ms until ``frac`` of ALL nodes hold ALL events."""
        total = self.per_segment.sum(axis=1)
        t = self._first_tick_at(total, frac * self.n)
        return None if t is None else (t + 1) * self.tick_ms

    def segment_time_to_ms(self, s: int, frac: float = 0.99):
        """Simulated ms until ``frac`` of segment ``s`` holds ALL
        events — the per-DC convergence time."""
        t = self._first_tick_at(
            self.per_segment[:, s], frac * self.seg_size
        )
        return None if t is None else (t + 1) * self.tick_ms

    def convergence_tick(self, frac: float = 0.99) -> Optional[int]:
        """First tick index at which EVERY segment reached ``frac``
        all-events coverage (None if any never did)."""
        ts = [
            self._first_tick_at(
                self.per_segment[:, s], frac * self.seg_size
            )
            for s in range(self.segments)
        ]
        if any(t is None for t in ts):
            return None
        return max(ts)

    # -- link accounting ---------------------------------------------------
    def accounting_ok(self) -> bool:
        """The loud-accounting identity, per link per tick:
        offered + queue_prev == admitted + queue + overflow."""
        queue_prev = np.vstack(
            [np.zeros((1, self.offered.shape[1]), self.queued.dtype),
             self.queued[:-1]]
        )
        return bool(np.array_equal(
            self.offered + queue_prev,
            self.admitted + self.queued + self.overflow,
        ))

    @property
    def wan_admitted_bytes(self) -> int:
        return int(self.admitted.sum()) * self.msg_bytes

    @property
    def wan_offered_bytes(self) -> int:
        return int(self.offered.sum()) * self.msg_bytes

    @property
    def wan_overflow_units(self) -> int:
        return int(self.overflow.sum())

    @property
    def wan_wasted_units(self) -> int:
        return int(self.wasted[-1])

    def summary(self) -> dict:
        return {
            "n": self.n,
            "segments": self.segments,
            "events": self.events,
            "ticks": self.ticks,
            "tick_ms": self.tick_ms,
            "adaptive": self.adaptive,
            "converged_nodes_final": int(self.per_segment[-1].sum()),
            "t50_ms": self.time_to_ms(0.50),
            "t99_ms": self.time_to_ms(0.99),
            "segment_t99_ms": [
                self.segment_time_to_ms(s) for s in range(self.segments)
            ],
            "wan_offered_bytes": self.wan_offered_bytes,
            "wan_admitted_bytes": self.wan_admitted_bytes,
            "wan_overflow_units": self.wan_overflow_units,
            "wan_wasted_units": self.wan_wasted_units,
            "wan_queue_final_units": int(self.queued[-1].sum()),
            "accounting_ok": self.accounting_ok(),
            "sim_rounds_per_sec": self.rounds_per_sec,
            **({"shard_overflow": self.shard_overflow}
               if self.shard_overflow is not None else {}),
            "device": self.device,
        }
