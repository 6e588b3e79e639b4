"""Host-side study reports (the slice's copy of ``consul_tpu/sim/metrics.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def time_to_fraction(counts: np.ndarray, n: int, frac: float) -> Optional[int]:
    """First tick index at which counts/n >= frac, or None if never."""
    hit = np.nonzero(np.asarray(counts) >= frac * n)[0]
    return int(hit[0]) if hit.size else None


@dataclasses.dataclass
class BroadcastReport:
    """Infection curve summary for one event broadcast."""

    n: int
    ticks: int
    tick_ms: float
    infected: np.ndarray          # int per tick (post-tick counts)
    wall_s: float                 # host wall time for the simulated run
    # Sharded runs only: outbox messages dropped to the static per-shard
    # budget; 0 means the sharded run delivered exactly what one shard
    # would.
    overflow: Optional[int] = None
    device: str = ""              # what the run ran on

    def time_to_ms(self, frac: float) -> Optional[float]:
        t = time_to_fraction(self.infected, self.n, frac)
        return None if t is None else (t + 1) * self.tick_ms

    @property
    def rounds_per_sec(self) -> float:
        return self.ticks / self.wall_s if self.wall_s > 0 else float("inf")

    def summary(self) -> dict:
        return {
            "n": self.n,
            "ticks": self.ticks,
            "tick_ms": self.tick_ms,
            "infected_final": int(self.infected[-1]),
            "t50_ms": self.time_to_ms(0.50),
            "t99_ms": self.time_to_ms(0.99),
            "t9999_ms": self.time_to_ms(0.9999),
            "sim_rounds_per_sec": self.rounds_per_sec,
            "device": self.device,
        }
