"""Host-side study reports (the port's copy of ``consul_tpu/sim/metrics.py``)."""

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


def _first_tick(counts: np.ndarray) -> Optional[int]:
    hit = np.nonzero(np.asarray(counts) > 0)[0]
    return int(hit[0]) if hit.size else None


@dataclasses.dataclass
class FalsePositiveReport:
    """Accuracy summary of a Lifeguard study.  Per-tick columns:

      suspecting[t]      observers viewing the subject SUSPECT
      dead_known[t]      observers viewing the subject DEAD
      fp_events[t]       fresh ALIVE->SUSPECT transitions while the
                         subject was actually alive
      refutes[t]         incarnation bumps by the subject this tick
      mean_awareness[t]  population-mean Lifeguard health score
    """

    n: int
    ticks: int
    tick_ms: float
    probe_interval_ms: float
    lifeguard: bool
    subject_alive: bool
    fail_at_tick: int
    suspecting: np.ndarray       # int32[ticks]
    dead_known: np.ndarray       # int32[ticks]
    fp_events: np.ndarray        # int32[ticks]
    refutes: np.ndarray          # int32[ticks]
    mean_awareness: np.ndarray   # float32[ticks]
    wall_s: float
    device: str = ""             # what the run ran on

    @property
    def rounds_per_sec(self) -> float:
        return self.ticks / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def fp_total(self) -> int:
        """Total false-positive suspicion events over the study."""
        return int(np.sum(self.fp_events))

    @property
    def fp_rate(self) -> float:
        """False-positive suspicions per simulated second (cluster-wide)."""
        sim_s = self.ticks * self.tick_ms / 1000.0
        return self.fp_total / sim_s if sim_s > 0 else 0.0

    @property
    def refute_total(self) -> int:
        return int(np.sum(self.refutes))

    @property
    def flap_count(self) -> int:
        """Incarnation flaps: each refute restarts the cycle one
        incarnation higher."""
        return self.refute_total

    def first_tick(self, counts: np.ndarray) -> Optional[int]:
        return _first_tick(counts)

    def time_to_true_dead_ms(self) -> Optional[float]:
        """Simulated ms from the subject's crash to the first observer
        viewing it DEAD (None for false-positive studies or if never);
        only ticks at or after the crash count."""
        if self.subject_alive:
            return None
        t = _first_tick(np.asarray(self.dead_known)[self.fail_at_tick:])
        return None if t is None else (t + 1) * self.tick_ms

    def summary(self) -> dict:
        return {
            "n": self.n,
            "ticks": self.ticks,
            "tick_ms": self.tick_ms,
            "lifeguard": self.lifeguard,
            "fp_total": self.fp_total,
            "fp_rate_per_s": round(self.fp_rate, 4),
            "refute_total": self.refute_total,
            "flap_count": self.flap_count,
            "suspecting_final": int(self.suspecting[-1]),
            "dead_known_final": int(self.dead_known[-1]),
            "mean_awareness_final": float(self.mean_awareness[-1]),
            "time_to_true_dead_ms": self.time_to_true_dead_ms(),
            "sim_rounds_per_sec": self.rounds_per_sec,
            "device": self.device,
        }


@dataclasses.dataclass
class MembershipReport:
    """Detection curves from a full-membership study, one column per
    tracked subject."""

    n: int
    ticks: int
    tick_ms: float
    probe_interval_ms: float
    track: tuple                  # tracked subject ids
    suspecting: np.ndarray        # int32[ticks, S] -- observers suspecting j
    dead_known: np.ndarray        # int32[ticks, S]
    suspect_cells: np.ndarray     # int32[ticks] -- global suspicion pressure
    known_members: np.ndarray     # [ticks] sum of membership sizes: int32
    #                               (dense), float32 gauge (sparse)
    wall_s: float
    # Sharded runs only (a later slice).
    overflow: Optional[int] = None
    device: str = ""              # what the run ran on
    # Sparse runs only: the final state's count of evicted settled cells.
    forgotten: Optional[int] = None

    @property
    def rounds_per_sec(self) -> float:
        return self.ticks / self.wall_s if self.wall_s > 0 else float("inf")

    def first_tick(self, counts: np.ndarray) -> Optional[int]:
        return _first_tick(counts)

    def first_detection_ms(self, subject_pos: int) -> Optional[float]:
        """First tick any observer suspects tracked subject #pos, in ms."""
        t = _first_tick(self.suspecting[:, subject_pos])
        return None if t is None else (t + 1) * self.tick_ms

    def dead_converged(self, subject_pos: int,
                       observers: int) -> Optional[int]:
        """First tick when ``observers`` observers view the subject DEAD."""
        hit = np.nonzero(self.dead_known[:, subject_pos] >= observers)[0]
        return int(hit[0]) if hit.size else None

    def summary(self) -> dict:
        return {
            "n": self.n,
            "ticks": self.ticks,
            "tick_ms": self.tick_ms,
            "tracked": list(self.track),
            "first_suspect_ms": [
                self.first_detection_ms(i) for i in range(len(self.track))
            ],
            "dead_known_final": self.dead_known[-1].tolist(),
            "suspect_cells_final": int(self.suspect_cells[-1]),
            "mean_membership_final": float(self.known_members[-1]) / self.n,
            "sim_rounds_per_sec": self.rounds_per_sec,
            "device": self.device,
        }


@dataclasses.dataclass
class SwimReport:
    """Failure-detection summary for one subject."""

    n: int
    ticks: int
    tick_ms: float
    probe_interval_ms: float
    suspecting: np.ndarray        # nodes viewing subject SUSPECT, per tick
    dead_known: np.ndarray        # nodes viewing subject DEAD, per tick
    wall_s: float
    device: str = ""              # what the run ran on

    @property
    def rounds_per_sec(self) -> float:
        return self.ticks / self.wall_s if self.wall_s > 0 else float("inf")

    def first_tick(self, counts: np.ndarray) -> Optional[int]:
        return _first_tick(counts)

    def summary(self) -> dict:
        fd = _first_tick(self.suspecting)
        fdead = _first_tick(self.dead_known)
        t99 = time_to_fraction(self.dead_known, self.n - 1, 0.99)
        return {
            "n": self.n,
            "ticks": self.ticks,
            "tick_ms": self.tick_ms,
            "first_suspect_ms": None if fd is None else (fd + 1) * self.tick_ms,
            "first_dead_ms": None if fdead is None else (fdead + 1) * self.tick_ms,
            "t99_dead_known_ms": None if t99 is None else (t99 + 1) * self.tick_ms,
            "suspecting_final": int(self.suspecting[-1]),
            "dead_known_final": int(self.dead_known[-1]),
            "sim_rounds_per_sec": self.rounds_per_sec,
            "device": self.device,
        }
