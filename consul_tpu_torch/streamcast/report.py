"""Host-side reduction of a streamcast trace into the throughput/
latency deliverables (a numpy copy of ``consul_tpu/streamcast/report.py``).

The scan emits O(ticks x W) window snapshots — ``slot_event[t, w]``
(who occupied each slot), ``slot_birth[t, w]`` and ``done_count[t, w]``
(nodes holding every chunk) — plus cumulative counters.  This module
reconstructs per-event delivery curves from the snapshots and reduces
them to the metric the north star actually needs: sustained events/sec
against offered load, with per-event delivery-latency quantiles and
the window-overflow saturation signal.  All numpy, all host-side: the
device program stays exactly the scan.

Time convention (sim/metrics.py): tick t's counters describe the state
AFTER tick t, so an event arriving in tick b and first complete at
index t has latency ``(t + 1 - b) * tick_ms``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Per-event delivery fractions reported (t50/t99 of the n nodes).
DELIVERY_FRACS = (0.50, 0.99)


def per_event_latency(slot_event: np.ndarray, slot_birth: np.ndarray,
                      done_count: np.ndarray, n: int, tick_ms: float,
                      frac: float) -> dict:
    """``{event_id: latency_ms}`` to ``frac * n`` delivery for every
    event observed in the window trace; NaN when the event never
    reached the fraction before its slot retired (quiesce, supersede,
    or horizon).  Arrays are [steps, W]."""
    slot_event = np.asarray(slot_event)
    slot_birth = np.asarray(slot_birth)
    done_count = np.asarray(done_count)
    out: dict = {}
    seen = np.unique(slot_event[slot_event >= 0])
    for ev in seen:
        mask = slot_event == ev                     # [steps, W]
        birth = int(slot_birth[mask][0])
        curve = np.where(mask, done_count, 0).sum(axis=1)
        hit = np.nonzero(curve >= frac * n)[0]
        out[int(ev)] = (
            float((hit[0] + 1 - birth) * tick_ms) if hit.size
            else float("nan")
        )
    return out


def latency_quantiles(slot_event, slot_birth, done_count, n: int,
                      tick_ms: float) -> dict:
    """The per-load-point summary the throughput curve carries: for
    each DELIVERY_FRACS fraction, the median/p95 over events of the
    per-event latency to that fraction, plus how many events defined
    it."""
    out: dict = {}
    for frac in DELIVERY_FRACS:
        lat = np.asarray(
            list(per_event_latency(
                slot_event, slot_birth, done_count, n, tick_ms, frac
            ).values()),
            dtype=float,
        )
        ok = lat[~np.isnan(lat)]
        tag = f"t{int(frac * 100)}"
        if ok.size:
            out[f"{tag}_ms_median"] = round(float(np.median(ok)), 1)
            out[f"{tag}_ms_p95"] = round(
                float(np.percentile(ok, 95)), 1
            )
        else:
            out[f"{tag}_ms_median"] = None
            out[f"{tag}_ms_p95"] = None
        out[f"{tag}_defined"] = int(ok.size)
    return out


@dataclasses.dataclass
class StreamcastReport:
    """One streamcast study: the window trace plus cumulative
    accounting, reduced on demand."""

    n: int
    ticks: int
    tick_ms: float
    window: int
    chunks: int
    k_events: int
    slot_event: np.ndarray      # int32[ticks, W]
    slot_birth: np.ndarray      # int32[ticks, W]
    done_count: np.ndarray      # int32[ticks, W]
    offered: np.ndarray         # int32[ticks] cumulative
    delivered: np.ndarray       # int32[ticks] cumulative
    quiesced: np.ndarray        # int32[ticks] cumulative
    window_overflow: np.ndarray  # int32[ticks] cumulative
    coalesced: np.ndarray       # int32[ticks] cumulative
    sent: np.ndarray            # int32[ticks] chunk copies offered/round
    wall_s: float
    # Chunk-selection policy of the study (model.POLICIES) — the label
    # every per-policy curve/telemetry row carries.
    policy: str = "uniform"
    # Sharded runs only: outbox budget misses.
    shard_overflow: int = None
    device: str = ""            # what the run ran on (not in summary())

    @property
    def sim_seconds(self) -> float:
        return self.ticks * self.tick_ms / 1000.0

    @property
    def rounds_per_sec(self) -> float:
        return self.ticks / self.wall_s if self.wall_s > 0 else float(
            "inf"
        )

    @property
    def offered_total(self) -> int:
        return int(self.offered[-1])

    @property
    def delivered_total(self) -> int:
        return int(self.delivered[-1])

    @property
    def offered_per_sec(self) -> float:
        """Offered load actually seen, events per SIMULATED second."""
        return self.offered_total / self.sim_seconds

    @property
    def events_per_sec(self) -> float:
        """Sustained throughput: fully-delivered events per SIMULATED
        second — the number the saturation curve plots against
        offered_per_sec."""
        return self.delivered_total / self.sim_seconds

    @property
    def saturated(self) -> bool:
        """True once the pipeline window overflowed: offered load x
        event lifetime exceeded W and arrivals were dropped — the
        knee of the throughput curve."""
        return int(self.window_overflow[-1]) > 0

    def delivery_ms(self, frac: float) -> dict:
        return per_event_latency(
            self.slot_event, self.slot_birth, self.done_count,
            self.n, self.tick_ms, frac,
        )

    def summary(self) -> dict:
        q = latency_quantiles(
            self.slot_event, self.slot_birth, self.done_count,
            self.n, self.tick_ms,
        )
        return {
            "n": self.n,
            "ticks": self.ticks,
            "tick_ms": self.tick_ms,
            "window": self.window,
            "chunks_per_event": self.chunks,
            "policy": self.policy,
            "events_offered": self.offered_total,
            "events_delivered": self.delivered_total,
            "events_quiesced": int(self.quiesced[-1]),
            "events_coalesced": int(self.coalesced[-1]),
            "window_overflow": int(self.window_overflow[-1]),
            "saturated": self.saturated,
            "offered_events_per_sim_s": round(self.offered_per_sec, 3),
            "delivered_events_per_sim_s": round(self.events_per_sec, 3),
            "peak_chunks_sent_per_round": int(self.sent.max())
            if self.sent.size else 0,
            **q,
            "sim_rounds_per_sec": self.rounds_per_sec,
            **({"shard_overflow": int(self.shard_overflow)}
               if self.shard_overflow is not None else {}),
        }
