"""Per-universe metric reduction and the robustness/latency frontier.

The port's copy of ``consul_tpu/sweep/frontier.py`` (numpy only), with
:func:`stream_points`, the throughput-curve reduction of bench.py's
streaming section.  A sweep's raw output is the stacked per-tick counter pytree the scan
entrypoints already emit ([U, steps, …] on the host); this module
reduces it to per-universe scalars — false-positive rate, incarnation
flaps, detection-latency quantiles, convergence tick — and extracts
the Pareto frontier over (robustness, latency): the tuning-curve
deliverable of "Robust and Tuneable Family of Gossiping Algorithms"
(PAPERS.md).  All host-side numpy: the device program stays exactly
the batched scan.

Conventions: metrics are float64 [U] arrays with NaN where a quantity
is undefined for the study (e.g. detection latency in a
subject-alive FP study, fp_rate for models without an FP counter).
Times follow the report classes in sim/metrics.py: tick t's counters
describe the state AFTER tick t, so the wall-clock time of an event
first visible at index t is ``(t + 1) * tick_ms``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Detection-latency quantiles reported per universe: the fraction of
#: the n-1 observers that must hold the DEAD view.
DETECT_FRACS = (0.50, 0.90, 0.99)

_DETECT_NAMES = ("detect_first_ms",) + tuple(
    f"detect_t{int(f * 100)}_ms" for f in DETECT_FRACS
)
_SWIM_NAMES = _DETECT_NAMES + (
    "false_dead_mean", "false_dead_max", "first_suspect_ms",
    "suspecting_final", "dead_known_final",
)

#: Every metric key :func:`summarize_sweep` can emit, per entrypoint —
#: the superset ``optimize_sweep`` validates its objective against
#: BEFORE running a sweep (a typo must not cost a multi-minute batched
#: program).  Pinned against real reports in tests/test_torch_sweep.py.
ENTRYPOINT_METRICS: dict = {
    "swim": frozenset(_SWIM_NAMES),
    "lifeguard": frozenset(_SWIM_NAMES + (
        "fp_total", "fp_rate", "flaps", "mean_awareness_final",
    )),
    "broadcast": frozenset({
        "infected_final", "t50_ms", "t99_ms", "converged_tick",
    }),
    "membership": frozenset(_DETECT_NAMES + (
        "suspecting_final", "dead_known_final", "suspect_cells_mean",
        "known_members_final",
    )),
    "sparse": frozenset(_DETECT_NAMES + (
        "suspecting_final", "dead_known_final", "suspect_cells_mean",
        "known_members_final",
    )),
    # Streamcast (consul_tpu/streamcast): throughput/latency axes.
    # pareto_mask MINIMIZES every column, so the throughput axis of a
    # (throughput, t99) frontier is ``undelivered_frac`` (fraction of
    # offered events not fully delivered — 0 is perfect throughput);
    # the raw rates ride along for reading the curve.
    "streamcast": frozenset({
        "events_offered", "events_delivered", "events_quiesced",
        "events_coalesced", "window_overflow",
        "offered_events_per_sim_s", "delivered_events_per_sim_s",
        "undelivered_frac", "t50_ms", "t99_ms",
    }),
    # Geo/WAN plane (consul_tpu/geo): convergence latency vs WAN byte
    # cost — the frontier axes (wan_admitted_bytes, t99_ms), both
    # minimized; overflow/waste ride along as the loud-accounting
    # columns of the brownout ladder.
    "geo": frozenset({
        "converged_frac", "t50_ms", "t99_ms", "seg_t99_ms_worst",
        "wan_offered_bytes", "wan_admitted_bytes",
        "wan_overflow_units", "wan_wasted_units",
        "wan_queue_final_units",
    }),
}


def first_tick_at_least(counts: np.ndarray, threshold: float) -> np.ndarray:
    """float64[U]: first tick index where counts[u, t] >= threshold, NaN
    if never.  ``counts`` is [U, steps]; a zero-width window (e.g. a
    crash tick at/past the sweep horizon) is "never" for every
    universe, matching first_tick in sim/metrics.py — not an argmax
    error."""
    counts = np.asarray(counts)
    if counts.shape[1] == 0:
        return np.full(counts.shape[0], np.nan)
    hit = counts >= threshold
    any_hit = hit.any(axis=1)
    idx = hit.argmax(axis=1).astype(float)
    idx[~any_hit] = np.nan
    return idx


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """bool[U]: Pareto-minimal rows of a [U, D] objective matrix (every
    column minimized).  A row is on the frontier iff no other valid row
    is <= it in every column and < in at least one; rows with any NaN
    are never on the frontier.  Duplicated points are all kept (they
    dominate nothing about each other)."""
    pts = np.asarray(points, float)
    if pts.ndim != 2:
        raise ValueError(f"points must be [U, D], got shape {pts.shape}")
    U = pts.shape[0]
    valid = ~np.isnan(pts).any(axis=1)
    mask = np.zeros(U, bool)
    for i in range(U):
        if not valid[i]:
            continue
        dominated = False
        for j in range(U):
            if i == j or not valid[j]:
                continue
            if (pts[j] <= pts[i]).all() and (pts[j] < pts[i]).any():
                dominated = True
                break
        mask[i] = not dominated
    return mask


@dataclasses.dataclass
class SweepReport:
    """One sweep's measured family: U universes, their knob coordinates,
    and per-universe metrics, plus the batched program's wall time."""

    entrypoint: str
    n: int
    U: int
    steps: int
    tick_ms: float
    knobs: tuple                 # knob paths
    values: dict                 # path -> np[U] knob values
    metrics: dict                # name -> np[U] per-universe metrics
    wall_s: float
    # What the sweep ran on (the card's name, or "cpu").
    device: str = ""
    # The stacked per-tick host outputs the metrics were reduced from
    # ([U, steps, ...], run_sweep sets them).
    outputs: tuple = None
    # telemetry=True sweeps only (consul_tpu_torch/obs): the batched
    # [U, steps, M] Consul-named metrics trace and its column names.
    metric_names: tuple = ()
    metrics_trace: "np.ndarray" = None
    # Composed (mesh=) sweeps only: the per-universe overflow (outbox
    # budget misses plus the family's own budget deferrals); None for an
    # unsharded sweep.
    outbox_overflow: "np.ndarray" = None
    # Composed sweeps: the mesh's shard count (1 for unsharded).
    devices: int = 1

    @property
    def universes_per_sec(self) -> float:
        return self.U / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def rounds_per_sec(self) -> float:
        """Aggregate simulated rounds/s across the whole sweep (U
        universes advance one tick each per round)."""
        total = self.U * self.steps
        return total / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def rounds_per_sec_per_universe(self) -> float:
        return self.steps / self.wall_s if self.wall_s > 0 else float("inf")

    def frontier(self, x: str = "fp_rate", y: str = "detect_t90_ms"):
        """Pareto-minimal universes over (metrics[x], metrics[y]) —
        robustness vs latency; the defaults fit lifeguard FP studies,
        other entrypoints pass their own axes (ENTRYPOINT_METRICS).  Returns a list of dicts (universe
        index, both coordinates, the universe's knob values), sorted
        by x."""
        for m in (x, y):
            if m not in self.metrics:
                raise ValueError(
                    f"frontier axis {m!r} is not a metric of this "
                    f"{self.entrypoint!r} sweep "
                    f"(defined: {', '.join(sorted(self.metrics))})"
                )
        pts = np.stack(
            [np.asarray(self.metrics[x], float),
             np.asarray(self.metrics[y], float)], axis=1
        )
        mask = pareto_mask(pts)
        out = [
            {
                "universe": int(i),
                x: float(pts[i, 0]),
                y: float(pts[i, 1]),
                **{k: _scalar(v[i]) for k, v in self.values.items()},
            }
            for i in np.nonzero(mask)[0]
        ]
        return sorted(out, key=lambda d: d[x])

    def accounting_ok(self) -> np.ndarray:
        """bool[U], geo sweeps: the loud-accounting identity ``offered +
        queue_prev == admitted + queue + overflow`` held on every link
        and tick of each universe."""
        if self.entrypoint != "geo" or self.outputs is None:
            raise ValueError("accounting_ok needs a geo sweep's outputs")
        _, offered, admitted, queued, overflow, _ = self.outputs
        prev = np.concatenate([np.zeros_like(queued[:, :1]),
                               queued[:, :-1]], axis=1)
        ok = offered + prev == admitted + queued + overflow
        return ok.all(axis=(1, 2))

    def summary(self) -> dict:
        """JSON-ready sweep summary."""
        def _stats(a):
            a = np.asarray(a, float)
            ok = a[~np.isnan(a)]
            if ok.size == 0:
                return None
            return {
                "mean": round(float(ok.mean()), 4),
                "min": round(float(ok.min()), 4),
                "max": round(float(ok.max()), 4),
                "defined": int(ok.size),
            }

        out = {
            "entrypoint": self.entrypoint,
            "n": self.n,
            "universes": self.U,
            "steps": self.steps,
            "knobs": list(self.knobs),
            "wall_s": round(self.wall_s, 3),
            "universes_per_sec": round(self.universes_per_sec, 3),
            "rounds_per_sec": round(self.rounds_per_sec, 2),
            "rounds_per_sec_per_universe": round(
                self.rounds_per_sec_per_universe, 3
            ),
            "metrics": {k: _stats(v) for k, v in self.metrics.items()},
        }
        if self.outbox_overflow is not None:
            # The composed plane's overflow column, never silent.
            out["devices"] = self.devices
            out["overflow_total"] = int(
                np.asarray(self.outbox_overflow).sum())
        return out


def _scalar(v):
    return float(v) if isinstance(v, (np.floating, float)) else int(v)


def _detect_metrics(dead: np.ndarray, n: int, tick_ms: float,
                    fail_at: float, defined: bool) -> dict:
    """Detection metrics from a [U, steps] dead-observer curve: first
    detection plus the DETECT_FRACS quantiles of the n-1 observers,
    each as latency-from-crash in ms (NaN when not a crash study or
    never reached).

    Only ticks at/after the crash count, the contract
    FalsePositiveReport.time_to_true_dead_ms pins: a pre-crash
    false-DEAD view that a refute later repairs must not register as a
    (negative-latency) detection — a hair-trigger suspicion scale pays
    for its false positives on the robustness axis, never by winning
    the latency axis."""
    U = dead.shape[0]
    nan = np.full(U, np.nan)
    out = {}
    start = max(int(fail_at), 0)
    targets = [("detect_first_ms", 1)] + [
        (f"detect_t{int(f * 100)}_ms", f * (n - 1)) for f in DETECT_FRACS
    ]
    for name, thresh in targets:
        if not defined:
            out[name] = nan.copy()
            continue
        t = first_tick_at_least(dead[:, start:], thresh)
        out[name] = (t + 1.0 + start - fail_at) * tick_ms
    return out


def summarize_sweep(universe, outs, wall_s: float) -> SweepReport:
    """Reduce a sweep's stacked host outputs into a SweepReport.

    ``outs`` is the per-tick output pytree of the entrypoint, stacked
    [U, steps, …] and already on the host (np.asarray'd by run_sweep).
    """
    from consul_tpu_torch.sweep.universe import SWEEP_ENTRYPOINTS

    spec = SWEEP_ENTRYPOINTS[universe.entrypoint]
    base = spec.base_cfg(universe.cfg)
    n = base.n
    tick_ms = float(base.profile.gossip_interval_ms)
    steps = universe.steps
    metrics: dict = {}

    if universe.entrypoint in ("swim", "lifeguard"):
        if universe.entrypoint == "swim":
            sus, dead = outs
        else:
            sus, dead, fp, refutes, aware = outs
            sim_s = steps * tick_ms / 1000.0
            metrics["fp_total"] = np.asarray(fp).sum(axis=1).astype(
                float
            )
            metrics["fp_rate"] = metrics["fp_total"] / sim_s
            metrics["flaps"] = np.asarray(refutes).sum(axis=1).astype(
                float
            )
            metrics["mean_awareness_final"] = np.asarray(
                aware, float
            )[:, -1]
        crash = not base.subject_alive
        dead_np = np.asarray(dead)
        metrics.update(_detect_metrics(
            dead_np, n, tick_ms,
            fail_at=float(base.fail_at_tick), defined=crash,
        ))
        # False-DEAD pressure — the robustness axis of the suspicion-
        # timeout family: observers holding a DEAD view of the still-
        # live subject (pre-crash window for crash studies, the whole
        # run for FP studies).  A short timeout (suspicion_scale << 1)
        # buys detection latency at exactly this cost.
        window = dead_np[:, :int(base.fail_at_tick)] if crash else dead_np
        if window.shape[1] > 0:
            metrics["false_dead_mean"] = window.mean(axis=1).astype(
                float
            )
            metrics["false_dead_max"] = window.max(axis=1).astype(
                float
            )
        else:
            metrics["false_dead_mean"] = np.full(dead_np.shape[0], np.nan)
            metrics["false_dead_max"] = np.full(dead_np.shape[0], np.nan)
        # First suspicion is defined for crash AND FP studies (raw sim
        # time, matching SwimReport.summary's first_suspect_ms).
        t = first_tick_at_least(np.asarray(sus), 1)
        metrics["first_suspect_ms"] = (t + 1.0) * tick_ms
        metrics["suspecting_final"] = np.asarray(sus, float)[:, -1]
        metrics["dead_known_final"] = np.asarray(dead, float)[:, -1]
    elif universe.entrypoint == "broadcast":
        infected = np.asarray(outs)
        metrics["infected_final"] = infected[:, -1].astype(float)
        for frac in (0.50, 0.99):
            t = first_tick_at_least(infected, frac * n)
            metrics[f"t{int(frac * 100)}_ms"] = (t + 1.0) * tick_ms
        metrics["converged_tick"] = first_tick_at_least(infected, n)
    elif universe.entrypoint == "streamcast":
        from consul_tpu_torch.streamcast.report import per_event_latency

        (slot_event, slot_birth, done_count, offered, delivered,
         quiesced, overflow, coalesced, _sent) = outs
        U = np.asarray(offered).shape[0]
        sim_s = steps * tick_ms / 1000.0
        metrics["events_offered"] = np.asarray(offered, float)[:, -1]
        metrics["events_delivered"] = np.asarray(
            delivered, float
        )[:, -1]
        metrics["events_quiesced"] = np.asarray(quiesced, float)[:, -1]
        metrics["events_coalesced"] = np.asarray(
            coalesced, float
        )[:, -1]
        metrics["window_overflow"] = np.asarray(overflow, float)[:, -1]
        metrics["offered_events_per_sim_s"] = (
            metrics["events_offered"] / sim_s
        )
        metrics["delivered_events_per_sim_s"] = (
            metrics["events_delivered"] / sim_s
        )
        off = metrics["events_offered"]
        metrics["undelivered_frac"] = np.where(
            off > 0, 1.0 - metrics["events_delivered"] / np.maximum(
                off, 1.0
            ), np.nan,
        )
        # Per-universe median of the per-event latency to frac*n —
        # the same reduction StreamcastReport.summary performs.
        for frac, name in ((0.50, "t50_ms"), (0.99, "t99_ms")):
            med = np.full(U, np.nan)
            for u in range(U):
                lat = np.asarray(
                    list(per_event_latency(
                        np.asarray(slot_event)[u],
                        np.asarray(slot_birth)[u],
                        np.asarray(done_count)[u],
                        n, tick_ms, frac,
                    ).values()),
                    dtype=float,
                )
                ok = lat[~np.isnan(lat)]
                if ok.size:
                    med[u] = float(np.median(ok))
            metrics[name] = med
    elif universe.entrypoint == "geo":
        per_segment, offered, admitted, queued, overflow, wasted = outs
        per_segment = np.asarray(per_segment)   # [U, steps, S]
        total = per_segment.sum(axis=2)         # [U, steps]
        seg_size = n // base.segments
        msg_bytes = base.wan_msg_bytes
        metrics["converged_frac"] = total[:, -1].astype(float) / n
        for frac in (0.50, 0.99):
            t = first_tick_at_least(total, frac * n)
            metrics[f"t{int(frac * 100)}_ms"] = (t + 1.0) * tick_ms
        # Worst segment's t99: the per-DC convergence straggler.
        seg_t = np.stack([
            first_tick_at_least(per_segment[:, :, s], 0.99 * seg_size)
            for s in range(base.segments)
        ], axis=1)                              # [U, S]
        metrics["seg_t99_ms_worst"] = (
            np.max(seg_t, axis=1) + 1.0
        ) * tick_ms                             # NaN propagates: any
        #                                         never-converged DC
        #                                         marks the universe
        metrics["wan_offered_bytes"] = (
            np.asarray(offered, float).sum(axis=(1, 2)) * msg_bytes
        )
        metrics["wan_admitted_bytes"] = (
            np.asarray(admitted, float).sum(axis=(1, 2)) * msg_bytes
        )
        metrics["wan_overflow_units"] = np.asarray(
            overflow, float
        ).sum(axis=(1, 2))
        metrics["wan_wasted_units"] = np.asarray(wasted, float)[:, -1]
        metrics["wan_queue_final_units"] = np.asarray(
            queued, float
        )[:, -1].sum(axis=1)
    else:  # membership / sparse
        sus_t, dead_t, sus_cells, known = outs
        if universe.track:
            dead0 = np.asarray(dead_t)[:, :, 0]
            sus0 = np.asarray(sus_t)[:, :, 0]
            fail_at = dict(base.fail_at).get(universe.track[0])
            metrics.update(_detect_metrics(
                dead0, n, tick_ms,
                fail_at=float(fail_at if fail_at is not None else 0),
                defined=fail_at is not None,
            ))
            metrics["suspecting_final"] = sus0[:, -1].astype(float)
            metrics["dead_known_final"] = dead0[:, -1].astype(float)
        metrics["suspect_cells_mean"] = np.asarray(
            sus_cells, float
        ).mean(axis=1)
        metrics["known_members_final"] = np.asarray(
            known, float
        )[:, -1]

    return SweepReport(
        entrypoint=universe.entrypoint,
        n=n,
        U=universe.U,
        steps=steps,
        tick_ms=tick_ms,
        knobs=tuple(universe.knobs),
        values={
            path: np.asarray(row)
            for path, row in zip(universe.knobs, universe.values)
        },
        metrics=metrics,
        wall_s=wall_s,
    )


def stream_points(rep: SweepReport, rates) -> tuple:
    """``(points, knee)`` off a ``streamload`` SweepReport: one point per
    offered load (offered and delivered events per simulated second, the
    per-event t50/t99 medians, the window overflow) and the knee, the
    first offered load whose window overflowed (None if none did)."""
    points, knee = [], None
    for i, rate in enumerate(rates):
        ov = int(rep.metrics["window_overflow"][i])
        t50 = rep.metrics["t50_ms"][i]
        t99 = rep.metrics["t99_ms"][i]
        points.append({
            "offered_rate_events_per_tick": rate,
            "offered_events_per_sim_s": round(
                float(rep.metrics["offered_events_per_sim_s"][i]), 3),
            "delivered_events_per_sim_s": round(
                float(rep.metrics["delivered_events_per_sim_s"][i]), 3),
            "t50_ms": None if np.isnan(t50) else float(t50),
            "t99_ms": None if np.isnan(t99) else float(t99),
            "window_overflow": ov,
        })
        if knee is None and ov > 0:
            knee = rate
    return points, knee
