"""Sweep presets: seed sweeps, knob grids, fault-severity matrices.

The port of ``consul_tpu/sweep/presets.py``, built on the port's
configs.  Each preset is a factory returning a :class:`Universe`;
``sim.engine.run_sweep`` runs it.  The families:

  seeds4k      U independent seeds of the flagship swim crash study —
               real error bars on first-detection time from ONE
               compiled program (the acceptance sweep: U=256 at
               n=4096, per-node dense state).
  tuning       the fanout × suspicion-scale Lifeguard grid: the
               "Robust and Tuneable Family of Gossiping Algorithms"
               experiment — every grid point is one universe, and the
               Pareto frontier over (fp_rate, detection latency) is
               the published tuning curve.
  faultmatrix  severity ladders of the three fault primitives
               (LossRamp scale × DegradedSet drop × Partition
               severity) crossed into a coverage matrix over the
               Lifeguard FP study.
  streamload   the offered-load ladder of the streamcast plane (one
  streamadv    batched program per selection policy) and its
               heavy-tail severity ladder under a standing backlog.
  wanbrownout  the bandwidth-brownout severity ladder of the geo plane.
"""

from __future__ import annotations

import itertools
import math

from consul_tpu_torch.models.lifeguard import LifeguardConfig
from consul_tpu_torch.models.swim import SwimConfig
from consul_tpu_torch.sim.faults import (
    DegradedSet,
    FaultSchedule,
    LossRamp,
    Partition,
)
from consul_tpu_torch.sweep.universe import Universe


def seed_sweep(universes=None, seed=0, n=4096, steps=60,
               loss=0.05) -> Universe:
    """U-seed error-bar sweep of the swim crash study (exact edges
    delivery): one batched program, U first-detection samples.  The
    per-universe keys fold one base key in per universe index
    (prefix-stable), so U=64 reads the same universes as the first 64
    of U=256."""
    cfg = SwimConfig(n=n, subject=7, fail_at_tick=0, loss=loss,
                     delivery="edges")
    return Universe(
        entrypoint="swim", cfg=cfg, steps=steps,
        split_from=seed,
        universes=256 if universes is None else universes,
    )


def tuning_grid(universes=None, seed=0, n=1024,
                fanouts=(2, 3, 4, 6), scales=(0.05, 0.15, 0.5, 1.5),
                loss=0.40, ack_late=0.15, fail_at=120,
                steps=None) -> Universe:
    """Fanout × suspicion-scale Lifeguard grid: a crash study under
    heavy loss and WAN tail latency, so every universe yields BOTH a
    robustness cost (false-DEAD views of the still-live subject before
    the crash — sub-1.0 scales expire suspicions before the delayed
    refutes land) and a detection latency (after it) — the two
    frontier axes.  Aggregate delivery: fanout enters as a Poisson
    rate, which is what makes it sweepable at all (see validate_knob).
    One shared seed across the grid isolates the knob effect."""
    if universes is not None:
        raise ValueError(
            "tuning is a grid preset: U = len(fanouts) x len(scales), "
            "not --universes"
        )
    cfg = LifeguardConfig(
        n=n, subject=7, subject_alive=False, fail_at_tick=fail_at,
        loss=loss, ack_late=ack_late, delivery="aggregate",
    )
    if steps is None:
        # Enough horizon for the slowest universe to declare the
        # subject dead: crash tick + the max-scaled minimum suspicion
        # bound (confirmations drive the timeout toward the minimum)
        # plus one unscaled bound of dissemination margin.
        lo, _hi = cfg.suspicion_bounds_ticks
        steps = (fail_at + int(math.ceil(lo * max(scales)))
                 + int(math.ceil(lo)) + 60)
    grid = list(itertools.product(fanouts, scales))
    return Universe(
        entrypoint="lifeguard", cfg=cfg, steps=steps,
        # One shared key: universes differ ONLY in their knob point, so
        # the grid isolates the knob effect from sampling noise.
        seeds=(seed,) * len(grid),
        knobs=("profile.gossip_nodes", "suspicion_scale"),
        values=(
            tuple(f for f, _ in grid),
            tuple(s for _, s in grid),
        ),
    )


def fault_matrix(universes=None, seed=0, n=192, steps=80,
                 rungs=(0.0, 0.45, 0.9)) -> Universe:
    """Severity coverage matrix: a static fault-schedule SHAPE (one
    loss ramp, one degraded set, one partition) whose severities ride
    as per-universe knobs — every (ramp, drop, partition) rung
    combination is one universe of the Lifeguard FP study."""
    if universes is not None:
        raise ValueError(
            "faultmatrix is a grid preset: U = len(rungs)^3, not "
            "--universes"
        )
    faults = FaultSchedule(
        ramps=(LossRamp(pieces=((10, 0.35),)),),
        degraded=(DegradedSet(frac=0.12, drop=0.5, late=0.25, seed=1),),
        partitions=(Partition(start=20, heal=45, segments=2,
                              severity=0.5),),
    )
    cfg = LifeguardConfig(
        n=n, subject=7, subject_alive=True, loss=0.02, ack_late=0.05,
        delivery="aggregate", faults=faults,
    )
    grid = list(itertools.product(rungs, repeat=3))
    return Universe(
        entrypoint="lifeguard", cfg=cfg, steps=steps,
        seeds=(seed,) * len(grid),
        knobs=(
            "faults.ramps[0].scale",
            "faults.degraded[0].drop",
            "faults.partitions[0].severity",
        ),
        values=tuple(
            tuple(g[i] for g in grid) for i in range(3)
        ),
    )


def stream_load_curve(universes=None, seed=0, n=4096, window=8,
                      chunks=4, fanout=4, chunk_budget=2,
                      rates=(0.1, 0.3, 0.6, 1.2), steps=150,
                      loss=0.05, policy="uniform", backlog=0,
                      size_tail=0.0, hotspot=0.0,
                      done_frac=0.999,
                      arrivals="poisson") -> Universe:
    """Offered-load ladder over the streamcast plane
    (consul_tpu/streamcast): each universe is one offered load
    (events/tick), all other knobs shared, so ONE batched program
    measures the whole sustained-throughput curve — delivered
    events/sec vs offered, with the window-overflow saturation knee
    where the curve flattens.  The frontier axes are
    (undelivered_frac, t99_ms): universes past the knee pay on the
    throughput axis, universes before it compete on latency.

    ``policy`` picks the chunk-selection schedule (streamcast.model
    POLICIES) — static, so a policy × load grid is one
    batched program per policy, never one per load point.
    ``backlog``/``size_tail``/``hotspot`` shape the offered stream
    adversarially (sim/load.py): a standing tick-0 backlog,
    heavy-tailed per-event chunk counts, and hot-node origin
    concentration — the same ladder re-run against production-shaped
    traffic."""
    if universes is not None:
        raise ValueError(
            "streamload is a grid preset: U = len(rates), not "
            "--universes"
        )
    from consul_tpu_torch.streamcast.model import StreamcastConfig

    cfg = StreamcastConfig(
        n=n, events=int(max(rates) * steps * 1.5), chunks=chunks,
        window=window, fanout=fanout, chunk_budget=chunk_budget,
        rate=rates[0], loss=loss, delivery="aggregate",
        policy=policy, backlog=backlog, size_tail=size_tail,
        hotspot=hotspot, arrivals=arrivals,
        # Sustained-load semantics: an event is delivered at a
        # NEAR-TOTAL fraction of nodes (default 99.9%) — the epidemic
        # tail means the LAST straggler of a big n may never land
        # before budgets drain, and a slot pinned on it would leak the
        # window (model.StreamcastConfig.done_frac).  The bench knee
        # curves use 0.99: past 99% the straggler tail is pure Poisson
        # thinning, identical under every selection policy, and a
        # delivery bar inside it just pads every slot lifetime with
        # policy-blind ticks.
        done_frac=done_frac,
    )
    return Universe(
        entrypoint="streamcast", cfg=cfg, steps=steps,
        # One shared key: the load points differ ONLY in rate (the
        # Poisson schedule still differs per universe because rate
        # scales the same exponential gap draws).
        seeds=(seed,) * len(rates),
        knobs=("rate",),
        values=(tuple(rates),),
    )


def stream_adversarial_ladder(universes=None, seed=0, n=4096,
                              window=8, chunks=4, fanout=4,
                              chunk_budget=2, rate=0.3,
                              tails=(0.25, 0.5, 1.0, 2.0), steps=150,
                              loss=0.05, policy="uniform",
                              backlog=None, hotspot=0.5,
                              done_frac=0.999) -> Universe:
    """Adversarial-severity ladder over the streamcast plane: a
    STANDING BACKLOG (the window starts the run full — ``backlog``
    defaults to the window width), a hotspot origin concentration, and
    a heavy-tail severity ladder — ``size_tail`` is the per-universe
    knob (sim/load.py: the Pareto tail index of per-event chunk
    counts, SMALLER = heavier), so the whole backlog × heavy-tail
    grid at one offered load is ONE batched program.  Run it per
    ``policy`` to see which schedule survives production-shaped
    traffic: delivered events/sec, t50/t99 and the loud window
    accounting per rung."""
    if universes is not None:
        raise ValueError(
            "streamadv is a grid preset: U = len(tails), not "
            "--universes"
        )
    from consul_tpu_torch.streamcast.model import StreamcastConfig

    if backlog is None:
        backlog = window
    cfg = StreamcastConfig(
        n=n, events=max(int(rate * steps * 1.5), backlog),
        chunks=chunks, window=window, fanout=fanout,
        chunk_budget=chunk_budget, rate=rate, loss=loss,
        delivery="aggregate", policy=policy, backlog=backlog,
        size_tail=tails[0], hotspot=hotspot, done_frac=done_frac,
    )
    return Universe(
        entrypoint="streamcast", cfg=cfg, steps=steps,
        # One shared key: rungs differ ONLY in tail severity.
        seeds=(seed,) * len(tails),
        knobs=("size_tail",),
        values=(tuple(tails),),
    )


def wan_brownout(universes=None, seed=0, n=2048, segments=8,
                 scales=(1.0, 0.5, 0.2, 0.05), steps=160,
                 brownout_at=4, heal_at=120, device=None) -> Universe:
    """Bandwidth-brownout severity ladder over the geo/WAN plane
    (consul_tpu/geo): ONE static BandwidthSchedule shape whose
    ``scale`` rides as the per-universe severity knob, so the whole
    ladder — healthy control (scale 1.0) down to a 5%-capacity
    brownout — runs as ONE batched program.  Per rung: convergence
    t50/t99, the worst segment's t99, and the loud per-link accounting
    (admitted bytes, overflow, stale waste).  Frontier axes:
    (wan_admitted_bytes, t99_ms) — WAN byte cost vs convergence
    latency, both minimized.  The Vivaldi derivation of the WAN
    latencies runs on ``device`` (CUDA unless given)."""
    if universes is not None:
        raise ValueError(
            "wanbrownout is a grid preset: U = len(scales), not "
            "--universes"
        )
    from consul_tpu_torch.geo.latency import derive_wan_latency
    from consul_tpu_torch.geo.model import GeoConfig
    from consul_tpu_torch.protocol import LAN
    from consul_tpu_torch.sim.faults import BandwidthSchedule

    base_bytes = 16 * 1400.0
    # The piece VALUES are scaled by the severity knob: during the
    # brownout window the link carries scale x base; after heal_at the
    # piece value is far above base so min(base, scale * heal) == base
    # for every rung >= 0.05 — the ladder heals to full capacity.
    faults = FaultSchedule(bandwidth=(
        BandwidthSchedule(
            pieces=((brownout_at, base_bytes), (heal_at, 64 * base_bytes))
        ),
    ))
    latency, _info = derive_wan_latency(
        segments, 3, tick_ms=LAN.gossip_interval_ms, seed=seed,
        rounds=300, wan_window=8, device=device,
    )
    cfg = GeoConfig(
        n=n, segments=segments, bridges_per_segment=3, events=16,
        wan_latency_ticks=latency, wan_window=8,
        wan_capacity_bytes=base_bytes, wan_msg_bytes=1400,
        wan_queue_bytes=2 * base_bytes, ae_batch=16, adaptive=True,
        loss_wan=0.05, faults=faults,
    )
    return Universe(
        entrypoint="geo", cfg=cfg, steps=steps,
        # One shared key: rungs differ ONLY in severity.
        seeds=(seed,) * len(scales),
        knobs=("faults.bandwidth[0].scale",),
        values=(tuple(scales),),
    )


PRESETS: dict = {
    "seeds4k": seed_sweep,
    "tuning": tuning_grid,
    "faultmatrix": fault_matrix,
    "streamload": stream_load_curve,
    "streamadv": stream_adversarial_ladder,
    "wanbrownout": wan_brownout,
}


def make_preset(name: str, universes=None, seed: int = 0,
                device=None) -> Universe:
    """Build a preset's Universe (``universes`` overrides U for seed
    presets; grid presets derive U from their ladders and reject it).
    ``device`` reaches the factories that compute on one
    (``wan_brownout``'s Vivaldi latencies; CUDA unless given).  Other
    sizes go to the factories in :data:`PRESETS` directly."""
    import inspect

    if name not in PRESETS:
        raise ValueError(
            f"unknown sweep preset {name!r} (have: {sorted(PRESETS)})"
        )
    factory = PRESETS[name]
    kw = ({"device": device}
          if "device" in inspect.signature(factory).parameters else {})
    return factory(universes=universes, seed=seed, **kw)


def main(argv=None) -> int:
    """``python -m consul_tpu_torch.sweep.presets [NAME ...]``: each named
    preset (default: all) at its own size on the card, run once to warm
    up and once timed; one JSON line a preset with its wall seconds and
    aggregate rounds/s."""
    import json
    import sys

    from consul_tpu_torch.sim.engine import run_sweep

    names = (sys.argv[1:] if argv is None else argv) or list(PRESETS)
    for name in names:
        rep = run_sweep(make_preset(name), warmup=True)
        print(json.dumps({"preset": name, "universes": rep.U, "n": rep.n,
                          "ticks": rep.steps, "wall_s": rep.wall_s,
                          "rounds_per_sec": rep.rounds_per_sec,
                          "device": rep.device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
