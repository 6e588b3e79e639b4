"""The BASELINE study presets of the ported paths.

The part of ``consul_tpu/sim/scenarios.py`` the port runs:

  dev3        BASELINE config 1: 3-node LAN pool, one user event
  probe1k     BASELINE config 2: 1k-node full-membership SWIM, LAN,
              fanout 3, 10 concurrent crashes (1%) at tick 10
  event100k   BASELINE config 3: 100k-node Serf event broadcast, LAN,
              fanout 4
  stream100k  100k-node sustained event stream: Poisson 4-chunk events
              pipelined through an 8-slot window
  suspect1m   BASELINE config 4: 1M-node suspicion/dead propagation,
              30% loss, WAN profile, aggregate delivery
  degraded1m  1M-node Lifeguard false-positive study, WAN profile, 2%
              degraded members (dropped sends, late acks), the same
              faulted universe with Lifeguard on and off
  multidc1m   BASELINE config 5: 1M nodes in 8 segments, LAN gossip
              inside each, WAN-profile gossip between their servers
  geo100k     100k nodes in 8 DCs with Vivaldi-derived link latencies,
              bandwidth-capped WAN links under a brownout, adaptive
              anti-entropy between the bridge sets

``geo_ab_config`` builds bench.py's geo A/B configuration (1M nodes, 8 DCs
x 5 bridges, 16 events from DC 0, a brownout to 10% over ticks [5, 120)),
either arm, for ``run_geo``.

Each returns the reference's summary dict and takes ``device=``
(CUDA unless given).  ``devices=`` lays a study over D logical shards of
one card (``parallel/mesh.py``) and ``exchange=`` picks the outbox
transport (``"ring"``: the CUDA ring kernel); ``telemetry=`` waits for a
later slice and is rejected.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from consul_tpu_torch.models import (
    BroadcastConfig,
    LifeguardConfig,
    MembershipConfig,
    SwimConfig,
)
from consul_tpu_torch.protocol import LAN, WAN
from consul_tpu_torch.sim.engine import (
    _check_later_slice,
    run_broadcast,
    run_geo,
    run_lifeguard,
    run_membership,
    run_multidc,
    run_streamcast,
    run_swim,
)


def dev3(seed: int = 0, telemetry: bool = False, device=None) -> dict:
    """BASELINE config 1: the 3-node ``agent -dev`` LAN pool, one user
    event, exact edges delivery, 10 ticks."""
    _check_later_slice(telemetry=(telemetry, False))
    cfg = BroadcastConfig(n=3, profile=LAN, delivery="edges")
    rep = run_broadcast(cfg, steps=10, seed=seed, warmup=False,
                        device=device)
    return {"scenario": "dev3", **rep.summary()}


def probe1k(seed: int = 0, devices: int = None, exchange: str = "alltoall",
            telemetry: bool = False, device=None) -> dict:
    """BASELINE config 2: 1k nodes, SWIM probe/ack, 1% induced failure: 10
    concurrent crashes in one full-membership study, interacting through
    shared gossip bandwidth, confirmations and push/pull (300 ticks).
    ``devices`` shards the observer rows over D logical shards (the dense
    twin); without it a non-default ``exchange`` is rejected."""
    from consul_tpu_torch.parallel import mesh_for

    _check_later_slice(telemetry=(telemetry, False))
    failed = tuple(range(0, 1000, 100))  # 10 spread-out subjects
    cfg = MembershipConfig(
        n=1000, loss=0.0, profile=LAN, fanout=3,
        fail_at=tuple((f, 10) for f in failed),
    )
    rep = run_membership(cfg, steps=300, seed=seed, track=failed,
                         warmup=False,
                         mesh=mesh_for(devices) if devices else None,
                         exchange=exchange, device=device)
    first_sus = [rep.first_detection_ms(i) for i in range(len(failed))]
    live = cfg.n - len(failed)
    conv = [rep.dead_converged(i, live) for i in range(len(failed))]
    return {
        "scenario": "probe1k",
        "n": cfg.n,
        "subjects": len(failed),
        "mean_first_suspect_ms": float(
            np.mean([s for s in first_sus if s])
        ) if any(first_sus) else None,
        "all_detected": all(c is not None for c in conv),
        "mean_converged_ms": float(np.mean(
            [(c + 1) * rep.tick_ms for c in conv if c is not None]
        )) if any(c is not None for c in conv) else None,
        "sim_rounds_per_sec": rep.rounds_per_sec,
        **({"devices": devices, "exchange_backend": exchange,
            "shard_overflow": rep.overflow}
           if devices else {}),
    }


def event100k_config(devices: int = None, n: int = 100_000):
    """The BroadcastConfig of :func:`event100k`: LAN, fanout 4, exact
    edges over shards, aggregate without."""
    return BroadcastConfig(n=n, fanout=4, profile=LAN,
                           delivery="edges" if devices else "aggregate")


def event100k(seed: int = 0, devices: int = None, exchange: str = "alltoall",
              telemetry: bool = False, device=None) -> dict:
    """BASELINE config 3: 100k-node event broadcast, LAN, fanout 4, 100
    ticks (:func:`event100k_config`).  ``devices`` runs the exact edges
    path over D logical shards (budget misses reported as
    ``shard_overflow``); without it the aggregate path runs and a
    non-default ``exchange`` is rejected."""
    from consul_tpu_torch.parallel import mesh_for

    _check_later_slice(telemetry=(telemetry, False))
    cfg = event100k_config(devices)
    if devices:
        rep = run_broadcast(cfg, steps=100, seed=seed,
                            mesh=mesh_for(devices), exchange=exchange,
                            device=device)
        return {"scenario": "event100k", **rep.summary(),
                "devices": devices, "exchange_backend": exchange,
                "shard_overflow": rep.overflow}
    rep = run_broadcast(cfg, steps=100, seed=seed, exchange=exchange,
                        device=device)
    return {"scenario": "event100k", **rep.summary()}


def stream100k_config(n: int = 100_000, steps: int = 150,
                      devices: int = None, policy: str = "uniform"):
    """The StreamcastConfig of :func:`stream100k`: rate 0.3 events a tick
    with K = 1.5x the expected arrivals, 4 chunks, 8 slots, fanout 4,
    2 slots serviced a round, 16 names, loss 0.05, LAN, done at 99.9%;
    edges over shards, aggregate without."""
    from consul_tpu_torch.streamcast import StreamcastConfig

    rate = 0.3
    return StreamcastConfig(
        n=n, events=int(rate * steps * 1.5), chunks=4, window=8,
        fanout=4, chunk_budget=2, rate=rate, names=16, loss=0.05,
        profile=LAN, done_frac=0.999, policy=policy,
        delivery="edges" if devices else "aggregate",
    )


def stream100k(seed: int = 0, n: int = 100_000, steps: int = 150,
               devices: int = None, exchange: str = "alltoall",
               telemetry: bool = False, policy: str = "uniform",
               device=None) -> dict:
    """Sustained event stream at 100k nodes (``stream100k_config``):
    delivered events/s against the offered load, t50/t99 delivery
    quantiles and the window-overflow saturation signal.  ``devices``
    shards the chunk planes over D logical shards (edges messages over
    the outbox, three columns); ``exchange`` picks the transport.
    ``n``/``steps`` scale down for CPU runs."""
    from consul_tpu_torch.parallel import mesh_for

    _check_later_slice(telemetry=(telemetry, False))
    cfg = stream100k_config(n, steps, devices, policy)
    rep = run_streamcast(cfg, steps=steps, seed=seed, warmup=False,
                         mesh=mesh_for(devices) if devices else None,
                         exchange=exchange, device=device)
    return {
        "scenario": "stream100k",
        **rep.summary(),
        **({"devices": devices, "exchange_backend": exchange}
           if devices else {}),
    }


from consul_tpu_torch.sim.faults import (
    BandwidthSchedule,
    DegradedSet,
    FaultSchedule,
)


def suspect1m(seed: int = 0, device=None) -> dict:
    """BASELINE config 4: 1M-node suspicion/dead propagation, 30% loss,
    WAN timing."""
    cfg = SwimConfig(n=1_000_000, subject=42, loss=0.30, profile=WAN,
                     delivery="aggregate")
    # Suspicion min timeout at 1M WAN = 6*log10(1e6)*5s = 180s = 360
    # ticks; run past it so dead propagation is measured.
    rep = run_swim(cfg, steps=500, seed=seed, device=device)
    return {"scenario": "suspect1m", **rep.summary()}


def degraded1m_environment():
    """(FaultSchedule, loss, ack_late) of the degraded1m preset: 2% slow
    members with dropped sends and late acks, 10% ambient loss, a 25%
    WAN ack tail."""
    faults = FaultSchedule(
        degraded=(DegradedSet(frac=0.02, drop=0.5, late=0.6, seed=1),)
    )
    return faults, 0.10, 0.25


def degraded1m(seed: int = 0, n: int = 1_000_000, steps: int = 300,
               device=None) -> dict:
    """Lifeguard A/B at the headline scale: the same faulted universe
    with Lifeguard on and off, reporting the false-positive rate, refute
    and incarnation-flap deltas.  ``n``/``steps`` scale down for CPU
    runs."""
    faults, loss, ack_late = degraded1m_environment()
    cfg = LifeguardConfig(
        n=n,
        subject=7 % n,
        subject_alive=True,
        loss=loss,
        ack_late=ack_late,
        profile=WAN,
        delivery="aggregate",
        lifeguard=True,
        faults=faults,
    )
    on = run_lifeguard(cfg, steps=steps, seed=seed, warmup=False,
                       device=device)
    off = run_lifeguard(dataclasses.replace(cfg, lifeguard=False),
                        steps=steps, seed=seed, warmup=False, device=device)
    return {
        "scenario": "degraded1m",
        "n": n,
        "ticks": steps,
        "tick_ms": on.tick_ms,
        "fp_total_on": on.fp_total,
        "fp_total_off": off.fp_total,
        "fp_rate_on": on.fp_rate,
        "fp_rate_off": off.fp_rate,
        "fp_reduction": (
            1.0 - on.fp_total / off.fp_total if off.fp_total else None
        ),
        "flaps_on": on.flap_count,
        "flaps_off": off.flap_count,
        "refutes_on": on.refute_total,
        "refutes_off": off.refute_total,
        "mean_awareness_final": float(on.mean_awareness[-1]),
        "sim_rounds_per_sec": on.rounds_per_sec,
    }


def multidc1m(seed: int = 0, device=None) -> dict:
    """BASELINE config 5: 1M nodes in 8 segments of 5 servers each, TWO
    edge classes (LAN gossip inside each segment, WAN-profile gossip
    between the servers, memberlist/config.go:315-326), aggregate
    delivery, 120 ticks.  The reference places one segment per device;
    the placement leaves its results unchanged, and the port runs the
    study unsharded on one card."""
    from consul_tpu_torch.models import MultiDCConfig

    cfg = MultiDCConfig(n=1_000_000, segments=8, bridges_per_segment=5,
                        delivery="aggregate")
    # Origin: a non-bridge node of segment 0, so the event climbs onto
    # the WAN through segment 0's servers and re-enters every other
    # segment through theirs.
    rep = run_multidc(cfg, steps=120, seed=seed, origin=cfg.seg_size // 2,
                      warmup=False, device=device)
    return {"scenario": "multidc1m", **rep.summary()}


def geo100k(seed: int = 0, n: int = 100_000, steps: int = 120,
            devices: int = None, exchange: str = "alltoall",
            device=None) -> dict:
    """100k-node geo/WAN study: 8 DCs with Vivaldi-derived per-link
    latency, bandwidth-capped WAN links under a mid-run brownout, and
    adaptive anti-entropy between the bridge sets.  ``devices`` lays the
    segments contiguously over D logical shards (WAN units over the
    outbox, budget misses reported as ``shard_overflow``); ``exchange``
    picks the transport (``"ring"``: the CUDA ring kernel).
    ``n``/``steps`` scale down for CPU runs."""
    from consul_tpu_torch.geo import GeoConfig, derive_wan_latency
    from consul_tpu_torch.parallel import mesh_for

    base_bytes = 16 * 1400.0
    latency, vinfo = derive_wan_latency(
        8, 3, tick_ms=LAN.gossip_interval_ms, seed=seed, rounds=300,
        wan_window=8, device=device,
    )
    cfg = GeoConfig(
        n=n, segments=8, bridges_per_segment=3, events=16,
        wan_latency_ticks=latency, wan_window=8,
        wan_capacity_bytes=base_bytes, wan_msg_bytes=1400,
        wan_queue_bytes=2 * base_bytes, ae_batch=16, adaptive=True,
        loss_wan=0.05,
        faults=FaultSchedule(bandwidth=(
            BandwidthSchedule(pieces=((20, 0.2 * base_bytes),
                                      (80, 64 * base_bytes))),
        )),
    )
    rep = run_geo(cfg, steps=steps, seed=seed, warmup=False,
                  mesh=mesh_for(devices) if devices else None,
                  exchange=exchange, device=device)
    return {
        "scenario": "geo100k",
        **rep.summary(),
        "vivaldi_rel_rtt_error": round(vinfo["rel_rtt_error"], 4),
        **({"devices": devices, "exchange_backend": exchange}
           if devices else {}),
    }


def geo_ab_config(latency: tuple, n: int = 1_000_000, adaptive: bool = True):
    """The GeoConfig of bench.py's geo section (``_geo_section``): 8 DCs of
    5 bridges, 16 events all published in DC 0 at non-bridge nodes, a
    16-unit link (1400-byte units) browned out to 10% over ticks [5, 120)
    and healed after, a 32-unit queue, WAN loss 0.05, over the Vivaldi
    ``latency`` matrix."""
    from consul_tpu_torch.geo import GeoConfig

    base_bytes = 16 * 1400.0
    faults = FaultSchedule(bandwidth=(
        BandwidthSchedule(pieces=((5, 0.1 * base_bytes),
                                  (120, 64 * base_bytes))),
    ))
    seg_size, bridges, events = n // 8, 5, 16
    origins = tuple(bridges + e * (seg_size - bridges) // events
                    for e in range(events))
    return GeoConfig(
        n=n, segments=8, bridges_per_segment=bridges, events=events,
        wan_latency_ticks=latency, wan_window=8,
        wan_capacity_bytes=base_bytes, wan_msg_bytes=1400,
        wan_queue_bytes=2 * base_bytes, ae_batch=16, adaptive=adaptive,
        loss_wan=0.05, origins=origins, faults=faults,
    )
