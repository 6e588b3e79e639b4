"""The BASELINE study presets of the ported paths.

The part of ``consul_tpu/sim/scenarios.py`` the port runs:

  probe1k     BASELINE config 2: 1k-node full-membership SWIM, LAN,
              fanout 3, 10 concurrent crashes (1%) at tick 10
  suspect1m   BASELINE config 4: 1M-node suspicion/dead propagation,
              30% loss, WAN profile, aggregate delivery
  degraded1m  1M-node Lifeguard false-positive study, WAN profile, 2%
              degraded members (dropped sends, late acks), the same
              faulted universe with Lifeguard on and off

Each returns the reference's summary dict and takes ``device=``
(CUDA unless given).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from consul_tpu_torch.models import (
    LifeguardConfig,
    MembershipConfig,
    SwimConfig,
)
from consul_tpu_torch.protocol import LAN, WAN
from consul_tpu_torch.sim.engine import run_lifeguard, run_membership, run_swim


def probe1k(seed: int = 0, device=None) -> dict:
    """BASELINE config 2: 1k nodes, SWIM probe/ack, 1% induced failure: 10
    concurrent crashes in one full-membership study, interacting through
    shared gossip bandwidth, confirmations and push/pull (300 ticks)."""
    failed = tuple(range(0, 1000, 100))  # 10 spread-out subjects
    cfg = MembershipConfig(
        n=1000, loss=0.0, profile=LAN, fanout=3,
        fail_at=tuple((f, 10) for f in failed),
    )
    rep = run_membership(cfg, steps=300, seed=seed, track=failed,
                         warmup=False, device=device)
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
    }
from consul_tpu_torch.sim.faults import DegradedSet, FaultSchedule


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
