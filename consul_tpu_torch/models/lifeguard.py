"""Lifeguard local-health (NHM) layer on the SWIM model, fault-aware.

The port of ``consul_tpu/models/lifeguard.py``.  Every node keeps a
health score (``awareness``, 0 = healthy) and trades detection latency
for accuracy when its own health is poor ("Local Health Awareness for
More Accurate Failure Detection"):

  * a failed probe matures into suspicion after ``score + 1`` probe
    intervals (awareness.go:60-69 ScaleTimeout);
  * the suspicion minimum timeout scales the same way;
  * the score moves on evidence about the local node: an acked probe
    lowers it, a failed probe raises it by the missing relay nacks
    (state.go probeNode), being refuted raises it.

Same state and merge rules as :mod:`consul_tpu_torch.models.swim`, plus
``lifeguard`` on/off (off freezes awareness at 0: plain SWIM) and a
:class:`consul_tpu_torch.sim.faults.FaultSchedule`.  Fault
approximations are the reference's: degraded nodes drop on their sends
(acks and nacks included), relays enter at the population-mean send
survival, and a partitioned indirect path crosses the cut twice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch.device import device_scalar
from consul_tpu_torch.models.swim import (
    NEVER,
    VIEW_DEAD,
    SwimConfig,
    SwimState,
    _merge_deliveries,
    edge_eras,
    expire_suspicions,
    mature_probes,
    newest_era,
    spend,
    swim_init,
    timeout_table,
)
from consul_tpu_torch.ops import (
    owned_uniform,
    poissonized_arrivals,
    sample_peers,
    sample_probe_targets,
    split,
)
from consul_tpu_torch.protocol import awareness_scaled_timeout
from consul_tpu_torch.sim.faults import (
    FaultSchedule,
    combine_loss,
    degraded_late,
    degraded_send_ok,
    edge_block_prob,
    extra_loss_at,
    online_mask,
    partition_severity_at,
    segment_bounds,
    segment_ids,
)

LifeguardState = SwimState  # same carry; awareness is already a field


@dataclasses.dataclass(frozen=True)
class LifeguardConfig(SwimConfig):
    """SwimConfig + the Lifeguard switch and a fault schedule.

    ``ack_late`` is the cluster-wide probability that a live target's ack
    lands past the unscaled probe window: a failure to a score-0
    observer, a success to one whose window is stretched (score >= 1).
    Degraded members add their own ``DegradedSet.late``."""

    lifeguard: bool = True
    ack_late: float = 0.0
    faults: FaultSchedule = FaultSchedule()

    def __post_init__(self):
        super().__post_init__()
        if self.delivery == "aggregate" and len(self.faults.partitions) > 1:
            # Poissonized arrivals decompose into per-segment sums for
            # one cut; stacked cuts need the exact edges path.
            raise ValueError(
                "aggregate delivery supports at most one Partition; "
                "use delivery='edges' for stacked partitions"
            )
        if self.faults.bandwidth:
            raise ValueError(
                "BandwidthSchedule faults apply to the geo/WAN plane only; "
                "this model has no per-link byte accounting to cap"
            )


class LifeguardConstants(NamedTuple):
    """What a round reads that depends on the config alone, built once
    per study by :func:`lifeguard_constants`."""

    timeout: torch.Tensor   # float32[k+1]: swim.timeout_table
    send_ok: torch.Tensor   # float32[n]: degraded_send_ok
    mean_ok: torch.Tensor   # float32 scalar: mean of send_ok
    p_late: torch.Tensor    # float32[n]: combine_loss(ack_late, degraded_late)


def lifeguard_constants(cfg: LifeguardConfig, device) -> LifeguardConstants:
    n = cfg.n
    send_ok = degraded_send_ok(cfg.faults, n, device)
    return LifeguardConstants(
        timeout=timeout_table(cfg).to(device),
        send_ok=send_ok,
        mean_ok=mean_f32(send_ok),
        p_late=combine_loss(
            device_scalar(cfg.ack_late, torch.float32, device),
            degraded_late(cfg.faults, n, device),
        ),
    )


def mean_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 mean as the reference's compiled program takes it: XLA
    turns ``sum / n`` into ``sum * f32(1/n)``, the float32 reciprocal.
    (``torch.mean`` divides on the CPU, so it differs by an ulp at most
    n that are not powers of two.)"""
    inv = float(np.float32(1.0) / np.float32(x.numel()))
    return torch.sum(x, dtype=torch.float32) * inv


def integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for a static int ``y >= 0`` in the order of XLA's
    ``integer_pow``: square-and-multiply from the low bit, so
    ``x**3 = x * (x*x)``."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def lifeguard_init(cfg: LifeguardConfig, device=None) -> LifeguardState:
    return swim_init(cfg, device)


def _segment_sums(w: torch.Tensor, bounds: list[int]) -> torch.Tensor:
    """float32[S]: the sum of ``w`` over each contiguous segment, one
    slice sum each in a fixed order (an ``index_add_`` would use float
    atomics on CUDA, which do not repeat from run to run)."""
    return torch.stack([torch.sum(w[a:b]) for a, b in zip(bounds, bounds[1:])])


def arrival_rate(cfg: LifeguardConfig, t: torch.Tensor, w: torch.Tensor,
                 participates: torch.Tensor) -> torch.Tensor:
    """float32[n] Poisson intensity of one message class: each receiver
    hears ``fanout / (n-1)`` of the other senders' surviving weight ``w``,
    cross-cut weight scaled by the partition's ``1 - severity``; absent
    receivers hear nothing."""
    n = cfg.n
    if cfg.faults.partitions:
        part = cfg.faults.partitions[0]
        seg = segment_ids(part, n, w.device).long()
        same = _segment_sums(w, segment_bounds(part, n))[seg]
        sev = partition_severity_at(part, t)
        reach = (same - w) + (1.0 - sev) * (torch.sum(w) - same)
    else:
        reach = torch.sum(w) - w
    denom = device_scalar(max(n - 1, 1), torch.float32, w.device)
    return torch.where(participates, reach * cfg.fanout / denom, 0.0)


def lifeguard_round(state: LifeguardState, key: torch.Tensor,
                    cfg: LifeguardConfig,
                    consts: LifeguardConstants | None = None) -> LifeguardState:
    """One tick.  ``consts`` is :func:`lifeguard_constants` of ``cfg``,
    built here when not given."""
    n, f, fanout = cfg.n, cfg.subject, cfg.fanout
    faults = cfg.faults
    dev = state.view.device
    if consts is None:
        consts = lifeguard_constants(cfg, dev)
    t = state.tick
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    (k_gossip, k_loss, k_probe, k_pfail, k_aware, k_nack,
     k_churn) = split(key, 7).unbind(-2)

    # Fault environment this tick.
    loss_t = combine_loss(device_scalar(cfg.loss, torch.float32, dev),
                          extra_loss_at(faults, t))
    send_ok = consts.send_ok
    online = online_mask(faults, k_churn, t, n)

    subject_dead_now = (t >= cfg.fail_at_tick) & (not cfg.subject_alive)
    is_subject = rows == f
    not_subject = ~is_subject
    # A crashed subject is gone for good; churned-off nodes sit out one
    # tick (neither send, receive, nor probe).
    participates = online & ~(is_subject & subject_dead_now)
    can_send = participates

    # 1. Gossip fan-out under the fault environment.
    classes = ((state.tx_suspect, state.sus_era),
               (state.tx_dead, state.dead_era),
               (state.tx_refute, state.ref_era))
    if cfg.delivery == "edges":
        targets = sample_peers(k_gossip, n, fanout)                 # [n, F]
        p_edge = ((1.0 - loss_t) * send_ok[:, None]
                  * (1.0 - edge_block_prob(faults, t, rows[:, None],
                                           targets, n)))
        wire_ok = owned_uniform(k_loss, rows, (fanout,)) < p_edge
        wire_ok = wire_ok & participates[targets.long()]
        sus_rx, dead_rx, ref_rx = (
            edge_eras(targets, wire_ok, can_send, tx_left, era)
            for tx_left, era in classes
        )
    else:
        # Weighted Poissonized arrivals: each sender's copies survive
        # with its own probability; a receiver sums the reachable weight
        # (partition-adjusted by per-segment sums).
        def rx_era(k_cls, tx_left, era):
            send = can_send & (tx_left > 0)
            w = send.to(torch.float32) * send_ok * (1.0 - loss_t)
            lam = arrival_rate(cfg, t, w, participates)
            got = poissonized_arrivals(k_cls, lam) & participates
            return newest_era(got, send, era)

        sus_rx, dead_rx, ref_rx = (
            rx_era(k_cls, tx_left, era)
            for k_cls, (tx_left, era) in zip(split(k_gossip, 3).unbind(-2),
                                             classes)
        )

    # 2. Incarnation-ordered merge rules, shared with the SWIM model.
    (
        view, inc_seen, suspect_since, confirmations,
        tx_suspect, sus_era, tx_dead, dead_era, tx_refute, ref_era,
        subject_inc, refute_now,
    ) = _merge_deliveries(
        cfg, t, state, sus_rx, dead_rx, ref_rx,
        spend(state.tx_suspect, can_send, fanout),
        spend(state.tx_dead, can_send, fanout),
        spend(state.tx_refute, can_send, fanout),
        is_subject,
    )

    # 3. Probe plane with NHM accounting.
    is_probe_tick = (t % cfg.probe_interval_ticks) == 0
    probe_target = sample_probe_targets(k_probe, n)
    probed_f = ((probe_target == f) & can_send & not_subject
                & (view != VIEW_DEAD))

    k_ind = cfg.profile.indirect_checks
    ok1 = 1.0 - loss_t                        # one generic wire leg
    mean_ok = consts.mean_ok                  # relay-population quality
    send_ok_f = send_ok[f]
    block_if = edge_block_prob(faults, t, rows, rows[f], n)
    # Direct round trip, each leg crossing the cut once (state.go:326-380).
    leg_out = ok1 * send_ok * (1.0 - block_if)
    leg_back = ok1 * send_ok_f * (1.0 - block_if)
    p_direct_fail = 1.0 - leg_out * leg_back
    # Indirect 4-leg path i->r->f->r->i (state.go:397-426).
    ind_ok = ((ok1 * send_ok) * (ok1 * mean_ok) * (ok1 * send_ok_f)
              * (ok1 * mean_ok) * integer_pow(1.0 - block_if, 2))
    p_fail_subject = p_direct_fail * integer_pow(1.0 - ind_ok, k_ind)
    subject_gone = subject_dead_now | ~online[f]
    p_fail_subject = torch.where(subject_gone, 1.0, p_fail_subject)

    # Late acks: a failure to a score-0 observer (and always with
    # Lifeguard off), rescued by a stretched window (score >= 1).
    k_hard, k_late = split(k_pfail).unbind(-2)
    ack_is_late = owned_uniform(k_late, rows) < consts.p_late
    rescued = (state.awareness >= 1) & cfg.lifeguard
    late_fail = ack_is_late & ~rescued
    hard_fail_subject = owned_uniform(k_hard, rows) < p_fail_subject
    probe_failed = (probed_f & (hard_fail_subject | (late_fail & ~subject_gone))
                    & is_probe_tick)

    # The whole probe cycle scales with the prober's health going into
    # the probe (state.go:283-300).
    cycle = cfg.probe_interval_ticks
    if cfg.lifeguard:
        cycle = awareness_scaled_timeout(cycle, state.awareness)
    probe_pending_at = torch.where(
        probe_failed & (state.probe_pending_at == NEVER),
        t + cycle, state.probe_pending_at,
    )

    # Probes of other live targets drive awareness too.
    probing_any = is_probe_tick & can_send & not_subject
    p_fail_other = (1.0 - (ok1 * send_ok) * (ok1 * mean_ok)) * integer_pow(
        1.0 - (ok1 * send_ok) * integer_pow(ok1 * mean_ok, 3), k_ind
    )
    other_failed = (probing_any & ~probed_f
                    & ((owned_uniform(k_aware, rows) < p_fail_other)
                       | late_fail))
    any_failed = probe_failed | other_failed

    # NACK accounting: each relay's nack returns iff i->r and r->i both
    # survive; a late-processing node misses its nacks like its ack.
    p_nack = (ok1 * send_ok) * (ok1 * mean_ok)
    nacks = torch.sum(
        owned_uniform(k_nack, rows, (max(k_ind, 1),)) < p_nack[:, None],
        dim=1, dtype=torch.int32,
    )
    nacks = torch.where(ack_is_late, 0, nacks)
    if k_ind > 0:
        fail_delta = torch.clamp(k_ind - nacks, min=0)
    else:
        fail_delta = torch.ones_like(nacks)
    delta = torch.where(any_failed, fail_delta,
                        -probing_any.to(torch.int32))
    # Being refuted costs the accused-but-alive subject a health point
    # (state.go:880-915 refute -> ApplyDelta(1)).
    delta = delta + (is_subject & refute_now).to(torch.int32)
    if cfg.lifeguard:
        awareness = torch.clamp(state.awareness + delta, 0,
                                cfg.profile.awareness_max_multiplier - 1)
    else:
        awareness = torch.zeros_like(state.awareness)

    view, suspect_since, tx_suspect, sus_era, probe_pending_at = (
        mature_probes(cfg, t, probe_pending_at, view, inc_seen,
                      suspect_since, tx_suspect, sus_era)
    )

    # 4. Suspicion expiry with the health-scaled minimum: a degraded
    #    observer's floor rises to lo * (score + 1).
    timeout_ticks = consts.timeout[confirmations.long()]
    if cfg.lifeguard:
        lo, _hi = cfg.suspicion_bounds_ticks
        timeout_ticks = torch.maximum(
            timeout_ticks,
            awareness_scaled_timeout(
                device_scalar(lo, torch.float32, dev),
                awareness.to(torch.float32),
            ),
        )
    view, suspect_since, tx_suspect, tx_dead, dead_era = expire_suspicions(
        cfg, t, timeout_ticks, view, inc_seen, suspect_since, tx_suspect,
        tx_dead, dead_era,
    )

    return LifeguardState(
        view=view, inc_seen=inc_seen, suspect_since=suspect_since,
        confirmations=confirmations, tx_suspect=tx_suspect, sus_era=sus_era,
        tx_dead=tx_dead, dead_era=dead_era, tx_refute=tx_refute,
        ref_era=ref_era, probe_pending_at=probe_pending_at,
        awareness=awareness, subject_inc=subject_inc, tick=t + 1,
    )
