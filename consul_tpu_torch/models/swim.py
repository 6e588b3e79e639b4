"""SWIM probe/suspect/dead state machine on PyTorch tensors.

The port of ``consul_tpu/models/swim.py``: the fate of ONE subject node
``f`` through the eyes of all n members, each a length-n tensor:

  view[i]           -- node i's view of f: ALIVE / SUSPECT / DEAD
  inc_seen[i]       -- subject incarnation attached to that view
  suspect_since[i]  -- tick when i marked f suspect (suspicion.go:50-80)
  confirmations[i]  -- suspect confirmations received (suspicion.go:103-130)
  tx_suspect/tx_dead/tx_refute[i] -- remaining retransmissions of each
                       message class, sus_era/dead_era/ref_era[i] the
                       incarnation the queued message carries
  probe_pending_at[i] -- tick when i's failed probe of f matures into
                       suspicion (state.go:283-497)
  awareness[i]      -- Lifeguard health score

The protocol rules and their memberlist sources are those of the
reference; one tick is one GossipInterval.  A round is a pure function
of ``(state, key)``: it allocates new tensors and never writes into the
state it was given (the Lifeguard scan diffs the two).  Nothing in a
round reads a device value back to the host.

A round also advances a sweep's U universes at once: keys ``[U, 2]``,
node planes ``[U, n]`` and the scalars ``subject_inc``/``tick`` ``[U]``;
``loss``, ``suspicion_scale`` and (aggregate delivery) the profile's
``gossip_nodes`` may then be ``[U]`` knobs, consumed in the float32
order of the reference's traced program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch.device import device_scalar, resolve_device
from consul_tpu_torch.ops import (
    aggregate_arrivals,
    bernoulli_mask,
    deliver_max,
    sample_peers,
    sample_probe_targets,
    split,
)
from consul_tpu_torch.ops.knobs import col, is_knob, keep_prob, lift
from consul_tpu_torch.ops.xla_math import integer_pow
from consul_tpu_torch.protocol import (
    LAN,
    GossipProfile,
    retransmit_limit,
    suspicion_timeout_bounds,
)

VIEW_ALIVE = 0
VIEW_SUSPECT = 1
VIEW_DEAD = 2

NEVER = 2 ** 31 - 1  # int32 max: "not suspecting" / "no probe pending"
NO_MSG = -1          # "no copy arrived" marker in received-era tensors


@dataclasses.dataclass(frozen=True)
class SwimConfig:
    """Static parameters of a failure-detection study.

    ``delivery="edges"`` simulates every (sender, target) message;
    ``delivery="aggregate"`` is receiver-side Poissonized delivery per
    message class (suspect / dead / refute).  ``suspicion_scale``
    multiplies both suspicion-timeout bounds; 1.0 is the reference's."""

    n: int
    subject: int = 0
    subject_alive: bool = False   # False: crash study; True: false-positive study
    fail_at_tick: int = 0
    loss: float = 0.0
    profile: GossipProfile = LAN
    delivery: str = "edges"
    suspicion_scale: float = 1.0

    def __post_init__(self):
        if self.delivery not in ("edges", "aggregate"):
            raise ValueError(
                f"delivery must be 'edges' or 'aggregate', got {self.delivery!r}"
            )

    @property
    def fanout(self) -> int:
        return self.profile.gossip_nodes

    @property
    def tx_limit(self) -> int:
        return retransmit_limit(self.profile.retransmit_mult, self.n)

    @property
    def probe_interval_ticks(self) -> int:
        return self.profile.probe_interval_ticks

    @property
    def probe_timeout_ticks(self) -> int:
        return self.profile.probe_timeout_ticks

    @property
    def confirmations_k(self) -> int:
        # state.go:1186-1196: k = SuspicionMult - 2, or 0 if n-2 < k.
        k = self.profile.suspicion_mult - 2
        return 0 if self.n - 2 < k else k

    @property
    def suspicion_bounds_ticks(self) -> tuple[float, float]:
        lo_ms, hi_ms = suspicion_timeout_bounds(
            self.profile.suspicion_mult,
            self.profile.suspicion_max_timeout_mult,
            self.n,
            self.profile.probe_interval_ms,
        )
        return scaled_bounds_ticks(lo_ms, hi_ms,
                                   self.profile.gossip_interval_ms,
                                   self.suspicion_scale)

    @property
    def probe_fail_prob_alive(self) -> float:
        """P(a probe of the live subject fails) under Bernoulli loss: the
        direct round trip (2 legs) and each indirect path (4 legs) all
        drop (state.go:326-454).  A swept ``loss`` gives float32 [U]
        tensor arithmetic in the traced program's order."""
        return probe_fail_prob(self.loss, self.profile.indirect_checks)


def scaled_bounds_ticks(lo_ms: float, hi_ms: float, g: float, s):
    """The suspicion timeout bounds ``(lo, hi)`` in ticks at scale ``s``:
    ``ms * s / g`` for a Python ``s``.  A swept ``s`` ([U] tensor) takes
    the traced order, where XLA folds it into ``s * f32(f32(ms) * f32(1 /
    g))``: two float32 [U] bounds that are not whole ticks even at s = 1."""
    if is_knob(s):
        inv_g = np.float32(1.0) / np.float32(g)
        return tuple(
            s * torch.full((), float(np.float32(np.float32(ms) * inv_g)),
                           dtype=torch.float32, device=s.device)
            for ms in (lo_ms, hi_ms))
    return lo_ms * s / g, hi_ms * s / g


def probe_fail_prob(loss, indirect_checks: int):
    """P(a probe of a live target fails) under Bernoulli ``loss``: the
    direct round trip (2 legs) and each indirect path (4 legs) all drop
    (state.go:326-454).  A swept ``loss`` gives float32 [U] tensor
    arithmetic in the traced program's order."""
    if is_knob(loss):
        ok = 1.0 - loss.to(torch.float32)
        p_direct = 1.0 - ok * ok
        p_indirect = 1.0 - integer_pow(ok, 4)
        return p_direct * integer_pow(p_indirect, indirect_checks)
    ok = 1.0 - loss
    p_direct = 1.0 - ok**2
    p_indirect = 1.0 - ok**4
    return p_direct * (p_indirect ** indirect_checks)


class SwimState(NamedTuple):
    view: torch.Tensor             # int32[n]
    inc_seen: torch.Tensor         # int32[n]
    suspect_since: torch.Tensor    # int32[n], NEVER if not suspecting
    confirmations: torch.Tensor    # int32[n]
    tx_suspect: torch.Tensor       # int32[n]
    sus_era: torch.Tensor          # int32[n]
    tx_dead: torch.Tensor          # int32[n]
    dead_era: torch.Tensor         # int32[n]
    tx_refute: torch.Tensor        # int32[n]
    ref_era: torch.Tensor          # int32[n]
    probe_pending_at: torch.Tensor # int32[n], NEVER if none pending
    awareness: torch.Tensor        # int32[n]
    subject_inc: torch.Tensor      # int32 scalar
    tick: torch.Tensor             # int32 scalar


def swim_init(cfg: SwimConfig, device=None) -> SwimState:
    dev = resolve_device(device)

    def full(value, shape=(cfg.n,)):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    return SwimState(
        view=full(VIEW_ALIVE), inc_seen=full(0), suspect_since=full(NEVER),
        confirmations=full(0), tx_suspect=full(0), sus_era=full(0),
        tx_dead=full(0), dead_era=full(0), tx_refute=full(0),
        ref_era=full(0), probe_pending_at=full(NEVER), awareness=full(0),
        subject_inc=full(0, ()), tick=full(0, ()),
    )


def timeout_table(cfg: SwimConfig, fused: bool = True) -> torch.Tensor:
    """float32[k+1] on the CPU: the total suspicion timeout in ticks after
    0..k confirmations (suspicion.go:86-97 remainingSuspicionTime),
    rounded UP to a tick and floored at the minimum ``lo``.

    The value is the reference's as XLA compiles it, which is not its
    source order: ``hi - log(c+1) / log(k+1) * (hi - lo)`` becomes
    ``fma(-log(c+1), C, hi)`` with the folded constant
    ``C = f32(f32(1 / f32(log(k+1))) * f32(hi - lo))``; op-by-op float32
    would declare DEAD one tick early at LOCAL's one confirmation.  The
    fused multiply-add is taken in float64, where the float32 product is
    exact.  With ``fused=False`` the product is rounded to float32 before
    the subtraction: the order in which XLA's constant folder evaluates
    the expression when ``c`` is a constant ``arange`` (the sparse
    membership model's table).  ``confirmations`` only takes the values
    0..k, so a round indexes this table on the device and never evaluates
    a ``log`` there: the card's ``logf`` cannot move a dead declaration."""
    lo, hi = cfg.suspicion_bounds_ticks
    k = cfg.confirmations_k
    f32 = torch.float32
    lo32 = torch.full((), lo, dtype=f32)
    if k < 1:
        return lo32.reshape(1)
    log_c = torch.log(torch.arange(k + 1, dtype=f32) + 1.0)
    inv = 1.0 / torch.full((), math.log(k + 1.0), dtype=f32)
    c = inv * torch.full((), hi - lo, dtype=f32)
    hi32 = torch.full((), hi, dtype=f32)
    if fused:
        raw = (hi32.double() - log_c.double() * c.double()).to(f32)
    else:
        raw = hi32 - log_c * c
    return torch.maximum(torch.ceil(raw), lo32)


def traced_timeout_table(cfg: SwimConfig) -> torch.Tensor:
    """float32[U, k+1]: :func:`timeout_table` for a swept
    ``suspicion_scale`` [U], in the order of the reference's traced
    program (read off its optimized HLO): the bounds ``lo``/``hi`` are
    the float32 [U] values of ``suspicion_bounds_ticks``, ``frac =
    log(c+1) * f32(1 / log(k+1))``, ``raw = hi - frac * (hi - lo)`` with
    the product fused into the subtraction, then ``max(ceil(raw), lo)``
    against the UNROUNDED ``lo``: the traced floor is not a whole tick,
    so even s = 1 is not the static table."""
    lo, hi = cfg.suspicion_bounds_ticks
    k = cfg.confirmations_k
    f32 = torch.float32
    if k < 1:
        return lo[..., None]
    dev = lo.device
    log_c = torch.log(torch.arange(k + 1, dtype=f32) + 1.0).to(dev)
    inv = float(np.float32(1.0) / np.float32(math.log(k + 1.0)))
    frac = log_c * torch.full((), inv, dtype=f32, device=dev)
    span = (hi - lo)[..., None]
    raw = (hi[..., None].double() - frac.double() * span.double()).to(f32)
    return torch.maximum(torch.ceil(raw), lo[..., None])


class SwimConstants(NamedTuple):
    """What a round reads that depends on the config alone, built once
    per study (:func:`swim_constants`) instead of once per tick."""

    timeout: torch.Tensor   # float32[k+1] (a sweep's knob: [U, k+1])


def swim_constants(cfg: SwimConfig, device) -> SwimConstants:
    if is_knob(cfg.suspicion_scale):
        return SwimConstants(timeout=traced_timeout_table(cfg).to(device))
    return SwimConstants(timeout=timeout_table(cfg).to(device))


def timeout_ticks_of(timeout: torch.Tensor,
                     confirmations: torch.Tensor) -> torch.Tensor:
    """Each observer's suspicion timeout: the table entry at its
    confirmation count (a per-universe row for a swept table)."""
    if timeout.dim() == 1:
        return timeout[confirmations.long()]
    return torch.gather(timeout, -1, confirmations.long())


def _merge_deliveries(cfg: SwimConfig, t: torch.Tensor, state: SwimState,
                      sus_rx, dead_rx, ref_rx, tx_suspect, tx_dead, tx_refute,
                      is_subject: torch.Tensor):
    """Apply one tick's deliveries under the incarnation-ordered merge
    rules, shared by the SWIM and Lifeguard rounds (state.go:1134-1251,
    880-1131; queue.go name-keyed invalidation).

    Returns (view, inc_seen, suspect_since, confirmations, tx_suspect,
    sus_era, tx_dead, dead_era, tx_refute, ref_era, subject_inc,
    refute_now)."""
    f = cfg.subject
    not_subject = ~is_subject
    view, inc_seen = state.view, state.inc_seen
    suspect_since, confirmations = state.suspect_since, state.confirmations
    sus_era, dead_era, ref_era = state.sus_era, state.dead_era, state.ref_era

    # Suspect messages below the receiver's incarnation are ignored; a
    # new one turns an ALIVE view SUSPECT and is re-gossiped; at an
    # already-suspect receiver it is a confirmation (at most one a tick).
    got_suspect = sus_rx >= torch.clamp(inc_seen, min=0)
    fresh_suspect = got_suspect & (view == VIEW_ALIVE) & not_subject
    confirming = got_suspect & (view == VIEW_SUSPECT)
    new_conf = torch.clamp(confirmations + confirming.to(torch.int32),
                           max=cfg.confirmations_k)
    gained_conf = confirming & (new_conf > confirmations)
    confirmations = new_conf

    view = torch.where(fresh_suspect, VIEW_SUSPECT, view)
    inc_seen = torch.where(fresh_suspect, sus_rx, inc_seen)
    suspect_since = torch.where(fresh_suspect, col(t), suspect_since)
    rebroadcast_sus = fresh_suspect | gained_conf
    tx_suspect = torch.where(rebroadcast_sus, cfg.tx_limit, tx_suspect)
    sus_era = torch.where(rebroadcast_sus, torch.maximum(sus_era, sus_rx),
                          sus_era)

    # The subject, while alive, refutes every accusation with
    # incarnation accused+1 (state.go:880-915).
    subject_live_now = (t < cfg.fail_at_tick) | cfg.subject_alive
    accused = torch.maximum(sus_rx[..., f], dead_rx[..., f])
    refute_now = subject_live_now & (accused >= state.subject_inc)
    subject_inc = torch.where(refute_now, accused + 1, state.subject_inc)
    refuting = is_subject & col(refute_now)
    tx_refute = torch.where(refuting, cfg.tx_limit, tx_refute)
    ref_era = torch.where(refuting, col(subject_inc), ref_era)

    # An alive message with a strictly higher incarnation overrides any
    # view, DEAD included, and invalidates queued suspect/dead messages.
    accept_refute = ref_rx > inc_seen
    view = torch.where(accept_refute, VIEW_ALIVE, view)
    inc_seen = torch.where(accept_refute, ref_rx, inc_seen)
    suspect_since = torch.where(accept_refute, NEVER, suspect_since)
    confirmations = torch.where(accept_refute, 0, confirmations)
    tx_refute = torch.where(accept_refute, cfg.tx_limit, tx_refute)
    ref_era = torch.where(accept_refute, ref_rx, ref_era)
    tx_suspect = torch.where(accept_refute, 0, tx_suspect)
    tx_dead = torch.where(accept_refute, 0, tx_dead)

    # Dead overrides suspect/alive at >= the receiver's incarnation
    # (state.go:1228-1232); a live subject refutes its own obituary.
    accept_dead = (dead_rx >= inc_seen) & (view != VIEW_DEAD)
    accept_dead = accept_dead & (not_subject | col(~subject_live_now))
    view = torch.where(accept_dead, VIEW_DEAD, view)
    inc_seen = torch.where(accept_dead, dead_rx, inc_seen)
    suspect_since = torch.where(accept_dead, NEVER, suspect_since)
    tx_dead = torch.where(accept_dead, cfg.tx_limit, tx_dead)
    dead_era = torch.where(accept_dead, dead_rx, dead_era)
    tx_suspect = torch.where(accept_dead, 0, tx_suspect)

    return (
        view, inc_seen, suspect_since, confirmations,
        tx_suspect, sus_era, tx_dead, dead_era, tx_refute, ref_era,
        subject_inc, refute_now,
    )


def row_fanout(fanout, plane: torch.Tensor):
    """``fanout`` as a factor of a ``[*B, n]`` plane: a Python int, or a
    swept ``[*B]`` int32 knob as a column."""
    return lift(fanout.to(plane.device), 1) if is_knob(fanout) else fanout


def spend(tx_left: torch.Tensor, can_send: torch.Tensor,
          fanout) -> torch.Tensor:
    """One transmission per target packet drained this tick, int32."""
    send = can_send & (tx_left > 0)
    return torch.clamp(tx_left - send.to(torch.int32)
                       * row_fanout(fanout, tx_left), min=0)


def edge_eras(targets: torch.Tensor, wire_ok: torch.Tensor,
              can_send: torch.Tensor, tx_left: torch.Tensor,
              era: torch.Tensor) -> torch.Tensor:
    """int32[*B, n]: max incarnation among the copies of one message
    class received this tick over explicit edges (NO_MSG if none)."""
    send = can_send & (tx_left > 0)
    delivered = send[..., None] & wire_ok
    return deliver_max(
        torch.full(era.shape, NO_MSG, dtype=torch.int32, device=era.device),
        targets, era[..., None].expand(targets.shape), delivered,
    )


def newest_era(got: torch.Tensor, send: torch.Tensor,
               era: torch.Tensor) -> torch.Tensor:
    """Aggregate delivery's arriving incarnation: the newest one among
    this tick's senders for receivers that heard the class, else NO_MSG."""
    newest = torch.amax(torch.where(send, era, NO_MSG), dim=-1, keepdim=True)
    return torch.where(got, newest, NO_MSG)


def expire_suspicions(cfg: SwimConfig, t, timeout_ticks, view, inc_seen,
                      suspect_since, tx_suspect, tx_dead, dead_era):
    """Suspicion timeout expiry -> DEAD at the suspicion's incarnation,
    broadcast deadMsg (state.go:1200-1215); returns the updated
    (view, suspect_since, tx_suspect, tx_dead, dead_era)."""
    # int32 difference: with suspect_since == NEVER it wraps, and is masked
    # below.
    elapsed = (col(t)  # tracelint: disable=J7 (NEVER wraps, masked)
               - suspect_since).to(torch.float32)
    expire = ((view == VIEW_SUSPECT) & (suspect_since != NEVER)
              & (elapsed >= timeout_ticks))
    return (
        torch.where(expire, VIEW_DEAD, view),
        torch.where(expire, NEVER, suspect_since),
        torch.where(expire, 0, tx_suspect),
        torch.where(expire, cfg.tx_limit, tx_dead),
        torch.where(expire, inc_seen, dead_era),
    )


def mature_probes(cfg: SwimConfig, t, probe_pending_at, view, inc_seen,
                  suspect_since, tx_suspect, sus_era):
    """Pending failed probes that are due turn an ALIVE view SUSPECT at
    the prober's incarnation and broadcast it (state.go:495-496);
    returns (view, suspect_since, tx_suspect, sus_era, probe_pending_at)."""
    due = probe_pending_at <= col(t)
    maturing = due & (view == VIEW_ALIVE)
    return (
        torch.where(maturing, VIEW_SUSPECT, view),
        torch.where(maturing, col(t), suspect_since),
        torch.where(maturing, cfg.tx_limit, tx_suspect),
        torch.where(maturing, inc_seen, sus_era),
        torch.where(due, NEVER, probe_pending_at),
    )


def swim_round(state: SwimState, key: torch.Tensor, cfg: SwimConfig,
               consts: SwimConstants | None = None) -> SwimState:
    """One tick.  ``consts`` is :func:`swim_constants` of ``cfg``, built
    here when not given."""
    n, f, fanout = cfg.n, cfg.subject, cfg.fanout
    dev = state.view.device
    if consts is None:
        consts = swim_constants(cfg, dev)
    t = state.tick
    k_gossip, k_loss, k_probe, k_pfail, k_aware = split(key, 5).unbind(-2)

    subject_dead_now = (t >= cfg.fail_at_tick) & (not cfg.subject_alive)
    is_subject = torch.arange(n, dtype=torch.int32, device=dev) == f
    not_subject = ~is_subject
    # A crashed subject neither sends nor receives.
    participates = ~(is_subject & col(subject_dead_now))
    can_send = participates

    # 1. Gossip fan-out: one compound packet per (sender, target).
    classes = ((state.tx_suspect, state.sus_era),
               (state.tx_dead, state.dead_era),
               (state.tx_refute, state.ref_era))
    if cfg.delivery == "edges":
        targets = sample_peers(k_gossip, n, fanout)                 # [n, F]
        wire_ok = bernoulli_mask(k_loss, (n, fanout), keep_prob(cfg.loss, 2))
        wire_ok = wire_ok & torch.gather(
            participates.expand(state.view.shape), -1,
            targets.reshape(*targets.shape[:-2], -1).long(),
        ).view(targets.shape)
        sus_rx, dead_rx, ref_rx = (
            edge_eras(targets, wire_ok, can_send, tx_left, era)
            for tx_left, era in classes
        )
    else:
        # Receiver-side Poissonized arrivals per message class; the
        # arriving incarnation is the newest one in circulation.
        def rx_era(k_cls, tx_left, era):
            send = can_send & (tx_left > 0)
            got = aggregate_arrivals(k_cls, send, fanout, cfg.loss, n)
            return newest_era(got & participates, send, era)

        sus_rx, dead_rx, ref_rx = (
            rx_era(k_cls, tx_left, era)
            for k_cls, (tx_left, era) in zip(split(k_gossip, 3).unbind(-2),
                                             classes)
        )

    # 2. Incarnation-ordered merge rules (shared with Lifeguard).
    (
        view, inc_seen, suspect_since, confirmations,
        tx_suspect, sus_era, tx_dead, dead_era, tx_refute, ref_era,
        subject_inc, _refute_now,
    ) = _merge_deliveries(
        cfg, t, state, sus_rx, dead_rx, ref_rx,
        spend(state.tx_suspect, can_send, fanout),
        spend(state.tx_dead, can_send, fanout),
        spend(state.tx_refute, can_send, fanout),
        is_subject,
    )

    # 3. Probe plane, every ProbeInterval ticks: a node probes one
    #    uniform member it does not consider dead (state.go:214-256).
    is_probe_tick = col((t % cfg.probe_interval_ticks) == 0)
    probe_target = sample_probe_targets(k_probe, n)
    probed_f = ((probe_target == f) & can_send & not_subject
                & (view != VIEW_DEAD))
    # Probes of a crashed subject always fail; of a live one, with the
    # loss-on-every-path probability.
    p_alive = cfg.probe_fail_prob_alive
    p_alive = (lift(p_alive, 1) if is_knob(p_alive)
               else device_scalar(p_alive, torch.float32, dev))
    p_fail = torch.where(col(subject_dead_now), 1.0, p_alive)
    probe_failed = (probed_f & bernoulli_mask(k_pfail, (n,), p_fail)
                    & is_probe_tick)
    # A failed probe matures at the end of its cycle, stretched by the
    # prober's health going into it (awareness.go:64 ScaleTimeout).
    matures_at = (col(t) + cfg.probe_interval_ticks
                  + state.awareness * cfg.probe_timeout_ticks)
    probe_pending_at = torch.where(
        probe_failed & (state.probe_pending_at == NEVER),
        matures_at, state.probe_pending_at,
    )
    # Health score drift: failed probes of any target raise it,
    # successes lower it.
    probing_any = is_probe_tick & can_send & not_subject
    other_failed = (probing_any & ~probed_f
                    & bernoulli_mask(k_aware, (n,), p_alive))
    any_failed = probe_failed | other_failed
    awareness = torch.clamp(
        state.awareness + any_failed.to(torch.int32)
        - (probing_any & ~any_failed).to(torch.int32),
        0, cfg.profile.awareness_max_multiplier - 1,
    )
    view, suspect_since, tx_suspect, sus_era, probe_pending_at = (
        mature_probes(cfg, t, probe_pending_at, view, inc_seen,
                      suspect_since, tx_suspect, sus_era)
    )

    # 4. Suspicion timeout expiry -> DEAD.
    timeout_ticks = timeout_ticks_of(consts.timeout, confirmations)
    view, suspect_since, tx_suspect, tx_dead, dead_era = expire_suspicions(
        cfg, t, timeout_ticks, view, inc_seen, suspect_since, tx_suspect,
        tx_dead, dead_era,
    )

    return SwimState(
        view=view, inc_seen=inc_seen, suspect_since=suspect_since,
        confirmations=confirmations, tx_suspect=tx_suspect, sus_era=sus_era,
        tx_dead=tx_dead, dead_era=dead_era, tx_refute=tx_refute,
        ref_era=ref_era, probe_pending_at=probe_pending_at,
        awareness=awareness, subject_inc=subject_inc, tick=t + 1,
    )
