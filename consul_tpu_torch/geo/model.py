"""Geo-distributed WAN plane: multi-DC gossip over latency-delayed,
bandwidth-capped cross-segment links with adaptive anti-entropy.

The port of ``consul_tpu/geo/model.py``.  ``events`` concurrent broadcast
items must reach every node of every segment:

  * inside a segment, LAN gossip is receiver-side Poissonized per
    (segment, event) over the owned ``[n, E]`` draws;
  * across segments every unit is exact: WAN gossip copies (a Poisson
    count per (link, event) from the bridge-known counts) and
    anti-entropy units (the missing events the sender believes the
    destination lacks, ``latency[s, d]`` ticks late through the
    ``known_hist`` ring) are admitted against the link's capacity this
    tick (``link_capacity_at``), anti-entropy leftovers defer into a
    bounded queue and the rest overflows, counted:

        offered + queue_prev == admitted + queue + overflow;

  * admitted units ride a per-link delay ring and land ``latency[s, d]``
    ticks later on one uniformly drawn bridge of the destination;
  * ``adaptive`` sizes each link's anti-entropy offer from an EWMA of
    its admitted units minus its own backlog (+1 probe unit), against the
    fixed ``ae_batch`` of the baseline arm.

The link plane (beliefs, offers, admission, ring, controller) is
S²-scale and shared with the sharded twin (``parallel/shard.py``), which
differs only in how the delivery slots reach their receivers.

A sweep runs U universes at once: a leading universe axis on every
state plane (``knows`` ``[U, n, E]``, ``ring`` ``[U, L, S*S, E]``, ...,
``tick`` ``[U]``), with ``loss_lan``, ``loss_wan``, ``ae_gain`` and the
fault severities as ``[U]`` knobs.

Bit-equal to the reference on the CPU, every output and every state
field, except that a LAN receiver may differ where its uniform lies
between the reference's ``-expm1(-lam)`` (XLA's, up to 5 ulps off) and
the port's (float64 rounded once, the same on CUDA and the CPU): the
arrival-threshold rule of ``tests/torch_parity.check_arrivals``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch.device import device_scalar, resolve_device
from consul_tpu_torch.ops import (
    bernoulli_mask,
    owned_uniform,
    poisson,
    randint,
    split,
    xla_math,
)
from consul_tpu_torch.ops.knobs import is_knob, lift
from consul_tpu_torch.protocol import LAN, WAN, GossipProfile, retransmit_limit
from consul_tpu_torch.sim.faults import (
    FaultSchedule,
    extra_loss_at,
    link_capacity_at,
)

#: Static ceiling on per-link units/tick (the delivery slot plane is
#: [S^2, cap_units]).
MAX_CAP_UNITS = 4096


@dataclasses.dataclass(frozen=True)
class GeoConfig:
    """Static parameters of a geo/WAN study.

    ``wan_latency_ticks`` is the per-segment-pair one-way latency matrix
    (tuple[S][S] of ints, diagonal 0, off-diagonal in [1, wan_window - 1];
    empty = every cross link at 1 tick).  ``wan_capacity_bytes`` is the
    static per-link ceiling in bytes/tick; BandwidthSchedule faults only
    tighten it.  ``adaptive`` switches the anti-entropy offer between the
    EWMA controller (gain ``ae_gain``) and the fixed ``ae_batch``.
    ``faults`` takes loss ramps and bandwidth schedules; the node-level
    primitives are rejected."""

    n: int
    segments: int = 8
    bridges_per_segment: int = 3
    events: int = 8
    lan_profile: GossipProfile = LAN
    wan_profile: GossipProfile = WAN
    loss_lan: float = 0.0
    loss_wan: float = 0.0
    wan_latency_ticks: tuple = ()
    wan_window: int = 8               # L: delay-ring slots
    wan_capacity_bytes: float = 64 * 1400.0
    wan_msg_bytes: int = 1400         # one WAN unit (gossip or AE)
    wan_queue_bytes: float = 128 * 1400.0
    ae_batch: int = 8                 # fixed-mode offer / adaptive cap
    adaptive: bool = True
    ae_gain: float = 0.2              # EWMA gain of the controller
    origins: tuple = ()               # per-event origin nodes
    faults: FaultSchedule = FaultSchedule()

    def __post_init__(self):
        if self.n % self.segments != 0:
            raise ValueError("n must divide evenly into segments")
        if self.bridges_per_segment >= self.seg_size:
            raise ValueError("segment smaller than its bridge set")
        if self.events < 1:
            raise ValueError(f"events={self.events} must be >= 1")
        if self.wan_window < 2:
            raise ValueError(
                f"wan_window={self.wan_window} leaves no room for a "
                "latency of >= 1 tick"
            )
        if self.wan_msg_bytes < 1:
            raise ValueError("wan_msg_bytes must be >= 1")
        if not 1 <= self.cap_units <= MAX_CAP_UNITS:
            raise ValueError(
                f"wan_capacity_bytes/wan_msg_bytes = {self.cap_units} "
                f"units/tick outside [1, {MAX_CAP_UNITS}]: the delivery "
                "slot plane is sized by this ratio; raise wan_msg_bytes "
                "alongside the capacity"
            )
        if self.ae_batch < 1:
            raise ValueError(f"ae_batch={self.ae_batch} must be >= 1")
        if self.faults.partitions or self.faults.degraded or \
                self.faults.churn:
            raise ValueError(
                "geo consumes loss ramps and bandwidth schedules only; "
                "partitions/degraded/churn model membership dynamics "
                "this plane does not simulate"
            )
        if self.wan_latency_ticks:
            S = self.segments
            if len(self.wan_latency_ticks) != S or any(
                len(row) != S for row in self.wan_latency_ticks
            ):
                raise ValueError(
                    f"wan_latency_ticks must be {S}x{S} to match "
                    f"segments={S}"
                )
            for s, row in enumerate(self.wan_latency_ticks):
                for d, lat in enumerate(row):
                    if s != d and not 1 <= lat <= self.wan_window - 1:
                        raise ValueError(
                            f"wan_latency_ticks[{s}][{d}]={lat} outside "
                            f"[1, {self.wan_window - 1}] (the ring "
                            "window's addressable delays)"
                        )
        for o in self.origins:
            if not 0 <= o < self.n:
                raise ValueError(f"origin {o} outside [0, {self.n})")
        if self.origins and len(self.origins) != self.events:
            raise ValueError(
                f"{len(self.origins)} origins for events={self.events}"
            )

    # -- layout -----------------------------------------------------------
    @property
    def seg_size(self) -> int:
        return self.n // self.segments

    @property
    def n_links(self) -> int:
        return self.segments * self.segments

    @property
    def fanout_lan(self) -> int:
        return self.lan_profile.gossip_nodes

    @property
    def fanout_wan(self) -> int:
        return self.wan_profile.gossip_nodes

    @property
    def profile(self) -> GossipProfile:
        """The clock-defining profile (one tick = one LAN interval)."""
        return self.lan_profile

    @property
    def tx_limit_lan(self) -> int:
        return retransmit_limit(self.lan_profile.retransmit_mult,
                                self.seg_size)

    @property
    def wan_rate(self) -> float:
        """P(a bridge runs a WAN gossip round in a given LAN tick)."""
        return min(
            self.lan_profile.gossip_interval_ms
            / self.wan_profile.gossip_interval_ms,
            1.0,
        )

    # -- link budgets -----------------------------------------------------
    @property
    def cap_units(self) -> int:
        """Static per-link ceiling in units/tick (= delivery slots a link)."""
        return int(self.wan_capacity_bytes // self.wan_msg_bytes)

    @property
    def queue_units(self) -> int:
        return int(self.wan_queue_bytes // self.wan_msg_bytes)

    @property
    def event_origins(self) -> tuple:
        """Per-event origin nodes: the explicit tuple, or events dealt
        round-robin across segments at non-bridge offsets."""
        if self.origins:
            return self.origins
        S, ss, B = self.segments, self.seg_size, self.bridges_per_segment
        span = ss - B
        per_seg = -(-self.events // S)
        return tuple(
            (e % S) * ss + B + (e // S) * span // per_seg
            for e in range(self.events)
        )

    def latency_flat(self) -> tuple:
        """tuple[S*S] of per-link one-way latencies in ticks (row-major
        (src, dst); self links 0; default geometry 1 tick)."""
        S = self.segments
        if self.wan_latency_ticks:
            return tuple(lat for row in self.wan_latency_ticks for lat in row)
        return tuple(0 if s == d else 1 for s in range(S) for d in range(S))

    @property
    def gossip_lam_max(self) -> float:
        """Largest WAN gossip rate a (link, event) can see: all B bridges
        of the source knowing the event.  Below 10 the Poisson draw never
        takes its rejection branch."""
        return self.bridges_per_segment * self.wan_rate * self.fanout_wan / max(
            self.segments - 1, 1)


class GeoState(NamedTuple):
    knows: torch.Tensor       # bool[n, E]: node holds event e
    tx_lan: torch.Tensor      # int32[n, E]: LAN transmit budget
    ring: torch.Tensor        # int32[L, S*S, E]: in-flight WAN units
    queue: torch.Tensor       # int32[S*S, E]: deferred units
    known_hist: torch.Tensor  # bool[L, S, E]: bridge-known history ring
    ewma: torch.Tensor        # f32[S*S]: EWMA of admitted units/tick
    wasted: torch.Tensor      # int32 scalar: admitted units already known
    tick: torch.Tensor        # int32 scalar


class GeoConstants(NamedTuple):
    """What a round reads that depends on the config alone, built once a
    study by :func:`geo_constants` (no host copy inside a tick)."""

    lat: torch.Tensor      # int64[S2]: per-link latency in ticks
    link: torch.Tensor     # int64[S2]
    src: torch.Tensor      # int64[S2]: source segment of each link
    dst: torch.Tensor      # int64[S2]: destination segment
    cross: torch.Tensor    # bool[S2]: not a self link
    seg: torch.Tensor      # int64[n]: segment of each node


def geo_constants(cfg: GeoConfig, device) -> GeoConstants:
    dev = torch.device(device)
    S = cfg.segments
    link = torch.arange(cfg.n_links, device=dev)
    src, dst = link // S, link % S
    return GeoConstants(
        lat=torch.tensor(cfg.latency_flat(), dtype=torch.int64).to(dev),
        link=link, src=src, dst=dst, cross=src != dst,
        seg=torch.arange(cfg.n, device=dev) // cfg.seg_size,
    )


def geo_init(cfg: GeoConfig, device=None) -> GeoState:
    dev = resolve_device(device)
    n, E, S, L = cfg.n, cfg.events, cfg.segments, cfg.wan_window
    origins = torch.tensor(cfg.event_origins, dtype=torch.int64).to(dev)
    ev = torch.arange(E, device=dev)
    knows = torch.zeros((n, E), dtype=torch.bool, device=dev)
    knows[origins, ev] = True
    tx_lan = torch.zeros((n, E), dtype=torch.int32, device=dev)
    tx_lan[origins, ev] = cfg.tx_limit_lan
    return GeoState(
        knows=knows,
        tx_lan=tx_lan,
        ring=torch.zeros((L, S * S, E), dtype=torch.int32, device=dev),
        queue=torch.zeros((S * S, E), dtype=torch.int32, device=dev),
        known_hist=torch.zeros((L, S, E), dtype=torch.bool, device=dev),
        # Optimistic start at the static ceiling.
        ewma=torch.full((S * S,), float(cfg.cap_units), dtype=torch.float32,
                        device=dev),
        wasted=torch.zeros((), dtype=torch.int32, device=dev),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1, dtype=torch.int32)


def admit_link_units(counts: torch.Tensor, cap_units: torch.Tensor,
                     queue_units: int):
    """Admit a per-link unit stream against per-link capacity.

    ``counts`` int32[..., S2, M]: units offered per (link, stream
    position) in priority order (deferred queue, fresh anti-entropy,
    fresh gossip); ``cap_units`` int32[..., S2].  Each link admits
    greedily up to its capacity, leftovers defer greedily up to
    ``queue_units``, the rest overflows.  Returns ``(admitted, deferred,
    overflow)``, int32[..., S2, M], with ``counts == admitted + deferred +
    overflow``."""
    prior = _cumsum(counts) - counts
    admitted = torch.minimum(
        torch.clamp(cap_units[..., None] - prior, min=0), counts)
    left = counts - admitted
    prior_l = _cumsum(left) - left
    deferred = torch.minimum(torch.clamp(queue_units - prior_l, min=0), left)
    return admitted, deferred, left - deferred


def _p_wan(cfg: GeoConfig, tick: torch.Tensor) -> torch.Tensor:
    """float32 per-unit WAN delivery survival this tick (``[*B]``): ``1 -
    loss_wan`` in float32, times any scheduled loss ramps."""
    if is_knob(cfg.loss_wan):
        base = 1.0 - cfg.loss_wan.to(device=tick.device,
                                     dtype=torch.float32)
    else:
        base = device_scalar(
            float(np.float32(1.0) - np.float32(cfg.loss_wan)),
            torch.float32, tick.device)
    if cfg.faults.ramps:
        return base * (1.0 - extra_loss_at(cfg.faults, tick))
    return base


def expand_delivery_slots(arriving: torch.Tensor, cap_units: int):
    """Unpack per-(link, event) unit counts into the delivery slot plane:
    ``(ev_slot, valid)`` each [..., S2, cap_units], slot j of a link
    carrying the event whose cumulative count interval covers j."""
    ends = _cumsum(arriving)                                  # [S2, E]
    j = torch.arange(cap_units, dtype=torch.int32, device=arriving.device)
    ev_slot = torch.sum(ends[..., :, None, :] <= j[:, None], dim=-1,
                        dtype=torch.int32)                    # [S2, U]
    valid = j < ends[..., -1:]
    return ev_slot, valid


def lan_arrivals(knows: torch.Tensor, tx_lan: torch.Tensor,
                 ids: torch.Tensor, key: torch.Tensor, cfg: GeoConfig,
                 nb: int = 0):
    """LAN gossip, receiver-side Poissonized per (segment, event), over
    rows ``[..., m, E]`` of whole segments whose global ids are ``ids``
    (``nb`` universe axes first).  Returns ``(senders, got_lan)``."""
    ss, E = cfg.seg_size, cfg.events
    dev = knows.device
    lead = knows.shape[:nb]
    senders = knows & (tx_lan > 0)
    per_seg = torch.sum(senders.view(*lead, -1, ss, E), dim=-2,
                        dtype=torch.int32).to(torch.float32)
    own = senders.view(*lead, -1, ss, E).to(torch.float32)
    lam = (per_seg[..., None, :] - own) * device_scalar(
        cfg.fanout_lan, torch.float32, dev)
    if is_knob(cfg.loss_lan):
        loss_lan = cfg.loss_lan.to(device=dev, dtype=torch.float32)
        keep = lift(1.0 - loss_lan, 3)
    else:
        keep = device_scalar(
            float(np.float32(1.0) - np.float32(cfg.loss_lan)),
            torch.float32, dev)
    lam = lam * keep
    lam = (lam / device_scalar(max(ss - 1, 1), torch.float32, dev)).view(
        knows.shape)
    thr = (-torch.expm1(-lam.to(torch.float64))).to(torch.float32)
    got = (owned_uniform(key, ids, (E,)) < thr) & ~knows
    return senders, got


def bridge_known(knows: torch.Tensor, cfg: GeoConfig, nb: int = 0):
    """(bk bool[*B, S, E], bk_cnt float32[*B, S, E]): which events each
    segment's bridge set holds, and by how many bridges."""
    rows = knows.view(*knows.shape[:nb], -1, cfg.seg_size,
                      cfg.events)[..., :cfg.bridges_per_segment, :]
    bk = torch.any(rows, dim=-2)
    cnt = torch.sum(rows, dim=-2, dtype=torch.int32).to(torch.float32)
    return bk, cnt


class LinkStep(NamedTuple):
    """One tick of the link plane: the next link state, the tick's link
    counters, and the delivery slots leaving the ring."""

    ring: torch.Tensor
    queue: torch.Tensor
    known_hist: torch.Tensor
    ewma: torch.Tensor
    wasted: torch.Tensor
    offered: torch.Tensor      # int32[S2]
    admitted: torch.Tensor     # int32[S2]
    queued: torch.Tensor       # int32[S2]
    overflow: torch.Tensor     # int32[S2]
    recv: torch.Tensor         # int32[S2, U]: receiving node of each slot
    ev_slot: torch.Tensor      # int32[S2, U]: event of each slot
    live: torch.Tensor         # bool[S2, U]: slot carries a surviving unit


def _ewma(cfg: GeoConfig, ewma: torch.Tensor,
          admitted: torch.Tensor) -> torch.Tensor:
    """``(1 - gain) * ewma + gain * admitted`` as XLA compiles it: the
    constant ``1 - gain`` folded in float32 and the first product fused
    into the sum (``xla_math.fma``); a swept ``[U]`` gain takes the same
    order with ``1 - gain`` computed in float32."""
    dev = ewma.device
    if is_knob(cfg.ae_gain):
        gain = lift(cfg.ae_gain.to(device=dev, dtype=torch.float32), 1)
        return xla_math.fma(1.0 - gain, ewma,
                            gain * admitted.to(torch.float32))
    gain = np.float32(cfg.ae_gain)
    g_adm = device_scalar(float(gain), torch.float32, dev) * admitted.to(
        torch.float32)
    return xla_math.fma(float(np.float32(1.0) - gain), ewma, g_adm)


def _ring_slots(state: GeoState, t: torch.Tensor, lat: torch.Tensor,
                L: int):
    """Per-universe index tuple of ring slot ``(t + lat) % L`` (``lat``
    broadcast against ``[*B, 1]``) into a ``[*B, L, ...]`` plane."""
    nb = t.dim()
    slot = (t.reshape(*t.shape, *([1] * lat.dim())) + lat) % L
    if not nb:
        return (slot,)
    uni = torch.arange(t.numel(), device=t.device).view(
        *t.shape, *([1] * lat.dim()))
    return (uni, slot)


def link_plane(state: GeoState, bk: torch.Tensor, bk_cnt: torch.Tensor,
               k_gossip: torch.Tensor, k_tgt: torch.Tensor,
               k_loss: torch.Tensor, cfg: GeoConfig,
               consts: GeoConstants) -> LinkStep:
    """Beliefs, offers, admission, the latency ring and the controller,
    from this tick's bridge-known masks: the reference's steps 2-6 up to
    the delivery slots, and the EWMA of step 7.  Every plane carries the
    state's universe axes first."""
    S, E, L = cfg.segments, cfg.events, cfg.wan_window
    U, ss, B = cfg.cap_units, cfg.seg_size, cfg.bridges_per_segment
    S2 = cfg.n_links
    t = state.tick
    nb = t.dim()
    lead = t.shape
    dev = bk.device
    c = consts
    zero = torch.zeros(1, dtype=torch.int64, device=dev)

    # Feedback: what the src believes the dst knows, latency[s, d] ticks
    # late (lat >= 1 on cross links keeps the read off the slot written).
    known_hist = state.known_hist.clone()
    known_hist[_ring_slots(state, t, zero, L)] = bk.view(
        *lead, 1, S, E) if nb else bk[None]
    belief = known_hist[(*_ring_slots(state, t, -c.lat, L), c.dst)]
    src_bk = bk[..., c.src, :]

    # Anti-entropy offers (the adaptive seam).
    missing = src_bk & ~belief & c.cross[:, None]
    miss_i = missing.to(torch.int32)
    rank = _cumsum(miss_i) - miss_i
    if cfg.adaptive:
        backlog = torch.sum(state.queue, dim=-1, dtype=torch.int32)
        batch = torch.clamp(
            torch.floor(state.ewma).to(torch.int32) + 1 - backlog,
            0, cfg.ae_batch)
    else:
        batch = torch.full((*lead, S2), cfg.ae_batch, dtype=torch.int32,
                           device=dev)
    ae = (missing & (rank < batch[..., None])).to(torch.int32)

    # WAN gossip offers: Poisson-staggered bridge chatter.
    rate = device_scalar(cfg.wan_rate * cfg.fanout_wan / max(S - 1, 1),
                         torch.float32, dev)
    lam_g = bk_cnt[..., c.src, :] * rate * c.cross[:, None].to(torch.float32)
    gossip = poisson(k_gossip, lam_g, lam_max=cfg.gossip_lam_max)

    # Admission against the bandwidth schedule.
    cap_f = link_capacity_at(cfg.faults, t, S,
                             base=cfg.wan_capacity_bytes).reshape(*lead, S2)
    cap_units = torch.clamp(
        torch.floor(cap_f / device_scalar(cfg.wan_msg_bytes, torch.float32,
                                          dev)), 0, U).to(torch.int32)
    cap_units = torch.where(c.cross, cap_units, 0).to(torch.int32)
    stream = torch.cat([state.queue, ae, gossip], dim=-1)
    adm, deferred, ovf = admit_link_units(stream, cap_units, cfg.queue_units)
    admitted_e = adm[..., :E] + adm[..., E:2 * E] + adm[..., 2 * E:]
    # Gossip is UDP-like: a congested link drops it into overflow; only
    # the anti-entropy stream defers into the queue.
    queue = deferred[..., :E] + deferred[..., E:2 * E]
    offered = torch.sum(ae + gossip, dim=-1, dtype=torch.int32)
    admitted = torch.sum(admitted_e, dim=-1, dtype=torch.int32)
    overflow = (torch.sum(ovf, dim=-1, dtype=torch.int32)
                + torch.sum(deferred[..., 2 * E:], dim=-1, dtype=torch.int32))

    # The latency ring: this tick's arrivals leave, admissions enter.
    now = _ring_slots(state, t, zero, L)
    arriving = state.ring[now].reshape(*lead, S2, E)
    ring = state.ring.clone()
    ring[now] = 0
    ring.index_put_((*_ring_slots(state, t, c.lat, L), c.link), admitted_e,
                    accumulate=True)

    ev_slot, valid = expand_delivery_slots(arriving, U)
    # Each unit lands on one uniformly drawn bridge of the destination.
    tb = randint(k_tgt, (S2, U), 0, B)
    recv = (c.dst[:, None] * ss + tb).to(torch.int32)
    p_wan = _p_wan(cfg, t)
    live = valid & bernoulli_mask(k_loss, (S2, U),
                                  lift(p_wan, 2) if p_wan.dim() else p_wan)
    # Capacity spent on events the dst bridge set already held, counted
    # at link exit over every arriving unit.
    wasted = state.wasted + torch.sum(
        arriving * bk[..., c.dst, :].to(torch.int32), dim=(-2, -1),
        dtype=torch.int32)
    return LinkStep(
        ring=ring, queue=queue, known_hist=known_hist,
        ewma=_ewma(cfg, state.ewma, admitted), wasted=wasted,
        offered=offered, admitted=admitted,
        queued=torch.sum(queue, dim=-1, dtype=torch.int32),
        overflow=overflow, recv=recv, ev_slot=ev_slot, live=live,
    )


def merge(knows: torch.Tensor, tx_lan: torch.Tensor, senders: torch.Tensor,
          newly: torch.Tensor, cfg: GeoConfig):
    """New knowledge and LAN budgets: senders spend a fanout, fresh
    recipients re-queue the event.  Returns ``(knows, tx_lan)``."""
    tx = torch.clamp(tx_lan - torch.where(senders, cfg.fanout_lan, 0), min=0)
    tx = torch.where(newly, cfg.tx_limit_lan, tx).to(torch.int32)
    return knows | newly, tx


def per_segment_done(knows: torch.Tensor, cfg: GeoConfig,
                     nb: int = 0) -> torch.Tensor:
    """int32[*B, S]: nodes of each segment holding ALL events."""
    full = torch.all(knows, dim=-1)
    return torch.sum(full.reshape(*knows.shape[:nb], cfg.segments,
                                  cfg.seg_size), dim=-1, dtype=torch.int32)


def geo_round(state: GeoState, key: torch.Tensor, cfg: GeoConfig,
              consts: GeoConstants = None):
    """One LAN tick of the geo plane.

    Returns ``(next_state, outs)`` with ``outs`` the per-tick
    ``(per_segment, offered, admitted, queued, overflow, wasted)``:
    ``per_segment`` int32[S] counts nodes holding ALL events, the link
    counters are int32[S2] in units, ``queued`` the post-tick queue depth
    and ``wasted`` the cumulative arriving units whose event the
    destination's bridge set already held.  A sweep's state and key
    batch give each a leading universe axis."""
    n, E = cfg.n, cfg.events
    dev = state.knows.device
    nb = state.tick.dim()
    if consts is None:
        consts = geo_constants(cfg, dev)
    k_lan, k_gossip, k_tgt, k_loss = split(key, 4).unbind(-2)
    knows = state.knows

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    senders, got_lan = lan_arrivals(knows, state.tx_lan, idx, k_lan, cfg, nb)
    bk, bk_cnt = bridge_known(knows, cfg, nb)
    step = link_plane(state, bk, bk_cnt, k_gossip, k_tgt, k_loss, cfg, consts)

    flat = torch.where(step.live, step.recv.long() * E + step.ev_slot, n * E)
    if nb:
        base = torch.arange(state.tick.numel(), device=dev)
        flat = flat + base.view(*state.tick.shape, 1, 1) * (n * E + 1)
    hits = torch.zeros((*state.tick.shape, n * E + 1), dtype=torch.bool,
                       device=dev)
    hits.view(-1)[flat.reshape(-1)] = True
    got_wan = hits[..., :n * E].view(knows.shape) & ~knows

    new_knows, tx_lan = merge(knows, state.tx_lan, senders, got_lan | got_wan,
                              cfg)
    outs = (per_segment_done(new_knows, cfg, nb), step.offered, step.admitted,
            step.queued, step.overflow, step.wasted)
    nxt = GeoState(
        knows=new_knows, tx_lan=tx_lan, ring=step.ring, queue=step.queue,
        known_hist=step.known_hist, ewma=step.ewma, wasted=step.wasted,
        tick=state.tick + 1,
    )
    return nxt, outs
