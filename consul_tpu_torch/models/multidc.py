"""Multi-segment (multi-DC) epidemic broadcast with two edge classes.

The port of ``consul_tpu/models/multidc.py`` (BASELINE config 5).  ``n``
nodes in ``segments`` contiguous blocks; every node gossips inside its own
segment with the LAN profile, and the first ``bridges_per_segment`` nodes
of each segment (its servers) also gossip across segments with the WAN
profile: a slower cadence (Poisson-staggered at lan_interval/wan_interval
per tick), a loss rate of its own, and a retransmit budget scaled by the
WAN pool.  One tick is one LAN GossipInterval.

Delivery modes as in the broadcast: ``edges`` scatters every message
(``randint`` over ``[n, fanout]`` from the round's site key, the shift
trick for "not self" and "not my segment"); ``aggregate`` Poissonizes
arrivals per segment (LAN) and over the bridge pool (WAN) with the
threshold ``1 - exp(-lam)``, whose ``exp`` is XLA's
(:mod:`consul_tpu_torch.ops.xla_math`), so both modes are bit-equal to
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from consul_tpu_torch.device import device_scalar, resolve_device
from consul_tpu_torch.ops import (
    bernoulli_mask,
    deliver_or,
    randint,
    split,
    uniform,
    xla_math,
)
from consul_tpu_torch.protocol import LAN, WAN, GossipProfile, retransmit_limit


@dataclasses.dataclass(frozen=True)
class MultiDCConfig:
    n: int
    segments: int = 8
    bridges_per_segment: int = 3      # servers per DC (3-5 typical)
    lan_profile: GossipProfile = LAN
    wan_profile: GossipProfile = WAN
    loss_lan: float = 0.0
    loss_wan: float = 0.0
    delivery: str = "edges"
    wan_enabled: bool = True          # False: isolated segments (control)

    def __post_init__(self):
        if self.n % self.segments != 0:
            raise ValueError("n must divide evenly into segments")
        if self.delivery not in ("edges", "aggregate"):
            raise ValueError(f"bad delivery {self.delivery!r}")
        if self.bridges_per_segment >= self.seg_size:
            raise ValueError("segment smaller than its bridge set")

    @property
    def seg_size(self) -> int:
        return self.n // self.segments

    @property
    def fanout_lan(self) -> int:
        return self.lan_profile.gossip_nodes

    @property
    def fanout_wan(self) -> int:
        return self.wan_profile.gossip_nodes

    @property
    def n_bridges(self) -> int:
        return self.segments * self.bridges_per_segment

    @property
    def tx_limit_lan(self) -> int:
        # The LAN pool is the segment (memberlist/util.go:72-76).
        return retransmit_limit(self.lan_profile.retransmit_mult, self.seg_size)

    @property
    def tx_limit_wan(self) -> int:
        return retransmit_limit(self.wan_profile.retransmit_mult, self.n_bridges)

    @property
    def wan_rate(self) -> float:
        """P(a bridge runs a WAN gossip round in a given LAN tick)."""
        return min(
            self.lan_profile.gossip_interval_ms
            / self.wan_profile.gossip_interval_ms,
            1.0,
        )


class MultiDCState(NamedTuple):
    knows: torch.Tensor    # bool[n]
    tx_lan: torch.Tensor   # int32[n]: LAN transmit budget
    tx_wan: torch.Tensor   # int32[n]: WAN budget (nonzero only on bridges)
    tick: torch.Tensor     # int32 scalar


def _segment_of(cfg: MultiDCConfig, device) -> torch.Tensor:
    return torch.arange(cfg.n, dtype=torch.int32, device=device) // cfg.seg_size


def _is_bridge(cfg: MultiDCConfig, device) -> torch.Tensor:
    idx = torch.arange(cfg.n, dtype=torch.int32, device=device)
    return (idx % cfg.seg_size) < cfg.bridges_per_segment


def multidc_init(cfg: MultiDCConfig, origin: int = 0,
                 device=None) -> MultiDCState:
    dev = resolve_device(device)
    knows = torch.zeros(cfg.n, dtype=torch.bool, device=dev)
    knows[origin] = True
    tx_lan = torch.zeros(cfg.n, dtype=torch.int32, device=dev)
    tx_lan[origin] = cfg.tx_limit_lan
    tx_wan = torch.zeros(cfg.n, dtype=torch.int32, device=dev)
    if (origin % cfg.seg_size) < cfg.bridges_per_segment:
        tx_wan[origin] = cfg.tx_limit_wan
    return MultiDCState(knows=knows, tx_lan=tx_lan, tx_wan=tx_wan,
                        tick=torch.zeros((), dtype=torch.int32, device=dev))


def _rate(total: torch.Tensor, own: torch.Tensor, fanout: int, loss: float,
          pool: int) -> torch.Tensor:
    """float32 ``(total - own) * fanout * (1 - loss) / max(pool, 1)`` in
    the reference's operation order."""
    dev = own.device
    lam = (total - own.to(torch.float32)) * device_scalar(
        fanout, torch.float32, dev)
    lam = lam * device_scalar(1.0 - loss, torch.float32, dev)
    return lam / device_scalar(max(pool, 1), torch.float32, dev)


def _arrivals(key: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """bool[n]: ``uniform(key, (n,)) < 1 - exp(-lam)``."""
    return uniform(key, (lam.shape[0],)) < 1.0 - xla_math.exp(-lam)


def multidc_round(state: MultiDCState, key: torch.Tensor,
                  cfg: MultiDCConfig) -> MultiDCState:
    n, S, ss, B = cfg.n, cfg.segments, cfg.seg_size, cfg.bridges_per_segment
    dev = state.knows.device
    k_lan_sel, k_lan_loss, k_wan_on, k_wan_seg, k_wan_slot, k_wan_loss = (
        split(key, 6).unbind(-2)
    )
    seg = _segment_of(cfg, dev)
    bridge = _is_bridge(cfg, dev)
    knows = state.knows

    # LAN edge class: gossip within the segment only.
    senders_l = knows & (state.tx_lan > 0)
    if cfg.delivery == "edges":
        # Uniform target in the own segment, not self: the shift trick
        # over the in-segment offset.
        draws = randint(k_lan_sel, (n, cfg.fanout_lan), 0, max(ss - 1, 1))
        off = (torch.arange(n, dtype=torch.int32, device=dev) % ss)[:, None]
        local = torch.where(draws >= off, draws + 1, draws) % ss
        targets = seg[:, None] * ss + local
        delivered = senders_l[:, None] & bernoulli_mask(
            k_lan_loss, (n, cfg.fanout_lan), 1.0 - cfg.loss_lan
        )
        got_lan = deliver_or(knows, targets, delivered) & ~knows
    else:
        per_seg = torch.sum(senders_l.view(S, ss), dim=1, dtype=torch.float32)
        lam = _rate(per_seg[seg.long()], senders_l, cfg.fanout_lan,
                    cfg.loss_lan, ss - 1)
        got_lan = _arrivals(k_lan_loss, lam) & ~knows

    # WAN edge class: bridges gossip across segments at the WAN cadence.
    if cfg.wan_enabled:
        wan_on = bernoulli_mask(k_wan_on, (n,), cfg.wan_rate)
        senders_w = knows & (state.tx_wan > 0) & bridge & wan_on
        fw = cfg.fanout_wan
        if cfg.delivery == "edges":
            # A uniform bridge of ANOTHER segment.
            dseg = randint(k_wan_seg, (n, fw), 0, max(S - 1, 1))
            tseg = torch.where(dseg >= seg[:, None], dseg + 1, dseg) % S
            slot = randint(k_wan_slot, (n, fw), 0, B)
            wtargets = tseg * ss + slot
            wdelivered = senders_w[:, None] & bernoulli_mask(
                k_wan_loss, (n, fw), 1.0 - cfg.loss_wan
            )
            got_wan = deliver_or(knows, wtargets, wdelivered) & ~knows
        else:
            # A bridge hears the senders outside its own segment.
            w_total = torch.sum(senders_w, dtype=torch.float32)
            per_seg_w = torch.sum(senders_w.view(S, ss), dim=1,
                                  dtype=torch.float32)
            lam_w = _rate(w_total, per_seg_w[seg.long()], fw, cfg.loss_wan,
                          cfg.n_bridges - B)
            got_wan = bridge & _arrivals(k_wan_loss, lam_w) & ~knows
        spent_w = torch.where(senders_w, fw, 0).to(torch.int32)
    else:
        got_wan = torch.zeros_like(knows)
        spent_w = torch.zeros_like(state.tx_wan)

    # Budgets: LAN spends every tick, WAN only on its staggered rounds;
    # fresh recipients queue the event on both their edge classes.
    newly = got_lan | got_wan
    tx_lan = torch.clamp(
        state.tx_lan - torch.where(senders_l, cfg.fanout_lan, 0), min=0
    ).to(torch.int32)
    tx_lan = torch.where(newly, cfg.tx_limit_lan, tx_lan).to(torch.int32)
    tx_wan = torch.clamp(state.tx_wan - spent_w, min=0)
    tx_wan = torch.where(newly & bridge, cfg.tx_limit_wan,
                         tx_wan).to(torch.int32)
    return MultiDCState(knows=knows | newly, tx_lan=tx_lan, tx_wan=tx_wan,
                        tick=state.tick + 1)
