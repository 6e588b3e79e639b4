"""Serf user-event epidemic broadcast on PyTorch tensors.

The port of ``consul_tpu/models/broadcast.py``: serf.UserEvent queues the
event on a TransmitLimitedQueue, every gossip tick each node drains its
queue into packets for GossipNodes random peers, and receivers dedup and
re-queue (serf/serf.go:459-516, memberlist/queue.go:288-373), as one
``(state, key) -> state`` round over n-length tensors:

  knows[i]    -- event present in node i's dedup buffer
  tx_left[i]  -- remaining transmissions of the event by node i; fresh
                 recipients get retransmit_limit(mult, n) of them.

One tick is one GossipInterval.  An ``alive`` mask takes dead nodes out
of the sender set and the target pool.  A round also runs a sweep's U
universes at once: state planes ``[U, n]``, keys ``[U, 2]``, and ``loss``
(and, under aggregate delivery, ``fanout``) may be ``[U]`` knobs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from consul_tpu_torch.device import resolve_device
from consul_tpu_torch.ops import (
    aggregate_arrivals,
    bernoulli_mask,
    deliver_or,
    sample_alive_peers,
    sample_peers,
    split,
)
from consul_tpu_torch.ops.knobs import is_knob, keep_prob, lift
from consul_tpu_torch.protocol import LAN, GossipProfile, retransmit_limit


@dataclasses.dataclass(frozen=True)
class BroadcastConfig:
    """Parameters of a broadcast study.

    ``delivery="edges"`` simulates every (sender, target) message;
    ``delivery="aggregate"`` is receiver-side Poissonized delivery, where
    a receiver hears >= 1 copy with probability 1 - exp(-lambda)."""

    n: int
    # None = follow the profile (gossip_nodes / retransmit_mult).
    fanout: int | None = None
    retransmit_mult: int | None = None
    loss: float = 0.0           # per-message drop probability
    profile: GossipProfile = LAN
    delivery: str = "edges"

    def __post_init__(self):
        if self.delivery not in ("edges", "aggregate"):
            raise ValueError(
                f"delivery must be 'edges' or 'aggregate', got {self.delivery!r}"
            )
        if self.fanout is None:
            object.__setattr__(self, "fanout", self.profile.gossip_nodes)
        if self.retransmit_mult is None:
            object.__setattr__(
                self, "retransmit_mult", self.profile.retransmit_mult
            )

    @property
    def tx_limit(self) -> int:
        return retransmit_limit(self.retransmit_mult, self.n)


class BroadcastState(NamedTuple):
    knows: torch.Tensor    # bool[n]
    tx_left: torch.Tensor  # int32[n]
    tick: torch.Tensor     # int32 scalar


def broadcast_init(cfg: BroadcastConfig, origin: int = 0,
                   device=None) -> BroadcastState:
    """Event fired at ``origin`` (serf/serf.go:507-515)."""
    dev = resolve_device(device)
    knows = torch.zeros(cfg.n, dtype=torch.bool, device=dev)
    knows[origin] = True
    tx_left = torch.zeros(cfg.n, dtype=torch.int32, device=dev)
    tx_left[origin] = cfg.tx_limit
    tick = torch.zeros((), dtype=torch.int32, device=dev)
    return BroadcastState(knows=knows, tx_left=tx_left, tick=tick)


def spend_budget(state: BroadcastState, new_knows: torch.Tensor,
                 senders: torch.Tensor, cfg: BroadcastConfig) -> BroadcastState:
    """Senders spent one transmission per target packet this tick
    (queue.go:288-373); fresh recipients queue the event with a full
    budget.  Shared by the unsharded round and the sharded tick."""
    fanout = cfg.fanout
    if is_knob(fanout):
        fanout = lift(fanout.to(senders.device), 1)
    spent = torch.where(senders, fanout, 0).to(torch.int32)
    tx_left = torch.clamp(state.tx_left - spent, min=0)
    newly = new_knows & ~state.knows
    tx_left = torch.where(newly, cfg.tx_limit, tx_left).to(torch.int32)
    return BroadcastState(knows=new_knows, tx_left=tx_left,
                          tick=state.tick + 1)


def broadcast_round(state: BroadcastState, key: torch.Tensor,
                    cfg: BroadcastConfig,
                    alive: torch.Tensor = None) -> BroadcastState:
    """One gossip tick.  ``alive`` (bool[n], optional) masks nodes that
    neither send, relay nor count as targets: live senders draw their
    fanout from the alive pool only (kRandomNodes skips dead members,
    memberlist/state.go:575-585) and dead nodes never learn the event."""
    n, fanout = cfg.n, cfg.fanout
    k_sel, k_loss = split(key).unbind(-2)
    senders = state.knows & (state.tx_left > 0)
    if alive is not None:
        senders = senders & alive

    if cfg.delivery == "edges":
        # Each node picks its gossip targets (memberlist/state.go:575-585
        # kRandomNodes over the member list, excluding self).
        if alive is None:
            targets = sample_peers(k_sel, n, fanout)            # [n, f]
        else:
            targets = sample_alive_peers(k_sel, alive, fanout)
        delivered = senders[..., None] & bernoulli_mask(
            k_loss, (n, fanout), keep_prob(cfg.loss, 2)
        )
        if alive is not None:
            delivered = delivered & alive[targets.long()]
        new_knows = deliver_or(state.knows, targets, delivered)
    else:
        got = aggregate_arrivals(k_loss, senders, fanout, cfg.loss, n, alive)
        new_knows = state.knows | got
    return spend_budget(state, new_knows, senders, cfg)
