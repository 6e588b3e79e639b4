"""Gossip timing profiles (the slice's copy of ``consul_tpu.protocol.profiles``).

The protocol constants of memberlist's three built-in configs
(memberlist/config.go:273-361, DefaultLANConfig / DefaultWANConfig /
DefaultLocalConfig).  All durations are in milliseconds; one simulator
tick is one ``gossip_interval_ms``.  Only the fields the ported
families read are kept.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GossipProfile:
    """One timing profile (LAN / WAN / Local); memberlist/config.go:273-361."""

    name: str
    probe_interval_ms: int        # config.go:289 (LAN 1s), :321 (WAN 5s), :357
    probe_timeout_ms: int         # config.go:288 (LAN 500ms), :320 (WAN 3s), :356
    indirect_checks: int          # config.go:283 (3), :352 (local 1)
    suspicion_mult: int           # config.go:285 (LAN 4, WAN 6, local 3)
    gossip_interval_ms: int       # config.go:293 (LAN 200ms), :322 (WAN 500ms), :358
    gossip_nodes: int             # config.go:294 (LAN 3, WAN 4, local 3)
    retransmit_mult: int          # config.go:284 (4, local 2)


LAN = GossipProfile(
    name="lan",
    probe_interval_ms=1000,
    probe_timeout_ms=500,
    indirect_checks=3,
    suspicion_mult=4,
    gossip_interval_ms=200,
    gossip_nodes=3,
    retransmit_mult=4,
)

WAN = GossipProfile(
    name="wan",
    probe_interval_ms=5000,
    probe_timeout_ms=3000,
    indirect_checks=3,
    suspicion_mult=6,
    gossip_interval_ms=500,
    gossip_nodes=4,
    retransmit_mult=4,
)

LOCAL = GossipProfile(
    name="local",
    probe_interval_ms=1000,
    probe_timeout_ms=200,
    indirect_checks=1,
    suspicion_mult=3,
    gossip_interval_ms=100,
    gossip_nodes=3,
    retransmit_mult=2,
)

PROFILES = {"lan": LAN, "wan": WAN, "local": LOCAL}
