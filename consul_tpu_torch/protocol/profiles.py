"""Gossip timing profiles (the slice's copy of ``consul_tpu.protocol.profiles``).

The protocol constants of memberlist's three built-in configs
(memberlist/config.go:273-361, DefaultLANConfig / DefaultWANConfig /
DefaultLocalConfig).  All durations are in milliseconds; one simulator
tick is one ``gossip_interval_ms``.  Every field of the reference's
profile is kept, in its order and with its defaults;
``gossip_to_the_dead_ms`` is required, as it is there.
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
    suspicion_max_timeout_mult: int  # config.go:286 (6)
    awareness_max_multiplier: int    # config.go: AwarenessMaxMultiplier (8)
    gossip_interval_ms: int       # config.go:293 (LAN 200ms), :322 (WAN 500ms), :358
    gossip_nodes: int             # config.go:294 (LAN 3, WAN 4, local 3)
    gossip_to_the_dead_ms: int    # config.go:295 (LAN 30s, WAN 60s, local 15s)
    retransmit_mult: int          # config.go:284 (4, local 2)
    push_pull_interval_ms: int    # config.go:287 (LAN 30s, WAN 60s, local 15s)
    # The host agent's: Memberlist reads the first, Cluster the rest.
    udp_buffer_size: int = 1400   # config.go:307 (packet budget, bytes)
    event_buffer_size: int = 512      # serf/config.go:291 (dedup ring entries)
    query_buffer_size: int = 512      # serf/config.go: QueryBuffer
    max_user_event_size: int = 512    # serf/config.go:311 (bytes)

    @property
    def probe_interval_ticks(self) -> int:
        return max(1, round(self.probe_interval_ms / self.gossip_interval_ms))

    @property
    def probe_timeout_ticks(self) -> int:
        return max(1, round(self.probe_timeout_ms / self.gossip_interval_ms))

    @property
    def push_pull_interval_ticks(self) -> int:
        return max(1, round(self.push_pull_interval_ms / self.gossip_interval_ms))


LAN = GossipProfile(
    name="lan",
    probe_interval_ms=1000,
    probe_timeout_ms=500,
    indirect_checks=3,
    suspicion_mult=4,
    suspicion_max_timeout_mult=6,
    awareness_max_multiplier=8,
    gossip_interval_ms=200,
    gossip_nodes=3,
    gossip_to_the_dead_ms=30_000,
    retransmit_mult=4,
    push_pull_interval_ms=30_000,
)

WAN = GossipProfile(
    name="wan",
    probe_interval_ms=5000,
    probe_timeout_ms=3000,
    indirect_checks=3,
    suspicion_mult=6,
    suspicion_max_timeout_mult=6,
    awareness_max_multiplier=8,
    gossip_interval_ms=500,
    gossip_nodes=4,
    gossip_to_the_dead_ms=60_000,
    retransmit_mult=4,
    push_pull_interval_ms=60_000,
)

LOCAL = GossipProfile(
    name="local",
    probe_interval_ms=1000,
    probe_timeout_ms=200,
    indirect_checks=1,
    suspicion_mult=3,
    suspicion_max_timeout_mult=6,
    awareness_max_multiplier=8,
    gossip_interval_ms=100,
    gossip_nodes=3,
    gossip_to_the_dead_ms=15_000,
    retransmit_mult=2,
    push_pull_interval_ms=15_000,
)

PROFILES = {"lan": LAN, "wan": WAN, "local": LOCAL}
