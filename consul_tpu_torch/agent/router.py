"""Cross-datacenter routing over the WAN gossip pool; the port's copy of
``consul_tpu/agent/router.py``.

The reference's router (agent/router/router.go:22-137) tracks "areas" —
serf pools — and the servers discovered in each, keyed by datacenter;
its headline query is GetDatacentersByDistance (router.go:534), which
orders DCs by median Vivaldi round-trip estimate from the local node so
prepared-query failover and cross-DC work walk the nearest DCs first.

Here the single WAN area is the server's WAN serf pool: members are
named ``<node>.<dc>`` and carry dc/rpc_addr tags
(agent/consul/server_serf.go:35-120 tags); coordinates come from the
pool's ping piggyback (consul_tpu/net/vivaldi.py).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from consul_tpu_torch.eventing.cluster import Cluster, MemberStatus


@dataclasses.dataclass
class ServerMeta:
    """router/manager.go metadata for one discovered server."""

    name: str         # WAN name, "<node>.<dc>"
    node: str         # bare node name
    dc: str
    rpc_addr: str


class Router:
    """Datacenter → servers map + RTT-ordered DC selection."""

    def __init__(self, local_dc: str, wan: Optional[Cluster]):
        self.local_dc = local_dc
        self.wan = wan
        self._rng = random.Random(hash(local_dc) & 0xFFFFFFFF)

    # ------------------------------------------------------------------
    # membership view (router.go:153-230 addServer/removeServer via the
    # serf adapter — here computed from the live WAN member list)
    # ------------------------------------------------------------------

    def servers_by_dc(self) -> dict[str, list[ServerMeta]]:
        out: dict[str, list[ServerMeta]] = {}
        if self.wan is None:
            return out
        for m in self.wan.members.values():
            if m.status != MemberStatus.ALIVE:
                continue
            dc = m.tags.get("dc")
            rpc = m.tags.get("rpc_addr")
            if not dc or not rpc:
                continue
            node = m.tags.get("id") or m.name.rsplit(".", 1)[0]
            out.setdefault(dc, []).append(
                ServerMeta(name=m.name, node=node, dc=dc, rpc_addr=rpc)
            )
        return out

    def servers_in_dc(self, dc: str) -> list[ServerMeta]:
        servers = self.servers_by_dc().get(dc, [])
        self._rng.shuffle(servers)
        return servers

    def datacenters(self) -> list[str]:
        return sorted(self.servers_by_dc())

    # ------------------------------------------------------------------
    # distance ordering (router.go:534 GetDatacentersByDistance)
    # ------------------------------------------------------------------

    def get_datacenters_by_distance(self) -> list[str]:
        """DCs ordered by median RTT estimate from us; the local DC
        always first; DCs with no usable coordinates sort last,
        alphabetically (router.go:534-607 sorts with infinite distance
        for missing coordinates)."""
        by_dc = self.servers_by_dc()
        if self.local_dc not in by_dc:
            by_dc.setdefault(self.local_dc, [])
        me = self.wan.get_coordinate() if self.wan else None

        def median_rtt(dc: str) -> float:
            if dc == self.local_dc:
                return -1.0
            if me is None or self.wan is None:
                return float("inf")
            dists = []
            for s in by_dc.get(dc, ()):
                coord = self.wan.get_cached_coordinate(s.name)
                if coord is not None:
                    dists.append(me.distance_to(coord))
            if not dists:
                return float("inf")
            dists.sort()
            return dists[len(dists) // 2]

        return sorted(by_dc, key=lambda dc: (median_rtt(dc), dc))
