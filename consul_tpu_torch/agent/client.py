"""The Client: a thin agent that forwards all RPCs to servers; the
port's copy of ``consul_tpu/agent/client.py``.

Equivalent of ``agent/consul/client.go`` + ``agent/router/manager.go``:
LAN serf membership only (no raft), a server list maintained from serf
member tags, and RPC forwarding with rebalancing and
retry-on-failure/no-leader (client.go:237-280).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
import time
from typing import Optional

from consul_tpu_torch.agent.rpc import (
    ERR_NO_LEADER,
    RPCClient,
    RPCError,
    rpc_timeout_for,
)
from consul_tpu_torch.eventing.cluster import Cluster, ClusterConfig, MemberStatus
from consul_tpu_torch.net.transport import Transport
from consul_tpu_torch.protocol import LAN, GossipProfile

log = logging.getLogger("consul_tpu_torch.client")

RPC_HOLD_TIMEOUT = 7.0  # config.go RPCHoldTimeout
RPC_RETRIES = 3


@dataclasses.dataclass
class ClientConfig:
    node_name: str
    datacenter: str = "dc1"
    profile: GossipProfile = LAN
    gossip_interval_scale: float = 1.0
    tags: dict = dataclasses.field(default_factory=dict)
    keyring: object = None  # gossip encryption (security.go)


REBALANCE_INTERVAL_S = 120.0  # router/manager.go clientRPCMinReuseDuration


class ServerManager:
    """Tracks known servers from serf tags, rotates through them
    (router/manager.go:44-190): sticky preferred server, cycled on
    failure and periodically re-shuffled so client load spreads over
    servers added later."""

    def __init__(
        self,
        serf: Cluster,
        datacenter: str,
        seed: int = 0,
        rebalance_interval_s: float = REBALANCE_INTERVAL_S,
    ):
        self.serf = serf
        self.datacenter = datacenter
        self._rng = random.Random(seed)
        self._preferred: Optional[str] = None  # rpc addr
        self.rebalance_interval_s = rebalance_interval_s
        self._next_rebalance = 0.0

    def servers(self) -> list[dict]:
        out = []
        for m in self.serf.members.values():
            if (
                m.status == MemberStatus.ALIVE
                and m.tags.get("role") == "consul"
                and m.tags.get("dc") == self.datacenter
                and m.tags.get("rpc_addr")
            ):
                out.append({
                    "name": m.name,
                    "id": m.tags.get("id", m.name),
                    "rpc_addr": m.tags["rpc_addr"],
                })
        return out

    def pick(self) -> Optional[str]:
        servers = self.servers()
        if not servers:
            return None
        addrs = [s["rpc_addr"] for s in servers]
        now = time.monotonic()
        if self._preferred in addrs and now < self._next_rebalance:
            return self._preferred
        self._preferred = self._rng.choice(addrs)
        self._next_rebalance = now + self.rebalance_interval_s
        return self._preferred

    def notify_failed(self, addr: str) -> None:
        if self._preferred == addr:
            self._preferred = None


class Client:
    """One Consul client agent (``consul.Client``)."""

    def __init__(
        self,
        config: ClientConfig,
        gossip_transport: Transport,
        rpc_transport: Transport,
    ):
        self.config = config
        tags = {"role": "node", "dc": config.datacenter, **config.tags}
        self.serf = Cluster(
            ClusterConfig(
                name=config.node_name,
                tags=tags,
                profile=config.profile,
                interval_scale=config.gossip_interval_scale,
                keyring=config.keyring,
            ),
            gossip_transport,
        )
        self.rpc_client = RPCClient(rpc_transport)
        self.routers = ServerManager(self.serf, config.datacenter)

    async def start(self) -> None:
        await self.serf.start()

    async def join(self, addrs: list[str]) -> int:
        return await self.serf.join(addrs)

    async def leave(self) -> None:
        await self.serf.leave()

    async def shutdown(self) -> None:
        await self.rpc_client.shutdown()
        await self.serf.shutdown()

    async def rpc(self, method: str, body: dict, timeout: float = 0.0):
        """Forward an RPC to a server, retrying with jitter across
        servers on connection failure or missing leader
        (client.go:237-280 RPC retry loop).  With no explicit timeout
        the budget follows the query's blocking wait."""
        timeout = timeout or rpc_timeout_for(body)
        last_error: Exception = RPCError("no known consul servers")
        for attempt in range(RPC_RETRIES):
            addr = self.routers.pick()
            if addr is None:
                await asyncio.sleep(0.05 * (attempt + 1))
                continue
            try:
                return await self.rpc_client.call(addr, method, body, timeout)
            except ConnectionError as e:
                self.routers.notify_failed(addr)
                last_error = e
            except RPCError as e:
                if ERR_NO_LEADER in str(e):
                    # Leader election in progress: back off and retry
                    # (rpc.go holds for RPCHoldTimeout under no-leader).
                    last_error = e
                    await asyncio.sleep(
                        min(RPC_HOLD_TIMEOUT / 8 * (attempt + 1), 1.0)
                    )
                else:
                    raise
        raise last_error
