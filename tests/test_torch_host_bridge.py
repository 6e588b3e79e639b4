"""The north-star seam in the port alone: the port's own host agent
(``consul_tpu_torch.net.Memberlist`` and ``consul_tpu_torch.eventing.
Cluster``) on the port's bridge (``SimBridge(..., device="cpu")``).

The five scenarios of ``tests/test_sim_transport.py`` under its bars,
and its 10k pool as a slow test (``-m slow``), as the reference marks it:
a host joins the simulated pool through push/pull and sees every member,
a simulated crash reaches it as a member event, its user event infects
the population, the population probes it and it answers, and its
periodic push/pull recovers the converged state.
"""

import asyncio

import pytest

from consul_tpu_torch.eventing import Cluster, ClusterConfig, EventType
from consul_tpu_torch.net import (
    Memberlist,
    MemberlistConfig,
    NodeStatus,
    SimBridge,
    SimPoolConfig,
    sim_addr,
)
from consul_tpu_torch.protocol import LAN, GossipProfile
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCALE = 0.01

# tests/test_sim_transport.py's detection-accelerated profile: probes
# every gossip tick, minimal suspicion multiplier.
FAST = GossipProfile(
    name="fast",
    probe_interval_ms=200,
    probe_timeout_ms=200,
    indirect_checks=3,
    suspicion_mult=2,
    suspicion_max_timeout_mult=2,
    awareness_max_multiplier=8,
    gossip_interval_ms=200,
    gossip_nodes=3,
    gossip_to_the_dead_ms=30_000,
    retransmit_mult=4,
    push_pull_interval_ms=30_000,
)


def run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


async def attach_host(bridge, name="host0", profile=LAN):
    transport = bridge.transport(f"sim-host://{name}")
    m = Memberlist(
        MemberlistConfig(name=name, profile=profile, interval_scale=SCALE),
        transport,
    )
    await m.start()
    return m, transport


def test_host_joins_simulated_pool():
    async def main():
        n = 512
        bridge = SimBridge(SimPoolConfig(n=n, interval_scale=SCALE,
                                         realtime=False), device="cpu")
        host, transport = await attach_host(bridge)
        assert await host.join([sim_addr(0)]) == 1
        assert len(host.members()) == n + 1
        assert {m.name for m in host.members()} >= {"sim-0", "sim-511"}
        assert bridge.host_awareness(transport) > 0
        await bridge.run_ticks(20)
        assert bridge.host_awareness(transport) > 0.9
        await host.shutdown()
        await bridge.shutdown()

    run(main())


def test_simulated_failure_reaches_host_as_member_event():
    async def main():
        n = 512
        failed = 7
        leaves: list[str] = []
        bridge = SimBridge(
            SimPoolConfig(n=n, profile=FAST, interval_scale=SCALE,
                          fail_at=((failed, 5),), realtime=False),
            device="cpu",
        )
        transport = bridge.transport("sim-host://host0")
        host = Memberlist(
            MemberlistConfig(
                name="host0",
                profile=FAST,
                interval_scale=SCALE,
                notify_leave=lambda node: leaves.append(node.name),
            ),
            transport,
        )
        await host.start()
        assert await host.join([sim_addr(0)]) == 1
        for _ in range(30):
            await bridge.run_ticks(5)
            node = host.nodes.get("sim-7")
            if node is not None and node.status == NodeStatus.DEAD:
                break
        assert host.nodes["sim-7"].status == NodeStatus.DEAD
        assert "sim-7" in leaves
        alive = [m.name for m in host.members()]
        assert "sim-7" not in alive
        assert len(alive) >= n
        await host.shutdown()
        await bridge.shutdown()

    run(main())


def test_host_user_event_infects_population():
    async def main():
        n = 512
        bridge = SimBridge(
            SimPoolConfig(n=n, interval_scale=SCALE, realtime=False),
            device="cpu",
        )
        transport = bridge.transport("sim-host://host0")
        cluster = Cluster(
            ClusterConfig(name="host0", interval_scale=SCALE), transport
        )
        await cluster.start()
        assert await cluster.join([sim_addr(0)]) == 1
        await bridge.run_ticks(3)
        await cluster.user_event("deploy", b"v2-rollout")
        await asyncio.sleep(0.05)
        await bridge.run_ticks(30)
        coverage = bridge.event_coverage(b"v2-rollout")
        assert coverage > 0.95, coverage
        await cluster.shutdown()
        await bridge.shutdown()

    run(main())


def test_population_probes_host_and_host_refutes():
    async def main():
        n = 256
        bridge = SimBridge(
            SimPoolConfig(n=n, interval_scale=SCALE, realtime=False),
            device="cpu",
        )
        host, transport = await attach_host(bridge)
        assert await host.join([sim_addr(0)]) == 1
        await bridge.run_ticks(40)
        assert transport.ping_seq > 0
        assert transport.missed_pings == 0
        assert host.local_node().status == NodeStatus.ALIVE
        await host.shutdown()
        await bridge.shutdown()

    run(main())


def test_push_pull_backstop_syncs_host():
    async def main():
        n = 256
        bridge = SimBridge(
            SimPoolConfig(n=n, profile=FAST, interval_scale=SCALE,
                          fail_at=((3, 2),), realtime=False),
            device="cpu",
        )
        host, transport = await attach_host(bridge, profile=FAST)
        await bridge.run_ticks(40)
        assert await host.join([sim_addr(0)]) == 1
        alive = {m.name for m in host.members()}
        assert "sim-3" not in alive
        assert len(alive) == n
        await host.shutdown()
        await bridge.shutdown()

    run(main())


@pytest.mark.slow  # the dense 10k round on the CPU
def test_ten_thousand_member_pool():
    """The VERDICT bar: the port's Cluster joins a 10k-member pool, holds
    n + 1 members, hears of the crash of sim-4242 as DEAD and
    MEMBER_FAILED, and its user event covers the population."""

    async def main():
        n = 10_000
        failed = 4242
        leaves: list[str] = []
        bridge = SimBridge(
            SimPoolConfig(n=n, profile=FAST, interval_scale=SCALE,
                          fail_at=((failed, 3),), realtime=False),
            device="cpu",
        )
        transport = bridge.transport("sim-host://host0")
        cluster = Cluster(
            ClusterConfig(name="host0", profile=FAST, interval_scale=SCALE),
            transport,
        )
        cluster.config.on_event = lambda ev: (
            leaves.extend(m.name for m in ev.members)
            if ev.type == EventType.MEMBER_FAILED
            else None
        )
        await cluster.start()
        assert await cluster.join([sim_addr(17)]) == 1
        assert len(cluster.memberlist.members()) == n + 1
        await cluster.user_event("deploy", b"big-pool-event")
        await asyncio.sleep(0.05)
        detected = False
        for _ in range(12):
            await bridge.run_ticks(5)
            node = cluster.memberlist.nodes.get(f"sim-{failed}")
            if node is not None and node.status == NodeStatus.DEAD:
                detected = True
                break
        assert detected, "simulated failure never reached the host"
        assert f"sim-{failed}" in leaves
        coverage = bridge.event_coverage(b"big-pool-event")
        assert coverage > 0.9, coverage
        await cluster.shutdown()
        await bridge.shutdown()

    run(main(), timeout=3600)
