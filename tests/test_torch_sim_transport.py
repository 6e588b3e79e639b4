"""The port's sim↔host bridge (``consul_tpu_torch.net``) against the JAX
package's (``consul_tpu.net.sim_transport``), on the CPU.

  * lockstep: both bridges driven tick for tick by one scripted host (a
    push/pull join carrying a stale and an advancing entry, the host's
    ALIVE, injected SUSPECT / DEAD / LEFT views, duplicate injections to
    one cell, three USER events, pings, an indirect ping, unanswered
    probes, a push/pull through a negative address) at n = 256 and 512, at the FAST and LAN profiles, with
    crashes, a leave and a late join: every state field equal with its
    dtype on every tick, every infection equal, every delivered packet
    byte-equal in order, ``up``, ``event_coverage`` and
    ``host_awareness`` equal;
  * the five scenarios of ``tests/test_sim_transport.py`` with the JAX
    package's host ``Memberlist``/``Cluster`` attached to the port's
    bridge (``device="cpu"``), under the same bars; its 10k pool as a
    slow test, as the reference marks it;
  * ``_inject_and_step`` with padded and duplicate slots.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.eventing.cluster import Cluster, ClusterConfig, EventType
from consul_tpu.models import membership as j_membership
from consul_tpu.net import sim_transport as j_sim
from consul_tpu.net.memberlist import Memberlist, MemberlistConfig, NodeStatus
from consul_tpu.protocol import profiles as j_profiles
from consul_tpu_torch.models import membership
from consul_tpu_torch.net import SimBridge, SimPoolConfig, sim_addr, wire
from consul_tpu_torch.net.sim_transport import _inject_and_step
from consul_tpu_torch.ops import PRNGKey, fold_in
from consul_tpu_torch.protocol import LAN, GossipProfile
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCALE = 0.01
HOST = "sim-host://host0"

# tests/test_sim_transport.py's detection-accelerated profile: probes
# every gossip tick, minimal suspicion multiplier.
FAST_FIELDS = dict(
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
FAST = GossipProfile(**FAST_FIELDS)
J_FAST = j_profiles.GossipProfile(**FAST_FIELDS)
PROFILES = {"fast": (J_FAST, FAST), "lan": (j_profiles.LAN, LAN)}


def run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# ---------------------------------------------------------------------------
# Lockstep parity
# ---------------------------------------------------------------------------


def _snap(name, inc=0, status=0):
    return {"name": name, "addr": f"sim://{name[4:]}", "inc": inc,
            "status": status, "meta": b""}


def _script(n: int) -> dict:
    """tick -> the host's actions before that tick: (kind, target, arg)."""
    own = {"name": "host0", "addr": HOST, "inc": 0, "status": 0,
           "meta": b""}
    return {
        0: [("push_pull", 0, {"join": True, "user": b"", "nodes": [
            own, _snap("sim-5"), _snap("sim-9", inc=2, status=1)]})],
        1: [("packet", 0, wire.encode(wire.MessageType.ALIVE, own)),
            ("packet", 13, wire.encode(wire.MessageType.USER, {
                "name": "deploy", "payload": b"v2-rollout", "ltime": 1}))],
        2: [("packet", 4, wire.encode(wire.MessageType.SUSPECT, {
                "inc": 0, "node": "sim-20", "from": "host0"})),
            ("packet", 4, wire.encode(wire.MessageType.DEAD, {
                "inc": 1, "node": "sim-21", "from": "host0"})),
            ("packet", 5, wire.encode(wire.MessageType.DEAD, {
                "inc": 0, "node": "sim-22", "from": "sim-22"})),
            # Two injections into one cell (row 6, subject 30) in one
            # tick: the larger key lands.
            ("packet", 6, wire.make_compound([
                wire.encode(wire.MessageType.SUSPECT, {
                    "inc": 3, "node": "sim-30", "from": "host0"}),
                wire.encode(wire.MessageType.SUSPECT, {
                    "inc": 1, "node": "sim-30", "from": "host0"}),
                wire.encode(wire.MessageType.ALIVE, _snap("sim-31", 2)),
            ])),
            ("packet", -1, wire.encode(wire.MessageType.ALIVE,
                                       _snap("sim-33", 1)))],
        5: [("packet", 7, wire.encode(wire.MessageType.USER, {
                "name": "deploy", "payload": b"v3-rollout", "ltime": 2})),
            ("packet", 8, wire.encode(wire.MessageType.PING, {"seq": 11})),
            ("packet", 3, wire.encode(wire.MessageType.PING, {"seq": 12})),
            ("packet", 8, wire.encode(wire.MessageType.INDIRECT_PING, {
                "seq": 13, "target_addr": sim_addr(3)}))],
        9: [("ping_stream", 8, wire.encode(wire.MessageType.PING,
                                           {"seq": 14})),
            ("ping_stream", 3, wire.encode(wire.MessageType.PING,
                                           {"seq": 15}))],
        12: [("push_pull", 11, {"join": False, "user": b"", "nodes": [
            own, _snap("sim-40", inc=1, status=2),
            _snap("sim-41", inc=0, status=0)]})],
        # A negative address reads row n - 1, as the reference's clamped
        # gather does.
        14: [("push_pull", -1, {"join": False, "user": b"", "nodes": [
            own, _snap("sim-42", inc=1)]})],
        # After the first retirement check (tick 16): a third event and a
        # fresh host seed, whose keys count the retired infections.
        18: [("packet", 9, wire.encode(wire.MessageType.USER, {
                "name": "deploy", "payload": b"v4-rollout", "ltime": 3})),
             ("packet", 2, wire.encode(wire.MessageType.ALIVE, own))],
    }


async def _act(transport, kind, j, arg):
    """One host action; returns what the host saw."""
    if kind == "packet":
        await transport.write_to(arg, sim_addr(j))
        return None
    try:
        stream = await transport.dial(sim_addr(j), 1.0)
    except ConnectionError as e:
        return ("refused", str(e))
    body = (wire.encode(wire.MessageType.PUSH_PULL, arg)
            if kind == "push_pull" else arg)
    await stream.send(body)
    got = await stream.recv(1.0)
    await stream.close()
    return got


def _drain(transport) -> list:
    out = []
    while not transport.packets.empty():
        payload, src, _ = transport.packets.get_nowait()
        out.append((payload, src))
    return out


def _infections(bridge, to_np) -> list:
    rows = [(body, to_np(inf.infected), to_np(inf.tx), inf.done)
            for body, inf in bridge.events.items()]
    rows += [(addr, to_np(h.known.infected), to_np(h.known.tx),
              h.known.done) for addr, h in bridge.hosts.items()]
    return rows


def _compare(j_bridge, t_bridge, tick):
    for f in j_membership.MembershipState._fields:
        want = np.asarray(getattr(j_bridge.state, f))
        got = getattr(t_bridge.state, f).numpy()
        assert got.dtype == want.dtype, (tick, f)
        np.testing.assert_array_equal(got, want, err_msg=f"tick {tick} {f}")
    want = _infections(j_bridge, np.asarray)
    got = _infections(t_bridge, lambda t: t.numpy())
    assert [w[0] for w in want] == [g[0] for g in got]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"tick {tick}")
        np.testing.assert_array_equal(g[2], w[2], err_msg=f"tick {tick}")
        assert g[2].dtype == w[2].dtype and g[3] == w[3], tick
    n = j_bridge.cfg.n
    assert ([t_bridge.up(j) for j in range(n)]
            == [j_bridge.up(j) for j in range(n)]), tick
    assert t_bridge.event_coverage() == j_bridge.event_coverage(), tick
    assert (t_bridge.event_coverage(b"v3") == j_bridge.event_coverage(b"v3")
            ), tick
    for addr, host in t_bridge.hosts.items():
        ref = j_bridge.hosts[addr]
        assert (t_bridge.host_awareness(host)
                == j_bridge.host_awareness(ref)), tick
        assert ((host.ping_seq, host.pending_pings, host.missed_pings,
                 host.host_inc)
                == (ref.ping_seq, ref.pending_pings, ref.missed_pings,
                    ref.host_inc)), tick


def _answer_pings(packets: list, pings: list) -> list:
    """The ACKs the scripted host sends: it leaves the first probe of it and
    every third after unanswered (``pings`` counts them over the run), so
    some expire."""
    acks = []
    for payload, src in packets:
        parts = (wire.split_compound(payload)
                 if payload[0] == wire.MessageType.COMPOUND else [payload])
        for part in parts:
            t, body = wire.decode(part)
            if t == wire.MessageType.PING:
                pings.append(body["seq"])
                if len(pings) % 3 != 1:
                    acks.append((wire.encode(wire.MessageType.ACK_RESP,
                                             {"seq": body["seq"]}), src))
    return acks


LOCKSTEP = [
    (256, "fast", 40),
    (256, "lan", 30),
    (512, "fast", 30),
    (512, "lan", 25),
]


@pytest.mark.parametrize("n,profile,steps", LOCKSTEP,
                         ids=[f"{n}-{p}" for n, p, _ in LOCKSTEP])
def test_lockstep_parity(n, profile, steps):
    j_prof, t_prof = PROFILES[profile]
    sched = dict(fail_at=((3, 2), (40, 10)), leave_at=((50, 4),),
                 join_at=((60, 6),), loss=0.05 if profile == "lan" else 0.0)

    async def main():
        j_bridge = j_sim.SimBridge(j_sim.SimPoolConfig(
            n=n, profile=j_prof, interval_scale=SCALE, realtime=False,
            seed=3, **sched))
        t_bridge = SimBridge(SimPoolConfig(
            n=n, profile=t_prof, interval_scale=SCALE, realtime=False,
            seed=3, **sched), device="cpu")
        j_host, t_host = j_bridge.transport(HOST), t_bridge.transport(HOST)
        script = _script(n)
        delivered = missed = 0
        pings: list = []
        for tick in range(steps):
            for kind, j, arg in script.get(tick, ()):
                want = await _act(j_host, kind, j, arg)
                got = await _act(t_host, kind, j, arg)
                assert got == want, (tick, kind, j)
            await j_bridge.step()
            await t_bridge.step()
            _compare(j_bridge, t_bridge, tick)
            want, got = _drain(j_host), _drain(t_host)
            assert got == want, tick
            delivered += len(got)
            missed = max(missed, t_host.missed_pings)
            for payload, src in _answer_pings(got, pings):
                await j_host.write_to(payload, src)
                await t_host.write_to(payload, src)
        assert delivered > 0
        assert t_host.ping_seq > 0 and missed > 0

    run(main())


def test_inject_and_step_padded_and_duplicate_slots():
    """Padding (row n), a negative row, rows past n, duplicate cells with
    advancing and stale keys, against the reference's jitted step."""
    n = 64
    j_cfg = j_membership.MembershipConfig(n=n, fail_at=((5, 0),))
    t_cfg = membership.MembershipConfig(n=n, fail_at=((5, 0),))
    rows = np.full(128, n, np.int32)
    cols = np.zeros(128, np.int32)
    vals = np.full(128, -1, np.int32)
    slots = [(1, 2, 9), (1, 2, 5), (1, 2, 13), (3, 4, 0), (4, 3, 6),
             (-1, 7, 9), (n + 5, 1, 99), (2 * n, 3, 99), (0, 63, 4),
             (0, 63, 4), (7, 7, 1)]
    for i, (r, c, v) in enumerate(slots):
        rows[i], cols[i], vals[i] = r, c, v
    j_state = j_membership.membership_init(j_cfg)
    t_state = membership.membership_init(t_cfg, "cpu")
    for tick in range(3):
        j_state = j_sim._inject_and_step(
            j_state, jnp.asarray(rows), jnp.asarray(cols),
            jnp.asarray(vals), jax.random.fold_in(jax.random.PRNGKey(1),
                                                  tick), j_cfg)
        t_state = _inject_and_step(
            t_state, torch.from_numpy(rows), torch.from_numpy(cols),
            torch.from_numpy(vals), fold_in(PRNGKey(1), tick), t_cfg)
        for f in j_membership.MembershipState._fields:
            want = np.asarray(getattr(j_state, f))
            got = getattr(t_state, f).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"{tick} {f}")


def test_bridge_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimBridge(SimPoolConfig(n=8))


# ---------------------------------------------------------------------------
# The reference's scenarios, with its host agents on the port's bridge
# ---------------------------------------------------------------------------


async def attach_host(bridge, name="host0", profile=j_profiles.LAN):
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
                profile=J_FAST,
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
        host, transport = await attach_host(bridge, profile=J_FAST)
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
            ClusterConfig(name="host0", profile=J_FAST,
                          interval_scale=SCALE),
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
        coverage = bridge.event_coverage(b"big-pool-event")
        assert coverage > 0.9, coverage
        await cluster.shutdown()
        await bridge.shutdown()

    run(main(), timeout=3600)
