"""The port's host gossip plane (``consul_tpu_torch.net``) on the CPU.

  * ``tests/test_memberlist.py``'s nine behaviour tests, run against the
    port's ``Memberlist`` over its ``InMemoryNetwork`` and
    ``UDPTransport`` at ``interval_scale`` 0.02;
  * parity with the JAX package's copies of the deterministic parts, on
    inputs drawn from a numpy seed: ``TransmitLimitedQueue`` (the same
    bytes in the same order, the same notifications), ``Suspicion``
    (the same timeout after each confirmation), ``push_pull_scale``,
    ``VivaldiClient`` (float-equal coordinates) and the ``Keyring``
    (each side opens what the other sealed);
  * every message a running cluster of each package puts on the wire,
    re-encoded by the other package's codec byte for byte.
"""

import asyncio
import itertools
import types

import msgpack
import numpy as np
import pytest

from helpers import requires_crypto, wait_until

from consul_tpu.net import broadcast_queue as j_queue
from consul_tpu.net import memberlist as j_memberlist
from consul_tpu.net import security as j_security
from consul_tpu.net import suspicion as j_suspicion
from consul_tpu.net import transport as j_transport
from consul_tpu.net import vivaldi as j_vivaldi
from consul_tpu.protocol import formulas as j_formulas
from consul_tpu_torch.net import (
    InMemoryNetwork,
    Memberlist,
    MemberlistConfig,
    NodeStatus,
    Transport,
    wire,
)
from consul_tpu_torch.net import broadcast_queue, security, suspicion, vivaldi
from consul_tpu_torch.protocol import push_pull_scale

SCALE = 0.02


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


async def make_cluster(net, n, joined=True, **cfg_kw):
    nodes = []
    for i in range(n):
        t = net.new_transport(f"mem://n{i}")
        m = Memberlist(
            MemberlistConfig(name=f"n{i}", interval_scale=SCALE, **cfg_kw), t
        )
        await m.start()
        nodes.append(m)
    if joined:
        for m in nodes[1:]:
            assert await m.join(["mem://n0"]) == 1
    return nodes


async def stop_all(nodes):
    for m in nodes:
        await m.shutdown()


# ---------------------------------------------------------------------------
# tests/test_memberlist.py, against the port
# ---------------------------------------------------------------------------


def test_three_node_cluster_forms():
    async def main():
        net = InMemoryNetwork()
        nodes = await make_cluster(net, 3)
        ok = await wait_until(
            lambda: all(len(m.members()) == 3 for m in nodes)
        )
        assert ok, [len(m.members()) for m in nodes]
        names = {m.config.name for m in nodes}
        for m in nodes:
            assert {x.name for x in m.members()} == names
        await stop_all(nodes)

    run(main())


def test_failure_detection_marks_dead():
    async def main():
        net = InMemoryNetwork()
        nodes = await make_cluster(net, 4)
        assert await wait_until(
            lambda: all(len(m.members()) == 4 for m in nodes)
        )
        await nodes[3].shutdown()
        survivors = nodes[:3]
        ok = await wait_until(
            lambda: all(
                m.nodes["n3"].status in (NodeStatus.DEAD,) for m in survivors
            ),
            timeout=40.0,
        )
        assert ok, [m.nodes["n3"].status for m in survivors]
        await stop_all(survivors)

    run(main())


def test_shutdown_cancels_tasks_in_flight(caplog):
    """Probe cycles and the sends they start are cancelled by shutdown():
    none of them runs on into the closed transport, and nothing is
    logged as a failed task."""

    async def main():
        net = InMemoryNetwork()
        nodes = await make_cluster(net, 3)
        assert await wait_until(
            lambda: all(len(m.members()) == 3 for m in nodes)
        )
        await nodes[2].shutdown()
        assert await wait_until(lambda: len(nodes[0]._inflight) > 0)
        held = set(nodes[0]._inflight)
        await stop_all(nodes[:2])
        await asyncio.sleep(10 * SCALE)
        assert all(t.done() for t in held)
        assert all(t.cancelled() or t.exception() is None for t in held)
        assert not nodes[0]._inflight

    with caplog.at_level("ERROR"):
        run(main())
    assert not [r for r in caplog.records if r.levelname == "ERROR"]


def test_graceful_leave_is_left_not_dead():
    async def main():
        net = InMemoryNetwork()
        nodes = await make_cluster(net, 3)
        assert await wait_until(
            lambda: all(len(m.members()) == 3 for m in nodes)
        )
        await nodes[2].leave()
        await nodes[2].shutdown()
        ok = await wait_until(
            lambda: all(
                m.nodes["n2"].status == NodeStatus.LEFT for m in nodes[:2]
            )
        )
        assert ok, [m.nodes["n2"].status for m in nodes[:2]]
        await stop_all(nodes[:2])

    run(main())


def test_false_suspicion_is_refuted():
    async def main():
        net = InMemoryNetwork()
        nodes = await make_cluster(net, 3)
        assert await wait_until(
            lambda: all(len(m.members()) == 3 for m in nodes)
        )
        victim_inc = nodes[0].nodes["n1"].incarnation
        nodes[0]._suspect_node(
            {"inc": victim_inc, "node": "n1", "from": "n0"}
        )
        assert nodes[0].nodes["n1"].status == NodeStatus.SUSPECT
        ok = await wait_until(
            lambda: all(
                m.nodes["n1"].status == NodeStatus.ALIVE
                and m.nodes["n1"].incarnation > victim_inc
                for m in nodes
            ),
            timeout=40.0,
        )
        assert ok, [
            (m.nodes["n1"].status, m.nodes["n1"].incarnation) for m in nodes
        ]
        await stop_all(nodes)

    run(main())


def test_cluster_survives_30pct_packet_loss():
    async def main():
        net = InMemoryNetwork(loss=0.30, seed=7)
        nodes = await make_cluster(net, 4)
        ok = await wait_until(
            lambda: all(len(m.members()) == 4 for m in nodes), timeout=40.0
        )
        assert ok
        await asyncio.sleep(2.0)
        for m in nodes:
            assert all(
                x.status in (NodeStatus.ALIVE, NodeStatus.SUSPECT)
                for x in m.nodes.values()
            ), f"{m.config.name} sees a dead node despite all being up"
        await stop_all(nodes)

    run(main())


def test_push_pull_converges_without_gossip():
    async def main():
        def drop(payload, src, dst):
            return payload[0] in (
                wire.MessageType.SUSPECT,
                wire.MessageType.ALIVE,
                wire.MessageType.DEAD,
                wire.MessageType.COMPOUND,
            )

        net = InMemoryNetwork(drop_fn=drop)
        nodes = await make_cluster(net, 3)
        ok = await wait_until(
            lambda: all(len(m.members()) == 3 for m in nodes), timeout=50.0
        )
        assert ok, [len(m.members()) for m in nodes]
        await stop_all(nodes)

    run(main())


def test_stale_alive_does_not_clear_suspicion():
    async def main():
        net = InMemoryNetwork()
        nodes = await make_cluster(net, 3)
        assert await wait_until(
            lambda: all(len(m.members()) == 3 for m in nodes)
        )
        m0 = nodes[0]
        inc = m0.nodes["n1"].incarnation
        m0._suspect_node({"inc": inc, "node": "n1", "from": "n0"})
        assert m0.nodes["n1"].status == NodeStatus.SUSPECT
        m0._alive_node(
            {"name": "n1", "addr": "mem://n1", "inc": inc,
             "status": 0, "meta": b""}
        )
        assert m0.nodes["n1"].status == NodeStatus.SUSPECT
        await stop_all(nodes)

    run(main())


def test_late_joiner_sees_left_not_dead_via_push_pull():
    async def main():
        net = InMemoryNetwork()
        nodes = await make_cluster(net, 3)
        assert await wait_until(
            lambda: all(len(m.members()) == 3 for m in nodes)
        )
        await nodes[2].leave()
        await nodes[2].shutdown()
        assert await wait_until(
            lambda: nodes[0].nodes["n2"].status == NodeStatus.LEFT
        )
        t = net.new_transport("mem://n3")
        late = Memberlist(
            MemberlistConfig(name="n3", interval_scale=SCALE), t
        )
        await late.start()
        assert await late.join(["mem://n0"]) == 1
        await asyncio.sleep(1.0)
        n2 = late.nodes.get("n2")
        assert n2 is None or n2.status == NodeStatus.LEFT, n2
        assert {m.name for m in late.members()} == {"n0", "n1", "n3"}
        await stop_all(nodes[:2] + [late])

    run(main())


def test_udp_transport_smoke():
    async def main():
        from consul_tpu_torch.net import UDPTransport

        ts = []
        ms = []
        for i in range(3):
            t = UDPTransport("127.0.0.1", 0)
            await t.start()
            ts.append(t)
            m = Memberlist(
                MemberlistConfig(name=f"u{i}", interval_scale=SCALE), t
            )
            await m.start()
            ms.append(m)
        for m in ms[1:]:
            assert await m.join([ts[0].local_addr()]) == 1
        ok = await wait_until(
            lambda: all(len(m.members()) == 3 for m in ms), timeout=30.0
        )
        assert ok, [len(m.members()) for m in ms]
        await stop_all(ms)

    run(main())


# ---------------------------------------------------------------------------
# Parity of the deterministic parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_broadcast_queue_matches_reference(seed, monkeypatch):
    """One random queue / invalidate / get_broadcasts / reset sequence:
    the same payloads in the same order and the same notifications."""
    rng = np.random.default_rng(seed)
    # Both modules order ties by a process-wide counter; start both at 0.
    monkeypatch.setattr(j_queue, "_seq", itertools.count())
    monkeypatch.setattr(broadcast_queue, "_seq", itertools.count())
    size = {"n": 1}
    notified = {"j": [], "t": []}
    queues = {
        "j": j_queue.TransmitLimitedQueue(lambda: size["n"], 3),
        "t": broadcast_queue.TransmitLimitedQueue(lambda: size["n"], 3),
    }
    names = [None, "a", "b", "c", "d", "e"]
    drained = 0
    for step in range(400):
        op = rng.integers(0, 10)
        if op < 5:
            name = names[rng.integers(0, len(names))]
            payload = rng.bytes(int(rng.integers(1, 120)))
            for side, q in queues.items():
                q.queue(payload, name=name,
                        notify=lambda s=side, k=step: notified[s].append(k))
        elif op < 9:
            overhead = int(rng.integers(0, 4))
            limit = int(rng.integers(0, 600))
            got = {s: q.get_broadcasts(overhead, limit)
                   for s, q in queues.items()}
            assert got["t"] == got["j"], step
            drained += len(got["t"])
        elif rng.random() < 0.2:
            for q in queues.values():
                q.reset()
        else:
            size["n"] = int(rng.integers(1, 5000))
        assert len(queues["t"]) == len(queues["j"])
        assert notified["t"] == notified["j"], step
    assert drained > 0 and notified["t"]


def test_suspicion_timeouts_match_reference(monkeypatch):
    """The same remaining timeout after each confirmation, at a frozen
    clock, for random (k, min, max, health score, elapsed)."""
    rng = np.random.default_rng(5)
    clock = {"now": 100.0}
    fake = types.SimpleNamespace(monotonic=lambda: clock["now"])
    monkeypatch.setattr(j_suspicion, "time", fake)
    monkeypatch.setattr(suspicion, "time", fake)

    async def main():
        for _ in range(60):
            k = int(rng.integers(0, 6))
            min_s = float(rng.uniform(0.01, 2.0))
            max_s = float(min_s * rng.uniform(1.0, 6.0))
            score = int(rng.integers(0, 8))
            clock["now"] = 100.0
            pair = [mod.Suspicion("accuser", k, min_s, max_s, lambda n: None,
                                  health_score=score)
                    for mod in (j_suspicion, suspicion)]
            assert (pair[1].min_s, pair[1].max_s) == (pair[0].min_s,
                                                      pair[0].max_s)
            assert pair[1].remaining() == pair[0].remaining()
            for c in range(k + 2):
                clock["now"] += float(rng.uniform(0.0, 0.3))
                who = "accuser" if c == 1 else f"peer{c}"
                assert pair[1].confirm(who) == pair[0].confirm(who)
                assert pair[1].n == pair[0].n
                assert pair[1].remaining() == pair[0].remaining()
            for s in pair:
                s.stop()

    run(main())


def test_push_pull_scale_matches_reference():
    rng = np.random.default_rng(9)
    ns = list(range(0, 300)) + [int(x) for x in rng.integers(1, 10 ** 7, 200)]
    for n in ns:
        for interval in (30_000.0, 60_000.0, 15_000.0, 123.5):
            assert (push_pull_scale(interval, n)
                    == j_formulas.push_pull_scale(interval, n)), n


def _random_coord(rng, mod):
    return mod.Coordinate(
        vec=[float(x) for x in rng.normal(0.0, 0.02, mod.DIMENSIONALITY)],
        error=float(rng.uniform(0.05, 1.5)),
        adjustment=float(rng.normal(0.0, 0.001)),
        height=float(rng.uniform(1e-5, 0.01)),
    )


def test_vivaldi_client_matches_reference(monkeypatch):
    """The same peers and RTT samples give float-equal coordinates,
    coincident points (the pseudo-random direction) included."""
    monkeypatch.setattr(j_vivaldi, "_dir_state", 0x9E3779B9)
    monkeypatch.setattr(vivaldi, "_dir_state", 0x9E3779B9)
    clients = (j_vivaldi.VivaldiClient(), vivaldi.VivaldiClient())
    rng = np.random.default_rng(11)
    peers = [f"p{i}" for i in range(6)]
    for step in range(500):
        state = rng.bit_generator.state
        others = []
        for mod in (j_vivaldi, vivaldi):
            rng.bit_generator.state = state
            others.append(_random_coord(rng, mod))
        if step % 50 == 0:  # a peer at our own position
            others = [mod.Coordinate(vec=list(c.coord.vec))
                      for mod, c in zip((j_vivaldi, vivaldi), clients)]
        peer = peers[int(rng.integers(0, len(peers)))]
        rtt = float(rng.choice([0.0, -1.0, 1e-7])) if step % 97 == 0 \
            else float(rng.uniform(1e-4, 0.3))
        for c, o in zip(clients, others):
            c.update(peer, o, rtt)
        want, got = (c.get_coordinate() for c in clients)
        assert got.to_wire() == want.to_wire(), step
        assert got.distance_to(others[1]) == want.distance_to(others[0])
    assert vivaldi._dir_state == j_vivaldi._dir_state != 0x9E3779B9
    bad = vivaldi.Coordinate(vec=[0.0] * 3)
    assert not bad.is_valid()
    assert clients[1].update("x", bad, 0.1) is clients[1].coord


def test_keyring_bookkeeping_matches_reference():
    keys = [security.generate_key(n) for n in (16, 24, 32)]
    pair = (j_security.Keyring.from_b64(keys[0]),
            security.Keyring.from_b64(keys[0]))
    for op, arg in (("install", keys[1]), ("install", keys[2]),
                    ("use", keys[1]), ("remove", keys[0]),
                    ("install", keys[0])):
        for ring in pair:
            getattr(ring, op)(arg)
        assert pair[1].list_keys() == pair[0].list_keys()
        assert pair[1].primary_b64() == pair[0].primary_b64()
    with pytest.raises(ValueError):
        security.decode_key("AAAA")  # 3 bytes: no AES key size
    with pytest.raises(ValueError):
        pair[1].use(security.generate_key())  # not installed
    with pytest.raises(ValueError):
        pair[1].remove(pair[1].primary_b64())


@requires_crypto
def test_keyring_opens_what_the_reference_sealed():
    rng = np.random.default_rng(13)
    k1, k2 = security.generate_key(), security.generate_key(16)
    j_ring, t_ring = (j_security.Keyring.from_b64(k1),
                      security.Keyring.from_b64(k1))
    for ring in (j_ring, t_ring):
        ring.install(k2)
    for i in range(20):
        payload = rng.bytes(int(rng.integers(0, 1400)))
        if i == 10:
            for ring in (j_ring, t_ring):
                ring.use(k2)
        assert t_ring.decrypt(j_ring.encrypt(payload)) == payload
        assert j_ring.decrypt(t_ring.encrypt(payload)) == payload
    stranger = security.Keyring.from_b64(security.generate_key())
    with pytest.raises(security.SecurityError):
        stranger.decrypt(j_ring.encrypt(b"secret"))
    with pytest.raises(security.SecurityError):
        t_ring.decrypt(b"\x02" + bytes(40))


def test_missing_crypto_raises_security_error(monkeypatch):
    """Without ``cryptography`` sealing and opening raise a
    ``SecurityError`` (also a ``RuntimeError``, as the reference's); a
    memberlist drops such a packet and sends no plaintext."""
    import builtins

    real_import = builtins.__import__

    def no_crypto(name, *args, **kwargs):
        if name.startswith("cryptography"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_crypto)
    ring = security.Keyring.from_b64(security.generate_key())
    for call in (lambda: ring.encrypt(b"x"),
                 lambda: ring.decrypt(b"\x01" + bytes(12 + 16 + 4))):
        with pytest.raises(security.SecurityError):
            call()
        with pytest.raises(RuntimeError):
            call()

    sent = []

    class Recorder(Transport):
        def local_addr(self):
            return "mem://x"

        async def write_to(self, payload, addr):
            sent.append(payload)

        async def recv_packet(self):
            await asyncio.Event().wait()

        async def dial(self, addr, timeout):
            raise ConnectionError(addr)

        async def accept_stream(self):
            await asyncio.Event().wait()

        async def shutdown(self):
            pass

    async def main():
        m = Memberlist(MemberlistConfig(name="x", keyring=ring), Recorder())
        sealed = bytes([wire.MessageType.ENCRYPT, 1]) + bytes(40)
        assert m._open(sealed) is None
        with pytest.raises(security.SecurityError):
            await m._send_msg("mem://y", wire.MessageType.PING, {"seq": 1})
        assert sent == []

    run(main())


# ---------------------------------------------------------------------------
# What each package's memberlist puts on the wire
# ---------------------------------------------------------------------------


def _bodies(payload: bytes) -> list:
    """Every (type, body bytes) message of one packet, compound or not."""
    parts = (wire.split_compound(payload)
             if payload[0] == wire.MessageType.COMPOUND else [payload])
    return [(p[0], p[1:]) for p in parts]


async def _capture(net_cls, ml_cls, cfg_cls, steps_s: float) -> list:
    seen = []
    net = net_cls(drop_fn=lambda p, s, d: seen.append(p) and False)
    nodes = []
    for i in range(3):
        m = ml_cls(cfg_cls(name=f"w{i}", interval_scale=SCALE),
                   net.new_transport(f"mem://w{i}"))
        await m.start()
        nodes.append(m)
    for m in nodes[1:]:
        await m.join(["mem://w0"])
    await asyncio.sleep(steps_s / 2)
    await nodes[2].leave(timeout=1.0)
    await nodes[2].shutdown()
    nodes[0]._suspect_node({"inc": nodes[0].nodes["w1"].incarnation,
                            "node": "w1", "from": "w0"})
    await asyncio.sleep(steps_s / 2)
    for m in nodes[:2]:
        await m.shutdown()
    return seen


@pytest.mark.parametrize("side", ["port", "reference"])
def test_memberlist_packets_match_msgpack(side):
    """A cluster of three (joins, probes, gossip, a leave, a suspicion and
    its refutation): each body on its wire re-encodes byte for byte under
    both codecs, and each decodes the same."""
    if side == "port":
        args = (InMemoryNetwork, Memberlist, MemberlistConfig)
    else:
        args = (j_transport.InMemoryNetwork, j_memberlist.Memberlist,
                j_memberlist.MemberlistConfig)
    packets = run(_capture(*args, steps_s=1.0))
    types_seen = set()
    for payload in packets:
        for t, raw in _bodies(payload):
            types_seen.add(wire.MessageType(t))
            body = wire.unpackb(raw)
            assert body == msgpack.unpackb(raw, raw=False)
            assert wire.packb(body) == raw
            assert msgpack.packb(body, use_bin_type=True) == raw
    mt = wire.MessageType
    assert {mt.PING, mt.ACK_RESP, mt.ALIVE, mt.DEAD, mt.SUSPECT} <= types_seen
