"""The port's serf layer (``consul_tpu_torch.eventing``) on the CPU.

  * ``tests/test_eventing.py``'s seven tests, the snapshot, rejoin and
    reconnect cases of ``tests/test_resilience.py``, the keyring cases of
    ``tests/test_surface.py`` and the coalescing case of
    ``tests/test_connect.py``, against the port at ``interval_scale``
    0.02;
  * parity with the JAX package: ``LamportClock`` under one random
    sequence, every serf body and tag map a running cluster of each
    package writes (re-encoded byte for byte by both codecs), the
    push/pull state, and snapshot files (each side replays, and compacts
    to, what the other wrote);
  * interop over a real wire: a reference ``Cluster`` and a port
    ``Cluster``, each on its own package's ``UDPTransport`` on
    127.0.0.1, form one cluster, deliver each other's user events once,
    see a graceful leave as left and detect a crash.
"""

import asyncio
import dataclasses

import msgpack
import numpy as np
import pytest

from helpers import requires_crypto, wait_for, wait_until

from consul_tpu.eventing import cluster as j_cluster
from consul_tpu.eventing import lamport as j_lamport
from consul_tpu.eventing import snapshot as j_snapshot
from consul_tpu.net import transport as j_transport
from consul_tpu_torch.eventing import (
    Cluster,
    ClusterConfig,
    Coalescer,
    Event,
    EventType,
    LamportClock,
    Member,
    MemberStatus,
    Snapshotter,
)
from consul_tpu_torch.eventing import cluster as t_cluster
from consul_tpu_torch.net import InMemoryNetwork, UDPTransport, wire
from consul_tpu_torch.net.security import Keyring, generate_key
from consul_tpu_torch.protocol.profiles import LAN

SCALE = 0.02


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


async def make_cluster(net, n, tags=None, **kw):
    out = []
    for i in range(n):
        t = net.new_transport(f"mem://e{i}")
        c = Cluster(
            ClusterConfig(
                name=f"e{i}",
                tags=(tags or {}) | {"idx": str(i)},
                interval_scale=SCALE,
                **kw,
            ),
            t,
        )
        await c.start()
        out.append(c)
    for c in out[1:]:
        assert await c.join(["mem://e0"]) == 1
    return out


async def collect_events(cluster, etype, bucket):
    while True:
        ev = await cluster.events.get()
        if ev.type == etype:
            bucket.append(ev)


async def stop_all(cs):
    for c in cs:
        await c.shutdown()


# ---------------------------------------------------------------------------
# tests/test_eventing.py, against the port
# ---------------------------------------------------------------------------


class TestLamport:
    def test_witness_and_increment(self):
        c = LamportClock()
        assert c.time() == 0
        assert c.increment() == 1
        c.witness(41)
        assert c.time() == 42
        c.witness(10)
        assert c.time() == 42

    def test_matches_reference(self):
        rng = np.random.default_rng(3)
        start = int(rng.integers(0, 100))
        pair = (j_lamport.LamportClock(start), LamportClock(start))
        for _ in range(2000):
            if rng.random() < 0.5:
                got = [c.increment() for c in pair]
            else:
                v = int(rng.integers(0, 3000))
                got = [c.witness(v) for c in pair]
            assert got[1] == got[0]
            assert pair[1].time() == pair[0].time()


def test_user_event_reaches_all_members_once():
    async def main():
        net = InMemoryNetwork()
        cs = await make_cluster(net, 4)
        assert await wait_until(
            lambda: all(len(c.alive_members()) == 4 for c in cs)
        )
        buckets = {c.config.name: [] for c in cs}
        tasks = [
            asyncio.create_task(
                collect_events(c, EventType.USER, buckets[c.config.name])
            )
            for c in cs
        ]
        await cs[0].user_event("deploy", b"v1.2.3")
        ok = await wait_until(
            lambda: all(len(b) >= 1 for b in buckets.values()), timeout=30.0
        )
        assert ok, {k: len(v) for k, v in buckets.items()}
        await asyncio.sleep(1.0)
        for name, b in buckets.items():
            assert len(b) == 1, f"{name} saw {len(b)} copies"
            assert b[0].name == "deploy" and b[0].payload == b"v1.2.3"
        for t in tasks:
            t.cancel()
        await stop_all(cs)

    run(main())


def test_event_size_limit_enforced():
    async def main():
        net = InMemoryNetwork()
        cs = await make_cluster(net, 1)
        with pytest.raises(ValueError):
            await cs[0].user_event("x", b"y" * 600)
        await stop_all(cs)

    run(main())


def test_profile_sets_serf_buffers_and_event_limit():
    """The serf fields of ``GossipProfile`` are the ones ``Cluster`` uses:
    a larger ``max_user_event_size`` lets a 600-byte event through, and
    the dedup rings take the profile's lengths."""
    profile = dataclasses.replace(
        LAN, max_user_event_size=1024, event_buffer_size=8,
        query_buffer_size=16,
    )

    async def main():
        net = InMemoryNetwork()
        cs = await make_cluster(net, 2, profile=profile)
        assert await wait_until(
            lambda: all(len(c.alive_members()) == 2 for c in cs)
        )
        assert [len(c._event_buffer) for c in cs] == [8, 8]
        assert [len(c._query_buffer) for c in cs] == [16, 16]
        got = []
        task = asyncio.create_task(collect_events(cs[1], EventType.USER, got))
        await cs[0].user_event("x", b"y" * 600)
        assert await wait_until(lambda: len(got) == 1, timeout=30.0)
        assert got[0].payload == b"y" * 600
        with pytest.raises(ValueError, match="1024 byte limit"):
            await cs[0].user_event("x", b"y" * 1024)
        task.cancel()
        await stop_all(cs)

    run(main())


def test_query_collects_responses():
    async def main():
        net = InMemoryNetwork()
        cs = await make_cluster(net, 3)
        assert await wait_until(
            lambda: all(len(c.alive_members()) == 3 for c in cs)
        )

        async def responder(c):
            while True:
                ev = await c.events.get()
                if ev.type == EventType.QUERY and ev.name == "whoami":
                    await ev.query.respond(c.config.name.encode())

        tasks = [asyncio.create_task(responder(c)) for c in cs[1:]]
        result = await cs[0].query("whoami", b"", timeout_s=5.0, want_ack=True)
        names = {a[0] for a in result.responses}
        assert names == {"e1", "e2"}, names
        assert set(result.acks) == {"e1", "e2"}, result.acks
        for t in tasks:
            t.cancel()
        await stop_all(cs)

    run(main())


def test_tags_visible_on_members():
    async def main():
        net = InMemoryNetwork()
        cs = await make_cluster(net, 3, tags={"role": "server"})
        assert await wait_until(
            lambda: all(len(c.alive_members()) == 3 for c in cs)
        )
        for c in cs:
            for m in c.alive_members():
                assert m.tags["role"] == "server"
                assert m.tags["idx"] in {"0", "1", "2"}
        await stop_all(cs)

    run(main())


def test_graceful_leave_emits_member_leave_not_failed():
    async def main():
        net = InMemoryNetwork()
        cs = await make_cluster(net, 3)
        assert await wait_until(
            lambda: all(len(c.alive_members()) == 3 for c in cs)
        )
        leaves, fails = [], []
        t1 = asyncio.create_task(
            collect_events(cs[0], EventType.MEMBER_LEAVE, leaves)
        )
        t2 = asyncio.create_task(
            collect_events(cs[0], EventType.MEMBER_FAILED, fails)
        )
        await cs[2].leave()
        await cs[2].shutdown()
        ok = await wait_until(lambda: len(leaves) >= 1, timeout=30.0)
        assert ok
        assert not fails, "graceful leave must not be reported as a failure"
        assert cs[0].members["e2"].status == MemberStatus.LEFT
        t1.cancel()
        t2.cancel()
        await stop_all(cs[:2])

    run(main())


def test_event_convergence_via_push_pull_backstop():
    async def main():
        def drop(payload, src, dst):
            return payload[0] in (
                wire.MessageType.USER,
                wire.MessageType.COMPOUND,
            )

        net = InMemoryNetwork(drop_fn=drop)
        cs = await make_cluster(net, 2)
        assert await wait_until(
            lambda: all(len(c.alive_members()) == 2 for c in cs)
        )
        bucket = []
        t = asyncio.create_task(collect_events(cs[1], EventType.USER, bucket))
        await cs[0].user_event("quiet", b"payload")
        ok = await wait_until(lambda: len(bucket) >= 1, timeout=30.0)
        assert ok, "event did not converge via push/pull"
        t.cancel()
        await stop_all(cs)

    run(main())


# ---------------------------------------------------------------------------
# tests/test_resilience.py: snapshots, rejoin, reconnect
# ---------------------------------------------------------------------------


def test_snapshot_replay_and_compact(tmp_path):
    path = tmp_path / "serf.snapshot"
    s = Snapshotter(path)
    s.alive("a", "mem://a")
    s.alive("b", "mem://b")
    s.not_alive("a")
    s.update_clock(5, 9, 2)
    s.close()

    s2 = Snapshotter(path)
    prev = s2.replay()
    assert prev.alive == {"b": "mem://b"}
    assert (prev.clock, prev.event_clock, prev.query_clock) == (5, 9, 2)
    assert not prev.left

    s2.compact()
    text = path.read_text()
    assert "not-alive" not in text and "alive: b: mem://b" in text
    s2.close()


def test_snapshot_leave_marker_blocks_rejoin(tmp_path):
    path = tmp_path / "serf.snapshot"
    s = Snapshotter(path)
    s.alive("a", "mem://a")
    s.leave()
    s.close()
    prev = Snapshotter(path).replay()
    assert prev.left and prev.alive == {}


async def make_serf(net, name, tmp_path=None, **kw):
    kw.setdefault("reconnect_interval_s", 5.0)
    c = Cluster(
        ClusterConfig(
            name=name,
            interval_scale=SCALE,
            snapshot_path=str(tmp_path / f"{name}.snap") if tmp_path else None,
            **kw,
        ),
        net.new_transport(f"mem://{name}"),
    )
    await c.start()
    return c


class TestGossipRecovery:
    async def test_restart_rejoins_from_snapshot(self, tmp_path):
        net = InMemoryNetwork()
        c1 = await make_serf(net, "n1", tmp_path)
        c2 = await make_serf(net, "n2", tmp_path)
        c3 = await make_serf(net, "n3", tmp_path)
        await c2.join(["mem://n1"])
        await c3.join(["mem://n1"])
        await wait_for(
            lambda: all(len(c.alive_members()) == 3 for c in (c1, c2, c3)),
            msg="3-node serf cluster",
        )
        await c3.shutdown()
        c3b = await make_serf(net, "n3", tmp_path)
        assert c3b.previous is not None and c3b.previous.alive
        n = await c3b.auto_rejoin()
        assert n >= 1
        await wait_for(
            lambda: len(c3b.alive_members()) == 3,
            msg="restarted node sees everyone",
        )
        assert c3b.event_clock.time() >= 1
        await c1.shutdown()
        await c2.shutdown()
        await c3b.shutdown()

    async def test_graceful_leave_blocks_auto_rejoin(self, tmp_path):
        net = InMemoryNetwork()
        c1 = await make_serf(net, "m1", tmp_path)
        c2 = await make_serf(net, "m2", tmp_path)
        await c2.join(["mem://m1"])
        await wait_for(lambda: len(c2.alive_members()) == 2, msg="joined")
        await c2.leave()
        await c2.shutdown()
        c2b = await make_serf(net, "m2", tmp_path)
        assert await c2b.auto_rejoin() == 0
        await c1.shutdown()
        await c2b.shutdown()

    async def test_reconnect_loop_recovers_failed_member(self, tmp_path):
        net = InMemoryNetwork()
        c1 = await make_serf(net, "r1", None, reconnect_interval_s=3.0)
        c2 = await make_serf(net, "r2", None, reconnect_interval_s=3.0)
        await c2.join(["mem://r1"])
        await wait_for(lambda: len(c1.alive_members()) == 2, msg="joined")
        await c2.shutdown()
        await wait_for(
            lambda: c1.members["r2"].status == MemberStatus.FAILED,
            timeout=30,
            msg="r2 marked failed",
        )
        c2b = await make_serf(net, "r2", None, reconnect_interval_s=3.0)
        await wait_for(
            lambda: c1.members["r2"].status == MemberStatus.ALIVE
            and len(c2b.alive_members()) == 2,
            timeout=30,
            msg="reconnect loop recovered r2",
        )
        await c1.shutdown()
        await c2b.shutdown()


def _snapshot_ops(rng, s) -> None:
    """One random sequence of snapshot appends (names with ': ' inside
    and IPv6-like addresses included)."""
    names = ["a", "b", "c", "node: x", "dc1-srv"]
    clocks = [0, 0, 0]
    for _ in range(60):
        op = int(rng.integers(0, 5))
        name = names[int(rng.integers(0, len(names)))]
        if op < 2:
            s.alive(name, f"[::1]:{int(rng.integers(1, 65535))}")
        elif op == 2:
            s.not_alive(name)
        elif op == 3:
            clocks = [c + int(rng.integers(-2, 5)) for c in clocks]
            s.update_clock(*clocks)
        elif rng.random() < 0.1:
            s.leave()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_files_interchange(tmp_path, writer):
    """The same appends give the same file; each package replays the
    other's file to the same previous state and compacts it to the same
    text."""
    rng = np.random.default_rng(21 if writer == "port" else 22)
    state = rng.bit_generator.state
    paths = {}
    for side, cls in (("port", Snapshotter),
                      ("reference", j_snapshot.Snapshotter)):
        rng.bit_generator.state = state
        paths[side] = tmp_path / f"{side}.snap"
        s = cls(paths[side])
        _snapshot_ops(rng, s)
        s.close()
    assert paths["port"].read_text() == paths["reference"].read_text()
    src = paths[writer]
    readers = {"port": Snapshotter(src), "reference": j_snapshot.Snapshotter(
        src)}
    prev = {side: r.replay() for side, r in readers.items()}
    fields = ("alive", "clock", "event_clock", "query_clock", "left")
    assert ([getattr(prev["port"], f) for f in fields]
            == [getattr(prev["reference"], f) for f in fields])
    texts = {}
    for side, r in readers.items():
        copy = tmp_path / f"compact-{side}.snap"
        copy.write_text(src.read_text())
        r.path = copy
        r.compact()
        r.close()
        texts[side] = copy.read_text()
    assert texts["port"] == texts["reference"]


# ---------------------------------------------------------------------------
# tests/test_surface.py: gossip encryption and the keyring
# ---------------------------------------------------------------------------


@requires_crypto
def test_keyring_seal_open_and_rotation():
    from consul_tpu_torch.net.security import SecurityError

    k1, k2 = generate_key(), generate_key()
    ring = Keyring.from_b64(k1)
    blob = ring.encrypt(b"gossip payload")
    assert blob != b"gossip payload"
    assert ring.decrypt(blob) == b"gossip payload"

    ring.install(k2)
    old_ct = ring.encrypt(b"before switch")
    ring.use(k2)
    assert ring.decrypt(old_ct) == b"before switch"
    assert ring.primary_b64() == k2
    with pytest.raises(ValueError):
        ring.remove(k2)
    ring.remove(k1)
    with pytest.raises(SecurityError):
        ring.decrypt(old_ct)

    stranger = Keyring.from_b64(generate_key())
    with pytest.raises(SecurityError):
        stranger.decrypt(ring.encrypt(b"secret"))


@requires_crypto
def test_encrypted_cluster_forms_and_rejects_plaintext():
    async def main():
        key = generate_key()
        net = InMemoryNetwork()

        def mk(name, keyring):
            return Cluster(
                ClusterConfig(name=name, interval_scale=0.02,
                              keyring=keyring),
                net.new_transport(f"mem://{name}"),
            )

        c1 = mk("e1", Keyring.from_b64(key))
        c2 = mk("e2", Keyring.from_b64(key))
        intruder = mk("e3", None)
        for c in (c1, c2, intruder):
            await c.start()
        assert await c2.join(["mem://e1"]) == 1
        await wait_for(
            lambda: len(c1.alive_members()) == 2
            and len(c2.alive_members()) == 2,
            msg="encrypted pair converges",
        )
        assert await intruder.join(["mem://e1"]) == 0
        assert len(intruder.alive_members()) == 1
        for c in (c1, c2, intruder):
            await c.shutdown()

    run(main())


@requires_crypto
def test_cluster_wide_key_rotation_via_queries():
    async def main():
        k1, k2 = generate_key(), generate_key()
        net = InMemoryNetwork()
        nodes = [
            Cluster(
                ClusterConfig(name=f"k{i}", interval_scale=0.02,
                              keyring=Keyring.from_b64(k1)),
                net.new_transport(f"mem://k{i}"),
            )
            for i in range(3)
        ]
        for c in nodes:
            await c.start()
        for c in nodes[1:]:
            await c.join(["mem://k0"])
        await wait_for(
            lambda: all(len(c.alive_members()) == 3 for c in nodes),
            msg="encrypted trio",
        )
        out = await nodes[0].install_key(k2)
        assert not out["errors"] and out["num_resp"] >= 2
        out = await nodes[0].use_key(k2)
        assert not out["errors"]
        out = await nodes[0].remove_key(k1)
        assert not out["errors"]
        out = await nodes[0].list_keys()
        assert set(out["keys"]) == {k2}
        await nodes[0].user_event("rotated", b"ok")
        for c in nodes:
            await c.shutdown()

    run(main())


# ---------------------------------------------------------------------------
# Coalescing (tests/test_connect.py's case, and the flush rule)
# ---------------------------------------------------------------------------


def test_member_events_coalesce():
    async def main():
        net = InMemoryNetwork()
        events = []
        c1 = Cluster(
            ClusterConfig(name="c1", interval_scale=0.02,
                          coalesce_period_s=10.0,
                          on_event=lambda ev: events.append(ev)),
            net.new_transport("mem://c1"),
        )
        await c1.start()
        others = []
        for i in range(4):
            c = Cluster(ClusterConfig(name=f"m{i}", interval_scale=0.02),
                        net.new_transport(f"mem://m{i}"))
            await c.start()
            await c.join(["mem://c1"])
            others.append(c)
        await wait_for(
            lambda: sum(
                len(e.members)
                for e in events
                if e.type == EventType.MEMBER_JOIN
            ) >= 5,
            msg="all joins delivered (coalesced)",
        )
        join_events = [e for e in events if e.type == EventType.MEMBER_JOIN]
        total_members = sum(len(e.members) for e in join_events)
        assert total_members >= 5
        assert len(join_events) < total_members
        for c in [c1] + others:
            await c.shutdown()

    run(main())


def test_coalescer_keeps_the_latest_state():
    async def main():
        out = []
        co = Coalescer(out.append, coalesce_s=0.05, quiescent_s=0.02)

        def member(name):
            return Member(name=name, addr=f"mem://{name}", tags={},
                          status=MemberStatus.ALIVE)

        a, b = member("a"), member("b")
        assert co.handle(Event(type=EventType.MEMBER_JOIN, members=[a, b]))
        assert co.handle(Event(type=EventType.MEMBER_FAILED, members=[a]))
        assert co.handle(Event(type=EventType.USER, name="x", payload=b"1"))
        assert co.handle(Event(type=EventType.USER, name="x", payload=b"2"))
        assert not co.handle(Event(type=EventType.QUERY, name="q"))
        assert out == []
        await asyncio.sleep(0.2)
        assert [(e.type, [m.name for m in e.members], e.payload)
                for e in out] == [
            (EventType.MEMBER_JOIN, ["b"], b""),
            (EventType.MEMBER_FAILED, ["a"], b""),
            (EventType.USER, [], b"2"),
        ]
        co.stop()

    run(main())


# ---------------------------------------------------------------------------
# Serf bodies on the wire
# ---------------------------------------------------------------------------


def _serf_messages(payload: bytes) -> list:
    """Every serf message (type byte, body bytes) inside one packet:
    memberlist USER bodies, and the messages relays carry inside."""
    parts = (wire.split_compound(payload)
             if payload[0] == wire.MessageType.COMPOUND else [payload])
    out = []
    for part in parts:
        if part[0] != wire.MessageType.USER:
            continue
        inner = wire.unpackb(part[1:])
        out.append((inner[0], inner[1:]))
        if inner[0] == t_cluster.SerfMessageType.RELAY:
            relayed = wire.unpackb(inner[1:])["payload"]
            out.append((relayed[0], relayed[1:]))
    return out


def _same_codec(raw: bytes):
    body = wire.unpackb(raw)
    assert body == msgpack.unpackb(raw, raw=False)
    assert wire.packb(body) == raw
    assert msgpack.packb(body, use_bin_type=True) == raw
    return body


async def _serf_traffic(pkg) -> tuple:
    """A cluster of three of one package: joins, tags, a user event, a
    query with acks, responses and relays, an internal key query (no
    keyring: its error reply), a leave; returns (packets, local states)."""
    mod, net_cls = pkg
    seen = []
    net = net_cls(drop_fn=lambda p, s, d: seen.append(p) and False)
    cs = []
    for i in range(3):
        c = mod.Cluster(mod.ClusterConfig(
            name=f"s{i}", interval_scale=SCALE,
            tags={"role": "server", "dc": "dc1", "idx": str(i),
                  "é": "ü" * 40}), net.new_transport(f"mem://s{i}"))
        await c.start()
        cs.append(c)
    for c in cs[1:]:
        await c.join(["mem://s0"])
    await asyncio.sleep(0.3)

    async def responder(c):
        while True:
            ev = await c.events.get()
            if ev.type == mod.EventType.QUERY:
                await ev.query.respond(b"\x00\xff" + c.config.name.encode())

    tasks = [asyncio.create_task(responder(c)) for c in cs[1:]]
    await cs[0].user_event("deploy", b"\x01" * 100)
    await cs[0].query("whoami", b"q", timeout_s=0.3, want_ack=True,
                      relay_factor=2)
    await cs[0].list_keys()
    states = [c._local_state(False) for c in cs]
    await cs[2].leave()
    await asyncio.sleep(0.2)
    for t in tasks:
        t.cancel()
    await stop_all(cs)
    return seen, states


@pytest.mark.parametrize("side", ["port", "reference"])
def test_serf_bodies_match_msgpack(side):
    pkg = ((t_cluster, InMemoryNetwork) if side == "port"
           else (j_cluster, j_transport.InMemoryNetwork))
    packets, states = run(_serf_traffic(pkg))
    kinds = set()
    for payload in packets:
        for t, raw in _serf_messages(payload):
            kinds.add(t_cluster.SerfMessageType(t))
            _same_codec(raw)
    st = t_cluster.SerfMessageType
    assert {st.JOIN, st.LEAVE, st.USER_EVENT, st.QUERY, st.QUERY_RESPONSE,
            st.RELAY} <= kinds, kinds
    for raw in states:
        body = _same_codec(raw)
        assert body["events"] and body["status_ltimes"]
    # Merged by the other package's Cluster without error.
    other = j_cluster if side == "port" else t_cluster
    net = (j_transport.InMemoryNetwork() if side == "port"
           else InMemoryNetwork())
    sink = other.Cluster(other.ClusterConfig(name="sink"),
                         net.new_transport("mem://sink"))
    for raw in states:
        sink._merge_remote_state(raw, False)
    assert sink.event_clock.time() >= 2


def test_tag_maps_and_intents_match_reference():
    rng = np.random.default_rng(17)
    for i in range(50):
        tags = {f"k{j}" * int(rng.integers(1, 12)):
                "v" * int(rng.integers(0, 300))
                for j in range(int(rng.integers(0, 20)))}
        raw = t_cluster.encode_tags(tags)
        assert raw == j_cluster.encode_tags(tags)
        assert t_cluster.decode_tags(raw) == j_cluster.decode_tags(raw) == tags
    for bad in (b"", b"\xc1", b"\x93\x01\x02\x03", b"\x81\x01\x02"):
        assert t_cluster.decode_tags(bad) == j_cluster.decode_tags(bad)
    bodies = [
        {"ltime": 2 ** 40, "node": "n", "prune": False},
        {"ltime": 7, "id": 3, "addr": "127.0.0.1:8301", "node": "n",
         "flags": 1, "relay_factor": 0, "name": "_serf_list-keys",
         "payload": b""},
        {"result": False, "error": "encryption is not enabled", "keys": []},
        {"dest_addr": "[::1]:1", "payload": bytes(range(256)) * 300},
    ]
    for body in bodies:
        _same_codec(msgpack.packb(body, use_bin_type=True))


# ---------------------------------------------------------------------------
# Interop over UDP/TCP on 127.0.0.1
# ---------------------------------------------------------------------------


def test_reference_and_port_clusters_interoperate():
    from consul_tpu.net.transport import UDPTransport as JUDPTransport

    async def main():
        pair = {}
        for side, mod, transport_cls in (
                ("ref", j_cluster, JUDPTransport),
                ("port", t_cluster, UDPTransport),
                ("port2", t_cluster, UDPTransport)):
            t = transport_cls("127.0.0.1", 0)
            await t.start()
            c = mod.Cluster(mod.ClusterConfig(
                name=side, interval_scale=SCALE,
                tags={"pkg": side}), t)
            await c.start()
            pair[side] = c
        ref, port, port2 = pair["ref"], pair["port"], pair["port2"]
        addr = ref.memberlist.transport.local_addr()
        assert await port.join([addr]) == 1
        assert await port2.join([addr]) == 1
        await wait_for(lambda: all(len(c.alive_members()) == 3
                                   for c in pair.values()),
                       timeout=20, msg="mixed cluster of three")
        assert ref.members["port"].tags == {"pkg": "port"}
        assert port.members["ref"].tags == {"pkg": "ref"}

        got = {side: [] for side in pair}
        for side, c in pair.items():
            # Both packages' EventType.USER is the int 5.
            c.config.on_event = (lambda ev, s=side: got[s].append(ev.name)
                                 if ev.type == EventType.USER else None)
        await ref.user_event("from-ref", b"1")
        await port.user_event("from-port", b"2")
        await wait_for(lambda: all(sorted(g) == ["from-port", "from-ref"]
                                   for g in got.values()),
                       timeout=20, msg="each event everywhere")
        await asyncio.sleep(0.5)  # duplicates would surface here
        assert all(sorted(g) == ["from-port", "from-ref"]
                   for g in got.values()), got

        await port2.leave()
        await port2.shutdown()
        await wait_for(lambda: ref.members["port2"].status == MemberStatus.LEFT
                       and port.members["port2"].status == MemberStatus.LEFT,
                       timeout=20, msg="port2 left")
        await ref.shutdown()  # a crash: no leave
        await wait_for(
            lambda: port.members["ref"].status == MemberStatus.FAILED,
            timeout=30, msg="the reference's crash detected by the port")
        await port.shutdown()

    run(main(), timeout=90)


def test_port_detects_reference_leave_and_reference_detects_port_crash():
    from consul_tpu.net.transport import UDPTransport as JUDPTransport

    async def main():
        t_ref, t_port = JUDPTransport("127.0.0.1", 0), UDPTransport(
            "127.0.0.1", 0)
        await t_ref.start()
        await t_port.start()
        ref = j_cluster.Cluster(j_cluster.ClusterConfig(
            name="ref", interval_scale=SCALE), t_ref)
        ref2 = j_cluster.Cluster(j_cluster.ClusterConfig(
            name="ref2", interval_scale=SCALE), JUDPTransport("127.0.0.1", 0))
        await ref2.memberlist.transport.start()
        port = Cluster(ClusterConfig(name="port", interval_scale=SCALE),
                       t_port)
        for c in (ref, ref2, port):
            await c.start()
        assert await ref.join([t_port.local_addr()]) == 1
        assert await ref2.join([t_port.local_addr()]) == 1
        await wait_for(lambda: len(port.alive_members()) == 3
                       and len(ref.alive_members()) == 3,
                       timeout=20, msg="joined")
        await ref2.leave()
        await ref2.shutdown()
        await wait_for(lambda: port.members["ref2"].status == MemberStatus.LEFT,
                       timeout=20, msg="the reference's leave seen as left")
        await port.shutdown()
        await wait_for(
            lambda: ref.members["port"].status
            == j_cluster.MemberStatus.FAILED,
            timeout=30, msg="the port's crash detected by the reference")
        await ref.shutdown()

    run(main(), timeout=90)
