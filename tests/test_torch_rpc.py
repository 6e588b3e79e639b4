"""The port's RPC layer (``consul_tpu_torch.agent.rpc``) beside the JAX
package's, on the CPU.

The thirteen scenarios of ``tests/test_rpc.py`` run against both packages
through one parametrised fixture: snake-case method names, muxed calls on
one connection, remote errors, the raft mux byte, a timed-out call that
keeps its connection, a server that dies under a pending call, the
blocking query's rules (no wait at index 0, a write wakes it, a timeout
returns the old index, the index floor of 1, a store swap wakes it) and
the credit window of a server-streaming call.

Beside them, the port's frames against the C ``msgpack`` codec: a seeded
set of request and reply bodies of the endpoints' shapes must pack to the
bytes ``msgpack.packb(..., use_bin_type=True)`` gives and read back as
``msgpack.unpackb(..., raw=False, strict_map_key=False)`` reads them.
"""

import asyncio
import random
import types

import msgpack
import pytest

from consul_tpu.agent import rpc as j_rpc
from consul_tpu.net import transport as j_transport
from consul_tpu.store import state as j_state
from consul_tpu_torch.agent import rpc as t_rpc
from consul_tpu_torch.net import transport as t_transport
from consul_tpu_torch.store import state as t_state

PACKAGES = {
    "jax": types.SimpleNamespace(rpc=j_rpc, net=j_transport, state=j_state),
    "torch": types.SimpleNamespace(rpc=t_rpc, net=t_transport, state=t_state),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class Echo:
    async def say(self, body):
        return {"echo": body["msg"]}

    async def slow(self, body):
        await asyncio.sleep(body["delay"])
        return {"done": body["delay"]}

    async def boom(self, body):
        raise ValueError("kaboom")


async def start_server(pkg, net, name="srv"):
    t = net.new_transport(name)
    srv = pkg.rpc.RPCServer(t)
    srv.register("Echo", Echo())
    await srv.start()
    return srv, t


def test_snake_names(pkg):
    snake = pkg.rpc.snake
    assert snake("Apply") == "apply"
    assert snake("ServiceNodes") == "service_nodes"
    assert snake("ListKeys") == "list_keys"
    assert snake("RPCAddr") == "rpc_addr"


class TestMuxedRPC:
    async def test_call_roundtrip(self, pkg):
        net = pkg.net.InMemoryNetwork()
        srv, _ = await start_server(pkg, net)
        client = pkg.rpc.RPCClient(net.new_transport("cli"))
        out = await client.call("srv", "Echo.Say", {"msg": "hi"})
        assert out == {"echo": "hi"}
        await client.shutdown()
        await srv.shutdown()

    async def test_concurrent_calls_one_conn(self, pkg):
        net = pkg.net.InMemoryNetwork()
        srv, _ = await start_server(pkg, net)
        client = pkg.rpc.RPCClient(net.new_transport("cli"))
        # The slow call is issued first but must not block the fast one:
        # requests are multiplexed by seq on a single stream.
        slow = asyncio.create_task(
            client.call("srv", "Echo.Slow", {"delay": 0.2})
        )
        fast = await client.call("srv", "Echo.Say", {"msg": "fast"})
        assert fast == {"echo": "fast"}
        assert not slow.done()
        assert await slow == {"done": 0.2}
        assert len(client._conns) == 1
        await client.shutdown()
        await srv.shutdown()

    async def test_remote_error(self, pkg):
        net = pkg.net.InMemoryNetwork()
        srv, _ = await start_server(pkg, net)
        client = pkg.rpc.RPCClient(net.new_transport("cli"))
        with pytest.raises(pkg.rpc.RPCError, match="kaboom"):
            await client.call("srv", "Echo.Boom", {})
        with pytest.raises(pkg.rpc.RPCError, match="can't find method"):
            await client.call("srv", "Echo.Nope", {})
        with pytest.raises(pkg.rpc.RPCError, match="can't find method"):
            await client.call("srv", "Ghost.Say", {})
        await client.shutdown()
        await srv.shutdown()

    async def test_raft_mux_byte(self, pkg):
        net = pkg.net.InMemoryNetwork()
        srv, _ = await start_server(pkg, net)
        seen = []

        async def raft_handler(method, body):
            seen.append(method)
            return {"term": 7}

        srv.bind_raft(raft_handler)
        raft_client = pkg.rpc.RPCClient(net.new_transport("peer"),
                                        rpc_type=pkg.rpc.RPC_RAFT)
        out = await raft_client.call("srv", "AppendEntries", {"term": 7})
        assert out == {"term": 7} and seen == ["AppendEntries"]
        await raft_client.shutdown()
        await srv.shutdown()

    async def test_call_timeout_keeps_connection(self, pkg):
        # A timed-out long-poll must not tear down the shared muxed conn
        # (other in-flight calls keep going).
        net = pkg.net.InMemoryNetwork()
        srv, _ = await start_server(pkg, net)
        client = pkg.rpc.RPCClient(net.new_transport("cli"))
        inflight = asyncio.create_task(
            client.call("srv", "Echo.Slow", {"delay": 0.3})
        )
        with pytest.raises(asyncio.TimeoutError):
            await client.call("srv", "Echo.Slow", {"delay": 5}, timeout=0.1)
        assert await inflight == {"done": 0.3}
        assert await client.call("srv", "Echo.Say", {"msg": "alive"}) == {
            "echo": "alive"
        }
        await client.shutdown()
        await srv.shutdown()

    async def test_server_death_fails_pending(self, pkg):
        net = pkg.net.InMemoryNetwork()
        srv, t = await start_server(pkg, net)
        client = pkg.rpc.RPCClient(net.new_transport("cli"))
        await client.call("srv", "Echo.Say", {"msg": "warm"})
        task = asyncio.create_task(
            client.call("srv", "Echo.Slow", {"delay": 5}, timeout=1.0)
        )
        await asyncio.sleep(0.05)
        await srv.shutdown()
        await t.shutdown()
        with pytest.raises((ConnectionError, asyncio.TimeoutError)):
            await task
        await client.shutdown()


def _kv_store(pkg):
    store = pkg.state.StateStore()
    store.kv_set(3, {"key": "a", "value": b"1"})
    return store, lambda ws: store.kv_get("a", ws=ws)


class TestBlockingQuery:
    async def test_nonblocking_when_index_zero(self, pkg):
        store, run = _kv_store(pkg)
        meta, rec = await pkg.rpc.blocking_query(
            store, pkg.rpc.QueryOptions(), run)
        assert meta.index == 3 and rec["value"] == b"1"

    async def test_write_wakes_blocked_reader(self, pkg):
        store, run = _kv_store(pkg)
        opts = pkg.rpc.QueryOptions(min_query_index=3, max_query_time=5)
        task = asyncio.create_task(pkg.rpc.blocking_query(store, opts, run))
        await asyncio.sleep(0.05)
        assert not task.done()
        store.kv_set(4, {"key": "a", "value": b"2"})
        meta, rec = await asyncio.wait_for(task, 2)
        assert meta.index == 4 and rec["value"] == b"2"

    async def test_timeout_returns_unchanged_index(self, pkg):
        store, run = _kv_store(pkg)
        opts = pkg.rpc.QueryOptions(min_query_index=3, max_query_time=0.1)
        meta, _ = await asyncio.wait_for(
            pkg.rpc.blocking_query(store, opts, run), 2)
        assert meta.index == 3

    async def test_index_floor_is_one(self, pkg):
        store = pkg.state.StateStore()

        def run(ws):
            return store.kv_get("missing", ws=ws)

        meta, rec = await pkg.rpc.blocking_query(
            store, pkg.rpc.QueryOptions(), run)
        assert meta.index == 1 and rec is None

    async def test_store_abandon_wakes_reader(self, pkg):
        store, run = _kv_store(pkg)
        opts = pkg.rpc.QueryOptions(min_query_index=3, max_query_time=5)
        task = asyncio.create_task(pkg.rpc.blocking_query(store, opts, run))
        await asyncio.sleep(0.05)
        store.abandon()  # snapshot restore path
        meta, _ = await asyncio.wait_for(task, 2)
        assert meta.index == 3


class TestStreamFlowControl:
    async def test_producer_stalls_at_window_until_client_consumes(
        self, pkg
    ):
        """yamux-style credit window: a server-streaming producer must
        stop at STREAM_WINDOW unconsumed frames instead of buffering
        without bound, and resume as the client's application drains."""
        window = pkg.rpc.STREAM_WINDOW
        produced = []

        class Feed:
            async def subscribe(self, body):
                i = 0
                while True:
                    produced.append(i)
                    yield {"i": i}
                    i += 1

        net = pkg.net.InMemoryNetwork()
        t = net.new_transport("feed-srv")
        srv = pkg.rpc.RPCServer(t)
        srv.register("Feed", Feed())
        await srv.start()
        client = pkg.rpc.RPCClient(net.new_transport("feed-cli"))

        gen = client.stream("feed-srv", "Feed.Subscribe", {})
        # Consume ONE item, then stop consuming entirely.
        first = await asyncio.wait_for(gen.__anext__(), 5)
        assert first == {"i": 0}
        await asyncio.sleep(0.3)
        # The producer ran ahead by at most the window (+ a small queue
        # in flight), NOT unboundedly.
        assert len(produced) <= window + 2, produced[-1]

        # Draining the stream grants credit and the producer resumes.
        for _ in range(window * 2):
            await asyncio.wait_for(gen.__anext__(), 5)
        await asyncio.sleep(0.1)
        assert len(produced) > window
        await gen.aclose()
        await client.shutdown()
        await srv.shutdown()


def test_flow_control_constants_match():
    assert (t_rpc.STREAM_WINDOW, t_rpc.SESSION_WINDOW) == (
        j_rpc.STREAM_WINDOW, j_rpc.SESSION_WINDOW)
    assert (t_rpc.RPC_CONSUL, t_rpc.RPC_RAFT, t_rpc.RPC_MULTIPLEX_V2,
            t_rpc.RPC_SNAPSHOT) == (j_rpc.RPC_CONSUL, j_rpc.RPC_RAFT,
                                    j_rpc.RPC_MULTIPLEX_V2,
                                    j_rpc.RPC_SNAPSHOT)


# ---------------------------------------------------------------------------
# frames against the C msgpack codec
# ---------------------------------------------------------------------------

METHODS = ("KVS.Apply", "KVS.Get", "Catalog.Register", "Health.ServiceNodes",
           "Session.Apply", "Txn.Apply", "ACL.TokenSet", "Coordinate.Update",
           "Snapshot.Save", "AppendEntries", "RequestVote")


def _value(rng: random.Random, depth: int = 0):
    """One body value of the kinds the endpoints carry."""
    kinds = ["str", "bytes", "int", "float", "bool", "none"]
    if depth < 3:
        kinds += ["dict", "list", "tuple"]
    kind = rng.choice(kinds)
    if kind == "str":
        return "".join(rng.choice("abcdé/-_.:0") for _ in
                       range(rng.choice((0, 1, 5, 31, 32, 40, 300))))
    if kind == "bytes":
        return bytes(rng.getrandbits(8) for _ in
                     range(rng.choice((0, 1, 7, 255, 256, 70_000))))
    if kind == "int":
        return rng.choice((0, 1, -1, 127, 128, -32, -33, 255, 256, 65535,
                           65536, -(2 ** 31), 2 ** 32, 2 ** 63 - 1,
                           -(2 ** 63), 2 ** 64 - 1,
                           rng.randint(-10 ** 6, 10 ** 6)))
    if kind == "float":
        return rng.choice((0.0, -0.0, 1.5, 1e-5, 1e300, rng.random()))
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "none":
        return None
    n = rng.choice((0, 1, 3, 15, 16, 17))
    if kind == "dict":
        return {f"k{i}": _value(rng, depth + 1) for i in range(n)}
    items = [_value(rng, depth + 1) for _ in range(n)]
    return tuple(items) if kind == "tuple" else items


def _frames(rng: random.Random):
    """Request and reply frames as the RPC layer builds them."""
    for seq in range(1, 120):
        body = {f"f{i}": _value(rng) for i in range(rng.randint(0, 6))}
        yield {"seq": seq, "method": rng.choice(METHODS), "body": body}
        yield {"seq": seq, "error": None, "body": _value(rng)}
        yield {"seq": seq, "error": "rpc: can't find method X", "body": None}
        yield {"seq": seq, "error": None, "body": body, "more": True}
        yield {"seq": seq, "credit": rng.randint(1, 32)}
        yield {"seq": seq, "cancel": True}
    # A reply whose map keys are not strings (raft's match index by id).
    yield {"seq": 0, "error": None, "body": {1: "a", 2: [b"x"], "s": 3}}


def test_frames_equal_c_msgpack():
    rng = random.Random(20261018)
    n = 0
    for frame in _frames(rng):
        raw = msgpack.packb(frame, use_bin_type=True)
        assert t_rpc._pack(frame) == raw
        assert j_rpc._pack(frame) == raw
        assert t_rpc._unpack(raw) == msgpack.unpackb(
            raw, raw=False, strict_map_key=False)
        n += 1
    assert n == 6 * 119 + 1
