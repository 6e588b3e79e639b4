"""RPC plumbing: multiplexed msgpack RPC over Transport streams; the
port's copy of ``consul_tpu/agent/rpc.py``, whose frames go through
``net/wire.py`` (byte for byte ``msgpack.packb(..., use_bin_type=True)``).

Equivalent of the reference's server RPC stack (SURVEY.md §2.2):

  first-byte conn mux     pool/conn.go:30-43 — a new stream's first
                          frame is one type byte selecting the protocol
                          (Consul RPC, Raft, Snapshot); everything
                          shares one listener
  multiplexed RPC         agent/pool/pool.go (yamux) — here one
                          persistent stream per peer carries
                          concurrent ``{seq, method, body}`` request
                          frames and ``{seq, error, body}`` responses
  dispatch                rpc.go:360 handleConsulConn → net/rpc-style
                          ``Service.Method`` names resolved against
                          registered endpoint objects
                          (server_oss.go:8-23)
  blocking queries        rpc.go:759-861 blockingQuery — memdb
                          WatchSet long-poll with jittered timeout and
                          index sanity rules

Method names keep the reference's Go spelling (``KVS.Apply``,
``Health.ServiceNodes``) and are resolved to snake_case coroutine
methods on the endpoint object, so the wire surface matches the
reference while the code stays Pythonic.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import logging
import random
import re
import time
from typing import Any, AsyncIterator, Callable, Optional

from consul_tpu_torch.net import wire
from consul_tpu_torch.net.transport import Stream, Transport
from consul_tpu_torch.telemetry import metrics
from consul_tpu_torch.store.memdb import WatchSet
from consul_tpu_torch.store.state import StateStore

log = logging.getLogger("consul_tpu_torch.rpc")

# Stream type bytes (pool/conn.go:30-43; gossip/TLS slots reserved).
RPC_CONSUL = 0
RPC_RAFT = 1
RPC_MULTIPLEX_V2 = 4
RPC_SNAPSHOT = 5

# Blocking query timing (rpc.go / config.go).
DEFAULT_QUERY_TIME = 300.0  # DefaultQueryTime  (5 min)
MAX_QUERY_TIME = 600.0  # MaxQueryTime (10 min)
JITTER_FRACTION = 16  # lib.RandomStagger denominator (rpc.go:788)


class RPCError(Exception):
    """Remote error string surfaced to the caller (net/rpc ServerError)."""


ERR_NO_LEADER = "No cluster leader"  # structs.ErrNoLeader
ERR_PERMISSION_DENIED = "Permission denied"  # acl.ErrPermissionDenied
ERR_ACL_NOT_FOUND = "ACL not found"  # acl.ErrNotFound


def _pack(obj: Any) -> bytes:
    return wire.packb(obj)


def _unpack(raw: bytes) -> Any:
    return wire.unpackb(raw, strict_map_key=False)


_CAMEL_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")


# Flow control (the yamux window analogue, in frames not bytes):
# per-streaming-call credit window and the shared write queue's bound.
STREAM_WINDOW = 32
SESSION_WINDOW = 1024


def snake(name: str) -> str:
    """``ServiceNodes`` → ``service_nodes`` (wire name → method name)."""
    return _CAMEL_RE.sub("_", name).lower()


def rpc_timeout_for(body: dict, default: float = 30.0) -> float:
    """Client-side wait budget for a call that may long-poll server-side
    (pool.go RPC deadline = query wait + jitter + RPCHoldTimeout): a
    blocking query must be given its full max_query_time plus the
    server's jitter (1/16) and a grace window, or a follower/client
    forwarding it would time out before the leader answers."""
    if int(body.get("min_query_index", 0) or 0) <= 0:
        return default
    wait = float(body.get("max_query_time", 0.0) or 0.0) or DEFAULT_QUERY_TIME
    wait = min(wait, MAX_QUERY_TIME)
    return wait + wait / JITTER_FRACTION + 5.0


@dataclasses.dataclass
class QueryOptions:
    """Client-supplied read options (structs.QueryOptions)."""

    min_query_index: int = 0
    max_query_time: float = 0.0  # 0 → DefaultQueryTime
    allow_stale: bool = False
    require_consistent: bool = False
    token: str = ""

    @classmethod
    def from_body(cls, body: dict) -> "QueryOptions":
        return cls(
            min_query_index=int(body.get("min_query_index", 0)),
            max_query_time=float(body.get("max_query_time", 0.0)),
            allow_stale=bool(body.get("allow_stale", False)),
            require_consistent=bool(body.get("require_consistent", False)),
            token=body.get("token", ""),
        )


@dataclasses.dataclass
class QueryMeta:
    """Server-reported read metadata (structs.QueryMeta →
    X-Consul-Index / X-Consul-KnownLeader / X-Consul-LastContact)."""

    index: int = 0
    known_leader: bool = True
    last_contact: float = 0.0

    def to_body(self) -> dict:
        return {
            "index": self.index,
            "known_leader": self.known_leader,
            "last_contact": self.last_contact,
        }


async def blocking_query(
    store: StateStore,
    opts: QueryOptions,
    run: Callable[[Optional[WatchSet]], tuple[int, Any]],
    *,
    rng: Optional[random.Random] = None,
) -> tuple[QueryMeta, Any]:
    """The long-poll loop of ``rpc.go:759-861 blockingQuery``.

    ``run(ws)`` executes the read against the store, registering radix
    watches on ``ws``, and returns ``(index, result)``.  Semantics kept
    from the reference: not blocking when min_query_index is 0; wait
    capped to MaxQueryTime with +1/16 jitter; a returned index below 1
    is reported as 1; an index that went *backwards* past the client's
    is served immediately (index sanity, rpc.go:836-848).
    """
    meta = QueryMeta()
    if opts.min_query_index <= 0:
        index, result = run(None)
        meta.index = max(index, 1)
        return meta, result

    wait = opts.max_query_time or DEFAULT_QUERY_TIME
    wait = min(wait, MAX_QUERY_TIME)
    wait += (rng or random).random() * wait / JITTER_FRACTION
    deadline = time.monotonic() + wait
    # rpc.go:796 metrics.IncrCounter rpc.queries_blocking.
    metrics().incr_counter("rpc.queries_blocking")

    while True:
        ws = WatchSet()
        abandon = store.abandon_event()
        ws.add(abandon)
        index, result = run(ws)
        if index < 1:
            index = 1
        if index < opts.min_query_index:
            # Store was reset (snapshot restore): serve immediately so
            # the client restarts its watch from the new world.
            meta.index = index
            return meta, result
        if index > opts.min_query_index:
            meta.index = index
            return meta, result
        remaining = deadline - time.monotonic()
        fired = remaining > 0 and await ws.wait(remaining)
        if abandon.is_set():
            # Store swapped out from under us (snapshot restore): return
            # right away so the client re-queries the new store
            # (rpc.go:825 AbandonCh case).
            meta.index = index
            return meta, result
        if not fired:
            meta.index = index
            return meta, result


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------


class RPCServer:
    """Accepts streams from a Transport, muxes by first byte, serves
    Consul RPC frames (rpc.go:61-360 listen/handleConn)."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self._endpoints: dict[str, Any] = {}
        self._raft_handler: Optional[Callable] = None
        self._snapshot_handler: Optional[Callable] = None
        self._tasks: list[asyncio.Task] = []
        self._conn_tasks: set[asyncio.Task] = set()
        self._shutdown = False

    def register(self, name: str, endpoint: Any) -> None:
        """Register an endpoint service (server_oss.go:8-23)."""
        self._endpoints[name] = endpoint

    def bind_raft(self, handler: Callable) -> None:
        """handler(method: str, body: dict) -> dict, from the raft node."""
        self._raft_handler = handler

    def bind_snapshot(self, handler: Callable) -> None:
        """handler(stream, body) for streaming snapshot save/restore."""
        self._snapshot_handler = handler

    async def start(self) -> None:
        self._tasks.append(asyncio.create_task(self._accept_loop()))

    async def shutdown(self) -> None:
        self._shutdown = True
        for t in self._tasks + list(self._conn_tasks):
            t.cancel()

    async def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                stream = await self.transport.accept_stream()
            except (asyncio.CancelledError, ConnectionError):
                return
            t = asyncio.create_task(self._handle_conn(stream))
            self._conn_tasks.add(t)
            t.add_done_callback(self._conn_tasks.discard)

    async def _handle_conn(self, stream: Stream) -> None:
        try:
            first = await stream.recv(timeout=30.0)
        except (asyncio.TimeoutError, ConnectionError, asyncio.CancelledError):
            await stream.close()
            return
        rpc_type = first[0] if first else -1
        try:
            if rpc_type in (RPC_CONSUL, RPC_MULTIPLEX_V2):
                await self._serve_frames(stream, self._dispatch_consul)
            elif rpc_type == RPC_RAFT:
                await self._serve_frames(stream, self._dispatch_raft)
            elif rpc_type == RPC_SNAPSHOT and self._snapshot_handler:
                await self._snapshot_handler(stream)
            else:
                log.warning("unrecognized RPC byte %r; closing", rpc_type)
        except (ConnectionError, asyncio.CancelledError, asyncio.TimeoutError):
            pass
        finally:
            await stream.close()

    async def _serve_frames(self, stream: Stream, dispatch: Callable) -> None:
        """Request pump: decode frames, run each in its own task, write
        responses through a queue (so concurrent handlers never
        interleave partial writes — the yamux-per-stream analogue).

        Flow control (yamux session/stream windows, yamux/session.go +
        stream.go): the shared write queue is BOUNDED (session-level
        backpressure — a slow socket suspends handlers instead of
        buffering without limit), and each server-streaming call holds a
        credit window of STREAM_WINDOW frames — the producer blocks when
        the client stops consuming, and the client grants more credit
        as its application drains (window-update frames)."""
        write_q: asyncio.Queue = asyncio.Queue(maxsize=SESSION_WINDOW)
        pending: set[asyncio.Task] = set()
        streams_by_seq: dict[int, asyncio.Task] = {}
        stream_credits: dict[int, asyncio.Semaphore] = {}
        # Cancels that raced ahead of their handler task starting.
        cancelled_seqs: set[int] = set()

        async def writer():
            try:
                while True:
                    frame = await write_q.get()
                    await stream.send(frame)
            except (ConnectionError, asyncio.CancelledError):
                pass
            finally:
                # A dead writer means responses can never be delivered:
                # close the stream so the request loop's recv unblocks
                # and the whole conn tears down instead of queueing
                # responses into the void.
                await stream.close()

        wtask = asyncio.create_task(writer())
        try:
            while True:
                raw = await stream.recv()
                req = _unpack(raw)
                if req.get("credit"):
                    # Window update: the client consumed k frames.
                    sem = stream_credits.get(req.get("seq", 0))
                    if sem is not None:
                        for _ in range(int(req["credit"])):
                            sem.release()
                    continue
                if req.get("cancel"):
                    # Client abandoned a server-streaming call
                    # (grpc-style cancellation for Subscribe).  The
                    # handler task may not have started yet — remember
                    # the seq so it aborts on arrival.
                    seq = req.get("seq", 0)
                    t = streams_by_seq.pop(seq, None)
                    if t is not None:
                        t.cancel()
                    else:
                        cancelled_seqs.add(seq)
                        # Seqs are monotonic per connection: entries far
                        # behind the current seq belong to streams that
                        # already finished — drop them so a cancel that
                        # raced a normal completion can't accumulate.
                        if len(cancelled_seqs) > 64:
                            cancelled_seqs.intersection_update(
                                s for s in cancelled_seqs if s > seq - 512
                            )
                    continue

                async def handle(req=req):
                    seq = req.get("seq", 0)
                    try:
                        result = await dispatch(req["method"], req.get("body") or {})
                        if inspect.isasyncgen(result):
                            if seq in cancelled_seqs:
                                # Cancel frame beat us here.
                                cancelled_seqs.discard(seq)
                                await result.aclose()
                                return
                            # Server-streaming response (the gRPC
                            # subscribe analogue, subscribe.go:45): one
                            # frame per yielded item with more=True,
                            # then a closing frame.
                            streams_by_seq[seq] = asyncio.current_task()
                            credit = asyncio.Semaphore(STREAM_WINDOW)
                            stream_credits[seq] = credit
                            try:
                                async for item in result:
                                    # One credit per frame: blocks here
                                    # when the client stops consuming.
                                    await credit.acquire()
                                    await write_q.put(_pack(
                                        {"seq": seq, "error": None,
                                         "body": item, "more": True}
                                    ))
                                resp = {"seq": seq, "error": None,
                                        "body": None, "more": False}
                            except asyncio.CancelledError:
                                await result.aclose()
                                return
                            finally:
                                streams_by_seq.pop(seq, None)
                                stream_credits.pop(seq, None)
                        else:
                            resp = {"seq": seq, "error": None, "body": result}
                    except Exception as e:  # noqa: BLE001 — error -> wire
                        resp = {"seq": seq, "error": str(e) or repr(e), "body": None}
                    try:
                        frame = _pack(resp)
                    except Exception as e:  # unserializable result
                        frame = _pack(
                            {"seq": seq, "error": f"unserializable response: {e}",
                             "body": None}
                        )
                    await write_q.put(frame)

                t = asyncio.create_task(handle())
                pending.add(t)
                t.add_done_callback(pending.discard)
        finally:
            wtask.cancel()
            for t in pending:
                t.cancel()

    async def dispatch_local(self, method: str, body: dict) -> Any:
        """In-process dispatch to a registered endpoint — the server
        agent's own RPC entry point (no wire round-trip)."""
        return await self._dispatch_consul(method, body)

    async def _dispatch_consul(self, method: str, body: dict) -> Any:
        service, _, verb = method.partition(".")
        endpoint = self._endpoints.get(service)
        fn = getattr(endpoint, snake(verb), None) if endpoint else None
        if fn is None or verb.startswith("_"):
            raise RPCError(f"rpc: can't find method {method}")
        if inspect.isasyncgenfunction(fn):
            # Server-streaming endpoint: hand the generator back to the
            # frame pump (or a local caller) to iterate.
            return fn(body)
        return await fn(body)

    async def _dispatch_raft(self, method: str, body: dict) -> Any:
        if self._raft_handler is None:
            raise RPCError("raft not enabled on this node")
        return await self._raft_handler(method, body)


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------


class _Conn:
    """One persistent muxed stream to a peer (agent/pool ConnPool entry)."""

    def __init__(self, stream: Stream):
        self.stream = stream
        self.seq = 0
        self.waiters: dict[int, asyncio.Future] = {}
        # seq -> queue for server-streaming calls (multiple frames).
        self.stream_waiters: dict[int, asyncio.Queue] = {}
        self.reader: Optional[asyncio.Task] = None
        self.dead = False

    def fail_all(self, exc: Exception) -> None:
        self.dead = True
        for fut in self.waiters.values():
            if not fut.done():
                fut.set_exception(exc)
        self.waiters.clear()
        for q in self.stream_waiters.values():
            q.put_nowait(exc)
        self.stream_waiters.clear()


class RPCClient:
    """Connection-pooled msgpack RPC caller (agent/pool/pool.go)."""

    def __init__(self, transport: Transport, rpc_type: int = RPC_CONSUL):
        self.transport = transport
        self.rpc_type = rpc_type
        self._conns: dict[str, _Conn] = {}
        self._dial_locks: dict[str, asyncio.Lock] = {}

    async def call(
        self, addr: str, method: str, body: dict, timeout: float = 30.0
    ) -> Any:
        conn = await self._get_conn(addr)
        conn.seq += 1
        seq = conn.seq
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        conn.waiters[seq] = fut
        try:
            await conn.stream.send(
                _pack({"seq": seq, "method": method, "body": body})
            )
            resp = await asyncio.wait_for(fut, timeout)
        except ConnectionError:
            self._drop_conn(addr, conn)
            raise
        except asyncio.TimeoutError:
            # The connection itself may be fine (e.g. a long-poll the
            # caller under-budgeted); abandoning just this call keeps the
            # other in-flight requests on the shared stream alive.
            raise
        finally:
            conn.waiters.pop(seq, None)
        if resp.get("error"):
            raise RPCError(resp["error"])
        return resp.get("body")

    async def shutdown(self) -> None:
        for addr in list(self._conns):
            self._drop_conn(addr, self._conns[addr])

    async def _get_conn(self, addr: str) -> _Conn:
        conn = self._conns.get(addr)
        if conn and not conn.dead:
            return conn
        lock = self._dial_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            conn = self._conns.get(addr)
            if conn and not conn.dead:
                return conn
            stream = await self.transport.dial(addr, timeout=10.0)
            await stream.send(bytes([self.rpc_type]))
            conn = _Conn(stream)
            conn.reader = asyncio.create_task(self._read_loop(addr, conn))
            self._conns[addr] = conn
            return conn

    async def stream(
        self, addr: str, method: str, body: dict
    ) -> AsyncIterator[Any]:
        """Server-streaming call: yields each frame's body until the
        server closes the stream (the client half of Subscribe).
        Abandoning the iterator sends a cancel frame."""
        conn = await self._get_conn(addr)
        conn.seq += 1
        seq = conn.seq
        q: asyncio.Queue = asyncio.Queue()
        conn.stream_waiters[seq] = q
        finished = False
        try:
            await conn.stream.send(
                _pack({"seq": seq, "method": method, "body": body})
            )
            consumed = 0
            while True:
                item = await q.get()
                if isinstance(item, Exception):
                    finished = True
                    raise item
                if item.get("error"):
                    finished = True
                    raise RPCError(item["error"])
                if not item.get("more", False):
                    finished = True
                    return
                yield item.get("body")
                # Window update AFTER the application consumed the item
                # (yamux stream.go sendWindowUpdate): batched at half
                # the window so updates amortize.
                consumed += 1
                if consumed >= STREAM_WINDOW // 2 and not conn.dead:
                    try:
                        await conn.stream.send(
                            _pack({"seq": seq, "credit": consumed}))
                        consumed = 0
                    except Exception:  # noqa: BLE001 - conn tearing down
                        pass
        finally:
            conn.stream_waiters.pop(seq, None)
            if not finished and not conn.dead:
                # Iterator abandoned mid-stream: tell the server.
                try:
                    await conn.stream.send(_pack({"seq": seq, "cancel": True}))
                except Exception:  # noqa: BLE001 - conn already torn down
                    pass

    async def _read_loop(self, addr: str, conn: _Conn) -> None:
        try:
            while True:
                resp = _unpack(await conn.stream.recv())
                seq = resp.get("seq")
                sq = conn.stream_waiters.get(seq)
                if sq is not None:
                    sq.put_nowait(resp)
                    continue
                fut = conn.waiters.get(seq)
                if fut and not fut.done():
                    fut.set_result(resp)
        except (ConnectionError, asyncio.CancelledError, Exception) as e:
            conn.fail_all(e if isinstance(e, ConnectionError) else ConnectionError(str(e)))
            if self._conns.get(addr) is conn:
                del self._conns[addr]

    def _drop_conn(self, addr: str, conn: _Conn) -> None:
        conn.fail_all(ConnectionError(f"connection to {addr} dropped"))
        if conn.reader:
            conn.reader.cancel()
        if self._conns.get(addr) is conn:
            del self._conns[addr]


class RaftRPCAdapter:
    """Raft's transport riding the shared RPC port (server.go raftLayer:
    raft traffic is just stream type byte 1 on the same listener)."""

    def __init__(self, client: RPCClient, addr_of: Callable[[str], Optional[str]]):
        self._client = client
        self._addr_of = addr_of  # node id -> rpc addr (from serf tags)
        self._handler: Optional[Callable] = None

    def bind(self, node_id: str, handler: Callable) -> None:
        # Exactly one raft node lives in a process (server.go); a second
        # bind indicates a wiring bug, not a routing feature.
        if self._handler is not None:
            raise RuntimeError("raft handler already bound on this adapter")
        self._handler = handler

    async def handle(self, method: str, body: dict) -> dict:
        if self._handler is None:
            raise RPCError("no raft node bound")
        return await self._handler(method, body)

    async def call(self, target: str, method: str, body: dict) -> dict:
        addr = self._addr_of(target)
        if addr is None:
            raise ConnectionError(f"no known address for raft peer {target}")
        return await self._client.call(addr, method, body, timeout=10.0)
