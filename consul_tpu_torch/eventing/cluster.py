"""The Cluster: serf-equivalent gossip eventing over Memberlist; the
port's copy of ``consul_tpu/eventing/cluster.py``.  Bodies go through
the port's msgpack codec (``net/wire.py`` ``packb``/``unpackb``), byte
for byte what the reference's ``msgpack`` calls write.

Maps to vendor/serf/serf/serf.go (Serf struct) + delegate.go:

  message routing    delegate.go:28-135 NotifyMsg dispatch over the
                     serf message-type byte carried in memberlist USER
                     payloads (messages.go:15-26, same numbering)
  3 Lamport clocks   serf.go:64-101 (clock, eventClock, queryClock)
  join/leave intents serf.go handleNodeJoinIntent/handleNodeLeaveIntent
  user events        serf.go:459-516 UserEvent + 1231-1287
                     handleUserEvent (dedup ring keyed LTime % size)
  queries            serf.go:522-640 Query + 1290-1440 handleQuery /
                     handleQueryResponse (direct response to the
                     originator's address, ack flag support)
  tags               members carry a msgpack tag map in the memberlist
                     node meta (serf.go EncodeTags/DecodeTags)
  push/pull backstop delegate.go:173-297 LocalState/MergeRemoteState
                     exchanging clocks + recent event buffer
  reaping            serf.go:1547-1612 reap loop: failed members pruned
                     after ReconnectTimeout, left after TombstoneTimeout
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import logging
import random
import time
from typing import Any, Callable, Optional

from consul_tpu_torch.net import wire
from consul_tpu_torch.net.memberlist import (
    Memberlist,
    MemberlistConfig,
    Node,
    NodeStatus,
)
from consul_tpu_torch.net.transport import Transport
from consul_tpu_torch.net.vivaldi import Coordinate, VivaldiClient
from consul_tpu_torch.eventing.lamport import LamportClock
from consul_tpu_torch.protocol import GossipProfile, LAN
from consul_tpu_torch.telemetry import metrics

log = logging.getLogger("consul_tpu_torch.eventing")


class SerfMessageType(enum.IntEnum):
    """serf/messages.go:15-26 (same numbering)."""

    LEAVE = 0
    JOIN = 1
    PUSH_PULL = 2
    USER_EVENT = 3
    QUERY = 4
    QUERY_RESPONSE = 5
    CONFLICT_RESPONSE = 6
    KEY_REQUEST = 7
    KEY_RESPONSE = 8
    RELAY = 9


QUERY_FLAG_ACK = 1  # messages.go:28-35


class MemberStatus(enum.IntEnum):
    """serf.go MemberStatus."""

    NONE = 0
    ALIVE = 1
    LEAVING = 2
    LEFT = 3
    FAILED = 4


class EventType(enum.IntEnum):
    MEMBER_JOIN = 0
    MEMBER_LEAVE = 1
    MEMBER_FAILED = 2
    MEMBER_UPDATE = 3
    MEMBER_REAP = 4
    USER = 5
    QUERY = 6


@dataclasses.dataclass
class Member:
    name: str
    addr: str
    tags: dict[str, str]
    status: MemberStatus
    status_ltime: int = 0
    leave_time: Optional[float] = None  # when FAILED/LEFT was observed


@dataclasses.dataclass
class Event:
    type: EventType
    members: list[Member] = dataclasses.field(default_factory=list)
    ltime: int = 0
    name: str = ""
    payload: bytes = b""
    query: Optional["QueryResponseHandle"] = None


@dataclasses.dataclass
class QueryResult:
    """What query() returns: who acked receipt (when want_ack) and who
    answered (serf query.go QueryResponse AckCh/ResponseCh)."""

    acks: list[str]
    responses: list[tuple[str, bytes]]


@dataclasses.dataclass
class QueryResponseHandle:
    """Handed to the app for an incoming query; respond() sends the
    answer straight back to the originator (serf query.go Respond)."""

    cluster: "Cluster"
    id: int
    ltime: int
    name: str
    payload: bytes
    origin_addr: str
    relay_factor: int = 0

    async def respond(self, payload: bytes) -> None:
        await self.cluster._send_query_response(self, payload)


@dataclasses.dataclass
class ClusterConfig:
    name: str
    tags: dict[str, str] = dataclasses.field(default_factory=dict)
    profile: GossipProfile = LAN
    interval_scale: float = 1.0
    # The dedup rings and the user-event size limit (serf/config.go:291,
    # 311) are read from ``profile``: its event_buffer_size,
    # query_buffer_size and max_user_event_size.
    # Reaping (serf/config.go ReconnectTimeout/TombstoneTimeout, scaled).
    reconnect_timeout_s: float = 24 * 3600.0
    tombstone_timeout_s: float = 24 * 3600.0
    reap_interval_s: float = 15.0
    # Event sink: called for every Event (the EventCh analogue); events
    # are also readable from Cluster.events (an asyncio.Queue).
    on_event: Optional[Callable[[Event], None]] = None
    # Vivaldi network coordinates piggybacked on probe acks
    # (serf/ping_delegate.go:46-90; DisableCoordinates in serf config).
    coordinates: bool = True
    # False: don't enqueue events on Cluster.events (for pools whose
    # owner consumes nothing from the queue, e.g. the WAN pool — the
    # queue would otherwise grow unboundedly under member churn).
    queue_events: bool = True
    # Gossip snapshot for restart recovery (serf/snapshot.go:17-60):
    # member list + Lamport clocks replayed on start, auto-rejoin
    # through previously-alive members.
    snapshot_path: Optional[str] = None
    rejoin_after_leave: bool = False  # server_serf.go:108
    # Failed-member reconnect attempts (serf.go:1547-1612 reconnect
    # loop: every ReconnectInterval=30s until ReconnectTimeout).
    reconnect_interval_s: float = 30.0
    # AES-GCM gossip keyring (memberlist/security.go + serf/keymanager);
    # rotated cluster-wide through internal queries.
    keyring: Optional["Keyring"] = None
    # Event coalescing windows (serf/coalesce.go; 0 = deliver raw).
    coalesce_period_s: float = 0.0
    quiescent_period_s: float = 0.0


def encode_tags(tags: dict[str, str]) -> bytes:
    """serf.go EncodeTags (msgpack map, no magic byte needed in v0)."""
    return wire.packb(tags)


def decode_tags(meta: bytes) -> dict[str, str]:
    if not meta:
        return {}
    try:
        return wire.unpackb(meta)
    except Exception:
        return {}


class Cluster:
    def __init__(self, config: ClusterConfig, transport: Transport):
        self.config = config
        self.clock = LamportClock()        # member intents
        self.event_clock = LamportClock()  # user events
        self.query_clock = LamportClock()  # queries
        self.event_min_time = 0
        self.query_min_time = 0
        self.events: asyncio.Queue[Event] = asyncio.Queue()
        self.members: dict[str, Member] = {}
        # Dedup rings keyed LTime % size (serf.go:1231-1287).
        profile = config.profile
        self._event_buffer: list[Optional[dict]] = [None] * profile.event_buffer_size
        self._query_buffer: list[Optional[dict]] = [None] * profile.query_buffer_size
        self._query_responses: dict[int, asyncio.Queue] = {}
        self._query_id = 0
        # Intents that arrived before their member (serf recentIntents).
        self._recent_intents: dict[str, tuple[SerfMessageType, int, float]] = {}
        self._left = False
        self._tasks: list[asyncio.Task] = []
        # Serf broadcasts ride their own transmit-limited queue
        # (serf.go:64-101 broadcasts/eventBroadcasts/queryBroadcasts;
        # one queue suffices since the drain order is FIFO-within-tier).
        from consul_tpu_torch.net.broadcast_queue import TransmitLimitedQueue

        self._broadcast_queue = TransmitLimitedQueue(
            num_nodes=lambda: max(len(self.alive_members()), 1),
            retransmit_mult=config.profile.retransmit_mult,
        )

        # Vivaldi coordinate client + peer coordinate cache, fed by the
        # probe ping/ack exchange (serf/ping_delegate.go:46-90; the
        # cache is serf's coordClient/coordCache pair, serf.go:82-90).
        self.vivaldi = VivaldiClient() if config.coordinates else None
        self.coord_cache: dict[str, "Coordinate"] = {}

        # Event coalescer shim (serf/coalesce.go): bursty member/user
        # events collapse to their latest state per subject.
        self._coalescer = None
        if config.coalesce_period_s > 0:
            from consul_tpu_torch.eventing.coalesce import Coalescer

            self._coalescer = Coalescer(
                self._emit_raw,
                config.coalesce_period_s * config.interval_scale,
                (config.quiescent_period_s or config.coalesce_period_s / 4)
                * config.interval_scale,
            )

        # Gossip snapshot: replay BEFORE the clocks first tick so the
        # restored Lamport times dedup pre-crash events (snapshot.go
        # Replay -> serf.go eventMinTime).
        self.snapshotter = None
        self.previous = None
        if config.snapshot_path:
            from consul_tpu_torch.eventing.snapshot import Snapshotter

            self.snapshotter = Snapshotter(config.snapshot_path)
            self.previous = self.snapshotter.replay()
            self.clock.witness(self.previous.clock)
            self.event_clock.witness(self.previous.event_clock)
            self.query_clock.witness(self.previous.query_clock)
            self.event_min_time = self.previous.event_clock + 1
            self.query_min_time = self.previous.query_clock + 1

        self.memberlist = Memberlist(
            MemberlistConfig(
                name=config.name,
                profile=config.profile,
                interval_scale=config.interval_scale,
                node_meta=lambda: encode_tags(self.config.tags),
                notify_user_msg=self._on_user_msg,
                get_broadcasts=self._get_broadcasts,
                local_state=self._local_state,
                merge_remote_state=self._merge_remote_state,
                notify_join=self._on_node_join,
                notify_leave=self._on_node_leave,
                notify_update=self._on_node_update,
                ack_payload=self._ack_payload if self.vivaldi else None,
                notify_ping_complete=(
                    self._on_ping_complete if self.vivaldi else None
                ),
                keyring=config.keyring,
            ),
            transport,
        )

    # ------------------------------------------------------------------
    # coordinates (ping_delegate.go:46-90)
    # ------------------------------------------------------------------

    def _ack_payload(self) -> dict:
        return {"coord": self.vivaldi.get_coordinate().to_wire()}

    def _on_ping_complete(self, node: Node, rtt_s: float, ack: dict) -> None:
        raw = ack.get("coord")
        if raw is None:
            return
        other = Coordinate.from_wire(raw)
        if not other.is_valid():
            return
        self.vivaldi.update(node.name, other, rtt_s)
        self.coord_cache[node.name] = other

    def get_coordinate(self):
        """Our own Vivaldi coordinate (serf.GetCoordinate)."""
        return self.vivaldi.get_coordinate() if self.vivaldi else None

    def get_cached_coordinate(self, name: str):
        """A peer's last seen coordinate (serf.GetCachedCoordinate)."""
        return self.coord_cache.get(name)

    # ------------------------------------------------------------------
    # lifecycle (serf.go:244 Create, 459 UserEvent, 630 Join, ...)
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self.clock.increment()
        self.event_clock.increment()
        self.query_clock.increment()
        await self.memberlist.start()
        self._tasks.append(asyncio.create_task(self._reap_loop()))
        self._tasks.append(asyncio.create_task(self._reconnect_loop()))

    async def auto_rejoin(self) -> int:
        """Rejoin through the snapshot's previously-alive members
        (snapshot.go AliveNodes -> serf auto-rejoin); refused after a
        graceful leave unless RejoinAfterLeave."""
        prev = self.previous
        if prev is None or (prev.left and not self.config.rejoin_after_leave):
            return 0
        addrs = [
            addr for name, addr in prev.alive.items()
            if name != self.config.name and addr
        ]
        if not addrs:
            return 0
        return await self.join(addrs)

    async def _reconnect_loop(self) -> None:
        """serf.go:1547-1612: periodically pick one failed member and
        attempt to re-establish contact via push/pull; success flows
        back through the normal alive path."""
        interval = self.config.reconnect_interval_s * self.config.interval_scale
        while True:
            await asyncio.sleep(interval)
            failed = [
                m for m in self.members.values()
                if m.status == MemberStatus.FAILED and m.addr
            ]
            if not failed:
                continue
            target = failed[int(time.monotonic() * 1000) % len(failed)]
            try:
                await self.memberlist.join([target.addr])
            except Exception:  # noqa: BLE001 - still down, retry later
                pass

    async def join(self, addrs: list[str]) -> int:
        n = await self.memberlist.join(addrs)
        if n > 0:
            self._broadcast_intent(
                SerfMessageType.JOIN,
                {"ltime": self.clock.increment(), "node": self.config.name},
            )
        return n

    async def remove_failed_node(self, name: str) -> bool:
        """serf.go RemoveFailedNode: broadcast a leave intent on BEHALF
        of a failed member, converting it to graceful LEFT everywhere so
        it reaps on the (shorter) tombstone schedule instead of waiting
        out the reconnect window."""
        # No local-status precondition: the reference broadcasts
        # unconditionally so the call works regardless of which agent
        # is asked or how far its failure detection has progressed;
        # only a completely unknown name is refused.
        if name not in self.members:
            return False
        msg = {"ltime": self.clock.increment(), "node": name,
               "prune": False}
        self._handle_leave_intent(msg)
        self._broadcast_intent(SerfMessageType.LEAVE, msg)
        return True

    async def leave(self) -> None:
        """serf.go:690-740 Leave: broadcast the leave intent, then leave
        the memberlist."""
        self._left = True
        self._broadcast_intent(
            SerfMessageType.LEAVE,
            {
                "ltime": self.clock.increment(),
                "node": self.config.name,
                "prune": False,
            },
        )
        await asyncio.sleep(self.config.interval_scale * 0.5)
        if self.snapshotter is not None:
            self.snapshotter.leave()
        await self.memberlist.leave()

    async def shutdown(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._coalescer is not None:
            self._coalescer.stop()
        if self.snapshotter is not None:
            self.snapshotter.close()
        await self.memberlist.shutdown()

    def local_member(self) -> Member:
        return self.members[self.config.name]

    def alive_members(self) -> list[Member]:
        return [
            m for m in self.members.values() if m.status == MemberStatus.ALIVE
        ]

    # ------------------------------------------------------------------
    # user events (serf.go:459-516, 1231-1287)
    # ------------------------------------------------------------------

    async def user_event(self, name: str, payload: bytes,
                         coalesce: bool = True) -> None:
        limit = self.config.profile.max_user_event_size
        if len(name) + len(payload) > limit:
            raise ValueError(f"user event exceeds {limit} byte limit")
        ltime = self.event_clock.time()
        self.event_clock.increment()
        msg = {
            "ltime": ltime,
            "name": name,
            "payload": payload,
            "cc": coalesce,
        }
        self._handle_user_event(msg)  # process locally first (serf.go:510)
        self._queue_serf_msg(SerfMessageType.USER_EVENT, msg)

    def _handle_user_event(self, msg: dict) -> bool:
        self.event_clock.witness(msg["ltime"])
        ltime = msg["ltime"]
        if ltime < self.event_min_time:
            return False
        size = self.config.profile.event_buffer_size
        cur = self.event_clock.time()
        if cur > size and ltime < cur - size:
            log.warning("received old event %s from time %d", msg["name"], ltime)
            return False
        idx = ltime % size
        seen = self._event_buffer[idx]
        key = (msg["name"], bytes(msg["payload"]))
        if seen is not None and seen["ltime"] == ltime:
            if key in seen["events"]:
                return False
        else:
            seen = {"ltime": ltime, "events": set()}
            self._event_buffer[idx] = seen
        seen["events"].add(key)
        self._emit(
            Event(
                type=EventType.USER,
                ltime=ltime,
                name=msg["name"],
                payload=bytes(msg["payload"]),
            )
        )
        return True

    # ------------------------------------------------------------------
    # queries (serf.go:522-640, 1290-1440)
    # ------------------------------------------------------------------

    async def query(
        self,
        name: str,
        payload: bytes,
        timeout_s: Optional[float] = None,
        want_ack: bool = False,
        relay_factor: int = 0,
    ) -> QueryResult:
        """Broadcast a query and collect acks + (node, response) pairs
        until the timeout (serf query semantics; default timeout =
        GossipInterval * QueryTimeoutMult(16) * log(N+1),
        serf.go DefaultQueryTimeout)."""
        import math

        if timeout_s is None:
            n = max(len(self.members), 1)
            timeout_s = (
                self.config.profile.gossip_interval_ms
                / 1000.0
                * self.config.interval_scale
                * 16
                * max(1.0, math.ceil(math.log10(n + 1)))
            )
        ltime = self.query_clock.time()
        self.query_clock.increment()
        self._query_id += 1
        qid = self._query_id
        responses: asyncio.Queue = asyncio.Queue()
        self._query_responses[qid] = responses
        msg = {
            "ltime": ltime,
            "id": qid,
            "addr": self.memberlist.transport.local_addr(),
            "node": self.config.name,
            "flags": QUERY_FLAG_ACK if want_ack else 0,
            "relay_factor": relay_factor,
            "name": name,
            "payload": payload,
        }
        self._handle_query(msg)
        self._queue_serf_msg(SerfMessageType.QUERY, msg)
        result = QueryResult(acks=[], responses=[])
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        try:
            while True:
                left = deadline - loop.time()
                if left <= 0:
                    break
                try:
                    kind, node, payload = await asyncio.wait_for(
                        responses.get(), left
                    )
                    if kind == "ack":
                        if node not in result.acks:
                            result.acks.append(node)
                    elif node not in (n for n, _ in result.responses):
                        result.responses.append((node, payload))
                except asyncio.TimeoutError:
                    break
        finally:
            self._query_responses.pop(qid, None)
        return result

    def _handle_query(self, msg: dict) -> bool:
        self.query_clock.witness(msg["ltime"])
        ltime = msg["ltime"]
        if ltime < self.query_min_time:
            return False
        size = self.config.profile.query_buffer_size
        cur = self.query_clock.time()
        if cur > size and ltime < cur - size:
            return False
        idx = ltime % size
        seen = self._query_buffer[idx]
        if seen is not None and seen["ltime"] == ltime:
            if msg["id"] in seen["ids"]:
                return False
        else:
            seen = {"ltime": ltime, "ids": set()}
            self._query_buffer[idx] = seen
        seen["ids"].add(msg["id"])

        handle = QueryResponseHandle(
            cluster=self,
            id=msg["id"],
            ltime=ltime,
            name=msg["name"],
            payload=bytes(msg["payload"]),
            origin_addr=msg["addr"],
            relay_factor=int(msg.get("relay_factor", 0)),
        )
        if msg["flags"] & QUERY_FLAG_ACK and msg["node"] != self.config.name:
            # Acks are relayed like responses (query.go handleQuery
            # relays the ack through relayFactor members too).
            self.memberlist._spawn(
                self._respond_with_relay(
                    {
                        "ltime": ltime,
                        "id": msg["id"],
                        "from": self.config.name,
                        "flags": QUERY_FLAG_ACK,
                        "payload": b"",
                    },
                    msg["addr"],
                    int(msg.get("relay_factor", 0)),
                )
            )
        if msg["name"].startswith("_serf_"):
            # Internal queries (serf/internal_query.go): handled by the
            # serf layer itself, never surfaced to the application.
            self.memberlist._spawn(self._handle_internal_query(handle))
            return True
        self._emit(
            Event(
                type=EventType.QUERY,
                ltime=ltime,
                name=msg["name"],
                payload=bytes(msg["payload"]),
                query=handle,
            )
        )
        return True

    async def _send_query_response(
        self, handle: QueryResponseHandle, payload: bytes
    ) -> None:
        body = {
            "ltime": handle.ltime,
            "id": handle.id,
            "from": self.config.name,
            "flags": 0,
            "payload": payload,
        }
        await self._respond_with_relay(
            body, handle.origin_addr, handle.relay_factor
        )

    async def _respond_with_relay(
        self, body: dict, origin_addr: str, relay_factor: int
    ) -> None:
        """Direct send + relay redundancy (serf query.go relayResponse):
        the message also travels through relay_factor random members so
        a lossy direct path doesn't lose it; the originator dedups by
        node.  A failing direct send must not abort the relays — they
        exist for exactly that case."""
        try:
            await self._send_direct(
                SerfMessageType.QUERY_RESPONSE, body, origin_addr
            )
        except Exception:  # noqa: BLE001 - relays below still fire
            log.debug("direct query response failed", exc_info=True)
        if relay_factor <= 0:
            return
        inner = bytes([SerfMessageType.QUERY_RESPONSE]) + wire.packb(body)
        candidates = [
            m for m in self.alive_members()
            if m.name != self.config.name and m.addr != origin_addr
        ]
        random.shuffle(candidates)
        for m in candidates[:relay_factor]:
            try:
                await self._send_direct(
                    SerfMessageType.RELAY,
                    {"dest_addr": origin_addr, "payload": inner},
                    m.addr,
                )
            except Exception:  # noqa: BLE001 - best-effort per relay
                log.debug("relay send failed", exc_info=True)

    def _handle_query_response(self, msg: dict) -> None:
        q = self._query_responses.get(msg["id"])
        if q is None:
            return
        kind = "ack" if msg["flags"] & QUERY_FLAG_ACK else "response"
        q.put_nowait((kind, msg["from"], bytes(msg["payload"])))

    # ------------------------------------------------------------------
    # membership intents (serf.go handleNodeJoinIntent / LeaveIntent)
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # keyring management (serf/keymanager.go + internal_query.go)
    # ------------------------------------------------------------------

    async def _handle_internal_query(self, handle: QueryResponseHandle) -> None:
        """serf/internal_query.go serfQueries: _serf_install-key /
        _serf_use-key / _serf_remove-key / _serf_list-keys applied to
        the local keyring, result returned to the originator."""
        op = handle.name[len("_serf_"):]
        resp: dict = {"result": True, "error": "", "keys": []}
        keyring = self.config.keyring
        try:
            arg = handle.payload.decode() if handle.payload else ""
            if keyring is None:
                raise ValueError("encryption is not enabled")
            if op == "install-key":
                keyring.install(arg)
            elif op == "use-key":
                keyring.use(arg)
            elif op == "remove-key":
                keyring.remove(arg)
            elif op == "list-keys":
                resp["keys"] = keyring.list_keys()
            else:
                return  # unknown internal query: stay silent
        except ValueError as e:
            resp = {"result": False, "error": str(e), "keys": []}
        try:
            await handle.respond(wire.packb(resp))
        except Exception:  # noqa: BLE001 - originator may be gone
            log.debug("internal query response failed", exc_info=True)

    async def _key_operation(self, op: str, key_b64: str = "") -> dict:
        """KeyManager.{InstallKey,UseKey,RemoveKey,ListKeys}: broadcast
        the op as an internal query and tally per-node outcomes."""
        result = await self.query(f"_serf_{op}", key_b64.encode())
        out = {"num_nodes": len(self.alive_members()),
               "num_resp": len(result.responses),
               "errors": {}, "keys": {}}
        for node, payload in result.responses:
            try:
                body = wire.unpackb(payload)
            except Exception:  # noqa: BLE001
                continue
            if not body.get("result", False):
                out["errors"][node] = body.get("error", "failed")
            for k in body.get("keys", []):
                out["keys"][k] = out["keys"].get(k, 0) + 1
        return out

    async def install_key(self, key_b64: str) -> dict:
        return await self._key_operation("install-key", key_b64)

    async def use_key(self, key_b64: str) -> dict:
        return await self._key_operation("use-key", key_b64)

    async def remove_key(self, key_b64: str) -> dict:
        return await self._key_operation("remove-key", key_b64)

    async def list_keys(self) -> dict:
        return await self._key_operation("list-keys")

    def _save_recent_intent(self, kind: SerfMessageType, msg: dict) -> bool:
        """Buffer an intent for a not-yet-known member so it can replay
        when the member arrives (serf.go recentIntents/upsertIntent);
        returns True if stored as the freshest intent for that node."""
        node = msg["node"]
        cur = self._recent_intents.get(node)
        if cur is not None and cur[1] >= msg["ltime"]:
            return False
        self._recent_intents[node] = (kind, msg["ltime"], time.monotonic())
        return True

    def _handle_join_intent(self, msg: dict) -> bool:
        self.clock.witness(msg["ltime"])
        m = self.members.get(msg["node"])
        if m is None:
            return self._save_recent_intent(SerfMessageType.JOIN, msg)
        if msg["ltime"] <= m.status_ltime:
            return False
        m.status_ltime = msg["ltime"]
        if m.status == MemberStatus.LEAVING:
            m.status = MemberStatus.ALIVE
        return True

    def _handle_leave_intent(self, msg: dict) -> bool:
        self.clock.witness(msg["ltime"])
        m = self.members.get(msg["node"])
        if m is None:
            return self._save_recent_intent(SerfMessageType.LEAVE, msg)
        if msg["ltime"] <= m.status_ltime:
            return False
        m.status_ltime = msg["ltime"]
        if m.status == MemberStatus.ALIVE:
            m.status = MemberStatus.LEAVING
            return True
        if m.status == MemberStatus.FAILED:
            # A failed node's leave intent converts it to graceful left
            # (serf.go handleNodeLeaveIntent).
            m.status = MemberStatus.LEFT
            self._emit(Event(type=EventType.MEMBER_LEAVE, members=[m]))
            return True
        return False

    # ------------------------------------------------------------------
    # memberlist delegate plumbing
    # ------------------------------------------------------------------

    def _queue_serf_msg(
        self, t: SerfMessageType, body: dict, name: Optional[str] = None
    ) -> None:
        self._broadcast_queue.queue(bytes([t]) + wire.packb(body), name=name)

    def _broadcast_intent(self, t: SerfMessageType, body: dict) -> None:
        # Intents are name-keyed so a newer intent for the same node
        # replaces the queued older one (TransmitLimitedQueue
        # invalidation, like serf's broadcast Invalidates).
        self._queue_serf_msg(t, body, name=f"intent:{body['node']}")

    def _get_broadcasts(self, overhead: int, limit: int) -> list[bytes]:
        """Drain serf broadcasts into the gossip packet, each message
        retransmitted up to the budget (delegate.go:137-171)."""
        # serf.go:1675 serf.queue.* depth gauges, emitted at drain time.
        metrics().set_gauge("serf.queue.Event", len(self._broadcast_queue))
        return self._broadcast_queue.get_broadcasts(overhead, limit)

    async def _forward_relay(self, body: dict) -> None:
        try:
            await self._send_raw(bytes(body["payload"]), body["dest_addr"])
        except Exception:  # noqa: BLE001 - relay is best-effort
            log.debug("relay forward failed", exc_info=True)

    async def _send_raw(self, serf_payload: bytes, addr: str) -> None:
        """One serf message straight to an address, through the
        memberlist seal so it stays encrypted when the keyring is on
        (security.go applies to ALL packets)."""
        await self.memberlist.transport.write_to(
            self.memberlist._seal(
                wire.encode(wire.MessageType.USER, serf_payload)
            ),
            addr,
        )

    async def _send_direct(self, t: SerfMessageType, body: dict, addr: str) -> None:
        await self._send_raw(bytes([t]) + wire.packb(body), addr)

    def _on_user_msg(self, payload: bytes) -> None:
        if not payload:
            return
        t = SerfMessageType(payload[0])
        body = wire.unpackb(bytes(payload[1:]))
        rebroadcast = False
        if t == SerfMessageType.USER_EVENT:
            rebroadcast = self._handle_user_event(body)
        elif t == SerfMessageType.QUERY:
            rebroadcast = self._handle_query(body)
        elif t == SerfMessageType.QUERY_RESPONSE:
            self._handle_query_response(body)
        elif t == SerfMessageType.RELAY:
            # messages.go relayHeader: unwrap and forward the embedded
            # message to its final destination (sealed like any packet).
            self.memberlist._spawn(self._forward_relay(body))
        elif t == SerfMessageType.JOIN:
            rebroadcast = self._handle_join_intent(body)
        elif t == SerfMessageType.LEAVE:
            rebroadcast = self._handle_leave_intent(body)
        else:
            log.warning("unhandled serf message type %s", t)
        if rebroadcast:
            self._queue_serf_msg(t, body)

    # --- member events from memberlist (serf delegate NotifyJoin etc.)

    def _member_from_node(self, node: Node) -> Member:
        return Member(
            name=node.name,
            addr=node.addr,
            tags=decode_tags(node.meta),
            status=MemberStatus.ALIVE,
        )

    def _on_node_join(self, node: Node) -> None:
        m = self.members.get(node.name)
        if m is None:
            m = self._member_from_node(node)
            self.members[node.name] = m
        else:
            m.addr = node.addr
            m.tags = decode_tags(node.meta)
            m.status = MemberStatus.ALIVE
        # Replay any intent that gossiped ahead of the membership
        # (serf.go handleNodeJoin recentIntents replay).
        pending = self._recent_intents.pop(node.name, None)
        if pending is not None:
            kind, ltime, _ = pending
            body = {"ltime": ltime, "node": node.name}
            if kind == SerfMessageType.LEAVE:
                self._handle_leave_intent({**body, "prune": False})
            else:
                self._handle_join_intent(body)
        if self.snapshotter is not None:
            self.snapshotter.alive(m.name, m.addr)
        self._emit(Event(type=EventType.MEMBER_JOIN, members=[m]))

    def _on_node_leave(self, node: Node) -> None:
        m = self.members.get(node.name)
        if m is None:
            return
        m.leave_time = time.monotonic()
        if self.snapshotter is not None:
            self.snapshotter.not_alive(m.name)
        if node.status == NodeStatus.LEFT or m.status == MemberStatus.LEAVING:
            m.status = MemberStatus.LEFT
            self._emit(Event(type=EventType.MEMBER_LEAVE, members=[m]))
        else:
            m.status = MemberStatus.FAILED
            self._emit(Event(type=EventType.MEMBER_FAILED, members=[m]))

    def _on_node_update(self, node: Node) -> None:
        m = self.members.get(node.name)
        if m is None:
            return
        m.tags = decode_tags(node.meta)
        self._emit(Event(type=EventType.MEMBER_UPDATE, members=[m]))

    def _emit(self, event: Event) -> None:
        if self._coalescer is not None and self._coalescer.handle(event):
            return
        self._emit_raw(event)

    def _emit_raw(self, event: Event) -> None:
        if self.snapshotter is not None:
            self.snapshotter.update_clock(
                self.clock.time(),
                self.event_clock.time(),
                self.query_clock.time(),
            )
        if self.config.queue_events:
            self.events.put_nowait(event)
        if self.config.on_event is not None:
            try:
                self.config.on_event(event)
            except Exception:
                log.exception("event handler failed")

    # ------------------------------------------------------------------
    # push/pull backstop (delegate.go:173-297)
    # ------------------------------------------------------------------

    def _local_state(self, join: bool) -> bytes:
        recent = [
            {"ltime": s["ltime"],
             "events": [{"name": n, "payload": p} for (n, p) in s["events"]]}
            for s in self._event_buffer
            if s is not None
        ]
        return wire.packb(
            {
                "ltime": self.clock.time(),
                "event_ltime": self.event_clock.time(),
                "query_ltime": self.query_clock.time(),
                "status_ltimes": {
                    name: m.status_ltime for name, m in self.members.items()
                },
                "left_members": [
                    name
                    for name, m in self.members.items()
                    if m.status == MemberStatus.LEFT
                ],
                "events": recent,
            }
        )

    def _merge_remote_state(self, raw: bytes, join: bool) -> None:
        body = wire.unpackb(raw)
        self.clock.witness(body["ltime"])
        self.event_clock.witness(body["event_ltime"])
        self.query_clock.witness(body["query_ltime"])
        for name, lt in body.get("status_ltimes", {}).items():
            m = self.members.get(name)
            if m is not None and lt > m.status_ltime:
                m.status_ltime = lt
        for name in body.get("left_members", []):
            m = self.members.get(name)
            if m is not None and m.status == MemberStatus.FAILED:
                m.status = MemberStatus.LEFT
        for entry in body.get("events", []):
            for ev in entry["events"]:
                self._handle_user_event(
                    {
                        "ltime": entry["ltime"],
                        "name": ev["name"],
                        "payload": ev["payload"],
                        "cc": False,
                    }
                )

    # ------------------------------------------------------------------
    # reaping (serf.go:1547-1612)
    # ------------------------------------------------------------------

    async def _reap_loop(self) -> None:
        interval = self.config.reap_interval_s * self.config.interval_scale
        while True:
            await asyncio.sleep(interval)
            now = time.monotonic()
            for name, m in list(self.members.items()):
                if m.status not in (MemberStatus.FAILED, MemberStatus.LEFT):
                    continue
                cutoff = (
                    self.config.reconnect_timeout_s
                    if m.status == MemberStatus.FAILED
                    else self.config.tombstone_timeout_s
                ) * self.config.interval_scale
                changed = getattr(m, "leave_time", None)
                node = self.memberlist.nodes.get(name)
                ref = changed or (node.state_change if node else now)
                if now - ref > cutoff:
                    del self.members[name]
                    self.memberlist.nodes.pop(name, None)
                    self._emit(Event(type=EventType.MEMBER_REAP, members=[m]))
            # Expire buffered intents that never found their member
            # (serf.go recentIntents expiry).
            for name, (_, _, ts) in list(self._recent_intents.items()):
                if now - ts > 60.0 * self.config.interval_scale * 5:
                    del self._recent_intents[name]
