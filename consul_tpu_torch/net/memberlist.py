"""SWIM cluster membership + failure detection over a Transport: the
port's copy of ``consul_tpu/net/memberlist.py``.

The host-plane equivalent of vendored memberlist: probe/ack with
indirect probes and TCP fallback, suspicion with Lifeguard confirmations
and refutation, piggybacked gossip via a transmit-limited queue, and
periodic full-state push/pull anti-entropy.  All protocol constants and
scaling formulas come from ``consul_tpu_torch.protocol``, the same ground
truth the simulator runs.  It imports no ``torch``: it is plain asyncio
over any :class:`~consul_tpu_torch.net.transport.Transport`, the device
population's :class:`~consul_tpu_torch.net.SimTransport` included.

Reference call stacks mirrored here (SURVEY.md §3.1-3.2):
  probe loop        state.go:214-497 probe/probeNode
  state handlers    state.go:917-1300 aliveNode/suspectNode/deadNode
  gossip            state.go:566-616
  push/pull         state.go:622-750, merge at 1283+
  awareness         awareness.go:14-69 (Lifeguard local health score)
  leave-vs-die      dead msg with From == the node itself means an
                    intentional leave (state.go deadNode -> StateLeft)

AES-GCM gossip encryption with a multi-key keyring is enforced at the
packet layer (``net/security.py``; install/use/remove via the keyring
RPCs) — when a keyring is configured, plaintext and undecryptable
packets are dropped (see ``_handle_packet``).  Remaining deliberate
deviations (gated, not silently dropped): no LZW compression, no CRC
(wire enum slots reserved in wire.py); probe ring is a fresh shuffle
each wrap rather than an incremental shuffle.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import logging
import random
import time
from typing import Callable, Optional

from consul_tpu_torch.net import wire
from consul_tpu_torch.net.security import Keyring, SecurityError
from consul_tpu_torch.telemetry import metrics
from consul_tpu_torch.net.broadcast_queue import TransmitLimitedQueue
from consul_tpu_torch.net.suspicion import Suspicion
from consul_tpu_torch.net.transport import Stream, Transport
from consul_tpu_torch.protocol import (
    GossipProfile,
    LAN,
    awareness_clamp,
    awareness_probe_delta,
    awareness_scaled_timeout,
    push_pull_scale,
    suspicion_timeout,
)

log = logging.getLogger("consul_tpu_torch.memberlist")


class NodeStatus(enum.IntEnum):
    ALIVE = 0
    SUSPECT = 1
    DEAD = 2
    LEFT = 3


@dataclasses.dataclass
class Node:
    name: str
    addr: str
    incarnation: int = 0
    status: NodeStatus = NodeStatus.ALIVE
    state_change: float = dataclasses.field(default_factory=time.monotonic)
    meta: bytes = b""

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "addr": self.addr,
            "inc": self.incarnation,
            "status": int(self.status),
            "meta": self.meta,
        }


@dataclasses.dataclass
class MemberlistConfig:
    name: str
    profile: GossipProfile = LAN
    # Scale all protocol intervals by this factor (tests use ~0.02 for a
    # 50x-faster virtual cluster; 1.0 = reference timing).
    interval_scale: float = 1.0
    # Serf-style delegate hooks (memberlist/delegate.go):
    node_meta: Callable[[], bytes] = lambda: b""
    notify_user_msg: Optional[Callable[[bytes], None]] = None
    get_broadcasts: Optional[Callable[[int, int], list]] = None
    local_state: Optional[Callable[[bool], bytes]] = None
    merge_remote_state: Optional[Callable[[bytes, bool], None]] = None
    # Event hooks (memberlist EventDelegate):
    notify_join: Optional[Callable[[Node], None]] = None
    notify_leave: Optional[Callable[[Node], None]] = None
    notify_update: Optional[Callable[[Node], None]] = None
    # Ping delegate (serf/ping_delegate.go:46-90): ``ack_payload`` is
    # appended to our ACK responses (the serf coordinate piggyback);
    # ``notify_ping_complete(node, rtt_seconds, ack_body)`` receives the
    # peer's ack including any such payload.
    ack_payload: Optional[Callable[[], dict]] = None
    notify_ping_complete: Optional[Callable[[Node, float, dict], None]] = None
    # AES-GCM gossip encryption (memberlist/security.go): when set,
    # every outbound packet/frame is sealed with the primary key and
    # unencrypted inbound traffic is dropped (GossipVerifyIncoming).
    keyring: Optional["Keyring"] = None

    def s(self, ms: float) -> float:
        """Protocol ms -> scaled seconds."""
        return ms / 1000.0 * self.interval_scale


class _Awareness:
    """Lifeguard node health score (awareness.go:14-69): 0 = healthy;
    each missed ack/nack raises it, each success lowers it; probe
    timeouts scale by (score + 1).  The clamp and scaling math are the
    shared ``consul_tpu_torch.protocol`` formulas, the exact numbers the
    simulated model (models/lifeguard.py) computes."""

    def __init__(self, max_mult: int):
        self._max = max_mult
        self.score = 0
        # Gauge exists from construction (newMemberlist wires the
        # awareness before the first probe), so /v1/agent/metrics
        # reports a healthy score even before any delta fires.
        metrics().set_gauge("memberlist.health.score", self.score)

    def apply_delta(self, delta: int) -> None:
        self.score = awareness_clamp(self.score + delta, self._max)
        # awareness.go:50 emits the health score on every change.
        metrics().set_gauge("memberlist.health.score", self.score)

    def scale_timeout(self, timeout: float) -> float:
        return awareness_scaled_timeout(timeout, self.score)


class Memberlist:
    def __init__(self, config: MemberlistConfig, transport: Transport):
        self.config = config
        self.transport = transport
        self.nodes: dict[str, Node] = {}
        self.incarnation = 0
        self.awareness = _Awareness(config.profile.awareness_max_multiplier)
        self.broadcasts = TransmitLimitedQueue(
            num_nodes=lambda: self.num_alive(), retransmit_mult=config.profile.retransmit_mult
        )
        self._suspicions: dict[str, Suspicion] = {}
        self._ack_waiters: dict[int, asyncio.Future] = {}
        self._nack_counts: dict[int, int] = {}
        self._seq = 0
        self._probe_ring: list[str] = []
        self._tasks: list[asyncio.Task] = []
        # Short-lived tasks (probe cycles, acks, relays, stream handlers),
        # kept so that shutdown() cancels them too.
        self._inflight: set[asyncio.Task] = set()
        self._shutdown = False
        self._rng = random.Random(hash(config.name) & 0xFFFFFFFF)
        self.leaving = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        """setAlive + schedule (memberlist.go:225-246, state.go:104-142)."""
        # Route our own record through the alive handler so the join
        # notification fires for the local node too (setAlive ->
        # aliveNode, memberlist.go:225-246).
        self._alive_node(
            {
                "name": self.config.name,
                "addr": self.transport.local_addr(),
                "inc": self.incarnation,
                "status": int(NodeStatus.ALIVE),
                "meta": self.config.node_meta(),
            },
            bootstrap=True,
        )
        for coro in (
            self._packet_listener(),
            self._stream_listener(),
            self._probe_loop(),
            self._gossip_loop(),
            self._push_pull_loop(),
        ):
            self._tasks.append(asyncio.create_task(coro))

    async def shutdown(self) -> None:
        self._shutdown = True
        for t in (*self._tasks, *self._inflight):
            t.cancel()
        for s in self._suspicions.values():
            s.stop()
        await self.transport.shutdown()

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.ensure_future(coro)
        self._inflight.add(task)
        task.add_done_callback(self._task_done)
        return task

    def _task_done(self, task: asyncio.Task) -> None:
        self._inflight.discard(task)
        if not task.cancelled() and task.exception():
            log.error("task failed", exc_info=task.exception())

    async def join(self, addrs: list[str]) -> int:
        """TCP push/pull state sync with each address (memberlist.go:249,
        state.go:644 pushPullNode); returns how many succeeded."""
        ok = 0
        for addr in addrs:
            try:
                await self._push_pull_node(addr, join=True)
                ok += 1
            except Exception as e:  # join failures are non-fatal
                log.warning("join %s failed: %s", addr, e)
        return ok

    async def leave(self, timeout: float = 5.0) -> None:
        """Broadcast an intentional-leave dead message about ourselves
        (memberlist Leave: dead msg with Node == From -> StateLeft)."""
        self.leaving = True
        me = self.nodes[self.config.name]
        done = asyncio.Event()
        msg = wire.encode(
            wire.MessageType.DEAD,
            {"inc": me.incarnation, "node": me.name, "from": me.name},
        )
        self.broadcasts.queue(msg, name=me.name, notify=done.set)
        me.status = NodeStatus.LEFT
        me.state_change = time.monotonic()
        # Wait for the broadcast if ANY other node is alive to hear it
        # (memberlist Leave anyAlive; self is already LEFT here).
        if self.num_alive() > 0:
            try:
                await asyncio.wait_for(done.wait(), timeout)
            except asyncio.TimeoutError:
                log.warning("leave broadcast not fully transmitted")

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    def members(self) -> list[Node]:
        return [
            n
            for n in self.nodes.values()
            if n.status in (NodeStatus.ALIVE, NodeStatus.SUSPECT)
        ]

    def num_alive(self) -> int:
        return len(self.members())

    def local_node(self) -> Node:
        return self.nodes[self.config.name]

    # ------------------------------------------------------------------
    # packet plane
    # ------------------------------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _seal(self, payload: bytes) -> bytes:
        """security.go encryptPayload: sealed payloads ride the ENCRYPT
        message-type slot (net.go:44-59)."""
        if self.config.keyring is None:
            return payload
        return bytes([wire.MessageType.ENCRYPT]) + self.config.keyring.encrypt(
            payload
        )

    def _open(self, payload: bytes) -> Optional[bytes]:
        """security.go decryptPayload + GossipVerifyIncoming: plaintext
        traffic is rejected once encryption is on."""
        if payload and payload[0] == wire.MessageType.ENCRYPT:
            if self.config.keyring is None:
                log.warning("dropping encrypted packet: no keyring")
                return None
            try:
                return self.config.keyring.decrypt(payload[1:])
            except SecurityError as e:
                log.warning("dropping undecryptable packet: %s", e)
                return None
        if self.config.keyring is not None:
            log.warning("dropping plaintext packet: encryption required")
            return None
        return payload

    async def _send_msg(self, addr: str, msg_type: wire.MessageType, body) -> None:
        """Send one message, piggybacking queued broadcasts up to the
        packet budget (state.go:597 gossip piggyback)."""
        payload = wire.encode(msg_type, body)
        budget = self.config.profile.udp_buffer_size - len(payload) - 16
        extra = self._drain_broadcasts(budget)
        if extra:
            payload = wire.make_compound([payload] + extra)
        await self.transport.write_to(self._seal(payload), addr)

    def _drain_broadcasts(self, limit: int) -> list[bytes]:
        out = self.broadcasts.get_broadcasts(overhead=2, limit=limit)
        if self.config.get_broadcasts is not None:
            user = self.config.get_broadcasts(2, max(0, limit - sum(map(len, out))))
            out.extend(
                wire.encode(wire.MessageType.USER, u) for u in user
            )
        return out

    async def _packet_listener(self) -> None:
        while not self._shutdown:
            payload, src, ts = await self.transport.recv_packet()
            try:
                payload = self._open(payload)
                if payload is None:
                    continue
                self._handle_packet(payload, src)
            except Exception:
                log.exception("bad packet from %s", src)

    def _handle_packet(self, payload: bytes, src: str) -> None:
        if payload and payload[0] == wire.MessageType.COMPOUND:
            for part in wire.split_compound(payload):
                self._handle_packet(part, src)
            return
        msg_type, body = wire.decode(payload)
        metrics().incr_counter(f"memberlist.msg.{msg_type.name.lower()}")
        if msg_type == wire.MessageType.PING:
            self._on_ping(body, src)
        elif msg_type == wire.MessageType.INDIRECT_PING:
            self._spawn(self._on_indirect_ping(body, src))
        elif msg_type == wire.MessageType.ACK_RESP:
            self._on_ack(body)
        elif msg_type == wire.MessageType.NACK_RESP:
            self._on_nack(body)
        elif msg_type == wire.MessageType.SUSPECT:
            self._suspect_node(body)
        elif msg_type == wire.MessageType.ALIVE:
            self._alive_node(body)
        elif msg_type == wire.MessageType.DEAD:
            self._dead_node(body)
        elif msg_type == wire.MessageType.USER:
            if self.config.notify_user_msg:
                self.config.notify_user_msg(body)
        else:
            log.warning("unhandled message type %s from %s", msg_type, src)

    def _ack_body(self, seq) -> dict:
        body = {"seq": seq}
        if self.config.ack_payload is not None:
            try:
                body.update(self.config.ack_payload())
            except Exception:
                log.exception("ack payload hook failed")
        return body

    def _on_ping(self, body, src: str) -> None:
        # Answer only pings addressed to us (net.go handlePing).
        if body.get("node") not in (None, self.config.name):
            return
        self._spawn(
            self._send_msg(src, wire.MessageType.ACK_RESP, self._ack_body(body["seq"]))
        )

    async def _on_indirect_ping(self, body, src: str) -> None:
        """Relay a probe on behalf of ``src`` (net.go handleIndirectPing)."""
        seq = self._next_seq()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._ack_waiters[seq] = fut
        await self._send_msg(
            body["target_addr"],
            wire.MessageType.PING,
            {"seq": seq, "node": body["target"], "from": self.config.name},
        )
        try:
            await asyncio.wait_for(
                fut, self.config.s(self.config.profile.probe_timeout_ms)
            )
            await self._send_msg(
                src, wire.MessageType.ACK_RESP, {"seq": body["seq"]}
            )
        except asyncio.TimeoutError:
            await self._send_msg(
                src, wire.MessageType.NACK_RESP, {"seq": body["seq"]}
            )
        finally:
            self._ack_waiters.pop(seq, None)

    def _on_ack(self, body) -> None:
        fut = self._ack_waiters.get(body["seq"])
        if fut and not fut.done():
            fut.set_result((time.monotonic(), body))

    def _on_nack(self, body) -> None:
        """A relay answered our indirect probe with a NACK: the target
        is unresponsive but OUR links work — counted so the failed
        probe's health penalty only charges the missing nacks
        (state.go probeNode awarenessDelta)."""
        seq = body.get("seq")
        if seq in self._nack_counts:
            self._nack_counts[seq] += 1

    # ------------------------------------------------------------------
    # probe plane (state.go:214-497)
    # ------------------------------------------------------------------

    async def _probe_loop(self) -> None:
        """Fixed-period ticker: each probe cycle (direct timeout +
        indirect probes + fallback) runs as its own task bounded inside
        one ProbeInterval, so a failing probe never stretches the probe
        period (state.go:214-256 probe ticker semantics)."""
        interval = self.config.s(self.config.profile.probe_interval_ms)
        while not self._shutdown:
            await asyncio.sleep(interval * (0.9 + 0.2 * self._rng.random()))
            try:
                node = self._next_probe_target()
                if node is not None:
                    self._spawn(self._probe_node(node))
            except Exception:
                log.exception("probe failed")

    def _next_probe_target(self) -> Optional[Node]:
        """Round-robin over a shuffled ring, skipping self/dead
        (state.go:214-256 probe)."""
        for _ in range(len(self._probe_ring) + 1):
            if not self._probe_ring:
                ring = [
                    n.name
                    for n in self.nodes.values()
                    if n.status in (NodeStatus.ALIVE, NodeStatus.SUSPECT)
                    and n.name != self.config.name
                ]
                self._rng.shuffle(ring)
                self._probe_ring = ring
                if not ring:
                    return None
            name = self._probe_ring.pop()
            node = self.nodes.get(name)
            if node and node.status in (NodeStatus.ALIVE, NodeStatus.SUSPECT):
                return node
        return None

    async def _probe_node(self, node: Node) -> None:
        profile = self.config.profile
        # The WHOLE probe cycle scales with local health, not just the
        # direct-ack wait (probeNode: `probeInterval = awareness.
        # ScaleTimeout(m.config.ProbeInterval)`, state.go:283-300) —
        # otherwise at score >= 1 the scaled direct wait eats the
        # cycle, the indirect/NACK phase is starved of its window, and
        # the missing NACKs ratchet the score to max (the opposite of
        # the Lifeguard rescue).  Same formula as the sim model
        # (models/lifeguard.py cycle = awareness_scaled_timeout(...)).
        cycle_deadline = asyncio.get_running_loop().time() + (
            self.awareness.scale_timeout(
                self.config.s(profile.probe_interval_ms)
            )
        )
        timeout = self.awareness.scale_timeout(
            self.config.s(profile.probe_timeout_ms)
        )
        seq = self._next_seq()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._ack_waiters[seq] = fut
        sent_at = time.monotonic()
        indirect_seq = None
        try:
            await self._send_msg(
                node.addr,
                wire.MessageType.PING,
                {"seq": seq, "node": node.name, "from": self.config.name},
            )
            try:
                _ts, ack = await asyncio.wait_for(fut, timeout)
                rtt = time.monotonic() - sent_at
                self.awareness.apply_delta(awareness_probe_delta(True))
                if self.config.notify_ping_complete:
                    self.config.notify_ping_complete(node, rtt, ack)
                return
            except asyncio.TimeoutError:
                pass

            # Indirect probes through k random peers (state.go:397-426).
            peers = self._k_random_nodes(
                profile.indirect_checks, exclude={node.name}
            )
            indirect_seq = self._next_seq()
            ifut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._ack_waiters[indirect_seq] = ifut
            self._nack_counts[indirect_seq] = 0
            for peer in peers:
                await self._send_msg(
                    peer.addr,
                    wire.MessageType.INDIRECT_PING,
                    {
                        "seq": indirect_seq,
                        "target": node.name,
                        "target_addr": node.addr,
                        "from": self.config.name,
                    },
                )
            # TCP fallback ping in parallel (state.go:438-454).  Indirect
            # acks are awaited only until the end of this probe cycle, so
            # the whole direct+indirect sequence fits one ProbeInterval.
            fallback = asyncio.create_task(self._tcp_fallback_ping(node))
            remaining = max(
                cycle_deadline - asyncio.get_running_loop().time(), 0.001
            )
            try:
                await asyncio.wait_for(ifut, remaining)
                fallback.cancel()
                self.awareness.apply_delta(awareness_probe_delta(True))
                return
            except asyncio.TimeoutError:
                pass
            except asyncio.CancelledError:
                fallback.cancel()
                raise
            finally:
                self._ack_waiters.pop(indirect_seq, None)
            try:
                if await fallback:
                    return
            except Exception:
                pass

            # No ack by any path: suspect (state.go:495-496), charging
            # our health score only the nacks that did NOT come back —
            # each received NACK proves our own links work.
            self.awareness.apply_delta(
                awareness_probe_delta(
                    False,
                    expected_nacks=len(peers),
                    nacks=self._nack_counts.get(indirect_seq, 0),
                )
            )
            self._suspect_node(
                {
                    "inc": node.incarnation,
                    "node": node.name,
                    "from": self.config.name,
                }
            )
        finally:
            self._ack_waiters.pop(seq, None)
            if indirect_seq is not None:
                self._nack_counts.pop(indirect_seq, None)

    async def _tcp_fallback_ping(self, node: Node) -> bool:
        try:
            stream = await self.transport.dial(
                node.addr, self.config.s(self.config.profile.probe_timeout_ms)
            )
        except Exception:
            return False
        try:
            await stream.send(self._seal(wire.encode(
                wire.MessageType.PING,
                {"seq": 0, "node": node.name, "from": self.config.name},
            )))
            raw = self._open(await stream.recv(
                timeout=self.config.s(self.config.profile.probe_timeout_ms)
            ))
            if raw is None:
                return False
            t, _ = wire.decode(raw)
            return t == wire.MessageType.ACK_RESP
        except Exception:
            return False
        finally:
            await stream.close()

    def _k_random_nodes(self, k: int, exclude: set[str]) -> list[Node]:
        """util.go:125-153 kRandomNodes."""
        candidates = [
            n
            for n in self.nodes.values()
            if n.status == NodeStatus.ALIVE
            and n.name != self.config.name
            and n.name not in exclude
        ]
        self._rng.shuffle(candidates)
        return candidates[:k]

    # ------------------------------------------------------------------
    # gossip plane (state.go:566-616)
    # ------------------------------------------------------------------

    async def _gossip_loop(self) -> None:
        profile = self.config.profile
        interval = self.config.s(profile.gossip_interval_ms)
        while not self._shutdown:
            await asyncio.sleep(interval)
            try:
                targets = self._gossip_targets(profile.gossip_nodes)
                for node in targets:
                    msgs = self._drain_broadcasts(
                        profile.udp_buffer_size - 16
                    )
                    if not msgs:
                        continue
                    payload = (
                        msgs[0] if len(msgs) == 1 else wire.make_compound(msgs)
                    )
                    await self.transport.write_to(
                        self._seal(payload), node.addr
                    )
            except Exception:
                log.exception("gossip failed")

    def _gossip_targets(self, k: int) -> list[Node]:
        """Gossip reaches alive/suspect nodes, plus dead ones for
        GossipToTheDead (state.go:572-590)."""
        dead_cutoff = self.config.s(self.config.profile.gossip_to_the_dead_ms)
        now = time.monotonic()
        candidates = [
            n
            for n in self.nodes.values()
            if n.name != self.config.name
            and (
                n.status in (NodeStatus.ALIVE, NodeStatus.SUSPECT)
                or (
                    n.status == NodeStatus.DEAD
                    and now - n.state_change < dead_cutoff
                )
            )
        ]
        self._rng.shuffle(candidates)
        return candidates[:k]

    # ------------------------------------------------------------------
    # push/pull anti-entropy (state.go:622-750)
    # ------------------------------------------------------------------

    async def _push_pull_loop(self) -> None:
        while not self._shutdown:
            base = self.config.s(self.config.profile.push_pull_interval_ms)
            scaled = push_pull_scale(base * 1000.0, self.num_alive()) / 1000.0
            await asyncio.sleep(scaled * (0.9 + 0.2 * self._rng.random()))
            nodes = self._k_random_nodes(1, exclude=set())
            if not nodes:
                continue
            try:
                await self._push_pull_node(nodes[0].addr, join=False)
            except Exception:
                log.debug("push/pull with %s failed", nodes[0].name)

    def _local_state_body(self, join: bool) -> dict:
        user = b""
        if self.config.local_state is not None:
            user = self.config.local_state(join)
        return {
            "join": join,
            "nodes": [n.snapshot() for n in self.nodes.values()],
            "user": user,
        }

    async def _push_pull_node(self, addr: str, join: bool) -> None:
        stream = await self.transport.dial(
            addr, self.config.s(self.config.profile.probe_timeout_ms) * 4
        )
        try:
            await stream.send(self._seal(wire.encode(
                wire.MessageType.PUSH_PULL, self._local_state_body(join)
            )))
            raw = self._open(await stream.recv(
                timeout=self.config.s(self.config.profile.probe_timeout_ms) * 4
            ))
            if raw is None:
                raise ConnectionError("push/pull response rejected")
            t, body = wire.decode(raw)
            if t != wire.MessageType.PUSH_PULL:
                raise ValueError(f"expected push/pull response, got {t}")
            self._merge_remote_state(body)
        finally:
            await stream.close()

    async def _stream_listener(self) -> None:
        while not self._shutdown:
            stream = await self.transport.accept_stream()
            self._spawn(self._handle_stream(stream))

    async def _handle_stream(self, stream: Stream) -> None:
        try:
            raw = self._open(await stream.recv(
                timeout=self.config.s(self.config.profile.probe_timeout_ms) * 8
            ))
            if raw is None:
                return
            t, body = wire.decode(raw)
            if t == wire.MessageType.PUSH_PULL:
                await stream.send(self._seal(wire.encode(
                    wire.MessageType.PUSH_PULL,
                    self._local_state_body(body.get("join", False)),
                )))
                self._merge_remote_state(body)
            elif t == wire.MessageType.PING:
                await stream.send(self._seal(wire.encode(
                    wire.MessageType.ACK_RESP,
                    self._ack_body(body.get("seq", 0)),
                )))
        except Exception:
            log.debug("stream handling failed", exc_info=True)
        finally:
            await stream.close()

    def _merge_remote_state(self, body: dict) -> None:
        """state.go:1283-1300 mergeState: replay each remote view through
        the local state machine."""
        for snap in body["nodes"]:
            status = NodeStatus(snap["status"])
            if status == NodeStatus.ALIVE:
                self._alive_node(snap)
            elif status == NodeStatus.SUSPECT:
                # Remote suspects are treated as suspect msgs (mergeState
                # passes them through suspectNode).
                self._suspect_node(
                    {"inc": snap["inc"], "node": snap["name"], "from": self.config.name}
                )
            elif status == NodeStatus.LEFT:
                # Preserve leave-vs-die: a LEFT snapshot replays as a
                # self-authored obituary so _dead_node classifies it LEFT
                # (mergeState keeps StateLeft distinct, state.go:1283+).
                self._dead_node(
                    {"inc": snap["inc"], "node": snap["name"],
                     "from": snap["name"]}
                )
            else:
                # A remote DEAD becomes a *suspicion* (state.go:1299
                # mergeState: "If the remote node believes a node is
                # dead, we prefer to suspect that node instead of
                # declaring it dead instantly") — crucially, a restarted
                # node merging its own obituary refutes it this way.
                self._suspect_node(
                    {"inc": snap["inc"], "node": snap["name"],
                     "from": self.config.name}
                )
        if self.config.merge_remote_state is not None and body.get("user"):
            self.config.merge_remote_state(body["user"], body.get("join", False))

    # ------------------------------------------------------------------
    # state machine (state.go:917-1300)
    # ------------------------------------------------------------------

    def _broadcast(self, msg_type: wire.MessageType, body: dict, name: str,
                   notify: Optional[Callable[[], None]] = None) -> None:
        self.broadcasts.queue(wire.encode(msg_type, body), name=name,
                              notify=notify)

    def _alive_node(self, a: dict, bootstrap: bool = False) -> None:
        name = a["name"]
        node = self.nodes.get(name)
        is_local = name == self.config.name

        if self.leaving and is_local and not bootstrap:
            return

        if node is None:
            node = Node(
                name=name,
                addr=a["addr"],
                incarnation=-1,
                status=NodeStatus.DEAD,
                meta=a.get("meta", b""),
            )
            self.nodes[name] = node

        inc = a["inc"]
        # Refute alive claims about us with a stale/competing incarnation
        # (aliveNode state.go:1015-1060): not applicable to v0 (no
        # address conflicts), but stale-inc filtering is.
        if not bootstrap and is_local:
            if inc <= node.incarnation:
                return
            # Someone else is advertising us at a newer incarnation:
            # re-assert ourselves.
            self._refute(node, inc)
            return

        if inc < node.incarnation and not is_local:
            return
        # An alive message only overrides suspect/dead with a *strictly*
        # newer incarnation (a refutation bumps it); ties lose to the
        # standing suspicion/obituary (aliveNode vs suspectNode/deadNode
        # precedence, state.go:917-1131).  The simulator implements the
        # same rule (swim.py accept_refute: ref_rx > inc_seen).
        if inc == node.incarnation and node.status != NodeStatus.ALIVE:
            if not (bootstrap and is_local):
                return
        if inc == node.incarnation and node.status == NodeStatus.ALIVE:
            if a.get("meta", node.meta) == node.meta and a.get(
                "addr", node.addr
            ) == node.addr:
                return

        was_dead = node.status in (NodeStatus.DEAD, NodeStatus.LEFT)
        was_alive = node.status == NodeStatus.ALIVE and node.incarnation >= 0
        changed_meta = a.get("meta", node.meta) != node.meta or (
            a.get("addr", node.addr) != node.addr
        )
        node.incarnation = inc
        node.addr = a.get("addr", node.addr)
        node.meta = a.get("meta", node.meta)
        if node.status != NodeStatus.ALIVE:
            node.status = NodeStatus.ALIVE
            node.state_change = time.monotonic()
        self._cancel_suspicion(name)
        self._broadcast(wire.MessageType.ALIVE, a, name=name)
        if (was_dead or bootstrap) and self.config.notify_join:
            self.config.notify_join(node)
        elif was_alive and changed_meta and self.config.notify_update:
            # Meta/addr change on a live node (EventDelegate.NotifyUpdate).
            self.config.notify_update(node)

    def _suspect_node(self, s: dict) -> None:
        name = s["node"]
        node = self.nodes.get(name)
        if node is None:
            return
        if s["inc"] < node.incarnation:
            return

        # Confirmation of an existing suspicion (state.go:1152-1157).
        timer = self._suspicions.get(name)
        if timer is not None:
            if timer.confirm(s["from"]):
                self._broadcast(wire.MessageType.SUSPECT, s, name=name)
            return

        if node.status != NodeStatus.ALIVE:
            return

        if name == self.config.name:
            self._refute(node, s["inc"])
            return

        self._broadcast(wire.MessageType.SUSPECT, s, name=name)
        node.incarnation = s["inc"]
        node.status = NodeStatus.SUSPECT
        changed_at = time.monotonic()
        node.state_change = changed_at

        profile = self.config.profile
        k = profile.suspicion_mult - 2
        n = self.num_alive()
        if n - 2 < k:
            k = 0
        min_s = (
            suspicion_timeout(
                profile.suspicion_mult, n, profile.probe_interval_ms
            )
            / 1000.0
            * self.config.interval_scale
        )
        max_s = profile.suspicion_max_timeout_mult * min_s

        def on_timeout(confirmations: int) -> None:
            cur = self.nodes.get(name)
            if (
                cur is not None
                and cur.status == NodeStatus.SUSPECT
                and cur.state_change == changed_at
            ):
                self._dead_node(
                    {
                        "inc": cur.incarnation,
                        "node": name,
                        "from": self.config.name,
                    }
                )

        # LHA-Suspicion: the minimum timeout scales with OUR health
        # score (shared awareness_scaled_timeout inside Suspicion) —
        # same math as the simulated model's expiry floor.
        self._suspicions[name] = Suspicion(
            s["from"], k, min_s, max_s, on_timeout,
            health_score=self.awareness.score,
        )

    def _dead_node(self, d: dict) -> None:
        name = d["node"]
        node = self.nodes.get(name)
        if node is None:
            return
        if d["inc"] < node.incarnation:
            return

        self._cancel_suspicion(name)

        if name == self.config.name and d["from"] != name and not self.leaving:
            # Someone declared us dead: refute (state.go:1246-1251).
            self._refute(node, d["inc"])
            return

        if node.status in (NodeStatus.DEAD, NodeStatus.LEFT):
            return

        self._broadcast(wire.MessageType.DEAD, d, name=name)
        node.incarnation = d["inc"]
        # An obituary authored by the node itself is an intentional leave.
        node.status = (
            NodeStatus.LEFT if d["from"] == name else NodeStatus.DEAD
        )
        node.state_change = time.monotonic()
        if self.config.notify_leave:
            self.config.notify_leave(node)

    def _refute(self, node: Node, accused_inc: int) -> None:
        """state.go:880-915: re-assert ourselves with a higher incarnation
        and a health penalty (Lifeguard)."""
        self.incarnation = max(self.incarnation + 1, accused_inc + 1)
        node.incarnation = self.incarnation
        node.status = NodeStatus.ALIVE
        self.awareness.apply_delta(1)
        self._broadcast(
            wire.MessageType.ALIVE,
            {
                "name": node.name,
                "addr": node.addr,
                "inc": self.incarnation,
                "status": int(NodeStatus.ALIVE),
                "meta": node.meta,
            },
            name=node.name,
        )

    def _cancel_suspicion(self, name: str) -> None:
        timer = self._suspicions.pop(name, None)
        if timer is not None:
            timer.stop()
