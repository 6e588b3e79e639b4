"""The sim↔host bridge: a Transport backed by the membership simulator.

The port of ``consul_tpu/net/sim_transport.py``.  The reference's
``memberlist.Transport`` interface (transport.go:28-66) is where a
simulated gossip plane can stand in for the kernel; the in-process
precedent is MockNetwork/MockTransport (mock_transport.go:14-66).  Here
the "network" on the other side of the transport is a *population*:
``n`` simulated SWIM members whose full N x N membership state advances
on the device through the port's dense
``models.membership.membership_round``.

A real host agent, the port's own :class:`consul_tpu_torch.net.Memberlist`
(and the serf-equivalent :class:`consul_tpu_torch.eventing.Cluster` above
it), attaches to a :class:`SimTransport` and takes part in the simulated
pool over the wire grammar (``net/wire.py``):

  host → sim   ``write_to("sim://j", packet)``: PING/INDIRECT_PING are
               answered from ground truth (crashed members drop
               packets, as a kernel socket would); ALIVE/SUSPECT/DEAD
               broadcasts are *injected* into row j of the simulated view
               matrix with a refreshed transmit budget, so host news
               spreads through the population; USER payloads (serf
               events) seed a per-event infection vector that spreads at
               the same fanout and loss.
  host → sim   ``dial("sim://j")``: TCP streams.  PUSH_PULL performs the
               full-state exchange (state.go:622-657): the response
               carries row j as node snapshots, and the host's own
               aliveness starts infecting the population.  PING is the
               fallback ping (state.go:438-454); a dial to a crashed
               member raises, like a refused connection.
  sim → host   each tick, simulated members that know the host gossip to
               it with the probability they would pick any other peer
               (fanout/n); their packets carry the top-priority entries
               of their *simulated* transmit queues, so the host hears
               of simulated failures as fast as the simulated protocol
               spreads them.  Simulated members also probe the host
               (state.go:214-256); a host that misses an ack deadline is
               suspected, and the suspicion is gossiped back so that the
               host's refutation (state.go:880-915) runs end to end.

Time: one tick is one gossip interval (``profile.gossip_interval_ms`` x
``interval_scale``).  The pump advances ticks on the wall clock when the
device keeps up and as fast as it can when it does not.

Every random draw is the reference's: the round keys are threefry
``fold_in(PRNGKey(seed), tick)``, and the host-side choices (which members
gossip to the host, which probe it) come from the same numpy generator in
the same order, so the port delivers the reference's packets byte for
byte.  The device state stays on the device; what the host needs of it
each tick is read in one copy per read site (the hosts' ``known`` vectors;
the senders' rows and event bits; every 16th tick the infections'
remaining budgets).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from consul_tpu_torch.device import resolve_device
from consul_tpu_torch.models.membership import (
    NEVER,
    RANK_ALIVE,
    RANK_LEFT,
    RANK_SUSPECT,
    RANK_DEAD,
    MembershipConfig,
    MembershipConstants,
    MembershipState,
    make_key,
    membership_constants,
    membership_init,
    membership_round,
)
from consul_tpu_torch.net import wire
from consul_tpu_torch.net.transport import Stream, Transport
from consul_tpu_torch.ops import (
    PRNGKey,
    bernoulli_mask,
    deliver_or,
    fold_in,
    sample_peers,
    split,
)
from consul_tpu_torch.protocol import LAN, GossipProfile

log = logging.getLogger("consul_tpu_torch.sim_transport")

_INJ_SLOTS = 128  # max host→sim view injections applied per tick
_INT32_MIN = -(2 ** 31)


def sim_addr(j: int) -> str:
    return f"sim://{j}"


def sim_name(j: int) -> str:
    return f"sim-{j}"


def parse_sim_addr(addr: str) -> Optional[int]:
    if addr.startswith("sim://"):
        try:
            return int(addr[6:])
        except ValueError:
            return None
    return None


def _scatter_index(j: int, n: int) -> Optional[int]:
    """Row ``j`` as the reference's scatters take a host index: a negative
    index counts from the end, and one out of range is dropped (None)."""
    if j < 0:
        j += n
    return j if 0 <= j < n else None


def _gather_index(j: int, n: int) -> int:
    """Row ``j`` as the reference's reads take a host index: negative from
    the end, then clamped into range."""
    if j < 0:
        j += n
    return min(max(j, 0), n - 1)


@dataclasses.dataclass(frozen=True)
class SimPoolConfig:
    """Static parameters of the simulated population behind the bridge."""

    n: int
    profile: GossipProfile = LAN
    loss: float = 0.0
    fanout: Optional[int] = None
    piggyback: int = 8
    fail_at: tuple = ()            # ((node, tick), ...) crashes
    leave_at: tuple = ()           # graceful departures
    join_at: tuple = ()            # late joiners
    interval_scale: float = 1.0    # wall seconds per protocol ms, like
                                   # MemberlistConfig.interval_scale
    seed: int = 0
    probe_host: bool = True        # simulated members probe the host
    realtime: bool = True          # pump sleeps to match wall-clock ticks

    def membership(self) -> MembershipConfig:
        return MembershipConfig(
            n=self.n,
            loss=self.loss,
            profile=self.profile,
            fanout=self.fanout,
            piggyback=self.piggyback,
            fail_at=self.fail_at,
            leave_at=self.leave_at,
            join_at=self.join_at,
        )

    @property
    def tick_seconds(self) -> float:
        return self.profile.gossip_interval_ms / 1000.0 * self.interval_scale


def _inject_and_step(
    state: MembershipState,
    inj_row: torch.Tensor,   # int32[_INJ_SLOTS], row index or n (drop)
    inj_col: torch.Tensor,   # int32[_INJ_SLOTS]
    inj_val: torch.Tensor,   # int32[_INJ_SLOTS] precedence keys
    rng: torch.Tensor,
    cfg: MembershipConfig,
    consts: MembershipConstants | None = None,
) -> MembershipState:
    """Apply host→sim view injections (each is one precedence-max, the
    same merge rule as any gossip delivery), refresh the transmit budget
    for cells that advanced so the population re-gossips the host's news,
    then run one protocol tick.

    A slot whose (row, col) lies outside the plane (the padding row ``n``)
    is dropped, as the reference's ``mode="drop"`` drops it: it reads cell
    0 and writes the identity of max there.  Duplicate slots take the
    largest value, and ``advanced`` compares against the key before any
    slot lands, as in the reference."""
    n = cfg.n
    row = torch.where(inj_row < 0, inj_row + n, inj_row).to(torch.int64)
    col = torch.where(inj_col < 0, inj_col + n, inj_col).to(torch.int64)
    live = (row >= 0) & (row < n) & (col >= 0) & (col < n)
    flat = torch.where(live, row * n + col, 0)
    advanced = inj_val > state.key.reshape(-1)[flat]
    key_m = state.key.clone()
    key_m.view(-1).scatter_reduce_(
        0, flat, torch.where(live, inj_val, _INT32_MIN), "amax")
    refresh = torch.where(advanced, cfg.tx_limit, -1).to(torch.int32)
    tx = state.tx.clone()
    tx.view(-1).scatter_reduce_(
        0, flat, torch.where(live, refresh, _INT32_MIN), "amax")
    state = state._replace(key=key_m, tx=tx)
    return membership_round(state, rng, cfg, consts)


def _infection_round(
    infected: torch.Tensor,      # bool[n]
    tx_ev: torch.Tensor,         # int32[n] remaining retransmissions
    participates: torch.Tensor,  # bool[n] ground-truth up
    rng: torch.Tensor,
    n: int,
    fanout: int,
    loss: float,
    tx_limit: int,
):
    """One epidemic tick for an opaque payload (a serf user event, or the
    news that the host exists): infected members with budget push
    ``fanout`` copies to uniform peers; survivors of Bernoulli loss who
    are up become infected with a fresh budget.  Mirrors
    models/broadcast.py's edges delivery (state.go:566-616 gossip)."""
    k_tgt, k_loss = split(rng).unbind(-2)
    senders = infected & (tx_ev > 0) & participates
    targets = sample_peers(k_tgt, n, fanout)
    ok = (
        senders[:, None]
        & bernoulli_mask(k_loss, (n, fanout), 1.0 - loss)
        & participates[targets.long()]
    )
    hit = deliver_or(torch.zeros_like(infected), targets, ok)
    newly = hit & ~infected & participates
    spent = torch.clamp(tx_ev - senders.to(torch.int32) * fanout, min=0)
    return infected | newly, torch.where(newly, tx_limit, spent)


class _Infection:
    """Host-side handle on one spreading payload."""

    def __init__(self, n: int, payload: Optional[bytes], device):
        self.infected = torch.zeros(n, dtype=torch.bool, device=device)
        self.tx = torch.zeros(n, dtype=torch.int32, device=device)
        self.payload = payload  # USER wire body; None for host-alive
        # An infection whose transmit budget is exhausted everywhere can
        # never spread further; it is skipped by the pump (and revived
        # by a fresh seed) so a long-lived host emitting many distinct
        # events doesn't accrete per-tick device work forever.
        self.done = False

    def seed(self, j: int, tx_limit: int) -> None:
        i = _scatter_index(j, self.infected.shape[0])
        if i is not None:
            self.infected = self.infected.clone()
            self.infected[i] = True
            self.tx = self.tx.clone()
            self.tx[i].clamp_(min=tx_limit)
        self.done = False


class _BridgeStream(Stream):
    """Host side of a dialed TCP stream into a simulated member: the
    bridge answers PUSH_PULL / fallback PING synchronously."""

    def __init__(self, bridge: "SimBridge", j: int, host: "SimTransport"):
        self._bridge = bridge
        self._j = j
        self._host = host
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._closed = False

    async def send(self, payload: bytes) -> None:
        if self._closed:
            raise ConnectionError("stream closed")
        t, body = wire.decode(payload)
        if t == wire.MessageType.PUSH_PULL:
            bridge = self._bridge
            key_row = bridge.state.key[
                _gather_index(self._j, bridge.cfg.n)].cpu().numpy()
            bridge._on_host_push_pull(self._j, body, self._host, key_row)
            self._inbox.put_nowait(
                wire.encode(
                    wire.MessageType.PUSH_PULL,
                    bridge._pool_state_body(self._j, key_row),
                )
            )
        elif t == wire.MessageType.PING:
            if self._bridge.up(self._j):
                self._inbox.put_nowait(
                    wire.encode(
                        wire.MessageType.ACK_RESP,
                        {"seq": body.get("seq", 0)},
                    )
                )

    async def recv(self, timeout: Optional[float] = None) -> bytes:
        if timeout is None:
            return await self._inbox.get()
        return await asyncio.wait_for(self._inbox.get(), timeout)

    async def close(self) -> None:
        self._closed = True


class SimTransport(Transport):
    """The host-facing endpoint.  One per attached host agent."""

    def __init__(self, bridge: "SimBridge", addr: str):
        self._bridge = bridge
        self._addr = addr
        self.packets: asyncio.Queue = asyncio.Queue()
        self.streams: asyncio.Queue = asyncio.Queue()
        self.closed = False
        # The population's knowledge that this host exists, spread
        # epidemically from the members the host joined through.
        self.known = _Infection(bridge.cfg.n, None, bridge.device)
        # Simulated probing of this host (state.go:214-256 from the
        # pool's perspective).
        self.ping_seq = 0
        self.pending_pings: dict[int, int] = {}  # seq -> deadline tick
        self.missed_pings = 0
        # Highest incarnation the host has asserted for itself (learned
        # from its ALIVE refutation broadcasts); suspicions the pool
        # raises must cite it or the host's _suspect_node drops them as
        # stale (state.go:1134 acceptance rule).
        self.host_inc = 0

    def local_addr(self) -> str:
        return self._addr

    async def write_to(self, payload: bytes, addr: str) -> float:
        if self.closed:
            raise ConnectionError("transport shut down")
        j = parse_sim_addr(addr)
        if j is not None:
            self._bridge._on_host_packet(j, payload, self)
        else:
            # Host→host packets (two real agents sharing one simulated
            # pool) route directly, like MockNetwork.
            peer = self._bridge.hosts.get(addr)
            if peer is not None and not peer.closed:
                peer.packets.put_nowait(
                    (payload, self._addr, time.monotonic())
                )
        return time.monotonic()

    async def recv_packet(self) -> tuple[bytes, str, float]:
        return await self.packets.get()

    async def dial(self, addr: str, timeout: float) -> Stream:
        j = parse_sim_addr(addr)
        if j is None:
            raise ConnectionError(f"not a simulated address: {addr}")
        if not self._bridge.up(j):
            raise ConnectionError(f"connection refused: {addr}")
        return _BridgeStream(self._bridge, j, self)

    async def accept_stream(self) -> Stream:
        return await self.streams.get()

    async def shutdown(self) -> None:
        self.closed = True
        self._bridge.hosts.pop(self._addr, None)


class SimBridge:
    """Owns the simulated population and pumps protocol ticks.

    ``device`` is where the population lives: CUDA unless the caller
    passes another (``device="cpu"``); without a GPU it must be given."""

    def __init__(self, cfg: SimPoolConfig, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mcfg = cfg.membership()
        self.state = membership_init(self.mcfg, self.device)
        self._consts = membership_constants(self.mcfg, self.device)
        self.tick = 0
        self.hosts: dict[str, SimTransport] = {}
        self.events: dict[bytes, _Infection] = {}  # USER payload -> spread
        self._inject: list[tuple[int, int, int]] = []  # (row, col, keyval)
        self._base_rng = PRNGKey(cfg.seed, self.device)
        self._host_rng = np.random.default_rng(cfg.seed + 1)
        self._pump_task: Optional[asyncio.Task] = None
        self._shutdown = False
        self._fail = {node: t for node, t in cfg.fail_at}
        self._leave = {node: t for node, t in cfg.leave_at}
        self._join = {node: t for node, t in cfg.join_at}
        # The device copy of the ground-truth ``participates`` vector,
        # uploaded again only when a schedule changes it.
        self._up_host: Optional[np.ndarray] = None
        self._up_dev: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    # ground truth
    # ------------------------------------------------------------------

    def up(self, j: int, at_tick: Optional[int] = None) -> bool:
        """Is member j actually up (present, not crashed, not departed)
        at the given tick — the same ``participates`` predicate the
        device round computes from the schedules."""
        t = self.tick if at_tick is None else at_tick
        if t < self._join.get(j, 0):
            return False
        if t >= self._fail.get(j, NEVER):
            return False
        leave = self._leave.get(j)
        if leave is not None and t >= leave + self.mcfg.leave_grace_ticks:
            return False
        return True

    def _participates_np(self) -> np.ndarray:
        out = np.ones(self.cfg.n, dtype=bool)
        for j, t in self._join.items():
            if self.tick < t:
                out[j] = False
        for j, t in self._fail.items():
            if self.tick >= t:
                out[j] = False
        for j, t in self._leave.items():
            if self.tick >= t + self.mcfg.leave_grace_ticks:
                out[j] = False
        return out

    def _participates(self) -> torch.Tensor:
        up = self._participates_np()
        if self._up_host is None or not np.array_equal(up, self._up_host):
            self._up_host, self._up_dev = up, self._upload(up)
        return self._up_dev

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the bridge's device; to a GPU through pinned memory,
        so the copy does not wait for the device."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def transport(self, addr: str) -> SimTransport:
        t = SimTransport(self, addr)
        self.hosts[addr] = t
        return t

    async def start(self) -> None:
        self._pump_task = asyncio.create_task(self._pump())

    async def shutdown(self) -> None:
        self._shutdown = True
        if self._pump_task is not None:
            self._pump_task.cancel()

    async def _pump(self) -> None:
        tick_s = self.cfg.tick_seconds
        while not self._shutdown:
            t0 = time.monotonic()
            await self.step()
            if self.cfg.realtime:
                elapsed = time.monotonic() - t0
                await asyncio.sleep(max(tick_s - elapsed, 0.0))
            else:
                await asyncio.sleep(0)  # yield to host tasks

    async def run_ticks(self, k: int) -> None:
        """Advance k ticks, yielding to the host between each (used by
        tests and non-realtime studies instead of ``start``)."""
        for _ in range(k):
            await self.step()
            await asyncio.sleep(0)

    # ------------------------------------------------------------------
    # one tick
    # ------------------------------------------------------------------

    async def step(self) -> None:
        rng = fold_in(self._base_rng, self.tick)
        inj = self._inject[:_INJ_SLOTS]
        del self._inject[: len(inj)]
        slots = np.empty((3, _INJ_SLOTS), np.int32)
        slots[0], slots[1], slots[2] = self.cfg.n, 0, -1
        for i, (r, c, v) in enumerate(inj):
            slots[0, i], slots[1, i], slots[2, i] = r, c, v
        rows, cols, vals = self._upload(slots).unbind(0)
        self.state = _inject_and_step(
            self.state, rows, cols, vals, rng, self.mcfg, self._consts
        )

        participates = self._participates()
        k_inf = fold_in(rng, 0xE0E0)
        stepped = []
        # ``i`` counts every infection, those skipped as done too, so
        # each keeps its key stream.
        for i, infection in enumerate(
            list(self.events.values())
            + [h.known for h in self.hosts.values()]
        ):
            if infection.done:
                continue
            infection.infected, infection.tx = _infection_round(
                infection.infected,
                infection.tx,
                participates,
                fold_in(k_inf, i),
                self.cfg.n,
                self.mcfg.fanout,
                self.cfg.loss,
                self.mcfg.tx_limit,
            )
            stepped.append(infection)
        if self.tick % 16 == 0 and stepped:
            budgets = torch.stack([inf.tx.max() for inf in stepped]).cpu()
            for infection, left in zip(stepped, budgets.tolist()):
                if left == 0:
                    infection.done = True

        self.tick += 1
        up_np = self._participates_np()
        hosts = list(self.hosts.values())
        if not hosts:
            return
        known_all = torch.stack([h.known.infected for h in hosts]).cpu()
        for host, known_np in zip(hosts, known_all.numpy()):
            self._deliver_to_host(host, up_np, known_np)
            if self.cfg.probe_host:
                self._probe_host(host, up_np, known_np)

    # ------------------------------------------------------------------
    # sim → host
    # ------------------------------------------------------------------

    def _deliver_to_host(
        self, host: SimTransport, up: np.ndarray, known: np.ndarray
    ) -> None:
        """Members that know the host include it in their gossip target
        selection like any other peer: P(host among fanout picks) ≈
        fanout/n, so expected packets/tick ≈ knowers·fanout/n
        (state.go:566-616 gossip + kRandomNodes)."""
        if host.closed:
            return
        knowers = np.flatnonzero(known & up)
        if knowers.size == 0:
            return
        p = min(self.mcfg.fanout / max(self.cfg.n, 1), 1.0)
        count = self._host_rng.binomial(knowers.size, p)
        if count == 0:
            return
        senders = self._host_rng.choice(
            knowers, size=min(count, knowers.size), replace=False
        )
        if self.cfg.loss > 0:
            senders = senders[
                self._host_rng.random(senders.size) >= self.cfg.loss
            ]
        for i, view in zip(senders, self._sender_views(senders)):
            packet = self._build_gossip_packet(int(i), *view)
            if packet is not None:
                host.packets.put_nowait(
                    (packet, sim_addr(int(i)), time.monotonic())
                )

    def _sender_views(self, senders: np.ndarray) -> list:
        """For each sender, ``(tx_row, key_row, user_bodies)``: its
        transmit budgets and view keys, and the USER bodies it still
        gossips (infected with budget left, in the order the events were
        seeded), all read in one copy from the device."""
        if senders.size == 0:
            return []
        n = self.cfg.n
        idx = self._upload(senders.astype(np.int64))
        live = [(body, inf) for body, inf in self.events.items()
                if not inf.done]
        block = torch.cat(
            [self.state.tx[idx], self.state.key[idx]]
            + [(inf.infected[idx] & (inf.tx[idx] > 0))[:, None]
               .to(torch.int32) for _, inf in live],
            dim=1,
        ).cpu().numpy()
        return [
            (row[:n], row[n:2 * n],
             [body for (body, _), bit in zip(live, row[2 * n:]) if bit])
            for row in block
        ]

    def _build_gossip_packet(
        self, i: int, tx_row: np.ndarray, key_row: np.ndarray,
        user_bodies: list,
    ) -> Optional[bytes]:
        """Drain member i's simulated transmit queue into one compound
        packet, highest remaining budget first — the same priority rule
        the device round uses (queue.go:288-373 GetBroadcasts) — then the
        user events it still gossips."""
        queued = np.flatnonzero((tx_row > 0) & (key_row >= 0))
        msgs: list[bytes] = []
        if queued.size:
            order = queued[np.argsort(-tx_row[queued], kind="stable")]
            for j in order[: self.cfg.piggyback]:
                msgs.append(self._view_message(i, int(j), int(key_row[j])))
        for body in user_bodies:
            # body is the already-encoded msgpack tail of the USER
            # message as it arrived; re-prefix the type byte only.
            msgs.append(bytes([wire.MessageType.USER]) + body)
        if not msgs:
            return None
        return msgs[0] if len(msgs) == 1 else wire.make_compound(msgs)

    def _view_message(self, i: int, j: int, keyval: int) -> bytes:
        """Encode member i's view of j as the wire message the reference
        would gossip (alive/suspect/dead, state.go:917-1279)."""
        inc, rank = keyval >> 2, keyval & 3
        name = sim_name(j)
        if rank == RANK_ALIVE:
            return wire.encode(
                wire.MessageType.ALIVE,
                {
                    "name": name,
                    "addr": sim_addr(j),
                    "inc": inc,
                    "status": 0,
                    "meta": b"",
                },
            )
        if rank == RANK_SUSPECT:
            return wire.encode(
                wire.MessageType.SUSPECT,
                {"inc": inc, "node": name, "from": sim_name(i)},
            )
        # DEAD, or LEFT as a self-authored obituary (leave-vs-die,
        # state.go deadNode -> StateLeft).
        author = name if rank == RANK_LEFT else sim_name(i)
        return wire.encode(
            wire.MessageType.DEAD,
            {"inc": inc, "node": name, "from": author},
        )

    def _probe_host(
        self, host: SimTransport, up: np.ndarray, known: np.ndarray
    ) -> None:
        """Simulated members probe the host once per probe interval in
        expectation; a missed ack deadline gossips a suspect-host
        message back so the host's refutation path runs
        (state.go:214-256, 880-915).  Deadlines are tick-denominated so
        the pump's time model (which may run slower than wall clock)
        never produces spurious suspicion."""
        if host.closed:
            return
        now = time.monotonic()
        for seq, deadline in list(host.pending_pings.items()):
            if self.tick >= deadline:
                del host.pending_pings[seq]
                host.missed_pings += 1
                # The prober suspects the host; the suspicion reaches
                # the host through gossip and it refutes.
                prober = int(self._host_rng.integers(self.cfg.n))
                host.packets.put_nowait(
                    (
                        wire.encode(
                            wire.MessageType.SUSPECT,
                            {
                                "inc": host.host_inc,
                                "node": self._host_name(host),
                                "from": sim_name(prober),
                            },
                        ),
                        sim_addr(prober),
                        now,
                    )
                )
        if self.tick % self.mcfg.probe_interval_ticks != 0:
            return
        knowers = np.flatnonzero(known & up)
        if knowers.size == 0:
            return
        # One member probes one target per interval; the host is picked
        # with probability 1/n by each of the knowers.
        if self._host_rng.random() >= min(knowers.size / self.cfg.n, 1.0):
            return
        prober = int(self._host_rng.choice(knowers))
        host.ping_seq += 1
        seq = host.ping_seq
        # Ack must land within the probe cycle (probe_interval ticks),
        # with slack for the host's event loop to run between ticks.
        host.pending_pings[seq] = (
            self.tick + 2 * self.mcfg.probe_interval_ticks + 2
        )
        host.packets.put_nowait(
            (
                wire.encode(
                    wire.MessageType.PING,
                    {
                        "seq": -seq,
                        "node": self._host_name(host),
                        "from": sim_name(prober),
                    },
                ),
                sim_addr(prober),
                now,
            )
        )

    def _host_name(self, host: SimTransport) -> str:
        # Hosts register their memberlist name via transport addr
        # "sim-host://<name>".
        addr = host.local_addr()
        return addr.split("://", 1)[1] if "://" in addr else addr

    # ------------------------------------------------------------------
    # host → sim
    # ------------------------------------------------------------------

    def _on_host_packet(
        self, j: int, payload: bytes, host: SimTransport
    ) -> None:
        if not payload:
            return
        if payload[0] == wire.MessageType.COMPOUND:
            for part in wire.split_compound(payload):
                self._on_host_packet(j, part, host)
            return
        try:
            t, body = wire.decode(payload)
        except Exception:
            return
        target_up = self.up(j)
        if t == wire.MessageType.PING:
            # A crashed member's kernel answers nothing; an up member's
            # memberlist acks (net.go handlePing).
            if target_up:
                self._ack_host(host, j, body.get("seq", 0))
        elif t == wire.MessageType.INDIRECT_PING:
            if not target_up:
                return
            k = parse_sim_addr(body.get("target_addr", ""))
            seq = body.get("seq", 0)
            if k is not None and self.up(k):
                self._ack_host(host, j, seq)
            else:
                host.packets.put_nowait(
                    (
                        wire.encode(
                            wire.MessageType.NACK_RESP, {"seq": seq}
                        ),
                        sim_addr(j),
                        time.monotonic(),
                    )
                )
        elif t == wire.MessageType.ACK_RESP:
            # Host answering a simulated probe of it.
            seq = -body.get("seq", 0)
            if host.pending_pings.pop(seq, None) is not None:
                host.missed_pings = 0
        elif t in (
            wire.MessageType.ALIVE,
            wire.MessageType.SUSPECT,
            wire.MessageType.DEAD,
        ):
            if target_up:
                self._inject_view(j, t, body, host)
        elif t == wire.MessageType.USER:
            if target_up:
                self._seed_event(j, payload)

    def _ack_host(self, host: SimTransport, j: int, seq) -> None:
        host.packets.put_nowait(
            (
                wire.encode(wire.MessageType.ACK_RESP, {"seq": seq}),
                sim_addr(j),
                time.monotonic(),
            )
        )

    def _inject_view(
        self, j: int, t: wire.MessageType, body: dict, host: SimTransport
    ) -> None:
        """A host broadcast about some member lands at simulated member
        j: merge it into row j by precedence (aliveNode/suspectNode/
        deadNode acceptance, state.go:917-1222) and let the population
        re-gossip it."""
        name = body.get("name") or body.get("node")
        if name == self._host_name(host):
            # News about the host itself: existence/refutation.
            if t == wire.MessageType.ALIVE:
                host.known.seed(j, self.mcfg.tx_limit)
                host.host_inc = max(host.host_inc, int(body.get("inc", 0)))
            return
        if not isinstance(name, str) or not name.startswith("sim-"):
            return
        try:
            subject = int(name[4:])
        except ValueError:
            return
        if not 0 <= subject < self.cfg.n:
            return
        inc = int(body.get("inc", 0))
        if t == wire.MessageType.ALIVE:
            rank = RANK_ALIVE
        elif t == wire.MessageType.SUSPECT:
            rank = RANK_SUSPECT
        else:
            rank = RANK_LEFT if body.get("from") == name else RANK_DEAD
        self._inject.append((j, subject, make_key(inc, rank)))

    def _seed_event(self, j: int, payload: bytes) -> None:
        body = bytes(payload[1:])
        infection = self.events.get(body)
        if infection is None:
            infection = _Infection(self.cfg.n, body, self.device)
            self.events[body] = infection
        infection.seed(j, self.mcfg.tx_limit)

    def _on_host_push_pull(
        self, j: int, body: dict, host: SimTransport, key_row: np.ndarray
    ) -> None:
        """Host side of pushPullNode (state.go:622-657): the host pushed
        its state; the population learns the host exists (and would
        learn any other real members the host knows, but those route
        host↔host).  Only entries that actually ADVANCE row j are
        queued for injection — a periodic push/pull is otherwise almost
        entirely no-ops and would flood the per-tick injection budget."""
        host.known.seed(j, self.mcfg.tx_limit)
        for snap in body.get("nodes", ()):
            name = snap.get("name", "")
            if name == self._host_name(host):
                continue
            if isinstance(name, str) and name.startswith("sim-"):
                try:
                    subject = int(name[4:])
                except ValueError:
                    continue
                if 0 <= subject < self.cfg.n:
                    status = int(snap.get("status", 0))
                    keyval = make_key(int(snap.get("inc", 0)), status)
                    if keyval > int(key_row[subject]):
                        self._inject.append((j, subject, keyval))

    def _pool_state_body(self, j: int, key_row: np.ndarray) -> dict:
        """Row j as push/pull node snapshots (the response half of the
        full-state exchange, state.go:1283 mergeState input)."""
        known = np.flatnonzero(key_row >= 0)
        nodes = []
        for c in known:
            keyval = int(key_row[c])
            nodes.append(
                {
                    "name": sim_name(int(c)),
                    "addr": sim_addr(int(c)),
                    "inc": keyval >> 2,
                    "status": keyval & 3,
                    "meta": b"",
                }
            )
        return {"join": False, "nodes": nodes, "user": b""}

    # ------------------------------------------------------------------
    # instrumentation
    # ------------------------------------------------------------------

    def event_coverage(self, payload_body: Optional[bytes] = None) -> float:
        """Fraction of up members infected by a user event."""
        if not self.events:
            return 0.0
        if payload_body is None:
            infection = next(iter(self.events.values()))
        else:
            match = [
                inf
                for body, inf in self.events.items()
                if payload_body in body
            ]
            if not match:
                return 0.0
            infection = match[0]
        up = self._participates_np()
        infected = infection.infected.cpu().numpy()
        denom = max(int(up.sum()), 1)
        return float((infected & up).sum()) / denom

    def host_awareness(self, host: SimTransport) -> float:
        """Fraction of up members that know the host exists."""
        up = self._participates_np()
        known = host.known.infected.cpu().numpy()
        return float((known & up).sum()) / max(int(up.sum()), 1)
