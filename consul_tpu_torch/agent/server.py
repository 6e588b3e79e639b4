"""The Server: raft quorum member owning the replicated catalog; the
port's copy of ``consul_tpu/agent/server.py``.

Equivalent of ``agent/consul/server.go`` + ``leader.go`` (SURVEY.md
§2.2): owns the raft node, FSM, state store, LAN serf pool, the RPC
listener, and — when leader — the reconcile/GC/session loops.

Wiring mirrored from the reference:

  serf tags           server_serf.go:35-120 — servers advertise
                      role/dc/id/expect and their RPC address in serf
                      node meta; peers discover each other from tags
  bootstrap           serf_server.go maybeBootstrap — wait until
                      bootstrap_expect servers are visible, then all
                      bootstrap the same deterministic voter set
  raft-over-RPC       server.go raftLayer — raft traffic is stream
                      type byte 1 on the shared RPC listener
  leader loop         leader.go:52,153 monitorLeadership/leaderLoop —
                      reconcile serf membership into the catalog,
                      add/remove raft peers, tombstone GC, session TTLs
  reconcile           leader.go:1075-1280 reconcileMember/
                      handleAliveMember/handleFailedMember/
                      handleLeftMember
  coordinate batching coordinate_endpoint.go:48 — Coordinate.Update
                      RPCs buffered and flushed as one raft entry per
                      CoordinateUpdatePeriod
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Optional

from consul_tpu_torch.agent import endpoints as eps
from consul_tpu_torch.agent.fsm import ConsulFSM, MessageType
from consul_tpu_torch.agent.rpc import (
    ERR_NO_LEADER,
    ERR_PERMISSION_DENIED,
    RPC_RAFT,
    RPCClient,
    RPCError,
    RPCServer,
    RaftRPCAdapter,
    rpc_timeout_for,
)
from consul_tpu_torch.consensus.raft import NotLeaderError, RaftConfig, RaftNode
from consul_tpu_torch.eventing.cluster import (
    Cluster,
    ClusterConfig,
    Event,
    EventType,
    Member,
    MemberStatus,
)
from consul_tpu_torch.agent.router import Router
from consul_tpu_torch.net.transport import Transport
from consul_tpu_torch.protocol import LAN, WAN, GossipProfile
from consul_tpu_torch.store.state import (
    HEALTH_CRITICAL,
    HEALTH_PASSING,
    SERF_CHECK_ID,
)

log = logging.getLogger("consul_tpu_torch.server")

SERF_CHECK_NAME = "Serf Health Status"


@dataclasses.dataclass
class ServerConfig:
    node_name: str
    datacenter: str = "dc1"
    bootstrap_expect: int = 1
    profile: GossipProfile = LAN
    gossip_interval_scale: float = 1.0
    # Leader cadences (leader.go / config.go defaults, scaled down for
    # in-proc tests the same way the reference's test configs do).
    reconcile_interval_s: float = 60.0
    tombstone_ttl_s: float = 15 * 60.0
    tombstone_granularity_s: float = 30.0
    coordinate_update_period_s: float = 5.0
    session_ttl_sweep_s: float = 1.0
    # Raft timings forwarded to RaftConfig.
    raft_heartbeat_s: float = 0.05
    raft_election_min_s: float = 0.15
    raft_election_max_s: float = 0.30
    # WAN pool timing profile (config.go:314-327 DefaultWANConfig) and
    # LAN->WAN flooder cadence (agent/consul/flood.go loop).
    wan_profile: GossipProfile = WAN
    flood_interval_s: float = 1.0
    # Serf gossip snapshot + auto-rejoin (serf/snapshot.go, RejoinAfterLeave).
    serf_snapshot_path: str = ""
    rejoin_after_leave: bool = False
    # Autopilot (consul/autopilot/autopilot.go): dead raft servers are
    # pruned once they have been failed for the grace window, never
    # removing more than (voters-1)//2 so quorum is preserved.
    autopilot_cleanup_dead_servers: bool = True
    autopilot_interval_s: float = 10.0
    autopilot_grace_s: float = 10.0
    # autopilot.go promoteStableServers: a staging (non-voter) server is
    # promoted once continuously healthy for this long.
    autopilot_server_stabilization_s: float = 10.0
    # structs.AutopilotConfig MaxTrailingLogs: a server whose log trails
    # the leader by more than this is unhealthy.
    autopilot_max_trailing_logs: int = 250
    # Gossip encryption keyring (shared LAN/WAN, security.go).
    keyring: object = None
    # WAN replication (leader.go:834-979 + {acl,config}_replication.go):
    # non-primary DCs pull config entries + ACL policies/tokens from the
    # primary and converge their local raft state.
    primary_datacenter: str = ""
    replication_interval_s: float = 30.0
    acl_replication_token: str = ""
    # ACL system (agent/config: acl.enabled / default_policy / tokens.master).
    acl_enabled: bool = False
    acl_default_policy: str = "allow"   # "allow" | "deny"
    acl_master_token: str = ""
    acl_token_ttl_s: float = 30.0
    # acl_token_exp.go: leader sweep cadence for expired-token GC.
    acl_token_reap_interval_s: float = 5.0
    # leader_federation_state_ae.go: cadence for publishing this DC's
    # mesh-gateway set to the primary.
    federation_state_ae_interval_s: float = 30.0
    # auto_config_endpoint.go authorizer: when set, clients may
    # bootstrap via AutoConfig.InitialConfiguration with a JWT matching
    # this spec ({jwt_secret | jwt_validation_pub_keys, bound_issuer,
    # bound_audiences, claim_mappings, claim_assertions}).
    auto_config_authorizer: Optional[dict] = None
    # Network segments (server_serf.go:50 segmentLAN + types/area.go):
    # names of the additional LAN gossip rings this server bridges.
    # Clients join exactly ONE ring; servers join them all, so segment
    # members stay isolated from each other's gossip but every segment
    # reaches the servers.
    segments: tuple = ()


class Server:
    """One Consul server (``consul.Server``)."""

    def __init__(
        self,
        config: ServerConfig,
        gossip_transport: Transport,
        rpc_transport: Transport,
        wan_transport: Optional[Transport] = None,
        segment_transports: Optional[dict[str, Transport]] = None,
    ):
        self.config = config
        # Change-stream pub/sub fed by the FSM (stream/event_publisher.go
        # wired at state/memdb.go:37-41), served by Subscribe RPCs.
        from consul_tpu_torch.stream import EventPublisher

        self.publisher = EventPublisher()
        self.fsm = ConsulFSM(publisher=self.publisher)
        self.store = self.fsm.store

        # ACL resolution against the replicated token/policy tables
        # (agent/consul/acl.go ACLResolver; cache TTL = ACLTokenTTL).
        from consul_tpu_torch.acl import ACLResolver

        self.acl = ACLResolver(
            token_lookup=self.store.acl_token_get,
            policy_lookup=self.store.acl_policy_get,
            role_lookup=self.store.acl_role_get,
            enabled=config.acl_enabled,
            default_policy=config.acl_default_policy,
            master_token=config.acl_master_token,
            ttl_s=config.acl_token_ttl_s,
        )

        # RPC plane (port 8300 analogue; serf rides gossip_transport).
        self.rpc_transport = rpc_transport
        self.rpc_server = RPCServer(rpc_transport)
        self.rpc_client = RPCClient(rpc_transport)
        self._raft_rpc_client = RPCClient(rpc_transport, rpc_type=RPC_RAFT)
        self.raft_adapter = RaftRPCAdapter(
            self._raft_rpc_client, self._raft_peer_addr
        )
        self.rpc_server.bind_raft(self.raft_adapter.handle)

        # Gossip plane: LAN serf pool with server tags.
        lan_tags = {
            "role": "consul",
            "dc": config.datacenter,
            "id": config.node_name,
            "rpc_addr": rpc_transport.local_addr(),
            "expect": str(config.bootstrap_expect),
        }
        if wan_transport is not None:
            # Advertised so peers' flooders can join us into the WAN
            # pool (serf_flooder.go reads the wan port from tags).
            lan_tags["wan_addr"] = wan_transport.local_addr()
        self.serf = Cluster(
            ClusterConfig(
                name=config.node_name,
                tags=lan_tags,
                profile=config.profile,
                interval_scale=config.gossip_interval_scale,
                on_event=self._on_serf_event,
                snapshot_path=config.serf_snapshot_path or None,
                rejoin_after_leave=config.rejoin_after_leave,
                keyring=config.keyring,
            ),
            gossip_transport,
        )

        # WAN pool (server.go:506 setupSerf(WAN)): servers of every DC,
        # named "<node>.<dc>" (server_serf.go), slower timing profile.
        self.serf_wan: Optional[Cluster] = None
        if wan_transport is not None:
            self.serf_wan = Cluster(
                ClusterConfig(
                    name=f"{config.node_name}.{config.datacenter}",
                    tags={
                        "role": "consul",
                        "dc": config.datacenter,
                        "id": config.node_name,
                        "rpc_addr": rpc_transport.local_addr(),
                    },
                    profile=config.wan_profile,
                    interval_scale=config.gossip_interval_scale,
                    queue_events=False,  # router reads members directly
                    keyring=config.keyring,
                ),
                wan_transport,
            )
        self.router = Router(config.datacenter, self.serf_wan)

        # Segment rings (server_serf.go segmentLAN map): one extra serf
        # pool per configured segment, same server tags + the segment
        # name so clients of that ring discover us.
        self.segment_serfs: dict[str, Cluster] = {}
        for seg_name in config.segments:
            transport = (segment_transports or {}).get(seg_name)
            if transport is None:
                raise ValueError(
                    f"segment {seg_name!r} has no gossip transport"
                )
            self.segment_serfs[seg_name] = Cluster(
                ClusterConfig(
                    name=config.node_name,
                    tags={**lan_tags, "segment": seg_name},
                    profile=config.profile,
                    interval_scale=config.gossip_interval_scale,
                    keyring=config.keyring,
                ),
                transport,
            )

        # Mesh-gateway locator for wan federation (gateway_locator.go).
        from consul_tpu_torch.connect.gateways import GatewayLocator

        self.gateway_locator = GatewayLocator(
            self.store, config.datacenter,
            config.primary_datacenter or config.datacenter,
        )

        self.raft: Optional[RaftNode] = None
        # Built-in Connect CA, created lazily on the leader (the private
        # key never leaves it; the root record replicates via raft).
        self._connect_ca = None
        self._connect_ca_lock = asyncio.Lock()
        self._bootstrap_disabled = False
        self._bootstrapping = False
        self._leader_tasks: list[asyncio.Task] = []
        self._tasks: list[asyncio.Task] = []
        self._reconcile_wake = asyncio.Event()
        self._coord_updates: dict[str, dict] = {}
        self._session_deadlines: dict[str, float] = {}
        self._tombstone_marks: list[tuple[float, int]] = []
        # Autopilot server-health records (autopilot.go clusterHealth)
        # + the static defaults replicated overrides layer over.
        self._server_health: dict[str, dict] = {}
        self._autopilot_defaults = {
            "autopilot_cleanup_dead_servers":
                config.autopilot_cleanup_dead_servers,
            "autopilot_grace_s": config.autopilot_grace_s,
            "autopilot_server_stabilization_s":
                config.autopilot_server_stabilization_s,
            "autopilot_max_trailing_logs":
                config.autopilot_max_trailing_logs,
        }
        self._shutdown = False

        # RPC endpoint services (server_oss.go:8-23).
        for name, ep in eps.build_endpoints(self).items():
            self.rpc_server.register(name, ep)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        await self.rpc_server.start()
        await self.serf.start()
        if self.serf_wan is not None:
            await self.serf_wan.start()
            self._tasks.append(asyncio.create_task(self._flood_loop()))
        for seg in self.segment_serfs.values():
            await seg.start()
            self._tasks.append(
                asyncio.create_task(self._segment_event_pump(seg))
            )
        self._tasks.append(asyncio.create_task(self._serf_event_pump()))
        # Snapshot auto-rejoin BEFORE bootstrap so a restarted server
        # re-discovers the established cluster instead of re-expecting
        # (serf/snapshot.go AliveNodes + server_serf.go RejoinAfterLeave).
        rejoined = await self.serf.auto_rejoin()
        if rejoined:
            log.info("auto-rejoined %d node(s) from gossip snapshot", rejoined)
        await self._maybe_bootstrap()

    async def join(self, addrs: list[str]) -> int:
        return await self.serf.join(addrs)

    async def join_segment(self, segment: str, addrs: list[str]) -> int:
        """Join peers of one segment ring (agent.go JoinLAN w/ segment
        port selection)."""
        seg = self.segment_serfs.get(segment)
        if seg is None:
            raise RPCError(f"unknown network segment {segment!r}")
        return await seg.join(addrs)

    async def _segment_event_pump(self, seg: Cluster) -> None:
        """Membership changes on a segment ring feed the same reconcile
        path as the main ring (server_serf.go lanEventHandler runs per
        segment)."""
        while not self._shutdown:
            await seg.events.get()
            self._reconcile_wake.set()

    async def join_wan(self, addrs: list[str]) -> int:
        """Join the WAN pool (server.go JoinWAN / `consul join -wan`)."""
        if self.serf_wan is None:
            raise RPCError("WAN gossip not configured")
        return await self.serf_wan.join(addrs)

    async def _flood_loop(self) -> None:
        """LAN→WAN flooder (agent/consul/flood.go:27-60 + router/
        serf_flooder.go): any server seen on the LAN but missing from
        the WAN pool gets joined in via its advertised wan_addr, so one
        explicit WAN join per DC suffices to federate every server."""
        while not self._shutdown:
            await asyncio.sleep(self.config.flood_interval_s)
            try:
                wan_names = {
                    m.tags.get("id")
                    for m in self.serf_wan.members.values()
                    if m.status == MemberStatus.ALIVE
                    and m.tags.get("dc") == self.config.datacenter
                }
                for m in list(self.serf.members.values()):
                    if (
                        m.status == MemberStatus.ALIVE
                        and m.tags.get("role") == "consul"
                        and m.tags.get("wan_addr")
                        and m.tags.get("id") not in wan_names
                    ):
                        await self.serf_wan.join([m.tags["wan_addr"]])
            except Exception:
                log.exception("flood loop failed")

    async def leave(self) -> None:
        # Graceful departure (server.go Leave): demote ourselves from
        # raft if possible, then leave serf.
        if self.raft and self.raft.is_leader() and len(self.raft.voters) > 1:
            try:
                await self.raft.remove_server(self.node_id)
            except Exception:  # noqa: BLE001 - best effort on the way out
                pass
        if self.serf_wan is not None:
            await self.serf_wan.leave()
        await self.serf.leave()

    async def shutdown(self) -> None:
        self._shutdown = True
        for t in self._tasks + self._leader_tasks:
            t.cancel()
        if self.raft:
            await self.raft.shutdown()
        if self.serf_wan is not None:
            await self.serf_wan.shutdown()
        for seg in self.segment_serfs.values():
            await seg.shutdown()
        await self.serf.shutdown()
        await self.rpc_client.shutdown()
        await self._raft_rpc_client.shutdown()
        await self.rpc_server.shutdown()

    @property
    def node_id(self) -> str:
        return self.config.node_name

    def is_leader(self) -> bool:
        return self.raft is not None and self.raft.is_leader()

    # ------------------------------------------------------------------
    # bootstrap & raft peer discovery (server_serf.go maybeBootstrap)
    # ------------------------------------------------------------------

    def _all_lan_members(self) -> list[Member]:
        """Union of the main ring and every segment ring, deduped by
        node name (a server appears in all rings — its main-ring record
        wins; a client lives in exactly one)."""
        merged: dict[str, Member] = {}
        for seg in self.segment_serfs.values():
            for m in seg.members.values():
                merged[m.name] = m
        for m in self.serf.members.values():
            merged[m.name] = m
        return list(merged.values())

    def _server_members(self) -> list[Member]:
        return [
            m
            for m in self.serf.members.values()
            if m.tags.get("role") == "consul"
            and m.tags.get("dc") == self.config.datacenter
        ]

    def _raft_peer_addr(self, node_id: str) -> Optional[str]:
        for m in self._server_members():
            if m.tags.get("id") == node_id:
                return m.tags.get("rpc_addr")
        return None

    async def _maybe_bootstrap(self) -> None:
        """Live-bootstrap guard dance (server_serf.go:318-401).

        Bootstrap only when (a) we have no raft state yet, (b) every
        visible server agrees on bootstrap_expect, and (c) NO visible
        server reports existing raft peers via Status.Peers.  A server
        that finds evidence of an established cluster disables its
        expect mode and starts raft as a non-voter follower instead —
        the leader's reconcile folds it in (handleAliveMember →
        add_voter), so a late joiner can never depose a live leader
        with a self-computed voter set.
        """
        if self.raft is not None or self._bootstrap_disabled or self._bootstrapping:
            return
        expect = self.config.bootstrap_expect
        servers = [
            m for m in self._server_members() if m.status == MemberStatus.ALIVE
        ]
        for m in servers:
            peer_expect = m.tags.get("expect")
            if peer_expect and int(peer_expect) != expect:
                log.error(
                    "%s: member %s has conflicting expect %s != %d; refusing bootstrap",
                    self.node_id, m.name, peer_expect, expect,
                )
                return
        if len(servers) < expect:
            return

        self._bootstrapping = True
        try:
            # Query each peer server; any reported raft peers is
            # evidence of an existing cluster (server_serf.go:365-401).
            for m in servers:
                if m.tags.get("id") == self.node_id:
                    continue
                addr = m.tags.get("rpc_addr")
                if not addr:
                    continue
                resp = None
                for attempt in range(3):
                    try:
                        resp = await self.rpc_client.call(
                            addr, "Status.Peers", {}, timeout=2.0
                        )
                        break
                    except Exception:  # noqa: BLE001 — unreachable peer
                        await asyncio.sleep(0.1 * (1 << attempt))
                if resp is None:
                    return  # retried on the next serf event
                if resp.get("peers"):
                    log.info(
                        "%s: existing raft peers reported by %s; disabling bootstrap",
                        self.node_id, m.name,
                    )
                    self._bootstrap_disabled = True
                    self._start_raft([])  # non-voter follower; leader adds us
                    return
            if self.raft is not None:
                return  # a concurrent path started raft while we probed
            # Initial voter set = every server visible when the expect
            # threshold is crossed; sorted so simultaneous bootstrappers
            # compute identical configs.
            voters = sorted(m.tags["id"] for m in servers)
            if self.node_id not in voters:
                voters.append(self.node_id)
            self._start_raft(sorted(voters))
            log.info("%s: raft bootstrapped with voters %s", self.node_id, voters)
        finally:
            self._bootstrapping = False

    def _start_raft(self, voters: list[str]) -> None:
        self.raft = RaftNode(
            RaftConfig(
                node_id=self.node_id,
                heartbeat_interval=self.config.raft_heartbeat_s,
                election_timeout_min=self.config.raft_election_min_s,
                election_timeout_max=self.config.raft_election_max_s,
            ),
            self.fsm,
            self.raft_adapter,
            voters,
        )
        self.raft.leadership_listeners.append(self._on_leadership)
        self._tasks.append(asyncio.create_task(self.raft.start()))

    # ------------------------------------------------------------------
    # RPC helpers used by endpoints
    # ------------------------------------------------------------------

    def acl_resolve(self, body: dict):
        """Token from QueryOptions → Authorizer; unknown tokens surface
        as an RPC error (consul/acl.go ResolveToken)."""
        from consul_tpu_torch.acl.engine import ACLError

        try:
            return self.acl.resolve(body.get("token", "") or "")
        except ACLError as e:
            raise RPCError(str(e)) from e

    def acl_check(self, body: dict, kind: str, name: str, want: str,
                  whole_subtree: bool = False) -> None:
        """Enforce one resource permission; raises the reference's
        'Permission denied' (acl.ErrPermissionDenied) on failure.
        Requests bound for another DC are enforced THERE — token tables
        are per-datacenter (the reference replicates them; we don't).
        ``whole_subtree`` (key resource only) requires write over every
        configured rule under the prefix (acl.go KeyWritePrefix) — the
        delete-tree guard."""
        if not self.acl.enabled:
            return
        dc = body.get("dc")
        if dc and dc != self.config.datacenter:
            return
        authz = self.acl_resolve(body)
        if whole_subtree:
            ok = authz.key_write_prefix(name)
        else:
            ok = authz.allowed(kind, name, want)
        if not ok:
            raise RPCError(ERR_PERMISSION_DENIED)

    def leader_rpc_addr(self) -> Optional[str]:
        if self.raft is None or self.raft.leader_id is None:
            return None
        return self._raft_peer_addr(self.raft.leader_id)

    async def forward(
        self, method: str, body: dict, *, read: bool = False
    ) -> Optional[dict]:
        """Forward to the right datacenter, then to the leader unless we
        are it (rpc.go:577-614 forward: the dc check comes FIRST —
        a request for another dc goes over the WAN regardless of our
        leadership or the read's staleness).

        Returns None when the caller should execute locally, else the
        remote response.  Only *reads* honor allow_stale — a write
        carrying a recycled query-options dict must still reach the
        leader (the reference's forward() checks info.IsRead()).
        """
        dc = body.get("dc")
        if dc and dc != self.config.datacenter:
            return await self._forward_dc(method, body, dc)
        if read and body.get("allow_stale"):
            return None
        if self.raft is not None and self.raft.is_leader():
            return None
        addr = self.leader_rpc_addr()
        if addr is None:
            raise RPCError(ERR_NO_LEADER)
        return await self.rpc_client.call(
            addr, method, body, timeout=rpc_timeout_for(body)
        )

    async def _forward_dc(self, method: str, body: dict, dc: str) -> dict:
        """rpc.go:617-655 forwardDC: pick a server of the target DC from
        the router (WAN-discovered) and relay the call; try a couple of
        candidates before giving up."""
        servers = self.router.servers_in_dc(dc)
        if not servers:
            raise RPCError(f"no path to datacenter {dc}")
        last: Optional[Exception] = None
        for meta in servers[:2]:
            try:
                return await self.rpc_client.call(
                    meta.rpc_addr, method, body, timeout=rpc_timeout_for(body)
                )
            except Exception as e:  # noqa: BLE001 - try the next server
                last = e
        raise RPCError(f"rpc to datacenter {dc} failed: {last}")

    async def raft_apply(self, msg_type: MessageType, body: dict):
        """Apply a command through raft (rpc.go:679 raftApply)."""
        if self.raft is None:
            raise RPCError(ERR_NO_LEADER)
        try:
            result = await self.raft.apply({"type": int(msg_type), "body": body})
        except NotLeaderError as e:
            raise RPCError(ERR_NO_LEADER) from e
        if isinstance(result, dict) and "error" in result and len(result) == 1:
            raise RPCError(result["error"])
        return result

    async def connect_ca(self):
        """The leader's signing authority (leader_connect.go
        initializeCA): first use generates a root and replicates its
        record.  A failover leader mints a fresh root (rotation without
        cross-signing); old roots stay stored so outstanding leaves
        verify until expiry."""
        async with self._connect_ca_lock:  # single-flight initialization
            if self._connect_ca is None:
                from consul_tpu_torch.connect import BuiltinCA

                _, roots = self.store.ca_roots()
                trust = next(
                    (r.get("trust_domain") for r in roots
                     if r.get("trust_domain")),
                    None,
                )
                ca = BuiltinCA(self.config.datacenter, trust_domain=trust)
                root = ca.generate_root()
                await self.raft_apply(
                    MessageType.CONNECT_CA, {"op": "set-root", "root": root}
                )
                self._connect_ca = ca
            return self._connect_ca

    async def consistent_barrier(self) -> None:
        """Leader linearizability fence for require_consistent reads
        (the reference's VerifyLeader in blockingQuery preamble)."""
        if self.raft is None:
            raise RPCError(ERR_NO_LEADER)
        try:
            await self.raft.barrier()
        except NotLeaderError as e:
            raise RPCError(ERR_NO_LEADER) from e

    # ------------------------------------------------------------------
    # serf event plumbing
    # ------------------------------------------------------------------

    def _on_serf_event(self, event: Event) -> None:
        if event.type in (
            EventType.MEMBER_JOIN,
            EventType.MEMBER_FAILED,
            EventType.MEMBER_LEAVE,
            EventType.MEMBER_REAP,
            EventType.MEMBER_UPDATE,
        ):
            self._reconcile_wake.set()

    async def _serf_event_pump(self) -> None:
        """Server-side event loop (server_serf.go lanEventHandler):
        membership changes trigger bootstrap checks and reconcile."""
        while not self._shutdown:
            await self.serf.events.get()
            self._reconcile_wake.set()
            await self._maybe_bootstrap()

    # ------------------------------------------------------------------
    # leader loops (leader.go)
    # ------------------------------------------------------------------

    def _on_leadership(self, leader: bool) -> None:
        if leader:
            self._leader_tasks = [
                asyncio.create_task(self._reconcile_loop()),
                asyncio.create_task(self._tombstone_gc_loop()),
                asyncio.create_task(self._session_ttl_loop()),
                asyncio.create_task(self._coordinate_flush_loop()),
                asyncio.create_task(self._autopilot_loop()),
                asyncio.create_task(self._replication_loop()),
                asyncio.create_task(self._acl_token_reap_loop()),
                asyncio.create_task(self._federation_state_ae_loop()),
            ]
            self._reconcile_wake.set()
        else:
            for t in self._leader_tasks:
                t.cancel()
            self._leader_tasks = []
            self._session_deadlines.clear()

    async def _reconcile_loop(self) -> None:
        while True:
            try:
                await asyncio.wait_for(
                    self._reconcile_wake.wait(),
                    timeout=self.config.reconcile_interval_s,
                )
            except asyncio.TimeoutError:
                pass
            self._reconcile_wake.clear()
            try:
                await self._reconcile()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — a leader loop must
                # survive transient apply timeouts / malformed tags; it
                # retries on the next tick (leader.go leaderLoop).
                log.warning("%s: reconcile failed: %s", self.node_id, e)

    async def _reconcile(self) -> None:
        """Fold serf membership into the catalog and the raft config
        (leader.go:1075-1280).  The gossip plane is the source of truth
        for node liveness; the catalog follows it."""
        _, catalog_nodes = self.store.nodes()
        known = {n["node"] for n in catalog_nodes}

        for m in self._all_lan_members():
            if m.status == MemberStatus.ALIVE:
                await self._handle_alive_member(m)
            elif m.status == MemberStatus.FAILED:
                await self._handle_failed_member(m)
            elif m.status == MemberStatus.LEFT:
                await self._handle_left_member(m)
            known.discard(m.name)

        # reconcileReaped: catalog nodes with a serfHealth check that
        # serf no longer knows at all are deregistered.
        for name in known:
            _, checks = self.store.node_checks(name)
            if any(c["check_id"] == SERF_CHECK_ID for c in checks):
                await self.raft_apply(MessageType.DEREGISTER, {"node": name})

    def _member_needs_update(self, m: Member, status: str) -> bool:
        _, node = self.store.node(m.name)
        if node is None or node.get("address") != m.addr:
            return True
        _, checks = self.store.node_checks(m.name)
        serf_check = next(
            (c for c in checks if c["check_id"] == SERF_CHECK_ID), None
        )
        return serf_check is None or serf_check["status"] != status

    def _is_peer_server(self, m: Member) -> bool:
        """Server of OUR datacenter (voter changes must never cross
        DCs — _server_members applies the same filter)."""
        return (
            m.tags.get("role") == "consul"
            and m.tags.get("dc") == self.config.datacenter
            and bool(m.tags.get("id"))
        )

    async def _handle_alive_member(self, m: Member) -> None:
        if self._is_peer_server(m) and self.raft is not None:
            sid = m.tags["id"]
            if sid not in self.raft.voters and \
                    sid not in self.raft.non_voters:
                # New servers join as STAGING non-voters; autopilot
                # promotes them once stable (leader.go joinConsulServer
                # → AddNonvoter under raft protocol 3, then
                # autopilot.promoteStableServers).
                await self.raft.add_nonvoter(sid)
        if not self._member_needs_update(m, HEALTH_PASSING):
            return
        await self.raft_apply(
            MessageType.REGISTER,
            {
                "node": m.name,
                "address": m.addr,
                "node_meta": {
                    "serf": "1",
                    **({"segment": m.tags["segment"]}
                       if m.tags.get("segment") else {}),
                },
                "check": {
                    "check_id": SERF_CHECK_ID,
                    "name": SERF_CHECK_NAME,
                    "status": HEALTH_PASSING,
                    "output": "Agent alive and reachable",
                },
            },
        )

    async def _handle_failed_member(self, m: Member) -> None:
        if not self._member_needs_update(m, HEALTH_CRITICAL):
            return
        await self.raft_apply(
            MessageType.REGISTER,
            {
                "node": m.name,
                "address": m.addr,
                "check": {
                    "check_id": SERF_CHECK_ID,
                    "name": SERF_CHECK_NAME,
                    "status": HEALTH_CRITICAL,
                    "output": "Agent not live or unreachable",
                },
            },
        )

    async def _handle_left_member(self, m: Member) -> None:
        if m.name == self.node_id:
            return  # never deregister ourselves (leader.go:1217)
        if self._is_peer_server(m) and self.raft is not None:
            if m.tags["id"] in self.raft.voters:
                await self.raft.remove_server(m.tags["id"])
        _, node = self.store.node(m.name)
        if node is not None:
            await self.raft_apply(MessageType.DEREGISTER, {"node": m.name})

    def apply_autopilot_overrides(self) -> None:
        """Fold the replicated autopilot-config entry (Operator.
        AutopilotSetConfiguration) over the STATIC defaults captured at
        construction — never over previously-mutated values, so the
        effective settings are a pure function of replicated state and
        identical on every (re)elected leader."""
        mapping = {
            "cleanup_dead_servers": "autopilot_cleanup_dead_servers",
            "last_contact_threshold_s": "autopilot_grace_s",
            "server_stabilization_time_s":
                "autopilot_server_stabilization_s",
            "max_trailing_logs": "autopilot_max_trailing_logs",
        }
        _, entry = self.store.config_entry_get("autopilot-config", "global")
        entry = entry or {}
        for key, field in mapping.items():
            setattr(
                self.config, field,
                entry.get(key, self._autopilot_defaults[field]),
            )

    def _autopilot_update_health(self) -> None:
        """autopilot.go serverHealthLoop/updateClusterHealth: score each
        peer server — serf-alive AND raft log within MaxTrailingLogs of
        the leader — and track how long it has been CONTINUOUSLY
        healthy (StableSince resets on any unhealthy observation)."""
        raft = self.raft
        is_leader = raft is not None and raft.is_leader()
        now = time.monotonic()
        seen = set()
        for m in list(self.serf.members.values()):
            if not self._is_peer_server(m):
                continue
            sid = m.tags["id"]
            seen.add(sid)
            alive = m.status == MemberStatus.ALIVE
            rec = self._server_health.get(sid)
            # Log lag is LEADER knowledge (match_index lives on the
            # leader's replicators) — followers score serf health only,
            # and a fresh leader whose match_index hasn't converged yet
            # (0 right after election) keeps the PREVIOUS verdict
            # instead of resetting every stabilization clock on each
            # failover.
            healthy = alive
            if is_leader and sid != self.node_id:
                m_idx = raft._match_index.get(sid, 0)
                if m_idx > 0 or raft.last_index() == 0:
                    lag = raft.last_index() - m_idx
                    healthy = alive and \
                        lag <= self.config.autopilot_max_trailing_logs
                elif rec is not None:
                    healthy = alive and rec["healthy"]
            if rec is None or rec["healthy"] != healthy:
                rec = {"healthy": healthy, "stable_since": now}
            if is_leader and sid != self.node_id:
                rec["last_index"] = raft._match_index.get(sid, 0)
            elif sid == self.node_id and raft is not None:
                rec["last_index"] = raft.last_index()
            else:
                # A follower has no view of other servers' match index —
                # report 0 rather than fabricating one.
                rec["last_index"] = 0
            self._server_health[sid] = rec
        for sid in list(self._server_health):
            if sid not in seen:
                del self._server_health[sid]

    async def _autopilot_loop(self) -> None:
        """autopilot.go run(): each pass promotes stable staging servers
        and prunes dead ones.

        promotion   a non-voter continuously healthy for
                    ServerStabilizationTime becomes a voter
                    (promoteStableServers)
        pruning     voters/non-voters whose serf member has been FAILED
                    past the grace window are removed — never more than
                    (voters-1)//2 voters in one pass, so a partition
                    can't talk the leader into destroying its own
                    quorum (autopilot.go removalLimit)
        """
        while not self._shutdown:
            await asyncio.sleep(self.config.autopilot_interval_s)
            try:
                if self.raft is None or not self.raft.is_leader():
                    continue
                self.apply_autopilot_overrides()
                self._autopilot_update_health()
                now = time.monotonic()

                # -- promote stable non-voters -------------------------
                for sid in list(self.raft.non_voters):
                    rec = self._server_health.get(sid)
                    if (
                        rec is not None
                        and rec["healthy"]
                        and now - rec["stable_since"]
                        >= self.config.autopilot_server_stabilization_s
                    ):
                        log.info("autopilot: promoting server %s", sid)
                        await self.raft.promote_server(sid)

                if not self.config.autopilot_cleanup_dead_servers:
                    continue
                # -- prune dead servers --------------------------------
                dead_voters, dead_staging = [], []
                for m in list(self.serf.members.values()):
                    sid = m.tags.get("id")
                    if (
                        self._is_peer_server(m)
                        and m.status == MemberStatus.FAILED
                        and sid != self.node_id
                        and (m.leave_time or now) + self.config.autopilot_grace_s
                        <= now
                    ):
                        if sid in self.raft.voters:
                            dead_voters.append(sid)
                        elif sid in self.raft.non_voters:
                            dead_staging.append(sid)
                # Dead staging servers cost no quorum — drop them all.
                for node_id in dead_staging:
                    log.info("autopilot: removing dead staging server %s",
                             node_id)
                    await self.raft.remove_server(node_id)
                limit = max((len(self.raft.voters) - 1) // 2, 0)
                for node_id in dead_voters[:limit]:
                    log.info("autopilot: removing dead server %s", node_id)
                    await self.raft.remove_server(node_id)
            except Exception:
                log.exception("autopilot loop failed")

    def _is_secondary(self) -> bool:
        return bool(
            self.config.primary_datacenter
            and self.config.primary_datacenter != self.config.datacenter
        )

    async def _replication_loop(self) -> None:
        """Primary→secondary replication (config_replication.go +
        acl_replication.go + federation_state_replication.go):
        rate-limited pull loops on the secondary's leader; remote state
        is diffed against local and converged through the local raft."""
        if not self._is_secondary():
            return
        while not self._shutdown:
            await asyncio.sleep(self.config.replication_interval_s)
            try:
                if self.raft is None or not self.raft.is_leader():
                    continue
                await self._replicate_config_entries()
                await self._replicate_acl()
                await self._replicate_federation_states()
            except Exception:
                log.exception("replication round failed")

    async def _federation_state_ae_loop(self) -> None:
        """Every DC's leader publishes its own mesh-gateway set to the
        PRIMARY's raft (leader_federation_state_ae.go
        FederationStateAntiEntropy); secondaries then pull the full map
        back via _replicate_federation_states, so each DC learns every
        other DC's gateways."""
        while True:
            await asyncio.sleep(self.config.federation_state_ae_interval_s)
            try:
                own = self.gateway_locator.build_own_state()
                # Skip the write when the published state already
                # matches (the reference diffs content before writing
                # for the same reason: no raft churn).  An EMPTY set
                # still publishes over a non-empty record — losing the
                # last gateway must prune the stale addresses everywhere
                # (leader_federation_state_ae.go replicates deletions
                # the same way).
                _, current = self.store.federation_state_get(
                    self.config.datacenter
                )
                if current is None:
                    if not own["mesh_gateways"]:
                        continue  # nothing to advertise yet
                elif self._strip_indexes(current) == own:
                    continue
                await self.rpc_server.dispatch_local(
                    "FederationState.Apply",
                    {"op": "upsert", "state": own,
                     "token": self.config.acl_replication_token
                     or self.config.acl_master_token},
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — retry next tick
                log.warning(
                    "%s: federation state anti-entropy failed: %s",
                    self.node_id, e,
                )

    async def _replicate_federation_states(self) -> None:
        """Pull every DC's federation state from the primary
        (federation_state_replication.go).  Own-DC state is replicated
        too — the AE loop is the writer of record and re-pushes if the
        catalog moved on."""
        primary = self.config.primary_datacenter
        out = await self._forward_dc(
            "FederationState.List",
            {"dc": primary, "token": self.config.acl_replication_token},
            primary,
        )
        remote = {s["datacenter"]: self._strip_indexes(s)
                  for s in out.get("states", [])}
        _, local_list = self.store.federation_state_list()
        local = {s["datacenter"]: self._strip_indexes(s)
                 for s in local_list}
        for dc, state in remote.items():
            if local.get(dc) != state:
                await self.raft_apply(
                    MessageType.FEDERATION_STATE,
                    {"op": "upsert", "state": state},
                )
        for dc in set(local) - set(remote):
            await self.raft_apply(
                MessageType.FEDERATION_STATE,
                {"op": "delete", "state": {"datacenter": dc}},
            )

    @staticmethod
    def _strip_indexes(rec: dict) -> dict:
        return {k: v for k, v in rec.items()
                if k not in ("create_index", "modify_index")}

    async def _replicate_config_entries(self) -> None:
        primary = self.config.primary_datacenter
        out = await self._forward_dc(
            "ConfigEntry.List",
            {"dc": primary, "token": self.config.acl_replication_token},
            primary,
        )
        # Autopilot settings are per-DC (the reference keeps them in a
        # separate table); never replicate or delete them.
        remote = {(e["kind"], e["name"]): self._strip_indexes(e)
                  for e in out.get("entries", [])
                  if e.get("kind") != "autopilot-config"}
        _, local_list = self.store.config_entries_by_kind(None)
        local = {(e["kind"], e["name"]): self._strip_indexes(e)
                 for e in local_list
                 if e.get("kind") != "autopilot-config"}
        for key, entry in remote.items():
            if local.get(key) != entry:
                await self.raft_apply(
                    MessageType.CONFIG_ENTRY, {"op": "set", "entry": entry}
                )
        for kind, name in set(local) - set(remote):
            await self.raft_apply(
                MessageType.CONFIG_ENTRY,
                {"op": "delete", "entry": {"kind": kind, "name": name}},
            )

    async def _replicate_acl(self) -> None:
        """ACL policies + tokens from the primary (acl_replication.go;
        needs an acl:write replication token or the primary redacts
        secrets, which we refuse to store)."""
        primary = self.config.primary_datacenter
        token = self.config.acl_replication_token
        pol_out = await self._forward_dc(
            "ACL.PolicyList", {"dc": primary, "token": token}, primary
        )
        remote_pols = {p["id"]: self._strip_indexes(p)
                       for p in pol_out.get("policies", [])}
        _, local_list = self.store.acl_policy_list()
        local_pols = {p["id"]: self._strip_indexes(p) for p in local_list}
        for pid, pol in remote_pols.items():
            if local_pols.get(pid) != pol:
                await self.raft_apply(
                    MessageType.ACL_POLICY_SET, {"policy": pol}
                )
        for pid in set(local_pols) - set(remote_pols):
            await self.raft_apply(
                MessageType.ACL_POLICY_DELETE, {"id": pid}
            )
        # Replicated policy changes must flush cached authorizers even
        # when token replication below is skipped.
        self.acl.invalidate()

        tok_out = await self._forward_dc(
            "ACL.TokenList", {"dc": primary, "token": token}, primary
        )
        remote_toks = {}
        for t in tok_out.get("tokens", []):
            if t.get("secret_id") == "<hidden>":
                log.warning(
                    "ACL replication token lacks acl:write on the "
                    "primary; skipping token replication"
                )
                break
            remote_toks[t["secret_id"]] = self._strip_indexes(t)
        else:
            _, local_tok_list = self.store.acl_token_list()
            local_toks = {t["secret_id"]: self._strip_indexes(t)
                          for t in local_tok_list}
            for sid, tok in remote_toks.items():
                if local_toks.get(sid) != tok:
                    await self.raft_apply(
                        MessageType.ACL_TOKEN_SET, {"token": tok}
                    )
            for sid in set(local_toks) - set(remote_toks):
                # DC-local tokens survive replication: management tokens
                # (a secondary's own bootstrap) and tokens marked local
                # (the reference's token.Local flag, acl_replication.go).
                t = local_toks[sid]
                if t.get("type") == "management" or t.get("local"):
                    continue
                await self.raft_apply(
                    MessageType.ACL_TOKEN_DELETE, {"secret_id": sid}
                )
            self.acl.invalidate()  # token set changed too

    async def _tombstone_gc_loop(self) -> None:
        """Time-based tombstone reaping (leader.go:292 + tombstone GC):
        the leader snapshots (now, kv index) marks and raft-applies a
        reap for the index recorded tombstone_ttl ago."""
        while True:
            await asyncio.sleep(self.config.tombstone_granularity_s)
            now = time.monotonic()
            self._tombstone_marks.append((now, self.store.max_index("kvs", "tombstones")))
            cutoff_idx = 0
            keep: list[tuple[float, int]] = []
            for ts, idx in self._tombstone_marks:
                if now - ts >= self.config.tombstone_ttl_s:
                    cutoff_idx = max(cutoff_idx, idx)
                else:
                    keep.append((ts, idx))
            self._tombstone_marks = keep
            if cutoff_idx:
                try:
                    await self.raft_apply(
                        MessageType.TOMBSTONE, {"op": "reap", "index": cutoff_idx}
                    )
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — retry next tick
                    log.warning("%s: tombstone reap failed: %s", self.node_id, e)
                    self._tombstone_marks.append((0.0, cutoff_idx))

    async def _acl_token_reap_loop(self) -> None:
        """Delete expired ACL tokens through raft (acl_token_exp.go
        startACLTokenReaping: periodic sweep on the leader; expired
        tokens already fail resolution, this is garbage collection)."""
        while True:
            await asyncio.sleep(self.config.acl_token_reap_interval_s)
            for rec in self.store.acl_tokens_expired(time.time()):
                try:
                    await self.raft_apply(
                        MessageType.ACL_TOKEN_DELETE,
                        {"secret_id": rec["secret_id"]},
                    )
                    self.acl.invalidate(rec["secret_id"])
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — retry next sweep
                    log.warning(
                        "%s: expired token reap failed: %s", self.node_id, e
                    )

    async def _session_ttl_loop(self) -> None:
        """Invalidate sessions whose TTL lapsed without renewal
        (session_ttl.go: timers at 2x TTL on the leader)."""
        while True:
            await asyncio.sleep(self.config.session_ttl_sweep_s)
            now = time.monotonic()
            _, sessions = self.store.session_list()
            live = set()
            for sess in sessions:
                ttl = _parse_ttl(sess.get("ttl"))
                if ttl <= 0:
                    continue
                sid = sess["id"]
                live.add(sid)
                deadline = self._session_deadlines.setdefault(sid, now + 2 * ttl)
                if now >= deadline:
                    try:
                        await self.raft_apply(
                            MessageType.SESSION,
                            {"op": "destroy", "session": {"id": sid}},
                        )
                        self._session_deadlines.pop(sid, None)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001 — retry next sweep
                        log.warning(
                            "%s: session %s invalidation failed: %s",
                            self.node_id, sid, e,
                        )
            for sid in list(self._session_deadlines):
                if sid not in live:
                    del self._session_deadlines[sid]

    def renew_session(self, sid: str, ttl: float) -> None:
        self._session_deadlines[sid] = time.monotonic() + 2 * ttl

    # -- coordinates ---------------------------------------------------

    def stage_coordinate_update(self, node: str, segment: str, coord: dict) -> None:
        self._coord_updates[f"{node}\x00{segment}"] = {
            "node": node,
            "segment": segment,
            "coord": coord,
        }

    async def _coordinate_flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.coordinate_update_period_s)
            if not self._coord_updates:
                continue
            updates = list(self._coord_updates.values())
            self._coord_updates.clear()
            try:
                await self.raft_apply(
                    MessageType.COORDINATE_BATCH_UPDATE, {"updates": updates}
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — restage for next flush
                log.warning("%s: coordinate flush failed: %s", self.node_id, e)
                for u in updates:
                    self._coord_updates.setdefault(
                        f"{u['node']}\x00{u['segment']}", u
                    )


def _parse_ttl(ttl) -> float:
    """'10s' / '1m' / numeric seconds → seconds (api session TTL)."""
    if ttl in (None, ""):
        return 0.0
    if isinstance(ttl, (int, float)):
        return float(ttl)
    s = str(ttl)
    try:
        if s.endswith("ms"):
            return float(s[:-2]) / 1000.0
        if s.endswith("s"):
            return float(s[:-1])
        if s.endswith("m"):
            return float(s[:-1]) * 60.0
        if s.endswith("h"):
            return float(s[:-1]) * 3600.0
        return float(s)
    except ValueError:
        return 0.0
