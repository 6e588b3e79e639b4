"""The Agent: composition root tying the delegate, local state, checks
and user events together; the port's copy of ``consul_tpu/agent/agent.py``.
A client's ``auto_encrypt`` and ``auto_config_enabled`` need Connect's CA
and the auto-config endpoint, which are not ported yet: they are refused
when the agent is built.

Equivalent of ``agent/agent.go`` (SURVEY.md §2.3): every node runs an
Agent; 3-5 run with a Server delegate (raft quorum), the rest with a
Client delegate.  The agent owns

  delegate            agent.go:121-123,167 — ``*consul.Server`` or
                      ``*consul.Client`` behind one RPC interface
  local state + AE    agent/local + agent/ae — the agent's services/
                      checks, anti-entropy synced into the catalog
  check executors     agent/checks — TTL/script/TCP/HTTP runners
                      feeding local state
  user events         agent/user_event.go:78-139 — serf events with a
                      dedup ring, exposed to the API/watches
  coordinate publish  agent keeps the server's Vivaldi coordinate
                      fresh via Coordinate.Update (ping piggyback in
                      the reference; a periodic task here)
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import uuid
from typing import Callable, Optional, Union

from consul_tpu_torch.agent.checks import CheckRunner, CheckTTL, build_check_runner
from consul_tpu_torch.agent.client import Client, ClientConfig
from consul_tpu_torch.agent.local import LocalState, StateSyncer
from consul_tpu_torch.agent.server import Server, ServerConfig
from consul_tpu_torch.eventing.cluster import Event, EventType
from consul_tpu_torch.net.transport import Transport
from consul_tpu_torch.protocol import LAN, GossipProfile

log = logging.getLogger("consul_tpu_torch.agent")

USER_EVENT_BUFFER = 256  # user_event.go agent-side ring


@dataclasses.dataclass
class AgentConfig:
    node_name: str
    datacenter: str = "dc1"
    server: bool = True
    bootstrap_expect: int = 1
    profile: GossipProfile = LAN
    gossip_interval_scale: float = 1.0
    advertise_addr: str = ""
    sync_interval_s: float = 60.0
    sync_retry_interval_s: float = 15.0  # ae.go retryFailIntv
    # Test-speed knobs forwarded to the Server delegate.
    reconcile_interval_s: float = 60.0
    coordinate_update_period_s: float = 5.0
    session_ttl_sweep_s: float = 1.0
    # ACLs (forwarded to ServerConfig).
    acl_enabled: bool = False
    acl_default_policy: str = "allow"
    acl_master_token: str = ""
    # Token the agent itself uses for anti-entropy catalog writes
    # (agent/config acl.tokens.agent).
    acl_agent_token: str = ""
    # Serf gossip snapshot + auto-rejoin (serf/snapshot.go).
    serf_snapshot_path: str = ""
    rejoin_after_leave: bool = False
    # Gossip encryption key, base64 (config "encrypt"; consul keygen).
    encrypt_key: str = ""
    # WAN replication (forwarded to ServerConfig).
    primary_datacenter: str = ""
    acl_replication_token: str = ""
    # Client TLS bootstrap (agent/auto-config + auto_encrypt_endpoint):
    # fetch an agent-kind SPIFFE leaf + CA roots from the servers at
    # startup.
    auto_encrypt: bool = False
    # Network segment membership for CLIENT agents (types/area.go /
    # agent config "segment"): the client's gossip ring name — join
    # addresses must point at a server's matching segment transport.
    segment: str = ""
    # Full auto-config bootstrap (agent/auto-config/config.go +
    # consul/auto_config_endpoint.go): a CLIENT with only a server RPC
    # address and a JWT intro token fetches its whole runtime (gossip
    # keys, agent token, TLS identity, cluster settings) before joining.
    auto_config_enabled: bool = False
    auto_config_intro_token: str = ""
    auto_config_server_addresses: tuple = ()
    # Server side: the JWT authorizer spec (ServerConfig field).
    auto_config_authorizer: Optional[dict] = None


@dataclasses.dataclass
class UserEvent:
    id: str
    name: str
    payload: bytes
    ltime: int


class Agent:
    """One Consul agent (``agent.Agent``)."""

    def __init__(
        self,
        config: AgentConfig,
        gossip_transport: Transport,
        rpc_transport: Optional[Transport] = None,
        wan_transport: Optional[Transport] = None,
    ):
        if not config.server:
            for knob in ("auto_encrypt", "auto_config_enabled"):
                if getattr(config, knob):
                    raise NotImplementedError(
                        f"{knob}= is not ported yet (it needs Connect's CA "
                        "and the AutoEncrypt/AutoConfig endpoints)")
        self.config = config
        # Shared keyring for LAN (and WAN) gossip (security.go).
        self.keyring = None
        if config.encrypt_key:
            from consul_tpu_torch.net.security import Keyring

            self.keyring = Keyring.from_b64(config.encrypt_key)
        if config.server:
            if rpc_transport is None:
                raise ValueError("server agents need an rpc transport")
            self.delegate: Union[Server, Client] = Server(
                ServerConfig(
                    node_name=config.node_name,
                    datacenter=config.datacenter,
                    bootstrap_expect=config.bootstrap_expect,
                    profile=config.profile,
                    gossip_interval_scale=config.gossip_interval_scale,
                    reconcile_interval_s=config.reconcile_interval_s,
                    coordinate_update_period_s=config.coordinate_update_period_s,
                    session_ttl_sweep_s=config.session_ttl_sweep_s,
                    acl_enabled=config.acl_enabled,
                    acl_default_policy=config.acl_default_policy,
                    acl_master_token=config.acl_master_token,
                    serf_snapshot_path=config.serf_snapshot_path,
                    rejoin_after_leave=config.rejoin_after_leave,
                    keyring=self.keyring,
                    primary_datacenter=config.primary_datacenter,
                    acl_replication_token=config.acl_replication_token,
                    auto_config_authorizer=config.auto_config_authorizer,
                ),
                gossip_transport,
                rpc_transport,
                wan_transport=wan_transport,
            )
        elif wan_transport is not None:
            raise ValueError("only server agents join the WAN pool")
        else:
            if rpc_transport is None:
                raise ValueError("client agents need an rpc transport")
            self.delegate = Client(
                ClientConfig(
                    node_name=config.node_name,
                    datacenter=config.datacenter,
                    profile=config.profile,
                    gossip_interval_scale=config.gossip_interval_scale,
                    keyring=self.keyring,
                    tags=(
                        {"segment": config.segment}
                        if config.segment else {}
                    ),
                ),
                gossip_transport,
                rpc_transport,
            )

        addr = config.advertise_addr or gossip_transport.local_addr()
        self.local = LocalState(config.node_name, self._agent_rpc, address=addr)
        self.syncer = StateSyncer(
            self.local,
            cluster_size=lambda: len(self.serf.members) or 1,
            sync_interval_s=config.sync_interval_s,
            retry_interval_s=config.sync_retry_interval_s,
        )
        # Agent cache: typed, background-blocking-refresh reads
        # (agent/cache, cache.go:285/488/717), primarily feeding DNS.
        from consul_tpu_torch.agent.cache import AgentCache

        # Reads through the cache run as the AGENT identity so DNS
        # works under ACL enforcement (the reference's DNS RPCs carry
        # the agent token too).
        self.cache = AgentCache(rpc=self._agent_rpc)
        # Proxy config snapshots for registered connect-proxy services
        # (agent/proxycfg/manager.go; wired in add/remove_service).
        from consul_tpu_torch.connect.proxycfg import ProxyConfigManager

        self.proxycfg = ProxyConfigManager(
            self.cache, self._agent_rpc, datacenter=config.datacenter
        )
        self.checks: dict[str, CheckRunner] = {}
        # DNS behavior knobs (dns_config block); DNSServer reads these
        # live, so reload changes DNS behavior without a restart.
        self.dns_only_passing = True
        self.dns_node_ttl_s = 0.0
        self.dns_recursors: list[str] = []
        # Config-file-sourced definitions (loadServices/loadChecks),
        # swapped wholesale on reload.
        self._config_services: list[dict] = []
        self._config_checks: list[dict] = []
        self._config_service_ids: set[str] = set()
        self._config_check_ids: set[str] = set()
        self.tls_identity = None  # auto-encrypt result (leaf + roots)
        self.events: list[UserEvent] = []  # dedup ring, newest last
        self.event_index = 0  # monotonic, the X-Consul-Index for /event/list
        self._event_seen: set[tuple[int, str]] = set()
        self.event_handlers: list[Callable[[UserEvent], None]] = []
        self._event_wake = asyncio.Event()

        # Chain onto the serf event stream without stealing the
        # delegate's own handler (server reconcile wake).
        serf_cfg = self.serf.config
        prev = serf_cfg.on_event

        def chained(event: Event) -> None:
            if prev is not None:
                prev(event)
            self._on_serf_event(event)

        serf_cfg.on_event = chained

    # ------------------------------------------------------------------

    @property
    def serf(self):
        return self.delegate.serf

    def is_server(self) -> bool:
        return isinstance(self.delegate, Server)

    async def rpc(self, method: str, body: dict):
        """The one RPC entry point (agent.go:1296 a.RPC): servers
        execute locally, clients forward (SURVEY.md §3.4)."""
        if isinstance(self.delegate, Server):
            return await self.delegate.rpc_server.dispatch_local(method, body)
        return await self.delegate.rpc(method, body)

    async def _agent_rpc(self, method: str, body: dict):
        """RPC as the AGENT identity: anti-entropy writes carry the
        agent token (agent/config acl.tokens.agent) so registration
        sync works under ACL enforcement."""
        if self.config.acl_agent_token and "token" not in body:
            body = {**body, "token": self.config.acl_agent_token}
        return await self.rpc(method, body)

    async def keyring_operation(self, op: str, key_b64: str = "") -> dict:
        """operator keyring (operator_endpoint.go KeyringOperation):
        fan the op over the LAN pool (and the WAN pool on servers)."""
        pools = [("lan", self.serf)]
        wan = getattr(self.delegate, "serf_wan", None)
        if wan is not None:
            pools.append(("wan", wan))
        out = {}
        for label, pool in pools:
            fn = getattr(pool, op.replace("-", "_"))
            out[label] = await (fn(key_b64) if key_b64 else fn())
        return out

    async def cached_rpc(self, cache_type: str, body: dict):
        """Read through the agent cache (agent.go cache-backed RPCs with
        QueryOptions.UseCache): warm entries answer instantly while a
        background blocking query keeps them fresh."""
        return await self.cache.get(cache_type, body)

    async def start(self) -> None:
        if self.config.auto_config_enabled and not self.is_server():
            # agent/auto-config/auto_config.go InitialConfiguration:
            # runs BEFORE gossip starts — the response carries the
            # gossip encryption keys the join itself needs.
            await self._auto_config_bootstrap()
        await self.delegate.start()
        self.syncer.start()
        # TLS identity: servers mint theirs locally; clients ask the
        # servers (auto-encrypt).  Stored as self.tls_identity =
        # {"leaf": {...}, "roots": [...]} for transports/proxies to use.
        if self.config.auto_encrypt and not self.is_server():
            self._auto_encrypt_task = asyncio.create_task(
                self._auto_encrypt_loop()
            )

    async def _auto_config_bootstrap(self) -> None:
        """Fetch and APPLY the initial configuration from a configured
        server address, retrying across addresses with backoff (the
        reference persists the response; here it is applied live)."""
        from consul_tpu_torch.agent.rpc import RPCError

        addrs = list(self.config.auto_config_server_addresses)
        if not addrs:
            raise ValueError(
                "auto_config requires auto_config_server_addresses"
            )
        backoff = 0.2
        while True:
            last: Exception = RPCError("no auto-config server reachable")
            for addr in addrs:
                try:
                    out = await self.delegate.rpc_client.call(
                        addr, "AutoConfig.InitialConfiguration",
                        {"node": self.config.node_name,
                         "jwt": self.config.auto_config_intro_token},
                    )
                    self._apply_auto_config(out)
                    return
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — next addr/retry
                    # A denial from ANY address means the intro token is
                    # bad — that never heals by retrying (a later
                    # unreachable address must not mask it).
                    if isinstance(e, RPCError) and \
                            "Permission denied" in str(e):
                        raise
                    last = e
            log.warning("auto-config bootstrap failed (%s); retrying", last)
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 5.0)

    def _apply_auto_config(self, out: dict) -> None:
        cfg = out.get("config") or {}
        # Gossip encryption: install the keys into the delegate's
        # memberlist config before serf starts.
        keys = out.get("gossip_keys") or []
        if keys:
            from consul_tpu_torch.net.security import Keyring

            keyring = Keyring.from_b64(keys[0])
            for extra in keys[1:]:
                keyring.install(extra)
            self.keyring = keyring
            self.delegate.serf.memberlist.config.keyring = keyring
        # ACL agent token for anti-entropy + agent-plane RPCs.
        token = ((cfg.get("acl") or {}).get("tokens") or {}).get("agent")
        if token:
            self.config.acl_agent_token = token
        # TLS identity (the auto-encrypt shape).
        if out.get("tls"):
            self.tls_identity = out["tls"]
        # Datacenter: the delegate, its serf 'dc' tag, and the server
        # manager were all constructed with the pre-bootstrap value —
        # re-point ALL of them (a dc applied only to AgentConfig would
        # leave ServerManager filtering on the wrong tag and the client
        # unable to find any server).
        dc = cfg.get("datacenter", self.config.datacenter)
        if dc != self.config.datacenter:
            self.config.datacenter = dc
            self.delegate.config.datacenter = dc
            self.delegate.routers.datacenter = dc
            self.delegate.serf.config.tags["dc"] = dc
        self.config.primary_datacenter = cfg.get(
            "primary_datacenter", self.config.primary_datacenter)
        log.info(
            "auto-config: applied initial configuration "
            "(%d gossip key(s), token=%s, tls=%s)",
            len(keys), "yes" if token else "no",
            "yes" if out.get("tls") else "no",
        )

    async def _auto_encrypt_loop(self) -> None:
        """Fetch, then RENEW: retry with backoff until the servers
        answer (a fresh client may join before a leader exists), and
        re-sign at half the leaf's remaining lifetime so expiry and CA
        rotation never strand a stale identity (auto_encrypt.go renews
        at a fraction of the TTL)."""
        backoff = 0.2
        while True:
            try:
                # As the AGENT identity: Sign requires node:write on our
                # own name under ACL enforcement (auto_encrypt uses the
                # configured tokens.agent, like anti-entropy writes).
                out = await self._agent_rpc(
                    "AutoEncrypt.Sign", {"node": self.config.node_name}
                )
                self.tls_identity = out
                log.info("auto-encrypt: TLS identity issued (%s)",
                         out["leaf"]["uri"])
                backoff = 0.2
                import datetime

                expires = datetime.datetime.fromisoformat(
                    out["leaf"]["valid_before"]
                )
                remaining = (
                    expires - datetime.datetime.now(datetime.timezone.utc)
                ).total_seconds()
                await asyncio.sleep(max(remaining / 2, 60.0))
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - keep retrying
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    async def join(self, addrs: list[str]) -> int:
        return await self.delegate.join(addrs)

    async def leave(self) -> None:
        await self.delegate.leave()

    async def force_leave(self, node: str) -> bool:
        """agent.go ForceLeave -> serf.RemoveFailedNode."""
        return await self.serf.remove_failed_node(node)

    async def shutdown(self) -> None:
        self.syncer.stop()
        self.proxycfg.stop()
        self.cache.stop()
        task = getattr(self, "_auto_encrypt_task", None)
        if task is not None:
            task.cancel()
        for runner in self.checks.values():
            runner.stop()
        await self.delegate.shutdown()

    # ------------------------------------------------------------------
    # config-sourced definitions + reload (agent.go loadServices /
    # loadChecks / reloadConfigInternal)
    # ------------------------------------------------------------------

    def load_definitions(self, services: list[dict],
                         checks: list[dict]) -> None:
        """(Re)apply config-file service/check definitions: definitions
        no longer present are deregistered, the rest re-registered —
        the reload path changes checks without an agent restart."""
        self._config_services = [dict(s) for s in services]
        self._config_checks = [dict(c) for c in checks]
        new_svc_ids = set()
        for svc in services:
            svc = dict(svc)
            svc.setdefault("service", svc.pop("name", ""))
            sid = svc.get("id") or svc["service"]
            svc["id"] = sid
            new_svc_ids.add(sid)
            svc_checks = [dict(c) for c in svc.pop("checks", [])]
            self.add_service(svc, svc_checks)
        new_check_ids = set()
        for chk in checks:
            chk = dict(chk)
            cid = chk.get("check_id") or chk.get("id") or chk.get("name", "")
            chk["check_id"] = cid  # add_check registers under check_id
            new_check_ids.add(cid)
            self.add_check(chk)
        for sid in self._config_service_ids - new_svc_ids:
            self.remove_service(sid)
        for cid in self._config_check_ids - new_check_ids:
            self.remove_check(cid)
        self._config_service_ids = new_svc_ids
        self._config_check_ids = new_check_ids

    def reload(self, apply: dict) -> None:
        """Apply a reloadable-config diff (see config.reloadable_diff):
        service/check definitions swap in place (a field absent from the
        diff keeps its current definitions); scalar knobs update."""
        from consul_tpu_torch.agent.config import thaw

        if "services" in apply or "checks" in apply:
            services = (
                [thaw(s) for s in apply["services"]]
                if "services" in apply
                else self._config_services
            )
            checks = (
                [thaw(c) for c in apply["checks"]]
                if "checks" in apply
                else self._config_checks
            )
            self.load_definitions(services, checks)
        for knob in ("dns_only_passing", "dns_node_ttl_s",
                     "dns_recursors"):
            if knob in apply:
                value = apply[knob]
                if knob == "dns_recursors":
                    value = list(value)
                setattr(self, knob, value)

    # ------------------------------------------------------------------
    # service & check registration (agent.go AddService/AddCheck)
    # ------------------------------------------------------------------

    def add_service(self, service: dict, checks: Optional[list[dict]] = None) -> None:
        sid = service.get("id") or service["service"]
        self.local.add_service(service)
        self.proxycfg.register(dict(service, id=sid))
        for i, defn in enumerate(checks or []):
            defn = dict(defn)
            defn.setdefault("check_id", f"service:{sid}" + (f":{i+1}" if i else ""))
            defn["service_id"] = sid
            defn.setdefault("service_name", service["service"])
            self.add_check(defn)

    def remove_service(self, service_id: str) -> bool:
        self.proxycfg.deregister(service_id)
        for cid, runner in list(self.checks.items()):
            entry = self.local.checks.get(cid)
            if entry and entry.check.get("service_id") == service_id:
                runner.stop()
                del self.checks[cid]
        return self.local.remove_service(service_id)

    # -- maintenance mode (agent.go:3411-3483 EnableServiceMaintenance /
    # EnableNodeMaintenance): a synthetic CRITICAL check pulls the
    # service (or every service on the node) out of discovery until
    # disabled; the reason lands in the check notes.

    def enable_service_maintenance(self, service_id: str,
                                   reason: str = "") -> bool:
        entry = self.local.services.get(service_id)
        if entry is None or entry.deleted:
            return False
        self.local.add_check({
            "check_id": f"_service_maintenance:{service_id}",
            "name": "Service Maintenance Mode",
            "status": "critical",
            "notes": reason or "Maintenance mode is enabled for this "
                               "service, but no reason was provided.",
            "service_id": service_id,
            "service_name": entry.service.get("service", ""),
        })
        return True

    def disable_service_maintenance(self, service_id: str) -> bool:
        if self.local.services.get(service_id) is None:
            return False
        self.local.remove_check(f"_service_maintenance:{service_id}")
        return True

    def enable_node_maintenance(self, reason: str = "") -> None:
        self.local.add_check({
            "check_id": "_node_maintenance",
            "name": "Node Maintenance Mode",
            "status": "critical",
            "notes": reason or "Maintenance mode is enabled for this "
                               "node, but no reason was provided.",
        })

    def disable_node_maintenance(self) -> None:
        self.local.remove_check("_node_maintenance")

    def in_node_maintenance(self) -> bool:
        entry = self.local.checks.get("_node_maintenance")
        return entry is not None and not entry.deleted

    def add_check(self, defn: dict) -> None:
        cid = defn.get("check_id") or defn.get("name")
        runner = build_check_runner(
            defn, self._notify_check, alias_lookup=self._alias_lookup
        )
        record = {
            k: v
            for k, v in defn.items()
            if k in ("check_id", "name", "notes", "status", "service_id",
                     "service_name")
        }
        record.setdefault("name", cid)
        self.local.add_check(record)
        # Always retire any previous executor for this id — even when
        # the new definition is a bare catalog check with no runner —
        # so a replaced check can't keep pushing stale statuses.
        old = self.checks.pop(cid, None)
        if old:
            old.stop()
        if runner is not None:
            self.checks[cid] = runner
            runner.start()

    def _alias_lookup(self, service_ref: str):
        """Statuses of the checks attached to a local service (matched
        by id OR name), or None when no such service is registered
        (alias.go local path)."""
        ids = {
            ls.service.get("id") or ls.service.get("service")
            for ls in self.local.services.values()
            if not ls.deleted and (
                ls.service.get("id") == service_ref
                or ls.service.get("service") == service_ref
            )
        }
        if not ids:
            return None
        return [
            lc.check.get("status", "")
            for lc in self.local.checks.values()
            if not lc.deleted and lc.check.get("service_id") in ids
        ]

    def remove_check(self, check_id: str) -> bool:
        runner = self.checks.pop(check_id, None)
        if runner:
            runner.stop()
        return self.local.remove_check(check_id)

    def update_ttl_check(self, check_id: str, status: str, output: str = "") -> bool:
        """Agent TTL endpoints (pass/warn/fail)."""
        runner = self.checks.get(check_id)
        if not isinstance(runner, CheckTTL):
            return False
        runner.set_status(status, output)
        return True

    def _notify_check(self, check_id: str, status: str, output: str) -> None:
        self.local.update_check(check_id, status, output)

    # ------------------------------------------------------------------
    # user events (agent/user_event.go)
    # ------------------------------------------------------------------

    async def fire_event(self, name: str, payload: bytes = b"") -> str:
        """Fire a user event into the gossip plane
        (user_event.go:78 UserEvent → serf.UserEvent)."""
        await self.serf.user_event(name, payload)
        return str(uuid.uuid4())

    def _on_serf_event(self, event: Event) -> None:
        if event.type != EventType.USER:
            return
        key = (event.ltime, event.name)
        if key in self._event_seen:
            return  # agent-side dedup ring (user_event.go:118-130)
        self._event_seen.add(key)
        ue = UserEvent(
            id=str(uuid.uuid4()),
            name=event.name,
            payload=event.payload,
            ltime=event.ltime,
        )
        self.events.append(ue)
        self.event_index += 1
        if len(self.events) > USER_EVENT_BUFFER:
            dropped = self.events.pop(0)
            self._event_seen.discard((dropped.ltime, dropped.name))
        self._event_wake.set()
        self._event_wake = asyncio.Event()
        for handler in self.event_handlers:
            try:
                handler(ue)
            except Exception:  # noqa: BLE001
                log.exception("user event handler failed")

    def event_wake_handle(self) -> asyncio.Event:
        """Current wake event for long-polling /v1/event/list."""
        return self._event_wake
