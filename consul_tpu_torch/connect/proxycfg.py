"""Per-proxy config-snapshot manager: the mesh control→data seam; the
port's copy of ``consul_tpu/connect/proxycfg.py``.

Re-design of ``agent/proxycfg/manager.go:37`` + ``state.go``: for every
connect-proxy service registered with the local agent, a state machine
watches everything that proxy's data plane needs —

  CA roots          (cache: connect-ca-roots, blocking refresh)
  its leaf cert     (re-signed when the active root changes or the
                    cert approaches expiry — cache-types/
                    connect_ca_leaf.go semantics)
  intentions        (cache: intention-match on the destination, with
                    the cluster's default decision riding along)
  upstream chains   (cache: discovery-chain per upstream)
  upstream health   (cache: health-services with connect=True per
                    chain target, re-reconciled when a chain changes —
                    state.go resetWatchesFromChain)

and assembles a versioned ConfigSnapshot.  Consumers (the built-in L4
proxy via the agent HTTP API, tests, a future xDS-alike) wait on
``wait(proxy_id, min_version)`` — the same longpoll shape as a
blocking query — or iterate ``watch()``.

The reference streams Envoy protobufs over gRPC (``xds/server.go:475``);
here the snapshot is a plain dict and the "stream" is the agent's
blocking HTTP endpoint ``/v1/agent/connect/proxy/<id>`` — a deliberate
re-design: one wire codec for the whole framework, no protobuf codegen.
"""

from __future__ import annotations

import asyncio
import datetime
import logging
from typing import AsyncIterator, Optional

from consul_tpu_torch.agent.cache import (
    CONNECT_CA_ROOTS,
    DISCOVERY_CHAIN,
    FEDERATION_MESH_GATEWAYS,
    HEALTH_SERVICES,
    INTENTION_MATCH,
    SERVICE_KIND_NODES,
)

log = logging.getLogger("consul_tpu_torch.proxycfg")

# Re-sign the leaf when less than this fraction of its lifetime remains
# (cache-types/connect_ca_leaf.go renews within an expiry window).
LEAF_RENEW_FRACTION = 0.5


class _ProxyState:
    """One proxy's watch set + snapshot assembly (proxycfg/state.go)."""

    def __init__(self, manager: "ProxyConfigManager", proxy_id: str,
                 service: dict):
        self.m = manager
        self.proxy_id = proxy_id
        self.service = service
        proxy = service.get("proxy") or {}
        self.destination = proxy.get("destination_service") or \
            service["service"].removesuffix("-proxy")
        self.upstreams: list[dict] = list(proxy.get("upstreams") or [])
        self.local_service_address = proxy.get(
            "local_service_address",
            f"127.0.0.1:{proxy.get('local_service_port', 0)}")

        self.version = 0
        self.snapshot: Optional[dict] = None
        self.changed = asyncio.Event()     # wakes wait()ers
        self._wake = asyncio.Event()       # wakes the assembly loop
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._leaf: Optional[dict] = None
        self._health_watched: set[str] = set()

    # -- watch plumbing -------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        # Wake blocked wait()ers so they observe the deregistration
        # instead of sleeping out their longpoll (an HTTP server
        # draining handlers would otherwise stall on them).
        self.changed.set()

    async def _run(self) -> None:
        cache = self.m.cache
        # Prime + subscribe the static sources; health watches are
        # reconciled per chain below.
        cache.notify(CONNECT_CA_ROOTS, {}, self._queue)
        cache.notify(INTENTION_MATCH, {"destination": self.destination},
                     self._queue)
        for up in self.upstreams:
            cache.notify(DISCOVERY_CHAIN,
                         {"name": up["destination_name"]}, self._queue)
        while True:
            try:
                await self._assemble()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - keep the proxy served
                log.exception("proxycfg %s: assembly failed", self.proxy_id)
                await asyncio.sleep(0.5)
                continue
            # Wait for any watched source to change (coalesce a burst).
            await self._queue.get()
            while not self._queue.empty():
                self._queue.get_nowait()

    # -- leaf lifecycle -------------------------------------------------

    def _leaf_stale(self, active_root_id: str) -> bool:
        if self._leaf is None:
            return True
        if self._leaf.get("root_id") != active_root_id:
            return True  # root rotated: roll the cert
        try:
            expires = datetime.datetime.fromisoformat(
                self._leaf["valid_before"])
            issued = datetime.datetime.fromisoformat(
                self._leaf.get("valid_after", self._leaf["valid_before"]))
            life = (expires - issued).total_seconds()
            left = (expires - datetime.datetime.now(datetime.timezone.utc)
                    ).total_seconds()
            return life > 0 and left < life * LEAF_RENEW_FRACTION
        except (KeyError, ValueError):
            return False

    # -- assembly -------------------------------------------------------

    async def _assemble(self) -> None:
        cache, rpc = self.m.cache, self.m.rpc
        roots_out = await cache.get(CONNECT_CA_ROOTS, {})
        roots = roots_out.get("roots") or []
        active_root_id = next(
            (r["id"] for r in roots if r.get("active")), "")

        if self._leaf_stale(active_root_id):
            out = await rpc("ConnectCA.Sign",
                            {"service": self.destination})
            self._leaf = out["leaf"]

        intent_out = await cache.get(
            INTENTION_MATCH, {"destination": self.destination})

        ups: dict[str, dict] = {}
        for up in self.upstreams:
            name = up["destination_name"]
            chain_out = await cache.get(DISCOVERY_CHAIN, {"name": name})
            chain = chain_out.get("chain") or {}
            instances: dict[str, list[dict]] = {}
            for tid, target in (chain.get("targets") or {}).items():
                remote = target["datacenter"] != self.m.datacenter
                mode = target.get("mesh_gateway", "default")
                if remote and mode in ("local", "remote"):
                    # WAN federation through mesh gateways
                    # (proxycfg/state.go resetWatchesFromChain →
                    # mesh-gateway watches; endpoints.go
                    # makeUpstreamLoadAssignmentForMeshGateway): dial a
                    # gateway instead of the instances — the LOCAL DC's
                    # gateways in local mode, the TARGET DC's (WAN
                    # addresses, via federation state) in remote mode.
                    instances[tid] = await self._gateway_endpoints(
                        mode, target["datacenter"])
                    continue
                req = {"service": target["service"], "connect": True,
                       "passing_only": True}
                if remote:
                    req["dc"] = target["datacenter"]
                hkey = f"{target['service']}@{target['datacenter']}"
                if hkey not in self._health_watched:
                    # state.go resetWatchesFromChain: new chain targets
                    # grow the watch set (stale ones age out of the
                    # cache on their own).
                    cache.notify(HEALTH_SERVICES, req, self._queue)
                    self._health_watched.add(hkey)
                health_out = await cache.get(HEALTH_SERVICES, req)
                instances[tid] = [
                    self._endpoint(row)
                    for row in health_out.get("nodes") or []
                ]
            ups[name] = {
                "chain": chain,
                "instances": instances,
                "local_bind_port": up.get("local_bind_port", 0),
                "local_bind_address": up.get("local_bind_address",
                                             "127.0.0.1"),
                "datacenter": up.get("datacenter", ""),
            }

        self.version += 1
        self.snapshot = {
            "proxy_id": self.proxy_id,
            "destination_service": self.destination,
            "datacenter": self.m.datacenter,
            "local_service_address": self.local_service_address,
            "roots": roots,
            "active_root_id": active_root_id,
            "leaf": self._leaf,
            "intentions": intent_out.get("intentions") or [],
            "default_allow": bool(intent_out.get("default_allow", True)),
            "upstreams": ups,
        }
        self.changed.set()
        self.changed = asyncio.Event()

    async def _gateway_endpoints(self, mode: str,
                                 target_dc: str) -> list[dict]:
        """Mesh-gateway endpoints for a gateway-routed upstream, with a
        live watch so assembly re-runs as gateways come and go.

        local mode   this DC's own gateways, straight from the local
                     catalog (health-watched — a freshly registered
                     gateway is visible immediately, and the watch fires
                     on changes)
        remote mode  the TARGET DC's gateways (WAN addresses) from the
                     replicated federation-state map, watched through
                     the federation-mesh-gateways cache type
        """
        from consul_tpu_torch.connect.gateways import (
            KIND_MESH_GATEWAY,
            gateway_endpoint,
        )

        cache = self.m.cache
        if mode == "local":
            # KIND-indexed health-aware catalog watch: any local mesh
            # gateway routes service traffic regardless of its service
            # name or wanfed meta (the wanfed:1 gate belongs to the
            # SERVER plane's gateway_locator.go, not to upstream
            # endpoints — xds/endpoints.go
            # makeUpstreamLoadAssignmentForMeshGateway uses the
            # kind-filtered CheckServiceNodes watch), but a gateway with
            # a failing check must drop out.
            req = {"kind": KIND_MESH_GATEWAY, "passing_only": True}
            if "local-gateways" not in self._health_watched:
                cache.notify(SERVICE_KIND_NODES, req, self._queue)
                self._health_watched.add("local-gateways")
            out = await cache.get(SERVICE_KIND_NODES, req)
            svcs = out.get("nodes") or []
            wan = False
        else:
            # The federation-state map only ever carries wanfed
            # gateways (the AE publisher filters) — no extra gate here.
            if "federation-gateways" not in self._health_watched:
                cache.notify(FEDERATION_MESH_GATEWAYS, {}, self._queue)
                self._health_watched.add("federation-gateways")
            out = await cache.get(FEDERATION_MESH_GATEWAYS, {})
            svcs = (out.get("gateways") or {}).get(target_dc, [])
            wan = True
        return [
            gateway_endpoint(svc, wan=wan) for svc in svcs
            if svc.get("kind") == KIND_MESH_GATEWAY
        ]

    @staticmethod
    def _endpoint(row: dict) -> dict:
        svc = row.get("service") or {}
        node = row.get("node") or {}
        return {
            "address": svc.get("address") or node.get("address", ""),
            "port": svc.get("port", 0),
            "proxy_id": svc.get("id", ""),
            "node": node.get("node", ""),
        }


class ProxyConfigManager:
    """proxycfg/manager.go Manager: tracks registered proxy services
    and owns one _ProxyState each."""

    def __init__(self, cache, rpc, datacenter: str = "dc1"):
        self.cache = cache
        self.rpc = rpc
        self.datacenter = datacenter
        self._states: dict[str, _ProxyState] = {}

    # Called from Agent.add_service / remove_service.
    def register(self, service: dict) -> None:
        if service.get("kind") != "connect-proxy":
            return
        pid = service.get("id") or service["service"]
        self.deregister(pid)
        state = _ProxyState(self, pid, service)
        self._states[pid] = state
        state.start()

    def deregister(self, proxy_id: str) -> None:
        state = self._states.pop(proxy_id, None)
        if state is not None:
            state.stop()

    def proxy_ids(self) -> list[str]:
        return list(self._states)

    def snapshot(self, proxy_id: str) -> Optional[tuple[int, dict]]:
        state = self._states.get(proxy_id)
        if state is None or state.snapshot is None:
            return None
        return state.version, state.snapshot

    async def wait(self, proxy_id: str, min_version: int = 0,
                   timeout: float = 300.0) -> Optional[tuple[int, dict]]:
        """Blocking-query shape over snapshot versions (the xDS stream
        stand-in): returns as soon as version > min_version, or the
        current snapshot at timeout."""
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            state = self._states.get(proxy_id)
            if state is None:
                return None
            # Capture the event BEFORE the version check: _assemble
            # sets-then-replaces it, so a change landing between check
            # and await still wakes us.
            ev = state.changed
            if state.snapshot is not None and state.version > min_version:
                return state.version, state.snapshot
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return (state.version, state.snapshot) \
                    if state.snapshot is not None else None
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                pass

    async def watch(self, proxy_id: str) -> AsyncIterator[tuple[int, dict]]:
        """Async iterator of snapshot versions (manager.go Watch)."""
        version = 0
        while True:
            out = await self.wait(proxy_id, min_version=version)
            if out is None:
                return
            version, snap = out
            yield version, snap

    def stop(self) -> None:
        for state in list(self._states.values()):
            state.stop()
        self._states.clear()
