"""Agent-side cache with background blocking-query refresh; the port's
copy of ``consul_tpu/agent/cache.py``.

Equivalent of ``agent/cache`` + ``agent/cache-types`` (SURVEY.md §2.3):
a generic cache keyed by (type, request-key) where each *type* declares
how to fetch (an RPC method) and whether the entry supports background
refresh.  Semantics kept from the reference:

  Get              cache.go:285 — hit returns immediately; miss blocks
                   on a single-flight fetch (concurrent Gets for the
                   same key share one RPC)
  fetch            cache.go:488 — runs the RPC; for refresh types the
                   request carries min_query_index so the server
                   long-polls and returns only on change
  background       cache.go:717 — refresh types keep fetching in a
  refresh          loop after the first Get, so subsequent reads are
                   always warm and watchers learn of changes without
                   polling; errors back off (RefreshBackoffMin)
  TTL              entries unused for ``ttl`` seconds are evicted and
                   their refresh loop stopped (cache.go expiry heap)
  Notify           watch.go — register an asyncio.Queue to receive
                   every update of an entry

Registered types mirror ``cache-types/``: health services, catalog
services/nodes/node-services, KV gets, prepared-query execution (the
latter TTL-only, like the reference's prepared_simple type).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Any, Awaitable, Callable, Optional

log = logging.getLogger("consul_tpu_torch.cache")

# cache-types/*.go registration names (reference spelling).
HEALTH_SERVICES = "health-services"
CATALOG_SERVICES = "catalog-services"
CATALOG_LIST_NODES = "catalog-list-nodes"
CATALOG_NODE_SERVICES = "catalog-node-services"
KV_GET = "kv-get"
NODE_INFO = "internal-node-info"
PREPARED_QUERY = "prepared-query"
CONNECT_CA_ROOTS = "connect-ca-roots"
INTENTION_MATCH = "intention-match"
DISCOVERY_CHAIN = "discovery-chain"
FEDERATION_MESH_GATEWAYS = "federation-state-list-mesh-gateways"
SERVICE_KIND_NODES = "catalog-service-kind-nodes"
CATALOG_SERVICES_DUMP = "catalog-service-dump"

REFRESH_BACKOFF_MIN = 0.5   # cache.go RefreshBackoffMin (scaled-friendly)
REFRESH_TIMEOUT = 600.0     # cache-types' 10-minute blocking wait
MAX_REFRESH_TASKS = 512     # cap on concurrent background refreshers


@dataclasses.dataclass(frozen=True)
class CacheType:
    """One registered cache type (cache.go RegisterType)."""

    name: str
    method: str                       # RPC method to fetch with
    refresh: bool = True              # background blocking refresh?
    ttl: float = 600.0                # eviction after this much disuse
    key_fields: tuple = ()            # request fields forming the key


TYPES: dict[str, CacheType] = {
    t.name: t
    for t in (
        CacheType(HEALTH_SERVICES, "Health.ServiceNodes",
                  key_fields=("service", "tag", "passing_only", "connect",
                              "dc")),
        # proxycfg data sources (cache-types/connect_ca_root.go,
        # intention_match.go, discovery_chain.go).
        CacheType(CONNECT_CA_ROOTS, "ConnectCA.Roots", key_fields=("dc",)),
        CacheType(INTENTION_MATCH, "Intention.Match",
                  key_fields=("destination", "dc")),
        CacheType(DISCOVERY_CHAIN, "DiscoveryChain.Get",
                  key_fields=("name", "dc")),
        # cache-types/federation_state_list_mesh_gateways.go: the data
        # plane's cross-DC gateway map, blocking on federation states.
        CacheType(FEDERATION_MESH_GATEWAYS,
                  "FederationState.ListMeshGateways", key_fields=("dc",)),
        # Kind-indexed catalog watch (the reference's internal
        # ServiceDump kind filter) — local mesh-gateway discovery.
        CacheType(SERVICE_KIND_NODES, "Catalog.ServiceKindNodes",
                  key_fields=("kind", "passing_only", "dc")),
        CacheType(CATALOG_SERVICES_DUMP, "Catalog.ServiceDump",
                  key_fields=("dc",)),
        CacheType(CATALOG_SERVICES, "Catalog.ServiceNodes",
                  key_fields=("service", "tag", "dc")),
        CacheType(CATALOG_LIST_NODES, "Catalog.ListNodes",
                  key_fields=("dc",)),
        CacheType(CATALOG_NODE_SERVICES, "Catalog.NodeServices",
                  key_fields=("node", "dc")),
        CacheType(KV_GET, "KVS.Get", key_fields=("key", "dc")),
        CacheType(NODE_INFO, "Internal.NodeInfo", key_fields=("node", "dc")),
        # Prepared queries change rarely but executions are per-request;
        # the reference caches them TTL-only (no blocking refresh).
        CacheType(PREPARED_QUERY, "PreparedQuery.Execute", refresh=False,
                  ttl=3.0, key_fields=("query_id", "limit", "dc")),
    )
}


class _Entry:
    __slots__ = (
        "value", "meta", "index", "valid", "fetching", "waiters",
        "last_access", "fetched_at", "refresh_task", "watchers", "error",
    )

    def __init__(self) -> None:
        self.value: Any = None
        self.meta: dict = {}
        self.index = 0
        self.valid = False
        self.fetching = False
        self.waiters: list[asyncio.Future] = []
        self.last_access = time.monotonic()
        self.fetched_at = 0.0
        self.refresh_task: Optional[asyncio.Task] = None
        self.watchers: list[asyncio.Queue] = []
        self.error: Optional[Exception] = None


class AgentCache:
    """cache.go Cache."""

    def __init__(
        self,
        rpc: Callable[[str, dict], Awaitable[Any]],
        types: Optional[dict[str, CacheType]] = None,
        refresh_timeout: float = REFRESH_TIMEOUT,
        backoff_min: float = REFRESH_BACKOFF_MIN,
    ):
        self._rpc = rpc
        self._types = types or TYPES
        self._entries: dict[tuple, _Entry] = {}
        self._refresh_timeout = refresh_timeout
        self._backoff_min = backoff_min
        self.hits = 0
        self.misses = 0
        self._shutdown = False

    # ------------------------------------------------------------------

    def _key(self, t: CacheType, body: dict) -> tuple:
        return (t.name,) + tuple(
            repr(body.get(f)) for f in t.key_fields
        )

    async def get(self, type_name: str, body: dict) -> dict:
        """cache.go:285 Get: returns the RPC response body (with its
        meta) from cache, fetching on miss."""
        t = self._types[type_name]
        key = self._key(t, body)
        entry = self._entries.get(key)
        if entry is None:
            entry = _Entry()
            self._entries[key] = entry
        now = time.monotonic()
        entry.last_access = now
        # Refresh types stay valid as long as their background loop
        # lives; TTL-only types (prepared queries) age out and re-fetch
        # (cache.go:285 checks the expiry on hit for non-refresh types).
        fresh = entry.valid and (
            t.refresh or now - entry.fetched_at < t.ttl
        )
        if fresh:
            self.hits += 1
            return entry.value
        self.misses += 1
        self._maybe_sweep()
        await self._fetch(t, key, entry, dict(body))
        if entry.error is not None and not entry.valid:
            raise entry.error
        return entry.value

    def _maybe_sweep(self) -> None:
        """Drop expired TTL-only entries so distinct one-shot keys
        (e.g. prepared-query ids) can't accumulate without bound."""
        if len(self._entries) < 256:
            return
        now = time.monotonic()
        for key in list(self._entries):
            t = self._types.get(key[0])
            entry = self._entries[key]
            if (
                t is not None
                and not t.refresh
                and now - entry.last_access > t.ttl
            ):
                del self._entries[key]

    def notify(self, type_name: str, body: dict, q: asyncio.Queue) -> None:
        """watch.go Notify: q receives every subsequent update of the
        entry (requires a refresh type).  Call get() first to prime."""
        t = self._types[type_name]
        key = self._key(t, body)
        entry = self._entries.get(key)
        if entry is None:
            entry = _Entry()
            self._entries[key] = entry
        entry.watchers.append(q)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stop(self) -> None:
        self._shutdown = True
        for entry in self._entries.values():
            if entry.refresh_task is not None:
                entry.refresh_task.cancel()
        self._entries.clear()

    # ------------------------------------------------------------------

    async def _fetch(self, t: CacheType, key: tuple, entry: _Entry,
                     body: dict) -> None:
        """Single-flight fetch (cache.go:488): concurrent callers await
        one in-flight RPC."""
        if entry.fetching:
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            entry.waiters.append(fut)
            await fut
            return
        entry.fetching = True
        try:
            result = await self._rpc(t.method, body)
            entry.value = result
            entry.meta = (result or {}).get("meta") or {}
            entry.index = int(entry.meta.get("index", 0) or 0)
            entry.valid = True
            entry.fetched_at = time.monotonic()
            entry.error = None
            self._notify_watchers(entry)
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            entry.error = e
        finally:
            entry.fetching = False
            for fut in entry.waiters:
                if not fut.done():
                    fut.set_result(None)
            entry.waiters.clear()
        if t.refresh and entry.refresh_task is None and not self._shutdown:
            # Cap background refreshers: a flood of distinct (possibly
            # bogus) names must not pin an unbounded task per key —
            # entries over the cap behave as TTL-only.
            active = sum(
                1 for e in self._entries.values()
                if e.refresh_task is not None and not e.refresh_task.done()
            )
            if active < MAX_REFRESH_TASKS:
                entry.refresh_task = asyncio.create_task(
                    self._refresh_loop(t, key, entry, body)
                )

    async def _refresh_loop(self, t: CacheType, key: tuple, entry: _Entry,
                            body: dict) -> None:
        """cache.go:717 refresh: blocking query against the last index;
        each change updates the entry in place and notifies watchers.
        Stops when the entry ages out (TTL disuse eviction)."""
        backoff = self._backoff_min
        while not self._shutdown:
            if time.monotonic() - entry.last_access > t.ttl:
                # Expired from disuse: drop the entry (expiry heap).
                if self._entries.get(key) is entry:
                    del self._entries[key]
                entry.refresh_task = None
                return
            req = dict(body)
            # A zero index would make the server answer immediately
            # (blocking_query only blocks for min_query_index > 0) and
            # this loop would hot-spin; ask from at least 1.
            req["min_query_index"] = max(entry.index, 1)
            req["max_query_time"] = self._refresh_timeout
            req["allow_stale"] = True
            try:
                result = await self._rpc(t.method, req)
                entry.value = result
                entry.meta = (result or {}).get("meta") or {}
                new_index = int(entry.meta.get("index", 0) or 0)
                changed = new_index != entry.index
                entry.index = new_index
                entry.valid = True
                entry.fetched_at = time.monotonic()
                backoff = self._backoff_min
                if changed:
                    self._notify_watchers(entry)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - transient RPC failures
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 30.0)

    def _notify_watchers(self, entry: _Entry) -> None:
        for q in entry.watchers:
            q.put_nowait(entry.value)
