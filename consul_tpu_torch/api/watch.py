"""Watch plans: long-poll a view and invoke a handler on change; the port's
copy of ``consul_tpu/api/watch.py``.

Equivalent of ``api/watch`` (plan types registered in
``api/watch/funcs.go:18-29``): key, keyprefix, services, nodes,
service, checks, event.  A plan loops a blocking query with the last
seen index and fires the handler whenever the index moves and the
payload differs (watch.Plan.Run).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Callable, Optional

from consul_tpu_torch.api.client import ConsulClient, QueryOptions

log = logging.getLogger("consul_tpu_torch.watch")

DEFAULT_WAIT = "60s"


class WatchPlan:
    def __init__(self, params: dict, client: ConsulClient):
        self.params = params
        self.client = client
        self.type = params["type"]
        self._fetch = _FETCHERS[self.type]
        self.handlers: list[Callable[[int, Any], None]] = []
        self._stop = False
        self._task: Optional[asyncio.Task] = None
        self.last_index = 0
        self._last_payload: Optional[str] = None

    def on_change(self, handler: Callable[[int, Any], None]) -> None:
        self.handlers.append(handler)

    async def run(self) -> None:
        """Blocking-run the plan until stop() (watch.Plan.RunWithConfig)."""
        backoff = 0.1
        while not self._stop:
            opts = QueryOptions(index=self.last_index, wait=DEFAULT_WAIT)
            try:
                index, data = await self._fetch(self.client, self.params, opts)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — retry w/ backoff
                log.warning("watch fetch failed: %s", e)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 10.0)
                continue
            backoff = 0.1
            if index < self.last_index:
                index = 0  # index reset (watch.go handling)
            if index == self.last_index:
                continue  # long-poll timed out with no change
            fingerprint = json.dumps(data, sort_keys=True, default=str)
            self.last_index = index
            if fingerprint == self._last_payload:
                continue  # spurious wake (index moved, view unchanged)
            self._last_payload = fingerprint
            for handler in self.handlers:
                try:
                    handler(index, data)
                except Exception:  # noqa: BLE001
                    log.exception("watch handler failed")

    def start(self) -> None:
        self._task = asyncio.create_task(self.run())

    def stop(self) -> None:
        self._stop = True
        if self._task:
            self._task.cancel()


# -- fetch functions (api/watch/funcs.go) -----------------------------------


async def _key(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    entry, meta = await c.kv.get(p["key"], opts)
    return meta.index, entry


async def _keyprefix(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    entries, meta = await c.kv.list(p["prefix"], opts)
    return meta.index, entries


async def _services(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    services, meta = await c.catalog.services(opts)
    return meta.index, services


async def _nodes(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    nodes, meta = await c.catalog.nodes(opts)
    return meta.index, nodes


async def _service(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    rows, meta = await c.health.service(
        p["service"], tag=p.get("tag", ""),
        passing=bool(p.get("passingonly", False)), opts=opts,
    )
    return meta.index, rows


async def _checks(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    if p.get("service"):
        rows, meta = await c.health.checks(p["service"], opts)
    else:
        rows, meta = await c.health.state(p.get("state", "any"), opts)
    return meta.index, rows


async def _event(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    events, meta = await c.event.list(p.get("name", ""), opts)
    return meta.index, events


async def _connect_roots(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    """funcs.go connectRootsWatch: the CA root set."""
    data, meta = await c.read("/v1/connect/ca/roots", opts=opts,
                              allow_404=False)
    return meta.index, data


async def _connect_leaf(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    """funcs.go connectLeafWatch: a service's leaf certificate.  The
    agent caches the leaf per service (re-signed only on root rotation
    or half-life), so a paced poll + payload fingerprint gives the same
    change semantics as the reference's cache-notify watch."""
    if opts.index:
        await asyncio.sleep(1.0)
    data, _meta = await c.read(
        f"/v1/agent/connect/ca/leaf/{p['service']}", allow_404=False)
    return opts.index + 1, data


async def _agent_service(c: ConsulClient, p: dict, opts) -> tuple[int, Any]:
    """funcs.go agentServiceWatch: one locally registered service.  The
    agent-local endpoint has no blocking index, so this POLLS on a fixed
    cadence (the reference's hash-based watch does the same under the
    hood) — the returned pseudo-index always advances and the plan's
    payload fingerprint suppresses no-change wakeups."""
    if opts.index:
        await asyncio.sleep(1.0)  # pacing between polls
    data, _meta = await c.read(f"/v1/agent/service/{p['service_id']}")
    return opts.index + 1, data


_FETCHERS = {
    "key": _key,
    "keyprefix": _keyprefix,
    "services": _services,
    "nodes": _nodes,
    "service": _service,
    "checks": _checks,
    "event": _event,
    "connect_roots": _connect_roots,
    "connect_leaf": _connect_leaf,
    "agent_service": _agent_service,
}


def parse_watch(params: dict, client: ConsulClient) -> WatchPlan:
    """watch.Parse: validate type + required params."""
    wtype = params.get("type")
    if wtype not in _FETCHERS:
        raise ValueError(
            f"unknown watch type {wtype!r}; expected one of "
            f"{sorted(_FETCHERS)}"
        )
    required = {"key": ["key"], "keyprefix": ["prefix"],
                "service": ["service"], "connect_leaf": ["service"],
                "agent_service": ["service_id"]}.get(wtype, [])
    for field in required:
        if not params.get(field):
            raise ValueError(f"watch type {wtype!r} requires {field!r}")
    return WatchPlan(params, client)
