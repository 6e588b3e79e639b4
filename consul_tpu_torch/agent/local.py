"""Agent-local catalog state + anti-entropy sync; the port's copy of
``consul_tpu/agent/local.py``.

Equivalent of ``agent/local`` (the agent's own view of its services and
checks, with per-entry in-sync flags) and ``agent/ae`` (the sync loop
that reconciles it against the servers):

  local catalog      local/state.go — services/checks registered on
                     THIS agent, each entry carrying an InSync flag;
                     check output updates are deferred to avoid write
                     amplification (CheckUpdateInterval)
  SyncFull           local/state.go:1020 — fetch the server's view of
                     this node (Catalog.NodeServices + Health.NodeChecks),
                     deregister remote-onlys, push out-of-sync entries
  SyncChanges        local/state.go:1038 — push only dirty entries
  sync cadence       ae/ae.go:25-38 — base interval scaled by
                     log2(cluster_size/128), staggered, retried on
                     failure with backoff
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
import random
import time
from typing import Awaitable, Callable, Optional

from consul_tpu_torch.store.state import HEALTH_CRITICAL, HEALTH_PASSING, SERF_CHECK_ID

log = logging.getLogger("consul_tpu_torch.local")

# ae/ae.go constants.
SYNC_STAGGER_FRACTION = 16
RETRY_FAILED_INTERVAL_S = 15.0
SCALE_THRESHOLD = 128  # ae.go:25 aeScaleThreshold


def sync_scale_factor(cluster_size: int) -> float:
    """ae.go:31-38 scaleFactor: 1 + log2(size/threshold), floor 1."""
    if cluster_size <= SCALE_THRESHOLD:
        return 1.0
    return 1.0 + math.log2(cluster_size / SCALE_THRESHOLD)


@dataclasses.dataclass
class LocalService:
    service: dict
    in_sync: bool = False
    deleted: bool = False


@dataclasses.dataclass
class LocalCheck:
    check: dict
    in_sync: bool = False
    deleted: bool = False
    defer_until: float = 0.0  # deferred output-only update


class LocalState:
    """The agent's source-of-truth for its own registrations
    (``local.State``)."""

    def __init__(
        self,
        node_name: str,
        rpc: Callable[[str, dict], Awaitable[dict]],
        address: str = "",
        check_update_interval_s: float = 5 * 60.0,
    ):
        self.node_name = node_name
        self.address = address
        self.rpc = rpc  # client/server delegate RPC entry point
        self.check_update_interval_s = check_update_interval_s
        self.services: dict[str, LocalService] = {}
        self.checks: dict[str, LocalCheck] = {}
        self.on_change: Optional[Callable[[], None]] = None  # wakes syncer

    # -- registration (local/state.go AddService/RemoveService/...) ---------

    def _changed(self) -> None:
        if self.on_change:
            self.on_change()

    def add_service(self, service: dict) -> None:
        sid = service.get("id") or service["service"]
        service = dict(service, id=sid)
        self.services[sid] = LocalService(service=service)
        self._changed()

    def remove_service(self, service_id: str) -> bool:
        entry = self.services.get(service_id)
        if entry is None:
            return False
        entry.deleted = True
        entry.in_sync = False
        for c in self.checks.values():
            if c.check.get("service_id") == service_id:
                c.deleted = True
                c.in_sync = False
        self._changed()
        return True

    def add_check(self, check: dict) -> None:
        cid = check.get("check_id") or check["name"]
        check = dict(check, check_id=cid)
        check.setdefault("status", HEALTH_CRITICAL)
        self.checks[cid] = LocalCheck(check=check)
        self._changed()

    def remove_check(self, check_id: str) -> bool:
        entry = self.checks.get(check_id)
        if entry is None:
            return False
        entry.deleted = True
        entry.in_sync = False
        self._changed()
        return True

    def update_check(self, check_id: str, status: str, output: str = "") -> None:
        """Check executor callback (local/state.go UpdateCheck): a pure
        output change is deferred up to CheckUpdateInterval to avoid
        constant catalog writes; a status change syncs immediately."""
        entry = self.checks.get(check_id)
        if entry is None or entry.deleted:
            return
        now = time.monotonic()
        if entry.check["status"] == status:
            if entry.check.get("output") == output:
                return
            entry.check["output"] = output
            if entry.defer_until == 0.0:
                entry.defer_until = now + self.check_update_interval_s
            if now < entry.defer_until:
                return  # deferred; SyncFull will pick it up eventually
        else:
            entry.check["status"] = status
            entry.check["output"] = output
        entry.defer_until = 0.0
        entry.in_sync = False
        self._changed()

    def service_records(self) -> list[dict]:
        return [e.service for e in self.services.values() if not e.deleted]

    def check_records(self) -> list[dict]:
        return [e.check for e in self.checks.values() if not e.deleted]

    # -- sync (local/state.go SyncFull/SyncChanges) -------------------------

    async def sync_full(self) -> None:
        """Reconcile against the servers' view of this node."""
        remote_svcs: dict[str, dict] = {}
        remote_checks: dict[str, dict] = {}
        out = await self.rpc(
            "Catalog.NodeServices", {"node": self.node_name, "allow_stale": True}
        )
        for svc in out.get("services") or []:
            remote_svcs[svc["id"]] = svc
        out = await self.rpc(
            "Health.NodeChecks", {"node": self.node_name, "allow_stale": True}
        )
        for chk in out.get("checks") or []:
            remote_checks[chk["check_id"]] = chk

        # Remote-only services/checks were registered by an old
        # incarnation: deregister (except the serf health check, which
        # the leader owns).
        for sid in remote_svcs:
            if sid not in self.services or self.services[sid].deleted:
                await self._deregister(service_id=sid)
        for cid in remote_checks:
            if cid == SERF_CHECK_ID:
                continue
            if cid not in self.checks or self.checks[cid].deleted:
                await self._deregister(check_id=cid)

        # Mark local entries out-of-sync when remote disagrees.  Local
        # dicts are normalized with the catalog's own defaults first
        # (state.py _ensure_service_txn/_ensure_check_txn), otherwise a
        # missing key (None) vs server default ('') would flag every
        # entry dirty and re-register the world each interval.
        for sid, entry in self.services.items():
            remote = remote_svcs.get(sid)
            local = entry.service
            entry.in_sync = (
                not entry.deleted
                and remote is not None
                and remote.get("service") == local.get("service")
                and int(remote.get("port", 0)) == int(local.get("port", 0))
                and (remote.get("address") or "") == (local.get("address") or "")
                and list(remote.get("tags") or []) == list(local.get("tags") or [])
            )
        for cid, entry in self.checks.items():
            remote = remote_checks.get(cid)
            local = entry.check
            entry.in_sync = (
                not entry.deleted
                and remote is not None
                and remote.get("status") == local.get("status")
                and (remote.get("output") or "") == (local.get("output") or "")
            )
        await self.sync_changes()

    async def sync_changes(self) -> None:
        """Push every dirty entry (local/state.go SyncChanges)."""
        for sid, entry in list(self.services.items()):
            if entry.deleted:
                await self._deregister(service_id=sid)
                # The id may have been re-registered while the RPC was
                # in flight — only drop the entry we deregistered.
                if self.services.get(sid) is entry:
                    del self.services[sid]
            elif not entry.in_sync:
                await self._register_service(entry)
        for cid, entry in list(self.checks.items()):
            if entry.deleted:
                await self._deregister(check_id=cid)
                if self.checks.get(cid) is entry:
                    del self.checks[cid]
            elif not entry.in_sync:
                await self._register_check(entry)

    async def _register_service(self, entry: LocalService) -> None:
        svc = entry.service
        checks = [
            c.check
            for c in self.checks.values()
            if not c.deleted and c.check.get("service_id") == svc["id"]
        ]
        await self.rpc(
            "Catalog.Register",
            {
                "node": self.node_name,
                "address": self.address,
                "service": svc,
                "checks": checks,
            },
        )
        entry.in_sync = True
        for c in self.checks.values():
            if not c.deleted and c.check.get("service_id") == svc["id"]:
                c.in_sync = True

    async def _register_check(self, entry: LocalCheck) -> None:
        await self.rpc(
            "Catalog.Register",
            {
                "node": self.node_name,
                "address": self.address,
                "check": entry.check,
            },
        )
        entry.in_sync = True

    async def _deregister(
        self, service_id: str = "", check_id: str = ""
    ) -> None:
        body: dict = {"node": self.node_name}
        if service_id:
            body["service_id"] = service_id
        if check_id:
            body["check_id"] = check_id
        await self.rpc("Catalog.Deregister", body)


class StateSyncer:
    """The anti-entropy pacing loop (``ae/ae.go:44-151``): full sync on
    start, then periodically (interval scaled by cluster size), with
    edge-triggered partial syncs in between and retry-with-stagger on
    failure."""

    def __init__(
        self,
        state: LocalState,
        cluster_size: Callable[[], int],
        sync_interval_s: float = 60.0,
        retry_interval_s: float = RETRY_FAILED_INTERVAL_S,
        rng: Optional[random.Random] = None,
    ):
        self.state = state
        self.cluster_size = cluster_size
        self.sync_interval_s = sync_interval_s
        self.retry_interval_s = retry_interval_s
        self._rng = rng or random.Random()
        self._changes = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        state.on_change = self._changes.set
        self.synced_once = asyncio.Event()

    def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()

    def _stagger(self, interval: float) -> float:
        return interval + self._rng.random() * interval / SYNC_STAGGER_FRACTION

    async def _run(self) -> None:
        while True:
            try:
                await self.state.sync_full()
                self.synced_once.set()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — retry on any RPC failure
                log.warning("anti-entropy full sync failed: %s", e)
                await asyncio.sleep(self._stagger(self.retry_interval_s))
                continue
            # Between full syncs, service edge-triggered changes.
            interval = self._stagger(
                self.sync_interval_s * sync_scale_factor(self.cluster_size())
            )
            deadline = time.monotonic() + interval
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    await asyncio.wait_for(self._changes.wait(), remaining)
                except asyncio.TimeoutError:
                    break
                self._changes.clear()
                try:
                    await self.state.sync_changes()
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001
                    log.warning("anti-entropy partial sync failed: %s", e)
                    break  # fall through to a full sync + retry pacing
