"""The replicated state store: catalog, KV, sessions, coordinates; the
port's copy of ``consul_tpu/store/state.py``.

Equivalent of the reference's ``agent/consul/state`` package — a
``go-memdb`` database of domain tables whose radix watches power
blocking queries (``state/state_store.go:102``, schema registry
``state/schema.go:16-38``).  Every record carries ``create_index`` /
``modify_index`` (the Raft log index of the write), and an ``index``
table tracks the last-modified index per table
(``maxIndexTxn``) so queries can report ``X-Consul-Index``.

Tables: nodes, services, checks, kvs, tombstones (graveyard), sessions,
coordinates, config_entries, prepared_queries, acl_tokens, acl_policies,
index.

Deletions of KV entries leave **tombstones** (``state/graveyard.go``)
so prefix listings report a bumped index after a delete; they are
reaped periodically by the leader (tombstone GC, ``leader.go:292``).

All writes go through ``StateStore`` methods taking an explicit
``idx`` (the Raft index) — the FSM is the only writer in a server,
mirroring ``fsm/fsm.go:102``.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

from consul_tpu_torch.store.memdb import (
    SEP,
    Change,
    IndexSchema,
    MemDB,
    MemTxn,
    TableSchema,
    WatchSet,
)

# Check status values (reference api/health.go).
HEALTH_PASSING = "passing"
HEALTH_WARNING = "warning"
HEALTH_CRITICAL = "critical"

# Session invalidation behaviors (structs/structs.go SessionBehavior).
SESSION_BEHAVIOR_RELEASE = "release"
SESSION_BEHAVIOR_DELETE = "delete"

SERF_CHECK_ID = "serfHealth"  # agent/structs: SerfCheckID


def _b(s: str) -> bytes:
    return s.encode()


def _schemas() -> list[TableSchema]:
    return [
        TableSchema("nodes", primary=lambda r: _b(r["node"])),
        TableSchema(
            "services",
            primary=lambda r: _b(r["node"]) + SEP + _b(r["id"]),
            indexes=(IndexSchema("service", key=lambda r: _b(r["service"])),),
        ),
        TableSchema(
            "checks",
            primary=lambda r: _b(r["node"]) + SEP + _b(r["check_id"]),
            indexes=(
                IndexSchema(
                    "service",
                    key=lambda r: _b(r["service_name"]) if r.get("service_name") else None,
                ),
                IndexSchema("status", key=lambda r: _b(r["status"])),
            ),
        ),
        TableSchema(
            "kvs",
            primary=lambda r: _b(r["key"]),
            indexes=(
                IndexSchema(
                    "session",
                    key=lambda r: _b(r["session"]) if r.get("session") else None,
                ),
            ),
        ),
        TableSchema("tombstones", primary=lambda r: _b(r["key"])),
        TableSchema(
            "sessions",
            primary=lambda r: _b(r["id"]),
            indexes=(IndexSchema("node", key=lambda r: _b(r["node"])),),
        ),
        TableSchema(
            "coordinates",
            primary=lambda r: _b(r["node"]) + SEP + _b(r.get("segment", "")),
        ),
        TableSchema(
            "config_entries",
            primary=lambda r: _b(r["kind"]) + SEP + _b(r["name"]),
        ),
        TableSchema("prepared_queries", primary=lambda r: _b(r["id"])),
        TableSchema(
            "acl_tokens",
            primary=lambda r: _b(r["secret_id"]),
            indexes=(
                IndexSchema(
                    "auth_method",
                    key=lambda r: (
                        _b(r["auth_method"]) if r.get("auth_method")
                        else None
                    ),
                ),
            ),
        ),
        TableSchema("acl_policies", primary=lambda r: _b(r["id"])),
        # ACL roles / auth methods / binding rules
        # (state/acl.go ACLRole*, ACLAuthMethod*, ACLBindingRule* txns).
        TableSchema(
            "acl_roles",
            primary=lambda r: _b(r["id"]),
            indexes=(IndexSchema("name", key=lambda r: _b(r["name"])),),
        ),
        TableSchema("acl_auth_methods", primary=lambda r: _b(r["name"])),
        TableSchema(
            "acl_binding_rules",
            primary=lambda r: _b(r["id"]),
            indexes=(
                IndexSchema(
                    "auth_method", key=lambda r: _b(r["auth_method"])
                ),
            ),
        ),
        # Connect: service-to-service intentions + CA roots
        # (state/intention.go, state/connect_ca.go).
        TableSchema(
            "intentions",
            primary=lambda r: _b(r["id"]),
            indexes=(
                IndexSchema("destination",
                            key=lambda r: _b(r["destination"])),
            ),
        ),
        TableSchema("connect_ca_roots", primary=lambda r: _b(r["id"])),
        # WAN federation: one record per datacenter carrying its mesh
        # gateways (state/federation_state.go).
        TableSchema(
            "federation_states", primary=lambda r: _b(r["datacenter"])
        ),
        TableSchema("index", primary=lambda r: _b(r["key"])),
    ]


DUMP_TABLES = [s.name for s in _schemas() if s.name != "index"]


def _writer(fn):
    """Write-method guard: abort any staged txn if the method raises, so
    a malformed request (e.g. a bad raft command replayed by the FSM)
    can never wedge the single-writer lock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except BaseException:
            self.db.abort_active()
            raise

    return wrapper


class StateStore:
    def __init__(self) -> None:
        self.db = MemDB(_schemas())
        self._abandon = None  # lazily-created asyncio.Event
        # Lock-delay expirations per key — wall-clock, leader-local,
        # deliberately NOT part of the replicated state
        # (state/state_store.go:117-118, delay_oss.go).
        self._lock_delays: dict[str, float] = {}

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    def abandon_event(self):
        import asyncio

        if self._abandon is None:
            self._abandon = asyncio.Event()
        return self._abandon

    def abandon(self) -> None:
        """Wake all blocked queries permanently (store being replaced by
        a snapshot restore — ``state_store.go`` AbandonCh)."""
        if self._abandon is not None:
            self._abandon.set()
            self._abandon = None

    @staticmethod
    def _bump(tx: MemTxn, idx: int, *tables: str) -> None:
        for t in tables:
            tx.insert("index", {"key": t, "value": idx})

    def max_index(self, *tables: str, tx: Optional[MemTxn] = None) -> int:
        tx = tx or self.db.txn()
        best = 0
        for t in tables:
            rec = tx.get("index", _b(t))
            if rec:
                best = max(best, rec["value"])
        return best

    def table_watch(self, table: str, ws: WatchSet) -> None:
        """Watch the whole table (root watch)."""
        ws.add(self.db.tree(table).watch_prefix(b""))

    # ------------------------------------------------------------------
    # catalog: nodes / services / checks  (state/catalog.go)
    # ------------------------------------------------------------------

    @_writer
    def ensure_registration(self, idx: int, req: dict) -> None:
        """Atomic node+service+check(s) registration
        (``state/catalog.go:274`` EnsureRegistration)."""
        tx = self.db.txn(write=True)
        self._ensure_node_txn(tx, idx, req)
        if req.get("service"):
            self._ensure_service_txn(tx, idx, req["node"], req["service"])
        # Both the singular Check and the Checks list are honored
        # (EnsureRegistration processes both).
        checks = list(req.get("checks") or [])
        if req.get("check"):
            checks.append(req["check"])
        for check in checks:
            self._ensure_check_txn(tx, idx, req["node"], check)
        tx.commit()

    def _ensure_node_txn(self, tx: MemTxn, idx: int, req: dict) -> None:
        existing = tx.get("nodes", _b(req["node"]))
        node = {
            "node": req["node"],
            "address": req.get("address", existing.get("address", "") if existing else ""),
            "meta": req.get("node_meta", existing.get("meta", {}) if existing else {}),
            "tagged_addresses": req.get(
                "tagged_addresses",
                existing.get("tagged_addresses", {}) if existing else {},
            ),
            "create_index": existing["create_index"] if existing else idx,
            "modify_index": idx,
        }
        if existing and all(
            existing[k] == node[k]
            for k in ("address", "meta", "tagged_addresses")
        ):
            return  # idempotent — don't bump indexes (catalog.go ensureNodeTxn)
        tx.insert("nodes", node)
        self._bump(tx, idx, "nodes")

    def _ensure_service_txn(self, tx: MemTxn, idx: int, node: str, svc: dict) -> None:
        sid = svc.get("id") or svc["service"]
        pk = _b(node) + SEP + _b(sid)
        existing = tx.get("services", pk)
        rec = {
            "node": node,
            "id": sid,
            "service": svc["service"],
            "tags": list(svc.get("tags", [])),
            "address": svc.get("address", ""),
            "port": int(svc.get("port", 0)),
            "meta": svc.get("meta", {}),
            "weights": svc.get("weights", {"passing": 1, "warning": 1}),
            # structs.NodeService.TaggedAddresses: per-service lan/wan
            # addresses — mesh gateways advertise their WAN side here.
            "tagged_addresses": svc.get("tagged_addresses", {}),
            # Mesh registration fields (structs.NodeService Kind/Proxy/
            # Connect): connect_service_nodes keys off these.
            "kind": svc.get("kind", ""),
            "proxy": svc.get("proxy") or {},
            "connect_native": bool(svc.get("connect_native", False)),
            "create_index": existing["create_index"] if existing else idx,
            "modify_index": idx,
        }
        if existing and all(
            existing.get(k) == rec[k]
            for k in ("service", "tags", "address", "port", "meta", "weights",
                      "tagged_addresses", "kind", "proxy", "connect_native")
        ):
            return
        tx.insert("services", rec)
        self._bump(tx, idx, "services")

    def _ensure_check_txn(self, tx: MemTxn, idx: int, node: str, check: dict) -> None:
        cid = check.get("check_id") or check.get("name")
        service_name = check.get("service_name", "")
        if check.get("service_id") and not service_name:
            svc = tx.get("services", _b(node) + SEP + _b(check["service_id"]))
            if svc:
                service_name = svc["service"]
        pk = _b(node) + SEP + _b(cid)
        existing = tx.get("checks", pk)
        rec = {
            "node": node,
            "check_id": cid,
            "name": check.get("name", cid),
            "status": check.get("status", HEALTH_CRITICAL),
            "notes": check.get("notes", ""),
            "output": check.get("output", ""),
            "service_id": check.get("service_id", ""),
            "service_name": service_name,
            "create_index": existing["create_index"] if existing else idx,
            "modify_index": idx,
        }
        if existing and all(
            existing[k] == rec[k]
            for k in ("name", "status", "notes", "output", "service_id",
                      "service_name")
        ):
            return
        tx.insert("checks", rec)
        self._bump(tx, idx, "checks")
        # A check leaving "passing" invalidates sessions that require it
        # (state/session.go invalidation via session_checks).
        if rec["status"] == HEALTH_CRITICAL:
            self._invalidate_sessions_for_check(tx, idx, node, cid)

    @_writer
    def delete_node(self, idx: int, node: str) -> bool:
        """Remove a node and everything attached to it
        (``state/catalog.go`` DeleteNode)."""
        tx = self.db.txn(write=True)
        if tx.get("nodes", _b(node)) is None:
            tx.abort()
            return False
        tx.delete("nodes", _b(node))
        n_svc = tx.delete_prefix("services", _b(node) + SEP)
        n_chk = tx.delete_prefix("checks", _b(node) + SEP)
        n_coord = tx.delete_prefix("coordinates", _b(node) + SEP)
        self._bump(tx, idx, "nodes")
        if n_coord:
            self._bump(tx, idx, "coordinates")
        if n_svc:
            self._bump(tx, idx, "services")
        if n_chk:
            self._bump(tx, idx, "checks")
        for sess in tx.records("sessions", _b(node) + SEP, index="node"):
            self._destroy_session_txn(tx, idx, sess)
        tx.commit()
        return True

    @_writer
    def delete_service(self, idx: int, node: str, service_id: str) -> bool:
        tx = self.db.txn(write=True)
        old = tx.delete("services", _b(node) + SEP + _b(service_id))
        if old is None:
            tx.abort()
            return False
        # Drop the service's checks too (catalog.go deleteServiceTxn),
        # invalidating sessions bound to them like an explicit delete.
        dropped_checks = False
        for chk in tx.records("checks", _b(node) + SEP):
            if chk.get("service_id") == service_id:
                tx.delete("checks", _b(node) + SEP + _b(chk["check_id"]))
                self._invalidate_sessions_for_check(tx, idx, node, chk["check_id"])
                dropped_checks = True
        self._bump(tx, idx, "services")
        if dropped_checks:
            self._bump(tx, idx, "checks")
        tx.commit()
        return True

    @_writer
    def delete_check(self, idx: int, node: str, check_id: str) -> bool:
        tx = self.db.txn(write=True)
        old = tx.delete("checks", _b(node) + SEP + _b(check_id))
        if old is None:
            tx.abort()
            return False
        self._bump(tx, idx, "checks")
        self._invalidate_sessions_for_check(tx, idx, node, check_id)
        tx.commit()
        return True

    # -- catalog reads (each returns (index, data) and feeds the WatchSet)

    def nodes(self, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        recs = tx.records("nodes", ws=ws)
        return self.max_index("nodes", tx=tx), recs

    def node(self, name: str, ws: Optional[WatchSet] = None) -> tuple[int, Optional[dict]]:
        tx = self.db.txn()
        return self.max_index("nodes", tx=tx), tx.get("nodes", _b(name), ws=ws)

    def services(self, ws: Optional[WatchSet] = None) -> tuple[int, dict[str, list[str]]]:
        """Service name -> union of tags (``Catalog.ListServices``)."""
        tx = self.db.txn()
        out: dict[str, set] = {}
        for rec in tx.records("services", ws=ws):
            out.setdefault(rec["service"], set()).update(rec["tags"])
        return (
            self.max_index("services", tx=tx),
            {k: sorted(v) for k, v in out.items()},
        )

    def node_services(self, node: str, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        recs = tx.records("services", _b(node) + SEP, ws=ws)
        return self.max_index("services", tx=tx), recs

    @staticmethod
    def _join_node(tx, rec: dict, ws: Optional[WatchSet]) -> dict:
        """Merge a service record with its node's address/meta (the
        ServiceNode join, state/catalog.go parseServiceNodes)."""
        node = tx.get("nodes", _b(rec["node"]), ws=ws)
        merged = dict(rec)
        merged["node_address"] = node["address"] if node else ""
        merged["node_meta"] = (node.get("meta") or {}) if node else {}
        return merged

    def service_nodes(
        self, service: str, tag: Optional[str] = None, ws: Optional[WatchSet] = None
    ) -> tuple[int, list[dict]]:
        """Service instances joined with their node's address
        (``Catalog.ServiceNodes``)."""
        tx = self.db.txn()
        out = []
        for rec in tx.records("services", _b(service) + SEP, index="service", ws=ws):
            if tag is not None and tag not in rec["tags"]:
                continue
            out.append(self._join_node(tx, rec, ws))
        return self.max_index("services", "nodes", tx=tx), out

    def node_checks(self, node: str, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("checks", tx=tx),
            tx.records("checks", _b(node) + SEP, ws=ws),
        )

    def service_checks(self, service: str, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("checks", tx=tx),
            tx.records("checks", _b(service) + SEP, index="service", ws=ws),
        )

    def checks_in_state(self, status: str, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("checks", tx=tx),
            tx.records("checks", _b(status) + SEP, index="status", ws=ws),
        )

    def connect_service_nodes(
        self, service: str, ws: Optional[WatchSet] = None
    ) -> tuple[int, list[dict]]:
        """Instances that can serve Connect traffic FOR ``service``:
        its registered sidecar proxies (kind=connect-proxy whose
        proxy.destination_service matches) plus connect-native
        instances (state/catalog.go ConnectServiceNodes via the
        ConnectName index; a table scan here — proxy counts are
        node-bounded)."""
        tx = self.db.txn()
        out = []
        for rec in tx.records("services", b"", index="service", ws=ws):
            proxy = rec.get("proxy") or {}
            is_proxy_for = (
                rec.get("kind") == "connect-proxy"
                and proxy.get("destination_service") == service
            )
            native = rec.get("connect_native") and rec["service"] == service
            if not (is_proxy_for or native):
                continue
            node = tx.get("nodes", _b(rec["node"]), ws=ws)
            merged = dict(rec)
            merged["node_address"] = node["address"] if node else ""
            out.append(merged)
        return self.max_index("services", "nodes", tx=tx), out

    def check_service_nodes(
        self,
        service: str,
        tag: Optional[str] = None,
        passing_only: bool = False,
        connect: bool = False,
        ws: Optional[WatchSet] = None,
    ) -> tuple[int, list[dict]]:
        """Health endpoint's joined view: service instance + node +
        its checks (node-level + service-level)
        (``Health.ServiceNodes``, ``state/catalog.go`` CheckServiceNodes).
        ``connect=True`` swaps the instance source for the proxies /
        connect-native instances serving the named service."""
        tx = self.db.txn()
        if connect:
            idx, instances = self.connect_service_nodes(service, ws)
        else:
            idx, instances = self.service_nodes(service, tag, ws)
        out = []
        for inst in instances:
            checks = [
                c
                for c in tx.records("checks", _b(inst["node"]) + SEP, ws=ws)
                if c["service_id"] in ("", inst["id"])
            ]
            if passing_only and any(c["status"] != HEALTH_PASSING for c in checks):
                continue
            node = tx.get("nodes", _b(inst["node"]), ws=ws)
            out.append({"node": node, "service": inst, "checks": checks})
        return max(idx, self.max_index("checks", tx=tx)), out

    # ------------------------------------------------------------------
    # KV (state/kvs.go, graveyard state/graveyard.go)
    # ------------------------------------------------------------------

    @_writer
    def kv_set(self, idx: int, entry: dict) -> None:
        tx = self.db.txn(write=True)
        self._kv_set_txn(tx, idx, entry)
        tx.commit()

    def _kv_set_txn(self, tx: MemTxn, idx: int, entry: dict) -> None:
        existing = tx.get("kvs", _b(entry["key"]))
        rec = {
            "key": entry["key"],
            "value": entry.get("value", b""),
            "flags": int(entry.get("flags", 0)),
            "lock_index": existing["lock_index"] if existing else 0,
            "session": existing.get("session") if existing else None,
            "create_index": existing["create_index"] if existing else idx,
            "modify_index": idx,
        }
        tx.insert("kvs", rec)
        self._bump(tx, idx, "kvs")

    @_writer
    def kv_set_cas(self, idx: int, entry: dict, cas_index: int) -> bool:
        """Check-and-set: write only if modify_index matches (0 = only
        if absent) (``KVSSetCAS``)."""
        tx = self.db.txn(write=True)
        existing = tx.get("kvs", _b(entry["key"]))
        if cas_index == 0 and existing is not None:
            tx.abort()
            return False
        if cas_index != 0 and (existing is None or existing["modify_index"] != cas_index):
            tx.abort()
            return False
        self._kv_set_txn(tx, idx, entry)
        tx.commit()
        return True

    def kv_get(self, key: str, ws: Optional[WatchSet] = None) -> tuple[int, Optional[dict]]:
        tx = self.db.txn()
        rec = tx.get("kvs", _b(key), ws=ws)
        return self.max_index("kvs", "tombstones", tx=tx), rec

    def kv_list(self, prefix: str, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        recs = tx.records("kvs", _b(prefix), ws=ws)
        if ws is not None:
            ws.add(self.db.tree("tombstones").watch_prefix(_b(prefix)))
        idx = self.max_index("kvs", "tombstones", tx=tx)
        return idx, recs

    def kv_keys(
        self, prefix: str, separator: str = "", ws: Optional[WatchSet] = None
    ) -> tuple[int, list[str]]:
        """Key listing with optional separator roll-up (``KVSListKeys``)."""
        idx, recs = self.kv_list(prefix, ws)
        if not separator:
            return idx, [r["key"] for r in recs]
        out: list[str] = []
        for r in recs:
            key = r["key"]
            after = key[len(prefix):]
            sep_at = after.find(separator)
            if sep_at >= 0:
                rolled = prefix + after[: sep_at + len(separator)]
                if not out or out[-1] != rolled:
                    out.append(rolled)
            else:
                out.append(key)
        return idx, out

    def _kv_delete_txn(self, tx: MemTxn, idx: int, key: str) -> bool:
        """Delete one key, leaving a tombstone (kv_delete core)."""
        old = tx.delete("kvs", _b(key))
        if old is None:
            return False
        tx.insert("tombstones", {"key": key, "index": idx})
        self._bump(tx, idx, "kvs", "tombstones")
        return True

    def _kv_delete_tree_txn(self, tx: MemTxn, idx: int, prefix: str) -> int:
        doomed = tx.records("kvs", _b(prefix))
        for rec in doomed:
            tx.delete("kvs", _b(rec["key"]))
            tx.insert("tombstones", {"key": rec["key"], "index": idx})
        if doomed:
            self._bump(tx, idx, "kvs", "tombstones")
        return len(doomed)

    def _kv_lock_txn(self, tx: MemTxn, idx: int, entry: dict, session_id: str) -> bool:
        """Acquire core shared by kv_lock and the txn 'lock' verb."""
        if not session_id or tx.get("sessions", _b(session_id)) is None:
            return False
        existing = tx.get("kvs", _b(entry["key"]))
        if existing and existing.get("session"):
            if existing["session"] != session_id:
                return False
            # Re-acquire by the same session: update value, keep lock_index.
            lock_index = existing["lock_index"]
        else:
            lock_index = (existing["lock_index"] if existing else 0) + 1
        rec = {
            "key": entry["key"],
            "value": entry.get("value", b""),
            "flags": int(entry.get("flags", 0)),
            "lock_index": lock_index,
            "session": session_id,
            "create_index": existing["create_index"] if existing else idx,
            "modify_index": idx,
        }
        tx.insert("kvs", rec)
        self._bump(tx, idx, "kvs")
        return True

    def _kv_unlock_txn(self, tx: MemTxn, idx: int, entry: dict, session_id: str) -> bool:
        """Release core shared by kv_unlock and the txn 'unlock' verb:
        updates value/flags from the entry like the reference's KVSUnlock."""
        existing = tx.get("kvs", _b(entry["key"]))
        if existing is None or existing.get("session") != session_id:
            return False
        rec = dict(existing)
        rec.update(
            value=entry.get("value", b""),
            flags=int(entry.get("flags", 0)),
            session=None,
            modify_index=idx,
        )
        tx.insert("kvs", rec)
        self._bump(tx, idx, "kvs")
        return True

    @_writer
    def kv_delete(self, idx: int, key: str) -> bool:
        tx = self.db.txn(write=True)
        if not self._kv_delete_txn(tx, idx, key):
            tx.abort()
            return False
        tx.commit()
        return True

    @_writer
    def kv_delete_cas(self, idx: int, key: str, cas_index: int) -> bool:
        tx = self.db.txn(write=True)
        existing = tx.get("kvs", _b(key))
        if existing is None or existing["modify_index"] != cas_index:
            tx.abort()
            return False
        self._kv_delete_txn(tx, idx, key)
        tx.commit()
        return True

    @_writer
    def kv_delete_tree(self, idx: int, prefix: str) -> int:
        tx = self.db.txn(write=True)
        n = self._kv_delete_tree_txn(tx, idx, prefix)
        tx.commit()
        return n

    @_writer
    def kv_lock(self, idx: int, entry: dict, session_id: str) -> bool:
        """Acquire: sets session + bumps lock_index if unlocked
        (``KVSLock``, the Leader-Election primitive)."""
        tx = self.db.txn(write=True)
        if not self._kv_lock_txn(tx, idx, entry, session_id):
            tx.abort()
            return False
        tx.commit()
        return True

    @_writer
    def kv_unlock(self, idx: int, entry: dict, session_id: str) -> bool:
        tx = self.db.txn(write=True)
        if not self._kv_unlock_txn(tx, idx, entry, session_id):
            tx.abort()
            return False
        tx.commit()
        return True

    @_writer
    def tombstone_reap(self, idx: int, up_to: int) -> int:
        """Tombstone GC (``state/graveyard.go`` ReapTxn, driven by the
        leader's tombstone GC loop)."""
        tx = self.db.txn(write=True)
        doomed = [r for r in tx.records("tombstones") if r["index"] <= up_to]
        for r in doomed:
            tx.delete("tombstones", _b(r["key"]))
        tx.commit()
        return len(doomed)

    # ------------------------------------------------------------------
    # sessions (state/session.go)
    # ------------------------------------------------------------------

    @_writer
    def session_create(self, idx: int, sess: dict) -> None:
        tx = self.db.txn(write=True)
        if tx.get("nodes", _b(sess["node"])) is None:
            tx.abort()
            raise ValueError(f"Missing node registration for {sess['node']!r}")
        checks = list(sess.get("checks", [SERF_CHECK_ID]))
        for cid in checks:
            chk = tx.get("checks", _b(sess["node"]) + SEP + _b(cid))
            if chk is None:
                tx.abort()
                raise ValueError(f"Check {cid!r} not registered on node")
            if chk["status"] == HEALTH_CRITICAL:
                tx.abort()
                raise ValueError(f"Check {cid!r} is in critical state")
        rec = {
            "id": sess["id"],
            "name": sess.get("name", ""),
            "node": sess["node"],
            "behavior": sess.get("behavior") or SESSION_BEHAVIOR_RELEASE,
            "ttl": sess.get("ttl", ""),
            "lock_delay": sess.get("lock_delay", 15.0),
            "checks": checks,
            "create_index": idx,
            "modify_index": idx,
        }
        tx.insert("sessions", rec)
        self._bump(tx, idx, "sessions")
        tx.commit()

    def session_get(self, sid: str, ws: Optional[WatchSet] = None) -> tuple[int, Optional[dict]]:
        tx = self.db.txn()
        return self.max_index("sessions", tx=tx), tx.get("sessions", _b(sid), ws=ws)

    def session_list(self, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return self.max_index("sessions", tx=tx), tx.records("sessions", ws=ws)

    def node_sessions(self, node: str, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("sessions", tx=tx),
            tx.records("sessions", _b(node) + SEP, index="node", ws=ws),
        )

    @_writer
    def session_destroy(self, idx: int, sid: str) -> bool:
        tx = self.db.txn(write=True)
        sess = tx.get("sessions", _b(sid))
        if sess is None:
            tx.abort()
            return False
        self._destroy_session_txn(tx, idx, sess)
        tx.commit()
        return True

    def kv_lock_delay(self, key: str) -> float:
        """Seconds until the lock-delay on ``key`` expires, 0 if clear
        (``state/kvs.go:376`` KVSLockDelay).  Enforced pre-commit on the
        leader only — see kvs_endpoint.go:67-82 for why it must not be
        checked inside the FSM."""
        exp = self._lock_delays.get(key)
        if exp is None:
            return 0.0
        remaining = exp - time.monotonic()
        if remaining <= 0:
            del self._lock_delays[key]
            return 0.0
        return remaining

    def _destroy_session_txn(self, tx: MemTxn, idx: int, sess: dict) -> None:
        """Delete the session and apply its behavior to held locks
        (``state/session.go`` deleteSessionTxn)."""
        tx.delete("sessions", _b(sess["id"]))
        self._bump(tx, idx, "sessions")
        held = tx.records("kvs", _b(sess["id"]) + SEP, index="session")
        delay = float(sess.get("lock_delay") or 0.0)
        if delay > 0 and held:
            # Guard the leader-election primitive against stale holders
            # reacquiring immediately (session.go:348-368).
            now = time.monotonic()
            for rec in held:
                self._lock_delays[rec["key"]] = now + delay
        for rec in held:
            if sess["behavior"] == SESSION_BEHAVIOR_DELETE:
                tx.delete("kvs", _b(rec["key"]))
                tx.insert("tombstones", {"key": rec["key"], "index": idx})
                self._bump(tx, idx, "kvs", "tombstones")
            else:  # release
                new = dict(rec)
                new["session"] = None
                new["modify_index"] = idx
                tx.insert("kvs", new)
                self._bump(tx, idx, "kvs")

    def _invalidate_sessions_for_check(
        self, tx: MemTxn, idx: int, node: str, check_id: str
    ) -> None:
        for sess in tx.records("sessions", _b(node) + SEP, index="node"):
            if check_id in sess.get("checks", []):
                self._destroy_session_txn(tx, idx, sess)

    # ------------------------------------------------------------------
    # coordinates (state/coordinate.go)
    # ------------------------------------------------------------------

    @_writer
    def coordinate_batch_update(self, idx: int, updates: list[dict]) -> None:
        """Apply a CoordinateBatchUpdate raft entry
        (``fsm/commands_oss.go`` applyCoordinateBatchUpdate): updates for
        nodes not in the catalog are skipped, not failed."""
        tx = self.db.txn(write=True)
        wrote = False
        for upd in updates:
            if tx.get("nodes", _b(upd["node"])) is None:
                continue
            pk = _b(upd["node"]) + SEP + _b(upd.get("segment", ""))
            existing = tx.get("coordinates", pk)
            tx.insert(
                "coordinates",
                {
                    "node": upd["node"],
                    "segment": upd.get("segment", ""),
                    "coord": upd["coord"],
                    "create_index": existing["create_index"] if existing else idx,
                    "modify_index": idx,
                },
            )
            wrote = True
        if wrote:
            self._bump(tx, idx, "coordinates")
        tx.commit()

    def coordinates(self, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return self.max_index("coordinates", tx=tx), tx.records("coordinates", ws=ws)

    def coordinate(self, node: str, segment: str = "") -> Optional[dict]:
        rec = self.db.txn().get("coordinates", _b(node) + SEP + _b(segment))
        return rec["coord"] if rec else None

    # ------------------------------------------------------------------
    # config entries / prepared queries (state/config_entries.go, prepared_query.go)
    # ------------------------------------------------------------------

    @_writer
    def config_entry_set(self, idx: int, entry: dict) -> None:
        tx = self.db.txn(write=True)
        existing = tx.get("config_entries", _b(entry["kind"]) + SEP + _b(entry["name"]))
        rec = dict(entry)
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("config_entries", rec)
        self._bump(tx, idx, "config_entries")
        tx.commit()

    def config_entry_get(
        self, kind: str, name: str, ws: Optional[WatchSet] = None
    ) -> tuple[int, Optional[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("config_entries", tx=tx),
            tx.get("config_entries", _b(kind) + SEP + _b(name), ws=ws),
        )

    def config_entries_by_kind(
        self, kind: Optional[str], ws: Optional[WatchSet] = None
    ) -> tuple[int, list[dict]]:
        """Entries of one kind, or ALL entries when kind is None (the
        replication pull reads everything)."""
        tx = self.db.txn()
        prefix = (_b(kind) + SEP) if kind else b""
        return (
            self.max_index("config_entries", tx=tx),
            tx.records("config_entries", prefix, ws=ws),
        )

    @_writer
    def config_entry_delete(self, idx: int, kind: str, name: str) -> bool:
        tx = self.db.txn(write=True)
        if tx.delete("config_entries", _b(kind) + SEP + _b(name)) is None:
            tx.abort()
            return False
        self._bump(tx, idx, "config_entries")
        tx.commit()
        return True

    @_writer
    def prepared_query_set(self, idx: int, query: dict) -> None:
        tx = self.db.txn(write=True)
        existing = tx.get("prepared_queries", _b(query["id"]))
        rec = dict(query)
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("prepared_queries", rec)
        self._bump(tx, idx, "prepared_queries")
        tx.commit()

    def prepared_query_get(self, qid: str, ws: Optional[WatchSet] = None) -> tuple[int, Optional[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("prepared_queries", tx=tx),
            tx.get("prepared_queries", _b(qid), ws=ws),
        )

    def prepared_query_resolve(self, name_or_id: str) -> Optional[dict]:
        tx = self.db.txn()
        rec = tx.get("prepared_queries", _b(name_or_id))
        if rec:
            return rec
        for r in tx.records("prepared_queries"):
            if r.get("name") == name_or_id:
                return r
        return None

    def prepared_query_list(self, ws: Optional[WatchSet] = None) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("prepared_queries", tx=tx),
            tx.records("prepared_queries", ws=ws),
        )

    @_writer
    def prepared_query_delete(self, idx: int, qid: str) -> bool:
        tx = self.db.txn(write=True)
        if tx.delete("prepared_queries", _b(qid)) is None:
            tx.abort()
            return False
        self._bump(tx, idx, "prepared_queries")
        tx.commit()
        return True

    # ------------------------------------------------------------------
    # ACL tables (the engine is consul_tpu.acl's, not yet ported)
    # ------------------------------------------------------------------

    @_writer
    def acl_token_set(self, idx: int, token: dict) -> None:
        tx = self.db.txn(write=True)
        existing = tx.get("acl_tokens", _b(token["secret_id"]))
        rec = dict(token)
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("acl_tokens", rec)
        self._bump(tx, idx, "acl_tokens")
        tx.commit()

    def acl_token_get(self, secret: str) -> Optional[dict]:
        return self.db.txn().get("acl_tokens", _b(secret))

    def acl_token_list(self) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return self.max_index("acl_tokens", tx=tx), tx.records("acl_tokens")

    @_writer
    def acl_token_delete(self, idx: int, secret: str) -> bool:
        tx = self.db.txn(write=True)
        if tx.delete("acl_tokens", _b(secret)) is None:
            tx.abort()
            return False
        self._bump(tx, idx, "acl_tokens")
        tx.commit()
        return True

    @_writer
    def acl_policy_set(self, idx: int, policy: dict) -> None:
        tx = self.db.txn(write=True)
        existing = tx.get("acl_policies", _b(policy["id"]))
        rec = dict(policy)
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("acl_policies", rec)
        self._bump(tx, idx, "acl_policies")
        tx.commit()

    def acl_policy_get(self, pid: str) -> Optional[dict]:
        return self.db.txn().get("acl_policies", _b(pid))

    def acl_policy_list(self) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return self.max_index("acl_policies", tx=tx), tx.records("acl_policies")

    @_writer
    def acl_policy_delete(self, idx: int, pid: str) -> bool:
        tx = self.db.txn(write=True)
        if tx.delete("acl_policies", _b(pid)) is None:
            tx.abort()
            return False
        self._bump(tx, idx, "acl_policies")
        tx.commit()
        return True

    # -- ACL roles / auth methods / binding rules (state/acl.go) ------------

    @_writer
    def acl_role_set(self, idx: int, role: dict) -> None:
        tx = self.db.txn(write=True)
        existing = tx.get("acl_roles", _b(role["id"]))
        rec = dict(role)
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("acl_roles", rec)
        self._bump(tx, idx, "acl_roles")
        tx.commit()

    def acl_role_get(self, rid: str) -> Optional[dict]:
        return self.db.txn().get("acl_roles", _b(rid))

    def acl_role_get_by_name(self, name: str) -> Optional[dict]:
        return self.db.txn().first(
            "acl_roles", _b(name) + SEP, index="name"
        )

    def acl_role_list(self) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return self.max_index("acl_roles", tx=tx), tx.records("acl_roles")

    @_writer
    def acl_role_delete(self, idx: int, rid: str) -> bool:
        tx = self.db.txn(write=True)
        if tx.delete("acl_roles", _b(rid)) is None:
            tx.abort()
            return False
        self._bump(tx, idx, "acl_roles")
        tx.commit()
        return True

    @_writer
    def acl_auth_method_set(self, idx: int, method: dict) -> None:
        tx = self.db.txn(write=True)
        existing = tx.get("acl_auth_methods", _b(method["name"]))
        rec = dict(method)
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("acl_auth_methods", rec)
        self._bump(tx, idx, "acl_auth_methods")
        tx.commit()

    def acl_auth_method_get(self, name: str) -> Optional[dict]:
        return self.db.txn().get("acl_auth_methods", _b(name))

    def acl_auth_method_list(self) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("acl_auth_methods", tx=tx),
            tx.records("acl_auth_methods"),
        )

    @_writer
    def acl_auth_method_delete(self, idx: int, name: str) -> bool:
        """Deleting an auth method cascades to its binding rules and to
        every token it minted (state/acl.go ACLAuthMethodDeleteTxn →
        aclBindingRuleDeleteAllForAuthMethodTxn +
        aclTokenDeleteAllForAuthMethodTxn)."""
        tx = self.db.txn(write=True)
        if tx.delete("acl_auth_methods", _b(name)) is None:
            tx.abort()
            return False
        for rec in tx.records(
            "acl_binding_rules", _b(name) + SEP, index="auth_method"
        ):
            tx.delete("acl_binding_rules", _b(rec["id"]))
        for rec in tx.records(
            "acl_tokens", _b(name) + SEP, index="auth_method"
        ):
            tx.delete("acl_tokens", _b(rec["secret_id"]))
        self._bump(tx, idx, "acl_auth_methods")
        self._bump(tx, idx, "acl_binding_rules")
        self._bump(tx, idx, "acl_tokens")
        tx.commit()
        return True

    @_writer
    def acl_binding_rule_set(self, idx: int, rule: dict) -> None:
        tx = self.db.txn(write=True)
        existing = tx.get("acl_binding_rules", _b(rule["id"]))
        rec = dict(rule)
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("acl_binding_rules", rec)
        self._bump(tx, idx, "acl_binding_rules")
        tx.commit()

    def acl_binding_rule_get(self, rid: str) -> Optional[dict]:
        return self.db.txn().get("acl_binding_rules", _b(rid))

    def acl_binding_rule_list(
        self, auth_method: str = ""
    ) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        if auth_method:
            rules = tx.records(
                "acl_binding_rules",
                _b(auth_method) + SEP,
                index="auth_method",
            )
        else:
            rules = tx.records("acl_binding_rules")
        return self.max_index("acl_binding_rules", tx=tx), rules

    @_writer
    def acl_binding_rule_delete(self, idx: int, rid: str) -> bool:
        tx = self.db.txn(write=True)
        if tx.delete("acl_binding_rules", _b(rid)) is None:
            tx.abort()
            return False
        self._bump(tx, idx, "acl_binding_rules")
        tx.commit()
        return True

    # -- federation states (state/federation_state.go) ----------------------

    @_writer
    def federation_state_set(self, idx: int, state: dict) -> None:
        tx = self.db.txn(write=True)
        existing = tx.get("federation_states", _b(state["datacenter"]))
        rec = dict(state)
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("federation_states", rec)
        self._bump(tx, idx, "federation_states")
        tx.commit()

    def federation_state_get(
        self, dc: str, ws: Optional[WatchSet] = None
    ) -> tuple[int, Optional[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("federation_states", tx=tx),
            tx.get("federation_states", _b(dc), ws=ws),
        )

    def federation_state_list(
        self, ws: Optional[WatchSet] = None
    ) -> tuple[int, list[dict]]:
        tx = self.db.txn()
        return (
            self.max_index("federation_states", tx=tx),
            tx.records("federation_states", ws=ws),
        )

    @_writer
    def federation_state_delete(self, idx: int, dc: str) -> bool:
        tx = self.db.txn(write=True)
        if tx.delete("federation_states", _b(dc)) is None:
            tx.abort()
            return False
        self._bump(tx, idx, "federation_states")
        tx.commit()
        return True

    def service_dump(
        self, ws: Optional[WatchSet] = None
    ) -> tuple[int, list[dict]]:
        """Every service instance joined with its node
        (state/catalog.go ServiceDump) — the PTR index and other
        whole-catalog consumers."""
        tx = self.db.txn()
        out = [
            self._join_node(tx, rec, ws)
            for rec in tx.records("services", ws=ws)
        ]
        return self.max_index("services", "nodes", tx=tx), out

    def services_by_kind(
        self, kind: str, passing_only: bool = False,
        ws: Optional[WatchSet] = None,
    ) -> tuple[int, list[dict]]:
        """Service instances of a given kind (mesh-gateway, ...), joined
        with node addresses like service_nodes (state/catalog.go
        ServiceDump w/ kind filter — health-aware like
        CheckServiceNodes: ``passing_only`` drops instances with any
        non-passing node- or service-level check)."""
        tx = self.db.txn()
        out = []
        for rec in tx.records("services", ws=ws):
            if rec.get("kind") != kind:
                continue
            if passing_only:
                checks = [
                    c
                    for c in tx.records(
                        "checks", _b(rec["node"]) + SEP, ws=ws)
                    if c["service_id"] in ("", rec["id"])
                ]
                if any(c["status"] != HEALTH_PASSING for c in checks):
                    continue
            out.append(self._join_node(tx, rec, ws))
        idx = self.max_index("services", "nodes", tx=tx)
        if passing_only:
            idx = max(idx, self.max_index("checks", tx=tx))
        return idx, out

    def acl_tokens_expired(self, now: float, limit: int = 256) -> list[dict]:
        """Tokens whose expiration_time has passed (acl_token_exp.go
        ListExpiredLocalTokens equivalent, capped per sweep)."""
        out = []
        for rec in self.db.txn().records("acl_tokens"):
            exp = rec.get("expiration_time")
            if exp and now >= float(exp):
                out.append(rec)
                if len(out) >= limit:
                    break
        return out

    # -- connect: intentions + CA roots (state/intention.go) ----------------

    @_writer
    def intention_set(self, idx: int, intention: dict) -> None:
        tx = self.db.txn(write=True)
        existing = tx.get("intentions", _b(intention["id"]))
        rec = dict(intention)
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("intentions", rec)
        self._bump(tx, idx, "intentions")
        tx.commit()

    def intention_get(self, iid: str, ws=None):
        tx = self.db.txn()
        return self.max_index("intentions", tx=tx), tx.get(
            "intentions", _b(iid), ws=ws
        )

    def intention_list(self, ws=None):
        tx = self.db.txn()
        return self.max_index("intentions", tx=tx), tx.records(
            "intentions", ws=ws
        )

    @_writer
    def intention_delete(self, idx: int, iid: str) -> bool:
        tx = self.db.txn(write=True)
        if tx.get("intentions", _b(iid)) is None:
            tx.abort()
            return False
        tx.delete("intentions", _b(iid))
        self._bump(tx, idx, "intentions")
        tx.commit()
        return True

    def intention_match(self, destination: str, ws=None):
        """Intentions whose destination matches the service exactly or
        by wildcard, most precedent first (state/intention.go
        IntentionMatch: exact > wildcard)."""
        tx = self.db.txn()
        idx = self.max_index("intentions", tx=tx)
        out = [
            r for r in tx.records("intentions", ws=ws)
            if r["destination"] in (destination, "*")
        ]
        out.sort(key=lambda r: (r["destination"] == "*",
                                r.get("source", "*") == "*"))
        return idx, out

    @_writer
    def ca_root_set(self, idx: int, root: dict) -> None:
        tx = self.db.txn(write=True)
        if root.get("active"):
            # Only one active root at a time (connect_ca.go).
            for r in tx.records("connect_ca_roots"):
                if r.get("active") and r["id"] != root["id"]:
                    r = dict(r)
                    r["active"] = False
                    tx.insert("connect_ca_roots", r)
        rec = dict(root)
        existing = tx.get("connect_ca_roots", _b(root["id"]))
        rec["create_index"] = existing["create_index"] if existing else idx
        rec["modify_index"] = idx
        tx.insert("connect_ca_roots", rec)
        self._bump(tx, idx, "connect_ca_roots")
        tx.commit()

    def ca_roots(self, ws=None):
        tx = self.db.txn()
        return self.max_index("connect_ca_roots", tx=tx), tx.records(
            "connect_ca_roots", ws=ws
        )

    # ------------------------------------------------------------------
    # transactions (state/txn.go TxnRW / TxnRO)
    # ------------------------------------------------------------------

    @_writer
    def txn_apply(self, idx: int, ops: list[dict]) -> tuple[list[dict], list[dict]]:
        """Apply a list of operations atomically in ONE write txn
        (``state/txn.go`` TxnRW → txnDispatch): all-or-nothing; on any
        error the whole txn aborts and the per-op errors are returned.

        Each op: ``{"kv": {"verb": ..., "entry": {...}}}`` using the KV
        verbs of ``api/txn.go`` (set, cas, lock, unlock, get, get-tree,
        check-index, check-session, check-not-exists, delete,
        delete-tree, delete-cas).
        """
        tx = self.db.txn(write=True)
        results: list[dict] = []
        errors: list[dict] = []
        for i, op in enumerate(ops):
            kv = op.get("kv") if isinstance(op, dict) else None
            if kv is None:
                errors.append({"op_index": i, "what": "unknown operation type"})
                continue
            try:
                err = self._txn_kv_op(tx, idx, kv, results)
            except (KeyError, TypeError) as e:
                err = f"malformed operation: {e!r}"
            if err is not None:
                errors.append({"op_index": i, "what": err})
        if errors:
            tx.abort()
            return [], errors
        tx.commit()
        return results, []

    def txn_read(self, ops: list[dict]) -> tuple[list[dict], list[dict]]:
        """Read-only transaction against the committed snapshot
        (``state/txn.go`` TxnRO: only get/get-tree/check-* verbs)."""
        tx = self.db.txn()
        results: list[dict] = []
        errors: list[dict] = []
        ro_verbs = {"get", "get-tree", "check-index", "check-session", "check-not-exists"}
        for i, op in enumerate(ops):
            kv = op.get("kv") if isinstance(op, dict) else None
            if kv is None or kv.get("verb") not in ro_verbs:
                errors.append({"op_index": i, "what": "not a read-only operation"})
                continue
            try:
                err = self._txn_kv_op(tx, 0, kv, results)
            except (KeyError, TypeError) as e:
                err = f"malformed operation: {e!r}"
            if err is not None:
                errors.append({"op_index": i, "what": err})
        return (results, errors) if not errors else ([], errors)

    def _txn_kv_op(
        self, tx: MemTxn, idx: int, kv: dict, results: list[dict]
    ) -> Optional[str]:
        """One KV verb inside a txn; appends to results, returns error
        string or None (``state/txn.go`` txnKVS)."""
        verb = kv["verb"]
        entry = kv.get("entry") or {}
        key = entry.get("key", "")
        existing = tx.get("kvs", _b(key)) if key else None

        if verb == "set":
            self._kv_set_txn(tx, idx, entry)
            results.append({"kv": tx.get("kvs", _b(key))})
        elif verb == "cas":
            cas = int(entry.get("modify_index", 0))
            if cas == 0 and existing is not None:
                return f"key {key!r} exists (cas index 0)"
            if cas != 0 and (existing is None or existing["modify_index"] != cas):
                return f"cas failed for key {key!r}"
            self._kv_set_txn(tx, idx, entry)
            results.append({"kv": tx.get("kvs", _b(key))})
        elif verb == "lock":
            sid = entry.get("session") or ""
            if not self._kv_lock_txn(tx, idx, entry, sid):
                return f"failed to lock key {key!r} with session {sid!r}"
            results.append({"kv": tx.get("kvs", _b(key))})
        elif verb == "unlock":
            sid = entry.get("session") or ""
            if not self._kv_unlock_txn(tx, idx, entry, sid):
                return f"key {key!r} not locked by session {sid!r}"
            results.append({"kv": tx.get("kvs", _b(key))})
        elif verb == "get":
            if existing is None:
                return f"key {key!r} doesn't exist"
            results.append({"kv": existing})
        elif verb == "get-tree":
            for rec in tx.records("kvs", _b(key)):
                results.append({"kv": rec})
        elif verb == "check-index":
            want = int(entry.get("modify_index", 0))
            if existing is None:
                return f"key {key!r} doesn't exist"
            if existing["modify_index"] != want:
                return (
                    f"current modify index ({existing['modify_index']}) "
                    f"!= {want} for key {key!r}"
                )
        elif verb == "check-session":
            sid = entry.get("session")
            if existing is None:
                return f"key {key!r} doesn't exist"
            if existing.get("session") != sid:
                return f"key {key!r} not held by session {sid!r}"
        elif verb == "check-not-exists":
            if existing is not None:
                return f"key {key!r} exists"
        elif verb == "delete":
            self._kv_delete_txn(tx, idx, key)
        elif verb == "delete-tree":
            self._kv_delete_tree_txn(tx, idx, key)
        elif verb == "delete-cas":
            cas = int(entry.get("modify_index", 0))
            if existing is None or existing["modify_index"] != cas:
                return f"cas delete failed for key {key!r}"
            self._kv_delete_txn(tx, idx, key)
        else:
            return f"unknown KV verb {verb!r}"
        return None

    # ------------------------------------------------------------------
    # snapshot / restore (fsm/snapshot_oss.go style table dump)
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        tx = self.db.txn()
        return {
            "tables": {t: tx.records(t) for t in DUMP_TABLES},
            "indexes": tx.records("index"),
        }

    def restore(self, snap: dict) -> None:
        self.db = MemDB(_schemas())
        tx = self.db.txn(write=True)
        for table, recs in snap["tables"].items():
            for rec in recs:
                tx.insert(table, rec)
        for rec in snap.get("indexes", []):
            tx.insert("index", rec)
        tx.commit()
        self.abandon()
