"""Server RPC endpoint services; the port's copy of
``consul_tpu/agent/endpoints.py``.

Equivalent of the reference's ``agent/consul/*_endpoint.go`` files,
registered like ``server_oss.go:8-23``.  Every method takes the msgpack
request body and returns a msgpack-friendly dict; reads run through
``blocking_query`` and return ``{"meta": QueryMeta, ...}``; writes
forward to the leader and apply through raft.

Wire method names match the reference (``KVS.Apply``,
``Health.ServiceNodes``, ``Catalog.NodeServices`` ...) so a client of
the reference finds the same RPC surface.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import TYPE_CHECKING, Any, Callable, Optional

from consul_tpu_torch.acl.engine import READ, WRITE
from consul_tpu_torch.agent.fsm import MessageType
from consul_tpu_torch.agent.rpc import (
    ERR_PERMISSION_DENIED,
    QueryOptions,
    RPCError,
    blocking_query,
)
from consul_tpu_torch.store.state import HEALTH_CRITICAL, HEALTH_PASSING

if TYPE_CHECKING:
    from consul_tpu_torch.agent.server import Server


class _Endpoint:
    def __init__(self, server: "Server"):
        self.server = server

    def _authz(self, body: dict):
        """Authorizer for read-side filterACL, or None when enforcement
        is off (ACLs disabled, or the request targets another DC whose
        own servers enforce)."""
        srv = self.server
        if not srv.acl.enabled:
            return None
        dc = body.get("dc")
        if dc and dc != srv.config.datacenter:
            return None
        return srv.acl_resolve(body)

    async def _read(self, method: str, body: dict, run: Callable):
        """Common read path: forward unless stale, optional consistency
        barrier, then blocking query (rpc.go blockingQuery users)."""
        fwd = await self.server.forward(method, body, read=True)
        if fwd is not None:
            return fwd
        opts = QueryOptions.from_body(body)
        if opts.require_consistent:
            await self.server.consistent_barrier()
        meta, result = await blocking_query(self.server.store, opts, run)
        out = {"meta": meta.to_body()}
        out.update(result if isinstance(result, dict) else {})
        return out

    async def _write(self, method: str, msg_type: MessageType, body: dict):
        fwd = await self.server.forward(method, body)
        if fwd is not None:
            return fwd
        result = await self.server.raft_apply(msg_type, body)
        return {"result": result, "index": self.server.store.max_index(
            *_TABLES_BY_TYPE.get(msg_type, ("index",)))}


_TABLES_BY_TYPE = {
    MessageType.REGISTER: ("nodes", "services", "checks"),
    MessageType.DEREGISTER: ("nodes", "services", "checks"),
    MessageType.KVS: ("kvs", "tombstones"),
    MessageType.SESSION: ("sessions",),
    MessageType.TXN: ("kvs", "tombstones"),
    MessageType.PREPARED_QUERY: ("prepared_queries",),
    MessageType.CONFIG_ENTRY: ("config_entries",),
}


class Status(_Endpoint):
    """status_endpoint.go — cluster metadata, never forwarded."""

    async def ping(self, body: dict) -> bool:
        return True

    async def leader(self, body: dict) -> dict:
        return {"leader": self.server.leader_rpc_addr() or ""}

    async def peers(self, body: dict) -> dict:
        raft = self.server.raft
        peers = []
        if raft is not None:
            for vid in raft.voters:
                addr = self.server._raft_peer_addr(vid)
                peers.append({"id": vid, "addr": addr or ""})
        return {"peers": peers}


class Catalog(_Endpoint):
    """catalog_endpoint.go."""

    async def register(self, body: dict):
        # catalog_endpoint.go Register: node write + service write when
        # a service is included (vetRegisterWithACL).
        self.server.acl_check(body, "node", body.get("node", ""), WRITE)
        svc = body.get("service")
        if svc:
            self.server.acl_check(
                body, "service", svc.get("service", ""), WRITE
            )
        return await self._write("Catalog.Register", MessageType.REGISTER, body)

    async def deregister(self, body: dict):
        self.server.acl_check(body, "node", body.get("node", ""), WRITE)
        return await self._write("Catalog.Deregister", MessageType.DEREGISTER, body)

    async def list_nodes(self, body: dict):
        out = await self._read(
            "Catalog.ListNodes", body,
            lambda ws: _wrap(self.server.store.nodes(ws), "nodes"),
        )
        authz = self._authz(body)
        if authz is not None and "nodes" in out:
            out["nodes"] = [
                n for n in out["nodes"] if authz.node_read(n.get("name", ""))
            ]
        return out

    async def service_dump(self, body: dict):
        """All service instances + node join (internal ServiceDump —
        the DNS PTR index and debug consumers)."""
        out = await self._read(
            "Catalog.ServiceDump", body,
            lambda ws: _wrap(
                self.server.store.service_dump(ws=ws), "services"),
        )
        authz = self._authz(body)
        if authz is not None and "services" in out:
            out["services"] = [
                s for s in out["services"]
                if authz.service_read(s.get("service", ""))
            ]
        return out

    async def service_kind_nodes(self, body: dict):
        """Instances of a service KIND — mesh-gateway discovery for the
        data plane (catalog_endpoint.go ServiceNodes with ServiceKind /
        internal ServiceDump kind filter)."""
        out = await self._read(
            "Catalog.ServiceKindNodes", body,
            lambda ws: _wrap(
                self.server.store.services_by_kind(
                    body.get("kind", ""),
                    passing_only=bool(body.get("passing_only", False)),
                    ws=ws),
                "nodes",
            ),
        )
        authz = self._authz(body)
        if authz is not None and "nodes" in out:
            out["nodes"] = [
                n for n in out["nodes"]
                if authz.service_read(n.get("service", ""))
            ]
        return out

    async def list_services(self, body: dict):
        out = await self._read(
            "Catalog.ListServices", body,
            lambda ws: _wrap(self.server.store.services(ws), "services"),
        )
        authz = self._authz(body)
        if authz is not None and "services" in out:
            out["services"] = {
                name: tags
                for name, tags in out["services"].items()
                if authz.service_read(name)
            }
        return out

    async def service_nodes(self, body: dict):
        self.server.acl_check(body, "service", body.get("service", ""), READ)
        tag = body.get("tag")
        return await self._read(
            "Catalog.ServiceNodes", body,
            lambda ws: _wrap(
                self.server.store.service_nodes(body["service"], tag=tag, ws=ws),
                "nodes",
            ),
        )

    async def node_services(self, body: dict):
        self.server.acl_check(body, "node", body.get("node", ""), READ)
        out = await self._read(
            "Catalog.NodeServices", body,
            lambda ws: _wrap(
                self.server.store.node_services(body["node"], ws=ws), "services"
            ),
        )
        authz = self._authz(body)
        if authz is not None and "services" in out:
            out["services"] = [
                s for s in out["services"]
                if authz.service_read(s.get("service", ""))
            ]
        return out

    async def list_datacenters(self, body: dict):
        """catalog_endpoint.go ListDatacenters: known DCs sorted by
        estimated round-trip from here (router.go:534)."""
        return {"datacenters": self.server.router.get_datacenters_by_distance()}


class Health(_Endpoint):
    """health_endpoint.go."""

    async def node_checks(self, body: dict):
        self.server.acl_check(body, "node", body.get("node", ""), READ)
        return await self._read(
            "Health.NodeChecks", body,
            lambda ws: _wrap(self.server.store.node_checks(body["node"], ws=ws),
                             "checks"),
        )

    async def service_checks(self, body: dict):
        self.server.acl_check(body, "service", body.get("service", ""), READ)
        return await self._read(
            "Health.ServiceChecks", body,
            lambda ws: _wrap(
                self.server.store.service_checks(body["service"], ws=ws), "checks"
            ),
        )

    async def checks_in_state(self, body: dict):
        return await self._read(
            "Health.ChecksInState", body,
            lambda ws: _wrap(
                self.server.store.checks_in_state(body["state"], ws=ws), "checks"
            ),
        )

    async def service_nodes(self, body: dict):
        """Nodes + service + checks, optionally only passing instances
        (health_endpoint.go ServiceNodes w/ PassingOnly)."""
        self.server.acl_check(body, "service", body.get("service", ""), READ)
        passing = bool(body.get("passing_only", body.get("passing", False)))
        return await self._read(
            "Health.ServiceNodes", body,
            lambda ws: _wrap(
                self.server.store.check_service_nodes(
                    body["service"], tag=body.get("tag"),
                    passing_only=passing,
                    connect=bool(body.get("connect")), ws=ws,
                ),
                "nodes",
            ),
        )


class KVS(_Endpoint):
    """kvs_endpoint.go."""

    async def apply(self, body: dict):
        # kvs_endpoint.go:35-60 kvsPreApply: key write (+ the reference
        # also checks session perms for lock ops via the session's node).
        # delete-tree needs write over the ENTIRE subtree
        # (acl.KeyWritePrefix) — a plain longest-prefix check on the
        # prefix would let a parent-level token wipe a denied child.
        key = (body.get("entry") or {}).get("key", "")
        if body.get("op") == "delete-tree":
            self.server.acl_check(body, "key", key, WRITE,
                                  whole_subtree=True)
        else:
            self.server.acl_check(body, "key", key, WRITE)
        fwd = await self.server.forward("KVS.Apply", body)
        if fwd is not None:
            return fwd
        if body.get("op") == "lock":
            # Lock-delay is wall-time, so it is enforced pre-commit with
            # the leader's clock only — doing it in the FSM would let
            # peers diverge (kvs_endpoint.go:67-82 kvsPreApply).
            key = (body.get("entry") or {}).get("key", "")
            if self.server.store.kv_lock_delay(key) > 0:
                return {
                    "result": False,
                    "index": self.server.store.max_index("kvs", "tombstones"),
                }
        result = await self.server.raft_apply(MessageType.KVS, body)
        return {
            "result": result,
            "index": self.server.store.max_index("kvs", "tombstones"),
        }

    async def get(self, body: dict):
        self.server.acl_check(body, "key", body["key"], READ)

        def run(ws):
            idx, rec = self.server.store.kv_get(body["key"], ws=ws)
            return idx, {"entries": [rec] if rec else []}

        return await self._read("KVS.Get", body, run)

    async def list(self, body: dict):
        out = await self._read(
            "KVS.List", body,
            lambda ws: _wrap(self.server.store.kv_list(body["key"], ws=ws),
                             "entries"),
        )
        return self._filter_keys(body, out, "entries", lambda e: e["key"])

    async def list_keys(self, body: dict):
        out = await self._read(
            "KVS.ListKeys", body,
            lambda ws: _wrap(
                self.server.store.kv_keys(
                    body["key"], body.get("separator", ""), ws=ws
                ),
                "keys",
            ),
        )
        return self._filter_keys(body, out, "keys", lambda k: k)

    def _filter_keys(self, body: dict, out: dict, field: str, key_of):
        """filterACL on list results: entries the token cannot read are
        dropped, not denied (consul/filter.go FilterKeys)."""
        authz = self._authz(body)
        if authz is not None and field in out:
            out[field] = [
                item for item in out[field] if authz.key_read(key_of(item))
            ]
        return out


class Session(_Endpoint):
    """session_endpoint.go."""

    async def apply(self, body: dict):
        op = body.get("op")
        # session_endpoint.go Apply: session write on the session's node.
        node = (body.get("session") or {}).get("node", "")
        if op == "destroy" and not node:
            _, existing = self.server.store.session_get(
                (body.get("session") or {}).get("id", "")
            )
            node = (existing or {}).get("node", "")
        self.server.acl_check(body, "session", node, WRITE)
        if op == "create":
            sess = dict(body.get("session") or {})
            sess.setdefault("id", str(uuid.uuid4()))
            body = {"op": "create", "session": sess}
        out = await self._write("Session.Apply", MessageType.SESSION, body)
        return out

    async def get(self, body: dict):
        def run(ws):
            idx, rec = self.server.store.session_get(body["id"], ws=ws)
            return idx, {"sessions": [rec] if rec else []}

        out = await self._read("Session.Get", body, run)
        return self._filter_sessions(body, out)

    async def list(self, body: dict):
        out = await self._read(
            "Session.List", body,
            lambda ws: _wrap(self.server.store.session_list(ws=ws), "sessions"),
        )
        return self._filter_sessions(body, out)

    async def node_sessions(self, body: dict):
        out = await self._read(
            "Session.NodeSessions", body,
            lambda ws: _wrap(
                self.server.store.node_sessions(body["node"], ws=ws), "sessions"
            ),
        )
        return self._filter_sessions(body, out)

    def _filter_sessions(self, body: dict, out: dict) -> dict:
        """filterACL session:read per session's node (consul/filter.go
        FilterSessions): unreadable sessions drop out of lists."""
        authz = self._authz(body)
        if authz is not None and "sessions" in out:
            out["sessions"] = [
                s for s in out["sessions"]
                if authz.session_read(s.get("node", ""))
            ]
        return out

    async def renew(self, body: dict):
        fwd = await self.server.forward("Session.Renew", body)
        if fwd is not None:
            return fwd
        idx, sess = self.server.store.session_get(body["id"])
        if sess is None:
            return {"sessions": [], "meta": {"index": idx}}
        # session_endpoint.go Renew: session write on the session's node
        # (an unauthorized party must not keep locks alive).
        self.server.acl_check(body, "session", sess.get("node", ""), WRITE)
        from consul_tpu_torch.agent.server import _parse_ttl

        ttl = _parse_ttl(sess.get("ttl"))
        if ttl > 0:
            self.server.renew_session(sess["id"], ttl)
        return {"sessions": [sess], "meta": {"index": idx}}


class Coordinate(_Endpoint):
    """coordinate_endpoint.go — updates are batched on the leader and
    flushed as one raft entry per CoordinateUpdatePeriod."""

    async def update(self, body: dict):
        # coordinate_endpoint.go Update: node write on the subject node.
        self.server.acl_check(body, "node", body.get("node", ""), WRITE)
        fwd = await self.server.forward("Coordinate.Update", body)
        if fwd is not None:
            return fwd
        self.server.stage_coordinate_update(
            body["node"], body.get("segment", ""), body["coord"]
        )
        return {"queued": True}

    async def list_nodes(self, body: dict):
        return await self._read(
            "Coordinate.ListNodes", body,
            lambda ws: _wrap(self.server.store.coordinates(ws=ws), "coordinates"),
        )

    async def node(self, body: dict):
        def run(ws):
            idx, _ = self.server.store.coordinates(ws=ws)
            coord = self.server.store.coordinate(
                body["node"], body.get("segment", "")
            )
            return idx, {"coord": coord}

        return await self._read("Coordinate.Node", body, run)


class Txn(_Endpoint):
    """txn_endpoint.go — read-only op sets skip raft (Txn.Read)."""

    def _check_txn_acls(self, body: dict, write: bool) -> None:
        """txn_endpoint.go Apply/Read vet each op's key against the
        token (the single-op KV enforcement must not be bypassable
        through /v1/txn)."""
        for op in body.get("ops") or []:
            kv = op.get("kv") if isinstance(op, dict) else None
            if not kv:
                continue
            key = (kv.get("entry") or {}).get("key", "")
            verb = kv.get("verb", "")
            want = READ if (not write or verb in ("get", "get-tree",
                                                  "check-index",
                                                  "check-session")) else WRITE
            self.server.acl_check(body, "key", key, want,
                                  whole_subtree=(verb == "delete-tree"))

    async def apply(self, body: dict):
        self._check_txn_acls(body, write=True)
        fwd = await self.server.forward("Txn.Apply", body)
        if fwd is not None:
            return fwd
        # Per-op pre-apply checks run with the leader's clock, exactly
        # like the single-op path (txn_endpoint.go Apply → kvsPreApply):
        # a "lock" verb inside a txn must honor lock-delay windows too.
        errors = []
        for i, op in enumerate(body.get("ops") or []):
            kv = op.get("kv") if isinstance(op, dict) else None
            if kv and kv.get("verb") == "lock":
                key = (kv.get("entry") or {}).get("key", "")
                if self.server.store.kv_lock_delay(key) > 0:
                    errors.append(
                        {"op_index": i,
                         "what": f"key {key!r} is under a lock-delay"}
                    )
        if errors:
            return {
                "result": {"results": [], "errors": errors},
                "index": self.server.store.max_index("kvs", "tombstones"),
            }
        result = await self.server.raft_apply(MessageType.TXN, body)
        return {
            "result": result,
            "index": self.server.store.max_index("kvs", "tombstones"),
        }

    async def read(self, body: dict):
        self._check_txn_acls(body, write=False)
        fwd = await self.server.forward("Txn.Read", body, read=True)
        if fwd is not None:
            return fwd
        results, errors = self.server.store.txn_read(body["ops"])
        return {"results": results, "errors": errors}


class ConfigEntry(_Endpoint):
    """config_endpoint.go."""

    async def apply(self, body: dict):
        # config_endpoint.go Apply checks per-kind service/operator
        # perms; collapsed here to operator write.
        self.server.acl_check(body, "operator", "", WRITE)
        return await self._write("ConfigEntry.Apply", MessageType.CONFIG_ENTRY, body)

    async def get(self, body: dict):
        def run(ws):
            idx, rec = self.server.store.config_entry_get(
                body["kind"], body["name"], ws=ws
            )
            return idx, {"entry": rec}

        return await self._read("ConfigEntry.Get", body, run)

    async def list(self, body: dict):
        return await self._read(
            "ConfigEntry.List", body,
            lambda ws: _wrap(
                self.server.store.config_entries_by_kind(body.get("kind"), ws=ws),
                "entries",
            ),
        )


class PreparedQuery(_Endpoint):
    """prepared_query_endpoint.go — execute resolves the query into a
    health-filtered node list (RTT ordering lands with the coordinate
    work in consul_tpu_torch.models.vivaldi)."""

    async def apply(self, body: dict):
        op = body.get("op")
        # prepared_query_endpoint.go Apply: query write on the name.
        self.server.acl_check(
            body, "query", (body.get("query") or {}).get("name", ""), WRITE
        )
        if op in ("create", "update"):
            q = dict(body.get("query") or {})
            q.setdefault("id", str(uuid.uuid4()))
            body = {"op": op, "query": q}
        return await self._write(
            "PreparedQuery.Apply", MessageType.PREPARED_QUERY, body
        )

    async def get(self, body: dict):
        def run(ws):
            idx, rec = self.server.store.prepared_query_get(body["id"], ws=ws)
            return idx, {"queries": [rec] if rec else []}

        return await self._read("PreparedQuery.Get", body, run)

    async def list(self, body: dict):
        return await self._read(
            "PreparedQuery.List", body,
            lambda ws: _wrap(self.server.store.prepared_query_list(ws=ws),
                             "queries"),
        )

    async def execute(self, body: dict):
        fwd = await self.server.forward("PreparedQuery.Execute", body, read=True)
        if fwd is not None:
            return fwd
        if body.get("query") is not None:
            # ExecuteRemote (prepared_query_endpoint.go:480): another
            # DC's server shipped us the full query — queries are
            # per-DC state, so failover carries the definition.
            query = body["query"]
        else:
            query = self.server.store.prepared_query_resolve(body["query_id"])
        if query is None:
            return {"nodes": [], "service": "", "error": "query not found"}
        service = query["service"]["service"]
        idx, rows = self.server.store.check_service_nodes(service)
        only_passing = bool(query["service"].get("only_passing", False))
        out = []
        for r in rows:
            bad = [c for c in r["checks"] if c["status"] == HEALTH_CRITICAL]
            if bad:
                continue
            if only_passing and any(
                c["status"] != HEALTH_PASSING for c in r["checks"]
            ):
                continue
            out.append(r)
        limit = int(query.get("limit", 0) or body.get("limit", 0) or 0)
        if limit:
            out = out[:limit]
        if not out and body.get("query") is None:
            remote = await self._execute_failover(query, body, limit)
            if remote is not None:
                return remote
        return {"nodes": out, "service": service, "meta": {"index": idx}}

    async def _execute_failover(
        self, query: dict, body: dict, limit: int
    ) -> Optional[dict]:
        """RTT-ranked cross-DC failover (prepared_query_endpoint.go
        ExecuteRemote + queryFailover): when the local DC has no healthy
        instances, walk the failover DCs — nearest_n by Vivaldi distance
        over the WAN pool (router.go:534 GetDatacentersByDistance),
        then any explicitly listed DCs — and return the first DC that
        answers with instances."""
        failover = (query.get("service") or {}).get("failover") or {}
        nearest_n = int(failover.get("nearest_n", 0) or 0)
        explicit = list(failover.get("datacenters") or ())
        if nearest_n <= 0 and not explicit:
            return None
        ordered: list[str] = []
        by_distance = [
            dc for dc in self.server.router.get_datacenters_by_distance()
            if dc != self.server.config.datacenter
        ]
        ordered.extend(by_distance[:nearest_n])
        for dc in explicit:
            if dc not in ordered and dc != self.server.config.datacenter:
                ordered.append(dc)
        for dc in ordered:
            try:
                out = await self.server._forward_dc(
                    "PreparedQuery.Execute",
                    {"query": query, "query_id": body.get("query_id", ""),
                     "limit": limit, "dc": dc,
                     "token": body.get("token", "")},
                    dc,
                )
            except Exception:  # noqa: BLE001 - next DC
                continue
            if out and out.get("nodes"):
                out["datacenter"] = dc
                out["failovers"] = ordered.index(dc) + 1
                return out
        return None


class Internal(_Endpoint):
    """internal_endpoint.go — composite reads used by the UI/agent."""

    async def acl_authorize(self, body: dict):
        """Token → one permission verdict, for CLIENT agents that hold
        no resolver of their own (consul/acl.go ResolveToken resolves
        through servers from clients; collapsed to a single yes/no RPC
        instead of shipping policy documents).  Answered by ANY server —
        ACL tables are replicated state, so no leader forward (losing
        the leader must not take client-side permission checks down)."""
        from consul_tpu_torch.acl.engine import PREFIX_RESOURCES, SCALAR_RESOURCES

        kind = body.get("kind", "")
        want = body.get("want", "")
        if (kind not in PREFIX_RESOURCES + SCALAR_RESOURCES
                or want not in (READ, WRITE)):
            return {"allowed": False}
        try:
            self.server.acl_check(body, kind, body.get("name", ""), want)
        except RPCError:
            return {"allowed": False}
        return {"allowed": True}

    async def node_info(self, body: dict):
        self.server.acl_check(body, "node", body.get("node", ""), READ)

        def run(ws):
            idx1, node = self.server.store.node(body["node"], ws=ws)
            idx2, svcs = self.server.store.node_services(body["node"], ws=ws)
            idx3, checks = self.server.store.node_checks(body["node"], ws=ws)
            return max(idx1, idx2, idx3), {
                "dump": [] if node is None else [
                    {"node": node, "services": svcs, "checks": checks}
                ]
            }

        return await self._read("Internal.NodeInfo", body, run)

    async def node_dump(self, body: dict):
        # internal_endpoint.go NodeDump is filtered per node
        # (filterACL); collapsed to a node read check on the whole dump.
        self.server.acl_check(body, "node", "", READ)

        def run(ws):
            idx, nodes = self.server.store.nodes(ws=ws)
            # Watch + index across ALL three tables, or a blocking dump
            # would sleep through service/check-only changes.
            idx = max(idx, self.server.store.max_index("services", "checks"))
            dump = []
            for n in nodes:
                _, svcs = self.server.store.node_services(n["node"], ws=ws)
                _, checks = self.server.store.node_checks(n["node"], ws=ws)
                dump.append({"node": n, "services": svcs, "checks": checks})
            if ws is not None:
                self.server.store.table_watch("services", ws)
                self.server.store.table_watch("checks", ws)
            return idx, {"dump": dump}

        return await self._read("Internal.NodeDump", body, run)


class Operator(_Endpoint):
    """operator_raft_endpoint.go / operator_autopilot_endpoint.go."""

    async def raft_get_configuration(self, body: dict):
        self.server.acl_check(body, "operator", "", READ)
        raft = self.server.raft
        servers = []
        if raft is not None:
            for vid in raft.voters:
                servers.append({
                    "id": vid,
                    "address": self.server._raft_peer_addr(vid) or "",
                    "leader": vid == raft.leader_id,
                    "voter": True,
                })
            for nid in raft.non_voters:
                servers.append({
                    "id": nid,
                    "address": self.server._raft_peer_addr(nid) or "",
                    "leader": False,
                    "voter": False,
                })
        return {"servers": servers, "index": raft.commit_index if raft else 0}

    async def autopilot_get_configuration(self, body: dict):
        """operator_autopilot_endpoint.go AutopilotGetConfiguration."""
        self.server.acl_check(body, "operator", "", READ)
        _, entry = self.server.store.config_entry_get(
            "autopilot-config", "global")
        cfg = self.server.config
        defaults = {
            "cleanup_dead_servers": cfg.autopilot_cleanup_dead_servers,
            "last_contact_threshold_s": cfg.autopilot_grace_s,
            "server_stabilization_time_s":
                cfg.autopilot_server_stabilization_s,
            "max_trailing_logs": cfg.autopilot_max_trailing_logs,
        }
        if entry:
            defaults.update({
                k: v for k, v in entry.items()
                if k in defaults
            })
            defaults["modify_index"] = entry.get("modify_index", 0)
        return {"config": defaults}

    async def autopilot_set_configuration(self, body: dict):
        """operator_autopilot_endpoint.go AutopilotSetConfiguration
        (CAS supported via ?cas=<modify_index>)."""
        self.server.acl_check(body, "operator", "", WRITE)
        fwd = await self.server.forward(
            "Operator.AutopilotSetConfiguration", body)
        if fwd is not None:
            return fwd
        result = await self.server.raft_apply(
            MessageType.AUTOPILOT,
            {"config": body.get("config") or {},
             "cas": bool(body.get("cas")),
             "modify_index": int(body.get("modify_index", 0) or 0)},
        )
        self.server.apply_autopilot_overrides()
        return {"result": result}

    async def raft_remove_peer_by_id(self, body: dict):
        self.server.acl_check(body, "operator", "", WRITE)
        fwd = await self.server.forward("Operator.RaftRemovePeerByID", body)
        if fwd is not None:
            return fwd
        if self.server.raft is None:
            return {"removed": False}
        await self.server.raft.remove_server(body["id"])
        return {"removed": True}

    async def server_health(self, body: dict):
        """operator_autopilot_endpoint.go ServerHealth — the autopilot
        health records (healthy flag, stable-since age, log index,
        voter) plus the cluster roll-up.  On a non-leader the log-lag
        component is unknown (match_index is leader state), so health
        there reflects serf liveness only."""
        srv = self.server
        members = srv._server_members()
        raft = srv.raft
        # Refresh the records on read so a non-leader (or a quiet
        # leader between autopilot passes) still answers accurately.
        srv._autopilot_update_health()
        now = time.monotonic()
        servers = []
        for m in members:
            rec = srv._server_health.get(m.tags.get("id"), {})
            servers.append({
                "id": m.tags.get("id", ""),
                "name": m.name,
                "serf_status": m.status.name.lower(),
                "healthy": bool(rec.get("healthy", False)),
                "stable_since_s": round(
                    now - rec["stable_since"], 3
                ) if rec.get("stable_since") else 0.0,
                "last_index": rec.get("last_index", 0),
                "voter": raft is not None
                and m.tags.get("id") in raft.voters,
            })
        healthy_voters = sum(
            1 for s in servers if s["healthy"] and s["voter"]
        )
        total_voters = len(raft.voters) if raft is not None else 0
        quorum = total_voters // 2 + 1 if total_voters else 0
        return {
            "healthy": all(s["healthy"] for s in servers) and bool(
                raft is not None and raft.leader_id is not None
            ),
            "servers": servers,
            # How many MORE healthy voters can fail before quorum is
            # lost — measured against the full voter set's quorum, so
            # already-failed voters count against it
            # (autopilot/structs.go OperatorHealthReply).
            "failure_tolerance": max(0, healthy_voters - quorum),
        }


def _wrap(idx_and_data: tuple[int, Any], key: str) -> tuple[int, dict]:
    idx, data = idx_and_data
    return idx, {key: data}


class ConnectCA(_Endpoint):
    """connect_ca_endpoint.go: roots + leaf signing.  The built-in CA
    lives on the leader; the active root record is replicated so every
    server serves Roots."""

    async def roots(self, body: dict):
        return await self._read(
            "ConnectCA.Roots", body,
            lambda ws: _wrap(self.server.store.ca_roots(ws=ws), "roots"),
        )

    async def sign(self, body: dict):
        """Sign a leaf for a service (connect_ca_endpoint.go Sign):
        leader-only (it holds the private key)."""
        self.server.acl_check(
            body, "service", body.get("service", ""), WRITE
        )
        fwd = await self.server.forward("ConnectCA.Sign", body)
        if fwd is not None:
            return fwd
        ca = await self.server.connect_ca()
        leaf = ca.sign_leaf(body["service"])
        return {"leaf": leaf}

    async def rotate(self, body: dict):
        """Mint + activate a new signing root (leader_connect.go CA
        config update path): the outgoing key CROSS-SIGNS the new root
        (provider_consul.go CrossSignCA) so old-root-pinned peers keep
        verifying new leaves via the chain; old roots stay stored so
        outstanding leaves verify until expiry, and proxies roll their
        certs when they observe the new active root."""
        self.server.acl_check(body, "operator", "", WRITE)
        fwd = await self.server.forward("ConnectCA.Rotate", body)
        if fwd is not None:
            return fwd
        ca = await self.server.connect_ca()
        root = ca.rotate()
        await self.server.raft_apply(
            MessageType.CONNECT_CA, {"op": "set-root", "root": root}
        )
        return {"root_id": root["id"]}


class Intention(_Endpoint):
    """intention_endpoint.go: CRUD + match + connect authorize."""

    async def apply(self, body: dict):
        intention = dict(body.get("intention") or {})
        self.server.acl_check(
            body, "service", intention.get("destination", ""), WRITE
        )
        if body.get("op") in ("create", "update"):
            if not intention.get("destination"):
                raise ValueError("intention requires a destination")
            intention.setdefault("source", "*")
            intention.setdefault("id", str(uuid.uuid4()))
            intention.setdefault("action", "allow")
            body = {**body, "intention": intention}
        if body.get("op") == "create":
            # One intention per (source, destination) pair — a second
            # create must not shadow the first in the precedence walk
            # (intention_endpoint.go Apply duplicate check).
            _, rows = self.server.store.intention_match(
                intention["destination"]
            )
            if any(r["source"] == intention["source"]
                   and r["destination"] == intention["destination"]
                   for r in rows):
                raise ValueError(
                    f"duplicate intention {intention['source']!r} -> "
                    f"{intention['destination']!r}")
        out = await self._write(
            "Intention.Apply", MessageType.INTENTION, body
        )
        out.setdefault("intention", intention)
        return out

    async def list(self, body: dict):
        return await self._read(
            "Intention.List", body,
            lambda ws: _wrap(self.server.store.intention_list(ws=ws),
                             "intentions"),
        )

    async def get(self, body: dict):
        def run(ws):
            idx, rec = self.server.store.intention_get(body["id"], ws=ws)
            return idx, {"intentions": [rec] if rec else []}

        return await self._read("Intention.Get", body, run)

    async def match(self, body: dict):
        self.server.acl_check(
            body, "service", body.get("destination", ""), READ
        )
        # default_allow rides along so enforcement points (proxies)
        # apply the same fallback as Intention.Check without a second
        # RPC (intention_endpoint.go Match + DefaultDecision).
        default_allow = (
            not self.server.acl.enabled
            or self.server.acl.default_policy == "allow"
        )

        def run(ws):
            idx, rows = self.server.store.intention_match(
                body.get("destination", ""), ws=ws
            )
            return idx, {"intentions": rows, "default_allow": default_allow}

        return await self._read("Intention.Match", body, run)

    async def check(self, body: dict):
        """Connect authorize core (intention_endpoint.go Check +
        consul/intention_endpoint.go Test): walk matching intentions by
        precedence; first source match decides; default follows the ACL
        default policy (intentions deny-by-default only when ACLs
        do)."""
        self.server.acl_check(
            body, "service", body.get("destination", ""), READ
        )
        source = body.get("source", "")
        _, matches = self.server.store.intention_match(
            body.get("destination", "")
        )
        for intention in matches:
            if intention["source"] in (source, "*"):
                return {
                    "allowed": intention.get("action", "allow") == "allow",
                    "reason": f"matched intention {intention['id']}",
                }
        default_allow = (
            not self.server.acl.enabled
            or self.server.acl.default_policy == "allow"
        )
        return {"allowed": default_allow, "reason": "default policy"}


class DiscoveryChain(_Endpoint):
    """discovery_chain_endpoint.go Get: compile one service's chain
    from the current config entries, blocking on entry changes."""

    async def get(self, body: dict):
        from consul_tpu_torch.connect.discoverychain import (
            compile_chain,
            entries_for_chain,
        )

        name = body.get("name", "")
        self.server.acl_check(body, "service", name, READ)

        def run(ws):
            idx, entries = entries_for_chain(self.server.store, name, ws=ws)
            chain = compile_chain(
                name, self.server.config.datacenter, entries,
                use_in_datacenter=body.get("use_in_datacenter", ""),
                override_protocol=body.get("override_protocol", ""),
                override_connect_timeout_s=float(
                    body.get("override_connect_timeout_s", 0) or 0),
            )
            return max(idx, 1), {"chain": chain}

        return await self._read("DiscoveryChain.Get", body, run)


class AutoEncrypt(_Endpoint):
    """consul/auto_encrypt_endpoint.go: a CLIENT agent bootstraps its
    TLS identity — an agent-kind SPIFFE leaf + the CA roots — in one
    RPC at startup, before it can do anything else."""

    async def sign(self, body: dict):
        # auto_encrypt_endpoint.go Sign: an anonymous caller must not be
        # able to mint an agent identity for an arbitrary node — require
        # node:write on the claimed node name (the intro/agent token).
        self.server.acl_check(body, "node", body.get("node", ""), WRITE)
        fwd = await self.server.forward("AutoEncrypt.Sign", body)
        if fwd is not None:
            return fwd
        ca = await self.server.connect_ca()
        leaf = ca.sign_leaf(body.get("node", ""), kind="agent")
        _, roots = self.server.store.ca_roots()
        return {"leaf": leaf, "roots": roots}


def _interpolate_bind_name(template: str, vars_: dict[str, str]) -> str:
    """``${var}`` interpolation over projected identity vars
    (agent/consul/acl_endpoint.go computeBindingRuleBindName →
    lib.InterpolateHIL).  Unknown vars raise KeyError so a login can
    never silently bind to a half-substituted name."""
    import re as _re

    def sub(m):
        name = m.group(1)
        if name not in vars_:
            raise KeyError(name)
        return vars_[name]

    return _re.sub(r"\$\{([A-Za-z0-9_.]+)\}", sub, template)


class AutoConfig(_Endpoint):
    """consul/auto_config_endpoint.go InitialConfiguration: a brand-new
    CLIENT with nothing but a server address and a JWT intro token
    bootstraps its full runtime — gossip encryption keys, an ACL agent
    token, its TLS identity, and cluster-level settings — in ONE RPC,
    before it can join gossip or speak ACL'd RPCs."""

    async def initial_configuration(self, body: dict):
        fwd = await self.server.forward(
            "AutoConfig.InitialConfiguration", body
        )
        if fwd is not None:
            return fwd
        authz = self.server.config.auto_config_authorizer
        if not authz:
            raise RPCError("auto-config is disabled on this server")
        node = body.get("node", "")
        if not node:
            raise ValueError("auto-config request must name a node")
        # The node name is caller-controlled AND interpolated into the
        # claim-assertion selectors below — restrict it to the hostname
        # alphabet so it can never smuggle bexpr syntax
        # (auto_config_endpoint.go validates against InvalidDnsRe the
        # same way).
        import re as _re

        if not _re.fullmatch(r"[A-Za-z0-9_.-]{1,128}", node):
            raise ValueError(f"invalid node name {node!r}")
        from consul_tpu_torch.acl import jwt as jwt_mod

        try:
            claims = jwt_mod.validate(
                body.get("jwt", ""),
                secret=authz.get("jwt_secret", ""),
                pub_keys=authz.get("jwt_validation_pub_keys") or [],
                bound_issuer=authz.get("bound_issuer", ""),
                bound_audiences=authz.get("bound_audiences") or [],
                clock_skew_s=float(authz.get("clock_skew_s", 30.0)),
            )
        except jwt_mod.JWTError as e:
            raise RPCError(ERR_PERMISSION_DENIED) from e
        selectable, _projected = jwt_mod.identity_from_claims(
            claims,
            authz.get("claim_mappings") or {},
            authz.get("list_claim_mappings") or {},
        )
        # auto_config_endpoint.go claim assertions: every configured
        # selector must match the verified identity; @@node@@ stands in
        # for the claimed node name (lib.InterpolateHIL equivalent).
        from consul_tpu_torch.agent.bexpr import FilterError, create_filter

        for raw in authz.get("claim_assertions") or []:
            selector = raw.replace("${node}", node)
            try:
                if not create_filter(selector).match(selectable):
                    raise RPCError(ERR_PERMISSION_DENIED)
            except FilterError as e:
                raise RPCError(ERR_PERMISSION_DENIED) from e

        cfg = self.server.config
        out: dict = {
            "config": {
                "datacenter": cfg.datacenter,
                "primary_datacenter": cfg.primary_datacenter
                or cfg.datacenter,
                "node_name": node,
                "acl": {
                    "enabled": cfg.acl_enabled,
                    "default_policy": cfg.acl_default_policy,
                },
            },
            # Primary key FIRST, then the rest of the ring — a client
            # bootstrapping mid-rotation must decrypt traffic still
            # using older keys.
            "gossip_keys": (
                [cfg.keyring.primary_b64()]
                + [k for k in cfg.keyring.list_keys()
                   if k != cfg.keyring.primary_b64()]
                if cfg.keyring else []
            ),
        }
        if cfg.acl_enabled:
            # Mint (or REUSE) a node-identity agent token so
            # anti-entropy and agent-plane RPCs work under enforcement
            # (auto_config_endpoint.go updateTokenResponse persists and
            # reuses) — a retrying or restarting client must not grow
            # an orphaned token per call.
            desc = f"auto-config token for node {node!r}"
            _, tokens = self.server.store.acl_token_list()
            existing = next(
                (t for t in tokens
                 if t.get("description") == desc
                 and t.get("node_identities")), None,
            )
            if existing is not None:
                secret = existing["secret_id"]
            else:
                token = {
                    "secret_id": str(uuid.uuid4()),
                    "accessor_id": str(uuid.uuid4()),
                    "description": desc,
                    "auth_method": "",
                    "local": True,
                    "node_identities": [
                        {"node_name": node, "datacenter": cfg.datacenter}
                    ],
                }
                await self.server.raft_apply(
                    MessageType.ACL_TOKEN_SET, {"token": token}
                )
                secret = token["secret_id"]
            out["config"]["acl"]["tokens"] = {"agent": secret}
        # TLS identity, exactly the auto-encrypt shape.
        ca = await self.server.connect_ca()
        leaf = ca.sign_leaf(node, kind="agent")
        _, roots = self.server.store.ca_roots()
        out["tls"] = {"leaf": leaf, "roots": roots}
        return out


class ACL(_Endpoint):
    """acl_endpoint.go — token/policy CRUD + one-shot bootstrap.

    Bootstrap (acl_endpoint.go:56-118 BootstrapTokens): allowed only
    while no management token exists; returns a generated management
    secret.  All other methods require acl read/write via a resolved
    token (consul/acl_endpoint.go authorizers)."""

    def __init__(self, server):
        super().__init__(server)
        self._bootstrap_lock = asyncio.Lock()

    async def bootstrap(self, body: dict):
        fwd = await self.server.forward("ACL.Bootstrap", body)
        if fwd is not None:
            return fwd
        # Serialize check-then-apply so concurrent bootstraps can't both
        # mint a management token (acl_endpoint.go guards with the
        # bootstrap reset index through raft).
        async with self._bootstrap_lock:
            _, tokens = self.server.store.acl_token_list()
            if any(t.get("type") == "management" for t in tokens):
                raise ValueError("ACL bootstrap no longer allowed")
            secret = str(uuid.uuid4())
            token = {
                "secret_id": secret,
                "description": "Bootstrap Token (Global Management)",
                "type": "management",
                "policies": [],
            }
            await self.server.raft_apply(
                MessageType.ACL_TOKEN_SET, {"token": token}
            )
        self.server.acl.invalidate()
        return {"token": token}

    async def token_set(self, body: dict):
        # Forward the ORIGINAL body (auth token intact) and transform on
        # the executing leader only — a follower must never forward a
        # half-built raft payload back into this endpoint.
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.TokenSet", body)
        if fwd is not None:
            return fwd
        token = dict(body.get("acl_token") or body.get("new_token") or {})
        token.setdefault("secret_id", str(uuid.uuid4()))
        # acl_endpoint.go:456-481: a relative TTL is converted into an
        # absolute expiration at create time and never stored itself.
        ttl = float(token.pop("expiration_ttl_s", 0) or 0)
        if ttl < 0:
            raise ValueError("Token Expiration TTL should be > 0")
        if ttl:
            if token.get("expiration_time"):
                raise ValueError(
                    "Token cannot have both an ExpirationTTL "
                    "and an ExpirationTime"
                )
            token["expiration_time"] = time.time() + ttl
        for rid in token.get("roles", []):
            if self.server.store.acl_role_get(rid) is None:
                raise ValueError(f"no such ACL role {rid!r}")
        result = await self.server.raft_apply(
            MessageType.ACL_TOKEN_SET, {"token": token}
        )
        self.server.acl.invalidate(token["secret_id"])
        return {"result": result, "token": token}

    async def token_delete(self, body: dict):
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.TokenDelete", body)
        if fwd is not None:
            return fwd
        result = await self.server.raft_apply(
            MessageType.ACL_TOKEN_DELETE, {"secret_id": body["secret_id"]}
        )
        self.server.acl.invalidate(body["secret_id"])
        return {"result": result}

    async def token_list(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        idx, tokens = self.server.store.acl_token_list()
        # Secrets are redacted for mere acl:read (the reference exposes
        # them only to acl:write).
        if not self.server.acl_resolve(body).acl_write():
            tokens = [
                {**t, "secret_id": "<hidden>"} for t in tokens
            ]
        return {"tokens": tokens, "meta": {"index": idx}}

    async def token_read(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        rec = self.server.store.acl_token_get(body["secret_id"])
        return {"token": rec}

    async def policy_set(self, body: dict):
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.PolicySet", body)
        if fwd is not None:
            return fwd
        policy = dict(body.get("policy") or {})
        policy.setdefault("id", str(uuid.uuid4()))
        result = await self.server.raft_apply(
            MessageType.ACL_POLICY_SET, {"policy": policy}
        )
        self.server.acl.invalidate()
        return {"result": result, "policy": policy}

    async def policy_delete(self, body: dict):
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.PolicyDelete", body)
        if fwd is not None:
            return fwd
        result = await self.server.raft_apply(
            MessageType.ACL_POLICY_DELETE, {"id": body["id"]}
        )
        self.server.acl.invalidate()
        return {"result": result}

    async def policy_list(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        idx, policies = self.server.store.acl_policy_list()
        return {"policies": policies, "meta": {"index": idx}}

    async def policy_read(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        rec = self.server.store.acl_policy_get(body["id"])
        return {"policy": rec}

    # -- roles (acl_endpoint.go RoleSet/RoleDelete/RoleList/RoleRead) ------

    async def role_set(self, body: dict):
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.RoleSet", body)
        if fwd is not None:
            return fwd
        role = dict(body.get("role") or {})
        if not role.get("name"):
            raise ValueError("ACL role must have a name")
        role.setdefault("id", str(uuid.uuid4()))
        existing = self.server.store.acl_role_get_by_name(role["name"])
        if existing is not None and existing["id"] != role["id"]:
            raise ValueError(
                f"role name {role['name']!r} is already in use"
            )
        for pid in role.get("policies", []):
            if self.server.store.acl_policy_get(pid) is None:
                raise ValueError(f"no such ACL policy {pid!r}")
        result = await self.server.raft_apply(
            MessageType.ACL_ROLE_SET, {"role": role}
        )
        self.server.acl.invalidate()
        return {"result": result, "role": role}

    async def role_delete(self, body: dict):
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.RoleDelete", body)
        if fwd is not None:
            return fwd
        result = await self.server.raft_apply(
            MessageType.ACL_ROLE_DELETE, {"id": body["id"]}
        )
        self.server.acl.invalidate()
        return {"result": result}

    async def role_list(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        idx, roles = self.server.store.acl_role_list()
        return {"roles": roles, "meta": {"index": idx}}

    async def role_read(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        if body.get("name"):
            rec = self.server.store.acl_role_get_by_name(body["name"])
        else:
            rec = self.server.store.acl_role_get(body["id"])
        return {"role": rec}

    # -- auth methods (acl_endpoint.go AuthMethodSet/...) ------------------

    async def auth_method_set(self, body: dict):
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.AuthMethodSet", body)
        if fwd is not None:
            return fwd
        method = dict(body.get("auth_method") or {})
        if not method.get("name"):
            raise ValueError("auth method must have a name")
        if method.get("type") not in ("jwt",):
            raise ValueError(
                f"invalid auth method type {method.get('type')!r} "
                "(supported: jwt)"
            )
        ttl = float(method.get("max_token_ttl_s", 0) or 0)
        if ttl < 0:
            raise ValueError("max_token_ttl_s should be >= 0")
        result = await self.server.raft_apply(
            MessageType.ACL_AUTH_METHOD_SET, {"method": method}
        )
        return {"result": result, "auth_method": method}

    async def auth_method_delete(self, body: dict):
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.AuthMethodDelete", body)
        if fwd is not None:
            return fwd
        result = await self.server.raft_apply(
            MessageType.ACL_AUTH_METHOD_DELETE, {"name": body["name"]}
        )
        # The cascade may have deleted tokens — drop all cached authz.
        self.server.acl.invalidate()
        return {"result": result}

    async def auth_method_list(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        idx, methods = self.server.store.acl_auth_method_list()
        return {"auth_methods": methods, "meta": {"index": idx}}

    async def auth_method_read(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        rec = self.server.store.acl_auth_method_get(body["name"])
        return {"auth_method": rec}

    # -- binding rules (acl_endpoint.go BindingRuleSet/...) ----------------

    async def binding_rule_set(self, body: dict):
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.BindingRuleSet", body)
        if fwd is not None:
            return fwd
        rule = dict(body.get("binding_rule") or {})
        if not rule.get("auth_method"):
            raise ValueError("binding rule must name an auth method")
        method = self.server.store.acl_auth_method_get(rule["auth_method"])
        if method is None:
            raise ValueError(
                f"no such auth method {rule['auth_method']!r}"
            )
        if rule.get("bind_type") not in ("role", "service", "node"):
            raise ValueError(
                f"invalid bind_type {rule.get('bind_type')!r} "
                "(role|service|node)"
            )
        if not rule.get("bind_name"):
            raise ValueError("binding rule must have a bind_name")
        # Vet the template against the method's projected vars NOW
        # (acl_endpoint.go BindingRuleSet → validateBindingRuleBindName
        # with validator.ProjectedVarNames) — a typo'd ${var} must fail
        # the write, not every later login.
        cfg = method.get("config") or {}
        known = {str(v) for v in (cfg.get("claim_mappings") or {}).values()}
        try:
            _interpolate_bind_name(
                rule["bind_name"], dict.fromkeys(known, "x")
            )
        except KeyError as e:
            raise ValueError(
                f"bind_name references unknown variable {e} "
                f"(auth method maps: {sorted(known) or 'none'})"
            ) from e
        if rule.get("selector"):
            from consul_tpu_torch.agent.bexpr import create_filter
            create_filter(rule["selector"])  # syntax check up front
        rule.setdefault("id", str(uuid.uuid4()))
        result = await self.server.raft_apply(
            MessageType.ACL_BINDING_RULE_SET, {"rule": rule}
        )
        return {"result": result, "binding_rule": rule}

    async def binding_rule_delete(self, body: dict):
        self.server.acl_check(body, "acl", "", WRITE)
        fwd = await self.server.forward("ACL.BindingRuleDelete", body)
        if fwd is not None:
            return fwd
        result = await self.server.raft_apply(
            MessageType.ACL_BINDING_RULE_DELETE, {"id": body["id"]}
        )
        return {"result": result}

    async def binding_rule_list(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        idx, rules = self.server.store.acl_binding_rule_list(
            body.get("auth_method", "")
        )
        return {"binding_rules": rules, "meta": {"index": idx}}

    async def binding_rule_read(self, body: dict):
        self.server.acl_check(body, "acl", "", READ)
        rec = self.server.store.acl_binding_rule_get(body["id"])
        return {"binding_rule": rec}

    # -- login / logout (acl_endpoint.go Login/Logout) ---------------------

    async def login(self, body: dict):
        """Exchange a bearer JWT for a Consul token
        (acl_endpoint.go:~Login → acl_authmethod.go
        evaluateRoleBindings).  Requires NO pre-existing token."""
        fwd = await self.server.forward("ACL.Login", body)
        if fwd is not None:
            return fwd
        auth = body.get("auth") or {}
        method_name = auth.get("auth_method", "")
        bearer = auth.get("bearer_token", "")
        method = self.server.store.acl_auth_method_get(method_name)
        if method is None:
            raise ValueError(f"no such auth method {method_name!r}")
        from consul_tpu_torch.acl import jwt as jwt_mod

        cfg = method.get("config") or {}
        try:
            claims = jwt_mod.validate(
                bearer,
                secret=cfg.get("jwt_secret", ""),
                pub_keys=cfg.get("jwt_validation_pub_keys") or [],
                bound_issuer=cfg.get("bound_issuer", ""),
                bound_audiences=cfg.get("bound_audiences") or [],
                clock_skew_s=float(cfg.get("clock_skew_s", 30.0)),
            )
        except jwt_mod.JWTError as e:
            # Surfaced as the canonical 403 string; the detail stays in
            # the server log only (acl_endpoint.go wraps in
            # ErrPermissionDenied the same way).
            raise RPCError(ERR_PERMISSION_DENIED) from e
        selectable, projected = jwt_mod.identity_from_claims(
            claims,
            cfg.get("claim_mappings") or {},
            cfg.get("list_claim_mappings") or {},
        )
        bindings = self._evaluate_role_bindings(
            method_name, selectable, projected
        )
        if not any(bindings.values()):
            # acl_endpoint.go Login: no rule matched → no token.
            raise RPCError(ERR_PERMISSION_DENIED)
        ttl = float(method.get("max_token_ttl_s", 0) or 0)
        token = {
            "secret_id": str(uuid.uuid4()),
            "accessor_id": str(uuid.uuid4()),
            "description": (
                f"token created via login: {auth.get('meta') or {}}"
            ),
            "auth_method": method_name,
            "local": True,
            "roles": bindings["roles"],
            "service_identities": bindings["service_identities"],
            "node_identities": bindings["node_identities"],
        }
        if ttl:
            token["expiration_time"] = time.time() + ttl
        await self.server.raft_apply(
            MessageType.ACL_TOKEN_SET, {"token": token}
        )
        return {"token": token}

    def _evaluate_role_bindings(
        self, method_name: str, selectable: dict, projected: dict
    ) -> dict:
        """acl_authmethod.go evaluateRoleBindings: match selectors
        against the verified identity, then interpolate bind names."""
        from consul_tpu_torch.agent.bexpr import FilterError, create_filter

        _, rules = self.server.store.acl_binding_rule_list(method_name)
        out = {"roles": [], "service_identities": [], "node_identities": []}
        for rule in rules:
            selector = rule.get("selector", "")
            if selector:
                try:
                    if not create_filter(selector).match(selectable):
                        continue
                except FilterError:
                    continue  # invalid selector fails closed
            try:
                bind_name = _interpolate_bind_name(
                    rule["bind_name"], projected
                )
            except KeyError:
                # The JWT simply lacks a mapped claim this rule needs —
                # skip the rule (no privileges granted) rather than
                # failing the whole login alongside rules that matched.
                continue
            if rule["bind_type"] == "service":
                out["service_identities"].append(
                    {"service_name": bind_name}
                )
            elif rule["bind_type"] == "node":
                out["node_identities"].append({
                    "node_name": bind_name,
                    "datacenter": self.server.config.datacenter,
                })
            elif rule["bind_type"] == "role":
                role = self.server.store.acl_role_get_by_name(bind_name)
                if role is not None:
                    out["roles"].append(role["id"])
        return out

    async def logout(self, body: dict):
        """Destroy the requesting token itself; only tokens minted by an
        auth method may log out (acl_endpoint.go Logout)."""
        fwd = await self.server.forward("ACL.Logout", body)
        if fwd is not None:
            return fwd
        secret = body.get("token", "")
        rec = self.server.store.acl_token_get(secret)
        if rec is None or not rec.get("auth_method"):
            raise RPCError(ERR_PERMISSION_DENIED)
        result = await self.server.raft_apply(
            MessageType.ACL_TOKEN_DELETE, {"secret_id": secret}
        )
        self.server.acl.invalidate(secret)
        return {"result": result}


class FederationState(_Endpoint):
    """federation_state_endpoint.go — CRUD over the per-DC mesh-gateway
    map.  Writes ALWAYS land in the primary datacenter and replicate
    outward (federation_state_endpoint.go:25-28)."""

    async def apply(self, body: dict):
        # Rewrite the target DC to the primary BEFORE forwarding — every
        # federation-state write goes to the primary's raft.
        body = {**body, "dc": self.server.config.primary_datacenter
                or self.server.config.datacenter}
        fwd = await self.server.forward("FederationState.Apply", body)
        if fwd is not None:
            return fwd
        self.server.acl_check(body, "operator", "", WRITE)
        state = body.get("state") or {}
        if not state.get("datacenter"):
            raise ValueError(
                "invalid request: missing federation state datacenter"
            )
        op = body.get("op", "upsert")
        if op not in ("upsert", "delete"):
            raise ValueError(f"Invalid federation state operation: {op}")
        result = await self.server.raft_apply(
            MessageType.FEDERATION_STATE, {"op": op, "state": state}
        )
        return {"result": result}

    async def get(self, body: dict):
        self.server.acl_check(body, "operator", "", READ)

        def run(ws):
            idx, state = self.server.store.federation_state_get(
                body["target_dc"], ws=ws
            )
            return max(idx, 1), {"state": state}

        return await self._read("FederationState.Get", body, run)

    async def list(self, body: dict):
        self.server.acl_check(body, "operator", "", READ)

        def run(ws):
            idx, states = self.server.store.federation_state_list(ws=ws)
            return max(idx, 1), {"states": states}

        return await self._read("FederationState.List", body, run)

    async def list_mesh_gateways(self, body: dict):
        """DC → healthy-ish mesh gateway instances, the data plane's
        cross-DC routing table (federation_state_endpoint.go
        ListMeshGateways).  Gateways are services — service:read
        filtering applies like any catalog read."""

        def run(ws):
            idx, states = self.server.store.federation_state_list(ws=ws)
            authz = self._authz(body)
            out = {}
            for st in states:
                gws = st.get("mesh_gateways", [])
                if authz is not None:
                    gws = [g for g in gws
                           if authz.service_read(g.get("service", ""))]
                if gws:
                    out[st["datacenter"]] = gws
            return max(idx, 1), {"gateways": out}

        return await self._read(
            "FederationState.ListMeshGateways", body, run
        )


class Snapshot(_Endpoint):
    """snapshot_endpoint.go: atomic save/restore of the full state.
    The reference gates both on management tokens; approximated here as
    operator read (save) / operator write (restore)."""

    async def save(self, body: dict):
        from consul_tpu_torch.agent.snapshot import write_archive

        self.server.acl_check(body, "operator", "", READ)
        fwd = await self.server.forward("Snapshot.Save", body)
        if fwd is not None:
            return fwd
        # Saved from the leader for a consistent, current view
        # (snapshot_endpoint.go defaults to consistent mode).
        raft = self.server.raft
        index = raft.last_index() if raft else 0
        term = raft.last_term() if raft else 0
        blob = write_archive(
            self.server.fsm.snapshot(), index, term, self.server.node_id
        )
        return {"archive": blob, "index": index}

    async def restore(self, body: dict):
        from consul_tpu_torch.agent.snapshot import SnapshotError, read_archive

        self.server.acl_check(body, "operator", "", WRITE)
        fwd = await self.server.forward("Snapshot.Restore", body)
        if fwd is not None:
            return fwd
        try:
            state, meta = read_archive(body["archive"])
        except SnapshotError as e:
            raise ValueError(str(e)) from e
        await self.server.raft_apply(
            MessageType.SNAPSHOT_RESTORE, {"state": state}
        )
        return {"result": True, "meta": meta}


class Subscribe(_Endpoint):
    """agent/rpc/subscribe/subscribe.go:45 — server-streaming change
    subscriptions: a snapshot of current state (closed by an
    end_of_snapshot marker), then live events as commits land.  Rides
    the muxed RPC port as a streaming method instead of gRPC."""

    async def subscribe(self, body: dict):
        from consul_tpu_torch.stream import SubscriptionClosed

        topic = body["topic"]
        key = body.get("key", "")
        # subscribe.go filterByAuth: resolve the subscriber's token up
        # front and drop events its authorizer cannot read.  Re-resolve
        # per event so token invalidation takes effect mid-stream.
        def readable(ev) -> bool:
            if not self.server.acl.enabled:
                return True
            authz = self.server.acl_resolve(body)
            if ev.end_of_snapshot:
                return True
            if ev.topic == "kv":
                return authz.key_read(ev.key)
            return authz.service_read(ev.key)

        sub = self.server.publisher.subscribe(topic, key)
        try:
            while True:
                ev = await sub.next()
                if not readable(ev):
                    continue
                yield {
                    "topic": ev.topic,
                    "key": ev.key,
                    "index": ev.index,
                    "payload": ev.payload,
                    "end_of_snapshot": ev.end_of_snapshot,
                }
        except SubscriptionClosed:
            # Store was rebuilt (snapshot restore): tell the consumer to
            # resubscribe for a fresh snapshot (pbsubscribe
            # NewSnapshotToFollow semantics, inverted: we end the
            # stream with a reset marker).
            yield {"reset": True}
        finally:
            sub.close()


def build_endpoints(server: "Server") -> dict[str, _Endpoint]:
    """The registry (server_oss.go:8-23)."""
    return {
        "Status": Status(server),
        "Catalog": Catalog(server),
        "Health": Health(server),
        "KVS": KVS(server),
        "Session": Session(server),
        "Coordinate": Coordinate(server),
        "Txn": Txn(server),
        "ConfigEntry": ConfigEntry(server),
        "PreparedQuery": PreparedQuery(server),
        "Internal": Internal(server),
        "Operator": Operator(server),
        "ACL": ACL(server),
        "AutoEncrypt": AutoEncrypt(server),
        "ConnectCA": ConnectCA(server),
        "Intention": Intention(server),
        "Snapshot": Snapshot(server),
        "Subscribe": Subscribe(server),
        "DiscoveryChain": DiscoveryChain(server),
        "FederationState": FederationState(server),
        "AutoConfig": AutoConfig(server),
    }
