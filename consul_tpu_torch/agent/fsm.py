"""The replicated state machine: raft log entries → StateStore writes; the
port's copy of ``consul_tpu/agent/fsm.py``.

Equivalent of the reference's ``agent/consul/fsm`` package: a dispatch
table from message type to a command handler built at init
(``fsm/fsm.go:19-120``), the command handlers themselves
(``fsm/commands_oss.go:13-40``), and whole-store snapshot/restore
(``fsm/snapshot_oss.go``).

Raft entry payloads are ``{"type": MessageType, "body": {...}}`` dicts
(the reference encodes the type as the first byte of the msgpack buffer,
``structs.Encode``); bodies are msgpack-friendly dicts throughout.

A message type OR'd with ``IGNORE_UNKNOWN_FLAG`` (bit 7) is skipped
without error when this node doesn't understand it — the reference's
forward-compatibility rule (``structs/structs.go`` IgnoreUnknownTypeFlag).
"""

from __future__ import annotations

import enum
import logging
import time
from typing import Any, Callable, Optional

from consul_tpu_torch.consensus.raft import FSM, Entry
from consul_tpu_torch.store.state import StateStore
from consul_tpu_torch.telemetry import metrics
from consul_tpu_torch.stream import (
    TOPIC_KV,
    TOPIC_SERVICE_HEALTH,
    Event,
    EventPublisher,
)

log = logging.getLogger("consul_tpu_torch.fsm")

IGNORE_UNKNOWN_FLAG = 128  # structs/structs.go IgnoreUnknownTypeFlag


class MessageType(enum.IntEnum):
    """Raft command types (``agent/structs/structs.go`` MessageType
    consts; same numbering so snapshots stay comparable)."""

    REGISTER = 0
    DEREGISTER = 1
    KVS = 2
    SESSION = 3
    ACL = 4  # deprecated legacy ACL path (unused, reserved)
    TOMBSTONE = 5
    COORDINATE_BATCH_UPDATE = 6
    PREPARED_QUERY = 7
    TXN = 8
    AUTOPILOT = 9
    AREA = 10
    ACL_BOOTSTRAP = 11
    INTENTION = 12
    CONNECT_CA = 13
    ACL_TOKEN_SET = 17
    ACL_TOKEN_DELETE = 18
    ACL_POLICY_SET = 19
    ACL_POLICY_DELETE = 20
    CONFIG_ENTRY = 22
    ACL_ROLE_SET = 23
    ACL_ROLE_DELETE = 24
    ACL_BINDING_RULE_SET = 25
    ACL_BINDING_RULE_DELETE = 26
    ACL_AUTH_METHOD_SET = 27
    ACL_AUTH_METHOD_DELETE = 28
    FEDERATION_STATE = 30
    # Not a reference command type: the reference installs user-snapshot
    # restores through raft.Restore/InstallSnapshot; here the unpacked
    # state rides one replicated log entry instead (agent/snapshot.py).
    SNAPSHOT_RESTORE = 96


_METRIC_NAMES = {
    int(t): f"consul.fsm.{t.name.lower()}" for t in MessageType
}


class ConsulFSM(FSM):
    """Applies committed raft entries to a :class:`StateStore`.

    The FSM is the ONLY writer to the store on a server, so every read
    is a consistent snapshot at some raft index (``fsm/fsm.go:102``).
    """

    def __init__(
        self,
        store: Optional[StateStore] = None,
        publisher: Optional[EventPublisher] = None,
    ):
        self.store = store or StateStore()
        # Change-stream publisher (state/memdb.go:37-41 wires the
        # reference's changeTrackerDB to the EventPublisher; here the
        # FSM is the single writer, so it is the publish point).
        self.publisher = publisher
        if publisher is not None:
            publisher.register_snapshot_handler(
                TOPIC_SERVICE_HEALTH, self._snapshot_service_health
            )
            publisher.register_snapshot_handler(TOPIC_KV, self._snapshot_kv)
        self._handlers: dict[int, Callable[[int, dict], Any]] = {
            MessageType.REGISTER: self._apply_register,
            MessageType.DEREGISTER: self._apply_deregister,
            MessageType.KVS: self._apply_kvs,
            MessageType.SESSION: self._apply_session,
            MessageType.TOMBSTONE: self._apply_tombstone,
            MessageType.COORDINATE_BATCH_UPDATE: self._apply_coordinates,
            MessageType.PREPARED_QUERY: self._apply_prepared_query,
            MessageType.TXN: self._apply_txn,
            MessageType.AUTOPILOT: self._apply_autopilot,
            MessageType.INTENTION: self._apply_intention,
            MessageType.CONNECT_CA: self._apply_connect_ca,
            MessageType.SNAPSHOT_RESTORE: self._apply_snapshot_restore,
            MessageType.ACL_TOKEN_SET: self._apply_acl_token_set,
            MessageType.ACL_TOKEN_DELETE: self._apply_acl_token_delete,
            MessageType.ACL_POLICY_SET: self._apply_acl_policy_set,
            MessageType.ACL_POLICY_DELETE: self._apply_acl_policy_delete,
            MessageType.ACL_ROLE_SET: self._apply_acl_role_set,
            MessageType.ACL_ROLE_DELETE: self._apply_acl_role_delete,
            MessageType.ACL_BINDING_RULE_SET:
                self._apply_acl_binding_rule_set,
            MessageType.ACL_BINDING_RULE_DELETE:
                self._apply_acl_binding_rule_delete,
            MessageType.ACL_AUTH_METHOD_SET:
                self._apply_acl_auth_method_set,
            MessageType.ACL_AUTH_METHOD_DELETE:
                self._apply_acl_auth_method_delete,
            MessageType.CONFIG_ENTRY: self._apply_config_entry,
            MessageType.FEDERATION_STATE: self._apply_federation_state,
        }

    # -- raft.FSM interface -------------------------------------------------

    def apply(self, entry: Entry) -> Any:
        msg_type = int(entry.data["type"])
        body = entry.data.get("body", {})
        handler = self._handlers.get(msg_type & ~IGNORE_UNKNOWN_FLAG)
        if handler is None:
            if msg_type & IGNORE_UNKNOWN_FLAG:
                log.warning("ignoring unknown message type %d", msg_type)
                return None
            raise ValueError(f"unknown raft command type {msg_type}")
        pre = (
            self._pre_change_info(msg_type & ~IGNORE_UNKNOWN_FLAG, body)
            if self.publisher is not None
            else None
        )
        try:
            _t0 = time.monotonic()
            result = handler(entry.index, body)
            metrics().measure_since(
                _METRIC_NAMES[msg_type & ~IGNORE_UNKNOWN_FLAG], _t0
            )
        except (ValueError, KeyError, TypeError) as e:
            # Domain errors (bad registration, missing session, malformed
            # body...) are a *result*, not an FSM failure: every replica
            # deterministically computes the same error and the leader
            # returns it to the caller (the reference returns the error
            # as the Apply value).
            return {"error": f"{type(e).__name__}: {e}"}
        if self.publisher is not None:
            try:
                events = self._events_for(
                    msg_type & ~IGNORE_UNKNOWN_FLAG, entry.index, body, pre
                )
                if events:
                    self.publisher.publish(events)
            except Exception:  # noqa: BLE001 - stream must never fail raft
                log.exception("event publish failed")
        return result

    def snapshot(self) -> Any:
        return self.store.snapshot()

    def restore(self, snap: Any) -> None:
        # The reference builds a NEW state store and abandons the old
        # one so blocked queries wake and re-run (fsm.go Restore);
        # StateStore.restore does both.  Stream subscribers likewise get
        # force-closed and must resubscribe for a fresh snapshot
        # (event_publisher.go on index regression).
        self.store.restore(snap)
        if self.publisher is not None:
            self.publisher.close_all()

    # -- change-stream plumbing (state/memdb.go:37-41 equivalents) ----------

    def _snapshot_service_health(self, key: str) -> tuple[int, list]:
        idx, rows = self.store.check_service_nodes(key)
        return idx, [
            Event(topic=TOPIC_SERVICE_HEALTH, key=key, index=idx, payload=rows)
        ]

    def _snapshot_kv(self, prefix: str) -> tuple[int, list]:
        idx, entries = self.store.kv_list(prefix)
        return idx, [
            Event(topic=TOPIC_KV, key=e["key"], index=idx, payload=e)
            for e in entries
        ]

    def _node_service_names(self, node: str) -> set[str]:
        try:
            _, services = self.store.node_services(node)
        except Exception:  # noqa: BLE001 - node may be gone
            return set()
        return {s.get("service", s.get("id", "")) for s in services}

    def _pre_change_info(self, msg_type: int, body: dict) -> Optional[dict]:
        """Subjects only determinable BEFORE the store mutates (a
        deregistration or recursive delete removes the rows we need to
        look at): affected service names and kv keys."""
        if msg_type == MessageType.DEREGISTER:
            node = body.get("node", "")
            if body.get("service_id"):
                names = set()
                _, services = self.store.node_services(node)
                for s in services:
                    if s.get("id") == body["service_id"]:
                        names.add(s.get("service", ""))
                return {"services": names}
            return {"services": self._node_service_names(node)}
        if msg_type == MessageType.KVS and body.get("op") == "delete-tree":
            prefix = (body.get("entry") or {}).get("key", "")
            _, entries = self.store.kv_list(prefix)
            return {"kv_keys": {e["key"] for e in entries}}
        return None

    def _events_for(
        self, msg_type: int, idx: int, body: dict, pre: Optional[dict]
    ) -> list:
        services: set[str] = set(
            (pre or {}).get("services", ())
        )
        kv_keys: set[str] = set((pre or {}).get("kv_keys", ()))
        if msg_type == MessageType.REGISTER:
            svc = body.get("service")
            if svc:
                services.add(svc.get("service", svc.get("id", "")))
            checks = list(body.get("checks") or [])
            if body.get("check"):
                checks.append(body["check"])
            for c in checks:
                if c.get("service_id"):
                    # Map the check's service id to its name.
                    node = body.get("node", "")
                    _, node_svcs = self.store.node_services(node)
                    for s in node_svcs:
                        if s.get("id") == c["service_id"]:
                            services.add(s.get("service", ""))
                else:
                    # Node-level check affects every service on the node
                    # (a failing serf check fails them all).
                    services |= self._node_service_names(body.get("node", ""))
            if not svc and not checks:
                # Node-only update (e.g. address change): every service
                # on the node embeds the node record in its rows.
                services |= self._node_service_names(body.get("node", ""))
        elif msg_type == MessageType.KVS:
            entry = body.get("entry") or {}
            if entry.get("key"):
                kv_keys.add(entry["key"])
        elif msg_type == MessageType.TXN:
            for op in body.get("ops", []):
                entry = (op.get("kv") or {}).get("entry") or {}
                if entry.get("key"):
                    kv_keys.add(entry["key"])
        events: list = []
        for name in sorted(s for s in services if s):
            _, rows = self.store.check_service_nodes(name)
            events.append(
                Event(
                    topic=TOPIC_SERVICE_HEALTH, key=name, index=idx,
                    payload=rows,
                )
            )
        for key in sorted(kv_keys):
            _, entry = self.store.kv_get(key)
            events.append(
                Event(topic=TOPIC_KV, key=key, index=idx, payload=entry)
            )
        return events

    # -- command handlers (fsm/commands_oss.go) -----------------------------

    def _apply_register(self, idx: int, body: dict) -> Any:
        self.store.ensure_registration(idx, body)
        return True

    def _apply_deregister(self, idx: int, body: dict) -> Any:
        # Precedence mirrors applyDeregister: a service or check id
        # limits the deregistration; otherwise the whole node goes.
        node = body["node"]
        if body.get("service_id"):
            return self.store.delete_service(idx, node, body["service_id"])
        if body.get("check_id"):
            return self.store.delete_check(idx, node, body["check_id"])
        return self.store.delete_node(idx, node)

    def _apply_kvs(self, idx: int, body: dict) -> Any:
        op = body["op"]
        entry = body.get("entry") or {}
        s = self.store
        if op == "set":
            s.kv_set(idx, entry)
            return True
        if op == "cas":
            return s.kv_set_cas(idx, entry, int(entry.get("modify_index", 0)))
        if op == "delete":
            return s.kv_delete(idx, entry["key"])
        if op == "delete-cas":
            return s.kv_delete_cas(idx, entry["key"], int(entry.get("modify_index", 0)))
        if op == "delete-tree":
            return s.kv_delete_tree(idx, entry["key"])
        if op == "lock":
            return s.kv_lock(idx, entry, entry.get("session") or "")
        if op == "unlock":
            return s.kv_unlock(idx, entry, entry.get("session") or "")
        raise ValueError(f"invalid KVS operation {op!r}")

    def _apply_session(self, idx: int, body: dict) -> Any:
        op = body["op"]
        if op == "create":
            self.store.session_create(idx, body["session"])
            return body["session"]["id"]
        if op == "destroy":
            return self.store.session_destroy(idx, body["session"]["id"])
        raise ValueError(f"invalid session operation {op!r}")

    def _apply_tombstone(self, idx: int, body: dict) -> Any:
        if body.get("op") != "reap":
            raise ValueError(f"invalid tombstone operation {body.get('op')!r}")
        return self.store.tombstone_reap(idx, int(body["index"]))

    def _apply_coordinates(self, idx: int, body: dict) -> Any:
        self.store.coordinate_batch_update(idx, body["updates"])
        return True

    def _apply_prepared_query(self, idx: int, body: dict) -> Any:
        op = body["op"]
        if op in ("create", "update"):
            self.store.prepared_query_set(idx, body["query"])
            return body["query"]["id"]
        if op == "delete":
            return self.store.prepared_query_delete(idx, body["query"]["id"])
        raise ValueError(f"invalid prepared query operation {op!r}")

    def _apply_txn(self, idx: int, body: dict) -> Any:
        results, errors = self.store.txn_apply(idx, body["ops"])
        return {"results": results, "errors": errors}

    def _apply_autopilot(self, idx: int, body: dict) -> Any:
        # Stored as a config entry of a reserved kind (the reference has
        # a dedicated autopilot-config table; one-row table ≡ one entry).
        cfg = dict(body["config"])
        cfg["kind"] = "autopilot-config"
        cfg["name"] = "global"
        if body.get("cas"):
            existing = self.store.config_entry_get("autopilot-config", "global")[1]
            have = existing["modify_index"] if existing else 0
            if have != int(body.get("modify_index", 0)):
                return False
        self.store.config_entry_set(idx, cfg)
        return True

    def _apply_intention(self, idx: int, body: dict) -> Any:
        """fsm intention ops (commands_oss.go applyIntentionOperation)."""
        op = body["op"]
        if op in ("create", "update"):
            self.store.intention_set(idx, body["intention"])
            return body["intention"]["id"]
        if op == "delete":
            return self.store.intention_delete(idx, body["intention"]["id"])
        raise ValueError(f"invalid intention operation {op!r}")

    def _apply_connect_ca(self, idx: int, body: dict) -> Any:
        """CA root records replicated through raft (connect_ca ops)."""
        if body.get("op") == "set-root":
            self.store.ca_root_set(idx, body["root"])
            return True
        raise ValueError(f"invalid connect-ca operation {body.get('op')!r}")

    def _apply_snapshot_restore(self, idx: int, body: dict) -> Any:
        """Install a user snapshot on every replica at the same log
        position (snapshot_endpoint.go Restore -> raft.Restore)."""
        self.restore(body["state"])
        return True

    def _apply_acl_token_set(self, idx: int, body: dict) -> Any:
        self.store.acl_token_set(idx, body["token"])
        return True

    def _apply_acl_token_delete(self, idx: int, body: dict) -> Any:
        return self.store.acl_token_delete(idx, body["secret_id"])

    def _apply_acl_policy_set(self, idx: int, body: dict) -> Any:
        self.store.acl_policy_set(idx, body["policy"])
        return True

    def _apply_acl_policy_delete(self, idx: int, body: dict) -> Any:
        return self.store.acl_policy_delete(idx, body["id"])

    def _apply_acl_role_set(self, idx: int, body: dict) -> Any:
        self.store.acl_role_set(idx, body["role"])
        return True

    def _apply_acl_role_delete(self, idx: int, body: dict) -> Any:
        return self.store.acl_role_delete(idx, body["id"])

    def _apply_acl_binding_rule_set(self, idx: int, body: dict) -> Any:
        self.store.acl_binding_rule_set(idx, body["rule"])
        return True

    def _apply_acl_binding_rule_delete(self, idx: int, body: dict) -> Any:
        return self.store.acl_binding_rule_delete(idx, body["id"])

    def _apply_acl_auth_method_set(self, idx: int, body: dict) -> Any:
        self.store.acl_auth_method_set(idx, body["method"])
        return True

    def _apply_acl_auth_method_delete(self, idx: int, body: dict) -> Any:
        return self.store.acl_auth_method_delete(idx, body["name"])

    def _apply_federation_state(self, idx: int, body: dict) -> Any:
        """fsm/commands_oss.go applyFederationStateOperation."""
        op = body["op"]
        state = body.get("state") or {}
        if not state.get("datacenter"):
            raise ValueError("federation state must name a datacenter")
        if op == "upsert":
            self.store.federation_state_set(idx, state)
            return True
        if op == "delete":
            return self.store.federation_state_delete(
                idx, state["datacenter"]
            )
        raise ValueError(f"invalid federation state operation {op!r}")

    def _apply_config_entry(self, idx: int, body: dict) -> Any:
        op = body["op"]
        entry = body.get("entry") or {}
        if op in ("set", "upsert"):
            self.store.config_entry_set(idx, entry)
            return True
        if op == "cas":
            existing = self.store.config_entry_get(entry["kind"], entry["name"])[1]
            have = existing["modify_index"] if existing else 0
            if have != int(body.get("modify_index", 0)):
                return False
            self.store.config_entry_set(idx, entry)
            return True
        if op == "delete":
            return self.store.config_entry_delete(idx, entry["kind"], entry["name"])
        raise ValueError(f"invalid config entry operation {op!r}")
