"""Async HTTP client for the agent API (reference ``api/api.go``); the
port's copy of ``consul_tpu/api/client.py``.

Raw asyncio sockets — the image ships no HTTP client library.  Every
read returns ``(data, QueryMeta)`` where the meta carries the
X-Consul-Index for blocking follow-ups, mirroring the Go client's
``(result, *QueryMeta, error)`` signatures.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import urllib.parse
from typing import Any, Optional


class APIError(Exception):
    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


@dataclasses.dataclass
class QueryMeta:
    index: int = 0
    known_leader: bool = True
    last_contact: float = 0.0


@dataclasses.dataclass
class QueryOptions:
    """Read options serialized as query params (api/api.go QueryOptions)."""

    index: int = 0
    wait: str = ""
    stale: bool = False
    consistent: bool = False

    def params(self) -> dict:
        out: dict = {}
        if self.index:
            out["index"] = str(self.index)
        if self.wait:
            out["wait"] = self.wait
        if self.stale:
            out["stale"] = ""
        if self.consistent:
            out["consistent"] = ""
        return out


class ConsulClient:
    """api.Client: one agent HTTP address, namespaced accessors."""

    def __init__(self, addr: str = "127.0.0.1:8500", token: str = ""):
        self.addr = addr.removeprefix("http://")
        self.token = token  # api.Config.Token -> X-Consul-Token header
        self.kv = KV(self)
        self.catalog = Catalog(self)
        self.health = Health(self)
        self.agent = AgentAPI(self)
        self.session = Session(self)
        self.event = EventAPI(self)
        self.status = StatusAPI(self)
        self.query = PreparedQueryAPI(self)
        self.operator = Operator(self)
        self.coordinate = Coordinate(self)
        self.txn = Txn(self)
        self.config = ConfigAPI(self)
        self.acl = ACLAPI(self)

    def _host_port(self) -> tuple[str, int]:
        host, _, port = self.addr.rpartition(":")
        if not host or not port.isdigit():
            return self.addr, 8500
        return host, int(port)

    async def stream(self, path: str):
        """GET a chunked-streaming endpoint (/v1/agent/monitor), yielding
        raw body chunks until the server ends the stream."""
        host, port = self._host_port()
        reader, writer = await asyncio.open_connection(host, port)
        try:
            token_hdr = (
                f"X-Consul-Token: {self.token}\r\n" if self.token else ""
            )
            writer.write(
                f"GET {path} HTTP/1.1\r\nHost: {host}\r\n{token_hdr}\r\n"
                .encode())
            await writer.drain()
            status = int((await reader.readline()).split()[1])
            while (await reader.readline()) not in (b"\r\n", b""):
                pass
            if status != 200:
                raise APIError(status, path)
            while True:
                size_line = await reader.readline()
                if not size_line:
                    return
                size = int(size_line.strip() or b"0", 16)
                if size == 0:
                    return
                chunk = await reader.readexactly(size)
                await reader.readexactly(2)  # trailing CRLF
                yield chunk
        finally:
            writer.close()

    # -- raw request -----------------------------------------------------

    async def request(
        self,
        method: str,
        path: str,
        params: Optional[dict] = None,
        body: Any = None,
        raw_body: Optional[bytes] = None,
        timeout: float = 610.0,
    ) -> tuple[int, dict, Any]:
        if params:
            path = path + "?" + urllib.parse.urlencode(params)
        payload = raw_body if raw_body is not None else (
            json.dumps(body).encode() if body is not None else b""
        )
        host, port = self.addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            token_hdr = (
                f"X-Consul-Token: {self.token}\r\n" if self.token else ""
            )
            head = (
                f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
                f"Content-Length: {len(payload)}\r\n{token_hdr}"
                f"Connection: close\r\n\r\n"
            )
            writer.write(head.encode() + payload)
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), timeout)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
        header_blob, _, resp_body = raw.partition(b"\r\n\r\n")
        lines = header_blob.decode().split("\r\n")
        status = int(lines[0].split()[1])
        headers = {}
        for line in lines[1:]:
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        if headers.get("content-type", "").startswith("application/json"):
            data = json.loads(resp_body) if resp_body.strip() else None
        else:
            data = resp_body
        return status, headers, data

    async def read(
        self, path: str, params: Optional[dict] = None,
        opts: Optional[QueryOptions] = None, allow_404: bool = True,
    ) -> tuple[Any, QueryMeta]:
        params = dict(params or {})
        if opts:
            params.update(opts.params())
        status, headers, data = await self.request("GET", path, params)
        meta = QueryMeta(
            index=int(headers.get("x-consul-index", 0) or 0),
            known_leader=headers.get("x-consul-knownleader", "true") == "true",
            last_contact=float(headers.get("x-consul-lastcontact", 0) or 0),
        )
        if status == 404 and allow_404:
            return None, meta
        if status >= 400:
            raise APIError(status, str(data))
        return data, meta

    async def write(self, method: str, path: str,
                    params: Optional[dict] = None, body: Any = None,
                    raw_body: Optional[bytes] = None) -> Any:
        status, _, data = await self.request(method, path, params, body,
                                             raw_body)
        if status >= 400:
            raise APIError(status, str(data))
        return data


class _NS:
    def __init__(self, client: ConsulClient):
        self.c = client


class KV(_NS):
    async def get(self, key: str, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read(f"/v1/kv/{key}", opts=opts)
        if not data:
            return None, meta
        entry = data[0]
        entry["Value"] = base64.b64decode(entry.get("Value") or "")
        return entry, meta

    async def list(self, prefix: str, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read(f"/v1/kv/{prefix}",
                                       {"recurse": ""}, opts)
        for entry in data or []:
            entry["Value"] = base64.b64decode(entry.get("Value") or "")
        return data or [], meta

    async def keys(self, prefix: str, separator: str = "",
                   opts: Optional[QueryOptions] = None):
        params = {"keys": ""}
        if separator:
            params["separator"] = separator
        data, meta = await self.c.read(f"/v1/kv/{prefix}", params, opts)
        return data or [], meta

    async def put(self, key: str, value: bytes, flags: int = 0,
                  cas: Optional[int] = None, acquire: str = "",
                  release: str = "") -> bool:
        params: dict = {}
        if flags:
            params["flags"] = str(flags)
        if cas is not None:
            params["cas"] = str(cas)
        if acquire:
            params["acquire"] = acquire
        if release:
            params["release"] = release
        return await self.c.write("PUT", f"/v1/kv/{key}", params,
                                  raw_body=value)

    async def delete(self, key: str, recurse: bool = False,
                     cas: Optional[int] = None) -> bool:
        params: dict = {}
        if recurse:
            params["recurse"] = ""
        if cas is not None:
            params["cas"] = str(cas)
        return await self.c.write("DELETE", f"/v1/kv/{key}", params)


class Catalog(_NS):
    async def datacenters(self):
        data, _ = await self.c.read("/v1/catalog/datacenters")
        return data or []

    async def nodes(self, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read("/v1/catalog/nodes", opts=opts)
        return data or [], meta

    async def services(self, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read("/v1/catalog/services", opts=opts)
        return data or {}, meta

    async def service(self, name: str, tag: str = "",
                      opts: Optional[QueryOptions] = None):
        params = {"tag": tag} if tag else {}
        data, meta = await self.c.read(f"/v1/catalog/service/{name}",
                                       params, opts)
        return data or [], meta

    async def node(self, name: str, opts: Optional[QueryOptions] = None):
        return await self.c.read(f"/v1/catalog/node/{name}", opts=opts)

    async def register(self, reg: dict) -> Any:
        return await self.c.write("PUT", "/v1/catalog/register", body=reg)

    async def deregister(self, dereg: dict) -> Any:
        return await self.c.write("PUT", "/v1/catalog/deregister", body=dereg)


class Health(_NS):
    async def node(self, node: str, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read(f"/v1/health/node/{node}", opts=opts)
        return data or [], meta

    async def checks(self, service: str, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read(f"/v1/health/checks/{service}",
                                       opts=opts)
        return data or [], meta

    async def service(self, name: str, tag: str = "", passing: bool = False,
                      opts: Optional[QueryOptions] = None):
        params: dict = {}
        if tag:
            params["tag"] = tag
        if passing:
            params["passing"] = ""
        data, meta = await self.c.read(f"/v1/health/service/{name}",
                                       params, opts)
        return data or [], meta

    async def state(self, state: str, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read(f"/v1/health/state/{state}", opts=opts)
        return data or [], meta


class AgentAPI(_NS):
    async def self(self):
        data, _ = await self.c.read("/v1/agent/self")
        return data

    async def members(self):
        data, _ = await self.c.read("/v1/agent/members")
        return data or []

    async def services(self):
        data, _ = await self.c.read("/v1/agent/services")
        return data or {}

    async def checks(self):
        data, _ = await self.c.read("/v1/agent/checks")
        return data or {}

    async def join(self, addr: str):
        return await self.c.write("PUT", f"/v1/agent/join/{addr}")

    async def force_leave(self, node: str):
        import urllib.parse as _up

        return await self.c.write(
            "PUT", f"/v1/agent/force-leave/{_up.quote(node, safe='')}"
        )

    async def leave(self):
        return await self.c.write("PUT", "/v1/agent/leave")

    async def service_register(self, svc: dict):
        return await self.c.write("PUT", "/v1/agent/service/register",
                                  body=svc)

    async def service_deregister(self, sid: str):
        return await self.c.write("PUT", f"/v1/agent/service/deregister/{sid}")

    async def check_register(self, check: dict):
        return await self.c.write("PUT", "/v1/agent/check/register",
                                  body=check)

    async def check_deregister(self, cid: str):
        return await self.c.write("PUT", f"/v1/agent/check/deregister/{cid}")

    async def pass_ttl(self, cid: str, note: str = ""):
        return await self.c.write("PUT", f"/v1/agent/check/pass/{cid}",
                                  {"note": note} if note else None)

    async def warn_ttl(self, cid: str, note: str = ""):
        return await self.c.write("PUT", f"/v1/agent/check/warn/{cid}",
                                  {"note": note} if note else None)

    async def fail_ttl(self, cid: str, note: str = ""):
        return await self.c.write("PUT", f"/v1/agent/check/fail/{cid}",
                                  {"note": note} if note else None)


class Session(_NS):
    async def create(self, sess: Optional[dict] = None) -> str:
        out = await self.c.write("PUT", "/v1/session/create", body=sess or {})
        return out["ID"]

    async def destroy(self, sid: str):
        return await self.c.write("PUT", f"/v1/session/destroy/{sid}")

    async def renew(self, sid: str):
        return await self.c.write("PUT", f"/v1/session/renew/{sid}")

    async def info(self, sid: str, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read(f"/v1/session/info/{sid}", opts=opts)
        return (data[0] if data else None), meta

    async def list(self, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read("/v1/session/list", opts=opts)
        return data or [], meta

    async def node(self, node: str, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read(f"/v1/session/node/{node}", opts=opts)
        return data or [], meta


class EventAPI(_NS):
    async def fire(self, name: str, payload: bytes = b"") -> dict:
        return await self.c.write("PUT", f"/v1/event/fire/{name}",
                                  raw_body=payload)

    async def list(self, name: str = "",
                   opts: Optional[QueryOptions] = None):
        params = {"name": name} if name else {}
        data, meta = await self.c.read("/v1/event/list", params, opts)
        for e in data or []:
            if e.get("Payload"):
                e["Payload"] = base64.b64decode(e["Payload"])
        return data or [], meta


class StatusAPI(_NS):
    async def leader(self) -> str:
        data, _ = await self.c.read("/v1/status/leader")
        return data or ""

    async def peers(self) -> list:
        data, _ = await self.c.read("/v1/status/peers")
        return data or []


class PreparedQueryAPI(_NS):
    async def create(self, query: dict) -> str:
        out = await self.c.write("POST", "/v1/query", body=query)
        return out["ID"]

    async def get(self, qid: str):
        data, meta = await self.c.read(f"/v1/query/{qid}")
        return (data[0] if data else None), meta

    async def list(self):
        data, meta = await self.c.read("/v1/query")
        return data or [], meta

    async def update(self, qid: str, query: dict):
        return await self.c.write("PUT", f"/v1/query/{qid}", body=query)

    async def delete(self, qid: str):
        return await self.c.write("DELETE", f"/v1/query/{qid}")

    async def execute(self, qid: str):
        data, meta = await self.c.read(f"/v1/query/{qid}/execute",
                                       allow_404=False)
        return data, meta


class Operator(_NS):
    async def raft_configuration(self):
        data, _ = await self.c.read("/v1/operator/raft/configuration")
        return data

    async def autopilot_health(self):
        data, _ = await self.c.read("/v1/operator/autopilot/health")
        return data


class Coordinate(_NS):
    async def nodes(self, opts: Optional[QueryOptions] = None):
        data, meta = await self.c.read("/v1/coordinate/nodes", opts=opts)
        return data or [], meta

    async def node(self, node: str):
        data, meta = await self.c.read(f"/v1/coordinate/node/{node}")
        return data or [], meta


class Txn(_NS):
    async def apply(self, ops: list[dict]):
        """ops use the HTTP shape: {"KV": {"Verb": ..., "Key": ...,
        "Value": b"..."}} — bytes values are base64'd here."""
        wire_ops = []
        for op in ops:
            op = json.loads(json.dumps(op, default=_b64))
            wire_ops.append(op)
        status, _, data = await self.c.request("PUT", "/v1/txn",
                                               body=wire_ops)
        if status >= 400 and status != 409:
            raise APIError(status, str(data))
        return data


class ConfigAPI(_NS):
    async def apply(self, entry: dict):
        return await self.c.write("PUT", "/v1/config", body=entry)

    async def get(self, kind: str, name: str):
        data, meta = await self.c.read(f"/v1/config/{kind}/{name}")
        return data, meta

    async def list(self, kind: str):
        data, meta = await self.c.read(f"/v1/config/{kind}")
        return data or [], meta

    async def delete(self, kind: str, name: str):
        return await self.c.write("DELETE", f"/v1/config/{kind}/{name}")


def _b64(obj):
    if isinstance(obj, bytes):
        return base64.b64encode(obj).decode()
    raise TypeError(type(obj))


class ACLAPI(_NS):
    """api/acl.go: token/policy CRUD + bootstrap."""

    async def bootstrap(self) -> dict:
        return await self.c.write("PUT", "/v1/acl/bootstrap")

    async def token_create(self, token: dict) -> dict:
        return await self.c.write("PUT", "/v1/acl/token", body=token)

    async def token_list(self) -> list:
        data, _ = await self.c.read("/v1/acl/tokens")
        return data or []

    async def token_read(self, secret_id: str) -> dict:
        data, _ = await self.c.read(f"/v1/acl/token/{secret_id}")
        return data

    async def token_delete(self, secret_id: str):
        return await self.c.write("DELETE", f"/v1/acl/token/{secret_id}")

    async def policy_create(self, policy: dict) -> dict:
        return await self.c.write("PUT", "/v1/acl/policy", body=policy)

    async def policy_list(self) -> list:
        data, _ = await self.c.read("/v1/acl/policies")
        return data or []

    async def policy_read(self, pid: str) -> dict:
        data, _ = await self.c.read(f"/v1/acl/policy/{pid}")
        return data

    async def policy_delete(self, pid: str):
        return await self.c.write("DELETE", f"/v1/acl/policy/{pid}")

    # api/acl.go: RoleCreate/RoleList/..., AuthMethod*, BindingRule*,
    # Login/Logout.

    async def role_create(self, role: dict) -> dict:
        return await self.c.write("PUT", "/v1/acl/role", body=role)

    async def role_list(self) -> list:
        data, _ = await self.c.read("/v1/acl/roles")
        return data or []

    async def role_read(self, rid: str = "", name: str = "") -> dict:
        path = f"/v1/acl/role/name/{name}" if name else f"/v1/acl/role/{rid}"
        data, _ = await self.c.read(path)
        return data

    async def role_delete(self, rid: str):
        return await self.c.write("DELETE", f"/v1/acl/role/{rid}")

    async def auth_method_create(self, method: dict) -> dict:
        return await self.c.write("PUT", "/v1/acl/auth-method", body=method)

    async def auth_method_list(self) -> list:
        data, _ = await self.c.read("/v1/acl/auth-methods")
        return data or []

    async def auth_method_read(self, name: str) -> dict:
        data, _ = await self.c.read(f"/v1/acl/auth-method/{name}")
        return data

    async def auth_method_delete(self, name: str):
        return await self.c.write("DELETE", f"/v1/acl/auth-method/{name}")

    async def binding_rule_create(self, rule: dict) -> dict:
        return await self.c.write("PUT", "/v1/acl/binding-rule", body=rule)

    async def binding_rule_list(self, auth_method: str = "") -> list:
        path = "/v1/acl/binding-rules"
        if auth_method:
            path += f"?authmethod={auth_method}"
        data, _ = await self.c.read(path)
        return data or []

    async def binding_rule_read(self, rid: str) -> dict:
        data, _ = await self.c.read(f"/v1/acl/binding-rule/{rid}")
        return data

    async def binding_rule_delete(self, rid: str):
        return await self.c.write("DELETE", f"/v1/acl/binding-rule/{rid}")

    async def login(self, auth_method: str, bearer_token: str,
                    meta: Optional[dict] = None) -> dict:
        return await self.c.write("POST", "/v1/acl/login", body={
            "AuthMethod": auth_method,
            "BearerToken": bearer_token,
            "Meta": meta or {},
        })

    async def logout(self) -> bool:
        return await self.c.write("POST", "/v1/acl/logout")
