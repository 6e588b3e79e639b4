"""The HTTP API: ``/v1/...`` endpoints over a hand-rolled asyncio
HTTP/1.1 server (no web framework in the image); the port's copy of
``consul_tpu/agent/http.py``.

Equivalent of ``agent/http.go`` + the ``agent/*_endpoint.go`` handlers
registered in ``http_register.go:1-125``.  Behaviors kept from the
reference:

  blocking queries    ?index=N&wait=10s → min_query_index/max_query_time;
                      results carry X-Consul-Index /
                      X-Consul-KnownLeader / X-Consul-LastContact
                      (http.go setMeta)
  consistency modes   ?stale / ?consistent (http.go parseConsistency)
  KV flags            ?recurse ?keys ?separator ?raw ?cas ?flags
                      ?acquire ?release (kvs_endpoint.go)
  JSON shape          CamelCase keys with ID/TTL/... acronyms upper-cased
                      (structs' JSON tags); KV Value base64-encoded
  errors              405 with Allow header, 404 unknown route,
                      400 malformed input, 500 with error text

The server binds a plain TCP port; send requests with any HTTP client.
"""

from __future__ import annotations

import asyncio
import base64
import functools
import gzip
import json
import logging
import re
import urllib.parse
from typing import Any, Callable, Optional

from consul_tpu_torch.agent.agent import Agent
from consul_tpu_torch.agent.bexpr import FilterError
from consul_tpu_torch.agent.rpc import (
    ERR_ACL_NOT_FOUND,
    ERR_PERMISSION_DENIED,
    RPCError,
)
from consul_tpu_torch.agent.server import _parse_ttl
from consul_tpu_torch.telemetry import metrics
from consul_tpu_torch.version import __version__

log = logging.getLogger("consul_tpu_torch.http")

_STATUS_TEXT = {200: "OK", 307: "Temporary Redirect",
                400: "Bad Request", 403: "Forbidden",
                404: "Not Found", 405: "Method Not Allowed",
                500: "Internal Server Error"}

_ACRONYMS = {
    "Id": "ID", "Ttl": "TTL", "Dns": "DNS", "Http": "HTTP", "Tcp": "TCP",
    "Rpc": "RPC", "Wan": "WAN", "Lan": "LAN", "Cas": "CAS", "Acl": "ACL",
    "Pem": "PEM", "Uri": "URI", "Ca": "CA",
}


@functools.lru_cache(maxsize=4096)
def _camel_key(key: str) -> str:
    # Memoized: response shapes reuse a small fixed key vocabulary, and
    # key camelization dominated the hot read path before caching.
    parts = [p.capitalize() for p in key.split("_")]
    parts = [_ACRONYMS.get(p, p) for p in parts]
    return "".join(parts)


class KeyedMap(dict):
    """A dict whose keys are DATA (service names, check ids, kv keys),
    not struct fields — camelize leaves the keys alone."""


def camelize(obj: Any) -> Any:
    """snake_case dict keys → the reference's CamelCase JSON shape."""
    if isinstance(obj, KeyedMap):
        return {k: camelize(v) for k, v in obj.items()}
    if isinstance(obj, dict):
        return {_camel_key(k): camelize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [camelize(v) for v in obj]
    if isinstance(obj, bytes):
        return base64.b64encode(obj).decode()
    return obj


class HTTPRequest:
    def __init__(self, method: str, path: str, query: dict, headers: dict,
                 body: bytes):
        self.method = method
        self.path = path
        self.query = query  # first-value dict
        self.headers = headers
        self.body = body

    def flag(self, name: str) -> bool:
        """?stale style presence flag (http.go parseQuery)."""
        return name in self.query

    def json(self) -> Any:
        if not self.body:
            return {}
        return json.loads(self.body)

    def token(self) -> str:
        """http.go parseToken: ?token= beats the X-Consul-Token header."""
        return self.query.get("token") or self.headers.get(
            "x-consul-token", ""
        )

    def dc_option(self) -> dict:
        """http.go parseDC + parseToken apply to WRITES as well as
        reads — splat this into every RPC write body so cross-DC
        forwarding and ACL enforcement engage (rpc.go:577)."""
        out: dict = {}
        if "dc" in self.query:
            out["dc"] = self.query["dc"]
        tok = self.token()
        if tok:
            out["token"] = tok
        return out

    def query_options(self) -> dict:
        """Blocking/consistency params → RPC body fields
        (http.go parseWait/parseConsistency)."""
        opts: dict = {}
        if "dc" in self.query:
            # http.go parseDC: target datacenter; the RPC layer forwards
            # over the WAN when it differs from the local DC.
            opts["dc"] = self.query["dc"]
        tok = self.token()
        if tok:
            opts["token"] = tok
        if "index" in self.query:
            opts["min_query_index"] = int(self.query["index"])
        if "wait" in self.query:
            opts["max_query_time"] = _parse_ttl(self.query["wait"])
        if self.flag("stale"):
            opts["allow_stale"] = True
        if self.flag("consistent"):
            opts["require_consistent"] = True
        return opts


class HTTPResponse:
    def __init__(self, status: int = 200, body: Any = None,
                 headers: Optional[dict] = None, raw: Optional[bytes] = None,
                 stream=None):
        self.status = status
        self.body = body
        self.headers = headers or {}
        self.raw = raw
        # Async iterator of bytes → Transfer-Encoding: chunked response
        # (the /v1/agent/monitor live feed).
        self.stream = stream


def _meta_headers(meta: Optional[dict]) -> dict:
    if not meta:
        return {}
    return {
        "X-Consul-Index": str(meta.get("index", 0)),
        "X-Consul-KnownLeader": "true" if meta.get("known_leader", True) else "false",
        "X-Consul-LastContact": str(int(meta.get("last_contact", 0))),
    }


class HTTPApi:
    """Routing + handlers (http.go:105-115 wrap/handle)."""

    def __init__(self, agent: Agent):
        self.agent = agent
        # (method, regex) -> handler(req, match) routes, first match wins.
        self.routes: list[tuple[str, re.Pattern, Callable]] = []
        self._route_buckets: dict[str, list] = {}
        self._register_routes()
        self._server: Optional[asyncio.AbstractServer] = None
        self.addr = ""

    # -- lifecycle ------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._conn_tasks: set[asyncio.Task] = set()

        async def tracked(reader, writer):
            task = asyncio.current_task()
            self._conn_tasks.add(task)
            try:
                await self._handle_conn(reader, writer)
            finally:
                self._conn_tasks.discard(task)

        self._server = await asyncio.start_server(tracked, host, port)
        h, p = self._server.sockets[0].getsockname()[:2]
        self.addr = f"{h}:{p}"
        return self.addr

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # Cancel in-flight handlers: a longpolling client (blocking
            # query, proxy config feed) would otherwise pin
            # wait_closed() for its full wait window.
            for task in list(getattr(self, "_conn_tasks", ())):
                task.cancel()
            try:
                await self._server.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    # -- HTTP plumbing --------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                resp = await self._dispatch(req)
                await self._write_response(writer, req, resp, reader=reader)
                if req.headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001
            log.exception("http connection handler failed")
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _read_request(self, reader) -> Optional[HTTPRequest]:
        # One readuntil for the whole head (request line + headers):
        # measurably faster than a readline loop on keep-alive
        # connections, where header parsing is per-request overhead.
        # CRLF line endings required (RFC 9112 §2.2 — bare-LF requests
        # are not recognized).
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            return None
        if not head:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split()
        except ValueError:
            return None
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        body = b""
        if "content-length" in headers:
            body = await reader.readexactly(int(headers["content-length"]))
        path, _, qs = target.partition("?")
        query: dict[str, str] = {}
        if qs:
            if "%" not in qs and "+" not in qs:
                # Fast path: no percent/plus escapes to decode —
                # first-value-wins like parse_qs below.
                for part in qs.split("&"):
                    k, _, v = part.partition("=")
                    if k and k not in query:
                        query[k] = v
            else:
                query = {
                    k: v[0] for k, v in urllib.parse.parse_qs(
                        qs, keep_blank_values=True
                    ).items()
                }
        # Go's net/http serves the decoded URL.Path; %2F in a KV key
        # must reach the store as '/'.
        if "%" in path:
            path = urllib.parse.unquote(path)
        return HTTPRequest(method, path, query, headers, body)

    async def _write_response(self, writer, req: HTTPRequest,
                              resp: HTTPResponse, reader=None) -> None:
        if resp.stream is not None:
            return await self._write_chunked(writer, resp, reader)
        if resp.raw is not None:
            payload = resp.raw
            ctype = "application/octet-stream"
        else:
            out = camelize(resp.body)
            if req.query and req.flag("pretty"):
                payload = (json.dumps(out, indent=4) + "\n").encode()
            else:
                payload = (json.dumps(out, separators=(",", ":"))
                           + "\n").encode()
            ctype = "application/json"
        status_text = _STATUS_TEXT.get(resp.status, "OK")
        encoding = ""
        if (
            "gzip" in req.headers.get("accept-encoding", "")
            and len(payload) >= 256
        ):
            # http.go wraps handlers in gziphandler for the same cutoff
            # class of responses.
            payload = gzip.compress(payload)
            encoding = "gzip"
        # A handler-supplied Content-Type overrides the default (single
        # Content-Type per RFC 9110).
        extra = dict(resp.headers)
        ctype = extra.pop("Content-Type", ctype)
        head = [f"HTTP/1.1 {resp.status} {status_text}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(payload)}"]
        if encoding:
            head.append(f"Content-Encoding: {encoding}")
        for k, v in extra.items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
        await writer.drain()

    async def _write_chunked(self, writer, resp: HTTPResponse,
                             reader=None) -> None:
        """Stream an async byte iterator as a chunked response
        (agent_endpoint.go AgentMonitor's flushing writer).  The
        connection closes when the stream ends or the client hangs up —
        a live feed has no meaningful keep-alive continuation."""
        head = [f"HTTP/1.1 {resp.status} {_STATUS_TEXT.get(resp.status, 'OK')}",
                "Content-Type: "
                + resp.headers.get("Content-Type", "text/plain"),
                "Transfer-Encoding: chunked",
                "Connection: close"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
        await writer.drain()
        try:
            async for chunk in resp.stream:
                # Empty chunks are liveness ticks from the stream: a
                # cleanly-closed client delivers EOF on the read side
                # (a FIN alone never flips writer.is_closing), so check
                # the reader to tear down while the stream is quiet.
                if writer.is_closing() or (
                    reader is not None and reader.at_eof()
                ):
                    break
                if not chunk:
                    continue
                writer.write(f"{len(chunk):x}\r\n".encode()
                             + chunk + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            if hasattr(resp.stream, "aclose"):
                await resp.stream.aclose()
            writer.close()

    async def _dispatch(self, req: HTTPRequest) -> HTTPResponse:
        import time as _time

        metrics().incr_counter(f"http.{req.method}")
        _t0 = _time.monotonic()
        try:
            return await self._dispatch_inner(req)
        finally:
            metrics().measure_since("http.request", _t0)

    async def _dispatch_inner(self, req: HTTPRequest) -> HTTPResponse:
        path_matched = False
        bucket, catchall = self._route_candidates(req.path)
        for method, pattern, handler in (*bucket, *catchall):
            m = pattern.match(req.path)
            if not m:
                continue
            path_matched = True
            if method != req.method:
                continue
            try:
                resp = await handler(req, m)
                # ?filter= bexpr filtering on list results (http.go
                # parseFilter → go-bexpr), evaluated against the
                # camelized row shape the client sees.
                if "filter" in req.query and isinstance(resp.body, list):
                    from consul_tpu_torch.agent.bexpr import create_filter

                    flt = create_filter(req.query["filter"])
                    resp.body = [
                        row
                        for row, crow in zip(resp.body, camelize(resp.body))
                        if flt.match(crow)
                    ]
                return resp
            except FilterError as e:
                return HTTPResponse(400, {"error": f"bad filter: {e}"})
            except RPCError as e:
                # http.go:1067-1080: ACL failures are 403s, the rest of
                # the RPC error space is a 500.
                msg = str(e)
                if msg in (ERR_PERMISSION_DENIED, ERR_ACL_NOT_FOUND):
                    return HTTPResponse(403, {"error": msg})
                return HTTPResponse(500, {"error": msg})
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                return HTTPResponse(400, {"error": f"{type(e).__name__}: {e}"})
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                log.exception("handler error for %s %s", req.method, req.path)
                return HTTPResponse(500, {"error": str(e)})
        if path_matched:
            allowed = sorted({m for m, p, _ in self.routes if p.match(req.path)})
            return HTTPResponse(405, {"error": "method not allowed"},
                                headers={"Allow": ", ".join(allowed)})
        return HTTPResponse(404, {"error": f"no handler for {req.path}"})

    # -- route table (http_register.go) --------------------------------

    def _route(self, method: str, pattern: str, handler: Callable) -> None:
        compiled = re.compile(pattern + r"$")
        self.routes.append((method, compiled, handler))
        # Prefix-bucketed dispatch: the route table is ~100 entries and
        # a linear regex scan per request dominated the KV hot path
        # (~33 pattern.match calls/request).  Bucket by the static
        # "/v1/<segment>" prefix; dispatch looks up the bucket and scans
        # only its handful of candidates.  Routes whose second segment
        # is not static land in the catch-all bucket, always scanned.
        static = pattern
        for i, ch in enumerate(pattern):
            if ch in "([?*+.\\^$|{":
                static = pattern[:i]
                break
        parts = static.split("/")
        if static == pattern and len(parts) >= 3:
            key = "/".join(parts[:3])       # fully-literal route
        elif len(parts) >= 4:
            key = "/".join(parts[:3])       # second segment complete
        else:
            key = ""                        # dynamic early — always scan
        self._route_buckets.setdefault(key, []).append(
            (method, compiled, handler)
        )

    def _route_candidates(self, path: str):
        first = path.find("/", 1)
        second = path.find("/", first + 1) if first != -1 else -1
        key = path[:second] if second != -1 else path
        return self._route_buckets.get(key, ()), \
            self._route_buckets.get("", ())

    def _register_routes(self) -> None:
        r = self._route
        # UI (http.go handleUI when EnableUI; single-page here)
        r("GET", r"/ui(?:/.*)?", self.ui_index)
        r("GET", r"/", self.ui_redirect)
        # status
        r("GET", r"/v1/status/leader", self.status_leader)
        r("GET", r"/v1/status/peers", self.status_peers)
        # agent
        r("PUT", r"/v1/agent/force-leave/(?P<node>.+)",
          self.agent_force_leave)
        r("GET", r"/v1/agent/host", self.agent_host)
        r("GET", r"/v1/agent/metrics", self.agent_metrics)
        r("GET", r"/v1/agent/monitor", self.agent_monitor)
        r("GET", r"/v1/agent/self", self.agent_self)
        r("GET", r"/v1/agent/members", self.agent_members)
        r("GET", r"/v1/agent/segments", self.agent_segments)
        r("GET", r"/v1/agent/services", self.agent_services)
        r("GET", r"/v1/agent/service/(?P<sid>[^/?]+)", self.agent_service)
        r("GET", r"/v1/agent/checks", self.agent_checks)
        r("PUT", r"/v1/agent/join/(?P<addr>.+)", self.agent_join)
        r("PUT", r"/v1/agent/leave", self.agent_leave)
        r("PUT", r"/v1/agent/reload", self.agent_reload)
        r("PUT", r"/v1/agent/maintenance", self.agent_node_maintenance)
        r("PUT", r"/v1/agent/service/maintenance/(?P<sid>[^/?]+)",
          self.agent_service_maintenance)
        r("PUT", r"/v1/agent/service/register", self.agent_service_register)
        r("PUT", r"/v1/agent/service/deregister/(?P<sid>.+)",
          self.agent_service_deregister)
        r("PUT", r"/v1/agent/check/register", self.agent_check_register)
        r("PUT", r"/v1/agent/check/deregister/(?P<cid>.+)",
          self.agent_check_deregister)
        r("PUT", r"/v1/agent/check/pass/(?P<cid>.+)", self.agent_check_pass)
        r("PUT", r"/v1/agent/check/warn/(?P<cid>.+)", self.agent_check_warn)
        r("PUT", r"/v1/agent/check/fail/(?P<cid>.+)", self.agent_check_fail)
        # catalog
        r("GET", r"/v1/catalog/datacenters", self.catalog_datacenters)
        r("GET", r"/v1/catalog/nodes", self.catalog_nodes)
        r("GET", r"/v1/catalog/services", self.catalog_services)
        r("GET", r"/v1/catalog/service/(?P<svc>.+)", self.catalog_service)
        r("GET", r"/v1/catalog/node/(?P<node>.+)", self.catalog_node)
        r("PUT", r"/v1/catalog/register", self.catalog_register)
        r("PUT", r"/v1/catalog/deregister", self.catalog_deregister)
        # health
        r("GET", r"/v1/health/node/(?P<node>.+)", self.health_node)
        r("GET", r"/v1/health/checks/(?P<svc>.+)", self.health_checks)
        r("GET", r"/v1/health/service/(?P<svc>.+)", self.health_service)
        # /v1/health/connect/:service (health_endpoint.go
        # HealthConnectServiceNodes): proxies/native instances FOR the
        # service.
        r("GET", r"/v1/health/connect/(?P<svc>.+)", self.health_connect)
        r("GET", r"/v1/health/state/(?P<state>.+)", self.health_state)
        # kv
        r("GET", r"/v1/kv/(?P<key>.*)", self.kv_get)
        r("PUT", r"/v1/kv/(?P<key>.*)", self.kv_put)
        r("DELETE", r"/v1/kv/(?P<key>.*)", self.kv_delete)
        # sessions
        r("PUT", r"/v1/session/create", self.session_create)
        r("PUT", r"/v1/session/destroy/(?P<sid>.+)", self.session_destroy)
        r("PUT", r"/v1/session/renew/(?P<sid>.+)", self.session_renew)
        r("GET", r"/v1/session/info/(?P<sid>.+)", self.session_info)
        r("GET", r"/v1/session/node/(?P<node>.+)", self.session_node)
        r("GET", r"/v1/session/list", self.session_list)
        # events
        r("PUT", r"/v1/event/fire/(?P<name>.+)", self.event_fire)
        r("GET", r"/v1/event/list", self.event_list)
        # coordinates
        r("GET", r"/v1/coordinate/nodes", self.coordinate_nodes)
        r("GET", r"/v1/coordinate/node/(?P<node>.+)", self.coordinate_node)
        # prepared queries
        r("POST", r"/v1/query", self.query_create)
        r("GET", r"/v1/query/(?P<qid>[^/]+)/execute", self.query_execute)
        r("GET", r"/v1/query/(?P<qid>[^/]+)", self.query_get)
        r("PUT", r"/v1/query/(?P<qid>[^/]+)", self.query_update)
        r("DELETE", r"/v1/query/(?P<qid>[^/]+)", self.query_delete)
        r("GET", r"/v1/query", self.query_list)
        # txn
        r("PUT", r"/v1/txn", self.txn)
        # config entries
        r("PUT", r"/v1/config", self.config_apply)
        # CA rotation (the reference rotates via PUT /v1/connect/ca/
        # configuration provider/key changes; collapsed to an explicit
        # operator verb here).
        r("PUT", r"/v1/connect/ca/rotate", self.connect_ca_rotate)
        # federation states (http_register.go /v1/internal/federation-state*)
        r("GET", r"/v1/internal/federation-states/mesh-gateways",
          self.federation_state_mesh_gateways)
        r("GET", r"/v1/internal/federation-states",
          self.federation_state_list)
        r("GET", r"/v1/internal/federation-state/(?P<dc>[^/?]+)",
          self.federation_state_get)
        # discovery chain (discovery_chain_endpoint.go /v1/discovery-chain/)
        r("GET", r"/v1/discovery-chain/(?P<svc>[^/?]+)",
          self.discovery_chain_get)
        r("POST", r"/v1/discovery-chain/(?P<svc>[^/?]+)",
          self.discovery_chain_get)
        r("GET", r"/v1/config/(?P<kind>[^/]+)/(?P<name>.+)", self.config_get)
        r("GET", r"/v1/config/(?P<kind>[^/]+)", self.config_list)
        r("DELETE", r"/v1/config/(?P<kind>[^/]+)/(?P<name>.+)",
          self.config_delete)
        # operator
        r("GET", r"/v1/operator/raft/configuration", self.operator_raft)
        r("GET", r"/v1/operator/autopilot/health", self.operator_health)
        # connect (http_register.go /v1/connect/* + agent connect)
        r("GET", r"/v1/connect/ca/roots", self.connect_ca_roots)
        r("GET", r"/v1/agent/connect/ca/roots", self.connect_ca_roots)
        r("GET", r"/v1/agent/connect/ca/leaf/(?P<svc>.+)",
          self.connect_ca_leaf)
        r("POST", r"/v1/connect/intentions", self.intention_create)
        r("GET", r"/v1/connect/intentions/check", self.intention_check)
        r("GET", r"/v1/connect/intentions/(?P<iid>.+)", self.intention_get)
        r("GET", r"/v1/connect/intentions", self.intention_list)
        r("PUT", r"/v1/connect/intentions/(?P<iid>.+)", self.intention_update)
        r("DELETE", r"/v1/connect/intentions/(?P<iid>.+)",
          self.intention_delete)
        r("POST", r"/v1/agent/connect/authorize", self.connect_authorize)
        # Built-in proxy config feed (the xDS stand-in): blocking
        # snapshot reads per registered connect-proxy
        # (proxycfg/manager.go via agent_endpoint.go, re-designed as a
        # longpoll JSON endpoint instead of an Envoy gRPC stream).
        r("GET", r"/v1/agent/connect/proxy/(?P<pid>[^/?]+)/xds",
          self.connect_proxy_xds)
        r("GET", r"/v1/agent/connect/proxy/(?P<pid>[^/?]+)",
          self.connect_proxy_config)
        # autopilot (operator_autopilot_endpoint.go)
        r("GET", r"/v1/operator/autopilot/configuration",
          self.operator_autopilot_get)
        r("PUT", r"/v1/operator/autopilot/configuration",
          self.operator_autopilot_set)
        r("GET", r"/v1/operator/autopilot/health",
          self.operator_health)
        # keyring (operator_endpoint.go /v1/operator/keyring)
        r("GET", r"/v1/operator/keyring", self.keyring_list)
        r("POST", r"/v1/operator/keyring", self.keyring_install)
        r("PUT", r"/v1/operator/keyring", self.keyring_use)
        r("DELETE", r"/v1/operator/keyring", self.keyring_remove)
        # snapshot (http_register.go /v1/snapshot)
        r("GET", r"/v1/snapshot", self.snapshot_save)
        r("PUT", r"/v1/snapshot", self.snapshot_restore)
        # acl (http_register.go /v1/acl/*)
        r("PUT", r"/v1/acl/bootstrap", self.acl_bootstrap)
        r("PUT", r"/v1/acl/token", self.acl_token_set)
        r("GET", r"/v1/acl/tokens", self.acl_token_list)
        r("GET", r"/v1/acl/token/(?P<sid>.+)", self.acl_token_read)
        r("DELETE", r"/v1/acl/token/(?P<sid>.+)", self.acl_token_delete)
        r("PUT", r"/v1/acl/policy", self.acl_policy_set)
        r("GET", r"/v1/acl/policies", self.acl_policy_list)
        r("GET", r"/v1/acl/policy/(?P<pid>.+)", self.acl_policy_read)
        r("DELETE", r"/v1/acl/policy/(?P<pid>.+)", self.acl_policy_delete)
        # acl roles / auth methods / binding rules / login
        # (http_register.go /v1/acl/role*, /v1/acl/auth-method*,
        #  /v1/acl/binding-rule*, /v1/acl/login, /v1/acl/logout)
        r("PUT", r"/v1/acl/role", self.acl_role_set)
        r("GET", r"/v1/acl/roles", self.acl_role_list)
        r("GET", r"/v1/acl/role/name/(?P<name>.+)", self.acl_role_read_name)
        r("GET", r"/v1/acl/role/(?P<rid>.+)", self.acl_role_read)
        r("DELETE", r"/v1/acl/role/(?P<rid>.+)", self.acl_role_delete)
        r("PUT", r"/v1/acl/auth-method", self.acl_auth_method_set)
        r("GET", r"/v1/acl/auth-methods", self.acl_auth_method_list)
        r("GET", r"/v1/acl/auth-method/(?P<name>.+)",
          self.acl_auth_method_read)
        r("DELETE", r"/v1/acl/auth-method/(?P<name>.+)",
          self.acl_auth_method_delete)
        r("PUT", r"/v1/acl/binding-rule", self.acl_binding_rule_set)
        r("GET", r"/v1/acl/binding-rules", self.acl_binding_rule_list)
        r("GET", r"/v1/acl/binding-rule/(?P<rid>.+)",
          self.acl_binding_rule_read)
        r("DELETE", r"/v1/acl/binding-rule/(?P<rid>.+)",
          self.acl_binding_rule_delete)
        r("POST", r"/v1/acl/login", self.acl_login)
        r("POST", r"/v1/acl/logout", self.acl_logout)

    # -- helpers --------------------------------------------------------

    async def _acl_check(self, req: HTTPRequest, kind: str, name: str,
                         want: str) -> None:
        """Enforce one permission for agent-local HTTP operations.
        Server agents hold the resolver and check in-process; CLIENT
        agents resolve through their servers (consul/acl.go
        ResolveToken) via Internal.ACLAuthorize — without that hop the
        check would silently no-op exactly where keyring keys and
        force-leave live."""
        delegate = self.agent.delegate
        if hasattr(delegate, "acl_check"):
            delegate.acl_check({"token": req.token()}, kind, name, want)
        elif self.agent.config.acl_enabled:
            out = await self.agent.rpc("Internal.ACLAuthorize", {
                "kind": kind, "name": name, "want": want,
                "token": req.token(),
            })
            if not out.get("allowed"):
                raise RPCError(ERR_PERMISSION_DENIED)

    async def _rpc_read(self, req: HTTPRequest, method: str, body: dict,
                        key: str, unwrap_single: bool = False,
                        row: Optional[Callable] = None) -> HTTPResponse:
        body.update(req.query_options())
        out = await self.agent.rpc(method, body)
        meta = out.get("meta")
        data = out.get(key)
        if row is not None and data is not None:
            data = [row(r) for r in data]
        if unwrap_single:
            data = data[0] if data else None
            if data is None:
                return HTTPResponse(404, None, headers=_meta_headers(meta))
        return HTTPResponse(200, data, headers=_meta_headers(meta))

    async def agent_force_leave(self, req, m) -> HTTPResponse:
        # agent_endpoint.go:499 AgentForceLeave requires operator:write —
        # otherwise any caller can evict members.
        await self._acl_check(req, "operator", "", "write")
        ok = await self.agent.force_leave(m.group("node"))
        if not ok:
            return HTTPResponse(404, {"error": "member not failed"})
        return HTTPResponse(200, True)

    async def agent_host(self, req, m) -> HTTPResponse:
        """/v1/agent/host (agent/debug/host.go:20-40): platform info
        for the debug bundle."""
        import os
        import platform
        import sys as _sys
        import time as _time

        la = os.getloadavg() if hasattr(os, "getloadavg") else (0, 0, 0)
        return HTTPResponse(200, KeyedMap({
            "Host": KeyedMap({
                "Hostname": platform.node(),
                "OS": platform.system().lower(),
                "Platform": platform.platform(),
                "KernelArch": platform.machine(),
                "Uptime": _time.monotonic(),
            }),
            "CPU": KeyedMap({"Count": os.cpu_count(),
                             "LoadAvg": list(la)}),
            "Runtime": KeyedMap({"Python": _sys.version.split()[0]}),
            "CollectionTime": int(_time.time() * 1e9),
        }))

    async def agent_metrics(self, req, m) -> HTTPResponse:
        """/v1/agent/metrics (agent_endpoint.go AgentMetrics): the
        in-memory sink's aggregated view."""
        return HTTPResponse(200, KeyedMap(metrics().snapshot()))

    async def agent_monitor(self, req, m) -> HTTPResponse:
        """/v1/agent/monitor (agent_endpoint.go:1140 AgentMonitor):
        chunked stream of live log lines from the whole consul_tpu_torch
        logger tree at ?loglevel= (default info)."""
        from consul_tpu_torch.agent.monitor import Monitor

        # agent_endpoint.go AgentMonitor: requires agent:read.
        await self._acl_check(
            req, "agent", self.agent.config.node_name, "read")
        try:
            mon = Monitor(req.query.get("loglevel", "info")).start()
        except ValueError as e:
            return HTTPResponse(400, {"error": str(e)})

        async def lines():
            try:
                while True:
                    try:
                        yield await mon.next_line(timeout=5.0)
                    except asyncio.TimeoutError:
                        yield b""  # liveness tick → hang-up detection
            finally:
                dropped = mon.stop()
                if dropped:
                    log.warning("monitor dropped %d log lines", dropped)

        return HTTPResponse(200, stream=lines())

    async def ui_index(self, req, m) -> HTTPResponse:
        from consul_tpu_torch.agent.ui import UI_HTML

        return HTTPResponse(
            200, None, raw=UI_HTML.encode(),
            headers={"Content-Type": "text/html; charset=utf-8"},
        )

    async def ui_redirect(self, req, m) -> HTTPResponse:
        return HTTPResponse(
            307, None, raw=b"", headers={"Location": "/ui"}
        )

    # -- status ---------------------------------------------------------

    async def status_leader(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Status.Leader", {})
        return HTTPResponse(200, out.get("leader", ""))

    async def status_peers(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Status.Peers", {})
        return HTTPResponse(200, [p["addr"] for p in out.get("peers", [])])

    # -- agent ----------------------------------------------------------

    async def agent_self(self, req, m) -> HTTPResponse:
        cfg = self.agent.config
        return HTTPResponse(200, {
            "config": {
                "datacenter": cfg.datacenter,
                "node_name": cfg.node_name,
                "server": cfg.server,
                "version": __version__,
            },
            "member": {
                "name": cfg.node_name,
                "addr": self.agent.serf.memberlist.transport.local_addr(),
                "tags": KeyedMap(self.agent.serf.config.tags),
            },
        })

    async def agent_members(self, req, m) -> HTTPResponse:
        # ?segment= filters one ring; ?segment=_all merges every ring a
        # server bridges (agent_endpoint.go AgentMembers segment param).
        segment = req.query.get("segment", "")
        delegate = self.agent.delegate
        if segment and hasattr(delegate, "segment_serfs"):
            if segment == "_all":
                rows = delegate._all_lan_members()
            else:
                seg = delegate.segment_serfs.get(segment)
                if seg is None:
                    return HTTPResponse(
                        404, {"error": f"unknown segment {segment!r}"})
                rows = list(seg.members.values())
        else:
            rows = list(self.agent.serf.members.values())
        members = [
            {
                "name": mem.name,
                "addr": mem.addr,
                # Serf tag names are data, not struct fields.
                "tags": KeyedMap(mem.tags),
                "status": int(mem.status),
            }
            for mem in rows
        ]
        return HTTPResponse(200, members)

    async def agent_segments(self, req, m) -> HTTPResponse:
        """GET /v1/agent/segments (operator segment listing)."""
        delegate = self.agent.delegate
        names = list(getattr(delegate, "segment_serfs", {}) or {})
        return HTTPResponse(200, [""] + names)

    async def agent_services(self, req, m) -> HTTPResponse:
        return HTTPResponse(200, KeyedMap({
            e.service["id"]: e.service for e in
            self.agent.local.services.values() if not e.deleted
        }))

    async def agent_reload(self, req, m) -> HTTPResponse:
        """PUT /v1/agent/reload (agent_endpoint.go AgentReload): re-read
        config sources, same path as SIGHUP.  Requires agent:write."""
        await self._acl_check(
            req, "agent", self.agent.config.node_name, "write")
        handler = getattr(self.agent, "reload_handler", None)
        if handler is None:
            return HTTPResponse(
                400, {"error": "agent has no reloadable config sources"})
        err = handler()
        if err is not None:
            # AgentReload returns the failure to the caller — a 200 on
            # a rejected config would leave the operator believing the
            # new config is live.
            return HTTPResponse(500, {"error": f"reload failed: {err}"})
        return HTTPResponse(200, True)

    async def agent_node_maintenance(self, req, m) -> HTTPResponse:
        """PUT /v1/agent/maintenance?enable=true|false&reason=...
        (agent_endpoint.go AgentNodeMaintenance)."""
        await self._acl_check(
            req, "node", self.agent.config.node_name, "write")
        enable = req.query.get("enable", "").lower()
        if enable not in ("true", "false"):
            return HTTPResponse(400, {"error": "missing ?enable=true|false"})
        if enable == "true":
            self.agent.enable_node_maintenance(req.query.get("reason", ""))
        else:
            self.agent.disable_node_maintenance()
        return HTTPResponse(200, True)

    async def agent_service_maintenance(self, req, m) -> HTTPResponse:
        """PUT /v1/agent/service/maintenance/:id?enable=...&reason=...
        (agent_endpoint.go AgentServiceMaintenance)."""
        sid = m.group("sid")
        # Lookup first, ACL with the REAL service name second (the
        # reference orders it the same way — a typo'd id is a 404, not
        # a spurious permission-denied on the empty name).
        entry = self.agent.local.services.get(sid)
        if entry is None or entry.deleted:
            return HTTPResponse(404, {"error": f"unknown service id {sid!r}"})
        await self._acl_check(
            req, "service", entry.service.get("service", ""), "write")
        enable = req.query.get("enable", "").lower()
        if enable not in ("true", "false"):
            return HTTPResponse(400, {"error": "missing ?enable=true|false"})
        if enable == "true":
            ok = self.agent.enable_service_maintenance(
                sid, req.query.get("reason", ""))
        else:
            ok = self.agent.disable_service_maintenance(sid)
        if not ok:
            return HTTPResponse(404, {"error": f"unknown service id {sid!r}"})
        return HTTPResponse(200, True)

    async def agent_service(self, req, m) -> HTTPResponse:
        """GET /v1/agent/service/:id (agent_endpoint.go AgentService) —
        one locally registered service, the agent_service watch's
        source."""
        entry = self.agent.local.services.get(m.group("sid"))
        if entry is None or entry.deleted:
            return HTTPResponse(404, {"error": "unknown service id"})
        return HTTPResponse(200, entry.service)

    async def agent_checks(self, req, m) -> HTTPResponse:
        return HTTPResponse(200, KeyedMap({
            e.check["check_id"]: e.check for e in
            self.agent.local.checks.values() if not e.deleted
        }))

    async def agent_join(self, req, m) -> HTTPResponse:
        n = await self.agent.join([m.group("addr")])
        return HTTPResponse(200, {"num_joined": n})

    async def agent_leave(self, req, m) -> HTTPResponse:
        await self.agent.leave()
        return HTTPResponse(200, {})

    async def agent_service_register(self, req, m) -> HTTPResponse:
        defn = _decamelize(req.json())
        checks = defn.pop("checks", None) or (
            [defn.pop("check")] if defn.get("check") else []
        )
        svc = {k: v for k, v in defn.items()
               if k in ("id", "service", "name", "tags", "port", "address",
                        "meta", "kind", "proxy", "connect_native")}
        if "name" in svc:
            svc["service"] = svc.pop("name")
        # Proxy block field spellings (structs.ConnectProxyConfig JSON):
        # DestinationServiceName is accepted as destination_service too.
        proxy = svc.get("proxy")
        if isinstance(proxy, dict) and "destination_service_name" in proxy:
            proxy = dict(proxy)
            proxy["destination_service"] = proxy.pop(
                "destination_service_name")
            svc["proxy"] = proxy
        self.agent.add_service(svc, checks)
        return HTTPResponse(200, {})

    async def agent_service_deregister(self, req, m) -> HTTPResponse:
        self.agent.remove_service(m.group("sid"))
        return HTTPResponse(200, {})

    async def agent_check_register(self, req, m) -> HTTPResponse:
        defn = _decamelize(req.json())
        if "name" in defn and "check_id" not in defn:
            defn["check_id"] = defn["name"]
        self.agent.add_check(defn)
        return HTTPResponse(200, {})

    async def agent_check_deregister(self, req, m) -> HTTPResponse:
        self.agent.remove_check(m.group("cid"))
        return HTTPResponse(200, {})

    async def _ttl_update(self, req, m, status: str) -> HTTPResponse:
        note = req.query.get("note", "")
        if not self.agent.update_ttl_check(m.group("cid"), status, note):
            return HTTPResponse(404, {"error": "unknown TTL check"})
        return HTTPResponse(200, {})

    async def agent_check_pass(self, req, m) -> HTTPResponse:
        return await self._ttl_update(req, m, "passing")

    async def agent_check_warn(self, req, m) -> HTTPResponse:
        return await self._ttl_update(req, m, "warning")

    async def agent_check_fail(self, req, m) -> HTTPResponse:
        return await self._ttl_update(req, m, "critical")

    # -- catalog ---------------------------------------------------------

    async def catalog_datacenters(self, req, m) -> HTTPResponse:
        try:
            out = await self.agent.rpc("Catalog.ListDatacenters", {})
        except RPCError:
            # No reachable server: answer with what we know locally.
            out = {}
        return HTTPResponse(200, out.get("datacenters") or
                            [self.agent.config.datacenter])

    async def catalog_nodes(self, req, m) -> HTTPResponse:
        return await self._rpc_read(req, "Catalog.ListNodes", {}, "nodes")

    async def catalog_services(self, req, m) -> HTTPResponse:
        body: dict = {}
        body.update(req.query_options())
        out = await self.agent.rpc("Catalog.ListServices", body)
        return HTTPResponse(200, KeyedMap(out.get("services") or {}),
                            headers=_meta_headers(out.get("meta")))

    def _service_node_row(self, r: dict) -> dict:
        """Internal service row → ``structs.ServiceNode`` JSON shape
        (camelized downstream: ServiceID/ServiceName/ServicePort/...)."""
        return {
            "id": "",
            "node": r.get("node", ""),
            "address": r.get("node_address", ""),
            "datacenter": self.agent.config.datacenter,
            "node_meta": KeyedMap(r.get("node_meta") or {}),
            "service_id": r.get("id", ""),
            "service_name": r.get("service", ""),
            "service_tags": r.get("tags") or [],
            "service_address": r.get("address", ""),
            "service_meta": KeyedMap(r.get("meta") or {}),
            "service_port": int(r.get("port") or 0),
            "create_index": r.get("create_index", 0),
            "modify_index": r.get("modify_index", 0),
        }

    def _check_service_node_row(self, r: dict) -> dict:
        """Internal health row → ``structs.CheckServiceNode`` JSON shape:
        {Node: {...}, Service: {...}, Checks: [...]}."""
        node = r.get("node") or {}
        svc = r.get("service") or {}
        return {
            "node": {
                "id": "",
                "node": node.get("node", svc.get("node", "")),
                "address": node.get("address", ""),
                "datacenter": self.agent.config.datacenter,
                "meta": KeyedMap(node.get("meta") or {}),
                "create_index": node.get("create_index", 0),
                "modify_index": node.get("modify_index", 0),
            },
            "service": {
                "id": svc.get("id", ""),
                "service": svc.get("service", ""),
                "tags": svc.get("tags") or [],
                "address": svc.get("address", ""),
                "meta": KeyedMap(svc.get("meta") or {}),
                "port": int(svc.get("port") or 0),
                "create_index": svc.get("create_index", 0),
                "modify_index": svc.get("modify_index", 0),
            },
            "checks": r.get("checks") or [],
        }

    async def catalog_service(self, req, m) -> HTTPResponse:
        body = {"service": m.group("svc")}
        if "tag" in req.query:
            body["tag"] = req.query["tag"]
        return await self._rpc_read(req, "Catalog.ServiceNodes", body, "nodes",
                                    row=self._service_node_row)

    async def catalog_node(self, req, m) -> HTTPResponse:
        return await self._rpc_read(
            req, "Internal.NodeInfo", {"node": m.group("node")}, "dump",
            unwrap_single=True,
        )

    async def catalog_register(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc(
            "Catalog.Register", {**_decamelize(req.json()), **req.dc_option()}
        )
        return HTTPResponse(200, out.get("result", True))

    async def catalog_deregister(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc(
            "Catalog.Deregister", {**_decamelize(req.json()), **req.dc_option()}
        )
        return HTTPResponse(200, out.get("result", True))

    # -- health ----------------------------------------------------------

    async def health_node(self, req, m) -> HTTPResponse:
        return await self._rpc_read(
            req, "Health.NodeChecks", {"node": m.group("node")}, "checks"
        )

    async def health_checks(self, req, m) -> HTTPResponse:
        return await self._rpc_read(
            req, "Health.ServiceChecks", {"service": m.group("svc")}, "checks"
        )

    async def health_service(self, req, m) -> HTTPResponse:
        body = {"service": m.group("svc"),
                "passing_only": req.flag("passing")}
        if "tag" in req.query:
            body["tag"] = req.query["tag"]
        return await self._rpc_read(req, "Health.ServiceNodes", body, "nodes",
                                    row=self._check_service_node_row)

    async def health_connect(self, req, m) -> HTTPResponse:
        body = {"service": m.group("svc"), "connect": True,
                "passing_only": req.flag("passing")}
        return await self._rpc_read(req, "Health.ServiceNodes", body, "nodes",
                                    row=self._check_service_node_row)

    async def health_state(self, req, m) -> HTTPResponse:
        return await self._rpc_read(
            req, "Health.ChecksInState", {"state": m.group("state")}, "checks"
        )

    # -- kv --------------------------------------------------------------

    async def kv_get(self, req, m) -> HTTPResponse:
        key = m.group("key")
        body: dict = {"key": key}
        body.update(req.query_options())
        if req.flag("keys"):
            body["separator"] = req.query.get("separator", "")
            out = await self.agent.rpc("KVS.ListKeys", body)
            return HTTPResponse(200, out.get("keys", []),
                                headers=_meta_headers(out.get("meta")))
        method = "KVS.List" if req.flag("recurse") else "KVS.Get"
        out = await self.agent.rpc(method, body)
        entries = out.get("entries", [])
        if not entries:
            return HTTPResponse(404, None,
                                headers=_meta_headers(out.get("meta")))
        if req.flag("raw") and not req.flag("recurse"):
            return HTTPResponse(200, None, raw=entries[0].get("value", b""),
                                headers=_meta_headers(out.get("meta")))
        return HTTPResponse(200, entries, headers=_meta_headers(out.get("meta")))

    async def kv_put(self, req, m) -> HTTPResponse:
        key = m.group("key")
        entry: dict = {"key": key, "value": req.body,
                       "flags": int(req.query.get("flags", 0))}
        if "acquire" in req.query:
            op = "lock"
            entry["session"] = req.query["acquire"]
        elif "release" in req.query:
            op = "unlock"
            entry["session"] = req.query["release"]
        elif "cas" in req.query:
            op = "cas"
            entry["modify_index"] = int(req.query["cas"])
        else:
            op = "set"
        out = await self.agent.rpc(
            "KVS.Apply", {"op": op, "entry": entry, **req.dc_option()}
        )
        result = out.get("result")
        return HTTPResponse(200, True if result is True or op == "set" else result)

    async def kv_delete(self, req, m) -> HTTPResponse:
        key = m.group("key")
        if req.flag("recurse"):
            body = {"op": "delete-tree", "entry": {"key": key}}
        elif "cas" in req.query:
            body = {"op": "delete-cas",
                    "entry": {"key": key,
                              "modify_index": int(req.query["cas"])}}
        else:
            body = {"op": "delete", "entry": {"key": key}}
        out = await self.agent.rpc("KVS.Apply", {**body, **req.dc_option()})
        result = out.get("result")
        return HTTPResponse(200, result if isinstance(result, bool) else True)

    # -- sessions ---------------------------------------------------------

    async def session_create(self, req, m) -> HTTPResponse:
        sess = _decamelize(req.json())
        sess.setdefault("node", self.agent.config.node_name)
        out = await self.agent.rpc(
            "Session.Apply",
            {"op": "create", "session": sess, **req.dc_option()},
        )
        return HTTPResponse(200, {"id": out["result"]})

    async def session_destroy(self, req, m) -> HTTPResponse:
        await self.agent.rpc("Session.Apply", {
            "op": "destroy", "session": {"id": m.group("sid")},
            **req.dc_option(),
        })
        return HTTPResponse(200, True)

    async def session_renew(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Session.Renew", {"id": m.group("sid")})
        sessions = out.get("sessions", [])
        if not sessions:
            return HTTPResponse(404, {"error": "session not found"})
        return HTTPResponse(200, sessions)

    async def session_info(self, req, m) -> HTTPResponse:
        return await self._rpc_read(
            req, "Session.Get", {"id": m.group("sid")}, "sessions"
        )

    async def session_node(self, req, m) -> HTTPResponse:
        return await self._rpc_read(
            req, "Session.NodeSessions", {"node": m.group("node")}, "sessions"
        )

    async def session_list(self, req, m) -> HTTPResponse:
        return await self._rpc_read(req, "Session.List", {}, "sessions")

    # -- events -----------------------------------------------------------

    async def event_fire(self, req, m) -> HTTPResponse:
        # event_endpoint.go Fire: event write on the name.
        await self._acl_check(req, "event", m.group("name"), "write")
        eid = await self.agent.fire_event(m.group("name"), req.body)
        return HTTPResponse(200, {"id": eid, "name": m.group("name")})

    async def event_list(self, req, m) -> HTTPResponse:
        """Supports blocking on new events via ?index&wait
        (event_endpoint.go eventList long-poll)."""
        name = req.query.get("name")
        min_index = int(req.query.get("index", 0))
        if min_index:
            wait = _parse_ttl(req.query.get("wait", "")) or 300.0
            deadline = asyncio.get_running_loop().time() + wait
            while self.agent.event_index <= min_index:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                handle = self.agent.event_wake_handle()
                try:
                    await asyncio.wait_for(handle.wait(), remaining)
                except asyncio.TimeoutError:
                    break
        events = [
            {"id": e.id, "name": e.name, "payload": e.payload,
             "l_time": e.ltime}
            for e in self.agent.events
            if name is None or e.name == name
        ]
        return HTTPResponse(
            200, events,
            headers={"X-Consul-Index": str(self.agent.event_index)},
        )

    # -- coordinates -------------------------------------------------------

    async def coordinate_nodes(self, req, m) -> HTTPResponse:
        return await self._rpc_read(req, "Coordinate.ListNodes", {},
                                    "coordinates")

    async def coordinate_node(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Coordinate.Node",
                                   {"node": m.group("node")})
        coord = out.get("coord")
        if coord is None:
            return HTTPResponse(404, None)
        return HTTPResponse(200, [{"node": m.group("node"), "coord": coord}])

    # -- prepared queries ---------------------------------------------------

    async def query_create(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("PreparedQuery.Apply", {
            "op": "create", "query": _decamelize(req.json()),
        })
        return HTTPResponse(200, {"id": out["result"]})

    async def query_get(self, req, m) -> HTTPResponse:
        return await self._rpc_read(
            req, "PreparedQuery.Get", {"id": m.group("qid")}, "queries"
        )

    async def query_update(self, req, m) -> HTTPResponse:
        q = _decamelize(req.json())
        q["id"] = m.group("qid")
        await self.agent.rpc("PreparedQuery.Apply", {"op": "update", "query": q})
        return HTTPResponse(200, {})

    async def query_delete(self, req, m) -> HTTPResponse:
        await self.agent.rpc("PreparedQuery.Apply", {
            "op": "delete", "query": {"id": m.group("qid")},
        })
        return HTTPResponse(200, {})

    async def query_list(self, req, m) -> HTTPResponse:
        return await self._rpc_read(req, "PreparedQuery.List", {}, "queries")

    async def query_execute(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("PreparedQuery.Execute",
                                   {"query_id": m.group("qid")})
        if out.get("error"):
            return HTTPResponse(404, {"error": out["error"]})
        return HTTPResponse(200, {"nodes": out["nodes"],
                                  "service": out["service"]},
                            headers=_meta_headers(out.get("meta")))

    # -- txn ----------------------------------------------------------------

    async def txn(self, req, m) -> HTTPResponse:
        raw_ops = req.json()
        ops = []
        for op in raw_ops:
            op = _decamelize(op)
            kv = op.get("kv")
            if kv and isinstance(kv.get("value"), str):
                kv = dict(kv)
                kv_entry = {k: v for k, v in kv.items() if k != "verb"}
                kv_entry["value"] = base64.b64decode(kv["value"])
                op = {"kv": {"verb": kv["verb"], "entry": kv_entry}}
            elif kv and "entry" not in kv:
                op = {"kv": {"verb": kv.pop("verb"), "entry": kv}}
            # The API KVTxnOp carries the CAS index as ``Index``
            # (api/kv.go KVTxnOp); internally it's the modify_index.
            entry = op.get("kv", {}).get("entry")
            if entry and "index" in entry and "modify_index" not in entry:
                entry["modify_index"] = entry.pop("index")
            ops.append(op)
        out = await self.agent.rpc(
            "Txn.Apply", {"ops": ops, **req.dc_option()}
        )
        result = out.get("result", out)
        status = 200 if not result.get("errors") else 409
        return HTTPResponse(status, result)

    # -- config entries ------------------------------------------------------

    async def config_apply(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ConfigEntry.Apply", {
            "op": "set", "entry": _decamelize(req.json()),
            **req.dc_option(),
        })
        return HTTPResponse(200, out.get("result", True))

    async def config_get(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ConfigEntry.Get", {
            "kind": m.group("kind"), "name": m.group("name"),
            **req.query_options(),
        })
        if out.get("entry") is None:
            return HTTPResponse(404, None,
                                headers=_meta_headers(out.get("meta")))
        return HTTPResponse(200, out["entry"],
                            headers=_meta_headers(out.get("meta")))

    async def config_list(self, req, m) -> HTTPResponse:
        return await self._rpc_read(
            req, "ConfigEntry.List", {"kind": m.group("kind")}, "entries"
        )

    async def config_delete(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ConfigEntry.Apply", {
            "op": "delete",
            "entry": {"kind": m.group("kind"), "name": m.group("name")},
            **req.dc_option(),
        })
        return HTTPResponse(200, out.get("result", True))

    async def connect_ca_rotate(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ConnectCA.Rotate",
                                   {"token": req.token()})
        return HTTPResponse(200, {"root_id": out.get("root_id", "")})

    async def discovery_chain_get(self, req, m) -> HTTPResponse:
        """GET/POST /v1/discovery-chain/:service
        (agent/discovery_chain_endpoint.go); POST bodies carry compile
        overrides."""
        body = {"name": m.group("svc"), **req.query_options()}
        if req.method == "POST" and req.body:
            overrides = _decamelize(req.json())
            for k in ("override_protocol", "use_in_datacenter"):
                if overrides.get(k):
                    body[k] = overrides[k]
            if overrides.get("override_connect_timeout_s"):
                # Validate at the boundary: a malformed override is the
                # caller's 400, not a server-side 500.
                body["override_connect_timeout_s"] = float(
                    overrides["override_connect_timeout_s"])
        out = await self.agent.rpc("DiscoveryChain.Get", body)
        chain = out.get("chain") or {}
        # Node keys / target ids are DATA keys — shield them from
        # camelization (their values still camelize normally).
        chain = {**chain,
                 "nodes": KeyedMap(chain.get("nodes") or {}),
                 "targets": KeyedMap(chain.get("targets") or {})}
        return HTTPResponse(200, {"chain": chain},
                            headers=_meta_headers(out.get("meta")))

    # -- federation states ---------------------------------------------------

    async def federation_state_list(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc(
            "FederationState.List", dict(req.query_options())
        )
        return HTTPResponse(200, out.get("states", []),
                            headers=_meta_headers(out.get("meta")))

    async def federation_state_get(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("FederationState.Get", {
            "target_dc": m.group("dc"), **req.query_options(),
        })
        if out.get("state") is None:
            return HTTPResponse(404, {"error": "federation state not found"})
        return HTTPResponse(200, {"state": out["state"]},
                            headers=_meta_headers(out.get("meta")))

    async def federation_state_mesh_gateways(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc(
            "FederationState.ListMeshGateways", dict(req.query_options())
        )
        # DC names are data keys — keep them out of camelization.
        return HTTPResponse(200, KeyedMap(out.get("gateways", {})),
                            headers=_meta_headers(out.get("meta")))

    # -- connect -------------------------------------------------------------

    async def connect_ca_roots(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ConnectCA.Roots", dict(req.query_options()))
        roots = out.get("roots") or []
        return HTTPResponse(200, {
            "active_root_id": next(
                (r["id"] for r in roots if r.get("active")), ""
            ),
            "roots": roots,
        }, headers=_meta_headers(out.get("meta")))

    async def connect_ca_leaf(self, req, m) -> HTTPResponse:
        """GET /v1/agent/connect/ca/leaf/:service — cached per service
        like the reference's connect-ca-leaf cache type: re-signed only
        when the active root rotates or the cert passes half-life
        (cache-types/connect_ca_leaf.go), so repeated reads (and the
        connect_leaf watch) see a STABLE cert, not a fresh signature
        per request."""
        import datetime as _dt

        svc = m.group("svc")
        # agent_endpoint.go AgentConnectCALeafCert: service:write on the
        # named service — enforced per request, cached cert or not (the
        # cache must never bypass the ACL gate).
        await self._acl_check(req, "service", svc, "write")
        roots_out = await self.agent.rpc(
            "ConnectCA.Roots", dict(req.query_options()))
        active = next(
            (r["id"] for r in roots_out.get("roots") or []
             if r.get("active")), "")
        cache = getattr(self.agent, "_leaf_cache", None)
        if cache is None:
            cache = self.agent._leaf_cache = {}
        cache_key = (svc, req.query.get("dc", ""))
        leaf = cache.get(cache_key)
        stale = leaf is None or leaf.get("root_id") != active
        if leaf is not None and not stale:
            try:
                expires = _dt.datetime.fromisoformat(leaf["valid_before"])
                issued = _dt.datetime.fromisoformat(
                    leaf.get("valid_after", leaf["valid_before"]))
                life = (expires - issued).total_seconds()
                left = (expires - _dt.datetime.now(_dt.timezone.utc)
                        ).total_seconds()
                stale = life > 0 and left < life * 0.5
            except (KeyError, ValueError):
                stale = False
        if stale:
            # query_options() carries the caller's token — the Sign RPC
            # enforces its own ACL with it.
            out = await self.agent.rpc("ConnectCA.Sign", {
                "service": svc, **req.query_options(),
            })
            leaf = out.get("leaf")
            cache[cache_key] = leaf
        return HTTPResponse(200, leaf)

    async def intention_create(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Intention.Apply", {
            "op": "create", "intention": _decamelize(req.json()),
            **req.dc_option(),
        })
        return HTTPResponse(200, {"id": out.get("result")})

    async def intention_update(self, req, m) -> HTTPResponse:
        intention = _decamelize(req.json())
        intention["id"] = m.group("iid")
        out = await self.agent.rpc("Intention.Apply", {
            "op": "update", "intention": intention, **req.dc_option(),
        })
        return HTTPResponse(200, bool(out.get("result")))

    async def intention_delete(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Intention.Apply", {
            "op": "delete", "intention": {"id": m.group("iid")},
            **req.dc_option(),
        })
        return HTTPResponse(200, bool(out.get("result")))

    async def intention_get(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Intention.Get", {
            "id": m.group("iid"), **req.query_options(),
        })
        rows = out.get("intentions") or []
        if not rows:
            return HTTPResponse(404, {"error": "intention not found"})
        return HTTPResponse(200, rows[0],
                            headers=_meta_headers(out.get("meta")))

    async def intention_list(self, req, m) -> HTTPResponse:
        return await self._rpc_read(req, "Intention.List", {}, "intentions")

    async def intention_check(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Intention.Check", {
            "source": req.query.get("source", ""),
            "destination": req.query.get("destination", ""),
            **req.query_options(),
        })
        return HTTPResponse(200, {"allowed": out.get("allowed", False)})

    async def connect_authorize(self, req, m) -> HTTPResponse:
        """agent_endpoint.go AgentConnectAuthorize: a proxy presents the
        client cert's SPIFFE URI; authorization = intention check on
        (client service -> target service)."""
        body = _decamelize(req.json())
        target = body.get("target", "")
        uri = body.get("client_cert_uri", "")
        source = uri.rsplit("/svc/", 1)[-1] if "/svc/" in uri else uri
        out = await self.agent.rpc("Intention.Check", {
            "source": source, "destination": target, **req.dc_option(),
        })
        return HTTPResponse(200, {
            "authorized": out.get("allowed", False),
            "reason": out.get("reason", ""),
        })

    async def _proxy_snapshot(self, req, pid: str):
        """Shared longpoll fetch for the proxy-config feeds: honor
        ?index/?wait, wait out the first assembly of a just-registered
        proxy, None for unknown ids."""
        min_version = int(req.query.get("index", 0) or 0)
        wait = _parse_ttl(req.query.get("wait", "")) or 300.0
        if min_version > 0:
            return await self.agent.proxycfg.wait(
                pid, min_version=min_version, timeout=wait)
        out = self.agent.proxycfg.snapshot(pid)
        if out is None and pid in self.agent.proxycfg.proxy_ids():
            # Registered but not yet assembled: wait for the first.
            out = await self.agent.proxycfg.wait(pid, 0, timeout=wait)
        return out

    async def connect_proxy_config(self, req, m) -> HTTPResponse:
        """GET /v1/agent/connect/proxy/:proxy_id?index=N&wait=30s —
        the proxy's config snapshot, longpolling on its version."""
        pid = m.group("pid")
        out = await self._proxy_snapshot(req, pid)
        if out is None:
            return HTTPResponse(404, {"error": f"unknown proxy {pid!r}"})
        version, snap = out
        # Upstream maps are keyed by service names / target ids: data.
        shaped = {**snap,
                  "upstreams": KeyedMap({
                      name: {**up, "instances": KeyedMap(up["instances"])}
                      for name, up in snap["upstreams"].items()
                  })}
        return HTTPResponse(200, shaped,
                            headers={"X-Consul-Index": str(version)})

    async def connect_proxy_xds(self, req, m) -> HTTPResponse:
        """GET /v1/agent/connect/proxy/:proxy_id/xds?index=N&wait=30s —
        the ADS-shaped export of the same snapshot (agent/xds/server.go
        re-designed as a blocking JSON feed; each resource family keyed
        by its v2 type URL)."""
        from consul_tpu_torch.connect import xds as xds_mod

        pid = m.group("pid")
        out = await self._proxy_snapshot(req, pid)
        if out is None:
            return HTTPResponse(404, {"error": f"unknown proxy {pid!r}"})
        version, snap = out
        public_port = int(req.query.get("port", 0) or 0)
        ads = xds_mod.ads_snapshot(snap, version, public_port=public_port)
        # The whole response is an Envoy-shaped wire structure
        # (DiscoveryResponse-style), not our struct fields — ship it
        # byte-exact, no camelization anywhere in the tree.
        return HTTPResponse(
            200, _raw_tree(ads),
            headers={"X-Consul-Index": str(version)},
        )

    # -- keyring -------------------------------------------------------------

    async def _keyring_op(self, req, op: str, need_key: bool) -> HTTPResponse:
        # internal_endpoint.go:414-422: list needs keyring:read, the
        # mutating ops keyring:write — without this an anonymous client
        # could read the live gossip keys.
        want = "read" if op == "list_keys" else "write"
        await self._acl_check(req, "keyring", "", want)
        key = ""
        if need_key:
            body = _decamelize(req.json())
            key = body.get("key", "")
            if not key:
                return HTTPResponse(400, {"error": "missing Key"})
        try:
            out = await self.agent.keyring_operation(op, key)
        except ValueError as e:
            return HTTPResponse(400, {"error": str(e)})
        # keys (base64) and errors (node names) are DATA keys: shield
        # them from camelization or they come back unusable.
        shaped = KeyedMap({
            label: {**res,
                    "keys": KeyedMap(res.get("keys", {})),
                    "errors": KeyedMap(res.get("errors", {}))}
            for label, res in out.items()
        })
        return HTTPResponse(200, shaped)

    async def keyring_list(self, req, m) -> HTTPResponse:
        return await self._keyring_op(req, "list_keys", need_key=False)

    async def keyring_install(self, req, m) -> HTTPResponse:
        return await self._keyring_op(req, "install_key", need_key=True)

    async def keyring_use(self, req, m) -> HTTPResponse:
        return await self._keyring_op(req, "use_key", need_key=True)

    async def keyring_remove(self, req, m) -> HTTPResponse:
        return await self._keyring_op(req, "remove_key", need_key=True)

    # -- snapshot ------------------------------------------------------------

    async def snapshot_save(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Snapshot.Save", dict(req.query_options()))
        return HTTPResponse(
            200, None, raw=out.get("archive", b""),
            headers={"X-Consul-Index": str(out.get("index", 0)),
                     "Content-Type": "application/x-gzip"},
        )

    async def snapshot_restore(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Snapshot.Restore", {
            "archive": req.body, **req.dc_option(),
        })
        return HTTPResponse(200, bool(out.get("result", True)))

    # -- acl -----------------------------------------------------------------

    async def acl_bootstrap(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.Bootstrap", req.dc_option())
        return HTTPResponse(200, out.get("token"))

    async def acl_token_set(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.TokenSet", {
            "acl_token": _decamelize(req.json()), **req.dc_option(),
        })
        return HTTPResponse(200, out.get("token"))

    async def acl_token_list(self, req, m) -> HTTPResponse:
        body = dict(req.query_options())
        out = await self.agent.rpc("ACL.TokenList", body)
        return HTTPResponse(200, out.get("tokens", []),
                            headers=_meta_headers(out.get("meta")))

    async def acl_token_read(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.TokenRead", {
            "secret_id": m.group("sid"), **req.query_options(),
        })
        if out.get("token") is None:
            return HTTPResponse(404, {"error": "token not found"})
        return HTTPResponse(200, out["token"])

    async def acl_token_delete(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.TokenDelete", {
            "secret_id": m.group("sid"), **req.dc_option(),
        })
        return HTTPResponse(200, bool(out.get("result", True)))

    async def acl_policy_set(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.PolicySet", {
            "policy": _decamelize(req.json()), **req.dc_option(),
        })
        return HTTPResponse(200, out.get("policy"))

    async def acl_policy_list(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.PolicyList", dict(req.query_options()))
        return HTTPResponse(200, out.get("policies", []),
                            headers=_meta_headers(out.get("meta")))

    async def acl_policy_read(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.PolicyRead", {
            "id": m.group("pid"), **req.query_options(),
        })
        if out.get("policy") is None:
            return HTTPResponse(404, {"error": "policy not found"})
        return HTTPResponse(200, out["policy"])

    async def acl_policy_delete(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.PolicyDelete", {
            "id": m.group("pid"), **req.dc_option(),
        })
        return HTTPResponse(200, bool(out.get("result", True)))

    async def acl_role_set(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.RoleSet", {
            "role": _decamelize(req.json()), **req.dc_option(),
        })
        return HTTPResponse(200, out.get("role"))

    async def acl_role_list(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.RoleList", dict(req.query_options()))
        return HTTPResponse(200, out.get("roles", []),
                            headers=_meta_headers(out.get("meta")))

    async def acl_role_read(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.RoleRead", {
            "id": m.group("rid"), **req.query_options(),
        })
        if out.get("role") is None:
            return HTTPResponse(404, {"error": "role not found"})
        return HTTPResponse(200, out["role"])

    async def acl_role_read_name(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.RoleRead", {
            "name": m.group("name"), **req.query_options(),
        })
        if out.get("role") is None:
            return HTTPResponse(404, {"error": "role not found"})
        return HTTPResponse(200, out["role"])

    async def acl_role_delete(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.RoleDelete", {
            "id": m.group("rid"), **req.dc_option(),
        })
        return HTTPResponse(200, bool(out.get("result", True)))

    async def acl_auth_method_set(self, req, m) -> HTTPResponse:
        raw = req.json()
        method = _decamelize(raw)
        # The Config subtree's claim-mapping keys are DATA (claim names
        # like "preferred_username"), not struct fields — rebuild them
        # from the raw JSON so case survives the snake/camel round-trip,
        # and mark them KeyedMap so responses leave them alone.
        cfg_raw = raw.get("Config") or raw.get("config") or {}
        if isinstance(cfg_raw, dict):
            cfg = {}
            for k, v in cfg_raw.items():
                sk = _snake_key(k)
                if sk in ("claim_mappings", "list_claim_mappings") \
                        and isinstance(v, dict):
                    v = KeyedMap(v)
                cfg[sk] = v
            method["config"] = cfg
        out = await self.agent.rpc("ACL.AuthMethodSet", {
            "auth_method": method, **req.dc_option(),
        })
        # Re-shield on the way out: the echoed record may have crossed
        # an RPC forward, which strips the KeyedMap marker.
        return HTTPResponse(
            200, _shield_claim_keys(out.get("auth_method") or {})
        )

    async def acl_auth_method_list(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc(
            "ACL.AuthMethodList", dict(req.query_options())
        )
        methods = [_shield_claim_keys(mth)
                   for mth in out.get("auth_methods", [])]
        return HTTPResponse(200, methods,
                            headers=_meta_headers(out.get("meta")))

    async def acl_auth_method_read(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.AuthMethodRead", {
            "name": m.group("name"), **req.query_options(),
        })
        if out.get("auth_method") is None:
            return HTTPResponse(404, {"error": "auth method not found"})
        return HTTPResponse(200, _shield_claim_keys(out["auth_method"]))

    async def acl_auth_method_delete(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.AuthMethodDelete", {
            "name": m.group("name"), **req.dc_option(),
        })
        return HTTPResponse(200, bool(out.get("result", True)))

    async def acl_binding_rule_set(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.BindingRuleSet", {
            "binding_rule": _decamelize(req.json()), **req.dc_option(),
        })
        return HTTPResponse(200, out.get("binding_rule"))

    async def acl_binding_rule_list(self, req, m) -> HTTPResponse:
        body = dict(req.query_options())
        if "authmethod" in req.query:
            body["auth_method"] = req.query["authmethod"]
        out = await self.agent.rpc("ACL.BindingRuleList", body)
        return HTTPResponse(200, out.get("binding_rules", []),
                            headers=_meta_headers(out.get("meta")))

    async def acl_binding_rule_read(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.BindingRuleRead", {
            "id": m.group("rid"), **req.query_options(),
        })
        if out.get("binding_rule") is None:
            return HTTPResponse(404, {"error": "binding rule not found"})
        return HTTPResponse(200, out["binding_rule"])

    async def acl_binding_rule_delete(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.BindingRuleDelete", {
            "id": m.group("rid"), **req.dc_option(),
        })
        return HTTPResponse(200, bool(out.get("result", True)))

    async def acl_login(self, req, m) -> HTTPResponse:
        # agent_endpoint.go ACLLogin: body carries AuthMethod +
        # BearerToken; no pre-existing token is required.
        out = await self.agent.rpc("ACL.Login", {
            "auth": _decamelize(req.json()), **req.dc_option(),
        })
        return HTTPResponse(200, out.get("token"))

    async def acl_logout(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("ACL.Logout", {
            **req.query_options(), **req.dc_option(),
        })
        return HTTPResponse(200, bool(out.get("result", True)))

    # -- operator ------------------------------------------------------------

    async def operator_raft(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Operator.RaftGetConfiguration", {})
        return HTTPResponse(200, out)

    async def operator_health(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc("Operator.ServerHealth", {})
        return HTTPResponse(200, out)

    async def operator_autopilot_get(self, req, m) -> HTTPResponse:
        out = await self.agent.rpc(
            "Operator.AutopilotGetConfiguration",
            dict(req.query_options()))
        return HTTPResponse(200, out.get("config"))

    async def operator_autopilot_set(self, req, m) -> HTTPResponse:
        body = {"config": _decamelize(req.json()), **req.query_options()}
        if "cas" in req.query:
            body["cas"] = True
            body["modify_index"] = int(req.query["cas"])
        out = await self.agent.rpc(
            "Operator.AutopilotSetConfiguration", body)
        return HTTPResponse(200, bool(out.get("result", True)))


_CAMEL_SPLIT = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")


def _raw_tree(obj: Any) -> Any:
    """Recursively mark every dict as KeyedMap so camelize ships the
    structure byte-exact (Envoy-shaped xDS resources use their own
    snake_case wire names)."""
    if isinstance(obj, dict):
        return KeyedMap({k: _raw_tree(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_raw_tree(v) for v in obj]
    return obj


def _shield_claim_keys(method: dict) -> dict:
    """Re-mark an auth method's claim-mapping keys as data before the
    response camelizes.  The KeyedMap wrapper applied at write time does
    not survive raft replication or a snapshot round-trip (it serializes
    as a plain dict), so reads re-apply it."""
    cfg = method.get("config")
    if not isinstance(cfg, dict):
        return method
    cfg = dict(cfg)
    for k in ("claim_mappings", "list_claim_mappings"):
        if isinstance(cfg.get(k), dict):
            cfg[k] = KeyedMap(cfg[k])
    return {**method, "config": cfg}


def _decamelize(obj: Any) -> Any:
    """CamelCase request JSON → snake_case bodies; ID/TTL handled."""
    if isinstance(obj, dict):
        return {_snake_key(k): _decamelize(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decamelize(v) for v in obj]
    return obj


def _snake_key(key: str) -> str:
    for acro, camel in (("ID", "Id"), ("TTL", "Ttl"), ("DNS", "Dns"),
                        ("HTTP", "Http"), ("TCP", "Tcp")):
        key = key.replace(acro, camel)
    return _CAMEL_SPLIT.sub("_", key).lower()
