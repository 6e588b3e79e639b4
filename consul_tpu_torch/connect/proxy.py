"""Built-in L4 proxy: the mesh data plane; the port's copy of
``consul_tpu/connect/proxy.py``.

Re-design of ``connect/proxy/proxy.go`` + the intention RBAC half of
``agent/xds/rbac.go``: a sidecar process that

  - longpolls its config snapshot from the local agent
    (``/v1/agent/connect/proxy/<id>`` — proxycfg's blocking feed, the
    xDS stream stand-in),
  - serves a PUBLIC mTLS listener for its service: client certs are
    required, the client's SPIFFE identity is matched against the
    snapshot's intentions (connection-time RBAC, evaluated locally —
    no per-connection agent round-trip), and authorized bytes are
    piped to the local application,
  - opens one LOCAL plaintext listener per upstream: connections are
    piped over mTLS to a healthy instance of the upstream's discovery
    chain (splitters honored by weighted choice, resolver failover
    targets tried in order), with the server's identity pinned to the
    destination service (connect/tls.go verifyServerCertMatchesURI),
  - rolls its certificates in place when the CA root rotates: the live
    ``ssl.SSLContext`` objects are re-loaded, so new handshakes use the
    new leaf while established connections keep streaming (zero
    downtime).

TCP only, like the reference's built-in proxy (L7 routing is the
chain's router/splitter semantics applied at connection granularity).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import re
import ssl
import tempfile
from typing import Optional

log = logging.getLogger("consul_tpu_torch.proxy")

_SVC_RE = re.compile(r"spiffe://([^/]+)/ns/[^/]+/dc/[^/]+/svc/(.+)$")


async def _pipe(reader: asyncio.StreamReader,
                writer: asyncio.StreamWriter) -> None:
    try:
        while True:
            data = await reader.read(65536)
            if not data:
                break
            writer.write(data)
            await writer.drain()
    except (ConnectionError, asyncio.IncompleteReadError, ssl.SSLError):
        pass
    finally:
        try:
            writer.close()
        except Exception:  # noqa: BLE001 - teardown
            pass


async def splice(r1, w1, r2, w2) -> None:
    """Bidirectional byte pump between two established streams."""
    await asyncio.gather(_pipe(r1, w2), _pipe(r2, w1))


def evaluate_intentions(intentions: list[dict], source: str,
                        default_allow: bool) -> bool:
    """First match by precedence decides (xds/rbac.go built from the
    same sorted intention list; store.intention_match returns
    most-precedent first)."""
    for intention in intentions:
        if intention.get("source") in (source, "*"):
            return intention.get("action", "allow") == "allow"
    return default_allow


def chain_candidates(upstream: dict) -> list[str]:
    """Walk the upstream's compiled chain to an ordered list of target
    ids to try (primary first, then failover) — the L4 projection of
    xds/clusters.go+endpoints.go."""
    chain = upstream.get("chain") or {}
    nodes = chain.get("nodes") or {}
    out: list[str] = []

    def visit(key: str) -> None:
        node = nodes.get(key)
        if node is None:
            return
        ntype = node.get("type")
        if ntype == "router":
            # TCP granularity: take the catch-all (last) route.
            routes = node.get("routes") or []
            if routes:
                visit(routes[-1]["next_node"])
        elif ntype == "splitter":
            splits = node.get("splits") or []
            if splits:
                weights = [max(float(s.get("weight", 0)), 0) for s in splits]
                total = sum(weights)
                if total <= 0:
                    choice = splits[0]
                else:
                    choice = random.choices(splits, weights=weights)[0]
                visit(choice["next_node"])
        elif ntype == "resolver":
            res = node.get("resolver") or {}
            if res.get("target"):
                out.append(res["target"])
            for tid in ((res.get("failover") or {}).get("targets") or []):
                out.append(tid)

    visit(chain.get("start_node", ""))
    if not out:
        # No chain (agent older than the entries, or compile error
        # upstream): fall back to the bare service target keys present.
        out = list((upstream.get("instances") or {}))
    return out


class ConnectProxy:
    """One sidecar: public mTLS listener + local upstream listeners."""

    def __init__(self, proxy_id: str, agent_http_addr: str,
                 public_port: int = 0, host: str = "127.0.0.1"):
        self.proxy_id = proxy_id
        self.agent = agent_http_addr
        self.host = host
        self.public_port = public_port
        self.public_addr = ""

        self.snapshot: Optional[dict] = None
        self.version = 0
        self._config_task: Optional[asyncio.Task] = None
        self._servers: list[asyncio.AbstractServer] = []
        self._upstream_servers: dict[str, asyncio.AbstractServer] = {}
        self._server_ctx: Optional[ssl.SSLContext] = None
        self._client_ctx: Optional[ssl.SSLContext] = None
        self._cert_state: tuple = ()
        self._tmpfiles: list[str] = []
        self._ready = asyncio.Event()
        self.trust_domain = ""

    # -- config feed ----------------------------------------------------

    async def _fetch_config(self, min_version: int, wait_s: float) -> dict:
        from consul_tpu_torch.agent.http import _decamelize

        host, port = self.agent.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            path = (f"/v1/agent/connect/proxy/{self.proxy_id}"
                    f"?index={min_version}&wait={wait_s}s")
            writer.write((f"GET {path} HTTP/1.1\r\nHost: a\r\n"
                          "Connection: close\r\n\r\n").encode())
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), wait_s + 30)
        finally:
            writer.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        status = int(head.split()[1])
        if status != 200:
            raise ConnectionError(
                f"proxy config fetch: HTTP {status} {body[:200]!r}")
        version = 0
        for line in head.decode().split("\r\n"):
            if line.lower().startswith("x-consul-index:"):
                version = int(line.split(":", 1)[1])
        snap = _decamelize(json.loads(body))
        snap["__version__"] = version
        return snap

    async def _config_loop(self) -> None:
        backoff = 0.2
        while True:
            try:
                snap = await self._fetch_config(self.version, 60.0)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - agent restarts etc.
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)
                continue
            backoff = 0.2
            version = snap.pop("__version__", self.version + 1)
            if version == self.version and self.snapshot is not None:
                continue
            self.version = version
            self.snapshot = snap
            await self._apply_snapshot(snap)
            self._ready.set()

    # -- certificates ---------------------------------------------------

    def _write_tmp(self, content: str) -> str:
        f = tempfile.NamedTemporaryFile("w", suffix=".pem", delete=False)
        f.write(content)
        f.close()
        self._tmpfiles.append(f.name)
        return f.name

    async def _apply_snapshot(self, snap: dict) -> None:
        leaf = snap.get("leaf") or {}
        roots_pem = "".join(
            r.get("root_cert", "") for r in snap.get("roots") or [])
        chain_pem = leaf.get("cert_pem", "") + "".join(
            leaf.get("intermediate_pems") or [])
        state = (chain_pem, roots_pem)
        if leaf and state != self._cert_state:
            cert = self._write_tmp(chain_pem)
            key = self._write_tmp(leaf["key_pem"])
            ca = self._write_tmp(roots_pem)
            if self._server_ctx is None:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.verify_mode = ssl.CERT_REQUIRED
                self._server_ctx = ctx
            # In-place reload: the listening server holds this context,
            # so future handshakes pick up the new material with zero
            # downtime (proxy.go re-reads its tlsutil configurator).
            self._server_ctx.load_cert_chain(cert, key)
            self._server_ctx.load_verify_locations(cafile=ca)
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_cert_chain(cert, key)
            ctx.load_verify_locations(cafile=ca)
            self._client_ctx = ctx
            self._cert_state = state
            m = _SVC_RE.match(leaf.get("uri", ""))
            if m:
                self.trust_domain = m.group(1)
        await self._reconcile_upstream_listeners(snap)

    # -- public listener (inbound) --------------------------------------

    def _peer_service(self, writer: asyncio.StreamWriter) -> str:
        sslobj = writer.get_extra_info("ssl_object")
        cert = sslobj.getpeercert() if sslobj else None
        for kind, value in (cert or {}).get("subjectAltName", ()):
            if kind == "URI":
                m = _SVC_RE.match(value)
                if m and m.group(1) == self.trust_domain:
                    return m.group(2)
        return ""

    async def _handle_public(self, reader, writer) -> None:
        snap = self.snapshot or {}
        try:
            source = self._peer_service(writer)
            if not source or not evaluate_intentions(
                snap.get("intentions") or [], source,
                bool(snap.get("default_allow", True)),
            ):
                writer.close()
                return
            addr = snap.get("local_service_address", "")
            host, port = addr.rsplit(":", 1)
            up_r, up_w = await asyncio.open_connection(host, int(port))
        except Exception:  # noqa: BLE001 - connection-scoped
            writer.close()
            return
        await splice(reader, writer, up_r, up_w)

    # -- upstream listeners (outbound) -----------------------------------

    async def _reconcile_upstream_listeners(self, snap: dict) -> None:
        wanted = {
            name: up for name, up in (snap.get("upstreams") or {}).items()
            if up.get("local_bind_port")
        }
        for name in list(self._upstream_servers):
            if name not in wanted:
                self._upstream_servers.pop(name).close()
        for name, up in wanted.items():
            if name in self._upstream_servers:
                continue

            def make_handler(upstream_name: str):
                async def handle(reader, writer):
                    await self._handle_upstream(upstream_name, reader,
                                                writer)
                return handle

            server = await asyncio.start_server(
                make_handler(name),
                up.get("local_bind_address", "127.0.0.1"),
                int(up["local_bind_port"]),
            )
            self._upstream_servers[name] = server

    def _pick_endpoint(self, upstream: dict) -> Optional[tuple[dict, str]]:
        instances = upstream.get("instances") or {}
        for tid in chain_candidates(upstream):
            rows = instances.get(tid) or []
            if rows:
                target = ((upstream.get("chain") or {}).get("targets")
                          or {}).get(tid) or {}
                return random.choice(rows), target.get(
                    "service", tid.split("@")[0].split(":")[0])
        return None

    async def _handle_upstream(self, name: str, reader, writer) -> None:
        snap = self.snapshot or {}
        upstream = (snap.get("upstreams") or {}).get(name) or {}
        picked = self._pick_endpoint(upstream)
        if picked is None or self._client_ctx is None:
            writer.close()
            return
        endpoint, dest_service = picked
        try:
            up_r, up_w = await asyncio.wait_for(
                asyncio.open_connection(
                    endpoint["address"], int(endpoint["port"]),
                    ssl=self._client_ctx,
                ),
                timeout=10.0,
            )
        except Exception:  # noqa: BLE001 - connection-scoped
            writer.close()
            return
        # Pin the server's identity to the destination service
        # (connect/tls.go verifyServerCertMatchesURI).
        peer = self._peer_service_of(up_w)
        if peer != dest_service:
            up_w.close()
            writer.close()
            return
        await splice(reader, writer, up_r, up_w)

    def _peer_service_of(self, writer: asyncio.StreamWriter) -> str:
        sslobj = writer.get_extra_info("ssl_object")
        cert = sslobj.getpeercert() if sslobj else None
        for kind, value in (cert or {}).get("subjectAltName", ()):
            if kind == "URI":
                m = _SVC_RE.match(value)
                if m and m.group(1) == self.trust_domain:
                    return m.group(2)
        return ""

    # -- lifecycle ------------------------------------------------------

    async def start(self, timeout: float = 30.0) -> "ConnectProxy":
        self._config_task = asyncio.create_task(self._config_loop())
        await asyncio.wait_for(self._ready.wait(), timeout)
        server = await asyncio.start_server(
            self._handle_public, self.host, self.public_port,
            ssl=self._server_ctx,
        )
        self._servers.append(server)
        h, p = server.sockets[0].getsockname()[:2]
        self.public_addr = f"{h}:{p}"
        return self

    async def wait_version(self, min_version: int,
                           timeout: float = 10.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while self.version < min_version:
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(
                    f"proxy config stuck at v{self.version}")
            await asyncio.sleep(0.05)

    async def stop(self) -> None:
        if self._config_task is not None:
            self._config_task.cancel()
        for server in self._servers + list(self._upstream_servers.values()):
            server.close()
        self._upstream_servers.clear()
        self._servers.clear()
        import os

        for path in self._tmpfiles:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._tmpfiles.clear()
