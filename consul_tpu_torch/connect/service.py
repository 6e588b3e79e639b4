"""Connect client library: mTLS service-to-service with intention authz;
the port's copy of ``consul_tpu/connect/service.py``.

Equivalent of ``connect/service.go`` + the dev L4 proxy
(``connect/proxy/``): a :class:`Service` fetches its SPIFFE leaf
certificate and the CA roots from its local agent, serves TLS with
client certificates REQUIRED, verifies the dialing service's identity
from its certificate's URI SAN, and asks the agent to authorize the
(source → destination) pair against intentions
(``/v1/agent/connect/authorize``).  Dialing verifies the server's
certificate against the CA roots the same way.

TLS is stdlib ``ssl``; certificates come from the built-in CA
(consul_tpu_torch/connect/ca.py) via the agent HTTP API.
"""

from __future__ import annotations

import asyncio
import json
import re
import ssl
import tempfile
from typing import Awaitable, Callable, Optional


class ConnectError(Exception):
    pass


async def _http_json(addr: str, method: str, path: str,
                     body: Optional[dict] = None, timeout: float = 10.0):
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        payload = json.dumps(body).encode() if body is not None else b""
        writer.write(
            (f"{method} {path} HTTP/1.1\r\nHost: c\r\n"
             f"Content-Length: {len(payload)}\r\n"
             f"Connection: close\r\n\r\n").encode() + payload
        )
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()
    head, _, resp = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    if status != 200:
        raise ConnectError(f"{path}: HTTP {status}: {resp[:200]!r}")
    return json.loads(resp)


class Service:
    """connect.Service: one logical service's mTLS identity."""

    def __init__(self, name: str, agent_http_addr: str):
        self.name = name
        self.agent = agent_http_addr
        self.uri = ""
        self._leaf_pem = ""
        self._key_pem = ""
        self._roots_pem = ""
        self._tmpfiles: list = []
        self._server_ctx: Optional[ssl.SSLContext] = None
        self._client_ctx: Optional[ssl.SSLContext] = None

    async def ready(self) -> "Service":
        """Fetch leaf + roots from the agent (service.go watches the
        leaf/roots cache; one fetch here — leaves are long-lived)."""
        leaf = await _http_json(
            self.agent, "GET", f"/v1/agent/connect/ca/leaf/{self.name}"
        )
        roots = await _http_json(self.agent, "GET", "/v1/connect/ca/roots")
        self.uri = leaf["URI"]
        # Present the FULL chain: leaf plus any cross-signed
        # intermediate from a rotation, so peers still pinned to the
        # previous root keep verifying us (provider_consul.go
        # CrossSignCA; the handshake carries the chain).
        self._leaf_pem = leaf["CertPEM"] + "".join(
            leaf.get("IntermediatePems") or [])
        self._key_pem = leaf["KeyPEM"]
        self._roots_pem = "".join(
            r["RootCert"] for r in roots.get("Roots", [])
        )
        return self

    # -- ssl contexts ---------------------------------------------------

    def _cert_files(self) -> tuple[str, str]:
        cert = tempfile.NamedTemporaryFile("w", suffix=".pem", delete=False)
        cert.write(self._leaf_pem)
        cert.close()
        key = tempfile.NamedTemporaryFile("w", suffix=".pem", delete=False)
        key.write(self._key_pem)
        key.close()
        self._tmpfiles += [cert.name, key.name]
        return cert.name, key.name

    def server_context(self) -> ssl.SSLContext:
        """TLS server requiring a Connect client certificate (built
        once and reused — contexts and their temp cert files would
        otherwise accumulate per call)."""
        if self._server_ctx is None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            cert, key = self._cert_files()
            ctx.load_cert_chain(cert, key)
            ctx.load_verify_locations(cadata=self._roots_pem)
            ctx.verify_mode = ssl.CERT_REQUIRED
            self._server_ctx = ctx
        return self._server_ctx

    def client_context(self) -> ssl.SSLContext:
        """TLS client presenting our leaf; verifies the server chains to
        the CA roots (identity is in the URI SAN, not the hostname, so
        hostname checking is off — connect/tls.go does the same)."""
        if self._client_ctx is None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            cert, key = self._cert_files()
            ctx.load_cert_chain(cert, key)
            ctx.load_verify_locations(cadata=self._roots_pem)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_REQUIRED
            self._client_ctx = ctx
        return self._client_ctx

    # -- serving --------------------------------------------------------

    @staticmethod
    def _peer_uri(writer: asyncio.StreamWriter) -> str:
        sslobj = writer.get_extra_info("ssl_object")
        cert = sslobj.getpeercert() if sslobj else None
        for kind, value in (cert or {}).get("subjectAltName", ()):
            if kind == "URI":
                return value
        return ""

    async def authorize(self, client_uri: str) -> bool:
        """agent_endpoint.go AgentConnectAuthorize via the local agent."""
        out = await _http_json(
            self.agent, "POST", "/v1/agent/connect/authorize",
            {"Target": self.name, "ClientCertURI": client_uri},
        )
        return bool(out.get("Authorized"))

    async def listen(
        self,
        handler: Callable[[asyncio.StreamReader, asyncio.StreamWriter],
                          Awaitable[None]],
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> tuple[asyncio.AbstractServer, str]:
        """Serve mTLS: every connection's client certificate is verified
        against the roots by TLS, then its SPIFFE identity is authorized
        against intentions before the handler runs."""

        async def wrapped(reader, writer):
            try:
                uri = self._peer_uri(writer)
                if not uri or not await self.authorize(uri):
                    writer.close()
                    return
                await handler(reader, writer)
            except Exception:  # noqa: BLE001 - connection-scoped
                writer.close()

        server = await asyncio.start_server(
            wrapped, host, port, ssl=self.server_context()
        )
        h, p = server.sockets[0].getsockname()[:2]
        return server, f"{h}:{p}"

    def _expect_uri(self, destination: str, dc: str = "") -> str:
        """Expected SPIFFE URI for a destination service, built from our
        own leaf's trust domain (connect/tls.go
        verifyServerCertMatchesURI compares against the intended
        CertURI, not just chain validity).  ``dc`` defaults to our own
        datacenter; cross-DC targets (failover/redirect chains) pass
        the target's datacenter."""
        from consul_tpu_torch.connect.ca import spiffe_service

        m = re.match(r"spiffe://([^/]+)/ns/[^/]+/dc/([^/]+)/svc/", self.uri)
        if not m:
            raise ConnectError(f"cannot derive trust domain from {self.uri!r}")
        return spiffe_service(m.group(1), dc or m.group(2), destination)

    async def dial(
        self, addr: str, destination: str = "", dc: str = "",
        timeout: float = 10.0,
    ) -> tuple[asyncio.StreamReader, asyncio.StreamWriter]:
        """Connect to another service's mTLS listener.

        When ``destination`` is given, the server's URI SAN must be the
        SPIFFE identity of that service — chain validity alone would let
        any leaf-holding service impersonate any destination
        (connect/tls.go verifyServerCertMatchesURI).  ``dc`` pins a
        cross-datacenter target's identity."""
        host, port = addr.rsplit(":", 1)
        # Resolve the expected identity BEFORE connecting: an unset or
        # malformed local leaf must not cost a handshake (or leak the
        # opened connection through the raise below).
        expect = self._expect_uri(destination, dc) if destination else ""
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(
                host, int(port), ssl=self.client_context()
            ),
            timeout,
        )
        if destination:
            peer = self._peer_uri(writer)
            if peer != expect:
                writer.close()
                raise ConnectError(
                    f"server identity {peer!r} is not {destination!r}"
                )
        return reader, writer

    def close(self) -> None:
        import os

        for path in self._tmpfiles:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._tmpfiles.clear()
