"""DNS interface: service discovery over the DNS protocol; the port's copy
of ``consul_tpu/agent/dns.py``.

Equivalent of ``agent/dns.go`` (the miekg/dns server on :8600): node
lookups (``<node>.node.<dc>.consul``), service lookups
(``[<tag>.]<service>.service[.<dc>].consul``) with only-passing
filtering, RFC 2782 SRV names (``_svc._tag.service.consul``), prepared
query lookups (``<name>.query.consul``), SOA/NS, A/AAAA/SRV/TXT answer
synthesis, shuffled answers, and UDP truncation with the TC bit.

The wire codec is hand-rolled (RFC 1035 §4) — the image has no DNS
library.  Compression pointers are emitted for repeated names.

One addition to the JAX package's lookups: ``consul.service.consul``
answers this datacenter's alive servers, from the agent's LAN pool,
where the catalog holds no ``consul`` service.  Consul's leader
registers that service for every server (``leader.go``
handleAliveMember); the JAX package's leader does not, and the port's
catalog stays equal to it.
"""

from __future__ import annotations

import asyncio
import logging
import random
import struct
from typing import Optional

from consul_tpu_torch.agent import cache
from consul_tpu_torch.agent.agent import Agent
from consul_tpu_torch.eventing.cluster import MemberStatus

log = logging.getLogger("consul_tpu_torch.dns")

# RR types/classes (RFC 1035 + 3596 + 6891).
TYPE_A = 1
TYPE_NS = 2
TYPE_SOA = 6
TYPE_PTR = 12
TYPE_TXT = 16
TYPE_AAAA = 28
TYPE_OPT = 41  # EDNS0 pseudo-RR (RFC 6891)
TYPE_SRV = 33
TYPE_ANY = 255
CLASS_IN = 1

RCODE_OK = 0
RCODE_SERVFAIL = 2
RCODE_NXDOMAIN = 3
RCODE_NOTIMPL = 4

UDP_PAYLOAD_MAX = 512    # pre-EDNS budget (dns.go truncation)
EDNS_PAYLOAD_MAX = 4096  # what we advertise back (dns.go setEDNS)
MAX_ANSWERS = 32  # dns.go a-record limit analogue
CONSUL_SERVICE = "consul"  # structs.ConsulServiceName
RECURSOR_TIMEOUT_S = 3.0  # dns.go recursor client timeout


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


class DNSQuestion:
    def __init__(self, name: str, qtype: int, qclass: int):
        self.name = name
        self.qtype = qtype
        self.qclass = qclass


class DNSRecord:
    def __init__(self, name: str, rtype: int, ttl: int, rdata: bytes):
        self.name = name
        self.rtype = rtype
        self.ttl = ttl
        self.rdata = rdata


def _encode_name(name: str, offsets: dict[str, int], pos: int) -> bytes:
    """RFC 1035 name encoding with compression pointers."""
    labels = [l for l in name.rstrip(".").split(".") if l]
    out = b""
    for i in range(len(labels)):
        suffix = ".".join(labels[i:])
        if suffix in offsets:
            return out + struct.pack(">H", 0xC000 | offsets[suffix])
        if pos + len(out) < 0x3FFF:
            offsets[suffix] = pos + len(out)
        label = labels[i].encode()
        out += bytes([len(label)]) + label
    return out + b"\x00"


def _decode_name(buf: bytes, pos: int) -> tuple[str, int]:
    labels = []
    jumped = False
    end = pos
    hops = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated name")
        length = buf[pos]
        if length & 0xC0 == 0xC0:
            if hops > 32:
                raise ValueError("compression loop")
            hops += 1
            ptr = struct.unpack(">H", buf[pos:pos + 2])[0] & 0x3FFF
            if not jumped:
                end = pos + 2
            pos = ptr
            jumped = True
            continue
        pos += 1
        if length == 0:
            break
        labels.append(buf[pos:pos + length].decode(errors="replace"))
        pos += length
    if not jumped:
        end = pos
    return ".".join(labels), end


def parse_query(buf: bytes) -> tuple[int, list[DNSQuestion]]:
    txid, questions, _edns = parse_query_edns(buf)
    return txid, questions


def parse_query_edns(
    buf: bytes,
) -> tuple[int, list[DNSQuestion], Optional[int]]:
    """Decode (txid, questions, edns_payload).  ``edns_payload`` is the
    client's advertised UDP payload size from an OPT pseudo-RR in the
    additional section (RFC 6891 §6.2.3), or None without EDNS."""
    txid, flags, qd, an, ns, ar = struct.unpack(">HHHHHH", buf[:12])
    pos = 12
    questions = []
    for _ in range(qd):
        name, pos = _decode_name(buf, pos)
        qtype, qclass = struct.unpack(">HH", buf[pos:pos + 4])
        pos += 4
        questions.append(DNSQuestion(name, qtype, qclass))
    edns_payload: Optional[int] = None
    try:
        for _ in range(an + ns + ar):
            _, pos = _decode_name(buf, pos)
            rtype, rclass, _ttl, rdlen = struct.unpack(
                ">HHIH", buf[pos:pos + 10])
            pos += 10 + rdlen
            if rtype == TYPE_OPT:
                # For OPT the CLASS field carries the payload size.
                edns_payload = rclass
    except (ValueError, struct.error):
        pass  # malformed tail: serve the question without EDNS
    return txid, questions, edns_payload


def build_query(txid: int, name: str, qtype: int = TYPE_A) -> bytes:
    """Client-side query encoder (used by tests and the CLI resolver)."""
    header = struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0)  # RD
    return header + _rd_name(name) + struct.pack(">HH", qtype, CLASS_IN)


def parse_response(buf: bytes) -> tuple[int, int, list[DNSRecord]]:
    """Decode (txid, rcode, answers) — rdata left raw."""
    txid, flags, qd, an, _ns, _ar = struct.unpack(">HHHHHH", buf[:12])
    pos = 12
    for _ in range(qd):
        _, pos = _decode_name(buf, pos)
        pos += 4
    answers = []
    for _ in range(an):
        name, pos = _decode_name(buf, pos)
        rtype, _rclass, ttl, rdlen = struct.unpack(">HHIH", buf[pos:pos + 10])
        pos += 10
        answers.append(DNSRecord(name, rtype, ttl, buf[pos:pos + rdlen]))
        pos += rdlen
    return txid, flags & 0xF, answers


def build_response(
    txid: int,
    questions: list[DNSQuestion],
    answers: list[DNSRecord],
    authority: list[DNSRecord],
    rcode: int,
    truncate_to: Optional[int] = UDP_PAYLOAD_MAX,
    edns: bool = False,
) -> bytes:
    flags = 0x8480 | (rcode & 0xF)  # QR|AA|RD-echo
    out = bytearray()
    offsets: dict[str, int] = {}
    # RFC 6891: when the client spoke EDNS we echo an OPT RR with our
    # own payload budget; reserve its 11 bytes from the truncation math.
    opt_rr = b"\x00" + struct.pack(
        ">HHIH", TYPE_OPT, EDNS_PAYLOAD_MAX, 0, 0) if edns else b""

    def emit_q(q: DNSQuestion) -> bytes:
        return _encode_name(q.name, offsets, 12 + len(out)) + struct.pack(
            ">HH", q.qtype, q.qclass
        )

    def emit_rr(r: DNSRecord) -> bytes:
        head = _encode_name(r.name, offsets, 12 + len(out))
        return head + struct.pack(
            ">HHIH", r.rtype, CLASS_IN, r.ttl, len(r.rdata)
        ) + r.rdata

    budget = (truncate_to - len(opt_rr)) if truncate_to else None
    for q in questions:
        out += emit_q(q)
    n_ans = 0
    truncated = False
    for r in answers:
        rr = emit_rr(r)
        if budget and 12 + len(out) + len(rr) > budget:
            truncated = True
            break
        out += rr
        n_ans += 1
    n_auth = 0
    if not truncated:
        for r in authority:
            rr = emit_rr(r)
            if budget and 12 + len(out) + len(rr) > budget:
                break
            out += rr
            n_auth += 1
    if truncated:
        flags |= 0x0200  # TC
    header = struct.pack(
        ">HHHHHH", txid, flags, len(questions), n_ans, n_auth,
        1 if edns else 0,
    )
    return header + bytes(out) + opt_rr


def _rd_a(ip: str) -> bytes:
    try:
        return bytes(int(p) for p in ip.split("."))
    except ValueError:
        return b"\x7f\x00\x00\x01"


def _rd_name(name: str) -> bytes:
    out = b""
    for label in name.rstrip(".").split("."):
        out += bytes([len(label)]) + label.encode()
    return out + b"\x00"


def _rd_srv(prio: int, weight: int, port: int, target: str) -> bytes:
    return struct.pack(">HHH", prio, weight, port) + _rd_name(target)


def _rd_txt(text: str) -> bytes:
    data = text.encode()[:255]
    return bytes([len(data)]) + data


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _split_host_port(addr: str, default_port: str = "53") -> tuple[str, str]:
    """IPv6-aware host:port split: "[::1]:53", "::1" (bare v6),
    "10.0.0.1:53", and "10.0.0.1" all parse correctly (the reference
    normalizes recursor addresses through net.SplitHostPort the same
    way, dns.go formatRecursorAddress)."""
    if addr.startswith("["):
        host, _, rest = addr[1:].partition("]")
        port = rest.lstrip(":") or default_port
        return host, port
    if addr.count(":") > 1:
        return addr, default_port  # bare IPv6, no port
    host, _, port = addr.rpartition(":")
    if not host:
        return addr, default_port
    return host, port or default_port


class DNSServer:
    """agent/dns.go DNSServer: dispatch on the .consul name space."""

    def __init__(self, agent: Agent, domain: str = "consul",
                 seed: int = 0):
        self.agent = agent
        self.domain = domain.strip(".").lower()
        self._rng = random.Random(seed)
        self._udp: Optional[asyncio.DatagramTransport] = None
        self._inflight: set[asyncio.Task] = set()
        self.addr = ""

    # DNS behavior follows the agent's live config knobs (dns_config
    # block; reloadable without restart — agent.go reloadConfigInternal).
    @property
    def node_ttl(self) -> int:
        return int(getattr(self.agent, "dns_node_ttl_s", 0.0))

    @property
    def only_passing(self) -> bool:
        return bool(getattr(self.agent, "dns_only_passing", True))

    @property
    def recursors(self) -> list[str]:
        """Upstream resolvers for non-.consul names (dns.go
        handleRecurse; config ``dns_config.recursors``)."""
        return list(getattr(self.agent, "dns_recursors", []) or [])

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        loop = asyncio.get_running_loop()
        server = self

        class Proto(asyncio.DatagramProtocol):
            def connection_made(self, transport):
                self.transport = transport

            def datagram_received(self, data, addr):
                # Hold a strong reference until done, or the loop's weak
                # ref lets the in-flight resolution be GC'd mid-query.
                task = asyncio.ensure_future(
                    server._handle(self.transport, data, addr)
                )
                server._inflight.add(task)
                task.add_done_callback(server._inflight.discard)

        self._udp, _ = await loop.create_datagram_endpoint(
            Proto, local_addr=(host, port)
        )
        h, p = self._udp.get_extra_info("sockname")[:2]
        self.addr = f"{h}:{p}"
        return self.addr

    async def stop(self) -> None:
        if self._udp:
            self._udp.close()

    async def _handle(self, transport, data: bytes, addr) -> None:
        try:
            txid, questions, edns_payload = parse_query_edns(data)
        except (ValueError, struct.error):
            return
        try:
            resp = await self.answer(txid, questions,
                                     edns_payload=edns_payload,
                                     raw_query=data)
        except Exception:  # noqa: BLE001
            log.exception("dns handler failed")
            resp = build_response(txid, questions, [], [], RCODE_NOTIMPL)
        transport.sendto(resp, addr)

    # -- resolution (dns.go:427 handleQuery → dispatch) -----------------

    async def answer(self, txid: int, questions: list[DNSQuestion],
                     edns_payload: Optional[int] = None,
                     raw_query: Optional[bytes] = None) -> bytes:
        edns = edns_payload is not None
        # RFC 6891 payload negotiation replaces the fixed 512 B budget
        # (dns.go setEDNS / truncation math).
        budget = UDP_PAYLOAD_MAX
        if edns:
            budget = max(UDP_PAYLOAD_MAX,
                         min(int(edns_payload), EDNS_PAYLOAD_MAX))

        def respond(answers, authority, rcode):
            return build_response(txid, questions, answers, authority,
                                  rcode, truncate_to=budget, edns=edns)

        if not questions:
            return respond([], [], RCODE_NXDOMAIN)
        q = questions[0]
        name = q.name.lower().rstrip(".")
        labels = name.split(".")
        domain_labels = self.domain.split(".")
        # Label-boundary match: "web.service.notconsul" and
        # "anythingconsul" are NOT ours (dns.go trimDomain).
        if labels[-len(domain_labels):] != domain_labels:
            # dns.go registers "arpa." for reverse lookups and "." for
            # recursor forwarding.
            if labels[-1] == "arpa":
                try:
                    answers = await self._ptr_lookup(labels, q)
                except LookupError:
                    answers = []
                if answers:
                    return respond(answers, [], RCODE_OK)
                if self.recursors and raw_query is not None:
                    return await self._recurse(txid, questions, raw_query)
                return respond([], [self._soa()], RCODE_NXDOMAIN)
            if self.recursors and raw_query is not None:
                return await self._recurse(txid, questions, raw_query)
            return respond([], [], RCODE_NXDOMAIN)
        core = labels[: -len(domain_labels)]
        answers: list[DNSRecord] = []
        rcode = RCODE_OK

        try:
            if not core or core == [""]:
                answers = [self._soa()]
            elif core[-1] == "node" or (len(core) >= 2 and core[-2] == "node"):
                answers = await self._node_lookup(core, q)
            elif "service" in core:
                answers = await self._service_lookup(core, q)
            elif core[-1] == "query":
                answers = await self._query_lookup(core, q)
            else:
                rcode = RCODE_NXDOMAIN
        except LookupError:
            rcode = RCODE_NXDOMAIN

        if not answers and rcode == RCODE_OK:
            rcode = RCODE_NXDOMAIN
        authority = [] if answers else [self._soa()]
        return respond(answers, authority, rcode)

    async def _ptr_lookup(self, labels: list[str],
                          q: DNSQuestion) -> list[DNSRecord]:
        """Reverse lookups over the node address index
        (dns.go:199 registers ``arpa.`` → handlePtr at :324): the
        in-addr.arpa octets reverse into an IPv4 address, matched
        against catalog node addresses; service addresses answer with
        their service name."""
        if labels[-2:] != ["in-addr", "arpa"] or len(labels) < 3:
            raise LookupError(".".join(labels))
        ip = ".".join(reversed(labels[:-2]))
        out = await self.agent.cached_rpc(
            cache.CATALOG_LIST_NODES, {"allow_stale": True}
        )
        recs = []
        for node in out.get("nodes") or []:
            if node.get("address") == ip:
                target = f"{node['node']}.node.{self.domain}."
                recs.append(DNSRecord(q.name, TYPE_PTR, self.node_ttl,
                                      _rd_name(target)))
        if not recs:
            # handlePtr also answers for service addresses
            # (dns.go:376-393 checkServiceNodes by ServiceAddress).
            svc_out = await self.agent.cached_rpc(
                cache.CATALOG_SERVICES_DUMP, {"allow_stale": True}
            )
            for svc in svc_out.get("services") or []:
                if svc.get("address") == ip:
                    target = (f"{svc['service']}.service."
                              f"{self.domain}.")
                    recs.append(DNSRecord(
                        q.name, TYPE_PTR, self.node_ttl,
                        _rd_name(target)))
        if not recs:
            raise LookupError(ip)
        return recs

    async def _recurse(self, txid: int, questions: list[DNSQuestion],
                       raw_query: bytes) -> bytes:
        """Forward the raw query to the configured recursors in order
        (dns.go handleRecurse): first response wins, SERVFAIL when all
        fail."""
        loop = asyncio.get_running_loop()
        for recursor in self.recursors:
            host, port = _split_host_port(recursor)
            try:
                reply_fut: asyncio.Future = loop.create_future()

                class _Client(asyncio.DatagramProtocol):
                    def connection_made(self, transport):
                        transport.sendto(raw_query)

                    def datagram_received(self, data, _addr):
                        if not reply_fut.done():
                            reply_fut.set_result(data)

                    def error_received(self, exc):
                        if not reply_fut.done():
                            reply_fut.set_exception(exc)

                transport, _ = await loop.create_datagram_endpoint(
                    _Client, remote_addr=(host, int(port))
                )
                try:
                    return await asyncio.wait_for(
                        reply_fut, RECURSOR_TIMEOUT_S)
                finally:
                    transport.close()
            except (OSError, asyncio.TimeoutError, ValueError) as e:
                log.warning("recursor %s failed: %s", recursor, e)
        return build_response(txid, questions, [], [], RCODE_SERVFAIL)

    def _soa(self) -> DNSRecord:
        """dns.go soa(): ns.<domain> authority record."""
        rdata = (
            _rd_name(f"ns.{self.domain}")
            + _rd_name(f"hostmaster.{self.domain}")
            + struct.pack(">IIIII", 1, 3600, 600, 86400, 0)
        )
        return DNSRecord(self.domain, TYPE_SOA, 0, rdata)

    async def _node_lookup(self, core: list[str], q: DNSQuestion) -> list[DNSRecord]:
        """<node>.node[.<dc>].consul (dns.go nodeLookup)."""
        idx = core.index("node") if "node" in core else len(core) - 1
        node = ".".join(core[:idx])
        out = await self.agent.cached_rpc(
            cache.NODE_INFO, {"node": node, "allow_stale": True}
        )
        dump = out.get("dump") or []
        if not dump:
            raise LookupError(node)
        addr = dump[0]["node"].get("address", "")
        recs = [DNSRecord(q.name, TYPE_A, self.node_ttl, _rd_a(addr))]
        if q.qtype == TYPE_TXT:
            meta = dump[0]["node"].get("meta", {})
            recs = [
                DNSRecord(q.name, TYPE_TXT, self.node_ttl,
                          _rd_txt(f"{k}={v}"))
                for k, v in meta.items()
            ] or [DNSRecord(q.name, TYPE_TXT, self.node_ttl, _rd_txt(""))]
        return recs

    async def _service_lookup(self, core: list[str], q: DNSQuestion) -> list[DNSRecord]:
        """[<tag>.]<service>.service[.<dc>] and RFC 2782
        _<service>._<proto> forms (dns.go serviceLookup)."""
        svc_idx = core.index("service")
        head = core[:svc_idx]
        tag = None
        if len(head) == 1:
            service = head[0]
        elif len(head) == 2:
            tag, service = head[0], head[1]
        else:
            raise LookupError(".".join(core))
        if service.startswith("_"):  # RFC 2782: _svc._tag
            service = service[1:]
            if tag and tag.startswith("_"):
                tag = tag[1:]
        # RFC 2782 ordering puts service first: _web._tcp → head is
        # [_web, _tcp] so swap after underscore stripping.
        if tag and head[0].startswith("_"):
            service, tag = head[0][1:], head[1].lstrip("_")
            if tag == "tcp" or tag == "udp":
                tag = None
        body = {"service": service, "allow_stale": True,
                "passing_only": self.only_passing}
        if tag:
            body["tag"] = tag
        out = await self.agent.cached_rpc(cache.HEALTH_SERVICES, body)
        # Cached values are shared: copy before shuffling.
        rows = list(out.get("nodes") or [])
        if not rows and service == CONSUL_SERVICE and not tag:
            rows = self._consul_servers()
        if not rows:
            raise LookupError(service)
        self._rng.shuffle(rows)
        rows = rows[:MAX_ANSWERS]
        recs = []
        for row in rows:
            svc = row["service"]
            ip = svc.get("address") or svc.get("node_address") or ""
            if q.qtype == TYPE_SRV:
                target = f"{svc['node']}.node.{self.domain}."
                recs.append(DNSRecord(
                    q.name, TYPE_SRV, self.node_ttl,
                    _rd_srv(1, 1, int(svc.get("port", 0)), target),
                ))
                recs.append(DNSRecord(
                    target.rstrip("."), TYPE_A, self.node_ttl, _rd_a(ip)
                ))
            else:
                recs.append(DNSRecord(q.name, TYPE_A, self.node_ttl,
                                      _rd_a(ip)))
        return recs

    def _consul_servers(self) -> list[dict]:
        """The ``consul`` service rows of this datacenter's alive servers
        in the agent's LAN pool, each at its gossip address (as the
        leader registers a node) and its RPC port."""
        dc = self.agent.config.datacenter
        rows = []
        for m in sorted(self.agent.serf.members.values(),
                        key=lambda m: m.name):
            if (m.status != MemberStatus.ALIVE
                    or m.tags.get("role") != "consul"
                    or m.tags.get("dc") != dc):
                continue
            port = m.tags.get("rpc_addr", "").rpartition(":")[2]
            rows.append({"service": {
                "node": m.name, "address": m.addr,
                "port": int(port) if port.isdigit() else 0}})
        return rows

    async def _query_lookup(self, core: list[str], q: DNSQuestion) -> list[DNSRecord]:
        """<name-or-id>.query.consul (dns.go preparedQueryLookup)."""
        name = ".".join(core[:-1])
        out = await self.agent.cached_rpc(
            cache.PREPARED_QUERY, {"query_id": name, "allow_stale": True}
        )
        if out.get("error"):
            raise LookupError(name)
        rows = list(out.get("nodes") or [])
        if not rows:
            raise LookupError(name)
        self._rng.shuffle(rows)
        recs = []
        for row in rows[:MAX_ANSWERS]:
            svc = row["service"]
            ip = svc.get("address") or svc.get("node_address") or ""
            if q.qtype == TYPE_SRV:
                target = f"{svc['node']}.node.{self.domain}."
                recs.append(DNSRecord(
                    q.name, TYPE_SRV, self.node_ttl,
                    _rd_srv(1, 1, int(svc.get("port", 0)), target),
                ))
                recs.append(DNSRecord(
                    target.rstrip("."), TYPE_A, self.node_ttl, _rd_a(ip)
                ))
            else:
                recs.append(DNSRecord(q.name, TYPE_A, self.node_ttl,
                                      _rd_a(ip)))
        return recs
