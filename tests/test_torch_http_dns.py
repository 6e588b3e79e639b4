"""The port's HTTP API and DNS (``consul_tpu_torch.agent.http``, ``.dns``)
beside the JAX package's, on the CPU.

* The reference's own scenarios on both packages (loaded as in
  ``tests/test_torch_agent.py``): ``tests/test_http_dns.py``, the HTTP
  cases of ``tests/test_acl.py``, ``TestFederationHTTP`` of
  ``tests/test_federation.py``, ``tests/test_realsocket_agent.py`` and
  ``test_segment_http_surface`` of ``tests/test_cluster_agents.py`` and the
  HTTP case of ``tests/test_multidc_host.py``.
  Left out, because they need what is not ported yet: the Connect CA
  watch case and the API client's watch parser of
  ``test_realsocket_agent.py``, and ``AutoEncrypt.Sign`` of
  ``test_acl.py``.
* A one-server datacenter of each package with ACLs on gets the same
  seeded stream of HTTP requests over the ported routes, errors and
  denied requests among them.  Status, the ``X-Consul-*`` headers and
  the body bytes must be equal once generated IDs (UUIDs, numbered by
  first appearance) and wall-clock fields are mapped out.
* A fixed list of DNS questions whose wire answers are byte-equal.
* A 64-member pool simulated by each package's ``SimBridge``, one server
  in its ``pool`` segment and one client ``Agent``: after the crash the
  client's ``/v1/health/state/critical`` and its DNS answers for the pool's
  members agree between the packages.
* What waits for Connect fails loudly on the port.
"""

import asyncio
import gzip
import inspect
import json
import random
import re
import types

import pytest

from helpers import wait_for as wait_until
from helpers import wait_for_leader

import consul_tpu.agent.agent as j_agent
import consul_tpu.agent.dns as j_dns
import consul_tpu.agent.http as j_http
import consul_tpu.agent.server as j_server
import consul_tpu.agent.snapshot as j_snapshot
import consul_tpu.net.memberlist as j_memberlist
import consul_tpu.net.transport as j_transport
import consul_tpu.protocol as j_protocol
import consul_tpu_torch.agent.agent as t_agent
import consul_tpu_torch.agent.dns as t_dns
import consul_tpu_torch.agent.http as t_http
import consul_tpu_torch.agent.server as t_server
import consul_tpu_torch.agent.snapshot as t_snapshot
import consul_tpu_torch.net.memberlist as t_memberlist
import consul_tpu_torch.net.transport as t_transport
import consul_tpu_torch.protocol as t_protocol
from test_torch_agent import case_id, reference_cases, run_reference_case
from torch_parity import one_torch_thread  # noqa: F401 (fixture)


def _namespace(agent, dns, http, server, snapshot, memberlist, transport,
               protocol, name):
    return types.SimpleNamespace(
        name=name, Agent=agent.Agent, AgentConfig=agent.AgentConfig,
        dns=dns, HTTPApi=http.HTTPApi, Server=server.Server,
        ServerConfig=server.ServerConfig, read_archive=snapshot.read_archive,
        NodeStatus=memberlist.NodeStatus,
        InMemoryNetwork=transport.InMemoryNetwork,
        GossipProfile=protocol.GossipProfile)


PACKAGES = {
    "jax": _namespace(j_agent, j_dns, j_http, j_server, j_snapshot,
                      j_memberlist, j_transport, j_protocol, "jax"),
    "torch": _namespace(t_agent, t_dns, t_http, t_server, t_snapshot,
                        t_memberlist, t_transport, t_protocol, "torch"),
}

# ---------------------------------------------------------------------------
# the reference's scenarios
# ---------------------------------------------------------------------------

NOT_PORTED = {
    "TestNewWatchTypes.test_connect_roots_leaf_and_agent_service_watches",
    "test_unknown_watch_type_rejected",
    "TestHardenedSurfaces.test_auto_encrypt_sign_requires_node_write",
}


def _is_http(qualname, fn) -> bool:
    src = inspect.getsource(fn)
    return ("http_call" in src or "acl_stack" in src) and \
        qualname not in NOT_PORTED


CASES = (
    reference_cases("test_http_dns")
    + reference_cases("test_acl", _is_http)
    + reference_cases("test_federation", lambda q, fn: q.startswith(
        "TestFederationHTTP."))
    + reference_cases("test_realsocket_agent",
                      lambda q, fn: q not in NOT_PORTED)
    + reference_cases("test_cluster_agents", lambda q, fn: q.endswith(
        ".test_segment_http_surface"))
    + reference_cases("test_multidc_host", _is_http)
)


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_reference_scenario(case, package, request):
    run_reference_case(case, package, request)


def test_reference_cases_found():
    """21 HTTP/DNS, 15 ACL-over-HTTP, 1 federation, 2 real-socket, 1
    segment and 1 cross-datacenter scenario."""
    counts = {}
    for name, _ in CASES:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {"test_http_dns": 21, "test_acl": 15,
                      "test_federation": 1, "test_realsocket_agent": 2,
                      "test_cluster_agents": 1, "test_multidc_host": 1}


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------


async def http(addr, method, path, body=b"", token=None):
    """One HTTP/1.1 exchange: ``(status, headers, payload)``, the payload
    as sent (inflated where gzip)."""
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    lines = [f"{method} {path} HTTP/1.1", f"Host: {host}",
             f"Content-Length: {len(body)}", "Connection: close"]
    if token is not None:
        lines.append(f"X-Consul-Token: {token}")
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    head_lines = head.decode().split("\r\n")
    headers = {}
    for line in head_lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    if headers.get("content-encoding") == "gzip":
        payload = gzip.decompress(payload)
    return int(head_lines[0].split()[1]), headers, payload


async def dns_raw(addr, query: bytes) -> bytes:
    host, port = addr.rsplit(":", 1)
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
            transport.sendto(query)

        def datagram_received(self, data, _addr):
            if not fut.done():
                fut.set_result(data)

    transport, _ = await loop.create_datagram_endpoint(
        Proto, remote_addr=(host, int(port)))
    try:
        return await asyncio.wait_for(fut, 5)
    finally:
        transport.close()


CADENCE = dict(gossip_interval_scale=0.05, sync_interval_s=0.3,
               sync_retry_interval_s=0.2, reconcile_interval_s=0.2)


# ---------------------------------------------------------------------------
# the seeded HTTP stream
# ---------------------------------------------------------------------------

MASTER = "master-token"
BOGUS = "not-a-token"
STREAM_SEED = 16
STREAM_REQUESTS = 240
NODES = ("n0", "n1", "n2", "n3")
SERVICES = ("web", "db", "api")
KEYS = ("app/a", "app/b", "app/c/d", "cfg/x", "cfg/y", "z")
UUID_RE = re.compile(
    rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
# JSON fields whose value is the wall clock or its age.
TIME_RE = re.compile(
    rb'"(LastContact|ExpirationTime|StableSinceS)":\s*[-0-9.e+]+')
HEADERS = ("x-consul-index", "x-consul-knownleader", "x-consul-lastcontact",
           "content-type", "allow", "location")


def _req(method, path, body=None, token=MASTER, save=None, local=False):
    """One request of the stream.  ``path``, ``body`` and ``token`` may name
    a value of an earlier reply as ``<<name>>`` (``save`` keeps a reply's
    ``ID``, or the field it names, under ``name``); ``local`` marks a write
    to the agent's own state, after which the stream waits for
    anti-entropy to settle."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body)
    if isinstance(save, str):
        save = (save, "ID")
    return {"method": method, "path": path, "body": body or "",
            "token": token, "save": save, "local": local}


def _prologue(ids):
    kv_rules = json.dumps({
        "key_prefix": {"app/": {"policy": "write"}, "": {"policy": "read"}},
        "node_prefix": {"": {"policy": "read"}},
        "service_prefix": {"web": {"policy": "write"},
                           "": {"policy": "read"}},
        "session_prefix": {"": {"policy": "write"}},
        "query_prefix": {"": {"policy": "write"}},
        "event_prefix": {"deploy": {"policy": "write"}},
        "agent_prefix": {"": {"policy": "read"}}})
    ro_rules = json.dumps({"key_prefix": {"": {"policy": "read"}},
                           "node_prefix": {"": {"policy": "read"}},
                           "service_prefix": {"": {"policy": "read"}}})
    return [
        _req("GET", "/v1/status/leader", token=None),
        _req("GET", "/v1/status/peers", token=None),
        _req("PUT", "/v1/kv/app/a", "0", token=None),
        _req("PUT", "/v1/acl/bootstrap", token=None, save=("boot",
                                                           "SecretID")),
        _req("PUT", "/v1/kv/cfg/x", "b", token="<<boot>>"),
        _req("DELETE", "/v1/acl/token/<<boot>>"),
        _req("PUT", "/v1/acl/policy", {"ID": ids["pol_kv"], "Name": "kv",
                                       "Rules": kv_rules}),
        _req("PUT", "/v1/acl/policy", {"ID": ids["pol_ro"], "Name": "ro",
                                       "Rules": ro_rules}),
        _req("PUT", "/v1/acl/policy", {"Name": "scratch", "Rules": "{}"},
             save="scratch"),
        _req("GET", "/v1/acl/policy/<<scratch>>"),
        _req("DELETE", "/v1/acl/policy/<<scratch>>"),
        _req("PUT", "/v1/acl/token", {"SecretID": ids["tok_kv"],
                                      "Policies": [ids["pol_kv"]]}),
        _req("PUT", "/v1/acl/token", {"SecretID": ids["tok_ro"],
                                      "Policies": [ids["pol_ro"]]}),
        _req("PUT", "/v1/acl/token", {"Roles": ["nope"]}),
        _req("PUT", "/v1/acl/role", {"Name": "team", "Policies":
                                     [ids["pol_ro"]]}, save="role"),
        _req("GET", "/v1/acl/role/<<role>>"),
        _req("GET", "/v1/acl/role/name/team"),
        _req("DELETE", "/v1/acl/role/<<role>>"),
        _req("PUT", "/v1/catalog/register", {
            "Node": "n0", "Address": "10.0.0.1", "NodeMeta": {"rack": "r1"},
            "Service": {"Service": "web", "Port": 80, "Tags": ["v1"]},
            "Checks": [{"CheckID": "alive", "Status": "passing"}]}),
        _req("PUT", "/v1/session/create", {"Node": "n0", "LockDelay": 0,
                                           "Checks": ["alive"]},
             save="sess"),
        _req("GET", "/v1/session/info/<<sess>>"),
        _req("PUT", "/v1/kv/app/lock?acquire=<<sess>>", "held"),
        _req("PUT", "/v1/kv/app/lock?release=<<sess>>", "free"),
        _req("PUT", "/v1/session/destroy/<<sess>>"),
        _req("POST", "/v1/query", {"Name": "webq",
                                   "Service": {"Service": "web"}},
             save="query"),
        _req("GET", "/v1/query/<<query>>"),
        _req("GET", "/v1/query/<<query>>/execute"),
        _req("DELETE", "/v1/query/<<query>>"),
        _req("POST", "/v1/connect/intentions", {"Source": "api",
                                                "Destination": "web",
                                                "Action": "allow"},
             save="ixn"),
        _req("GET", "/v1/connect/intentions/<<ixn>>"),
        _req("GET", "/v1/connect/intentions/check?source=api&destination=web"),
        _req("DELETE", "/v1/connect/intentions/<<ixn>>"),
    ]


def _stream(seed=STREAM_SEED, n=STREAM_REQUESTS):
    """The prologue, then ``n`` requests drawn over the routes with a
    token drawn for each (mostly the master token, else the limited, the
    read-only, the anonymous or an unknown one), then a snapshot and a
    few reads."""
    rng = random.Random(seed)

    def uid():
        return "%08x-%04x-4%03x-8%03x-%012x" % (
            rng.getrandbits(32), rng.getrandbits(16), rng.getrandbits(12),
            rng.getrandbits(12), rng.getrandbits(48))

    ids = {k: uid() for k in ("pol_kv", "pol_ro", "tok_kv", "tok_ro")}
    # Generated IDs would order the lists that hold them differently in
    # every run: the seeded part names its sessions and intentions.
    sessions = [uid() for _ in range(4)]
    intentions = [uid() for _ in range(4)]
    reqs = _prologue(ids)

    def token():
        return rng.choices([MASTER, ids["tok_kv"], ids["tok_ro"], None, BOGUS],
                           weights=[10, 4, 2, 2, 1])[0]

    def key():
        return rng.choice(KEYS)

    def draw():
        c = rng.randrange(34)
        t = token()
        node, svc = rng.choice(NODES), rng.choice(SERVICES)
        if c == 0:
            return _req("PUT", f"/v1/kv/{key()}", f"v{rng.randrange(99)}",
                        token=t)
        if c == 1:
            flag = rng.choice(["", "?raw", "?recurse", "?keys",
                               "?keys&separator=/", "?stale", "?consistent",
                               "?index=1&wait=1ms"])
            return _req("GET", f"/v1/kv/{key()}{flag}", token=t)
        if c == 2:
            flag = rng.choice(["", "?recurse", f"?cas={rng.randrange(40)}"])
            return _req("DELETE", f"/v1/kv/{key()}{flag}", token=t)
        if c == 3:
            return _req("PUT", f"/v1/kv/{key()}?cas={rng.randrange(40)}"
                        f"&flags={rng.randrange(3)}", "c", token=t)
        if c == 4:
            body = {"Node": node, "Address": f"10.0.0.{NODES.index(node)}",
                    "Service": {"Service": svc, "Port": rng.randrange(1, 9),
                                "Tags": rng.sample(["v1", "v2", "x"], 2)}}
            if rng.random() < 0.5:
                body["Checks"] = [{"CheckID": f"c-{svc}", "ServiceID": svc,
                                   "Status": rng.choice(
                                       ["passing", "warning", "critical"])}]
            return _req("PUT", "/v1/catalog/register", body, token=t)
        if c == 5:
            return _req("PUT", "/v1/catalog/deregister",
                        {"Node": node, "ServiceID": svc}, token=t)
        if c == 6:
            return _req("GET", rng.choice([
                "/v1/catalog/nodes", "/v1/catalog/services",
                "/v1/catalog/datacenters", f"/v1/catalog/node/{node}",
                f"/v1/catalog/service/{svc}", f"/v1/catalog/service/{svc}"
                "?tag=v1", "/v1/catalog/nodes?filter=Node%20%3D%3D%20%22n1%22",
                "/v1/catalog/nodes?filter=Node%20%3D%3D", "/v1/catalog/nodes"
                "?pretty"]), token=t)
        if c == 7:
            return _req("GET", rng.choice([
                f"/v1/health/node/{node}", f"/v1/health/checks/{svc}",
                f"/v1/health/service/{svc}", f"/v1/health/service/{svc}"
                "?passing", "/v1/health/state/any",
                "/v1/health/state/critical", "/v1/health/state/passing",
                f"/v1/health/connect/{svc}"]), token=t)
        if c == 8:
            body = {"Name": svc, "ID": f"{svc}-local", "Port": 8000,
                    "Tags": ["local"]}
            if rng.random() < 0.5:
                body["Check"] = {"TTL": "1h"}
            return _req("PUT", "/v1/agent/service/register", body, token=t,
                        local=True)
        if c == 9:
            return _req("PUT", f"/v1/agent/service/deregister/{svc}-local",
                        token=t, local=True)
        if c == 10:
            verb = rng.choice(["pass", "warn", "fail"])
            return _req("PUT", f"/v1/agent/check/{verb}/service:{svc}-local"
                        f"?note={verb}", token=t, local=True)
        if c == 11:
            return _req("PUT", "/v1/agent/check/register",
                        {"Name": f"mem-{node}", "TTL": "1h"}, token=t,
                        local=True)
        if c == 12:
            return _req("PUT", f"/v1/agent/check/deregister/mem-{node}",
                        token=t, local=True)
        if c == 13:
            return _req("GET", rng.choice([
                "/v1/agent/services", "/v1/agent/checks",
                "/v1/agent/members", "/v1/agent/self", "/v1/agent/segments",
                f"/v1/agent/service/{svc}-local"]), token=t)
        if c == 14:
            return _req("PUT", "/v1/session/create",
                        {"ID": rng.choice(sessions), "LockDelay": 0,
                         "Node": rng.choice(("s0",) + NODES), "Name": svc},
                        token=t)
        if c == 15:
            return _req("GET", rng.choice([
                "/v1/session/list", f"/v1/session/node/{node}",
                "/v1/session/node/s0",
                f"/v1/session/info/{rng.choice(sessions)}"]), token=t)
        if c == 16:
            return _req("PUT", f"/v1/session/destroy/{rng.choice(sessions)}",
                        token=t)
        if c == 17:
            return _req("PUT", f"/v1/event/fire/{rng.choice(['deploy', 'x'])}",
                        f"p{rng.randrange(9)}", token=t)
        if c == 18:
            return _req("GET", rng.choice([
                "/v1/coordinate/nodes", f"/v1/coordinate/node/{node}"]),
                token=t)
        if c == 19:
            return _req("POST", "/v1/query", {
                "Name": f"q-{svc}", "Service": {"Service": svc}}, token=t)
        if c == 20:
            return _req("GET", rng.choice([
                "/v1/query", f"/v1/query/{uid()}",
                f"/v1/query/q-{svc}/execute"]), token=t)
        if c == 21:
            ops = [{"KV": {"Verb": "set", "Key": key(), "Value": "dHhu"}},
                   {"KV": {"Verb": rng.choice(["get", "cas", "delete"]),
                           "Key": key(), "Index": rng.randrange(30)}}]
            return _req("PUT", "/v1/txn", ops, token=t)
        if c == 22:
            return _req("PUT", "/v1/config", {
                "Kind": "service-defaults", "Name": svc,
                "Protocol": rng.choice(["http", "tcp"])}, token=t)
        if c == 23:
            return _req(rng.choice(["GET", "DELETE"]),
                        f"/v1/config/service-defaults/{svc}", token=t)
        if c == 24:
            return _req("GET", rng.choice([
                "/v1/config/service-defaults", "/v1/operator/raft/"
                "configuration", "/v1/operator/autopilot/configuration",
                "/v1/operator/autopilot/health"]), token=t)
        if c == 25:
            return _req("POST", "/v1/connect/intentions", {
                "ID": rng.choice(intentions), "Source": rng.choice(SERVICES),
                "Destination": svc, "Action": rng.choice(
                    ["allow", "deny"])}, token=t)
        if c == 26:
            return _req("GET", rng.choice([
                "/v1/connect/intentions", "/v1/connect/intentions/check"
                f"?source={rng.choice(SERVICES)}&destination={svc}",
                f"/v1/connect/intentions/{rng.choice(intentions)}"]),
                token=t)
        if c == 27:
            return _req("GET", rng.choice([
                "/v1/acl/tokens", "/v1/acl/policies", "/v1/acl/roles",
                f"/v1/acl/token/{ids['tok_ro']}",
                f"/v1/acl/policy/{ids['pol_kv']}", f"/v1/acl/policy/{uid()}",
                "/v1/acl/auth-methods", "/v1/acl/binding-rules"]), token=t)
        if c == 28:
            return _req("GET", rng.choice([
                "/v1/internal/federation-states",
                "/v1/internal/federation-state/dc1",
                "/v1/internal/federation-states/mesh-gateways"]), token=t)
        if c == 29:
            return _req(rng.choice(["GET", "PUT", "DELETE"]), rng.choice([
                "/v1/nope", "/v1/status/leader", "/v1/agent/members",
                "/v1/session/create"]), token=t)
        if c == 30:
            return _req("PUT", rng.choice([
                "/v1/catalog/register", "/v1/session/create",
                "/v1/agent/check/register"]), "{not json", token=t)
        if c == 31:
            return _req("PUT", f"/v1/agent/maintenance?enable="
                        f"{rng.choice(['true', 'false', 'maybe'])}"
                        "&reason=drill", token=t, local=True)
        if c == 32:
            return _req("PUT", f"/v1/agent/service/maintenance/{svc}-local"
                        f"?enable={rng.choice(['true', 'false'])}", token=t,
                        local=True)
        return _req("GET", rng.choice(["/v1/status/leader",
                                       "/v1/status/peers", "/ui", "/"]),
                    token=t)

    reqs += [draw() for _ in range(n)]
    reqs += [
        _req("GET", "/v1/snapshot"),
        _req("GET", "/v1/snapshot", token=ids["tok_ro"]),
        _req("GET", "/v1/event/list"),
        _req("GET", "/v1/catalog/nodes"),
        _req("GET", "/v1/health/state/any"),
        _req("GET", "/v1/kv/?recurse"),
    ]
    return reqs


def _fill(text: str, saved: dict) -> str:
    for name, value in saved.items():
        text = text.replace(f"<<{name}>>", value)
    return text


async def _settle(agent):
    """Wait until anti-entropy has nothing left to push and Raft has
    applied everything it holds."""
    srv = agent.delegate
    for _ in range(500):
        local = agent.local
        raft = srv.raft
        if (all(e.in_sync for e in local.services.values())
                and all(e.in_sync for e in local.checks.values())
                and raft.commit_index == raft.last_index() == raft.last_applied):
            await asyncio.sleep(0.02)
            if raft.last_applied == raft.last_index():
                return
        await asyncio.sleep(0.01)
    raise AssertionError("anti-entropy never settled")


async def _run_stream(pkg, reqs):
    net = pkg.InMemoryNetwork()
    agent = pkg.Agent(
        pkg.AgentConfig(node_name="s0", bootstrap_expect=1, acl_enabled=True,
                        acl_default_policy="deny", acl_master_token=MASTER,
                        acl_agent_token=MASTER,
                        **{**CADENCE, "sync_interval_s": 3600.0}),
        gossip_transport=net.new_transport("s0:gossip"),
        rpc_transport=net.new_transport("s0:rpc"),
    )
    agent.delegate.config.federation_state_ae_interval_s = 3600.0
    agent.delegate.config.acl_token_ttl_s = 3600.0
    await agent.start()
    await wait_for_leader([agent.delegate])
    await wait_until(lambda: agent.delegate.store.node("s0")[1] is not None,
                     msg="s0 reconciled into its catalog")
    await agent.syncer.synced_once.wait()
    api = pkg.HTTPApi(agent)
    addr = await api.start()
    saved: dict = {}
    replies = []
    fired = 0
    try:
        for r in reqs:
            path, body = (_fill(r[k], saved) for k in ("path", "body"))
            token = r["token"] and _fill(r["token"], saved)
            status, headers, payload = await http(
                addr, r["method"], path, body.encode(), token=token)
            if r["save"]:
                name, field = r["save"]
                saved[name] = (json.loads(payload)[field]
                               if status == 200 else "refused")
            if r["local"]:
                await _settle(agent)
            if path.startswith("/v1/event/fire") and status == 200:
                fired += 1
                await wait_until(lambda: len(agent.events) == fired,
                                 msg="the event heard")
            replies.append((path, status, headers, payload))
    finally:
        await api.stop()
        await agent.shutdown()
    return replies


class _Canon:
    """Maps generated IDs (numbered by first appearance) and wall-clock
    fields out of a run's bytes; an archive becomes its state and meta."""

    def __init__(self, read_archive):
        self.ids: dict = {}
        self.read_archive = read_archive

    def _id(self, m):
        return self.ids.setdefault(m.group(0),
                                   b"<id %d>" % len(self.ids))

    def text(self, raw: bytes) -> bytes:
        return TIME_RE.sub(rb'"\1":<time>', UUID_RE.sub(self._id, raw))

    def reply(self, path, status, headers, payload):
        kept = {k: self.text(headers[k].encode()) for k in HEADERS
                if k in headers}
        if headers.get("content-type") == "application/x-gzip":
            state, meta = self.read_archive(payload)
            payload = json.dumps([state, meta], sort_keys=True,
                                 default=repr).encode()
        return self.text(path.encode()), status, kept, self.text(payload)


def test_http_stream_equal():
    reqs = _stream()
    assert len(reqs) >= 250
    got = {}
    for name in ("jax", "torch"):
        pkg = PACKAGES[name]
        replies = asyncio.run(asyncio.wait_for(_run_stream(pkg, reqs), 240))
        canon = _Canon(pkg.read_archive)
        got[name] = [canon.reply(*r) for r in replies]
    assert len(got["jax"]) == len(got["torch"]) == len(reqs)
    for i, (want, have) in enumerate(zip(got["jax"], got["torch"])):
        assert want == have, (i, reqs[i], want, have)
    statuses = [status for _, status, _, _ in got["torch"]]
    assert statuses.count(403) >= 10, statuses
    assert sum(s >= 400 and s != 403 for s in statuses) >= 20, statuses


# ---------------------------------------------------------------------------
# DNS answers, byte for byte
# ---------------------------------------------------------------------------

DNS_CATALOG = [
    {"Node": "n0", "Address": "10.0.0.1",
     "NodeMeta": {"rack": "r1", "zone": "a"},
     "Service": {"Service": "web", "Port": 80, "Tags": ["v1"]},
     "Checks": [{"CheckID": "web-ok", "ServiceID": "web",
                 "Status": "passing"}]},
    {"Node": "n1", "Address": "10.0.0.2",
     "Service": {"Service": "web", "Port": 81, "Tags": ["v2"]},
     "Checks": [{"CheckID": "web-ok", "ServiceID": "web",
                 "Status": "passing"}]},
    {"Node": "n2", "Address": "10.0.0.3",
     "Service": {"Service": "web", "Port": 82, "Tags": ["v1"]},
     "Checks": [{"CheckID": "web-ok", "ServiceID": "web",
                 "Status": "critical"}]},
    {"Node": "n3", "Address": "10.0.0.4",
     "Service": {"Service": "db", "Port": 5432, "Tags": ["primary"]}},
]
DNS_QUESTIONS = [
    ("n0.node.consul", "A"), ("n0.node.dc1.consul", "A"),
    ("n0.node.consul", "TXT"), ("n3.node.consul", "TXT"),
    ("s0.node.consul", "A"), ("web.service.consul", "A"),
    ("web.service.consul", "SRV"), ("v1.web.service.consul", "A"),
    ("v1.web.service.consul", "SRV"), ("_web._tcp.service.consul", "SRV"),
    ("primary.db.service.consul", "SRV"), ("db.service.dc1.consul", "A"),
    ("2.0.0.10.in-addr.arpa", "PTR"), ("4.0.0.10.in-addr.arpa", "PTR"),
    ("nope.node.consul", "A"), ("nope.service.consul", "SRV"),
    ("v9.web.service.consul", "A"), ("consul", "SOA"), ("consul", "NS"),
]


async def _dns_answers(pkg):
    net = pkg.InMemoryNetwork()
    agent = pkg.Agent(pkg.AgentConfig(node_name="s0", bootstrap_expect=1,
                                      **CADENCE),
                      gossip_transport=net.new_transport("s0:gossip"),
                      rpc_transport=net.new_transport("s0:rpc"))
    await agent.start()
    await wait_for_leader([agent.delegate])
    await wait_until(lambda: agent.delegate.store.node("s0")[1] is not None,
                     msg="s0 reconciled into its catalog")
    api, dns = pkg.HTTPApi(agent), pkg.dns.DNSServer(agent)
    addr, dns_addr = await api.start(), await dns.start()
    try:
        for body in DNS_CATALOG:
            status, _, _ = await http(addr, "PUT", "/v1/catalog/register",
                                      json.dumps(body).encode())
            assert status == 200
        out = []
        for txid, (name, qtype) in enumerate(DNS_QUESTIONS):
            query = pkg.dns.build_query(txid, name,
                                        getattr(pkg.dns, f"TYPE_{qtype}"))
            out.append(await dns_raw(dns_addr, query))
        return out
    finally:
        await api.stop()
        await dns.stop()
        await agent.shutdown()


def test_dns_answers_byte_equal():
    got = {name: asyncio.run(asyncio.wait_for(_dns_answers(pkg), 60))
           for name, pkg in PACKAGES.items()}
    for q, want, have in zip(DNS_QUESTIONS, got["jax"], got["torch"]):
        assert want == have, q
    rcodes = [t_dns.parse_response(raw)[1] for raw in got["torch"]]
    answers = [len(t_dns.parse_response(raw)[2]) for raw in got["torch"]]
    assert rcodes.count(3) >= 3 and all(answers[:3]), (rcodes, answers)
    # Only passing instances: n2's web is critical.
    srv = t_dns.parse_response(got["torch"][6])[2]
    assert sorted(r.name for r in srv if r.rtype == t_dns.TYPE_A) == [
        "n0.node.consul", "n1.node.consul"]


async def _consul_service(pkg):
    net = pkg.InMemoryNetwork()
    agents = [pkg.Agent(pkg.AgentConfig(node_name=f"s{i}", bootstrap_expect=3,
                                        **CADENCE),
                        gossip_transport=net.new_transport(f"s{i}:gossip"),
                        rpc_transport=net.new_transport(f"s{i}:rpc"))
              for i in range(3)]
    client = pkg.Agent(pkg.AgentConfig(node_name="c0", server=False,
                                       **CADENCE),
                       gossip_transport=net.new_transport("c0:gossip"),
                       rpc_transport=net.new_transport("c0:rpc"))
    dns = pkg.dns.DNSServer(client)
    try:
        for a in agents + [client]:
            await a.start()
        for a in agents[1:] + [client]:
            await a.join(["s0:gossip"])
        await wait_for_leader([a.delegate for a in agents])
        await wait_until(lambda: len(client.serf.members) == 4,
                         msg="the client sees the servers")
        dns_addr = await dns.start()
        raw = await dns_raw(dns_addr, pkg.dns.build_query(
            1, "consul.service.consul", pkg.dns.TYPE_SRV))
        return pkg.dns.parse_response(raw)
    finally:
        await dns.stop()
        for a in [client] + agents:
            await a.shutdown()


def test_consul_service_answers_the_servers():
    """The port's one addition to the lookups: ``consul.service.consul``
    answers the datacenter's servers, as Consul's does; the JAX package's
    leader registers no ``consul`` service, so it answers NXDOMAIN."""
    _, rcode, answers = asyncio.run(asyncio.wait_for(
        _consul_service(PACKAGES["torch"]), 60))
    assert rcode == 0
    srv = [r for r in answers if r.rtype == t_dns.TYPE_SRV]
    targets = sorted(r.name for r in answers if r.rtype == t_dns.TYPE_A)
    assert len(srv) == 3 and targets == [
        "s0.node.consul", "s1.node.consul", "s2.node.consul"]
    _, rcode, answers = asyncio.run(asyncio.wait_for(
        _consul_service(PACKAGES["jax"]), 60))
    assert (rcode, answers) == (3, [])


# ---------------------------------------------------------------------------
# a client agent over a simulated pool
# ---------------------------------------------------------------------------

POOL_N = 64
POOL_FAILED = 42
POOL_BLOCK = 5
POOL_MAX_TICKS = 60
POOL_NAMES = [f"sim-{POOL_FAILED}", "sim-0", "sim-17", "sim-63", "s0", "c0",
              "sim-64"]


def _fast(pkg):
    """tests/test_sim_transport.py's FAST profile."""
    return pkg.GossipProfile(
        name="fast", probe_interval_ms=200, probe_timeout_ms=200,
        indirect_checks=3, suspicion_mult=2, suspicion_max_timeout_mult=2,
        awareness_max_multiplier=8, gossip_interval_ms=200, gossip_nodes=3,
        gossip_to_the_dead_ms=30_000, retransmit_mult=4,
        push_pull_interval_ms=30_000)


def _bridge(name):
    cfg = dict(n=POOL_N, profile=_fast(PACKAGES[name]), interval_scale=0.01,
               fail_at=((POOL_FAILED, 3),), realtime=False, seed=0)
    if name == "jax":
        from consul_tpu.net import sim_transport

        return sim_transport.SimBridge(sim_transport.SimPoolConfig(**cfg)), \
            sim_transport.sim_addr
    from consul_tpu_torch.net import sim_transport

    return (sim_transport.SimBridge(sim_transport.SimPoolConfig(**cfg),
                                    device="cpu"), sim_transport.sim_addr)


async def _pool_view(name):
    """One server in the pool's ``pool`` segment and one client ``Agent``
    on its LAN; the pool runs until the crashed member is DEAD at the
    server and critical in the catalog.  Returns the client's
    ``/v1/health/state/critical`` rows (indexes aside) and its DNS answers
    for ``POOL_NAMES``."""
    pkg = PACKAGES[name]
    bridge, sim_addr = _bridge(name)
    net = pkg.InMemoryNetwork()
    server = pkg.Server(
        pkg.ServerConfig(node_name="s0", bootstrap_expect=1,
                         segments=("pool",), gossip_interval_scale=0.05,
                         reconcile_interval_s=0.2),
        gossip_transport=net.new_transport("s0:gossip"),
        rpc_transport=net.new_transport("s0:rpc"),
        segment_transports={"pool": bridge.transport("sim-host://s0")})
    client = pkg.Agent(pkg.AgentConfig(node_name="c0", server=False,
                                       **CADENCE),
                       gossip_transport=net.new_transport("c0:gossip"),
                       rpc_transport=net.new_transport("c0:rpc"))
    api, dns = pkg.HTTPApi(client), pkg.dns.DNSServer(client)
    target = f"sim-{POOL_FAILED}"
    try:
        await server.start()
        await client.start()
        await client.join(["s0:gossip"])
        await wait_for_leader([server])
        assert await server.join_segment("pool", [sim_addr(17)]) == 1
        addr, dns_addr = await api.start(), await dns.start()

        async def folded():
            _, _, raw = await http(addr, "GET", "/v1/catalog/nodes")
            return len(json.loads(raw)) == POOL_N + 2

        await wait_until(folded, timeout=20, msg="the pool folded")
        ticks = 0
        while ticks < POOL_MAX_TICKS:
            await bridge.run_ticks(POOL_BLOCK)
            ticks += POOL_BLOCK
            node = server.segment_serfs["pool"].memberlist.nodes.get(target)
            if node is not None and node.status == pkg.NodeStatus.DEAD:
                break

        async def critical():
            _, _, raw = await http(addr, "GET", "/v1/health/state/critical")
            return sorted((c["Node"], c["CheckID"], c["Status"], c["Output"])
                          for c in json.loads(raw))

        async def target_critical():
            return any(row[0] == target for row in await critical())

        await wait_until(target_critical, timeout=20, msg=f"{target} critical")
        answers = []
        for txid, node in enumerate(POOL_NAMES):
            answers.append(await dns_raw(dns_addr, pkg.dns.build_query(
                txid, f"{node}.node.consul", pkg.dns.TYPE_A)))
        return await critical(), answers, ticks
    finally:
        await api.stop()
        await dns.stop()
        await client.shutdown()
        await server.shutdown()
        await bridge.shutdown()


def test_pool_client_agent_equal(one_torch_thread):
    got = {name: asyncio.run(asyncio.wait_for(_pool_view(name), 120))
           for name in ("jax", "torch")}
    (j_crit, j_dns_raw, j_ticks), (t_crit, t_dns_raw, t_ticks) = (
        got["jax"], got["torch"])
    assert t_crit == j_crit, (j_ticks, t_ticks)
    assert [row[0] for row in t_crit] == [f"sim-{POOL_FAILED}"]
    assert t_dns_raw == j_dns_raw
    rcodes = [t_dns.parse_response(raw)[1] for raw in t_dns_raw]
    assert rcodes == [0] * (len(POOL_NAMES) - 1) + [3]


# ---------------------------------------------------------------------------
# what waits for Connect
# ---------------------------------------------------------------------------


async def _connect_routes(pkg):
    net = pkg.InMemoryNetwork()
    agent = pkg.Agent(pkg.AgentConfig(node_name="s0", bootstrap_expect=1,
                                      **CADENCE),
                      gossip_transport=net.new_transport("s0:gossip"),
                      rpc_transport=net.new_transport("s0:rpc"))
    await agent.start()
    await wait_for_leader([agent.delegate])
    api = pkg.HTTPApi(agent)
    addr = await api.start()
    try:
        out = {}
        for method, path in (
                ("GET", "/v1/connect/ca/roots"),
                ("GET", "/v1/agent/connect/ca/roots"),
                ("GET", "/v1/agent/connect/ca/leaf/web"),
                ("PUT", "/v1/connect/ca/rotate"),
                ("GET", "/v1/discovery-chain/web")):
            status, _, raw = await http(addr, method, path)
            out[path] = (status, json.loads(raw))
        body = json.dumps({"Name": "web-proxy", "Kind": "connect-proxy",
                           "Port": 21000, "Proxy": {
                               "DestinationServiceName": "web"}})
        status, _, _ = await http(addr, "PUT", "/v1/agent/service/register",
                                  body.encode())
        assert status == 200
        for path in ("/v1/agent/connect/proxy/web-proxy?wait=5s",
                     "/v1/agent/connect/proxy/web-proxy/xds?wait=5s"):
            status, _, raw = await http(addr, "GET", path)
            out[path.partition("?")[0]] = (status, json.loads(raw))
        return out
    finally:
        await api.stop()
        await agent.shutdown()


def test_connect_routes_fail_loudly():
    """Connect's CA, the discovery chain and the xDS export are not ported:
    every route that reaches them answers an error, never an empty 200."""
    out = asyncio.run(asyncio.wait_for(
        _connect_routes(PACKAGES["torch"]), 60))
    missing = "rpc: can't find method "
    assert out["/v1/connect/ca/roots"] == (
        500, {"Error": missing + "ConnectCA.Roots"})
    assert out["/v1/agent/connect/ca/roots"] == (
        500, {"Error": missing + "ConnectCA.Roots"})
    assert out["/v1/agent/connect/ca/leaf/web"] == (
        500, {"Error": missing + "ConnectCA.Roots"})
    assert out["/v1/connect/ca/rotate"] == (
        500, {"Error": missing + "ConnectCA.Rotate"})
    assert out["/v1/discovery-chain/web"] == (
        500, {"Error": missing + "DiscoveryChain.Get"})
    status, body = out["/v1/agent/connect/proxy/web-proxy"]
    assert status == 500 and missing + "ConnectCA.Roots" in body["Error"]
    assert out["/v1/agent/connect/proxy/web-proxy/xds"] == (
        500, {"Error": t_http.XDS_NOT_PORTED})


@pytest.mark.parametrize("knob", ["auto_encrypt", "auto_config_enabled"])
def test_client_tls_bootstrap_refused(knob):
    net = t_transport.InMemoryNetwork()
    cfg = t_agent.AgentConfig(node_name="c0", server=False, **{knob: True})
    with pytest.raises(NotImplementedError, match=f"{knob}= is not ported"):
        t_agent.Agent(cfg, gossip_transport=net.new_transport("c0:gossip"),
                      rpc_transport=net.new_transport("c0:rpc"))
