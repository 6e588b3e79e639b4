"""Connect in the port (``consul_tpu_torch.connect``: the built-in CA, the
discovery-chain compiler, the xDS export, the mTLS service and proxy; the
``ConnectCA``, ``DiscoveryChain``, ``AutoEncrypt`` and ``AutoConfig``
endpoints) beside the JAX package's, on the CPU.

* The reference's own scenarios on both packages (loaded as in
  ``tests/test_torch_agent.py``): ``tests/test_discoverychain.py``,
  ``tests/test_xds.py`` (its golden files), ``tests/test_connect.py``,
  ``tests/test_proxy.py`` and ``tests/test_autoconfig.py``.
* Cross-package checks, tolerance "equal": ``compile_chain`` over seeded
  config entries and ``ads_snapshot`` over seeded proxy snapshots give
  equal dicts (or the same ``ChainCompileError``); a leaf signed by either
  package's CA verifies under the other's ``verify_leaf`` with the same
  SPIFFE URI, through a rotation's cross-signed chain too.
* Without ``cryptography`` both packages answer Connect's routes, the
  proxy feed and a client's auto-encrypt with the same status and body:
  ``chip_smoke.NO_CRYPTO_CONNECT``, which the smoke holds the card's
  machine to.
"""

import asyncio
import json
import sys

import numpy as np
import pytest

from helpers import requires_crypto
from helpers import wait_for as wait_until
from helpers import wait_for_leader

import chip_smoke
import consul_tpu.agent.agent as j_agent
import consul_tpu.agent.http as j_http
import consul_tpu.connect.ca as j_ca
import consul_tpu.connect.discoverychain as j_chain
import consul_tpu.connect.xds as j_xds
import consul_tpu.net.transport as j_transport
import consul_tpu_torch.agent.agent as t_agent
import consul_tpu_torch.agent.http as t_http
import consul_tpu_torch.connect.ca as t_ca
import consul_tpu_torch.connect.discoverychain as t_chain
import consul_tpu_torch.connect.xds as t_xds
import consul_tpu_torch.net.transport as t_transport
from test_torch_agent import case_id, reference_cases, run_reference_case

CASES = (
    reference_cases("test_discoverychain")
    + reference_cases("test_xds")
    + reference_cases("test_connect")
    + reference_cases("test_proxy")
    + reference_cases("test_autoconfig")
)


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_reference_scenario(case, package, request):
    run_reference_case(case, package, request)


def test_reference_cases_found():
    """21 chain, 14 xDS, 8 Connect, 6 proxy and 8 auto-config scenarios."""
    counts = {}
    for name, _ in CASES:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {"test_discoverychain": 21, "test_xds": 14,
                      "test_connect": 8, "test_proxy": 6,
                      "test_autoconfig": 8}


# ---------------------------------------------------------------------------
# the compiler and the export on seeded inputs
# ---------------------------------------------------------------------------

SERVICES = ("web", "api", "db", "cache")
DCS = ("dc1", "dc2", "dc3")
PROTOCOLS = ("tcp", "http", "http2", "grpc")


def _seeded_entries(rng) -> dict:
    """Config entries for the four services: service-defaults, resolvers
    (subsets, a default subset, redirects, failover), splitters and
    routers, drawn so that some chains compile and some are refused."""
    pick = lambda seq: seq[int(rng.integers(len(seq)))]  # noqa: E731
    entries = {"services": {}, "resolvers": {}, "splitters": {},
               "routers": {}, "global_proxy": None}
    if rng.random() < 0.5:
        entries["global_proxy"] = {"kind": "proxy-defaults", "name": "global",
                                   "config": {"protocol": pick(PROTOCOLS)}}
    for svc in SERVICES:
        if rng.random() < 0.6:
            entries["services"][svc] = {"kind": "service-defaults",
                                        "name": svc,
                                        "protocol": pick(PROTOCOLS)}
        if rng.random() < 0.8:
            subsets = {f"v{i}": {"filter": f'Service.Meta.version == "{i}"'}
                       for i in range(1, int(rng.integers(0, 4)) + 1)}
            res = {"kind": "service-resolver", "name": svc,
                   "connect_timeout_s": float(rng.integers(1, 30))}
            if subsets:
                res["subsets"] = subsets
                if rng.random() < 0.5:
                    res["default_subset"] = pick(sorted(subsets))
            roll = rng.random()
            if roll < 0.2:
                res["redirect"] = {"service": pick(SERVICES)}
                if rng.random() < 0.5:
                    res["redirect"]["datacenter"] = pick(DCS)
            elif roll < 0.6:
                key = "*" if not subsets or rng.random() < 0.5 else \
                    pick(sorted(subsets))
                res["failover"] = {key: {"datacenters": [
                    d for d in DCS if rng.random() < 0.5]}}
                if rng.random() < 0.3:
                    res["failover"][key]["service"] = pick(SERVICES)
            entries["resolvers"][svc] = res
        if rng.random() < 0.4:
            subs = sorted(entries["resolvers"].get(svc, {}).get("subsets")
                          or {})
            w = int(rng.integers(1, 100))
            entries["splitters"][svc] = {"kind": "service-splitter",
                                         "name": svc, "splits": [
                {"weight": w, "service_subset": pick(subs) if subs else ""},
                {"weight": 100 - w, "service": pick(SERVICES)}]}
        if rng.random() < 0.3:
            entries["routers"][svc] = {"kind": "service-router", "name": svc,
                                       "routes": [{
                "match": {"http": {"path_prefix": f"/{pick(SERVICES)}"}},
                "destination": {"service": pick(SERVICES)}}]}
    return entries


def _compile(mod, svc, entries, **kw):
    try:
        return mod.compile_chain(svc, "dc1", entries, **kw)
    except mod.ChainCompileError as e:
        return ("ChainCompileError", str(e))


def test_compile_chain_equal_on_seeded_entries():
    rng = np.random.default_rng(17)
    compiled = refused = 0
    for _ in range(120):
        entries = _seeded_entries(rng)
        for svc in SERVICES:
            kw = {}
            if rng.random() < 0.2:
                kw["override_protocol"] = "tcp"
            if rng.random() < 0.2:
                kw["override_connect_timeout_s"] = 2.5
            want = _compile(j_chain, svc, json.loads(json.dumps(entries)),
                            **kw)
            got = _compile(t_chain, svc, json.loads(json.dumps(entries)),
                           **kw)
            assert got == want, (svc, entries, kw)
            if isinstance(want, tuple):
                refused += 1
            else:
                compiled += 1
    # The draw reaches both outcomes often.
    assert compiled > 100 and refused > 20, (compiled, refused)


def _seeded_snapshot(rng, chain_mod) -> dict:
    """A proxy snapshot for ``web`` whose upstreams carry chains compiled
    from seeded entries, with instances, intentions and roots."""
    upstreams = {}
    while not upstreams:
        entries = _seeded_entries(rng)
        for k, svc in enumerate(SERVICES[1:]):
            try:
                chain = chain_mod.compile_chain(svc, "dc1", entries)
            except chain_mod.ChainCompileError:
                continue
            upstreams[svc] = {
                "chain": chain,
                "instances": {
                    tid: [{"address": f"10.{k}.{j}.{i + 1}",
                           "port": 8080 + i, "proxy_id": f"{tid}-{i}",
                           "node": f"n{i}"}
                          for i in range(int(rng.integers(0, 3)))]
                    for j, tid in enumerate(sorted(chain["targets"]))},
                "local_bind_port": 5000 + k,
                "local_bind_address": "127.0.0.1",
                "datacenter": "",
            }
    sources = ["api", "db", "cache", "*"]
    return {
        "proxy_id": "web-proxy", "destination_service": "web",
        "datacenter": "dc1", "local_service_address": "127.0.0.1:9090",
        "roots": [{"id": "root-1", "active": True,
                   "trust_domain": "11111111-2222.consul",
                   "root_cert_pem": "-----BEGIN CERT-----fake\n"}],
        "active_root_id": "root-1",
        "leaf": {"cert_pem": "-----BEGIN CERT-----leaf\n",
                 "private_key_pem": "-----BEGIN KEY-----leaf\n",
                 "root_id": "root-1"},
        "intentions": [
            {"source": s, "action": "allow" if rng.random() < 0.5
             else "deny", "precedence": int(rng.integers(1, 10))}
            for s in sources if rng.random() < 0.6],
        "default_allow": bool(rng.random() < 0.5),
        "upstreams": upstreams,
    }


def test_ads_snapshot_equal_on_seeded_snapshots():
    for seed in range(40):
        j_snap = _seeded_snapshot(np.random.default_rng(seed), j_chain)
        t_snap = _seeded_snapshot(np.random.default_rng(seed), t_chain)
        assert t_snap == j_snap
        version = seed + 1
        port = 21000 + seed
        want = j_xds.ads_snapshot(j_snap, version, public_port=port)
        got = t_xds.ads_snapshot(t_snap, version, public_port=port)
        assert got == want, seed
        assert len(got["resources"][t_xds.CLUSTER_TYPE]) >= 2


# ---------------------------------------------------------------------------
# the CA, across the packages
# ---------------------------------------------------------------------------


@requires_crypto
@pytest.mark.parametrize("signer", ["jax", "torch"])
def test_leaf_verifies_under_the_other_package(signer):
    sign_mod, check_mod = (j_ca, t_ca) if signer == "jax" else (t_ca, j_ca)
    ca = sign_mod.BuiltinCA("dc1", trust_domain="abcd.consul")
    root = ca.generate_root()
    leaf = ca.sign_leaf("web")
    uri = "spiffe://abcd.consul/ns/default/dc/dc1/svc/web"
    assert leaf["uri"] == uri
    assert check_mod.verify_leaf(leaf["cert_pem"], root["root_cert"]) == uri
    agent_leaf = ca.sign_leaf("c0", kind="agent")
    assert check_mod.verify_leaf(agent_leaf["cert_pem"], root["root_cert"]) \
        == check_mod.spiffe_agent("abcd.consul", "dc1", "c0")
    # After a rotation the new leaf reaches the old root only through the
    # cross-signed intermediate.
    ca.rotate()
    new_leaf = ca.sign_leaf("web")
    assert check_mod.verify_leaf(new_leaf["cert_pem"], root["root_cert"]) \
        is None
    assert check_mod.verify_leaf_chain(
        new_leaf["cert_pem"], new_leaf["intermediate_pems"],
        root["root_cert"]) == uri
    other = check_mod.BuiltinCA("dc1", trust_domain="abcd.consul")
    other_root = other.generate_root()
    assert check_mod.verify_leaf(leaf["cert_pem"],
                                 other_root["root_cert"]) is None


def test_spiffe_ids_equal():
    for dc, name in (("dc1", "web"), ("eu-west", "a.b-c")):
        assert t_ca.spiffe_service("td.consul", dc, name) == \
            j_ca.spiffe_service("td.consul", dc, name)
        assert t_ca.spiffe_agent("td.consul", dc, name) == \
            j_ca.spiffe_agent("td.consul", dc, name)


# ---------------------------------------------------------------------------
# without cryptography
# ---------------------------------------------------------------------------

PACKAGES = {
    "jax": (j_agent, j_http, j_transport),
    "torch": (t_agent, t_http, t_transport),
}
CADENCE = dict(gossip_interval_scale=0.05, sync_interval_s=0.3,
               sync_retry_interval_s=0.2, reconcile_interval_s=0.2)


async def _http(addr, method, path, body=b""):
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    head = [f"{method} {path} HTTP/1.1", f"Host: {host}",
            f"Content-Length: {len(body)}", "Connection: close"]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload)


async def _connect_without_crypto(name):
    """Connect's routes, the proxy feed and a client's auto-encrypt on a
    one-server datacenter of ``name`` with ``cryptography`` unimportable."""
    agent_mod, http_mod, transport = PACKAGES[name]
    net = transport.InMemoryNetwork()
    server = agent_mod.Agent(
        agent_mod.AgentConfig(node_name="s0", bootstrap_expect=1, **CADENCE),
        gossip_transport=net.new_transport("s0:gossip"),
        rpc_transport=net.new_transport("s0:rpc"))
    await server.start()
    await wait_for_leader([server.delegate])
    client = agent_mod.Agent(
        agent_mod.AgentConfig(node_name="c0", server=False,
                              auto_encrypt=True, **CADENCE),
        gossip_transport=net.new_transport("c0:gossip"),
        rpc_transport=net.new_transport("c0:rpc"))
    await client.start()
    await client.join(["s0:gossip"])
    api = http_mod.HTTPApi(client)
    addr = await api.start()
    try:
        await wait_until(lambda: client.delegate.routers.servers(), 10,
                         msg="c0 finds s0")
        out = {}
        for method, path in chip_smoke.NO_CRYPTO_ROUTES:
            out[f"{method} {path}"] = list(await _http(addr, method, path))
        proxy = json.dumps({"Name": "web-proxy", "Kind": "connect-proxy",
                            "Port": 21000, "Proxy": {
                                "DestinationServiceName": "web"}}).encode()
        assert (await _http(addr, "PUT", "/v1/agent/service/register",
                            proxy))[0] == 200
        for path in chip_smoke.NO_CRYPTO_FEEDS:
            out[f"GET {path}"] = list(await _http(addr, "GET", path))
        try:
            await client._agent_rpc("AutoEncrypt.Sign", {"node": "c0"})
            out["AutoEncrypt.Sign"] = None
        except Exception as e:  # noqa: BLE001 - the answer is what is held
            out["AutoEncrypt.Sign"] = str(e)
        out["tls_identity"] = client.tls_identity
        return out
    finally:
        await api.stop()
        await client.shutdown()
        await server.shutdown()


def test_connect_without_cryptography(monkeypatch):
    monkeypatch.setitem(sys.modules, "cryptography", None)
    got = {name: asyncio.run(asyncio.wait_for(
        _connect_without_crypto(name), 60)) for name in PACKAGES}
    assert got["torch"] == got["jax"]
    assert got["torch"] == chip_smoke.NO_CRYPTO_CONNECT
