"""The port's server plane (``consul_tpu_torch.agent``: ``Server``,
``Client``, the endpoints and the ACL resolver) beside the JAX package's,
on the CPU.

* The scenarios of ``tests/test_cluster_agents.py`` (all but its HTTP
  one) and of ``tests/test_replication.py`` run against both packages
  through one parametrised fixture.  The segment scenario's clients are
  ``Client``s whose serf carries the ``segment`` tag, which is what the
  reference's ``Agent`` with ``segment=`` gossips.
* A one-server datacenter of each package, ACLs on with a master token,
  gets the same seeded stream of RPC calls over the sixteen endpoints,
  errors and denied calls among them.  Each reply and each error string
  must be equal once the generated IDs (UUIDs, numbered by first
  appearance) and the wall-clock fields are mapped out, and so must the
  final ``store.snapshot()``.  Every frame the port's RPC layer packed
  on the way must equal the C ``msgpack``'s bytes.
* A 64-member pool simulated by each package's ``SimBridge`` with three
  servers on its ``pool`` segment: after the crash, each catalog's node
  names and ``serfHealth`` statuses must equal the other package's.
"""

import asyncio
import gzip
import io
import random
import re
import tarfile
import types
import uuid

import msgpack
import pytest

from helpers import wait_for as wait_until
from helpers import wait_for_leader

import consul_tpu.acl.jwt as j_jwt
import consul_tpu.agent.client as j_client
import consul_tpu.agent.rpc as j_rpc
import consul_tpu.agent.server as j_server
import consul_tpu.agent.snapshot as j_snapshot
import consul_tpu.eventing.cluster as j_cluster
import consul_tpu.net.memberlist as j_memberlist
import consul_tpu.net.transport as j_transport
import consul_tpu.protocol as j_protocol
import consul_tpu_torch.acl.jwt as t_jwt
import consul_tpu_torch.agent.client as t_client
import consul_tpu_torch.agent.rpc as t_rpc
import consul_tpu_torch.agent.server as t_server
import consul_tpu_torch.agent.snapshot as t_snapshot
import consul_tpu_torch.eventing.cluster as t_cluster
import consul_tpu_torch.net.memberlist as t_memberlist
import consul_tpu_torch.net.transport as t_transport
import consul_tpu_torch.protocol as t_protocol


def _namespace(server, client, rpc, transport, jwt, snapshot, cluster,
               memberlist, protocol, name):
    return types.SimpleNamespace(
        name=name, Server=server.Server, ServerConfig=server.ServerConfig,
        Client=client.Client, ClientConfig=client.ClientConfig, rpc=rpc,
        InMemoryNetwork=transport.InMemoryNetwork, jwt=jwt,
        read_archive=snapshot.read_archive,
        MemberStatus=cluster.MemberStatus, NodeStatus=memberlist.NodeStatus,
        GossipProfile=protocol.GossipProfile)


PACKAGES = {
    "jax": _namespace(j_server, j_client, j_rpc, j_transport, j_jwt,
                      j_snapshot, j_cluster, j_memberlist, j_protocol, "jax"),
    "torch": _namespace(t_server, t_client, t_rpc, t_transport, t_jwt,
                        t_snapshot, t_cluster, t_memberlist, t_protocol,
                        "torch"),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# tests/test_cluster_agents.py's cadences.
CADENCE = dict(gossip_interval_scale=0.05, reconcile_interval_s=0.2,
               coordinate_update_period_s=0.1, session_ttl_sweep_s=0.1)


def make_server(pkg, net, name, expect=3, **kw):
    # Fast staging→voter promotion (late joiners are non-voters until
    # autopilot promotes them).
    kw.setdefault("autopilot_interval_s", 0.3)
    kw.setdefault("autopilot_server_stabilization_s", 0.3)
    cfg = pkg.ServerConfig(node_name=name, bootstrap_expect=expect,
                           **{**CADENCE, **kw})
    return pkg.Server(
        cfg,
        gossip_transport=net.new_transport(f"{name}:gossip"),
        rpc_transport=net.new_transport(f"{name}:rpc"),
    )


def make_client(pkg, net, name, **kw):
    cfg = pkg.ClientConfig(node_name=name, gossip_interval_scale=0.05, **kw)
    return pkg.Client(
        cfg,
        gossip_transport=net.new_transport(f"{name}:gossip"),
        rpc_transport=net.new_transport(f"{name}:rpc"),
    )


async def start_cluster(pkg, net, n=3):
    servers = [make_server(pkg, net, f"s{i}", expect=n) for i in range(n)]
    for s in servers:
        await s.start()
    for s in servers[1:]:
        await s.join(["s0:gossip"])
    await wait_for_leader(servers)
    return servers


async def start_client(pkg, net, n_servers=None):
    client = make_client(pkg, net, "c0")
    await client.start()
    await client.join(["s0:gossip"])
    if n_servers:
        await wait_until(lambda: len(client.routers.servers()) == n_servers,
                         msg=f"client sees {n_servers} servers via serf tags")
    else:
        await wait_until(lambda: client.routers.servers(),
                         msg="servers known")
    return client


async def shutdown_all(*nodes):
    for n in nodes:
        await n.shutdown()
    await asyncio.sleep(0)


# ---------------------------------------------------------------------------
# tests/test_cluster_agents.py
# ---------------------------------------------------------------------------


class TestServerCluster:
    async def test_three_servers_elect_and_replicate(self, pkg):
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        leader = next(s for s in servers if s.is_leader())

        out = await leader.rpc_client.call(
            f"{leader.node_id}:rpc", "KVS.Apply",
            {"op": "set", "entry": {"key": "a", "value": b"1"}},
        )
        assert out["result"] is True
        # Replicated to every server's store (follower stale read).
        await wait_until(
            lambda: all(s.store.kv_get("a")[1] is not None for s in servers),
            msg="kv replicated to all followers",
        )
        await shutdown_all(*servers)

    async def test_follower_forwards_write_to_leader(self, pkg):
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        follower = next(s for s in servers if not s.is_leader())

        out = await follower.rpc_client.call(
            f"{follower.node_id}:rpc", "KVS.Apply",
            {"op": "set", "entry": {"key": "fwd", "value": b"x"}},
        )
        assert out["result"] is True
        leader = next(s for s in servers if s.is_leader())
        assert leader.store.kv_get("fwd")[1]["value"] == b"x"
        await shutdown_all(*servers)

    async def test_serf_membership_reconciled_into_catalog(self, pkg):
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        leader = next(s for s in servers if s.is_leader())

        await wait_until(
            lambda: len(leader.store.nodes()[1]) == 3,
            msg="all serf members registered in catalog",
        )
        _, checks = leader.store.node_checks("s1")
        assert checks and checks[0]["check_id"] == "serfHealth"
        assert checks[0]["status"] == "passing"
        await shutdown_all(*servers)

    async def test_leader_failover(self, pkg):
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        leader = next(s for s in servers if s.is_leader())
        rest = [s for s in servers if s is not leader]

        await leader.shutdown()
        new_leader = await wait_for_leader(rest, timeout=10)
        out = await new_leader.rpc_client.call(
            f"{new_leader.node_id}:rpc", "KVS.Apply",
            {"op": "set", "entry": {"key": "post-failover", "value": b"ok"}},
        )
        assert out["result"] is True
        await shutdown_all(*rest)


class TestClientAgent:
    async def test_client_discovers_servers_and_rpcs(self, pkg):
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        client = await start_client(pkg, net, n_servers=3)

        out = await client.rpc(
            "KVS.Apply",
            {"op": "set", "entry": {"key": "via-client", "value": b"v"}})
        assert out["result"] is True
        got = await client.rpc("KVS.Get", {"key": "via-client"})
        assert got["entries"][0]["value"] == b"v"
        assert got["meta"]["index"] >= 1
        await shutdown_all(client, *servers)

    async def test_client_blocking_query_wakes_on_write(self, pkg):
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        client = await start_client(pkg, net)

        await client.rpc(
            "KVS.Apply", {"op": "set", "entry": {"key": "w", "value": b"1"}}
        )
        got = await client.rpc("KVS.Get", {"key": "w"})
        idx = got["meta"]["index"]

        async def blocked():
            return await client.rpc(
                "KVS.Get",
                {"key": "w", "min_query_index": idx, "max_query_time": 5},
                timeout=10,
            )

        task = asyncio.create_task(blocked())
        await asyncio.sleep(0.1)
        assert not task.done()
        await client.rpc(
            "KVS.Apply", {"op": "set", "entry": {"key": "w", "value": b"2"}}
        )
        got2 = await asyncio.wait_for(task, 5)
        assert got2["entries"][0]["value"] == b"2"
        await shutdown_all(client, *servers)

    async def test_catalog_health_session_flow(self, pkg):
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        client = await start_client(pkg, net)

        # An EXTERNAL node (no serfHealth: exempt from the leader's
        # reconcileReaped pass, like external services in the reference).
        out = await client.rpc("Catalog.Register", {
            "node": "web-1", "address": "10.1.1.1",
            "service": {"service": "web", "port": 80, "tags": ["v1"]},
            "checks": [
                {"check_id": "web-alive", "status": "passing"},
                {"check_id": "web-http", "service_id": "web",
                 "status": "passing"},
            ],
        })
        assert out["result"] is True

        nodes = await client.rpc("Health.ServiceNodes",
                                 {"service": "web", "passing_only": True})
        assert len(nodes["nodes"]) == 1
        assert nodes["nodes"][0]["service"]["port"] == 80

        svc = await client.rpc("Catalog.ServiceNodes",
                               {"service": "web", "tag": "v1"})
        assert len(svc["nodes"]) == 1
        none = await client.rpc("Catalog.ServiceNodes",
                                {"service": "web", "tag": "v9"})
        assert none["nodes"] == []

        # Session + lock through the full stack (explicit check set: this
        # external node has no serfHealth).
        sess = await client.rpc("Session.Apply", {
            "op": "create",
            "session": {"node": "web-1", "ttl": "10s",
                        "checks": ["web-alive"]},
        })
        sid = sess["result"]
        lock = await client.rpc("KVS.Apply", {
            "op": "lock",
            "entry": {"key": "svc/leader", "value": b"web-1", "session": sid},
        })
        assert lock["result"] is True
        rec = await client.rpc("KVS.Get", {"key": "svc/leader"})
        assert rec["entries"][0]["session"] == sid
        await shutdown_all(client, *servers)

    async def test_session_ttl_expires_without_renew(self, pkg):
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        leader = next(s for s in servers if s.is_leader())
        client = await start_client(pkg, net)

        # External node (no serfHealth): the session can only vanish
        # through the leader's TTL sweep, the code under test here.
        await client.rpc("Catalog.Register", {
            "node": "n-ttl", "address": "10.2.2.2",
        })
        sess = await client.rpc("Session.Apply", {
            "op": "create",
            "session": {"node": "n-ttl", "ttl": "0.2s", "checks": []},
        })
        sid = sess["result"]
        assert leader.store.session_get(sid)[1] is not None
        # TTL x2 + sweep interval: destroyed by the leader.
        await wait_until(
            lambda: leader.store.session_get(sid)[1] is None,
            timeout=5,
            msg="session invalidated after TTL",
        )
        await shutdown_all(client, *servers)


class TestCoordinateBatching:
    async def test_updates_flush_in_one_batch(self, pkg):
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        client = await start_client(pkg, net)

        await client.rpc("Catalog.Register",
                         {"node": "n1", "address": "10.0.0.1"})
        await client.rpc("Coordinate.Update", {
            "node": "n1", "coord": {"vec": [0.1] * 8, "height": 1e-5,
                                    "adjustment": 0.0, "error": 1.5},
        })
        await wait_until(
            lambda: any(s.store.coordinate("n1") is not None
                        for s in servers),
            msg="coordinate flushed via raft batch",
        )
        await shutdown_all(client, *servers)


class TestBootstrapGuards:
    async def test_late_joiner_does_not_depose_leader(self, pkg):
        """A server joining an established cluster at the expect
        threshold must NOT live-bootstrap its own voter set: it probes
        Status.Peers, disables bootstrap, and waits for the leader's
        reconcile to add it (server_serf.go:318-401)."""
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        leader = next(s for s in servers if s.is_leader())
        term_before = leader.raft.current_term

        late = make_server(pkg, net, "s9", expect=3)
        await late.start()
        await late.join(["s0:gossip"])

        # The late joiner must end up a follower in the SAME cluster.
        await wait_until(
            lambda: late.raft is not None
            and "s9" in late.raft.voters
            and late.raft.leader_id == leader.node_id,
            timeout=10,
            msg="late joiner folded in as follower",
        )
        assert late._bootstrap_disabled is True
        assert not late.is_leader()
        # Leadership never churned: same leader, same term.
        assert leader.is_leader()
        assert leader.raft.current_term == term_before
        await shutdown_all(late, *servers)


class TestLockDelay:
    async def test_invalidated_session_lock_delay_blocks_reacquire(self, pkg):
        """KVSLock honors the lock-delay window set when a lock-holding
        session dies (kvs_endpoint.go:67-82, state/session.go:348-368)."""
        net = pkg.InMemoryNetwork()
        servers = await start_cluster(pkg, net)
        leader = next(s for s in servers if s.is_leader())
        addr = f"{leader.node_id}:rpc"
        call = leader.rpc_client.call

        await call(addr, "Catalog.Register", {
            "node": "n-ld", "address": "10.9.9.9",
        })
        s1 = (await call(addr, "Session.Apply", {
            "op": "create",
            "session": {"node": "n-ld", "lock_delay": 0.4, "checks": []},
        }))["result"]
        got = await call(addr, "KVS.Apply", {
            "op": "lock", "entry": {"key": "svc/lead", "session": s1},
        })
        assert got["result"] is True

        # Session dies while holding the lock -> delay window opens.
        await call(addr, "Session.Apply",
                   {"op": "destroy", "session": {"id": s1}})
        s2 = (await call(addr, "Session.Apply", {
            "op": "create",
            "session": {"node": "n-ld", "lock_delay": 0.4, "checks": []},
        }))["result"]
        denied = await call(addr, "KVS.Apply", {
            "op": "lock", "entry": {"key": "svc/lead", "session": s2},
        })
        assert denied["result"] is False

        await asyncio.sleep(0.5)  # let the delay lapse
        allowed = await call(addr, "KVS.Apply", {
            "op": "lock", "entry": {"key": "svc/lead", "session": s2},
        })
        assert allowed["result"] is True
        await shutdown_all(*servers)


class TestNetworkSegments:
    async def test_segment_rings_isolate_clients_but_reach_servers(self, pkg):
        """server_serf.go:50 segmentLAN: clients of different segments
        never see each other's gossip, the server bridges all rings, and
        reconcile folds every segment's nodes into one catalog with their
        segment recorded."""
        net = pkg.InMemoryNetwork()
        srv = pkg.Server(
            pkg.ServerConfig(node_name="seg-server", bootstrap_expect=1,
                             segments=("alpha", "beta"), **CADENCE),
            gossip_transport=net.new_transport("srv:gossip"),
            rpc_transport=net.new_transport("srv:rpc"),
            segment_transports={
                "alpha": net.new_transport("srv:alpha"),
                "beta": net.new_transport("srv:beta"),
            },
        )
        await srv.start()
        ca = make_client(pkg, net, "c-alpha", tags={"segment": "alpha"})
        cb = make_client(pkg, net, "c-beta", tags={"segment": "beta"})
        await ca.start()
        await cb.start()
        try:
            await wait_until(lambda: srv.is_leader(), msg="leader")
            assert await ca.join(["srv:alpha"]) == 1
            assert await cb.join(["srv:beta"]) == 1
            await wait_until(
                lambda: "c-alpha" in srv.segment_serfs["alpha"].members
                and "c-beta" in srv.segment_serfs["beta"].members,
                msg="server bridges both segments",
            )
            # Isolation: alpha's ring never learns beta's client.
            await asyncio.sleep(0.5)
            assert "c-beta" not in ca.serf.members
            assert "c-alpha" not in cb.serf.members
            # The main ring holds only the server itself.
            assert set(srv.serf.members) == {"seg-server"}
            # Reconcile registers both segment clients in the catalog with
            # their segment in node meta.
            await wait_until(
                lambda: srv.store.node("c-alpha")[1] is not None
                and srv.store.node("c-beta")[1] is not None,
                timeout=10, msg="segment nodes reconciled into catalog",
            )
            assert srv.store.node("c-alpha")[1]["meta"]["segment"] == "alpha"
            assert srv.store.node("c-beta")[1]["meta"]["segment"] == "beta"
        finally:
            await ca.shutdown()
            await cb.shutdown()
            await srv.shutdown()


# ---------------------------------------------------------------------------
# tests/test_replication.py
# ---------------------------------------------------------------------------


def make_repl_server(pkg, lan, wan, rpc, name, dc, primary=""):
    cfg = pkg.ServerConfig(
        node_name=name, datacenter=dc, bootstrap_expect=1,
        flood_interval_s=0.1, primary_datacenter=primary,
        replication_interval_s=0.2, **CADENCE,
    )
    return pkg.Server(
        cfg,
        gossip_transport=lan.new_transport(f"{name}.{dc}:gossip"),
        rpc_transport=rpc.new_transport(f"{name}.{dc}:rpc"),
        wan_transport=wan.new_transport(f"{name}.{dc}:wan"),
    )


class TestWANReplication:
    async def test_config_and_acl_replicate_to_secondary(self, pkg):
        lan1, lan2 = pkg.InMemoryNetwork(), pkg.InMemoryNetwork()
        wan, rpc = pkg.InMemoryNetwork(), pkg.InMemoryNetwork()
        p = make_repl_server(pkg, lan1, wan, rpc, "p0", "dc1")
        s = make_repl_server(pkg, lan2, wan, rpc, "s0", "dc2", primary="dc1")
        await p.start()
        await s.start()
        await wait_for_leader([p])
        await wait_for_leader([s])
        await s.join_wan(["p0.dc1:wan"])

        # Writes land in the PRIMARY only.
        call = p.rpc_client.call
        await call("p0.dc1:rpc", "ConfigEntry.Apply",
                   {"op": "set", "entry": {"kind": "service-defaults",
                                           "name": "web",
                                           "protocol": "http"}})
        await call("p0.dc1:rpc", "ACL.PolicySet",
                   {"policy": {"id": "pol-1", "name": "ro", "rules": "{}"}})
        await call("p0.dc1:rpc", "ACL.TokenSet",
                   {"acl_token": {"secret_id": "tok-1",
                                  "policies": ["pol-1"]}})

        # The secondary's pull loop converges them.
        await wait_until(
            lambda: s.store.config_entry_get("service-defaults", "web")[1]
            is not None, timeout=15, msg="config entry replicated")
        await wait_until(lambda: s.store.acl_policy_get("pol-1") is not None,
                         timeout=15, msg="acl policy replicated")
        await wait_until(lambda: s.store.acl_token_get("tok-1") is not None,
                         timeout=15, msg="acl token replicated")
        entry = s.store.config_entry_get("service-defaults", "web")[1]
        assert entry["protocol"] == "http"

        # Deletions replicate too.
        await call("p0.dc1:rpc", "ConfigEntry.Apply",
                   {"op": "delete",
                    "entry": {"kind": "service-defaults", "name": "web"}})
        await call("p0.dc1:rpc", "ACL.PolicyDelete", {"id": "pol-1"})
        await wait_until(
            lambda: s.store.config_entry_get("service-defaults", "web")[1]
            is None, timeout=15, msg="config entry deletion replicated")
        await wait_until(lambda: s.store.acl_policy_get("pol-1") is None,
                         timeout=15, msg="acl policy deletion replicated")
        # The replicated world is usable locally: the token still resolves
        # in dc2 (tokens were not deleted).
        assert s.store.acl_token_get("tok-1") is not None
        await p.shutdown()
        await s.shutdown()

    async def test_primary_runs_no_replication(self, pkg):
        lan, wan, rpc = (pkg.InMemoryNetwork(), pkg.InMemoryNetwork(),
                         pkg.InMemoryNetwork())
        p = make_repl_server(pkg, lan, wan, rpc, "q0", "dc1", primary="dc1")
        await p.start()
        await wait_for_leader([p])
        # primary == own dc: the loop exits immediately (no self-pull).
        assert not p._is_secondary()
        await p.shutdown()


# ---------------------------------------------------------------------------
# the sixteen endpoints, call by call
# ---------------------------------------------------------------------------

MASTER = "master-token"
BOGUS = "not-a-token"
JWT_SECRET = "sekrit"
STREAM_SEED = 15
STREAM_CALLS = 320
NODES = ("n0", "n1", "n2", "n3", "s0")
SERVICES = ("web", "db", "api")
KEYS = ("app/a", "app/b", "app/c/d", "cfg/x", "cfg/y", "z")
# Fields whose value is the wall clock or its age.
TIME_FIELDS = ("last_contact", "expiration_time", "stable_since_s")
UUID_RE = re.compile(
    r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


class Ref:
    """A value taken from an earlier reply of the same run."""

    def __init__(self, name, *path):
        self.name, self.path = name, path

    def resolve(self, saved):
        value = saved[self.name]
        for part in self.path:
            value = value[part]
        return value


def _resolve(value, saved):
    if isinstance(value, Ref):
        return value.resolve(saved)
    if isinstance(value, dict):
        return {k: _resolve(v, saved) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve(v, saved) for v in value]
    return value


def _call(method, body, token=MASTER, save=None, after=None):
    if token is not None:
        body = {**body, "token": token}
    return {"method": method, "body": body, "save": save, "after": after}


def _prologue(ids):
    """The ACL world of the stream, then every call that generates an ID
    (bootstrap, login, creates without an ``id``), each read back through
    its reply and deleted again before the seeded part lists anything."""
    team_rules = '{"key_prefix": {"team-a/": {"policy": "write"}}}'
    kv_rules = ('{"key_prefix": {"app/": {"policy": "write"}, '
                '"": {"policy": "read"}}, "node_prefix": {"": {"policy": '
                '"read"}}, "service_prefix": {"web": {"policy": "write"}}, '
                '"session_prefix": {"": {"policy": "write"}}, '
                '"query_prefix": {"": {"policy": "write"}}}')
    bearer = t_jwt.encode_hs256({"iss": "https://idp", "team": "team-a"},
                                JWT_SECRET)
    stranger = t_jwt.encode_hs256({"iss": "https://idp", "team": "team-b"},
                                  JWT_SECRET)
    forged = t_jwt.encode_hs256({"iss": "https://idp", "team": "team-a"},
                                "other")
    return [
        _call("Status.Ping", {}, token=None),
        _call("Status.Leader", {}, token=None),
        _call("Status.Peers", {}, token=None),
        _call("KVS.Apply", {"op": "set",
                            "entry": {"key": "app/a", "value": b"0"}},
              token=""),
        _call("ACL.Bootstrap", {}, token=None, save="boot"),
        _call("ACL.Bootstrap", {}, token=None),
        _call("ACL.TokenRead", {"secret_id": Ref("boot", "token",
                                                 "secret_id")}),
        _call("KVS.Apply", {"op": "set",
                            "entry": {"key": "cfg/x", "value": b"b"}},
              token=Ref("boot", "token", "secret_id")),
        _call("ACL.TokenDelete", {"secret_id": Ref("boot", "token",
                                                   "secret_id")}),
        _call("ACL.PolicySet", {"policy": {"id": ids["pol_kv"],
                                           "name": "kv", "rules": kv_rules}}),
        _call("ACL.PolicySet", {"policy": {"id": ids["pol_ro"],
                                           "name": "ro",
                                           "rules": '{"key_prefix": {"": '
                                                    '{"policy": "read"}}}'}}),
        _call("ACL.PolicySet", {"policy": {"id": ids["pol_team"],
                                           "name": "team-a-kv",
                                           "rules": team_rules}}),
        _call("ACL.PolicySet", {"policy": {"name": "scratch",
                                           "rules": "{}"}}, save="scratch"),
        _call("ACL.PolicyRead", {"id": Ref("scratch", "policy", "id")}),
        _call("ACL.PolicyDelete", {"id": Ref("scratch", "policy", "id")}),
        _call("ACL.RoleSet", {"role": {"id": ids["role_team"],
                                       "name": "team-a",
                                       "policies": [ids["pol_team"]]}}),
        _call("ACL.RoleSet", {"role": {"name": "team-a"}}),
        _call("ACL.RoleSet", {"role": {"name": "ghost",
                                       "policies": ["nope"]}}),
        _call("ACL.RoleSet", {"role": {"name": "tmp"}}, save="tmp_role"),
        _call("ACL.RoleRead", {"name": "tmp"}),
        _call("ACL.RoleDelete", {"id": Ref("tmp_role", "role", "id")}),
        _call("ACL.TokenSet", {"acl_token": {"secret_id": ids["tok_kv"],
                                             "policies": [ids["pol_kv"]]}}),
        _call("ACL.TokenSet", {"acl_token": {"secret_id": ids["tok_ro"],
                                             "policies": [ids["pol_ro"]],
                                             "expiration_ttl_s": 3600}}),
        _call("ACL.TokenSet", {"acl_token": {"roles": ["nope"]}}),
        _call("ACL.TokenSet", {"acl_token": {"expiration_ttl_s": -1}}),
        _call("ACL.TokenSet", {"acl_token": {"policies": []}},
              save="tmp_tok"),
        _call("ACL.TokenDelete", {"secret_id": Ref("tmp_tok", "token",
                                                   "secret_id")}),
        _call("ACL.AuthMethodSet", {"auth_method": {
            "name": "idp", "type": "jwt", "max_token_ttl_s": 600,
            "config": {"jwt_secret": JWT_SECRET,
                       "bound_issuer": "https://idp",
                       "claim_mappings": {"team": "team"}}}}),
        _call("ACL.AuthMethodSet", {"auth_method": {"name": "x",
                                                    "type": "ldap"}}),
        _call("ACL.BindingRuleSet", {"binding_rule": {
            "id": ids["rule_team"], "auth_method": "idp",
            "selector": 'value.team == "team-a"', "bind_type": "role",
            "bind_name": "${team}"}}),
        _call("ACL.BindingRuleSet", {"binding_rule": {
            "auth_method": "idp", "bind_type": "role",
            "bind_name": "${nope}"}}),
        _call("ACL.BindingRuleSet", {"binding_rule": {
            "auth_method": "idp", "bind_type": "role", "bind_name": "x",
            "selector": "value.team =="}}),
        _call("ACL.BindingRuleSet", {"binding_rule": {
            "auth_method": "missing", "bind_type": "role",
            "bind_name": "x"}}),
        _call("ACL.Login", {"auth": {"auth_method": "idp",
                                     "bearer_token": bearer}},
              token=None, save="login"),
        _call("KVS.Apply", {"op": "set",
                            "entry": {"key": "team-a/x", "value": b"t"}},
              token=Ref("login", "token", "secret_id")),
        _call("KVS.Apply", {"op": "set",
                            "entry": {"key": "other", "value": b"t"}},
              token=Ref("login", "token", "secret_id")),
        _call("ACL.Logout", {}, token=Ref("login", "token", "secret_id")),
        _call("ACL.Logout", {}, token=ids["tok_kv"]),
        _call("ACL.Login", {"auth": {"auth_method": "idp",
                                     "bearer_token": stranger}}, token=None),
        _call("ACL.Login", {"auth": {"auth_method": "idp",
                                     "bearer_token": forged}}, token=None),
        _call("ACL.Login", {"auth": {"auth_method": "nope",
                                     "bearer_token": bearer}}, token=None),
        _call("Catalog.Register", {"node": "n0", "address": "10.0.0.1",
                                   "checks": [{"check_id": "alive",
                                               "status": "passing"}]}),
        _call("Session.Apply", {"op": "create", "session": {
            "node": "n0", "checks": ["alive"], "lock_delay": 0}},
              save="tmp_sess"),
        _call("Session.Get", {"id": Ref("tmp_sess", "result")}),
        _call("Session.Apply", {"op": "destroy", "session": {
            "id": Ref("tmp_sess", "result")}}),
        _call("PreparedQuery.Apply", {"op": "create", "query": {
            "name": "tmp", "service": {"service": "web"}}}, save="tmp_q"),
        _call("PreparedQuery.Get", {"id": Ref("tmp_q", "result")}),
        _call("PreparedQuery.Apply", {"op": "delete", "query": {
            "id": Ref("tmp_q", "result")}}),
        _call("Intention.Apply", {"op": "create", "intention": {
            "source": "tmp", "destination": "web"}}, save="tmp_ixn"),
        _call("Intention.Apply", {"op": "delete", "intention": {
            "id": Ref("tmp_ixn", "intention", "id"),
            "destination": "web"}}),
        _call("Status.Ping", {}, token=None),
    ]


def _bad_archive(with_sums: bool) -> bytes:
    """A well-formed tar.gz that fails the archive's own checks: its
    SHA256SUMS names the wrong digests, or it has none.  (A blob that is
    not gzip at all is refused by both packages with texts that differ in
    the bytes they quote: ``test_non_gzip_archive_refused``.)"""
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as gz:
        with tarfile.open(fileobj=gz, mode="w") as tar:
            files = [("meta.json", b'{"index": 1}'), ("state.bin", b"\x80")]
            if with_sums:
                files.append(("SHA256SUMS", b"00  meta.json\n00  state.bin\n"))
            for name, data in files:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _uuid(rng):
    return str(uuid.UUID(int=rng.getrandbits(128), version=4))


def _stream(seed=STREAM_SEED, n=STREAM_CALLS):
    """The seeded stream: the prologue, then ``n`` calls drawn over the
    sixteen endpoints with a token drawn for each (mostly the master
    token, else a limited, a read-only, an anonymous or an unknown one),
    then a snapshot saved and restored and a few reads after it."""
    rng = random.Random(seed)
    ids = {k: _uuid(rng) for k in ("pol_kv", "pol_ro", "pol_team",
                                   "role_team", "tok_kv", "tok_ro",
                                   "rule_team")}
    pool = {kind: [_uuid(rng) for _ in range(4)]
            for kind in ("session", "query", "intention", "policy")}
    calls = _prologue(ids)

    def token():
        return rng.choices([MASTER, ids["tok_kv"], ids["tok_ro"], "", BOGUS],
                           weights=[12, 4, 2, 1, 1])[0]

    def node():
        return rng.choice(NODES)

    def check_list():
        return [{"check_id": f"c{k}",
                 "status": rng.choice(("passing", "passing", "warning",
                                       "critical")),
                 **({"service_id": rng.choice(SERVICES)}
                    if rng.random() < 0.3 else {})}
                for k in range(rng.randint(0, 2))]

    def kv_entry(key=None):
        entry = {"key": key or rng.choice(KEYS),
                 "value": bytes(rng.getrandbits(8)
                                for _ in range(rng.randint(0, 6)))}
        if rng.random() < 0.3:
            entry["flags"] = rng.randint(0, 9)
        return entry

    def catalog():
        verb = rng.choice(("register", "register", "deregister", "list_nodes",
                           "list_services", "service_nodes", "node_services",
                           "service_dump", "kind_nodes", "datacenters"))
        if verb == "register":
            nd = rng.choice(NODES[:4])
            body = {"node": nd, "address": f"10.0.0.{NODES.index(nd) + 1}",
                    "checks": check_list()}
            if rng.random() < 0.6:
                svc = rng.choice(SERVICES)
                body["service"] = {"service": svc, "id": svc,
                                   "port": rng.choice((80, 5432, 8080)),
                                   "tags": rng.sample(["v1", "v2", "x"],
                                                      rng.randint(0, 2))}
            if rng.random() < 0.2:
                body["service"] = {"service": "mgw", "id": "mgw",
                                   "kind": "mesh-gateway", "port": 443}
            return "Catalog.Register", body
        if verb == "deregister":
            body = {"node": rng.choice(NODES[:4])}
            r = rng.random()
            if r < 0.4:
                body["service_id"] = rng.choice(SERVICES)
            elif r < 0.7:
                body["check_id"] = f"c{rng.randint(0, 1)}"
            return "Catalog.Deregister", body
        return {
            "list_nodes": ("Catalog.ListNodes", {}),
            "list_services": ("Catalog.ListServices", {}),
            "service_nodes": ("Catalog.ServiceNodes",
                              {"service": rng.choice(SERVICES),
                               **({"tag": "v1"} if rng.random() < 0.5
                                  else {})}),
            "node_services": ("Catalog.NodeServices", {"node": node()}),
            "service_dump": ("Catalog.ServiceDump", {}),
            "kind_nodes": ("Catalog.ServiceKindNodes",
                           {"kind": "mesh-gateway"}),
            "datacenters": ("Catalog.ListDatacenters", {}),
        }[verb]

    def health():
        verb = rng.choice(("node", "service", "state", "nodes"))
        if verb == "node":
            return "Health.NodeChecks", {"node": node()}
        if verb == "service":
            return "Health.ServiceChecks", {"service": rng.choice(SERVICES)}
        if verb == "state":
            return "Health.ChecksInState", {
                "state": rng.choice(("passing", "warning", "critical"))}
        return "Health.ServiceNodes", {"service": rng.choice(SERVICES),
                                       "passing_only": rng.random() < 0.5}

    def kvs():
        op = rng.choice(("set", "set", "cas", "delete", "delete-tree",
                         "delete-cas", "lock", "unlock", "get", "get",
                         "list", "keys"))
        if op == "get":
            return "KVS.Get", {"key": rng.choice(KEYS)}
        if op == "list":
            return "KVS.List", {"key": rng.choice(("app/", "cfg", ""))}
        if op == "keys":
            return "KVS.ListKeys", {"key": rng.choice(("app/", "")),
                                    "separator": rng.choice(("/", ""))}
        entry = kv_entry()
        if op in ("cas", "delete-cas"):
            entry["modify_index"] = rng.randint(0, 40)
        if op in ("lock", "unlock"):
            entry["session"] = rng.choice(pool["session"])
        if op == "delete-tree":
            entry["key"] = rng.choice(("app/c", "cfg", "team"))
        return "KVS.Apply", {"op": op, "entry": entry}

    def session():
        verb = rng.choice(("create", "create", "destroy", "get", "list",
                           "node", "renew"))
        sid = rng.choice(pool["session"])
        if verb == "create":
            return "Session.Apply", {"op": "create", "session": {
                "id": sid, "node": node(),
                "checks": rng.choice(([], ["serfHealth"], ["c0"])),
                "lock_delay": rng.choice((0, 3600)),
                "ttl": rng.choice(("", "3600s")),
                "behavior": rng.choice(("release", "delete"))}}
        if verb == "destroy":
            return "Session.Apply", {"op": "destroy", "session": {"id": sid}}
        if verb == "get":
            return "Session.Get", {"id": sid}
        if verb == "list":
            return "Session.List", {}
        if verb == "node":
            return "Session.NodeSessions", {"node": node()}
        return "Session.Renew", {"id": sid}

    def coordinate():
        verb = rng.choice(("update", "list", "node"))
        if verb == "update":
            return "Coordinate.Update", {"node": node(), "coord": {
                "vec": [round(rng.uniform(-1, 1), 3) for _ in range(8)],
                "height": 1e-5, "adjustment": 0.0, "error": 1.5}}
        if verb == "list":
            return "Coordinate.ListNodes", {}
        return "Coordinate.Node", {"node": node()}

    def txn():
        verbs = ("set", "get", "get-tree", "delete", "check-index",
                 "check-not-exists", "cas")
        ops = []
        for _ in range(rng.randint(1, 3)):
            verb = rng.choice(verbs)
            entry = {"key": rng.choice(KEYS)}
            if verb in ("set", "cas"):
                entry = kv_entry(entry["key"])
            if verb in ("check-index", "cas"):
                entry["modify_index"] = rng.randint(0, 40)
            ops.append({"kv": {"verb": verb, "entry": entry}})
        if all(op["kv"]["verb"] in ("get", "get-tree", "check-index",
                                    "check-not-exists") for op in ops) \
                and rng.random() < 0.6:
            return "Txn.Read", {"ops": ops}
        return "Txn.Apply", {"ops": ops}

    def config_entry():
        verb = rng.choice(("set", "delete", "get", "list"))
        kind, name = rng.choice((("service-defaults", "web"),
                                 ("service-defaults", "db"),
                                 ("proxy-defaults", "global")))
        if verb == "set":
            return "ConfigEntry.Apply", {"op": "set", "entry": {
                "kind": kind, "name": name,
                "protocol": rng.choice(("http", "tcp", "grpc"))}}
        if verb == "delete":
            return "ConfigEntry.Apply", {"op": "delete", "entry": {
                "kind": kind, "name": name}}
        if verb == "get":
            return "ConfigEntry.Get", {"kind": kind, "name": name}
        return "ConfigEntry.List", {"kind": rng.choice((kind, None))}

    def prepared_query():
        verb = rng.choice(("create", "update", "delete", "get", "list",
                           "execute", "execute"))
        qid = rng.choice(pool["query"])
        if verb in ("create", "update"):
            return "PreparedQuery.Apply", {"op": verb, "query": {
                "id": qid, "name": f"q{pool['query'].index(qid)}",
                "service": {"service": rng.choice(SERVICES),
                            "only_passing": rng.random() < 0.5},
                "limit": rng.choice((0, 1))}}
        if verb == "delete":
            return "PreparedQuery.Apply", {"op": "delete",
                                           "query": {"id": qid}}
        if verb == "get":
            return "PreparedQuery.Get", {"id": qid}
        if verb == "list":
            return "PreparedQuery.List", {}
        return "PreparedQuery.Execute", {"query_id": rng.choice(
            (qid, f"q{rng.randint(0, 3)}", "nope"))}

    def internal():
        verb = rng.choice(("authorize", "info", "dump"))
        if verb == "authorize":
            return "Internal.AclAuthorize", {
                "kind": rng.choice(("key", "node", "operator", "acl", "x")),
                "name": rng.choice(KEYS), "want": rng.choice(("read",
                                                              "write"))}
        if verb == "info":
            return "Internal.NodeInfo", {"node": node()}
        return "Internal.NodeDump", {}

    def operator():
        verb = rng.choice(("raft", "get", "set", "health", "remove"))
        if verb == "raft":
            return "Operator.RaftGetConfiguration", {}
        if verb == "get":
            return "Operator.AutopilotGetConfiguration", {}
        if verb == "set":
            return "Operator.AutopilotSetConfiguration", {
                "config": {"max_trailing_logs": rng.randint(100, 500)},
                "cas": rng.random() < 0.3,
                "modify_index": rng.randint(0, 30)}
        if verb == "health":
            return "Operator.ServerHealth", {}
        return "Operator.RaftRemovePeerByID", {"id": "s0"}

    def intention():
        verb = rng.choice(("create", "update", "delete", "list", "get",
                           "match", "check"))
        iid = rng.choice(pool["intention"])
        k = pool["intention"].index(iid)
        if verb in ("create", "update"):
            return "Intention.Apply", {"op": verb, "intention": {
                "id": iid, "source": rng.choice(("api", "*", f"src{k}")),
                "destination": rng.choice(("web", "db", "")),
                "action": rng.choice(("allow", "deny"))}}
        if verb == "delete":
            return "Intention.Apply", {"op": "delete", "intention": {
                "id": iid, "destination": "web"}}
        if verb == "list":
            return "Intention.List", {}
        if verb == "get":
            return "Intention.Get", {"id": iid}
        if verb == "match":
            return "Intention.Match", {"destination": rng.choice(SERVICES)}
        return "Intention.Check", {"source": rng.choice(("api", "src1")),
                                   "destination": rng.choice(SERVICES)}

    def acl():
        verb = rng.choice(("token_read", "token_list", "policy_list",
                           "policy_read", "policy_set", "policy_delete",
                           "role_list", "role_read", "method_list",
                           "method_read", "rule_list", "rule_read",
                           "token_set"))
        pid = rng.choice(pool["policy"])
        return {
            "token_read": ("ACL.TokenRead", {"secret_id": rng.choice(
                (ids["tok_kv"], ids["tok_ro"], BOGUS))}),
            "token_list": ("ACL.TokenList", {}),
            "policy_list": ("ACL.PolicyList", {}),
            "policy_read": ("ACL.PolicyRead", {"id": rng.choice(
                (pid, ids["pol_kv"]))}),
            "policy_set": ("ACL.PolicySet", {"policy": {
                "id": pid, "name": f"p{pool['policy'].index(pid)}",
                "rules": rng.choice(('{"key_prefix": {"cfg/": {"policy": '
                                     '"write"}}}', '{"operator": "read"}'))}}),
            "policy_delete": ("ACL.PolicyDelete", {"id": pid}),
            "role_list": ("ACL.RoleList", {}),
            "role_read": ("ACL.RoleRead", {"id": ids["role_team"]}),
            "method_list": ("ACL.AuthMethodList", {}),
            "method_read": ("ACL.AuthMethodRead", {"name": rng.choice(
                ("idp", "none"))}),
            "rule_list": ("ACL.BindingRuleList", {"auth_method": "idp"}),
            "rule_read": ("ACL.BindingRuleRead", {"id": ids["rule_team"]}),
            "token_set": ("ACL.TokenSet", {"acl_token": {
                "secret_id": ids["tok_ro"], "policies": [ids["pol_ro"], pid],
                "description": f"d{rng.randint(0, 9)}"}}),
        }[verb]

    def federation():
        verb = rng.choice(("apply", "get", "list", "gateways"))
        if verb == "apply":
            return "FederationState.Apply", {
                "op": rng.choice(("upsert", "upsert", "delete", "bogus")),
                "state": {"datacenter": rng.choice(("dc2", "dc3", "")),
                          "mesh_gateways": [{"service": "mgw",
                                             "address": "10.9.0.1",
                                             "port": 443}]}}
        if verb == "get":
            return "FederationState.Get", {"target_dc": rng.choice(
                ("dc2", "dc9"))}
        if verb == "list":
            return "FederationState.List", {}
        return "FederationState.ListMeshGateways", {}

    def status():
        return rng.choice(("Status.Ping", "Status.Leader",
                           "Status.Peers")), {}

    def snapshot():
        return "Snapshot.Save", {}

    def subscribe():
        return "Subscribe.Subscribe", {"topic": rng.choice(
            ("kv", "service_health")), "key": rng.choice(("", "web",
                                                          "app/a"))}

    makers = (status, catalog, health, kvs, session, coordinate, txn,
              config_entry, prepared_query, internal, operator, intention,
              acl, federation, snapshot, subscribe)
    weights = (1, 6, 3, 8, 5, 2, 3, 2, 3, 2, 2, 3, 4, 2, 1, 1)
    for i in range(n):
        # Every endpoint once in the first sixteen, then by weight.
        make = makers[i] if i < len(makers) else rng.choices(
            makers, weights=weights)[0]
        method, body = make()
        tok = token()
        if method.startswith("Status."):
            tok = None
        elif method == "Operator.RaftRemovePeerByID":
            # Only the refusals: the one server stays a voter.
            tok = rng.choice((ids["tok_kv"], ids["tok_ro"], "", BOGUS))
        calls.append(_call(method, body, token=tok,
                           after="coordinate" if method ==
                           "Coordinate.Update" else None))
    calls += [
        _call("Snapshot.Save", {}, save="archive"),
        _call("KVS.Apply", {"op": "set", "entry": {"key": "after",
                                                   "value": b"1"}}),
        _call("Snapshot.Restore", {"archive": Ref("archive", "archive")},
              token=ids["tok_ro"]),
        _call("Snapshot.Restore", {"archive": _bad_archive(True)}),
        _call("Snapshot.Restore", {"archive": _bad_archive(False)}),
        _call("Snapshot.Restore", {"archive": Ref("archive", "archive")}),
        _call("KVS.Get", {"key": "after"}),
        _call("KVS.List", {"key": ""}),
        _call("Catalog.ListNodes", {}),
        _call("ACL.TokenList", {}),
    ]
    return calls


async def _quiesce(srv):
    """Wait until the staged coordinate updates have been applied."""
    for _ in range(400):
        raft = srv.raft
        if (not srv._coord_updates and raft.commit_index == raft.last_index()
                and raft.last_applied == raft.commit_index):
            await asyncio.sleep(0.12)
            if not srv._coord_updates and \
                    raft.last_applied == raft.last_index():
                return
        await asyncio.sleep(0.01)
    raise AssertionError("coordinate updates were never flushed")


async def _run_stream(pkg, calls):
    """One run of the stream against a one-server DC of ``pkg`` over the
    wire; returns the replies, the final snapshot and the server's
    archive reader."""
    net = pkg.InMemoryNetwork()
    srv = pkg.Server(
        pkg.ServerConfig(
            node_name="s0", bootstrap_expect=1, acl_enabled=True,
            acl_default_policy="deny", acl_master_token=MASTER,
            acl_token_ttl_s=3600.0, federation_state_ae_interval_s=3600.0,
            **{**CADENCE, "coordinate_update_period_s": 0.05}),
        gossip_transport=net.new_transport("s0:gossip"),
        rpc_transport=net.new_transport("s0:rpc"),
    )
    await srv.start()
    await wait_for_leader([srv])
    await wait_until(lambda: srv.store.node("s0")[1] is not None,
                     msg="s0 reconciled into its catalog")
    client = pkg.rpc.RPCClient(net.new_transport("cli"))
    saved: dict = {}
    replies = []
    try:
        for call in calls:
            body = _resolve(call["body"], saved)
            if "token" in body and isinstance(body["token"], Ref):
                body["token"] = body["token"].resolve(saved)
            method = call["method"]
            try:
                if method == "Subscribe.Subscribe":
                    reply = []
                    gen = client.stream("s0:rpc", method, body)
                    async for item in gen:
                        reply.append(item)
                        if item.get("end_of_snapshot") or \
                                item.get("reset"):
                            break
                    await gen.aclose()
                else:
                    reply = await client.call("s0:rpc", method, body)
            except pkg.rpc.RPCError as e:
                reply = {"error": str(e)}
            if call["save"]:
                saved[call["save"]] = reply
            if call["after"] == "coordinate":
                await _quiesce(srv)
            replies.append((method, reply))
        snap = srv.store.snapshot()
        try:
            await client.call("s0:rpc", "ConnectCA.Roots", {"token": MASTER})
            connect_ca = None
        except Exception as e:  # noqa: BLE001 - the reply is what is held
            connect_ca = str(e)
    finally:
        await client.shutdown()
        await srv.shutdown()
    return replies, snap, connect_ca


class _Canon:
    """Maps generated IDs and wall-clock values out of a run's replies:
    every UUID becomes ``<id N>`` by its first appearance in the run, each
    time field becomes ``<time>``, and an archive is read back into its
    state and meta."""

    def __init__(self, read_archive):
        self.ids: dict = {}
        self.read_archive = read_archive

    def _id(self, m):
        return self.ids.setdefault(m.group(0), f"<id {len(self.ids)}>")

    def __call__(self, value, key=None):
        if key in TIME_FIELDS and isinstance(value, (int, float)):
            return "<time>"
        if key == "archive" and isinstance(value, bytes):
            try:
                state, meta = self.read_archive(value)
            except Exception as e:  # noqa: BLE001 - compared as text
                return f"<bad archive {type(e).__name__}>"
            return {"state": self(state), "meta": self(meta)}
        if isinstance(value, str):
            return UUID_RE.sub(self._id, value)
        if isinstance(value, bytes):
            return UUID_RE.sub(lambda m: self._id(m).encode(),
                               value.decode("latin-1")).encode("latin-1") \
                if UUID_RE.search(value.decode("latin-1")) else value
        if isinstance(value, dict):
            return {self(k): self(v, k) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(self(v) for v in value)
        return value


def test_endpoint_stream_equal(monkeypatch):
    calls = _stream()
    assert len(calls) >= 300
    assert {c["method"].split(".")[0] for c in calls} == {
        "Status", "Catalog", "Health", "KVS", "Session", "Coordinate",
        "Txn", "ConfigEntry", "PreparedQuery", "Internal", "Operator",
        "ACL", "Intention", "Snapshot", "Subscribe", "FederationState"}
    frames = []
    pack = t_rpc._pack

    def recorded(obj):
        raw = pack(obj)
        frames.append((obj, raw))
        return raw

    monkeypatch.setattr(t_rpc, "_pack", recorded)
    got = {}
    for name in ("jax", "torch"):
        pkg = PACKAGES[name]
        replies, snap, connect_ca = asyncio.run(asyncio.wait_for(
            _run_stream(pkg, calls), 120))
        canon = _Canon(pkg.read_archive)
        got[name] = ([(m, canon(r)) for m, r in replies], canon(snap),
                     connect_ca)
    (j_replies, j_snap, j_ca), (t_replies, t_snap, t_ca) = (
        got["jax"], got["torch"])
    assert len(j_replies) == len(t_replies) == len(calls)
    for i, (want, have) in enumerate(zip(j_replies, t_replies)):
        assert want == have, (i, want, have)
    assert j_snap == t_snap
    errors = sum(isinstance(r, dict) and "error" in r for _, r in t_replies)
    denied = sum(isinstance(r, dict) and r.get("error") == "Permission denied"
                 for _, r in t_replies)
    assert errors >= 30 and denied >= 10, (errors, denied)
    # Both packages answer ConnectCA.Roots.
    assert j_ca is None
    assert t_ca is None
    # Every frame the port's RPC layer packed, against the C codec.
    assert len(frames) > 2 * len(calls)
    for obj, raw in frames:
        assert raw == msgpack.packb(obj, use_bin_type=True)
        assert t_rpc._unpack(raw) == msgpack.unpackb(
            raw, raw=False, strict_map_key=False)


def test_non_gzip_archive_refused():
    """Both packages refuse a blob that is not gzip as an unreadable
    archive.  The JAX package reads the tar straight from the gzip stream,
    and ``tarfile`` tries its other formats on that stream before giving
    up, so the bytes its message quotes come from further into the blob
    than the port's, which inflates first."""
    blob = b"not an archive"
    for read, snapshot in ((j_snapshot.read_archive, j_snapshot),
                           (t_snapshot.read_archive, t_snapshot)):
        with pytest.raises(snapshot.SnapshotError,
                           match="^unreadable archive: Not a gzipped file"):
            read(blob)


# ---------------------------------------------------------------------------
# three servers on a simulated pool's segment
# ---------------------------------------------------------------------------

POOL_N = 64
POOL_FAILED = 42
POOL_BLOCK = 5
POOL_MAX_TICKS = 60


def _fast(pkg):
    """tests/test_sim_transport.py's FAST profile: probes every gossip
    tick, the smallest suspicion multiplier."""
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


async def _pool_catalog(name):
    """Three servers join the pool through its ``pool`` segment; the
    leader's reconcile folds every member in; the pool runs until the
    crashed member is DEAD at each server's segment memberlist and
    critical in the catalog.  Returns the leader's ``serfHealth`` status of
    every node, the servers' snapshots and the ticks run."""
    pkg = PACKAGES[name]
    bridge, sim_addr = _bridge(name)
    net = pkg.InMemoryNetwork()
    servers = [
        pkg.Server(
            pkg.ServerConfig(node_name=f"s{i}", bootstrap_expect=3,
                             segments=("pool",), autopilot_interval_s=0.3,
                             autopilot_server_stabilization_s=0.3, **CADENCE),
            gossip_transport=net.new_transport(f"s{i}:gossip"),
            rpc_transport=net.new_transport(f"s{i}:rpc"),
            segment_transports={"pool": bridge.transport(f"sim-host://s{i}")},
        )
        for i in range(3)
    ]
    target = f"sim-{POOL_FAILED}"
    try:
        for s in servers:
            await s.start()
        for s in servers[1:]:
            await s.join(["s0:gossip"])
        leader = await wait_for_leader(servers)
        for s in servers:
            assert await s.join_segment("pool", [sim_addr(17)]) == 1
        await wait_until(
            lambda: len(leader.store.nodes()[1]) == POOL_N + 3
            and len(leader._all_lan_members()) == POOL_N + 3,
            timeout=20, msg="the pool folded into the catalog")
        ticks = 0
        while ticks < POOL_MAX_TICKS:
            await bridge.run_ticks(POOL_BLOCK)
            ticks += POOL_BLOCK
            nodes = [s.segment_serfs["pool"].memberlist.nodes.get(target)
                     for s in servers]
            if all(n is not None and n.status == pkg.NodeStatus.DEAD
                   for n in nodes):
                break

        def checks():
            return {c["node"]: c["status"]
                    for st in ("passing", "warning", "critical")
                    for c in leader.store.checks_in_state(st)[1]
                    if c["check_id"] == "serfHealth"}

        await wait_until(lambda: checks().get(target) == "critical",
                         timeout=20, msg=f"{target} critical")
        await wait_until(
            lambda: all(s.store.snapshot() == leader.store.snapshot()
                        for s in servers),
            timeout=20, msg="the three stores agree")
        return checks(), ticks
    finally:
        for s in servers:
            await s.shutdown()
        await bridge.shutdown()


def test_pool_segment_catalog_equal():
    got = {name: asyncio.run(asyncio.wait_for(_pool_catalog(name), 120))
           for name in ("jax", "torch")}
    (j_checks, j_ticks), (t_checks, t_ticks) = got["jax"], got["torch"]
    assert len(t_checks) == POOL_N + 3
    assert t_checks == j_checks, (j_ticks, t_ticks)
    critical = sorted(n for n, st in t_checks.items() if st != "passing")
    assert critical == [f"sim-{POOL_FAILED}"]
