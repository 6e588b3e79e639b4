"""The port's state store (``consul_tpu_torch.store``) beside the JAX
package's, on the CPU.

  * a seeded stream of writes goes through both packages' ``StateStore``:
    the catalog (nodes, services, checks, deletions), KV with CAS, locks
    and tree deletes, sessions with both behaviours and their
    invalidation, txn, tombstone reaps, coordinates, config entries,
    prepared queries, intentions, CA roots, ACLs and federation states.
    Each write must return the same result or raise the same error; a
    fixed set of blocking-query reads, taken before each write with a
    ``WatchSet`` each, must read the same and fire the same sets; and the
    two stores must end in the same ``snapshot()``, with the same msgpack
    bytes, that each package restores from the other's;
  * the radix tree and memdb underneath: a seeded stream of inserts and
    deletes, the same iteration order, watch firings and change lists.

The lock delays read ``time.monotonic()``, outside the FSM's determinism;
they are held by behaviour (a delay after a destroy that held locks, none
otherwise), not by value.
"""

import asyncio

import msgpack
import numpy as np
import pytest

from consul_tpu.store import iradix as j_iradix
from consul_tpu.store import memdb as j_memdb
from consul_tpu.store import state as j_state
from consul_tpu_torch.net import wire
from consul_tpu_torch.store import iradix as t_iradix
from consul_tpu_torch.store import memdb as t_memdb
from consul_tpu_torch.store import state as t_state

NODES = [f"n{i}" for i in range(6)]
SERVICES = ["web", "db", "api"]
KEYS = ["a/x", "a/y", "a/b/z", "b/q", "b/r", "c"]
SESSIONS = [f"sess-{i}" for i in range(4)]
STATUSES = ["passing", "warning", "critical"]
WRITES = 600


def fired(ws) -> bool:
    return any(ev.is_set() for ev in ws._events)


# Blocking-query reads whose WatchSets are compared around every write.
READS = (
    ("nodes", ()), ("node", ("n1",)), ("node_checks", ("n2",)),
    ("node_services", ("n0",)), ("services", ()),
    ("service_nodes", ("web",)), ("check_service_nodes", ("web",)),
    ("check_service_nodes", ("db",)), ("checks_in_state", ("critical",)),
    ("service_checks", ("api",)), ("kv_get", ("a/x",)),
    ("kv_list", ("a/",)), ("kv_keys", ("", "/")), ("session_list", ()),
    ("node_sessions", ("n1",)), ("coordinates", ()),
    ("config_entries_by_kind", (None,)), ("prepared_query_list", ()),
    ("intention_list", ()), ("ca_roots", ()),
    ("federation_state_list", ()),
)


def read_all(store):
    out = []
    for name, args in READS:
        ws = (j_memdb if isinstance(store, j_state.StateStore)
              else t_memdb).WatchSet()
        out.append((name, getattr(store, name)(*args, ws=ws), ws))
    return out


class Stream:
    """Draws one write at a time from a seeded numpy generator, reading
    the reference store to pick CAS indexes and lock holders."""

    def __init__(self, seed: int, ref):
        self.rng = np.random.RandomState(seed)
        self.ref = ref
        self.idx = 0

    def pick(self, seq):
        return seq[self.rng.randint(len(seq))]

    def coin(self, p=0.5) -> bool:
        return bool(self.rng.random_sample() < p)

    def entry(self, key=None) -> dict:
        e = {"key": key or self.pick(KEYS),
             "value": bytes(self.rng.randint(0, 256, self.rng.randint(4))
                            .astype(np.uint8))}
        if self.coin(0.3):
            e["flags"] = int(self.rng.randint(1, 100))
        return e

    def modify_index(self, key) -> int:
        rec = self.ref.kv_get(key)[1]
        if rec is None or self.coin(0.25):
            return int(self.rng.randint(0, self.idx + 1))
        return rec["modify_index"]

    def register(self) -> dict:
        node = self.pick(NODES)
        req = {"node": node, "address": f"10.0.0.{self.rng.randint(4)}"}
        if self.coin(0.3):
            req["node_meta"] = {"rack": self.pick(["r1", "r2"])}
        if self.coin(0.6):
            svc = self.pick(SERVICES)
            req["service"] = {"service": svc,
                              "id": f"{svc}-{self.rng.randint(2)}",
                              "tags": sorted({self.pick(["v1", "v2", "x"])
                                              for _ in range(2)}),
                              "port": int(self.rng.randint(1, 9000))}
        checks = []
        if self.coin(0.6):
            checks.append({"check_id": "serfHealth", "name": "Serf Health",
                           "status": self.pick(STATUSES)})
        if req.get("service") and self.coin(0.5):
            checks.append({"check_id": f"svc:{req['service']['id']}",
                           "service_id": req["service"]["id"],
                           "status": self.pick(STATUSES),
                           "output": self.pick(["", "ok", "timeout"])})
        if checks and self.coin(0.5):
            req["check"] = checks.pop()
        if checks:
            req["checks"] = checks
        return req

    def txn_op(self) -> dict:
        verb = self.pick(["set", "cas", "lock", "unlock", "get", "get-tree",
                          "check-index", "check-session",
                          "check-not-exists", "delete", "delete-tree",
                          "delete-cas", "bogus"])
        entry = self.entry(self.pick(KEYS + ["a/", "b/"]))
        if verb in ("cas", "check-index", "delete-cas"):
            entry["modify_index"] = self.modify_index(entry["key"])
        if verb in ("lock", "unlock", "check-session"):
            entry["session"] = self.pick(SESSIONS)
        if self.coin(0.03):
            return {"kv": {"entry": entry}}  # malformed: no verb
        return {"kv": {"verb": verb, "entry": entry}}

    def next(self):
        """(method, args) of the next write, at raft index ``self.idx``."""
        self.idx += 1
        i = self.idx
        r = self.rng.random_sample()
        key = self.pick(KEYS)
        if r < 0.16:
            return "ensure_registration", (i, self.register())
        if r < 0.19:
            return "delete_node", (i, self.pick(NODES))
        if r < 0.22:
            return "delete_service", (
                i, self.pick(NODES), f"{self.pick(SERVICES)}-"
                f"{self.rng.randint(2)}")
        if r < 0.25:
            return "delete_check", (i, self.pick(NODES), self.pick(
                ["serfHealth", "svc:web-0", "svc:db-1"]))
        if r < 0.33:
            return "kv_set", (i, self.entry())
        if r < 0.39:
            return "kv_set_cas", (i, self.entry(key), self.modify_index(key))
        if r < 0.42:
            return "kv_delete", (i, key)
        if r < 0.45:
            return "kv_delete_cas", (i, key, self.modify_index(key))
        if r < 0.47:
            return "kv_delete_tree", (i, self.pick(["a/", "b/", "a/b/"]))
        if r < 0.53:
            return "kv_lock", (i, self.entry(key), self.pick(SESSIONS))
        if r < 0.57:
            return "kv_unlock", (i, self.entry(key), self.pick(SESSIONS))
        if r < 0.64:
            sess = {"id": self.pick(SESSIONS), "node": self.pick(NODES),
                    "behavior": self.pick(["release", "delete", ""]),
                    "lock_delay": self.pick([0.0, 15.0])}
            if self.coin(0.3):
                sess["checks"] = []
            return "session_create", (i, sess)
        if r < 0.68:
            return "session_destroy", (i, self.pick(SESSIONS))
        if r < 0.76:
            return "txn_apply", (i, [self.txn_op() for _ in
                                     range(self.rng.randint(1, 5))])
        if r < 0.79:
            return "tombstone_reap", (i, int(self.rng.randint(0, i)))
        if r < 0.84:
            return "coordinate_batch_update", (i, [
                {"node": self.pick(NODES + ["ghost"]),
                 "segment": self.pick(["", "alpha"]),
                 "coord": {"vec": [float(x) for x in
                                   self.rng.standard_normal(3)],
                           "error": 1.5, "adjustment": 0.0,
                           "height": 1e-5}}
                for _ in range(self.rng.randint(1, 4))])
        return self.other(i)

    def other(self, i):
        kind = self.rng.randint(12)
        name = self.pick(["alpha", "beta"])
        if kind == 0:
            return "config_entry_set", (i, {"kind": "service-defaults",
                                            "name": name,
                                            "protocol": self.pick(
                                                ["http", "tcp"])})
        if kind == 1:
            return "config_entry_delete", (i, "service-defaults", name)
        if kind == 2:
            return "prepared_query_set", (i, {"id": f"q-{name}",
                                              "name": name,
                                              "service": {"service": "web"}})
        if kind == 3:
            return "prepared_query_delete", (i, f"q-{name}")
        if kind == 4:
            return "intention_set", (i, {"id": f"i-{name}",
                                         "source": self.pick(["web", "*"]),
                                         "destination": self.pick(
                                             ["db", "*"]),
                                         "action": "allow"})
        if kind == 5:
            return "intention_delete", (i, f"i-{name}")
        if kind == 6:
            return "ca_root_set", (i, {"id": f"root-{name}",
                                       "active": self.coin(),
                                       "root_cert": "PEM"})
        if kind == 7:
            return "acl_token_set", (i, {"secret_id": f"tok-{name}",
                                         "accessor_id": f"acc-{name}",
                                         "auth_method": self.pick(
                                             ["", "kube"])})
        if kind == 8:
            return "acl_policy_set", (i, {"id": f"pol-{name}",
                                          "name": name, "rules": ""})
        if kind == 9:
            return "acl_auth_method_set", (i, {"name": "kube",
                                               "type": "jwt"})
        if kind == 10:
            return "acl_auth_method_delete", (i, "kube")
        return "federation_state_set", (i, {"datacenter": name,
                                            "mesh_gateways": []})


def call(store, method, args):
    try:
        return ("ok", getattr(store, method)(*args))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_stream_matches_reference(seed):
    ref, port = j_state.StateStore(), t_state.StateStore()
    stream = Stream(seed, ref)
    fired_any = set()
    kinds = set()
    held_delays = 0
    for _ in range(WRITES):
        method, args = stream.next()
        kinds.add(method)
        reads = read_all(ref), read_all(port)
        for (name, want, _), (_, got, _) in zip(*reads):
            assert got == want, (method, name)
        held = {k for k in KEYS if (ref.kv_get(k)[1] or {}).get("session")}
        want, got = call(ref, method, args), call(port, method, args)
        assert got == want, (stream.idx, method, args)
        for (name, _, ws_j), (_, _, ws_t) in zip(*reads):
            assert fired(ws_t) == fired(ws_j), (stream.idx, method, name)
            if fired(ws_j):
                fired_any.add(name)
        if method == "session_destroy" and held:
            for k in KEYS:
                assert ((port.kv_lock_delay(k) > 0)
                        == (ref.kv_lock_delay(k) > 0)), (stream.idx, k)
                held_delays += ref.kv_lock_delay(k) > 0
    # The stream reached every kind of write, every read's watch fired and
    # a destroy left a lock delay.
    assert len(kinds) == 28, sorted(kinds)
    assert fired_any == {name for name, _ in READS}
    assert held_delays > 0
    snap_j, snap_t = ref.snapshot(), port.snapshot()
    assert snap_t == snap_j
    assert wire.packb(snap_t) == msgpack.packb(snap_j, use_bin_type=True)
    # Each package restores the other's snapshot to the same state, and a
    # restore wakes the blocked queries of the store it replaces.
    for src, dst_cls in ((snap_j, t_state.StateStore),
                         (snap_t, j_state.StateStore)):
        dst = dst_cls()
        abandon = dst.abandon_event()
        dst.restore(src)
        assert abandon.is_set()
        assert dst.snapshot() == snap_j
        assert dst.max_index("kvs", "nodes") == ref.max_index("kvs", "nodes")


def test_write_stream_is_long_and_mixed():
    """The stream holds at least 500 writes, among them each behaviour
    the slice names: catalog, CAS, both session behaviours, txn, reaps
    and coordinates."""
    ref = j_state.StateStore()
    stream = Stream(0, ref)
    seen = set()
    for _ in range(WRITES):
        method, args = stream.next()
        if method == "session_create":
            seen.add("session:" + (args[1]["behavior"] or "release"))
        seen.add(method)
        call(ref, method, args)
    assert WRITES >= 500
    assert {"ensure_registration", "kv_set_cas", "kv_delete_cas",
            "session:release", "session:delete", "txn_apply",
            "tombstone_reap", "coordinate_batch_update"} <= seen


def test_constants_and_exports_match_reference():
    from consul_tpu import store as j_pkg
    from consul_tpu_torch import store as t_pkg

    assert t_pkg.__all__ == j_pkg.__all__
    for name in ("HEALTH_PASSING", "HEALTH_WARNING", "HEALTH_CRITICAL",
                 "SESSION_BEHAVIOR_RELEASE", "SESSION_BEHAVIOR_DELETE"):
        assert getattr(t_pkg, name) == getattr(j_pkg, name)
    assert t_state.SERF_CHECK_ID == j_state.SERF_CHECK_ID
    assert t_state.DUMP_TABLES == j_state.DUMP_TABLES


@pytest.mark.parametrize("seed", [0, 1])
def test_radix_tree_matches_reference(seed):
    """Inserts and deletes through path-copying txns: the same values,
    iteration order, sizes and fired watches; old roots stay frozen."""
    rng = np.random.RandomState(seed)
    trees = [j_iradix.Tree(), t_iradix.Tree()]
    alphabet = [b"", b"a", b"ab", b"abc", b"b", b"ba", b"\x00", b"\xff"]

    def key():
        return b"".join(alphabet[rng.randint(len(alphabet))]
                        for _ in range(rng.randint(1, 4)))

    for _ in range(300):
        watched = [key() for _ in range(3)]
        watches = [[t.watch_prefix(w) for w in watched] for t in trees]
        ops = [(rng.random_sample() < 0.7, key(), int(rng.randint(100)))
               for _ in range(rng.randint(1, 6))]
        old = [list(t.iterate(b"")) for t in trees]
        out = []
        for i, t in enumerate(trees):
            txn = t.txn()
            res = [txn.insert(k, v) if ins else txn.delete(k)
                   for ins, k, v in ops]
            trees[i] = txn.commit()
            out.append(res)
            assert list(t.iterate(b"")) == old[i]  # the old root is frozen
        assert out[1] == out[0]
        assert ([e is not None and e.is_set() for e in watches[1]]
                == [e is not None and e.is_set() for e in watches[0]])
        prefix = key()
        assert (list(trees[1].iterate(prefix))
                == list(trees[0].iterate(prefix)))
        assert len(trees[1]) == len(trees[0])


def test_memdb_changes_and_watch_sets_match_reference():
    """A table with a secondary index: the same change lists, records
    through both indexes, and a WatchSet that wakes on commit."""
    def db(mod):
        return mod.MemDB([mod.TableSchema(
            "t", primary=lambda r: r["id"].encode(),
            indexes=(mod.IndexSchema("g", key=lambda r: r["g"].encode()),))])

    dbs = [db(j_memdb), db(t_memdb)]
    rng = np.random.RandomState(5)
    for _ in range(200):
        rec = {"id": f"r{rng.randint(20)}", "g": f"g{rng.randint(3)}",
               "v": int(rng.randint(9))}
        delete = rng.random_sample() < 0.3
        wss, outs = [], []
        for d, mod in zip(dbs, (j_memdb, t_memdb)):
            ws = mod.WatchSet()
            d.txn().records("t", b"g1", index="g", ws=ws)
            tx = d.txn(write=True)
            if delete:
                tx.delete("t", rec["id"].encode())
            else:
                tx.insert("t", dict(rec))
            changes = tx.commit()
            outs.append(([(c.table, c.op, c.before, c.after)
                          for c in changes],
                          d.txn().records("t"),
                          d.txn().records("t", b"g", index="g")))
            wss.append(fired(ws))
        assert outs[1] == outs[0]
        assert wss[1] == wss[0]


def test_watch_set_wait_wakes_on_commit():
    async def run():
        woke = []
        for mod, st in ((j_memdb, j_state), (t_memdb, t_state)):
            store = st.StateStore()
            ws = mod.WatchSet()
            store.kv_get("k", ws=ws)
            waiter = asyncio.create_task(ws.wait(timeout=5.0))
            await asyncio.sleep(0)
            store.kv_set(1, {"key": "k", "value": b"v"})
            woke.append(await waiter)
            ws2 = mod.WatchSet()
            store.kv_get("other", ws=ws2)
            woke.append(await ws2.wait(timeout=0.01))
        return woke

    assert asyncio.run(run()) == [True, False, True, False]
