"""The port's FSM, change stream and snapshot archives
(``consul_tpu_torch.agent``, ``consul_tpu_torch.stream``) beside the JAX
package's, on the CPU, and the consistency plane as a whole.

  * one entry for each handler of ``ConsulFSM``'s dispatch table, several
    for most (success, a refused CAS, a domain error), an unknown type and
    unknown types under ``IGNORE_UNKNOWN_FLAG``: each gives the same
    result, ``{"error": ...}`` or exception in both packages, the same
    change-stream events and the same store snapshot;
  * subscriptions: the same snapshot-then-follow events, and a restore
    closes every subscription in both;
  * archives: for the same state ``write_archive`` gives the same bytes in
    both packages, each package reads the other's, and a flipped or cut
    byte is refused before any state changes;
  * the slice: the smoke's replicated catalog (``chip_smoke._Catalog``),
    three Raft servers with the port's ``ConsulFSM``, folds a member view
    after a join and after a failure, adds a fourth server after
    compaction and restores an archive on every server; the catalog
    equals the one the JAX package's FSM builds from the same entries.
"""

import asyncio
import gzip
import sys
import types
from pathlib import Path

import msgpack
import pytest

from consul_tpu.agent import fsm as j_fsm
from consul_tpu.agent import snapshot as j_snapshot
from consul_tpu.consensus.raft import Entry as JEntry
from consul_tpu.stream import publisher as j_pub
from consul_tpu_torch.agent import fsm as t_fsm
from consul_tpu_torch.agent import snapshot as t_snapshot
from consul_tpu_torch.consensus.raft import Entry as TEntry
from consul_tpu_torch.net import wire
from consul_tpu_torch.stream import publisher as t_pub

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MT = j_fsm.MessageType
FLAG = j_fsm.IGNORE_UNKNOWN_FLAG
REG_WEB = {
    "node": "n1", "address": "10.0.0.1",
    "service": {"service": "web", "id": "web-1", "tags": ["v1"],
                "port": 80},
    "checks": [{"check_id": "serfHealth", "status": "passing"},
               {"check_id": "svc:web-1", "service_id": "web-1",
                "status": "passing"}],
}

# (name, message type, body): each handler of the dispatch table at least
# once, in an order where later entries see the state earlier ones made.
STEPS = [
    ("register_service", MT.REGISTER, REG_WEB),
    ("register_node_only", MT.REGISTER, {"node": "n2",
                                         "address": "10.0.0.2"}),
    ("register_critical", MT.REGISTER, {
        "node": "n2", "check": {"check_id": "serfHealth",
                                "status": "critical"}}),
    ("register_address_change", MT.REGISTER, {"node": "n1",
                                              "address": "10.0.0.9"}),
    ("register_bad", MT.REGISTER, {"address": "no node"}),
    ("kvs_set", MT.KVS, {"op": "set", "entry": {"key": "a/x",
                                                "value": b"1"}}),
    ("kvs_cas_absent", MT.KVS, {"op": "cas", "entry": {
        "key": "a/y", "value": b"2", "modify_index": 0}}),
    ("kvs_cas_stale", MT.KVS, {"op": "cas", "entry": {
        "key": "a/x", "value": b"3", "modify_index": 1}}),
    ("kvs_cas_good", MT.KVS, {"op": "cas", "entry": {
        "key": "a/x", "value": b"4", "modify_index": 6}}),
    ("session_create", MT.SESSION, {"op": "create", "session": {
        "id": "sess-1", "node": "n1", "behavior": "delete",
        "lock_delay": 0.0}}),
    ("session_create_missing_node", MT.SESSION, {"op": "create", "session": {
        "id": "sess-2", "node": "ghost"}}),
    ("session_create_critical", MT.SESSION, {"op": "create", "session": {
        "id": "sess-3", "node": "n2"}}),
    ("kvs_lock", MT.KVS, {"op": "lock", "entry": {
        "key": "a/lock", "value": b"me", "session": "sess-1"}}),
    ("kvs_lock_other", MT.KVS, {"op": "lock", "entry": {
        "key": "a/lock", "value": b"them", "session": "sess-9"}}),
    ("kvs_unlock", MT.KVS, {"op": "unlock", "entry": {
        "key": "a/lock", "value": b"", "session": "sess-1"}}),
    ("kvs_relock", MT.KVS, {"op": "lock", "entry": {
        "key": "a/lock2", "session": "sess-1"}}),
    ("session_destroy", MT.SESSION, {"op": "destroy",
                                     "session": {"id": "sess-1"}}),
    ("session_bad_op", MT.SESSION, {"op": "renew",
                                    "session": {"id": "sess-1"}}),
    ("kvs_delete", MT.KVS, {"op": "delete", "entry": {"key": "a/y"}}),
    ("kvs_delete_cas_stale", MT.KVS, {"op": "delete-cas", "entry": {
        "key": "a/x", "modify_index": 1}}),
    ("kvs_delete_tree", MT.KVS, {"op": "delete-tree",
                                 "entry": {"key": "a/"}}),
    ("kvs_bogus", MT.KVS, {"op": "bogus", "entry": {}}),
    ("tombstone_reap", MT.TOMBSTONE, {"op": "reap", "index": 19}),
    ("tombstone_bad", MT.TOMBSTONE, {"op": "purge", "index": 1}),
    ("coordinates", MT.COORDINATE_BATCH_UPDATE, {"updates": [
        {"node": "n1", "coord": {"vec": [0.1, 0.2], "error": 1.5}},
        {"node": "ghost", "coord": {"vec": [0.0], "error": 1.0}}]}),
    ("prepared_query_create", MT.PREPARED_QUERY, {"op": "create", "query": {
        "id": "q1", "name": "web-q", "service": {"service": "web"}}}),
    ("prepared_query_update", MT.PREPARED_QUERY, {"op": "update", "query": {
        "id": "q1", "name": "web-q2", "service": {"service": "web"}}}),
    ("prepared_query_delete", MT.PREPARED_QUERY, {"op": "delete",
                                                  "query": {"id": "q1"}}),
    ("prepared_query_bad", MT.PREPARED_QUERY, {"op": "explain",
                                               "query": {"id": "q1"}}),
    ("txn", MT.TXN, {"ops": [
        {"kv": {"verb": "set", "entry": {"key": "t/1", "value": b"a"}}},
        {"kv": {"verb": "cas", "entry": {"key": "t/2", "value": b"b",
                                         "modify_index": 0}}},
        {"kv": {"verb": "get-tree", "entry": {"key": "t/"}}}]}),
    ("txn_rollback", MT.TXN, {"ops": [
        {"kv": {"verb": "set", "entry": {"key": "t/3", "value": b"c"}}},
        {"kv": {"verb": "check-not-exists", "entry": {"key": "t/1"}}}]}),
    ("autopilot", MT.AUTOPILOT, {"config": {"cleanup_dead_servers": True}}),
    ("autopilot_cas_stale", MT.AUTOPILOT, {
        "config": {"cleanup_dead_servers": False}, "cas": True,
        "modify_index": 1}),
    ("intention_create", MT.INTENTION, {"op": "create", "intention": {
        "id": "i1", "source": "web", "destination": "db",
        "action": "allow"}}),
    ("intention_delete", MT.INTENTION, {"op": "delete",
                                        "intention": {"id": "i1"}}),
    ("intention_bad", MT.INTENTION, {"op": "flip",
                                     "intention": {"id": "i1"}}),
    ("connect_ca", MT.CONNECT_CA, {"op": "set-root", "root": {
        "id": "root-1", "active": True, "root_cert": "PEM"}}),
    ("connect_ca_rotate", MT.CONNECT_CA, {"op": "set-root", "root": {
        "id": "root-2", "active": True, "root_cert": "PEM2"}}),
    ("connect_ca_bad", MT.CONNECT_CA, {"op": "sign"}),
    ("acl_policy_set", MT.ACL_POLICY_SET, {"policy": {
        "id": "p1", "name": "read", "rules": "key {}"}}),
    ("acl_token_set", MT.ACL_TOKEN_SET, {"token": {
        "secret_id": "t1", "accessor_id": "a1", "policies": ["p1"]}}),
    ("acl_role_set", MT.ACL_ROLE_SET, {"role": {"id": "r1",
                                                "name": "ops"}}),
    ("acl_auth_method_set", MT.ACL_AUTH_METHOD_SET, {"method": {
        "name": "kube", "type": "jwt"}}),
    ("acl_binding_rule_set", MT.ACL_BINDING_RULE_SET, {"rule": {
        "id": "b1", "auth_method": "kube", "bind_type": "role"}}),
    ("acl_token_minted", MT.ACL_TOKEN_SET, {"token": {
        "secret_id": "t2", "accessor_id": "a2", "auth_method": "kube"}}),
    ("acl_binding_rule_delete", MT.ACL_BINDING_RULE_DELETE, {"id": "b1"}),
    ("acl_auth_method_delete", MT.ACL_AUTH_METHOD_DELETE, {"name": "kube"}),
    ("acl_role_delete", MT.ACL_ROLE_DELETE, {"id": "r1"}),
    ("acl_token_delete", MT.ACL_TOKEN_DELETE, {"secret_id": "t1"}),
    ("acl_token_delete_missing", MT.ACL_TOKEN_DELETE, {"secret_id": "t9"}),
    ("acl_policy_delete", MT.ACL_POLICY_DELETE, {"id": "p1"}),
    ("config_entry_set", MT.CONFIG_ENTRY, {"op": "set", "entry": {
        "kind": "service-defaults", "name": "web", "protocol": "http"}}),
    ("config_entry_cas_stale", MT.CONFIG_ENTRY, {
        "op": "cas", "modify_index": 1, "entry": {
            "kind": "service-defaults", "name": "web", "protocol": "tcp"}}),
    ("config_entry_upsert", MT.CONFIG_ENTRY, {"op": "upsert", "entry": {
        "kind": "proxy-defaults", "name": "global"}}),
    ("config_entry_delete", MT.CONFIG_ENTRY, {"op": "delete", "entry": {
        "kind": "service-defaults", "name": "web"}}),
    ("config_entry_bad", MT.CONFIG_ENTRY, {"op": "merge", "entry": {}}),
    ("federation_state", MT.FEDERATION_STATE, {"op": "upsert", "state": {
        "datacenter": "dc2", "mesh_gateways": [{"address": "1.1.1.1"}]}}),
    ("federation_state_delete", MT.FEDERATION_STATE, {
        "op": "delete", "state": {"datacenter": "dc2"}}),
    ("federation_state_no_dc", MT.FEDERATION_STATE, {"op": "upsert",
                                                     "state": {}}),
    ("deregister_check", MT.DEREGISTER, {"node": "n1",
                                         "check_id": "svc:web-1"}),
    ("deregister_service", MT.DEREGISTER, {"node": "n1",
                                           "service_id": "web-1"}),
    ("register_again", MT.REGISTER, REG_WEB),
    ("deregister_node", MT.DEREGISTER, {"node": "n1"}),
    ("deregister_missing", MT.DEREGISTER, {"node": "ghost"}),
    ("flagged_kvs", MT.KVS | FLAG, {"op": "set", "entry": {
        "key": "flag/known", "value": b"ok"}}),
    ("unknown_ignored", 99 | FLAG, {"anything": 1}),
    ("unknown", 99, {"anything": 1}),
    ("missing_body_key", MT.KVS, {"entry": {"key": "x"}}),
]
HANDLED = {t for _, t, _ in STEPS if t & ~FLAG in set(MT)}


def events(evs) -> list:
    return [(e.topic, e.key, e.index, e.payload, e.end_of_snapshot)
            for e in evs]


def make(fsm_mod, pub_mod):
    """An FSM whose publisher records every published event."""
    class Recording(pub_mod.EventPublisher):
        def __init__(self):
            super().__init__()
            self.log: list = []

        def publish(self, evs):
            self.log.append(events(evs))
            super().publish(evs)

    return fsm_mod.ConsulFSM(publisher=Recording())


def apply(fsm, entry_cls, idx, msg_type, body):
    try:
        return ("ok", fsm.apply(entry_cls(idx, 1, 0, {"type": int(msg_type),
                                                      "body": body})))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__, str(e))


def run_steps(n):
    """Both packages' FSMs through the first ``n`` steps; yields each
    step's results, events and snapshots."""
    ref, port = make(j_fsm, j_pub), make(t_fsm, t_pub)
    for idx, (name, msg_type, body) in enumerate(STEPS[:n], start=1):
        want = apply(ref, JEntry, idx, msg_type, body)
        got = apply(port, TEntry, idx, msg_type, body)
        yield name, want, got, ref, port


def test_every_handler_is_covered():
    assert {int(t) for t in MT} <= {int(t) & ~FLAG for t in HANDLED} | {
        int(MT.ACL), int(MT.AREA), int(MT.ACL_BOOTSTRAP),
        int(MT.SNAPSHOT_RESTORE)}
    port_table = t_fsm.ConsulFSM()._handlers
    assert sorted(port_table) == sorted(j_fsm.ConsulFSM()._handlers)
    assert ([(t.name, int(t)) for t in t_fsm.MessageType]
            == [(t.name, int(t)) for t in j_fsm.MessageType])
    assert t_fsm.IGNORE_UNKNOWN_FLAG == j_fsm.IGNORE_UNKNOWN_FLAG


@pytest.mark.parametrize("step", range(len(STEPS)),
                         ids=[name for name, _, _ in STEPS])
def test_handler_matches_reference(step):
    for name, want, got, ref, port in run_steps(step + 1):
        assert got == want, name
        assert port.publisher.log == ref.publisher.log, name
        assert port.snapshot() == ref.snapshot(), name
    if name == "unknown":
        assert want[0] == "raise" and want[1] == "ValueError"
    elif name == "unknown_ignored":
        assert want == ("ok", None)
    elif name.endswith(("_bad", "_no_dc", "_missing_node", "_critical",
                        "_bad_op", "bogus", "missing_body_key")) and \
            name != "register_critical":
        assert want[0] == "ok" and set(want[1]) == {"error"}, want


def test_steps_publish_events():
    """The sequence drives both topics of the change stream."""
    *_, (_, _, _, ref, port) = run_steps(len(STEPS))
    topics = {ev[0] for batch in port.publisher.log for ev in batch}
    assert topics == {t_pub.TOPIC_KV, t_pub.TOPIC_SERVICE_HEALTH}
    assert port.publisher.log == ref.publisher.log


def test_subscriptions_follow_and_restore_closes_them():
    async def run(fsm_mod, pub_mod, entry_cls):
        fsm = fsm_mod.ConsulFSM(publisher=pub_mod.EventPublisher())
        apply(fsm, entry_cls, 1, MT.REGISTER, REG_WEB)
        apply(fsm, entry_cls, 2, MT.KVS, {"op": "set", "entry": {
            "key": "k/1", "value": b"v"}})
        health = fsm.publisher.subscribe(pub_mod.TOPIC_SERVICE_HEALTH, "web")
        kv = fsm.publisher.subscribe(pub_mod.TOPIC_KV, "")
        snap = fsm.snapshot()
        apply(fsm, entry_cls, 3, MT.KVS, {"op": "set", "entry": {
            "key": "k/2", "value": b"w"}})
        apply(fsm, entry_cls, 4, MT.REGISTER, {
            "node": "n1", "check": {"check_id": "serfHealth",
                                    "status": "critical"}})
        seen = []
        for sub, count in ((health, 2), (kv, 3)):
            for _ in range(count):
                seen.append(events([await sub.next(timeout=1.0)]))
        apply(fsm, entry_cls, 5, MT.SNAPSHOT_RESTORE, {"state": snap})
        closed = []
        for sub in (health, kv):
            try:
                await sub.next(timeout=0.1)
            except pub_mod.SubscriptionClosed:
                closed.append(True)
        return seen, closed, fsm.snapshot() == snap

    want = asyncio.run(run(j_fsm, j_pub, JEntry))
    got = asyncio.run(run(t_fsm, t_pub, TEntry))
    assert got == want
    assert got[1] == [True, True] and got[2]


def _state():
    *_, (_, _, _, ref, _) = run_steps(len(STEPS))
    return ref.snapshot()


def test_archive_bytes_and_cross_reads():
    state = _state()
    blob_j = j_snapshot.write_archive(state, 70, 3, "s0")
    blob_t = t_snapshot.write_archive(state, 70, 3, "s0")
    assert blob_t == blob_j
    assert (gzip.decompress(blob_t).find(wire.packb(state))
            == gzip.decompress(blob_j).find(
                msgpack.packb(state, use_bin_type=True)))
    want = ({**state}, {"index": 70, "term": 3, "node": "s0", "version": 1})
    assert t_snapshot.read_archive(blob_j) == want
    assert j_snapshot.read_archive(blob_t) == want
    # A store restored from the archive snapshots to the same state.
    fsm = t_fsm.ConsulFSM()
    fsm.restore(t_snapshot.read_archive(blob_j)[0])
    assert fsm.snapshot() == state


def test_archive_int_keys_read_back():
    """The archive's state may hold int map keys (``strict_map_key=False``
    in the reference)."""
    state = {"tables": {}, "indexes": [], "extra": {1: "one", 2: [3]}}
    blob = t_snapshot.write_archive(state, 1, 1, "s0")
    assert blob == j_snapshot.write_archive(state, 1, 1, "s0")
    assert t_snapshot.read_archive(blob)[0] == state
    assert j_snapshot.read_archive(blob)[0] == state


# The gzip header's FTEXT bit, MTIME, XFL and OS carry no data.
FREE_HEADER = range(3, 10)


def test_flipped_or_cut_archive_is_refused():
    """Every byte that carries data, flipped, is a SnapshotError in the
    port; the JAX package refuses most of them (a few by another error)
    but reads a changed gzip trailer as good, since its tar reader stops
    before it.  Neither ever returns a changed state."""
    state = _state()
    blob = t_snapshot.write_archive(state, 70, 3, "s0")
    good = t_snapshot.read_archive(blob)
    outcomes = {"port_refused": 0, "ref_refused": 0, "ref_read_good": 0}
    for pos in range(len(blob)):
        bad = bytearray(blob)
        bad[pos] ^= 0x01
        if pos in FREE_HEADER:
            assert t_snapshot.read_archive(bytes(bad)) == good
            continue
        with pytest.raises(t_snapshot.SnapshotError):
            t_snapshot.read_archive(bytes(bad))
        outcomes["port_refused"] += 1
        try:
            got = j_snapshot.read_archive(bytes(bad))
        except Exception:  # noqa: BLE001 - a refusal of any kind
            outcomes["ref_refused"] += 1
        else:
            assert got == good, pos
            outcomes["ref_read_good"] += 1
    assert outcomes["port_refused"] == len(blob) - len(FREE_HEADER)
    assert outcomes["ref_refused"] > 0.9 * outcomes["port_refused"]
    for cut in (0, 10, len(blob) // 2, len(blob) - 9, len(blob) - 1):
        with pytest.raises(t_snapshot.SnapshotError):
            t_snapshot.read_archive(blob[:cut])
    with pytest.raises(j_snapshot.SnapshotError):
        j_snapshot.read_archive(blob[:len(blob) // 2])


def test_tampered_member_is_refused_in_both():
    """A state.bin changed inside a well-formed archive fails its
    checksum in both packages; a missing member is named."""
    import io
    import tarfile

    def rebuild(blob, edit):
        with tarfile.open(fileobj=io.BytesIO(gzip.decompress(blob))) as tar:
            files = {m.name: tar.extractfile(m).read()
                     for m in tar.getmembers()}
        files = edit(files)
        out = io.BytesIO()
        with gzip.GzipFile(fileobj=out, mode="wb", mtime=0) as gz:
            with tarfile.open(fileobj=gz, mode="w") as tar:
                for name, data in files.items():
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
        return out.getvalue()

    blob = t_snapshot.write_archive(_state(), 70, 3, "s0")

    def flip(data):
        data = bytearray(data)
        data[len(data) // 2] ^= 0x01
        return bytes(data)

    tampered = rebuild(blob, lambda f: {**f, "state.bin": flip(
        f["state.bin"])})
    partial = rebuild(blob, lambda f: {k: v for k, v in f.items()
                                       if k != "meta.json"})
    for mod in (j_snapshot, t_snapshot):
        with pytest.raises(mod.SnapshotError, match="checksum"):
            mod.read_archive(tampered)
        with pytest.raises(mod.SnapshotError, match="missing meta.json"):
            mod.read_archive(partial)


def test_agent_exports():
    from consul_tpu import stream as j_stream
    from consul_tpu_torch import agent, stream

    assert agent.__all__ == ["ConsulFSM", "MessageType", "SnapshotError",
                             "read_archive", "write_archive"]
    assert stream.__all__ == j_stream.__all__


def _members(n):
    from consul_tpu_torch.eventing import MemberStatus

    out = {f"sim-{i}": types.SimpleNamespace(
        name=f"sim-{i}", addr=f"sim://{i}", tags={},
        status=MemberStatus.ALIVE) for i in range(n)}
    out["host0"] = types.SimpleNamespace(
        name="host0", addr="sim-host://host0", tags={"segment": "a"},
        status=MemberStatus.ALIVE)
    return out


def _unindexed(snap):
    def strip(rec):
        return {k: v for k, v in rec.items()
                if k not in ("create_index", "modify_index")}

    return {t: sorted((strip(r) for r in recs), key=repr)
            for t, recs in snap["tables"].items()}


def test_smoke_catalog_on_the_cpu(capsys, monkeypatch):
    """The smoke's consistency plane at n = 300 with a snapshot threshold
    of 64: both folds (a failure and a leave between them), the fourth
    server's InstallSnapshot and the archive restore; the catalog equals
    the one the JAX package's FSM builds from the same commands, indexes
    aside."""
    import chip_smoke
    from consul_tpu_torch.eventing import MemberStatus

    n = 300
    commands = []
    monkeypatch.setattr(chip_smoke, "CATALOG_RAFT", dict(
        chip_smoke.CATALOG_RAFT, snapshot_threshold=64, snapshot_trailing=16))

    async def run():
        view = types.SimpleNamespace(members=_members(n))
        catalog = chip_smoke._Catalog()
        apply_cmd = catalog.apply

        async def recorded(msg_type, body):
            commands.append((msg_type, body))
            return await apply_cmd(msg_type, body)

        catalog.apply = recorded
        await catalog.start()
        first = await catalog.reconcile(view)
        catalog.check_view(first["view"], "join")
        view.members["sim-42"].status = MemberStatus.FAILED
        view.members["sim-7"].status = MemberStatus.LEFT
        second = await catalog.reconcile(view)
        catalog.check_view(second["view"], "failed")
        row = await chip_smoke._consistency(catalog, second["view"], "cpu", {
            "fold_after_join": first["applied"],
            "fold_after_failed": second["applied"]})
        return first, second, row, catalog

    first, second, row, catalog = asyncio.run(run())
    assert first["applied"] >= n + 1
    assert second["applied"] >= 2
    assert row["nodes"] == {f"s{i}": n for i in range(4)}
    assert row["critical"] == 1 and row["critical_names"] == ["sim-42"]
    assert min(row["snapshot_index"].values()) > 0
    assert "consistency {" in capsys.readouterr().out
    ref = j_fsm.ConsulFSM()
    folded = [c for c in commands if c[0] != MT.SNAPSHOT_RESTORE]
    assert len(folded) == len(commands) - 1
    for idx, (msg_type, body) in enumerate(folded, start=1):
        assert apply(ref, JEntry, idx, msg_type, body) == ("ok", True)
    for node in catalog.servers:
        assert (_unindexed(node.fsm.store.snapshot())
                == _unindexed(ref.store.snapshot()))
