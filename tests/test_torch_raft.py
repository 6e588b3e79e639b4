"""The port's Raft (``consul_tpu_torch.consensus``) beside the JAX
package's, on the CPU.

The ten scenarios of ``tests/test_raft.py`` run against both packages'
``RaftNode`` through one parametrised fixture: election of one node and of
three, the not-leader hint, replication, partition and re-election, a
divergent follower log, compaction with InstallSnapshot, adding a voter,
removing a server and the barrier.  After each scenario every node's
committed entries ``(index, term, type, data)`` must agree wherever two
nodes both hold an index, and every FSM that has applied the whole log
must equal the leader's.  ``InmemRaftNet`` hands the same body objects to
every node, so an in-place change of a body on one node would show here.
"""

import asyncio
import types

import pytest

from helpers import wait_for_leader

from consul_tpu.consensus import raft as j_raft
from consul_tpu_torch.consensus import raft as t_raft

PACKAGES = {"jax": j_raft, "torch": t_raft}


def _package(mod):
    class DictFSM(mod.FSM):
        """Tiny KV FSM: entries are ("set", k, v); snapshot is the dict."""

        def __init__(self):
            self.data: dict = {}
            self.applied: list = []

        def apply(self, entry):
            op, k, v = entry.data
            assert op == "set"
            self.data[k] = v
            self.applied.append(entry.index)
            return ("ok", k, v)

        def snapshot(self):
            return dict(self.data)

        def restore(self, snap):
            self.data = dict(snap)
            self.applied = []

    def make_cluster(n, net=None, **cfg_kwargs):
        net = net or mod.InmemRaftNet()
        ids = [f"s{i}" for i in range(n)]
        nodes = [mod.RaftNode(mod.RaftConfig(node_id=nid, **cfg_kwargs),
                              DictFSM(), net, ids) for nid in ids]
        return net, nodes

    return types.SimpleNamespace(mod=mod, DictFSM=DictFSM,
                                 make_cluster=make_cluster)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return _package(PACKAGES[request.param])


def committed(node) -> dict:
    return {e.index: (e.term, e.type, e.data) for e in node.log
            if e.index <= node.commit_index}


def check_logs(nodes) -> None:
    """Committed entries agree wherever two nodes hold the same index."""
    logs = [committed(n) for n in nodes]
    for i, a in enumerate(logs):
        for b in logs[i + 1:]:
            for idx in a.keys() & b.keys():
                assert a[idx] == b[idx], (idx, a[idx], b[idx])
    leader = next((n for n in nodes if n.is_leader()), None)
    if leader is not None:
        for n in nodes:
            if n.last_applied == leader.last_applied:
                assert n.fsm.data == leader.fsm.data, n.id


async def finish(nodes) -> None:
    check_logs(nodes)
    for n in nodes:
        await n.shutdown()
    await asyncio.sleep(0)


async def start(nodes):
    for n in nodes:
        await n.start()
    return await wait_for_leader(nodes)


def test_single_node_self_elects_and_applies(pkg):
    async def run():
        _, nodes = pkg.make_cluster(1)
        leader = await start(nodes)
        assert await leader.apply(("set", "a", 1)) == ("ok", "a", 1)
        assert leader.fsm.data == {"a": 1}
        await finish(nodes)

    asyncio.run(run())


def test_three_node_elects_exactly_one_leader(pkg):
    async def run():
        _, nodes = pkg.make_cluster(3)
        leader = await start(nodes)
        assert sum(n.is_leader() for n in nodes) == 1
        assert all(n.current_term == leader.current_term for n in nodes)
        await finish(nodes)

    asyncio.run(run())


def test_follower_apply_raises_not_leader_with_hint(pkg):
    async def run():
        _, nodes = pkg.make_cluster(3)
        leader = await start(nodes)
        follower = next(n for n in nodes if not n.is_leader())
        with pytest.raises(pkg.mod.NotLeaderError) as ei:
            await follower.apply(("set", "x", 1))
        assert ei.value.leader_id == leader.id
        await finish(nodes)

    asyncio.run(run())


def test_writes_replicate_to_all_fsms(pkg):
    async def run():
        _, nodes = pkg.make_cluster(3)
        leader = await start(nodes)
        for i in range(20):
            await leader.apply(("set", f"k{i}", i))
        await asyncio.sleep(0.3)
        for n in nodes:
            assert n.fsm.data == {f"k{i}": i for i in range(20)}
            assert n.fsm.applied == sorted(n.fsm.applied)
        await finish(nodes)

    asyncio.run(run())


def test_leader_partition_reelects_and_old_leader_steps_down(pkg):
    async def run():
        net, nodes = pkg.make_cluster(3)
        leader = await start(nodes)
        await leader.apply(("set", "before", 1))
        rest = [n for n in nodes if n is not leader]
        net.partition({leader.id}, {n.id for n in rest})
        new_leader = await wait_for_leader(rest)
        assert new_leader.id != leader.id
        await new_leader.apply(("set", "after", 2))
        with pytest.raises((pkg.mod.NotLeaderError, asyncio.TimeoutError)):
            await leader.apply(("set", "lost", 3), timeout=0.5)
        net.heal()
        await asyncio.sleep(0.6)
        assert not leader.is_leader() or leader.id == new_leader.id
        for n in nodes:
            assert n.fsm.data.get("after") == 2
            assert "lost" not in n.fsm.data
        await finish(nodes)

    asyncio.run(run())


def test_divergent_follower_log_is_overwritten(pkg):
    async def run():
        net, nodes = pkg.make_cluster(3)
        leader = await start(nodes)
        follower = next(n for n in nodes if not n.is_leader())
        net.partition({follower.id},
                      {n.id for n in nodes if n is not follower})
        for i in range(5):
            await leader.apply(("set", f"m{i}", i))
        net.heal()
        await asyncio.sleep(0.5)
        assert follower.fsm.data == leader.fsm.data
        assert follower.last_index() == leader.last_index()
        await finish(nodes)

    asyncio.run(run())


def test_log_compaction_and_install_snapshot(pkg):
    async def run():
        net, nodes = pkg.make_cluster(3, snapshot_threshold=32,
                                      snapshot_trailing=8)
        leader = await start(nodes)
        follower = next(n for n in nodes if not n.is_leader())
        net.partition({follower.id},
                      {n.id for n in nodes if n is not follower})
        for i in range(100):
            await leader.apply(("set", f"k{i}", i))
        await asyncio.sleep(0.2)
        assert leader.snapshot_index > 0
        assert len(leader.log) < 100
        net.heal()
        await asyncio.sleep(1.0)
        assert follower.fsm.data == leader.fsm.data
        assert follower.snapshot_index > 0
        assert follower.last_applied == leader.last_applied
        await finish(nodes)

    asyncio.run(run())


def test_add_voter_catches_up_and_votes(pkg):
    """``tests/test_raft.py`` builds the newcomer with ``voters=["s9"]``
    and then clears them, which leaves its own bootstrap entry at index 1,
    term 0; the leader's index 1 is also term 0, so that entry is never
    overwritten (``test_self_bootstrapped_newcomer_keeps_its_first_entry``).
    Here the newcomer starts with an empty log, as a server that joins
    without bootstrapping does."""

    async def run():
        net, nodes = pkg.make_cluster(3)
        leader = await start(nodes)
        await leader.apply(("set", "seed", 1))
        newcomer = pkg.mod.RaftNode(pkg.mod.RaftConfig(node_id="s9"),
                                    pkg.DictFSM(), net, voters=[])
        await newcomer.start()
        await leader.add_voter("s9")
        await asyncio.sleep(0.5)
        assert "s9" in leader.voters
        assert newcomer.fsm.data.get("seed") == 1
        await leader.apply(("set", "post", 2))
        await asyncio.sleep(0.3)
        assert newcomer.fsm.data.get("post") == 2
        assert "s9" in newcomer.voters
        await finish(nodes + [newcomer])

    asyncio.run(run())


def test_self_bootstrapped_newcomer_keeps_its_first_entry(pkg):
    """The reference scenario's own construction: both packages keep the
    newcomer's bootstrap configuration at index 1 beside the cluster's,
    since the two entries share term 0 and the log-matching check at
    ``prev_log_index`` 1 passes.  The rest of the log agrees."""

    async def run():
        net, nodes = pkg.make_cluster(3)
        leader = await start(nodes)
        await leader.apply(("set", "seed", 1))
        newcomer = pkg.mod.RaftNode(pkg.mod.RaftConfig(node_id="s9"),
                                    pkg.DictFSM(), net, voters=["s9"])
        newcomer.voters = []
        await newcomer.start()
        await leader.add_voter("s9")
        await asyncio.sleep(0.5)
        assert newcomer.fsm.data == leader.fsm.data == {"seed": 1}
        ours, theirs = committed(newcomer), committed(leader)
        assert ours[1][2] == {"voters": ["s9"]}
        assert theirs[1][2] == {"voters": ["s0", "s1", "s2"]}
        assert {i: ours[i] for i in ours if i > 1} == {
            i: theirs[i] for i in ours if i > 1}
        check_logs(nodes)
        for n in nodes + [newcomer]:
            await n.shutdown()
        await asyncio.sleep(0)

    asyncio.run(run())


def test_remove_server_shrinks_quorum(pkg):
    async def run():
        _, nodes = pkg.make_cluster(3)
        leader = await start(nodes)
        victim = next(n for n in nodes if not n.is_leader())
        await leader.remove_server(victim.id)
        await victim.shutdown()
        await leader.apply(("set", "still", 1))
        assert leader.fsm.data["still"] == 1
        assert victim.id not in leader.voters
        await finish(nodes)

    asyncio.run(run())


def test_barrier_sees_prior_commits(pkg):
    async def run():
        _, nodes = pkg.make_cluster(3)
        leader = await start(nodes)
        for i in range(5):
            await leader.apply(("set", f"b{i}", i))
        await leader.barrier()
        assert len(leader.fsm.data) == 5
        assert leader.last_applied == leader.commit_index
        await finish(nodes)

    asyncio.run(run())


def test_public_names_match_the_reference():
    from consul_tpu import consensus as j_pkg
    from consul_tpu_torch import consensus as t_pkg

    assert t_pkg.__all__ == j_pkg.__all__
    for name in ("ENTRY_COMMAND", "ENTRY_NOOP", "ENTRY_CONFIG"):
        assert getattr(t_pkg, name) == getattr(j_pkg, name)
    assert [r.value for r in t_pkg.Role] == [r.value for r in j_pkg.Role]
    assert ([f.name for f in t_raft.dataclasses.fields(t_pkg.RaftConfig)]
            == [f.name for f in j_raft.dataclasses.fields(j_pkg.RaftConfig)])
    assert t_pkg.RaftConfig("x") == t_pkg.RaftConfig(
        **vars(j_pkg.RaftConfig("x")))
