"""Raft consensus: leader election, log replication, snapshots; the
port's copy of ``consul_tpu/consensus/raft.py``.

The host-plane equivalent of the reference's vendored
``hashicorp/raft`` engine (SURVEY.md §2.1): the consistency plane runs
on 3-5 server nodes, so it stays on host CPUs (asyncio) by design —
only the gossip plane runs on the accelerator (SURVEY.md §2.4
"Leader-based replication ... not TPU-lowered").

Shape of the implementation (reference call sites it mirrors):

  role loops           raft.go:150,249,366 runFollower/Candidate/Leader
  replication          replication.go — per-follower next/match index,
                       decrement-on-conflict with a conflict-index hint
  commit rule          only entries of the current term commit by
                       counting (Raft §5.4.2); noop barrier on election
  FSM apply pump       fsm.go:69 runFSM — ordered apply, one inflight
  snapshots            file_snapshot.go / snapshot.go — log compaction
                       past a threshold + InstallSnapshot for laggards
  membership           single-server AddVoter/RemoveServer config
                       entries, effective as soon as appended
  transports           net_transport.go (stream RPC) has an in-memory
                       twin (inmem_transport.go) — here ``InmemRaftNet``
                       with partition/loss injection for tests

Log indexes are 1-based; index 0 is the empty-log sentinel.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import logging
import random
from typing import Any, Callable, Optional

log = logging.getLogger("consul_tpu_torch.raft")


class Role(enum.Enum):
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


ENTRY_COMMAND = 0
ENTRY_NOOP = 1
ENTRY_CONFIG = 2


@dataclasses.dataclass
class Entry:
    index: int
    term: int
    type: int
    data: Any


@dataclasses.dataclass
class RaftConfig:
    node_id: str
    # Timings (seconds). Defaults suit in-proc tests; the server scales
    # them up for real deployments (reference DefaultConfig: 1s/10ms).
    heartbeat_interval: float = 0.05
    election_timeout_min: float = 0.15
    election_timeout_max: float = 0.30
    snapshot_threshold: int = 2048  # raft.Config.SnapshotThreshold (8192)
    snapshot_trailing: int = 128  # logs kept behind a snapshot (TrailingLogs)
    max_append_entries: int = 64


class FSM:
    """State-machine interface (raft/fsm.go FSM)."""

    def apply(self, entry: Entry) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def snapshot(self) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def restore(self, snap: Any) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class NotLeaderError(Exception):
    def __init__(self, leader_id: Optional[str]):
        super().__init__(f"not the leader (leader hint: {leader_id})")
        self.leader_id = leader_id


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class RaftTransport:
    """RPC fabric between raft nodes. ``call`` raises on drop/timeout."""

    async def call(self, target: str, method: str, body: dict) -> dict:
        raise NotImplementedError

    def bind(self, node_id: str, handler: Callable) -> None:
        raise NotImplementedError


class InmemRaftNet(RaftTransport):
    """In-process transport with partition & loss injection
    (raft/inmem_transport.go equivalent; the unit of testing per
    SURVEY.md §4.2)."""

    def __init__(self, rtt: float = 0.0, seed: int = 0):
        self._handlers: dict[str, Callable] = {}
        self.rtt = rtt
        self.loss = 0.0
        self._rng = random.Random(seed)
        self._partitions: list[set[str]] = []  # groups that can ONLY talk internally

    def bind(self, node_id: str, handler: Callable) -> None:
        self._handlers[node_id] = handler

    def partition(self, *groups: set[str]) -> None:
        self._partitions = [set(g) for g in groups]

    def heal(self) -> None:
        self._partitions = []

    def _blocked(self, a: str, b: str) -> bool:
        for group in self._partitions:
            if (a in group) != (b in group):
                return True
        return False

    async def call(self, target: str, method: str, body: dict) -> dict:
        src = body.get("from", "")
        if self._blocked(src, target) or target not in self._handlers:
            raise ConnectionError(f"{src} -> {target} unreachable")
        if self.loss and self._rng.random() < self.loss:
            raise ConnectionError("dropped")
        if self.rtt:
            await asyncio.sleep(self.rtt)
        return await self._handlers[target](method, body)


# ---------------------------------------------------------------------------
# the node
# ---------------------------------------------------------------------------


class RaftNode:
    def __init__(
        self,
        config: RaftConfig,
        fsm: FSM,
        transport: RaftTransport,
        voters: list[str],
    ):
        self.config = config
        self.fsm = fsm
        self.transport = transport
        self.id = config.node_id

        # Persistent state (storage hooks below).
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self.log: list[Entry] = []  # contiguous entries from _log_start
        self._log_start = 1  # index of log[0]
        self.snapshot_index = 0
        self.snapshot_term = 0
        self.snapshot_data: Any = None
        self.voters: list[str] = list(voters)
        # Staging servers: replicated to, never counted for quorum or
        # elections (hashicorp/raft nonvoter/staging servers; autopilot
        # promotes them once stable).
        self.non_voters: list[str] = []
        # Bootstrap writes the initial configuration INTO THE LOG
        # (hashicorp/raft BootstrapCluster appends a configuration entry
        # at index 1) so it replicates to servers that lost the
        # simultaneous-bootstrap race and idle with an empty config —
        # constructor-only voter state would never reach them.
        if voters:
            self.log.append(
                Entry(1, 0, ENTRY_CONFIG, {"voters": list(voters)})
            )

        # Volatile state.
        self.role = Role.FOLLOWER
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: Optional[str] = None
        self._last_contact = 0.0
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._apply_waiters: dict[int, asyncio.Future] = {}
        self._replicate_wake: dict[str, asyncio.Event] = {}
        self._commit_wake = asyncio.Event()
        self._tasks: list[asyncio.Task] = []
        self._repl_tasks: dict[str, asyncio.Task] = {}
        self._shutdown = False
        self._rng = random.Random(hash(config.node_id) & 0xFFFFFFFF)
        self.leadership_listeners: list[Callable[[bool], None]] = []

        transport.bind(self.id, self._handle_rpc)

    # -- log accessors ------------------------------------------------------

    def last_index(self) -> int:
        return self.log[-1].index if self.log else self.snapshot_index

    def last_term(self) -> int:
        return self.log[-1].term if self.log else self.snapshot_term

    def _entry(self, index: int) -> Optional[Entry]:
        pos = index - self._log_start
        if 0 <= pos < len(self.log):
            return self.log[pos]
        return None

    def _term_at(self, index: int) -> Optional[int]:
        if index == 0:
            return 0
        if index == self.snapshot_index:
            return self.snapshot_term
        e = self._entry(index)
        return e.term if e else None

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._tasks = [
            asyncio.create_task(self._election_loop()),
            asyncio.create_task(self._apply_loop()),
        ]

    async def shutdown(self) -> None:
        self._shutdown = True
        for t in self._tasks + list(self._repl_tasks.values()):
            t.cancel()
        for fut in self._apply_waiters.values():
            if not fut.done():
                fut.cancel()

    def is_leader(self) -> bool:
        return self.role == Role.LEADER

    # -- public API ---------------------------------------------------------

    async def apply(self, data: Any, timeout: float = 10.0) -> Any:
        """Append a command; resolves with the FSM's apply result once
        committed (raft/api.go:667 Apply)."""
        if self.role != Role.LEADER:
            raise NotLeaderError(self.leader_id)
        entry = self._append_local(ENTRY_COMMAND, data)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._apply_waiters[entry.index] = fut
        self._kick_replication()
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._apply_waiters.pop(entry.index, None)

    async def barrier(self, timeout: float = 10.0) -> None:
        """Commit a noop and wait for it to apply — guarantees the FSM
        has seen every prior commit (api.go Barrier)."""
        if self.role != Role.LEADER:
            raise NotLeaderError(self.leader_id)
        entry = self._append_local(ENTRY_NOOP, None)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._apply_waiters[entry.index] = fut
        self._kick_replication()
        try:
            await asyncio.wait_for(fut, timeout)
        finally:
            self._apply_waiters.pop(entry.index, None)

    async def add_voter(self, node_id: str, timeout: float = 10.0) -> None:
        """Single-server membership change (api.go AddVoter)."""
        if node_id in self.voters:
            return
        await self._change_config(
            [*self.voters, node_id],
            [p for p in self.non_voters if p != node_id],
            timeout,
        )

    async def add_nonvoter(self, node_id: str,
                           timeout: float = 10.0) -> None:
        """Add a STAGING server: receives the log, counts for nothing
        (api.go AddNonvoter) — autopilot's promotion pipeline input."""
        if node_id in self.voters or node_id in self.non_voters:
            return
        await self._change_config(
            list(self.voters), [*self.non_voters, node_id], timeout
        )

    async def promote_server(self, node_id: str,
                             timeout: float = 10.0) -> None:
        """Non-voter → voter (autopilot.go promoteServers →
        raft.AddVoter on a staging server)."""
        if node_id in self.voters or node_id not in self.non_voters:
            return
        await self._change_config(
            [*self.voters, node_id],
            [p for p in self.non_voters if p != node_id],
            timeout,
        )

    async def remove_server(self, node_id: str, timeout: float = 10.0) -> None:
        if node_id not in self.voters and node_id not in self.non_voters:
            return
        await self._change_config(
            [v for v in self.voters if v != node_id],
            [p for p in self.non_voters if p != node_id],
            timeout,
        )

    async def _change_config(self, new_voters: list[str],
                             new_non_voters: list[str],
                             timeout: float) -> None:
        if self.role != Role.LEADER:
            raise NotLeaderError(self.leader_id)
        entry = self._append_local(
            ENTRY_CONFIG,
            {"voters": new_voters, "non_voters": new_non_voters},
        )
        self._apply_config(entry)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._apply_waiters[entry.index] = fut
        self._kick_replication()
        try:
            await asyncio.wait_for(fut, timeout)
        finally:
            self._apply_waiters.pop(entry.index, None)

    def stats(self) -> dict:
        return {
            "state": self.role.value,
            "term": self.current_term,
            "last_log_index": self.last_index(),
            "commit_index": self.commit_index,
            "applied_index": self.last_applied,
            "leader": self.leader_id,
            "voters": list(self.voters),
            "non_voters": list(self.non_voters),
            "snapshot_index": self.snapshot_index,
        }

    # -- role machinery -----------------------------------------------------

    def _now(self) -> float:
        return asyncio.get_running_loop().time()

    def _election_deadline(self) -> float:
        return self._rng.uniform(
            self.config.election_timeout_min, self.config.election_timeout_max
        )

    def _become_follower(self, term: int, leader: Optional[str]) -> None:
        was_leader = self.role == Role.LEADER
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
        self.role = Role.FOLLOWER
        self.leader_id = leader
        if was_leader:
            self._stop_replication()
            self._fail_waiters()
            self._notify_leadership(False)

    def _notify_leadership(self, is_leader: bool) -> None:
        for fn in self.leadership_listeners:
            try:
                fn(is_leader)
            except Exception:
                log.exception("leadership listener failed")

    def _fail_waiters(self) -> None:
        for fut in self._apply_waiters.values():
            if not fut.done():
                fut.set_exception(NotLeaderError(self.leader_id))
        self._apply_waiters.clear()

    async def _election_loop(self) -> None:
        """Follower/candidate pump (raft.go runFollower/runCandidate)."""
        while not self._shutdown:
            timeout = self._election_deadline()
            await asyncio.sleep(timeout)
            if self.role == Role.LEADER:
                continue
            if self.id not in self.voters:
                continue  # non-voter never campaigns
            if self._now() - self._last_contact < timeout:
                continue  # heard from a live leader recently
            await self._run_candidate()

    async def _run_candidate(self) -> None:
        self.role = Role.CANDIDATE
        self.current_term += 1
        self.voted_for = self.id
        self.leader_id = None
        term = self.current_term
        votes = 1
        needed = len(self.voters) // 2 + 1
        log.debug("%s campaigning term=%d", self.id, term)

        async def ask(peer: str) -> bool:
            try:
                resp = await asyncio.wait_for(
                    self.transport.call(
                        peer,
                        "request_vote",
                        {
                            "from": self.id,
                            "term": term,
                            "candidate": self.id,
                            "last_log_index": self.last_index(),
                            "last_log_term": self.last_term(),
                        },
                    ),
                    self.config.election_timeout_min,
                )
            except Exception:
                return False
            if resp["term"] > self.current_term:
                self._become_follower(resp["term"], None)
                return False
            return bool(resp["granted"])

        results = await asyncio.gather(
            *(ask(p) for p in self.voters if p != self.id)
        )
        if self.role != Role.CANDIDATE or self.current_term != term:
            return
        votes += sum(results)
        if votes >= needed:
            self._become_leader()
        else:
            self.role = Role.FOLLOWER

    def _become_leader(self) -> None:
        log.info("%s won election term=%d", self.id, self.current_term)
        self.role = Role.LEADER
        self.leader_id = self.id
        last = self.last_index()
        peers = [*self.voters, *self.non_voters]
        self._next_index = {p: last + 1 for p in peers if p != self.id}
        self._match_index = {p: 0 for p in peers if p != self.id}
        # Noop barrier so the new term has a committable entry (§5.4.2,
        # raft.go runLeader -> dispatchLogs noop).
        self._append_local(ENTRY_NOOP, None)
        self._start_replication()
        self._tasks = [t for t in self._tasks if not t.done()]
        self._tasks.append(
            asyncio.create_task(self._leader_commit_loop(self.current_term))
        )
        self._notify_leadership(True)

    # -- log append/commit --------------------------------------------------

    def _append_local(self, etype: int, data: Any) -> Entry:
        entry = Entry(self.last_index() + 1, self.current_term, etype, data)
        self.log.append(entry)
        if len(self.voters) == 1 and self.id in self.voters:
            self._advance_commit()  # single-node cluster commits instantly
        return entry

    def _apply_config(self, entry: Entry) -> None:
        self.voters = list(entry.data["voters"])
        self.non_voters = list(entry.data.get("non_voters", []))
        if self.role == Role.LEADER:
            peers = set(self.voters) | set(self.non_voters)
            for p in peers:
                if p != self.id and p not in self._next_index:
                    self._next_index[p] = self.last_index() + 1
                    self._match_index[p] = 0
                    self._spawn_replicator(p)
            for p in list(self._repl_tasks):
                if p not in peers:
                    self._repl_tasks.pop(p).cancel()
                    self._next_index.pop(p, None)
                    self._match_index.pop(p, None)
                    self._replicate_wake.pop(p, None)

    def _advance_commit(self) -> None:
        """Leader commit rule: highest N replicated on a majority with
        term == current_term (raft.go leaderLoop commit check)."""
        if self.role == Role.LEADER or len(self.voters) == 1:
            matches = [self.last_index()] + [
                self._match_index.get(p, 0)
                for p in self.voters
                if p != self.id
            ]
            matches.sort(reverse=True)
            majority_n = matches[len(self.voters) // 2]
            for n in range(majority_n, self.commit_index, -1):
                if self._term_at(n) == self.current_term:
                    if n > self.commit_index:
                        self.commit_index = n
                        self._commit_wake.set()
                    break

    async def _leader_commit_loop(self, term: int) -> None:
        """Heartbeat cadence re-kick: replicators mostly self-schedule,
        this guarantees idle-cluster heartbeats. Term-scoped so a stale
        loop from a previous leadership exits instead of doubling up."""
        while (
            not self._shutdown
            and self.role == Role.LEADER
            and self.current_term == term
        ):
            self._kick_replication()
            await asyncio.sleep(self.config.heartbeat_interval)

    # -- replication (replication.go) ---------------------------------------

    def _start_replication(self) -> None:
        for peer in [*self.voters, *self.non_voters]:
            if peer != self.id:
                self._spawn_replicator(peer)

    def _spawn_replicator(self, peer: str) -> None:
        if peer in self._repl_tasks and not self._repl_tasks[peer].done():
            return
        self._replicate_wake[peer] = asyncio.Event()
        self._repl_tasks[peer] = asyncio.create_task(self._replicate(peer))

    def _stop_replication(self) -> None:
        for t in self._repl_tasks.values():
            t.cancel()
        self._repl_tasks.clear()

    def _kick_replication(self) -> None:
        for ev in self._replicate_wake.values():
            ev.set()

    async def _replicate(self, peer: str) -> None:
        """Per-follower pump: batched AppendEntries, decrement-on-
        conflict, snapshot install when the follower is behind the
        compaction horizon."""
        term = self.current_term
        while not self._shutdown and self.role == Role.LEADER and self.current_term == term:
            wake = self._replicate_wake[peer]
            wake.clear()
            try:
                next_idx = self._next_index.get(peer, self.last_index() + 1)
                if next_idx <= self.snapshot_index:
                    await self._send_snapshot(peer)
                else:
                    await self._send_entries(peer, next_idx)
            except (ConnectionError, asyncio.TimeoutError):
                pass
            except Exception:
                log.exception("replicate to %s failed", peer)
            if self.role != Role.LEADER:
                return
            pending = self._next_index.get(peer, 0) <= self.last_index()
            if not pending:
                try:
                    await asyncio.wait_for(
                        wake.wait(), self.config.heartbeat_interval
                    )
                except asyncio.TimeoutError:
                    pass
            else:
                await asyncio.sleep(0)  # yield, keep streaming

    async def _send_entries(self, peer: str, next_idx: int) -> None:
        prev = next_idx - 1
        prev_term = self._term_at(prev)
        if prev_term is None:
            await self._send_snapshot(peer)
            return
        batch = []
        for i in range(next_idx, min(self.last_index(), next_idx + self.config.max_append_entries - 1) + 1):
            e = self._entry(i)
            if e is None:
                break
            batch.append({"index": e.index, "term": e.term, "type": e.type, "data": e.data})
        resp = await asyncio.wait_for(
            self.transport.call(
                peer,
                "append_entries",
                {
                    "from": self.id,
                    "term": self.current_term,
                    "leader": self.id,
                    "prev_log_index": prev,
                    "prev_log_term": prev_term,
                    "entries": batch,
                    "leader_commit": self.commit_index,
                },
            ),
            self.config.heartbeat_interval * 4,
        )
        if resp["term"] > self.current_term:
            self._become_follower(resp["term"], None)
            return
        if resp["success"]:
            if batch:
                self._match_index[peer] = batch[-1]["index"]
                self._next_index[peer] = batch[-1]["index"] + 1
            else:
                self._match_index[peer] = max(self._match_index.get(peer, 0), prev)
            self._advance_commit()
        else:
            hint = resp.get("conflict_index")
            self._next_index[peer] = max(
                1, hint if hint else self._next_index.get(peer, 2) - 1
            )

    async def _send_snapshot(self, peer: str) -> None:
        """InstallSnapshot for a follower behind the log horizon
        (net_transport InstallSnapshot / snapshot.go)."""
        resp = await asyncio.wait_for(
            self.transport.call(
                peer,
                "install_snapshot",
                {
                    "from": self.id,
                    "term": self.current_term,
                    "leader": self.id,
                    "last_included_index": self.snapshot_index,
                    "last_included_term": self.snapshot_term,
                    "data": self.snapshot_data,
                    "voters": list(self.voters),
                    "non_voters": list(self.non_voters),
                },
            ),
            self.config.heartbeat_interval * 20,
        )
        if resp["term"] > self.current_term:
            self._become_follower(resp["term"], None)
            return
        self._match_index[peer] = self.snapshot_index
        self._next_index[peer] = self.snapshot_index + 1

    # -- RPC handlers -------------------------------------------------------

    async def _handle_rpc(self, method: str, body: dict) -> dict:
        if method == "request_vote":
            return self._on_request_vote(body)
        if method == "append_entries":
            return self._on_append_entries(body)
        if method == "install_snapshot":
            return self._on_install_snapshot(body)
        raise ValueError(f"unknown raft rpc {method}")

    def _on_request_vote(self, req: dict) -> dict:
        # A candidate outside our committed configuration never gets a
        # vote (hashicorp/raft raft.go requestVote "not in configuration"
        # check): keeps a divergently-bootstrapped or stale server from
        # assembling a quorum that doesn't intersect ours.
        if self.voters and req["candidate"] not in self.voters:
            return {"term": self.current_term, "granted": False}
        if req["term"] > self.current_term:
            self._become_follower(req["term"], None)
        granted = False
        up_to_date = req["last_log_term"] > self.last_term() or (
            req["last_log_term"] == self.last_term()
            and req["last_log_index"] >= self.last_index()
        )
        if (
            req["term"] == self.current_term
            and self.voted_for in (None, req["candidate"])
            and up_to_date
        ):
            granted = True
            self.voted_for = req["candidate"]
            self._last_contact = asyncio.get_event_loop().time()
        return {"term": self.current_term, "granted": granted}

    def _on_append_entries(self, req: dict) -> dict:
        if req["term"] < self.current_term:
            return {"term": self.current_term, "success": False}
        if req["term"] > self.current_term or self.role != Role.FOLLOWER:
            self._become_follower(req["term"], req["leader"])
        self.leader_id = req["leader"]
        self._last_contact = asyncio.get_event_loop().time()

        prev_idx, prev_term = req["prev_log_index"], req["prev_log_term"]
        local_prev_term = self._term_at(prev_idx)
        if prev_idx > 0 and local_prev_term is None:
            # Missing entirely: hint the leader to back up to our end.
            return {
                "term": self.current_term,
                "success": False,
                "conflict_index": self.last_index() + 1,
            }
        if prev_idx > self.snapshot_index and local_prev_term != prev_term:
            # Conflict: find the first index of the conflicting term.
            conflict_term = local_prev_term
            ci = prev_idx
            while ci > self._log_start and self._term_at(ci - 1) == conflict_term:
                ci -= 1
            return {
                "term": self.current_term,
                "success": False,
                "conflict_index": ci,
            }

        for e in req["entries"]:
            local = self._entry(e["index"])
            if local is not None and local.term != e["term"]:
                # Truncate the divergent suffix (log matching property).
                pos = e["index"] - self._log_start
                del self.log[pos:]
                local = None
            if local is None and e["index"] > self.last_index():
                entry = Entry(e["index"], e["term"], e["type"], e["data"])
                self.log.append(entry)
                if entry.type == ENTRY_CONFIG:
                    self._apply_config(entry)

        if req["leader_commit"] > self.commit_index:
            self.commit_index = min(req["leader_commit"], self.last_index())
            self._commit_wake.set()
        return {"term": self.current_term, "success": True}

    def _on_install_snapshot(self, req: dict) -> dict:
        if req["term"] < self.current_term:
            return {"term": self.current_term}
        self._become_follower(req["term"], req["leader"])
        self._last_contact = asyncio.get_event_loop().time()
        idx = req["last_included_index"]
        if idx <= self.snapshot_index:
            return {"term": self.current_term}
        self.fsm.restore(req["data"])
        self.snapshot_index = idx
        self.snapshot_term = req["last_included_term"]
        self.snapshot_data = req["data"]
        self.voters = list(req["voters"])
        self.non_voters = list(req.get("non_voters", []))
        self.log = [e for e in self.log if e.index > idx]
        self._log_start = idx + 1
        self.commit_index = max(self.commit_index, idx)
        self.last_applied = idx
        return {"term": self.current_term}

    # -- FSM apply pump (fsm.go:69 runFSM) ----------------------------------

    async def _apply_loop(self) -> None:
        while not self._shutdown:
            await self._commit_wake.wait()
            self._commit_wake.clear()
            while self.last_applied < self.commit_index:
                idx = self.last_applied + 1
                entry = self._entry(idx)
                if entry is None:
                    break  # compacted past; snapshot restore set last_applied
                result = None
                if entry.type == ENTRY_COMMAND:
                    try:
                        result = self.fsm.apply(entry)
                    except Exception as e:
                        log.exception("fsm apply failed at %d", idx)
                        result = e
                self.last_applied = idx
                fut = self._apply_waiters.get(idx)
                if fut and not fut.done():
                    fut.set_result(result)
            self._maybe_compact()

    def _maybe_compact(self) -> None:
        """Snapshot + truncate when the log outgrows the threshold
        (snapshot.go runSnapshots / takeSnapshot)."""
        if len(self.log) < self.config.snapshot_threshold:
            return
        horizon = self.last_applied - self.config.snapshot_trailing
        if horizon <= self.snapshot_index:
            return
        self.snapshot_data = self.fsm.snapshot()
        self.snapshot_term = self._term_at(self.last_applied) or self.snapshot_term
        self.snapshot_index = self.last_applied
        # Keep TrailingLogs entries behind the snapshot so followers
        # slightly behind catch up from the log, not a full install.
        self.log = [e for e in self.log if e.index > horizon]
        self._log_start = horizon + 1
        log.debug(
            "%s compacted log to %d entries (snapshot@%d)",
            self.id,
            len(self.log),
            self.snapshot_index,
        )
