"""Consensus plane: host-side Raft (election, replication, snapshots);
the port's copy of ``consul_tpu.consensus``.

Kept on host CPUs by design — the consistency plane spans 3-5 server
nodes (SURVEY.md §2.4: raft is "not TPU-lowered").  It reaches the card
only through the simulated pool whose members it records.
"""

from consul_tpu_torch.consensus.raft import (
    ENTRY_COMMAND,
    ENTRY_CONFIG,
    ENTRY_NOOP,
    Entry,
    FSM,
    InmemRaftNet,
    NotLeaderError,
    RaftConfig,
    RaftNode,
    RaftTransport,
    Role,
)

__all__ = [
    "Entry",
    "FSM",
    "InmemRaftNet",
    "NotLeaderError",
    "RaftConfig",
    "RaftNode",
    "RaftTransport",
    "Role",
    "ENTRY_COMMAND",
    "ENTRY_NOOP",
    "ENTRY_CONFIG",
]
