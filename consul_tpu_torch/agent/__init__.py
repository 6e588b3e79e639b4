"""Agent plane: the consistency-plane node logic above the gossip layer;
the port's copy of ``consul_tpu.agent``, so far its replicated state
machine and its snapshot archives.

Equivalent of the reference's ``agent/consul/fsm`` and ``snapshot/``
packages (SURVEY.md §2.2-2.3).  ``Agent``, ``Server`` and ``Client``
come with the RPC and front-end layers.
"""

from consul_tpu_torch.agent.fsm import ConsulFSM, MessageType
from consul_tpu_torch.agent.snapshot import (
    SnapshotError,
    read_archive,
    write_archive,
)

__all__ = [
    "ConsulFSM",
    "MessageType",
    "SnapshotError",
    "read_archive",
    "write_archive",
]
