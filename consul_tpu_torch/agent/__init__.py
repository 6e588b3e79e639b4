"""Agent plane: the consistency-plane node logic above the gossip layer;
the port's copy of ``consul_tpu.agent``, so far its replicated state
machine, its snapshot archives, the RPC layer with its endpoints, and
``Server`` and ``Client``.

Equivalent of the reference's ``agent/consul/fsm``, ``snapshot/``,
``agent/pool`` and ``agent/consul`` packages (SURVEY.md §2.2-2.3).
``Agent`` comes with the HTTP and DNS front ends.
"""

from consul_tpu_torch.agent.client import Client, ClientConfig
from consul_tpu_torch.agent.fsm import ConsulFSM, MessageType
from consul_tpu_torch.agent.server import Server, ServerConfig
from consul_tpu_torch.agent.snapshot import (
    SnapshotError,
    read_archive,
    write_archive,
)

__all__ = [
    "Client",
    "ClientConfig",
    "ConsulFSM",
    "MessageType",
    "Server",
    "ServerConfig",
    "SnapshotError",
    "read_archive",
    "write_archive",
]
