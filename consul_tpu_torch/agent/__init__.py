"""Agent plane: the consistency-plane node logic above the gossip layer;
the port's copy of ``consul_tpu.agent``: its replicated state machine,
its snapshot archives, the RPC layer with its endpoints, ``Server`` and
``Client``, and the composition-root ``Agent`` with its local state,
anti-entropy, checks, cache, config and the HTTP and DNS front ends.

Equivalent of the reference's ``agent/consul/fsm``, ``snapshot/``,
``agent/pool``, ``agent/consul`` and ``agent/`` packages (SURVEY.md
§2.2-2.3).
"""

from consul_tpu_torch.agent.agent import Agent, AgentConfig
from consul_tpu_torch.agent.client import Client, ClientConfig
from consul_tpu_torch.agent.fsm import ConsulFSM, MessageType
from consul_tpu_torch.agent.server import Server, ServerConfig
from consul_tpu_torch.agent.snapshot import (
    SnapshotError,
    read_archive,
    write_archive,
)

__all__ = [
    "Agent",
    "AgentConfig",
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
