"""The host gossip plane and the sim↔host bridge.

The port's copy of ``consul_tpu.net``: a real host agent, plain asyncio
over pluggable transports, and the bridge that lets it join a population
simulated on the device.

  wire.py            message types, the msgpack codec, compound messages
  transport.py       the Transport and Stream interfaces; the in-memory
                     network (memberlist's MockNetwork) and a UDP/TCP
                     socket transport
  security.py        AES-GCM sealing with a rotating keyring
  broadcast_queue.py TransmitLimitedQueue
  suspicion.py       the Lifeguard suspicion timer
  vivaldi.py         the host's Vivaldi coordinate client
  memberlist.py      SWIM membership and failure detection
  sim_transport.py   the bridge: a Transport backed by the dense
                     membership round (``SimBridge``, ``SimTransport``)
"""

from consul_tpu_torch.net import wire
from consul_tpu_torch.net.wire import MessageType, decode, encode
from consul_tpu_torch.net.transport import (
    InMemoryNetwork,
    InMemoryTransport,
    Stream,
    Transport,
    UDPTransport,
)
from consul_tpu_torch.net.security import Keyring, SecurityError, generate_key
from consul_tpu_torch.net.broadcast_queue import TransmitLimitedQueue
from consul_tpu_torch.net.memberlist import (
    Memberlist,
    MemberlistConfig,
    Node,
    NodeStatus,
)

# The bridge needs ``torch``; it loads on first use so that the host plane
# imports without it.
_BRIDGE = ("SimBridge", "SimPoolConfig", "SimTransport", "sim_addr")


def __getattr__(name):
    if name not in _BRIDGE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from consul_tpu_torch.net import sim_transport

    return getattr(sim_transport, name)

__all__ = [
    "InMemoryNetwork",
    "InMemoryTransport",
    "Keyring",
    "Memberlist",
    "MemberlistConfig",
    "MessageType",
    "Node",
    "NodeStatus",
    "SecurityError",
    "SimBridge",
    "SimPoolConfig",
    "SimTransport",
    "Stream",
    "TransmitLimitedQueue",
    "Transport",
    "UDPTransport",
    "decode",
    "encode",
    "generate_key",
    "sim_addr",
    "wire",
]
