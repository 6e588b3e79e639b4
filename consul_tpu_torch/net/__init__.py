"""The sim↔host bridge: a host agent joins a population simulated on the
device.

  wire.py           message types, the msgpack codec, compound messages
  transport.py      the Transport and Stream interfaces a host agent takes
  sim_transport.py  the bridge: a Transport backed by the dense membership
                    round (``SimBridge``, ``SimTransport``)
"""

from consul_tpu_torch.net import wire
from consul_tpu_torch.net.sim_transport import (
    SimBridge,
    SimPoolConfig,
    SimTransport,
    sim_addr,
)
from consul_tpu_torch.net.transport import Stream, Transport

__all__ = [
    "SimBridge",
    "SimPoolConfig",
    "SimTransport",
    "Stream",
    "Transport",
    "sim_addr",
    "wire",
]
