"""Protocol ground truth: the timing profiles and formulas the port uses."""

from consul_tpu_torch.protocol.formulas import retransmit_limit
from consul_tpu_torch.protocol.profiles import (
    LAN,
    LOCAL,
    PROFILES,
    WAN,
    GossipProfile,
)

__all__ = [
    "GossipProfile",
    "LAN",
    "LOCAL",
    "PROFILES",
    "WAN",
    "retransmit_limit",
]
