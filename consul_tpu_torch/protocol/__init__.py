"""Protocol ground truth: the timing profiles and formulas the port uses."""

from consul_tpu_torch.protocol.formulas import (
    awareness_clamp,
    awareness_probe_delta,
    awareness_scaled_timeout,
    push_pull_scale,
    remaining_suspicion_timeout,
    retransmit_limit,
    suspicion_timeout,
    suspicion_timeout_bounds,
)
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
    "awareness_clamp",
    "awareness_probe_delta",
    "awareness_scaled_timeout",
    "push_pull_scale",
    "remaining_suspicion_timeout",
    "retransmit_limit",
    "suspicion_timeout",
    "suspicion_timeout_bounds",
]
