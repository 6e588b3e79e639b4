"""The protocol planes as PyTorch models."""

from consul_tpu_torch.models.broadcast import (
    BroadcastConfig,
    BroadcastState,
    broadcast_init,
    broadcast_round,
)
from consul_tpu_torch.models.lifeguard import (
    LifeguardConfig,
    LifeguardState,
    lifeguard_init,
    lifeguard_round,
)
from consul_tpu_torch.models.swim import (
    SwimConfig,
    SwimState,
    swim_init,
    swim_round,
)

__all__ = [
    "BroadcastConfig",
    "BroadcastState",
    "LifeguardConfig",
    "LifeguardState",
    "SwimConfig",
    "SwimState",
    "broadcast_init",
    "broadcast_round",
    "lifeguard_init",
    "lifeguard_round",
    "swim_init",
    "swim_round",
]
