"""The protocol planes as PyTorch models."""

from consul_tpu_torch.models.broadcast import (
    BroadcastConfig,
    BroadcastState,
    broadcast_init,
    broadcast_round,
)

__all__ = [
    "BroadcastConfig",
    "BroadcastState",
    "broadcast_init",
    "broadcast_round",
]
