"""The protocol planes as PyTorch models (broadcast, SWIM, Lifeguard,
membership, multi-DC, Vivaldi)."""

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
from consul_tpu_torch.models.membership import (
    MembershipConfig,
    MembershipState,
    membership_init,
    membership_round,
)
from consul_tpu_torch.models.vivaldi import (
    VivaldiConfig,
    VivaldiState,
    vivaldi_init,
    vivaldi_round,
)
from consul_tpu_torch.models.membership_sparse import (
    SparseMembershipConfig,
    SparseMembershipState,
    densify,
    sparse_membership_init,
    sparse_membership_round,
)
from consul_tpu_torch.models.multidc import (
    MultiDCConfig,
    MultiDCState,
    multidc_init,
    multidc_round,
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
    "MembershipConfig",
    "MembershipState",
    "MultiDCConfig",
    "MultiDCState",
    "SparseMembershipConfig",
    "SparseMembershipState",
    "SwimConfig",
    "SwimState",
    "VivaldiConfig",
    "VivaldiState",
    "broadcast_init",
    "broadcast_round",
    "densify",
    "lifeguard_init",
    "lifeguard_round",
    "membership_init",
    "membership_round",
    "multidc_init",
    "multidc_round",
    "sparse_membership_init",
    "sparse_membership_round",
    "swim_init",
    "swim_round",
    "vivaldi_init",
    "vivaldi_round",
]
