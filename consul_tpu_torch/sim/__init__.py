"""Study engine, fault schedules and reports."""

from consul_tpu_torch.sim.engine import (
    broadcast_scan,
    lifeguard_scan,
    membership_scan,
    run_broadcast,
    run_lifeguard,
    run_membership,
    run_membership_sparse,
    run_swim,
    sparse_membership_scan,
    swim_scan,
)
from consul_tpu_torch.sim.faults import (
    ChurnWindow,
    DegradedSet,
    FaultSchedule,
    LossRamp,
    Partition,
)
from consul_tpu_torch.sim.metrics import (
    BroadcastReport,
    FalsePositiveReport,
    MembershipReport,
    SwimReport,
    time_to_fraction,
)

__all__ = [
    "BroadcastReport",
    "ChurnWindow",
    "DegradedSet",
    "FalsePositiveReport",
    "FaultSchedule",
    "LossRamp",
    "MembershipReport",
    "Partition",
    "SwimReport",
    "broadcast_scan",
    "lifeguard_scan",
    "membership_scan",
    "run_broadcast",
    "run_lifeguard",
    "run_membership",
    "run_membership_sparse",
    "run_swim",
    "sparse_membership_scan",
    "swim_scan",
    "time_to_fraction",
]
