"""Study engine (plain runs, universe sweeps and their composition with
the sharded twins), fault schedules, offered-load generators and
reports, and the scenario presets (``run_scenario``)."""

from consul_tpu_torch.sim.engine import (
    broadcast_scan,
    geo_scan,
    lifeguard_scan,
    membership_scan,
    multidc_scan,
    run_broadcast,
    run_geo,
    run_lifeguard,
    run_membership,
    run_membership_sparse,
    run_multidc,
    run_streamcast,
    run_sweep,
    run_swim,
    sparse_membership_scan,
    streamcast_scan,
    swim_scan,
)
from consul_tpu_torch.sim.faults import (
    BandwidthSchedule,
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
    MultiDCReport,
    SwimReport,
    time_to_fraction,
)


def __getattr__(name: str):
    # PEP 562: the presets import the models, which import this package
    # through ``sim.faults``, so they load on first touch.
    if name in ("SCENARIOS", "run_scenario"):
        from consul_tpu_torch.sim import scenarios

        return getattr(scenarios, name)
    raise AttributeError(name)


__all__ = [
    "BandwidthSchedule",
    "BroadcastReport",
    "ChurnWindow",
    "DegradedSet",
    "FalsePositiveReport",
    "FaultSchedule",
    "LossRamp",
    "MembershipReport",
    "MultiDCReport",
    "Partition",
    "SCENARIOS",
    "SwimReport",
    "broadcast_scan",
    "geo_scan",
    "lifeguard_scan",
    "membership_scan",
    "multidc_scan",
    "run_broadcast",
    "run_geo",
    "run_lifeguard",
    "run_membership",
    "run_membership_sparse",
    "run_multidc",
    "run_scenario",
    "run_streamcast",
    "run_sweep",
    "run_swim",
    "sparse_membership_scan",
    "streamcast_scan",
    "swim_scan",
    "time_to_fraction",
]
