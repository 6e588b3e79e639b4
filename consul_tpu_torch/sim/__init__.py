"""Study engine and reports."""

from consul_tpu_torch.sim.engine import broadcast_scan, run_broadcast
from consul_tpu_torch.sim.metrics import BroadcastReport, time_to_fraction

__all__ = [
    "BroadcastReport",
    "broadcast_scan",
    "run_broadcast",
    "time_to_fraction",
]
