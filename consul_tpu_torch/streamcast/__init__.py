"""Streamcast: pipelined chunked event broadcast under sustained load.

The port of ``consul_tpu/streamcast``: a continuous event stream
(Poisson or scheduled arrivals, each event E chunks) gossiped under a
fixed per-round, per-node transmit budget through a W-slot in-flight
window, with overflow and coalescing counted.  Entry points:
``sim.engine.streamcast_scan`` / ``run_streamcast``; the sharded twin is
``parallel.shard.sharded_streamcast_scan``.
"""

from consul_tpu_torch.streamcast.model import (
    POLICIES,
    StreamcastConfig,
    StreamcastState,
    arrival_arrays,
    chunk_validity,
    cursor_dtype,
    select_chunk,
    streamcast_init,
    streamcast_round,
)
from consul_tpu_torch.streamcast.report import (
    StreamcastReport,
    latency_quantiles,
    per_event_latency,
)
from consul_tpu_torch.streamcast.window import admit, retire

__all__ = [
    "POLICIES",
    "StreamcastConfig",
    "StreamcastReport",
    "StreamcastState",
    "admit",
    "arrival_arrays",
    "chunk_validity",
    "cursor_dtype",
    "latency_quantiles",
    "per_event_latency",
    "retire",
    "select_chunk",
    "streamcast_init",
    "streamcast_round",
]
