"""Geo-distributed WAN plane (the port of ``consul_tpu/geo``).

Vivaldi-derived per-link latency (``latency``), the latency-delayed,
bandwidth-capped WAN link plane with adaptive anti-entropy (``model``)
and the host-side convergence and accounting report (``report``).  The
study entry points are ``sim.engine.geo_scan``/``run_geo``, with the
sharded twin in ``parallel.shard.sharded_geo_scan``.
"""

from consul_tpu_torch.geo.latency import dc_placement, derive_wan_latency
from consul_tpu_torch.geo.model import (
    GeoConfig,
    GeoState,
    admit_link_units,
    expand_delivery_slots,
    geo_init,
    geo_round,
)
from consul_tpu_torch.geo.report import GeoReport

__all__ = [
    "GeoConfig",
    "GeoReport",
    "GeoState",
    "admit_link_units",
    "dc_placement",
    "derive_wan_latency",
    "expand_delivery_slots",
    "geo_init",
    "geo_round",
]
