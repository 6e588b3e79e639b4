"""consul_tpu_torch: the gossip simulator of ``consul_tpu`` on PyTorch and CUDA.

A port, slice by slice, of the JAX package ``consul_tpu`` to one NVIDIA
H100.  The JAX package is the reference: the same config, seed and step
count give the same per-tick outputs, bit for bit for integer and
boolean outputs, because :mod:`consul_tpu_torch.ops.threefry` reproduces
``jax.random``'s threefry draws.  The package imports ``torch`` and
numpy, never ``jax`` or ``consul_tpu``.

Layout (mirrors the JAX package):
  - ``protocol`` -- timing profiles and formulas.
  - ``ops``      -- threefry, owned sampling, budget compaction, delivery
    scatters, the sort-merge delivery into sorted slot rows, and the
    ring-exchange CUDA kernel (``csrc/ring_exchange.cu``).
  - ``models``   -- the event broadcast, SWIM failure detection, the
    Lifeguard health layer, full-membership SWIM (dense and top-K
    sparse), the two-edge-class multi-DC broadcast and Vivaldi
    coordinates.
  - ``geo``      -- the geo/WAN plane: Vivaldi-derived link latencies,
    bandwidth-capped delayed links with adaptive anti-entropy.
  - ``parallel`` -- D logical shards on one device, the outbox router.
  - ``sim``      -- ``run_broadcast``, ``run_swim``, ``run_lifeguard``,
    ``run_membership``, ``run_membership_sparse``, ``run_multidc``,
    ``run_geo``, fault schedules, reports, and the BASELINE presets
    ``probe1k``, ``suspect1m``, ``degraded1m``, ``multidc1m`` and
    ``geo100k`` (``sim.scenarios``).
  - ``convert``  -- numpy bridges for state and keys.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from consul_tpu_torch.models import (
    BroadcastConfig,
    LifeguardConfig,
    MembershipConfig,
    MultiDCConfig,
    SparseMembershipConfig,
    SwimConfig,
)
from consul_tpu_torch.parallel import make_mesh, mesh_for
from consul_tpu_torch.sim import (
    run_broadcast,
    run_geo,
    run_lifeguard,
    run_membership,
    run_membership_sparse,
    run_multidc,
    run_swim,
)
from consul_tpu_torch.geo import GeoConfig  # noqa: E402 (needs sim first)

__all__ = [
    "BroadcastConfig",
    "GeoConfig",
    "LifeguardConfig",
    "MembershipConfig",
    "MultiDCConfig",
    "SparseMembershipConfig",
    "SwimConfig",
    "make_mesh",
    "mesh_for",
    "run_broadcast",
    "run_geo",
    "run_lifeguard",
    "run_membership",
    "run_membership_sparse",
    "run_multidc",
    "run_swim",
]
