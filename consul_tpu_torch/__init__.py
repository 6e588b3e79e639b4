"""consul_tpu_torch: the gossip simulator of ``consul_tpu`` on PyTorch and CUDA.

A port, slice by slice, of the JAX package ``consul_tpu`` to one NVIDIA
H100.  The JAX package is the reference: the same config, seed and step
count give the same per-tick outputs, bit for bit for integer and
boolean outputs, because :mod:`consul_tpu_torch.ops.threefry` reproduces
``jax.random``'s threefry draws.  The package imports ``torch`` and
numpy, never ``jax`` or ``consul_tpu``.

Layout (mirrors the JAX package):
  - ``protocol`` -- timing profiles and formulas.
  - ``ops``      -- threefry, owned sampling, delivery scatters, and the
    ring-exchange CUDA kernel (``csrc/ring_exchange.cu``).
  - ``models``   -- the event broadcast.
  - ``parallel`` -- D logical shards on one device, the outbox router.
  - ``sim``      -- ``run_broadcast`` and its report.
  - ``convert``  -- numpy bridges for state and keys.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from consul_tpu_torch.models import BroadcastConfig
from consul_tpu_torch.parallel import make_mesh, mesh_for
from consul_tpu_torch.sim import run_broadcast

__all__ = ["BroadcastConfig", "make_mesh", "mesh_for", "run_broadcast"]
