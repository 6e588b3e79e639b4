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
  - ``streamcast`` -- the pipelined chunked event stream under sustained
    load: the in-flight window, chunk selection policies, reports.
  - ``parallel`` -- D logical shards on one device, the outbox router.
  - ``sim``      -- ``run_broadcast``, ``run_swim``, ``run_lifeguard``,
    ``run_membership``, ``run_membership_sparse``, ``run_multidc``,
    ``run_geo``, ``run_streamcast``, fault schedules, offered-load
    generators, reports, and the BASELINE presets ``dev3``, ``probe1k``,
    ``event100k``, ``stream100k``, ``suspect1m``, ``degraded1m``,
    ``multidc1m`` and ``geo100k`` (``sim.scenarios``).
  - ``net``      -- the host gossip plane (``Memberlist`` over in-memory,
    UDP/TCP or simulated transports, the keyring, the broadcast queue)
    and the sim↔host bridge: a host agent joins a population simulated
    on the device through ``SimTransport`` (``net/wire.py`` carries the
    wire grammar and its msgpack codec).
  - ``eventing`` -- the serf layer over ``net``: ``Cluster`` with its
    Lamport clocks, user events, queries, coalescing and snapshots.
  - ``consensus``, ``store``, ``stream``, ``agent`` -- the consistency
    plane: Raft, the iradix/memdb state store, the change stream, the
    FSM and its snapshot archives; and the server plane above it: the
    RPC layer, the endpoints, ``Server`` and ``Client``.
  - ``acl``, ``connect`` -- the ACL resolver with the ``jwt`` auth
    method, and the mesh-gateway locator, which every ``Server`` builds.
  - ``convert``  -- numpy bridges for state and keys.

Entry points run on CUDA unless the caller passes ``device="cpu"``.

The names below load on first use, so that the host planes (``net``
without its bridge, ``eventing``, ``consensus``, ``store``, ``stream``,
``agent``, ``acl``, ``connect``) import without ``torch``.
"""

import importlib

# name -> the module that defines it.  ``geo`` and ``streamcast`` build on
# ``sim``, which is loaded first.
_EXPORTS = {
    "BroadcastConfig": "consul_tpu_torch.models",
    "LifeguardConfig": "consul_tpu_torch.models",
    "MembershipConfig": "consul_tpu_torch.models",
    "MultiDCConfig": "consul_tpu_torch.models",
    "SparseMembershipConfig": "consul_tpu_torch.models",
    "SwimConfig": "consul_tpu_torch.models",
    "make_mesh": "consul_tpu_torch.parallel",
    "mesh_for": "consul_tpu_torch.parallel",
    "run_broadcast": "consul_tpu_torch.sim",
    "run_geo": "consul_tpu_torch.sim",
    "run_lifeguard": "consul_tpu_torch.sim",
    "run_membership": "consul_tpu_torch.sim",
    "run_membership_sparse": "consul_tpu_torch.sim",
    "run_multidc": "consul_tpu_torch.sim",
    "run_streamcast": "consul_tpu_torch.sim",
    "run_swim": "consul_tpu_torch.sim",
    "GeoConfig": "consul_tpu_torch.geo",
    "StreamcastConfig": "consul_tpu_torch.streamcast",
}

__all__ = sorted([*_EXPORTS, "net"])


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    importlib.import_module("consul_tpu_torch.sim")
    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value
