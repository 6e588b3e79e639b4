"""The node-axis "mesh": D logical shards held on one device.

In the reference, ``mesh_for(D)`` is a 1-D ``nodes`` mesh over D chips
and every per-node array is split into contiguous blocks of n/D nodes.
The port keeps those semantics on one card: every per-node plane of the
sharded scans carries a leading shard axis ``[D, blk]`` and every draw is
still made by global node id, so call sites read as in JAX::

    run_broadcast(cfg, 30, mesh=mesh_for(8), exchange="ring")
"""

from __future__ import annotations

import dataclasses

import torch

NODE_AXIS = "nodes"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` logical shards of the node axis on ``device``
    (``None``: the device the caller runs on)."""

    n_shards: int
    device: torch.device | None = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"need at least 1 shard, asked for {self.n_shards}")
        if self.device is not None:
            object.__setattr__(self, "device", torch.device(self.device))


def make_mesh(n_shards: int = 1, device=None) -> Mesh:
    """A ``nodes`` mesh of ``n_shards`` logical shards."""
    return Mesh(n_shards, device)


def mesh_for(n_devices: int, device=None) -> Mesh:
    """The mesh of ``cli sim --devices D``: D logical shards."""
    return make_mesh(n_devices, device)


def block_size(n: int, mesh: Mesh) -> int:
    """Nodes per shard under contiguous-block sharding; the node axis
    must divide evenly."""
    d = mesh.n_shards
    if n % d:
        raise ValueError(f"n={n} does not divide over {d} devices")
    return n // d
