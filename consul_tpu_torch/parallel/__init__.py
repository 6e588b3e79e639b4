"""The sharded plane: D logical shards of the node axis on one device."""

# The models come first: ``models.lifeguard`` loads ``sim``, whose engine
# loads ``parallel.shard``.
import consul_tpu_torch.models  # noqa: F401
from consul_tpu_torch.parallel.mesh import (
    NODE_AXIS,
    Mesh,
    block_size,
    make_mesh,
    mesh_for,
)
from consul_tpu_torch.parallel.shard import (
    exchange_outbox,
    outbox_budget,
    outbox_pitch,
    pack_outbox,
    sharded_broadcast_scan,
    sharded_geo_scan,
    ShardPlan,
    sharded_membership_plan,
    sharded_membership_round,
    sharded_membership_scan,
    sharded_sparse_membership_round,
    sharded_sparse_membership_scan,
    sharded_sparse_plan,
    sharded_streamcast_scan,
)

__all__ = [
    "Mesh",
    "NODE_AXIS",
    "ShardPlan",
    "block_size",
    "exchange_outbox",
    "make_mesh",
    "mesh_for",
    "outbox_budget",
    "outbox_pitch",
    "pack_outbox",
    "sharded_broadcast_scan",
    "sharded_geo_scan",
    "sharded_membership_plan",
    "sharded_membership_round",
    "sharded_membership_scan",
    "sharded_sparse_membership_round",
    "sharded_sparse_membership_scan",
    "sharded_sparse_plan",
    "sharded_streamcast_scan",
]
