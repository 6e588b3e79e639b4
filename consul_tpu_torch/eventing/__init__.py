"""Gossip eventing layer (the serf equivalent): the port's copy of
``consul_tpu.eventing``.

Lamport-clocked membership intents, user-event epidemic broadcast with a
dedup ring, request/response queries, tag-carrying members, event
coalescing, the gossip snapshot and a push/pull convergence backstop,
layered on ``consul_tpu_torch.net.Memberlist`` through its delegate
hooks, as serf layers on memberlist (vendor/serf/serf/delegate.go).
"""

from consul_tpu_torch.eventing.lamport import LamportClock
from consul_tpu_torch.eventing.cluster import (
    Cluster,
    ClusterConfig,
    Event,
    EventType,
    Member,
    MemberStatus,
    QueryResponseHandle,
    QueryResult,
)
from consul_tpu_torch.eventing.coalesce import Coalescer
from consul_tpu_torch.eventing.snapshot import Snapshotter

__all__ = [
    "Cluster",
    "ClusterConfig",
    "Coalescer",
    "Event",
    "EventType",
    "LamportClock",
    "Member",
    "MemberStatus",
    "QueryResponseHandle",
    "QueryResult",
    "Snapshotter",
]
