"""State-change pub/sub: snapshot + live-follow subscriptions
(agent/consul/stream + agent/rpc/subscribe equivalents); the port's copy
of ``consul_tpu.stream``."""

from consul_tpu_torch.stream.publisher import (
    TOPIC_KV,
    TOPIC_SERVICE_HEALTH,
    Event,
    EventPublisher,
    Subscription,
    SubscriptionClosed,
)

__all__ = [
    "TOPIC_KV",
    "TOPIC_SERVICE_HEALTH",
    "Event",
    "EventPublisher",
    "Subscription",
    "SubscriptionClosed",
]
