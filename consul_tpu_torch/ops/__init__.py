"""Tensor primitives: threefry draws, peer sampling, delivery scatters,
and the ring-exchange kernel."""

from consul_tpu_torch.ops.ring_exchange import (
    ring_exchange,
    ring_exchange_plain,
)
from consul_tpu_torch.ops.sampling import (
    aggregate_arrivals,
    arrival_rate,
    bernoulli_mask,
    bernoulli_mask_owned,
    owned_keys,
    owned_randint,
    owned_uniform,
    poissonized_arrivals,
    poissonized_arrivals_owned,
    sample_peers,
    sample_peers_owned,
    sample_probe_targets,
    sample_probe_targets_owned,
)
from consul_tpu_torch.ops.scatter import deliver_max, deliver_or
from consul_tpu_torch.ops.threefry import (
    PRNGKey,
    fold_in,
    randint,
    random_bits,
    split,
    threefry2x32,
    uniform,
)

__all__ = [
    "PRNGKey",
    "aggregate_arrivals",
    "arrival_rate",
    "bernoulli_mask",
    "bernoulli_mask_owned",
    "deliver_max",
    "deliver_or",
    "fold_in",
    "owned_keys",
    "owned_randint",
    "owned_uniform",
    "poissonized_arrivals",
    "poissonized_arrivals_owned",
    "randint",
    "random_bits",
    "ring_exchange",
    "ring_exchange_plain",
    "sample_peers",
    "sample_peers_owned",
    "sample_probe_targets",
    "sample_probe_targets_owned",
    "split",
    "threefry2x32",
    "uniform",
]
