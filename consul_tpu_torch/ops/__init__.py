"""Tensor primitives: threefry draws, peer sampling, budget compaction,
delivery scatters, the sort-merge delivery into sorted slot rows, and the
ring-exchange kernel."""

from consul_tpu_torch.ops.compact import compact_to_budget
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
    owned_uniform_rows,
    poissonized_arrivals,
    poissonized_arrivals_owned,
    sample_peers,
    sample_peers_owned,
    sample_probe_targets,
    sample_probe_targets_owned,
)
from consul_tpu_torch.ops.scatter import deliver_max, deliver_or
from consul_tpu_torch.ops.sortmerge import (
    host_cond,
    insert_rows_one,
    merge_deliveries,
    merge_into_rows,
    row_locate,
    row_locate_lo,
    sort_slot_rows,
)
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
    "compact_to_budget",
    "deliver_max",
    "deliver_or",
    "fold_in",
    "host_cond",
    "insert_rows_one",
    "merge_deliveries",
    "merge_into_rows",
    "owned_keys",
    "owned_randint",
    "owned_uniform",
    "owned_uniform_rows",
    "poissonized_arrivals",
    "poissonized_arrivals_owned",
    "randint",
    "random_bits",
    "ring_exchange",
    "ring_exchange_plain",
    "row_locate",
    "row_locate_lo",
    "sample_peers",
    "sample_peers_owned",
    "sample_probe_targets",
    "sample_probe_targets_owned",
    "sort_slot_rows",
    "split",
    "threefry2x32",
    "uniform",
]
