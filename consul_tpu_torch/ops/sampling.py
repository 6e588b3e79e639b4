"""Random peer sampling on owned, counter-based key streams.

The port of ``consul_tpu/ops/sampling.py``.  Every node-indexed draw
derives from ``fold_in(fold_in(fold_in(scan_key, round), site), id)``
with ``id`` the GLOBAL node id, so node ``i``'s values depend only on
``(scan_key, round, site, i)``: a shard holding the block
``[start, start+blk)`` draws for its rows only and gets the values the
unsharded round draws over ``arange(n)``.  ``ids`` may carry any
leading shape (``[m]`` or the sharded plane's ``[D, blk]``); draws
append their own shape after it.
"""

from __future__ import annotations

import torch

from consul_tpu_torch.device import device_scalar
from consul_tpu_torch.ops.threefry import fold_in, randint, uniform


def _f32(x, device) -> torch.Tensor:
    return device_scalar(x, torch.float32, device)


def owned_keys(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-node key stream ``fold_in(key, id)``: ``[*ids.shape, 2]``."""
    return fold_in(key, ids)


def owned_uniform(key: torch.Tensor, ids: torch.Tensor,
                  shape: tuple = ()) -> torch.Tensor:
    """float32 ``[*ids.shape, *shape]`` uniform in [0, 1): row j is node
    ids[j]'s private stream for this site key."""
    return uniform(owned_keys(key, ids), shape)


# Values per block of owned_uniform_rows: its int64 threefry temporaries
# stay near 512 MB each.
_DRAW_BLOCK = 1 << 26


def owned_uniform_rows(key: torch.Tensor, rows: int,
                       width: int) -> torch.Tensor:
    """float32 ``[rows, width]``: :func:`owned_uniform` over ``arange(rows)``
    with draw shape ``(width,)``, generated in row blocks of about
    ``_DRAW_BLOCK`` values.  Row i is node i's stream whatever the
    blocking, so the result is the same as one call's."""
    out = torch.empty((rows, width), dtype=torch.float32, device=key.device)
    step = max(1, _DRAW_BLOCK // max(width, 1))
    for start in range(0, rows, step):
        stop = min(rows, start + step)
        ids = torch.arange(start, stop, dtype=torch.int32, device=key.device)
        out[start:stop] = owned_uniform(key, ids, (width,))
    return out


def owned_randint(key: torch.Tensor, ids: torch.Tensor, shape: tuple,
                  minval, maxval) -> torch.Tensor:
    """int32 ``[*ids.shape, *shape]`` uniform integers in [minval, maxval)."""
    return randint(owned_keys(key, ids), shape, minval, maxval)


def sample_peers_owned(key: torch.Tensor, ids: torch.Tensor, n: int,
                       fanout: int) -> torch.Tensor:
    """Each owned node picks ``fanout`` peers uniformly over the other
    n-1 nodes: int32 ``[*ids.shape, fanout]`` of GLOBAL ids.

    The shift trick of the reference: draw from [0, n-1) and bump values
    at or above the row's own id by one, so self is never drawn."""
    draws = owned_randint(key, ids, (fanout,), 0, max(n - 1, 1))
    own = ids[..., None].to(torch.int32)
    return torch.where(draws >= own, draws + 1, draws) % n


def sample_peers(key: torch.Tensor, n: int, fanout: int) -> torch.Tensor:
    """:func:`sample_peers_owned` over ``arange(n)``: int32 ``[n, fanout]``."""
    ids = torch.arange(n, dtype=torch.int32, device=key.device)
    return sample_peers_owned(key, ids, n, fanout)


def sample_alive_peers_owned(key: torch.Tensor, ids: torch.Tensor,
                             alive: torch.Tensor, fanout: int) -> torch.Tensor:
    """Each owned node picks ``fanout`` peers uniformly among the ALIVE
    nodes other than itself (kRandomNodes filters dead and left members,
    memberlist/util.go:131-153): int32 ``[*ids.shape, fanout]`` of global
    ids.

    The alive ordering (the alive-first index table and the alive count)
    is a function of the whole ``alive`` plane; the draws are owned: from
    [0, A-1) with the alive count A as a tensor bound, shifted past the
    row's own alive rank, then mapped through the table.  Dead rows draw
    too; the caller masks their packets."""
    n = alive.shape[0]
    cnt = torch.sum(alive, dtype=torch.int32)
    order = torch.sort((~alive).to(torch.int8), stable=True).indices
    rank = torch.empty(n, dtype=torch.int32, device=alive.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=alive.device)
    draws = owned_randint(key, ids, (fanout,), 0, torch.clamp(cnt - 1, min=1))
    own = rank[ids.long()][..., None]
    draws = torch.where(draws >= own, draws + 1, draws)
    return order.to(torch.int32)[(draws % torch.clamp(cnt, min=1)).long()]


def sample_alive_peers(key: torch.Tensor, alive: torch.Tensor,
                       fanout: int) -> torch.Tensor:
    """:func:`sample_alive_peers_owned` over ``arange(n)``: int32
    ``[n, fanout]``."""
    ids = torch.arange(alive.shape[0], dtype=torch.int32, device=key.device)
    return sample_alive_peers_owned(key, ids, alive, fanout)


def sample_probe_targets_owned(key: torch.Tensor, ids: torch.Tensor,
                               n: int) -> torch.Tensor:
    """One probe target per owned node per probe round (memberlist probes
    one node per ProbeInterval, state.go:214-256), uniform over the other
    n-1 nodes: int32 ``ids.shape`` of global ids."""
    return sample_peers_owned(key, ids, n, 1)[..., 0]


def sample_probe_targets(key: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`sample_probe_targets_owned` over ``arange(n)``: int32 ``[n]``."""
    ids = torch.arange(n, dtype=torch.int32, device=key.device)
    return sample_probe_targets_owned(key, ids, n)


def bernoulli_mask_owned(key: torch.Tensor, ids: torch.Tensor, shape: tuple,
                         p_success) -> torch.Tensor:
    """bool ``[*ids.shape, *shape]``, True = delivered: a float32 uniform
    below the float32 ``p_success``."""
    return owned_uniform(key, ids, shape) < _f32(p_success, key.device)


def bernoulli_mask(key: torch.Tensor, shape, p_success) -> torch.Tensor:
    """:func:`bernoulli_mask_owned` with ``shape[0]`` rows over ``arange``."""
    ids = torch.arange(shape[0], dtype=torch.int32, device=key.device)
    return bernoulli_mask_owned(key, ids, tuple(shape[1:]), p_success)


def poissonized_arrivals_owned(key: torch.Tensor, ids: torch.Tensor,
                               lam: torch.Tensor) -> torch.Tensor:
    """bool per owned receiver: >= 1 arrival under Poisson(``lam``), with
    ``lam`` float32 already cut to the owned rows (``lam.shape`` begins
    with ``ids.shape``)."""
    shape = tuple(lam.shape[ids.dim():])
    return owned_uniform(key, ids, shape) < -torch.expm1(-lam)


def poissonized_arrivals(key: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """:func:`poissonized_arrivals_owned` over ``arange(lam.shape[0])``."""
    ids = torch.arange(lam.shape[0], dtype=torch.int32, device=key.device)
    return poissonized_arrivals_owned(key, ids, lam)


def arrival_rate(s_total: torch.Tensor, senders: torch.Tensor, fanout: int,
                 loss: float, n: int) -> torch.Tensor:
    """float32 Poisson intensity per receiver: the other senders' copies,
    ``(s_total - own) * fanout * (1 - loss) / (n - 1)``, in the
    reference's float32 operation order."""
    dev = senders.device
    lam = (s_total - senders.to(torch.float32)) * _f32(fanout, dev)
    lam = lam * _f32(1.0 - loss, dev)
    return lam / _f32(max(n - 1, 1), dev)


def aggregate_arrivals(key: torch.Tensor, senders: torch.Tensor, fanout: int,
                       loss: float, n: int,
                       alive: torch.Tensor = None) -> torch.Tensor:
    """bool[n]: received >= 1 copy under Poissonized push-gossip delivery
    (S senders, each pushing ``fanout`` copies to uniform non-self
    targets, each copy surviving loss independently), so
    P(>= 1 copy) = 1 - exp(-lambda).  A sender's own copies are not in
    its lambda.

    ``alive`` (bool[n]) is the aggregate dual of
    :func:`sample_alive_peers`: the copies spread over the other A-1
    alive nodes (the float32 denominator ``max(A - 1, 1)``) and dead
    receivers hear nothing."""
    s_total = torch.sum(senders, dtype=torch.float32)
    if alive is None:
        return poissonized_arrivals(
            key, arrival_rate(s_total, senders, fanout, loss, n)
        )
    dev = senders.device
    lam = (s_total - senders.to(torch.float32)) * _f32(fanout, dev)
    lam = lam * _f32(1.0 - loss, dev)
    lam = lam / torch.clamp(torch.sum(alive, dtype=torch.float32) - 1.0,
                            min=1.0)
    return poissonized_arrivals(key, lam) & alive
