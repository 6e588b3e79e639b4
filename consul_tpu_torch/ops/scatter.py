"""Message delivery as scatter ops (the port of ``consul_tpu/ops/scatter.py``).

All ops take flat target indices plus a delivery mask; masked-out
messages point at index n, one past the end, and land in an extra slot
that is sliced off: the reference's ``mode="drop"``.
"""

from __future__ import annotations

import torch


def _masked_targets(targets: torch.Tensor, mask: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Route undelivered messages to the out-of-range bucket n."""
    return torch.where(mask.reshape(-1), targets.reshape(-1).to(torch.int64), n)


def deliver_or(dest: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """OR a True bit into dest[t] for every delivered message (bool[n])."""
    n = dest.shape[-1]
    hits = torch.zeros(n + 1, dtype=torch.bool, device=dest.device)
    hits[_masked_targets(targets, mask, n)] = True
    return dest | hits[:n]


def deliver_max(dest: torch.Tensor, targets: torch.Tensor,
                values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """dest[t] = max(dest[t], value) per delivered message."""
    n = dest.shape[-1]
    buf = torch.cat((dest, dest.new_zeros(1)))
    buf.scatter_reduce_(
        0, _masked_targets(targets, mask, n),
        values.reshape(-1).to(dest.dtype), reduce="amax",
    )
    return buf[:n]
