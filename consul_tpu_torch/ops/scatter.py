"""Message delivery as scatter ops (the port of ``consul_tpu/ops/scatter.py``).

All ops take target indices plus a delivery mask; masked-out messages
point at index n, one past the end, and land in an extra slot that is
sliced off: the reference's ``mode="drop"``.  A ``dest`` of shape
``[*B, n]`` (one row per universe of a sweep) takes targets
``[*B, ...]``, each universe scattering into its own row.
"""

from __future__ import annotations

import torch


def _masked_targets(dest: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Flat indices into ``dest`` padded to ``[*B, n + 1]``: undelivered
    messages go to the out-of-range bucket n of their universe's row."""
    n = dest.shape[-1]
    flat = torch.where(mask, targets.to(torch.int64), n)
    if dest.dim() > 1:
        rows = torch.arange(dest[..., 0].numel(), dtype=torch.int64,
                            device=dest.device)
        rows = rows.reshape(*dest.shape[:-1], *([1] * (flat.dim()
                                                     - dest.dim() + 1)))
        flat = flat + rows * (n + 1)
    return flat.reshape(-1)


def deliver_or(dest: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """OR a True bit into dest[t] for every delivered message (bool[*B, n])."""
    n = dest.shape[-1]
    hits = torch.zeros((*dest.shape[:-1], n + 1), dtype=torch.bool,
                       device=dest.device)
    # index_fill_ takes True as a kernel argument; assigning it through
    # an index tensor would copy it to the device and wait for the device.
    hits.view(-1).index_fill_(0, _masked_targets(dest, targets, mask), True)
    return dest | hits[..., :n]


def deliver_max(dest: torch.Tensor, targets: torch.Tensor,
                values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """dest[t] = max(dest[t], value) per delivered message."""
    n = dest.shape[-1]
    buf = torch.cat((dest, dest.new_zeros((*dest.shape[:-1], 1))), dim=-1)
    buf.view(-1).scatter_reduce_(
        0, _masked_targets(dest, targets, mask),
        values.reshape(-1).to(dest.dtype), reduce="amax",
    )
    return buf[..., :n]
