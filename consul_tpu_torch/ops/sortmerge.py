"""Sort-merge primitives (the part of ``consul_tpu/ops/sortmerge.py`` the
outbox packer needs)."""

from __future__ import annotations

import torch


def _segmented_sum(flags: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum along the last axis: each position holds
    the sum over its segment prefix (segments start where ``flags`` is
    True; positions before the first flag sum from index 0).  One
    cumsum, one cummax and a gather, as in the reference."""
    m = x.shape[-1]
    idx = torch.arange(m, dtype=torch.int64, device=x.device)
    cs = torch.cumsum(x, dim=-1, dtype=x.dtype)
    start = torch.cummax(torch.where(flags, idx, -1), dim=-1).values
    prev = torch.gather(cs, -1, torch.clamp(start - 1, min=0))
    base = torch.where(start >= 1, prev, torch.zeros_like(prev))
    return cs - base
