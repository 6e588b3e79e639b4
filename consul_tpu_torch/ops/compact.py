"""Budget compaction: rank the wanted entries of a stream into a fixed
slot budget, counting what missed (the port of ``consul_tpu/ops/compact.py``).

Positions come from a cumsum over the wanted mask (two cumsums in
class-major order when a priority class is given), so admitted entries
keep stream order.  The slot table is built by scattering the stream
index at its admitted position into ``budget + 1`` slots, the last of
which takes every entry that was not admitted and is sliced off: no
boolean is ever scattered with duplicate indices.
"""

from __future__ import annotations

import torch


def compact_to_budget(want: torch.Tensor, budget: int,
                      first: torch.Tensor = None):
    """Compact the True entries of ``want`` (bool[A]) into ``budget``
    slots in stream order; ``first`` (bool[A]) marks a priority class
    admitted ahead of the rest (class-major, stream order within each).

    Returns ``(idx, taken, kept, dropped)``: ``idx`` int32[budget], the
    stream index in each slot (A-1 on empty slots, so it is safe to
    gather with); ``taken`` bool[budget], the slot holds an entry;
    ``kept`` bool[A], wanted and admitted; ``dropped`` int32, wanted
    entries past the budget."""
    a_len = want.shape[0]
    dev = want.device
    if first is None:
        cpos = torch.cumsum(want, 0, dtype=torch.int32) - 1
    else:
        prio = want & first
        pq = torch.cumsum(prio, 0, dtype=torch.int32)
        rest = torch.cumsum(want & ~first, 0, dtype=torch.int32)
        cpos = torch.where(prio, pq - 1, pq[-1] + rest - 1)
    kept = want & (cpos < budget)
    ctgt = torch.where(kept, torch.clamp(cpos, 0, budget - 1), budget)
    idx = torch.full((budget + 1,), a_len, dtype=torch.int32, device=dev)
    idx = idx.scatter(0, ctgt.long(),
                      torch.arange(a_len, dtype=torch.int32, device=dev))
    idx = idx[:budget]
    taken = idx < a_len
    dropped = (torch.sum(want, dtype=torch.int32)
               - torch.sum(taken, dtype=torch.int32))
    return torch.clamp(idx, max=a_len - 1), taken, kept, dropped
