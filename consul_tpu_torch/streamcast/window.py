"""The in-flight event window: fixed-W slot allocation for a stream.

The port of ``consul_tpu/streamcast/window.py``.  ``slot_event[W]`` holds
the global id of the event in each slot (-1 free).  Both functions are
integer functions of the replicated ``[W]`` and ``[K]`` planes, so the
sharded twin steps them once for all shards.

Accounting: an arrival the window cannot hold is counted, never lost
silently --

  window_overflow   arrivals that found no free slot and were dropped
  coalesced         arrivals or occupants superseded by a newer event of
                    the same name (event ids are Lamport times and the
                    schedule arrives in id order)

Admission order is ascending event id into ascending free slots.
"""

from __future__ import annotations

import torch

_I32 = torch.int32


def admit(slot_event: torch.Tensor, slot_birth: torch.Tensor,
          arrive: torch.Tensor, ev_name: torch.Tensor, tick: torch.Tensor):
    """One tick of window admission.

    ``slot_event`` int32[W] (-1 free), ``slot_birth`` int32[W],
    ``arrive`` bool[K], ``ev_name`` int32[K] (-1 unnamed), ``tick`` int32
    scalar.  Returns ``(slot_event, slot_birth, filled, freed, overflow,
    coalesced)``: ``filled`` bool[W] the slots holding a fresh event
    (ranked admissions and in-place supersede claims), ``freed`` bool[W]
    the slots whose occupant a newer same-name arrival replaced (a subset
    of ``filled``), and the int32 counts of dropped and superseded
    events."""
    k_events = arrive.shape[0]
    dev = arrive.device
    ev_id = torch.arange(k_events, dtype=_I32, device=dev)
    occ = slot_event >= 0

    # Lamport supersede in place: a named arrival replaces any older
    # same-name occupant in its own slot (the newest superseder claims
    # it); older same-tick arrivals of a name never allocate.
    named_arr = torch.where(arrive & (ev_name >= 0), ev_name, -2)
    slot_name = torch.where(occ, ev_name[torch.clamp(slot_event, min=0).long()],
                            -3)
    supersedes = ((named_arr[None, :] == slot_name[:, None])
                  & (ev_id[None, :] > slot_event[:, None]))       # [W, K]
    freed = occ & torch.any(supersedes, dim=1)
    claim = torch.amax(torch.where(supersedes, ev_id[None, :], -1), dim=1)
    superseded_arr = arrive & torch.any(
        (named_arr[None, :] == named_arr[:, None])
        & (ev_id[None, :] > ev_id[:, None])
        & (ev_name[:, None] >= 0),
        dim=1,
    )
    coalesced = (torch.sum(freed, dtype=_I32)
                 + torch.sum(superseded_arr, dtype=_I32))
    slot_event = torch.where(freed, claim, slot_event)
    slot_birth = torch.where(freed, tick, slot_birth)
    claimed = torch.any(freed[:, None] & (claim[:, None] == ev_id[None, :]),
                        dim=0)                                    # [K]

    # Rank-matched allocation: arrival rank r takes the r-th free slot;
    # arrivals ranked past the free count are the overflow.
    want = arrive & ~superseded_arr & ~claimed
    free = slot_event < 0
    n_free = torch.sum(free, dtype=_I32)
    arr_rank = torch.cumsum(want.to(_I32), dim=0, dtype=_I32) - 1
    admitted = want & (arr_rank < n_free)
    n_adm = torch.sum(admitted, dtype=_I32)
    overflow = torch.sum(want, dtype=_I32) - n_adm

    # The reference's scatter with mode="drop": non-admitted events aim
    # at the sentinel slot K, which is cut off.
    ids_by_rank = torch.full((k_events + 1,), -1, dtype=_I32, device=dev)
    ids_by_rank.scatter_(0, torch.where(admitted, arr_rank, k_events).long(),
                         ev_id)
    free_rank = torch.cumsum(free.to(_I32), dim=0, dtype=_I32) - 1
    filled = free & (free_rank < n_adm)
    take = ids_by_rank[torch.clamp(free_rank, 0, k_events - 1).long()]
    slot_event = torch.where(filled, take, slot_event)
    slot_birth = torch.where(filled, tick, slot_birth)
    return (slot_event, slot_birth, filled | freed, freed, overflow,
            coalesced)


def retire(slot_event: torch.Tensor, done_count: torch.Tensor,
           active_senders: torch.Tensor, slot_birth: torch.Tensor,
           tick: torch.Tensor, target: int):
    """End-of-round retirement: a slot clears when at least ``target``
    nodes hold every chunk (``complete``) or when no node can transmit
    for it any more (``quiesced``; a slot born this tick never
    quiesces).  Returns ``(cleared, complete, quiesced)`` bool[W]."""
    occ = slot_event >= 0
    complete = occ & (done_count >= target)
    quiesced = occ & ~complete & (active_senders == 0) & (slot_birth < tick)
    return complete | quiesced, complete, quiesced
