"""Top-K sparse full-membership SWIM on PyTorch tensors.

The port of ``consul_tpu/models/membership_sparse.py``.  The dense model's
N x N view does not fit past n of a few 10^4; but almost every cell holds
the default (alive at incarnation 0, nothing queued, no timer).  So each
observer keeps only K explicit slots, its row's non-default cells, and
every absent subject implicitly holds the default.

  slot_subj[i, k]  int32 -- the subject of slot (i, k), -1 empty.  Every
                   row stays sorted ascending by subject, empties last
                   (the sorted-row invariant ``ops/sortmerge.py`` locates
                   against); empty slots hold the default contents.
  key              int32[n, K]
  suspect_since    int16[n, K] -- the suspicion's AGE in ticks (-1 none,
                   saturating at AGE_CAP); :func:`densify` restores the
                   absolute tick as ``tick - age``
  confirms, tx     int8[n, K]; awareness int8[n]
  overflow         int32 -- news dropped to slot pressure or budgets
  forgotten        int32 -- settled cells evicted (benign)

The narrow dtypes stay narrow through the round, so the state round-trips
dtype for dtype.  With K == n and the identity layout a round draws the
same values in the same shapes as ``membership_round``, so the two agree
through :func:`densify`.

The reference branches twice a round with ``lax.cond`` on a device
predicate (does any arrival need a slot? does any maturing probe?).  With
``amortize`` (the default) the port reads each predicate on the host
through ``ops.sortmerge.host_cond``: at most two synchronisations a round,
or one per chunk on the chunked path, counted in ``host_cond.syncs``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from consul_tpu_torch.device import device_scalar, resolve_device
from consul_tpu_torch.models.membership import (
    NEVER,
    RANK_ALIVE,
    RANK_DEAD,
    RANK_LEFT,
    RANK_SUSPECT,
    MembershipConfig,
    _schedule_array,
    _set_cols,
    ground_truth,
    key_inc,
    key_rank,
    make_key,
    top_slots,
)
from consul_tpu_torch.models.swim import timeout_table
from consul_tpu_torch.ops import (
    bernoulli_mask,
    compact_to_budget,
    host_cond,
    insert_rows_one,
    merge_into_rows,
    owned_uniform_rows,
    row_locate,
    sample_peers,
    sample_probe_targets,
    split,
)
from consul_tpu_torch.ops import sortmerge

DEFAULT_KEY = 0  # make_key(0, RANK_ALIVE): the steady-state cell

CONF_DTYPE = torch.int8
TX_DTYPE = torch.int8
AWARE_DTYPE = torch.int8
SINCE_DTYPE = torch.int16

AGE_NONE = -1
AGE_CAP = 32000

# Arrivals one merge call may see before the round switches to the
# chunked driver (_deliver_chunked), and the arrivals per chunk there.
_CHUNK_A = 1 << 25
_CHUNK_TARGET = 1 << 23

# Allocation-substream budget handed to merge_into_rows.
_ALLOC_BUDGET = 1 << 16

# Loud-accounting counters saturate here instead of wrapping.
COUNTER_CAP = 1 << 29

# Default contents of an empty (or freshly claimed) slot, aligned with the
# (key, suspect_since, confirms, tx) companion planes.
_PLANE_DEFAULTS = (DEFAULT_KEY, AGE_NONE, 0, 0)


def _chunk_count(total: int, n_rows: int) -> int:
    """Chunks needed to keep per-chunk arrivals near _CHUNK_TARGET,
    preferring a divisor of ``n_rows``."""
    c_min = max(1, -(-total // _CHUNK_TARGET))
    for c in range(c_min, min(4 * c_min + 1, n_rows)):
        if n_rows % c == 0:
            return c
    return c_min


@dataclasses.dataclass(frozen=True)
class SparseMembershipConfig:
    """A membership study bounded to K explicit cells per observer.

    ``join_at`` is unsupported: a joiner's default is "unknown", not
    "alive@0".  ``amortize``: True or None (the default) skips the
    allocation machinery on ticks that need no slot, at one host read of
    the predicate each; False runs it every tick, with the same results
    and no host read."""

    base: MembershipConfig
    k_slots: int = 64
    amortize: Optional[bool] = None

    def __post_init__(self):
        if self.base.join_at:
            raise ValueError(
                "sparse membership does not support join_at schedules"
            )
        if self.k_slots < 2:
            raise ValueError("k_slots must be >= 2")
        limit = self.base.tx_limit
        if limit > torch.iinfo(TX_DTYPE).max - self.base.fanout:
            raise ValueError(
                f"tx_limit {limit} exceeds the certified int8 tx plane"
            )
        if self.base.confirmations_k > torch.iinfo(CONF_DTYPE).max:
            raise ValueError(
                f"confirmations_k {self.base.confirmations_k} exceeds the "
                "certified int8 confirms plane"
            )
        amax = self.base.profile.awareness_max_multiplier
        if amax > torch.iinfo(AWARE_DTYPE).max:
            raise ValueError(
                f"awareness_max_multiplier {amax} exceeds the certified "
                "int8 awareness plane"
            )
        hi = self.base.suspicion_bounds_ticks[1]
        if hi >= AGE_CAP:
            raise ValueError(
                f"suspicion timeout bound {hi:.0f} ticks exceeds the "
                f"age-packed suspect_since saturation AGE_CAP={AGE_CAP}"
            )


class SparseMembershipState(NamedTuple):
    slot_subj: torch.Tensor        # int32[n, K]
    key: torch.Tensor              # int32[n, K]
    suspect_since: torch.Tensor    # int16[n, K] (age)
    confirms: torch.Tensor         # int8[n, K]
    tx: torch.Tensor               # int8[n, K]
    own_inc: torch.Tensor          # int32[n]
    awareness: torch.Tensor        # int8[n]
    probe_pending_at: torch.Tensor # int32[n]
    probe_subject: torch.Tensor    # int32[n]
    overflow: torch.Tensor         # int32 scalar
    forgotten: torch.Tensor        # int32 scalar
    tick: torch.Tensor             # int32 scalar


def pp_initiator_budget(n: int, push_pull_ticks: int) -> int:
    """Initiator slots of the compacted push/pull exchange: 8x the
    Poissonized mean, floor 64; misses count into ``overflow``."""
    return min(n, max(64, (8 * n) // max(1, push_pull_ticks)))


def gossip_sender_budget(n: int) -> int:
    """Sender slots of the compacted gossip emission at K < n: n/4, floor
    2048; unselected senders spend nothing, retry next tick and count into
    ``overflow``."""
    return min(n, max(2048, n // 4))


def arrival_count(cfg: SparseMembershipConfig) -> int:
    """Length of one tick's flat arrival stream."""
    base = cfg.base
    n = base.n
    K = min(cfg.k_slots, n)
    M = min(base.piggyback, K)
    if K < n:
        A = gossip_sender_budget(n) * base.fanout * M
        if base.push_pull_enabled:
            A += 2 * pp_initiator_budget(n, base.push_pull_ticks) * K
    else:
        A = n * base.fanout * M
        if base.push_pull_enabled:
            A += 2 * n * K
    return A


def sparse_membership_init(cfg: SparseMembershipConfig,
                           device=None) -> SparseMembershipState:
    dev = resolve_device(device)
    n, K = cfg.base.n, cfg.k_slots
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    if K >= n:
        # Identity layout: slot j holds subject j (the exact-parity mode).
        K = n
        slot_subj = ids[None, :].expand(n, n).clone()
    else:
        # Slot 0 holds the observer itself; the rest fill on demand.
        slot_subj = torch.full((n, K), -1, dtype=torch.int32, device=dev)
        slot_subj[:, 0] = ids

    def full(value, shape, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return SparseMembershipState(
        slot_subj=slot_subj,
        key=full(0, (n, K)),
        suspect_since=full(AGE_NONE, (n, K), SINCE_DTYPE),
        confirms=full(0, (n, K), CONF_DTYPE),
        tx=full(0, (n, K), TX_DTYPE),
        own_inc=full(0, (n,)),
        awareness=full(0, (n,), AWARE_DTYPE),
        probe_pending_at=full(NEVER, (n,)),
        probe_subject=full(0, (n,)),
        overflow=full(0, ()),
        forgotten=full(0, ()),
        tick=full(0, ()),
    )


# ---------------------------------------------------------------------------
# slot lookup and arrival machinery
# ---------------------------------------------------------------------------


def settled_of(slots: tuple, row_ids: torch.Tensor = None) -> torch.Tensor:
    """Cells whose eviction loses only recoverable information: alive rank,
    nothing queued, no timer, no confirmations; the self slot is pinned.
    ``row_ids`` gives each row's global node id (``arange`` by default)."""
    slot_subj, key_m, since, conf, tx = slots
    if row_ids is None:
        row_ids = torch.arange(slot_subj.shape[0], dtype=torch.int32,
                               device=slot_subj.device)
    return ((slot_subj >= 0) & (slot_subj != row_ids[:, None])
            & (key_rank(key_m) == RANK_ALIVE)
            & (tx == 0) & (since < 0) & (conf == 0))


def _rows_of(a: torch.Tensor, start, rows: int) -> torch.Tensor:
    """Rows [start, start + rows) of a plane; the plane itself when
    ``start`` is None."""
    return a if start is None else a[start:start + rows]


def _settled_blocks(row_ids: torch.Tensor = None):
    """Eviction mask for merge_into_rows as a callable of
    ``(slot_subj, planes, start, rows)``: settled_of over that row block,
    with global row ids so the self-slot pin survives slicing."""
    def mask(slot_subj, planes, start, rows: int):
        blk = tuple(_rows_of(p, start, rows) for p in (slot_subj, *planes))
        base = 0 if start is None else start
        ids = (base + torch.arange(rows, dtype=torch.int32,
                                   device=slot_subj.device)
               if row_ids is None else _rows_of(row_ids, start, rows))
        return settled_of(blk, ids)
    return mask


def _remembers_blocks():
    """Remembered-cell mask (evicting it loses an incarnation), with the
    contract of :func:`_settled_blocks`."""
    def mask(slot_subj, planes, start, rows: int):
        return ((_rows_of(slot_subj, start, rows) >= 0)
                & (_rows_of(planes[0], start, rows) != DEFAULT_KEY))
    return mask


def _claim_one(slots: tuple, want: torch.Tensor, new_subj: torch.Tensor,
               row_ids: torch.Tensor = None, amortize: bool = True):
    """One bounded-insertion claim per row for ``new_subj`` where ``want``
    (the probe-maturity path): empty slots first, then settled ones.  With
    ``amortize`` the claim runs only when some row wants one (one host
    read of ``any(want)``).

    Returns (slots', can, pos, forgotten_delta, overflow_delta)."""
    slot_subj, key_m, since, conf, tx = slots
    dev = slot_subj.device
    if amortize and not host_cond(torch.any(want)):
        n = slot_subj.shape[0]
        zero = device_scalar(0, torch.int32, dev)
        return (slots, torch.zeros((n,), dtype=torch.bool, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev),
                zero, zero)
    new_ss, planes, can, pos, forgot = insert_rows_one(
        slot_subj, (key_m, since, conf, tx), _PLANE_DEFAULTS, want, new_subj,
        evictable=settled_of(slots, row_ids),
        remembers=(slot_subj >= 0) & (key_m != DEFAULT_KEY),
    )
    ov = torch.sum(want & ~can, dtype=torch.int32)
    return (new_ss, *planes), can, pos, forgot, ov


def _add_capped(counter: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(counter, max=COUNTER_CAP) + delta


def _merge_arrivals(slots: tuple, recv, subj, val, sus, ok, alloc, n: int,
                    K: int, overflow, forgotten, row_ids=None,
                    amortize: bool = True):
    """The delivery pipeline on ``merge_into_rows``: only settled cells may
    be claimed, evicting one whose key is not the default counts into
    ``forgotten``, allocation-worthy news without a slot into
    ``overflow``.  Returns (slots, key_rx, sus_rx, overflow, forgotten);
    rows come back sorted, so positional handles must be re-derived."""
    slot_subj, key_m, since, conf, tx = slots
    new_subj, planes, key_rx, sus_rx, dropped, forgot = merge_into_rows(
        slot_subj, (key_m, since, conf, tx), _PLANE_DEFAULTS,
        recv, subj, val, sus, ok, alloc,
        evictable=_settled_blocks(row_ids), remembers=_remembers_blocks(),
        default_val=DEFAULT_KEY, allocate=K < n,
        alloc_budget=_ALLOC_BUDGET, amortize=amortize,
    )
    return ((new_subj, *planes), key_rx, sus_rx,
            _add_capped(overflow, dropped), _add_capped(forgotten, forgot))


def _sus_of(v: torch.Tensor) -> torch.Tensor:
    """Suspicion incarnation carried by a gossip value, -1 for none."""
    return torch.where(key_rank(v) == RANK_SUSPECT, key_inc(v), -1)


def _slice_clamped(a: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """``a[start:start + size]`` with ``lax.dynamic_slice``'s rule: a start
    past ``len(a) - size`` is moved back so the slice stays whole."""
    start = max(0, min(start, a.shape[0] - size))
    return a[start:start + size]


def _pad_rows(a: torch.Tensor, pad: int, value) -> torch.Tensor:
    if not pad:
        return a
    return torch.cat((a, a.new_full((pad, *a.shape[1:]), value)))


def _deliver_chunked(slots, targets, packet_ok, msg_subj, msg_key, msg_valid,
                     pp, n: int, K: int, overflow, forgotten,
                     amortize: bool = True):
    """Delivery for streams too large to build whole (n of a few million):
    the gossip and push/pull legs are generated chunk by chunk from their
    [S, F]/[S, M]/[I] sources and each chunk lands through merge_into_rows
    with the rx planes carried as accumulators.  Chunks merge in order, so
    later chunks see earlier claims, and push/pull rows are read from the
    partly merged table; gossip chunks start where ``lax.dynamic_slice``
    would put them.  Returns (slots', key_rx, sus_rx, overflow',
    forgotten')."""
    F = targets.shape[1]
    M = msg_subj.shape[1]
    dev = targets.device
    rx = (torch.full((n, K), -1, dtype=torch.int32, device=dev),
          torch.full((n, K), -1, dtype=torch.int32, device=dev))
    dropped = device_scalar(0, torch.int32, dev)
    forgot = device_scalar(0, torch.int32, dev)

    def merge_chunk(slots, rx, dropped, forgot, recv, subj, val, ok, alloc,
                    sus):
        slot_subj, key_m, since, conf, tx = slots
        new_subj, planes, rxk, rxs, d, f = merge_into_rows(
            slot_subj, (key_m, since, conf, tx), _PLANE_DEFAULTS,
            recv, subj, val, sus, ok, alloc,
            evictable=_settled_blocks(), remembers=_remembers_blocks(),
            default_val=DEFAULT_KEY, allocate=True, rx=rx,
            alloc_budget=_ALLOC_BUDGET, amortize=amortize,
        )
        return ((new_subj, *planes), (rxk, rxs), _add_capped(dropped, d),
                _add_capped(forgot, f))

    # Gossip leg: sender blocks of B rows.
    C_g = _chunk_count(n * F * M, n)
    B = -(-n // C_g)
    pad = C_g * B - n
    tgt_p = _pad_rows(targets, pad, 0)
    pok_p = _pad_rows(packet_ok, pad, False)
    ms_p = _pad_rows(msg_subj, pad, -1)
    mk_p = _pad_rows(msg_key, pad, 0)
    mv_p = _pad_rows(msg_valid, pad, False)
    for c in range(C_g):
        tgt, pok, ms, mk, mv = (_slice_clamped(a, c * B, B)
                                for a in (tgt_p, pok_p, ms_p, mk_p, mv_p))
        rows_c = tgt.shape[0]
        recv = tgt[:, :, None].expand(rows_c, F, M).reshape(-1)
        subj = ms[:, None, :].expand(rows_c, F, M).reshape(-1)
        val = mk[:, None, :].expand(rows_c, F, M).reshape(-1)
        ok = (pok[:, :, None] & mv[:, None, :]).reshape(-1)
        slots, rx, dropped, forgot = merge_chunk(
            slots, rx, dropped, forgot, recv, subj, val, ok,
            torch.ones_like(ok), _sus_of)

    if pp is not None:
        who, pwho, sel = pp
        I = who.shape[0]
        C_p = _chunk_count(I * K, I)
        Bi = -(-I // C_p)
        padi = C_p * Bi - I
        who_p = _pad_rows(who, padi, 0)
        pwho_p = _pad_rows(pwho, padi, 0)
        sel_p = _pad_rows(sel, padi, False)
        for c in range(C_p):
            span = slice(c * Bi, (c + 1) * Bi)
            who_c, pwho_c, sel_c = who_p[span], pwho_p[span], sel_p[span]
            # Pull: the partner's rows flow to the initiator; push: the
            # initiator's rows flow to the partner.
            for src, dst in ((pwho_c, who_c), (who_c, pwho_c)):
                subj_c = slots[0][src.long()].reshape(-1)
                val_c = slots[1][src.long()].reshape(-1)
                recv_c = dst[:, None].expand(-1, K).reshape(-1)
                ok_c = sel_c[:, None].expand(-1, K).reshape(-1) & (subj_c >= 0)
                # Settled alive@inc push/pull rows merge but never allocate.
                alloc_c = key_rank(val_c) >= RANK_SUSPECT
                slots, rx, dropped, forgot = merge_chunk(
                    slots, rx, dropped, forgot, recv_c, subj_c, val_c, ok_c,
                    alloc_c, None)

    return (slots, rx[0], rx[1],
            _add_capped(overflow, torch.clamp(dropped, max=COUNTER_CAP)),
            _add_capped(forgotten, torch.clamp(forgot, max=COUNTER_CAP)))


def _view_of(slot_subj, slot_key, who: torch.Tensor, subj: torch.Tensor):
    """who's view key of subj, absent cells reading alive@0; ``who`` and
    ``subj`` broadcast together."""
    who_b, subj_b = torch.broadcast_tensors(who, subj)
    K = slot_subj.shape[1]
    slot = row_locate(slot_subj, who_b, subj_b)
    got = slot_key.reshape(-1)[who_b.long() * K + torch.clamp(slot, min=0)]
    return torch.where(slot >= 0, got, DEFAULT_KEY)


def _merge_step(cfg: SparseMembershipConfig, key_c, since_c, conf_c, tx_c,
                inc_c, aw_c, krx, srx, sslot, part, leave):
    """Refutation and the merge of one row block's deliveries (steps 3 and
    4 of the round; row-local, so the huge-table path applies it block by
    block).  Returns (key, since, confirms, tx, own_inc, awareness)."""
    base = cfg.base
    sidx = sslot.long()[:, None]
    self_rx = torch.gather(krx, 1, sidx)[:, 0]
    accused = torch.where(key_rank(self_rx) >= RANK_SUSPECT,
                          key_inc(self_rx), -1)
    refuting = part & ~leave & (accused >= inc_c)
    inc_c = torch.where(refuting, accused + 1, inc_c)
    aw_c = torch.clamp(aw_c + refuting.to(aw_c.dtype), 0,
                       base.profile.awareness_max_multiplier - 1)
    krx = krx.scatter(1, sidx, torch.full_like(sidx, -1, dtype=krx.dtype))
    self_key = torch.where(leave, make_key(inc_c, RANK_LEFT),
                           make_key(inc_c, RANK_ALIVE))
    old_key = key_c.scatter(1, sidx, torch.maximum(
        torch.gather(key_c, 1, sidx)[:, 0], self_key)[:, None])
    tx_self = torch.where(refuting, base.tx_limit,
                          torch.gather(tx_c, 1, sidx)[:, 0])
    tx_c = tx_c.scatter(1, sidx, tx_self.to(tx_c.dtype)[:, None])
    changed = krx > old_key
    confirming = (~changed & (key_rank(old_key) == RANK_SUSPECT)
                  & (srx >= key_inc(old_key)))
    new_confirms = torch.clamp(conf_c + confirming.to(conf_c.dtype),
                               max=base.confirmations_k)
    gained_conf = confirming & (new_confirms > conf_c)
    conf_c = torch.where(changed, 0, new_confirms)
    new_key = torch.maximum(old_key, krx)
    fresh_suspect = changed & (key_rank(new_key) == RANK_SUSPECT)
    # A fresh suspicion starts at age 0; any other change clears the timer.
    since_c = torch.where(fresh_suspect, 0,
                          torch.where(changed, AGE_NONE, since_c))
    tx_c = torch.where(changed | gained_conf, base.tx_limit, tx_c)
    return new_key, since_c, conf_c, tx_c, inc_c, aw_c


class SparseConstants(NamedTuple):
    """Config-only tensors a round reads, built once per study."""

    fail_tick: torch.Tensor     # int32[n]
    leave_tick: torch.Tensor    # int32[n]
    join_tick: torch.Tensor     # int32[n], all 0
    threshold: torch.Tensor     # int16[k+1]: expiry age after c confirms
    p_fail_alive: torch.Tensor  # float32 scalar


def threshold_table(base: MembershipConfig) -> torch.Tensor:
    """int16[k+1] on the CPU: the age at which a suspicion with c
    confirmations expires, clamped to AGE_CAP + 1.  The reference builds
    it from a constant ``arange``, which XLA folds without the dense
    model's fused multiply-add (``swim.timeout_table(fused=False)``): at
    LOCAL n=100, for one, the dense model expires at 61 ticks and the
    sparse one at 60."""
    thr = torch.ceil(timeout_table(base, fused=False)).to(torch.int32)
    return torch.clamp(thr, max=AGE_CAP + 1).to(SINCE_DTYPE)


def sparse_constants(cfg: SparseMembershipConfig, device) -> SparseConstants:
    base = cfg.base
    n = base.n
    return SparseConstants(
        fail_tick=_schedule_array(n, base.fail_at, NEVER, device),
        leave_tick=_schedule_array(n, base.leave_at, NEVER, device),
        join_tick=torch.zeros((n,), dtype=torch.int32, device=device),
        threshold=threshold_table(base).to(device),
        p_fail_alive=device_scalar(base.probe_fail_prob_alive, torch.float32,
                                   device),
    )


def _flat_stream(parts):
    return tuple(torch.cat([p[i] for p in parts]) for i in range(6))


def sparse_membership_round(state: SparseMembershipState,
                            key_rng: torch.Tensor,
                            cfg: SparseMembershipConfig,
                            consts: SparseConstants | None = None
                            ) -> SparseMembershipState:
    """One tick, step for step the dense round over the slot
    representation (the same draws in the same shapes at K == n)."""
    base = cfg.base
    n, fanout = base.n, base.fanout
    K = state.key.shape[1]
    M = min(base.piggyback, K)
    dev = state.key.device
    if consts is None:
        consts = sparse_constants(cfg, dev)
    amortize = cfg.amortize is not False
    t = state.tick
    (k_tie, k_tgt, k_loss, k_pp, k_ppsel, k_probe,
     k_pfail) = split(key_rng, 7).unbind(-2)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    amax = base.profile.awareness_max_multiplier - 1

    _, leaving, participates = ground_truth(
        t, consts.fail_tick, consts.leave_tick, consts.join_tick,
        base.leave_grace_ticks)

    slot_subj = state.slot_subj
    own_inc = state.own_inc
    awareness = state.awareness
    overflow = state.overflow

    occupied = slot_subj >= 0
    self_slot = row_locate(slot_subj, rows, rows)  # the self slot is pinned

    # Self-view re-stamp (leave intent).
    diag = torch.gather(state.key, 1, self_slot.long()[:, None])[:, 0]
    diag_val = torch.where(leaving, make_key(own_inc, RANK_LEFT),
                           make_key(own_inc, RANK_ALIVE))
    diag_val = torch.maximum(diag, diag_val)
    key_m = _set_cols(state.key, self_slot, torch.ones_like(leaving),
                      diag_val)
    tx = _set_cols(state.tx, self_slot, diag_val > diag, base.tx_limit)

    # -- 1. gossip ---------------------------------------------------------
    prio = (torch.where(occupied, tx.to(torch.float32), float("-inf"))
            + owned_uniform_rows(k_tie, n, K))
    sslot = top_slots(prio, M)                            # [n, M]
    msg_subj = torch.gather(slot_subj, 1, sslot)
    msg_key = torch.gather(key_m, 1, sslot)
    msg_valid = ((torch.gather(tx, 1, sslot) > 0) & (msg_subj >= 0)
                 & participates[:, None])

    targets = sample_peers(k_tgt, n, fanout)
    tgt_view = _view_of(slot_subj, key_m, rows[:, None], targets)
    tgt_sendable = key_rank(tgt_view) <= RANK_SUSPECT
    packet_ok = (participates[:, None] & tgt_sendable
                 & bernoulli_mask(k_loss, (n, fanout), 1.0 - base.loss)
                 & participates[targets.long()])

    if K < n:
        # Compacted emission: senders with a live message take one of S_b
        # slots before the [., F, M] expansion; the others spend nothing
        # and count into overflow.
        has_msg = torch.any(msg_valid, dim=1)
        sndc, sel_s, sel_mask, missed = compact_to_budget(
            has_msg, gossip_sender_budget(n))
        overflow = _add_capped(overflow, missed)
        msg_valid = msg_valid & sel_mask[:, None]
        sndc = sndc.long()
        g_targets = targets[sndc]
        g_packet_ok = packet_ok[sndc] & sel_s[:, None]
        g_msg_subj = msg_subj[sndc]
        g_msg_key = msg_key[sndc]
        g_msg_valid = msg_valid[sndc]
    else:
        g_targets, g_packet_ok = targets, packet_ok
        g_msg_subj, g_msg_key, g_msg_valid = msg_subj, msg_key, msg_valid

    # The drained slots of a row are distinct: gather, subtract, write.
    spend = torch.where(msg_valid, fanout, 0).to(tx.dtype)
    tx = tx.scatter(1, sslot, torch.gather(tx, 1, sslot) - spend)
    tx = torch.clamp(tx, min=0)

    # -- 2. push/pull ------------------------------------------------------
    pp_sel = None
    pp_full = None
    if base.push_pull_enabled:
        dead_cnt = torch.sum(occupied & (key_rank(key_m) > RANK_SUSPECT),
                             dim=1, dtype=torch.int32)
        known_cnt = n - dead_cnt  # absent slots read alive
        needs_join = participates & (known_cnt <= 1)
        initiate = participates & (
            needs_join
            | bernoulli_mask(k_pp, (n,), 1.0 / base.push_pull_ticks))
        partner = sample_probe_targets(k_ppsel, n)
        pp_ok = initiate & participates[partner.long()]
        if K < n:
            # Compacted exchange: initiators take one of I slots in index
            # order; the rest lose this tick's exchange into overflow.
            who, sel, _, missed = compact_to_budget(
                pp_ok, pp_initiator_budget(n, base.push_pull_ticks))
            overflow = _add_capped(overflow, missed)
            pp_sel = (who, partner[who.long()], sel)
        else:
            pp_full = (partner, pp_ok)

    # -- delivery ----------------------------------------------------------
    slots_in = (slot_subj, key_m, state.suspect_since, state.confirms, tx)
    if K < n and arrival_count(cfg) > _CHUNK_A:
        slots_t, key_rx, sus_rx, overflow, forgotten = _deliver_chunked(
            slots_in, g_targets, g_packet_ok, g_msg_subj, g_msg_key,
            g_msg_valid, pp_sel, n, K, overflow, state.forgotten,
            amortize=amortize)
    else:
        sg = g_targets.shape[0]
        val_g = g_msg_key[:, None, :].expand(sg, fanout, M).reshape(-1)
        parts = [(
            g_targets[:, :, None].expand(sg, fanout, M).reshape(-1),
            g_msg_subj[:, None, :].expand(sg, fanout, M).reshape(-1),
            val_g, _sus_of(val_g),
            (g_packet_ok[:, :, None] & g_msg_valid[:, None, :]).reshape(-1),
            torch.ones((sg * fanout * M,), dtype=torch.bool, device=dev),
        )]
        legs = None
        if pp_sel is not None:
            who, pwho, sel = pp_sel
            # Pull: the partner's slots flow to the initiator; push: the
            # initiator's slots flow to the partner.
            legs = ((who, pwho, sel), (pwho, who, sel))
        elif pp_full is not None:
            # Full-width exchange: the K == n mode keeps the dense shapes.
            partner, pp_ok = pp_full
            legs = ((rows, partner, pp_ok), (partner, rows, pp_ok))
        for dst, src, on in legs or ():
            subj_l = slot_subj[src.long()].reshape(-1)
            val_l = key_m[src.long()].reshape(-1)
            # Settled alive@inc rows merge into existing slots but never
            # allocate (the evict-relearn loop); suspect/dead/left news
            # stays allocation-worthy.
            parts.append((
                dst[:, None].expand(-1, K).reshape(-1), subj_l, val_l,
                torch.full_like(subj_l, -1),
                on[:, None].expand(-1, K).reshape(-1) & (subj_l >= 0),
                key_rank(val_l) >= RANK_SUSPECT,
            ))
        recv, subj, val, sus, ok, alloc = _flat_stream(parts)
        slots_t, key_rx, sus_rx, overflow, forgotten = _merge_arrivals(
            slots_in, recv, subj, val, sus, ok, alloc, n, K, overflow,
            state.forgotten, amortize=amortize)
    slot_subj, key_m, suspect_since, confirms, tx = slots_t
    # The merge re-sorts rows when it allocates: re-locate the self slot.
    self_slot = row_locate(slot_subj, rows, rows)

    # -- 3 + 4. refutation and merge, by row block on huge tables ----------
    blocks = sortmerge._row_blocks(n)
    spans = ([(0, n)] if blocks is None
             else [(b * blocks[1], blocks[1]) for b in range(blocks[0])])
    outs = None
    for start, nb in spans:
        sl = slice(start, start + nb)
        part = _merge_step(
            cfg, key_m[sl], suspect_since[sl], confirms[sl], tx[sl],
            own_inc[sl], awareness[sl], key_rx[sl], sus_rx[sl],
            self_slot[sl], participates[sl], leaving[sl])
        if blocks is None:
            outs = part
        else:
            if outs is None:
                outs = tuple(torch.empty_like(p) for p in
                             (key_m, suspect_since, confirms, tx, own_inc,
                              awareness))
            for o, p in zip(outs, part):
                o[sl] = p
    key_m, suspect_since, confirms, tx, own_inc, awareness = outs

    # -- 5. probes ---------------------------------------------------------
    if base.probe_enabled:
        is_probe_tick = (t % base.probe_interval_ticks) == 0
        ptarget = sample_probe_targets(k_probe, n)
        pt_view = _view_of(slot_subj, key_m, rows, ptarget)
        probing = (is_probe_tick & participates
                   & (key_rank(pt_view) <= RANK_SUSPECT))
        p_fail = torch.where(participates[ptarget.long()],
                             consts.p_fail_alive, 1.0)
        failed = probing & bernoulli_mask(k_pfail, (n,), p_fail)
        can_pend = failed & (state.probe_pending_at == NEVER)
        # Widen the int8 awareness before it scales tick arithmetic.
        matures_at = (t + base.probe_interval_ticks
                      + awareness.to(torch.int32) * base.probe_timeout_ticks)
        awareness = torch.clamp(
            awareness + failed.to(awareness.dtype)
            - (probing & ~failed).to(awareness.dtype), 0, amax)
        probe_pending_at = torch.where(can_pend, matures_at,
                                       state.probe_pending_at)
        probe_subject = torch.where(can_pend, ptarget, state.probe_subject)

        mature = (probe_pending_at <= t) & participates
        # Locate (or claim) the matured subject's slot.
        mslot = row_locate(slot_subj, rows, probe_subject)
        if K < n:
            slots_p, can, pos, forgot, ov = _claim_one(
                (slot_subj, key_m, suspect_since, confirms, tx),
                mature & (mslot < 0), probe_subject, amortize=amortize)
            slot_subj, key_m, suspect_since, confirms, tx = slots_p
            forgotten = _add_capped(forgotten, forgot)
            overflow = _add_capped(overflow, ov)
            # Only the claiming rows shifted; their subject sits at pos.
            mslot = torch.where(can, pos, mslot)
        mcol = torch.clamp(mslot, min=0).long()[:, None]
        mview = torch.where(mslot >= 0,
                            torch.gather(key_m, 1, mcol)[:, 0], DEFAULT_KEY)
        apply_sus = (mature & (mslot >= 0)
                     & (key_rank(mview) == RANK_ALIVE))
        sus_key = make_key(key_inc(mview), RANK_SUSPECT)
        key_m = _set_cols(key_m, mslot, apply_sus, sus_key)
        suspect_since = _set_cols(suspect_since, mslot, apply_sus, 0)
        confirms = _set_cols(confirms, mslot, apply_sus, 0)
        tx = _set_cols(tx, mslot, apply_sus, base.tx_limit)
        probe_pending_at = torch.where(mature, NEVER, probe_pending_at)
    else:
        probe_pending_at = state.probe_pending_at
        probe_subject = state.probe_subject

    # -- 6. suspicion expiry -----------------------------------------------
    # The age plane is the elapsed time and the timeout depends on the
    # confirmations alone: one small table of expiry ages.
    threshold = consts.threshold[confirms.long()]
    expire = ((key_rank(key_m) == RANK_SUSPECT) & (suspect_since >= 0)
              & (suspect_since >= threshold) & participates[:, None])
    key_m = torch.where(expire, make_key(key_inc(key_m), RANK_DEAD), key_m)
    suspect_since = torch.where(expire, AGE_NONE, suspect_since)
    tx = torch.where(expire, base.tx_limit, tx)
    # Live timers age by one tick, saturating at AGE_CAP.
    suspect_since = torch.where(
        suspect_since >= 0, torch.clamp(suspect_since + 1, max=AGE_CAP),
        suspect_since)

    return SparseMembershipState(
        slot_subj=slot_subj, key=key_m, suspect_since=suspect_since,
        confirms=confirms, tx=tx, own_inc=own_inc, awareness=awareness,
        probe_pending_at=probe_pending_at, probe_subject=probe_subject,
        overflow=overflow, forgotten=forgotten, tick=t + 1,
    )


def converged_state(cfg: SparseMembershipConfig, dead: int, tick: int = 200,
                    device=None) -> SparseMembershipState:
    """The converged state after a crash study of subject ``dead`` (the
    reference benchmark's steady state, ``bench.py:852-905``): every row
    holds itself and ``dead`` (DEAD at incarnation 0, except in its own
    row), sorted; nothing queued, no timers.  A tick from here needs no
    allocation, so it measures the steady-state path."""
    dev = resolve_device(device)
    n, K = cfg.base.n, cfg.k_slots
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    lo = torch.clamp(ids, max=dead)
    hi = torch.clamp(ids, min=dead)
    is_dead = ids == dead
    dead_key = make_key(0, RANK_DEAD)
    slot_subj = torch.full((n, K), -1, dtype=torch.int32, device=dev)
    slot_subj[:, 0] = lo
    slot_subj[:, 1] = torch.where(is_dead, -1, hi)
    key = torch.zeros((n, K), dtype=torch.int32, device=dev)
    key[:, 1] = torch.where((hi == dead) & ~is_dead, dead_key, 0)
    key[:, 0] = torch.where((lo == dead) & ~is_dead, dead_key, 0)
    state = sparse_membership_init(cfg, device=dev)
    return state._replace(slot_subj=slot_subj, key=key,
                          tick=torch.full((), tick, dtype=torch.int32,
                                          device=dev))


def densify(state: SparseMembershipState, n: int):
    """The slots as the dense int32 [n, n] planes ``(key, suspect_since,
    confirms, tx)``, scattered by subject id (so the row order does not
    matter); the age plane becomes the absolute start tick ``tick - age``."""
    dev = state.key.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    cols = state.slot_subj.long()
    flat = torch.where(cols >= 0, rows * n + cols, n * n).reshape(-1)
    age = state.suspect_since.to(torch.int32)
    since_abs = torch.where(age >= 0, state.tick - age, NEVER)
    out = []
    for plane, default in ((state.key, DEFAULT_KEY), (since_abs, NEVER),
                           (state.confirms, 0), (state.tx, 0)):
        buf = torch.full((n * n + 1,), default, dtype=torch.int32, device=dev)
        buf[flat] = plane.to(torch.int32).reshape(-1)
        out.append(buf[:n * n].reshape(n, n))
    return tuple(out)
