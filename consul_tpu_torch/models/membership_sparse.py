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

A round also runs a sweep's U universes at once: planes ``[U, n, K]`` and
``[U, n]``, ``overflow``/``forgotten``/``tick`` ``[U]``, keys ``[U, 2]``;
every budget (gossip senders, push/pull initiators, the allocation
substream, the chunk count) stays per universe, and ``base.loss`` and
``base.suspicion_scale`` may be ``[U]`` knobs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
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
    knob_column,
    make_key,
    row_of,
    table_at,
    take_rows,
    top_slots,
)
from consul_tpu_torch.models.swim import timeout_table, traced_timeout_table
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
from consul_tpu_torch.ops.knobs import col, is_knob, keep_prob

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
        if not is_knob(hi) and hi >= AGE_CAP:
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


def resolve_amortize(cfg: SparseMembershipConfig,
                     batched: bool = False) -> bool:
    """The effective dispatch of a config: an explicit ``amortize`` wins;
    None (auto) amortizes a plain scan and, for a batched sweep
    (``batched``), runs the allocation branch every tick with no host
    read, as the reference resolves it for its vmapped programs."""
    if cfg.amortize is None:
        return not batched
    return cfg.amortize


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
        row_ids = torch.arange(slot_subj.shape[-2], dtype=torch.int32,
                               device=slot_subj.device)
    return ((slot_subj >= 0) & (slot_subj != row_ids[..., None])
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
    read of ``any(want)`` for every universe).

    Returns (slots', can, pos, forgotten_delta, overflow_delta), the
    deltas per universe."""
    slot_subj, key_m, since, conf, tx = slots
    dev = slot_subj.device
    if amortize and not host_cond(torch.any(want)):
        zero = (device_scalar(0, torch.int32, dev) if want.dim() == 1
                else torch.zeros(want.shape[:-1], dtype=torch.int32,
                                 device=dev))
        return (slots, torch.zeros_like(want),
                torch.full(want.shape, -1, dtype=torch.int32, device=dev),
                zero, zero)
    new_ss, planes, can, pos, forgot = insert_rows_one(
        slot_subj, (key_m, since, conf, tx), _PLANE_DEFAULTS, want, new_subj,
        evictable=settled_of(slots, row_ids),
        remembers=(slot_subj >= 0) & (key_m != DEFAULT_KEY),
    )
    ov = torch.sum(want & ~can, dim=-1, dtype=torch.int32)
    return (new_ss, *planes), can, pos, forgot, ov


def _add_capped(counter: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(counter, max=COUNTER_CAP) + delta


def batch_row_ids(slot_subj: torch.Tensor):
    """Global node id of every row of a batched table's flattened ``[B*n,
    K]`` rows (the row index within its universe), None for an unbatched
    table (the rows are the ids)."""
    if slot_subj.dim() == 2:
        return None
    n = slot_subj.shape[-2]
    groups = slot_subj[..., 0, 0].numel()
    return torch.arange(n, dtype=torch.int32,
                        device=slot_subj.device).repeat(groups)


def _merge_arrivals(slots: tuple, recv, subj, val, sus, ok, alloc, n: int,
                    K: int, overflow, forgotten, row_ids=None,
                    amortize: bool = True, segments: int = 1):
    """The delivery pipeline on ``merge_into_rows``: only settled cells may
    be claimed, evicting one whose key is not the default counts into
    ``forgotten``, allocation-worthy news without a slot into
    ``overflow``.  ``segments``: each universe's stream is that many equal
    per-shard streams, each with its own allocation budget
    (``merge_into_rows``'s ``alloc_segments``).  Returns (slots, key_rx,
    sus_rx, overflow, forgotten); rows come back sorted, so positional
    handles must be re-derived."""
    slot_subj, key_m, since, conf, tx = slots
    if row_ids is None:
        row_ids = batch_row_ids(slot_subj)
    new_subj, planes, key_rx, sus_rx, dropped, forgot = merge_into_rows(
        slot_subj, (key_m, since, conf, tx), _PLANE_DEFAULTS,
        recv, subj, val, sus, ok, alloc,
        evictable=_settled_blocks(row_ids), remembers=_remembers_blocks(),
        default_val=DEFAULT_KEY, allocate=K < n,
        alloc_budget=_ALLOC_BUDGET, amortize=amortize,
        alloc_segments=segments,
    )
    return ((new_subj, *planes), key_rx, sus_rx,
            _add_capped(overflow, dropped), _add_capped(forgotten, forgot))


def _sus_of(v: torch.Tensor) -> torch.Tensor:
    """Suspicion incarnation carried by a gossip value, -1 for none."""
    return torch.where(key_rank(v) == RANK_SUSPECT, key_inc(v), -1)


def _slice_clamped(a: torch.Tensor, start: int, size: int,
                   dim: int = 0) -> torch.Tensor:
    """``a[start:start + size]`` along ``dim`` with ``lax.dynamic_slice``'s
    rule: a start past ``len - size`` is moved back so the slice stays
    whole."""
    start = max(0, min(start, a.shape[dim] - size))
    return a.narrow(dim, start, size)


def _pad_rows(a: torch.Tensor, pad: int, value, dim: int = 0) -> torch.Tensor:
    if not pad:
        return a
    shape = list(a.shape)
    shape[dim] = pad
    return torch.cat((a, a.new_full(shape, value)), dim=dim)


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
    F = targets.shape[-1]
    M = msg_subj.shape[-1]
    dev = targets.device
    batch = tuple(targets.shape[:-2])
    nb = len(batch)
    rx = (torch.full((*batch, n, K), -1, dtype=torch.int32, device=dev),
          torch.full((*batch, n, K), -1, dtype=torch.int32, device=dev))
    dropped = (device_scalar(0, torch.int32, dev) if not batch
               else torch.zeros(batch, dtype=torch.int32, device=dev))
    forgot = dropped.clone()
    row_ids = batch_row_ids(slots[0])

    def merge_chunk(slots, rx, dropped, forgot, recv, subj, val, ok, alloc,
                    sus):
        slot_subj, key_m, since, conf, tx = slots
        new_subj, planes, rxk, rxs, d, f = merge_into_rows(
            slot_subj, (key_m, since, conf, tx), _PLANE_DEFAULTS,
            recv, subj, val, sus, ok, alloc,
            evictable=_settled_blocks(row_ids), remembers=_remembers_blocks(),
            default_val=DEFAULT_KEY, allocate=True, rx=rx,
            alloc_budget=_ALLOC_BUDGET, amortize=amortize,
        )
        return ((new_subj, *planes), (rxk, rxs), _add_capped(dropped, d),
                _add_capped(forgot, f))

    def stream(x):
        return x.reshape(*batch, -1)

    # Gossip leg: sender blocks of B rows (of each universe).
    C_g = _chunk_count(n * F * M, n)
    B = -(-n // C_g)
    pad = C_g * B - n
    tgt_p = _pad_rows(targets, pad, 0, nb)
    pok_p = _pad_rows(packet_ok, pad, False, nb)
    ms_p = _pad_rows(msg_subj, pad, -1, nb)
    mk_p = _pad_rows(msg_key, pad, 0, nb)
    mv_p = _pad_rows(msg_valid, pad, False, nb)
    for c in range(C_g):
        tgt, pok, ms, mk, mv = (_slice_clamped(a, c * B, B, nb)
                                for a in (tgt_p, pok_p, ms_p, mk_p, mv_p))
        shape3 = (*batch, tgt.shape[nb], F, M)
        recv = stream(tgt[..., None].expand(shape3))
        subj = stream(ms[..., None, :].expand(shape3))
        val = stream(mk[..., None, :].expand(shape3))
        ok = stream(pok[..., None] & mv[..., None, :])
        slots, rx, dropped, forgot = merge_chunk(
            slots, rx, dropped, forgot, recv, subj, val, ok,
            torch.ones_like(ok), _sus_of)

    if pp is not None:
        who, pwho, sel = pp
        I = who.shape[-1]
        C_p = _chunk_count(I * K, I)
        Bi = -(-I // C_p)
        padi = C_p * Bi - I
        who_p = _pad_rows(who, padi, 0, nb)
        pwho_p = _pad_rows(pwho, padi, 0, nb)
        sel_p = _pad_rows(sel, padi, False, nb)
        for c in range(C_p):
            who_c, pwho_c, sel_c = (a.narrow(nb, c * Bi, Bi)
                                    for a in (who_p, pwho_p, sel_p))
            # Pull: the partner's rows flow to the initiator; push: the
            # initiator's rows flow to the partner.
            for src, dst in ((pwho_c, who_c), (who_c, pwho_c)):
                subj_c = stream(row_of(slots[0], src))
                val_c = stream(row_of(slots[1], src))
                recv_c = stream(dst[..., None].expand(*dst.shape, K))
                ok_c = (stream(sel_c[..., None].expand(*sel_c.shape, K))
                        & (subj_c >= 0))
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
    ``subj`` broadcast together (leading with a batched table's axes)."""
    who_b, subj_b = torch.broadcast_tensors(who, subj)
    slot = row_locate(slot_subj, who_b, subj_b)
    got = slot_key.reshape(-1)[sortmerge.row_base(slot_subj, who_b)
                               + torch.clamp(slot, min=0)]
    return torch.where(slot >= 0, got, DEFAULT_KEY)


def _merge_step(cfg: SparseMembershipConfig, key_c, since_c, conf_c, tx_c,
                inc_c, aw_c, krx, srx, sslot, part, leave):
    """Refutation and the merge of one row block's deliveries (steps 3 and
    4 of the round; row-local, so the huge-table path applies it block by
    block).  Returns (key, since, confirms, tx, own_inc, awareness)."""
    base = cfg.base
    sidx = sslot.long()[..., None]
    self_rx = torch.gather(krx, -1, sidx)[..., 0]
    accused = torch.where(key_rank(self_rx) >= RANK_SUSPECT,
                          key_inc(self_rx), -1)
    refuting = part & ~leave & (accused >= inc_c)
    inc_c = torch.where(refuting, accused + 1, inc_c)
    aw_c = torch.clamp(aw_c + refuting.to(aw_c.dtype), 0,
                       base.profile.awareness_max_multiplier - 1)
    krx = krx.scatter(-1, sidx, torch.full_like(sidx, -1, dtype=krx.dtype))
    self_key = torch.where(leave, make_key(inc_c, RANK_LEFT),
                           make_key(inc_c, RANK_ALIVE))
    old_key = key_c.scatter(-1, sidx, torch.maximum(
        torch.gather(key_c, -1, sidx)[..., 0], self_key)[..., None])
    tx_self = torch.where(refuting, base.tx_limit,
                          torch.gather(tx_c, -1, sidx)[..., 0])
    tx_c = tx_c.scatter(-1, sidx, tx_self.to(tx_c.dtype)[..., None])
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
    #                             (a swept suspicion_scale: [U, k+1])
    p_fail_alive: torch.Tensor  # float32 scalar (a swept loss: [U, 1])


def threshold_table(base: MembershipConfig) -> torch.Tensor:
    """int16[k+1] on the CPU: the age at which a suspicion with c
    confirmations expires, clamped to AGE_CAP + 1.  The reference builds
    it from a constant ``arange``, which XLA folds without the dense
    model's fused multiply-add (``swim.timeout_table(fused=False)``): at
    LOCAL n=100, for one, the dense model expires at 61 ticks and the
    sparse one at 60.  A swept ``suspicion_scale`` gives the traced
    program's ``[U, k+1]`` table (``swim.traced_timeout_table``)."""
    table = (traced_timeout_table(base) if is_knob(base.suspicion_scale)
             else timeout_table(base, fused=False))
    thr = torch.ceil(table).to(torch.int32)
    return torch.clamp(thr, max=AGE_CAP + 1).to(SINCE_DTYPE)


def sparse_constants(cfg: SparseMembershipConfig, device) -> SparseConstants:
    base = cfg.base
    n = base.n
    return SparseConstants(
        fail_tick=_schedule_array(n, base.fail_at, NEVER, device),
        leave_tick=_schedule_array(n, base.leave_at, NEVER, device),
        join_tick=torch.zeros((n,), dtype=torch.int32, device=device),
        threshold=threshold_table(base).to(device),
        p_fail_alive=knob_column(base.probe_fail_prob_alive, device),
    )


def _flat_stream(parts):
    return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(6))


class SparseGossip(NamedTuple):
    """What the first stage of a sparse tick leaves for the delivery: the
    site keys, the tick's ground truth, the re-stamped key and queue
    planes, and the gossip packets (``sslot``/``msg_subj``/``msg_key``/
    ``msg_valid`` [n, M], ``targets``/``packet_ok`` [n, F])."""

    keys: tuple
    leaving: torch.Tensor
    participates: torch.Tensor
    key_m: torch.Tensor
    tx: torch.Tensor
    sslot: torch.Tensor
    msg_subj: torch.Tensor
    msg_key: torch.Tensor
    msg_valid: torch.Tensor
    targets: torch.Tensor
    packet_ok: torch.Tensor


def sparse_gossip_stage(state: SparseMembershipState, key_rng: torch.Tensor,
                        cfg: SparseMembershipConfig,
                        consts: SparseConstants) -> SparseGossip:
    """The self-view re-stamp and the gossip packets of a tick.  Every draw
    is keyed by global node id, so the sharded twin builds the same
    packets."""
    base = cfg.base
    n, fanout = base.n, base.fanout
    K = state.key.shape[-1]
    M = min(base.piggyback, K)
    dev = state.key.device
    t = state.tick
    keys = split(key_rng, 7).unbind(-2)
    k_tie, k_tgt, k_loss = keys[:3]
    rows = node_rows(state)

    _, leaving, participates = ground_truth(
        col(t), consts.fail_tick, consts.leave_tick, consts.join_tick,
        base.leave_grace_ticks)

    slot_subj = state.slot_subj
    own_inc = state.own_inc
    occupied = slot_subj >= 0
    self_slot = row_locate(slot_subj, rows, rows)  # the self slot is pinned

    # Self-view re-stamp (leave intent).
    diag = torch.gather(state.key, -1, self_slot.long()[..., None])[..., 0]
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
    msg_subj = torch.gather(slot_subj, -1, sslot)
    msg_key = torch.gather(key_m, -1, sslot)
    msg_valid = ((torch.gather(tx, -1, sslot) > 0) & (msg_subj >= 0)
                 & participates[..., None])

    targets = sample_peers(k_tgt, n, fanout)
    tgt_view = _view_of(slot_subj, key_m, rows[..., None], targets)
    tgt_sendable = key_rank(tgt_view) <= RANK_SUSPECT
    packet_ok = (participates[..., None] & tgt_sendable
                 & bernoulli_mask(k_loss, (n, fanout),
                                  keep_prob(base.loss, 2))
                 & take_rows(participates, targets))
    return SparseGossip(keys, leaving, participates, key_m, tx, sslot,
                        msg_subj, msg_key, msg_valid, targets, packet_ok)


def sparse_spend(g: SparseGossip, msg_valid: torch.Tensor,
                 fanout: int) -> torch.Tensor:
    """The tx plane after the gossip of ``msg_valid`` (the drained slots of
    a row are distinct: gather, subtract, write)."""
    spend = torch.where(msg_valid, fanout, 0).to(g.tx.dtype)
    tx = g.tx.scatter(-1, g.sslot, torch.gather(g.tx, -1, g.sslot) - spend)
    return torch.clamp(tx, min=0)


def sparse_push_pull_draws(g: SparseGossip, slot_subj: torch.Tensor,
                           base: MembershipConfig):
    """(partner, pp_ok) of the push/pull exchange; absent slots read
    alive, so a row's known count is n minus its dead cells."""
    n = base.n
    k_pp, k_ppsel = g.keys[3:5]
    dead_cnt = torch.sum((slot_subj >= 0)
                         & (key_rank(g.key_m) > RANK_SUSPECT),
                         dim=-1, dtype=torch.int32)
    known_cnt = n - dead_cnt
    needs_join = g.participates & (known_cnt <= 1)
    initiate = g.participates & (
        needs_join | bernoulli_mask(k_pp, (n,), 1.0 / base.push_pull_ticks))
    partner = sample_probe_targets(k_ppsel, n)
    return partner, initiate & take_rows(g.participates, partner)


def node_rows(state: SparseMembershipState) -> torch.Tensor:
    """int32 ``[*B, n]``: each row's node id, with the state's batch axes
    (the row index within its universe)."""
    n = state.own_inc.shape[-1]
    rows = torch.arange(n, dtype=torch.int32, device=state.own_inc.device)
    return rows.expand(state.own_inc.shape)


def sparse_membership_round(state: SparseMembershipState,
                            key_rng: torch.Tensor,
                            cfg: SparseMembershipConfig,
                            consts: SparseConstants | None = None
                            ) -> SparseMembershipState:
    """One tick, step for step the dense round over the slot
    representation (the same draws in the same shapes at K == n)."""
    base = cfg.base
    n, fanout = base.n, base.fanout
    K = state.key.shape[-1]
    M = min(base.piggyback, K)
    dev = state.key.device
    if consts is None:
        consts = sparse_constants(cfg, dev)
    amortize = resolve_amortize(cfg)
    rows = node_rows(state)
    g = sparse_gossip_stage(state, key_rng, cfg, consts)
    slot_subj, key_m = state.slot_subj, g.key_m
    targets, packet_ok = g.targets, g.packet_ok
    msg_subj, msg_key, msg_valid = g.msg_subj, g.msg_key, g.msg_valid
    overflow = state.overflow

    if K < n:
        # Compacted emission: senders with a live message take one of S_b
        # slots before the [., F, M] expansion; the others spend nothing
        # and count into overflow.
        has_msg = torch.any(msg_valid, dim=-1)
        sndc, sel_s, sel_mask, missed = compact_to_budget(
            has_msg, gossip_sender_budget(n))
        overflow = _add_capped(overflow, missed)
        msg_valid = msg_valid & sel_mask[..., None]
        g_targets = row_of(targets, sndc)
        g_packet_ok = row_of(packet_ok, sndc) & sel_s[..., None]
        g_msg_subj = row_of(msg_subj, sndc)
        g_msg_key = row_of(msg_key, sndc)
        g_msg_valid = row_of(msg_valid, sndc)
    else:
        g_targets, g_packet_ok = targets, packet_ok
        g_msg_subj, g_msg_key, g_msg_valid = msg_subj, msg_key, msg_valid
    tx = sparse_spend(g, msg_valid, fanout)

    # -- 2. push/pull ------------------------------------------------------
    pp_sel = None
    pp_full = None
    if base.push_pull_enabled:
        partner, pp_ok = sparse_push_pull_draws(g, slot_subj, base)
        if K < n:
            # Compacted exchange: initiators take one of I slots in index
            # order; the rest lose this tick's exchange into overflow.
            who, sel, _, missed = compact_to_budget(
                pp_ok, pp_initiator_budget(n, base.push_pull_ticks))
            overflow = _add_capped(overflow, missed)
            pp_sel = (who, take_rows(partner, who), sel)
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
        batch = tuple(g_targets.shape[:-2])
        shape3 = (*batch, g_targets.shape[-2], fanout, M)

        def stream(x):
            return x.reshape(*batch, -1)

        val_g = stream(g_msg_key[..., None, :].expand(shape3))
        parts = [(
            stream(g_targets[..., None].expand(shape3)),
            stream(g_msg_subj[..., None, :].expand(shape3)),
            val_g, _sus_of(val_g),
            stream(g_packet_ok[..., None] & g_msg_valid[..., None, :]),
            torch.ones(val_g.shape, dtype=torch.bool, device=dev),
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
            parts.append(push_pull_leg(slot_subj, key_m, dst, src, on))
        recv, subj, val, sus, ok, alloc = _flat_stream(parts)
        slots_t, key_rx, sus_rx, overflow, forgotten = _merge_arrivals(
            slots_in, recv, subj, val, sus, ok, alloc, n, K, overflow,
            state.forgotten, amortize=amortize)
    return sparse_finish_round(state, g, slots_t, key_rx, sus_rx, overflow,
                               forgotten, cfg, consts)


def push_pull_leg(slot_subj: torch.Tensor, key_m: torch.Tensor,
                  dst: torch.Tensor, src: torch.Tensor, on: torch.Tensor):
    """One push/pull leg as an arrival stream ``(recv, subj, val, sus, ok,
    alloc)``: row ``src[i]``'s slots flow to ``dst[i]`` where ``on[i]``.
    Settled alive@inc rows merge into existing slots but never allocate
    (the evict-relearn loop); suspect/dead/left news stays
    allocation-worthy.  Leading dimensions of ``dst``/``src``/``on`` are
    kept (a batched table's universes, then the sharded plane's shards),
    the slots flattened after them."""
    K = slot_subj.shape[-1]
    subj_l = row_of(slot_subj, src).flatten(-2)
    val_l = row_of(key_m, src).flatten(-2)
    return (dst[..., None].expand(*dst.shape, K).flatten(-2), subj_l, val_l,
            torch.full_like(subj_l, -1),
            on[..., None].expand(*on.shape, K).flatten(-2) & (subj_l >= 0),
            key_rank(val_l) >= RANK_SUSPECT)


def sparse_finish_round(state: SparseMembershipState, g: SparseGossip,
                        slots_t: tuple, key_rx: torch.Tensor,
                        sus_rx: torch.Tensor, overflow: torch.Tensor,
                        forgotten: torch.Tensor,
                        cfg: SparseMembershipConfig,
                        consts: SparseConstants) -> SparseMembershipState:
    """Refutation and merge of the delivered ``key_rx``/``sus_rx`` into the
    merged slot table ``slots_t``, the probe plane (with its slot claim)
    and suspicion expiry: steps 3-6 of the round."""
    base = cfg.base
    n = base.n
    K = state.key.shape[-1]
    dev = state.key.device
    amortize = resolve_amortize(cfg)
    t = state.tick
    k_probe, k_pfail = g.keys[5:7]
    rows = node_rows(state)
    amax = base.profile.awareness_max_multiplier - 1
    participates, leaving = g.participates, g.leaving
    slot_subj, key_m, suspect_since, confirms, tx = slots_t
    own_inc = state.own_inc
    awareness = state.awareness
    # The merge re-sorts rows when it allocates: re-locate the self slot.
    self_slot = row_locate(slot_subj, rows, rows)

    # -- 3 + 4. refutation and merge, by row block on huge tables ----------
    ax = rows.dim() - 1                                    # the node axis
    blocks = sortmerge._row_blocks(n)
    spans = ([(0, n)] if blocks is None
             else [(b * blocks[1], blocks[1]) for b in range(blocks[0])])
    outs = None
    for start, nb in spans:
        part = _merge_step(cfg, *(
            p.narrow(ax, start, nb) for p in (
                key_m, suspect_since, confirms, tx, own_inc, awareness,
                key_rx, sus_rx, self_slot, participates, leaving)))
        if blocks is None:
            outs = part
        else:
            if outs is None:
                outs = tuple(torch.empty_like(p) for p in
                             (key_m, suspect_since, confirms, tx, own_inc,
                              awareness))
            for o, p in zip(outs, part):
                o.narrow(ax, start, nb).copy_(p)
    key_m, suspect_since, confirms, tx, own_inc, awareness = outs

    # -- 5. probes ---------------------------------------------------------
    if base.probe_enabled:
        is_probe_tick = col((t % base.probe_interval_ticks) == 0)
        ptarget = sample_probe_targets(k_probe, n)
        pt_view = _view_of(slot_subj, key_m, rows, ptarget)
        probing = (is_probe_tick & participates
                   & (key_rank(pt_view) <= RANK_SUSPECT))
        p_fail = torch.where(take_rows(participates, ptarget),
                             consts.p_fail_alive, 1.0)
        failed = probing & bernoulli_mask(k_pfail, (n,), p_fail)
        can_pend = failed & (state.probe_pending_at == NEVER)
        # Widen the int8 awareness before it scales tick arithmetic.
        matures_at = (col(t) + base.probe_interval_ticks
                      + awareness.to(torch.int32) * base.probe_timeout_ticks)
        awareness = torch.clamp(
            awareness + failed.to(awareness.dtype)
            - (probing & ~failed).to(awareness.dtype), 0, amax)
        probe_pending_at = torch.where(can_pend, matures_at,
                                       state.probe_pending_at)
        probe_subject = torch.where(can_pend, ptarget, state.probe_subject)

        mature = (probe_pending_at <= col(t)) & participates
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
        mcol = torch.clamp(mslot, min=0).long()[..., None]
        mview = torch.where(mslot >= 0,
                            torch.gather(key_m, -1, mcol)[..., 0], DEFAULT_KEY)
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
    threshold = table_at(consts.threshold, confirms)
    expire = ((key_rank(key_m) == RANK_SUSPECT) & (suspect_since >= 0)
              & (suspect_since >= threshold) & participates[..., None])
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


def n_squared(n: int, device) -> torch.Tensor:
    """float32 ``f32(n) * n``, the known-members gauge's full count."""
    return torch.full((), float(np.float32(n) * np.float32(n)),
                      dtype=torch.float32, device=device)


def sparse_membership_counts(state: SparseMembershipState,
                             track_idx: torch.Tensor, n_sq: torch.Tensor,
                             n_shards: int = 1):
    """A sparse tick's outputs, matched by subject id (so they do not
    depend on the row order): for each tracked subject the slots holding
    it SUSPECT / DEAD (int32[S] each, empty without tracked subjects), the
    suspect slots (int32), and the float32 gauge ``n_sq - dead_cells``.
    Over ``n_shards`` row blocks the dead cells are summed per block, then
    across blocks, as the sharded reference's ``psum`` does.  A batched
    state gives each output per universe."""
    ranks = key_rank(state.key)
    batch = tuple(ranks.shape[:-2])
    cells = (-2, -1)
    if track_idx.numel():
        hit = state.slot_subj[..., None] == track_idx
        sus_t = torch.sum(hit & (ranks == RANK_SUSPECT)[..., None],
                          dim=(-3, -2), dtype=torch.int32)
        dead_t = torch.sum(hit & (ranks == RANK_DEAD)[..., None],
                           dim=(-3, -2), dtype=torch.int32)
    else:
        sus_t = dead_t = torch.zeros((*batch, 0), dtype=torch.int32,
                                     device=ranks.device)
    occupied = state.slot_subj >= 0
    dead = occupied & (ranks > RANK_SUSPECT)
    if n_shards == 1:
        dead_cells = torch.sum(dead, dim=cells, dtype=torch.float32)
    else:
        dead_cells = torch.sum(torch.sum(dead.view(*batch, n_shards, -1),
                                         dim=-1, dtype=torch.float32), dim=-1)
    return (sus_t, dead_t,
            torch.sum(occupied & (ranks == RANK_SUSPECT), dim=cells,
                      dtype=torch.int32),
            n_sq - dead_cells)


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
