"""Sort-merge delivery into sorted slot rows (the port of
``consul_tpu/ops/sortmerge.py``).

The sparse membership model lands every tick's (receiver, subject,
value) arrival stream in each receiver's K-slot table.  Every row of the
table stays sorted ascending by subject id, empty slots (-1) last: the
*sorted-row invariant*.  So an arrival finds its slot by a per-row
binary search (:func:`row_locate`), duplicates collapse after a lex-sort
by (receiver, subject) and a segmented max, and unseated subjects claim
slots by their rank within the receiver's segment.

:func:`merge_into_rows` is the amortized tick: seated deliveries land as
one scatter-max, and the allocation machinery runs only when some
arrival needs a slot.  The reference branches with ``lax.cond`` on that
device predicate; here :func:`host_cond` reads it on the host, one
device-to-host synchronisation per call, counted in ``host_cond.syncs``.
``amortize=False`` runs the allocation branch unconditionally, with the
same results and no synchronisation.

Translations from XLA that matter for bit-equality:
  * ``lax.sort((r, s, idx), num_keys=2)`` is one stable ``torch.sort`` of
    the int64 key ``r * (n + 1) + s`` carrying the permutation;
  * ``lax.associative_scan``'s segmented max becomes a group max
    (``scatter_reduce("amax")`` by segment id) read back at every
    position: the callers read only a segment's last position, where the
    two agree;
  * ``mode="drop"`` scatters write into one sentinel slot past the end,
    sliced off; a boolean OR-scatter is ``index_fill_`` of True.

A table may carry leading batch axes ``[*B, n, K]`` (a sweep's U
universes, each its own table): arrivals and queries then carry the same
leading axes and address rows ``0..n-1`` of their own universe.  The
batched calls run as one call over the ``[B*n, K]`` rows, every budget
per universe, and return per-universe counts ``[*B]``.
"""

from __future__ import annotations

import torch

from consul_tpu_torch.ops.compact import compact_to_budget

_SUBJ_MAX = 2 ** 31 - 1  # empty-slot sort sentinel

# Row-block ceiling for the huge-table claim construction in
# merge_into_rows: tables with more rows than this rebuild block by
# block, so the eviction masks never materialise whole.
_BLOCK_ROWS = 1 << 21


def host_cond(pred: torch.Tensor) -> bool:
    """The eager form of ``lax.cond``'s dispatch: read a device boolean on
    the host (one synchronisation, counted in ``host_cond.syncs``).

    While a program's tick is traced (``analysis/graph.py``), a fake
    tensor has no value to read: ``host_cond.override`` then records the
    sync as a node of the graph and names the branch the trace takes.
    Outside a trace it is None, and the cost is that one check."""
    if host_cond.override is not None:
        return host_cond.override(pred)
    host_cond.syncs += 1
    # The one read itself: PERF.md section 2's allowed syncs.
    return bool(pred)  # tracelint: disable=R2 (the counted host read)


host_cond.syncs = 0
host_cond.override = None


def _row_blocks(n: int):
    """(R, block_rows) splitting ``n`` rows into R equal blocks of at
    most ``_BLOCK_ROWS`` each, or None when the table is small enough
    (or has no suitable divisor)."""
    if n <= _BLOCK_ROWS:
        return None
    r_min = -(-n // _BLOCK_ROWS)
    for r in range(r_min, min(n, 4096) + 1):
        if n % r == 0:
            return r, n // r
    return None


def _col_dtype(K: int) -> torch.dtype:
    """Column-count temps: int8 while they hold values <= K <= 126."""
    return torch.int8 if K <= 126 else torch.int16


def _fill(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def _with_sentinel(flat: torch.Tensor, value) -> torch.Tensor:
    """``flat`` plus one trailing slot for dropped writes."""
    return torch.cat((flat, flat.new_full((1,), value)))


def sort_slot_rows(slot_subj: torch.Tensor, *planes: torch.Tensor):
    """Sort each row of ``slot_subj`` ascending by subject id, empty slots
    (-1) last, and apply the same permutation to every companion plane.
    Returns ``(slot_subj, *planes)`` sorted."""
    keyed = torch.where(slot_subj < 0, _SUBJ_MAX, slot_subj)
    order = torch.sort(keyed, dim=-1, stable=True).indices
    return tuple(torch.gather(p, -1, order) for p in (slot_subj, *planes))


def row_base(slot_subj: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """int64 flat index of the first cell of receiver ``recv``'s row in
    ``slot_subj.reshape(-1)``: ``recv`` (clamped into the table) carries
    the table's batch axes leading and indexes its own universe's rows."""
    n, K = slot_subj.shape[-2:]
    base = torch.clamp(recv.long(), 0, n - 1) * K
    nb = slot_subj.dim() - 2
    if nb:
        g = torch.arange(slot_subj[..., 0, 0].numel(), dtype=torch.int64,
                         device=recv.device)
        base = base + (g * (n * K)).reshape(
            *slot_subj.shape[:nb], *([1] * (recv.dim() - nb)))
    return base


def row_locate_lo(slot_subj: torch.Tensor, recv: torch.Tensor,
                  subj: torch.Tensor):
    """(slot, lo) of ``subj`` in receiver ``recv``'s sorted row: the slot
    index (-1 when absent) and the binary search's insertion point ``lo``
    (the number of subjects in the row below ``subj``), both int32.
    ``recv`` and ``subj`` broadcast together; for a batched table the
    broadcast shape leads with its batch axes."""
    K = slot_subj.shape[-1]
    recv, subj = torch.broadcast_tensors(recv, subj)
    flat = torch.where(slot_subj < 0, _SUBJ_MAX, slot_subj).reshape(-1)
    base = row_base(slot_subj, recv)
    q = subj.to(torch.int32)
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, K, dtype=torch.int32, device=q.device)
    for _ in range(max(1, (K - 1).bit_length() + 1)):
        mid = (lo + hi) >> 1
        v = flat[base + torch.clamp(mid, max=K - 1)]
        # mid < hi stops a converged search on a full row from walking
        # lo past K.
        go_right = (v < q) & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    found = (lo < K) & (flat[base + torch.clamp(lo, max=K - 1)] == q)
    return torch.where(found, lo, -1), lo


def row_locate(slot_subj: torch.Tensor, recv: torch.Tensor,
               subj: torch.Tensor) -> torch.Tensor:
    """Slot index of ``subj`` in receiver ``recv``'s sorted row, -1 when
    absent."""
    return row_locate_lo(slot_subj, recv, subj)[0]


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


def _segmented_max3(flags: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    z: torch.Tensor):
    """Segmented max of three 1-D arrays sharing one segment structure
    (segments start where ``flags`` is True; ``flags[0]`` is True).

    Each position gets its whole segment's max.  The reference's
    associative scan gives the prefix max instead; the two agree at a
    segment's last position, the only one its callers read."""
    gid = torch.clamp(torch.cumsum(flags, 0, dtype=torch.int64) - 1, min=0)
    out = []
    for a in (x, y, z):
        g = torch.zeros_like(a).scatter_reduce(0, gid, a, "amax",
                                               include_self=False)
        out.append(g[gid])
    return tuple(out)


def _lexsort2(r: torch.Tensor, s: torch.Tensor, n: int):
    """Stable sort by (r, s), both in [0, n]: returns (r, s, perm)."""
    key = r.long() * (n + 1) + s.long()
    perm = torch.sort(key, stable=True).indices
    return r[perm], s[perm], perm


def _first_of_group(r: torch.Tensor, s: torch.Tensor):
    """(first, rstart, idx) of a lex-sorted stream: where each (r, s)
    group and each r segment starts."""
    m = r.shape[0]
    idx = torch.arange(m, dtype=torch.int64, device=r.device)
    new_r = r != torch.roll(r, 1)
    first = (idx == 0) | new_r | (s != torch.roll(s, 1))
    return first, (idx == 0) | new_r, idx


def _last_of_group(first: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.roll(first, -1) | (idx == first.shape[0] - 1)


def merge_deliveries(
    slot_subj: torch.Tensor,
    recv: torch.Tensor, subj: torch.Tensor, val: torch.Tensor,
    sus: torch.Tensor, ok: torch.Tensor, alloc: torch.Tensor,
    *,
    evictable: torch.Tensor, remembers: torch.Tensor,
    default_val: int, allocate: bool,
):
    """Sort-merge one arrival stream into the slot table: the full-sort
    path, which :func:`merge_into_rows` equals after a claimed-plane reset
    and :func:`sort_slot_rows`.

    Arguments (A = stream length, [n, K] = slot table): int32[A]
    ``recv``/``subj``/``val``/``sus`` (receiver, subject, precedence
    value, suspicion incarnation or -1); bool[A] ``ok`` (delivered) and
    ``alloc`` (may claim a slot); bool[n, K] ``evictable`` and
    ``remembers``; ``default_val`` (only news above it justifies
    allocation); ``allocate`` (run the allocation stage at all).

    Returns ``(new_slot_subj, claimed, key_rx, sus_rx, dropped,
    forgot)``: the post-claim table (rows not re-sorted), the claim mask,
    the per-slot maxima of delivered values and suspicion incarnations
    (-1 where nothing landed), and the counts of dropped allocation-worthy
    groups and of remembered cells lost to eviction."""
    n, K = slot_subj.shape
    nk = n * K
    dev = slot_subj.device
    r = torch.where(ok, recv.to(torch.int32), n)
    s = torch.where(ok, subj.to(torch.int32), n)
    r, s, perm = _lexsort2(r, s, n)
    valid = r < n
    val32 = val.to(torch.int32)[perm]
    v = torch.where(valid, val32, -1)
    su = torch.where(valid, sus.to(torch.int32)[perm], -1)
    el = valid & alloc[perm] & (val32 > default_val)

    first, rstart, idx = _first_of_group(r, s)
    v_max, su_max, el_any = _segmented_max3(first, v, su,
                                            el.to(torch.int32))
    rep = _last_of_group(first, idx) & valid

    slot = row_locate(slot_subj, r, s)
    located = rep & (slot >= 0)
    rc = torch.clamp(r.long(), 0, n - 1)

    if allocate:
        needs = rep & (slot < 0) & (el_any > 0)
        needs_i = needs.to(torch.int32)
        rank = _segmented_sum(rstart, needs_i) - needs_i
        cols = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
        cls = torch.where(slot_subj < 0, 0,
                          torch.where(evictable, 1, 2)).to(torch.int32)
        order = torch.argsort(cls * K + cols, dim=1)
        n_claim = torch.sum(cls < 2, dim=1, dtype=torch.int32)

        can = needs & (rank < n_claim[rc])
        chosen = order.reshape(-1)[rc * K + torch.clamp(rank, max=K - 1)]
        tgt = torch.where(can, rc * K + chosen, nk)
        new_slot_subj = _with_sentinel(slot_subj.reshape(-1), -1).scatter(
            0, tgt, s)[:nk].reshape(n, K)
        claimed = torch.zeros(nk + 1, dtype=torch.bool, device=dev)
        claimed = claimed.index_fill_(0, tgt, True)[:nk].reshape(n, K)
        forgot = torch.sum(
            can & remembers.reshape(-1)[torch.clamp(tgt, max=nk - 1)],
            dtype=torch.int32)
        # A seated subject whose slot was just claimed lost its cell this
        # tick: its news drops (and counts, when it could have allocated).
        evicted = located & claimed.reshape(-1)[
            rc * K + torch.clamp(slot, min=0)]
        dropped = (torch.sum(needs & ~can, dtype=torch.int32)
                   + torch.sum(evicted & (el_any > 0), dtype=torch.int32))
        deliver = (located & ~evicted) | can
        final_slot = torch.where(can, chosen, slot.long())
    else:
        new_slot_subj = slot_subj
        claimed = torch.zeros((n, K), dtype=torch.bool, device=dev)
        forgot = _fill(0, torch.int32, dev)
        dropped = torch.sum(rep & (slot < 0) & (el_any > 0),
                            dtype=torch.int32)
        deliver = located
        final_slot = slot.long()

    flat = torch.where(deliver, rc * K + final_slot, nk)
    key_rx, sus_rx = _rx_scatter(flat, v_max, su_max, n, K)
    return new_slot_subj, claimed, key_rx, sus_rx, dropped, forgot


def _rx_scatter(flat: torch.Tensor, v: torch.Tensor, su: torch.Tensor,
                n: int, K: int, rx: tuple = None):
    """Scatter-max ``v``/``su`` at flat cell ``flat`` (n*K drops) into
    fresh -1 planes, or into the accumulators ``rx``."""
    out = []
    for i, a in enumerate((v, su)):
        base = (torch.full((n * K,), -1, dtype=torch.int32, device=a.device)
                if rx is None else rx[i].reshape(-1))
        buf = _with_sentinel(base, -1).scatter_reduce(
            0, flat, a, "amax", include_self=True)
        out.append(buf[:n * K].reshape(n, K))
    return tuple(out)


def _mask(m, ss, pl, n: int, start=None, rows_=None):
    """An eviction-policy mask for rows [start, start+rows_) (the whole
    table when ``start`` is None): ``m`` is an array or a callable
    ``(slot_subj, planes, start, rows)``."""
    if callable(m):
        return m(ss, pl, start, n if rows_ is None else rows_)
    if start is None:
        return m
    return m[start:start + rows_]


def merge_into_rows(
    slot_subj: torch.Tensor, planes: tuple, defaults: tuple,
    recv: torch.Tensor, subj: torch.Tensor, val: torch.Tensor, sus,
    ok: torch.Tensor, alloc: torch.Tensor,
    *,
    evictable, remembers,
    default_val: int, allocate: bool,
    rx: tuple = None,
    alloc_budget: int = None,
    amortize: bool = True,
    alloc_segments: int = 1,
):
    """The amortized sort-merge tick: locate every arrival once,
    scatter-max every seated delivery, and, when some arrival needs a slot,
    compact the unseated arrivals into an ``alloc_budget``-entry
    substream (None = exact), lex-sort and dedup it, claim slots and
    restore the sorted-row invariant by a direct-position merge.

    Arguments are :func:`merge_deliveries`'s plus the companion
    ``planes`` (permuted with ``slot_subj``) and their ``defaults`` (what
    an empty or freshly claimed cell holds).  ``evictable``/``remembers``
    are arrays or callables ``(slot_subj, planes, start, rows)`` evaluated
    only on allocation; ``sus`` is an array, a callable of ``val``, or
    None (all -1); ``rx`` optional (key_rx, sus_rx) accumulators that ride
    the claim permutation like any companion plane.

    ``amortize`` selects the dispatch: True reads the predicate "does any
    arrival need a slot?" on the host (:func:`host_cond`) and skips the
    allocation machinery when it is false; False runs it always, with the
    same results.

    ``alloc_segments`` cuts the stream into that many equal segments,
    each compacted into its own ``alloc_budget`` substream: the sharded
    plane merges its D shards' streams (disjoint row blocks, each
    shard's stream one segment) in one call, exactly as D calls would,
    behind one host read of "does any shard need a slot?".

    A batched table ``[*B, n, K]`` takes streams ``[*B, A]``: each
    universe's stream is ``alloc_segments`` segments of its own, the
    predicate is read once for all universes, and ``dropped``/``forgot``
    come back per universe ``[*B]``.  Array masks are ``[*B, n, K]``; a
    callable mask sees the flattened ``[B*n, K]`` rows.

    Returns ``(slot_subj', planes', key_rx, sus_rx, dropped, forgot)``
    with rows sorted and the rx planes at their final columns.  Never
    writes into its arguments.  Its kernels run inside the profiler range
    ``sortmerge.merge_into_rows``."""
    with torch.profiler.record_function("sortmerge.merge_into_rows"):
        batch = tuple(slot_subj.shape[:-2])
        if not batch:
            return _merge_into_rows(
                slot_subj, planes, defaults, recv, subj, val, sus, ok, alloc,
                evictable, remembers, default_val, allocate, rx,
                alloc_budget, amortize, alloc_segments, None)
        n, K = slot_subj.shape[-2:]
        groups = slot_subj[..., 0, 0].numel()

        def rows2(x):
            return x.reshape(groups * n, K)

        def flat(x):
            return x.reshape(-1)

        g = torch.arange(groups, dtype=torch.int64,
                         device=recv.device).reshape(*batch, 1)
        recv_f = flat(recv.long() + g * n).to(recv.dtype)
        sus_f = flat(sus) if isinstance(sus, torch.Tensor) else sus
        masks = tuple(m if callable(m) else rows2(m)
                      for m in (evictable, remembers))
        out = _merge_into_rows(
            rows2(slot_subj), tuple(rows2(p) for p in planes), defaults,
            recv_f, flat(subj), flat(val), sus_f, flat(ok), flat(alloc),
            *masks, default_val, allocate,
            None if rx is None else tuple(rows2(r) for r in rx),
            alloc_budget, amortize, alloc_segments * groups, groups)
        new_subj, new_planes, key_rx, sus_rx, dropped, forgot = out
        shape = slot_subj.shape
        return (new_subj.view(shape), tuple(p.view(shape) for p in new_planes),
                key_rx.view(shape), sus_rx.view(shape), dropped.view(batch),
                forgot.view(batch))


def _group_sum(mask: torch.Tensor, rows: torch.Tensor, groups, n: int):
    """int32 count of ``mask`` per group of ``n // groups`` table rows
    (``rows`` the row of each entry): ``[groups]``, or 0-dim when
    ``groups`` is None (an unbatched table)."""
    if groups is None:
        return torch.sum(mask, dtype=torch.int32)
    gid = torch.where(mask, rows.long() // (n // groups), groups)
    return torch.zeros(groups + 1, dtype=torch.int32,
                       device=mask.device).scatter_add_(
        0, gid.reshape(-1), torch.ones_like(gid, dtype=torch.int32)
        .reshape(-1))[:groups]


def _seg_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """int32 sum of ``x`` over each of ``groups`` equal contiguous parts
    (the whole, 0-dim, when ``groups`` is None)."""
    if groups is None:
        return torch.sum(x, dtype=torch.int32)
    return torch.sum(x.reshape(groups, -1), dim=1, dtype=torch.int32)


def _merge_into_rows(slot_subj, planes, defaults, recv, subj, val, sus, ok,
                     alloc, evictable, remembers, default_val, allocate, rx,
                     alloc_budget, amortize, alloc_segments, groups):
    n, K = slot_subj.shape
    A = recv.shape[0]
    dev = slot_subj.device
    rc0 = torch.clamp(recv.long(), 0, n - 1)
    slot0, lo0 = row_locate_lo(slot_subj, recv, subj)
    val32 = val.to(torch.int32)
    el0 = ok & alloc & (val32 > default_val)
    # The substream compacts every UNSEATED delivered arrival (non-worthy
    # duplicates still count toward a claimed group's value max); the
    # allocation branch runs only when a claim might happen.
    unseated = ok & (slot0 < 0)
    need_any = torch.any(el0 & unseated)
    if A % alloc_segments:
        raise ValueError(f"{A} arrivals do not cut into {alloc_segments} "
                         "equal segments")
    A_seg = A // alloc_segments
    B = A_seg if alloc_budget is None else max(1, min(A_seg, alloc_budget))

    if sus is None:
        susv = torch.full((A,), -1, dtype=torch.int32, device=dev)
    else:
        susv = (sus(val) if callable(sus) else sus).to(torch.int32)

    # Seated deliveries land every tick as one raw scatter-max (the group
    # max equals the raw max over its members).
    flat0 = torch.where(ok & (slot0 >= 0), rc0 * K + slot0, n * K)
    key_rx0, sus_rx0 = _rx_scatter(flat0, val32, susv, n, K, rx)

    if amortize and not host_cond(need_any):
        zero = (_fill(0, torch.int32, dev) if groups is None
                else torch.zeros(groups, dtype=torch.int32, device=dev))
        return slot_subj, tuple(planes), key_rx0, sus_rx0, zero, zero
    return _allocate_and_merge(
        slot_subj, tuple(planes), defaults, key_rx0, sus_rx0, recv, subj,
        val32, susv, lo0, el0, flat0, unseated, evictable, remembers,
        allocate, B, alloc_segments, groups)


def _allocate_and_merge(slot_subj, planes, defaults, rxk0, rxs0, recv, subj,
                        val32, susv, lo0, el0, flat0, uns, evictable,
                        remembers, allocate, B, segments, groups):
    """The allocation branch of :func:`merge_into_rows`."""
    n, K = slot_subj.shape
    nk = n * K
    dev = slot_subj.device
    # Prioritised admission: allocation-worthy arrivals take the first
    # positions in stream order, the rest queue behind them; worthy
    # arrivals past the budget count into ``dropped``.  Each segment
    # compacts into its own B slots.
    a_seg = uns.shape[0] // segments
    gi, taken, kept, _ = compact_to_budget(
        uns.view(segments, a_seg), B, first=el0.view(segments, a_seg))
    missed = (_seg_sum(el0 & uns, groups)
              - _seg_sum(kept.reshape(-1) & el0, groups))
    seg0 = torch.arange(segments, dtype=torch.int64, device=dev) * a_seg
    gi = (gi.long() + seg0[:, None]).reshape(-1)
    taken = taken.reshape(-1)
    r = torch.where(taken, recv.to(torch.int32)[gi], n)
    s = torch.where(taken, subj.to(torch.int32)[gi], n)
    r, s, perm = _lexsort2(r, s, n)
    valid = r < n
    gs = gi[perm]
    v = torch.where(valid, val32[gs], -1)
    su = torch.where(valid, susv[gs], -1)
    el = valid & el0[gs]
    lo = torch.where(valid, lo0[gs], 0)
    first, rstart, idx = _first_of_group(r, s)
    v_max, su_max, el_any = _segmented_max3(first, v, su,
                                            el.to(torch.int32))
    rep = _last_of_group(first, idx) & valid
    needs = rep & (el_any > 0)
    rc = torch.clamp(r.long(), 0, n - 1)

    if not allocate:
        dropped = missed + _group_sum(needs, rc, groups, n)
        return (slot_subj, planes, rxk0, rxs0, dropped,
                torch.zeros_like(dropped))

    rows = torch.arange(n, dtype=torch.int64, device=dev)
    cols = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
    needs_i = needs.to(torch.int32)
    rank = _segmented_sum(rstart, needs_i) - needs_i

    # Claim order without an argsort: under the invariant the empties are
    # the row tail, so claim j is column K - E + j for j < E, else the
    # (j - E)-th evictable column.
    cdt = _col_dtype(K)
    cols_c = cols.to(cdt).expand(n, K)
    blocks = _row_blocks(n)
    settled_cols = torch.empty((n, K), dtype=cdt, device=dev)
    E = torch.empty(n, dtype=torch.int32, device=dev)
    n_settled = torch.empty(n, dtype=torch.int32, device=dev)
    spans = ([(0, n)] if blocks is None
             else [(b * blocks[1], blocks[1]) for b in range(blocks[0])])
    for start, nb in spans:
        ss_b = slot_subj[start:start + nb]
        part = None if blocks is None else start
        set_b = _mask(evictable, slot_subj, planes, n, part, nb) & (ss_b >= 0)
        E[start:start + nb] = torch.sum(ss_b < 0, dim=1, dtype=torch.int32)
        n_settled[start:start + nb] = torch.sum(set_b, dim=1,
                                                dtype=torch.int32)
        scnt = torch.cumsum(set_b, dim=1, dtype=cdt) - set_b.to(cdt)
        # settled_cols[i, j] = column of row i's j-th settled slot; the
        # other cells dump into the sliced-off column K.
        rows_b = torch.arange(nb, dtype=torch.int64, device=dev)[:, None]
        sc_t = (rows_b * (K + 1)
                + torch.where(set_b, scnt.long(), K)).reshape(-1)
        sc = torch.full((nb * (K + 1),), K, dtype=cdt, device=dev).scatter(
            0, sc_t, cols_c[:nb].reshape(-1))
        settled_cols[start:start + nb] = sc.reshape(nb, K + 1)[:, :K]
    n_claim = E + n_settled

    e_rc = E[rc]
    can = needs & (rank < n_claim[rc])
    chosen = torch.where(
        rank < e_rc,
        (K - e_rc) + torch.clamp(rank, max=K - 1),
        settled_cols[rc, torch.clamp(rank - e_rc, 0, K - 1).long()]
        .to(torch.int32),
    )
    tgt = torch.where(can, rc * K + torch.clamp(chosen, 0, K - 1), nk)
    claimed = torch.zeros(nk + 1, dtype=torch.bool, device=dev)
    claimed = claimed.index_fill_(0, tgt, True)[:nk].reshape(n, K)
    forgot = _group_sum(
        can & _mask(remembers, slot_subj, planes, n).reshape(-1)[
            torch.clamp(tgt, max=nk - 1)], rc, groups, n)
    # A seated group whose cell was just claimed loses its news with the
    # cell; it counts into dropped when some member could have allocated
    # (an OR over the el bit of the seated deliveries of each cell).
    el_rx = torch.zeros(nk + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(el0, flat0, nk), True)[:nk].reshape(n, K)
    dropped = (missed
               + _group_sum(needs & ~can, rc, groups, n)
               + _seg_sum(claimed & (slot_subj >= 0) & el_rx, groups))

    # Direct-position merge: survivors and the rank-ordered claims are two
    # sorted sequences per row, so each cell's final column is its own
    # column plus (#claims inserted at or before it) minus (#evictions
    # strictly before it).
    ev_real = claimed & (slot_subj >= 0)
    evc = torch.cat((torch.zeros((n, 1), dtype=cdt, device=dev),
                     torch.cumsum(ev_real, dim=1, dtype=cdt)), dim=1)
    lo_t = torch.where(can, rc * (K + 1) + torch.clamp(lo, 0, K).long(),
                       n * (K + 1))
    # ncum[i, c] = #claims with insertion point <= c: per row the claim
    # ranks are consecutive and lo is nondecreasing in subject, so the
    # running max of rank+1 over lo <= c is the count.  (Built in int32:
    # the values are <= K either way.)
    newmax = torch.zeros(n * (K + 1) + 1, dtype=torch.int32, device=dev)
    newmax = newmax.scatter_reduce(
        0, lo_t, torch.clamp(rank, 0, K - 1) + 1, "amax", include_self=True)
    ncum = torch.cummax(newmax[:-1].reshape(n, K + 1), dim=1).values
    pos_new = lo - evc[rc, torch.clamp(lo, 0, K).long()].to(torch.int32) \
        + rank
    new_t = torch.where(can, rc * K + torch.clamp(pos_new, 0, K - 1), nk)

    ss_out = torch.empty_like(slot_subj)
    pl_out = tuple(torch.empty_like(p) for p in planes)
    rx_out = (torch.empty_like(rxk0), torch.empty_like(rxs0))
    # The permutation is row-local: apply it per row block (one block
    # unless the table is huge) as an inverted source map and gathers.
    for start, nb in spans:
        sl = slice(start, start + nb)
        rows_b = rows[:nb, None]
        surv = (slot_subj[sl] >= 0) & ~claimed[sl]
        pos_s = cols + ncum[sl, :K].long() - evc[sl, :K].long()
        out_t = torch.where(surv, rows_b * K + pos_s, nb * K).reshape(-1)
        src = torch.full((nb * K + 1,), -1, dtype=cdt, device=dev).scatter(
            0, out_t, cols_c[:nb].reshape(-1))[:nb * K].reshape(nb, K)
        take = torch.clamp(src.long(), 0, K - 1)
        keep = src >= 0

        def permute(plane, d, out):
            out[sl] = torch.where(keep, torch.gather(plane[sl], 1, take),
                                  _fill(d, plane.dtype, dev))

        permute(slot_subj, -1, ss_out)
        for p, d, o in zip(planes, defaults, pl_out):
            permute(p, d, o)
        # The rx planes ride the permutation like any companion (an
        # evicted cell's news resets with it).
        permute(rxk0, -1, rx_out[0])
        permute(rxs0, -1, rx_out[1])

    new_subj = _with_sentinel(ss_out.reshape(-1), -1).scatter(
        0, new_t, s)[:nk].reshape(n, K)
    key_rx, sus_rx = _rx_scatter(new_t, v_max, su_max, n, K, rx_out)
    return new_subj, pl_out, key_rx, sus_rx, dropped, forgot


def insert_rows_one(
    slot_subj: torch.Tensor, planes: tuple, defaults: tuple,
    want: torch.Tensor, new_subj: torch.Tensor,
    *,
    evictable: torch.Tensor, remembers: torch.Tensor,
):
    """Claim at most one slot per row for ``new_subj`` where ``want``,
    keeping every row sorted by bounded insertion (delete the claimed
    column, shift, insert at the subject's merge rank).  Claims take the
    first empty column (the row tail), else the first evictable one; the
    claimed cell resets to ``defaults``.  ``new_subj`` must be absent
    from its row wherever ``want`` is True.

    Returns ``(slot_subj', planes', can, pos, forgot)``: ``pos`` is the
    inserted subject's final column (-1 where no claim happened).  A
    batched table ``[*B, n, K]`` takes ``[*B, n]`` rows and masks and
    counts ``forgot`` per universe.  Its kernels run inside the profiler
    range ``sortmerge.insert_rows_one``."""
    with torch.profiler.record_function("sortmerge.insert_rows_one"):
        batch = tuple(slot_subj.shape[:-2])
        if not batch:
            return _insert_rows_one(slot_subj, planes, defaults, want,
                                    new_subj, evictable, remembers)
        n, K = slot_subj.shape[-2:]

        def rows2(x):
            return x.reshape(-1, K)

        new_ss, new_planes, can, pos, forgot_rows = _insert_rows_one(
            rows2(slot_subj), tuple(rows2(p) for p in planes), defaults,
            want.reshape(-1), new_subj.reshape(-1), rows2(evictable),
            rows2(remembers), per_row=True)
        shape = slot_subj.shape
        return (new_ss.view(shape), tuple(p.view(shape) for p in new_planes),
                can.view(*batch, n), pos.view(*batch, n),
                torch.sum(forgot_rows.view(*batch, n), dim=-1,
                          dtype=torch.int32))


def _insert_rows_one(slot_subj, planes, defaults, want, new_subj, evictable,
                     remembers, per_row: bool = False):
    n, K = slot_subj.shape
    dev = slot_subj.device
    cdt = _col_dtype(K)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    cols = torch.arange(K, dtype=cdt, device=dev)[None, :]
    empty = slot_subj < 0
    E = torch.sum(empty, dim=1, dtype=torch.int32)
    settled = evictable & ~empty
    # torch.argmax returns the first maximum, as jnp.argmax does.
    fsc = torch.argmax(settled.to(torch.uint8), dim=1).to(torch.int32)
    can = want & ((E > 0) | torch.any(settled, dim=1))
    vcol = torch.where(E > 0, K - E, fsc)
    forgot = can & remembers[rows, torch.clamp(vcol, 0, K - 1).long()]
    if not per_row:
        forgot = torch.sum(forgot, dtype=torch.int32)
    _, loq = row_locate_lo(slot_subj, rows, new_subj)
    p = loq - (vcol < loq).to(torch.int32)
    q = cols.expand(n, K)
    pe = torch.clamp(p, 0, K).to(cdt)[:, None]
    ve = torch.clamp(vcol, 0, K).to(cdt)[:, None]
    t_ = q - (q > pe).to(cdt)
    src = t_ + (t_ >= ve).to(cdt)
    is_new = can[:, None] & (q == pe)
    take = torch.where(can[:, None], torch.clamp(src, 0, K - 1), q).long()
    out_subj = torch.where(is_new, new_subj[:, None].to(slot_subj.dtype),
                           torch.gather(slot_subj, 1, take))
    out_planes = tuple(
        torch.where(is_new, _fill(d, pl.dtype, dev),
                    torch.gather(pl, 1, take))
        for pl, d in zip(planes, defaults)
    )
    return out_subj, out_planes, can, torch.where(can, p, -1), forgot
