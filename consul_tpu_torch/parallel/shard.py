"""The sharded simulation plane over D logical shards on one device.

The port of ``consul_tpu/parallel/shard.py`` (the broadcast, dense and
sparse membership, geo and streamcast families).  Shard
``me`` owns the contiguous block of global ids ``[me*blk, (me+1)*blk)``;
every per-node plane is ``[D, blk]``, and one sharded round decomposes as
in the reference:

  1. **Sample owned.**  Targets are GLOBAL ids drawn from the per-(round,
     node) streams of each shard's own rows, so values equal the
     unsharded round's at any D.
  2. **Route.**  Messages to another shard's nodes are packed into a
     fixed per-destination outbox (:func:`outbox_budget` slots, misses
     counted into ``overflow``) and exchanged once per round through
     :func:`exchange_outbox`: ``"alltoall"`` is the plain layout move,
     ``"ring"`` the CUDA ring kernel (``ops/ring_exchange.py``), one
     launch that moves every payload plane from the packed buffers into
     the inbox layout.  Both give the same inbox.
  3. **Merge.**  Inbound messages land through the same delivery scatter
     the unsharded model uses.

Exactness ladder: D == 1 equals the unsharded scan; overflow == 0 means
the sharded run delivered every message a single shard would have.  The
reference's per-shard ``psum``s are sums over the shard axis.

With ``telemetry=True`` every twin also returns the ``[steps, M]`` metrics
trace last (``obs/spec.py``): per-node counts per logical shard, summed
over the shard axis, so it equals the unsharded trace at any D.

Every twin also runs a sweep's U universes at once (the sweep x shard
composition): a key batch ``[U, 2]`` over a stacked ``[U, ...]`` state
gives planes ``[U, D, blk, ...]``, outboxes ``[U, D, D, budget]`` with the
budgets per universe and per shard, one exchange (one ring launch) a tick
for every universe and payload plane, and overflow per universe ``[U]``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from consul_tpu_torch.device import resolve_device
from consul_tpu_torch.models.broadcast import (
    BroadcastConfig,
    BroadcastState,
    broadcast_init,
    spend_budget,
)
from consul_tpu_torch.models.membership import (
    RANK_SUSPECT,
    MembershipConfig,
    MembershipState,
    finish_round,
    gossip_stage,
    cell_rx,
    key_inc,
    key_rank,
    membership_constants,
    membership_counts,
    push_pull_draws,
    push_pull_full,
    row_of,
    scatter_cells,
    spend_gossip,
    track_outputs,
)
from consul_tpu_torch.models.membership_sparse import (
    COUNTER_CAP,
    SparseMembershipConfig,
    SparseMembershipState,
    _merge_arrivals,
    _sus_of,
    gossip_sender_budget,
    n_squared,
    pp_initiator_budget,
    push_pull_leg,
    resolve_amortize,
    sparse_constants,
    sparse_finish_round,
    sparse_gossip_stage,
    sparse_membership_counts,
    sparse_push_pull_draws,
    sparse_spend,
)
from consul_tpu_torch.ops import (
    PRNGKey,
    arrival_rate,
    bernoulli_mask_owned,
    compact_to_budget,
    deliver_or,
    fold_in,
    poissonized_arrivals_owned,
    ring_exchange_planes,
    sample_peers,
    sample_peers_owned,
    split,
)
from consul_tpu_torch.obs.spec import open_trace, with_trace
from consul_tpu_torch.ops.knobs import keep_prob
from consul_tpu_torch.ops.sortmerge import _segmented_sum
from consul_tpu_torch.parallel.mesh import Mesh, block_size, mesh_for

OUTBOX_SAFETY = 2   # c: budget multiple of the per-destination mean
OUTBOX_FLOOR = 64   # never fewer slots than this (small-n studies)
EXCHANGE_BACKENDS = ("alltoall", "ring")

# Each sharded twin and the unsharded family it twins, under the
# reference's names (the registry's ladder rungs are keyed by them).
SHARDED_TWINS = {
    "sharded_broadcast": "broadcast",
    "sharded_membership": "membership",
    "sharded_sparse": "sparse",
    "sharded_streamcast": "streamcast",
    "sharded_geo": "geo",
}

# Twins whose outputs append one trailing output (the outbox overflow) to
# the unsharded scan's; the sparse twin counts its misses into the state's
# own ``overflow``, so its outputs align one for one.
SHARDED_EXTRA_OVERFLOW = frozenset({
    "sharded_broadcast", "sharded_membership", "sharded_streamcast",
    "sharded_geo",
})


def outbox_budget(stream_len: int, n_shards: int,
                  c: int = OUTBOX_SAFETY, floor: int = OUTBOX_FLOOR) -> int:
    """Per-destination outbox slots for a shard emitting ``stream_len``
    messages a round: ``c`` times the Poissonized mean per destination,
    ``stream_len / D``, with a floor, never above the stream."""
    if n_shards <= 1:
        return 1  # degenerate: remote traffic cannot exist
    return min(stream_len, max(floor, -(-c * stream_len // n_shards)))


def outbox_pitch(n_shards: int, budget: int) -> int:
    """Row pitch (int32) of a packed outbox plane: the ``n_shards * budget``
    slots plus one drop slot for messages past the budget, rounded up to
    a multiple of 4 so that every source row starts 16-byte aligned."""
    return -(-(n_shards * budget + 1) // 4) * 4


def pack_outbox(dest: torch.Tensor, ok: torch.Tensor, cols: tuple,
                n_shards: int, budget: int):
    """Pack flat message streams into per-destination outbox slots.

    ``dest`` int[..., A] -- destination shard per message; ``ok``
    bool[..., A] -- the message exists; ``cols`` -- int[..., A] payload
    planes.  Leading dimensions are independent streams (the source
    shards).  Messages sort stably by destination, take their rank within
    the destination's segment and claim that slot of the destination's
    ``budget`` slots; unpacked slots hold -1 and messages ranked past the
    budget are dropped and counted.

    Returns ``(outbox_cols, dropped)``: each plane an int32
    ``[..., n_shards, budget]`` view of one buffer for all planes whose
    rows are :func:`outbox_pitch` long (the drop slot and the padding
    after the slots), and ``dropped`` int32 ``[...]``."""
    batch = dest.shape[:-1]
    a_len = dest.shape[-1]
    idx = torch.arange(a_len, dtype=torch.int64, device=dest.device)
    d = torch.where(ok, dest.to(torch.int64), n_shards)
    d_sorted, perm = torch.sort(d, dim=-1, stable=True)
    seg_start = (idx == 0) | (d_sorted != torch.roll(d_sorted, 1, dims=-1))
    rank = _segmented_sum(seg_start, torch.ones_like(d_sorted)) - 1
    valid = d_sorted < n_shards
    can = valid & (rank < budget)
    width = n_shards * budget
    slot = torch.where(can, d_sorted * budget + rank, width)
    bufs = torch.full((len(cols), *batch, outbox_pitch(n_shards, budget)), -1,
                      dtype=torch.int32, device=dest.device)
    for buf, c_ in zip(bufs, cols):
        buf.scatter_(-1, slot, torch.gather(c_, -1, perm).to(torch.int32))
    packed = bufs[..., :width].unflatten(-1, (n_shards, budget)).unbind(0)
    dropped = torch.sum(valid & ~can, dim=-1, dtype=torch.int32)
    return packed, dropped


def _check_backend(backend: str) -> None:
    if backend not in EXCHANGE_BACKENDS:
        raise ValueError(
            f"unknown exchange backend {backend!r}; "
            "choose 'alltoall' or 'ring'"
        )


def exchange_outbox(planes: tuple, backend: str = "alltoall") -> tuple:
    """Move outbox row ``dst`` of every source shard to shard ``dst``.

    ``planes`` -- int32 ``[D_src, D_dst, budget]`` outboxes, one per
    payload column, as :func:`pack_outbox` leaves them (``[U, D_src,
    D_dst, budget]`` with a sweep's universe axis).  Returns one ``[(U,)
    D_dst, D_src*budget]`` inbox per plane: row ``dst`` holds what each
    shard addressed to ``dst``, in source order, -1 slots empty -- the
    reference's all_to_all layout.

      alltoall  the plain layout move (what ``lax.all_to_all`` does in
                the reference), one copy per plane
      ring      the CUDA ring kernel, one launch over all the packed
                planes and universes in place (the plain version on a
                CPU tensor)
    """
    _check_backend(backend)
    if backend == "ring":
        return ring_exchange_planes(planes)
    *lead, d, _, budget = planes[0].shape
    return tuple(
        p.to(torch.int32).transpose(-3, -2).reshape(*lead, d, d * budget)
        for p in planes
    )


def _check_mesh_state(plane: torch.Tensor, mesh: Mesh, n: int,
                      nb: int = 0) -> None:
    """A state's per-node ``plane`` holds ``n`` rows (on axis ``nb``, after
    a sweep's universe axes) on the mesh's device."""
    if mesh.device is not None and plane.device != mesh.device:
        raise ValueError(f"state on {plane.device} but mesh on {mesh.device}")
    if plane.dim() <= nb or plane.shape[nb] != n:
        raise ValueError(f"state holds {tuple(plane.shape)} on node axis "
                         f"{nb}, cfg n={n}")


def _mark(hits: torch.Tensor, flat: torch.Tensor) -> None:
    """``hits[..., flat] = True`` in place: ``hits`` ``[*B, size + 1]`` (the
    last slot a sink), ``flat`` ``[*B, ...]`` indexing its own universe's
    row."""
    batch = hits.shape[:-1]
    if batch:
        g = torch.arange(hits[..., 0].numel(), device=flat.device)
        flat = flat + g.view(*batch, *([1] * (flat.dim() - len(batch)))
                             ) * hits.shape[-1]
    hits.view(-1)[flat.reshape(-1)] = True


def _per_tick(batch: tuple, steps: int, *shape, device,
              dtype=torch.int32) -> torch.Tensor:
    return torch.empty((*batch, steps, *shape), dtype=dtype, device=device)


def _sum_shards(x: torch.Tensor) -> torch.Tensor:
    """int32 sum over the last (shard) axis: per universe."""
    return torch.sum(x, dim=-1, dtype=torch.int32)


def sharded_broadcast_scan(state: BroadcastState, key: torch.Tensor,
                           cfg: BroadcastConfig, steps: int, mesh: Mesh,
                           exchange: str = "alltoall",
                           telemetry: bool = False):
    """Sharded twin of ``sim.engine.broadcast_scan``.

    ``state`` holds global ``[n]`` planes (as the reference's sharded
    arrays do); inside, every plane is ``[D, blk]``.  Returns
    ``(final_state, (infected[steps], overflow))`` with ``overflow`` the
    total outbox budget misses (0 at D == 1 by construction) and the
    final planes global ``[n]`` again, and the trace last with
    ``telemetry``.  A key batch ``[U, 2]`` over a stacked ``[U, ...]``
    state runs U universes (``overflow`` ``[U]``)."""
    _check_backend(exchange)
    n, fanout = cfg.n, cfg.fanout
    d_shards = mesh.n_shards
    blk = block_size(n, mesh)
    batch = tuple(key.shape[:-1])
    nb = len(batch)
    _check_mesh_state(state.knows, mesh, n, nb)
    dev = state.knows.device
    budget = (
        outbox_budget(blk * fanout, d_shards)
        if cfg.delivery == "edges" else 1
    )
    me = torch.arange(d_shards, dtype=torch.int64, device=dev)[:, None]
    rows_g = torch.arange(n, dtype=torch.int32, device=dev).view(
        d_shards, blk
    )

    st = state
    ov = torch.zeros(batch, dtype=torch.int32, device=dev)
    infected = _per_tick(batch, steps, device=dev)
    trace = open_trace("broadcast", key, steps, telemetry,
                       mesh.n_shards)
    for t in range(steps):
        k_sel, k_loss = split(fold_in(key, t)).unbind(-2)
        senders = st.knows & (st.tx_left > 0)
        senders_l = senders.view(*batch, d_shards, blk)

        if cfg.delivery == "edges":
            targets = sample_peers_owned(k_sel, rows_g, n, fanout)
            ok = senders_l[..., None] & bernoulli_mask_owned(
                k_loss, rows_g, (fanout,), keep_prob(cfg.loss, 3)
            )
            recv = targets.reshape(*batch, d_shards, blk * fanout)
            okf = ok.reshape(*batch, d_shards, blk * fanout)
            dest = recv.to(torch.int64) // blk
            local = okf & (dest == me)
            # Shard me's local index recv - me*blk is global index recv
            # of the flattened [D*blk] plane.
            new_knows = deliver_or(st.knows, recv, local)
            (ob_recv,), dropped = pack_outbox(
                dest, okf & (dest != me), (recv,), d_shards, budget
            )
            (ib_recv,) = exchange_outbox((ob_recv,), backend=exchange)
            new_knows = deliver_or(new_knows, ib_recv, ib_recv >= 0)
            ov = ov + _sum_shards(dropped)
        else:
            # Poissonized aggregate delivery: the only cross-shard
            # traffic is the float32 sender count, summed per shard and
            # then across shards as psum does.
            s_total = torch.sum(
                torch.sum(senders_l, dim=-1, dtype=torch.float32), dim=-1)
            lam = arrival_rate(s_total[..., None, None], senders_l, fanout,
                               cfg.loss, n, trailing=2)
            new_knows = st.knows | poissonized_arrivals_owned(
                k_loss, rows_g, lam
            ).view(st.knows.shape)

        prev = st if trace is not None else None
        st = spend_budget(st, new_knows, senders, cfg)
        infected[..., t] = torch.sum(
            torch.sum(new_knows.view(*batch, d_shards, blk), dim=-1,
                      dtype=torch.int32), dim=-1, dtype=torch.int32)
        if trace is not None:
            trace.record(t, prev, st, infected[..., t], cfg)
    return st, with_trace((infected, ov), trace)


def _rows(x: torch.Tensor, n_shards: int, nb: int = 0) -> torch.Tensor:
    """Every shard's row block of a full-population array (node axis
    ``nb``, after a sweep's universe axes), ``[*B, D, blk, ...]``: block
    ``me`` is what the reference's per-shard ``dynamic_slice`` at ``me *
    blk`` gives shard ``me``."""
    return x.reshape(*x.shape[:nb], n_shards, -1, *x.shape[nb + 1:])


def _global_initiators(pp_ok_l: torch.Tensor, partner_l: torch.Tensor,
                       rows_g: torch.Tensor, n: int, i_slots: int):
    """The global budgeted push/pull initiator set, assembled from each
    shard's owned rows (``pp_ok_l``, ``partner_l``, ``rows_g``: ``[D,
    blk]``).

    Each shard compacts its own initiators (ascending global id) into
    ``min(i_slots, blk)`` slots, a lossless cap for the global first
    ``i_slots`` cut; the shards' id lists, concatenated in shard order
    (the reference's tiled ``all_gather``), are already globally
    ascending and compact down to ``i_slots``.  The selected set is
    therefore the unsharded compaction's prefix at every D.  Returns
    int32 ``(who, pwho, sel, missed)``: initiator and partner ids (``n``
    on empty slots), the slot mask, and the initiators past the budget,
    per universe of leading ``[*B]`` axes."""
    blk = rows_g.shape[-1]
    batch = pp_ok_l.shape[:-2]
    li, lt, _, _ = compact_to_budget(pp_ok_l, min(i_slots, blk))
    li = li.long()
    who_l = torch.where(lt, torch.gather(rows_g.expand(pp_ok_l.shape), -1,
                                         li), n)
    pwho_l = torch.where(lt, torch.gather(partner_l.to(torch.int32), -1, li),
                         n)
    who_all = who_l.reshape(*batch, -1)
    pwho_all = pwho_l.reshape(*batch, -1)
    gi, sel, _, _ = compact_to_budget(who_all < n, i_slots)
    gi = gi.long()
    who = torch.where(sel, torch.gather(who_all, -1, gi), n)
    pwho = torch.where(sel, torch.gather(pwho_all, -1, gi), n)
    missed = (torch.sum(pp_ok_l, dim=(-2, -1), dtype=torch.int32)
              - torch.sum(sel, dim=-1, dtype=torch.int32))
    return who, pwho, sel, missed


def _route_and_exchange(dest, ok, cols: tuple, d_shards: int, budget: int,
                        exchange: str):
    """Pack each shard's messages to other shards (``dest``/``ok``/``cols``:
    ``[*B, D, A]``) and exchange the outboxes: returns ``(inbox planes
    [*B, D, D*budget], dropped [*B, D])``."""
    me = torch.arange(d_shards, device=dest.device)[:, None]
    packed, dropped = pack_outbox(dest, ok & (dest != me), cols, d_shards,
                                  budget)
    return exchange_outbox(packed, backend=exchange), dropped


class ShardPlan(NamedTuple):
    """What a sharded membership tick reads besides the state and its key,
    fixed for a study: the layout, the budgets and the config's tensors
    on the study's device (:func:`sharded_membership_plan`,
    :func:`sharded_sparse_plan`)."""

    n_shards: int
    blk: int                 # observer rows a shard owns
    budget: int              # outbox slots per destination shard
    i_slots: int             # push/pull initiator budget (global)
    s_budget: int            # gossip sender slots a shard (sparse)
    pp_owned: int            # push/pull legs a shard sources (sparse)
    exchange: str
    consts: tuple            # MembershipConstants / SparseConstants
    rows_g: torch.Tensor     # int32 [D, blk]: each shard's global ids
    track_idx: torch.Tensor
    n_sq: torch.Tensor       # float32 f32(n) * n (sparse)


def sharded_membership_plan(cfg: MembershipConfig, mesh: Mesh, device,
                            track: tuple = (),
                            exchange: str = "alltoall") -> ShardPlan:
    """The plan of a dense study over ``mesh``: outbox budget twice the
    per-destination mean of a shard's ``blk * F * M`` gossip lanes."""
    _check_backend(exchange)
    d_shards = mesh.n_shards
    blk = block_size(cfg.n, mesh)
    m = min(cfg.piggyback, cfg.n)
    return ShardPlan(
        d_shards, blk, outbox_budget(blk * cfg.fanout * m, d_shards),
        pp_initiator_budget(cfg.n, cfg.push_pull_ticks), 0, 0, exchange,
        membership_constants(cfg, device), _shard_rows(cfg.n, d_shards,
                                                       device),
        torch.tensor(track, dtype=torch.int64).to(device), None)


def sharded_sparse_plan(cfg: SparseMembershipConfig, mesh: Mesh, device,
                        track: tuple = (),
                        exchange: str = "alltoall") -> ShardPlan:
    """The plan of a sparse study over ``mesh`` (K < n): the gossip sender
    budget over a shard's rows, the owned push/pull legs (``i_slots /
    D``, floor 64, exactly ``i_slots`` at D == 1) and an outbox budget
    twice the per-destination mean of the resulting stream."""
    _check_backend(exchange)
    base = cfg.base
    n = base.n
    K = min(cfg.k_slots, n)
    if K >= n:
        raise ValueError(
            "sharded sparse plane requires k_slots < n (K == n is the "
            "unsharded dense-parity mode)"
        )
    d_shards = mesh.n_shards
    blk = block_size(n, mesh)
    i_slots = pp_initiator_budget(n, base.push_pull_ticks)
    s_budget = gossip_sender_budget(blk)
    pp_owned = min(i_slots, max(64, i_slots // d_shards))
    stream_len = s_budget * base.fanout * min(base.piggyback, K)
    if base.push_pull_enabled:
        stream_len += 2 * pp_owned * K
    return ShardPlan(
        d_shards, blk, outbox_budget(stream_len, d_shards), i_slots,
        s_budget, pp_owned, exchange, sparse_constants(cfg, device),
        _shard_rows(n, d_shards, device),
        torch.tensor(track, dtype=torch.int32).to(device),
        n_squared(n, device))


def _shard_rows(n: int, d_shards: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).view(d_shards,
                                                                  -1)


def sharded_membership_round(state: MembershipState, key_rng: torch.Tensor,
                             cfg: MembershipConfig, plan: ShardPlan):
    """One tick of the sharded dense twin: ``(state', (suspecting,
    dead_known, suspect_cells, known_members, overflow))`` with
    ``overflow`` this tick's misses.

    The tick is the unsharded round (the draws are owned, so the packets
    are the same) with two changes.  Gossip to another shard's observers
    rides the per-destination outbox with the four columns ``(recv, subj,
    val, sus)``; misses count.  At D > 1 the push/pull exchange takes the
    budgeted initiators of :func:`_global_initiators` (misses count) and
    each selected pair merges the other's row, the reference's ``pmax``
    over the shard axis being the owning shard's row.  D == 1 keeps the
    full-width exchange and equals the unsharded round."""
    n, fanout = cfg.n, cfg.fanout
    m = min(cfg.piggyback, n)
    d_shards, blk = plan.n_shards, plan.blk
    dev = state.key.device
    g = gossip_stage(state, key_rng, cfg, plan.consts)
    batch = tuple(g.key_m.shape[:-2])
    nb = len(batch)
    shape3 = (*batch, n, fanout, m)

    def per_shard(x):
        return x.reshape(*batch, d_shards, -1)

    ok3 = per_shard(g.packet_ok[..., None] & g.msg_valid[..., None, :])
    recv = per_shard(g.targets[..., None].expand(shape3))
    subj3 = per_shard(g.subj[..., None, :].expand(shape3))
    val3 = per_shard(g.msg_key[..., None, :].expand(shape3))
    sus3 = torch.where(key_rank(val3) == RANK_SUSPECT, key_inc(val3), -1)
    # Local deliveries scatter straight into the [n + 1, n] receive planes
    # (the last row a sink); remote ones ride the outbox and land from the
    # inbox.  Both are maxima, so order is free.
    dest = recv // blk
    me = torch.arange(d_shards, device=dev)[:, None]
    local = ok3 & (dest == me)
    key_rx = cell_rx(batch, n, dev)
    sus_rx = cell_rx(batch, n, dev)
    flat = torch.where(local, recv * n + subj3, n * n)
    scatter_cells(key_rx, flat, val3)
    scatter_cells(sus_rx, flat, sus3)
    (ib_recv, ib_subj, ib_val, ib_sus), dropped = _route_and_exchange(
        dest, ok3, (recv, subj3, val3, sus3), d_shards, plan.budget,
        plan.exchange)
    flat_in = torch.where(ib_recv >= 0, ib_recv.long() * n + ib_subj, n * n)
    scatter_cells(key_rx, flat_in, ib_val)
    scatter_cells(sus_rx, flat_in, ib_sus)
    key_rx = key_rx.view(*batch, n + 1, n)
    tx = spend_gossip(g, fanout)
    ov = _sum_shards(dropped)

    if cfg.push_pull_enabled:
        partner, pp_ok = push_pull_draws(g, cfg)
        if d_shards == 1:
            # At D == 1 the owned rows are the population: the full-width
            # exchange, as the unsharded round.
            push_pull_full(key_rx, g.key_m, partner, pp_ok)
        else:
            who, pwho, sel, missed = _global_initiators(
                _rows(pp_ok, d_shards, nb), _rows(partner, d_shards, nb),
                plan.rows_g, n, plan.i_slots)
            ov = ov + missed
            # Each id has one owning shard, so the max over the shard axis
            # of "the row where owned, else -1" is its row.
            i_rows, p_rows = (
                torch.where(sel[..., None],
                            row_of(g.key_m, torch.clamp(ids, max=n - 1)), -1)
                for ids in (who, pwho))
            # Pull: an initiator merges its partner's row; push: a partner
            # merges its initiator's.
            for dst, rows in ((who, p_rows), (pwho, i_rows)):
                tgt = torch.where(sel, dst, n).long()[..., None]
                key_rx.scatter_reduce_(-2, tgt.expand(rows.shape), rows,
                                       "amax")
    st = finish_round(state, g, tx, key_rx[..., :n, :],
                      sus_rx.view(*batch, n + 1, n)[..., :n, :], cfg,
                      plan.consts)
    return st, (*membership_counts(st.key, plan.track_idx), ov)


def sharded_membership_scan(state, key: torch.Tensor, cfg, steps: int,
                            mesh: Mesh, track: tuple = (),
                            exchange: str = "alltoall",
                            telemetry: bool = False):
    """Sharded twin of ``sim.engine.membership_scan`` (cfg: a
    MembershipConfig): shard ``me`` owns observer rows ``[me*blk,
    (me+1)*blk)`` of every [n, n] plane; each tick is
    :func:`sharded_membership_round`.  Returns ``(final_state,
    (suspecting, dead_known, suspect_cells, known_members, overflow))``
    with ``overflow`` the total misses (per universe for a key batch), and
    the trace last with ``telemetry``."""
    batch = tuple(key.shape[:-1])
    _check_mesh_state(state.key, mesh, cfg.n, len(batch))
    dev = state.key.device
    plan = sharded_membership_plan(cfg, mesh, dev, tuple(track), exchange)
    outs = track_outputs(steps, len(track), torch.int32, dev, batch)
    ov = torch.zeros(batch, dtype=torch.int32, device=dev)
    trace = open_trace("membership", key, steps, telemetry,
                       mesh.n_shards)
    for t in range(steps):
        prev = state if trace is not None else None
        state, (*counts, ov_t) = sharded_membership_round(
            state, fold_in(key, t), cfg, plan)
        for o, v in zip(outs, counts):
            o.select(len(batch), t).copy_(v)
        if trace is not None:
            trace.record(t, prev, state, counts, cfg)
        ov = ov + ov_t
    return state, with_trace((*outs, ov), trace)


def _owned_legs(src_g, recv_ids, sel, plan: ShardPlan):
    """The push/pull legs whose source row each shard owns, compacted to
    ``plan.pp_owned`` a shard: ``(taken, src rows, receivers, missed)``,
    ``[*B, D, pp_owned]`` each but ``missed`` ``[*B, D]``."""
    start = plan.rows_g[:, :1]
    loc = src_g[..., None, :] - start
    own = (loc >= 0) & (loc < plan.blk) & sel[..., None, :]
    j, taken, _, missed = compact_to_budget(own, plan.pp_owned)
    j = j.long()

    def at(x):
        return torch.gather(x[..., None, :].expand(own.shape), -1, j)

    rows = torch.clamp(at(src_g) - start, 0, plan.blk - 1) + start
    return taken, rows, at(recv_ids), missed


def sharded_sparse_membership_round(state: SparseMembershipState,
                                    key_rng: torch.Tensor,
                                    cfg: SparseMembershipConfig,
                                    plan: ShardPlan):
    """One tick of the sharded sparse twin: ``(state', (suspecting,
    dead_known, suspect_cells, known_members))``; every miss counts into
    ``state.overflow``.

    Per shard, as the reference: gossip senders compact to
    ``plan.s_budget``; the push/pull initiators come from
    :func:`_global_initiators` and each shard emits the legs whose source
    row it owns, compacted to ``plan.pp_owned``; the ``(recv, subj, val,
    sus, alloc)`` stream is routed (own rows direct, other shards' through
    the outbox), and each shard's own messages followed by its inbox land
    through one sort-merge.  On one card the D merges are one
    ``merge_into_rows`` call with a per-shard allocation budget, behind
    one host read of "does any shard need a slot?" (the allocation branch
    equals the skip branch where it is not needed); the probe claim reads
    its predicate once for all shards too: at most 2 host syncs a tick."""
    base = cfg.base
    n, fanout = base.n, base.fanout
    K = state.key.shape[-1]
    m = min(base.piggyback, K)
    d_shards = plan.n_shards
    dev = state.key.device
    start = plan.rows_g[:, :1]                             # [D, 1]
    g = sparse_gossip_stage(state, key_rng, cfg, plan.consts)
    slot_subj, key_m = state.slot_subj, g.key_m
    batch = tuple(key_m.shape[:-2])
    nb = len(batch)

    # Compacted emission over each shard's own rows.
    has_msg = _rows(torch.any(g.msg_valid, dim=-1), d_shards, nb)
    sndc, sel_s, sel_mask, ov_shards = compact_to_budget(has_msg,
                                                         plan.s_budget)
    msg_valid = g.msg_valid & sel_mask.reshape(*batch, n, 1)
    src = (sndc + start).reshape(*batch, -1)               # global rows
    shape3 = (*src.shape, fanout, m)
    val_g = row_of(g.msg_key, src)[..., None, :].expand(shape3)
    parts = [tuple(x.reshape(*batch, d_shards, -1) for x in (
        row_of(g.targets, src)[..., None].expand(shape3),
        row_of(g.msg_subj, src)[..., None, :].expand(shape3),
        val_g, _sus_of(val_g),
        (row_of(g.packet_ok, src) & sel_s.reshape(*batch, -1, 1))[..., None]
        & row_of(msg_valid, src)[..., None, :],
        torch.ones(shape3, dtype=torch.bool, device=dev),
    ))]
    tx = sparse_spend(g, msg_valid, fanout)

    overflow = torch.clamp(state.overflow, max=COUNTER_CAP)
    if base.push_pull_enabled:
        partner, pp_ok = sparse_push_pull_draws(g, slot_subj, base)
        who, pwho, sel, missed = _global_initiators(
            _rows(pp_ok, d_shards, nb), _rows(partner, d_shards, nb),
            plan.rows_g, n, plan.i_slots)
        overflow = overflow + missed
        # Pull: the partner's slots flow to the initiator; push: the
        # initiator's to the partner.
        for src_g, recv_ids in ((pwho, who), (who, pwho)):
            taken, rows, recv_l, missed_legs = _owned_legs(src_g, recv_ids,
                                                           sel, plan)
            ov_shards = ov_shards + missed_legs
            parts.append(push_pull_leg(slot_subj, key_m, recv_l, rows,
                                       taken))
    recv, subj, val, sus, ok, alloc = (
        torch.cat([p[i] for p in parts], dim=-1) for i in range(6))

    # Route: own rows direct, the rest through the outbox.
    dest = recv.long() // plan.blk
    local = ok & (dest == torch.arange(d_shards, device=dev)[:, None])
    (ib_recv, ib_subj, ib_val, ib_sus, ib_alloc), dropped = (
        _route_and_exchange(dest, ok, (recv, subj, val, sus,
                                       alloc.to(torch.int32)),
                            d_shards, plan.budget, plan.exchange))
    ib_ok = ib_recv >= 0
    # Shard me's merge stream: its own messages, then its inbox; a
    # universe's stream is its D shards' streams in shard order.
    stream = tuple(torch.cat(pair, dim=-1).reshape(*batch, -1) for pair in (
        (torch.where(local, recv, start), torch.where(ib_ok, ib_recv, start)),
        (subj, ib_subj), (val, ib_val), (sus, ib_sus), (local, ib_ok),
        (alloc, ib_alloc > 0)))
    zero = torch.zeros(batch, dtype=torch.int32, device=dev)
    slots_t, key_rx, sus_rx, ov_merge, forgot = _merge_arrivals(
        (slot_subj, key_m, state.suspect_since, state.confirms, tx), *stream,
        n, K, zero, zero, amortize=resolve_amortize(cfg),
        segments=d_shards)
    overflow = overflow + (_sum_shards(ov_shards + dropped) + ov_merge)
    forgotten = torch.clamp(state.forgotten, max=COUNTER_CAP) + forgot
    st = sparse_finish_round(state, g, slots_t, key_rx, sus_rx, overflow,
                             forgotten, cfg, plan.consts)
    return st, sparse_membership_counts(st, plan.track_idx, plan.n_sq,
                                        d_shards)


def sharded_sparse_membership_scan(state, key: torch.Tensor, cfg,
                                   steps: int, mesh: Mesh,
                                   track: tuple = (),
                                   exchange: str = "alltoall",
                                   telemetry: bool = False):
    """Sharded twin of ``sim.engine.sparse_membership_scan`` (cfg: a
    SparseMembershipConfig with K < n): shard ``me`` owns observer rows
    ``[me*blk, (me+1)*blk)`` of the [n, K] slot planes; each tick is
    :func:`sharded_sparse_membership_round`.  Returns ``(final_state,
    (suspecting, dead_known, suspect_cells, known_members))`` like the
    unsharded scan (the trace last with ``telemetry``);
    ``state.overflow`` also counts the outbox misses.  A
    key batch ``[U, 2]`` over a stacked state runs U universes, their D
    per-shard merges one ``merge_into_rows`` call of U*D segments."""
    batch = tuple(key.shape[:-1])
    _check_mesh_state(state.key, mesh, cfg.base.n, len(batch))
    dev = state.key.device
    plan = sharded_sparse_plan(cfg, mesh, dev, tuple(track), exchange)
    outs = track_outputs(steps, len(track), torch.float32, dev, batch)
    trace = open_trace("sparse", key, steps, telemetry,
                       mesh.n_shards)
    for t in range(steps):
        prev = state if trace is not None else None
        state, counts = sharded_sparse_membership_round(
            state, fold_in(key, t), cfg, plan)
        for o, v in zip(outs, counts):
            o.select(len(batch), t).copy_(v)
        if trace is not None:
            trace.record(t, prev, state, counts, cfg)
    return state, with_trace(outs, trace)


def sharded_geo_scan(state, key: torch.Tensor, cfg, steps: int, mesh: Mesh,
                     exchange: str = "alltoall", telemetry: bool = False):
    """Sharded twin of ``sim.engine.geo_scan`` (cfg: a GeoConfig).

    Segments lie contiguously over the shards (``segments % D == 0``, each
    shard owning ``segments/D`` whole DCs), so the LAN gossip is
    shard-local and only WAN units cross.  The link plane is replicated
    in the reference (a pure function of the bridge-known masks, which
    are sums over the shard axis of each shard's own segments, and of the
    replicated round keys); on one card it is stepped once.  Each
    delivery slot is emitted by the shard owning its SOURCE segment:
    deliveries to its own nodes land directly, the others ride the
    per-destination outbox with the two columns ``(recv, ev)``
    (``exchange`` = ``"alltoall"`` | ``"ring"``).  D == 1 equals the
    unsharded scan.  Returns ``(final_state, (*outs, outbox_overflow))``
    with ``outbox_overflow`` the running count of budget misses per tick
    (and the trace last with ``telemetry``).
    A key batch ``[U, 2]`` over a stacked state runs U universes; the
    Knuth Poisson loop of the link plane still reads its predicate on the
    host for all U universes at once."""
    from consul_tpu_torch.geo.model import (
        GeoState,
        bridge_known,
        geo_constants,
        lan_arrivals,
        link_plane,
        merge,
        per_segment_done,
    )

    _check_backend(exchange)
    n, S, E = cfg.n, cfg.segments, cfg.events
    S2, U = cfg.n_links, cfg.cap_units
    d_shards = mesh.n_shards
    if S % d_shards:
        raise ValueError(
            f"segments={S} does not divide over {d_shards} devices: the geo "
            "layout owns whole DCs per device"
        )
    spd = S // d_shards
    blk = block_size(n, mesh)
    dev = state.knows.device
    batch = tuple(key.shape[:-1])
    nb = len(batch)
    if mesh.device is not None and dev != mesh.device:
        raise ValueError(f"state on {dev} but mesh on {mesh.device}")
    if state.knows.shape != (*batch, n, E):
        raise ValueError(f"state holds {tuple(state.knows.shape)}, cfg "
                         f"{(*batch, n, E)}")
    # A shard emits only the slots of links leaving its own segments.
    budget = outbox_budget(spd * S * U, d_shards)
    consts = geo_constants(cfg, dev)
    me = torch.arange(d_shards, device=dev)[:, None]
    rows_g = torch.arange(n, dtype=torch.int32, device=dev).view(
        d_shards, blk)
    src_owner = (consts.src // spd)[:, None].expand(S2, U).reshape(-1)
    emits = src_owner[None, :] == me                    # [D, S2*U]

    outs = (
        _per_tick(batch, steps, S, device=dev),
        *(_per_tick(batch, steps, S2, device=dev) for _ in range(4)),
        _per_tick(batch, steps, device=dev),
        _per_tick(batch, steps, device=dev),
    )
    ob_ov = torch.zeros(batch, dtype=torch.int32, device=dev)
    trace = open_trace("geo", key, steps, telemetry,
                       mesh.n_shards)
    st = state
    for t in range(steps):
        k_lan, k_gossip, k_tgt, k_loss = split(fold_in(key, t), 4).unbind(-2)
        knows = st.knows.view(*batch, d_shards, blk, E)
        tx_lan_l = st.tx_lan.view(*batch, d_shards, blk, E)
        senders, got_lan = lan_arrivals(knows, tx_lan_l, rows_g, k_lan, cfg,
                                        nb)
        bk, bk_cnt = bridge_known(knows, cfg, nb)
        step = link_plane(st, bk, bk_cnt, k_gossip, k_tgt, k_loss, cfg,
                          consts)

        recv_f = step.recv.reshape(*batch, 1, -1)
        ev_f = step.ev_slot.reshape(*batch, 1, -1)
        okf = step.live.reshape(*batch, 1, -1) & emits   # [*B, D, S2*U]
        dest = (recv_f // blk).to(torch.int64).expand(okf.shape)
        local = okf & (dest == me)
        # Shard me's local index (recv - me*blk)*E + ev is the global
        # index recv*E + ev of the [D*blk*E] plane.
        flat = recv_f.to(torch.int64) * E + ev_f
        hits = torch.zeros((*batch, n * E + 1), dtype=torch.bool, device=dev)
        _mark(hits, torch.where(local, flat, n * E))
        cols = tuple(c.expand(okf.shape) for c in (recv_f, ev_f))
        packed, dropped = pack_outbox(dest, okf & (dest != me), cols,
                                      d_shards, budget)
        ib_recv, ib_ev = exchange_outbox(packed, backend=exchange)
        _mark(hits, torch.where(ib_recv >= 0,
                                ib_recv.to(torch.int64) * E + ib_ev, n * E))
        got_wan = hits[..., :n * E].view(knows.shape) & ~knows
        ob_ov = ob_ov + _sum_shards(dropped)

        new_knows, tx_lan = merge(knows, tx_lan_l, senders,
                                  got_lan | got_wan, cfg)
        out = (per_segment_done(new_knows, cfg, nb), step.offered,
               step.admitted, step.queued, step.overflow, step.wasted)
        for o, v in zip(outs, (*out, ob_ov)):
            o.select(nb, t).copy_(v)
        prev = st if trace is not None else None
        st = GeoState(
            knows=new_knows.view(*batch, n, E),
            tx_lan=tx_lan.view(*batch, n, E),
            ring=step.ring, queue=step.queue, known_hist=step.known_hist,
            ewma=step.ewma, wasted=step.wasted, tick=st.tick + 1,
        )
        if trace is not None:
            trace.record(t, prev, st, out, cfg)
    return st, with_trace(outs, trace)


def sharded_streamcast_scan(state, key: torch.Tensor, cfg, steps: int,
                            mesh: Mesh, exchange: str = "alltoall",
                            telemetry: bool = False):
    """Sharded twin of ``sim.engine.streamcast_scan`` (cfg: a
    StreamcastConfig).

    Shard ``me`` owns rows ``[me*blk, (me+1)*blk)`` of the ``[n, W, E]``
    chunk plane and the ``[n, W]`` budget and cursor planes, viewed
    ``[D, blk, ...]``; the window and every counter are replicated (the
    allocator is a function of the replicated schedule) and stepped once.
    Draws are owned, over the global ids of each shard's rows.  Edges
    messages to a node of the same shard land directly; the rest ride the
    per-destination outbox with the three columns ``(recv, slot,
    chunk)``, exchanged through ``exchange`` (``"alltoall"`` | ``"ring"``:
    one ring-kernel launch a tick for the three planes).  The aggregate
    path shares only each shard's ``[W, E]`` sender counts, whose sums are
    exact in any order.  Returns ``(final_state, (*outs, overflow))``
    with the unsharded scan's outputs and the running outbox overflow
    a tick (and the trace last with ``telemetry``); D == 1 equals the
    unsharded scan.  A key batch ``[U, 2]`` over
    a stacked state runs U universes (the planes ``[U, D, blk, ...]``)."""
    from consul_tpu_torch.sim.engine import streamcast_outputs
    from consul_tpu_torch.streamcast.model import (
        _SCHED_SALT,
        StreamcastState,
        _p_live,
        admit_stage,
        aggregate_arrivals_chunks,
        aggregate_rate,
        arrival_arrays,
        chunk_index,
        edge_messages,
        finish_stage,
        round_keys,
        service_stage,
    )

    _check_backend(exchange)
    n, w_slots, e_chunks = cfg.n, cfg.window, cfg.chunks
    d_shards = mesh.n_shards
    blk = block_size(n, mesh)
    batch = tuple(key.shape[:-1])
    nb = len(batch)
    _check_mesh_state(state.chunks, mesh, n, nb)
    dev = state.chunks.device
    budget = (outbox_budget(blk * w_slots * cfg.fanout, d_shards)
              if cfg.delivery == "edges" else 1)
    me = torch.arange(d_shards, dtype=torch.int64, device=dev)[:, None]
    rows_g = _shard_rows(n, d_shards, dev)
    size = n * w_slots * e_chunks

    def shard_sum(x):
        # Each shard's sum over its rows, then the sum over shards (psum).
        return torch.sum(torch.sum(x, dim=nb + 1, dtype=x.dtype), dim=nb,
                         dtype=x.dtype)

    sched = arrival_arrays(cfg, fold_in(key, _SCHED_SALT))
    outs = (*streamcast_outputs(cfg, steps, dev, batch),
            _per_tick(batch, steps, device=dev))
    ob_ov = torch.zeros(batch, dtype=torch.int32, device=dev)
    trace = open_trace("streamcast", key, steps, telemetry,
                       mesh.n_shards)
    st = state._replace(
        chunks=state.chunks.view(*batch, d_shards, blk, w_slots, e_chunks),
        tx_left=state.tx_left.view(*batch, d_shards, blk, w_slots),
        cursor=state.cursor.view(*batch, d_shards, blk, w_slots),
    )
    for t in range(steps):
        k_sel, k_loss, k_tie, k_chunk = round_keys(fold_in(key, t))
        adm = admit_stage(st, cfg, sched, rows_g)
        held_real, serviced, sel, cursor = service_stage(
            cfg, k_tie, k_chunk, rows_g, adm)
        p_live = _p_live(cfg, st.tick)
        if cfg.delivery == "edges":
            recv, wix, cix, ok = edge_messages(cfg, k_sel, k_loss, rows_g,
                                               serviced, sel, p_live)
            dest = recv.to(torch.int64) // blk
            local = ok & (dest == me)
            # Shard me's local index of (recv, w, c) is the global index
            # of the flattened [D*blk, W, E] plane.
            hits = torch.zeros((*batch, size + 1), dtype=torch.bool,
                               device=dev)
            _mark(hits, torch.where(local, chunk_index(cfg, recv, wix, cix),
                                    size))
            packed, dropped = pack_outbox(dest, ok & (dest != me),
                                          (recv, wix, cix), d_shards, budget)
            ib_recv, ib_w, ib_c = exchange_outbox(packed, backend=exchange)
            _mark(hits, torch.where(ib_recv >= 0,
                                    chunk_index(cfg, ib_recv, ib_w, ib_c),
                                    size))
            new_chunks = adm.chunks | hits[..., :size].view(adm.chunks.shape)
            ob_ov = ob_ov + _sum_shards(dropped)
        else:
            lam = aggregate_rate(cfg, held_real, serviced, sel, p_live,
                                 shard_sum, nb)
            new_chunks = adm.chunks | aggregate_arrivals_chunks(
                cfg, k_loss, rows_g, lam)
        prev = st if trace is not None else None
        st, out = finish_stage(st, cfg, adm, new_chunks, serviced, cursor,
                               shard_sum)
        for o, v in zip(outs, (*out, ob_ov)):
            o.select(nb, t).copy_(v)
        if trace is not None:
            trace.record(t, prev, st, out, cfg)
    final = st._replace(
        chunks=st.chunks.reshape(*batch, n, w_slots, e_chunks),
        tx_left=st.tx_left.reshape(*batch, n, w_slots),
        cursor=st.cursor.reshape(*batch, n, w_slots),
    )
    return StreamcastState(*final), with_trace(outs, trace)


# ---------------------------------------------------------------------------
# Standalone multichip datapoint: python -m consul_tpu_torch.parallel.shard
# ---------------------------------------------------------------------------


def _wall_s(fn, iters: int, dev: torch.device) -> float:
    """Seconds one ``fn()`` takes: the mean of ``iters`` back-to-back calls
    after one warm-up call, between CUDA events on a GPU (host time
    between calls counts where the device waits for it), by the host
    clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def exchange_phase_walls(cfg: BroadcastConfig, mesh: Mesh, backend: str,
                         iters: int = 20) -> dict:
    """Per-round wall split of one broadcast-shaped gossip round: the
    pack-and-exchange step and the local delivery scatter, each timed
    alone at the round's exact shapes.  ``exchange_wall_s`` is what a
    round pays when the transport does not hide behind the merge,
    ``merge_wall_s`` the local work it could hide behind.  Unrounded
    seconds (the reference rounds to microseconds, which a card's
    exchange is a few of)."""
    n, fanout = cfg.n, cfg.fanout
    d_shards = mesh.n_shards
    blk = block_size(n, mesh)
    budget = outbox_budget(blk * fanout, d_shards)
    dev = resolve_device(mesh.device)
    me = torch.arange(d_shards, dtype=torch.int64, device=dev)[:, None]
    recv = sample_peers(PRNGKey(7, dev), n, fanout).view(
        d_shards, blk * fanout)
    ok = torch.ones_like(recv, dtype=torch.bool)
    knows = torch.zeros(n, dtype=torch.bool, device=dev)

    def exchange():
        dest = recv.to(torch.int64) // blk
        (ob_recv,), dropped = pack_outbox(
            dest, ok & (dest != me), (recv,), d_shards, budget)
        (ib_recv,) = exchange_outbox((ob_recv,), backend=backend)
        return torch.sum(ib_recv, dim=-1, dtype=torch.int32) + dropped

    def merge():
        # Shard me's local index recv - me*blk is global index recv of
        # the flattened [D*blk] plane, as in sharded_broadcast_scan.
        return deliver_or(knows, recv, ok & (recv.to(torch.int64) // blk
                                             == me))

    return {
        "exchange_wall_s": _wall_s(exchange, iters, dev),
        "merge_wall_s": _wall_s(merge, iters, dev),
    }


def main(argv=None) -> int:
    """Print one multichip datapoint as a JSON line: the sharded broadcast
    study (fanout 4, edges) over ``--devices`` logical shards at ``--n``
    aggregate nodes, per outbox transport, with its exchange and merge
    walls.  CUDA unless ``--device`` names another device."""
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="consul_tpu_torch.parallel.shard")
    parser.add_argument("--devices", type=int, default=8,
                        help="logical shards of the node axis")
    parser.add_argument("--n", type=int, default=4096,
                        help="aggregate nodes across the shards")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--exchange", default="both",
                        choices=("alltoall", "ring", "both"),
                        help="outbox transport(s) to measure")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current GPU)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = mesh_for(args.devices, dev)
    cfg = BroadcastConfig(n=args.n, fanout=4, delivery="edges")
    key = PRNGKey(args.seed, dev)
    backends = (
        ("alltoall", "ring") if args.exchange == "both"
        else (args.exchange,)
    )
    per_backend: dict = {}
    for ex in backends:
        # A warm-up pass (allocator, kernel build), then the timed one.
        _, (infected, ov) = sharded_broadcast_scan(
            broadcast_init(cfg, device=dev), key, cfg, args.steps, mesh, ex)
        infected.cpu()
        t0 = time.perf_counter()
        _, (infected, ov) = sharded_broadcast_scan(
            broadcast_init(cfg, device=dev), key, cfg, args.steps, mesh, ex)
        infected = infected.cpu().numpy()
        wall = time.perf_counter() - t0
        per_backend[ex] = {
            "rounds_per_sec": (
                round(args.steps / wall, 2) if wall > 0 else None
            ),
            "infected_final": int(infected[-1]),
            "overflow": int(ov),
            **exchange_phase_walls(cfg, mesh, ex),
        }
    head = per_backend[backends[0]]
    print(json.dumps({
        "devices": mesh.n_shards,
        "nodes_aggregate": cfg.n,
        "nodes_per_device": cfg.n // mesh.n_shards,
        "rounds": args.steps,
        "rounds_per_sec": head["rounds_per_sec"],
        "infected_final": head["infected_final"],
        "overflow": head["overflow"],
        "exchange_backend": backends[0],
        "exchange_backends": per_backend,
        # D logical shards on one device: nothing to force.
        "host_devices_forced": False,
        "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else str(dev)),
    }))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
