"""The sharded simulation plane over D logical shards on one device.

The port of ``consul_tpu/parallel/shard.py`` (the broadcast and geo
families).  Shard
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
     ``"ring"`` the CUDA ring kernel (``ops/ring_exchange.py``).  Both
     give the same inbox.
  3. **Merge.**  Inbound messages land through the same delivery scatter
     the unsharded model uses.

Exactness ladder: D == 1 equals the unsharded scan; overflow == 0 means
the sharded run delivered every message a single shard would have.  The
reference's per-shard ``psum``s are sums over the shard axis.
"""

from __future__ import annotations

import torch

from consul_tpu_torch.models.broadcast import (
    BroadcastConfig,
    BroadcastState,
    spend_budget,
)
from consul_tpu_torch.ops import (
    arrival_rate,
    bernoulli_mask_owned,
    deliver_or,
    fold_in,
    poissonized_arrivals_owned,
    ring_exchange,
    sample_peers_owned,
    split,
)
from consul_tpu_torch.ops.sortmerge import _segmented_sum
from consul_tpu_torch.parallel.mesh import Mesh, block_size

OUTBOX_SAFETY = 2   # c: budget multiple of the per-destination mean
OUTBOX_FLOOR = 64   # never fewer slots than this (small-n studies)
EXCHANGE_BACKENDS = ("alltoall", "ring")


def outbox_budget(stream_len: int, n_shards: int,
                  c: int = OUTBOX_SAFETY, floor: int = OUTBOX_FLOOR) -> int:
    """Per-destination outbox slots for a shard emitting ``stream_len``
    messages a round: ``c`` times the Poissonized mean per destination,
    ``stream_len / D``, with a floor, never above the stream."""
    if n_shards <= 1:
        return 1  # degenerate: remote traffic cannot exist
    return min(stream_len, max(floor, -(-c * stream_len // n_shards)))


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

    Returns ``(outbox_cols, dropped)``: each plane int32
    ``[..., n_shards, budget]`` and ``dropped`` int32 ``[...]``."""
    batch = dest.shape[:-1]
    a_len = dest.shape[-1]
    idx = torch.arange(a_len, dtype=torch.int64, device=dest.device)
    d = torch.where(ok, dest.to(torch.int64), n_shards)
    d_sorted, perm = torch.sort(d, dim=-1, stable=True)
    seg_start = (idx == 0) | (d_sorted != torch.roll(d_sorted, 1, dims=-1))
    rank = _segmented_sum(seg_start, torch.ones_like(d_sorted)) - 1
    valid = d_sorted < n_shards
    can = valid & (rank < budget)
    slot = torch.where(can, d_sorted * budget + rank, n_shards * budget)
    packed = []
    for c_ in cols:
        buf = torch.full((*batch, n_shards * budget + 1), -1,
                         dtype=torch.int32, device=dest.device)
        buf.scatter_(-1, slot, torch.gather(c_, -1, perm).to(torch.int32))
        packed.append(buf[..., :-1].reshape(*batch, n_shards, budget))
    dropped = torch.sum(valid & ~can, dim=-1, dtype=torch.int32)
    return tuple(packed), dropped


def _check_backend(backend: str) -> None:
    if backend not in EXCHANGE_BACKENDS:
        raise ValueError(
            f"unknown exchange backend {backend!r}; "
            "choose 'alltoall' or 'ring'"
        )


def exchange_outbox(planes: tuple, backend: str = "alltoall") -> tuple:
    """Move outbox row ``dst`` of every source shard to shard ``dst``.

    ``planes`` -- int32 ``[D_src, D_dst, budget]`` outboxes, one per
    payload column.  Returns one ``[D_dst, D_src*budget]`` inbox per
    plane: row ``dst`` holds what each shard addressed to ``dst``, in
    source order, -1 slots empty -- the reference's all_to_all layout.

      alltoall  the plain layout move (what ``lax.all_to_all`` does in
                the reference)
      ring      the CUDA ring kernel over the stacked ``[D, D, C,
                budget]`` box (the plain version on a CPU tensor)
    """
    _check_backend(backend)
    d, _, budget = planes[0].shape
    if backend == "ring":
        box = torch.stack([p.to(torch.int32) for p in planes], dim=2)
        inbox = ring_exchange(box)
        return tuple(
            inbox[:, :, c, :].reshape(d, d * budget)
            for c in range(len(planes))
        )
    return tuple(
        p.to(torch.int32).transpose(0, 1).reshape(d, d * budget)
        for p in planes
    )


def _check_mesh_state(state: BroadcastState, mesh: Mesh, n: int) -> None:
    if mesh.device is not None and state.knows.device != mesh.device:
        raise ValueError(
            f"state on {state.knows.device} but mesh on {mesh.device}"
        )
    if state.knows.numel() != n:
        raise ValueError(f"state holds {state.knows.numel()} nodes, cfg {n}")


def sharded_broadcast_scan(state: BroadcastState, key: torch.Tensor,
                           cfg: BroadcastConfig, steps: int, mesh: Mesh,
                           exchange: str = "alltoall"):
    """Sharded twin of ``sim.engine.broadcast_scan``.

    ``state`` holds global ``[n]`` planes (as the reference's sharded
    arrays do); inside, every plane is ``[D, blk]``.  Returns
    ``(final_state, (infected[steps], overflow))`` with ``overflow`` the
    total outbox budget misses (0 at D == 1 by construction) and the
    final planes global ``[n]`` again."""
    _check_backend(exchange)
    n, fanout = cfg.n, cfg.fanout
    d_shards = mesh.n_shards
    blk = block_size(n, mesh)
    _check_mesh_state(state, mesh, n)
    dev = state.knows.device
    budget = (
        outbox_budget(blk * fanout, d_shards)
        if cfg.delivery == "edges" else 1
    )
    me = torch.arange(d_shards, dtype=torch.int64, device=dev)[:, None]
    rows_g = torch.arange(n, dtype=torch.int32, device=dev).view(
        d_shards, blk
    )

    st = BroadcastState(
        knows=state.knows.reshape(d_shards, blk),
        tx_left=state.tx_left.reshape(d_shards, blk),
        tick=state.tick,
    )
    ov = torch.zeros((), dtype=torch.int32, device=dev)
    infected = torch.empty(steps, dtype=torch.int32, device=dev)
    for t in range(steps):
        k_sel, k_loss = split(fold_in(key, t)).unbind(-2)
        senders = st.knows & (st.tx_left > 0)

        if cfg.delivery == "edges":
            targets = sample_peers_owned(k_sel, rows_g, n, fanout)
            ok = senders[..., None] & bernoulli_mask_owned(
                k_loss, rows_g, (fanout,), 1.0 - cfg.loss
            )
            recv = targets.reshape(d_shards, blk * fanout)
            okf = ok.reshape(d_shards, blk * fanout)
            dest = recv.to(torch.int64) // blk
            local = okf & (dest == me)
            # Shard me's local index recv - me*blk is global index recv
            # of the flattened [D*blk] plane.
            new_knows = deliver_or(st.knows.reshape(n), recv, local)
            (ob_recv,), dropped = pack_outbox(
                dest, okf & (dest != me), (recv,), d_shards, budget
            )
            (ib_recv,) = exchange_outbox((ob_recv,), backend=exchange)
            new_knows = deliver_or(new_knows, ib_recv, ib_recv >= 0)
            new_knows = new_knows.view(d_shards, blk)
            ov = ov + torch.sum(dropped, dtype=torch.int32)
        else:
            # Poissonized aggregate delivery: the only cross-shard
            # traffic is the float32 sender count, summed per shard and
            # then across shards as psum does.
            s_total = torch.sum(
                torch.sum(senders, dim=1, dtype=torch.float32)
            )
            lam = arrival_rate(s_total, senders, fanout, cfg.loss, n)
            new_knows = st.knows | poissonized_arrivals_owned(
                k_loss, rows_g, lam
            )

        st = spend_budget(st, new_knows, senders, cfg)
        infected[t] = torch.sum(
            torch.sum(new_knows, dim=1, dtype=torch.int32)
        )
    final = BroadcastState(
        knows=st.knows.reshape(n), tx_left=st.tx_left.reshape(n),
        tick=st.tick,
    )
    return final, (infected, ov)


def sharded_geo_scan(state, key: torch.Tensor, cfg, steps: int, mesh: Mesh,
                     exchange: str = "alltoall"):
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
    with ``outbox_overflow`` the running count of budget misses per tick."""
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
    if mesh.device is not None and dev != mesh.device:
        raise ValueError(f"state on {dev} but mesh on {mesh.device}")
    if state.knows.shape != (n, E):
        raise ValueError(f"state holds {tuple(state.knows.shape)}, cfg "
                         f"{(n, E)}")
    # A shard emits only the slots of links leaving its own segments.
    budget = outbox_budget(spd * S * U, d_shards)
    consts = geo_constants(cfg, dev)
    me = torch.arange(d_shards, device=dev)[:, None]
    rows_g = torch.arange(n, dtype=torch.int32, device=dev).view(
        d_shards, blk)
    src_owner = (consts.src // spd)[:, None].expand(S2, U).reshape(-1)
    emits = src_owner[None, :] == me                    # [D, S2*U]

    outs = (
        torch.empty((steps, S), dtype=torch.int32, device=dev),
        *(torch.empty((steps, S2), dtype=torch.int32, device=dev)
          for _ in range(4)),
        torch.empty(steps, dtype=torch.int32, device=dev),
        torch.empty(steps, dtype=torch.int32, device=dev),
    )
    ob_ov = torch.zeros((), dtype=torch.int32, device=dev)
    st = state
    for t in range(steps):
        k_lan, k_gossip, k_tgt, k_loss = split(fold_in(key, t), 4).unbind(-2)
        knows = st.knows.view(d_shards, blk, E)
        senders, got_lan = lan_arrivals(knows, st.tx_lan.view(d_shards, blk, E),
                                        rows_g, k_lan, cfg)
        bk, bk_cnt = bridge_known(knows, cfg)
        step = link_plane(st, bk, bk_cnt, k_gossip, k_tgt, k_loss, cfg,
                          consts)

        recv_f = step.recv.reshape(-1)
        ev_f = step.ev_slot.reshape(-1)
        okf = step.live.reshape(-1)[None, :] & emits     # [D, S2*U]
        dest = (recv_f // blk).to(torch.int64)[None, :].expand(d_shards, -1)
        local = okf & (dest == me)
        # Shard me's local index (recv - me*blk)*E + ev is the global
        # index recv*E + ev of the [D*blk*E] plane.
        flat = recv_f.to(torch.int64) * E + ev_f
        hits = torch.zeros(n * E + 1, dtype=torch.bool, device=dev)
        hits[torch.where(local, flat[None, :], n * E).reshape(-1)] = True
        cols = tuple(c[None, :].expand(d_shards, -1) for c in (recv_f, ev_f))
        packed, dropped = pack_outbox(dest, okf & (dest != me), cols,
                                      d_shards, budget)
        ib_recv, ib_ev = exchange_outbox(packed, backend=exchange)
        flat_in = torch.where(ib_recv >= 0,
                              ib_recv.to(torch.int64) * E + ib_ev, n * E)
        hits[flat_in.reshape(-1)] = True
        got_wan = hits[:n * E].view(d_shards, blk, E) & ~knows
        ob_ov = ob_ov + torch.sum(dropped, dtype=torch.int32)

        new_knows, tx_lan = merge(knows, st.tx_lan.view(d_shards, blk, E),
                                  senders, got_lan | got_wan, cfg)
        for o, v in zip(outs, (per_segment_done(new_knows, cfg), step.offered,
                               step.admitted, step.queued, step.overflow,
                               step.wasted, ob_ov)):
            o[t] = v
        st = GeoState(
            knows=new_knows.view(n, E), tx_lan=tx_lan.view(n, E),
            ring=step.ring, queue=step.queue, known_hist=step.known_hist,
            ewma=step.ewma, wasted=step.wasted, tick=st.tick + 1,
        )
    return st, outs
