"""Pipelined chunked event broadcast under sustained load, on tensors.

The port of ``consul_tpu/streamcast/model.py``.  The broadcast model
delivers one point event; this model gossips a continuous stream of
events (Serf user-event traffic) along the two axes of "The Algorithm of
Pipelined Gossiping":

* **chunking**: an event is E chunks, a node holds a per-event chunk
  mask (``chunks`` bool[n, W, E]) and has the event once all E landed;
* **pipelining**: up to W events are in flight in a fixed window, and a
  node services at most ``chunk_budget`` slots a round, one chunk to
  ``fanout`` targets each, so its bandwidth is bounded whatever the
  number of events in flight.

``policy`` picks which held chunk a serviced slot pushes
(:func:`select_chunk`): ``uniform`` draws one at random, ``pipeline``
cycles a per-(node, slot) cursor through the held chunks, ``rarest``
takes the lowest-index held chunk not yet pushed this cycle.  Arrivals
are a static schedule of K events: explicit ``schedule`` tuples, or
Poisson at ``rate`` events a tick, shaped by the adversarial generators
of :mod:`consul_tpu_torch.sim.load`.  Window overflow and coalescing are
counted (:mod:`consul_tpu_torch.streamcast.window`).

At ``window=1, chunks=1`` with one scheduled event a round draws the
same streams and does the same delivery arithmetic as
``broadcast_round``.

A round is built from stages (:func:`admit_stage`,
:func:`service_stage`, the delivery, :func:`finish_stage`) over node
planes of any leading shape, so the sharded twin
(``parallel/shard.py``) runs them on ``[D, blk, ...]`` planes with its
own routed delivery.  A sweep runs U universes at once: a leading
universe axis on every plane (window ``[U, W]``, nodes ``[U, n, W,
...]``, schedule ``[U, K]``, counters and ``tick`` ``[U]``), with
``loss``, ``rate``, ``chunk_budget``, ``size_tail``, ``hotspot`` and
(aggregate) ``fanout`` as ``[U]`` knobs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch.device import device_scalar, resolve_device
from consul_tpu_torch.ops import (
    bernoulli_mask_owned,
    exponential,
    fold_in,
    owned_uniform,
    randint,
    sample_peers_owned,
    split,
    xla_math,
)
from consul_tpu_torch.ops.knobs import is_knob, lift
from consul_tpu_torch.protocol import LAN, GossipProfile, retransmit_limit
from consul_tpu_torch.sim.faults import FaultSchedule, extra_loss_at
from consul_tpu_torch.sim.load import (
    heavy_tail_sizes,
    hotspot_origins,
    paced_ticks,
    rate_reciprocal,
    standing_backlog,
    traced_rate,
)
from consul_tpu_torch.streamcast.window import admit, retire

# Salts folded into the round key (tie-breaks, chunk choice) and the scan
# key (the schedule and its adversarial draws), far above any round index.
_AUX_SALT = 0x73C00000
_SCHED_SALT = 0x73C00001
_SIZE_SALT = 0x73C00002
_HOT_SALT = 0x73C00003

#: Chunk selection policies (``StreamcastConfig.policy``).
POLICIES = ("uniform", "pipeline", "rarest")

_I32 = torch.int32


def cursor_dtype(chunks: int) -> torch.dtype:
    """Narrowest signed dtype holding a cursor in [0, chunks] (``rarest``
    parks it at ``chunks``): int8 up to 127 chunks, int16 beyond."""
    return torch.int8 if chunks <= 127 else torch.int16


def cursor_phase(rows: torch.Tensor, e_chunks: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Per-node starting cursor at slot fill, ``global_id % E``: a phase
    that keeps the population's round-robin out of lockstep."""
    return (rows % e_chunks).to(dtype)


@dataclasses.dataclass(frozen=True)
class StreamcastConfig:
    """Parameters of a streamcast study.

    Exactly one arrival mode: ``schedule``, ``((tick, origin, name[,
    chunks]), ...)`` in non-decreasing tick order (name -1 never
    coalesces), or Poisson at ``rate`` events a tick with ``events`` = K
    the schedule's capacity.  ``names`` > 0 draws Poisson names from
    [0, names).  ``backlog``, ``arrivals="paced"``, ``size_tail`` and
    ``hotspot`` shape the Poisson stream only.  ``faults`` takes loss
    ramps only.  ``done_frac`` is the delivered fraction at which an
    event counts as delivered and its slot retires."""

    n: int
    events: int = 0                 # K: Poisson schedule capacity
    chunks: int = 1                 # E chunks per event
    window: int = 1                 # W concurrent in-flight slots
    fanout: int | None = None
    chunk_budget: int = 1           # slots serviced per node per round
    retransmit_mult: int | None = None
    loss: float = 0.0
    rate: float = 0.0               # Poisson offered load, events/tick
    schedule: tuple = ()            # ((tick, origin, name[, chunks]), ...)
    names: int = 0                  # Poisson name-space size (0 = unnamed)
    policy: str = "uniform"         # chunk selection schedule (POLICIES)
    arrivals: str = "poisson"       # Poisson gaps | "paced" stagger
    backlog: int = 0                # arrivals pre-pinned to tick 0
    size_tail: float = 0.0          # Pareto tail index of event sizes
    hotspot: float = 0.0            # fraction re-originated at the hot node
    hotspot_node: int = 0
    done_frac: float = 1.0
    profile: GossipProfile = LAN
    delivery: str = "edges"
    faults: FaultSchedule = FaultSchedule()

    def __post_init__(self):
        if self.delivery not in ("edges", "aggregate"):
            raise ValueError(
                f"delivery must be 'edges' or 'aggregate', "
                f"got {self.delivery!r}"
            )
        if self.fanout is None:
            object.__setattr__(self, "fanout", self.profile.gossip_nodes)
        if self.retransmit_mult is None:
            object.__setattr__(
                self, "retransmit_mult", self.profile.retransmit_mult
            )
        if self.chunks < 1 or self.window < 1:
            raise ValueError(
                f"chunks={self.chunks} and window={self.window} must be >= 1"
            )
        if not is_knob(self.chunk_budget) and self.chunk_budget < 1:
            raise ValueError(f"chunk_budget={self.chunk_budget} must be >= 1")
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy={self.policy!r} is not a chunk-selection policy; "
                f"choose from {POLICIES}"
            )
        if self.arrivals not in ("poisson", "paced"):
            raise ValueError(
                f"arrivals={self.arrivals!r} is not an arrival process; "
                "choose 'poisson' (exponential gaps) or 'paced' "
                "(constant-interval stagger)"
            )
        if self.backlog < 0:
            raise ValueError(f"backlog={self.backlog} must be >= 0")
        if not is_knob(self.size_tail) and self.size_tail < 0.0:
            raise ValueError(
                f"size_tail={self.size_tail} must be >= 0 (a Pareto tail "
                "index; 0 disables heavy-tailed sizes)"
            )
        if not is_knob(self.hotspot) and not 0.0 <= self.hotspot <= 1.0:
            raise ValueError(f"hotspot={self.hotspot} outside [0, 1]")
        if not 0 <= self.hotspot_node < self.n:
            raise ValueError(
                f"hotspot_node={self.hotspot_node} outside [0, {self.n})"
            )
        if not 0.0 < self.done_frac <= 1.0:
            raise ValueError(f"done_frac={self.done_frac} outside (0, 1]")
        if (self.faults.partitions or self.faults.degraded
                or self.faults.churn or self.faults.bandwidth):
            raise ValueError(
                "streamcast consumes loss ramps only; partitions, degraded "
                "sets and churn model membership dynamics this plane does "
                "not simulate, and bandwidth schedules cap the geo/WAN "
                "link plane"
            )
        if self.schedule:
            self._check_schedule()
        else:
            if not is_knob(self.rate) and self.rate <= 0.0:
                raise ValueError(
                    "pass exactly one arrival mode: schedule=(...) OR "
                    "rate= > 0"
                )
            if self.events < 1:
                raise ValueError(
                    "Poisson mode needs events=K (static schedule "
                    "capacity; size it to cover rate x steps with headroom)"
                )
            if self.backlog > self.events:
                raise ValueError(
                    f"backlog={self.backlog} exceeds the schedule capacity "
                    f"events={self.events}: the standing backlog is a "
                    "prefix of the K arrivals"
                )

    def _check_schedule(self):
        if is_knob(self.rate) or self.rate:
            raise ValueError(
                "pass exactly one arrival mode: schedule=(...) OR rate="
            )
        if self.events not in (0, len(self.schedule)):
            raise ValueError(
                f"events={self.events} disagrees with "
                f"len(schedule)={len(self.schedule)}; omit events in "
                "scheduled mode"
            )
        adversarial = (
            ("backlog", self.backlog),
            ("arrivals", self.arrivals != "poisson"),
            ("size_tail", is_knob(self.size_tail) or self.size_tail),
            ("hotspot", is_knob(self.hotspot) or self.hotspot),
        )
        for knob, val in adversarial:
            if val:
                raise ValueError(
                    f"{knob}= shapes the POISSON arrival stream; a "
                    "scheduled stream expresses it explicitly (tick-0 "
                    "entries for backlog, 4-tuple chunk counts for sizes, "
                    "repeated origins for the hotspot)"
                )
        last = None
        for entry in self.schedule:
            if len(entry) not in (3, 4):
                raise ValueError(
                    "schedule entries are (tick, origin, name) 3-tuples or "
                    f"(tick, origin, name, chunks) 4-tuples, got {entry!r}"
                )
            tick, origin, _name = entry[:3]
            if len(entry) == 4 and not 1 <= entry[3] <= self.chunks:
                raise ValueError(
                    f"schedule chunk count {entry[3]} outside "
                    f"[1, chunks={self.chunks}]"
                )
            if tick < 0:
                raise ValueError(f"schedule tick {tick} < 0")
            if last is not None and tick < last:
                raise ValueError(
                    "schedule ticks must be non-decreasing (event ids are "
                    "Lamport times)"
                )
            last = tick
            if not 0 <= origin < self.n:
                raise ValueError(
                    f"schedule origin {origin} outside [0, {self.n})"
                )

    @property
    def k_events(self) -> int:
        """K: the static arrival-schedule capacity."""
        return len(self.schedule) if self.schedule else self.events

    @property
    def done_target(self) -> int:
        """Nodes that must hold every chunk for delivery:
        ``ceil(done_frac * n)``, n itself at the default."""
        if self.done_frac >= 1.0:
            return self.n
        return max(1, math.ceil(self.done_frac * self.n))

    @property
    def tx_limit(self) -> int:
        """Per-slot transmit budget: each of the E chunks is owed its own
        ``retransmit_limit`` (E = 1 is the broadcast model's budget)."""
        return retransmit_limit(self.retransmit_mult, self.n) * self.chunks


class StreamcastState(NamedTuple):
    chunks: torch.Tensor           # bool[n, W, E]: chunk c of slot w held
    tx_left: torch.Tensor          # int32[n, W]: per-slot transmit budget
    cursor: torch.Tensor           # int8/16[n, W]: chunk cursor
    slot_event: torch.Tensor       # int32[W]: global event id, -1 free
    slot_birth: torch.Tensor       # int32[W]: arrival tick of the occupant
    offered: torch.Tensor          # int32: arrivals seen
    delivered: torch.Tensor        # int32: events retired fully delivered
    quiesced: torch.Tensor         # int32: events retired incomplete
    window_overflow: torch.Tensor  # int32: arrivals dropped, no free slot
    coalesced: torch.Tensor        # int32: events superseded by name
    tick: torch.Tensor             # int32 scalar


def streamcast_init(cfg: StreamcastConfig, device=None) -> StreamcastState:
    dev = resolve_device(device)
    n, w, e = cfg.n, cfg.window, cfg.chunks

    def zero():
        return torch.zeros((), dtype=_I32, device=dev)

    return StreamcastState(
        chunks=torch.zeros((n, w, e), dtype=torch.bool, device=dev),
        tx_left=torch.zeros((n, w), dtype=_I32, device=dev),
        cursor=torch.zeros((n, w), dtype=cursor_dtype(e), device=dev),
        slot_event=torch.full((w,), -1, dtype=_I32, device=dev),
        slot_birth=torch.zeros((w,), dtype=_I32, device=dev),
        offered=zero(), delivered=zero(), quiesced=zero(),
        window_overflow=zero(), coalesced=zero(), tick=zero(),
    )


def arrival_arrays(cfg: StreamcastConfig, key: torch.Tensor):
    """``(ev_tick, ev_origin, ev_name, ev_chunks)`` int32[K] on ``key``'s
    device: the scheduled tuples (3-tuples take the full E), or the
    Poisson stream drawn from ``key`` (gaps ``exponential / rate`` summed
    as XLA sums them, or the paced stagger; then backlog, origins with
    the hotspot, names and heavy-tailed sizes, each regime on its own
    salted key).  A key batch ``[U, 2]`` gives ``[U, K]`` schedules, one
    per universe; a swept ``rate`` divides truly, as the reference's
    traced program does."""
    dev = key.device
    k = cfg.k_events
    batch = tuple(key.shape[:-1])
    if cfg.schedule:
        cols = np.asarray(
            [(*e[:3], e[3] if len(e) == 4 else cfg.chunks)
             for e in cfg.schedule], dtype=np.int32,
        )
        return tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                     .expand(*batch, k) for c in cols.T)
    k_gap, k_org, k_name = split(key, 3).unbind(-2)
    if cfg.arrivals == "paced":
        ev_tick = paced_ticks(k, cfg.rate, dev)
    elif is_knob(cfg.rate):
        gaps = exponential(k_gap, (k,)) / traced_rate(cfg.rate)
        ev_tick = torch.floor(xla_math.cumsum(gaps)).to(_I32)
    else:
        recip = device_scalar(rate_reciprocal(cfg.rate), torch.float32, dev)
        gaps = exponential(k_gap, (k,)) * recip
        ev_tick = torch.floor(xla_math.cumsum(gaps)).to(_I32)
    ev_tick = standing_backlog(ev_tick, cfg.backlog)
    ev_origin = randint(k_org, (k,), 0, cfg.n)
    ev_origin = hotspot_origins(fold_in(key, _HOT_SALT), ev_origin,
                                cfg.hotspot, cfg.hotspot_node)
    if cfg.names > 0:
        ev_name = randint(k_name, (k,), 0, cfg.names)
    else:
        ev_name = torch.full((*batch, k), -1, dtype=_I32, device=dev)
    ev_chunks = heavy_tail_sizes(fold_in(key, _SIZE_SALT), k, cfg.chunks,
                                 cfg.size_tail)
    return tuple(x.expand(*batch, k)
                 for x in (ev_tick, ev_origin, ev_name, ev_chunks))


def _p_live(cfg: StreamcastConfig, tick: torch.Tensor):
    """Per-copy survival probability this round: ``1 - loss``, times the
    ramps' survival where there are ramps, in the reference's order.  A
    Python float in a plain run without ramps, else a ``[*B]`` tensor."""
    loss = cfg.loss
    if is_knob(loss):
        base = 1.0 - loss.to(device=tick.device, dtype=torch.float32)
    elif cfg.faults.ramps:
        base = device_scalar(1.0 - loss, torch.float32, tick.device)
    else:
        return 1.0 - loss
    if cfg.faults.ramps:
        return base * (1.0 - extra_loss_at(cfg.faults, tick))
    return base


def over_nodes(x: torch.Tensor, nb: int, nrows: int) -> torch.Tensor:
    """A window plane ``[*B, W, ...]`` (``nb`` universe axes) shaped to
    broadcast against node planes ``[*B, *rows, W, ...]``."""
    return x.reshape(*x.shape[:nb], *([1] * nrows), *x.shape[nb:])


def chunk_validity(slot_event: torch.Tensor, ev_chunks: torch.Tensor,
                   e_chunks: int) -> torch.Tensor:
    """bool[*B, W, E]: chunk c of a slot is real iff ``c < ev_chunks`` of
    its occupant; the rest is heavy-tail padding, born delivered.  Free
    slots read event 0's count (every consumer is occupancy-gated)."""
    nch = torch.gather(ev_chunks, -1, torch.clamp(slot_event, min=0).long())
    cidx = torch.arange(e_chunks, dtype=_I32, device=slot_event.device)
    return cidx < nch[..., None]


def select_chunk(cfg: StreamcastConfig, k_chunk: torch.Tensor,
                 rows: torch.Tensor, held_real: torch.Tensor,
                 cursor: torch.Tensor, serviced: torch.Tensor):
    """Which held chunk a serviced slot pushes: ``(sel int32[..., W],
    next_cursor)`` for ``held_real`` bool[..., W, E] over the node
    ``rows``.  ``sel`` indexes a held real chunk wherever one exists.

      uniform   argmax of a fresh per-(node, slot) uniform over the held
                chunks (the only policy that draws)
      pipeline  the held chunk at the smallest cyclic distance from the
                cursor; the cursor moves past it on service
      rarest    the lowest-index held chunk at or past the cursor, else
                the lowest held (the cursor runs to E, "cycle spent")
    """
    e_chunks = held_real.shape[-1]
    if cfg.policy == "uniform":
        g = owned_uniform(k_chunk, rows, tuple(held_real.shape[-2:]))
        sel = torch.argmax(torch.where(held_real, g, -1.0), dim=-1)
        return sel.to(_I32), cursor
    cidx = torch.arange(e_chunks, dtype=_I32, device=held_real.device)
    cur = cursor.to(_I32)[..., None]
    if cfg.policy == "pipeline":
        dist = torch.remainder(cidx - cur, e_chunks)
        sel = torch.argmin(torch.where(held_real, dist, e_chunks),
                           dim=-1).to(_I32)
        nxt = torch.where(serviced, (sel + 1) % e_chunks, cursor.to(_I32))
        return sel, nxt.to(cursor.dtype)
    score = torch.where(
        held_real & (cidx >= cur), cidx,
        torch.where(held_real, cidx + e_chunks, 2 * e_chunks),
    )
    sel = torch.argmin(score, dim=-1).to(_I32)
    nxt = torch.where(serviced, sel + 1, cursor.to(_I32))
    return sel, nxt.to(cursor.dtype)


class Admitted(NamedTuple):
    """The window and node planes after a tick's admission and seeding."""

    slot_event: torch.Tensor
    slot_birth: torch.Tensor
    chunks: torch.Tensor       # bool[..., W, E]
    tx_left: torch.Tensor      # int32[..., W]
    cursor: torch.Tensor       # [..., W]
    occ: torch.Tensor          # bool[*B, W]
    cvalid: torch.Tensor       # bool[*B, W, E]
    arrive: torch.Tensor       # bool[*B, K]
    overflow: torch.Tensor     # int32 [*B]: this tick's window overflow
    coalesced: torch.Tensor    # int32 [*B]: this tick's supersedes

    def nodes(self, x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """A window plane of this tick against the node planes of
        ``rows``."""
        return over_nodes(x, self.occ.dim() - 1, rows.dim())


def admit_stage(state: StreamcastState, cfg: StreamcastConfig, sched: tuple,
                rows: torch.Tensor) -> Admitted:
    """Arrivals and window admission (replicated), then the node planes of
    ``rows`` (global ids, any leading shape; the state's planes shaped
    ``[*B, *rows.shape, W, ...]``): fresh or freed slots cleared and
    their cursors re-phased, each new origin seeded with a full budget,
    and heavy-tail padding chunks born delivered everywhere."""
    ev_tick, ev_origin, ev_name, ev_chunks = sched
    t = state.tick
    nb, nrows = t.dim(), rows.dim()

    def nodes(x):
        return over_nodes(x, nb, nrows)

    arrive = ev_tick == t[..., None]
    slot_event, slot_birth, filled, freed, ov, co = admit(
        state.slot_event, state.slot_birth, arrive, ev_name, t
    )
    fresh = nodes(freed | filled)                            # [W]
    chunks = state.chunks & ~fresh[..., None]
    tx_left = torch.where(fresh, 0, state.tx_left)
    cursor = torch.where(
        fresh, cursor_phase(rows, cfg.chunks, state.cursor.dtype)[..., None],
        state.cursor,
    )
    org = torch.gather(ev_origin, -1, torch.clamp(slot_event, min=0).long())
    seed = nodes(filled) & (rows[..., None] == nodes(org))   # [..., W]
    occ = slot_event >= 0
    cvalid = chunk_validity(slot_event, ev_chunks, cfg.chunks)
    born = nodes(occ[..., None] & ~cvalid)
    chunks = chunks | seed[..., None] | born
    tx_left = torch.where(seed, cfg.tx_limit, tx_left)
    return Admitted(slot_event, slot_birth, chunks, tx_left, cursor, occ,
                    cvalid, arrive, ov, co)


def service_stage(cfg: StreamcastConfig, k_tie: torch.Tensor,
                  k_chunk: torch.Tensor, rows: torch.Tensor, adm: Admitted):
    """Each node services its top-``chunk_budget`` eligible slots (highest
    remaining budget, a per-(node, slot) uniform tie-break, then slot
    index so that the bound is exact) and picks the chunk each pushes.
    Returns ``(held_real, serviced, sel, cursor)``."""
    w_slots = cfg.window
    held_real = adm.chunks & adm.nodes(adm.cvalid, rows)
    eligible = (torch.any(held_real, dim=-1) & (adm.tx_left > 0)
                & adm.nodes(adm.occ, rows))
    prio = torch.where(eligible, adm.tx_left.to(torch.float32),
                       -math.inf) + owned_uniform(k_tie, rows, (w_slots,))
    widx = torch.arange(w_slots, dtype=_I32, device=prio.device)
    ahead = (prio[..., None, :] > prio[..., :, None]) | (
        (prio[..., None, :] == prio[..., :, None])
        & (widx[None, :] < widx[:, None])
    )
    rank = torch.sum(ahead, dim=-1, dtype=_I32)
    budget = cfg.chunk_budget
    if is_knob(budget):
        budget = lift(budget.to(rank.device), rows.dim() + 1)
    serviced = eligible & (rank < budget)
    sel, cursor = select_chunk(cfg, k_chunk, rows, held_real, adm.cursor,
                               serviced)
    return held_real, serviced, sel, cursor


def edge_messages(cfg: StreamcastConfig, k_sel: torch.Tensor,
                  k_loss: torch.Tensor, rows: torch.Tensor,
                  serviced: torch.Tensor, sel: torch.Tensor, p_live):
    """The (sender, slot, target) messages of the serviced slots in the
    reference's ``[rows, W, F]`` order, the last row axis flattened with
    the slot and target axes: ``(recv, wix, cix, ok)``, each
    ``[*B, *rows.shape[:-1], rows.shape[-1] * W * F]`` (one stream a shard
    or a universe)."""
    w_slots, fanout = cfg.window, cfg.fanout
    targets = sample_peers_owned(k_sel, rows, cfg.n, fanout)  # [..., F]
    if isinstance(p_live, torch.Tensor) and p_live.dim():
        p_live = lift(p_live, rows.dim() + 2)
    ok = serviced[..., None] & bernoulli_mask_owned(
        k_loss, rows, (w_slots, fanout), p_live
    )
    shape = (*targets.shape[:-1], w_slots, fanout)
    recv = targets[..., None, :].expand(shape)
    wix = torch.arange(w_slots, dtype=_I32,
                       device=rows.device)[:, None].expand(shape)
    cix = sel[..., None].expand(shape)
    lead = targets.shape[:-2]
    return tuple(x.reshape(*lead, -1) for x in (recv, wix, cix, ok))


def chunk_index(cfg: StreamcastConfig, recv: torch.Tensor, wix: torch.Tensor,
                cix: torch.Tensor) -> torch.Tensor:
    """int64 flat index ``(recv * W + wix) * E + cix`` of the global
    ``[n, W, E]`` chunk plane."""
    return ((recv.long() * cfg.window + wix) * cfg.chunks + cix)


def aggregate_rate(cfg: StreamcastConfig, held_real: torch.Tensor,
                   serviced: torch.Tensor, sel: torch.Tensor, p_live,
                   node_sum, nb: int = 0) -> torch.Tensor:
    """float32[..., W, E]: each receiver's Poisson intensity per (slot,
    chunk) class, the class's sender count over all nodes (``node_sum``,
    exact: its terms are 0 and 1) less the receiver's own copies, times
    ``fanout * p_live / (n - 1)`` in the reference's operation order.
    ``nb`` counts the universe axes in front of the node axis."""
    dev = held_real.device
    cidx = torch.arange(cfg.chunks, dtype=_I32, device=dev)
    onehot = held_real & (sel[..., None] == cidx)
    contrib = (serviced[..., None] & onehot).to(torch.float32)
    # The node axes (one, or the sharded plane's [D, blk]) sit between
    # the universe axes and the trailing [W, E].
    s_tot = over_nodes(node_sum(contrib), nb, contrib.dim() - nb - 2)
    fanout, trailing = cfg.fanout, contrib.dim() - nb
    if is_knob(fanout):
        fanout = lift(fanout.to(device=dev, dtype=torch.float32), trailing)
    else:
        fanout = device_scalar(fanout, torch.float32, dev)
    if isinstance(p_live, torch.Tensor) and p_live.dim():
        p_live = lift(p_live, trailing)
    lam = (s_tot - contrib) * fanout
    lam = lam * device_scalar(p_live, torch.float32, dev)
    return lam / device_scalar(max(cfg.n - 1, 1), torch.float32, dev)


def aggregate_arrivals_chunks(cfg: StreamcastConfig, k_loss: torch.Tensor,
                              rows: torch.Tensor, lam: torch.Tensor):
    """bool[..., W, E]: >= 1 copy of each class arrived, ``u < 1 -
    exp(-lam)`` with ``u`` the owned uniform of ``rows`` (all copies of a
    class are identical, so the count is sufficient)."""
    u = owned_uniform(k_loss, rows, (cfg.window, cfg.chunks))
    return u < -torch.expm1(-lam)


def finish_stage(state: StreamcastState, cfg: StreamcastConfig,
                 adm: Admitted, new_chunks: torch.Tensor,
                 serviced: torch.Tensor, cursor: torch.Tensor, node_sum):
    """Budget spend, completion and retirement: ``(next_state, outs)``
    with ``outs`` the per-tick ``(slot_event, slot_birth, done_count,
    offered, delivered, quiesced, window_overflow, coalesced, sent)``.
    ``node_sum`` sums a ``[*B, ..., W]`` plane over the nodes."""
    t = state.tick
    nb = t.dim()
    nrows = serviced.dim() - nb - 1

    def nodes(x):
        return over_nodes(x, nb, nrows)

    fanout = cfg.fanout
    spent_f = lift(fanout.to(t.device), nrows + 1) if is_knob(fanout) \
        else fanout
    sent = torch.sum(serviced, dim=tuple(range(nb, serviced.dim())),
                     dtype=_I32) * fanout
    spent = torch.where(serviced, spent_f, 0).to(_I32)
    tx_left = torch.clamp(adm.tx_left - spent, min=0)
    newly = torch.any(new_chunks & ~adm.chunks, dim=-1)
    tx_left = torch.where(newly, cfg.tx_limit, tx_left)

    full = torch.all(new_chunks, dim=-1) & nodes(adm.occ)
    done_count = node_sum(full.to(_I32))                      # [W]
    # Active senders hold a REAL chunk: padding never keeps a slot busy.
    active = node_sum((torch.any(new_chunks & nodes(adm.cvalid), dim=-1)
                       & (tx_left > 0)).to(_I32))
    cleared, complete, quiesced = retire(
        adm.slot_event, done_count, active, adm.slot_birth, t,
        cfg.done_target,
    )
    offered = state.offered + torch.sum(adm.arrive, dim=-1, dtype=_I32)
    delivered = state.delivered + torch.sum(complete, dim=-1, dtype=_I32)
    quiesced_ct = state.quiesced + torch.sum(quiesced, dim=-1, dtype=_I32)
    overflow = state.window_overflow + adm.overflow
    coalesced = state.coalesced + adm.coalesced
    outs = (adm.slot_event, adm.slot_birth, done_count, offered, delivered,
            quiesced_ct, overflow, coalesced, sent)
    cleared_n = nodes(cleared)
    nxt = StreamcastState(
        chunks=new_chunks & ~cleared_n[..., None],
        tx_left=torch.where(cleared_n, 0, tx_left),
        cursor=torch.where(cleared_n, 0, cursor),
        slot_event=torch.where(cleared, -1, adm.slot_event),
        slot_birth=adm.slot_birth,
        offered=offered,
        delivered=delivered,
        quiesced=quiesced_ct,
        window_overflow=overflow,
        coalesced=coalesced,
        tick=t + 1,
    )
    return nxt, outs


def round_keys(key: torch.Tensor):
    """``(k_sel, k_loss, k_tie, k_chunk)``: the target and loss draws split
    as ``broadcast_round`` splits them, the rest from a salted fold-in."""
    k_sel, k_loss = split(key).unbind(-2)
    k_tie, k_chunk = split(fold_in(key, _AUX_SALT)).unbind(-2)
    return k_sel, k_loss, k_tie, k_chunk


def streamcast_round(state: StreamcastState, key: torch.Tensor,
                     cfg: StreamcastConfig, sched: tuple):
    """One gossip tick of the pipelined stream: ``(next_state, outs)``
    (:func:`finish_stage`).  The window snapshots are taken after
    admission and before retirement."""
    n, w_slots, e_chunks = cfg.n, cfg.window, cfg.chunks
    nb = state.tick.dim()
    k_sel, k_loss, k_tie, k_chunk = round_keys(key)
    rows = torch.arange(n, dtype=_I32, device=key.device)

    def sum_nodes(x):
        return torch.sum(x, dim=nb, dtype=x.dtype)

    adm = admit_stage(state, cfg, sched, rows)
    held_real, serviced, sel, cursor = service_stage(cfg, k_tie, k_chunk,
                                                     rows, adm)
    p_live = _p_live(cfg, state.tick)
    if cfg.delivery == "edges":
        recv, wix, cix, ok = edge_messages(cfg, k_sel, k_loss, rows,
                                           serviced, sel, p_live)
        size = n * w_slots * e_chunks
        flat = torch.where(ok, chunk_index(cfg, recv, wix, cix), size)
        if nb:
            base = torch.arange(state.tick.numel(), device=key.device)
            flat = flat + base.view(*state.tick.shape, 1) * (size + 1)
        hits = torch.zeros((*state.tick.shape, size + 1), dtype=torch.bool,
                           device=key.device)
        hits.view(-1)[flat.reshape(-1)] = True
        new_chunks = adm.chunks | hits[..., :size].view(
            *state.tick.shape, n, w_slots, e_chunks)
    else:
        lam = aggregate_rate(cfg, held_real, serviced, sel, p_live,
                             sum_nodes, nb)
        new_chunks = adm.chunks | aggregate_arrivals_chunks(cfg, k_loss,
                                                            rows, lam)
    return finish_stage(state, cfg, adm, new_chunks, serviced, cursor,
                        sum_nodes)
