"""Full-membership SWIM on PyTorch tensors: every node's view of every node.

The port of ``consul_tpu/models/membership.py``.  Where ``models/swim.py``
follows one subject, this model carries the complete N x N view the
reference's memberlist keeps per member (state.go nodeState), so
concurrent failures interact through shared gossip bandwidth, joins and
graceful leaves spread, and the periodic push/pull anti-entropy closes
the tails (state.go:622-657 pushPull, :1283 mergeState).

State (observer i = rows, subject j = columns):

  key[i, j]            int32 -- i's view of j as (incarnation << 2) | rank,
                       rank ALIVE=0 < SUSPECT=1 < DEAD=2 < LEFT=3, or -1
                       while i has never heard of j.  Integer order of keys
                       is the protocol's merge precedence, so every
                       delivery is one max().
  suspect_since[i, j]  int32 -- tick i began suspecting j; NEVER otherwise
  confirms[i, j]       int32 -- independent suspicion confirmations
  tx[i, j]             int32 -- retransmissions left of i's queued message
                       about j (the name-keyed TransmitLimitedQueue)
  own_inc, awareness, probe_pending_at, probe_subject  int32[n]
  tick                 int32 scalar

A round never writes into the state it was given and reads nothing back
to the host.  It also runs a sweep's U universes at once: planes ``[U, n,
n]`` and ``[U, n]``, ``tick`` ``[U]``, keys ``[U, 2]``, and ``loss`` and
``suspicion_scale`` may be ``[U]`` knobs (``ops/knobs``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from consul_tpu_torch.device import device_scalar, resolve_device
from consul_tpu_torch.models.swim import (
    probe_fail_prob,
    scaled_bounds_ticks,
    timeout_table,
    traced_timeout_table,
)
from consul_tpu_torch.ops import (
    bernoulli_mask,
    owned_uniform_rows,
    sample_peers,
    sample_probe_targets,
    split,
)
from consul_tpu_torch.ops.knobs import col, is_knob, keep_prob, lift
from consul_tpu_torch.protocol import (
    LAN,
    GossipProfile,
    retransmit_limit,
    suspicion_timeout_bounds,
)

RANK_ALIVE = 0
RANK_SUSPECT = 1
RANK_DEAD = 2
RANK_LEFT = 3

NEVER = 2 ** 31 - 1  # int32 max: "no timer" / "no probe pending"


def make_key(inc, rank):
    """Precedence key ``(inc << 2) | rank``."""
    return (inc << 2) | rank


def key_rank(k: torch.Tensor) -> torch.Tensor:
    """Rank of a view key; -1 for unknown cells."""
    return torch.where(k >= 0, k & 3, -1)


def key_inc(k: torch.Tensor) -> torch.Tensor:
    """Incarnation of a view key; 0 for unknown cells."""
    return torch.where(k >= 0, k >> 2, 0)


@dataclasses.dataclass(frozen=True)
class MembershipConfig:
    """Static parameters of a full-membership study.

    Schedules are tuples of ``(node, tick)``: ``fail_at`` crashes,
    ``leave_at`` graceful departures (the LEFT intent is gossiped for
    ``leave_grace_ticks`` first), ``join_at`` late joiners (known to
    nobody until their first push/pull lands, memberlist.go:249)."""

    n: int
    loss: float = 0.0
    profile: GossipProfile = LAN
    fanout: Optional[int] = None          # default: profile.gossip_nodes
    piggyback: int = 8                    # messages per compound packet
    fail_at: tuple = ()
    leave_at: tuple = ()
    join_at: tuple = ()
    probe_enabled: bool = True
    push_pull_enabled: bool = True
    leave_grace_ticks: int = 10
    suspicion_scale: float = 1.0

    def __post_init__(self):
        if self.fanout is None:
            object.__setattr__(self, "fanout", self.profile.gossip_nodes)

    @property
    def tx_limit(self) -> int:
        return retransmit_limit(self.profile.retransmit_mult, self.n)

    @property
    def probe_interval_ticks(self) -> int:
        return self.profile.probe_interval_ticks

    @property
    def probe_timeout_ticks(self) -> int:
        return self.profile.probe_timeout_ticks

    @property
    def push_pull_ticks(self) -> int:
        return self.profile.push_pull_interval_ticks

    @property
    def confirmations_k(self) -> int:
        # state.go:1186-1196: k = SuspicionMult - 2, or 0 if n-2 < k.
        k = self.profile.suspicion_mult - 2
        return 0 if self.n - 2 < k else k

    @property
    def suspicion_bounds_ticks(self) -> tuple[float, float]:
        lo_ms, hi_ms = suspicion_timeout_bounds(
            self.profile.suspicion_mult,
            self.profile.suspicion_max_timeout_mult,
            self.n,
            self.profile.probe_interval_ms,
        )
        return scaled_bounds_ticks(lo_ms, hi_ms,
                                   self.profile.gossip_interval_ms,
                                   self.suspicion_scale)

    @property
    def probe_fail_prob_alive(self) -> float:
        """P(a probe of a live target fails): the direct round trip (2
        legs) and every indirect path (4 legs) drop (state.go:326-454);
        float32 [U] arithmetic for a swept ``loss``."""
        return probe_fail_prob(self.loss, self.profile.indirect_checks)


class MembershipState(NamedTuple):
    key: torch.Tensor              # int32[n, n]
    suspect_since: torch.Tensor    # int32[n, n]
    confirms: torch.Tensor         # int32[n, n]
    tx: torch.Tensor               # int32[n, n]
    own_inc: torch.Tensor          # int32[n]
    awareness: torch.Tensor        # int32[n]
    probe_pending_at: torch.Tensor # int32[n]
    probe_subject: torch.Tensor    # int32[n]
    tick: torch.Tensor             # int32 scalar


def _schedule_array(n: int, pairs: tuple, default: int,
                    device) -> torch.Tensor:
    """int32[n] of ``default`` with each ``(node, tick)`` pair set.  Node
    ids are checked on the host: an out-of-range id would otherwise make
    a fault that never fires."""
    arr = torch.full((n,), default, dtype=torch.int32, device=device)
    for node, tick in pairs:
        if not -n <= node < n:
            raise IndexError(
                f"schedule entry ({node}, {tick}) is out of bounds for n={n}"
            )
        arr[node] = tick
    return arr


def membership_init(cfg: MembershipConfig, device=None) -> MembershipState:
    dev = resolve_device(device)
    n = cfg.n
    joiner = _schedule_array(n, cfg.join_at, 0, dev) > 0
    # Established members know each other as alive@0; joiners' rows and
    # columns start unknown except their own self-view.
    key = torch.zeros((n, n), dtype=torch.int32, device=dev)
    key = torch.where(joiner[None, :] | joiner[:, None], -1, key)
    key.diagonal().fill_(0)

    def full(value, shape):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    return MembershipState(
        key=key,
        suspect_since=full(NEVER, (n, n)),
        confirms=full(0, (n, n)),
        tx=full(0, (n, n)),
        own_inc=full(0, (n,)),
        awareness=full(0, (n,)),
        probe_pending_at=full(NEVER, (n,)),
        probe_subject=full(0, (n,)),
        tick=full(0, ()),
    )


class MembershipConstants(NamedTuple):
    """What a round reads that depends on the config alone, built once per
    study (:func:`membership_constants`)."""

    fail_tick: torch.Tensor   # int32[n]
    leave_tick: torch.Tensor  # int32[n]
    join_tick: torch.Tensor   # int32[n]
    timeout: torch.Tensor     # float32[k+1]: swim.timeout_table of cfg
    #                           (a swept suspicion_scale: [U, k+1])
    p_fail_alive: torch.Tensor  # float32 scalar (a swept loss: [U, 1])


def knob_column(x, device) -> torch.Tensor:
    """A config-derived float32 value as a factor of ``[*B, n]`` planes: a
    0-dim tensor for a Python number, a ``[U, 1]`` column for a swept
    ``[U]`` value."""
    if is_knob(x):
        return lift(x.to(device=device, dtype=torch.float32), 1)
    return device_scalar(x, torch.float32, device)


def membership_constants(cfg: MembershipConfig, device) -> MembershipConstants:
    n = cfg.n
    table = (traced_timeout_table(cfg) if is_knob(cfg.suspicion_scale)
             else timeout_table(cfg))
    return MembershipConstants(
        fail_tick=_schedule_array(n, cfg.fail_at, NEVER, device),
        leave_tick=_schedule_array(n, cfg.leave_at, NEVER, device),
        join_tick=_schedule_array(n, cfg.join_at, 0, device),
        timeout=table.to(device),
        p_fail_alive=knob_column(cfg.probe_fail_prob_alive, device),
    )


def table_at(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` elementwise for a ``[k+1]`` table, or per universe
    for a swept ``[U, k+1]`` table against ``[U, ...]`` indices."""
    if table.dim() == 1:
        return table[idx.long()]
    return torch.gather(table, -1, idx.flatten(1).long()).view(idx.shape)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a node plane ``[*B, n]`` and indices ``[*B, ...]``,
    each universe indexing its own row."""
    return torch.gather(x, -1, idx.reshape(*x.shape[:-1], -1).long()
                        ).view(idx.shape)


def ground_truth(t, fail_tick, leave_tick, join_tick, grace: int):
    """(present, leaving, participates) at tick ``t``.  The departure tick
    is clamped before the grace is added, so NEVER saturates."""
    present = t >= join_tick
    crashed = t >= fail_tick
    leaving = present & (t >= leave_tick) & ~crashed
    departed = present & ~crashed & (
        t >= torch.clamp(leave_tick, max=NEVER - grace) + grace
    )
    return present, leaving, present & ~crashed & ~departed


def top_slots(prio: torch.Tensor, m: int) -> torch.Tensor:
    """int64[rows, m]: the columns of the ``m`` largest entries of each row
    of float32 ``prio``, largest first, ties lowest column first -- the
    order of ``jax.lax.top_k``.  Each entry becomes a distinct int64 key
    (the float's order-preserving bits over the inverted column), so
    ``torch.topk`` has no ties left to order."""
    width = prio.shape[-1]
    bits = prio.view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    cols = torch.arange(width, dtype=torch.int64, device=prio.device)
    keyed = (ordered << 32) | (0xFFFFFFFF - cols)
    top = torch.topk(keyed, m, dim=-1, sorted=True).values
    return 0xFFFFFFFF - (top & 0xFFFFFFFF)


def diag(plane: torch.Tensor) -> torch.Tensor:
    """The diagonal of each ``[n, n]`` plane of ``[*B, n, n]``."""
    return plane.diagonal(dim1=-2, dim2=-1)


def _set_diag(plane: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    out = plane.clone()
    diag(out).copy_(values)
    return out


def _set_cols(plane: torch.Tensor, col: torch.Tensor, apply: torch.Tensor,
              value) -> torch.Tensor:
    """``plane`` with ``plane[..., i, col[i]] = value[i]`` in each row where
    ``apply`` (the reference's ``.at[rows, col].set(mode="drop")`` with
    the dropped rows pointing past the end)."""
    idx = torch.clamp(col, 0, plane.shape[-1] - 1).long()[..., None]
    cur = torch.gather(plane, -1, idx)[..., 0]
    value = device_scalar(value, plane.dtype, plane.device)
    new = torch.where(apply, value, cur)
    return plane.scatter(-1, idx, new[..., None])


def track_outputs(steps: int, n_track: int, known_dtype, device,
                  batch: tuple = ()):
    """Preallocated per-tick outputs of the membership scans: suspecting
    and dead_known [*batch, steps, S], suspect_cells and known_members
    [*batch, steps]."""
    def out(*shape, dtype=torch.int32):
        return torch.empty((*batch, steps, *shape), dtype=dtype,
                           device=device)

    return (out(n_track), out(n_track), out(), out(dtype=known_dtype))


def membership_counts(key_m: torch.Tensor, track_idx: torch.Tensor):
    """A dense tick's outputs: for each tracked subject the observers
    viewing it SUSPECT / DEAD (int32[*B, S] each), the global count of
    suspect cells and the sum of membership-list sizes (int32 [*B])."""
    ranks = key_rank(key_m)
    cols = ranks[..., track_idx]
    cells = (-2, -1)
    return (torch.sum(cols == RANK_SUSPECT, dim=-2, dtype=torch.int32),
            torch.sum(cols == RANK_DEAD, dim=-2, dtype=torch.int32),
            torch.sum(ranks == RANK_SUSPECT, dim=cells, dtype=torch.int32),
            torch.sum((key_m >= 0) & (ranks <= RANK_SUSPECT), dim=cells,
                      dtype=torch.int32))


class GossipStage(NamedTuple):
    """What the first stage of a tick leaves for the delivery: the site
    keys, the tick's ground truth, the re-stamped view and queue, and the
    gossip packets (``subj``/``msg_key``/``msg_valid`` [n, m] drained
    messages, ``targets``/``packet_ok`` [n, F])."""

    keys: tuple
    present: torch.Tensor
    leaving: torch.Tensor
    participates: torch.Tensor
    key_m: torch.Tensor
    tx: torch.Tensor
    subj: torch.Tensor
    msg_key: torch.Tensor
    msg_valid: torch.Tensor
    targets: torch.Tensor
    packet_ok: torch.Tensor


def gossip_stage(state: MembershipState, key_rng: torch.Tensor,
                 cfg: MembershipConfig,
                 consts: MembershipConstants) -> GossipStage:
    """The leave re-stamp and the gossip packets of a tick.  Every draw is
    keyed by global node id, so the sharded twin builds the same packets."""
    n, fanout = cfg.n, cfg.fanout
    m = min(cfg.piggyback, n)
    t = state.tick
    keys = split(key_rng, 7).unbind(-2)
    k_tie, k_tgt, k_loss = keys[:3]
    own_inc = state.own_inc

    present, leaving, participates = ground_truth(
        col(t), consts.fail_tick, consts.leave_tick, consts.join_tick,
        cfg.leave_grace_ticks)

    # Leave intent: the leaver re-stamps its self-view LEFT at its own
    # incarnation and gossips it; the self-view never regresses.
    self_view = diag(state.key)
    diag_val = torch.where(leaving, make_key(own_inc, RANK_LEFT),
                           make_key(own_inc, RANK_ALIVE))
    diag_val = torch.maximum(self_view, diag_val)
    key_m = _set_diag(state.key, torch.where(present, diag_val, self_view))
    tx = _set_diag(state.tx, torch.where(diag_val > self_view, cfg.tx_limit,
                                         diag(state.tx)))

    # 1. Gossip: the top-m queued messages (most retransmits left, random
    #    tie-break) go to each of ``fanout`` random targets in one packet.
    prio = tx.to(torch.float32) + owned_uniform_rows(k_tie, n, n)
    subj = top_slots(prio, m)                               # [n, m]
    msg_key = torch.gather(key_m, -1, subj)
    msg_valid = ((torch.gather(tx, -1, subj) > 0) & (msg_key >= 0)
                 & participates[..., None])

    targets = sample_peers(k_tgt, n, fanout).long()         # [n, F]
    tgt_view = torch.gather(key_m, -1, targets)
    # Senders gossip only to members they consider non-dead.
    tgt_sendable = (tgt_view >= 0) & (key_rank(tgt_view) <= RANK_SUSPECT)
    packet_ok = (participates[..., None] & tgt_sendable
                 & bernoulli_mask(k_loss, (n, fanout), keep_prob(cfg.loss, 2))
                 & take_rows(participates, targets))
    return GossipStage(keys, present, leaving, participates, key_m, tx, subj,
                       msg_key, msg_valid, targets, packet_ok)


def spend_gossip(g: GossipStage, fanout: int) -> torch.Tensor:
    """The queue after the gossip: one transmission per target packet per
    drained message, spent whether or not the packet survived
    (queue.go:288-373); the drained columns of a row are distinct."""
    spend = torch.where(g.msg_valid, fanout, 0).to(torch.int32)
    tx = g.tx.scatter(-1, g.subj, torch.gather(g.tx, -1, g.subj) - spend)
    return torch.clamp(tx, min=0)


def push_pull_draws(g: GossipStage, cfg: MembershipConfig):
    """(partner, pp_ok) of the push/pull anti-entropy: who initiates an
    exchange this tick, and with whom."""
    n = cfg.n
    k_pp, k_ppsel = g.keys[3:5]
    key_m = g.key_m
    known_cnt = torch.sum(
        (key_m >= 0) & (key_rank(key_m) <= RANK_SUSPECT), dim=-1)
    # A node that knows only itself (a joiner) syncs at once.
    needs_join = g.participates & (known_cnt <= 1)
    initiate = g.participates & (
        needs_join | bernoulli_mask(k_pp, (n,), 1.0 / cfg.push_pull_ticks)
    )
    partner = sample_probe_targets(k_ppsel, n).long()
    return partner, initiate & take_rows(g.participates, partner)


def row_of(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``plane[idx]`` of ``[*B, n, W]`` for indices ``[*B, ...]``:
    ``[*B, ..., W]``, each universe reading its own plane."""
    nb = plane.dim() - 2
    flat = idx.reshape(*idx.shape[:nb], -1).long()
    rows = torch.gather(plane, -2, flat[..., None].expand(
        *flat.shape, plane.shape[-1]))
    return rows.view(*idx.shape, plane.shape[-1])


def push_pull_full(key_rx: torch.Tensor, key_m: torch.Tensor,
                   partner: torch.Tensor, pp_ok: torch.Tensor) -> None:
    """Merge every exchange into ``key_rx`` ([*B, n + 1, n], the last row a
    sink), in place: the initiator merges the partner's row (pull), the
    partner the initiator's (push), as cellwise maxima."""
    n = key_m.shape[-1]
    key_rx[..., :n, :] = torch.maximum(
        key_rx[..., :n, :],
        torch.where(pp_ok[..., None], row_of(key_m, partner), -1))
    # Push: a row scatter-max; idle initiators point at the spare row.
    prow = torch.where(pp_ok, partner, n)
    key_rx.scatter_reduce_(-2, prow[..., None].expand(key_m.shape), key_m,
                           "amax")


def cell_rx(batch: tuple, n: int, device) -> torch.Tensor:
    """A flat ``[*batch, n + 1, n]`` receive plane of -1 (the last row of
    each universe a sink)."""
    return torch.full((*batch, (n + 1) * n), -1, dtype=torch.int32,
                      device=device)


def scatter_cells(rx: torch.Tensor, flat: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """Scatter-max ``vals`` at the per-universe cell indices ``flat``
    (``[*B, ...]``, ``recv * n + subj`` or the sink) into the flat receive
    planes ``rx`` ``[*B, (n + 1) * n]``, in place."""
    rx.scatter_reduce_(-1, flat.reshape(*rx.shape[:-1], -1),
                       vals.reshape(*rx.shape[:-1], -1), "amax")


def membership_round(state: MembershipState, key_rng: torch.Tensor,
                     cfg: MembershipConfig,
                     consts: MembershipConstants | None = None
                     ) -> MembershipState:
    """One tick.  ``consts`` is :func:`membership_constants` of ``cfg``,
    built here when not given."""
    n, fanout = cfg.n, cfg.fanout
    m = min(cfg.piggyback, n)
    dev = state.key.device
    if consts is None:
        consts = membership_constants(cfg, dev)
    g = gossip_stage(state, key_rng, cfg, consts)
    targets = g.targets
    batch = tuple(g.key_m.shape[:-2])

    # key_rx[r, s] = max key among arriving messages about s at r, in a
    # [n + 1, n] buffer whose last row takes every dropped message.
    ok3 = g.packet_ok[..., None] & g.msg_valid[..., None, :]
    flat = torch.where(ok3, targets[..., None] * n + g.subj[..., None, :],
                       n * n)
    val3 = g.msg_key[..., None, :].expand(*batch, n, fanout, m)
    key_rx = cell_rx(batch, n, dev)
    scatter_cells(key_rx, flat, val3)
    sus_val = torch.where(key_rank(val3) == RANK_SUSPECT, key_inc(val3), -1)
    sus_inc_rx = cell_rx(batch, n, dev)
    scatter_cells(sus_inc_rx, flat, sus_val)
    key_rx = key_rx.view(*batch, n + 1, n)
    sus_inc_rx = sus_inc_rx.view(*batch, n + 1, n)[..., :n, :]
    tx = spend_gossip(g, fanout)

    # 2. Push/pull anti-entropy: initiators exchange full state with one
    #    partner; both sides merge the cellwise max of the two rows.
    if cfg.push_pull_enabled:
        push_pull_full(key_rx, g.key_m, *push_pull_draws(g, cfg))
    return finish_round(state, g, tx, key_rx[..., :n, :], sus_inc_rx, cfg,
                        consts)


def finish_round(state: MembershipState, g: GossipStage, tx: torch.Tensor,
                 key_rx: torch.Tensor, sus_inc_rx: torch.Tensor,
                 cfg: MembershipConfig,
                 consts: MembershipConstants) -> MembershipState:
    """Refutation, the merge of the tick's deliveries (``key_rx``,
    ``sus_inc_rx`` [n, n], -1 where nothing arrived; ``key_rx`` is
    written), the probe plane and suspicion expiry."""
    n = cfg.n
    t = state.tick
    k_probe, k_pfail = g.keys[5:7]
    amax = cfg.profile.awareness_max_multiplier - 1
    present, leaving, participates = g.present, g.leaving, g.participates
    own_inc = state.own_inc
    awareness = state.awareness
    key_m = g.key_m

    # 3. Refutation: a node that hears itself suspected or declared dead
    #    at >= its incarnation re-asserts aliveness at accused + 1 and
    #    takes a health penalty (state.go:880-915).
    self_rx = diag(key_rx)
    accused = torch.where(key_rank(self_rx) >= RANK_SUSPECT,
                          key_inc(self_rx), -1)
    refuting = participates & ~leaving & (accused >= own_inc)
    own_inc = torch.where(refuting, accused + 1, own_inc)
    awareness = torch.clamp(awareness + refuting.to(torch.int32), 0, amax)
    # The self-view never merges from the wire; re-stamp it post-refute.
    diag(key_rx).fill_(-1)
    self_key = torch.where(leaving, make_key(own_inc, RANK_LEFT),
                           make_key(own_inc, RANK_ALIVE))
    old_key = _set_diag(key_m, torch.maximum(
        diag(key_m), torch.where(present, self_key, -1)))
    tx = _set_diag(tx, torch.where(refuting, cfg.tx_limit, diag(tx)))

    # 4. Merge the deliveries into the view.
    new_key = torch.maximum(old_key, key_rx)
    changed = new_key > old_key
    fresh_suspect = changed & (key_rank(new_key) == RANK_SUSPECT)
    suspect_since = torch.where(
        fresh_suspect, col(col(t)),
        torch.where(changed, NEVER, state.suspect_since))
    # A suspect message at the incarnation already suspected is an
    # independent confirmation, re-gossiped when it advances the count.
    confirming = (~changed & (key_rank(old_key) == RANK_SUSPECT)
                  & (sus_inc_rx >= key_inc(old_key)))
    new_confirms = torch.clamp(state.confirms + confirming.to(torch.int32),
                               max=cfg.confirmations_k)
    gained_conf = confirming & (new_confirms > state.confirms)
    confirms = torch.where(changed, 0, new_confirms)
    tx = torch.where(changed | gained_conf, cfg.tx_limit, tx)
    key_m = new_key

    # 5. Probe plane, every ProbeInterval (state.go:214-497).
    if cfg.probe_enabled:
        is_probe_tick = col((t % cfg.probe_interval_ticks) == 0)
        ptarget = sample_probe_targets(k_probe, n).long()
        pt_view = torch.gather(key_m, -1, ptarget[..., None])[..., 0]
        probing = (is_probe_tick & participates & (pt_view >= 0)
                   & (key_rank(pt_view) <= RANK_SUSPECT))
        p_fail = torch.where(take_rows(participates, ptarget),
                             consts.p_fail_alive, 1.0)
        failed = probing & bernoulli_mask(k_pfail, (n,), p_fail)
        # A failed probe matures after the probe cycle plus the timeout
        # scaled by the health score going into it (awareness.go:64).
        can_pend = failed & (state.probe_pending_at == NEVER)
        matures_at = (col(t) + cfg.probe_interval_ticks
                      + awareness * cfg.probe_timeout_ticks)
        awareness = torch.clamp(
            awareness + failed.to(torch.int32)
            - (probing & ~failed).to(torch.int32), 0, amax)
        probe_pending_at = torch.where(can_pend, matures_at,
                                       state.probe_pending_at)
        probe_subject = torch.where(can_pend, ptarget.to(torch.int32),
                                    state.probe_subject)

        # A crashed observer's pending probe never matures.
        mature = (probe_pending_at <= col(t)) & participates
        mview = torch.gather(key_m, -1,
                             probe_subject.long()[..., None])[..., 0]
        # Suspect at the incarnation on the view, only if it is ALIVE.
        apply_sus = mature & (key_rank(mview) == RANK_ALIVE)
        sus_key = make_key(key_inc(mview), RANK_SUSPECT)
        key_m = _set_cols(key_m, probe_subject, apply_sus, sus_key)
        suspect_since = _set_cols(suspect_since, probe_subject, apply_sus,
                                  col(t).expand(apply_sus.shape))
        confirms = _set_cols(confirms, probe_subject, apply_sus, 0)
        tx = _set_cols(tx, probe_subject, apply_sus, cfg.tx_limit)
        probe_pending_at = torch.where(mature, NEVER, probe_pending_at)
    else:
        probe_pending_at = state.probe_pending_at
        probe_subject = state.probe_subject

    # 6. Suspicion expiry -> DEAD at the suspicion's incarnation
    #    (state.go:1200-1215), Lifeguard-accelerated by confirmations.
    timeout = table_at(consts.timeout, confirms)
    elapsed = (col(col(t)) - suspect_since).to(torch.float32)
    expire = ((key_rank(key_m) == RANK_SUSPECT) & (suspect_since != NEVER)
              & (elapsed >= timeout) & participates[..., None])
    key_m = torch.where(expire, make_key(key_inc(key_m), RANK_DEAD), key_m)
    suspect_since = torch.where(expire, NEVER, suspect_since)
    tx = torch.where(expire, cfg.tx_limit, tx)

    return MembershipState(
        key=key_m, suspect_since=suspect_since, confirms=confirms, tx=tx,
        own_inc=own_inc, awareness=awareness,
        probe_pending_at=probe_pending_at, probe_subject=probe_subject,
        tick=t + 1,
    )
