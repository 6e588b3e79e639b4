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
to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from consul_tpu_torch.device import device_scalar, resolve_device
from consul_tpu_torch.models.swim import timeout_table
from consul_tpu_torch.ops import (
    bernoulli_mask,
    owned_uniform_rows,
    sample_peers,
    sample_probe_targets,
    split,
)
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
        g = self.profile.gossip_interval_ms
        s = self.suspicion_scale
        return lo_ms * s / g, hi_ms * s / g

    @property
    def probe_fail_prob_alive(self) -> float:
        """P(a probe of a live target fails): the direct round trip (2
        legs) and every indirect path (4 legs) drop (state.go:326-454)."""
        ok = 1.0 - self.loss
        p_direct = 1.0 - ok**2
        p_indirect = 1.0 - ok**4
        return p_direct * (p_indirect ** self.profile.indirect_checks)


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
    p_fail_alive: torch.Tensor  # float32 scalar


def membership_constants(cfg: MembershipConfig, device) -> MembershipConstants:
    n = cfg.n
    return MembershipConstants(
        fail_tick=_schedule_array(n, cfg.fail_at, NEVER, device),
        leave_tick=_schedule_array(n, cfg.leave_at, NEVER, device),
        join_tick=_schedule_array(n, cfg.join_at, 0, device),
        timeout=timeout_table(cfg).to(device),
        p_fail_alive=device_scalar(cfg.probe_fail_prob_alive, torch.float32,
                                   device),
    )


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


def _set_diag(plane: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    out = plane.clone()
    out.diagonal().copy_(values)
    return out


def _set_cols(plane: torch.Tensor, col: torch.Tensor, apply: torch.Tensor,
              value) -> torch.Tensor:
    """``plane`` with ``plane[i, col[i]] = value[i]`` in each row where
    ``apply`` (the reference's ``.at[rows, col].set(mode="drop")`` with
    the dropped rows pointing past the end)."""
    idx = torch.clamp(col, 0, plane.shape[1] - 1).long()[:, None]
    cur = torch.gather(plane, 1, idx)[:, 0]
    value = device_scalar(value, plane.dtype, plane.device)
    new = torch.where(apply, value, cur)
    return plane.scatter(1, idx, new[:, None])


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
    t = state.tick
    (k_tie, k_tgt, k_loss, k_pp, k_ppsel, k_probe,
     k_pfail) = split(key_rng, 7).unbind(-2)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    amax = cfg.profile.awareness_max_multiplier - 1

    present, leaving, participates = ground_truth(
        t, consts.fail_tick, consts.leave_tick, consts.join_tick,
        cfg.leave_grace_ticks)

    own_inc = state.own_inc
    awareness = state.awareness

    # Leave intent: the leaver re-stamps its self-view LEFT at its own
    # incarnation and gossips it; the self-view never regresses.
    diag = state.key.diagonal()
    diag_val = torch.where(leaving, make_key(own_inc, RANK_LEFT),
                           make_key(own_inc, RANK_ALIVE))
    diag_val = torch.maximum(diag, diag_val)
    key_m = _set_diag(state.key, torch.where(present, diag_val, diag))
    tx = _set_diag(state.tx, torch.where(diag_val > diag, cfg.tx_limit,
                                         state.tx.diagonal()))

    # 1. Gossip: the top-m queued messages (most retransmits left, random
    #    tie-break) go to each of ``fanout`` random targets in one packet.
    prio = tx.to(torch.float32) + owned_uniform_rows(k_tie, n, n)
    subj = top_slots(prio, m)                               # [n, m]
    msg_key = torch.gather(key_m, 1, subj)
    msg_valid = ((torch.gather(tx, 1, subj) > 0) & (msg_key >= 0)
                 & participates[:, None])

    targets = sample_peers(k_tgt, n, fanout).long()         # [n, F]
    tgt_view = torch.gather(key_m, 1, targets)
    # Senders gossip only to members they consider non-dead.
    tgt_sendable = (tgt_view >= 0) & (key_rank(tgt_view) <= RANK_SUSPECT)
    packet_ok = (participates[:, None] & tgt_sendable
                 & bernoulli_mask(k_loss, (n, fanout), 1.0 - cfg.loss)
                 & participates[targets])

    # key_rx[r, s] = max key among arriving messages about s at r, in a
    # [n + 1, n] buffer whose last row takes every dropped message.
    ok3 = packet_ok[:, :, None] & msg_valid[:, None, :]
    flat = torch.where(ok3, targets[:, :, None] * n + subj[:, None, :],
                       n * n).reshape(-1)
    val3 = msg_key[:, None, :].expand(n, fanout, m).reshape(-1)
    key_rx = torch.full(((n + 1) * n,), -1, dtype=torch.int32, device=dev)
    key_rx.scatter_reduce_(0, flat, val3, "amax")
    sus_val = torch.where(key_rank(val3) == RANK_SUSPECT, key_inc(val3), -1)
    sus_inc_rx = torch.full(((n + 1) * n,), -1, dtype=torch.int32,
                            device=dev)
    sus_inc_rx.scatter_reduce_(0, flat, sus_val, "amax")
    key_rx = key_rx.view(n + 1, n)
    sus_inc_rx = sus_inc_rx.view(n + 1, n)[:n]

    # One transmission per target packet per drained message, spent
    # whether or not the packet survived (queue.go:288-373); the drained
    # columns of a row are distinct.
    spend = torch.where(msg_valid, fanout, 0).to(torch.int32)
    tx = tx.scatter(1, subj, torch.gather(tx, 1, subj) - spend)
    tx = torch.clamp(tx, min=0)

    # 2. Push/pull anti-entropy: initiators exchange full state with one
    #    partner; both sides merge the cellwise max of the two rows.
    if cfg.push_pull_enabled:
        known_cnt = torch.sum(
            (key_m >= 0) & (key_rank(key_m) <= RANK_SUSPECT), dim=1)
        # A node that knows only itself (a joiner) syncs at once.
        needs_join = participates & (known_cnt <= 1)
        initiate = participates & (
            needs_join | bernoulli_mask(k_pp, (n,), 1.0 / cfg.push_pull_ticks)
        )
        partner = sample_probe_targets(k_ppsel, n).long()
        pp_ok = initiate & participates[partner]
        # Pull: the initiator merges the partner's row.
        key_rx[:n] = torch.maximum(
            key_rx[:n], torch.where(pp_ok[:, None], key_m[partner], -1))
        # Push: the partner merges the initiator's row (row scatter-max;
        # idle initiators point at the spare last row).
        prow = torch.where(pp_ok, partner, n)
        key_rx.scatter_reduce_(0, prow[:, None].expand(n, n), key_m, "amax")
    key_rx = key_rx[:n]

    # 3. Refutation: a node that hears itself suspected or declared dead
    #    at >= its incarnation re-asserts aliveness at accused + 1 and
    #    takes a health penalty (state.go:880-915).
    self_rx = key_rx.diagonal()
    accused = torch.where(key_rank(self_rx) >= RANK_SUSPECT,
                          key_inc(self_rx), -1)
    refuting = participates & ~leaving & (accused >= own_inc)
    own_inc = torch.where(refuting, accused + 1, own_inc)
    awareness = torch.clamp(awareness + refuting.to(torch.int32), 0, amax)
    # The self-view never merges from the wire; re-stamp it post-refute.
    key_rx.diagonal().fill_(-1)
    self_key = torch.where(leaving, make_key(own_inc, RANK_LEFT),
                           make_key(own_inc, RANK_ALIVE))
    old_key = _set_diag(key_m, torch.maximum(
        key_m.diagonal(), torch.where(present, self_key, -1)))
    tx = _set_diag(tx, torch.where(refuting, cfg.tx_limit, tx.diagonal()))

    # 4. Merge the deliveries into the view.
    new_key = torch.maximum(old_key, key_rx)
    changed = new_key > old_key
    fresh_suspect = changed & (key_rank(new_key) == RANK_SUSPECT)
    suspect_since = torch.where(
        fresh_suspect, t, torch.where(changed, NEVER, state.suspect_since))
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
        is_probe_tick = (t % cfg.probe_interval_ticks) == 0
        ptarget = sample_probe_targets(k_probe, n).long()
        pt_view = torch.gather(key_m, 1, ptarget[:, None])[:, 0]
        probing = (is_probe_tick & participates & (pt_view >= 0)
                   & (key_rank(pt_view) <= RANK_SUSPECT))
        p_fail = torch.where(participates[ptarget], consts.p_fail_alive, 1.0)
        failed = probing & bernoulli_mask(k_pfail, (n,), p_fail)
        # A failed probe matures after the probe cycle plus the timeout
        # scaled by the health score going into it (awareness.go:64).
        can_pend = failed & (state.probe_pending_at == NEVER)
        matures_at = (t + cfg.probe_interval_ticks
                      + awareness * cfg.probe_timeout_ticks)
        awareness = torch.clamp(
            awareness + failed.to(torch.int32)
            - (probing & ~failed).to(torch.int32), 0, amax)
        probe_pending_at = torch.where(can_pend, matures_at,
                                       state.probe_pending_at)
        probe_subject = torch.where(can_pend, ptarget.to(torch.int32),
                                    state.probe_subject)

        # A crashed observer's pending probe never matures.
        mature = (probe_pending_at <= t) & participates
        mview = torch.gather(key_m, 1, probe_subject.long()[:, None])[:, 0]
        # Suspect at the incarnation on the view, only if it is ALIVE.
        apply_sus = mature & (key_rank(mview) == RANK_ALIVE)
        sus_key = make_key(key_inc(mview), RANK_SUSPECT)
        key_m = _set_cols(key_m, probe_subject, apply_sus, sus_key)
        suspect_since = _set_cols(suspect_since, probe_subject, apply_sus,
                                  t.expand(n))
        confirms = _set_cols(confirms, probe_subject, apply_sus, 0)
        tx = _set_cols(tx, probe_subject, apply_sus, cfg.tx_limit)
        probe_pending_at = torch.where(mature, NEVER, probe_pending_at)
    else:
        probe_pending_at = state.probe_pending_at
        probe_subject = state.probe_subject

    # 6. Suspicion expiry -> DEAD at the suspicion's incarnation
    #    (state.go:1200-1215), Lifeguard-accelerated by confirmations.
    timeout = consts.timeout[confirms.long()]
    elapsed = (t - suspect_since).to(torch.float32)
    expire = ((key_rank(key_m) == RANK_SUSPECT) & (suspect_since != NEVER)
              & (elapsed >= timeout) & participates[:, None])
    key_m = torch.where(expire, make_key(key_inc(key_m), RANK_DEAD), key_m)
    suspect_since = torch.where(expire, NEVER, suspect_since)
    tx = torch.where(expire, cfg.tx_limit, tx)

    return MembershipState(
        key=key_m, suspect_since=suspect_since, confirms=confirms, tx=tx,
        own_inc=own_inc, awareness=awareness,
        probe_pending_at=probe_pending_at, probe_subject=probe_subject,
        tick=t + 1,
    )
