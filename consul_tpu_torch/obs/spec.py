"""In-scan telemetry: the static per-entrypoint metric registry.

The port of ``consul_tpu/obs/spec.py``.  Every scan family returns its
own per-tick outputs; this module gives them one metrics vocabulary:
ordered Consul-style metric names (SURVEY.md §5: ``memberlist.health.score``
awareness.go:50, ``serf.queue.Event`` serf.go:1675, ``consul.*`` study
gauges), each bound to a pure ``(prev_state, next_state, tick_out, cfg,
counts) -> int32`` emitter.  With ``telemetry=True`` a scan writes one
``[M]`` row a tick into a preallocated ``[steps, M]`` float32 trace
(``[*B, steps, M]`` under a sweep's key batch) returned as its last
output; ``obs.bridge`` replays it into ``telemetry.Metrics`` under the
reference names.

Exactness, as in the reference:

  * every emitter reduces to an **int32 count** (integer sums, exact in
    any order and wrapping as the reference's do), and the assembled
    vector is cast to float32 once a tick (round to nearest even above
    2**24, on the CPU and on CUDA alike);
  * ``reduce="sum"`` columns sum over the per-node planes: the sharded
    twins count them per logical shard and sum over the shard axis
    (:func:`reduce_over_shards`, the reference's one ``psum``), so
    D == 1 equals the unsharded trace and D == 2 equals D == 1;
  * ``reduce="rep"`` columns read values the twin holds once (window
    counters, the geo link census, cumulative overflow): taken once, as
    the reference takes shard 0's copy.

Emitters read the tick's state before and after the round and never
write: ``telemetry=False`` runs no emitter and allocates no trace.
No emitter reads a device value on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# The model constants are imported inside the per-family builders, as the
# reference does: the models import the engine's package through
# ``sim.faults``, and the engine imports this module.


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One metric of one scan family.

    ``emit(prev, nxt, out, cfg, counts)``: a pure function of the tick's
    before and after states and its per-tick output tuple, returning an
    int32 count per universe (a count this tick for ``kind="counter"``, a
    level for ``kind="gauge"``).  ``counts`` (:class:`Counts`) sums a
    plane the way the scan lays it out.  ``reduce`` states how the
    sharded twins assemble the global value."""

    name: str       # Consul-style metric name (the bridge emits it)
    kind: str       # "counter" | "gauge" (bridge-side semantics)
    reduce: str     # "sum" (over the shard axis) | "rep" (held once)
    emit: Callable  # (prev, nxt, out, cfg, counts) -> int32

    def __post_init__(self):
        if self.kind not in ("counter", "gauge"):
            raise ValueError(f"bad kind {self.kind!r} for {self.name}")
        if self.reduce not in ("sum", "rep"):
            raise ValueError(
                f"bad reduce {self.reduce!r} for {self.name}"
            )


class Counts:
    """How an emitter sums a plane to int32 counts.

    ``nb`` leading axes are a sweep's universe axes and stay.  A per-node
    plane (:meth:`nodes`, node axis at ``nb``) sums over everything else;
    with ``shards`` = D it sums each logical shard's contiguous row block,
    giving ``[D, *B]`` for :func:`reduce_over_shards`.  A replicated value
    (:meth:`rep`) always sums to ``[*B]``."""

    def __init__(self, nb: int = 0, shards: int = 0):
        self.nb = nb
        self.shards = shards

    def nodes(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:self.nb]
        if not self.shards:
            return torch.sum(x.reshape(*lead, -1), dim=-1,
                             dtype=torch.int32)
        per_shard = torch.sum(x.reshape(*lead, self.shards, -1), dim=-1,
                              dtype=torch.int32)
        return per_shard.movedim(-1, 0)

    def rep(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x.reshape(*x.shape[:self.nb], -1), dim=-1,
                         dtype=torch.int32)


def _delta(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return (x - p).to(torch.int32)


# ---------------------------------------------------------------------------
# Per-family emitters, in the reference's order.  Each reads per-node planes
# (reduce="sum") or values held once (reduce="rep") only.
# ---------------------------------------------------------------------------


def _swim_specs() -> tuple:
    """SwimState families (swim and lifeguard share the state)."""
    from consul_tpu_torch.models.swim import (
        VIEW_ALIVE,
        VIEW_DEAD,
        VIEW_SUSPECT,
    )

    return (
        MetricSpec(
            "memberlist.msg.suspect", "counter", "sum",
            lambda p, x, out, cfg, c: c.nodes(
                (x.view == VIEW_SUSPECT) & (p.view != VIEW_SUSPECT)
            ),
        ),
        MetricSpec(
            "memberlist.msg.dead", "counter", "sum",
            lambda p, x, out, cfg, c: c.nodes(
                (x.view == VIEW_DEAD) & (p.view != VIEW_DEAD)
            ),
        ),
        # Refute landings: views overridden back to ALIVE by a
        # higher-incarnation alive message (state.go:917 aliveNode).
        MetricSpec(
            "memberlist.msg.alive", "counter", "sum",
            lambda p, x, out, cfg, c: c.nodes(
                (x.view == VIEW_ALIVE) & (p.view != VIEW_ALIVE)
            ),
        ),
        # TransmitLimitedQueue pressure: nodes holding any queued
        # suspect/dead/refute broadcast (queue.go).
        MetricSpec(
            "memberlist.queue.broadcasts", "gauge", "sum",
            lambda p, x, out, cfg, c: (
                c.nodes(x.tx_suspect > 0)
                + c.nodes(x.tx_dead > 0)
                + c.nodes(x.tx_refute > 0)
            ),
        ),
        # Aggregate Lifeguard NHM (awareness.go:50 emits per node; the
        # population sum is the study-level gauge).
        MetricSpec(
            "memberlist.health.score", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.awareness),
        ),
        MetricSpec(
            "consul.swim.suspecting", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.view == VIEW_SUSPECT),
        ),
        MetricSpec(
            "consul.swim.dead_known", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.view == VIEW_DEAD),
        ),
    )


def _lifeguard_specs() -> tuple:
    return _swim_specs() + (
        # Subject refutations this tick (incarnation bumps: the flap
        # counter of the false-positive studies).
        MetricSpec(
            "consul.lifeguard.refutes", "counter", "rep",
            lambda p, x, out, cfg, c: _delta(x.subject_inc, p.subject_inc),
        ),
    )


def _broadcast_specs() -> tuple:
    return (
        # Gossip messages offered this tick: live senders x fanout
        # (state.go:566 gossip; the Poissonized aggregate mode offers the
        # same count by construction).  A swept fanout is an int32 [U]
        # knob, so the product stays int32, as the traced reference's.
        MetricSpec(
            "memberlist.gossip", "counter", "sum",
            lambda p, x, out, cfg, c: (
                c.nodes(p.knows & (p.tx_left > 0)) * cfg.fanout
            ),
        ),
        # Event-queue depth: nodes still holding a queued rebroadcast
        # (serf.go:1675 serf.queue.Event).
        MetricSpec(
            "serf.queue.Event", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.tx_left > 0),
        ),
        MetricSpec(
            "consul.broadcast.infected", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.knows),
        ),
        MetricSpec(
            "consul.broadcast.newly_infected", "counter", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.knows & ~p.knows),
        ),
    )


def _membership_specs() -> tuple:
    """Dense [n, n] view-matrix family: per-cell transitions are
    position-stable, so the msg.* counters diff prev against next cells."""
    from consul_tpu_torch.models.membership import (
        RANK_DEAD,
        RANK_SUSPECT,
        key_rank,
    )

    def new_rank(p, x, rank):
        return (key_rank(x.key) == rank) & (key_rank(p.key) != rank)

    return (
        MetricSpec(
            "memberlist.msg.suspect", "counter", "sum",
            lambda p, x, out, cfg, c: c.nodes(new_rank(p, x, RANK_SUSPECT)),
        ),
        MetricSpec(
            "memberlist.msg.dead", "counter", "sum",
            lambda p, x, out, cfg, c: c.nodes(new_rank(p, x, RANK_DEAD)),
        ),
        # Cells re-learned alive at a HIGHER key (refute landings; the key
        # max-merge makes "changed to alive-rank" exactly that).
        MetricSpec(
            "memberlist.msg.alive", "counter", "sum",
            lambda p, x, out, cfg, c: c.nodes(
                (x.key > p.key) & (key_rank(x.key) == 0)
            ),
        ),
        MetricSpec(
            "memberlist.health.score", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.awareness),
        ),
        MetricSpec(
            "consul.membership.suspect_cells", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(
                (x.key >= 0) & (key_rank(x.key) == RANK_SUSPECT)
            ),
        ),
        MetricSpec(
            "consul.membership.known", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(
                (x.key >= 0) & (key_rank(x.key) <= RANK_SUSPECT)
            ),
        ),
    )


def _sparse_specs() -> tuple:
    """Top-K slot family: the sort-merge permutes slot columns between
    ticks, so every emitter here is position-free (occupancy-masked sums
    and cumulative-counter deltas only)."""
    from consul_tpu_torch.models.membership import RANK_SUSPECT, key_rank

    return (
        MetricSpec(
            "consul.membership.suspect_cells", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(
                (x.slot_subj >= 0) & (key_rank(x.key) == RANK_SUSPECT)
            ),
        ),
        MetricSpec(
            "consul.membership.dead_cells", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(
                (x.slot_subj >= 0) & (key_rank(x.key) > RANK_SUSPECT)
            ),
        ),
        MetricSpec(
            "memberlist.health.score", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.awareness),
        ),
        # Cumulative state counters -> per-tick deltas.  Held once in the
        # sharded twin (its per-shard increments land in the state).
        MetricSpec(
            "consul.membership.overflow", "counter", "rep",
            lambda p, x, out, cfg, c: _delta(x.overflow, p.overflow),
        ),
        MetricSpec(
            "consul.membership.forgotten", "counter", "rep",
            lambda p, x, out, cfg, c: _delta(x.forgotten, p.forgotten),
        ),
    )


def _streamcast_specs() -> tuple:
    return (
        # In-flight window occupancy (serf.queue.Event: the event queue
        # depth of the streaming plane).
        MetricSpec(
            "serf.queue.Event", "gauge", "rep",
            lambda p, x, out, cfg, c: c.rep(x.slot_event >= 0),
        ),
        MetricSpec(
            "consul.streamcast.window_overflow", "counter", "rep",
            lambda p, x, out, cfg, c: _delta(x.window_overflow,
                                             p.window_overflow),
        ),
        MetricSpec(
            "consul.streamcast.offered", "counter", "rep",
            lambda p, x, out, cfg, c: _delta(x.offered, p.offered),
        ),
        MetricSpec(
            "consul.streamcast.delivered", "counter", "rep",
            lambda p, x, out, cfg, c: _delta(x.delivered, p.delivered),
        ),
        MetricSpec(
            "consul.streamcast.coalesced", "counter", "rep",
            lambda p, x, out, cfg, c: _delta(x.coalesced, p.coalesced),
        ),
        MetricSpec(
            "consul.streamcast.chunks_held", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.chunks),
        ),
    )


def _geo_specs() -> tuple:
    """Geo/WAN family: the link census rides the per-tick output tuple
    ``(per_segment, offered, admitted, queued, overflow, wasted)``, values
    of the link plane the sharded twin steps once."""
    return (
        MetricSpec(
            "consul.geo.wan.offered", "counter", "rep",
            lambda p, x, out, cfg, c: c.rep(out[1]),
        ),
        MetricSpec(
            "consul.geo.wan.admitted", "counter", "rep",
            lambda p, x, out, cfg, c: c.rep(out[2]),
        ),
        MetricSpec(
            "consul.geo.wan.queued", "gauge", "rep",
            lambda p, x, out, cfg, c: c.rep(out[3]),
        ),
        MetricSpec(
            "consul.geo.wan.overflow", "counter", "rep",
            lambda p, x, out, cfg, c: c.rep(out[4]),
        ),
        MetricSpec(
            "consul.geo.wan.wasted", "counter", "rep",
            lambda p, x, out, cfg, c: _delta(x.wasted, p.wasted),
        ),
        MetricSpec(
            "consul.geo.events_known", "gauge", "sum",
            lambda p, x, out, cfg, c: c.nodes(x.knows),
        ),
    )


# Ordered and static: the column order of every [steps, M] trace, keyed by
# scan family (the entrypoint names the engine and the sweep plane share).
# Each family builds on first use, so importing this module imports no
# model.
_SPEC_BUILDERS: dict = {
    "swim": _swim_specs,
    "lifeguard": _lifeguard_specs,
    "broadcast": _broadcast_specs,
    "membership": _membership_specs,
    "sparse": _sparse_specs,
    "streamcast": _streamcast_specs,
    "geo": _geo_specs,
}
_SPEC_CACHE: dict = {}


def __getattr__(name: str):
    # PEP 562: METRIC_SPECS reads as a plain dict while the per-family
    # tuples build on first touch.
    if name == "METRIC_SPECS":
        return {e: _specs(e) for e in _SPEC_BUILDERS}
    raise AttributeError(name)


def metric_names(entrypoint: str) -> tuple:
    """Ordered metric names of one scan family: column j of the family's
    [steps, M] trace is ``metric_names(...)[j]``."""
    return tuple(s.name for s in _specs(entrypoint))


def metric_count(entrypoint: str) -> int:
    return len(_specs(entrypoint))


def _specs(entrypoint: str) -> tuple:
    try:
        if entrypoint not in _SPEC_CACHE:
            _SPEC_CACHE[entrypoint] = _SPEC_BUILDERS[entrypoint]()
        return _SPEC_CACHE[entrypoint]
    except KeyError:
        raise ValueError(
            f"no metric specs for entrypoint {entrypoint!r} "
            f"(have: {sorted(_SPEC_BUILDERS)})"
        ) from None


def emit_local(entrypoint: str, prev, nxt, out, cfg, nb: int = 0,
               shards: int = 0) -> torch.Tensor:
    """The raw int32 metrics vector of one tick: ``[*B, M]`` for ``nb``
    universe axes, or ``[D, *B, M]`` per logical shard with ``shards`` =
    D (each "rep" column repeated on every shard), for
    :func:`reduce_over_shards`."""
    counts = Counts(nb, shards)
    cols = [s.emit(prev, nxt, out, cfg, counts).to(torch.int32)
            for s in _specs(entrypoint)]
    if shards:
        cols = torch.broadcast_tensors(*cols)
    return torch.stack(cols, dim=-1)


def emit_metrics(entrypoint: str, prev, nxt, out, cfg,
                 nb: int = 0) -> torch.Tensor:
    """One float32 ``[*B, M]`` trace row (the unsharded emission)."""
    return emit_local(entrypoint, prev, nxt, out, cfg, nb).to(torch.float32)


def sum_mask(entrypoint: str) -> tuple:
    """Static bool[M]: which columns the sharded twins sum over shards."""
    return tuple(s.reduce == "sum" for s in _specs(entrypoint))


def shard_keep(entrypoint: str, shards: int, device) -> torch.Tensor:
    """bool ``[D, M]``: the entries of a ``[D, *B, M]`` local vector that
    :func:`reduce_over_shards` keeps, every shard's "sum" columns and
    shard 0's "rep" columns.  Built once a study: it copies the static
    mask from the host."""
    mask = torch.tensor(sum_mask(entrypoint), dtype=torch.bool).to(device)
    first = torch.arange(shards, device=device) == 0
    return mask[None, :] | first[:, None]


def reduce_over_shards(vec: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The global float32 ``[*B, M]`` trace row from shard-local int32
    ``[D, *B, M]`` vectors: one integer sum over the shard axis of the
    entries ``keep`` (:func:`shard_keep`) marks, the reference's
    ``psum`` (exact in any grouping, so D == 1 equals the unsharded row
    and D == 2 equals D == 1)."""
    keep = keep.view(keep.shape[0], *([1] * (vec.dim() - 2)), keep.shape[1])
    return torch.sum(torch.where(keep, vec, 0), dim=0,
                     dtype=torch.int32).to(torch.float32)


class MetricsTrace:
    """The ``[*B, steps, M]`` float32 trace of one scan, preallocated on
    the key's device and filled a row a tick (:meth:`record`).  ``shards``
    = D assembles each row from per-shard counts through
    :func:`reduce_over_shards`."""

    def __init__(self, entrypoint: str, key: torch.Tensor, steps: int,
                 shards: int = 0):
        self.entrypoint = entrypoint
        self.nb = key.dim() - 1
        self.shards = shards
        self.keep = (shard_keep(entrypoint, shards, key.device)
                     if shards else None)
        self.buf = torch.empty((*key.shape[:-1], steps,
                                metric_count(entrypoint)),
                               dtype=torch.float32, device=key.device)

    def record(self, t: int, prev, nxt, out, cfg) -> None:
        if self.shards:
            row = reduce_over_shards(
                emit_local(self.entrypoint, prev, nxt, out, cfg, self.nb,
                           self.shards), self.keep)
        else:
            row = emit_metrics(self.entrypoint, prev, nxt, out, cfg, self.nb)
        self.buf.select(self.nb, t).copy_(row)


def open_trace(entrypoint: str, key: torch.Tensor, steps: int,
               telemetry: bool, shards: int = 0):
    """The :class:`MetricsTrace` a ``telemetry=True`` scan fills, else None
    (nothing is allocated with telemetry off)."""
    return MetricsTrace(entrypoint, key, steps, shards) if telemetry else None


def with_trace(outs: tuple, trace) -> tuple:
    """A scan's outputs, with the trace appended last when there is one."""
    return outs if trace is None else (*outs, trace.buf)
