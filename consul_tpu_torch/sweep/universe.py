"""The :class:`Universe` spec and the batched-scan builder.

The port of ``consul_tpu/sweep/universe.py``.  A universe is one (seed,
knob values, fault severities) point of a study family.  The spec splits
a swept configuration into

  * static structure: the base config object, steps, the tracked
    subjects and the (entrypoint, U) choice, everything that feeds a
    tensor shape or a branch.  These stay Python values, as in a plain
    run, so one batched program serves every knob value;
  * per-universe knobs: rate-like config fields (loss, suspicion_scale,
    ack_late, aggregate-mode fanout, streamcast rate, fault-schedule
    severities) passed as ``[U]`` tensors and written into the config
    by :func:`apply_knobs`; the models read them through tensor
    arithmetic in the reference's traced float32 order;
  * per-universe keys: an explicit seed tuple (U independent
    ``PRNGKey``; U = 1 with seed s equals the plain run at seed s) or a
    ``split_from`` base key folded in per universe (prefix-stable: the
    first U keys of a larger sweep are the same).

The universe axis is a real leading dimension: keys ``int64[U, 2]``,
node planes ``[U, n, ...]``, one batched tick for all universes, so the
number of kernel launches a tick does not grow with U.  A field that
feeds a shape would need one program per universe: :func:`validate_knob`
rejects it with the reason when the :class:`Universe` is built.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Callable, Optional

import torch

from consul_tpu_torch.device import resolve_device
from consul_tpu_torch.parallel import shard
from consul_tpu_torch.geo.model import geo_init
from consul_tpu_torch.models import (
    broadcast_init,
    membership_init,
    sparse_membership_init,
    swim_init,
)
from consul_tpu_torch.models.lifeguard import lifeguard_init
from consul_tpu_torch.models.membership_sparse import resolve_amortize
from consul_tpu_torch.ops import PRNGKey, fold_in
from consul_tpu_torch.sim import engine
from consul_tpu_torch.streamcast.model import streamcast_init

# Final-field names that feed tensor shapes or structure anywhere in the
# model family (the reference's list, consul_tpu/sweep/universe.py).
_SHAPE_FIELDS = frozenset({
    # array extents / budgets
    "n", "k_slots", "piggyback", "stage_width", "segments", "seg_size",
    "bridges_per_segment", "indirect_checks", "udp_buffer_size",
    "event_buffer_size", "query_buffer_size", "max_user_event_size",
    "events", "chunks", "window", "names",
    # streamcast policy seam + backlog + hot node
    "policy", "arrivals", "backlog", "hotspot_node",
    # geo/WAN plane: the link slot planes, ring window and queue bound
    "wan_latency_ticks", "wan_window", "wan_capacity_bytes",
    "wan_msg_bytes", "wan_queue_bytes", "ae_batch", "adaptive",
    "origins", "lan_profile", "wan_profile", "src", "dst",
    # schedule structure (host-validated scatter indices)
    "fail_at", "leave_at", "join_at", "pieces", "subject", "schedule",
    "fail_at_tick", "start", "heal", "end", "seed", "leave_grace_ticks",
    # branch selectors and constants of the round
    "delivery", "profile", "base", "faults", "lifeguard", "done_frac",
    "subject_alive", "probe_enabled", "push_pull_enabled", "name",
    "amortize",
    "probe_interval_ms", "probe_timeout_ms", "gossip_interval_ms",
    "push_pull_interval_ms", "gossip_to_the_dead_ms",
    "suspicion_mult", "suspicion_max_timeout_mult",
    "awareness_max_multiplier", "retransmit_mult",
})

# Fault-schedule severity fields sweepable through "faults.…" paths.
_FAULT_KNOB_FIELDS = frozenset({
    "drop", "late", "frac", "severity", "p_offline", "scale",
})

# Knobs that are integer-valued in the models; everything else stacks as
# float32.  chunk_budget only ever enters as a rank comparison.
_INT_KNOB_FIELDS = frozenset({"fanout", "gossip_nodes", "chunk_budget"})

@dataclasses.dataclass(frozen=True)
class _EntrypointSpec:
    """One sweepable scan entrypoint: its init, its batched scan and the
    knob paths legal for it."""

    name: str
    init: Callable[[Any, Any], Any]     # (cfg, device) -> state
    # (state, keys, cfg, steps, track, telemetry) -> (final, outs), the
    # [U, steps, M] trace last in ``outs`` with telemetry.
    call: Callable
    base_cfg: Callable[[Any], Any]      # cfg -> the profile/n config
    knob_paths: frozenset
    aggregate_only: frozenset           # legal only under aggregate
    fault_paths: bool = False           # "faults.…" severity paths legal
    bandwidth_paths: bool = False       # "faults.bandwidth[*].…" legal
    # The sweep x shard seam: the batched sharded twin
    # (parallel/shard.py), normalized to
    #   (state, keys, cfg, steps, track, telemetry, mesh, exchange)
    #     -> (final, outs_core, overflow[U])
    # with ``outs_core`` exactly the unsharded sweep's outputs (the trace
    # last with telemetry), so U = 1 x D = 1 composed equals the
    # unsharded sweep.  None: no sharded twin
    # (swim, lifeguard), and make_sweep(mesh=) rejects the entrypoint.
    sharded: Optional[Callable] = None


# --- sharded-twin adapters (the reference's _sharded_* seam) -------------


def _split(outs: tuple, telemetry: bool):
    """(the twin's own outputs, the trace as a 1-tuple or ())."""
    return (outs[:-1], outs[-1:]) if telemetry else (outs, ())


def _sharded_broadcast(s, k, c, steps, track, telemetry, mesh, ex):
    final, outs = shard.sharded_broadcast_scan(s, k, c, steps, mesh, ex,
                                               telemetry)
    (infected, ov), trace = _split(outs, telemetry)
    return final, ((infected, *trace) if telemetry else infected), ov


def _sharded_membership(s, k, c, steps, track, telemetry, mesh, ex):
    final, outs = shard.sharded_membership_scan(s, k, c, steps, mesh, track,
                                                ex, telemetry)
    (*core, ov), trace = _split(outs, telemetry)
    return final, (*core, *trace), ov


def _sharded_sparse(s, k, c, steps, track, telemetry, mesh, ex):
    final, outs = shard.sharded_sparse_membership_scan(s, k, c, steps, mesh,
                                                       track, ex, telemetry)
    # The sparse plane carries its overflow in the state (model budgets
    # and outbox misses, one count as unsharded).
    return final, outs, final.overflow


def _sharded_streamcast(s, k, c, steps, track, telemetry, mesh, ex):
    final, outs = shard.sharded_streamcast_scan(s, k, c, steps, mesh, ex,
                                                telemetry)
    (*core, ov_t), trace = _split(outs, telemetry)
    # The outbox overflow rides the per-tick outputs; the last tick holds
    # the total.
    return final, (*core, *trace), ov_t[..., -1]


def _sharded_geo(s, k, c, steps, track, telemetry, mesh, ex):
    final, outs = shard.sharded_geo_scan(s, k, c, steps, mesh, ex, telemetry)
    (*core, ov_t), trace = _split(outs, telemetry)
    return final, (*core, *trace), ov_t[..., -1]


SWEEP_ENTRYPOINTS: dict = {
    "swim": _EntrypointSpec(
        name="swim", init=lambda c, d: swim_init(c, device=d),
        call=lambda s, k, c, steps, track, tel: engine.swim_scan(
            s, k, c, steps, tel),
        base_cfg=lambda c: c,
        knob_paths=frozenset({"loss", "suspicion_scale"}),
        aggregate_only=frozenset({"profile.gossip_nodes"}),
    ),
    "lifeguard": _EntrypointSpec(
        name="lifeguard", init=lambda c, d: lifeguard_init(c, device=d),
        call=lambda s, k, c, steps, track, tel: engine.lifeguard_scan(
            s, k, c, steps, tel),
        base_cfg=lambda c: c,
        knob_paths=frozenset({"loss", "suspicion_scale", "ack_late"}),
        aggregate_only=frozenset({"profile.gossip_nodes"}),
        fault_paths=True,
    ),
    "broadcast": _EntrypointSpec(
        name="broadcast",
        init=lambda c, d: broadcast_init(c, origin=0, device=d),
        call=lambda s, k, c, steps, track, tel: engine.broadcast_scan(
            s, k, c, steps, tel),
        base_cfg=lambda c: c,
        knob_paths=frozenset({"loss"}),
        aggregate_only=frozenset({"fanout"}),
        sharded=_sharded_broadcast,
    ),
    "membership": _EntrypointSpec(
        name="membership", init=lambda c, d: membership_init(c, device=d),
        call=lambda s, k, c, steps, track, tel: engine.membership_scan(
            s, k, c, steps, track, tel),
        base_cfg=lambda c: c,
        knob_paths=frozenset({"loss", "suspicion_scale"}),
        aggregate_only=frozenset(),
        sharded=_sharded_membership,
    ),
    "sparse": _EntrypointSpec(
        name="sparse",
        init=lambda c, d: sparse_membership_init(c, device=d),
        call=lambda s, k, c, steps, track, tel: (
            engine.sparse_membership_scan(s, k, c, steps, track, tel)),
        base_cfg=lambda c: c.base,
        knob_paths=frozenset({"base.loss", "base.suspicion_scale"}),
        aggregate_only=frozenset(),
        sharded=_sharded_sparse,
    ),
    # The sustained-load plane: ``rate`` is the offered load (each
    # universe's arrival schedule derives from its own key), so one
    # batched program measures a whole throughput curve; the selection
    # ``policy`` stays static (one batched program per policy).
    "streamcast": _EntrypointSpec(
        name="streamcast", init=lambda c, d: streamcast_init(c, device=d),
        call=lambda s, k, c, steps, track, tel: engine.streamcast_scan(
            s, k, c, steps, tel),
        base_cfg=lambda c: c,
        knob_paths=frozenset({"loss", "rate", "chunk_budget",
                              "size_tail", "hotspot"}),
        aggregate_only=frozenset({"fanout"}),
        fault_paths=True,
        sharded=_sharded_streamcast,
    ),
    # The geo/WAN plane: LAN/WAN loss and the controller's EWMA gain are
    # rate knobs; the brownout severity rides faults.bandwidth[*].scale.
    "geo": _EntrypointSpec(
        name="geo", init=lambda c, d: geo_init(c, device=d),
        call=lambda s, k, c, steps, track, tel: engine.geo_scan(
            s, k, c, steps, tel),
        base_cfg=lambda c: c,
        knob_paths=frozenset({"loss_lan", "loss_wan", "ae_gain"}),
        aggregate_only=frozenset(),
        fault_paths=True,
        bandwidth_paths=True,
        sharded=_sharded_geo,
    ),
}


_SEGMENT_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)(?:\[([0-9]+)\])?$")


def _path_segments(path: str) -> list:
    """'faults.degraded[0].drop' -> [('faults', None), ('degraded', 0),
    ('drop', None)]; raises on malformed paths."""
    segments = []
    for raw in path.split("."):
        m = _SEGMENT_RE.match(raw)
        if m is None:
            raise ValueError(f"malformed knob path segment {raw!r} in "
                             f"{path!r}")
        name, idx = m.group(1), m.group(2)
        segments.append((name, None if idx is None else int(idx)))
    return segments


def _resolve_path(cfg, path: str):
    """(owner object, final field name) of a knob path, validating that
    every segment exists on the base config."""
    segments = _path_segments(path)
    obj = cfg
    for name, idx in segments[:-1]:
        if not hasattr(obj, name):
            raise ValueError(
                f"knob path {path!r}: {type(obj).__name__} has no field "
                f"{name!r}"
            )
        obj = getattr(obj, name)
        if idx is not None:
            if idx >= len(obj):
                raise ValueError(
                    f"knob path {path!r}: index [{idx}] out of range "
                    f"(len {len(obj)})"
                )
            obj = obj[idx]
    final, fidx = segments[-1]
    if fidx is not None:
        raise ValueError(
            f"knob path {path!r} must end on a field, not an index"
        )
    if not hasattr(obj, final):
        raise ValueError(
            f"knob path {path!r}: {type(obj).__name__} has no field "
            f"{final!r}"
        )
    return obj, final


def _replace_path(obj, segments, value):
    """Functional update of a nested frozen-dataclass/tuple path."""
    (name, idx), rest = segments[0], segments[1:]
    cur = getattr(obj, name)
    if idx is None:
        new = value if not rest else _replace_path(cur, rest, value)
        return dataclasses.replace(obj, **{name: new})
    item = cur[idx]
    new_item = value if not rest else _replace_path(item, rest, value)
    return dataclasses.replace(
        obj, **{name: cur[:idx] + (new_item,) + cur[idx + 1:]}
    )


def apply_knobs(cfg, knobs: tuple, values: tuple):
    """Rebuild ``cfg`` with each knob path set to its ``[U]`` tensor of
    per-universe values (the configs' checks skip a swept value)."""
    for path, value in zip(knobs, values):
        cfg = _replace_path(cfg, _path_segments(path), value)
    return cfg


def knob_dtype(path: str) -> torch.dtype:
    """Stacking dtype of a knob: int32 for transmission-count knobs
    (fanout, gossip_nodes, chunk_budget), float32 for every rate."""
    final = _path_segments(path)[-1][0]
    return torch.int32 if final in _INT_KNOB_FIELDS else torch.float32


def validate_knob(entrypoint: str, cfg, path: str) -> None:
    """Reject non-sweepable knob paths loudly, at Universe construction
    time, with the reference's messages: a field that feeds shapes or
    structure would need a program per universe; rate-like fields are
    the sweepable family."""
    spec = SWEEP_ENTRYPOINTS[entrypoint]
    owner, final = _resolve_path(cfg, path)
    base = spec.base_cfg(cfg)
    # Dense/sparse membership gossip is always the exact per-message
    # scatter, i.e. edges-shaped.
    delivery = getattr(base, "delivery", "edges")
    allowed = set(spec.knob_paths)
    if delivery == "aggregate":
        allowed |= set(spec.aggregate_only)

    if path in allowed:
        return
    if path.startswith("faults.bandwidth") and not spec.bandwidth_paths:
        raise ValueError(
            f"knob {path!r}: BandwidthSchedule severities only act on "
            "the geo/WAN link plane — sweeping one on "
            f"{entrypoint!r} would ladder identical universes "
            "(the model has no per-link byte accounting to cap)"
        )
    if spec.fault_paths and path.startswith("faults.") and (
        final in _FAULT_KNOB_FIELDS
    ):
        return
    if path in spec.aggregate_only or final in _INT_KNOB_FIELDS:
        if spec.aggregate_only:
            if delivery == "aggregate":
                raise ValueError(
                    f"knob {path!r} is not the aggregate-mode "
                    f"transmission knob for {entrypoint!r}; fanout "
                    "enters as a Poisson arrival rate only via "
                    f"{sorted(spec.aggregate_only)}"
                )
            raise ValueError(
                f"knob {path!r} feeds the [n, fanout] gossip-target "
                f"shapes under delivery={delivery!r}; fanout is only "
                "sweepable under delivery='aggregate', where it enters "
                "as a Poisson arrival rate via "
                f"{sorted(spec.aggregate_only)}"
            )
        raise ValueError(
            f"knob {path!r} feeds the [n, fanout] gossip-target "
            f"shapes; transmission-count knobs are not sweepable for "
            f"{entrypoint!r} (sweepable: {sorted(allowed)})"
        )
    if final in _SHAPE_FIELDS:
        raise ValueError(
            f"knob {path!r}: field {final!r} of {type(owner).__name__} "
            "feeds array shapes or trace-time structure; a vmapped "
            "sweep over it would retrace per universe — sweep "
            "rate-like knobs instead (sweepable for "
            f"{entrypoint!r}: {sorted(allowed)}"
            + (", faults.*.{%s}" % "/".join(sorted(_FAULT_KNOB_FIELDS))
               if spec.fault_paths else "") + ")"
        )
    raise ValueError(
        f"unknown or unsweepable knob {path!r} for entrypoint "
        f"{entrypoint!r} (sweepable: {sorted(allowed)})"
    )


@dataclasses.dataclass(frozen=True)
class Universe:
    """Static structure + per-universe axes of one sweep.

    ``seeds`` stacks one independent ``PRNGKey`` per universe (U = len);
    ``split_from``/``universes`` instead folds one base key in per
    universe (prefix-stable, the error-bar mode).  ``values`` carries one
    U-tuple per knob path in ``knobs``; every path is validated at
    construction."""

    entrypoint: str
    cfg: Any
    steps: int
    seeds: tuple = ()
    split_from: Optional[int] = None
    universes: int = 0
    knobs: tuple = ()
    values: tuple = ()   # one U-length tuple of scalars per knob
    track: tuple = ()

    def __post_init__(self):
        if self.entrypoint not in SWEEP_ENTRYPOINTS:
            raise ValueError(
                f"unknown sweep entrypoint {self.entrypoint!r} "
                f"(have: {sorted(SWEEP_ENTRYPOINTS)})"
            )
        if (self.split_from is None) == (not self.seeds):
            raise ValueError(
                "exactly one of seeds=(…) or split_from=/universes= "
                "must be given"
            )
        if self.seeds and self.universes:
            raise ValueError(
                f"seeds= fixes U=len(seeds)={len(self.seeds)}; "
                f"universes={self.universes} would be silently ignored "
                "— pass exactly one seed mode"
            )
        if self.split_from is not None and self.universes < 1:
            raise ValueError("universes must be >= 1 with split_from")
        if len(self.knobs) != len(self.values):
            raise ValueError(
                f"{len(self.knobs)} knobs but {len(self.values)} value "
                "rows"
            )
        if len(set(self.knobs)) != len(self.knobs):
            raise ValueError(f"duplicate knob paths in {self.knobs}")
        for path, row in zip(self.knobs, self.values):
            validate_knob(self.entrypoint, self.cfg, path)
            if len(row) != self.U:
                raise ValueError(
                    f"knob {path!r} has {len(row)} values for U="
                    f"{self.U} universes"
                )
        if self.track and self.entrypoint not in ("membership", "sparse"):
            raise ValueError(
                f"track= only applies to membership/sparse, not "
                f"{self.entrypoint!r}"
            )

    @property
    def U(self) -> int:
        return len(self.seeds) if self.seeds else self.universes

    def keys(self, device=None) -> torch.Tensor:
        """int64[U, 2] stacked per-universe keys (uint32 words), on
        ``device`` (None: the current CUDA device).

        ``split_from`` derives key u as ``fold_in(base, u)``, which does
        not depend on U: the first 64 universes of a U=256 sweep are the
        U=64 sweep's universes."""
        device = resolve_device(device)
        if self.seeds:
            return torch.stack([PRNGKey(s, device=device)
                                for s in self.seeds])
        base = PRNGKey(self.split_from, device=device)
        return fold_in(base, torch.arange(self.U, dtype=torch.int64,
                                          device=device))

    def knob_arrays(self, device=None) -> tuple:
        """One ``[U]`` tensor per knob, at the knob's dtype, on ``device``
        (None: the current CUDA device)."""
        device = resolve_device(device)
        return tuple(
            torch.tensor(row, dtype=knob_dtype(path)).to(device)
            for path, row in zip(self.knobs, self.values)
        )


def stacked_init(universe: Universe, device=None):
    """The ``[U, ...]`` initial state on ``device`` (None: the current
    CUDA device): the per-universe init state repeated over the universe
    axis as a real copy (no knob reaches an init, so every universe
    starts from the same state)."""
    spec = SWEEP_ENTRYPOINTS[universe.entrypoint]
    return _stack(spec.init(universe.cfg, resolve_device(device)), universe.U)


def _stack(state, U: int):
    """``state`` repeated over a new leading universe axis, a real copy."""
    return type(state)(*(x.unsqueeze(0).repeat(U, *([1] * x.dim()))
                         for x in state))


def make_sweep(entrypoint: str, U: int, telemetry: bool = False,
               mesh=None, exchange: str = "alltoall"):
    """The batched scan program for (entrypoint, U, telemetry, mesh,
    exchange):

        sweep(stacked_state, keys, values, cfg, steps, knobs, track)
          -> (stacked_final, stacked_outs[, overflow])

    ``stacked_state`` is the ``[U, ...]`` state (:func:`stacked_init`),
    ``keys`` ``int64[U, 2]``, ``values`` one ``[U]`` tensor per path of
    the static ``knobs`` tuple.  Each tick advances all U universes with
    one set of tensor ops; no Python loop runs over the universes.

    ``mesh=`` composes the universe axis with the node shards: each tick
    runs the entrypoint's sharded twin (``parallel/shard.py``) over ``[U,
    D, blk, ...]`` planes, with the outbox budgets per universe and per
    shard and one exchange for all U universes (``exchange``:
    ``"alltoall"`` | ``"ring"``, the ring one kernel launch a tick).  The
    composed program returns a third element, the overflow per universe
    ``int32[U]``; U = 1 x D = 1 equals the unsharded sweep.  Swim and
    lifeguard have no sharded twin and reject ``mesh=``.

    A sparse sweep's ``amortize=None`` resolves to False (the allocation
    branch every tick, no host read), as the reference resolves it for
    its vmapped programs; an explicit True reads its predicates once for
    all U universes.  ``telemetry=True`` threads the in-scan metrics
    (``consul_tpu_torch/obs``) through the batched scan: the outputs gain
    one ``[U, steps, M]`` float32 trace as their last element (summed
    over the shards on the composed plane) and every other output stays
    the same.  One callable per (entrypoint, U, telemetry, mesh,
    exchange), cached."""
    return _make_sweep(entrypoint, U, bool(telemetry), mesh, exchange)


@functools.lru_cache(maxsize=None)
def _make_sweep(entrypoint: str, U: int, telemetry: bool, mesh,
                exchange: str):
    if entrypoint not in SWEEP_ENTRYPOINTS:
        raise ValueError(
            f"unknown sweep entrypoint {entrypoint!r} "
            f"(have: {sorted(SWEEP_ENTRYPOINTS)})"
        )
    if U < 1:
        raise ValueError(f"U must be >= 1, got {U}")
    spec = SWEEP_ENTRYPOINTS[entrypoint]
    if mesh is None:
        if exchange != "alltoall":
            raise ValueError(
                f"exchange={exchange!r} requires mesh= (the outbox "
                "transport only exists on the composed multi-chip plane)"
            )
    elif spec.sharded is None:
        raise ValueError(
            f"entrypoint {entrypoint!r} has no sharded twin — sweep x "
            "shard composition covers: "
            f"{sorted(n for n, s in SWEEP_ENTRYPOINTS.items() if s.sharded)}"
        )
    elif exchange not in shard.EXCHANGE_BACKENDS:
        raise ValueError(
            f"unknown exchange backend {exchange!r}; choose 'alltoall' or "
            "'ring'"
        )

    def sweep(stacked_state, keys, values, cfg, steps, knobs=(), track=()):
        if keys.shape != (U, 2):
            raise ValueError(
                f"this sweep program is built for U={U}, got keys of "
                f"shape {tuple(keys.shape)}"
            )
        for path, v in zip(knobs, values):
            if tuple(v.shape) != (U,) or v.dtype != knob_dtype(path):
                raise ValueError(
                    f"knob {path!r} needs a [{U}] {knob_dtype(path)} "
                    f"tensor, got {tuple(v.shape)} {v.dtype}"
                )
        if entrypoint == "sparse" and cfg.amortize is None:
            cfg = dataclasses.replace(cfg, amortize=resolve_amortize(
                cfg, batched=True))
        ucfg = apply_knobs(cfg, knobs, tuple(values))
        if mesh is None:
            return spec.call(stacked_state, keys, ucfg, steps, track,
                             telemetry)
        return spec.sharded(stacked_state, keys, ucfg, steps, track,
                            telemetry, mesh, exchange)

    tag = "" if mesh is None else f"_D{mesh.n_shards}"
    sweep.__name__ = f"sweep_{entrypoint}_U{U}{tag}"
    return sweep


def abstract_sweep_program(entrypoint: str, cfg, steps: int, U: int,
                           knobs: tuple = (), track: tuple = (),
                           telemetry: bool = False, mesh=None,
                           exchange: str = "alltoall"):
    """``(fn, make_args)`` of the batched program, the registry's build
    shape (``sim/registry.py``): ``fn(*make_args(device))`` runs the sweep
    on ``device``.  ``make_args`` allocates only when called: the
    config's initial state stacked U times, ``PRNGKey(0)`` as every
    universe's key and each knob at the config's own value, so U copies
    of the plain study (at U = 1 exactly the plain scan's arguments);
    ``make_args("meta")`` gives their shapes with no storage.
    ``mesh=``/``exchange=`` build the composed sweep x shard program."""
    spec = SWEEP_ENTRYPOINTS[entrypoint]
    sweep = make_sweep(entrypoint, U, telemetry, mesh, exchange)

    def make_args(device):
        device = torch.device(device)
        stacked = _stack(spec.init(cfg, device), U)
        keys = PRNGKey(0, device=device).unsqueeze(0).repeat(U, 1)
        values = tuple(
            torch.full((U,), getattr(*_resolve_path(cfg, p)),
                       dtype=knob_dtype(p), device=device)
            for p in knobs
        )
        return stacked, keys, values

    def fn(s, k, v):
        return sweep(s, k, v, cfg, steps, knobs, track)

    return fn, make_args
