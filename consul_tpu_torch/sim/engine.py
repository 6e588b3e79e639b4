"""The study engine: tick loops over the round functions, timed on the device.

The port of the broadcast, SWIM, Lifeguard, membership (dense and
sparse, unsharded and over D logical shards), multi-DC, geo and
streamcast paths of ``consul_tpu/sim/engine.py``, and of its universe
sweeps (:func:`run_sweep`: the broadcast, SWIM, Lifeguard, streamcast
and geo scans run U universes at once over a leading universe axis).  Round
keys are counter-based as in the reference: round ``t`` draws from
``fold_in(scan_key, t)``, so trajectories are prefix-stable in ``steps``
and the sharded twin stays bit-equal at D == 1.  ``lax.scan`` becomes a
Python loop; each tick's counters go into preallocated device tensors
and stay there until the end.
"""

from __future__ import annotations

import time

import torch

from consul_tpu_torch.device import resolve_device
from consul_tpu_torch.models.broadcast import (
    BroadcastConfig,
    broadcast_init,
    broadcast_round,
)
from consul_tpu_torch.models.membership import (
    MembershipConfig,
    membership_constants,
    membership_counts,
    membership_init,
    membership_round,
    track_outputs,
)
from consul_tpu_torch.models.multidc import (
    MultiDCConfig,
    multidc_init,
    multidc_round,
)
from consul_tpu_torch.models.membership_sparse import (
    n_squared,
    sparse_constants,
    sparse_membership_counts,
    sparse_membership_init,
    sparse_membership_round,
)
from consul_tpu_torch.models.swim import (
    VIEW_DEAD,
    VIEW_SUSPECT,
    SwimConfig,
    swim_constants,
    swim_init,
    swim_round,
)
from consul_tpu_torch.obs.spec import metric_names, open_trace, with_trace
from consul_tpu_torch.ops import PRNGKey, fold_in
from consul_tpu_torch.parallel.shard import (
    sharded_broadcast_scan,
    sharded_geo_scan,
    sharded_membership_scan,
    sharded_sparse_membership_scan,
    sharded_streamcast_scan,
)
from consul_tpu_torch.sim.metrics import (
    BroadcastReport,
    FalsePositiveReport,
    MembershipReport,
    MultiDCReport,
    SwimReport,
)


# The program registry and the ladder (``sim/registry.py``), exported here
# as the reference exports them; loaded on first touch, since the registry
# imports this module.
_REGISTRY_NAMES = frozenset({
    "EQUIV_PAIRS", "EquivPair", "SimProgram", "broadcast_program_at",
    "jaxlint_registry", "sparse_program_at", "swim_program_at",
    "walk_equiv_pairs",
})


def __getattr__(name: str):
    if name in _REGISTRY_NAMES:
        from consul_tpu_torch.sim import registry

        return getattr(registry, name)
    raise AttributeError(name)


def _per_tick(key: torch.Tensor, steps: int, *shape, dtype=torch.int32):
    """A scan output ``[*B, steps, *shape]`` for a key batch ``[*B, 2]``
    (``B`` empty for a plain run, ``[U]`` for a sweep)."""
    return torch.empty((*key.shape[:-1], steps, *shape), dtype=dtype,
                       device=key.device)


def _count_nodes(x: torch.Tensor) -> torch.Tensor:
    """int32 sum over the node axis, the last: one count per universe."""
    return torch.sum(x, dim=-1, dtype=torch.int32)


def broadcast_scan(state, key: torch.Tensor, cfg: BroadcastConfig,
                   steps: int, telemetry: bool = False):
    """Run ``steps`` gossip ticks; returns (final_state, infected[steps]).
    A key batch ``[U, 2]`` over a stacked ``[U, ...]`` state runs U
    universes in each tick (the sweep plane); outputs gain a leading U.

    ``telemetry`` appends one output, the ``[steps, M]`` float32 trace of
    the Consul-named metrics (``obs/spec.py``): (final, (infected,
    trace)).  Every other output is the same with it on; off, no emitter
    runs.  The same seam is on every scan below."""
    infected = _per_tick(key, steps)
    trace = open_trace("broadcast", key, steps, telemetry)
    for t in range(steps):
        prev = state if trace is not None else None
        state = broadcast_round(state, fold_in(key, t), cfg)
        infected[..., t] = _count_nodes(state.knows)
        if trace is not None:
            trace.record(t, prev, state, infected[..., t], cfg)
    return state, (infected if trace is None else (infected, trace.buf))


def multidc_scan(state, key: torch.Tensor, cfg: MultiDCConfig, steps: int):
    """Run ``steps`` LAN ticks of the two-edge-class broadcast; returns
    (final_state, (infected_total[steps], infected_per_segment[steps, S]))."""
    dev = key.device
    total = torch.empty(steps, dtype=torch.int32, device=dev)
    per_seg = torch.empty((steps, cfg.segments), dtype=torch.int32,
                          device=dev)
    for t in range(steps):
        state = multidc_round(state, fold_in(key, t), cfg)
        per_seg[t] = torch.sum(state.knows.view(cfg.segments, cfg.seg_size),
                               dim=1, dtype=torch.int32)
        total[t] = torch.sum(state.knows, dtype=torch.int32)
    return state, (total, per_seg)


def geo_scan(state, key: torch.Tensor, cfg, steps: int,
             telemetry: bool = False):
    """Run ``steps`` LAN ticks of the geo/WAN plane (``geo.model.geo_round``);
    returns ``(final_state, outs)`` with ``outs`` the per-tick
    ``(per_segment, offered, admitted, queued, overflow, wasted)`` (and
    the trace with ``telemetry``).  Batches over a key batch as
    :func:`broadcast_scan` does."""
    # Imported at call time: geo.model depends on sim.faults, whose
    # package imports this module.
    from consul_tpu_torch.geo.model import geo_constants, geo_round

    consts = geo_constants(cfg, key.device)
    S, S2 = cfg.segments, cfg.n_links
    outs = (_per_tick(key, steps, S),
            *(_per_tick(key, steps, S2) for _ in range(4)),
            _per_tick(key, steps))
    nb = key.dim() - 1
    trace = open_trace("geo", key, steps, telemetry)
    for t in range(steps):
        prev = state if trace is not None else None
        state, out = geo_round(state, fold_in(key, t), cfg, consts)
        for o, v in zip(outs, out):
            o.select(nb, t).copy_(v)
        if trace is not None:
            trace.record(t, prev, state, out, cfg)
    return state, with_trace(outs, trace)


def streamcast_outputs(cfg, steps: int, device, batch: tuple = ()) -> tuple:
    """Preallocated per-tick outputs of a streamcast scan: the window
    snapshots ``[*batch, steps, W]`` (slot_event, slot_birth, done_count)
    and the cumulative counters ``[*batch, steps]`` (offered, delivered,
    quiesced, window_overflow, coalesced) and ``sent``, all int32."""
    return tuple(
        torch.empty((*batch, steps, cfg.window) if i < 3
                    else (*batch, steps), dtype=torch.int32, device=device)
        for i in range(9)
    )


def streamcast_scan(state, key: torch.Tensor, cfg, steps: int,
                    telemetry: bool = False):
    """Run ``steps`` ticks of the pipelined event stream; returns
    ``(final_state, outs)`` with ``outs`` the per-tick window snapshots
    and counters (:func:`streamcast_outputs`; the trace last with
    ``telemetry``).  The arrival schedule comes
    from ``fold_in(key, _SCHED_SALT)``, round ``t`` from
    ``fold_in(key, t)``.  Batches over a key batch as
    :func:`broadcast_scan` does."""
    # Imported at call time: streamcast.model depends on sim.faults,
    # whose package imports this module.
    from consul_tpu_torch.streamcast.model import (
        _SCHED_SALT,
        arrival_arrays,
        streamcast_round,
    )

    sched = arrival_arrays(cfg, fold_in(key, _SCHED_SALT))
    batch = tuple(key.shape[:-1])
    outs = streamcast_outputs(cfg, steps, key.device, batch)
    trace = open_trace("streamcast", key, steps, telemetry)
    for t in range(steps):
        prev = state if trace is not None else None
        state, out = streamcast_round(state, fold_in(key, t), cfg, sched)
        for o, v in zip(outs, out):
            o.select(len(batch), t).copy_(v)
        if trace is not None:
            trace.record(t, prev, state, out, cfg)
    return state, with_trace(outs, trace)


def _count(view: torch.Tensor, value: int) -> torch.Tensor:
    return _count_nodes(view == value)


def swim_scan(state, key: torch.Tensor, cfg: SwimConfig, steps: int,
              telemetry: bool = False):
    """Run ``steps`` ticks; returns (final_state, (suspecting[steps],
    dead_known[steps])), the trace last with ``telemetry``.  Batches over
    a key batch as :func:`broadcast_scan` does."""
    consts = swim_constants(cfg, key.device)
    suspecting = _per_tick(key, steps)
    dead_known = _per_tick(key, steps)
    trace = open_trace("swim", key, steps, telemetry)
    for t in range(steps):
        prev = state if trace is not None else None
        state = swim_round(state, fold_in(key, t), cfg, consts)
        suspecting[..., t] = _count(state.view, VIEW_SUSPECT)
        dead_known[..., t] = _count(state.view, VIEW_DEAD)
        if trace is not None:
            trace.record(t, prev, state, None, cfg)
    outs = (suspecting, dead_known)
    return state, with_trace(outs, trace)


def lifeguard_scan(state, key: torch.Tensor, cfg, steps: int,
                   telemetry: bool = False):
    """Run ``steps`` fault-injected Lifeguard ticks; returns (final_state,
    (suspecting, dead_known, fp_events, refutes, mean_awareness)), the
    trace last with ``telemetry``.

    ``fp_events`` diffs each tick's state against the one before it
    (fresh ALIVE->SUSPECT views while the subject is actually alive),
    which is sound because a round never writes into its input."""
    # Imported at call time: models.lifeguard depends on sim.faults, so
    # a module-level import here would close an import cycle through
    # the package __init__s.
    from consul_tpu_torch.models.lifeguard import (
        lifeguard_constants,
        lifeguard_round,
        mean_f32,
    )

    consts = lifeguard_constants(cfg, key.device)
    outs = tuple(_per_tick(key, steps) for _ in range(4))
    suspecting, dead_known, fp_events, refutes = outs
    mean_awareness = _per_tick(key, steps, dtype=torch.float32)
    trace = open_trace("lifeguard", key, steps, telemetry)
    for t in range(steps):
        nxt = lifeguard_round(state, fold_in(key, t), cfg, consts)
        newly_suspect = _count_nodes(
            (nxt.view == VIEW_SUSPECT) & (state.view != VIEW_SUSPECT))
        subject_live = (state.tick < cfg.fail_at_tick) | cfg.subject_alive
        suspecting[..., t] = _count(nxt.view, VIEW_SUSPECT)
        dead_known[..., t] = _count(nxt.view, VIEW_DEAD)
        fp_events[..., t] = torch.where(subject_live, newly_suspect, 0)
        refutes[..., t] = nxt.subject_inc - state.subject_inc
        mean_awareness[..., t] = mean_f32(nxt.awareness)
        if trace is not None:
            trace.record(t, state, nxt, None, cfg)
        state = nxt
    outs = (*outs, mean_awareness)
    return state, with_trace(outs, trace)


def membership_scan(state, key: torch.Tensor, cfg: MembershipConfig,
                    steps: int, track: tuple = (), telemetry: bool = False):
    """Run ``steps`` ticks of the dense full-membership model.  Per tick:
    for each tracked subject j the OTHER nodes viewing j SUSPECT / DEAD,
    the global count of suspect cells, and the sum of membership-list
    sizes.  Returns (final_state, (suspecting, dead_known, suspect_cells,
    known_members)), the trace last with ``telemetry``.  Batches over a
    key batch as :func:`broadcast_scan` does."""
    dev = key.device
    consts = membership_constants(cfg, dev)
    track_idx = torch.tensor(track, dtype=torch.int64).to(dev)
    batch = tuple(key.shape[:-1])
    outs = track_outputs(steps, len(track), torch.int32, dev, batch)
    trace = open_trace("membership", key, steps, telemetry)
    for t in range(steps):
        prev = state if trace is not None else None
        state = membership_round(state, fold_in(key, t), cfg, consts)
        counts = membership_counts(state.key, track_idx)
        for o, v in zip(outs, counts):
            o.select(len(batch), t).copy_(v)
        if trace is not None:
            trace.record(t, prev, state, counts, cfg)
    return state, with_trace(outs, trace)


def sparse_membership_scan(state, key: torch.Tensor, cfg, steps: int,
                           track: tuple = (), telemetry: bool = False):
    """The sparse twin of :func:`membership_scan`: counts match slots by
    subject id, so they do not depend on the row order (nor do its
    metrics, the trace last with ``telemetry``).  ``known_members``
    is the float32 gauge ``f32(n) * n - dead_cells`` (n**2 overflows int32
    at the scales this model exists for; exact while the dead-cell count
    stays below 2**24).  Batches over a key batch as
    :func:`broadcast_scan` does."""
    dev = key.device
    consts = sparse_constants(cfg, dev)
    track_idx = torch.tensor(track, dtype=torch.int32).to(dev)
    n_sq = n_squared(cfg.base.n, dev)
    batch = tuple(key.shape[:-1])
    outs = track_outputs(steps, len(track), torch.float32, dev, batch)
    trace = open_trace("sparse", key, steps, telemetry)
    for t in range(steps):
        prev = state if trace is not None else None
        state = sparse_membership_round(state, fold_in(key, t), cfg, consts)
        counts = sparse_membership_counts(state, track_idx, n_sq)
        for o, v in zip(outs, counts):
            o.select(len(batch), t).copy_(v)
        if trace is not None:
            trace.record(t, prev, state, counts, cfg)
    return state, with_trace(outs, trace)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(make_state, scan_fn, key, device, warmup: bool):
    """Run a scan, returning (final state, host outputs, wall seconds).

    The fence is ``torch.cuda.synchronize()`` plus the device-to-host copy
    of the per-tick counters.  With ``warmup`` the study runs once outside
    the timed region, so the wall time is steady-state."""
    def host(out):
        if isinstance(out, torch.Tensor):
            out = (out,)
        return tuple(o.cpu().numpy() for o in out)

    if warmup:
        _, out = scan_fn(make_state(), key)
        host(out)
    state = make_state()
    _sync(device)
    t0 = time.perf_counter()
    final, out = scan_fn(state, key)
    _sync(device)
    out = host(out)
    wall = time.perf_counter() - t0
    return final, out, wall


def _check_later_slice(**knobs) -> None:
    """Knobs of the reference entry points that wait for a later slice of
    the port are rejected, never ignored."""
    for name, (value, default) in knobs.items():
        if value != default:
            raise NotImplementedError(
                f"{name}= is not ported yet (the reference's multi-card "
                "placement waits for a machine with several cards)"
            )


def _check_exchange(exchange: str, mesh) -> None:
    """The exchange backend is a knob of the sharded plane: asking for a
    non-default transport without a mesh would silently ignore it, so
    reject it loudly instead."""
    if exchange != "alltoall" and mesh is None:
        raise ValueError(
            f"exchange={exchange!r} requires mesh= (the outbox transport "
            "only exists on the sharded plane)"
        )


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _split_trace(outs: tuple, telemetry: bool):
    """(outputs, trace): a ``telemetry=True`` scan's trace rides last."""
    if not telemetry:
        return outs, None
    return outs[:-1], outs[-1]


def _trace_fields(entrypoint: str, trace) -> dict:
    """Report fields of a ``telemetry=True`` study (empty when off)."""
    if trace is None:
        return {}
    return {"metric_names": metric_names(entrypoint), "metrics_trace": trace}


def run_broadcast(
    cfg: BroadcastConfig,
    steps: int,
    seed: int = 0,
    origin: int = 0,
    sharded: bool = False,
    mesh=None,
    warmup: bool = True,
    exchange: str = "alltoall",
    telemetry: bool = False,
    device=None,
) -> BroadcastReport:
    """One broadcast study.  ``mesh=`` selects the sharded plane
    (``parallel/shard.py``: D logical shards, outbox message routing,
    D == 1 bit-equal to the unsharded scan) and fills
    ``report.overflow``; ``exchange`` picks its outbox transport
    (``"alltoall"`` | ``"ring"``).  ``telemetry`` fills
    ``report.metrics_trace`` with the ``[steps, M]`` Consul-named trace
    (``consul_tpu_torch/obs``) and every other output stays the same; the
    same seam is on every ``run_*`` below.  Runs on CUDA unless
    ``device`` (or the mesh's device) says otherwise; ``sharded`` (the
    reference's multi-card placement) is rejected."""
    _check_later_slice(sharded=(sharded, False))
    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    key = PRNGKey(seed, device=dev)

    def make_state():
        return broadcast_init(cfg, origin=origin, device=dev)

    if mesh is not None:
        def scan(st, k):
            return sharded_broadcast_scan(st, k, cfg, steps, mesh, exchange,
                                          telemetry)
    else:
        def scan(st, k):
            final, outs = broadcast_scan(st, k, cfg, steps, telemetry)
            return final, (outs if telemetry else (outs,))

    _, outs, wall = _timed(make_state, scan, key, dev, warmup)
    out, trace = _split_trace(outs, telemetry)
    return BroadcastReport(
        n=cfg.n,
        ticks=steps,
        tick_ms=cfg.profile.gossip_interval_ms,
        infected=out[0],
        wall_s=wall,
        overflow=int(out[1]) if mesh is not None else None,
        device=_device_name(dev),
        **_trace_fields("broadcast", trace),
    )


def run_swim(
    cfg: SwimConfig,
    steps: int,
    seed: int = 0,
    sharded: bool = False,
    mesh=None,
    warmup: bool = True,
    telemetry: bool = False,
    device=None,
) -> SwimReport:
    """One failure-detection study.  Runs on CUDA unless ``device`` says
    otherwise; with ``warmup`` the study runs once untimed first;
    ``telemetry`` as :func:`run_broadcast`; ``sharded`` and ``mesh`` (the
    reference's multi-card placement) are rejected."""
    _check_later_slice(sharded=(sharded, False), mesh=(mesh, None))
    dev = resolve_device(device)
    _, outs, wall = _timed(
        lambda: swim_init(cfg, device=dev),
        lambda st, k: swim_scan(st, k, cfg, steps, telemetry),
        PRNGKey(seed, device=dev), dev, warmup,
    )
    (sus, dead), trace = _split_trace(outs, telemetry)
    return SwimReport(
        n=cfg.n,
        ticks=steps,
        tick_ms=cfg.profile.gossip_interval_ms,
        probe_interval_ms=cfg.profile.probe_interval_ms,
        suspecting=sus,
        dead_known=dead,
        wall_s=wall,
        device=_device_name(dev),
        **_trace_fields("swim", trace),
    )


def run_lifeguard(
    cfg,
    steps: int,
    seed: int = 0,
    sharded: bool = False,
    mesh=None,
    warmup: bool = True,
    telemetry: bool = False,
    device=None,
) -> FalsePositiveReport:
    """Fault-injected Lifeguard study (``cfg``: a LifeguardConfig): the
    accuracy (false-positive) workload, with :func:`run_swim`'s device,
    timing, telemetry and placement contract."""
    _check_later_slice(sharded=(sharded, False), mesh=(mesh, None))
    from consul_tpu_torch.models.lifeguard import lifeguard_init

    dev = resolve_device(device)
    _, outs, wall = _timed(
        lambda: lifeguard_init(cfg, device=dev),
        lambda st, k: lifeguard_scan(st, k, cfg, steps, telemetry),
        PRNGKey(seed, device=dev), dev, warmup,
    )
    (sus, dead, fp, refutes, aware), trace = _split_trace(outs, telemetry)
    return FalsePositiveReport(
        n=cfg.n,
        ticks=steps,
        tick_ms=cfg.profile.gossip_interval_ms,
        probe_interval_ms=cfg.profile.probe_interval_ms,
        lifeguard=cfg.lifeguard,
        subject_alive=cfg.subject_alive,
        fail_at_tick=cfg.fail_at_tick,
        suspecting=sus,
        dead_known=dead,
        fp_events=fp,
        refutes=refutes,
        mean_awareness=aware,
        wall_s=wall,
        device=_device_name(dev),
        **_trace_fields("lifeguard", trace),
    )


def _membership_report(cfg: MembershipConfig, track, outs, wall, dev,
                       entrypoint: str, trace) -> MembershipReport:
    sus, dead, sus_cells, known = outs
    return MembershipReport(
        n=cfg.n,
        ticks=sus_cells.shape[0],
        tick_ms=cfg.profile.gossip_interval_ms,
        probe_interval_ms=cfg.profile.probe_interval_ms,
        track=tuple(track),
        suspecting=sus,
        dead_known=dead,
        suspect_cells=sus_cells,
        known_members=known,
        wall_s=wall,
        device=_device_name(dev),
        **_trace_fields(entrypoint, trace),
    )


def run_membership(
    cfg: MembershipConfig,
    steps: int,
    seed: int = 0,
    track: tuple = (),
    sharded: bool = False,
    mesh=None,
    warmup: bool = True,
    exchange: str = "alltoall",
    telemetry: bool = False,
    device=None,
) -> MembershipReport:
    """Dense full-membership study; ``track`` selects the subjects whose
    detection curves come back per tick.  ``mesh=`` runs the sharded twin
    (``parallel/shard.py``: observer rows over D logical shards, gossip
    over the outbox, budgeted push/pull at D > 1) and fills
    ``report.overflow``; ``exchange`` picks its outbox transport;
    ``telemetry`` as :func:`run_broadcast`.  Runs on CUDA unless
    ``device`` (or the mesh's device) says otherwise; ``sharded`` (the
    reference's multi-card placement) is rejected."""
    _check_later_slice(sharded=(sharded, False))
    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    track = tuple(track)
    if mesh is not None:
        def scan(st, k):
            return sharded_membership_scan(st, k, cfg, steps, mesh, track,
                                           exchange, telemetry)
    else:
        def scan(st, k):
            return membership_scan(st, k, cfg, steps, track, telemetry)

    _, outs, wall = _timed(lambda: membership_init(cfg, device=dev), scan,
                           PRNGKey(seed, device=dev), dev, warmup)
    outs, trace = _split_trace(outs, telemetry)
    report = _membership_report(cfg, track, outs[:4], wall, dev,
                                "membership", trace)
    if mesh is not None:
        report.overflow = int(outs[4])
    return report


def run_membership_sparse(
    cfg,
    steps: int,
    seed: int = 0,
    track: tuple = (),
    warmup: bool = True,
    mesh=None,
    exchange: str = "alltoall",
    telemetry: bool = False,
    device=None,
):
    """Top-K sparse membership study (``cfg``: a SparseMembershipConfig),
    delivered through the sort-merge path (``ops/sortmerge.py``).  Returns
    ``(report, overflow)``, the final state's overflow counter.  ``mesh=``
    shards the observer rows over D logical shards (the overflow then
    also counts outbox misses); ``exchange`` picks the outbox transport;
    ``telemetry`` as :func:`run_broadcast`.  Runs on CUDA unless
    ``device`` (or the mesh's device) says otherwise."""
    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    track = tuple(track)
    if mesh is not None:
        def scan(st, k):
            return sharded_sparse_membership_scan(st, k, cfg, steps, mesh,
                                                  track, exchange, telemetry)
    else:
        def scan(st, k):
            return sparse_membership_scan(st, k, cfg, steps, track,
                                          telemetry)

    final, outs, wall = _timed(
        lambda: sparse_membership_init(cfg, device=dev), scan,
        PRNGKey(seed, device=dev), dev, warmup)
    outs, trace = _split_trace(outs, telemetry)
    report = _membership_report(cfg.base, track, outs, wall, dev, "sparse",
                                trace)
    report.forgotten = int(final.forgotten)
    return report, int(final.overflow)


def run_multidc(
    cfg: MultiDCConfig,
    steps: int,
    seed: int = 0,
    origin: int = 0,
    sharded: bool = False,
    mesh=None,
    warmup: bool = True,
    device=None,
) -> MultiDCReport:
    """Two-edge-class (LAN intra-segment / WAN cross-segment) broadcast
    study.  Runs on CUDA unless ``device`` says otherwise.  ``sharded``
    and ``mesh`` (the reference's placement of whole segments on each of
    several devices, which leaves the results unchanged) wait for the
    multi-card work and are rejected.  The reference has no telemetry
    seam here."""
    _check_later_slice(sharded=(sharded, False), mesh=(mesh, None))
    dev = resolve_device(device)
    _, (total, per_seg), wall = _timed(
        lambda: multidc_init(cfg, origin=origin, device=dev),
        lambda st, k: multidc_scan(st, k, cfg, steps),
        PRNGKey(seed, device=dev), dev, warmup,
    )
    return MultiDCReport(
        n=cfg.n,
        segments=cfg.segments,
        ticks=steps,
        tick_ms=cfg.lan_profile.gossip_interval_ms,
        infected=total,
        per_segment=per_seg,
        wall_s=wall,
        device=_device_name(dev),
    )


def run_geo(
    cfg,
    steps: int,
    seed: int = 0,
    warmup: bool = True,
    mesh=None,
    exchange: str = "alltoall",
    telemetry: bool = False,
    device=None,
):
    """Geo-distributed WAN study (cfg: a GeoConfig): E concurrent events
    spread over S segments through latency-delayed, bandwidth-capped WAN
    links with adaptive (or fixed) anti-entropy between the bridge sets.
    Returns a ``geo.GeoReport``.  ``mesh=`` runs the sharded twin
    (segments laid out contiguously over D logical shards, WAN units over
    the outbox) and fills ``report.shard_overflow``; ``exchange`` picks
    its transport; ``telemetry`` as :func:`run_broadcast`.  Runs on CUDA
    unless ``device`` (or the mesh's device) says otherwise."""
    from consul_tpu_torch.geo.model import geo_init
    from consul_tpu_torch.geo.report import GeoReport

    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    if mesh is not None:
        def scan(st, k):
            return sharded_geo_scan(st, k, cfg, steps, mesh, exchange,
                                    telemetry)
    else:
        def scan(st, k):
            return geo_scan(st, k, cfg, steps, telemetry)

    _, outs, wall = _timed(lambda: geo_init(cfg, device=dev), scan,
                           PRNGKey(seed, device=dev), dev, warmup)
    outs, trace = _split_trace(outs, telemetry)
    per_segment, offered, admitted, queued, overflow, wasted = outs[:6]
    return GeoReport(
        n=cfg.n,
        segments=cfg.segments,
        events=cfg.events,
        ticks=steps,
        tick_ms=cfg.lan_profile.gossip_interval_ms,
        msg_bytes=cfg.wan_msg_bytes,
        adaptive=cfg.adaptive,
        per_segment=per_segment,
        offered=offered,
        admitted=admitted,
        queued=queued,
        overflow=overflow,
        wasted=wasted,
        wall_s=wall,
        shard_overflow=int(outs[6][-1]) if mesh is not None else None,
        device=_device_name(dev),
        **_trace_fields("geo", trace),
    )


def run_streamcast(
    cfg,
    steps: int,
    seed: int = 0,
    warmup: bool = True,
    mesh=None,
    exchange: str = "alltoall",
    telemetry: bool = False,
    policy: str = None,
    device=None,
):
    """Sustained-load streamcast study (cfg: a StreamcastConfig): a
    continuous chunked event stream under the pipelined per-round
    transmit budget.  Returns a ``streamcast.StreamcastReport``.
    ``policy=`` rebuilds the config with that chunk-selection policy (a
    typo fails in the config's validation).  ``mesh=`` runs the sharded
    twin (chunk planes over D logical shards, edges messages over the
    outbox) and fills ``report.shard_overflow``; ``exchange`` picks its
    transport; ``telemetry`` as :func:`run_broadcast`.  Runs on CUDA
    unless ``device`` (or the mesh's device) says otherwise."""
    import dataclasses

    from consul_tpu_torch.streamcast.model import streamcast_init
    from consul_tpu_torch.streamcast.report import StreamcastReport

    if policy is not None and policy != cfg.policy:
        cfg = dataclasses.replace(cfg, policy=policy)
    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    if mesh is not None:
        def scan(st, k):
            return sharded_streamcast_scan(st, k, cfg, steps, mesh, exchange,
                                           telemetry)
    else:
        def scan(st, k):
            return streamcast_scan(st, k, cfg, steps, telemetry)

    _, outs, wall = _timed(lambda: streamcast_init(cfg, device=dev), scan,
                           PRNGKey(seed, device=dev), dev, warmup)
    outs, trace = _split_trace(outs, telemetry)
    (slot_event, slot_birth, done_count, offered, delivered, quiesced,
     overflow, coalesced, sent) = outs[:9]
    return StreamcastReport(
        n=cfg.n,
        ticks=steps,
        tick_ms=cfg.profile.gossip_interval_ms,
        window=cfg.window,
        chunks=cfg.chunks,
        k_events=cfg.k_events,
        slot_event=slot_event,
        slot_birth=slot_birth,
        done_count=done_count,
        offered=offered,
        delivered=delivered,
        quiesced=quiesced,
        window_overflow=overflow,
        coalesced=coalesced,
        sent=sent,
        wall_s=wall,
        policy=cfg.policy,
        shard_overflow=int(outs[9][-1]) if mesh is not None else None,
        device=_device_name(dev),
        **_trace_fields("streamcast", trace),
    )


def run_sweep(universe, warmup: bool = True, telemetry: bool = False,
              mesh=None, exchange: str = "alltoall", device=None):
    """Run a universe sweep (``consul_tpu_torch.sweep``): one batched
    program advances all U universes (stacked ``[U, ...]`` state,
    per-universe keys, knob values as ``[U]`` tensors) and the stacked
    per-tick counters reduce on the host into a ``SweepReport`` (FP rate,
    flaps, detection-latency quantiles, throughput, Pareto frontier).

    The wall time is the host clock around the batched scan, fenced by
    ``torch.cuda.synchronize()`` and the copy of the outputs to the host;
    with ``warmup`` the sweep runs once untimed first.  Runs on CUDA
    unless ``device`` (or the mesh's device) says otherwise.

    ``mesh=`` composes the universe axis with the node shards (the sweep
    x shard composition of ``make_sweep``): the report gains
    ``outbox_overflow``, the overflow per universe, and ``devices``, the
    shard count; ``exchange`` picks the outbox transport.  ``telemetry``
    fills ``report.metrics_trace`` with the ``[U, steps, M]`` trace (and
    ``metric_names``); every other output stays the same."""
    from consul_tpu_torch.sweep.frontier import summarize_sweep
    from consul_tpu_torch.sweep.universe import make_sweep, stacked_init

    sweep = make_sweep(universe.entrypoint, universe.U, telemetry, mesh,
                       exchange)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    keys = universe.keys(dev)
    values = universe.knob_arrays(dev)

    def scan(state, k):
        out = sweep(state, k, values, universe.cfg, universe.steps,
                    universe.knobs, universe.track)
        if mesh is None:
            return out
        final, outs, overflow = out
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        return final, (*outs, overflow)

    _, outs, wall = _timed(lambda: stacked_init(universe, dev), scan, keys,
                           dev, warmup)
    overflow = None
    if mesh is not None:
        *outs, overflow = outs
        outs = tuple(outs)
    # The [U, steps, M] trace rides last; the summarizer reads the
    # telemetry-off outputs.
    outs, trace = _split_trace(outs, telemetry)
    report = summarize_sweep(
        universe, outs[0] if universe.entrypoint == "broadcast" else outs,
        wall)
    report.device = _device_name(dev)
    report.outputs = outs
    if trace is not None:
        report.metric_names = metric_names(universe.entrypoint)
        report.metrics_trace = trace
    if overflow is not None:
        report.outbox_overflow = overflow
        report.devices = mesh.n_shards
    return report
