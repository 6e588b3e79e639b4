"""The study engine: tick loops over the round functions, timed on the device.

The port of the broadcast, SWIM, Lifeguard, membership (dense and
sparse, unsharded and over D logical shards), multi-DC, geo and
streamcast paths of ``consul_tpu/sim/engine.py``.  Round
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


def broadcast_scan(state, key: torch.Tensor, cfg: BroadcastConfig,
                   steps: int):
    """Run ``steps`` gossip ticks; returns (final_state, infected[steps])."""
    infected = torch.empty(steps, dtype=torch.int32, device=key.device)
    for t in range(steps):
        state = broadcast_round(state, fold_in(key, t), cfg)
        infected[t] = torch.sum(state.knows, dtype=torch.int32)
    return state, infected


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


def geo_scan(state, key: torch.Tensor, cfg, steps: int):
    """Run ``steps`` LAN ticks of the geo/WAN plane (``geo.model.geo_round``);
    returns ``(final_state, outs)`` with ``outs`` the per-tick
    ``(per_segment, offered, admitted, queued, overflow, wasted)``."""
    # Imported at call time: geo.model depends on sim.faults, whose
    # package imports this module.
    from consul_tpu_torch.geo.model import geo_constants, geo_round

    dev = key.device
    consts = geo_constants(cfg, dev)
    S, S2 = cfg.segments, cfg.n_links
    outs = (
        torch.empty((steps, S), dtype=torch.int32, device=dev),
        *(torch.empty((steps, S2), dtype=torch.int32, device=dev)
          for _ in range(4)),
        torch.empty(steps, dtype=torch.int32, device=dev),
    )
    for t in range(steps):
        state, out = geo_round(state, fold_in(key, t), cfg, consts)
        for o, v in zip(outs, out):
            o[t] = v
    return state, outs


def streamcast_outputs(cfg, steps: int, device) -> tuple:
    """Preallocated per-tick outputs of a streamcast scan: the window
    snapshots ``[steps, W]`` (slot_event, slot_birth, done_count) and the
    cumulative counters ``[steps]`` (offered, delivered, quiesced,
    window_overflow, coalesced) and ``sent``, all int32."""
    return tuple(
        torch.empty((steps, cfg.window) if i < 3 else (steps,),
                    dtype=torch.int32, device=device)
        for i in range(9)
    )


def streamcast_scan(state, key: torch.Tensor, cfg, steps: int):
    """Run ``steps`` ticks of the pipelined event stream; returns
    ``(final_state, outs)`` with ``outs`` the per-tick window snapshots
    and counters (:func:`streamcast_outputs`).  The arrival schedule comes
    from ``fold_in(key, _SCHED_SALT)``, round ``t`` from
    ``fold_in(key, t)``."""
    # Imported at call time: streamcast.model depends on sim.faults,
    # whose package imports this module.
    from consul_tpu_torch.streamcast.model import (
        _SCHED_SALT,
        arrival_arrays,
        streamcast_round,
    )

    sched = arrival_arrays(cfg, fold_in(key, _SCHED_SALT))
    outs = streamcast_outputs(cfg, steps, key.device)
    for t in range(steps):
        state, out = streamcast_round(state, fold_in(key, t), cfg, sched)
        for o, v in zip(outs, out):
            o[t] = v
    return state, outs


def _count(view: torch.Tensor, value: int) -> torch.Tensor:
    return torch.sum(view == value, dtype=torch.int32)


def swim_scan(state, key: torch.Tensor, cfg: SwimConfig, steps: int):
    """Run ``steps`` ticks; returns (final_state, (suspecting[steps],
    dead_known[steps]))."""
    dev = key.device
    consts = swim_constants(cfg, dev)
    suspecting = torch.empty(steps, dtype=torch.int32, device=dev)
    dead_known = torch.empty(steps, dtype=torch.int32, device=dev)
    for t in range(steps):
        state = swim_round(state, fold_in(key, t), cfg, consts)
        suspecting[t] = _count(state.view, VIEW_SUSPECT)
        dead_known[t] = _count(state.view, VIEW_DEAD)
    return state, (suspecting, dead_known)


def lifeguard_scan(state, key: torch.Tensor, cfg, steps: int):
    """Run ``steps`` fault-injected Lifeguard ticks; returns (final_state,
    (suspecting, dead_known, fp_events, refutes, mean_awareness)).

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

    dev = key.device
    consts = lifeguard_constants(cfg, dev)
    outs = tuple(torch.empty(steps, dtype=torch.int32, device=dev)
                 for _ in range(4))
    suspecting, dead_known, fp_events, refutes = outs
    mean_awareness = torch.empty(steps, dtype=torch.float32, device=dev)
    for t in range(steps):
        nxt = lifeguard_round(state, fold_in(key, t), cfg, consts)
        newly_suspect = torch.sum(
            (nxt.view == VIEW_SUSPECT) & (state.view != VIEW_SUSPECT),
            dtype=torch.int32,
        )
        subject_live = (state.tick < cfg.fail_at_tick) | cfg.subject_alive
        suspecting[t] = _count(nxt.view, VIEW_SUSPECT)
        dead_known[t] = _count(nxt.view, VIEW_DEAD)
        fp_events[t] = torch.where(subject_live, newly_suspect, 0)
        refutes[t] = nxt.subject_inc - state.subject_inc
        mean_awareness[t] = mean_f32(nxt.awareness)
        state = nxt
    return state, (*outs, mean_awareness)


def membership_scan(state, key: torch.Tensor, cfg: MembershipConfig,
                    steps: int, track: tuple = ()):
    """Run ``steps`` ticks of the dense full-membership model.  Per tick:
    for each tracked subject j the OTHER nodes viewing j SUSPECT / DEAD,
    the global count of suspect cells, and the sum of membership-list
    sizes.  Returns (final_state, (suspecting, dead_known, suspect_cells,
    known_members))."""
    dev = key.device
    consts = membership_constants(cfg, dev)
    track_idx = torch.tensor(track, dtype=torch.int64).to(dev)
    outs = track_outputs(steps, len(track), torch.int32, dev)
    for t in range(steps):
        state = membership_round(state, fold_in(key, t), cfg, consts)
        for o, v in zip(outs, membership_counts(state.key, track_idx)):
            o[t] = v
    return state, outs


def sparse_membership_scan(state, key: torch.Tensor, cfg, steps: int,
                           track: tuple = ()):
    """The sparse twin of :func:`membership_scan`: counts match slots by
    subject id, so they do not depend on the row order.  ``known_members``
    is the float32 gauge ``f32(n) * n - dead_cells`` (n**2 overflows int32
    at the scales this model exists for; exact while the dead-cell count
    stays below 2**24)."""
    dev = key.device
    consts = sparse_constants(cfg, dev)
    track_idx = torch.tensor(track, dtype=torch.int32).to(dev)
    n_sq = n_squared(cfg.base.n, dev)
    outs = track_outputs(steps, len(track), torch.float32, dev)
    for t in range(steps):
        state = sparse_membership_round(state, fold_in(key, t), cfg, consts)
        for o, v in zip(outs, sparse_membership_counts(state, track_idx,
                                                       n_sq)):
            o[t] = v
    return state, outs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(make_state, scan_fn, key, device, warmup: bool):
    """Run a scan, returning (final state, host outputs, wall seconds).

    The fence is ``torch.cuda.synchronize()`` plus the device-to-host copy
    of the per-tick counters.  With ``warmup`` the study runs once outside
    the timed region, so the wall time is steady-state."""
    def host(out):
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
                f"{name}= is not ported yet (the multi-card placement and "
                "telemetry come in later slices)"
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


def run_broadcast(
    cfg: BroadcastConfig,
    steps: int,
    seed: int = 0,
    origin: int = 0,
    mesh=None,
    warmup: bool = True,
    exchange: str = "alltoall",
    device=None,
) -> BroadcastReport:
    """One broadcast study.  ``mesh=`` selects the sharded plane
    (``parallel/shard.py``: D logical shards, outbox message routing,
    D == 1 bit-equal to the unsharded scan) and fills
    ``report.overflow``; ``exchange`` picks its outbox transport
    (``"alltoall"`` | ``"ring"``).  Runs on CUDA unless ``device`` (or the
    mesh's device) says otherwise."""
    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    key = PRNGKey(seed, device=dev)

    def make_state():
        return broadcast_init(cfg, origin=origin, device=dev)

    if mesh is not None:
        def scan(st, k):
            return sharded_broadcast_scan(st, k, cfg, steps, mesh, exchange)
    else:
        def scan(st, k):
            final, infected = broadcast_scan(st, k, cfg, steps)
            return final, (infected,)

    _, out, wall = _timed(make_state, scan, key, dev, warmup)
    return BroadcastReport(
        n=cfg.n,
        ticks=steps,
        tick_ms=cfg.profile.gossip_interval_ms,
        infected=out[0],
        wall_s=wall,
        overflow=int(out[1]) if mesh is not None else None,
        device=_device_name(dev),
    )


def run_swim(
    cfg: SwimConfig,
    steps: int,
    seed: int = 0,
    warmup: bool = True,
    device=None,
) -> SwimReport:
    """One failure-detection study.  Runs on CUDA unless ``device`` says
    otherwise; with ``warmup`` the study runs once untimed first."""
    dev = resolve_device(device)
    _, (sus, dead), wall = _timed(
        lambda: swim_init(cfg, device=dev),
        lambda st, k: swim_scan(st, k, cfg, steps),
        PRNGKey(seed, device=dev), dev, warmup,
    )
    return SwimReport(
        n=cfg.n,
        ticks=steps,
        tick_ms=cfg.profile.gossip_interval_ms,
        probe_interval_ms=cfg.profile.probe_interval_ms,
        suspecting=sus,
        dead_known=dead,
        wall_s=wall,
        device=_device_name(dev),
    )


def run_lifeguard(
    cfg,
    steps: int,
    seed: int = 0,
    warmup: bool = True,
    device=None,
) -> FalsePositiveReport:
    """Fault-injected Lifeguard study (``cfg``: a LifeguardConfig): the
    accuracy (false-positive) workload, with :func:`run_swim`'s device and
    timing contract."""
    from consul_tpu_torch.models.lifeguard import lifeguard_init

    dev = resolve_device(device)
    _, (sus, dead, fp, refutes, aware), wall = _timed(
        lambda: lifeguard_init(cfg, device=dev),
        lambda st, k: lifeguard_scan(st, k, cfg, steps),
        PRNGKey(seed, device=dev), dev, warmup,
    )
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
    )


def _membership_report(cfg: MembershipConfig, track, outs, wall,
                       dev) -> MembershipReport:
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
    ``report.overflow``; ``exchange`` picks its outbox transport.  Runs
    on CUDA unless ``device`` (or the mesh's device) says otherwise;
    ``sharded`` (the reference's multi-card placement) and ``telemetry``
    wait for later slices and are rejected."""
    _check_later_slice(sharded=(sharded, False),
                       telemetry=(telemetry, False))
    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    track = tuple(track)
    if mesh is not None:
        def scan(st, k):
            return sharded_membership_scan(st, k, cfg, steps, mesh, track,
                                           exchange)
    else:
        def scan(st, k):
            return membership_scan(st, k, cfg, steps, track)

    _, outs, wall = _timed(lambda: membership_init(cfg, device=dev), scan,
                           PRNGKey(seed, device=dev), dev, warmup)
    report = _membership_report(cfg, track, outs[:4], wall, dev)
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
    also counts outbox misses); ``exchange`` picks the outbox transport.
    Runs on CUDA unless ``device`` (or the mesh's device) says otherwise;
    ``telemetry`` waits for a later slice and is rejected."""
    _check_later_slice(telemetry=(telemetry, False))
    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    track = tuple(track)
    if mesh is not None:
        def scan(st, k):
            return sharded_sparse_membership_scan(st, k, cfg, steps, mesh,
                                                  track, exchange)
    else:
        def scan(st, k):
            return sparse_membership_scan(st, k, cfg, steps, track)

    final, outs, wall = _timed(
        lambda: sparse_membership_init(cfg, device=dev), scan,
        PRNGKey(seed, device=dev), dev, warmup)
    report = _membership_report(cfg.base, track, outs, wall, dev)
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
    multi-card work and are rejected."""
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
    its transport.  Runs on CUDA unless ``device`` (or the mesh's device)
    says otherwise; ``telemetry`` waits for a later slice and is
    rejected."""
    from consul_tpu_torch.geo.model import geo_init
    from consul_tpu_torch.geo.report import GeoReport

    _check_later_slice(telemetry=(telemetry, False))
    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    if mesh is not None:
        def scan(st, k):
            return sharded_geo_scan(st, k, cfg, steps, mesh, exchange)
    else:
        def scan(st, k):
            return geo_scan(st, k, cfg, steps)

    _, outs, wall = _timed(lambda: geo_init(cfg, device=dev), scan,
                           PRNGKey(seed, device=dev), dev, warmup)
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
    transport.  Runs on CUDA unless ``device`` (or the mesh's device)
    says otherwise; ``telemetry`` waits for a later slice and is
    rejected."""
    import dataclasses

    from consul_tpu_torch.streamcast.model import streamcast_init
    from consul_tpu_torch.streamcast.report import StreamcastReport

    if policy is not None and policy != cfg.policy:
        cfg = dataclasses.replace(cfg, policy=policy)
    _check_later_slice(telemetry=(telemetry, False))
    _check_exchange(exchange, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    if mesh is not None:
        def scan(st, k):
            return sharded_streamcast_scan(st, k, cfg, steps, mesh, exchange)
    else:
        def scan(st, k):
            return streamcast_scan(st, k, cfg, steps)

    _, outs, wall = _timed(lambda: streamcast_init(cfg, device=dev), scan,
                           PRNGKey(seed, device=dev), dev, warmup)
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
    )
