"""The study engine: tick loops over the round functions, timed on the device.

The port of the broadcast, SWIM and Lifeguard paths of
``consul_tpu/sim/engine.py``.  Round
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
from consul_tpu_torch.models.swim import (
    VIEW_DEAD,
    VIEW_SUSPECT,
    SwimConfig,
    swim_constants,
    swim_init,
    swim_round,
)
from consul_tpu_torch.ops import PRNGKey, fold_in
from consul_tpu_torch.parallel.shard import sharded_broadcast_scan
from consul_tpu_torch.sim.metrics import (
    BroadcastReport,
    FalsePositiveReport,
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
