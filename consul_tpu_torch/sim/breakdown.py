"""Where a study's device time goes, by kernel, on one GPU.

    python -m consul_tpu_torch.sim.breakdown

Runs the port's studies at 1M nodes, seed 0: the Serf broadcast (LAN,
fanout 4: edges unsharded, edges over 8 logical shards with each outbox
transport, and the aggregate study), the SWIM headline (WAN, 30% loss,
subject 42: aggregate for 450 ticks, edges for 100) and the degraded1m
Lifeguard study (160 ticks, Lifeguard on).  Each study runs once to warm
up, once timed without the profiler, and once under ``torch.profiler``.
For each it prints one JSON line: the unprofiled and profiled wall
times, the device's busy time (the sum of kernel times) and its share of
the unprofiled wall, the kernel launches in all and per tick, and the
device time per kernel family, the families being what the port's
layers launch (threefry arithmetic, sorting, scatters and gathers, the
ring kernel, reductions, the rest).  Needs a CUDA device; the first line
names it with its power limit.
"""

from __future__ import annotations

import collections
import json
import subprocess
import time

import torch

N_NODES = 1_000_000
EDGE_STEPS = 30
AGG_STEPS = 60
SWIM_AGG_STEPS = 450
SWIM_EDGE_STEPS = 100
LIFEGUARD_STEPS = 160

# Kernel-name fragments -> the layer that launches them.  The threefry
# draws are elementwise int64 arithmetic; everything elementwise that is
# not theirs is counted with them, which the per-kernel list shows.
FAMILIES = (
    ("ring_exchange", "ring kernel (parallel/shard exchange)"),
    ("sort", "sort (parallel/shard pack_outbox)"),
    ("radix", "sort (parallel/shard pack_outbox)"),
    ("scatter", "scatter (ops/scatter, pack_outbox)"),
    ("index", "gather/index (index_put, participates[targets], tables)"),
    ("reduce", "reductions (counts, cumsum)"),
    ("scan", "reductions (counts, cumsum)"),
    ("elementwise", "elementwise (threefry, masks, round update)"),
    ("vectorized", "elementwise (threefry, masks, round update)"),
    ("copy", "copies and layout moves"),
    ("transpose", "copies and layout moves"),
)


def _family(name: str) -> str:
    low = name.lower()
    for frag, fam in FAMILIES:
        if frag in low:
            return fam
    return "other"


def _kernel_times(prof) -> dict[str, tuple[int, float]]:
    """Kernel name -> (launches, device microseconds) from a profile."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out[evt.key] = (evt.count, evt.self_device_time_total)
    return out


def profile_study(run, label: str, ticks: int) -> dict:
    run()  # warm up: allocator, kernel build, cuBLAS/cub workspaces
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    kernels = _kernel_times(prof)
    busy_us = sum(us for _, us in kernels.values())
    launches = sum(c for c, _ in kernels.values())
    fams = collections.defaultdict(float)
    for name, (_, us) in kernels.items():
        fams[_family(name)] += us / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "study": label,
        "ticks": ticks,
        "wall_ms": wall * 1e3,
        "rounds_per_sec": ticks / wall if wall > 0 else None,
        "wall_profiled_ms": wall_profiled * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": (busy_us / 1e6) / wall if wall > 0 else None,
        "launches": launches,
        "launches_per_tick": launches / ticks,
        "by_family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"kernel": name[:90], "launches": c, "ms": us / 1e3}
            for name, (c, us) in top
        ],
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("breakdown needs a CUDA device")

    from consul_tpu_torch import (
        BroadcastConfig,
        LifeguardConfig,
        SwimConfig,
        mesh_for,
        run_broadcast,
        run_lifeguard,
        run_swim,
    )
    from consul_tpu_torch.protocol import LAN, WAN
    from consul_tpu_torch.sim.scenarios import degraded1m_environment

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__}))
    edges = BroadcastConfig(n=N_NODES, fanout=4, profile=LAN)
    agg = BroadcastConfig(n=N_NODES, fanout=4, profile=LAN,
                          delivery="aggregate")
    swim = {d: SwimConfig(n=N_NODES, subject=42, loss=0.30, profile=WAN,
                          delivery=d) for d in ("aggregate", "edges")}
    faults, loss, ack_late = degraded1m_environment()
    lifeguard = LifeguardConfig(n=N_NODES, subject=7, subject_alive=True,
                                loss=loss, ack_late=ack_late, profile=WAN,
                                delivery="aggregate", faults=faults)

    def study(entry, cfg, steps, **kw):
        return lambda: entry(cfg, steps, warmup=False, **kw)

    studies = (
        ("edges_unsharded", study(run_broadcast, edges, EDGE_STEPS),
         EDGE_STEPS),
        ("edges_d8_ring", study(run_broadcast, edges, EDGE_STEPS,
                                mesh=mesh_for(8), exchange="ring"),
         EDGE_STEPS),
        ("edges_d8_alltoall", study(run_broadcast, edges, EDGE_STEPS,
                                    mesh=mesh_for(8)), EDGE_STEPS),
        ("aggregate_unsharded", study(run_broadcast, agg, AGG_STEPS),
         AGG_STEPS),
        ("swim_aggregate_1m", study(run_swim, swim["aggregate"],
                                    SWIM_AGG_STEPS), SWIM_AGG_STEPS),
        ("swim_edges_1m", study(run_swim, swim["edges"], SWIM_EDGE_STEPS),
         SWIM_EDGE_STEPS),
        ("lifeguard_degraded_1m", study(run_lifeguard, lifeguard,
                                        LIFEGUARD_STEPS), LIFEGUARD_STEPS),
    )
    for label, run, ticks in studies:
        print(json.dumps(profile_study(run, label, ticks)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
