"""Where a broadcast study's device time goes, by kernel, on one GPU.

    python -m consul_tpu_torch.sim.breakdown

Runs the slice's studies (1M-node Serf broadcast, LAN, fanout 4, seed 0:
edges unsharded, edges over 8 logical shards with each outbox transport,
and the aggregate study) once to warm up, then once under
``torch.profiler``.  For each it prints one JSON line: the wall time, the
device's busy share (the sum of kernel times over the wall time), the
number of kernel launches, and the device time per kernel family, the
families being what the port's layers launch (threefry arithmetic,
sorting, scatters, the ring kernel, reductions, the rest).  Needs a CUDA
device; the first line names it with its power limit.
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

# Kernel-name fragments -> the layer that launches them.  The threefry
# draws are elementwise int64 arithmetic; everything elementwise that is
# not theirs is counted with them, which the per-kernel list shows.
FAMILIES = (
    ("ring_exchange", "ring kernel (parallel/shard exchange)"),
    ("sort", "sort (parallel/shard pack_outbox)"),
    ("radix", "sort (parallel/shard pack_outbox)"),
    ("scatter", "scatter (ops/scatter, pack_outbox)"),
    ("index", "scatter (ops/scatter, pack_outbox)"),
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


def profile_study(run, label: str) -> dict:
    run()  # warm up: allocator, kernel build, cuBLAS/cub workspaces
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernel_times(prof)
    busy_us = sum(us for _, us in kernels.values())
    fams = collections.defaultdict(float)
    for name, (_, us) in kernels.items():
        fams[_family(name)] += us / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "study": label,
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": (busy_us / 1e6) / wall if wall > 0 else None,
        "launches": sum(c for c, _ in kernels.values()),
        "by_family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"kernel": name[:90], "launches": c, "ms": us / 1e3}
            for name, (c, us) in top
        ],
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("breakdown needs a CUDA device")

    from consul_tpu_torch import BroadcastConfig, mesh_for, run_broadcast
    from consul_tpu_torch.protocol import LAN

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__}))
    edges = BroadcastConfig(n=N_NODES, fanout=4, profile=LAN)
    agg = BroadcastConfig(n=N_NODES, fanout=4, profile=LAN,
                          delivery="aggregate")

    def study(cfg, steps, **kw):
        return lambda: run_broadcast(cfg, steps, warmup=False, **kw)

    studies = (
        ("edges_unsharded", study(edges, EDGE_STEPS)),
        ("edges_d8_ring", study(edges, EDGE_STEPS, mesh=mesh_for(8),
                                exchange="ring")),
        ("edges_d8_alltoall", study(edges, EDGE_STEPS, mesh=mesh_for(8))),
        ("aggregate_unsharded", study(agg, AGG_STEPS)),
    )
    for label, run in studies:
        print(json.dumps(profile_study(run, label)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
