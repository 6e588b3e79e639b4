"""Where a study's device time goes, by kernel, on one GPU.

    python -m consul_tpu_torch.sim.breakdown

Runs the port's studies, seed 0: the Serf broadcast at 1M nodes (LAN,
fanout 4: edges unsharded, edges over 8 logical shards with each outbox
transport, and the aggregate study), the SWIM headline at 1M (WAN, 30%
loss, subject 42: aggregate and edges), the degraded1m Lifeguard study at
1M (Lifeguard on), and the membership studies (LAN, loss 0.01, subject 42
crashing at tick 5): the top-K sparse model (K=64) at 100k nodes in the
steady state (8 ticks from the converged state) and at 1M nodes cold (its
first 10 ticks), and the dense model at 16384 nodes (10 ticks); then the
geo slice: ``multidc1m`` (1M nodes, 8 segments x 5 bridges, aggregate,
120 ticks), bench.py's geo A/B at 1M (the adaptive arm, 160 ticks, over
the Vivaldi-derived latencies) and the same over 8 logical shards with the
ring transport; then the sharded membership twins over 8 logical shards
with the ring transport beside the unsharded runs: the sparse model at
100k nodes cold (its first 30 ticks, unsharded and sharded), at 1M cold
(10 ticks) and the dense model at 16384 nodes (10 ticks); then the
streamcast slice: the reference's 1M sustained-load study (4-chunk
events, 8 slots, aggregate, 100 ticks) with the uniform and the pipeline
policy, and ``stream100k``'s edges configuration at 1M nodes over 8
logical shards with the ring transport (60 ticks).

Each study runs once to warm up, once timed over all its ticks without
the profiler (rounds/s), and over a shorter window twice: once timed
without the profiler and once under ``torch.profiler``.  For each it
prints one JSON line: rounds/s, the window's unprofiled and profiled wall
times, the device's busy time in the window (the sum of kernel times) and
its share of the unprofiled window, the kernel launches in all and per
tick, and the device time per kernel family, the families being what the
port's layers launch (threefry arithmetic, sorting, scatters and gathers,
the ring kernel, reductions, the rest).  Kernels launched inside the
sort-merge delivery (``ops/sortmerge.py``, marked with
``record_function``) are also summed by family on their own.  Needs a
CUDA device; the first line names it with its power limit.
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
SPARSE_STEADY_STEPS = 8
MEMBERSHIP_WINDOW = 10
DENSE_N = 16384
MULTIDC_STEPS = 120
GEO_STEPS = 160
SPARSE_COLD_STEPS = 30   # bench.py's cold run at 100k
STREAM_STEPS = 100       # the reference's 1M sustained-load study
STREAM_SHARD_STEPS = 60

# Kernel-name fragments -> the layer that launches them.  The threefry
# draws are elementwise int64 arithmetic; everything elementwise that is
# not theirs is counted with them, which the per-kernel list shows.
FAMILIES = (
    ("ring_exchange", "ring kernel (parallel/shard exchange)"),
    ("sort", "sort (pack_outbox, sort-merge lex-sort, top-k)"),
    ("radix", "sort (pack_outbox, sort-merge lex-sort, top-k)"),
    ("topk", "sort (pack_outbox, sort-merge lex-sort, top-k)"),
    ("scatter", "scatter (ops/scatter, pack_outbox, sort-merge)"),
    ("index", "gather/index (index, gather, tables)"),
    ("gather", "gather/index (index, gather, tables)"),
    ("reduce", "reductions (counts, cumsum)"),
    ("scan", "reductions (counts, cumsum)"),
    ("elementwise", "elementwise (threefry, masks, round update)"),
    ("vectorized", "elementwise (threefry, masks, round update)"),
    ("copy", "copies and layout moves"),
    ("transpose", "copies and layout moves"),
    ("cat", "copies and layout moves"),
)
SORTMERGE_RANGE = "sortmerge"


def _family(name: str) -> str:
    low = name.lower()
    for frag, fam in FAMILIES:
        if frag in low:
            return fam
    return "other"


def _kernel_times(prof) -> dict[str, tuple[int, float]]:
    """Kernel name -> (launches, device microseconds) from a profile.  The
    device-side spans of ``record_function`` ranges are not kernels and
    are left out."""
    out = {}
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key.startswith(SORTMERGE_RANGE)):
            continue
        out[evt.key] = (evt.count, evt.self_device_time_total)
    return out


def _in_range(evt, prefix: str) -> bool:
    while evt is not None:
        if evt.name.startswith(prefix):
            return True
        evt = evt.cpu_parent
    return False


def _range_families(prof, prefix: str) -> dict[str, float]:
    """Device ms by family of the kernels launched inside ``record_function``
    ranges named ``prefix...``."""
    fams = collections.defaultdict(float)
    for evt in prof.events():
        kernels = getattr(evt, "kernels", ())
        if kernels and _in_range(evt, prefix):
            for k in kernels:
                fams[_family(k.name)] += k.duration / 1e3
    return dict(sorted(fams.items(), key=lambda kv: -kv[1]))


def profile_study(run, label: str, ticks: int, window: int) -> dict:
    """``run(steps)`` runs the study for ``steps`` ticks and returns once
    the device is done."""
    run(window)  # warm up: allocator, kernel build, library workspaces
    t0 = time.perf_counter()
    run(ticks)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(window)
    wall_window = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(window)
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
        "rounds_per_sec": ticks / wall if wall > 0 else None,
        "window_ticks": window,
        "wall_window_ms": wall_window * 1e3,
        "wall_profiled_ms": wall_profiled * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": (busy_us / 1e6) / wall_window if wall_window else None,
        "launches": launches,
        "launches_per_tick": launches / window,
        "device_ms_per_tick": busy_us / 1e3 / window,
        "by_family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "sortmerge_by_family_ms": _range_families(prof, SORTMERGE_RANGE),
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
        MembershipConfig,
        MultiDCConfig,
        SparseMembershipConfig,
        StreamcastConfig,
        SwimConfig,
        mesh_for,
        run_broadcast,
        run_lifeguard,
        run_membership,
        run_geo,
        run_membership_sparse,
        run_multidc,
        run_streamcast,
        run_swim,
    )
    from consul_tpu_torch.geo import derive_wan_latency
    from consul_tpu_torch.models.membership_sparse import converged_state
    from consul_tpu_torch.ops import PRNGKey
    from consul_tpu_torch.protocol import LAN, WAN
    from consul_tpu_torch.sim import sparse_membership_scan
    from consul_tpu_torch.sim.scenarios import (
        degraded1m_environment,
        geo_ab_config,
        stream100k_config,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__}))
    dev = torch.device("cuda", 0)
    edges = BroadcastConfig(n=N_NODES, fanout=4, profile=LAN)
    agg = BroadcastConfig(n=N_NODES, fanout=4, profile=LAN,
                          delivery="aggregate")
    swim = {d: SwimConfig(n=N_NODES, subject=42, loss=0.30, profile=WAN,
                          delivery=d) for d in ("aggregate", "edges")}
    faults, loss, ack_late = degraded1m_environment()
    lifeguard = LifeguardConfig(n=N_NODES, subject=7, subject_alive=True,
                                loss=loss, ack_late=ack_late, profile=WAN,
                                delivery="aggregate", faults=faults)
    base = dict(loss=0.01, profile=LAN, fail_at=((42, 5),))
    sparse = {n: SparseMembershipConfig(MembershipConfig(n=n, **base),
                                        k_slots=64)
              for n in (100_000, N_NODES)}
    dense = MembershipConfig(n=DENSE_N, **base)
    multidc = MultiDCConfig(n=N_NODES, segments=8, bridges_per_segment=5,
                            delivery="aggregate")
    stream = {p: StreamcastConfig(
        n=N_NODES, events=64, chunks=4, window=8, fanout=4, chunk_budget=2,
        rate=0.1, names=16, loss=0.05, done_frac=0.999,
        delivery="aggregate", policy=p) for p in ("uniform", "pipeline")}

    latency, _ = derive_wan_latency(8, 5, tick_ms=LAN.gossip_interval_ms,
                                    seed=0, rounds=400, wan_window=8,
                                    device=dev)
    geo = geo_ab_config(latency, n=N_NODES)

    ring8 = {"mesh": mesh_for(8), "exchange": "ring"}

    def study(entry, cfg, **kw):
        def run(steps):
            entry(cfg, steps, warmup=False, **kw)
        return run

    # The steady state: bench.py's converged state after 8 warm-up ticks.
    warm, _ = sparse_membership_scan(
        converged_state(sparse[100_000], 42, device=dev),
        PRNGKey(1, device=dev), sparse[100_000], SPARSE_STEADY_STEPS, (42,))

    def steady(steps):
        _, outs = sparse_membership_scan(warm, PRNGKey(2, device=dev),
                                         sparse[100_000], steps, (42,))
        outs[1].cpu()

    studies = (
        ("edges_unsharded", study(run_broadcast, edges), EDGE_STEPS, 10),
        ("edges_d8_ring", study(run_broadcast, edges, mesh=mesh_for(8),
                                exchange="ring"), EDGE_STEPS, 10),
        ("edges_d8_alltoall", study(run_broadcast, edges, mesh=mesh_for(8)),
         EDGE_STEPS, 10),
        ("aggregate_unsharded", study(run_broadcast, agg), AGG_STEPS, 20),
        ("swim_aggregate_1m", study(run_swim, swim["aggregate"]),
         SWIM_AGG_STEPS, 60),
        ("swim_edges_1m", study(run_swim, swim["edges"]), SWIM_EDGE_STEPS,
         20),
        ("lifeguard_degraded_1m", study(run_lifeguard, lifeguard),
         LIFEGUARD_STEPS, 30),
        ("membership_sparse_100k_steady", steady, SPARSE_STEADY_STEPS,
         SPARSE_STEADY_STEPS),
        ("membership_sparse_1m_cold",
         study(run_membership_sparse, sparse[N_NODES], track=(42,)),
         MEMBERSHIP_WINDOW, MEMBERSHIP_WINDOW),
        ("membership_dense_16k", study(run_membership, dense, track=(42,)),
         MEMBERSHIP_WINDOW, MEMBERSHIP_WINDOW),
        ("multidc1m", study(run_multidc, multidc,
                            origin=multidc.seg_size // 2),
         MULTIDC_STEPS, 20),
        ("geo_1m_adaptive", study(run_geo, geo), GEO_STEPS, 10),
        ("geo_1m_adaptive_d8_ring", study(run_geo, geo, mesh=mesh_for(8),
                                          exchange="ring"), GEO_STEPS, 10),
        ("membership_sparse_100k_cold",
         study(run_membership_sparse, sparse[100_000], track=(42,)),
         SPARSE_COLD_STEPS, MEMBERSHIP_WINDOW),
        ("membership_sparse_100k_cold_d8_ring",
         study(run_membership_sparse, sparse[100_000], track=(42,),
               **ring8), SPARSE_COLD_STEPS, MEMBERSHIP_WINDOW),
        ("membership_sparse_1m_cold_d8_ring",
         study(run_membership_sparse, sparse[N_NODES], track=(42,),
               **ring8), MEMBERSHIP_WINDOW, MEMBERSHIP_WINDOW),
        ("membership_dense_16k_d8_ring",
         study(run_membership, dense, track=(42,), **ring8),
         MEMBERSHIP_WINDOW, MEMBERSHIP_WINDOW),
        ("stream_1m_aggregate_uniform",
         study(run_streamcast, stream["uniform"]), STREAM_STEPS,
         MEMBERSHIP_WINDOW),
        ("stream_1m_aggregate_pipeline",
         study(run_streamcast, stream["pipeline"]), STREAM_STEPS,
         MEMBERSHIP_WINDOW),
        ("stream_1m_d8_ring",
         study(run_streamcast, stream100k_config(N_NODES, STREAM_SHARD_STEPS,
                                                 devices=8), **ring8),
         STREAM_SHARD_STEPS, MEMBERSHIP_WINDOW),
    )
    for label, run, ticks, window in studies:
        print(json.dumps(profile_study(run, label, ticks, window)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
