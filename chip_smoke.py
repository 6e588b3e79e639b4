#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``consul_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository.  Phases, each fatal on failure:

  1. the card: print the card's name and power limit, build every
     CUDA kernel of the port from ``consul_tpu_torch/csrc``;
  2. kernels against their plain versions, bit for bit, at small shapes
     and at the broadcast's outbox shape (the ring kernel's box entry
     point; phase 8 times it at every path's shape);
  3. the threefry draws on CUDA against the same draws on the CPU, and
     against golden values computed with jax 0.9.0
     (``jax_threefry_partitionable=True``);
  4. the broadcast slice: the 1M-node Serf event broadcast (LAN, fanout
     4, edges, 30 ticks, seed 0) unsharded and over 8 logical shards with
     both outbox transports, bit-equal per tick with no overflow, the ring
     kernel launched once per tick; the 1M-node aggregate study
     (60 ticks); and a small study held against the port on the CPU;
  5. the SWIM slice: the bench headline, a 1M-node SWIM crash study (WAN,
     30% loss, subject 42, seed 0) with aggregate delivery for 450 ticks
     and with edges delivery for 100, each checked for first suspicion
     within 10 probe intervals, no DEAD view before the suspicion minimum
     has passed since the first suspicion, a ``dead_known`` that never
     falls, and ``suspecting + dead_known <= n - 1``; the degraded1m
     Lifeguard A/B at 1M nodes for 160 ticks, Lifeguard on and off; and
     CUDA held against the CPU at n=4096 (SWIM edges and Lifeguard edges
     with every fault primitive field for field on every tick, SWIM
     aggregate by the arrival-threshold rule);
  6. the membership slice: the top-K sparse model (K=64, LAN, loss 0.01,
     subject 42 crashing at tick 5, seed 0) at 100k nodes, a cold
     detection study of 200 ticks checked for first suspicion, the
     suspicion minimum, monotone ``dead_known`` and 99% DEAD, then the
     benchmark's steady-state measure (the converged state, 8 ticks with
     PRNGKey(1) to warm up, 8 timed with PRNGKey(2)); the same at 1M
     nodes with a cold study of 60 ticks and the sorted-row invariant at
     the end; the dense model at 16384 nodes for 30 ticks and the probe1k
     preset (all ten crashes detected); and every membership round on
     CUDA held against the CPU, every field with its dtype on every tick
     (sparse at K < n with amortize on and off, sparse at K == n, dense,
     and the chunked and row-blocked branches forced on a small study).
     The ring kernel launches 0 times on this path.
  7. the geo slice: the ring kernel at the geo outbox shape
     ``[8, 8, 2, 64]`` against its plain version, bit for bit;
     ``derive_wan_latency`` on the card for (8 DCs x 5 bridges, 400
     rounds) and (8 x 3, 300 rounds), equal to golden matrices computed
     with jax 0.9.0 and to the port's CPU result; ``multidc1m`` (BASELINE
     config 5: 1M nodes, 8 segments x 5 bridges, aggregate, 120 ticks:
     ``infected`` never falls, all 8 segments reach 99%, the curves equal
     the JAX package's); bench.py's geo A/B at 1M (8 DCs x 5 bridges, 16
     events, brownout to 10% over ticks [5, 120), 160 ticks, adaptive and
     fixed arms: the link accounting identity in both); the adaptive arm
     over 8 logical shards with both outbox transports, equal to the
     unsharded run on every tick with no outbox overflow and one ring
     launch a tick; and CUDA held against the CPU on every tick, every
     field with its dtype (multi-DC edges and aggregate and geo at
     n=4096 under a brownout and a loss ramp, both arms; 50 Vivaldi
     rounds).
  8. the sharded membership slice: the rebuilt ring kernel at every ring
     path's outbox (broadcast ``[8, 8, 1, 125000]``, geo ``[8, 8, 2,
     64]``, dense 16k ``[8, 8, 4, 12288]``, sparse 100k ``[8, 8, 5,
     40062]``, sparse 1M ``[8, 8, 5, 400812]``), fed the packed planes at
     buffer offsets 0 and 1, bit for bit against its plain version, and
     timed: the whole ``exchange_outbox`` on the ring and on the alltoall
     path, the kernel alone, the plain version, ``transpose(0,
     1).contiguous()`` of the stacked box and the byte bound; the
     studies over 8 logical shards with both transports: sparse 100k cold
     (200 ticks), sparse 1M cold (60), dense 16k (30), each with ring ==
     alltoall on every tick and in the final state, one ring launch a
     tick, at most 2 host syncs a sparse tick (0 dense), the detection
     invariants, the peak memory, and the unsharded run's outputs where
     both overflows are 0; and both twins' ticks on CUDA held against the
     CPU (sparse K=16 at n=4096, dense at n=512), every field and output
     with its dtype on every tick, both transports.
  9. the streamcast slice: the ring kernel at its three new outboxes
     (``stream100k`` over 8 shards ``[8, 8, 3, 100000]`` and at 1M
     ``[8, 8, 3, 1000000]``, ``event100k`` over 8 shards ``[8, 8, 1,
     12500]``), bit for bit and timed as in phase 8; ``stream100k``'s
     edges configuration over 8 shards at 100k (150 ticks) and 1M (60)
     with both transports, equal to each other and to the unsharded run
     on every tick with no outbox overflow, one ring launch a tick
     (counted, and seen by ``torch.profiler``), and the window's
     accounting identity; ``event100k`` over 8 shards with both
     transports (equal, overflow 0), ``dev3``, ``probe1k`` over 8 shards
     with the ring (all ten crashes detected); ``stream100k`` (aggregate,
     150 ticks) for each policy with the accounting identity and events
     delivered; the reference's own 1M study (``tests/test_streamcast.py``:
     4-chunk events, 8 slots, rate 0.1, aggregate, 100 ticks) for the
     uniform and pipeline policies; bench.py's sustained-load curve at 1M
     (the paced stream, W=7, budget 4, rates 0.1 / 0.3 / 0.6 / 1.2, 150
     ticks) for each policy, with its knee printed; and CUDA held against
     the CPU at n=4096 on every tick (streamcast edges and aggregate for
     each policy, the paced stream with a backlog, a hotspot and heavy
     tails, a loss ramp, the sharded twin at D=8 with both transports,
     and ``broadcast_round(alive=)`` at both deliveries).

The next-to-last line of output is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
where CUDA is not available or the port is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM data sheet: HBM3 bandwidth.
PEAK_BYTES_PER_S = 3.35e12

# owned_uniform (float32 bits) and owned_randint(0, 999_999) with draw
# shape (3,), computed with jax 0.9.0 for the site keys
# split(fold_in(PRNGKey(0), tick))[site] and GOLDEN_IDS.
GOLDEN_IDS = (0, 1, 2, 999_999, 2 ** 31 - 1)
GOLDEN = (
    (0, 0, [[0x3d92ef70, 0x3eb99c58, 0x3edf2d1c], [0x3da92c30, 0x3f47e1aa, 0x3f70331c], [0x3dd7df90, 0x3ea41328, 0x3de4bb50], [0x3e799378, 0x3f44fb22, 0x3ec91d94], [0x3f6fb038, 0x3ed471d4, 0x3e9b88e8]], [[784894, 875903, 249833], [902716, 59153, 692229], [408753, 823374, 885556], [191322, 166994, 537696], [910617, 961342, 200413]]),  # noqa: E501
    (0, 1, [[0x3c85cbc0, 0x3f567ac8, 0x3eb87bd0], [0x3f5b432c, 0x3ef8dbb4, 0x3f7728f0], [0x3f074508, 0x3d1b0260, 0x3f3500d6], [0x3e6ad528, 0x3f659aec, 0x3f4ca748], [0x3f33f702, 0x3f3a85a6, 0x3eeb622c]], [[274531, 36602, 33883], [669741, 710376, 480975], [787553, 656861, 315473], [651774, 118000, 507352], [322026, 781446, 693612]]),  # noqa: E501
    (29, 0, [[0x3ed19d38, 0x3f458dfe, 0x3de3d580], [0x3f5e63c8, 0x3f496068, 0x3d0403e0], [0x3f2740ce, 0x3e159db8, 0x3dd5f600], [0x3e6b26e8, 0x3f3b6f3a, 0x3f57d684], [0x3e9ce71c, 0x3ef89780, 0x3edb273c]], [[134257, 564630, 947417], [341124, 788904, 459383], [764098, 200311, 934798], [534175, 155634, 579227], [73161, 187819, 428914]]),  # noqa: E501
    (29, 1, [[0x3dd94f60, 0x3f0bbf56, 0x3f3a4e26], [0x3f1c9064, 0x3f4c45fa, 0x3c09fc80], [0x3ec0c700, 0x3ee1fe7c, 0x3f58a9ee], [0x3c70f280, 0x3f54e5ba, 0x3eebffac], [0x3f7cb7e0, 0x3d86f0e0, 0x3f12865e]], [[44709, 862819, 711368], [107266, 876412, 845649], [539277, 777457, 934980], [174027, 551166, 617454], [112516, 828164, 791914]]),  # noqa: E501
)

N_1M = 1_000_000
SHARDS = 8
EDGE_STEPS = 30
AGG_STEPS = 60
SWIM_AGG_STEPS = 450     # bench.py's STEPS for the headline
SWIM_EDGE_STEPS = 100    # bench.py's STEPS_EDGES
LIFEGUARD_STEPS = 160    # bench.py's cut of degraded1m's 300 ticks
SMALL_N = 4096
# The sparse cold study at 100k: LAN's suspicion minimum is 100 ticks
# there (4 * log10(1e5) * 1 s at 200 ms a tick) and its maximum 600.  The
# first suspicion is due within 10 probe intervals (50 ticks) of the crash
# at tick 5, suspicions confirmed twice expire after the minimum, and the
# DEAD news reaches the rest within a few dozen ticks: 5 + 50 + 100 + 45
# = 200 ticks.
SPARSE_N = 100_000
SPARSE_COLD_100K_STEPS = 200
SPARSE_COLD_1M_STEPS = 60  # holds the first suspicion, not the DEAD wave
STEADY_STEPS = 8           # bench.py's steps for the steady-state measure
DENSE_N = 16384            # the reference's dense@16k registry program
DENSE_STEPS = 30
MULTIDC_STEPS = 120        # multidc1m's depth
GEO_STEPS = 160            # bench.py's geo section
GEO_RING_SHAPE = (8, 8, 2, 64)
GEO_PARITY_STEPS = 60
VIVALDI_PARITY_ROUNDS = 50
STREAM_N = 100_000         # stream100k's preset size
STREAM_STEPS = 150         # stream100k's preset depth
STREAM_1M_SHARD_STEPS = 60
STREAM_REF_1M_STEPS = 100  # tests/test_streamcast.py:966-992
EVENT_STEPS = 100          # event100k's depth
# bench.py's sustained-load curve (_streaming_curve, _STREAM_WORK): the
# paced stream at n=1M, one run per offered load and policy.
CURVE_RATES = (0.1, 0.3, 0.6, 1.2)
CURVE_STEPS = 150
CURVE_WORK = dict(window=7, chunks=4, fanout=4, chunk_budget=4,
                  done_frac=0.99)
STREAM_PARITY_STEPS = 30

# derive_wan_latency(8, B, tick_ms=200, seed=0, rounds=R, wan_window=8)
# as computed with jax 0.9.0 on the CPU: (matrix, rel_rtt_error).
LATENCY_GOLDEN = {
    (5, 400): (((0, 4, 4, 5, 5, 2, 2, 5), (4, 0, 3, 1, 2, 4, 4, 3),
                (4, 3, 0, 5, 3, 4, 4, 4), (5, 1, 5, 0, 4, 5, 5, 4),
                (5, 2, 3, 4, 0, 4, 5, 1), (2, 4, 4, 5, 4, 0, 1, 3),
                (2, 4, 4, 5, 5, 1, 0, 4), (5, 3, 4, 4, 1, 3, 4, 0)),
               0.014131767675280571),
    (3, 300): (((0, 4, 4, 5, 5, 2, 2, 5), (4, 0, 3, 1, 2, 4, 4, 3),
                (4, 3, 0, 4, 3, 4, 4, 4), (5, 1, 4, 0, 3, 5, 5, 4),
                (5, 2, 3, 3, 0, 4, 5, 1), (2, 4, 4, 5, 4, 0, 1, 3),
                (2, 4, 4, 5, 5, 1, 0, 4), (5, 3, 4, 4, 1, 3, 4, 0)),
               0.014702200889587402),
}
# The JAX package's multidc1m and geo A/B at seed 0 on the CPU (simulated
# ms and units).  multidc1m is bit-equal in the port; a geo LAN arrival
# may differ where its uniform lies between the two packages' thresholds.
MULTIDC1M_REFERENCE = {
    "infected_final": 1_000_000, "t50_ms": 3800, "t99_ms": 4200,
    "segment_t99_ms": [2200, 4200, 4200, 4200, 3800, 4400, 4400, 4400],
}
GEO_AB_REFERENCE = {
    "adaptive": {"t50_ms": 20000, "t99_ms": 21200,
                 "segment_t99_ms": [2400, 21000, 21400, 21400, 20400, 16000,
                                    15600, 20200],
                 "wan_admitted_bytes": 56315000, "wan_overflow_units": 88149,
                 "wan_wasted_units": 37061},
    "fixed": {"t50_ms": 27000, "t99_ms": 27600,
              "segment_t99_ms": [2400, 27400, 27400, 27600, 27600, 27000,
                                 27000, 27600],
              "wan_admitted_bytes": 55192200, "wan_overflow_units": 67113,
              "wan_wasted_units": 36150},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def cuda_ms(fn, iters: int = 50, windows: int = 5, warm: int = 3) -> float:
    """Device time of ``fn()`` in ms: the median over ``windows`` CUDA-event
    windows of the mean over ``iters`` back-to-back calls.  Host time
    between calls counts where the device waits for it."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def device_ms(fn, iters: int = 20) -> float:
    """Device time of the work one ``fn()`` enqueues, in ms: the median over
    ``iters`` launches of CUDA events recorded just before and after it,
    each behind a spin kernel (``torch.cuda._sleep``) that keeps the device
    busy until the host has enqueued the events and ``fn``'s work, so no
    host time falls between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def phase_card() -> str:
    from consul_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    for name in _build.KERNELS:
        _build.build(name)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, out in _build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return card


def phase_ring_kernel(dev) -> int:
    """The box entry point of the ring kernel against its plain version at
    small shapes and the broadcast outbox's; returns the largest error.
    Phase 8 times the kernel at every path's shape."""
    import torch

    from consul_tpu_torch.ops import ring_exchange, ring_exchange_plain
    from consul_tpu_torch.parallel import outbox_budget

    gen = torch.Generator(device=dev).manual_seed(0)

    def box_of(shape, offset=0):
        flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (int(np.prod(shape)) + offset,),
                             generator=gen, dtype=torch.int32, device=dev)
        return flat[offset:].view(shape)

    blk = N_1M // SHARDS
    main_shape = (SHARDS, SHARDS, 1, outbox_budget(blk * 4, SHARDS))
    shapes = [(d, d, c, b) for d in (1, 2, 3, 8) for c in (1, 4, 5)
              for b in (7, 64)] + [main_shape]
    max_err = 0
    for shape in shapes:
        for offset in (0, 1):  # offset 1: rows off 16-byte alignment
            box = box_of(shape, offset)
            got = ring_exchange(box)
            want = ring_exchange_plain(box)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max()) if got.numel() else 0
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"ring kernel != plain at {shape} offset {offset}")
    log(f"ring kernel == plain at {len(shapes)} shapes x 2 alignments")
    return max_err


def phase_threefry(dev) -> None:
    import torch

    from consul_tpu_torch.ops import (
        PRNGKey,
        fold_in,
        owned_randint,
        owned_uniform,
        sample_peers_owned,
        split,
    )

    ids = torch.cat((
        torch.tensor(GOLDEN_IDS, dtype=torch.int32),
        torch.randint(0, 2 ** 31 - 1, (200_000,), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(1)),
    ))
    for t, site, u_bits, r_vals in GOLDEN:
        for where in ("cpu", dev):
            key = split(fold_in(PRNGKey(0, device=where), t))[site]
            gid = ids[:len(GOLDEN_IDS)].to(where)
            u = owned_uniform(key, gid, (3,)).cpu().view(torch.int32)
            r = owned_randint(key, gid, (3,), 0, 999_999).cpu()
            check(u.numpy().astype(np.uint32).tolist() == u_bits,
                  f"owned_uniform golden tick {t} site {site} on {where}")
            check(r.tolist() == r_vals,
                  f"owned_randint golden tick {t} site {site} on {where}")
        key = split(fold_in(PRNGKey(0, device=dev), t))[site]
        on_card = (owned_uniform(key, ids.to(dev), (4,)),
                   owned_randint(key, ids.to(dev), (4,), 0, 999_999),
                   sample_peers_owned(key, ids.to(dev) % N_1M, N_1M, 4))
        key = key.cpu()
        on_cpu = (owned_uniform(key, ids, (4,)),
                  owned_randint(key, ids, (4,), 0, 999_999),
                  sample_peers_owned(key, ids % N_1M, N_1M, 4))
        for a, b in zip(on_card, on_cpu):
            check(torch.equal(a.cpu(), b), f"draws on CUDA != CPU, tick {t}")
    log(f"threefry: golden values and {ids.numel()} ids x 4 draws "
        "CUDA == CPU")


def report_line(tag: str, rep, card: str) -> None:
    s = rep.summary()
    row = {"run": tag, "rounds_per_sec": rep.rounds_per_sec,
           "wall_s": rep.wall_s, "t99_ms": s["t99_ms"],
           "infected_final": s["infected_final"], "overflow": rep.overflow,
           "device": rep.device, "card": card}
    log("study " + json.dumps(row))


def phase_slice(dev, card: str) -> int:
    """The slice's studies; returns the ring kernel's launches in the
    main-path run (8 shards, ring transport)."""
    import torch

    from consul_tpu_torch import BroadcastConfig, mesh_for, run_broadcast
    from consul_tpu_torch.ops import ring_exchange
    from consul_tpu_torch.protocol import LAN

    def drive(cfg, steps, **kw):
        # One untimed pass, then the counted and timed pass.
        run_broadcast(cfg, steps, seed=0, warmup=False, device=dev, **kw)
        ring_exchange.launches = 0
        rep = run_broadcast(cfg, steps, seed=0, warmup=False, device=dev,
                            **kw)
        return rep, ring_exchange.launches

    edges = BroadcastConfig(n=N_1M, fanout=4, profile=LAN, delivery="edges")
    torch.cuda.reset_peak_memory_stats()
    plain, plain_launches = drive(edges, EDGE_STEPS)
    report_line("edges_1m_unsharded", plain, card)
    ring, launches = drive(edges, EDGE_STEPS, mesh=mesh_for(SHARDS),
                           exchange="ring")
    report_line("edges_1m_d8_ring", ring, card)
    a2a, a2a_launches = drive(edges, EDGE_STEPS, mesh=mesh_for(SHARDS),
                              exchange="alltoall")
    report_line("edges_1m_d8_alltoall", a2a, card)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    check(np.array_equal(plain.infected, ring.infected),
          "ring infected != unsharded")
    check(np.array_equal(plain.infected, a2a.infected),
          "alltoall infected != unsharded")
    check(ring.overflow == 0 and a2a.overflow == 0, "outbox overflow")
    check(launches == EDGE_STEPS,
          f"ring kernel launched {launches} times, want {EDGE_STEPS}")
    check(plain_launches == 0 and a2a_launches == 0,
          "ring kernel launched off the ring path")
    check(ring.time_to_ms(0.99) is not None, "edges study never reached 99%")

    agg = BroadcastConfig(n=N_1M, fanout=4, profile=LAN,
                          delivery="aggregate")
    agg_plain, _ = drive(agg, AGG_STEPS)
    report_line("broadcast_1m_aggregate", agg_plain, card)
    agg_ring, _ = drive(agg, AGG_STEPS, mesh=mesh_for(SHARDS),
                        exchange="ring")
    report_line("broadcast_1m_aggregate_d8", agg_ring, card)
    check(np.array_equal(agg_plain.infected, agg_ring.infected),
          "aggregate sharded != unsharded")
    check(agg_plain.time_to_ms(0.99) is not None,
          "aggregate study never reached 99%")
    check(bool(np.all(np.diff(agg_plain.infected) >= 0)),
          "aggregate curve not monotone")

    # A small study held against the port on the CPU, which the tests
    # hold bit-equal to the JAX package.
    small = BroadcastConfig(n=4096, fanout=3, loss=0.2)
    for kw in ({}, {"mesh": mesh_for(4), "exchange": "ring"}):
        on_card = run_broadcast(small, 20, seed=3, warmup=False,
                                device=dev, **kw)
        on_cpu = run_broadcast(small, 20, seed=3, warmup=False,
                               device="cpu", **kw)
        check(np.array_equal(on_card.infected, on_cpu.infected),
              f"small study on CUDA != CPU ({kw})")
        check(on_card.infected.shape == (20,), "infected shape")
    log("small study: CUDA == CPU, unsharded and 4 shards (ring)")
    return launches


def swim_headline_cfg(delivery: str):
    from consul_tpu_torch import SwimConfig
    from consul_tpu_torch.protocol import WAN

    return SwimConfig(n=N_1M, subject=42, loss=0.30, profile=WAN,
                      delivery=delivery)


def check_swim_report(rep, cfg, tag: str) -> None:
    """The headline's invariants: the subject crashes at tick 0 and
    never refutes."""
    sus = np.asarray(rep.suspecting, np.int64)
    dead = np.asarray(rep.dead_known, np.int64)
    check(sus.shape == (rep.ticks,) and dead.shape == (rep.ticks,),
          f"{tag}: output shapes")
    first_sus = rep.first_tick(sus)
    check(first_sus is not None
          and first_sus + 1 <= 10 * cfg.probe_interval_ticks,
          f"{tag}: first suspicion at tick {first_sus}, later than 10 "
          "probe intervals")
    lo, _ = cfg.suspicion_bounds_ticks
    first_dead = rep.first_tick(dead)
    check(first_dead is None or first_dead - first_sus >= lo,
          f"{tag}: DEAD at tick {first_dead}, {lo} ticks not passed since "
          f"first suspicion at {first_sus}")
    check(bool(np.all(np.diff(dead) >= 0)), f"{tag}: dead_known fell")
    check(bool(np.all(sus + dead <= cfg.n - 1)),
          f"{tag}: suspecting + dead_known > n - 1")


def phase_swim(dev, card: str) -> None:
    """The SWIM headline at 1M nodes, aggregate and edges.  The path runs
    no kernel of the port's own: the ring kernel's count, zeroed before
    each run, must read 0 after it."""
    import torch

    from consul_tpu_torch import run_swim
    from consul_tpu_torch.ops import ring_exchange

    launches = 0
    for delivery, steps in (("aggregate", SWIM_AGG_STEPS),
                            ("edges", SWIM_EDGE_STEPS)):
        cfg = swim_headline_cfg(delivery)
        # Eager PyTorch compiles nothing: a few ticks warm the allocator.
        run_swim(cfg, 5, seed=0, warmup=False, device=dev)
        torch.cuda.reset_peak_memory_stats()
        ring_exchange.launches = 0
        rep = run_swim(cfg, steps, seed=0, warmup=False, device=dev)
        launches += ring_exchange.launches
        s = rep.summary()
        row = {"run": f"swim_{delivery}_1m", "ticks": steps,
               "rounds_per_sec": rep.rounds_per_sec, "wall_s": rep.wall_s,
               "first_suspect_ms": s["first_suspect_ms"],
               "first_dead_ms": s["first_dead_ms"],
               "t99_dead_known_ms": s["t99_dead_known_ms"],
               "suspecting_final": s["suspecting_final"],
               "dead_known_final": s["dead_known_final"],
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "device": rep.device, "card": card}
        log("study " + json.dumps(row))
        check_swim_report(rep, cfg, f"swim_{delivery}_1m")
    log(f"ring kernel launches on the SWIM path: {launches}")
    check(launches == 0, "ring kernel launched on the SWIM path")


def phase_lifeguard(dev, card: str) -> None:
    """degraded1m's environment at 1M nodes, Lifeguard on then off."""
    import dataclasses

    from consul_tpu_torch import LifeguardConfig, run_lifeguard
    from consul_tpu_torch.protocol import WAN
    from consul_tpu_torch.sim.scenarios import degraded1m_environment

    faults, loss, ack_late = degraded1m_environment()
    cfg = LifeguardConfig(n=N_1M, subject=7, subject_alive=True, loss=loss,
                          ack_late=ack_late, profile=WAN,
                          delivery="aggregate", lifeguard=True,
                          faults=faults)
    run_lifeguard(cfg, 5, seed=0, warmup=False, device=dev)
    reps = {}
    for on in (True, False):
        rep = run_lifeguard(dataclasses.replace(cfg, lifeguard=on),
                            LIFEGUARD_STEPS, seed=0, warmup=False,
                            device=dev)
        reps[on] = rep
        s = rep.summary()
        log("study " + json.dumps({
            "run": f"lifeguard_degraded_1m_{'on' if on else 'off'}",
            "ticks": LIFEGUARD_STEPS, "rounds_per_sec": rep.rounds_per_sec,
            "wall_s": rep.wall_s, "fp_total": s["fp_total"],
            "refute_total": s["refute_total"],
            "mean_awareness_final": s["mean_awareness_final"],
            "suspecting_final": s["suspecting_final"],
            "device": rep.device, "card": card}))
        check(rep.suspecting.shape == (LIFEGUARD_STEPS,),
              "lifeguard output shape")
        check(bool(np.all(np.isfinite(rep.mean_awareness))),
              "mean_awareness not finite")
        check(bool(np.all((rep.mean_awareness >= 0)
                          & (rep.mean_awareness <= 7))),
              "mean_awareness outside [0, 7]")
        check(bool(np.all(rep.suspecting + rep.dead_known <= N_1M - 1)),
              "suspecting + dead_known > n - 1")
    check(float(reps[False].mean_awareness[-1]) == 0.0,
          "awareness moved with Lifeguard off")


def to_cpu(state):
    return type(state)(*(x.cpu() for x in state))


def state_diff(want, got, skip=None) -> str:
    """The first field where two CPU states differ (dtype included),
    leaving out the nodes in ``skip``; '' where they agree."""
    for name, x, y in zip(want._fields, want, got):
        if x.dtype != y.dtype:
            return name
        if skip is not None and x.shape == skip.shape:
            x, y = x[~skip], y[~skip]
        if not np.array_equal(x.numpy(), y.numpy()):
            return name
    return ""


def _aggregate_flips(cfg, state, key):
    """bool[n] receivers whose SWIM aggregate arrival of some class
    differs between the card and the CPU in the round from ``state``,
    after checking the shared uniforms bit for bit, each threshold within
    1 ulp of its float64 value, and that a differing receiver's uniform
    lies between the two thresholds."""
    import torch

    from consul_tpu_torch.ops import arrival_rate, owned_uniform, split

    n = cfg.n
    dead_now = (not cfg.subject_alive) and int(state.tick) >= cfg.fail_at_tick
    flips = torch.zeros(n, dtype=torch.bool)
    ids = torch.arange(n, dtype=torch.int32)
    k_cls = split(split(key, 5)[0], 3)
    for c, tx in enumerate((state.tx_suspect, state.tx_dead,
                            state.tx_refute)):
        send = tx.cpu() > 0
        send[cfg.subject] &= not dead_now
        per_dev = []
        for where in (key.device, "cpu"):
            s = send.to(where)
            lam = arrival_rate(torch.sum(s, dtype=torch.float32), s,
                               cfg.fanout, cfg.loss, n)
            u = owned_uniform(k_cls[c].to(where), ids.to(where))
            per_dev.append((lam.cpu(), u.cpu(), (-torch.expm1(-lam)).cpu()))
        (lam_d, u_d, thr_d), (lam_c, u_c, thr_c) = per_dev
        check(torch.equal(lam_d, lam_c), "aggregate rates CUDA != CPU")
        check(torch.equal(u_d, u_c), "aggregate uniforms CUDA != CPU")
        truth = (-torch.expm1(-lam_c.double())).float()
        for thr in (thr_d, thr_c):
            gap = (thr.view(torch.int32).long()
                   - truth.view(torch.int32).long()).abs()
            check(int(gap.max()) <= 1, "threshold > 1 ulp from float64")
        flip = (u_c < thr_d) != (u_c < thr_c)
        lo = torch.minimum(thr_d, thr_c)[flip]
        hi = torch.maximum(thr_d, thr_c)[flip]
        check(bool(((lo <= u_c[flip]) & (u_c[flip] < hi)).all()),
              "receiver differs outside the threshold band")
        flips |= flip
    return flips


def phase_small_parity(dev) -> None:
    """The round on the card against the round on the CPU at n=4096."""
    import torch

    from consul_tpu_torch import LifeguardConfig, SwimConfig
    from consul_tpu_torch.models import (
        lifeguard_init,
        lifeguard_round,
        swim_init,
        swim_round,
    )
    from consul_tpu_torch.models.lifeguard import lifeguard_constants
    from consul_tpu_torch.models.swim import swim_constants
    from consul_tpu_torch.ops import PRNGKey, fold_in
    from consul_tpu_torch.sim import (
        ChurnWindow,
        DegradedSet,
        FaultSchedule,
        LossRamp,
        Partition,
    )
    from consul_tpu_torch.sim.scenarios import degraded1m

    faults = FaultSchedule(
        ramps=(LossRamp(((10, 0.2), (50, 0.0))),),
        partitions=(Partition(start=15, heal=45, segments=2, severity=0.8),),
        degraded=(DegradedSet(frac=0.1, drop=0.5, late=0.6, seed=3),),
        churn=(ChurnWindow(start=20, end=60, p_offline=0.05),),
    )
    # LAN at n=4096: suspicion minimum 72.2 ticks, so these depths see
    # dead declarations.  The degraded set drops half its sends, so the
    # mean send survival is an exact float32 sum in any order.
    studies = (
        ("swim_edges", SwimConfig(n=SMALL_N, subject=9, loss=0.1),
         swim_init, swim_round, swim_constants, 110),
        ("swim_aggregate", SwimConfig(n=SMALL_N, subject=9, loss=0.1,
                                      delivery="aggregate"),
         swim_init, swim_round, swim_constants, 110),
        ("lifeguard_edges", LifeguardConfig(
            n=SMALL_N, subject=9, fail_at_tick=10, loss=0.1, ack_late=0.25,
            faults=faults), lifeguard_init, lifeguard_round,
         lifeguard_constants, 140),
    )
    for tag, cfg, init, rnd, constants, steps in studies:
        on_card = init(cfg, device=dev)
        card_consts, cpu_consts = constants(cfg, dev), constants(cfg, "cpu")
        key = PRNGKey(3, device=dev)
        flipped = 0
        for t in range(steps):
            k = fold_in(key, t)
            before = to_cpu(on_card)
            want = rnd(before, k.cpu(), cfg, cpu_consts)
            on_card = rnd(on_card, k, cfg, card_consts)
            skip = None
            if cfg.delivery == "aggregate":
                skip = _aggregate_flips(cfg, before, k)
                flipped += int(skip.sum())
            diff = state_diff(want, to_cpu(on_card), skip)
            check(not diff, f"{tag} tick {t}: {diff} CUDA != CPU")
        check(int((on_card.view == 2).sum()) > 0,
              f"{tag}: no dead declaration in {steps} ticks")
        log(f"{tag}: CUDA == CPU, every field on every tick, {steps} ticks "
            f"at n={SMALL_N}" + (f", {flipped} near-threshold receivers"
                                 if cfg.delivery == "aggregate" else ""))
    small = degraded1m(seed=0, n=SMALL_N, steps=20)  # default device: CUDA
    check(small["n"] == SMALL_N and small["ticks"] == 20, "degraded1m dict")
    log("degraded1m(n=4096, steps=20) on the default device: "
        + json.dumps(small))


def sparse_cfg(n: int):
    from consul_tpu_torch import MembershipConfig, SparseMembershipConfig
    from consul_tpu_torch.protocol import LAN

    return SparseMembershipConfig(
        MembershipConfig(n=n, loss=0.01, profile=LAN, fail_at=((42, 5),)),
        k_slots=64)


def check_detection(rep, base, tag: str, fail_tick: int = 5) -> dict:
    """The detection invariants of a crash study of tracked subject #0;
    returns its first suspicion and DEAD ticks."""
    sus = np.asarray(rep.suspecting[:, 0], np.int64)
    dead = np.asarray(rep.dead_known[:, 0], np.int64)
    check(sus.shape == (rep.ticks,) and dead.shape == (rep.ticks,),
          f"{tag}: output shapes")
    first_sus = rep.first_tick(sus)
    check(first_sus is not None
          and first_sus + 1 <= fail_tick + 10 * base.probe_interval_ticks,
          f"{tag}: first suspicion at tick {first_sus}, later than 10 probe "
          "intervals after the crash")
    lo, _ = base.suspicion_bounds_ticks
    first_dead = rep.first_tick(dead)
    check(first_dead is None or first_dead - first_sus >= lo,
          f"{tag}: DEAD at tick {first_dead}, {lo} ticks not passed since "
          f"first suspicion at {first_sus}")
    check(bool(np.all(np.diff(dead) >= 0)), f"{tag}: dead_known fell")
    check(bool(np.all(sus + dead <= base.n - 1)),
          f"{tag}: suspecting + dead_known > n - 1")
    check(bool(np.all(np.isfinite(rep.known_members))),
          f"{tag}: known_members not finite")
    return {"first_suspect_tick": first_sus, "first_dead_tick": first_dead}


def rows_sorted(slot_subj) -> bool:
    """The sorted-row invariant on the card: subjects strictly ascending,
    empties last, the self slot present in every row."""
    import torch

    keyed = torch.where(slot_subj < 0, 2 ** 31 - 1, slot_subj)
    step = keyed[:, 1:] - keyed[:, :-1]
    ok = bool(((step > 0) | (slot_subj[:, 1:] < 0)).all())
    ok &= bool((step >= 0).all())
    rows = torch.arange(slot_subj.shape[0], device=slot_subj.device)
    return ok and bool((slot_subj == rows[:, None].int()).any(dim=1).all())


def membership_line(tag: str, card: str, **row) -> None:
    log("study " + json.dumps({"run": tag, **row, "card": card}))


def sparse_steady(cfg, dev, card: str, tag: str):
    """bench.py's steady-state measure: the converged state, 8 ticks with
    PRNGKey(1) to warm up, 8 timed with PRNGKey(2).  The dead subject
    stays DEAD in every live row; ``overflow`` is reported, not checked: a
    false suspicion (a live probe fails with probability 1.2e-6 at loss
    0.01) may start a wave whose senders outnumber the gossip budget.
    Returns the final state."""
    import torch

    from consul_tpu_torch.models.membership_sparse import converged_state
    from consul_tpu_torch.ops import PRNGKey, host_cond
    from consul_tpu_torch.sim import sparse_membership_scan

    n = cfg.base.n
    torch.cuda.reset_peak_memory_stats()
    st, _ = sparse_membership_scan(converged_state(cfg, 42, device=dev),
                                   PRNGKey(1, device=dev), cfg, STEADY_STEPS,
                                   (42,))
    torch.cuda.synchronize()
    syncs = host_cond.syncs
    t0 = time.perf_counter()
    st, outs = sparse_membership_scan(st, PRNGKey(2, device=dev), cfg,
                                      STEADY_STEPS, (42,))
    torch.cuda.synchronize()
    dead = outs[1].cpu().numpy()
    wall = time.perf_counter() - t0
    overflow, forgotten = int(st.overflow), int(st.forgotten)
    membership_line(
        tag, card, ticks=STEADY_STEPS, rounds_per_sec=STEADY_STEPS / wall,
        wall_s=wall, overflow=overflow, forgotten=forgotten,
        dead_known_final=int(dead[-1, 0]),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        host_syncs_per_tick=(host_cond.syncs - syncs) / STEADY_STEPS)
    check(bool(np.all(dead[:, 0] == n - 1)),
          f"{tag}: the converged state lost a DEAD view")
    check(rows_sorted(st.slot_subj), f"{tag}: sorted-row invariant")
    return st


def phase_membership(dev, card: str) -> dict:
    """The membership slice's studies.  The path runs no kernel of the
    port's own: the ring kernel's count, zeroed before each run, must read
    0 after it.  Returns the cold and dense reports with their overflow by
    study name, for phase 8 to hold the sharded twins against."""
    import torch

    from consul_tpu_torch import MembershipConfig, run_membership
    from consul_tpu_torch import run_membership_sparse
    from consul_tpu_torch.ops import host_cond, ring_exchange
    from consul_tpu_torch.protocol import LAN
    from consul_tpu_torch.sim.scenarios import probe1k

    launches = 0

    def sparse_cold(n: int, steps: int, tag: str):
        nonlocal launches
        cfg = sparse_cfg(n)
        run_membership_sparse(cfg, 3, seed=0, track=(42,), warmup=False,
                              device=dev)
        torch.cuda.reset_peak_memory_stats()
        ring_exchange.launches = 0
        syncs = host_cond.syncs
        rep, overflow = run_membership_sparse(cfg, steps, seed=0,
                                              track=(42,), warmup=False,
                                              device=dev)
        launches += ring_exchange.launches
        per_tick = (host_cond.syncs - syncs) / steps
        det = check_detection(rep, cfg.base, tag)
        live = n - 1
        dead = rep.dead_known[:, 0]
        hit = np.nonzero(dead >= 0.99 * live)[0]
        row = dict(
            ticks=steps, rounds_per_sec=rep.rounds_per_sec, wall_s=rep.wall_s,
            overflow=overflow, forgotten=rep.forgotten, **det,
            dead99_tick=int(hit[0]) if hit.size else None,
            dead_known_final=int(dead[-1]),
            suspect_cells_final=int(rep.suspect_cells[-1]),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            host_syncs_per_tick=per_tick, device=rep.device)
        membership_line(tag, card, **row)
        check(per_tick <= 2, f"{tag}: {per_tick} host syncs a tick")
        reports[tag] = (rep, overflow)
        return cfg, rep, row

    reports = {}
    cfg100k, _, row = sparse_cold(SPARSE_N, SPARSE_COLD_100K_STEPS,
                                  "membership_sparse_100k_cold")
    check(row["dead99_tick"] is not None,
          "sparse 100k: 99% of live observers never held 42 DEAD")
    sparse_steady(cfg100k, dev, card, "membership_sparse_100k_steady")

    cfg1m, _, _ = sparse_cold(N_1M, SPARSE_COLD_1M_STEPS,
                              "membership_sparse_1m_cold")
    st = sparse_steady(cfg1m, dev, card, "membership_sparse_1m_steady")
    del st

    dense = MembershipConfig(n=DENSE_N, loss=0.01, profile=LAN,
                             fail_at=((42, 5),))
    run_membership(dense, 2, seed=0, track=(42,), warmup=False, device=dev)
    torch.cuda.reset_peak_memory_stats()
    ring_exchange.launches = 0
    rep = run_membership(dense, DENSE_STEPS, seed=0, track=(42,),
                         warmup=False, device=dev)
    launches += ring_exchange.launches
    det = check_detection(rep, dense, "membership_dense_16k")
    membership_line(
        "membership_dense_16k", card, ticks=DENSE_STEPS,
        rounds_per_sec=rep.rounds_per_sec, wall_s=rep.wall_s, overflow=None,
        forgotten=None, **det, dead_known_final=int(rep.dead_known[-1, 0]),
        suspect_cells_final=int(rep.suspect_cells[-1]),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        host_syncs_per_tick=0.0, device=rep.device)
    check(int(rep.known_members[0]) > 0, "dense 16k: known_members")
    reports["membership_dense_16k"] = (rep, 0)

    ring_exchange.launches = 0
    torch.cuda.reset_peak_memory_stats()
    summary = probe1k(seed=0, device=dev)
    launches += ring_exchange.launches
    membership_line("probe1k", card, **summary, overflow=None,
                    forgotten=None, host_syncs_per_tick=0.0,
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    check(summary["all_detected"], "probe1k: a crash went undetected")
    log(f"ring kernel launches on the membership path: {launches}")
    check(launches == 0, "ring kernel launched on the membership path")
    return reports


def _parity_run(tag, init, rnd, consts, cfg, dev, steps: int, seed: int,
                check_end=None) -> None:
    """Step the round on the card and on the CPU from the same state and
    key, every field compared with its dtype after every tick."""
    from consul_tpu_torch.ops import PRNGKey, fold_in

    on_card = init(cfg, device=dev)
    card_consts, cpu_consts = consts(cfg, dev), consts(cfg, "cpu")
    key = PRNGKey(seed, device=dev)
    for t in range(steps):
        k = fold_in(key, t)
        want = rnd(to_cpu(on_card), k.cpu(), cfg, cpu_consts)
        on_card = rnd(on_card, k, cfg, card_consts)
        diff = state_diff(want, to_cpu(on_card))
        check(not diff, f"{tag} tick {t}: {diff} CUDA != CPU")
    if check_end is not None:
        check_end(on_card)
    log(f"{tag}: CUDA == CPU, every field on every tick, {steps} ticks")


def phase_membership_parity(dev) -> None:
    """Every membership round on the card against the CPU."""
    import dataclasses

    from consul_tpu_torch import MembershipConfig, SparseMembershipConfig
    from consul_tpu_torch.models import (
        membership_init,
        membership_round,
        sparse_membership_init,
        sparse_membership_round,
    )
    from consul_tpu_torch.models import membership_sparse as ms
    from consul_tpu_torch.models.membership import membership_constants
    from consul_tpu_torch.ops import sortmerge
    from consul_tpu_torch.protocol import LAN

    churn = MembershipConfig(n=SMALL_N, loss=0.2, profile=LAN,
                             fail_at=((5, 3), (100, 5), (2000, 8)),
                             leave_at=((77, 10),))

    def pressured(st):
        check(int(st.overflow) > 0 and int(st.forgotten) > 0,
              "small sparse study: no overflow or no eviction")
        check(rows_sorted(st.slot_subj), "small sparse: sorted rows")

    for amortize in (True, False):
        _parity_run(f"sparse_k16_n{SMALL_N}_amortize_{amortize}",
                    sparse_membership_init, sparse_membership_round,
                    ms.sparse_constants,
                    SparseMembershipConfig(churn, k_slots=16,
                                           amortize=amortize),
                    dev, 40, 3, pressured)
    full = MembershipConfig(n=256, loss=0.2, profile=LAN,
                            fail_at=((5, 3), (17, 8)), leave_at=((30, 12),))
    _parity_run("sparse_k_eq_n_256", sparse_membership_init,
                sparse_membership_round, ms.sparse_constants,
                SparseMembershipConfig(full, k_slots=256), dev, 40, 7)
    _parity_run("dense_512", membership_init, membership_round,
                membership_constants,
                dataclasses.replace(full, n=512, join_at=((400, 6),)),
                dev, 40, 7)
    # The >= 2M-node branches on a small study: lower the thresholds that
    # select them, then put them back.
    saved = (sortmerge._BLOCK_ROWS, ms._CHUNK_A, ms._CHUNK_TARGET)
    sortmerge._BLOCK_ROWS, ms._CHUNK_A, ms._CHUNK_TARGET = (
        1024, 1 << 14, 1 << 14)
    cfg = SparseMembershipConfig(churn, k_slots=16)
    check(ms.arrival_count(cfg) > ms._CHUNK_A
          and sortmerge._row_blocks(SMALL_N) == (4, 1024),
          "chunked/blocked branches not selected")
    _parity_run(f"sparse_chunked_blocked_n{SMALL_N}",
                sparse_membership_init, sparse_membership_round,
                ms.sparse_constants, cfg, dev, 20, 5)
    sortmerge._BLOCK_ROWS, ms._CHUNK_A, ms._CHUNK_TARGET = saved


def phase_geo_kernel(dev) -> int:
    """The box entry point of the ring kernel at the geo outbox shape, bit
    for bit against its plain version; returns the largest error (phase 8
    times the kernel there)."""
    import torch

    from consul_tpu_torch.ops import ring_exchange, ring_exchange_plain

    gen = torch.Generator(device=dev).manual_seed(4)
    box = torch.randint(-2 ** 31, 2 ** 31 - 1, GEO_RING_SHAPE, generator=gen,
                        dtype=torch.int32, device=dev)
    got = ring_exchange(box)
    want = ring_exchange_plain(box)
    torch.cuda.synchronize()
    max_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(torch.equal(got, want), f"ring kernel != plain at {GEO_RING_SHAPE}")
    log(f"ring kernel at {GEO_RING_SHAPE}: == plain")
    return max_err


def phase_geo_latency(dev):
    """derive_wan_latency on the card for both golden configs; returns the
    (8 x 5) matrix the geo A/B runs on."""
    from consul_tpu_torch.geo import derive_wan_latency

    for (bridges, rounds), (golden, rel_ref) in LATENCY_GOLDEN.items():
        t0 = time.perf_counter()
        lat, info = derive_wan_latency(8, bridges, tick_ms=200, seed=0,
                                       rounds=rounds, wan_window=8,
                                       device=dev)
        wall = time.perf_counter() - t0
        lat_cpu, info_cpu = derive_wan_latency(
            8, bridges, tick_ms=200, seed=0, rounds=rounds, wan_window=8,
            device="cpu")
        log(f"derive_wan_latency(8, {bridges}, rounds={rounds}) on the card "
            f"in {wall:.2f} s: rel_rtt_error {info['rel_rtt_error']!r} "
            f"(CPU {info_cpu['rel_rtt_error']!r}, jax 0.9.0 {rel_ref!r})")
        check(lat == golden, f"latency (8, {bridges}) != golden: {lat}")
        check(lat_cpu == lat, f"latency (8, {bridges}) CUDA != CPU")
        check(info["rel_rtt_error"] == info_cpu["rel_rtt_error"],
              "rel_rtt_error CUDA != CPU")
    return LATENCY_GOLDEN[(5, 400)][0]


def phase_multidc(dev, card: str) -> None:
    """multidc1m at 1M: the preset and the study behind it."""
    import torch

    from consul_tpu_torch import MultiDCConfig, run_multidc
    from consul_tpu_torch.ops import host_cond, ring_exchange
    from consul_tpu_torch.sim.scenarios import multidc1m

    cfg = MultiDCConfig(n=N_1M, segments=8, bridges_per_segment=5,
                        delivery="aggregate")
    origin = cfg.seg_size // 2
    run_multidc(cfg, 3, origin=origin, warmup=False, device=dev)
    torch.cuda.reset_peak_memory_stats()
    ring_exchange.launches = 0
    syncs = host_cond.syncs
    rep = run_multidc(cfg, MULTIDC_STEPS, seed=0, origin=origin,
                      warmup=False, device=dev)
    per_tick = (host_cond.syncs - syncs) / MULTIDC_STEPS
    s = rep.summary()
    log("study " + json.dumps({
        "run": "multidc1m", "ticks": MULTIDC_STEPS,
        "rounds_per_sec": rep.rounds_per_sec, "wall_s": rep.wall_s,
        "infected_final": s["infected_final"],
        "segments_reached": s["segments_reached"], "t50_ms": s["t50_ms"],
        "t99_ms": s["t99_ms"], "segment_t99_ms": s["segment_t99_ms"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "host_syncs_per_tick": per_tick, "device": rep.device,
        "card": card}))
    check(rep.infected.shape == (MULTIDC_STEPS,)
          and rep.per_segment.shape == (MULTIDC_STEPS, 8), "multidc1m shapes")
    check(bool(np.all(np.diff(rep.infected) >= 0)), "multidc1m: infected fell")
    check(s["segments_reached"] == 8, "multidc1m: a segment never reached")
    check(all(t is not None for t in s["segment_t99_ms"]),
          "multidc1m: a segment never reached 99%")
    check(per_tick == 0, f"multidc1m: {per_tick} host syncs a tick")
    check(ring_exchange.launches == 0, "ring kernel launched on multidc")
    got = {k: s[k] for k in MULTIDC1M_REFERENCE}
    check(got == MULTIDC1M_REFERENCE,
          f"multidc1m {got} != the JAX package's {MULTIDC1M_REFERENCE}")
    preset = multidc1m(seed=0, device=dev)
    check({k: preset[k] for k in MULTIDC1M_REFERENCE} == got,
          "multidc1m preset != the study")
    log("multidc1m: equal to the JAX package's curves; preset "
        f"{preset['sim_rounds_per_sec']!r} rounds/s")


GEO_FIELDS = ("per_segment", "offered", "admitted", "queued", "overflow",
              "wasted")


def phase_geo(dev, card: str, latency) -> int:
    """The geo A/B at 1M, then the adaptive arm over 8 logical shards with
    each transport; returns the ring kernel's launches on the ring run."""
    import torch

    from consul_tpu_torch import mesh_for, run_geo
    from consul_tpu_torch.ops import host_cond, ring_exchange
    from consul_tpu_torch.sim.scenarios import geo_ab_config

    def drive(cfg, tag, **kw):
        run_geo(cfg, 3, seed=0, warmup=False, device=dev, **kw)
        torch.cuda.reset_peak_memory_stats()
        ring_exchange.launches = 0
        syncs = host_cond.syncs
        rep = run_geo(cfg, GEO_STEPS, seed=0, warmup=False, device=dev, **kw)
        launches = ring_exchange.launches
        s = rep.summary()
        row = {"run": tag, "ticks": GEO_STEPS,
               "rounds_per_sec": rep.rounds_per_sec, "wall_s": rep.wall_s,
               **{k: s[k] for k in (
                   "t50_ms", "t99_ms", "segment_t99_ms",
                   "wan_admitted_bytes", "wan_overflow_units",
                   "wan_wasted_units", "accounting_ok")},
               "shard_overflow": rep.shard_overflow,
               "ring_launches": launches,
               "host_syncs_per_tick": (host_cond.syncs - syncs) / GEO_STEPS,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "device": rep.device, "card": card}
        log("study " + json.dumps(row))
        check(rep.per_segment.shape == (GEO_STEPS, 8)
              and rep.offered.shape == (GEO_STEPS, 64), f"{tag}: shapes")
        check(s["accounting_ok"], f"{tag}: link accounting identity broken")
        check(row["host_syncs_per_tick"] <= 2,
              f"{tag}: {row['host_syncs_per_tick']} host syncs a tick")
        return rep, s, launches

    arms = {}
    for label, adaptive in (("adaptive", True), ("fixed", False)):
        rep, s, launches = drive(geo_ab_config(latency, adaptive=adaptive),
                                 f"geo_1m_{label}")
        check(launches == 0, "ring kernel launched on the unsharded geo path")
        arms[label] = (rep, s)
        ref = GEO_AB_REFERENCE[label]
        got = {k: s[k] for k in ref}
        diff = sorted(k for k in ref if got[k] != ref[k])
        log(f"geo_1m_{label} against the JAX package's CPU run: "
            + ("equal" if not diff else f"differs in {diff}: {got}"))
    first = [np.array_equal(getattr(arms["adaptive"][0], f)[0],
                            getattr(arms["fixed"][0], f)[0])
             for f in GEO_FIELDS]
    check(all(first), "geo A/B arms differ at tick 0: not one universe")

    unsharded = arms["adaptive"][0]
    ring_launches = None
    for exchange in ("ring", "alltoall"):
        rep, _, launches = drive(geo_ab_config(latency),
                                 f"geo_1m_adaptive_d8_{exchange}",
                                 mesh=mesh_for(SHARDS), exchange=exchange)
        for f in GEO_FIELDS:
            check(np.array_equal(getattr(rep, f), getattr(unsharded, f)),
                  f"geo d8 {exchange}: {f} != unsharded")
        check(rep.shard_overflow == 0, f"geo d8 {exchange}: outbox overflow")
        if exchange == "ring":
            check(launches == GEO_STEPS,
                  f"ring kernel launched {launches} times, want {GEO_STEPS}")
            ring_launches = launches
        else:
            check(launches == 0, "ring kernel launched on alltoall")
    log("geo d8 ring and alltoall == unsharded on every tick, overflow 0")
    return ring_launches


def _step_parity(tag, state, step, dev, steps: int, seed: int) -> None:
    """``step(state, key) -> (state, outs)`` on the card and on the CPU
    from the same state and key, every field and output compared with its
    dtype after every tick."""
    import torch

    from consul_tpu_torch.ops import PRNGKey, fold_in

    key = PRNGKey(seed, device=dev)
    for t in range(steps):
        k = fold_in(key, t)
        want, want_out = step(to_cpu(state), k.cpu())
        state, out = step(state, k)
        diff = state_diff(want, to_cpu(state))
        check(not diff, f"{tag} tick {t}: {diff} CUDA != CPU")
        for i, (a, b) in enumerate(zip(want_out, out)):
            check(a.dtype == b.dtype and torch.equal(a, b.cpu()),
                  f"{tag} tick {t}: output {i} CUDA != CPU")
    log(f"{tag}: CUDA == CPU, every field on every tick, {steps} ticks")


def phase_geo_parity(dev, latency) -> None:
    """The geo slice's rounds on the card against the CPU."""
    import dataclasses

    from consul_tpu_torch.geo.latency import dc_placement
    from consul_tpu_torch.geo.model import geo_constants, geo_init, geo_round
    from consul_tpu_torch.models import (
        MultiDCConfig,
        VivaldiConfig,
        multidc_init,
        multidc_round,
        vivaldi_init,
        vivaldi_round,
    )
    from consul_tpu_torch.models.vivaldi import euclidean_rtt_model
    from consul_tpu_torch.sim import LossRamp
    from consul_tpu_torch.sim.scenarios import geo_ab_config

    for delivery in ("edges", "aggregate"):
        cfg = MultiDCConfig(n=SMALL_N, segments=8, bridges_per_segment=3,
                            delivery=delivery, loss_lan=0.1, loss_wan=0.2)
        _step_parity(f"multidc_{delivery}_{SMALL_N}",
                     multidc_init(cfg, origin=SMALL_N // 16, device=dev),
                     lambda st, k, c=cfg: (multidc_round(st, k, c), ()),
                     dev, 40, 3)
    for adaptive in (True, False):
        cfg = geo_ab_config(latency, n=SMALL_N, adaptive=adaptive)
        cfg = dataclasses.replace(cfg, events=8, origins=cfg.origins[:8],
                                  faults=dataclasses.replace(
                                      cfg.faults,
                                      ramps=(LossRamp(((10, 0.2),
                                                       (40, 0.0))),)))
        consts = {d: geo_constants(cfg, d) for d in ("cpu", dev)}
        _step_parity(f"geo_{'adaptive' if adaptive else 'fixed'}_{SMALL_N}",
                     geo_init(cfg, device=dev),
                     lambda st, k, c=cfg: geo_round(
                         st, k, c, consts["cpu" if k.device.type == "cpu"
                                          else dev]),
                     dev, GEO_PARITY_STEPS, 3)
    cfg = VivaldiConfig(n=40, rtt_jitter=0.05)
    pos = {d: dc_placement(8, 5, seed=0, device=d) for d in ("cpu", dev)}
    _step_parity("vivaldi_40", vivaldi_init(cfg, device=dev),
                 lambda st, k: (vivaldi_round(
                     st, k, cfg, euclidean_rtt_model(
                         pos["cpu" if k.device.type == "cpu" else dev])), ()),
                 dev, VIVALDI_PARITY_ROUNDS, 0)


def sharded_dense_cfg():
    from consul_tpu_torch import MembershipConfig
    from consul_tpu_torch.protocol import LAN

    return MembershipConfig(n=DENSE_N, loss=0.01, profile=LAN,
                            fail_at=((42, 5),))


def ring_path_shapes(dev) -> list:
    """(path, [D, D, C, budget]) of every ring path, from the budgets the
    code computes for the studies that drive it."""
    from consul_tpu_torch.parallel import (
        mesh_for,
        outbox_budget,
        sharded_membership_plan,
        sharded_sparse_plan,
    )

    mesh = mesh_for(SHARDS)
    return [
        ("sharded_broadcast_scan(exchange='ring')",
         (SHARDS, SHARDS, 1, outbox_budget(N_1M // SHARDS * 4, SHARDS))),
        ("sharded_geo_scan(exchange='ring')", GEO_RING_SHAPE),
        ("sharded_membership_scan(exchange='ring'), n=16384",
         (SHARDS, SHARDS, 4,
          sharded_membership_plan(sharded_dense_cfg(), mesh, dev).budget)),
        ("sharded_sparse_membership_scan(exchange='ring'), n=100000",
         (SHARDS, SHARDS, 5,
          sharded_sparse_plan(sparse_cfg(SPARSE_N), mesh, dev).budget)),
        ("sharded_sparse_membership_scan(exchange='ring'), n=1000000",
         (SHARDS, SHARDS, 5,
          sharded_sparse_plan(sparse_cfg(N_1M), mesh, dev).budget)),
    ]


def phase_ring_paths(dev, shapes) -> list:
    """The rebuilt ring kernel at each ``(path, shape)``, fed as the outbox
    packer leaves its planes (one buffer, rows of ``outbox_pitch``) at
    buffer offsets 0 and 1 (rows off 16-byte alignment): bit for bit
    against its plain version; then the whole ``exchange_outbox`` on both
    transports, the kernel alone (:func:`device_ms`), the plain version
    and the one-call yardstick ``transpose(0, 1).contiguous()`` of the
    stacked box."""
    import torch

    from consul_tpu_torch.ops import (
        ring_exchange_planes,
        ring_exchange_planes_plain,
    )
    from consul_tpu_torch.parallel import exchange_outbox, outbox_pitch

    gen = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for path, (d, _, c, budget) in shapes:
        pitch = outbox_pitch(d, budget)
        max_err = 0
        for offset in (1, 0):
            flat = torch.randint(-2 ** 31, 2 ** 31 - 1,
                                 (c * d * pitch + offset,), generator=gen,
                                 dtype=torch.int32, device=dev)
            planes = flat[offset:].view(c, d, pitch)[..., :d * budget] \
                .unflatten(-1, (d, budget)).unbind(0)
            got = ring_exchange_planes(planes)
            want = ring_exchange_planes_plain(planes)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                max_err = max(max_err, int((g.to(torch.int64)
                                            - w.to(torch.int64))
                                           .abs().max()))
                check(torch.equal(g, w),
                      f"ring kernel != plain at {path} offset {offset}")
            del got, want
        # Timed at offset 0, as pack_outbox leaves its buffer.
        iters = 50 if budget < 200_000 else 20
        box = torch.stack(planes, dim=2).contiguous()
        row = {
            "path": path, "shape": [d, d, c, budget], "max_abs_err": max_err,
            "ms": cuda_ms(lambda: exchange_outbox(planes, "ring"), iters),
            "alltoall_ms": cuda_ms(lambda: exchange_outbox(planes,
                                                           "alltoall"),
                                   iters),
            "busy_ms": device_ms(lambda: ring_exchange_planes(planes)),
            "plain_ms": cuda_ms(lambda: ring_exchange_planes_plain(planes),
                                10, 3),
            "library_ms": cuda_ms(lambda: box.transpose(0, 1).contiguous(),
                                  iters),
            "bound_ms": 2 * c * d * d * budget * 4 / PEAK_BYTES_PER_S * 1e3,
        }
        del box, planes, flat
        log("ring path " + json.dumps(row))
        rows.append(row)
    return rows


def _timed_scan(scan, dev):
    """Run ``scan()`` fenced by synchronisation and the copy of its outputs
    to the host: (final state, host outputs, wall seconds)."""
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    final, outs = scan()
    torch.cuda.synchronize(dev)
    outs = tuple(o.cpu().numpy() for o in outs)
    return final, outs, time.perf_counter() - t0


def phase_sharded_membership(dev, card: str, unsharded: dict) -> dict:
    """The sharded membership studies over 8 logical shards, each with both
    transports: ring == alltoall on every tick and in the final state, one
    ring launch a tick, at most 2 host syncs a sparse tick (0 dense), the
    detection invariants, and the unsharded run's outputs wherever both
    overflows are 0.  Returns each ring study's kernel launches."""
    import torch

    from consul_tpu_torch.models import membership_init, sparse_membership_init
    from consul_tpu_torch.ops import PRNGKey, host_cond, ring_exchange
    from consul_tpu_torch.parallel import (
        mesh_for,
        sharded_membership_scan,
        sharded_sparse_membership_scan,
    )
    from consul_tpu_torch.sim.metrics import MembershipReport

    mesh = mesh_for(SHARDS, dev)
    studies = (
        ("membership_sparse_100k_cold_d8", "membership_sparse_100k_cold",
         sparse_cfg(SPARSE_N), SPARSE_COLD_100K_STEPS),
        ("membership_sparse_1m_cold_d8", "membership_sparse_1m_cold",
         sparse_cfg(N_1M), SPARSE_COLD_1M_STEPS),
        ("membership_dense_16k_d8", "membership_dense_16k",
         sharded_dense_cfg(), DENSE_STEPS),
    )
    launches = {}
    for tag, plain_tag, cfg, steps in studies:
        sparse = hasattr(cfg, "base")
        base = cfg.base if sparse else cfg

        def scan(steps, exchange, cfg=cfg, sparse=sparse):
            key = PRNGKey(0, device=dev)
            if sparse:
                return sharded_sparse_membership_scan(
                    sparse_membership_init(cfg, device=dev), key, cfg, steps,
                    mesh, (42,), exchange)
            return sharded_membership_scan(membership_init(cfg, device=dev),
                                           key, cfg, steps, mesh, (42,),
                                           exchange)

        runs = {}
        for exchange in ("ring", "alltoall"):
            scan(2, exchange)  # eager PyTorch compiles nothing: warm up
            torch.cuda.reset_peak_memory_stats()
            ring_exchange.launches = 0
            syncs = host_cond.syncs
            final, outs, wall = _timed_scan(lambda: scan(steps, exchange),
                                            dev)
            n_launch = ring_exchange.launches
            per_tick = (host_cond.syncs - syncs) / steps
            overflow = int(final.overflow) if sparse else int(outs[4])
            rep = MembershipReport(
                n=base.n, ticks=steps,
                tick_ms=base.profile.gossip_interval_ms,
                probe_interval_ms=base.profile.probe_interval_ms,
                track=(42,), suspecting=outs[0], dead_known=outs[1],
                suspect_cells=outs[2], known_members=outs[3], wall_s=wall,
                overflow=overflow)
            det = check_detection(rep, base, f"{tag}_{exchange}")
            dead = rep.dead_known[:, 0]
            hit = np.nonzero(dead >= 0.99 * (base.n - 1))[0]
            membership_line(
                f"{tag}_{exchange}", card, ticks=steps,
                rounds_per_sec=rep.rounds_per_sec, wall_s=wall,
                overflow=overflow,
                forgotten=int(final.forgotten) if sparse else None, **det,
                dead99_tick=int(hit[0]) if hit.size else None,
                dead_known_final=int(dead[-1]),
                suspect_cells_final=int(rep.suspect_cells[-1]),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                host_syncs_per_tick=per_tick, ring_launches=n_launch,
                device=torch.cuda.get_device_name(dev))
            check(per_tick <= (2 if sparse else 0),
                  f"{tag}_{exchange}: {per_tick} host syncs a tick")
            check(n_launch == (steps if exchange == "ring" else 0),
                  f"{tag}_{exchange}: ring kernel launched {n_launch} times")
            runs[exchange] = (final, outs[:4], overflow)
            if exchange == "ring":
                launches[tag] = n_launch
        (f_ring, o_ring, ov_ring), (f_a2a, o_a2a, ov_a2a) = (
            runs["ring"], runs["alltoall"])
        for i, (a, b) in enumerate(zip(o_ring, o_a2a)):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"{tag}: output {i} ring != alltoall")
        for name, a, b in zip(f_ring._fields, f_ring, f_a2a):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"{tag}: final {name} ring != alltoall")
        check(ov_ring == ov_a2a, f"{tag}: overflow ring != alltoall")
        del runs, f_ring, f_a2a
        plain, plain_ov = unsharded[plain_tag]
        fields = ("suspecting", "dead_known", "suspect_cells",
                  "known_members")
        same = all(np.array_equal(o, getattr(plain, f))
                   for o, f in zip(o_ring, fields))
        log(f"{tag}: ring == alltoall every tick and in the final state; "
            f"overflow sharded {ov_ring}, unsharded {plain_ov}; per-tick "
            f"outputs {'equal to' if same else 'differ from'} the unsharded "
            "run")
        if ov_ring == 0 and plain_ov == 0:
            check(same, f"{tag}: overflow 0 but outputs != unsharded")
    return launches


def phase_sharded_parity(dev) -> None:
    """Every sharded membership tick on the card against the CPU, both
    twins, both transports, every field with its dtype and every output."""
    import torch

    from consul_tpu_torch import MembershipConfig, SparseMembershipConfig
    from consul_tpu_torch.models import membership_init, sparse_membership_init
    from consul_tpu_torch.parallel import (
        mesh_for,
        sharded_membership_plan,
        sharded_membership_round,
        sharded_sparse_membership_round,
        sharded_sparse_plan,
    )
    from consul_tpu_torch.protocol import LAN

    churn = MembershipConfig(n=SMALL_N, loss=0.2, profile=LAN,
                             fail_at=((5, 3), (100, 5), (2000, 8)),
                             leave_at=((77, 10),))
    dense = MembershipConfig(n=512, loss=0.2, profile=LAN,
                             fail_at=((5, 3), (17, 8)), leave_at=((30, 12),))
    for exchange in ("ring", "alltoall"):
        for tag, cfg, init, plan_of, rnd, steps in (
                (f"sharded_sparse_k16_n{SMALL_N}_{exchange}",
                 SparseMembershipConfig(churn, k_slots=16),
                 sparse_membership_init, sharded_sparse_plan,
                 sharded_sparse_membership_round, 30),
                (f"sharded_dense_512_{exchange}", dense, membership_init,
                 sharded_membership_plan, sharded_membership_round, 40)):
            plans = {where: plan_of(cfg, mesh_for(SHARDS), where, (5,),
                                    exchange) for where in ("cpu", dev)}
            _step_parity(tag, init(cfg, device=dev),
                         lambda st, k, c=cfg, r=rnd, p=plans: r(
                             st, k, c, p["cpu" if k.device.type == "cpu"
                                         else dev]),
                         dev, steps, 3)


def stream_ring_shapes() -> list:
    """(path, [D, D, C, budget]) of the streamcast slice's ring paths, from
    the budgets the code computes for the studies that drive them."""
    from consul_tpu_torch.parallel import outbox_budget
    from consul_tpu_torch.sim.scenarios import (
        event100k_config,
        stream100k_config,
    )

    def stream(n):
        cfg = stream100k_config(n, devices=SHARDS)
        lanes = n // SHARDS * cfg.window * cfg.fanout
        return (f"sharded_streamcast_scan(exchange='ring'), n={n}",
                (SHARDS, SHARDS, 3, outbox_budget(lanes, SHARDS)))

    return [
        stream(STREAM_N),
        stream(N_1M),
        ("sharded_broadcast_scan(exchange='ring'), event100k",
         (SHARDS, SHARDS, 1, outbox_budget(
             STREAM_N // SHARDS * event100k_config(SHARDS).fanout, SHARDS))),
    ]


def check_stream_summary(s: dict, window: int, tag: str,
                         delivers: bool = True) -> int:
    """The window's accounting identity ``offered = delivered + quiesced +
    overflow + coalesced + in_flight`` with ``0 <= in_flight <= W``, and
    (where ``delivers``) events delivered; returns ``in_flight``."""
    in_flight = (s["events_offered"] - s["events_delivered"]
                 - s["events_quiesced"] - s["window_overflow"]
                 - s["events_coalesced"])
    check(0 <= in_flight <= window, f"{tag}: {in_flight} in flight")
    check(s["events_offered"] > 0, f"{tag}: nothing offered")
    check(not delivers or s["events_delivered"] > 0,
          f"{tag}: nothing delivered")
    return in_flight


def stream_line(tag: str, card: str, rep, **extra) -> None:
    s = rep.summary()
    row = {"run": tag, "ticks": rep.ticks,
           "rounds_per_sec": rep.rounds_per_sec, "wall_s": rep.wall_s,
           **{k: s[k] for k in (
               "events_offered", "events_delivered", "events_quiesced",
               "events_coalesced", "window_overflow",
               "delivered_events_per_sim_s", "t50_ms_median",
               "t99_ms_median")},
           "shard_overflow": rep.shard_overflow, **extra,
           "device": rep.device, "card": card}
    log("stream " + json.dumps(row))


def phase_stream_presets(dev, card: str) -> None:
    """stream100k (aggregate) per policy, the reference's own 1M config,
    and bench.py's sustained-load curve at 1M per policy with its knee."""
    import torch

    from consul_tpu_torch import StreamcastConfig, run_streamcast
    from consul_tpu_torch.sim.scenarios import stream100k, stream100k_config
    from consul_tpu_torch.streamcast import POLICIES

    window = stream100k_config().window
    for policy in POLICIES:
        s = stream100k(seed=0, policy=policy, device=dev)
        check(s["scenario"] == "stream100k" and s["n"] == STREAM_N
              and s["ticks"] == STREAM_STEPS and s["policy"] == policy,
              "stream100k preset summary")
        flight = check_stream_summary(s, window, f"stream100k {policy}")
        log("stream " + json.dumps({**s, "in_flight": flight, "card": card}))

    for policy in ("uniform", "pipeline"):
        cfg = StreamcastConfig(
            n=N_1M, events=64, chunks=4, window=8, fanout=4,
            chunk_budget=2, rate=0.1, names=16, loss=0.05, done_frac=0.999,
            delivery="aggregate", policy=policy)
        torch.cuda.reset_peak_memory_stats()
        rep = run_streamcast(cfg, STREAM_REF_1M_STEPS, seed=0, warmup=False,
                             device=dev)
        s = rep.summary()
        flight = check_stream_summary(s, cfg.window, f"stream 1m {policy}")
        check(s["t50_ms_median"] is not None, f"stream 1m {policy}: t50")
        stream_line(f"stream_1m_{policy}", card, rep, in_flight=flight,
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    t0 = time.perf_counter()
    knees = {}
    for policy in POLICIES:
        knee = None
        for rate in CURVE_RATES:
            cfg = StreamcastConfig(
                n=N_1M, events=int(max(CURVE_RATES) * CURVE_STEPS * 1.5),
                rate=rate, loss=0.05, delivery="aggregate", policy=policy,
                arrivals="paced", **CURVE_WORK)
            rep = run_streamcast(cfg, CURVE_STEPS, seed=0, warmup=False,
                                 device=dev)
            s = rep.summary()
            check_stream_summary(s, cfg.window, f"curve {policy} {rate}",
                                 delivers=False)
            if knee is None and s["window_overflow"] > 0:
                knee = rate
            stream_line(f"curve_1m_{policy}_rate{rate}", card, rep,
                        offered_events_per_sim_s=s[
                            "offered_events_per_sim_s"])
        knees[policy] = knee
    log(f"curve knees (first rate with window overflow) {json.dumps(knees)}"
        f" in {time.perf_counter() - t0:.1f} s")


def _same_outputs(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def _stream_outputs(rep) -> tuple:
    return (rep.slot_event, rep.slot_birth, rep.done_count, rep.offered,
            rep.delivered, rep.quiesced, rep.window_overflow, rep.coalesced,
            rep.sent)


def _ring_kernels_profiled(run) -> int:
    """Launches of the ring kernel that ``torch.profiler`` sees in ``run()``."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "ring" in e.key.lower())


def phase_stream_sharded(dev, card: str) -> dict:
    """stream100k over 8 logical shards at 100k and 1M (edges, both
    transports): equal to each other and to the unsharded edges run on
    every tick, outbox overflow 0, one ring launch a tick (counted, and
    seen by the profiler); event100k over 8 shards with both transports;
    dev3; probe1k over 8 shards with the ring.  Returns each ring study's
    kernel launches."""
    import torch

    from consul_tpu_torch import mesh_for, run_streamcast
    from consul_tpu_torch.ops import ring_exchange
    from consul_tpu_torch.sim import scenarios
    from consul_tpu_torch.sim.scenarios import (
        dev3,
        event100k,
        probe1k,
        stream100k_config,
    )

    launches = {}
    for n, steps in ((STREAM_N, STREAM_STEPS), (N_1M, STREAM_1M_SHARD_STEPS)):
        cfg = stream100k_config(n, steps, devices=SHARDS)
        tag = f"stream_{n}_edges"
        plain = run_streamcast(cfg, steps, seed=0, warmup=False, device=dev)
        stream_line(f"{tag}_unsharded", card, plain)
        runs = {}
        for exchange in ("ring", "alltoall"):
            torch.cuda.reset_peak_memory_stats()
            ring_exchange.launches = 0
            rep = run_streamcast(cfg, steps, seed=0, warmup=False,
                                 mesh=mesh_for(SHARDS), exchange=exchange,
                                 device=dev)
            n_launch = ring_exchange.launches
            stream_line(f"{tag}_d8_{exchange}", card, rep,
                        ring_launches=n_launch,
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            check(rep.shard_overflow == 0,
                  f"{tag} {exchange}: outbox overflow {rep.shard_overflow}")
            check(n_launch == (steps if exchange == "ring" else 0),
                  f"{tag} {exchange}: ring kernel launched {n_launch} times")
            runs[exchange] = _stream_outputs(rep)
            if exchange == "ring":
                launches[n] = n_launch
        check(_same_outputs(runs["ring"], runs["alltoall"]),
              f"{tag}: ring != alltoall")
        check(_same_outputs(runs["ring"], _stream_outputs(plain)),
              f"{tag}: sharded != unsharded")
        # The exact edges path reaches 99.9% of n slowly (no slot retires
        # inside these depths), so only the accounting is held here.
        check_stream_summary(plain.summary(), cfg.window, tag,
                             delivers=False)
        log(f"{tag}: ring == alltoall == unsharded on every tick, overflow 0")
    cfg = stream100k_config(STREAM_N, 5, devices=SHARDS)
    seen = _ring_kernels_profiled(lambda: run_streamcast(
        cfg, 5, seed=0, warmup=False, mesh=mesh_for(SHARDS),
        exchange="ring", device=dev))
    check(seen == 5, f"profiler saw {seen} ring kernels in 5 ticks")
    log("profiler: one ring kernel a tick on the sharded streamcast twin")

    # The preset returns a summary; its timed run's report is kept from the
    # preset's own call so that the transports are compared on every tick
    # without a third run of the study.
    curves = {}
    preset_run = scenarios.run_broadcast
    for exchange in ("ring", "alltoall"):
        reports = []

        def kept(*args, **kw):
            reports.append(preset_run(*args, **kw))
            return reports[-1]

        ring_exchange.launches = 0
        scenarios.run_broadcast = kept
        try:
            summary = event100k(seed=0, devices=SHARDS, exchange=exchange,
                                device=dev)
        finally:
            scenarios.run_broadcast = preset_run
        n_launch = ring_exchange.launches
        check(summary["shard_overflow"] == 0,
              f"event100k {exchange}: overflow {summary['shard_overflow']}")
        # The preset runs the study twice (warm-up, then timed), as the
        # reference's event100k does.
        check(n_launch == (2 * EVENT_STEPS if exchange == "ring" else 0),
              f"event100k {exchange}: {n_launch} ring launches")
        log("event100k " + json.dumps({**summary, "ring_launches": n_launch,
                                       "card": card}))
        if exchange == "ring":
            launches["event100k"] = n_launch
        curves[exchange] = reports[-1].infected
    check(np.array_equal(curves["ring"], curves["alltoall"]),
          "event100k: ring != alltoall")
    check(int(curves["ring"][-1]) == STREAM_N, "event100k: not all reached")

    small = dev3(seed=0, device=dev)
    check(small["infected_final"] == 3, "dev3: the event missed a node")
    log("dev3 " + json.dumps(small))
    summary = probe1k(seed=0, devices=SHARDS, exchange="ring", device=dev)
    check(summary["all_detected"], "probe1k over 8 shards: a crash missed")
    log("probe1k_d8_ring " + json.dumps({**summary, "card": card}))
    return launches


def phase_stream_parity(dev) -> None:
    """The streamcast slice on the card against the CPU at n=4096, every
    field and output with its dtype on every tick: edges and aggregate for
    all three policies (Poisson with names), the paced stream with a
    backlog, a hotspot and ``size_tail=1.0``, a loss ramp, the sharded
    twin at D=8 with both transports, and ``broadcast_round(alive=)`` at
    both deliveries.  An aggregate tick where a receiver's uniform lies
    between the card's and the CPU's threshold is checked by that rule
    and not compared further."""
    import torch

    from consul_tpu_torch import BroadcastConfig, StreamcastConfig
    from consul_tpu_torch.models import broadcast_init, broadcast_round
    from consul_tpu_torch.ops import PRNGKey, fold_in, owned_uniform, split
    from consul_tpu_torch.parallel import mesh_for, sharded_streamcast_scan
    from consul_tpu_torch.sim import LossRamp, FaultSchedule
    from consul_tpu_torch.streamcast import (
        POLICIES,
        arrival_arrays,
        streamcast_init,
        streamcast_round,
    )
    from consul_tpu_torch.streamcast.model import (
        _SCHED_SALT,
        _p_live,
        admit_stage,
        aggregate_rate,
        round_keys,
        service_stage,
    )

    def thresholds_agree(lam_card, lam_cpu, u_card, u_cpu) -> int:
        lam_card, u_card = lam_card.cpu(), u_card.cpu()
        check(torch.equal(lam_card, lam_cpu), "aggregate rates CUDA != CPU")
        check(torch.equal(u_card, u_cpu), "aggregate uniforms CUDA != CPU")
        thr = [(-torch.expm1(-lam)).cpu() for lam in (lam_card.to(dev),
                                                     lam_cpu)]
        truth = (-torch.expm1(-lam_cpu.double())).float()
        for t in thr:
            gap = (t.view(torch.int32).long()
                   - truth.view(torch.int32).long()).abs()
            check(int(gap.max()) <= 1, "threshold > 1 ulp from float64")
        flip = (u_cpu < thr[0]) != (u_cpu < thr[1])
        lo = torch.minimum(*thr)[flip]
        hi = torch.maximum(*thr)[flip]
        check(bool(((lo <= u_cpu[flip]) & (u_cpu[flip] < hi)).all()),
              "receiver differs outside the threshold band")
        return int(flip.sum())

    def stream_flips(cfg, state, key, sched) -> int:
        rows = torch.arange(cfg.n, dtype=torch.int32)
        per = []
        for where in (dev, "cpu"):
            st = type(state)(*(x.to(where) for x in state))
            k = key.to(where)
            _, k_loss, k_tie, k_chunk = round_keys(k)
            sc = tuple(x.to(where) for x in sched)
            adm = admit_stage(st, cfg, sc, rows.to(where))
            held, serviced, sel, _ = service_stage(cfg, k_tie, k_chunk,
                                                   rows.to(where), adm)
            lam = aggregate_rate(cfg, held, serviced, sel,
                                 _p_live(cfg, st.tick), lambda x: torch.sum(
                                     x, dim=0, dtype=x.dtype))
            per.append((lam, owned_uniform(k_loss, rows.to(where),
                                           (cfg.window, cfg.chunks))))
        return thresholds_agree(per[0][0], per[1][0].cpu(), per[0][1],
                                per[1][1].cpu())

    base = dict(n=SMALL_N, events=40, chunks=4, window=4, fanout=3,
                chunk_budget=2, loss=0.1, done_frac=0.99)
    cases = [(f"stream_{d}_{p}", StreamcastConfig(
        **base, rate=0.5, names=6, delivery=d, policy=p))
        for d in ("edges", "aggregate") for p in POLICIES]
    cases += [
        ("stream_paced_backlog_hotspot_tail", StreamcastConfig(
            **base, rate=0.6, arrivals="paced", backlog=3, hotspot=0.3,
            hotspot_node=7, size_tail=1.0, policy="pipeline")),
        ("stream_loss_ramp", StreamcastConfig(
            **base, rate=0.5, names=6, policy="rarest",
            faults=FaultSchedule(ramps=(LossRamp(((5, 0.3), (15, 0.0))),)))),
    ]
    for tag, cfg in cases:
        key = PRNGKey(3, device=dev)
        scheds = {where: arrival_arrays(cfg, fold_in(key.to(where),
                                                     _SCHED_SALT))
                  for where in ("cpu", dev)}
        for a, b in zip(scheds["cpu"], scheds[dev]):
            check(a.dtype == b.dtype and torch.equal(a, b.cpu()),
                  f"{tag}: arrival schedule CUDA != CPU")
        state = streamcast_init(cfg, device=dev)
        flipped = skipped = 0
        for t in range(STREAM_PARITY_STEPS):
            k = fold_in(key, t)
            before = to_cpu(state)
            want, want_out = streamcast_round(before, k.cpu(), cfg,
                                              scheds["cpu"])
            state, out = streamcast_round(state, k, cfg, scheds[dev])
            if cfg.delivery == "aggregate":
                f = stream_flips(cfg, before, k.cpu(), scheds["cpu"])
                flipped += f
                if f:
                    skipped += 1
                    continue
            diff = state_diff(want, to_cpu(state))
            check(not diff, f"{tag} tick {t}: {diff} CUDA != CPU")
            for i, (a, b) in enumerate(zip(want_out, out)):
                check(a.dtype == b.dtype and torch.equal(a, b.cpu()),
                      f"{tag} tick {t}: output {i} CUDA != CPU")
        check(int(state.delivered) + int(state.coalesced) > 0,
              f"{tag}: nothing delivered or coalesced")
        log(f"{tag}: CUDA == CPU, every field on every tick, "
            f"{STREAM_PARITY_STEPS} ticks at n={SMALL_N}"
            + (f", {flipped} near-threshold receivers ({skipped} ticks)"
               if cfg.delivery == "aggregate" else ""))

    for exchange in ("ring", "alltoall"):
        cfg = StreamcastConfig(**base, rate=0.5, names=6, policy="pipeline")
        got = {}
        for where in ("cpu", dev):
            final, outs = sharded_streamcast_scan(
                streamcast_init(cfg, device=where), PRNGKey(3, device=where),
                cfg, STREAM_PARITY_STEPS, mesh_for(SHARDS, where), exchange)
            got[str(where)] = (to_cpu(final), tuple(o.cpu() for o in outs))
        (f_c, o_c), (f_d, o_d) = got["cpu"], got[str(dev)]
        check(not state_diff(f_c, f_d), f"sharded {exchange}: final state")
        for i, (a, b) in enumerate(zip(o_c, o_d)):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"sharded {exchange}: output {i} CUDA != CPU")
        log(f"sharded streamcast D={SHARDS} {exchange}: CUDA == CPU on every "
            f"tick, {STREAM_PARITY_STEPS} ticks")

    alive = torch.ones(SMALL_N, dtype=torch.bool)
    alive[100:900] = False
    for delivery in ("edges", "aggregate"):
        cfg = BroadcastConfig(n=SMALL_N, fanout=3, loss=0.1,
                              delivery=delivery)
        state = broadcast_init(cfg, origin=0, device=dev)
        key = PRNGKey(5, device=dev)
        flipped = 0
        for t in range(STREAM_PARITY_STEPS):
            k = fold_in(key, t)
            before = to_cpu(state)
            want = broadcast_round(before, k.cpu(), cfg, alive)
            state = broadcast_round(state, k, cfg, alive.to(dev))
            skip = None
            if delivery == "aggregate":
                k_loss = split(k.cpu())[1]
                per = []
                for where in (dev, "cpu"):
                    snd = (before.knows & (before.tx_left > 0)
                           & alive).to(where)
                    lam = (torch.sum(snd, dtype=torch.float32)
                           - snd.to(torch.float32)) * 3.0
                    lam = lam * torch.full((), 0.9, dtype=torch.float32,
                                           device=where)
                    lam = lam / torch.clamp(torch.sum(
                        alive.to(where), dtype=torch.float32) - 1.0, min=1.0)
                    ids = torch.arange(SMALL_N, dtype=torch.int32,
                                       device=where)
                    per.append((lam, owned_uniform(k_loss.to(where), ids)))
                f = thresholds_agree(per[0][0], per[1][0], per[0][1],
                                     per[1][1])
                flipped += f
                if f:
                    continue
            diff = state_diff(want, to_cpu(state), skip)
            check(not diff, f"broadcast alive {delivery} tick {t}: {diff}")
        knows = state.knows.cpu()
        check(not bool(knows[100:900].any()), "a dead node learned the event")
        log(f"broadcast_round(alive=) {delivery}: CUDA == CPU on every tick, "
            f"{STREAM_PARITY_STEPS} ticks at n={SMALL_N}"
            + (f", {flipped} near-threshold receivers"
               if delivery == "aggregate" else ""))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = phase_card()
    ring_err = phase_ring_kernel(dev)
    phase_threefry(dev)
    broadcast_launches = phase_slice(dev, card)
    phase_swim(dev, card)
    phase_lifeguard(dev, card)
    membership_reports = phase_membership(dev, card)
    phase_membership_parity(dev)
    phase_small_parity(dev)
    t7 = time.perf_counter()
    geo_err = phase_geo_kernel(dev)
    latency = phase_geo_latency(dev)
    phase_multidc(dev, card)
    geo_launches = phase_geo(dev, card, latency)
    phase_geo_parity(dev, latency)
    log(f"geo slice phase passed in {time.perf_counter() - t7:.1f} s")
    t8 = time.perf_counter()
    paths = phase_ring_paths(dev, ring_path_shapes(dev))
    study_launches = phase_sharded_membership(dev, card, membership_reports)
    phase_sharded_parity(dev)
    log(f"sharded membership phase passed in {time.perf_counter() - t8:.1f}"
        " s")
    t9 = time.perf_counter()
    stream_paths = phase_ring_paths(dev, stream_ring_shapes())
    stream_launches = phase_stream_sharded(dev, card)
    phase_stream_presets(dev, card)
    phase_stream_parity(dev)
    log(f"streamcast phase passed in {time.perf_counter() - t9:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)
    # Every ring path with the launches of the study that drives it; the
    # largest (the 1M streamcast outbox) heads the line.
    for row, n_launch in zip(paths + stream_paths, (
            broadcast_launches, geo_launches,
            study_launches["membership_dense_16k_d8"],
            study_launches["membership_sparse_100k_cold_d8"],
            study_launches["membership_sparse_1m_cold_d8"],
            stream_launches[STREAM_N], stream_launches[N_1M],
            stream_launches["event100k"])):
        row["launches"] = n_launch
    paths = paths + stream_paths
    head = max(paths, key=lambda row: np.prod(row["shape"]))
    kernel = {
        "name": "ring_exchange", "route": "cuda",
        "source": "consul_tpu_torch/csrc/ring_exchange.cu",
        "replaces": "consul_tpu/ops/ring_exchange.py:67",
        "launches": head["launches"],
        "max_abs_err": max([ring_err, geo_err]
                           + [p["max_abs_err"] for p in paths]),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes", "library_ms": head["library_ms"],
        "paths": paths,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
