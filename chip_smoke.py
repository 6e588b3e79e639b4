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
     Lifeguard A/B at 1M nodes for 300 ticks, Lifeguard on and off; and
     CUDA held against the CPU at n=4096 (SWIM edges and Lifeguard edges
     with every fault primitive field for field on every tick, SWIM
     aggregate by the arrival-threshold rule);
  6. the membership slice: the top-K sparse model (K=64, LAN, loss 0.01,
     subject 42 crashing at tick 5, seed 0) at 100k nodes, a cold
     detection study of 200 ticks checked for first suspicion, the
     suspicion minimum, monotone ``dead_known`` and 99% DEAD, then the
     benchmark's steady-state measure (the converged state, 8 ticks with
     PRNGKey(1) to warm up, 8 timed with PRNGKey(2)); the same at 1M
     nodes with a cold study of 30 ticks and the sorted-row invariant at
     the end; the dense model at 16384 nodes for 15 ticks and the probe1k
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
     fixed arms: the link accounting identity in both); the adaptive arm's
     first 60 ticks over 8 logical shards with both outbox transports,
     equal to the unsharded run on every tick with no outbox overflow and
     one ring launch a tick; and CUDA held against the CPU on every tick, every
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
     (60 ticks), sparse 1M cold (30), dense 16k (15), each with ring ==
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
     edges configuration over 8 shards at 100k (150 ticks) and 1M (30)
     with both transports, equal to each other and to the unsharded run
     on every tick with no outbox overflow, one ring launch a tick
     (counted, and seen by ``torch.profiler``), and the window's
     accounting identity; ``event100k`` over 8 shards with both
     transports (equal, overflow 0), ``dev3`` (``probe1k`` over 8 shards
     runs in phase 12); ``stream100k`` (aggregate,
     150 ticks) for each policy with the accounting identity and events
     delivered; the reference's own 1M study (``tests/test_streamcast.py``:
     4-chunk events, 8 slots, rate 0.1, aggregate, 100 ticks) for the
     uniform and pipeline policies; and CUDA held against
     the CPU at n=4096 on every tick (streamcast edges and aggregate for
     each policy, the paced stream with a backlog, a hotspot and heavy
     tails, a loss ramp, the sharded twin at D=8 with both transports,
     and ``broadcast_round(alive=)`` at both deliveries).
 10. the sweep plane (``consul_tpu_torch.sweep``, ``run_sweep``): U = 1
     equal to the plain scan at n=4096 for swim, lifeguard (every fault
     primitive), broadcast, streamcast and geo, every output and the
     final state; each preset's knobs varying at small n (U = 4 to 6, and
     the faultmatrix preset itself, 27 x 192) run on the card and on the
     CPU with equal outputs and final states; ``seeds4k`` (U = 256, n =
     4096, 60 ticks) with universes/s, rounds/s, the first-suspicion mean
     and p95 (every universe detecting) and the card's kernel launches
     and busy share a tick at U = 256 against U = 1 (``torch.profiler``);
     ``tuning`` (16 x 1024) with its (false_dead_mean, detect_t90_ms)
     frontier; ``faultmatrix``; ``wanbrownout`` (4 rungs x 2048, 160
     ticks) with the accounting identity in every universe; ``streamadv``
     (uniform, 4096); and bench.py's 1M sustained-load curve in its swept
     form (the paced stream, W=7, E=4, fanout 4, budget 4, done_frac 0.99,
     rates 0.1 / 0.3 / 0.6 / 1.2 as one U = 4 sweep of 50 ticks per
     policy, bench.py's 150 cut for time) with its points, knee,
     rounds/s, device ms a tick and peak
     memory.
 11. the sweep x shard composition and the membership sweeps: the ring
     kernel at the composed outbox ``[4, 8, 8, 5, 40062]`` (U = 4
     universes of the sparse 100k twin's planes, one ``(C, U, D, pitch)``
     buffer at offsets 0 and 1) bit for bit against its plain version and
     timed as in phase 8; bench.py's composed real run at full width, the
     sparse 100k cold study's loss ladder 0.01-0.04 as one U = 4 sweep of
     60 ticks, unsharded (``sweep_sparse_100k_u4``) and over 8 logical
     shards with both transports (``sweepshard_sparse_100k_u4_d8_ring`` /
     ``_alltoall``): ring == alltoall on every tick and in the final
     state, == the unsharded sweep in every universe whose overflows are
     0, the detection invariants in every universe, one ring launch a
     tick (counted, and seen by ``torch.profiler``), 0 host syncs a tick,
     launches and device ms a tick, peak memory, beside the plain sparse
     100k study's rounds/s; ``sweep_dense_16k_u2`` (U = 2, 10 ticks) with
     its peak memory; and the five composed families (broadcast, dense,
     sparse, streamcast, geo) at U = 2 x D = 2 with a knob varying, both
     transports, with the telemetry trace on: card == CPU on every tick's
     outputs and trace, the final state and the overflow.
 12. the telemetry plane and the command line: ``run_scenario(...,
     telemetry=True)`` on the presets at their published sizes
     (``event100k`` and ``probe1k`` over 8 logical shards with each
     transport, ``stream100k`` over 8 shards with the ring, ``geo100k``,
     ``dev3``): every output equal to the same preset without telemetry
     (phase 9's runs, phase 6's unsharded probe1k, whose outputs the dense
     twin equals with no overflow, all ten crashes detected; geo100k's twin
     here), the ring trace equal to the
     alltoall trace, one ring launch a tick (counted, and seen by
     ``torch.profiler``), the bridged snapshot and the columns that restate
     an output (``consul.broadcast.infected``, the geo link census, the
     membership cells, the stream's counters) equal to it, host syncs
     unchanged; the 1M SWIM headline (60 ticks) with the trace on and off,
     outputs and final state equal and no more host synchronisations
     (``torch.cuda.set_sync_debug_mode``); the seven families at n=4096
     (dense 512) with the trace, card == CPU; and ``python -m
     consul_tpu_torch.cli sim event100k --devices 8 --exchange ring
     --metrics`` in a process of its own, printing run_scenario's JSON.
 13. the sim↔host bridge (``consul_tpu_torch.net``) and the multichip
     datapoint: a scripted host joins a 10,000-member pool on the card
     (the FAST profile, member 4242 crashing at tick 3, seed 0) by a
     push/pull through ``sim://17`` whose answer holds all 10,000
     snapshots, announces itself, fires one user event and acks every
     probe while the pool runs in blocks of 5 ticks (at most 60) until a
     DEAD message about ``sim-4242`` reaches it; then event coverage and
     host awareness above 0.9 and no missed ping, with ticks/s, host
     syncs a tick, device ms and launches a tick (``torch.profiler``, 2
     more ticks) and the peak memory; the same bar with the port's own
     ``Cluster`` (serf over ``Memberlist``), no ERROR logged, and beside
     it the consistency plane: its view after the join and again after
     MEMBER_FAILED folded into a catalog replicated by three Raft servers
     (``_Catalog``: the port's ``RaftNode``, ``ConsulFSM``,
     ``StateStore``), every server's catalog equal to the view
     (``sim-4242`` critical), a fourth server caught up through
     InstallSnapshot, and the leader's snapshot through an archive and a
     replicated restore onto every server (the ``consistency`` line:
     entries and seconds a fold, leader changes, the final term, the
     snapshot indexes, the archive's bytes and seconds); the bridge at
     n=512 on the card and
     on the CPU, driven by one scripted host for 40 ticks (SUSPECT, DEAD
     and duplicate injections, a push/pull with a stale and an advancing
     entry, two user events, an unanswered probe), every state field,
     infection and delivered packet equal on every tick; and
     ``parallel.shard.main`` at phase 4's sharded 1M broadcast (8 shards,
     30 ticks, both transports): ``infected_final`` equal to phase 4's,
     overflow 0, the exchange and merge walls per transport.
 14. the program registry (``consul_tpu_torch.sim.registry``) and the
     profile harness (``obs/profile.py``), after the earlier phases'
     tensors are freed (under 1 GiB left allocated): the registry's 94
     small and 14 big programs, every big program's ``state_bytes()``
     printed before anything runs; ``profile_registry(big,
     execute=True)``: each of the 13 executable programs (1M-node
     broadcast, SWIM, Lifeguard, streamcast, geo, sparse; dense 16k; the
     sharded twins at 1M nodes a shard over 2 logical shards; the sparse
     100k sweep at U = 1 and 8) run from its own initial state and
     ``PRNGKey(0)``: a first call of its first 10 ticks under
     ``torch.profiler`` (launches and device ms a tick, the launches held
     within a band of the counts the whole studies gave; a program whose
     window lost events is profiled once more) and a timed call
     of its first 10 ticks (the earlier phases run these studies whole;
     execute wall, peak memory, the arguments unchanged), each held under
     the memory gate (90% of the
     card); ``sparse@10m`` sized only, allocating nothing; the 22
     ``EQUIV_PAIRS`` rungs walked on the card, bit for bit, the five
     ``D2/ring`` programs launching the ring kernel once a tick (counted,
     and seen by the profiler) at their ``[2, 2, C, budget]`` shapes,
     which the ring kernel is then held and timed at as in phase 8; and
     ``python -m consul_tpu_torch.cli profile --which small --entry
     sharded_broadcast@small/D2 --execute --format json --perfetto DIR``
     (three programs: plain, ring, trace) in a process
     of its own beside the ladder: exit 0, every row executed, a Chrome
     trace holding CUDA kernel events.

The next-to-last line of output is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
where CUDA is not available or the port is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
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
# degraded1m's own depth: Lifeguard's lower false-positive rate shows only
# past tick 160, where bench.py cuts the study (both arms count the same
# false positives up to there).
LIFEGUARD_STEPS = 300
SMALL_N = 4096
# The sparse cold study at 100k: LAN's suspicion minimum is 100 ticks
# there (4 * log10(1e5) * 1 s at 200 ms a tick) and its maximum 600.  The
# first suspicion is due within 10 probe intervals (50 ticks) of the crash
# at tick 5, suspicions confirmed twice expire after the minimum, and the
# DEAD news reaches the rest within a few dozen ticks: 5 + 50 + 100 + 45
# = 200 ticks.
SPARSE_N = 100_000
SPARSE_COLD_100K_STEPS = 200
# The first suspicion (tick 10), not the DEAD wave; also the twin's depth.
SPARSE_COLD_1M_STEPS = 30
# The 100k twin over 8 shards (phase 8): the first suspicion (tick 10) is
# inside, the first DEAD (tick 110, in the unsharded 200-tick study) not;
# phase 11 runs the same twin for as long in each of its four universes.
SPARSE_SHARD_100K_STEPS = 60
STEADY_STEPS = 8           # bench.py's steps for the steady-state measure
DENSE_N = 16384            # the reference's dense@16k registry program
DENSE_STEPS = 15            # the first suspicion comes at tick 10
MULTIDC_STEPS = 120        # multidc1m's depth
GEO_STEPS = 160            # bench.py's geo section
GEO_SHARD_STEPS = 60       # the twin over 8 shards, inside the brownout
GEO_RING_SHAPE = (8, 8, 2, 64)
GEO_PARITY_STEPS = 60
VIVALDI_PARITY_ROUNDS = 50
STREAM_N = 100_000         # stream100k's preset size
STREAM_STEPS = 150         # stream100k's preset depth
STREAM_1M_SHARD_STEPS = 30
STREAM_REF_1M_STEPS = 100  # tests/test_streamcast.py:966-992
EVENT_STEPS = 100          # event100k's depth
# bench.py's sustained-load curve (_streaming_curve, _STREAM_WORK): the
# paced stream at n=1M, one U = 4 sweep per policy (phase 10).
CURVE_RATES = (0.1, 0.3, 0.6, 1.2)
CURVE_STEPS = 50           # bench.py's 150, cut for the smoke's time
CURVE_WORK = dict(window=7, chunks=4, fanout=4, chunk_budget=4,
                  done_frac=0.99)
STREAM_PARITY_STEPS = 30
# The knees of the per-rate 1M curve (PR 6's phase 9: one run_streamcast
# per rate and policy), printed beside the swept curve's.
PER_RATE_KNEES = {"uniform": 0.3, "pipeline": 0.6, "rarest": 0.6}
SWEEP_PARITY_N = 512
SWEEP_PROFILE_TICKS = 5

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


# The smoke's start, set by main(): every log line leads with the seconds
# since then, so a run's tail shows where its time went.
_T0 = time.perf_counter()
# Past this many seconds the tracebacks of every thread go to stderr, so a
# run cut at its time limit shows where it was.
WATCHDOG_S = 1100.0


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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


def phase_slice(dev, card: str) -> tuple:
    """The slice's studies; returns the ring kernel's launches in the
    main-path run (8 shards, ring transport) and that run's final
    ``infected``."""
    import torch

    from consul_tpu_torch import BroadcastConfig, mesh_for, run_broadcast
    from consul_tpu_torch.ops import ring_exchange
    from consul_tpu_torch.protocol import LAN

    def drive(cfg, steps, **kw):
        # A few untimed ticks warm the allocator (eager PyTorch compiles
        # nothing), then the counted and timed pass.
        run_broadcast(cfg, 3, seed=0, warmup=False, device=dev, **kw)
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
    return launches, int(ring.infected[-1])


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
    # tests/test_lifeguard.py's acceptance claim, at 1M.
    on, off = reps[True], reps[False]
    log(f"lifeguard 1M: fp_rate {on.fp_rate} on, {off.fp_rate} off; flaps "
        f"{on.flap_count} on, {off.flap_count} off")
    check(on.fp_total > 0, "lifeguard 1M: the faulted universe has no FPs")
    check(on.fp_rate < off.fp_rate,
          f"lifeguard 1M: FP rate {on.fp_rate} on, not below {off.fp_rate}")
    check(on.flap_count <= off.flap_count,
          f"lifeguard 1M: {on.flap_count} flaps on > {off.flap_count} off")


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
    with kept_reports("run_membership") as (kept, _):
        summary = probe1k(seed=0, device=dev)
    reports["probe1k"] = (kept[-1], None)
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

    def drive(cfg, tag, steps=GEO_STEPS, **kw):
        run_geo(cfg, 3, seed=0, warmup=False, device=dev, **kw)
        torch.cuda.reset_peak_memory_stats()
        ring_exchange.launches = 0
        syncs = host_cond.syncs
        rep = run_geo(cfg, steps, seed=0, warmup=False, device=dev, **kw)
        launches = ring_exchange.launches
        s = rep.summary()
        row = {"run": tag, "ticks": steps,
               "rounds_per_sec": rep.rounds_per_sec, "wall_s": rep.wall_s,
               **{k: s[k] for k in (
                   "t50_ms", "t99_ms", "segment_t99_ms",
                   "wan_admitted_bytes", "wan_overflow_units",
                   "wan_wasted_units", "accounting_ok")},
               "shard_overflow": rep.shard_overflow,
               "ring_launches": launches,
               "host_syncs_per_tick": (host_cond.syncs - syncs) / steps,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "device": rep.device, "card": card}
        log("study " + json.dumps(row))
        check(rep.per_segment.shape == (steps, 8)
              and rep.offered.shape == (steps, 64), f"{tag}: shapes")
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

    # The twins run the first GEO_SHARD_STEPS ticks: a trajectory is
    # prefix-stable, so they compare with the unsharded run's prefix.
    unsharded = arms["adaptive"][0]
    ring_launches = None
    for exchange in ("ring", "alltoall"):
        rep, _, launches = drive(geo_ab_config(latency),
                                 f"geo_1m_adaptive_d8_{exchange}",
                                 steps=GEO_SHARD_STEPS,
                                 mesh=mesh_for(SHARDS), exchange=exchange)
        for f in GEO_FIELDS:
            check(np.array_equal(getattr(rep, f),
                                 getattr(unsharded, f)[:GEO_SHARD_STEPS]),
                  f"geo d8 {exchange}: {f} != unsharded")
        check(rep.shard_overflow == 0, f"geo d8 {exchange}: outbox overflow")
        if exchange == "ring":
            check(launches == GEO_SHARD_STEPS,
                  f"ring kernel launched {launches} times, want "
                  f"{GEO_SHARD_STEPS}")
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
    overflows are 0.  Returns each ring study's kernel launches, and the
    sparse 100k ring run's host outputs, final state on the host and
    overflow (phase 11's composed ladder holds its universe 0 to them)."""
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
         sparse_cfg(SPARSE_N), SPARSE_SHARD_100K_STEPS),
        ("membership_sparse_1m_cold_d8", "membership_sparse_1m_cold",
         sparse_cfg(N_1M), SPARSE_COLD_1M_STEPS),
        ("membership_dense_16k_d8", "membership_dense_16k",
         sharded_dense_cfg(), DENSE_STEPS),
    )
    launches = {}
    twin = None
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
        if tag == "membership_sparse_100k_cold_d8":
            twin = (to_cpu(f_ring), o_ring, ov_ring)
        del runs, f_ring, f_a2a
        plain, plain_ov = unsharded[plain_tag]
        fields = ("suspecting", "dead_known", "suspect_cells",
                  "known_members")
        # Trajectories are prefix-stable and the overflow counter only
        # grows, so a shorter sharded run compares with the unsharded
        # run's prefix.
        same = all(np.array_equal(o, getattr(plain, f)[:len(o)])
                   for o, f in zip(o_ring, fields))
        log(f"{tag}: ring == alltoall every tick and in the final state; "
            f"overflow sharded {ov_ring}, unsharded {plain_ov}; per-tick "
            f"outputs {'equal to' if same else 'differ from'} the unsharded "
            "run")
        if ov_ring == 0 and plain_ov == 0:
            check(same, f"{tag}: overflow 0 but outputs != unsharded")
    return launches, twin


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
    """stream100k (aggregate) per policy and the reference's own 1M
    config.  bench.py's sustained-load curve at 1M runs in its swept form
    in phase 10."""
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


@contextlib.contextmanager
def kept_reports(*names):
    """Keep the report, and the config, of every call a preset makes to the
    ``sim.scenarios`` entry points ``names`` (``run_broadcast``, ...), in
    call order: the presets return summaries, and the per-tick outputs are
    compared without another run of the study.  Yields ``(reports,
    configs)``."""
    from consul_tpu_torch.sim import scenarios

    reports, configs = [], []
    real = {name: getattr(scenarios, name) for name in names}

    def keeper(fn):
        def run(cfg, *args, **kw):
            reports.append(fn(cfg, *args, **kw))
            configs.append(cfg)
            return reports[-1]
        return run

    for name, fn in real.items():
        setattr(scenarios, name, keeper(fn))
    try:
        yield reports, configs
    finally:
        for name, fn in real.items():
            setattr(scenarios, name, fn)


def phase_stream_sharded(dev, card: str) -> tuple:
    """stream100k over 8 logical shards at 100k and 1M (edges, both
    transports): equal to each other and to the unsharded edges run on
    every tick, outbox overflow 0, one ring launch a tick (counted, and
    seen by the profiler); event100k over 8 shards with both transports;
    dev3.  (probe1k over 8 shards runs in phase 12, with the trace.)
    Returns each ring study's kernel launches, and the reports of the
    preset runs (telemetry off) that phase 12 holds its telemetry runs
    against."""
    import torch

    from consul_tpu_torch import mesh_for, run_streamcast
    from consul_tpu_torch.ops import ring_exchange
    from consul_tpu_torch.sim.scenarios import (
        dev3,
        event100k,
        stream100k_config,
    )

    launches, off = {}, {}
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
                if n == STREAM_N:   # stream100k(devices=8, exchange="ring")
                    off["stream100k_d8_ring"] = rep
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
    for exchange in ("ring", "alltoall"):
        ring_exchange.launches = 0
        with kept_reports("run_broadcast") as (reports, _):
            summary = event100k(seed=0, devices=SHARDS, exchange=exchange,
                                device=dev)
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
        off[f"event100k_d8_{exchange}"] = reports[-1]
    check(np.array_equal(curves["ring"], curves["alltoall"]),
          "event100k: ring != alltoall")
    check(int(curves["ring"][-1]) == STREAM_N, "event100k: not all reached")

    with kept_reports("run_broadcast") as (reports, _):
        small = dev3(seed=0, device=dev)
    off["dev3"] = reports[-1]
    check(small["infected_final"] == 3, "dev3: the event missed a node")
    log("dev3 " + json.dumps(small))
    return launches, off


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


def _sweep_leaves(tree) -> list:
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree.cpu()]
    return [x.cpu() for x in tree]


def _leaves_equal(want: list, got: list) -> str:
    """'' where two lists of CPU tensors agree leaf for leaf, dtype
    included, else the index of the first that differs."""
    if len(want) != len(got):
        return "leaf count"
    for i, (x, y) in enumerate(zip(want, got)):
        if (x.dtype != y.dtype or x.shape != y.shape
                or not np.array_equal(x.numpy(), y.numpy())):
            return f"leaf {i}"
    return ""


def _profile_ticks(run, ticks: int) -> dict:
    """Kernel launches and kernel time a tick that ``torch.profiler`` sees
    in ``run()`` (copies and fills aside), and the share of the run's
    wall time the card was busy.  Only the device is traced: with the
    host traced too, the ``record_function`` ranges of the sort-merge
    would count as device events, and the host's tracing slows the run."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))]
    launches = sum(e.count for e in cuda)
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in cuda)
    return {"launches_per_tick": launches / ticks,
            "device_ms_per_tick": dev_us / 1000.0 / ticks,
            "busy_share": dev_us / 1e6 / wall if wall > 0 else None,
            "kernels": {e.key: e.count for e in cuda}}


def phase_sweep(dev, card: str) -> None:
    """The sweep plane: U = 1 equals the plain scan; the card equals the
    CPU with each preset's knobs varying; the presets at their sizes; the
    1M sustained-load curve in its swept form."""
    import torch

    from consul_tpu_torch import (
        BroadcastConfig,
        GeoConfig,
        LifeguardConfig,
        StreamcastConfig,
        SwimConfig,
    )
    from consul_tpu_torch.ops import PRNGKey
    from consul_tpu_torch.sim import (
        DegradedSet,
        FaultSchedule,
        LossRamp,
        Partition,
        engine,
        run_sweep,
    )
    from consul_tpu_torch.streamcast import POLICIES
    from consul_tpu_torch.sweep import (
        Universe,
        make_preset,
        make_sweep,
        presets,
        stacked_init,
        stream_points,
    )

    t_phase = time.perf_counter()
    faults = FaultSchedule(
        ramps=(LossRamp(((10, 0.2), (30, 0.0))),),
        degraded=(DegradedSet(frac=0.1, drop=0.4, late=0.2, seed=2),),
        partitions=(Partition(start=15, heal=35, severity=0.6),))
    plain = {
        "swim": (SwimConfig(n=SMALL_N, subject=7, loss=0.05), 20,
                 engine.swim_scan),
        "lifeguard": (LifeguardConfig(n=SMALL_N, subject=7, loss=0.1,
                                      subject_alive=True, ack_late=0.05,
                                      faults=faults), 20,
                      engine.lifeguard_scan),
        "broadcast": (BroadcastConfig(n=SMALL_N, fanout=3, loss=0.05), 20,
                      engine.broadcast_scan),
        "streamcast": (StreamcastConfig(
            n=SMALL_N, events=40, chunks=4, window=8, fanout=4,
            chunk_budget=2, rate=0.3, loss=0.05, delivery="aggregate",
            policy="pipeline"), 20, engine.streamcast_scan),
        "geo": (GeoConfig(n=SMALL_N, segments=8, bridges_per_segment=3,
                          events=8), 20, engine.geo_scan),
    }
    for entrypoint, (cfg, steps, scan) in plain.items():
        uni = Universe(entrypoint=entrypoint, cfg=cfg, steps=steps,
                       seeds=(0,))
        init = stacked_init(uni, dev)
        s_final, s_outs = make_sweep(entrypoint, 1)(
            init, uni.keys(dev), (), cfg, steps)
        p_final, p_outs = scan(type(init)(*(x[0].clone() for x in init)),
                               PRNGKey(0, device=dev), cfg, steps)
        diff = _leaves_equal([x[0] for x in _sweep_leaves(s_outs)],
                             _sweep_leaves(p_outs))
        check(not diff, f"sweep {entrypoint} U=1 outputs != plain: {diff}")
        diff = _leaves_equal([x[0] for x in _sweep_leaves(s_final)],
                             _sweep_leaves(p_final))
        check(not diff, f"sweep {entrypoint} U=1 state != plain: {diff}")
        log(f"sweep {entrypoint}: U=1 == plain scan, every output and the "
            f"final state, {steps} ticks at n={SMALL_N}")

    log(f"sweep U=1 == plain in {time.perf_counter() - t_phase:.1f} s")
    t_part = time.perf_counter()
    small = SWEEP_PARITY_N
    # One Vivaldi derivation on the card (300 rounds) for both sizes: the
    # latencies depend on the segments and the seed, not on n.
    brownout = presets.wan_brownout(device=dev)
    cases = {
        "seeds4k": presets.seed_sweep(universes=6, n=small, steps=30),
        "tuning": presets.tuning_grid(n=small, fanouts=(2, 4),
                                      scales=(0.15, 1.5), fail_at=20,
                                      steps=40),
        "faultmatrix": presets.fault_matrix(steps=30),
        "streamadv": presets.stream_adversarial_ladder(n=small, steps=30),
        "wanbrownout": dataclasses.replace(
            brownout, cfg=dataclasses.replace(brownout.cfg, n=small),
            steps=40),
    }
    # The policies' rounds are held card == CPU in phase 9; here the
    # swept rate on the paced (uniform) and Poisson edges streams.
    cases["streamload_uniform"] = presets.stream_load_curve(
        n=small, steps=30, rates=CURVE_RATES, policy="uniform",
        arrivals="paced", **CURVE_WORK)
    edges = presets.stream_load_curve(n=small, steps=30, policy="pipeline")
    cases["streamload_edges"] = Universe(
        entrypoint="streamcast", cfg=StreamcastConfig(**{
            **{f: getattr(edges.cfg, f) for f in (
                "n", "events", "chunks", "window", "fanout", "chunk_budget",
                "rate", "loss", "policy", "done_frac")},
            "delivery": "edges"}),
        steps=edges.steps, seeds=edges.seeds, knobs=edges.knobs,
        values=edges.values)
    for tag, uni in cases.items():
        got = []
        for where in (dev, torch.device("cpu")):
            final, outs = make_sweep(uni.entrypoint, uni.U)(
                stacked_init(uni, where), uni.keys(where),
                uni.knob_arrays(where), uni.cfg, uni.steps, uni.knobs)
            got.append((_sweep_leaves(outs), _sweep_leaves(final)))
        diff = _leaves_equal(got[1][0], got[0][0])
        check(not diff, f"sweep {tag}: card outputs != CPU: {diff}")
        diff = _leaves_equal(got[1][1], got[0][1])
        check(not diff, f"sweep {tag}: card state != CPU: {diff}")
        log(f"sweep {tag}: card == CPU, every output and the final state, "
            f"U={uni.U} knobs={list(uni.knobs)} {uni.steps} ticks at "
            f"n={uni.cfg.n}")
    log(f"sweep card == CPU in {time.perf_counter() - t_part:.1f} s")

    def sweep_line(tag: str, rep, **extra) -> None:
        s = rep.summary()
        log("sweep " + json.dumps({
            "run": tag, "universes": rep.U, "n": rep.n, "ticks": rep.steps,
            "wall_s": rep.wall_s, "universes_per_sec": rep.universes_per_sec,
            "rounds_per_sec": rep.rounds_per_sec, **extra,
            "metrics": s["metrics"], "device": rep.device, "card": card}))

    # seeds4k: the reference's acceptance sweep, and the launches a tick.
    t_part = time.perf_counter()
    uni = make_preset("seeds4k")
    # A few untimed ticks at the same U warm the allocator; then timed.
    run_sweep(dataclasses.replace(uni, steps=3), warmup=False, device=dev)
    rep = run_sweep(uni, warmup=False, device=dev)
    first = rep.metrics["first_suspect_ms"]
    check(not np.isnan(first).any(),
          f"seeds4k: {int(np.isnan(first).sum())} universes never detected")
    prof = {}
    for U in (1, uni.U):
        short = Universe(entrypoint="swim", cfg=uni.cfg,
                         steps=SWEEP_PROFILE_TICKS, split_from=0,
                         universes=U)
        state, keys = stacked_init(short, dev), short.keys(dev)
        sweep = make_sweep("swim", U)
        sweep(stacked_init(short, dev), keys, (), short.cfg, short.steps)
        prof[U] = _profile_ticks(
            lambda: sweep(state, keys, (), short.cfg, short.steps),
            SWEEP_PROFILE_TICKS)
    # A loop over universes would multiply the launches by U; the
    # profiler's count of a 5-tick window has varied between calls by up
    # to 2 launches a tick of 3,080, so the bound is 1%.
    kernels = [prof[U].pop("kernels") for U in (1, uni.U)]
    moved = {name[:60]: (kernels[0].get(name, 0), kernels[1].get(name, 0))
             for name in set(kernels[0]) | set(kernels[1])
             if kernels[0].get(name, 0) != kernels[1].get(name, 0)}
    log(f"seeds4k kernels whose count differs at U=1 / U={uni.U}: "
        f"{json.dumps(moved)}")
    check(prof[uni.U]["launches_per_tick"]
          <= 1.01 * prof[1]["launches_per_tick"],
          f"seeds4k launches a tick grow with U: {prof}")
    sweep_line("seeds4k", rep,
               first_suspect_ms_mean=float(np.mean(first)),
               first_suspect_ms_p95=float(np.percentile(first, 95)),
               profile_u1=prof[1], profile_u256=prof[uni.U])

    rep = run_sweep(make_preset("tuning"), warmup=False, device=dev)
    front = rep.frontier("false_dead_mean", "detect_t90_ms")
    check(len(front) > 0, "tuning: empty frontier")
    sweep_line("tuning", rep, frontier=front)

    rep = run_sweep(make_preset("faultmatrix"), warmup=False, device=dev)
    check(len(np.unique(rep.metrics["fp_total"])) > 1,
          "faultmatrix: every rung gave the same false positives")
    sweep_line("faultmatrix", rep)

    rep = run_sweep(brownout, warmup=False, device=dev)
    ok = rep.accounting_ok()
    check(bool(ok.all()), f"wanbrownout: accounting identity broken {ok}")
    sweep_line("wanbrownout", rep, accounting_ok=ok.tolist(),
               t99_ms=rep.metrics["t99_ms"].tolist(),
               wan_admitted_bytes=rep.metrics["wan_admitted_bytes"].tolist())

    uni = make_preset("streamadv")
    rep = run_sweep(uni, warmup=False, device=dev)
    for u in range(uni.U):
        check_stream_summary({k: rep.metrics[k][u] for k in (
            "events_offered", "events_delivered", "events_quiesced",
            "window_overflow", "events_coalesced")}, uni.cfg.window,
            f"streamadv rung {u}", delivers=False)
    sweep_line("streamadv_uniform", rep)
    log(f"sweep presets in {time.perf_counter() - t_part:.1f} s")

    # bench.py's 1M sustained-load curve: one U = 4 sweep per policy.
    t_curve = time.perf_counter()
    knees = {}
    for policy in POLICIES:
        uni = presets.stream_load_curve(
            n=N_1M, rates=CURVE_RATES, steps=CURVE_STEPS, policy=policy,
            arrivals="paced", **CURVE_WORK)
        torch.cuda.reset_peak_memory_stats()
        rep = run_sweep(uni, warmup=False, device=dev)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for u in range(uni.U):
            check_stream_summary({k: rep.metrics[k][u] for k in (
                "events_offered", "events_delivered", "events_quiesced",
                "window_overflow", "events_coalesced")}, uni.cfg.window,
                f"curve {policy} rate {CURVE_RATES[u]}", delivers=False)
        points, knee = stream_points(rep, CURVE_RATES)
        knees[policy] = knee
        short = dataclasses.replace(uni, steps=1)
        state, keys = stacked_init(short, dev), short.keys(dev)
        vals = short.knob_arrays(dev)
        sweep = make_sweep("streamcast", uni.U)
        prof = _profile_ticks(lambda: sweep(state, keys, vals, short.cfg,
                                            short.steps, short.knobs),
                              short.steps)
        prof.pop("kernels")
        log("sweep " + json.dumps({
            "run": f"curve_1m_{policy}", "universes": rep.U, "n": rep.n,
            "ticks": rep.steps, "wall_s": rep.wall_s,
            "rounds_per_sec": rep.rounds_per_sec,
            "wall_ms_per_tick": 1000.0 * rep.wall_s / rep.steps,
            "profile": prof, "peak_gib": peak, "knee_rate": knee,
            "per_rate_knee": PER_RATE_KNEES[policy], "points": points,
            "device": rep.device, "card": card}))
    log(f"curve knees swept {json.dumps(knees)} per-rate "
        f"{json.dumps(PER_RATE_KNEES)} in "
        f"{time.perf_counter() - t_curve:.1f} s")
    log(f"sweep phase passed in {time.perf_counter() - t_phase:.1f} s")


# Phase 11: the sweep x shard composition and the membership sweeps.
# bench.py's composed real run (consul_tpu/sweep/compose.py:115-123) with
# the cold study's crash tick: the loss ladder as U = 4 universes; 120
# ticks hold the first suspicion and the first DEAD (due at tick 110).
# Universe 0 (loss 0.01, seed 0) is phase 8's sharded twin, tick for tick.
SWEEPSHARD_LOSSES = (0.01, 0.02, 0.03, 0.04)
SWEEPSHARD_STEPS = SPARSE_SHARD_100K_STEPS
SWEEP_DENSE_LOSSES = (0.01, 0.02)   # U = 2: a plain 16k study peaks at 25 GiB
SWEEP_DENSE_STEPS = 10
SWEEPSHARD_SMALL_STEPS = 12
SWEEPSHARD_PROFILE_TICKS = 3


def sweepshard_universe(cfg, steps: int, losses: tuple, track=(42,)):
    from consul_tpu_torch.sweep import Universe

    sparse = hasattr(cfg, "base")
    return Universe(entrypoint="sparse" if sparse else "membership", cfg=cfg,
                    steps=steps, seeds=(0,) * len(losses), track=track,
                    knobs=("base.loss" if sparse else "loss",),
                    values=(losses,))


def phase_ring_universe(dev, path: str, shape) -> dict:
    """The ring kernel at a composed sweep's outbox ``[U, D, D, C,
    budget]``, fed as ``pack_outbox`` leaves the planes (one ``(C, U, D,
    pitch)`` buffer) at offsets 0 and 1: bit for bit against its plain
    version, then timed as in phase 8 (the whole exchange on both
    transports, the kernel alone, the plain version, and
    ``transpose(1, 2).contiguous()`` of the stacked box as the library
    call)."""
    import torch

    from consul_tpu_torch.ops import (
        ring_exchange_planes,
        ring_exchange_planes_plain,
    )
    from consul_tpu_torch.parallel import exchange_outbox, outbox_pitch

    u, d, _, c, budget = shape
    pitch = outbox_pitch(d, budget)
    gen = torch.Generator(device=dev).manual_seed(11)
    max_err = 0
    for offset in (1, 0):
        flat = torch.randint(-2 ** 31, 2 ** 31 - 1,
                             (c * u * d * pitch + offset,), generator=gen,
                             dtype=torch.int32, device=dev)
        planes = flat[offset:].view(c, u, d, pitch)[..., :d * budget] \
            .unflatten(-1, (d, budget)).unbind(0)
        got = ring_exchange_planes(planes)
        want = ring_exchange_planes_plain(planes)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            max_err = max(max_err, int((g.to(torch.int64) - w.to(torch.int64))
                                       .abs().max()))
            check(g.shape == (u, d, d * budget) and torch.equal(g, w),
                  f"ring kernel != plain at {list(shape)} offset {offset}")
        del got, want
    box = torch.stack(planes, dim=3).contiguous()
    row = {
        "path": path, "shape": list(shape), "max_abs_err": max_err,
        "ms": cuda_ms(lambda: exchange_outbox(planes, "ring")),
        "alltoall_ms": cuda_ms(lambda: exchange_outbox(planes, "alltoall")),
        "busy_ms": device_ms(lambda: ring_exchange_planes(planes)),
        "plain_ms": cuda_ms(lambda: ring_exchange_planes_plain(planes), 10, 3),
        "library_ms": cuda_ms(lambda: box.transpose(1, 2).contiguous()),
        "bound_ms": 2 * c * u * d * d * budget * 4 / PEAK_BYTES_PER_S * 1e3,
    }
    del box, planes, flat
    log("ring path " + json.dumps(row))
    return row


def _membership_report_of(uni, outs, u: int, wall: float):
    """Universe ``u`` of a membership sweep's host outputs as a report."""
    from consul_tpu_torch.sim.metrics import MembershipReport

    base = uni.cfg.base if hasattr(uni.cfg, "base") else uni.cfg
    return MembershipReport(
        n=base.n, ticks=uni.steps, tick_ms=base.profile.gossip_interval_ms,
        probe_interval_ms=base.profile.probe_interval_ms, track=uni.track,
        suspecting=outs[0][u], dead_known=outs[1][u],
        suspect_cells=outs[2][u], known_members=outs[3][u], wall_s=wall)


def _run_membership_sweep(uni, dev, mesh=None, exchange="alltoall"):
    """One membership sweep on the card, fenced: ``(final, host outs,
    overflow[U] or None, wall s, host syncs a tick, peak GiB)``."""
    import torch

    from consul_tpu_torch.ops import host_cond
    from consul_tpu_torch.sweep import make_sweep, stacked_init

    sweep = make_sweep(uni.entrypoint, uni.U, False, mesh, exchange)
    state, keys = stacked_init(uni, dev), uni.keys(dev)
    vals = uni.knob_arrays(dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats()
    syncs = host_cond.syncs
    t0 = time.perf_counter()
    out = sweep(state, keys, vals, uni.cfg, uni.steps, uni.knobs, uni.track)
    torch.cuda.synchronize(dev)
    outs = tuple(o.cpu().numpy() for o in out[1])
    ov = out[2].cpu().numpy() if mesh is not None else None
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return (out[0], outs, ov, wall, (host_cond.syncs - syncs) / uni.steps,
            peak)


def _profile_sweep(uni, dev, ticks: int, mesh=None, exchange="alltoall"):
    """Launches and device ms a tick of a ``ticks``-tick window of the
    sweep (``_profile_ticks``), and the ring kernels the profiler saw."""
    import dataclasses as dc

    from consul_tpu_torch.sweep import make_sweep, stacked_init

    short = dc.replace(uni, steps=ticks)
    sweep = make_sweep(uni.entrypoint, uni.U, False, mesh, exchange)
    state, keys = stacked_init(short, dev), short.keys(dev)
    vals = short.knob_arrays(dev)

    def run():
        return sweep(state, keys, vals, short.cfg, ticks, short.knobs,
                     short.track)

    prof = _profile_ticks(run, ticks)
    prof["ring_kernels"] = sum(count for name, count in
                               prof.pop("kernels").items()
                               if "ring" in name.lower())
    return prof


def phase_sweepshard(dev, card: str, plain_sparse, twin) -> tuple:
    """The sweep x shard composition and the membership sweeps at full
    width: the kernel at the composed outbox; the sparse 100k loss ladder
    (U = 4, 60 ticks) unsharded and over 8 shards with both transports
    (ring == alltoall every tick and in the final state, universe 0 ==
    phase 8's sharded ``twin`` every tick and in the final state, ==
    unsharded wherever both overflows are 0, the detection invariants in
    every universe, one ring launch a tick, 0 host syncs a tick); the dense 16k
    ladder (U = 2, 10 ticks) with its peak memory.  Returns the kernel's
    row and the composed ring study's launches."""
    import torch

    from consul_tpu_torch import MembershipConfig
    from consul_tpu_torch.ops import ring_exchange
    from consul_tpu_torch.parallel import mesh_for, sharded_sparse_plan
    from consul_tpu_torch.protocol import LAN

    t_phase = time.perf_counter()
    mesh = mesh_for(SHARDS, dev)
    cfg = sparse_cfg(SPARSE_N)
    U = len(SWEEPSHARD_LOSSES)
    shape = (U, SHARDS, SHARDS, 5, sharded_sparse_plan(cfg, mesh, dev).budget)
    row = phase_ring_universe(
        dev, "make_sweep('sparse', 4, mesh=mesh_for(8), exchange='ring'), "
        "n=100000", shape)

    uni = sweepshard_universe(cfg, SWEEPSHARD_STEPS, SWEEPSHARD_LOSSES)
    base = cfg.base
    runs = {}
    launches = None
    for tag, mesh_, exchange in (
            ("sweep_sparse_100k_u4", None, "alltoall"),
            ("sweepshard_sparse_100k_u4_d8_ring", mesh, "ring"),
            ("sweepshard_sparse_100k_u4_d8_alltoall", mesh, "alltoall")):
        ring_exchange.launches = 0
        final, outs, ov, wall, syncs, peak = _run_membership_sweep(
            uni, dev, mesh_, exchange)
        n_launch = ring_exchange.launches
        if exchange == "ring":
            launches = n_launch
        check(n_launch == (uni.steps if exchange == "ring" else 0),
              f"{tag}: ring kernel launched {n_launch} times in "
              f"{uni.steps} ticks")
        check(syncs == 0, f"{tag}: {syncs} host syncs a tick (auto amortize "
              "resolves to False in a sweep)")
        model_ov = final.overflow.cpu().numpy()
        dets = []
        for u in range(U):
            rep = _membership_report_of(uni, outs, u, wall)
            dets.append(check_detection(rep, base, f"{tag} universe {u}"))
        t_prof = time.perf_counter()
        prof = _profile_sweep(uni, dev, SWEEPSHARD_PROFILE_TICKS, mesh_,
                              exchange)
        prof_s = time.perf_counter() - t_prof
        if exchange == "ring":
            check(prof["ring_kernels"] == SWEEPSHARD_PROFILE_TICKS,
                  f"{tag}: the profiler saw {prof['ring_kernels']} ring "
                  f"kernels in {SWEEPSHARD_PROFILE_TICKS} ticks")
        membership_line(
            tag, card, universes=U, ticks=uni.steps, losses=SWEEPSHARD_LOSSES,
            wall_s=wall, rounds_per_sec=U * uni.steps / wall,
            plain_sparse_100k_rounds_per_sec=plain_sparse.rounds_per_sec,
            overflow=model_ov.tolist(),
            outbox_overflow=None if ov is None else ov.tolist(),
            detection=dets, dead_known_final=outs[1][:, -1, 0].tolist(),
            peak_gib=peak, host_syncs_per_tick=syncs, ring_launches=n_launch,
            profile=prof, profile_s=prof_s,
            device=torch.cuda.get_device_name(dev))
        runs[tag] = (final, outs, model_ov)
        del final
        torch.cuda.empty_cache()
    (f_r, o_r, ov_r), (f_a, o_a, ov_a) = (
        runs["sweepshard_sparse_100k_u4_d8_ring"],
        runs["sweepshard_sparse_100k_u4_d8_alltoall"])
    for i, (a, b) in enumerate(zip(o_r, o_a)):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"sweepshard sparse: output {i} ring != alltoall")
    for name, a, b in zip(f_r._fields, f_r, f_a):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"sweepshard sparse: final {name} ring != alltoall")
    check(np.array_equal(ov_r, ov_a), "sweepshard sparse: overflow ring != "
          "alltoall")
    # Universe 0 runs phase 8's twin (loss 0.01, seed 0, the same ticks):
    # equal whatever the overflow, so every universe index of the composed
    # program is held to a run that has no universe axis.
    w_final, w_outs, w_ov = twin
    for i, (a, b) in enumerate(zip(w_outs, o_r)):
        check(a.dtype == b.dtype and np.array_equal(a, b[0]),
              f"sweepshard sparse universe 0: output {i} != phase 8's twin")
    for name, a, b in zip(w_final._fields, w_final, f_r):
        check(a.dtype == b.dtype and torch.equal(a, b[0].cpu()),
              f"sweepshard sparse universe 0: final {name} != phase 8's twin")
    check(int(ov_r[0]) == w_ov, f"sweepshard sparse universe 0: overflow "
          f"{int(ov_r[0])} != phase 8's twin's {w_ov}")
    _, o_p, ov_p = runs["sweep_sparse_100k_u4"]
    equal = []
    for u in range(U):
        same = all(np.array_equal(a[u], b[u]) for a, b in zip(o_r, o_p))
        equal.append(same)
        if ov_r[u] == 0 and ov_p[u] == 0:
            check(same, f"sweepshard sparse universe {u}: overflow 0 but "
                  "outputs != unsharded sweep")
    log(f"sweepshard sparse 100k: ring == alltoall every tick and in the "
        f"final state; universe 0 == phase 8's twin every tick and in the "
        f"final state; overflow composed {ov_r.tolist()}, unsharded "
        f"{ov_p.tolist()}; per-universe outputs equal to the unsharded "
        f"sweep: {equal}")
    del runs, f_r, f_a
    torch.cuda.empty_cache()

    dense = MembershipConfig(n=DENSE_N, loss=0.01, profile=LAN,
                             fail_at=((42, 5),))
    duni = sweepshard_universe(dense, SWEEP_DENSE_STEPS, SWEEP_DENSE_LOSSES)
    final, outs, _, wall, syncs, peak = _run_membership_sweep(duni, dev)
    del final
    torch.cuda.empty_cache()
    for u in range(duni.U):
        rep = _membership_report_of(duni, outs, u, wall)
        check(bool(np.all(np.diff(rep.dead_known[:, 0]) >= 0)),
              f"sweep_dense_16k_u2 universe {u}: dead_known fell")
        check(bool(np.all(rep.known_members > 0)),
              f"sweep_dense_16k_u2 universe {u}: known_members")
    prof = _profile_sweep(duni, dev, 1)
    torch.cuda.empty_cache()
    membership_line(
        "sweep_dense_16k_u2", card, universes=duni.U, ticks=duni.steps,
        losses=SWEEP_DENSE_LOSSES, wall_s=wall,
        rounds_per_sec=duni.U * duni.steps / wall, peak_gib=peak,
        host_syncs_per_tick=syncs, suspect_cells_final=outs[2][:, -1].tolist(),
        profile=prof, device=torch.cuda.get_device_name(dev))
    check(syncs == 0, f"sweep_dense_16k_u2: {syncs} host syncs a tick")
    log(f"sweepshard full-width studies in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return row, launches


def phase_sweepshard_small(dev) -> None:
    """The five composed families at a small shape, U = 2 x D = 2 with a
    knob varying, on both transports, with the telemetry trace on: ring ==
    alltoall, and the card == the CPU on every tick's outputs, the
    ``[U, steps, M]`` trace (phase 12's composed sweep), the final state
    and the overflow."""
    import torch

    from consul_tpu_torch import (
        BroadcastConfig,
        GeoConfig,
        MembershipConfig,
        SparseMembershipConfig,
        StreamcastConfig,
    )
    from consul_tpu_torch.parallel import mesh_for
    from consul_tpu_torch.protocol import LAN
    from consul_tpu_torch.sweep import Universe, make_sweep, stacked_init

    t_part = time.perf_counter()
    churn = MembershipConfig(n=SMALL_N, loss=0.2, profile=LAN,
                             fail_at=((5, 3), (100, 5), (2000, 8)),
                             leave_at=((77, 10),))
    dense = MembershipConfig(n=512, loss=0.2, profile=LAN,
                             fail_at=((5, 3), (17, 8)), leave_at=((30, 12),))
    families = {
        "broadcast": (BroadcastConfig(n=SMALL_N, fanout=3, loss=0.05), (),
                      "loss", (0.05, 0.3)),
        "membership": (dense, (5,), "loss", (0.1, 0.3)),
        "sparse": (SparseMembershipConfig(churn, k_slots=16), (5,),
                   "base.loss", (0.1, 0.3)),
        "streamcast": (StreamcastConfig(
            n=SMALL_N, events=40, chunks=4, window=8, fanout=4,
            chunk_budget=2, rate=0.3, loss=0.05, delivery="edges",
            policy="pipeline"), (), "rate", (0.3, 0.8)),
        "geo": (GeoConfig(n=SMALL_N, segments=8, bridges_per_segment=3,
                          events=8), (), "loss_lan", (0.0, 0.3)),
    }
    for model, (cfg, track, knob, values) in families.items():
        uni = Universe(entrypoint=model, cfg=cfg,
                       steps=SWEEPSHARD_SMALL_STEPS, seeds=(3, 4),
                       track=track, knobs=(knob,), values=(values,))
        got = {}
        for exchange in ("ring", "alltoall"):
            for where in (dev, torch.device("cpu")):
                final, outs, ov = make_sweep(
                    model, 2, True, mesh_for(2, where), exchange)(
                    stacked_init(uni, where), uni.keys(where),
                    uni.knob_arrays(where), cfg, uni.steps, uni.knobs,
                    track)
                got[exchange, where.type] = (
                    _sweep_leaves(outs) + [ov.cpu()], _sweep_leaves(final))
        want = got["alltoall", "cpu"]
        for key, (outs, final) in got.items():
            diff = _leaves_equal(want[0], outs)
            check(not diff, f"sweepshard {model} {key}: outputs != CPU "
                  f"alltoall: {diff}")
            diff = _leaves_equal(want[1], final)
            check(not diff, f"sweepshard {model} {key}: state != CPU "
                  f"alltoall: {diff}")
        log(f"sweepshard {model}: U=2 x D=2, {knob} {values}, ring == "
            f"alltoall and card == CPU on every tick's outputs and trace, "
            f"the final state and the overflow ({want[0][-1].tolist()}), "
            f"{uni.steps} ticks at n={getattr(cfg, 'n', None) or cfg.base.n}")
    log(f"sweepshard small families in {time.perf_counter() - t_part:.1f} s")


# Phase 12: the telemetry plane and the command line.
PROBE1K_STEPS = 300           # probe1k's depth
GEO100K_STEPS = 120           # geo100k's depth
DEV3_STEPS = 10               # dev3's depth
TELEMETRY_SWIM_STEPS = 60     # the headline study's first 60 ticks
TELEMETRY_PARITY_STEPS = 12
NOT_OUTPUTS = ("metrics_trace", "metric_names", "wall_s")


def _report_diff(want, got, skip=()) -> str:
    """The first field of two reports that differs (arrays by dtype and
    value), the trace and the wall time aside; '' when none does."""
    for name, w in vars(want).items():
        if name in NOT_OUTPUTS or name in skip:
            continue
        g = getattr(got, name)
        if isinstance(w, np.ndarray):
            if not (isinstance(g, np.ndarray) and w.dtype == g.dtype
                    and np.array_equal(w, g)):
                return name
        elif w != g:
            return name
    return ""


def _column(rep, name: str) -> np.ndarray:
    return rep.metrics_trace[:, rep.metric_names.index(name)]


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _check_trace(tag: str, rep, entrypoint: str, ticks: int) -> None:
    """The trace has the family's columns, one float32 row a tick, and
    holds integer counts."""
    from consul_tpu_torch.obs import metric_names

    trace = rep.metrics_trace
    check(rep.metric_names == metric_names(entrypoint)
          and trace.dtype == np.float32
          and trace.shape == (ticks, len(rep.metric_names)),
          f"{tag}: trace {trace.dtype} {trace.shape}")
    check(np.isfinite(trace).all() and np.array_equal(trace,
                                                       np.round(trace)),
          f"{tag}: the trace holds a value that is not a count")


def _check_snapshot(tag: str, snap: dict, rep, entrypoint: str) -> None:
    """The bridged /v1/agent/metrics snapshot restates the trace: a counter
    per column with one sample a tick summing to the column, a gauge at
    the final tick's level."""
    from consul_tpu_torch.obs.spec import METRIC_SPECS

    counters = {c["Name"]: c for c in snap["Counters"]}
    gauges = {g["Name"]: g["Value"] for g in snap["Gauges"]}
    for spec in METRIC_SPECS[entrypoint]:
        col = _column(rep, spec.name).astype(float)
        if spec.kind == "gauge":
            check(gauges.get(spec.name) == col[-1],
                  f"{tag}: gauge {spec.name} != the trace's last level")
        else:
            c = counters.get(spec.name, {})
            check(c.get("Count") == len(col)
                  and c.get("Sum") == round(float(col.sum()), 6),
                  f"{tag}: counter {spec.name} != the trace's column")


@contextlib.contextmanager
def _sync_warnings():
    """The warnings the block's host synchronisations raise: every call
    that waits for the device warns under ``torch.cuda.set_sync_debug_mode``
    (:func:`_n_syncs` counts them)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _n_syncs(seen) -> int:
    return sum("synchroniz" in str(w.message) for w in seen)


def _count_syncs(fn):
    """(host synchronisations ``fn()`` made, its result)."""
    with _sync_warnings() as seen:
        out = fn()
    return _n_syncs(seen), out


def phase_telemetry(dev, card: str, off: dict) -> dict:
    """The presets at their published sizes through ``run_scenario(...,
    telemetry=True)``: event100k and probe1k over 8 logical shards with
    each transport, stream100k over 8 shards with the ring, geo100k and
    dev3.  Every output equals the same preset's run with telemetry off
    (phase 9's runs and phase 6's unsharded probe1k, ``off``, and here
    geo100k's), the ring trace equals
    the alltoall trace, the ring kernel launches once a tick (counted, and
    seen by the profiler), the bridged snapshot restates the trace, and
    the columns that restate an output equal it.  Then the 1M SWIM
    headline (60 ticks) with telemetry on and off (outputs equal, no more
    host syncs), the seven families card == CPU at a small size, and the
    command line (``sim event100k --devices 8 --exchange ring --metrics``)
    in a process of its own.  Returns each ring study's launches."""
    import torch

    from consul_tpu_torch import (
        BroadcastConfig,
        GeoConfig,
        LifeguardConfig,
        MembershipConfig,
        SparseMembershipConfig,
        StreamcastConfig,
        SwimConfig,
        mesh_for,
        run_broadcast,
        run_geo,
        run_lifeguard,
        run_membership,
        run_membership_sparse,
        run_streamcast,
        run_swim,
    )
    from consul_tpu_torch.models import swim_init
    from consul_tpu_torch.obs import metric_names
    from consul_tpu_torch.ops import PRNGKey, host_cond, ring_exchange
    from consul_tpu_torch.protocol import LAN
    from consul_tpu_torch.sim.engine import swim_scan
    from consul_tpu_torch.sim.scenarios import event100k_config, run_scenario

    t_phase = time.perf_counter()
    presets = (
        # (tag, preset, arguments, the run_* it calls, family, ticks,
        #  ring launches: event100k runs twice, warm-up and timed)
        ("event100k_d8_ring", "event100k",
         dict(devices=SHARDS, exchange="ring"), "run_broadcast", "broadcast",
         EVENT_STEPS, 2 * EVENT_STEPS),
        ("event100k_d8_alltoall", "event100k",
         dict(devices=SHARDS, exchange="alltoall"), "run_broadcast",
         "broadcast", EVENT_STEPS, 0),
        ("probe1k_d8_ring", "probe1k", dict(devices=SHARDS, exchange="ring"),
         "run_membership", "membership", PROBE1K_STEPS, PROBE1K_STEPS),
        ("probe1k_d8_alltoall", "probe1k",
         dict(devices=SHARDS, exchange="alltoall"), "run_membership",
         "membership", PROBE1K_STEPS, 0),
        ("stream100k_d8_ring", "stream100k",
         dict(devices=SHARDS, exchange="ring"), "run_streamcast",
         "streamcast", STREAM_STEPS, STREAM_STEPS),
        ("geo100k", "geo100k", {}, "run_geo", "geo", GEO100K_STEPS, 0),
        ("dev3", "dev3", {}, "run_broadcast", "broadcast", DEV3_STEPS, 0),
    )
    on, summaries, cfgs, launches, syncs = {}, {}, {}, {}, {}
    for tag, name, kw, runner, entry, ticks, want in presets:
        t0 = time.perf_counter()
        ring_exchange.launches = 0
        before = host_cond.syncs
        with kept_reports(runner) as (reports, configs):
            summary = run_scenario(name, seed=0, telemetry=True, device=dev,
                                   **kw)
        n_launch = ring_exchange.launches
        syncs[tag] = host_cond.syncs - before
        rep = on[tag] = reports[-1]
        summaries[tag], cfgs[tag] = summary, configs[-1]
        check(n_launch == want,
              f"telemetry {tag}: ring kernel launched {n_launch} times")
        _check_trace(tag, rep, entry, ticks)
        _check_snapshot(tag, summary["metrics"], rep, entry)
        launches[tag] = n_launch
        log(f"telemetry {tag}: {ticks} ticks, ring launches {n_launch}, "
            f"{time.perf_counter() - t0:.1f} s; " + json.dumps(
                {k: v for k, v in summary.items() if k != "metrics"}))

    # geo100k has no earlier run: its telemetry-off twin runs here, on the
    # preset's own config (its Vivaldi latencies derived once).
    before = host_cond.syncs
    off = dict(off, geo100k=run_geo(cfgs["geo100k"], GEO100K_STEPS, seed=0,
                                    warmup=False, device=dev))
    check(host_cond.syncs - before == syncs["geo100k"],
          f"geo100k: {syncs['geo100k']} host syncs with telemetry, "
          f"{host_cond.syncs - before} without")
    for tag, rep in on.items():
        if tag.startswith("probe1k"):
            # probe1k's run without the trace is phase 6's unsharded one:
            # the dense twin equals it where no outbox overflows.
            check(rep.overflow == 0 and summaries[tag]["all_detected"],
                  f"telemetry {tag}: overflow {rep.overflow}, or a crash "
                  "went undetected")
            diff = _report_diff(off["probe1k"], rep, skip=("overflow",))
        else:
            diff = _report_diff(off[tag.replace("alltoall", "ring")], rep)
        check(not diff, f"telemetry {tag}: {diff} != the run without it")
    for name in ("event100k", "probe1k"):
        check(_same_bits(on[f"{name}_d8_ring"].metrics_trace,
                         on[f"{name}_d8_alltoall"].metrics_trace),
              f"telemetry {name}: ring trace != alltoall trace")
    seen = _ring_kernels_profiled(lambda: run_broadcast(
        event100k_config(SHARDS), 5, seed=0, warmup=False,
        mesh=mesh_for(SHARDS), exchange="ring", telemetry=True, device=dev))
    check(seen == 5, f"profiler saw {seen} ring kernels in 5 telemetry ticks")

    # The columns that restate an output equal it.
    for tag in ("event100k_d8_ring", "event100k_d8_alltoall", "dev3"):
        rep = on[tag]
        check(np.array_equal(_column(rep, "consul.broadcast.infected"),
                             rep.infected.astype(np.float32)),
              f"{tag}: consul.broadcast.infected != infected")
    rep = on["geo100k"]
    for name in ("offered", "admitted", "queued", "overflow"):
        per_link = getattr(rep, name).sum(axis=1, dtype=np.int64)
        check(np.array_equal(_column(rep, f"consul.geo.wan.{name}"),
                             per_link.astype(np.float32)),
              f"geo100k: consul.geo.wan.{name} != the per-link sums")
    for tag in ("probe1k_d8_ring", "probe1k_d8_alltoall"):
        rep = on[tag]
        for name, field in (("suspect_cells", rep.suspect_cells),
                            ("known", rep.known_members)):
            check(np.array_equal(_column(rep, f"consul.membership.{name}"),
                                 field.astype(np.float32)),
                  f"{tag}: consul.membership.{name} != its output")
    rep = on["stream100k_d8_ring"]
    for name, field in (("offered", rep.offered),
                        ("delivered", rep.delivered),
                        ("window_overflow", rep.window_overflow),
                        ("coalesced", rep.coalesced)):
        total = np.cumsum(_column(rep, f"consul.streamcast.{name}"),
                          dtype=np.float64)
        check(np.array_equal(total, field.astype(np.float64)),
              f"stream100k: consul.streamcast.{name} deltas != {name}")
    log("telemetry presets: every output == telemetry off, ring trace == "
        "alltoall trace, one ring launch a tick (profiled), the snapshot "
        "and the restating columns equal the outputs; host syncs "
        + json.dumps(syncs))

    # The 1M SWIM headline, with the trace and without.
    cfg = swim_headline_cfg("aggregate")
    runs = {}
    for telemetry in (False, True):
        state = swim_init(cfg, device=dev)
        key = PRNGKey(0, device=dev)
        t0 = time.perf_counter()
        n_sync, (final, outs) = _count_syncs(lambda: swim_scan(
            state, key, cfg, TELEMETRY_SWIM_STEPS, telemetry))
        wall = time.perf_counter() - t0
        runs[telemetry] = (to_cpu(final), [o.cpu().numpy() for o in outs],
                           n_sync, wall)
    (f_off, o_off, s_off, w_off), (f_on, o_on, s_on, w_on) = (
        runs[False], runs[True])
    check(all(_same_outputs((a,), (b,)) for a, b in zip(o_off, o_on[:2])),
          "swim_aggregate_1m: outputs with telemetry != without")
    diff = state_diff(f_off, f_on)
    check(not diff, f"swim_aggregate_1m: final {diff} with telemetry")
    check(s_on == s_off, f"swim_aggregate_1m: {s_on} host syncs with "
          f"telemetry, {s_off} without")
    trace = o_on[2]
    names = list(metric_names("swim"))
    for i, name in enumerate(("consul.swim.suspecting",
                              "consul.swim.dead_known")):
        check(np.array_equal(trace[:, names.index(name)],
                             o_on[i].astype(np.float32)),
              f"swim_aggregate_1m: {name} != its output")
    log("telemetry swim_aggregate_1m " + json.dumps({
        "ticks": TELEMETRY_SWIM_STEPS, "host_syncs_off": s_off,
        "host_syncs_on": s_on, "wall_s_off": w_off, "wall_s_on": w_on,
        "suspecting_final": int(o_on[0][-1]),
        "card": card}))

    # The seven families on the card against the CPU.
    churn = MembershipConfig(n=SMALL_N, loss=0.2, profile=LAN,
                             fail_at=((5, 3), (100, 5), (2000, 8)),
                             leave_at=((77, 10),))
    families = {
        "swim": (run_swim, SwimConfig(n=SMALL_N, subject=9, loss=0.1), {}),
        "lifeguard": (run_lifeguard, LifeguardConfig(
            n=SMALL_N, subject=9, fail_at_tick=10, loss=0.1, ack_late=0.25),
            {}),
        "broadcast": (run_broadcast,
                      BroadcastConfig(n=SMALL_N, fanout=3, loss=0.05), {}),
        "membership": (run_membership, MembershipConfig(
            n=512, loss=0.2, profile=LAN, fail_at=((5, 3), (17, 8)),
            leave_at=((30, 12),)), {"track": (5,)}),
        "sparse": (run_membership_sparse,
                   SparseMembershipConfig(churn, k_slots=16),
                   {"track": (5,)}),
        "streamcast": (run_streamcast, StreamcastConfig(
            n=SMALL_N, events=40, chunks=4, window=8, fanout=4,
            chunk_budget=2, rate=0.3, loss=0.05, delivery="edges",
            policy="pipeline"), {}),
        "geo": (run_geo, GeoConfig(n=SMALL_N, segments=8,
                                   bridges_per_segment=3, events=8), {}),
    }
    for family, (run, fcfg, kw) in families.items():
        reps = {}
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            out = run(fcfg, TELEMETRY_PARITY_STEPS, seed=3, warmup=False,
                      telemetry=True, device=where, **kw)
            reps[side] = out[0] if isinstance(out, tuple) else out
        check(_same_bits(reps["cpu"].metrics_trace,
                         reps["card"].metrics_trace),
              f"telemetry {family}: card trace != CPU trace")
        diff = _report_diff(reps["cpu"], reps["card"], skip=("device",))
        check(not diff, f"telemetry {family}: card {diff} != CPU")
    log(f"telemetry: the seven families card == CPU, trace and outputs, "
        f"{TELEMETRY_PARITY_STEPS} ticks at n={SMALL_N} (dense 512)")

    # The command line in a process of its own.
    t0 = time.perf_counter()
    argv = [sys.executable, "-m", "consul_tpu_torch.cli", "sim", "event100k",
            "--devices", str(SHARDS), "--exchange", "ring", "--metrics"]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"cli sim: exit {proc.returncode}: {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout)
    want = json.loads(json.dumps(summaries["event100k_d8_ring"],
                                 default=str))
    for d in (got, want):
        d.pop("sim_rounds_per_sec")
        d["metrics"].pop("Timestamp")
    check(got == want, "cli sim event100k --metrics != run_scenario's")
    log(f"cli: {' '.join(argv[1:])} printed run_scenario's JSON in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"telemetry phase passed in {time.perf_counter() - t_phase:.1f} s")
    return launches


def probe1k_ring_shape(dev) -> tuple:
    """(path, [D, D, C, budget]) of probe1k's ring path over 8 shards."""
    from consul_tpu_torch import MembershipConfig
    from consul_tpu_torch.parallel import mesh_for, sharded_membership_plan
    from consul_tpu_torch.protocol import LAN

    cfg = MembershipConfig(n=1000, loss=0.0, profile=LAN, fanout=3)
    budget = sharded_membership_plan(cfg, mesh_for(SHARDS), dev).budget
    return ("sharded_membership_scan(exchange='ring'), probe1k, telemetry",
            (SHARDS, SHARDS, 4, budget))


# ---------------------------------------------------------------------------
# Phase 13: the sim↔host bridge and the multichip datapoint
# ---------------------------------------------------------------------------

BRIDGE_N = 10_000             # tests/test_sim_transport.py's VERDICT bar
BRIDGE_FAILED = 4242
BRIDGE_BLOCK = 5              # ticks between the host's checks
BRIDGE_MAX_TICKS = 60
BRIDGE_PROFILE_TICKS = 2
BRIDGE_PARITY_N = 512
BRIDGE_PARITY_STEPS = 40
BRIDGE_SCALE = 0.01           # interval_scale of the reference's tests
HOST_ADDR = "sim-host://host0"


def fast_profile():
    """tests/test_sim_transport.py's FAST profile: probes every gossip
    tick, the smallest suspicion multiplier."""
    from consul_tpu_torch.protocol import GossipProfile

    return GossipProfile(
        name="fast", probe_interval_ms=200, probe_timeout_ms=200,
        indirect_checks=3, suspicion_mult=2, suspicion_max_timeout_mult=2,
        awareness_max_multiplier=8, gossip_interval_ms=200, gossip_nodes=3,
        retransmit_mult=4, push_pull_interval_ms=30_000)


def _host_self() -> dict:
    return {"name": "host0", "addr": HOST_ADDR, "inc": 0, "status": 0,
            "meta": b""}


def _messages(payload: bytes) -> list:
    """The (type, body) messages of one packet, compound or not."""
    from consul_tpu_torch.net import wire

    parts = (wire.split_compound(payload)
             if payload[0] == wire.MessageType.COMPOUND else [payload])
    return [wire.decode(p) for p in parts]


async def _push_pull(transport, j: int, nodes: list) -> bytes:
    from consul_tpu_torch.net import sim_addr, wire

    stream = await transport.dial(sim_addr(j), 1.0)
    await stream.send(wire.encode(wire.MessageType.PUSH_PULL, {
        "join": True, "nodes": nodes, "user": b""}))
    raw = await stream.recv(10.0)
    await stream.close()
    return raw


async def _bridge_10k(dev, card: str) -> dict:
    """The VERDICT bar on the card: a scripted host joins the 10k pool
    through sim://17, announces itself, fires one user event and acks
    every probe of it while the pool runs in blocks of 5 ticks until a
    DEAD message about the crashed member reaches it."""
    import asyncio

    import torch

    from consul_tpu_torch.net import SimBridge, SimPoolConfig, sim_addr, wire
    from consul_tpu_torch.sim.breakdown import _kernel_times

    torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    bridge = SimBridge(SimPoolConfig(
        n=BRIDGE_N, profile=fast_profile(), interval_scale=BRIDGE_SCALE,
        fail_at=((BRIDGE_FAILED, 3),), realtime=False, seed=0), device=dev)
    transport = bridge.transport(HOST_ADDR)
    t, body = wire.decode(await _push_pull(transport, 17, [_host_self()]))
    check(t == wire.MessageType.PUSH_PULL
          and len(body["nodes"]) == BRIDGE_N,
          f"10k join: push/pull answered {len(body['nodes'])} snapshots")
    await transport.write_to(
        wire.encode(wire.MessageType.ALIVE, _host_self()), sim_addr(17))
    await transport.write_to(wire.encode(wire.MessageType.USER, {
        "name": "deploy", "payload": b"big-pool-event", "ltime": 1}),
        sim_addr(17))
    setup_s = time.perf_counter() - t_setup

    dead = []

    async def listen():
        # The host's packet loop: ack the pool's probes, note obituaries.
        while True:
            payload, src, _ = await transport.recv_packet()
            for mt, msg in _messages(payload):
                if mt == wire.MessageType.PING:
                    await transport.write_to(wire.encode(
                        wire.MessageType.ACK_RESP, {"seq": msg["seq"]}), src)
                elif (mt == wire.MessageType.DEAD
                      and msg.get("node") == f"sim-{BRIDGE_FAILED}"):
                    dead.append(bridge.tick)

    listener = asyncio.create_task(listen())
    ticks = 0
    t0 = time.perf_counter()
    with _sync_warnings() as seen:
        while ticks < BRIDGE_MAX_TICKS and not dead:
            await bridge.run_ticks(BRIDGE_BLOCK)
            ticks += BRIDGE_BLOCK
    wall = time.perf_counter() - t0
    if listener.done():
        listener.result()  # the host's loop failed: raise what it raised
    syncs = _n_syncs(seen)
    coverage = bridge.event_coverage(b"big-pool-event")
    awareness = bridge.host_awareness(transport)
    check(bool(dead), f"10k: no DEAD about sim-{BRIDGE_FAILED} reached the "
          f"host in {ticks} ticks")
    check(coverage > 0.9, f"10k: event coverage {coverage}")
    check(awareness > 0.9, f"10k: host awareness {awareness}")
    check(transport.missed_pings == 0 and transport.ping_seq > 0,
          f"10k: {transport.missed_pings} missed pings of "
          f"{transport.ping_seq}")
    # Device time a tick from a profiled block after the bar is met.
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        await bridge.run_ticks(BRIDGE_PROFILE_TICKS)
        torch.cuda.synchronize()
    kernels = _kernel_times(prof)
    listener.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await listener
    await transport.shutdown()
    row = {
        "run": "bridge_10k", "n": BRIDGE_N, "ticks": ticks,
        "first_dead_tick": dead[0], "event_coverage": coverage,
        "host_awareness": awareness, "pings": transport.ping_seq,
        "missed_pings": transport.missed_pings,
        "ticks_per_sec": ticks / wall, "wall_s": wall, "setup_s": setup_s,
        "host_syncs_per_tick": syncs / ticks,
        "device_ms_per_tick": sum(us for _, us in kernels.values())
        / 1e3 / BRIDGE_PROFILE_TICKS,
        "launches_per_tick": sum(c for c, _ in kernels.values())
        / BRIDGE_PROFILE_TICKS,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": card,
    }
    log("bridge " + json.dumps(row))
    return row


def _instrument_host(ml, bridge) -> dict:
    """Count what the host's own failure detector does: its probes, the
    suspicions its failed probes raise, and the false ones among them
    (the subject was up in the pool's ground truth when the probe ended).
    Wraps the memberlist's probe; the protocol runs as it would."""
    from consul_tpu_torch.net import NodeStatus
    from consul_tpu_torch.net.sim_transport import parse_sim_addr

    seen = {"probes": 0, "suspicions": 0, "false_suspicions": 0}
    probe = ml._probe_node

    async def counted(node):
        before = node.status
        await probe(node)
        seen["probes"] += 1
        if before == NodeStatus.ALIVE and node.status == NodeStatus.SUSPECT:
            seen["suspicions"] += 1
            j = parse_sim_addr(node.addr)
            if j is not None and bridge.up(j):
                seen["false_suspicions"] += 1

    ml._probe_node = counted
    return seen


class _ErrorRecords(logging.Handler):
    """Keeps every record logged at ERROR or above while it is attached."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list = []

    def emit(self, record) -> None:
        self.records.append(record)


SERF_CHECK_NAME = "Serf Health Status"   # consul_tpu/agent/server.py:68
# The server's Raft timings (consul_tpu/agent/server.py:86-88) and the
# default snapshot threshold.
CATALOG_RAFT = {"heartbeat_interval": 0.05, "election_timeout_min": 0.15,
                "election_timeout_max": 0.30}
CATALOG_SERVERS = 3
CATALOG_SETTLE_S = 60.0      # the longest a fold may take to reach every store
CATALOG_PASSES = 20          # folds before the catalog must match the view


class _Catalog:
    """The consistency plane beside the host agent: servers ``s0``-``s2``,
    each a ``RaftNode`` with its own ``ConsulFSM``,
    ``StateStore`` and change stream, on one ``InmemRaftNet``, into which
    the ``Cluster``'s view of the pool is folded.

    ``fold`` is a short copy of the reference server's reconcile
    (``consul_tpu/agent/server.py:710-730``): one REGISTER entry per member
    whose catalog entry is out of date (``_member_needs_update``,
    ``:733-742``), with the bodies of ``_handle_alive_member``
    (``:752-781``, without the raft-peer promotion) and
    ``_handle_failed_member`` (``:783-799``), and a DEREGISTER for a member
    that left (``:801-809``).  A NotLeaderError is retried against the new
    leader, as the reference's loop retries on its next tick
    (``:691-708``), and counted.  Unlike the reference's loop it keeps one
    AppendEntries batch of entries in flight (``fold``).  It stands in
    for the port's ``Server`` until that is ported."""

    def __init__(self):
        from consul_tpu_torch.consensus import InmemRaftNet

        self.net = InmemRaftNet()
        self.wins: list = []          # (server, term) of every election won
        self.not_leader = 0           # applies retried on a new leader
        ids = [f"s{i}" for i in range(CATALOG_SERVERS)]
        self.servers = [self._server(sid, ids) for sid in ids]

    def _server(self, sid: str, voters: list):
        from consul_tpu_torch.agent import ConsulFSM
        from consul_tpu_torch.consensus import RaftConfig, RaftNode
        from consul_tpu_torch.store import StateStore
        from consul_tpu_torch.stream import EventPublisher

        node = RaftNode(RaftConfig(node_id=sid, **CATALOG_RAFT),
                        ConsulFSM(StateStore(), EventPublisher()),
                        self.net, voters)
        node.leadership_listeners.append(
            lambda won: won and self.wins.append((sid, node.current_term)))
        return node

    async def start(self) -> None:
        for node in self.servers:
            await node.start()
        await self.leader()

    async def stop(self) -> None:
        for node in self.servers:
            await node.shutdown()

    async def leader(self, timeout: float = 10.0):
        """The one leader every server names."""
        import asyncio

        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            leaders = [n for n in self.servers if n.is_leader()]
            if len(leaders) == 1 and all(
                    n.leader_id == leaders[0].id for n in self.servers):
                return leaders[0]
            check(loop.time() < deadline, "catalog: no stable leader: "
                  + str([(n.id, n.role.value, n.leader_id)
                         for n in self.servers]))
            await asyncio.sleep(0.01)

    async def _on_leader(self, call):
        from consul_tpu_torch.consensus import NotLeaderError

        while True:
            leader = await self.leader()
            try:
                return await call(leader)
            except NotLeaderError:
                self.not_leader += 1

    async def apply(self, msg_type, body: dict):
        """``Server.raft_apply`` (server.py:600-610): a domain error is a
        failure of the run."""
        result = await self._on_leader(
            lambda n: n.apply({"type": int(msg_type), "body": body}))
        check(not (isinstance(result, dict) and "error" in result),
              f"catalog: {msg_type!r} for {body.get('node')}: {result}")
        return result

    @staticmethod
    def _needs_update(store, m, status: str) -> bool:
        """server.py:733-742 ``_member_needs_update``."""
        from consul_tpu_torch.store.state import SERF_CHECK_ID

        _, node = store.node(m.name)
        if node is None or node.get("address") != m.addr:
            return True
        _, checks = store.node_checks(m.name)
        serf = next((c for c in checks if c["check_id"] == SERF_CHECK_ID),
                    None)
        return serf is None or serf["status"] != status

    def _command(self, store, m):
        """The entry the reference's handler would apply for member ``m``,
        or None where its catalog entry is up to date."""
        from consul_tpu_torch.agent import MessageType
        from consul_tpu_torch.eventing import MemberStatus
        from consul_tpu_torch.store import HEALTH_CRITICAL, HEALTH_PASSING
        from consul_tpu_torch.store.state import SERF_CHECK_ID

        if m.status == MemberStatus.ALIVE:
            if not self._needs_update(store, m, HEALTH_PASSING):
                return None
            return MessageType.REGISTER, {
                "node": m.name, "address": m.addr,
                "node_meta": {"serf": "1", **(
                    {"segment": m.tags["segment"]}
                    if m.tags.get("segment") else {})},
                "check": {"check_id": SERF_CHECK_ID,
                          "name": SERF_CHECK_NAME,
                          "status": HEALTH_PASSING,
                          "output": "Agent alive and reachable"}}
        if m.status == MemberStatus.FAILED:
            if not self._needs_update(store, m, HEALTH_CRITICAL):
                return None
            return MessageType.REGISTER, {
                "node": m.name, "address": m.addr,
                "check": {"check_id": SERF_CHECK_ID,
                          "name": SERF_CHECK_NAME,
                          "status": HEALTH_CRITICAL,
                          "output": "Agent not live or unreachable"}}
        if m.status == MemberStatus.LEFT and store.node(m.name)[1]:
            return MessageType.DEREGISTER, {"node": m.name}
        return None

    async def fold(self, members: list) -> int:
        """One reconcile pass over ``members``; returns the entries it
        applied.  The reference applies one entry at a time; here up to
        ``max_append_entries`` are in flight, one AppendEntries batch,
        since at 10k members the host's memberlist holds most of the
        event loop and each entry would otherwise wait its turn several
        times."""
        import asyncio

        store = (await self.leader()).fsm.store
        commands = [c for c in (self._command(store, m) for m in members)
                    if c is not None]
        batch = self.servers[0].config.max_append_entries
        for i in range(0, len(commands), batch):
            await asyncio.gather(*(self.apply(t, body)
                                   for t, body in commands[i:i + batch]))
        return len(commands)

    async def settle(self) -> None:
        """A barrier on the leader, then every server applied as far."""
        import asyncio

        await self._on_leader(lambda n: n.barrier())
        target = (await self.leader()).last_applied
        loop = asyncio.get_running_loop()
        deadline = loop.time() + CATALOG_SETTLE_S
        while any(n.last_applied < target for n in self.servers):
            check(loop.time() < deadline, "catalog: servers behind: " + str(
                [(n.id, n.last_applied) for n in self.servers]))
            await asyncio.sleep(0.01)

    async def reconcile(self, cluster) -> dict:
        """Fold the cluster's view until the leader's catalog matches it
        after the stores have settled; returns the view, ``name ->
        status``, that it matched.  Nothing runs between that match and
        the caller's checks."""
        applied = passes = 0
        while True:
            passes += 1
            check(passes <= CATALOG_PASSES, "catalog: the view kept moving "
                  f"for {CATALOG_PASSES} folds")
            applied += await self.fold(list(cluster.members.values()))
            await self.settle()
            store = (await self.leader()).fsm.store
            members = list(cluster.members.values())
            if not any(self._command(store, m) for m in members):
                return {"view": {m.name: m.status for m in members},
                        "applied": applied, "passes": passes}

    def check_view(self, view: dict, tag: str) -> dict:
        """Every server's catalog against the view: a node for every member
        that has not left, each ``serfHealth`` passing where the member is
        alive and critical where it failed, and one snapshot on every
        server.  Returns the count of each status."""
        from consul_tpu_torch.eventing import MemberStatus
        from consul_tpu_torch.store import HEALTH_CRITICAL, HEALTH_PASSING
        from consul_tpu_torch.store.state import SERF_CHECK_ID

        want = {MemberStatus.ALIVE: HEALTH_PASSING,
                MemberStatus.FAILED: HEALTH_CRITICAL}
        present = {name for name, st in view.items()
                   if st != MemberStatus.LEFT}
        snaps = []
        for node in self.servers:
            store = node.fsm.store
            _, nodes = store.nodes()
            check({n["node"] for n in nodes} == present,
                  f"{tag}: {node.id} holds {len(nodes)} nodes, the view "
                  f"{len(present)}")
            for name, st in view.items():
                if st not in want:
                    continue
                serf = [c["status"] for c in store.node_checks(name)[1]
                        if c["check_id"] == SERF_CHECK_ID]
                check(serf == [want[st]], f"{tag}: {node.id}: {name} is "
                      f"{serf}, the view says {st.name}")
            snaps.append(store.snapshot())
        check(all(s == snaps[0] for s in snaps),
              f"{tag}: the servers' snapshots differ")
        counts: dict = {}
        for st in view.values():
            counts[st.name] = counts.get(st.name, 0) + 1
        return counts

    async def add_server(self, sid: str) -> None:
        """A server with an empty log joins as a voter and catches up."""
        node = self._server(sid, [])
        await node.start()
        await self._on_leader(lambda n: n.add_voter(sid))
        self.servers.append(node)
        await self.settle()

    async def archive_round_trip(self) -> dict:
        """The leader's snapshot through ``write_archive`` and
        ``read_archive``, installed on every server by a replicated
        SNAPSHOT_RESTORE entry, which closes every change-stream
        subscription."""
        from consul_tpu_torch.agent import (
            MessageType,
            read_archive,
            write_archive,
        )
        from consul_tpu_torch.stream import TOPIC_KV, SubscriptionClosed

        leader = await self.leader()
        snap = leader.fsm.store.snapshot()
        t0 = time.perf_counter()
        blob = write_archive(snap, leader.last_applied, leader.current_term,
                             leader.id)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, meta = read_archive(blob)
        read_s = time.perf_counter() - t0
        check(state == snap and meta["index"] == leader.last_applied,
              "catalog: the archive does not read back as written")
        subs = [n.fsm.publisher.subscribe(TOPIC_KV) for n in self.servers]
        await self.apply(MessageType.SNAPSHOT_RESTORE, {"state": state})
        await self.settle()
        for node in self.servers:
            check(node.fsm.store.snapshot() == state,
                  f"catalog: {node.id} differs from the archive after the "
                  "restore")
        closed = 0
        for sub in subs:
            try:
                await sub.next(timeout=0.01)
            except SubscriptionClosed:
                closed += 1
        check(closed == len(subs), f"catalog: the restore closed {closed} "
              f"of {len(subs)} subscriptions")
        return {"archive_bytes": len(blob), "archive_write_s": write_s,
                "archive_read_s": read_s}


async def _bridge_10k_host(dev, card: str) -> dict:
    """The VERDICT bar with the port's own host agent: a ``Cluster`` (serf
    over ``Memberlist``) joins the 10k pool through sim://17, holds n + 1
    members, fires one user event, and the pool runs in blocks of 5 ticks
    until the host's memberlist marks the crashed member DEAD and its
    cluster raises MEMBER_FAILED.  The host's timers run on the event
    loop, which the pool's ticks hold: its probes of live members may
    time out, and those false suspicions are counted, not hidden.

    Beside it runs the consistency plane (``_Catalog``): the view after
    the join is folded into a catalog replicated on three Raft servers,
    and again after MEMBER_FAILED; each server's catalog must follow the
    view, ``sim-4242`` critical; a fourth server joins after compaction
    and catches up through InstallSnapshot; the leader's snapshot goes
    through an archive and back onto every server."""
    import asyncio

    import torch

    from consul_tpu_torch.eventing import (
        Cluster,
        ClusterConfig,
        EventType,
        MemberStatus,
    )
    from consul_tpu_torch.net import (
        NodeStatus,
        SimBridge,
        SimPoolConfig,
        sim_addr,
    )

    torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    bridge = SimBridge(SimPoolConfig(
        n=BRIDGE_N, profile=fast_profile(), interval_scale=BRIDGE_SCALE,
        fail_at=((BRIDGE_FAILED, 3),), realtime=False, seed=0), device=dev)
    transport = bridge.transport(HOST_ADDR)
    failed: list = []
    cluster = Cluster(ClusterConfig(
        name="host0", profile=fast_profile(), interval_scale=BRIDGE_SCALE,
        on_event=lambda ev: failed.extend(
            (bridge.tick, m.name) for m in ev.members)
        if ev.type == EventType.MEMBER_FAILED else None), transport)
    ml = cluster.memberlist
    counts = _instrument_host(ml, bridge)
    await cluster.start()
    check(await cluster.join([sim_addr(17)]) == 1, "10k host: join failed")
    members = len(ml.members())
    check(members == BRIDGE_N + 1, f"10k host: {members} members after the "
          f"join, not {BRIDGE_N + 1}")
    await cluster.user_event("deploy", b"big-pool-event")
    await asyncio.sleep(0.05)
    setup_s = time.perf_counter() - t_setup

    catalog = _Catalog()
    await catalog.start()
    t0 = time.perf_counter()
    first = await catalog.reconcile(cluster)
    first_s = time.perf_counter() - t0
    first_counts = catalog.check_view(first["view"], "catalog after the join")

    target = f"sim-{BRIDGE_FAILED}"
    ticks = 0
    t0 = time.perf_counter()
    while ticks < BRIDGE_MAX_TICKS:
        await bridge.run_ticks(BRIDGE_BLOCK)
        ticks += BRIDGE_BLOCK
        node = ml.nodes.get(target)
        if node is not None and node.status == NodeStatus.DEAD:
            break
    wall = time.perf_counter() - t0
    # The second fold: only the members whose status changed.
    t0 = time.perf_counter()
    second = await catalog.reconcile(cluster)
    second_s = time.perf_counter() - t0
    second_counts = catalog.check_view(second["view"],
                                       "catalog after MEMBER_FAILED")
    node = ml.nodes.get(target)
    coverage = bridge.event_coverage(b"big-pool-event")
    failed_ticks = [t for t, name in failed if name == target]
    row = {
        "run": "bridge_10k_host", "n": BRIDGE_N, "members": members,
        "ticks": ticks, "dead_at_host": bool(
            node is not None and node.status == NodeStatus.DEAD),
        "member_failed_tick": failed_ticks[0] if failed_ticks else None,
        "event_coverage": coverage,
        "host_awareness": bridge.host_awareness(transport),
        "host_health_score": ml.awareness.score,
        "host_probes": counts["probes"],
        "host_suspicions": counts["suspicions"],
        "host_false_suspicions": counts["false_suspicions"],
        "host_false_failures": sum(name != target for _, name in failed),
        "pool_pings": transport.ping_seq,
        "missed_pings": transport.missed_pings,
        "ticks_per_sec": ticks / wall, "wall_s": wall, "setup_s": setup_s,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": card,
    }
    log("bridge " + json.dumps(row))
    await cluster.shutdown()
    check(row["dead_at_host"], f"10k host: {target} not DEAD at the host in "
          f"{ticks} ticks")
    check(bool(failed_ticks), f"10k host: no MEMBER_FAILED for {target}")
    check(coverage > 0.9, f"10k host: event coverage {coverage}")
    check(second["view"].get(target) == MemberStatus.FAILED,
          f"catalog: the view of {target} is {second['view'].get(target)}")
    check(len(second["view"]) == BRIDGE_N + 1,
          f"catalog: {len(second['view'])} members in the view")
    await _consistency(catalog, second["view"], card, {
        "fold_after_join": dict(entries=first["applied"],
                                passes=first["passes"], s=first_s,
                                view=first_counts),
        "fold_after_failed": dict(entries=second["applied"],
                                  passes=second["passes"], s=second_s,
                                  view=second_counts)})
    return row


async def _consistency(catalog, view: dict, card: str, folds: dict) -> dict:
    """After the folds: a fourth server joins after compaction and catches
    up through InstallSnapshot, the leader's snapshot goes through an
    archive and back onto every server, and the ``consistency`` line is
    printed."""
    leader = await catalog.leader()
    check(leader.snapshot_index > 0, "catalog: the leader never compacted "
          f"its log ({len(leader.log)} entries)")
    t0 = time.perf_counter()
    await catalog.add_server("s3")
    join_s = time.perf_counter() - t0
    s3 = catalog.servers[-1]
    check(s3.snapshot_index > 0, "catalog: s3 caught up without an "
          "InstallSnapshot")
    catalog.check_view(view, "catalog with s3")
    snapshot_index = {n.id: n.snapshot_index for n in catalog.servers}
    t0 = time.perf_counter()
    archive = await catalog.archive_round_trip()
    round_trip_s = time.perf_counter() - t0
    leader = await catalog.leader()
    critical = sorted(name for name, st in view.items()
                      if st.name == "FAILED")
    row = {
        "run": "consistency", "members": len(view),
        "nodes": {n.id: len(n.fsm.store.nodes()[1])
                  for n in catalog.servers},
        "critical": len(critical), "critical_names": critical[:10],
        **folds,
        "leader_changes": len(catalog.wins) - 1,
        "not_leader_retries": catalog.not_leader,
        "final_term": leader.current_term, "final_leader": leader.id,
        "snapshot_index": snapshot_index, "s3_join_s": join_s,
        **archive, "archive_round_trip_s": round_trip_s, "card": card,
    }
    await catalog.stop()
    log("consistency " + json.dumps(row))
    return row


def _bridge_script() -> dict:
    """tick -> the scripted host's actions before it: (kind, j, arg)."""
    from consul_tpu_torch.net import wire

    def snap(j, inc=0, status=0):
        return {"name": f"sim-{j}", "addr": f"sim://{j}", "inc": inc,
                "status": status, "meta": b""}

    enc = wire.encode
    mt = wire.MessageType
    return {
        0: [("push_pull", 0, [_host_self(), snap(5), snap(9, 2, 1)])],
        1: [("packet", 0, enc(mt.ALIVE, _host_self())),
            ("packet", 3, enc(mt.USER, {"name": "deploy",
                                        "payload": b"v2", "ltime": 1}))],
        2: [("packet", 4, enc(mt.SUSPECT, {"inc": 0, "node": "sim-20",
                                           "from": "host0"})),
            ("packet", 4, enc(mt.DEAD, {"inc": 1, "node": "sim-21",
                                        "from": "host0"})),
            # Two injections into one cell (row 6, subject 30).
            ("packet", 6, wire.make_compound([
                enc(mt.SUSPECT, {"inc": 3, "node": "sim-30",
                                 "from": "host0"}),
                enc(mt.SUSPECT, {"inc": 1, "node": "sim-30",
                                 "from": "host0"})]))],
        5: [("packet", 7, enc(mt.USER, {"name": "deploy", "payload": b"v3",
                                        "ltime": 2})),
            ("packet", 8, enc(mt.PING, {"seq": 11}))],
    }


def _bridge_tick(bridge) -> tuple:
    """What a tick leaves on the host: state planes, infections, host
    counters (numpy)."""
    state = tuple(x.cpu().numpy() for x in bridge.state)
    infections = [(k, inf.infected.cpu().numpy(), inf.tx.cpu().numpy(),
                   inf.done) for k, inf in bridge.events.items()]
    infections += [(a, h.known.infected.cpu().numpy(),
                    h.known.tx.cpu().numpy(), h.known.done)
                   for a, h in bridge.hosts.items()]
    hosts = [(h.ping_seq, dict(h.pending_pings), h.missed_pings, h.host_inc)
             for h in bridge.hosts.values()]
    return state, infections, hosts


async def _bridge_parity(dev) -> int:
    """The bridge at n=512 on the card and on the CPU, driven by one
    scripted host for 40 ticks: every state field with its dtype, every
    infection and every delivered packet equal on every tick.  Returns the
    packets compared."""
    from consul_tpu_torch.net import SimBridge, SimPoolConfig, sim_addr, wire

    cfg = SimPoolConfig(
        n=BRIDGE_PARITY_N, profile=fast_profile(),
        interval_scale=BRIDGE_SCALE, fail_at=((3, 2), (40, 10)),
        leave_at=((50, 4),), join_at=((60, 6),), realtime=False, seed=3)
    pair = [SimBridge(cfg, device=dev), SimBridge(cfg, device="cpu")]
    hosts = [b.transport(HOST_ADDR) for b in pair]
    script = _bridge_script()
    packets = 0
    for tick in range(BRIDGE_PARITY_STEPS):
        for kind, j, arg in script.get(tick, ()):
            seen = []
            for host in hosts:
                if kind == "push_pull":
                    seen.append(await _push_pull(host, j, arg))
                else:
                    await host.write_to(arg, sim_addr(j))
            check(len(set(seen)) <= 1, f"bridge parity: tick {tick} "
                  "push/pull answers differ")
        for bridge in pair:
            await bridge.step()
        want, got = _bridge_tick(pair[1]), _bridge_tick(pair[0])
        for f, a, b in zip(pair[1].state._fields, want[0], got[0]):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"bridge parity: tick {tick} state.{f} CUDA != CPU")
        check(len(want[1]) == len(got[1]), "bridge parity: infections")
        for a, b in zip(want[1], got[1]):
            check(a[0] == b[0] and np.array_equal(a[1], b[1])
                  and np.array_equal(a[2], b[2]) and a[3] == b[3],
                  f"bridge parity: tick {tick} infection {a[0]!r}")
        check(want[2] == got[2], f"bridge parity: tick {tick} host counters")
        drained = []
        for host in hosts:
            out = []
            while not host.packets.empty():
                payload, src, _ = host.packets.get_nowait()
                out.append((payload, src))
            drained.append(out)
        check(drained[0] == drained[1],
              f"bridge parity: tick {tick} delivered packets differ")
        packets += len(drained[0])
        # Ack every probe but the first, so one expires.
        for payload, src in drained[0]:
            for mt, msg in _messages(payload):
                if mt == wire.MessageType.PING and msg["seq"] != -1:
                    for host in hosts:
                        await host.write_to(wire.encode(
                            wire.MessageType.ACK_RESP, {"seq": msg["seq"]}),
                            src)
    check(packets > 0 and hosts[0].ping_seq > 0,
          "bridge parity: the pool never gossiped to or probed the host")
    return packets


def phase_bridge(dev, card: str, broadcast_final: int) -> int:
    """Phase 13: the 10k VERDICT bar with a scripted host and with the
    port's own ``Cluster``, the bridge CUDA == CPU at n=512 and
    the multichip datapoint (``parallel.shard.main`` at phase 4's sharded
    1M broadcast).  Returns the datapoint's ring launches."""
    import asyncio
    import gc
    import io

    import torch

    from consul_tpu_torch.ops import ring_exchange
    from consul_tpu_torch.parallel import shard

    t_phase = time.perf_counter()
    asyncio.run(_bridge_10k(dev, card))
    log(f"bridge n={BRIDGE_N} in {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    # Every error the host agent logs (a task that failed, an exception
    # nobody retrieved) fails the run: the run is clean or it is wrong.
    errors = _ErrorRecords()
    logging.getLogger().addHandler(errors)
    try:
        asyncio.run(_bridge_10k_host(dev, card))
        # The 10k pools go with their event loops; give their planes back.
        gc.collect()
    finally:
        logging.getLogger().removeHandler(errors)
    torch.cuda.empty_cache()
    log(f"bridge n={BRIDGE_N} with the port's Cluster in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(dev)} bytes left allocated; "
        f"{len(errors.records)} errors logged")
    check(not errors.records, "10k host: errors logged: "
          + "; ".join(r.getMessage() for r in errors.records[:3]))
    t0 = time.perf_counter()
    packets = asyncio.run(_bridge_parity(dev))
    log(f"bridge n={BRIDGE_PARITY_N}: CUDA == CPU on "
        f"{BRIDGE_PARITY_STEPS} ticks (state, infections, {packets} "
        f"packets byte-equal) in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    argv = ["--devices", str(SHARDS), "--n", str(N_1M), "--steps",
            str(EDGE_STEPS), "--exchange", "both"]
    out = io.StringIO()
    ring_exchange.launches = 0
    with contextlib.redirect_stdout(out):
        check(shard.main(argv) == 0, "datapoint main failed")
    launches = ring_exchange.launches
    (line,) = out.getvalue().strip().splitlines()
    point = json.loads(line)
    rows = point["exchange_backends"]
    for ex, row in rows.items():
        check(row["infected_final"] == broadcast_final,
              f"datapoint {ex}: infected_final {row['infected_final']} != "
              f"phase 4's {broadcast_final}")
        check(row["overflow"] == 0, f"datapoint {ex}: overflow")
    check(set(rows) == {"alltoall", "ring"}, "datapoint backends")
    log("datapoint " + json.dumps(dict(point, card=card)))
    log(f"datapoint in {time.perf_counter() - t0:.1f} s")
    log(f"bridge phase passed in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the program registry, the ladder and the profile harness
# ---------------------------------------------------------------------------

REGISTRY_COUNTS = {"small": 94, "big": 14}
PHASE14_AIM_S = 240.0        # the phase's aimed share of the 1200 s
LEFTOVER_LIMIT = 1 << 30     # what earlier phases may still hold
# Ticks of each big program's profiled first call (the whole study when it
# is shorter); the timed call runs the study cut to BIG_STEPS ticks (the
# earlier phases run the same studies whole).
PROFILE_WINDOW = 10
BIG_STEPS = 10
# The programs that ``cli profile`` executes in a process of its own: the
# sharded broadcast over 2 shards, plain, with the ring and with the trace.
CLI_PROFILE_ENTRY = "sharded_broadcast@small/D2"
# Kernel launches a tick of each big program over its whole study, as an
# NVIDIA H100 80GB HBM3 at 700 W counted them (PERF.md section 6).  A
# window's count must lie within LAUNCH_BAND of these: the profiler has
# been seen to lose events, and a count that lost them is no measurement.
LAUNCHES_PER_TICK = {
    "broadcast@1m": 732.5, "membership@16k": 5357.2, "sparse@1m": 4984.3,
    "swim@1m": 3250.5, "lifeguard@1m": 4042.8, "streamcast@1m": 1964.5,
    "geo@1m": 3513.7, "sharded_broadcast@1m_per_chip/D2": 1530.5,
    "sharded_membership@1m_per_chip/D2": 5509.5,
    "sharded_sparse@1m_per_chip/D2": 5540.0,
    "sharded_streamcast@1m_per_chip/D2": 2980.8,
    "sweep_sparse@100k/U1": 5468.7, "sweep_sparse@100k/U8": 5469.7,
}
LAUNCH_BAND = (0.75, 1.33)


def cut_program(prog, ticks: int):
    """``prog`` cut to its first ``ticks`` ticks, on the same arguments
    (``prog`` itself where the study is no longer)."""
    if prog.at_steps is None or prog.steps is None or prog.steps <= ticks:
        return prog
    _, make_args = prog.build()
    return dataclasses.replace(
        prog, steps=ticks, build=lambda: (prog.at_steps(ticks), make_args))


def free_card(dev) -> None:
    """Return what earlier phases left in the allocator's cache, and check
    that under 1 GiB is still allocated before the 1M-node programs run."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    log(f"registry phase starts with {held} bytes allocated on the card")
    check(held < LEFTOVER_LIMIT,
          f"earlier phases hold {held} bytes on the card")


@contextlib.contextmanager
def ring_shapes_seen():
    """Record ``[D, D, C, budget]`` of every ring exchange the sharded plane
    makes inside the block (the shapes the registry's programs give the
    kernel)."""
    from consul_tpu_torch.parallel import shard

    seen = []
    real = shard.ring_exchange_planes

    def spy(planes):
        *_, d, _, budget = planes[0].shape
        seen.append((d, d, len(planes), budget))
        return real(planes)

    shard.ring_exchange_planes = spy
    try:
        yield seen
    finally:
        shard.ring_exchange_planes = real


def _trace_kernels(path: str) -> int:
    """CUDA kernel events in a ``torch.profiler`` Chrome trace (counted in
    its text: the trace of a 4096-node study is about 100 MB)."""
    with open(path) as f:
        text = f.read()
    check('"traceEvents"' in text, f"{path} is not a Chrome trace")
    return text.count('"cat": "kernel"')


def walk_ladder(small: dict, dev) -> list:
    """The 22 ladder rungs on the card, one at a time; the ring rungs under
    the profiler, with the shapes their programs give the kernel.  Returns
    ``(path, [D, D, C, budget], launches)`` of each ``D2/ring`` program."""
    from consul_tpu_torch.ops import ring_exchange
    from consul_tpu_torch.sim.registry import EQUIV_PAIRS, walk_equiv_pairs

    import torch

    from consul_tpu_torch.obs.profile import kernel_events

    def ring_kernels_profiled(run) -> int:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return sum(1 for name, _ in kernel_events(prof)
                   if "ring" in name.lower())

    t_ladder = time.perf_counter()
    ring_rows = []
    for pair in EQUIV_PAIRS:
        if not pair.a.endswith("/D2/ring"):
            (walked,) = walk_equiv_pairs(small, dev, (pair,))
            log(f"ladder {pair.a} == {pair.b} ({pair.relation}) in "
                f"{walked['seconds']:.2f} s")
            continue
        ring_exchange.launches = 0
        with ring_shapes_seen() as seen:
            profiled = ring_kernels_profiled(
                lambda: walk_equiv_pairs(small, dev, (pair,)))
        counted = ring_exchange.launches
        check(counted >= 1 and profiled == counted,
              f"{pair.a}: ring launches counted {counted}, profiled "
              f"{profiled}")
        check(len(set(seen)) == 1 and len(seen) == counted,
              f"{pair.a}: ring shapes {seen}")
        ring_rows.append((f"registry {pair.a}", seen[0], counted))
        log(f"ladder {pair.a} == {pair.b}: ring launches {counted} "
            f"(profiled {profiled}) at {list(seen[0])}")
    log(f"ladder: {len(EQUIV_PAIRS)} rungs hold on the card, bit for bit, in "
        f"{time.perf_counter() - t_ladder:.1f} s")
    return ring_rows


def phase_registry(dev, card: str) -> list:
    """Phase 14: the big registry profiled on the card from each program's
    own initial state, under the memory gate; the 22 ladder rungs on CUDA,
    with the ring launches of the five ``D2/ring`` programs; ``cli profile``
    in a process of its own.  Returns the ring kernel's rows at the
    registry's ``[2, 2, C, budget]`` shapes."""
    import tempfile

    import torch

    from consul_tpu_torch.obs.profile import (
        memory_budget,
        memory_gate,
        profile_registry,
    )
    from consul_tpu_torch.sim.registry import EQUIV_PAIRS, jaxlint_registry

    t_phase = time.perf_counter()
    free_card(dev)
    small = jaxlint_registry(include=("small",))
    big = {name: cut_program(prog, BIG_STEPS)
           for name, prog in jaxlint_registry(include=("big",)).items()}
    log(f"registry: {len(small)} small, {len(big)} big programs, "
        f"{len(EQUIV_PAIRS)} ladder rungs")
    check({"small": len(small), "big": len(big)} == REGISTRY_COUNTS,
          "registry counts != the reference's 94 small, 14 big")
    predicted = {}
    for name, prog in big.items():
        predicted[name] = prog.state_bytes()
        log(f"registry {name}: state_bytes {predicted[name]} "
            f"({predicted[name] / 2 ** 30:.3f} GiB) before executing")

    # The abstract-only entry is sized and never run: nothing allocated.
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    (row,) = profile_registry({"sparse@10m": big["sparse@10m"]},
                              execute=True, device=dev)
    check(torch.cuda.max_memory_allocated(dev) == before,
          "sparse@10m allocated on the card")
    check(row.execute_skipped == "abstract-only registry entry "
          "(never compiled/executed)" and row.execute_s is None,
          f"sparse@10m: {row}")

    budget = memory_budget(dev)
    t_big = time.perf_counter()
    profiles = profile_registry(big, execute=True, device=dev,
                                window=PROFILE_WINDOW)
    for p in profiles:
        if big[p.name].abstract_only:
            check(p.execute_s is None and p.peak_bytes is None,
                  f"{p.name} executed")
            log("registry " + json.dumps(
                {"program": p.name, "skipped": p.execute_skipped,
                 "argument_bytes": p.argument_bytes, "card": card}))
            continue
        check(p.execute_skipped is None and p.execute_s is not None,
              f"{p.name}: not executed ({p.execute_skipped})")
        check(p.launches > 0 and p.device_ms > 0,
              f"{p.name}: the profiler saw no device work")
        per_tick = p.launches / p.profiled_steps
        want = LAUNCHES_PER_TICK[p.name]
        if not LAUNCH_BAND[0] * want <= per_tick <= LAUNCH_BAND[1] * want:
            # The profiler has lost events in one window of a run (PERF.md
            # section 7): that count is no measurement, so the program is
            # profiled once more, and the new count must lie in the band.
            log(f"registry {p.name}: {per_tick:.1f} launches a tick, outside "
                f"{LAUNCH_BAND} x {want}: the profiler lost events; again")
            (p,) = profile_registry({p.name: big[p.name]}, execute=True,
                                    device=dev, window=PROFILE_WINDOW)
            per_tick = p.launches / p.profiled_steps
        check(LAUNCH_BAND[0] * want <= per_tick <= LAUNCH_BAND[1] * want,
              f"{p.name}: {per_tick:.1f} launches a tick over "
              f"{p.profiled_steps} ticks, outside {LAUNCH_BAND} x {want}")
        check(p.argument_bytes == predicted[p.name],
              f"{p.name}: arguments != state_bytes()")
        memory_gate(p, budget)
        log("registry " + json.dumps({
            "program": p.name, "trace_s": p.trace_s,
            "compile_s": p.compile_s, "execute_s": p.execute_s,
            "profiled_steps": p.profiled_steps, "steps": big[p.name].steps,
            "launches": p.launches, "device_ms": p.device_ms,
            "launches_per_tick": per_tick,
            "device_ms_per_tick": p.device_ms / p.profiled_steps,
            "peak_gib": p.peak_bytes / 2 ** 30,
            "argument_bytes": p.argument_bytes,
            "output_bytes": p.output_bytes, "temp_bytes": p.temp_bytes,
            "gate_gib": budget / 2 ** 30, "device": p.device,
            "card": card}))
    log(f"registry big set profiled in {time.perf_counter() - t_big:.1f} s")

    # cli profile in a process of its own, with a Chrome trace, beside the
    # ladder (whose walls are not measurements).
    t_cli = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli = subprocess.Popen(
            [sys.executable, "-m", "consul_tpu_torch.cli", "profile",
             "--which", "small", "--entry", CLI_PROFILE_ENTRY, "--execute",
             "--format", "json", "--perfetto", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            ring_rows = walk_ladder(small, dev)
            out, err = cli.communicate(timeout=600)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.wait()
        check(cli.returncode == 0,
              f"cli profile exited {cli.returncode}: {err[-2000:]}")
        cli_rows = json.loads(out)["programs"]
        check(bool(cli_rows) and all(
            r["execute_s"] is not None and r["launches"] > 0
            for r in cli_rows), f"cli profile rows: {cli_rows}")
        kernels = _trace_kernels(f"{tmp}/trace.json")
        check(kernels > 0, "cli profile's trace holds no CUDA kernel")
    log(f"cli profile: {len(cli_rows)} programs executed, the Chrome trace "
        f"holds {kernels} kernel events, in "
        f"{time.perf_counter() - t_cli:.1f} s")

    rows = phase_ring_paths(dev, [(path, shape)
                                  for path, shape, _ in ring_rows])
    for row, (_, _, counted) in zip(rows, ring_rows):
        row["launches"] = counted
    wall = time.perf_counter() - t_phase
    log(f"registry phase passed in {wall:.1f} s (aim {PHASE14_AIM_S:.0f})")
    return rows


def main() -> int:
    global _T0
    import faulthandler

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t0 = _T0 = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = phase_card()
    ring_err = phase_ring_kernel(dev)
    phase_threefry(dev)
    broadcast_launches, broadcast_final = phase_slice(dev, card)
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
    study_launches, sparse_twin = phase_sharded_membership(
        dev, card, membership_reports)
    phase_sharded_parity(dev)
    log(f"sharded membership phase passed in {time.perf_counter() - t8:.1f}"
        " s")
    t9 = time.perf_counter()
    stream_paths = phase_ring_paths(dev, stream_ring_shapes())
    stream_launches, preset_off = phase_stream_sharded(dev, card)
    phase_stream_presets(dev, card)
    phase_stream_parity(dev)
    log(f"streamcast phase passed in {time.perf_counter() - t9:.1f} s")
    phase_sweep(dev, card)
    t11 = time.perf_counter()
    composed_row, composed_launches = phase_sweepshard(
        dev, card, membership_reports["membership_sparse_100k_cold"][0],
        sparse_twin)
    phase_sweepshard_small(dev)
    log(f"sweep x shard phase passed in {time.perf_counter() - t11:.1f} s")
    preset_off["probe1k"] = membership_reports["probe1k"][0]
    telemetry_launches = phase_telemetry(dev, card, preset_off)
    (probe1k_row,) = phase_ring_paths(dev, [probe1k_ring_shape(dev)])
    datapoint_launches = phase_bridge(dev, card, broadcast_final)
    # Phase 14 reads none of the earlier phases' reports.
    del membership_reports, sparse_twin, preset_off
    registry_rows = phase_registry(dev, card)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    faulthandler.cancel_dump_traceback_later()
    print(card, flush=True)
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
    composed_row["launches"] = composed_launches
    # Phase 12's ring studies, with the telemetry runs' launches (the
    # event100k and stream100k shapes are timed in phase 9).
    telemetry_rows = []
    for row, tag in ((stream_paths[2], "event100k_d8_ring"),
                     (stream_paths[0], "stream100k_d8_ring"),
                     (probe1k_row, "probe1k_d8_ring")):
        row = dict(row, launches=telemetry_launches[tag])
        if "telemetry" not in row["path"]:
            row["path"] += ", telemetry"
        telemetry_rows.append(row)
    # Phase 13's datapoint runs the broadcast twin at phase 4's shape.
    datapoint_row = dict(
        paths[0], launches=datapoint_launches,
        path="parallel.shard.main (the multichip datapoint), ring")
    paths = (paths + stream_paths + [composed_row] + telemetry_rows
             + [datapoint_row] + registry_rows)
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
