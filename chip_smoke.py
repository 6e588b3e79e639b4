#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``consul_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository.  Phases, each fatal on failure:

  1. the card: print the card's name and power limit, build every
     CUDA kernel of the port from ``consul_tpu_torch/csrc``;
  2. kernels against their plain versions, bit for bit, at small shapes
     and at the shapes of the main path, and timed there with CUDA events
     beside the plain version, the one-call PyTorch yardstick and the
     card's memory-bandwidth bound;
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


def kernel_busy_ms(fn, kernel: str, iters: int = 50) -> float:
    """Mean device time of one launch of the kernel whose name contains
    ``kernel``, over ``iters`` calls of ``fn()`` under ``torch.profiler``:
    the kernel alone, without host time between launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and kernel in evt.key):
            return evt.self_device_time_total / evt.count / 1e3
    raise SystemExit(f"FAILED: profiler saw no {kernel} kernel")


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


def phase_ring_kernel(dev) -> dict:
    """Ring kernel against its plain version; times at the slice's shape."""
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

    box = box_of(main_shape)
    ms = cuda_ms(lambda: ring_exchange(box))
    plain_ms = cuda_ms(lambda: ring_exchange_plain(box))
    library_ms = cuda_ms(lambda: box.transpose(0, 1).contiguous())
    busy_ms = kernel_busy_ms(lambda: ring_exchange(box), "ring_exchange")
    nbytes = 2 * box.numel() * box.element_size()
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"ring kernel at {main_shape}: {ms!r} ms (CUDA events, median of 5 "
        f"windows of 50 calls), {busy_ms!r} ms a launch (profiler, kernel "
        f"alone), plain {plain_ms!r} ms, transpose().contiguous() "
        f"{library_ms!r} ms, bound {bound_ms!r} ms ({nbytes} bytes)")
    return {
        "name": "ring_exchange",
        "route": "cuda",
        "source": "consul_tpu_torch/csrc/ring_exchange.cu",
        "replaces": "consul_tpu/ops/ring_exchange.py:67",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


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


def phase_membership(dev, card: str) -> None:
    """The membership slice's studies.  The path runs no kernel of the
    port's own: the ring kernel's count, zeroed before each run, must read
    0 after it."""
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
        return cfg, rep, row

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
    ring = phase_ring_kernel(dev)
    phase_threefry(dev)
    ring["launches"] = phase_slice(dev, card)
    phase_swim(dev, card)
    phase_lifeguard(dev, card)
    phase_membership(dev, card)
    phase_membership_parity(dev)
    phase_small_parity(dev)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({"kernels": [ring]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
