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
  4. the slice: the 1M-node Serf event broadcast (LAN, fanout 4, edges,
     30 ticks, seed 0) unsharded and over 8 logical shards with both
     outbox transports, bit-equal per tick with no overflow, the ring
     kernel launched once per tick; the 1M-node aggregate study
     (60 ticks); and a small study held against the port on the CPU.

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = phase_card()
    ring = phase_ring_kernel(dev)
    phase_threefry(dev)
    ring["launches"] = phase_slice(dev, card)
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
