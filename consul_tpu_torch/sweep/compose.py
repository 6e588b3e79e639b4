"""The composed sweep x shard datapoint.

``python -m consul_tpu_torch.sweep.compose`` prints one JSON line with two
parts (the port of ``consul_tpu/sweep/compose.py``):

  max_u_table   the composed sparse@100k program's peak device memory at
                U = 1 and U = 4, unsharded and over D logical shards,
                read with ``torch.cuda.max_memory_allocated``: the bytes
                each further universe adds, and the universes that fit
                in the card's own memory at that rate; beside each, the
                same table from jaxlint J6's estimate (``estimate_peak``
                of one traced tick, nothing allocated), the reference's
                reading, on the card or off it.  The D shards of
                the port live on ONE card and share its memory, so the
                composed column measures what the composed plane costs
                on top of the unsharded one (the outboxes, inboxes and
                per-shard merge streams); it is not a capacity
                multiplier.
  real_run      a composed sparse sweep executed over the shards (U
                universes x n/D nodes a shard), with its rounds/s, the
                overflow per universe (0: every message a single shard
                would have delivered was delivered) and each universe's
                final count of observers holding the crashed node DEAD.

Runs on CUDA unless ``--device cpu`` is given; on the CPU the measured
columns are ``null`` and the J6 ones stand alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from consul_tpu_torch.device import resolve_device
from consul_tpu_torch.models import MembershipConfig, SparseMembershipConfig
from consul_tpu_torch.parallel import mesh_for
from consul_tpu_torch.protocol import LAN
from consul_tpu_torch.sim.engine import run_sweep
from consul_tpu_torch.sweep.universe import Universe, make_sweep, stacked_init


def sparse100k() -> SparseMembershipConfig:
    """The reference's sparse@100k study (``consul_tpu/sweep/
    compose.py:55-59``)."""
    return SparseMembershipConfig(
        base=MembershipConfig(n=100_000, loss=0.01, profile=LAN,
                              fail_at=((42, 5),)),
        k_slots=64,
    )


def peak_bytes(entrypoint: str, cfg, U: int, steps: int, knobs: tuple,
               values: tuple, track: tuple, mesh, device) -> int:
    """Peak device bytes one sweep of ``U`` universes allocates above what
    was allocated before it (state, keys, knobs and every temporary of
    ``steps`` ticks), on a CUDA ``device``."""
    uni = Universe(entrypoint=entrypoint, cfg=cfg, steps=steps,
                   seeds=(0,) * U, knobs=knobs,
                   values=tuple(row[:1] * U for row in values), track=track)
    sweep = make_sweep(entrypoint, U, False, mesh, "alltoall" if mesh is None
                       else "ring")
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = sweep(stacked_init(uni, device), uni.keys(device),
                uni.knob_arrays(device), cfg, steps, knobs, track)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return int(peak)


def estimated_peak_bytes(entrypoint: str, cfg, U: int, steps: int,
                         knobs: tuple, track: tuple, mesh) -> int:
    """jaxlint J6's estimate of the same sweep's peak (one tick traced on
    fake tensors, nothing allocated): the reference's reading of the
    table."""
    from consul_tpu_torch.analysis.graph import capture
    from consul_tpu_torch.analysis.jaxlint import estimate_peak
    from consul_tpu_torch.sweep.universe import abstract_sweep_program

    exchange = "alltoall" if mesh is None else "ring"
    _, make_args = abstract_sweep_program(entrypoint, cfg, steps, U, knobs,
                                          track, False, mesh, exchange)
    fn, _ = abstract_sweep_program(entrypoint, cfg, 1, U, knobs, track,
                                   False, mesh, exchange)
    gm = capture(f"{entrypoint}@U{U}", fn, make_args, steps)
    return estimate_peak(gm).chip_bytes


def _max_u(peaks: dict, total: int) -> dict:
    per_u = max((peaks[4] - peaks[1]) / 3.0, 1.0)
    fixed = max(peaks[1] - per_u, 0.0)
    return {"peak_bytes_u1": peaks[1], "peak_bytes_u4": peaks[4],
            "per_universe_bytes": int(per_u),
            "max_u": int((total - fixed) // per_u)}


def compose_max_u(d_shards: int, device, steps: int = 3) -> dict:
    """The sparse@100k table: bytes per universe at U = 1 and U = 4,
    unsharded and over ``d_shards`` shards, and the universes that fit in
    the card's memory at that rate."""
    from consul_tpu_torch.analysis.jaxlint import H100_80GB_HBM3_BYTES

    cfg = sparse100k()
    knobs, values, track = ("base.loss",), ((0.01,),), (42,)
    on_card = device.type == "cuda"
    total = (torch.cuda.get_device_properties(device).total_memory
             if on_card else H100_80GB_HBM3_BYTES)

    def row(mesh):
        out = {}
        if on_card:
            out = _max_u({u: peak_bytes("sparse", cfg, u, steps, knobs,
                                        values, track, mesh, device)
                          for u in (1, 4)}, total)
        j6 = _max_u({u: estimated_peak_bytes("sparse", cfg, u, steps, knobs,
                                             track, mesh)
                     for u in (1, 4)}, total)
        out.update({f"j6_{k}": v for k, v in j6.items()})
        return out

    unsharded = row(None)
    composed = row(mesh_for(d_shards, device))
    over = ({"composed_overhead_per_universe_bytes": (
        composed["per_universe_bytes"] - unsharded["per_universe_bytes"])}
        if on_card else {})
    return {"sparse@100k": {
        "card": (torch.cuda.get_device_name(device) if on_card
                 else "NVIDIA H100 80GB HBM3 (J6 only, not measured)"),
        "card_bytes": int(total),
        "steps": steps,
        "unsharded": unsharded,
        f"composed_D{d_shards}": dict(composed, devices=d_shards),
        **over,
        "note": ("the D shards share one card's memory: the composed "
                 "column is the composed plane's own cost (outboxes, "
                 "inboxes, per-shard merge streams), not a capacity "
                 "multiplier"),
    }}


def compose_real_run(d_shards: int, n: int, k_slots: int, U: int,
                     steps: int, seed: int, device) -> dict:
    """One composed sparse sweep over ``d_shards`` shards: U universes on
    a loss ladder, overflow reported per universe (the reference's
    ``_compose_real_run``)."""
    cfg = SparseMembershipConfig(
        base=MembershipConfig(n=n, loss=0.01, profile=LAN,
                              fail_at=((42, min(2, steps - 1)),)),
        k_slots=k_slots,
    )
    losses = tuple(0.01 + 0.01 * u for u in range(U))
    uni = Universe(entrypoint="sparse", cfg=cfg, steps=steps,
                   seeds=(seed,) * U, track=(42,), knobs=("base.loss",),
                   values=(losses,))
    t0 = time.perf_counter()
    # Over the ring kernel, so the datapoint runs the port's own exchange.
    rep = run_sweep(uni, warmup=True, mesh=mesh_for(d_shards, device),
                    exchange="ring", device=device)
    wall = time.perf_counter() - t0
    ov = np.asarray(rep.outbox_overflow)
    return {
        "entrypoint": "sparse",
        "nodes": n,
        "k_slots": k_slots,
        "universes": U,
        "devices": d_shards,
        "steps": steps,
        "rounds_per_sec": (U * steps / rep.wall_s) if rep.wall_s > 0
        else None,
        "wall_s": wall,
        "overflow_per_universe": [int(v) for v in ov],
        "overflow_total": int(ov.sum()),
        "dead_known_final": [int(v) for v in
                             rep.metrics["dead_known_final"]],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="consul_tpu_torch.sweep.compose")
    parser.add_argument("--devices", type=int, default=8,
                        help="logical shards of the node axis")
    parser.add_argument("--n", type=int, default=16384,
                        help="real-run nodes across the shards")
    parser.add_argument("--k", type=int, default=32)
    parser.add_argument("--universes", type=int, default=4)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA "
                        "device)")
    parser.add_argument("--skip-real-run", action="store_true",
                        help="the memory table only")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    out = {
        "devices": args.devices,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "max_u_table": compose_max_u(args.devices, device),
    }
    if not args.skip_real_run:
        out["real_run"] = compose_real_run(
            args.devices, args.n, args.k, args.universes, args.steps,
            args.seed, device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
