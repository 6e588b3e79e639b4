"""Vivaldi network coordinates, every node updated at once.

The port of ``consul_tpu/models/vivaldi.py`` (vendor/serf/coordinate/):
one 8-D Euclidean coordinate + height + adjustment per node, updated from
the RTT of each node's probe of one uniform peer:

  update rule        client.go:144-167 updateVivaldi
  adjustment term    client.go:170-187 updateAdjustment
  gravity            client.go:190-196 updateGravity (rho=150)
  force application  coordinate.go:104-118 ApplyForce
  distance           coordinate.go:121-139 DistanceTo
  tuning             config.go:62-71 DefaultConfig

The per-peer median-of-3 latency filter is left out, as in the
reference.  Draws are the reference's: the probe targets from
``sample_probe_targets``, the RTT jitter and the random direction of
coincident points from ``normal`` (bit-equal to ``jax.random.normal``).
The float arithmetic is one IEEE float32 operation per call, sums taken
column by column and square roots correctly rounded, so a round gives the
same bits on the CPU and on CUDA.  The reference's compiled program sums
and fuses multiply-adds in its own order, so a round agrees with the
reference's to a few float32 ulps, not bit for bit
(``tests/test_torch_vivaldi.py`` states the tolerance).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from consul_tpu_torch.device import device_scalar, resolve_device
from consul_tpu_torch.ops import normal, sample_probe_targets, split, xla_math

ZERO_THRESHOLD = 1.0e-6


@dataclasses.dataclass(frozen=True)
class VivaldiConfig:
    """Tuning parameters (coordinate/config.go:62-71 DefaultConfig)."""

    n: int
    dimensionality: int = 8
    vivaldi_error_max: float = 1.5
    vivaldi_ce: float = 0.25
    vivaldi_cc: float = 0.25
    adjustment_window_size: int = 20
    height_min: float = 10.0e-6
    gravity_rho: float = 150.0
    rtt_jitter: float = 0.0   # multiplicative jitter sigma on measured RTTs


class VivaldiState(NamedTuple):
    vec: torch.Tensor          # f32[n, dim]: Euclidean part, seconds
    error: torch.Tensor        # f32[n]: confidence
    height: torch.Tensor       # f32[n]: non-Euclidean access-link term
    adjustment: torch.Tensor   # f32[n]: windowed offset term
    adj_samples: torch.Tensor  # f32[n, window]: ring of rtt - rawdist
    adj_index: torch.Tensor    # int32 scalar: ring position
    tick: torch.Tensor         # int32 scalar


def vivaldi_init(cfg: VivaldiConfig, device=None) -> VivaldiState:
    """All nodes at the origin with the maximum error (coordinate.go:54-61)."""
    dev = resolve_device(device)
    f32 = torch.float32
    return VivaldiState(
        vec=torch.zeros((cfg.n, cfg.dimensionality), dtype=f32, device=dev),
        error=torch.full((cfg.n,), cfg.vivaldi_error_max, dtype=f32,
                         device=dev),
        height=torch.full((cfg.n,), cfg.height_min, dtype=f32, device=dev),
        adjustment=torch.zeros(cfg.n, dtype=f32, device=dev),
        adj_samples=torch.zeros((cfg.n, cfg.adjustment_window_size),
                                dtype=f32, device=dev),
        adj_index=torch.zeros((), dtype=torch.int32, device=dev),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, one column after the other: the same
    float32 result on the CPU and on CUDA, whose reductions associate
    differently."""
    acc = x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c]
    return acc


def _norm(x: torch.Tensor) -> torch.Tensor:
    return xla_math.sqrt(_sum_last(x * x))


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true division on every device (CUDA multiplies by
    the reciprocal of a Python divisor)."""
    return x / device_scalar(d, torch.float32, x.device)


def raw_distance(vec_a: torch.Tensor, h_a: torch.Tensor, vec_b: torch.Tensor,
                 h_b: torch.Tensor) -> torch.Tensor:
    """coordinate.go:141-145 rawDistanceTo: ||a-b|| + heights, seconds."""
    d = vec_a - vec_b
    return xla_math.sqrt(_sum_last(d * d) + 1e-30) + h_a + h_b


def estimated_rtt(state: VivaldiState, i: torch.Tensor,
                  j: torch.Tensor) -> torch.Tensor:
    """coordinate.go:121-133 DistanceTo, adjustments included when the sum
    stays positive."""
    i, j = i.long(), j.long()
    dist = raw_distance(state.vec[i], state.height[i], state.vec[j],
                        state.height[j])
    adjusted = dist + state.adjustment[i] + state.adjustment[j]
    return torch.where(adjusted > 0.0, adjusted, dist)


def _apply_force(vec, height, force, other_vec, other_h, height_min,
                 rand_dir=None):
    """coordinate.go:104-118 ApplyForce: move along the unit vector from
    other toward self; couple the height when not coincident.  Coincident
    points move along ``rand_dir`` normalised (unitVectorAt)."""
    delta = vec - other_vec
    mag = _norm(delta)
    if rand_dir is not None:
        rd = rand_dir / _norm(rand_dir)[:, None]
    else:
        rd = torch.zeros_like(vec)
    apart = mag > ZERO_THRESHOLD
    safe = torch.clamp(mag, min=1e-30)
    unit = torch.where(apart[:, None], delta / safe[:, None], rd)
    new_vec = vec + unit * force[:, None]
    new_height = torch.where(
        apart,
        torch.clamp((height + other_h) * force / safe + height,
                    min=height_min),
        height,
    )
    return new_vec, new_height


def vivaldi_round(state: VivaldiState, key: torch.Tensor, cfg: VivaldiConfig,
                  true_rtt_fn: Callable) -> VivaldiState:
    """One probe round: every node observes the RTT to one uniform peer and
    applies the Vivaldi update.  ``true_rtt_fn(i, j)`` gives ground-truth
    RTTs in seconds for index tensors ``i``, ``j``."""
    n = cfg.n
    dev = state.vec.device
    k_peer, k_jit, k_dir = split(key, 3).unbind(-2)
    i = torch.arange(n, dtype=torch.int32, device=dev)
    j = sample_probe_targets(k_peer, n)

    rtt = true_rtt_fn(i, j)
    if cfg.rtt_jitter > 0.0:
        rtt = rtt * xla_math.exp(cfg.rtt_jitter * normal(k_jit, (n,)))
    rtt = torch.clamp(rtt, min=ZERO_THRESHOLD)  # client.go:147-149

    jl = j.long()
    vec_o, h_o = state.vec[jl], state.height[jl]
    err_o, adj_o = state.error[jl], state.adjustment[jl]

    # updateVivaldi (client.go:144-167): dist is DistanceTo.
    rdist = raw_distance(state.vec, state.height, vec_o, h_o)
    adjusted = rdist + state.adjustment + adj_o
    dist = torch.where(adjusted > 0.0, adjusted, rdist)
    wrongness = torch.abs(dist - rtt) / rtt
    total_error = torch.clamp(state.error + err_o, min=ZERO_THRESHOLD)
    weight = state.error / total_error
    ce = cfg.vivaldi_ce
    new_error = torch.clamp(
        ce * weight * wrongness + state.error * (1.0 - ce * weight),
        max=cfg.vivaldi_error_max,
    )
    force = cfg.vivaldi_cc * weight * (rtt - dist)
    new_vec, new_height = _apply_force(
        state.vec, state.height, force, vec_o, h_o, cfg.height_min,
        rand_dir=normal(k_dir, tuple(state.vec.shape)),
    )

    # updateAdjustment (client.go:170-187), from the UPDATED coordinate.
    sample = rtt - raw_distance(new_vec, new_height, vec_o, h_o)
    w = cfg.adjustment_window_size
    adj_samples = state.adj_samples.clone()
    adj_samples.index_copy_(1, (state.adj_index % w).long().view(1),
                            sample[:, None])
    new_adjustment = _div(_sum_last(adj_samples), 2.0 * w)

    # updateGravity (client.go:190-196): ApplyForce toward the origin.
    origin_vec = torch.zeros_like(new_vec)
    origin_h = torch.zeros_like(new_height)
    g_rdist = raw_distance(new_vec, new_height, origin_vec, origin_h)
    g_adjusted = g_rdist + new_adjustment
    g_dist = torch.where(g_adjusted > 0.0, g_adjusted, g_rdist)
    g_scaled = _div(g_dist, cfg.gravity_rho)
    g_force = -1.0 * (g_scaled * g_scaled)
    new_vec, new_height = _apply_force(new_vec, new_height, g_force,
                                       origin_vec, origin_h, cfg.height_min)

    return VivaldiState(
        vec=new_vec, error=new_error, height=new_height,
        adjustment=new_adjustment, adj_samples=adj_samples,
        adj_index=state.adj_index + 1, tick=state.tick + 1,
    )


def euclidean_rtt_model(positions: torch.Tensor) -> Callable:
    """Ground-truth RTT = Euclidean distance between latent positions
    (seconds).  positions: f32[n, d_true]."""

    def true_rtt(i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        d = positions[i.long()] - positions[j.long()]
        return xla_math.sqrt(_sum_last(d * d) + 1e-30)

    return true_rtt
