"""Vivaldi-derived WAN link latencies: coordinates feed the geo plane.

The port of ``consul_tpu/geo/latency.py``:

  1. **Latent DC-clustered placement.**  Each segment (DC) gets a cluster
     center in a latent metric space; its bridge nodes sit at the center
     plus LAN-scale jitter.  Ground-truth RTT is the latent distance, so
     intra-DC RTTs are about ``lan_scale`` and inter-DC RTTs about
     ``dc_scale``, exaggerated so that a link's latency spans several
     200 ms ticks.
  2. **Vivaldi to convergence.**  The bridge population runs
     ``vivaldi_round``; the median relative error of the converged
     coordinates is returned, so convergence is measured.
  3. **Per-link latency matrix.**  The converged coordinates (not the
     latent truth) give each segment pair's one-way latency in ticks: the
     mean estimated RTT between the two bridge sets, symmetrised, halved,
     rounded and clipped into the geo ring window.

The result is a static tuple of ints that goes into ``GeoConfig``; it
equals the reference's (``tests/test_torch_vivaldi.py``).  The
derivation runs on the caller's device (CUDA unless given) and reduces
the converged matrices on the host with the reference's numpy code.
"""

from __future__ import annotations

import numpy as np
import torch

from consul_tpu_torch.device import resolve_device
from consul_tpu_torch.models.vivaldi import (
    VivaldiConfig,
    euclidean_rtt_model,
    raw_distance,
    vivaldi_init,
    vivaldi_round,
)
from consul_tpu_torch.ops import PRNGKey, fold_in, normal, split

#: Default latent scales (seconds): dc_scale spreads the one-way
#: latencies over the ring window at the LAN 200 ms tick; lan_scale is the
#: intra-DC jitter around each center.
DC_SCALE_S = 0.6
LAN_SCALE_S = 0.01


def dc_placement(segments: int, bridges_per_segment: int, seed: int = 0,
                 dim_true: int = 3, dc_scale: float = DC_SCALE_S,
                 lan_scale: float = LAN_SCALE_S,
                 device=None) -> torch.Tensor:
    """f32[S*B, dim_true] latent positions of the bridge population:
    per-segment centers plus per-node jitter, bridges of segment s at rows
    [s*B, (s+1)*B)."""
    dev = resolve_device(device)
    k_centers, k_jitter = split(PRNGKey(seed, device=dev)).unbind(-2)
    centers = normal(k_centers, (segments, dim_true)) * dc_scale
    jitter = normal(k_jitter, (segments * bridges_per_segment, dim_true))
    return (torch.repeat_interleave(centers, bridges_per_segment, dim=0)
            + jitter * lan_scale)


def derive_wan_latency(segments: int, bridges_per_segment: int,
                       tick_ms: float, seed: int = 0, rounds: int = 400,
                       wan_window: int = 8, dim_true: int = 3,
                       rtt_jitter: float = 0.05,
                       dc_scale: float = DC_SCALE_S,
                       lan_scale: float = LAN_SCALE_S, device=None):
    """Run Vivaldi to convergence over the DC-clustered placement and
    derive the per-segment-pair one-way WAN latency in ticks.

    Returns ``(latency_ticks, info)``: ``latency_ticks`` is tuple[S][S] of
    ints, symmetric, diagonal 0, off-diagonal clipped into [1, wan_window
    - 1]; ``info`` holds the median relative RTT error of the converged
    coordinates over cross-DC bridge pairs (``rel_rtt_error``), the mean
    cross-DC RTT in ms, the rounds run and the population size."""
    if wan_window < 2:
        raise ValueError(f"wan_window={wan_window} leaves no room for a "
                         "latency of >= 1 tick")
    dev = resolve_device(device)
    positions = dc_placement(segments, bridges_per_segment, seed=seed,
                             dim_true=dim_true, dc_scale=dc_scale,
                             lan_scale=lan_scale, device=dev)
    nv = segments * bridges_per_segment
    cfg = VivaldiConfig(n=nv, rtt_jitter=rtt_jitter)
    rtt_fn = euclidean_rtt_model(positions)
    st = vivaldi_init(cfg, device=dev)
    key = fold_in(PRNGKey(seed, device=dev), 0x6E0)
    for i in range(rounds):
        st = vivaldi_round(st, fold_in(key, i), cfg, rtt_fn)

    # Converged pairwise estimates (DistanceTo, adjustments included when
    # positive) and the latent ground truth.
    idx = torch.arange(nv, dtype=torch.int32, device=dev)
    i = torch.repeat_interleave(idx, nv)
    j = idx.repeat(nv)
    est = _estimated_rtt_matrix(st, i, j).reshape(nv, nv).cpu().numpy()
    true = rtt_fn(i, j).reshape(nv, nv).cpu().numpy()

    seg = np.arange(nv) // bridges_per_segment
    cross = seg[:, None] != seg[None, :]
    rel_err = float(np.median(
        np.abs(est[cross] - true[cross]) / np.maximum(true[cross], 1e-9)
    ))

    # Per-link mean estimated RTT between the two bridge sets.
    rtt_sd = np.zeros((segments, segments))
    for s in range(segments):
        for d in range(segments):
            if s == d:
                continue
            block = est[np.ix_(seg == s, seg == d)]
            rtt_sd[s, d] = float(block.mean())
    rtt_sd = 0.5 * (rtt_sd + rtt_sd.T)  # RTT is symmetric by contract

    one_way_ticks = np.rint(rtt_sd * 1000.0 / 2.0 / tick_ms)
    ticks = np.clip(one_way_ticks, 1, wan_window - 1).astype(int)
    np.fill_diagonal(ticks, 0)
    latency = tuple(tuple(int(v) for v in row) for row in ticks)
    info = {
        "rel_rtt_error": rel_err,
        "mean_cross_rtt_ms": float(
            rtt_sd[~np.eye(segments, dtype=bool)].mean() * 1000.0
        ),
        "rounds": rounds,
        "population": nv,
    }
    return latency, info


def _estimated_rtt_matrix(st, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """coordinate.go DistanceTo over index tensors, from the CONVERGED
    coordinates."""
    i, j = i.long(), j.long()
    dist = raw_distance(st.vec[i], st.height[i], st.vec[j], st.height[j])
    adjusted = dist + st.adjustment[i] + st.adjustment[j]
    return torch.where(adjusted > 0.0, adjusted, dist)
