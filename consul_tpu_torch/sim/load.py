"""Adversarial offered-load generators for the streaming planes.

The port of ``consul_tpu/sim/load.py``: pure functions that shape a
clean arrival schedule into the regimes production event traffic shows
(a queue that wakes up holding work, heavy-tailed payloads, publishers
clustered on a hot node):

  standing_backlog   pin the first B arrivals to tick 0
  paced_ticks        constant-interval birth ticks at the Poisson
                     stream's mean rate (the deterministic knee stream)
  heavy_tail_sizes   Pareto(tail) chunk counts over [1, E]; 0 disables
  hotspot_origins    re-originate a ``frac`` of arrivals at one node

The disable values (backlog 0, tail 0.0, frac 0.0) leave the schedule
unchanged.  Each severity draw comes from the caller's salted key, never
from the gap, origin or name streams.

Rates and severities are the static config's Python floats in a plain
run.  Under ``jit`` the reference's ``x / rate`` with a constant
``rate`` compiles to ``x * (1 / rate)``, the reciprocal rounded to
float32, and the port computes that product.  A universe sweep passes
``[U]`` tensors (one value per universe, key batch ``[U, 2]``); the
reference's traced program then keeps the true float32 division, takes
a heavy tail's power from ``powf`` at every tail (1.0 included) and
never skips a draw for a zero severity, and so does the port there.
"""

from __future__ import annotations

import numpy as np
import torch

from consul_tpu_torch.ops import uniform, xla_math
from consul_tpu_torch.ops.knobs import is_knob, lift


def traced_rate(rate: torch.Tensor) -> torch.Tensor:
    """``max(rate, 1e-6)`` of a swept ``[U]`` rate as a ``[U, 1]`` float32
    divisor (the reference divides by it truly)."""
    return lift(torch.clamp(rate.to(torch.float32), min=1e-6), 1)


def rate_reciprocal(rate: float) -> float:
    """float32 ``1 / max(rate, 1e-6)``, both operands float32: the
    multiplier XLA substitutes for the reference's division by the
    constant ``jnp.maximum(jnp.asarray(rate, f32), 1e-6)``."""
    rate_f = max(np.float32(rate), np.float32(1e-6))
    return float(np.float32(1.0) / rate_f)


def standing_backlog(ev_tick: torch.Tensor, backlog: int) -> torch.Tensor:
    """Pin the first ``backlog`` schedule entries to tick 0: the run
    starts with B events in flight, then the ongoing arrival process."""
    if backlog <= 0:
        return ev_tick
    idx = torch.arange(ev_tick.shape[-1], dtype=torch.int64,
                       device=ev_tick.device)
    return torch.where(idx < backlog, 0, ev_tick)


def paced_ticks(k: int, rate: float, device) -> torch.Tensor:
    """int32[k] staggered birth ticks: event i is born at
    ``floor(i / rate)``, one event every ``1/rate`` ticks with no burst
    variance (computed as the compiled reference computes it, see the
    module docstring); a swept rate gives ``[U, k]``."""
    idx = torch.arange(k, dtype=torch.float32, device=device)
    if is_knob(rate):
        return torch.floor(idx / traced_rate(rate)).to(torch.int32)
    recip = torch.full((), rate_reciprocal(rate), dtype=torch.float32,
                       device=device)
    return torch.floor(idx * recip).to(torch.int32)


def heavy_tail_sizes(key: torch.Tensor, k: int, e_max: int,
                     tail: float) -> torch.Tensor:
    """int32[k] per-event chunk counts in [1, e_max]: Pareto(x_min=1,
    index=tail) sizes ``floor(u ** (-1/tail))`` clipped to the static E
    ceiling, ``u`` uniform in [1e-7, 1).  ``tail`` 0 gives every event
    the full ``e_max``: the reference draws and discards, the port skips
    the draw.  A swept ``[U]`` tail (key ``[U, 2]``) draws for every
    universe: the exponent ``f32(-1) / max(tail, 1e-6)`` in float32, the
    power in float64 rounded once (``powf`` in the reference, 1.0
    included), and ``e_max`` where the tail is 0."""
    if is_knob(tail):
        u = uniform(key, (k,), 1e-7, 1.0)
        tail_f = tail.to(torch.float32)
        exponent = -1.0 / torch.clamp(tail_f, min=1e-6)
        power = torch.pow(u.double(), lift(exponent, 1).double()).float()
        pareto = torch.clamp(torch.floor(power), 1.0, float(e_max))
        return torch.where(lift(tail_f > 0.0, 1), pareto.to(torch.int32),
                           e_max)
    if not tail > 0.0:
        return torch.full((k,), e_max, dtype=torch.int32, device=key.device)
    u = uniform(key, (k,), 1e-7, 1.0)
    alpha = max(np.float32(tail), np.float32(1e-6))
    exponent = float(np.float32(-1.0) / alpha)
    pareto = torch.floor(xla_math.pow(u, exponent))
    return torch.clamp(pareto, 1.0, float(e_max)).to(torch.int32)


def hotspot_origins(key: torch.Tensor, ev_origin: torch.Tensor, frac: float,
                    node: int) -> torch.Tensor:
    """Each event publishes from the hot ``node`` with probability
    ``frac`` (a float32 uniform below float32 ``frac``); ``frac`` 0 keeps
    every origin, and the port then skips the draw.  A swept ``[U]``
    ``frac`` always draws."""
    if is_knob(frac):
        u = uniform(key, tuple(ev_origin.shape[key.dim() - 1:]))
        hot = u < lift(frac.to(torch.float32), 1)
        return torch.where(hot, node, ev_origin).to(torch.int32)
    if not frac > 0.0:
        return ev_origin
    u = uniform(key, tuple(ev_origin.shape[key.dim() - 1:]))
    hot = u < torch.full((), frac, dtype=torch.float32, device=key.device)
    return torch.where(hot, node, ev_origin).to(torch.int32)
