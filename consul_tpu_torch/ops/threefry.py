"""Threefry-2x32 keys and draws, bit for bit those of ``jax.random``.

Every random draw of the reference derives from ``jax.random``'s
threefry2x32 keys (jax 0.9.0 with ``jax_threefry_partitionable=True``),
so the port reproduces that generator exactly:

* :func:`threefry2x32` — the 20-round block function
  (``jax/_src/prng.py`` ``_threefry2x32_lowering``);
* :func:`PRNGKey`, :func:`fold_in` and :func:`split` — the key
  constructors (``prng.py`` ``threefry_seed``, ``_threefry_fold_in``,
  ``_threefry_split_foldlike``);
* :func:`random_bits`, :func:`uniform` and :func:`randint` — the draws
  (``prng.py`` ``_threefry_random_bits_partitionable``;
  ``jax/_src/random.py`` ``_uniform``, ``_randint``);
* :func:`normal`, :func:`exponential` and :func:`poisson` —
  ``jax/_src/random.py`` ``_normal_real``, ``_exponential`` and
  ``_poisson`` (Knuth below lam 10, Hormann's transformed rejection
  above), over the float32 functions of
  :mod:`consul_tpu_torch.ops.xla_math`.

A key is an int64 tensor of shape ``[..., 2]`` holding two uint32
words; leading dimensions are a batch of keys (what ``jax.vmap`` over
keys gives in the reference).  A draw of shape ``shape`` from a key
batch ``[..., 2]`` has shape ``[..., *shape]``.  All arithmetic is
int64 masked to 32 bits: PyTorch has no ``+``, ``<<`` or ``>>`` on
``torch.uint32`` on the CPU, and the same code then runs on the CPU and
on CUDA with identical results.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from consul_tpu_torch.device import device_scalar
from consul_tpu_torch.ops import xla_math
from consul_tpu_torch.ops.sortmerge import host_cond

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _as_u32(x, device) -> torch.Tensor:
    """Python int or integer tensor -> int64 tensor of its uint32 bits."""
    return device_scalar(x, torch.int64, device) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block function over broadcasting int64 tensors
    of uint32 values: key ``(k0, k1)``, counter ``(x0, x1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1).bitwise_and_(MASK32)
            x1 = ((x1 << r) | (x1 >> (32 - r))).bitwise_and_(MASK32)
            x1 = x1.bitwise_xor_(x0)
        x0 = (x0 + ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1 = (x1 + ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK32)
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (jax name)
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    if not -(2 ** 31) <= int(seed) < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the uint32 ``data`` into ``key``.

    The seed key of ``data`` is ``[0, data]``, so this is the block
    function on counter ``(0, data)``.  ``data`` broadcasts against
    the key batch: a key ``[2]`` with ids ``[m]`` gives keys ``[m, 2]``."""
    d = _as_u32(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _iota_counts(shape: tuple, device) -> torch.Tensor:
    """Low words of the reshaped uint64 iota; the high words are zero
    for every draw smaller than 2**32 elements."""
    total = math.prod(shape)
    if total >= 2 ** 32:
        raise ValueError(f"draw of {total} values needs high counter words")
    return torch.arange(total, dtype=torch.int64, device=device).reshape(shape)


def _bits_pair(key: torch.Tensor, shape: tuple):
    """Block function of each key in the batch over the draw's counters:
    two ``[..., *shape]`` words."""
    lo = _iota_counts(shape, key.device)
    expand = (slice(None),) * (key.dim() - 1) + (None,) * len(shape)
    k0 = key[..., 0][expand]
    k1 = key[..., 1][expand]
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (foldlike form): ``[..., 2]`` -> ``[..., num, 2]``."""
    y0, y1 = _bits_pair(key, (num,))
    return torch.stack((y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """32-bit ``jax.random.bits``: int64 ``[..., *shape]`` of uint32 values."""
    y0, y1 = _bits_pair(key, tuple(shape))
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` in [minval, maxval): the top 23 bits
    as the mantissa of a float in [1, 2), minus one, then
    ``max(minval, floats * (maxval - minval) + minval)`` with the bounds
    and their difference in float32 and the multiply-add fused, as XLA
    compiles it.  On [0, 1) that is the floats themselves."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return floats
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    lo_t = torch.full((), float(lo), dtype=torch.float32, device=key.device)
    return torch.maximum(lo_t, xla_math.fma(floats, float(span), lo_t))


def normal(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """float32 ``jax.random.normal``: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform in [nextafter(-1, 0), 1), ``erf_inv`` as XLA evaluates it."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    sqrt2 = torch.full((), float(np.float32(np.sqrt(2))), dtype=torch.float32,
                       device=key.device)
    return sqrt2 * xla_math.erf_inv(u)


def exponential(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """float32 ``jax.random.exponential``: ``-log1p(-u)`` with ``u``
    uniform in [0, 1) and ``log1p`` as XLA evaluates it."""
    return -xla_math.log1p(-uniform(key, shape))


# Knuth iterations between two host reads of the loop predicate.
POISSON_BLOCK = 8


def _poisson_knuth(key: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Knuth's count over every lane: each iteration takes the next split
    of the carried key, draws a float32 uniform per lane, and a lane
    counts while its running float32 sum of logs stays above ``-lam``.
    The reference stops at the first iteration where no lane counts; a
    lane's sum only falls, so iterations past that change nothing, and
    the port runs them ``POISSON_BLOCK`` at a time with one host read a
    block.  For a key batch ``[*B, 2]`` (``lam`` ``[*B, ...]``) the loop
    runs while any lane of any universe counts, as the reference's
    batched loop does: a universe whose lanes are all done gains nothing
    from the extra iterations."""
    shape = tuple(lam.shape[key.dim() - 1:])
    k = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros(lam.shape, dtype=torch.float32, device=lam.device)
    neg_lam = -lam
    rng = key
    while True:
        subkeys = []
        for _ in range(POISSON_BLOCK):
            rng, sub = split(rng).unbind(-2)
            subkeys.append(sub)
        logs = xla_math.log(uniform(torch.stack(subkeys), shape))
        for i in range(POISSON_BLOCK):
            k = k + (log_prod > neg_lam).to(torch.int32)
            log_prod = log_prod + logs[i]
        if not host_cond(  # tracelint: disable=R2 (block test)
                (log_prod > neg_lam).any()):
            return k - 1


def _poisson_rejection(key: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Hormann's transformed rejection (``jax/_src/random.py``
    ``_poisson_rejection``) with XLA's fused multiply-adds.  A lane keeps
    the ``k`` of its LAST accepting iteration, so the iteration count
    matters: the loop reads its predicate every iteration, as the
    reference's does.  ``lgamma`` is PyTorch's.  For a key batch
    ``[*B, 2]`` a universe whose lanes have all accepted stops updating,
    as in the reference's batched loop, while the others go on."""
    f32 = torch.float32

    def c(v):
        return torch.full((), v, dtype=f32, device=lam.device)

    log_lam = xla_math.log(lam)
    b = xla_math.fma(2.53, xla_math.sqrt(lam), 0.931)
    a = xla_math.fma(0.02483, b, -0.059)
    inv_alpha = c(1.1239) + c(1.1328) / (b - c(3.4))
    v_r = c(0.9277) - c(3.6224) / (b - c(2.0))
    k_out = torch.full(lam.shape, -1.0, dtype=f32, device=lam.device)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    nb = key.dim() - 1
    shape = tuple(lam.shape[nb:])
    lane_dims = tuple(range(nb, lam.dim()))
    while True:
        keys = split(key, 3)
        key, k0, k1 = keys.unbind(-2)
        u = uniform(k0, shape) - c(0.5)
        v = uniform(k1, shape)
        u_shifted = c(0.5) - torch.abs(u)
        kk = torch.floor(
            xla_math.fma(c(2.0) * a / u_shifted + b, u, lam) + c(0.43))
        s = xla_math.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = xla_math.fma(kk, log_lam, -lam) - torch.lgamma(kk + c(1.0))
        accept1 = (u_shifted >= c(0.07)) & (v <= v_r)
        reject = (kk < 0) | ((u_shifted < c(0.013)) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        if nb:
            open_u = torch.any(~accepted, dim=lane_dims, keepdim=True)
            accept = accept & open_u
        k_out = torch.where(accept, kk, k_out)
        accepted = accepted | accept
        if not host_cond(  # tracelint: disable=R2 (a while_loop)
                (~accepted).any()):
            return k_out.to(torch.int32)


def poisson(key: torch.Tensor, lam: torch.Tensor,
            lam_max: float = None) -> torch.Tensor:
    """int32 ``jax.random.poisson(key, lam)`` for a float32 ``lam``: Knuth
    where ``lam < 10``, Hormann's rejection elsewhere, 0 where
    ``lam == 0``.  The rejection branch runs only where some lane may
    reach 10: ``lam_max``, a static bound on ``lam`` from the caller's
    config, below 10 says none can; without it the lanes are read on the
    host (one synchronisation).  Both branches are counted in
    ``host_cond.syncs``."""
    use_knuth = torch.isnan(lam) | (lam < 10)
    zero = torch.zeros((), dtype=torch.float32, device=lam.device)
    result = _poisson_knuth(key, torch.where(use_knuth, lam, zero))
    if lam_max is None or lam_max >= 10:
        if host_cond(  # tracelint: disable=R2 (a lax.cond)
                (~use_knuth).any()):
            big = torch.full((), 1e5, dtype=torch.float32, device=lam.device)
            rejected = _poisson_rejection(
                key, torch.where(use_knuth, big, lam))
            result = torch.where(use_knuth, result, rejected)
    return torch.where(lam == 0, torch.zeros_like(result), result)


def _clip_int32(x) -> torch.Tensor:
    return torch.clamp(x, -(2 ** 31), 2 ** 31 - 1)


def randint(key: torch.Tensor, shape: tuple, minval, maxval) -> torch.Tensor:
    """int32 ``jax.random.randint`` in [minval, maxval).

    As in the reference: the key splits in two, each half draws 32 bits,
    and the pair is reduced modulo the span with the multiply-mod step
    ``(hi % span) * (2**16 % span)**2 + lo % span``, every product and
    sum wrapping at 32 bits.  ``minval`` and ``maxval`` are ints or
    int tensors that broadcast against ``[..., *shape]``."""
    dev = key.device
    minval = device_scalar(minval, torch.int64, dev)
    maxval = device_scalar(maxval, torch.int64, dev)
    out_of_range = maxval > 2 ** 31 - 1
    minval = _clip_int32(minval)
    maxval = _clip_int32(maxval)
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & MASK32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    span = torch.where(out_of_range & (maxval > minval),
                       (span + 1) & MASK32, span)
    # A span that wrapped to 0 (the full 2**32 range) leaves the offset
    # as the raw bits, as the reference's remainders by zero do.
    safe = torch.where(span == 0, torch.full_like(span, 2 ** 32), span)
    mult = (2 ** 16) % safe
    mult = ((mult * mult) & MASK32) % safe
    off = (((higher % safe) * mult) & MASK32) + (lower % safe)
    off = (off & MASK32) % safe
    return ((minval + off) & MASK32).to(torch.int32)
