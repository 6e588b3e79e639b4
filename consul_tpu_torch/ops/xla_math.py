"""float32 transcendentals as the reference's compiled programs compute them.

The reference runs under ``jit`` on XLA's CPU backend, which evaluates
``exp``, ``log``, ``log1p`` and ``erf_inv`` with its own float32
polynomials (Cephes-style for ``exp`` and ``log``; a Cephes rational for
``log1p`` below ``sqrt(2) - 1``; Giles' single-precision approximation for
``erf_inv``), and lets LLVM contract a multiply feeding an add into one
fused multiply-add.  PyTorch's functions are other algorithms and land an
ulp away often (``torch.log`` on 14% of float32 uniforms).  Where a draw
or an integer output depends on those last bits (Knuth's Poisson loop,
``jax.random.normal``, the multi-DC arrival thresholds), the port spells
the same polynomials out here, operation for operation.

A fused multiply-add is evaluated in float64 and rounded once to float32:
the float64 product of two float32 values is exact, so the one float64
rounding of the sum is the only one before the float32 rounding.  Every
other step is one IEEE float32 operation per PyTorch call, so the
results are the same on the CPU and on CUDA (with :func:`sqrt`, as
PyTorch's CPU square root is not correctly rounded).  Held bit for bit against
the JAX package on the CPU by ``tests/test_torch_geo_random.py``.
``expm1`` is not reproduced: its XLA form below |x| = 0.5 is not these
polynomials, and its callers keep the arrival-threshold rule.

Two more of the compiled program's choices are spelled out here:
:func:`cumsum`, the order in which XLA's CPU backend adds a float32
prefix sum, and :func:`pow`, whose float32 result XLA takes from the C
library's ``powf``.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device, filled there (no copy)."""
    return torch.full((), value, dtype=_F32, device=like.device)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (LLVM's contracted multiply-add).
    Operands are float32 tensors or Python floats (taken as float32)."""
    like = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))

    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64)
        return _c(x, like).to(torch.float64)

    return torch.addcmul(f64(c), f64(a), f64(b)).to(_F32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA and CUDA's ``sqrtf``
    give it: PyTorch's vectorised CPU ``sqrt`` lands an ulp off on about
    0.6% of float32 inputs, so the root is taken in float64 (whose one
    rounding back to float32 is then exact for a square root)."""
    return torch.sqrt(x.to(torch.float64)).to(_F32)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``exp``: ``x = n*log(2) + a`` with ``n`` rounded
    from ``x/log(2)``, a degree-7 polynomial for ``e**a``, times ``2**n``
    built in the exponent bits (``n`` clamped to [-127, 127])."""
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.floor(x * _c(1.44269504088896341, x) + _c(0.5, x))
    n = torch.clamp(n, -127.0, 127.0)
    a = fma(-0.693359375, n, x)
    a = fma(2.12194440e-4, n, a)
    z = fma(a, _EXP_P[0], _EXP_P[1])
    for coeff in _EXP_P[2:]:
        z = fma(z, a, coeff)
    z = fma(z, a * a, a)
    z = z + _c(1.0, x)
    pow2 = ((n.to(torch.int32) + 0x7F) << 23).view(_F32)
    return z * pow2


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_MIN_NORMAL = 1.1754943508222875e-38  # float32 0x00800000


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` (the Cephes ``logf`` reduction to a
    mantissa in [sqrt(1/2), sqrt(2)) and a degree-9 polynomial), with
    ``log(0) = -inf``, ``log(inf) = inf`` and NaN below 0."""
    m = torch.clamp(x, min=_MIN_NORMAL)
    bits = m.view(torch.int32)
    e = _c(1.0, x) + ((bits >> 23) - 0x7F).to(_F32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(_F32)  # in [0.5, 1)
    small = m < _c(0.707106781186547524, x)
    t = m - _c(1.0, x)
    e = e - small.to(_F32)
    t = t + torch.where(small, m, _c(0.0, x))
    x2 = t * t
    x3 = x2 * t
    y = fma(t, _LOG_P[0], _LOG_P[1])
    y1 = fma(t, _LOG_P[3], _LOG_P[4])
    y2 = fma(t, _LOG_P[6], _LOG_P[7])
    y = fma(y, t, _LOG_P[2])
    y1 = fma(y1, t, _LOG_P[5])
    y2 = fma(y2, t, _LOG_P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, _c(-2.12194440e-4, x) * e)
    t = t - _c(0.5, x) * x2
    t = t + y
    t = t + _c(0.693359375, x) * e
    # Subnormal inputs are flushed to zero, so they too give -inf.
    t = torch.where((x >= 0) & (x < _MIN_NORMAL), _c(-math.inf, x), t)
    t = torch.where(x == math.inf, _c(math.inf, x), t)
    return torch.where((x < 0) | torch.isnan(x), _c(math.nan, x), t)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553540891750e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: ``log(1 + x)`` where ``|x| >= sqrt(2) - 1``,
    a Cephes rational ``x - x**2/2 + x**3 * P(x)/Q(x)`` below."""
    def horner(coeffs):
        r = torch.zeros_like(x)
        for coeff in coeffs:
            r = fma(r, x, coeff)
        return r

    x2 = x * x
    near = horner(_LOG1P_NUM) / horner(_LOG1P_DEN)
    near = x + (_c(-0.5, x) * x2 + (x * x2) * near)
    far = log(x + _c(1.0, x))
    return torch.where(torch.abs(x) < _c(0.41421356237309504880, x),
                       near, far)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' approximation): ``w =
    -log1p(-x*x)``, a degree-8 polynomial in ``w - 2.5`` below ``w = 5``
    and in ``sqrt(w) - 3`` above, times ``x``; ``+-inf`` at ``x = +-1``."""
    w = -log1p(x * -x)
    lt = w < _c(5.0, x)
    w = torch.where(lt, w - _c(2.5, x), sqrt(w) - _c(3.0, x))
    p = torch.where(lt, _c(_ERFINV_LT5[0], x), _c(_ERFINV_GE5[0], x))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(lt, _c(lo, x), _c(hi, x)))
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


# Block length of XLA's reduce-window rewrite of a prefix sum.
_SCAN_BLOCK = 16


def _block_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis (at most one block long),
    added one element after the other from zero."""
    cols = [x[..., 0] + _c(0.0, x)]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.cumsum`` along the last axis as XLA's CPU backend adds
    it.  The prefix sum lowers to a reduce-window, which XLA rewrites
    into blocks of 16: the input, padded with zeros to whole blocks, is
    summed in order inside each block; the block totals get the same
    treatment recursively, and each block then adds the (exclusive)
    prefix of the totals before it.  Up to 16 elements it is the
    sequential sum.  Every step is one float32 add, so CUDA and the CPU
    agree (``torch.cumsum`` on the CPU accumulates in float64)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _block_scan(x) if n else x.clone()
    nb = -(-n // _SCAN_BLOCK)
    pad = torch.zeros((*x.shape[:-1], nb * _SCAN_BLOCK - n), dtype=x.dtype,
                      device=x.device)
    blocks = _block_scan(torch.cat((x, pad), dim=-1)
                         .unflatten(-1, (nb, _SCAN_BLOCK)))
    totals = cumsum(blocks[..., -1])
    carry = torch.cat((torch.zeros_like(totals[..., :1]), totals[..., :-1]),
                      dim=-1)
    return (blocks + carry[..., None]).flatten(-2)[..., :n]


def pow(x: torch.Tensor, exponent: float) -> torch.Tensor:  # noqa: A001
    """float32 ``x ** exponent`` for a constant float32 ``exponent``, as
    the reference's compiled program gives it.  XLA rewrites a power of
    -1 into the reciprocal, which is reproduced exactly.  Any other power
    it takes from glibc's ``powf``, which is not reproduced: the port
    takes the power in float64 and rounds once, which lands within an ulp
    of ``powf`` (0.06% of float32 uniforms differ).  Where the result is
    floored to a small integer, ``tests/test_torch_streamcast.py``
    enumerates every float32 input near each step and finds no
    difference."""
    if exponent == -1.0:
        return _c(1.0, x) / x
    return torch.pow(x.to(torch.float64), float(exponent)).to(_F32)


def integer_pow(x, y: int) -> torch.Tensor:
    """``x ** y`` for a static int ``y >= 0`` in the order of XLA's
    ``integer_pow``: square-and-multiply from the low bit, so
    ``x**3 = x * (x*x)``."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc
