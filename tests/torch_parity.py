"""Shared comparison rules of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps between non-negative floats."""
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


def check_arrivals(u_j, u_t, thr_j, thr_t, lam, got_j, got_t) -> int:
    """Aggregate delivery: ``got = u < 1 - exp(-lam)`` in both packages.

    The uniforms must be bit-equal.  The thresholds are not: XLA's CPU
    expm1 lands up to 5 float32 ulps from the float64 value (measured on
    jax 0.9.0 over lam in [0, 10)), PyTorch's within 1.  So the port's
    threshold is held within 1 ulp of float64, the reference's within 5,
    and a receiver may differ only where the shared uniform lies between
    the two thresholds.  Returns how many receivers differ."""
    np.testing.assert_array_equal(u_j.view(np.uint32), u_t.view(np.uint32))
    truth = (-np.expm1(-lam.astype(np.float64))).astype(np.float32)
    assert ulps(thr_t, truth).max() <= 1
    assert ulps(thr_j, truth).max() <= 5
    np.testing.assert_array_equal(got_j, u_j < thr_j)
    np.testing.assert_array_equal(got_t, u_t < thr_t)
    flip = got_j != got_t
    lo = np.minimum(thr_j, thr_t)[flip]
    hi = np.maximum(thr_j, thr_t)[flip]
    assert np.all((lo <= u_j[flip]) & (u_j[flip] < hi))
    return int(flip.sum())
