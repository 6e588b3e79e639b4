"""Shared comparison rules of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's PyTorch side on one intra-op thread, then restore the
    count, which the fixture yields.  Under ``pytest -n 6`` every worker's
    OpenMP pool would otherwise spin 8 threads on 8 cores, and the many
    small tensor ops of a streamcast tick slow down tenfold.  A module
    that uses it checks its parity at one thread; a test that needs the
    default count sets it back for its own run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield threads
    torch.set_num_threads(threads)


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps between non-negative floats."""
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


def _threshold64(lam) -> np.ndarray:
    return (-np.expm1(-np.asarray(lam, np.float64))).astype(np.float32)


def check_arrivals(u_j, u_t, thr_j, thr_t, lam, got_j, got_t,
                   lam_t=None) -> int:
    """Aggregate delivery: ``got = u < 1 - exp(-lam)`` in both packages.

    The uniforms must be bit-equal.  The thresholds are not: XLA's CPU
    expm1 lands up to 5 float32 ulps from the float64 value (measured on
    jax 0.9.0 over lam in [0, 10)), PyTorch's within 1.  So the port's
    threshold is held within 1 ulp of float64, the reference's within 5,
    and a receiver may differ only where the shared uniform lies between
    the two thresholds.  ``lam`` is the reference's rate; ``lam_t``, where
    the port's differs from it, the port's.  Returns how many receivers
    differ."""
    np.testing.assert_array_equal(u_j.view(np.uint32), u_t.view(np.uint32))
    lam_t = lam if lam_t is None else lam_t
    assert ulps(thr_t, _threshold64(lam_t)).max() <= 1
    assert ulps(thr_j, _threshold64(lam)).max() <= 5
    np.testing.assert_array_equal(got_j, u_j < thr_j)
    np.testing.assert_array_equal(got_t, u_t < thr_t)
    flip = got_j != got_t
    lo = np.minimum(thr_j, thr_t)[flip]
    hi = np.maximum(thr_j, thr_t)[flip]
    assert np.all((lo <= u_j[flip]) & (u_j[flip] < hi))
    return int(flip.sum())
