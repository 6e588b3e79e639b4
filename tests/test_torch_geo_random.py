"""The geo slice's new draws and float32 functions against the JAX package.

* ``uniform(key, shape, minval, maxval)``, ``normal`` and the Knuth branch
  of ``poisson`` (lam in [0, 10)) are bit-equal to ``jax.random``;
* the rejection branch (lam in [10, 1000]) is bit-equal where PyTorch's
  ``lgamma`` agrees with XLA's: the lanes that differ are counted and at
  most 1 in 500;
* ``ops.xla_math``'s ``exp``, ``log``, ``log1p`` and ``erf_inv`` are
  bit-equal to the jitted ``jnp``/``lax`` functions on float32 grids.

All on the CPU, keys and grids made from seeds with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from consul_tpu_torch.convert import key_from_numpy
from consul_tpu_torch.ops import normal, poisson, threefry, uniform, xla_math
from consul_tpu_torch.ops.sortmerge import host_cond


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _keys(seed: int, count: int):
    keys = jax.random.split(jax.random.PRNGKey(seed), count)
    return [(k, key_from_numpy(np.asarray(k))) for k in keys]


def _uniform_grid(seed: int, size: int) -> np.ndarray:
    """float32 values on [0, 1)'s 2**-23 grid, as the uniforms are."""
    bits = np.random.default_rng(seed).integers(0, 2 ** 23, size)
    return (bits * 2.0 ** -23).astype(np.float32)


@pytest.mark.parametrize("lo,hi", [(-3.0, 5.5), (0.1, 0.2), (-1e-3, 7.0),
                                   (0.0, 1.0)])
def test_bounded_uniform_bit_equal(lo, hi):
    for jk, tk in _keys(11, 6):
        want = jax.random.uniform(jk, (4096,), jnp.float32, lo, hi)
        got = uniform(tk, (4096,), lo, hi)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


@pytest.mark.parametrize("shape", [(5000,), (40, 8), (3, 7, 11)])
def test_normal_bit_equal(shape):
    for jk, tk in _keys(5, 8):
        want = jax.random.normal(jk, shape)
        got = normal(tk, shape)
        assert got.shape == shape and got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def _lam_grid(seed, lo, hi, shape=(64, 16)):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_poisson_knuth_bit_equal(seed):
    lam = _lam_grid(seed, 0.0, 10.0)
    lam[0, :5] = 0.0
    lam[1, :3] = np.float32(10.0) - np.float32(2 ** -20)
    (jk, tk), = _keys(seed, 1)
    want = np.asarray(jax.random.poisson(jk, jnp.asarray(lam)))
    got = poisson(tk, torch.from_numpy(lam), lam_max=9.99).numpy()
    assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(want, got)
    assert np.all(got[0, :5] == 0)


@pytest.mark.parametrize("block", (1, 3, 32))
def test_poisson_block_size_does_not_change_the_draw(monkeypatch, block):
    lam = torch.from_numpy(_lam_grid(3, 0.0, 10.0))
    (_, tk), = _keys(3, 1)
    want = poisson(tk, lam, lam_max=9.99)
    monkeypatch.setattr(threefry, "POISSON_BLOCK", block)
    assert torch.equal(want, poisson(tk, lam, lam_max=9.99))


def test_poisson_block_predicate_reads():
    """One host read a block of 8 while every lane's count is below 8."""
    lam = torch.full((64, 16), 0.5)
    (_, tk), = _keys(9, 1)
    before = host_cond.syncs
    out = poisson(tk, lam, lam_max=1.0)
    assert int(out.max()) < 8
    assert host_cond.syncs - before == 1


@pytest.mark.parametrize("seed", range(4))
def test_poisson_rejection_lanes_counted(seed):
    lam = _lam_grid(seed, 10.0, 1000.0)
    lam[0, :8] = _lam_grid(seed + 100, 0.0, 10.0, (8,))
    (jk, tk), = _keys(seed, 1)
    want = np.asarray(jax.random.poisson(jk, jnp.asarray(lam)))
    got = poisson(tk, torch.from_numpy(lam)).numpy()
    differ = want != got
    print(f"seed {seed}: {int(differ.sum())} of {lam.size} rejection lanes "
          "differ")
    assert differ.sum() <= lam.size // 500
    np.testing.assert_array_equal(want[0, :8], got[0, :8])  # Knuth lanes
    # The rejection branch must be taken without a static bound.
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(
            got, poisson(tk, torch.from_numpy(lam), lam_max=9.0).numpy())


def _jit(fn):
    return lambda x: np.asarray(jax.jit(fn)(jnp.asarray(x)))


def test_xla_log_bit_equal():
    u = _uniform_grid(0, 400_000)
    wide = np.random.default_rng(1).integers(
        0x00800000, 0x7F000000, 200_000).astype(np.int32).view(np.float32)
    special = np.array([0.0, 1.0, 0.5, 2.0, np.inf, 1e-40], np.float32)
    x = np.concatenate([u, wide, special])
    want = _jit(jnp.log)(x)
    got = xla_math.log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(want), _bits(got))
    assert np.isnan(xla_math.log(torch.tensor([-1.0, np.nan])).numpy()).all()


def test_xla_exp_bit_equal():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(-20, 5, 300_000),
                        rng.uniform(-0.02, 0.02, 100_000),
                        -rng.exponential(0.5, 100_000),
                        [-100.0, 100.0, 0.0]]).astype(np.float32)
    want = _jit(jnp.exp)(x)
    got = xla_math.exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(want), _bits(got))
    # multidc's aggregate threshold, fused as the reference compiles it
    lam = np.abs(x[:400_000])
    np.testing.assert_array_equal(
        _bits(_jit(lambda v: 1.0 - jnp.exp(-v))(lam)),
        _bits(1.0 - xla_math.exp(-torch.from_numpy(lam)).numpy()))


def test_xla_log1p_and_erf_inv_bit_equal():
    f = _uniform_grid(3, 400_000)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, f * np.float32(2.0) + lo).astype(np.float32)
    arg = (u * -u).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(_jit(jnp.log1p)(arg)),
        _bits(xla_math.log1p(torch.from_numpy(arg)).numpy()))
    np.testing.assert_array_equal(
        _bits(_jit(lax.erf_inv)(u)),
        _bits(xla_math.erf_inv(torch.from_numpy(u)).numpy()))


def test_torch_log_is_not_xla_log():
    """Why ``xla_math`` exists: PyTorch's float32 log lands an ulp from
    XLA's on a share of the uniforms."""
    u = _uniform_grid(4, 100_000)
    u = u[u > 0]
    want = _jit(jnp.log)(u)
    assert np.mean(_bits(want) != _bits(torch.log(torch.from_numpy(u)))) > 0.01


def test_xla_sqrt_correctly_rounded():
    x = np.random.default_rng(5).uniform(0, 100, 400_000).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(np.sqrt(x)), _bits(xla_math.sqrt(torch.from_numpy(x)).numpy()))
    np.testing.assert_array_equal(
        _bits(_jit(jnp.sqrt)(x)),
        _bits(xla_math.sqrt(torch.from_numpy(x)).numpy()))
