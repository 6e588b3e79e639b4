"""The port's threefry draws against ``jax.random``, bit for bit.

``consul_tpu_torch.ops.threefry`` must reproduce the installed jax's
threefry2x32 (``jax_threefry_partitionable=True``): keys, fold_in,
split, raw bits, float32 uniforms and int32 randint, over many keys,
ids up to 2**31-1 and spans including ``n-1``.  Inputs are made from
numpy seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu_torch.convert import key_from_numpy
from consul_tpu_torch.ops import threefry as tf

IDS = np.array(
    [0, 1, 2, 3, 255, 65535, 65536, 999_999, 1_000_000, 2 ** 31 - 2,
     2 ** 31 - 1], dtype=np.int32,
)


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the partitionable threefry; report the flag
    and version rather than fail on another setting."""
    assert jax.config.jax_threefry_partitionable, (
        f"jax {jax.__version__}: jax_threefry_partitionable is off; the "
        "port reproduces the partitionable form"
    )


def _keys(seed: int, count: int) -> np.ndarray:
    """uint32[count, 2] raw keys from a numpy seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (count, 2), dtype=np.uint64).astype(
        np.uint32
    )


def _ids(seed: int, count: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    more = rng.integers(0, 2 ** 31, count, dtype=np.int64).astype(np.int32)
    return np.concatenate([IDS, more])


def _tk(keys: np.ndarray) -> torch.Tensor:
    return key_from_numpy(keys)


def _eq(a, b: torch.Tensor) -> None:
    a = np.asarray(a)
    b = b.numpy()
    if a.dtype == np.uint32:
        b = b.astype(np.uint32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 12345, 2 ** 31 - 1, -1, -(2 ** 31)])
def test_prng_key(seed):
    _eq(jax.random.PRNGKey(seed), tf.PRNGKey(seed))


def test_prng_key_rejects_wide_seed():
    with pytest.raises(ValueError, match="32 bits"):
        tf.PRNGKey(2 ** 40)


def test_threefry2x32_block_function():
    rng = np.random.default_rng(3)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 100), dtype=np.uint64).astype(np.uint32)
    from jax._src.prng import threefry_2x32

    want = np.asarray(threefry_2x32(jnp.asarray(k), jnp.asarray(x.ravel())))
    k_t = torch.from_numpy(k.astype(np.int64))
    x_t = torch.from_numpy(x.astype(np.int64))
    y0, y1 = tf.threefry2x32(k_t[0], k_t[1], x_t[0], x_t[1])
    _eq(want, torch.cat([y0, y1]))


@pytest.mark.parametrize("seed", range(4))
def test_fold_in(seed):
    keys, ids = _keys(seed, 16), _ids(seed)
    want = jax.vmap(
        lambda k: jax.vmap(lambda i: jax.random.fold_in(k, i))(ids)
    )(keys)
    got = tf.fold_in(_tk(keys)[:, None, :], torch.from_numpy(ids))
    _eq(want, got)


@pytest.mark.parametrize("num", [1, 2, 3, 7])
def test_split(num):
    keys = _keys(10 + num, 32)
    want = jax.vmap(lambda k: jax.random.split(k, num))(keys)
    _eq(want, tf.split(_tk(keys), num))


@pytest.mark.parametrize("shape", [(), (1,), (2,), (4,), (3, 5), (1000,)])
def test_random_bits(shape):
    keys = _keys(20, 8)
    want = jax.vmap(lambda k: jax.random.bits(k, shape))(keys)
    _eq(want, tf.random_bits(_tk(keys), shape))


@pytest.mark.parametrize("shape", [(), (1,), (3,), (4,), (2, 3), (1000,)])
def test_uniform(shape):
    keys = _keys(30, 8)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
    got = tf.uniform(_tk(keys), shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want.view(np.uint32),
                                  got.numpy().view(np.uint32))


_SPANS = [(0, n - 1) for n in (2, 3, 256, 1_000_000)] + [
    (0, n) for n in (2, 3, 256, 1_000_000)
] + [(0, 65536), (0, 65537), (0, 2 ** 31 - 1), (-5, 17), (7, 7), (9, 3),
     (-(2 ** 31), 2 ** 31 - 1)]


@pytest.mark.parametrize("minval,maxval", _SPANS)
def test_randint(minval, maxval):
    keys = _keys(40 + (maxval % 97), 32)
    want = jax.vmap(lambda k: jax.random.randint(
        k, (4,), minval=minval, maxval=maxval, dtype=jnp.int32
    ))(keys)
    got = tf.randint(_tk(keys), (4,), minval, maxval)
    assert got.dtype == torch.int32
    _eq(want, got)


def test_randint_scalar_shape_and_tensor_bounds():
    keys = _keys(50, 16)
    hi = np.arange(2, 18, dtype=np.int32)
    want = jax.vmap(lambda k, h: jax.random.randint(
        k, (), minval=0, maxval=h, dtype=jnp.int32
    ))(keys, hi)
    got = tf.randint(_tk(keys), (), 0, torch.from_numpy(hi))
    _eq(want, got)


def test_key_from_numpy():
    keys = _keys(60, 5)
    np.testing.assert_array_equal(_tk(keys).numpy(), keys.astype(np.int64))
    with pytest.raises(ValueError, match="uint32"):
        key_from_numpy(keys.astype(np.int64))
