"""The port's sampling, scatter and segmented-sum ops against the JAX
package, bit for bit, on inputs made from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.ops import sampling as jsamp
from consul_tpu.ops import scatter as jscat
from consul_tpu.ops.sortmerge import _segmented_sum as j_segmented_sum
from consul_tpu_torch.convert import key_from_numpy
from consul_tpu_torch.ops import sampling as tsamp
from consul_tpu_torch.ops import scatter as tscat
from consul_tpu_torch.ops.sortmerge import _segmented_sum as t_segmented_sum
from torch_parity import check_arrivals


def _site_keys(seed: int):
    """A round key's two site keys, as the round functions derive them."""
    k = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 5))
    return [(np.asarray(s), key_from_numpy(np.asarray(s))) for s in k]


def _ids(seed: int, n: int, count: int = 200) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, count, dtype=np.int64)
    return np.concatenate([[0, n - 1], ids]).astype(np.int32)


def _eq(a, b: torch.Tensor) -> None:
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n", [2, 3, 257, 1_000_000, 2 ** 31 - 1])
@pytest.mark.parametrize("fanout", [1, 4])
def test_sample_peers_owned(n, fanout):
    ids = _ids(n % 1000, n)
    for jk, tk in _site_keys(n % 13):
        want = jsamp.sample_peers_owned(jk, jnp.asarray(ids), n, fanout)
        got = tsamp.sample_peers_owned(tk, torch.from_numpy(ids), n, fanout)
        _eq(want, got)
        assert not (got == torch.from_numpy(ids)[:, None]).any()


def test_sample_peers_owned_on_sharded_plane():
    """[D, blk] ids give the rows the flat [n] ids give."""
    jk, tk = _site_keys(1)[0]
    n, d = 96, 4
    ids = torch.arange(n, dtype=torch.int32)
    flat = tsamp.sample_peers_owned(tk, ids, n, 3)
    plane = tsamp.sample_peers_owned(tk, ids.view(d, n // d), n, 3)
    assert torch.equal(plane.reshape(n, 3), flat)
    _eq(jsamp.sample_peers(jk, n, 3), tsamp.sample_peers(tk, n, 3))


@pytest.mark.parametrize("p_success", [1.0, 0.8, 0.3, 0.0])
@pytest.mark.parametrize("shape", [(), (3,)])
def test_bernoulli_mask_owned(p_success, shape):
    ids = _ids(4, 1_000_000)
    for jk, tk in _site_keys(2):
        want = jsamp.bernoulli_mask_owned(jk, jnp.asarray(ids), shape,
                                          p_success)
        got = tsamp.bernoulli_mask_owned(tk, torch.from_numpy(ids), shape,
                                         p_success)
        _eq(want, got)
    _eq(jsamp.bernoulli_mask(jk, (50, 3), p_success),
        tsamp.bernoulli_mask(tk, (50, 3), p_success))


@pytest.mark.parametrize("shape", [(), (1,), (4,)])
def test_owned_uniform(shape):
    ids = _ids(5, 2 ** 31 - 1)
    for jk, tk in _site_keys(3):
        want = np.asarray(jsamp.owned_uniform(jk, jnp.asarray(ids), shape))
        got = tsamp.owned_uniform(tk, torch.from_numpy(ids), shape).numpy()
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.view(np.uint32))


@pytest.mark.parametrize("maxval", [2, 255, 999_999])
def test_owned_randint_and_keys(maxval):
    ids = _ids(6, 2 ** 31 - 1)
    for jk, tk in _site_keys(4):
        _eq(jsamp.owned_randint(jk, jnp.asarray(ids), (3,), 0, maxval),
            tsamp.owned_randint(tk, torch.from_numpy(ids), (3,), 0, maxval))
        want = np.asarray(jsamp.owned_keys(jk, jnp.asarray(ids)))
        got = tsamp.owned_keys(tk, torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(want.astype(np.int64), got)


@pytest.mark.parametrize("seed", range(3))
def test_deliver_or_with_dropped(seed):
    rng = np.random.default_rng(seed)
    n, m = 50, 120
    dest = rng.random(n) < 0.2
    # Index n is "dropped" in the reference; so is every masked message.
    targets = rng.integers(0, n + 1, m).astype(np.int32)
    mask = rng.random(m) < 0.6
    want = jscat.deliver_or(jnp.asarray(dest), jnp.asarray(targets),
                            jnp.asarray(mask))
    got = tscat.deliver_or(torch.from_numpy(dest), torch.from_numpy(targets),
                           torch.from_numpy(mask))
    _eq(want, got)


@pytest.mark.parametrize("seed", range(3))
def test_deliver_max_with_dropped(seed):
    rng = np.random.default_rng(10 + seed)
    n, m = 40, 100
    dest = rng.integers(-5, 50, n).astype(np.int32)
    targets = rng.integers(0, n + 1, (m // 4, 4)).astype(np.int32)
    values = rng.integers(-100, 100, (m // 4, 4)).astype(np.int32)
    mask = rng.random((m // 4, 4)) < 0.5
    want = jscat.deliver_max(jnp.asarray(dest), jnp.asarray(targets),
                             jnp.asarray(values), jnp.asarray(mask))
    got = tscat.deliver_max(torch.from_numpy(dest),
                            torch.from_numpy(targets),
                            torch.from_numpy(values), torch.from_numpy(mask))
    _eq(want, got)


@pytest.mark.parametrize("seed", range(4))
def test_segmented_sum(seed):
    rng = np.random.default_rng(20 + seed)
    m = 300
    flags = rng.random(m) < 0.1
    flags[0] = seed % 2 == 0  # with and without a leading segment start
    x = rng.integers(0, 5, m).astype(np.int32)
    want = j_segmented_sum(jnp.asarray(flags), jnp.asarray(x))
    got = t_segmented_sum(torch.from_numpy(flags), torch.from_numpy(x))
    assert got.dtype == torch.int32
    _eq(want, got)


def test_segmented_sum_batched_rows():
    """The port's form runs along the last axis of a batch of streams."""
    rng = np.random.default_rng(30)
    flags = rng.random((3, 64)) < 0.2
    x = rng.integers(0, 9, (3, 64)).astype(np.int32)
    got = t_segmented_sum(torch.from_numpy(flags), torch.from_numpy(x))
    for r in range(3):
        _eq(j_segmented_sum(jnp.asarray(flags[r]), jnp.asarray(x[r])), got[r])


def test_poissonized_arrivals_owned():
    """Uniforms bit-equal, thresholds and arrivals by the rule of
    ``torch_parity.check_arrivals``."""
    ids = _ids(7, 10_000, 500)
    rng = np.random.default_rng(8)
    lam = rng.random(ids.shape[0]).astype(np.float32) * 3
    jk, tk = _site_keys(9)[1]
    want = np.asarray(jsamp.poissonized_arrivals_owned(
        jk, jnp.asarray(ids), jnp.asarray(lam)))
    got = tsamp.poissonized_arrivals_owned(
        tk, torch.from_numpy(ids), torch.from_numpy(lam)).numpy()
    check_arrivals(
        np.asarray(jsamp.owned_uniform(jk, jnp.asarray(ids))),
        tsamp.owned_uniform(tk, torch.from_numpy(ids)).numpy(),
        np.asarray(-jnp.expm1(-jnp.asarray(lam))),
        (-torch.expm1(-torch.from_numpy(lam))).numpy(),
        lam, want, got,
    )
