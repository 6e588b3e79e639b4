"""The fault evaluators of the port against the JAX package.

Every evaluator of ``consul_tpu_torch.sim.faults`` on schedules drawn
from numpy seeds, at several ticks, against the reference's evaluator
jitted (as the Lifeguard round runs it): bit for bit, except where the
source subtracts a product from one.  There XLA on a CPU with FMA fuses
``1 - x*y`` into one multiply-add (LLVM contraction) while the port,
like the source, rounds the product first.  The product of two
probabilities lies in [0, 1), where that rounding moves it by at most
2**-25, so ``combine_loss``, ``extra_loss_at`` and ``offline_prob_at``
are held within 2**-24 of the reference (two schedules stack two such
roundings), and the test records how many values differ.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.sim import faults as jf
from consul_tpu_torch.convert import key_from_numpy
from consul_tpu_torch.sim import faults as tf
from torch_parity import ulps

N = 257
TICKS = (0, 9, 10, 11, 30, 59, 60, 61, 150)
SEEDS = (0, 1, 2, 3)


def _schedule(m, seed: int):
    """A schedule of every primitive with parameters drawn from ``seed``,
    built with module ``m`` (the reference's or the port's faults)."""
    rng = np.random.default_rng(seed)
    starts = sorted(int(s) for s in rng.integers(0, 100, 3))
    return m.FaultSchedule(
        ramps=(
            m.LossRamp(tuple((s, float(rng.uniform(0, 1))) for s in starts),
                       scale=float(rng.uniform(0.5, 1.5))),
            m.LossRamp(((10, 0.3), (60, 0.0))),
        ),
        partitions=(
            m.Partition(start=int(rng.integers(0, 30)), heal=60,
                        segments=int(rng.integers(2, 5)),
                        severity=float(rng.uniform(0.3, 1.0))),
            m.Partition(start=10, heal=int(rng.integers(40, 200)),
                        segments=3, severity=1.0),
        ),
        degraded=(
            m.DegradedSet(frac=float(rng.uniform(0.05, 0.5)),
                          drop=float(rng.uniform(0, 1)),
                          late=float(rng.uniform(0, 1)), seed=seed),
            m.DegradedSet(frac=0.2, drop=0.5, late=0.0, seed=seed + 7),
            m.DegradedSet(frac=0.0, drop=0.9, late=0.9, seed=3),
        ),
        churn=(
            m.ChurnWindow(start=5, end=60, p_offline=float(rng.uniform(0, 0.3))),
            m.ChurnWindow(start=int(rng.integers(0, 40)), end=100,
                          p_offline=0.05),
        ),
    )


def _pair(seed):
    return _schedule(jf, seed), _schedule(tf, seed)


def _tick(t):
    return torch.tensor(t, dtype=torch.int32)


def _eq(want, got: torch.Tensor):
    want = np.asarray(want)
    got = got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    if want.dtype == np.float32:
        want, got = want.view(np.uint32), got.view(np.uint32)
    np.testing.assert_array_equal(want, got)


def _within_product_rounding(want, got: torch.Tensor) -> int:
    """Float32 probabilities at most 2**-24 apart; returns how many
    differ at all."""
    want = np.asarray(want)
    got = got.numpy()
    assert want.dtype == got.dtype == np.float32 and want.shape == got.shape
    gap = np.abs(want.astype(np.float64) - got)
    assert gap.max(initial=0.0) <= 2.0 ** -24, (gap.max(), ulps(want, got))
    return int(np.count_nonzero(gap))


@pytest.mark.parametrize("seed", SEEDS)
def test_extra_and_offline_loss(seed, record_property):
    js, ts = _pair(seed)
    extra = jax.jit(functools.partial(jf.extra_loss_at, js))
    offline = jax.jit(functools.partial(jf.offline_prob_at, js))
    differ = 0
    for t in TICKS:
        differ += _within_product_rounding(extra(jnp.int32(t)),
                                  tf.extra_loss_at(ts, _tick(t)))
        differ += _within_product_rounding(offline(jnp.int32(t)),
                                  tf.offline_prob_at(ts, _tick(t)))
    record_property("values_apart", differ)
    # A single process, or none, has no product to fuse: bit for bit.
    one = tf.FaultSchedule(ramps=ts.ramps[:1], churn=ts.churn[:1])
    j_one = jf.FaultSchedule(ramps=js.ramps[:1], churn=js.churn[:1])
    for t in TICKS:
        _eq(jax.jit(functools.partial(jf.extra_loss_at, j_one))(jnp.int32(t)),
            tf.extra_loss_at(one, _tick(t)))
        _eq(jax.jit(functools.partial(jf.offline_prob_at, j_one))(
            jnp.int32(t)), tf.offline_prob_at(one, _tick(t)))
    assert float(tf.extra_loss_at(tf.FaultSchedule(), _tick(3))) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_combine_loss(seed, record_property):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, 300).astype(np.float32)
    b = rng.uniform(0, 1, 300).astype(np.float32)
    want = jax.jit(jf.combine_loss)(jnp.asarray(a), jnp.asarray(b))
    got = tf.combine_loss(torch.from_numpy(a), torch.from_numpy(b))
    record_property("values_apart", _within_product_rounding(want, got))
    # The source order, op by op, is the port's exactly.
    _eq(1.0 - (1.0 - a) * (1.0 - b), got)


@pytest.mark.parametrize("seed", SEEDS)
def test_degraded_planes(seed):
    js, ts = _pair(seed)
    for n in (N, 4096):
        _eq(jax.jit(jf.degraded_send_ok, static_argnums=(0, 1))(js, n),
            tf.degraded_send_ok(ts, n, "cpu"))
        _eq(jax.jit(jf.degraded_late, static_argnums=(0, 1))(js, n),
            tf.degraded_late(ts, n, "cpu"))
        _eq(jax.jit(jf.degraded_mask, static_argnums=(0, 1))(js, n),
            tf.degraded_mask(ts, n, "cpu"))
        for jd, td in zip(js.degraded, ts.degraded):
            _eq(jf._members(jd, n), tf._members(td, n, "cpu"))


@pytest.mark.parametrize("seed", SEEDS)
def test_partition_evaluators(seed):
    js, ts = _pair(seed)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, (N, 1)).astype(np.int32)
    dst = rng.integers(0, N, (N, 4)).astype(np.int32)
    block = jax.jit(functools.partial(jf.edge_block_prob, js), static_argnums=3)
    for jp, tp in zip(js.partitions, ts.partitions):
        ids = tf.segment_ids(tp, N, "cpu")
        _eq(jf.segment_ids(jp, N), ids)
        bounds = tf.segment_bounds(tp, N)
        for seg, (a, b) in enumerate(zip(bounds, bounds[1:])):
            assert bool((ids[a:b] == seg).all()) and b > a
        for t in TICKS:
            _eq(jax.jit(functools.partial(jf.partition_severity_at, jp))(
                jnp.int32(t)), tf.partition_severity_at(tp, _tick(t)))
    for t in TICKS:
        _eq(block(jnp.int32(t), jnp.asarray(src), jnp.asarray(dst), N),
            tf.edge_block_prob(ts, _tick(t), torch.from_numpy(src),
                               torch.from_numpy(dst), N))
        # The probe plane's form: every node against one subject.
        _eq(block(jnp.int32(t), jnp.arange(N, dtype=jnp.int32),
                  jnp.int32(5), N),
            tf.edge_block_prob(ts, _tick(t), torch.arange(N, dtype=torch.int32),
                               torch.tensor(5, dtype=torch.int32), N))


@pytest.mark.parametrize("seed", SEEDS)
def test_online_mask(seed):
    js, ts = _pair(seed)
    online = jax.jit(functools.partial(jf.online_mask, js), static_argnums=2)
    for t in TICKS:
        key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  t), 7)[6]
        _eq(online(key, jnp.int32(t), N),
            tf.online_mask(ts, key_from_numpy(np.asarray(key)), _tick(t), N))
    assert bool(tf.online_mask(tf.FaultSchedule(), key_from_numpy(
        np.asarray(key)), _tick(0), N).all())


def test_schedule_validation_and_compose():
    with pytest.raises(ValueError, match="sorted"):
        tf.LossRamp(((5, 0.1), (2, 0.2)))
    with pytest.raises(ValueError, match="outside"):
        tf.LossRamp(((5, 1.5),))
    with pytest.raises(ValueError, match="scale"):
        tf.LossRamp(((5, 0.5),), scale=-1.0)
    with pytest.raises(ValueError, match="sorted"):
        tf.BandwidthSchedule(((5, 10.0), (2, 20.0)))
    with pytest.raises(ValueError, match="bytes"):
        tf.BandwidthSchedule(((5, -1.0),))
    a, b = _schedule(tf, 0), _schedule(tf, 1)
    both = a.compose(b)
    assert both.ramps == a.ramps + b.ramps
    assert both.degraded == a.degraded + b.degraded and both.has_faults
    assert not tf.FaultSchedule().has_faults
