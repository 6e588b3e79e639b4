"""The multi-DC broadcast (BASELINE config 5) against the JAX package.

Both packages start from the same state (carried across by
``consul_tpu_torch.convert``) and the same key at n=1024, 8 segments of 3
bridges, LAN loss 0.1, WAN loss 0.2, for 40 ticks.  Both delivery modes,
with the WAN class on and off, are held bit-equal on every tick, every
state field with its dtype: the aggregate mode's ``1 - exp(-lam)`` uses
XLA's float32 ``exp`` (``ops.xla_math``), so its thresholds, and so its
arrivals, are the reference's (the arrival-threshold rule of
``torch_parity.check_arrivals`` is held too, with no receiver allowed to
differ).  The scans and ``run_multidc`` are held against the reference's,
and ``sharded=True`` is rejected.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.models.multidc import MultiDCConfig as JConfig
from consul_tpu.models.multidc import multidc_init as j_init
from consul_tpu.models.multidc import multidc_round as j_round
from consul_tpu.sim.engine import run_multidc as j_run_multidc
from consul_tpu_torch import MultiDCConfig, run_multidc
from consul_tpu_torch.convert import (
    key_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from consul_tpu_torch.models import MultiDCState, multidc_init, multidc_round
from consul_tpu_torch.ops import split, uniform, xla_math
from consul_tpu_torch.sim import multidc_scan

N, SEGMENTS, BRIDGES, STEPS, SEED, ORIGIN = 1024, 8, 3, 40, 2, 64
MODES = [(d, w) for d in ("edges", "aggregate") for w in (True, False)]


def _cfgs(delivery, wan_enabled=True):
    kw = dict(n=N, segments=SEGMENTS, bridges_per_segment=BRIDGES,
              delivery=delivery, wan_enabled=wan_enabled, loss_lan=0.1,
              loss_wan=0.2)
    return JConfig(**kw), MultiDCConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(delivery, wan_enabled):
    jcfg, _ = _cfgs(delivery, wan_enabled)
    key = jax.random.PRNGKey(SEED)
    step = jax.jit(j_round, static_argnums=(2,))
    states = [j_init(jcfg, origin=ORIGIN)]
    for t in range(STEPS):
        states.append(step(states[-1], jax.random.fold_in(key, t), jcfg))
    return [jax.tree.map(np.asarray, s) for s in states]


def _assert_state_equal(want, got, msg=""):
    for name in MultiDCState._fields:
        a, b = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert a.dtype == b.dtype, f"{msg} {name} dtype"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


def test_init_matches():
    for origin in (ORIGIN, 1, 130):   # a non-bridge and two bridges
        jcfg, cfg = _cfgs("edges")
        want = jax.tree.map(np.asarray, j_init(jcfg, origin=origin))
        got = state_to_numpy(multidc_init(cfg, origin=origin, device="cpu"))
        _assert_state_equal(want, got, f"origin {origin}")


@pytest.mark.parametrize("delivery,wan_enabled", MODES)
def test_round_bit_equal_every_tick(delivery, wan_enabled):
    _, cfg = _cfgs(delivery, wan_enabled)
    states = _jax_trajectory(delivery, wan_enabled)
    key = jax.random.PRNGKey(SEED)
    for t in range(STEPS):
        k = key_from_numpy(np.asarray(jax.random.fold_in(key, t)))
        got = state_to_numpy(multidc_round(state_from_numpy(states[t]), k,
                                           cfg))
        _assert_state_equal(states[t + 1], got, f"tick {t}")
    assert states[-1].knows.sum() == (N if wan_enabled else N // SEGMENTS)


def _aggregate_thresholds(state_np, t):
    """The reference's LAN arrival thresholds in round ``t`` (the float32
    rates in its operation order, ``1 - exp(-lam)`` jitted) and the
    port's, with the shared uniforms."""
    ss = N // SEGMENTS
    seg = np.arange(N) // ss
    senders = state_np.knows & (state_np.tx_lan > 0)
    per_seg = senders.reshape(SEGMENTS, ss).sum(1).astype(np.float32)
    lam = ((per_seg[seg] - senders.astype(np.float32)) * np.float32(3)
           * np.float32(1.0 - 0.1) / np.float32(ss - 1))
    thr_j = np.asarray(jax.jit(lambda v: 1.0 - jnp.exp(-v))(lam))
    thr_t = (1.0 - xla_math.exp(-torch.from_numpy(lam))).numpy()
    keys = split(key_from_numpy(np.asarray(jax.random.fold_in(
        jax.random.PRNGKey(SEED), t))), 6)
    u_t = uniform(keys[1], (N,)).numpy()
    k_j = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), t), 6)
    u_j = np.asarray(jax.random.uniform(k_j[1], (N,)))
    return u_j, u_t, thr_j, thr_t


@pytest.mark.parametrize("wan_enabled", (True, False))
def test_aggregate_thresholds_are_the_references(wan_enabled):
    """Aggregate LAN class: the uniforms are bit-equal and the port's
    thresholds are the reference's, so no receiver lies between them
    (the arrival-threshold rule with an empty band)."""
    states = _jax_trajectory("aggregate", wan_enabled)
    for t in range(STEPS):
        u_j, u_t, thr_j, thr_t = _aggregate_thresholds(states[t], t)
        np.testing.assert_array_equal(u_j.view(np.uint32),
                                      u_t.view(np.uint32))
        np.testing.assert_array_equal(thr_j.view(np.uint32),
                                      thr_t.view(np.uint32))
        np.testing.assert_array_equal(u_j < thr_j, u_t < thr_t)


@pytest.mark.parametrize("delivery", ("edges", "aggregate"))
def test_scan_and_run_match_reference(delivery):
    jcfg, cfg = _cfgs(delivery)
    key = jax.random.PRNGKey(SEED)
    _, (j_total, j_per) = jax.jit(
        lambda s, k: jax.lax.scan(
            lambda c, t: (lambda nxt: (nxt, (
                jnp.sum(nxt.knows, dtype=jnp.int32),
                jnp.sum(nxt.knows.reshape(SEGMENTS, -1), axis=1,
                        dtype=jnp.int32))))(
                j_round(c, jax.random.fold_in(k, t), jcfg)),
            s, jnp.arange(STEPS, dtype=jnp.int32)))(
        j_init(jcfg, origin=ORIGIN), key)
    _, (total, per_seg) = multidc_scan(
        multidc_init(cfg, origin=ORIGIN, device="cpu"),
        key_from_numpy(np.asarray(key)), cfg, STEPS)
    np.testing.assert_array_equal(np.asarray(j_total), total.numpy())
    np.testing.assert_array_equal(np.asarray(j_per), per_seg.numpy())
    assert total.dtype == per_seg.dtype == torch.int32

    want = j_run_multidc(jcfg, STEPS, seed=SEED, origin=ORIGIN, warmup=False)
    got = run_multidc(cfg, STEPS, seed=SEED, origin=ORIGIN, warmup=False,
                      device="cpu")
    np.testing.assert_array_equal(want.infected, got.infected)
    np.testing.assert_array_equal(want.per_segment, got.per_segment)
    ws, gs = want.summary(), got.summary()
    for k in ("infected_final", "segments_reached", "t50_ms", "t99_ms",
              "segment_t99_ms"):
        assert ws[k] == gs[k], k
    assert gs["device"] == "cpu"


def test_sharded_and_mesh_are_rejected():
    _, cfg = _cfgs("aggregate")
    with pytest.raises(NotImplementedError, match="sharded"):
        run_multidc(cfg, 2, sharded=True, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        run_multidc(cfg, 2, mesh=object(), device="cpu")


def test_config_validation_matches():
    for kw in (dict(n=1000, segments=7), dict(n=64, delivery="bogus"),
               dict(n=64, segments=8, bridges_per_segment=8)):
        with pytest.raises(ValueError):
            JConfig(**kw)
        with pytest.raises(ValueError):
            MultiDCConfig(**kw)
    jcfg, cfg = _cfgs("edges")
    for prop in ("seg_size", "fanout_lan", "fanout_wan", "n_bridges",
                 "tx_limit_lan", "tx_limit_wan", "wan_rate"):
        assert getattr(jcfg, prop) == getattr(cfg, prop), prop
