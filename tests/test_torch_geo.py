"""The geo/WAN plane against the JAX package.

At n=1024 (8 DCs x 5 bridges, 4 events, the pinned Vivaldi latency
matrix), a bandwidth brownout to 10% over ticks [5, 30) and a loss ramp
over [10, 25), adaptive and fixed arms, 60 ticks, both packages stepped
from the same state and key:

* ``admit_link_units``, ``expand_delivery_slots`` and ``link_capacity_at``
  (with ``src``/``dst`` selectors, scales and composition by minimum) are
  bit-equal to the reference's;
* ``geo_round``: every state field and output bit-equal on every tick,
  dtype included (the EWMA controller in XLA's fused order, the WAN
  gossip through ``poisson``), except that a LAN receiver may differ
  where its uniform lies between the two packages' ``-expm1(-lam)``
  thresholds (``torch_parity.check_arrivals``); the test counts those
  receivers, and none occurred here;
* ``run_geo`` equals the reference's report; ``sharded_geo_scan`` at
  D in {1, 2, 4} with both transports equals the unsharded scan on every
  tick with no outbox overflow; segments must divide over the shards;
* ``GeoConfig`` rejects what the reference rejects, and ``run_geo``
  rejects a transport without a mesh.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.geo.model import GeoConfig as JConfig
from consul_tpu.geo.model import admit_link_units as j_admit
from consul_tpu.geo.model import expand_delivery_slots as j_expand
from consul_tpu.geo.model import geo_init as j_init
from consul_tpu.geo.model import geo_round as j_round
from consul_tpu.ops.sampling import owned_uniform as j_owned_uniform
from consul_tpu.sim.engine import run_geo as j_run_geo
from consul_tpu.sim.faults import BandwidthSchedule as JBandwidth
from consul_tpu.sim.faults import FaultSchedule as JFaults
from consul_tpu.sim.faults import LossRamp as JLossRamp
from consul_tpu.sim.faults import link_capacity_at as j_link_capacity_at
from consul_tpu_torch import GeoConfig, mesh_for, run_geo
from consul_tpu_torch.convert import (
    key_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from consul_tpu_torch.geo import (
    GeoState,
    admit_link_units,
    expand_delivery_slots,
    geo_init,
    geo_round,
)
from consul_tpu_torch.geo.model import geo_constants
from consul_tpu_torch.ops import owned_uniform, split
from consul_tpu_torch.parallel import sharded_geo_scan
from consul_tpu_torch.sim import (
    BandwidthSchedule,
    FaultSchedule,
    LossRamp,
    geo_scan,
)
from consul_tpu_torch.sim.faults import link_capacity_at
from torch_parity import check_arrivals

N, S, B, E, STEPS, SEED = 1024, 8, 5, 4, 60, 0
BASE = 16 * 1400.0
LATENCY = ((0, 4, 4, 5, 5, 2, 2, 5), (4, 0, 3, 1, 2, 4, 4, 3),
           (4, 3, 0, 5, 3, 4, 4, 4), (5, 1, 5, 0, 4, 5, 5, 4),
           (5, 2, 3, 4, 0, 4, 5, 1), (2, 4, 4, 5, 4, 0, 1, 3),
           (2, 4, 4, 5, 5, 1, 0, 4), (5, 3, 4, 4, 1, 3, 4, 0))
FIELDS = ("per_segment", "offered", "admitted", "queued", "overflow",
          "wasted")


def _faults(fs, bw, lr):
    return fs(bandwidth=(bw(pieces=((5, 0.1 * BASE), (30, 64 * BASE))),),
              ramps=(lr(((10, 0.2), (25, 0.0))),))


def _cfgs(adaptive=True, **kw):
    common = dict(n=N, segments=S, bridges_per_segment=B, events=E,
                  wan_latency_ticks=LATENCY, wan_window=8,
                  wan_capacity_bytes=BASE, wan_msg_bytes=1400,
                  wan_queue_bytes=2 * BASE, ae_batch=16, adaptive=adaptive,
                  loss_wan=0.05)
    common.update(kw)
    return (JConfig(**common, faults=_faults(JFaults, JBandwidth, JLossRamp)),
            GeoConfig(**common,
                      faults=_faults(FaultSchedule, BandwidthSchedule,
                                     LossRamp)))


@pytest.mark.parametrize("seed", range(5))
def test_admit_link_units_matches(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, (64, 12)).astype(np.int32)
    cap = rng.integers(0, 30, 64).astype(np.int32)
    want = j_admit(jnp.asarray(counts), jnp.asarray(cap), 20)
    got = admit_link_units(torch.from_numpy(counts), torch.from_numpy(cap),
                           20)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    np.testing.assert_array_equal(counts, sum(g.numpy() for g in got))


@pytest.mark.parametrize("seed", range(5))
def test_expand_delivery_slots_matches(seed):
    rng = np.random.default_rng(seed)
    arriving = rng.integers(0, 5, (64, 6)).astype(np.int32)
    arriving[rng.random(64) < 0.3] = 0
    for cap in (16, 40):
        want = j_expand(jnp.asarray(arriving), cap)
        got = expand_delivery_slots(torch.from_numpy(arriving), cap)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _schedules(fs, bw):
    return fs(bandwidth=(
        bw(pieces=((3, 9000.0), (8, 2000.0), (12, 30000.0)), scale=0.7),
        bw(pieces=((5, 4000.0),), src=2),
        bw(pieces=((0, 1500.0), (10, 0.0)), dst=5),
        bw(pieces=((6, 100.0),), src=1, dst=3, scale=3.0),
    ))


def test_link_capacity_at_matches():
    jsched = _schedules(JFaults, JBandwidth)
    sched = _schedules(FaultSchedule, BandwidthSchedule)
    for t in range(16):
        want = np.asarray(j_link_capacity_at(jsched, jnp.int32(t), S,
                                             base=BASE))
        got = link_capacity_at(sched, torch.tensor(t, dtype=torch.int32), S,
                               base=BASE)
        assert got.dtype == torch.float32 and got.shape == (S, S)
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.numpy().view(np.uint32))
    for bad in (dict(src=S), dict(dst=S + 2)):
        sched = FaultSchedule(bandwidth=(
            BandwidthSchedule(pieces=((0, 1.0),), **bad),))
        with pytest.raises(ValueError, match="outside"):
            link_capacity_at(sched, torch.tensor(0), S, base=BASE)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(adaptive):
    """States 0..STEPS and the per-tick outputs of the jitted reference."""
    jcfg, _ = _cfgs(adaptive)
    key = jax.random.PRNGKey(SEED)
    step = jax.jit(j_round, static_argnums=(2,))
    states, outs = [j_init(jcfg)], []
    for t in range(STEPS):
        nxt, out = step(states[-1], jax.random.fold_in(key, t), jcfg)
        states.append(nxt)
        outs.append(out)
    return ([jax.tree.map(np.asarray, s) for s in states],
            [tuple(np.asarray(o) for o in out) for out in outs])


def _lan_flips(state_np, t):
    """bool[n, E]: LAN receivers whose arrival differs between the packages
    in round ``t``, after holding the thresholds to the arrival rule."""
    ss = N // S
    senders = state_np.knows & (state_np.tx_lan > 0)
    per_seg = senders.reshape(S, ss, E).astype(np.int32).sum(1).astype(
        np.float32)
    lam = ((per_seg[np.arange(N) // ss] - senders.astype(np.float32))
           * np.float32(3) * np.float32(1.0) / np.float32(ss - 1))
    thr_j = np.asarray(jax.jit(lambda v: -jnp.expm1(-v))(lam))
    thr_t = (-torch.expm1(-torch.from_numpy(lam).double())).float().numpy()
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), t)
    ids = np.arange(N, dtype=np.int32)
    u_j = np.asarray(j_owned_uniform(jax.random.split(key, 4)[0], ids, (E,)))
    k_t = split(key_from_numpy(np.asarray(key)), 4)[0]
    u_t = owned_uniform(k_t, torch.from_numpy(ids), (E,)).numpy()
    fresh = ~state_np.knows
    got_j, got_t = (u_j < thr_j) & fresh, (u_t < thr_t) & fresh
    if fresh.any():
        check_arrivals(u_j[fresh], u_t[fresh], thr_j[fresh], thr_t[fresh],
                       lam[fresh], got_j[fresh], got_t[fresh])
    return got_j != got_t


@pytest.mark.parametrize("adaptive", (True, False))
def test_round_bit_equal_every_tick(adaptive):
    _, cfg = _cfgs(adaptive)
    states, outs = _jax_trajectory(adaptive)
    consts = geo_constants(cfg, "cpu")
    key = jax.random.PRNGKey(SEED)
    flipped = 0
    for t in range(STEPS):
        k = key_from_numpy(np.asarray(jax.random.fold_in(key, t)))
        nxt, out = geo_round(state_from_numpy(states[t]), k, cfg, consts)
        flips = _lan_flips(states[t], t)
        flipped += int(flips.sum())
        want, got = states[t + 1], state_to_numpy(nxt)
        for name in GeoState._fields:
            a, b = getattr(want, name), getattr(got, name)
            assert a.dtype == b.dtype, f"tick {t} {name} dtype"
            if a.shape == flips.shape:
                a, b = a[~flips], b[~flips]
            np.testing.assert_array_equal(a, b, err_msg=f"tick {t} {name}")
        for i, (a, b) in enumerate(zip(outs[t], out)):
            assert a.dtype == b.numpy().dtype, f"tick {t} out {i} dtype"
            if i == 0 and flips.any():
                continue  # per-segment counts move with a flipped receiver
            np.testing.assert_array_equal(a, b.numpy(),
                                          err_msg=f"tick {t} out {i}")
    print(f"adaptive={adaptive}: {flipped} near-threshold LAN receivers")
    assert flipped == 0
    # The study exercised what it claims: a brownout with overflow and
    # waste, and full convergence after the heal.
    ovf = sum(int(o[4].sum()) for o in outs)
    assert ovf > 0 and int(states[-1].wasted) > 0
    assert states[-1].knows.all()


def test_arms_differ_only_in_the_controller():
    _, a_outs = _jax_trajectory(True)
    _, f_outs = _jax_trajectory(False)
    for i in range(6):
        np.testing.assert_array_equal(a_outs[0][i], f_outs[0][i])
    assert any(not np.array_equal(a[1], f[1])
               for a, f in zip(a_outs, f_outs))


@pytest.mark.parametrize("adaptive", (True, False))
def test_run_geo_matches_reference(adaptive):
    jcfg, cfg = _cfgs(adaptive)
    want = j_run_geo(jcfg, STEPS, seed=SEED, warmup=False)
    got = run_geo(cfg, STEPS, seed=SEED, warmup=False, device="cpu")
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(w, g, err_msg=f)
    ws, gs = want.summary(), got.summary()
    for k in ws:
        if k != "sim_rounds_per_sec":
            assert ws[k] == gs[k], k
    assert gs["accounting_ok"] and got.shard_overflow is None


@functools.lru_cache(maxsize=None)
def _unsharded(adaptive):
    _, cfg = _cfgs(adaptive)
    final, outs = geo_scan(geo_init(cfg, device="cpu"),
                           key_from_numpy(np.asarray(jax.random.PRNGKey(3))),
                           cfg, 40)
    return state_to_numpy(final), tuple(o.numpy() for o in outs)


@pytest.mark.parametrize("d", (1, 2, 4))
@pytest.mark.parametrize("exchange", ("alltoall", "ring"))
def test_sharded_equals_unsharded(d, exchange):
    _, cfg = _cfgs(True)
    want_final, want = _unsharded(True)
    final, outs = sharded_geo_scan(
        geo_init(cfg, device="cpu"),
        key_from_numpy(np.asarray(jax.random.PRNGKey(3))), cfg, 40,
        mesh_for(d), exchange)
    for i, (a, b) in enumerate(zip(want, outs[:6])):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"out {i}")
    got_final = state_to_numpy(final)
    for name in GeoState._fields:
        np.testing.assert_array_equal(getattr(want_final, name),
                                      getattr(got_final, name), name)
    assert int(outs[6][-1]) == 0   # outbox overflow


def test_sharded_ring_equals_alltoall_under_pressure():
    """A capacity of 64 units per link at D=4 puts more WAN slots in the
    outbox than the smallest budgets hold: both transports must agree on
    every tick, overflow included."""
    _, cfg = _cfgs(True, wan_capacity_bytes=64 * 1400.0,
                   wan_queue_bytes=128 * 1400.0, ae_batch=64)
    key = key_from_numpy(np.asarray(jax.random.PRNGKey(1)))
    runs = [sharded_geo_scan(geo_init(cfg, device="cpu"), key, cfg, 25,
                             mesh_for(4), ex)[1] for ex in ("alltoall",
                                                           "ring")]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_sharded_layout_checks():
    _, cfg = _cfgs(True)
    key = key_from_numpy(np.asarray(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="segments=8 does not divide"):
        sharded_geo_scan(geo_init(cfg, device="cpu"), key, cfg, 1,
                         mesh_for(3))
    with pytest.raises(ValueError, match="exchange backend"):
        sharded_geo_scan(geo_init(cfg, device="cpu"), key, cfg, 1,
                         mesh_for(2), "bogus")


def test_run_geo_sharded_report():
    _, cfg = _cfgs(False)
    plain = run_geo(cfg, 30, seed=2, warmup=False, device="cpu")
    ring = run_geo(cfg, 30, seed=2, warmup=False, device="cpu",
                   mesh=mesh_for(2), exchange="ring")
    assert ring.shard_overflow == 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(plain, f), getattr(ring, f))


def test_entry_point_rejections():
    """A transport without a mesh is refused; ``telemetry=`` is accepted
    and adds the [steps, M] trace (tests/test_torch_obs.py holds it)."""
    _, cfg = _cfgs(True)
    rep = run_geo(cfg, 2, telemetry=True, device="cpu")
    assert rep.metrics_trace.shape == (2, 6)
    with pytest.raises(ValueError, match="requires mesh"):
        run_geo(cfg, 2, exchange="ring", device="cpu")


BAD_CONFIGS = (
    dict(n=1000, segments=7),
    dict(n=64, segments=8, bridges_per_segment=8),
    dict(n=64, segments=8, bridges_per_segment=2, events=0),
    dict(n=64, segments=8, bridges_per_segment=2, wan_window=1),
    dict(n=64, segments=8, bridges_per_segment=2, wan_msg_bytes=0),
    dict(n=64, segments=8, bridges_per_segment=2, wan_capacity_bytes=10.0),
    dict(n=64, segments=8, bridges_per_segment=2,
         wan_capacity_bytes=5000 * 1400.0),
    dict(n=64, segments=8, bridges_per_segment=2, ae_batch=0),
    dict(n=64, segments=2, bridges_per_segment=2,
         wan_latency_ticks=((0, 1), (1, 0), (1, 1))),
    dict(n=64, segments=2, bridges_per_segment=2,
         wan_latency_ticks=((0, 8), (1, 0))),
    dict(n=64, segments=2, bridges_per_segment=2, events=2, origins=(0, 64)),
    dict(n=64, segments=2, bridges_per_segment=2, events=2, origins=(0,)),
)


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_config_validation_matches(kw):
    with pytest.raises(ValueError):
        JConfig(**kw)
    with pytest.raises(ValueError):
        GeoConfig(**kw)


def test_config_rejects_node_faults_and_matches_properties():
    from consul_tpu_torch.sim import ChurnWindow, DegradedSet, Partition

    for f in (FaultSchedule(partitions=(Partition(1, 2),)),
              FaultSchedule(degraded=(DegradedSet(0.1),)),
              FaultSchedule(churn=(ChurnWindow(1, 2, 0.1),))):
        with pytest.raises(ValueError, match="loss ramps and bandwidth"):
            GeoConfig(n=64, segments=2, bridges_per_segment=2, faults=f)
    jcfg, cfg = _cfgs(True, events=11)
    for prop in ("seg_size", "n_links", "fanout_lan", "fanout_wan",
                 "tx_limit_lan", "wan_rate", "cap_units", "queue_units",
                 "event_origins"):
        assert getattr(jcfg, prop) == getattr(cfg, prop), prop
    assert jcfg.latency_flat() == cfg.latency_flat()
    d = dataclasses.replace(cfg, wan_latency_ticks=())
    assert d.latency_flat() == dataclasses.replace(
        jcfg, wan_latency_ticks=()).latency_flat()
    assert cfg.gossip_lam_max < 10


def test_init_matches():
    jcfg, cfg = _cfgs(True, events=11)
    want = jax.tree.map(np.asarray, j_init(jcfg))
    got = state_to_numpy(geo_init(cfg, device="cpu"))
    for name in GeoState._fields:
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_geo100k_preset_small():
    from consul_tpu.sim.scenarios import geo100k as j_geo100k
    from consul_tpu_torch.sim.scenarios import geo100k

    want = j_geo100k(n=8000, steps=30)
    got = geo100k(n=8000, steps=30, device="cpu")
    for k in want:
        if k != "sim_rounds_per_sec":
            assert want[k] == got[k], k
    ring = geo100k(n=8000, steps=30, devices=4, exchange="ring",
                   device="cpu")
    assert ring["shard_overflow"] == 0
    assert ring["segment_t99_ms"] == got["segment_t99_ms"]
