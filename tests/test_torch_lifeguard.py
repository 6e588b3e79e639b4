"""The Lifeguard slice: the port against the JAX package on the CPU.

Each tick starts both packages from the reference's state with the same
round key; the reference round runs jitted.  Lifeguard on and off, with
each fault primitive (``LossRamp``, ``Partition`` with one cut and, on
the edges path, two, ``DegradedSet`` with late acks, ``ChurnWindow``),
in a false-positive study and a crash study:

* ``delivery="edges"``: every state field bit-equal on every tick;
* ``delivery="aggregate"``: the arrival rates of the reference, jitted,
  and of the port are compared and their largest ulp distance recorded
  (they are not bit-equal: XLA folds ``fanout / (n-1)`` into one
  constant, fuses the ``1 - x*y`` of the loss into one multiply-add, and
  sums ``w`` in its own order); the uniforms must be bit-equal and a
  receiver may differ only where its uniform lies between the two
  thresholds (``torch_parity.check_arrivals``); every other field is
  bit-equal;
* ``lifeguard_scan``'s five outputs equal the reference's scan, and
  ``degraded1m(n=256, steps=50)`` the reference's dict apart from its
  rounds/s.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.models.lifeguard import LifeguardConfig as JConfig
from consul_tpu.models.lifeguard import lifeguard_round as j_round
from consul_tpu.models.swim import swim_init as j_init
from consul_tpu.ops import sampling as jsamp
from consul_tpu.protocol import formulas as jformulas
from consul_tpu.protocol.profiles import PROFILES as J_PROFILES
from consul_tpu.sim import faults as jf
from consul_tpu.sim.engine import lifeguard_scan as j_scan
from consul_tpu.sim.scenarios import degraded1m as j_degraded1m
from consul_tpu_torch import protocol as tformulas
from consul_tpu_torch.convert import (
    key_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from consul_tpu_torch.models import LifeguardConfig, SwimState, lifeguard_round
from consul_tpu_torch.models.lifeguard import (
    arrival_rate,
    integer_pow,
    mean_f32,
)
from consul_tpu_torch.ops import owned_uniform, split
from consul_tpu_torch.protocol import PROFILES
from consul_tpu_torch.sim import faults as tf
from consul_tpu_torch.sim import lifeguard_scan, run_lifeguard
from consul_tpu_torch.sim.scenarios import degraded1m
from torch_parity import check_arrivals, ulps

SEED = 1


def _primitive(m, name):
    """One fault primitive as a schedule of module ``m``'s classes."""
    return {
        "ramp": m.FaultSchedule(ramps=(
            m.LossRamp(((5, 0.2), (30, 0.5), (60, 0.0)), scale=0.9),)),
        "partition": m.FaultSchedule(partitions=(
            m.Partition(start=10, heal=50, segments=3, severity=0.9),)),
        "partition2": m.FaultSchedule(partitions=(
            m.Partition(start=0, heal=40, segments=2, severity=1.0),
            m.Partition(start=20, heal=60, segments=3, severity=0.5))),
        "degraded": m.FaultSchedule(degraded=(
            m.DegradedSet(frac=0.2, drop=0.3, late=0.6, seed=2),)),
        "churn": m.FaultSchedule(churn=(
            m.ChurnWindow(start=10, end=50, p_offline=0.1),)),
        "all": m.FaultSchedule(
            ramps=(m.LossRamp(((10, 0.2), (50, 0.0))),),
            partitions=(m.Partition(start=15, heal=45, segments=2,
                                    severity=0.8),),
            degraded=(m.DegradedSet(frac=0.1, drop=0.5, late=0.6, seed=3),),
            churn=(m.ChurnWindow(start=20, end=60, p_offline=0.05),),
        ),
    }[name]


@dataclasses.dataclass(frozen=True)
class Case:
    faults: str
    lifeguard: bool
    delivery: str = "edges"
    subject_alive: bool = True
    fail_at_tick: int = 0
    profile: str = "lan"
    steps: int = 60
    n: int = 128

    def cfgs(self):
        kw = dict(n=self.n, subject=5, subject_alive=self.subject_alive,
                  fail_at_tick=self.fail_at_tick, loss=0.1, ack_late=0.25,
                  delivery=self.delivery, lifeguard=self.lifeguard)
        return (JConfig(profile=J_PROFILES[self.profile],
                        faults=_primitive(jf, self.faults), **kw),
                LifeguardConfig(profile=PROFILES[self.profile],
                                faults=_primitive(tf, self.faults), **kw))


def _cases():
    cases = {}
    for faults in ("ramp", "partition", "partition2", "degraded", "churn"):
        for delivery in ("edges", "aggregate"):
            if faults == "partition2" and delivery == "aggregate":
                continue
            for on in (True, False):
                name = f"{faults}-{delivery}-{'on' if on else 'off'}"
                cases[name] = Case(faults, on, delivery)
    # Crash studies past the suspicion minimum (LAN n=128: 42.1 ticks).
    for delivery in ("edges", "aggregate"):
        cases[f"all-crash-{delivery}-on"] = Case(
            "all", True, delivery, subject_alive=False, fail_at_tick=6,
            steps=80)
    cases["all-fp-wan-edges-on"] = Case("all", True, profile="wan")
    # n=100: no power of two, so the float32 means take their reciprocal.
    cases["degraded-aggregate-on-n100"] = Case("degraded", True, "aggregate",
                                               n=100)
    return cases


CASES = _cases()


def _np(state):
    return jax.tree.map(np.asarray, state)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(case: Case):
    jcfg, _ = case.cfgs()
    key = jax.random.PRNGKey(SEED)
    step = jax.jit(j_round, static_argnums=(2,))
    states = [j_init(jcfg)]
    for t in range(case.steps):
        states.append(step(states[-1], jax.random.fold_in(key, t), jcfg))
    return [_np(s) for s in states]


def _keys(t):
    jkey = jax.random.fold_in(jax.random.PRNGKey(SEED), t)
    return jkey, key_from_numpy(np.asarray(jkey))


def _assert_state_equal(want, got, skip=None, msg=""):
    for name in SwimState._fields:
        a, b = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert a.dtype == b.dtype, f"{msg} {name}: {a.dtype} != {b.dtype}"
        if skip is not None and a.shape == skip.shape:
            a, b = a[~skip], b[~skip]
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


@functools.partial(jax.jit, static_argnums=0)
def _j_rates(jcfg, state, key):
    """The reference round's three arrival rates, thresholds and uniforms
    (``lifeguard_round``'s fault environment and aggregate ``rx_era``)."""
    n, f = jcfg.n, jcfg.subject
    t = state.tick
    rows = jnp.arange(n, dtype=jnp.int32)
    k_gossip, *_, k_churn = jax.random.split(key, 7)
    loss_t = jf.combine_loss(jnp.float32(jcfg.loss),
                             jf.extra_loss_at(jcfg.faults, t))
    send_ok = jf.degraded_send_ok(jcfg.faults, n)
    online = jf.online_mask(jcfg.faults, k_churn, t, n)
    dead = jnp.logical_and(not jcfg.subject_alive, t >= jcfg.fail_at_tick)
    participates = jnp.where((rows == f) & dead, False, online)
    out = []
    for kcls, tx in zip(jax.random.split(k_gossip, 3),
                        (state.tx_suspect, state.tx_dead, state.tx_refute)):
        w = (participates & (tx > 0)).astype(jnp.float32) * send_ok * (
            1.0 - loss_t)
        if jcfg.faults.partitions:
            part = jcfg.faults.partitions[0]
            seg = jf.segment_ids(part, n)
            sev = jf.partition_severity_at(part, t)
            seg_sum = jnp.zeros((part.segments,), jnp.float32).at[seg].add(w)
            same = seg_sum[seg]
            reach = (same - w) + (1.0 - sev) * (jnp.sum(w) - same)
        else:
            reach = jnp.sum(w) - w
        lam = jnp.where(participates, jcfg.fanout * reach / max(n - 1, 1),
                        0.0)
        out.append((lam, -jnp.expm1(-lam), jsamp.owned_uniform(kcls, rows)))
    return out


def _t_rates(cfg, state, key):
    """The port's counterparts of :func:`_j_rates`."""
    n, f = cfg.n, cfg.subject
    t = state.tick
    rows = torch.arange(n, dtype=torch.int32)
    keys = split(key, 7)
    loss_t = tf.combine_loss(torch.tensor(cfg.loss, dtype=torch.float32),
                             tf.extra_loss_at(cfg.faults, t))
    send_ok = tf.degraded_send_ok(cfg.faults, n, "cpu")
    online = tf.online_mask(cfg.faults, keys[6], t, n)
    dead = (t >= cfg.fail_at_tick) & (not cfg.subject_alive)
    participates = online & ~((rows == f) & dead)
    out = []
    for kcls, tx in zip(split(keys[0], 3),
                        (state.tx_suspect, state.tx_dead, state.tx_refute)):
        w = (participates & (tx > 0)).to(torch.float32) * send_ok * (
            1.0 - loss_t)
        lam = arrival_rate(cfg, t, w, participates)
        out.append((lam, -torch.expm1(-lam), owned_uniform(kcls, rows)))
    return out


def _aggregate_flips(case, state_np, t):
    """(bool[n] receivers whose arrival of some class differs, largest
    ulp distance between the two packages' rates)."""
    jcfg, cfg = case.cfgs()
    jkey, tkey = _keys(t)
    want = _j_rates(jcfg, state_np, jkey)
    got = _t_rates(cfg, state_from_numpy(state_np, state_cls=SwimState),
                   tkey)
    flips = np.zeros(cfg.n, bool)
    lam_ulps = 0
    for (lam_j, thr_j, u_j), (lam_t, thr_t, u_t) in zip(want, got):
        lam_j, thr_j, u_j = map(np.asarray, (lam_j, thr_j, u_j))
        lam_t, thr_t, u_t = lam_t.numpy(), thr_t.numpy(), u_t.numpy()
        lam_ulps = max(lam_ulps, int(ulps(lam_j, lam_t).max()))
        check_arrivals(u_j, u_t, thr_j, thr_t, lam_j, u_j < thr_j,
                       u_t < thr_t, lam_t=lam_t)
        flips |= (u_j < thr_j) != (u_t < thr_t)
    return flips, lam_ulps


@pytest.mark.parametrize("name", list(CASES))
def test_lifeguard_round_matches_jax(name, record_property):
    case = CASES[name]
    states = _jax_trajectory(case)
    _, cfg = case.cfgs()
    flipped, lam_ulps = 0, 0
    for t in range(case.steps):
        got = state_to_numpy(lifeguard_round(
            state_from_numpy(states[t], state_cls=SwimState), _keys(t)[1],
            cfg))
        skip = None
        if case.delivery == "aggregate":
            skip, dist = _aggregate_flips(case, states[t], t)
            flipped += int(skip.sum())
            lam_ulps = max(lam_ulps, dist)
        _assert_state_equal(states[t + 1], got, skip=skip,
                            msg=f"{name} tick {t}")
    if case.delivery == "aggregate":
        record_property("near_threshold_receivers", flipped)
        record_property("max_rate_ulps", lam_ulps)
        # The rates differ by a few roundings (up to 7 ulps at these
        # cases), never by a formula.
        assert lam_ulps <= 32, lam_ulps
    views = np.stack([s.view for s in states])
    assert (views == 1).any(), "no suspicion in the study"
    if not case.subject_alive:
        assert (views == 2).any(), "no dead declaration in the study"
    if case.lifeguard:
        assert any(s.awareness.any() for s in states)
    else:
        assert not any(s.awareness.any() for s in states)


@pytest.mark.parametrize("name", ["all-crash-edges-on", "churn-aggregate-off",
                                  "all-fp-wan-edges-on",
                                  "degraded-aggregate-on-n100"])
def test_lifeguard_scan_matches_jax(name):
    case = CASES[name]
    jcfg, cfg = case.cfgs()
    key = jax.random.PRNGKey(SEED)
    j_final, want = j_scan(j_init(jcfg), key, jcfg, case.steps)
    init = state_from_numpy(_np(j_init(jcfg)), state_cls=SwimState)
    final, got = lifeguard_scan(init, key_from_numpy(np.asarray(key)), cfg,
                                case.steps)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(w, g.numpy())
    _assert_state_equal(_np(j_final), state_to_numpy(final))
    if case.subject_alive:
        # A round that wrote into its input would zero this diff count.
        assert int(got[2].sum()) > 0


@pytest.mark.parametrize("n", [100, 128, 4096, 100_000, 1_000_000])
def test_reductions_against_xla(n, record_property):
    """The round's float32 reductions of ``send_ok``-weighted planes: the
    population mean (``mean_ok``) and a sender-weight sum.  With
    ``drop=0.5`` every partial sum is exact, so the mean is bit-equal
    (both multiply by the float32 ``1/n``); with ``drop=0.3`` the
    summation orders differ and the ulp distance is recorded."""
    for drop, exact in ((0.5, True), (0.3, False)):
        sched = (jf.FaultSchedule(degraded=(jf.DegradedSet(0.2, drop),)),
                 tf.FaultSchedule(degraded=(tf.DegradedSet(0.2, drop),)))
        j_ok = jf.degraded_send_ok(sched[0], n)
        t_ok = tf.degraded_send_ok(sched[1], n, "cpu")
        w = t_ok * 0.9
        for want, got, what in (
                (jax.jit(jnp.mean)(j_ok), mean_f32(t_ok), "mean"),
                (jax.jit(jnp.sum)(j_ok * 0.9), torch.sum(w), "sum")):
            dist = int(ulps(np.asarray(want), got.numpy()))
            record_property(f"{what}_ulps_drop{drop}", dist)
            if exact and what == "mean":
                assert dist == 0
            assert dist <= 64, (what, drop, dist)


@pytest.mark.parametrize("n", [256, 100])
def test_degraded1m_small_matches_jax(n):
    """The dicts agree on every field but rounds/s, ``mean_awareness_final``
    included: at n=100, 1/n is not a power of two, so this pins the
    reference's compiled mean (sum times the float32 reciprocal)."""
    want = j_degraded1m(seed=0, n=n, steps=50)
    got = degraded1m(seed=0, n=n, steps=50, device="cpu")
    want.pop("sim_rounds_per_sec")
    got.pop("sim_rounds_per_sec")
    assert want == got


def test_run_lifeguard_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, cfg = CASES["ramp-edges-on"].cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_lifeguard(cfg, 2)
    rep = run_lifeguard(cfg, 3, warmup=False, device="cpu")
    assert rep.device == "cpu" and rep.suspecting.shape == (3,)


def test_config_rejections():
    stacked = tf.FaultSchedule(partitions=(tf.Partition(0, 10),
                                           tf.Partition(5, 20)))
    with pytest.raises(ValueError, match="at most one Partition"):
        LifeguardConfig(n=64, delivery="aggregate", faults=stacked)
    LifeguardConfig(n=64, delivery="edges", faults=stacked)
    brownout = tf.FaultSchedule(
        bandwidth=(tf.BandwidthSchedule(((0, 1e3),)),))
    with pytest.raises(ValueError, match="BandwidthSchedule"):
        LifeguardConfig(n=64, faults=brownout)


@pytest.mark.parametrize("y", [0, 1, 2, 3, 4, 5, 7])
def test_integer_pow_order(y):
    x = np.random.default_rng(y).uniform(0, 1, 500).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: v ** y)(jnp.asarray(x)))
    got = integer_pow(torch.from_numpy(x), y).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_formulas_match_reference():
    for n in (1, 2, 3, 64, 257, 10 ** 6):
        for mult, interval in ((4, 1000), (6, 5000), (3, 1000)):
            assert (tformulas.suspicion_timeout(mult, n, interval)
                    == jformulas.suspicion_timeout(mult, n, interval))
            assert (tformulas.suspicion_timeout_bounds(mult, 6, n, interval)
                    == jformulas.suspicion_timeout_bounds(mult, 6, n,
                                                          interval))
    for k in (0, 1, 2, 4):
        for c in range(k + 1):
            assert (tformulas.remaining_suspicion_timeout(c, k, 600.0, 3600.0)
                    == jformulas.remaining_suspicion_timeout(c, k, 600.0,
                                                             3600.0))
    for score in range(-2, 10):
        assert (tformulas.awareness_clamp(score, 8)
                == jformulas.awareness_clamp(score, 8))
        assert (tformulas.awareness_scaled_timeout(500, score)
                == jformulas.awareness_scaled_timeout(500, score))
    for args in ((True,), (False,), (False, 3, 1), (False, 3, 5)):
        assert (tformulas.awareness_probe_delta(*args)
                == jformulas.awareness_probe_delta(*args))
    for name, jp in J_PROFILES.items():
        tp = PROFILES[name]
        for field in ("suspicion_max_timeout_mult", "awareness_max_multiplier",
                      "probe_interval_ticks", "probe_timeout_ticks"):
            assert getattr(tp, field) == getattr(jp, field), (name, field)
