"""The SWIM slice: the port against the JAX package on the CPU.

Both packages start each tick from the reference's state (carried
across by ``consul_tpu_torch.convert``) with the same round key; the
reference round runs jitted, as its scan runs it.

* the suspicion-timeout table equals ``_lifeguard_timeout_ticks`` as
  XLA compiles it, across profiles, n and scales;
* ``sample_probe_targets`` is bit-equal;
* ``delivery="edges"``: every state field bit-equal on every tick, over
  crash studies (``fail_at_tick`` 0 and > 0) and false-positive studies
  (``subject_alive``, loss 0.3) on LAN/WAN/LOCAL, suspicion_scale 1.0 and
  0.5, n 64 and 257, long enough that dead declarations happen;
* ``delivery="aggregate"``: uniforms bit-equal and the arrival
  thresholds by the rule of ``torch_parity.check_arrivals``; a receiver
  may differ only where its uniform lies between the two thresholds, and
  every other field is bit-equal;
* ``run_swim``'s per-tick ``(suspecting, dead_known)`` equals the
  reference's ``run_swim``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.models.swim import SwimConfig as JConfig
from consul_tpu.models.swim import _lifeguard_timeout_ticks
from consul_tpu.models.swim import swim_init as j_init
from consul_tpu.models.swim import swim_round as j_round
from consul_tpu.ops import sampling as jsamp
from consul_tpu.protocol.profiles import PROFILES as J_PROFILES
from consul_tpu.sim.engine import run_swim as j_run_swim
from consul_tpu_torch.convert import (
    key_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from consul_tpu_torch.models import SwimConfig, SwimState, swim_round
from consul_tpu_torch.models.swim import timeout_table
from consul_tpu_torch.ops import arrival_rate, fold_in, owned_uniform, split
from consul_tpu_torch.ops import sampling as tsamp
from consul_tpu_torch.protocol import PROFILES
from consul_tpu_torch.sim import run_swim, swim_scan
from torch_parity import check_arrivals

SEED = 0


@dataclasses.dataclass(frozen=True)
class Case:
    profile: str
    n: int
    steps: int
    subject_alive: bool = False
    fail_at_tick: int = 0
    loss: float = 0.0
    suspicion_scale: float = 1.0
    delivery: str = "edges"

    def kw(self):
        kw = dataclasses.asdict(self)
        del kw["profile"], kw["steps"]
        return dict(kw, subject=5)

    def cfgs(self):
        return (JConfig(profile=J_PROFILES[self.profile], **self.kw()),
                SwimConfig(profile=PROFILES[self.profile], **self.kw()))


# Suspicion minimum (ticks) at these sizes: LAN 36.1 (n=64) / 48.2
# (257), WAN 108.4 / 144.5, LOCAL 54.2 / 72.3; scale 0.5 halves them.
CASES = {
    "lan-crash-n64": Case("lan", 64, 90, loss=0.1),
    "lan-crash-late-n257-s0.5": Case("lan", 257, 70, fail_at_tick=12,
                                     suspicion_scale=0.5),
    "wan-crash-n257-s0.5": Case("wan", 257, 110, loss=0.1,
                                suspicion_scale=0.5),
    "local-crash-late-n64": Case("local", 64, 100, fail_at_tick=8),
    # LOCAL's minimum is a whole 60 ticks at n=100, where the compiled
    # reference's table entry for one confirmation is 61.
    "local-crash-n100": Case("local", 100, 100, loss=0.2),
    "lan-fp-n257": Case("lan", 257, 90, subject_alive=True, loss=0.3),
    "wan-fp-n64-s0.5": Case("wan", 64, 90, subject_alive=True, loss=0.3,
                            suspicion_scale=0.5),
    "local-fp-n257-s0.5": Case("local", 257, 90, subject_alive=True,
                               loss=0.3, suspicion_scale=0.5),
}
AGG_CASES = {
    "agg-" + name: dataclasses.replace(CASES[name], delivery="aggregate")
    for name in ("lan-crash-n64", "wan-crash-n257-s0.5", "lan-fp-n257")
}


def _np(state):
    return jax.tree.map(np.asarray, state)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(case: Case):
    """States 0..steps of the jitted JAX round, as numpy."""
    jcfg, _ = case.cfgs()
    key = jax.random.PRNGKey(SEED)
    step = jax.jit(j_round, static_argnums=(2,))
    states = [j_init(jcfg)]
    for t in range(case.steps):
        states.append(step(states[-1], jax.random.fold_in(key, t), jcfg))
    return [_np(s) for s in states]


def _tkey(t):
    return fold_in(key_from_numpy(np.asarray(jax.random.PRNGKey(SEED))), t)


def _assert_state_equal(want, got, skip=None, msg=""):
    for name in SwimState._fields:
        a, b = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert a.dtype == b.dtype, f"{msg} {name}: {a.dtype} != {b.dtype}"
        if skip is not None and a.shape == skip.shape:
            a, b = a[~skip], b[~skip]
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


_j_uniform = jax.jit(jsamp.owned_uniform)
_j_threshold = jax.jit(lambda lam: -jnp.expm1(-lam))


def _aggregate_flips(case: Case, state_np, t):
    """bool[n]: receivers whose aggregate arrival of some message class
    differs between the packages in round ``t`` from ``state_np``, after
    checking each class by the rule of ``check_arrivals``."""
    jcfg, cfg = case.cfgs()
    n, fanout = cfg.n, cfg.fanout
    ids = np.arange(n, dtype=np.int32)
    j_gossip = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(SEED), t), 5)[0]
    t_gossip = split(_tkey(t), 5)[0]
    dead_now = (not cfg.subject_alive) and t >= cfg.fail_at_tick
    can_send = np.ones(n, bool)
    can_send[cfg.subject] = not dead_now
    flips = np.zeros(n, bool)
    for c, tx in enumerate((state_np.tx_suspect, state_np.tx_dead,
                            state_np.tx_refute)):
        send = can_send & (tx > 0)
        u_j = np.asarray(_j_uniform(jax.random.split(j_gossip, 3)[c], ids))
        lam_j = ((np.float32(send.sum()) - send.astype(np.float32))
                 * np.float32(fanout) * np.float32(1.0 - cfg.loss)
                 / np.float32(n - 1))
        thr_j = np.asarray(_j_threshold(lam_j))
        send_t = torch.from_numpy(send)
        lam_t = arrival_rate(torch.sum(send_t, dtype=torch.float32), send_t,
                             fanout, cfg.loss, n)
        np.testing.assert_array_equal(lam_j, lam_t.numpy())
        u_t = owned_uniform(split(t_gossip, 3)[c], torch.from_numpy(ids))
        thr_t = (-torch.expm1(-lam_t)).numpy()
        u_t = u_t.numpy()
        check_arrivals(u_j, u_t, thr_j, thr_t, lam_j, u_j < thr_j, u_t < thr_t)
        flips |= (u_j < thr_j) != (u_t < thr_t)
    return flips


# -- the timeout table -------------------------------------------------------


@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("profile", ["lan", "wan", "local"])
def test_timeout_table_matches_reference(profile, scale):
    """The (k+1)-entry table equals the jitted reference on every entry
    for n from 3 to 1M (k = 0 below n = suspicion_mult)."""
    for n in (3, 4, 5, 16, 64, 257, 1000, 4096, 100_000, 999_999,
              1_000_000):
        jcfg = JConfig(n=n, profile=J_PROFILES[profile],
                       suspicion_scale=scale)
        cfg = SwimConfig(n=n, profile=PROFILES[profile],
                         suspicion_scale=scale)
        conf = jnp.arange(jcfg.confirmations_k + 1, dtype=jnp.int32)
        want = np.asarray(jax.jit(
            functools.partial(_lifeguard_timeout_ticks, jcfg))(conf))
        got = timeout_table(cfg).numpy()
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.view(np.uint32),
                                      err_msg=f"{profile} n={n}")


def test_timeout_table_is_the_compiled_reference():
    """Where the minimum is a whole tick (LOCAL, n=100: 60 ticks), the
    jitted reference waits one tick longer at one confirmation than its
    op-by-op evaluation (XLA folds the constants and fuses a
    multiply-add, leaving 60.000008); the table follows the compiled
    program."""
    jcfg = JConfig(n=100, profile=J_PROFILES["local"])
    conf = jnp.arange(2, dtype=jnp.int32)
    eager = np.asarray(_lifeguard_timeout_ticks(jcfg, conf))
    table = timeout_table(SwimConfig(n=100, profile=PROFILES["local"]))
    assert eager.tolist() == [360.0, 60.0]
    assert table.tolist() == [360.0, 61.0]


# -- the probe sampler -------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 257, 1_000_000])
def test_sample_probe_targets(n):
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(4), 7))[1]
    tkey = key_from_numpy(np.asarray(key))
    rng = np.random.default_rng(n)
    ids = np.concatenate([[0, n - 1], rng.integers(0, n, 300)]).astype(
        np.int32)
    want = np.asarray(jsamp.sample_probe_targets_owned(key, jnp.asarray(ids),
                                                       n))
    got = tsamp.sample_probe_targets_owned(tkey, torch.from_numpy(ids), n)
    np.testing.assert_array_equal(want, got.numpy())
    assert got.dtype == torch.int32 and got.shape == (ids.size,)
    if n <= 257:
        np.testing.assert_array_equal(np.asarray(jsamp.sample_probe_targets(
            key, n)), tsamp.sample_probe_targets(tkey, n).numpy())


# -- the round ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_swim_round_edges_matches_jax(name):
    case = CASES[name]
    states = _jax_trajectory(case)
    _, cfg = case.cfgs()
    for t in range(case.steps):
        got = state_to_numpy(swim_round(
            state_from_numpy(states[t], state_cls=SwimState), _tkey(t), cfg))
        _assert_state_equal(states[t + 1], got, msg=f"{name} tick {t}")
    views = np.stack([s.view for s in states])
    assert (views == 1).any(), "no suspicion in the study"
    if not case.subject_alive:
        assert (views == 2).any(), "no dead declaration in the study"


@pytest.mark.parametrize("name", list(AGG_CASES))
def test_swim_round_aggregate_matches_jax(name, record_property):
    case = AGG_CASES[name]
    states = _jax_trajectory(case)
    _, cfg = case.cfgs()
    flipped = 0
    for t in range(case.steps):
        got = state_to_numpy(swim_round(
            state_from_numpy(states[t], state_cls=SwimState), _tkey(t), cfg))
        skip = _aggregate_flips(case, states[t], t)
        flipped += int(skip.sum())
        _assert_state_equal(states[t + 1], got, skip=skip,
                            msg=f"{name} tick {t}")
    record_property("near_threshold_receivers", flipped)
    views = np.stack([s.view for s in states])
    assert (views == 1).any()


@pytest.mark.parametrize("name", ["lan-crash-n64", "agg-lan-fp-n257"])
def test_run_swim_matches_jax(name):
    case = {**CASES, **AGG_CASES}[name]
    jcfg, cfg = case.cfgs()
    want = j_run_swim(jcfg, case.steps, seed=SEED, warmup=False)
    got = run_swim(cfg, case.steps, seed=SEED, warmup=False, device="cpu")
    np.testing.assert_array_equal(want.suspecting, got.suspecting)
    np.testing.assert_array_equal(want.dead_known, got.dead_known)
    assert got.suspecting.dtype == np.int32 and got.device == "cpu"
    ws, gs = want.summary(), got.summary()
    for field in ("first_suspect_ms", "first_dead_ms", "t99_dead_known_ms",
                  "suspecting_final", "dead_known_final"):
        assert ws[field] == gs[field], field


def test_swim_scan_final_state_matches_trajectory():
    case = CASES["lan-crash-n64"]
    states = _jax_trajectory(case)
    _, cfg = case.cfgs()
    final, (sus, dead) = swim_scan(
        state_from_numpy(states[0], state_cls=SwimState),
        key_from_numpy(np.asarray(jax.random.PRNGKey(SEED))), cfg,
        case.steps)
    _assert_state_equal(states[-1], state_to_numpy(final))
    np.testing.assert_array_equal(
        sus.numpy(), [int((s.view == 1).sum()) for s in states[1:]])
    np.testing.assert_array_equal(
        dead.numpy(), [int((s.view == 2).sum()) for s in states[1:]])


def test_round_leaves_its_input_untouched():
    case = CASES["lan-fp-n257"]
    states = _jax_trajectory(case)
    _, cfg = case.cfgs()
    st = state_from_numpy(states[40], state_cls=SwimState)
    before = [t.clone() for t in st]
    swim_round(st, _tkey(40), cfg)
    for a, b in zip(before, st):
        assert torch.equal(a, b)


def test_run_swim_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_swim(SwimConfig(n=16), 2)


def test_config_rejects_unknown_delivery():
    with pytest.raises(ValueError, match="delivery"):
        SwimConfig(n=16, delivery="bulk")
