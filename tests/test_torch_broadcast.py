"""The broadcast slice as a whole: the port against the JAX package.

Both packages start from the same state (the JAX state carried across
by ``consul_tpu_torch.convert``) and the same key, at
``BroadcastConfig(n=256, fanout=3, loss=0.2)`` for 20 ticks:

* ``delivery="edges"``: every output bit-equal, unsharded and sharded
  at D in {1, 2, 4, 8} with both outbox transports;
* ``delivery="aggregate"``: uniforms bit-equal and the arrival
  thresholds by the rule of ``torch_parity.check_arrivals``; a receiver
  may differ only where its uniform lies between the two thresholds,
  and the test reports how many did.

The alive-masked round (``broadcast_round(alive=)``, the alive-pool
target draw ``sample_alive_peers`` and ``aggregate_arrivals(alive=)``)
is held to the reference's own case (``tests/test_broadcast.py``: n=64,
nodes 10..39 dead, 40 rounds) at both deliveries, tick by tick.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from consul_tpu.models.broadcast import BroadcastConfig as JConfig
from consul_tpu.models.broadcast import broadcast_init as j_init
from consul_tpu.models.broadcast import broadcast_round as j_round
from consul_tpu.models.swim import SwimConfig as JSwimConfig
from consul_tpu.models.swim import swim_init as j_swim_init
from consul_tpu.models.swim import swim_round as j_swim_round
from consul_tpu.ops.sampling import owned_uniform as j_owned_uniform
from consul_tpu.ops.sampling import (
    sample_alive_peers_owned as j_sample_alive_peers_owned,
)
from consul_tpu.parallel import make_mesh as j_make_mesh
from consul_tpu.parallel.shard import (
    sharded_broadcast_scan as j_sharded_scan,
)
from consul_tpu.sim.engine import broadcast_scan as j_scan
from consul_tpu.sim.engine import run_broadcast as j_run_broadcast
from consul_tpu_torch.convert import (
    key_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from consul_tpu_torch.models import (
    BroadcastConfig,
    BroadcastState,
    SwimState,
    broadcast_round,
)
from consul_tpu_torch.ops import (
    arrival_rate,
    fold_in,
    owned_uniform,
    sample_alive_peers,
    sample_alive_peers_owned,
    split,
)
from consul_tpu_torch.parallel import block_size, make_mesh, mesh_for
from consul_tpu_torch.parallel import sharded_broadcast_scan
from consul_tpu_torch.sim import broadcast_scan, run_broadcast
from torch_parity import check_arrivals

N, FANOUT, LOSS, STEPS, SEED = 256, 3, 0.2, 20, 0
DELIVERIES = ("edges", "aggregate")


def _cfgs(delivery):
    kw = dict(n=N, fanout=FANOUT, loss=LOSS, delivery=delivery)
    return JConfig(**kw), BroadcastConfig(**kw)


def _np(state):
    return jax.tree.map(np.asarray, state)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(delivery):
    """States 0..STEPS of the JAX round, tick by tick, as numpy."""
    jcfg, _ = _cfgs(delivery)
    key = jax.random.PRNGKey(SEED)
    step = jax.jit(j_round, static_argnums=(2,))
    states = [j_init(jcfg)]
    for t in range(STEPS):
        states.append(step(states[-1], jax.random.fold_in(key, t), jcfg))
    return [_np(s) for s in states]


def _assert_state_equal(want, got, skip=None, msg=""):
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        if skip is not None and a.shape == skip.shape:
            a, b = a[~skip], b[~skip]
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


def _aggregate_flips(state_np, t):
    """Receivers whose aggregate arrival differs between the packages in
    round ``t`` from ``state_np``, after checking the threshold rule."""
    _, cfg = _cfgs("aggregate")
    key_j = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), t))
    ids = np.arange(N, dtype=np.int32)
    u_j = np.asarray(j_owned_uniform(key_j[1], ids))
    senders_np = state_np.knows & (state_np.tx_left > 0)
    s_total = np.float32(senders_np.sum())
    lam_j = ((s_total - senders_np.astype(np.float32)) * np.float32(FANOUT)
             * np.float32(1.0 - LOSS) / np.float32(N - 1))
    thr_j = np.asarray(-jax.numpy.expm1(-jax.numpy.asarray(lam_j)))

    st = state_from_numpy(state_np)
    k_loss = split(fold_in(key_from_numpy(np.asarray(
        jax.random.PRNGKey(SEED))), t))[1]
    senders = st.knows & (st.tx_left > 0)
    lam_t = arrival_rate(torch.sum(senders, dtype=torch.float32), senders,
                         FANOUT, LOSS, N)
    np.testing.assert_array_equal(lam_j, lam_t.numpy())
    u_t = owned_uniform(k_loss, torch.from_numpy(ids)).numpy()
    thr_t = (-torch.expm1(-lam_t)).numpy()
    got_j = u_j < thr_j
    got_t = u_t < thr_t
    check_arrivals(u_j, u_t, thr_j, thr_t, lam_j, got_j, got_t)
    return got_j != got_t


@functools.lru_cache(maxsize=None)
def _first_aggregate_flip():
    """First tick of the JAX trajectory with a receiver on which the two
    packages' thresholds disagree (STEPS if none)."""
    states = _jax_trajectory("aggregate")
    for t in range(STEPS):
        if _aggregate_flips(states[t], t).any():
            return t
    return STEPS


@pytest.mark.parametrize("delivery", DELIVERIES)
@pytest.mark.parametrize("t", [0, 1, 2, 3, 4, 6, 10, 19])
def test_broadcast_round_matches_jax(delivery, t, record_property):
    """One round from the JAX state at tick t."""
    states = _jax_trajectory(delivery)
    _, cfg = _cfgs(delivery)
    key = fold_in(key_from_numpy(np.asarray(jax.random.PRNGKey(SEED))), t)
    got = state_to_numpy(broadcast_round(state_from_numpy(states[t]), key,
                                         cfg))
    skip = None
    if delivery == "aggregate":
        skip = _aggregate_flips(states[t], t)
        record_property("near_threshold_nodes", int(skip.sum()))
        if skip.any():
            print(f"tick {t}: near-threshold receivers "
                  f"{np.nonzero(skip)[0].tolist()}")
    _assert_state_equal(states[t + 1], got, skip=skip, msg=f"tick {t}")


@pytest.mark.parametrize("delivery", DELIVERIES)
def test_broadcast_scan_matches_jax(delivery, record_property):
    jcfg, cfg = _cfgs(delivery)
    key = jax.random.PRNGKey(SEED)
    init = _np(j_init(jcfg))
    j_final, j_infected = j_scan(j_init(jcfg), key, jcfg, STEPS)
    final, infected = broadcast_scan(
        state_from_numpy(init), key_from_numpy(np.asarray(key)), cfg, STEPS
    )
    upto = STEPS if delivery == "edges" else _first_aggregate_flip()
    record_property("ticks_compared", upto)
    np.testing.assert_array_equal(np.asarray(j_infected)[:upto],
                                  infected.numpy()[:upto])
    assert infected.dtype == torch.int32
    if upto == STEPS:
        _assert_state_equal(_np(j_final), state_to_numpy(final))


@functools.lru_cache(maxsize=None)
def _jax_sharded(delivery, d):
    jcfg, _ = _cfgs(delivery)
    final, (infected, ov) = j_sharded_scan(
        j_init(jcfg), jax.random.PRNGKey(SEED), jcfg, STEPS,
        j_make_mesh(jax.devices()[:d]), "alltoall",
    )
    return _np(final), np.asarray(infected), int(np.asarray(ov))


@pytest.mark.parametrize("exchange", ["alltoall", "ring"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("delivery", DELIVERIES)
def test_sharded_scan_matches_jax(delivery, d, exchange):
    jcfg, cfg = _cfgs(delivery)
    key = jax.random.PRNGKey(SEED)
    init = state_from_numpy(_np(j_init(jcfg)))
    tkey = key_from_numpy(np.asarray(key))
    final, (infected, ov) = sharded_broadcast_scan(
        init, tkey, cfg, STEPS, mesh_for(d), exchange
    )
    # D logical shards evaluate the unsharded scan's functions: equal at
    # every D, not only D == 1.
    u_final, u_infected = broadcast_scan(init, tkey, cfg, STEPS)
    assert torch.equal(infected, u_infected)
    _assert_state_equal(state_to_numpy(u_final), state_to_numpy(final))
    assert int(ov) == 0

    j_final, j_infected, j_ov = _jax_sharded(delivery, d)
    assert int(ov) == j_ov
    upto = STEPS if delivery == "edges" else _first_aggregate_flip()
    np.testing.assert_array_equal(j_infected[:upto], infected.numpy()[:upto])
    if upto == STEPS:
        _assert_state_equal(j_final, state_to_numpy(final))


def test_run_broadcast_matches_jax_report():
    jcfg, cfg = _cfgs("edges")
    want = j_run_broadcast(jcfg, STEPS, seed=SEED, warmup=False)
    got = run_broadcast(cfg, STEPS, seed=SEED, warmup=False, device="cpu")
    np.testing.assert_array_equal(want.infected, got.infected)
    for field in ("infected_final", "t50_ms", "t99_ms", "t9999_ms"):
        assert want.summary()[field] == got.summary()[field]
    assert got.device == "cpu" and got.overflow is None


@pytest.mark.parametrize("exchange", ["alltoall", "ring"])
def test_run_broadcast_sharded_equals_unsharded(exchange):
    _, cfg = _cfgs("edges")
    plain = run_broadcast(cfg, STEPS, warmup=False, device="cpu")
    sharded = run_broadcast(cfg, STEPS, warmup=True,
                            mesh=mesh_for(4, device="cpu"),
                            exchange=exchange)
    np.testing.assert_array_equal(plain.infected, sharded.infected)
    assert sharded.overflow == 0 and sharded.device == "cpu"


def test_run_broadcast_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, cfg = _cfgs("edges")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_broadcast(cfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_broadcast(cfg, 2, mesh=mesh_for(2), exchange="ring")


def test_exchange_requires_mesh():
    _, cfg = _cfgs("edges")
    with pytest.raises(ValueError, match="requires mesh"):
        run_broadcast(cfg, 2, exchange="ring", device="cpu")


def test_mesh_shapes():
    assert block_size(256, mesh_for(8)) == 32
    with pytest.raises(ValueError, match="does not divide"):
        block_size(256, mesh_for(3))
    with pytest.raises(ValueError, match="at least 1 shard"):
        make_mesh(0)
    assert mesh_for(2, device="cpu").device == torch.device("cpu")


def _swim_state_np():
    """A SWIM state some ticks into a crash study, as numpy."""
    cfg = JSwimConfig(n=64, subject=3, loss=0.2)
    state = j_swim_init(cfg)
    for t in range(12):
        state = j_swim_round(state, jax.random.fold_in(
            jax.random.PRNGKey(SEED), t), cfg)
    return _np(state)


@pytest.mark.parametrize("state_cls", [BroadcastState, SwimState],
                         ids=["broadcast", "swim"])
def test_state_round_trip(state_cls):
    if state_cls is BroadcastState:
        init = _jax_trajectory("edges")[5]
        back = state_to_numpy(state_from_numpy(init))
    else:
        init = _swim_state_np()
        back = state_to_numpy(state_from_numpy(init, state_cls=state_cls))
    assert type(back) is state_cls
    for name in state_cls._fields:
        want, got = np.asarray(getattr(init, name)), getattr(back, name)
        assert want.dtype == got.dtype and want.shape == got.shape, name
        np.testing.assert_array_equal(want, got, err_msg=name)
    if state_cls is SwimState:
        assert back.tick.shape == () and int(back.tick) == 12
        assert back.subject_inc.shape == ()
    else:
        assert back.knows.dtype == np.bool_ and back.tx_left.dtype == np.int32


@pytest.mark.parametrize("dead_frac", [0.0, 0.3, 0.97, 1.0])
def test_sample_alive_peers_matches_jax(dead_frac):
    """Owned alive-pool draws over random masks, including the one-alive
    and none-alive edges (the tensor bound ``max(A - 1, 1)``)."""
    rng = np.random.default_rng(int(dead_frac * 100))
    draw = jax.jit(j_sample_alive_peers_owned, static_argnums=3)
    for s in range(4):
        n = 257
        alive = rng.random(n) >= dead_frac
        ids = rng.choice(n, size=64, replace=False).astype(np.int32)
        key = jax.random.PRNGKey(s)
        want = np.asarray(draw(key, ids, alive, 3))
        got = sample_alive_peers_owned(
            key_from_numpy(np.asarray(key)), torch.from_numpy(ids),
            torch.from_numpy(alive), 3)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())
        full = sample_alive_peers(key_from_numpy(np.asarray(key)),
                                  torch.from_numpy(alive), 3)
        np.testing.assert_array_equal(full.numpy()[ids], want)
        if 1 < alive.sum() < n:
            live = np.nonzero(alive)[0]
            assert np.isin(want[alive[ids]], live).all()


ALIVE_N, ALIVE_FANOUT, ALIVE_STEPS = 64, 3, 40


def _alive_mask():
    alive = np.ones(ALIVE_N, bool)
    alive[10:40] = False
    return alive


@pytest.mark.parametrize("delivery", DELIVERIES)
def test_broadcast_round_alive_matches_jax(delivery, record_property):
    """The reference's own case, both deliveries, tick by tick from the
    JAX state; aggregate by the arrival-threshold rule."""
    jcfg = JConfig(n=ALIVE_N, fanout=ALIVE_FANOUT, delivery=delivery)
    cfg = BroadcastConfig(n=ALIVE_N, fanout=ALIVE_FANOUT, delivery=delivery)
    alive = _alive_mask()
    alive_t = torch.from_numpy(alive)
    step = jax.jit(j_round, static_argnums=(2,))
    key = jax.random.PRNGKey(5)
    state = _np(j_init(jcfg))
    near = 0
    for t in range(ALIVE_STEPS):
        k = jax.random.fold_in(key, t)
        nxt = _np(step(state, k, jcfg, alive))
        got = state_to_numpy(broadcast_round(
            state_from_numpy(state), key_from_numpy(np.asarray(k)), cfg,
            alive_t))
        skip = None
        if delivery == "aggregate":
            senders = state.knows & (state.tx_left > 0) & alive
            lam = ((np.float32(senders.sum()) - senders.astype(np.float32))
                   * np.float32(ALIVE_FANOUT) * np.float32(1.0)
                   / np.float32(alive.sum() - 1))
            u_j = np.asarray(j_owned_uniform(
                jax.random.split(k)[1], np.arange(ALIVE_N, dtype=np.int32)))
            thr_j = np.asarray(-jax.numpy.expm1(-jax.numpy.asarray(lam)))
            u_t = owned_uniform(split(key_from_numpy(np.asarray(k)))[1],
                                torch.arange(ALIVE_N, dtype=torch.int32))
            thr_t = (-torch.expm1(-torch.from_numpy(lam))).numpy()
            got_j, got_t = u_j < thr_j, u_t.numpy() < thr_t
            near += check_arrivals(u_j, u_t.numpy(), thr_j, thr_t, lam,
                                   got_j, got_t)
            skip = got_j != got_t
        _assert_state_equal(nxt, got, skip=skip, msg=f"tick {t}")
        state = nxt
    record_property("near_threshold_nodes", near)
    assert not state.knows[10:40].any(), "dead nodes never learn the event"
    assert state.knows[np.r_[0:10, 40:64]].all(), "live nodes converge"


def test_aggregate_arrivals_alive_rate():
    """The alive form's rate spreads the copies over the other A-1 alive
    nodes, in float32: the port's threshold within 1 ulp of float64."""
    from consul_tpu.ops.sampling import aggregate_arrivals as j_agg
    from consul_tpu_torch.ops import aggregate_arrivals

    rng = np.random.default_rng(3)
    for s in range(5):
        alive = rng.random(500) < 0.7
        senders = (rng.random(500) < 0.2) & alive
        key = jax.random.PRNGKey(s)
        want = np.asarray(jax.jit(j_agg, static_argnums=(2, 3, 4))(
            key, senders, 4, 0.1, 500, alive))
        got = aggregate_arrivals(key_from_numpy(np.asarray(key)),
                                 torch.from_numpy(senders), 4, 0.1, 500,
                                 torch.from_numpy(alive)).numpy()
        assert not got[~alive].any()
        # Differences only where the thresholds disagree: none at these
        # seeds.
        np.testing.assert_array_equal(want, got)
