"""The streamcast slice: the port against the JAX package on the CPU.

Same config, seed and state in both packages (the JAX state carried
across by ``consul_tpu_torch.convert``):

* the XLA float32 order the arrival schedule depends on: the
  ``exponential`` draw, the block-16 prefix sum of ``jnp.cumsum``, the
  constant-divisor reciprocal of ``paced_ticks``, and the power of
  ``heavy_tail_sizes`` over every float32 near a size step (pinned on
  jax and jaxlib 0.9.0's CPU backend: the order is XLA's compile choice,
  and another version may choose another);
* ``arrival_arrays`` in both modes, the window (``admit``/``retire``)
  and ``select_chunk`` bit for bit;
* ``streamcast_scan`` edges: every per-tick output and the final state
  bit-equal, dtype included, for all three policies; aggregate tick by
  tick under ``torch_parity.check_arrivals``;
* the scheduled mode, a loss ramp, the W=1/E=1 broadcast pin, the
  config's validation, ``run_streamcast`` and the ``stream100k``
  preset's summary.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.sim import load as j_load
from consul_tpu.sim.engine import run_streamcast as j_run_streamcast
from consul_tpu.sim.engine import streamcast_scan as j_scan
from consul_tpu.sim.faults import FaultSchedule as JFaults
from consul_tpu.sim.faults import LossRamp as JRamp
from consul_tpu.sim.scenarios import stream100k as j_stream100k
from consul_tpu.streamcast import model as j_model
from consul_tpu.streamcast import window as j_window
from consul_tpu_torch.convert import (
    key_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from consul_tpu_torch.models import BroadcastConfig, broadcast_init
from consul_tpu_torch.ops import exponential, owned_uniform, xla_math
from consul_tpu_torch.sim import FaultSchedule, LossRamp, broadcast_scan
from consul_tpu_torch.sim import load, run_streamcast, streamcast_scan
from consul_tpu_torch.sim.scenarios import stream100k
from consul_tpu_torch.streamcast import (
    POLICIES,
    StreamcastConfig,
    StreamcastState,
    admit,
    arrival_arrays,
    retire,
    select_chunk,
    streamcast_init,
    streamcast_round,
)
from consul_tpu_torch.streamcast import model as t_model
from torch_parity import check_arrivals, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEED = 0


def _tkey(jkey):
    return key_from_numpy(np.asarray(jkey))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_equal(want, got, msg=""):
    """numpy arrays or a state NamedTuple: values and dtypes."""
    if hasattr(want, "_fields"):
        for name in want._fields:
            _assert_equal(getattr(want, name), getattr(got, name),
                          f"{msg} {name}")
        return
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.dtype == got.dtype, f"{msg}: {want.dtype} != {got.dtype}"
    np.testing.assert_array_equal(want, got, err_msg=msg)


def _cfgs(**kw):
    """The same StreamcastConfig in both packages (loss ramps given as
    tuples of pieces)."""
    ramps = kw.pop("ramps", None)
    jkw, tkw = dict(kw), dict(kw)
    if ramps:
        jkw["faults"] = JFaults(ramps=tuple(JRamp(p) for p in ramps))
        tkw["faults"] = FaultSchedule(ramps=tuple(LossRamp(p) for p in ramps))
    return j_model.StreamcastConfig(**jkw), StreamcastConfig(**tkw)


# -- the XLA float32 order of the schedule -----------------------------------


@pytest.mark.parametrize("shape", [(270,), (67,), (16, 9)])
def test_exponential_matches_jax(shape):
    for s in range(4):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jax.jit(jax.random.exponential,
                                  static_argnums=1)(key, shape))
        got = exponential(_tkey(key), shape).numpy()
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.view(np.uint32))


@pytest.mark.parametrize("k", [1, 15, 16, 17, 67, 256, 257, 270, 600, 4100])
def test_cumsum_matches_xla(k):
    """XLA's CPU prefix sum (blocks of 16, recursively) bit for bit;
    ``torch.cumsum`` is not it."""
    rng = np.random.default_rng(k)
    cs = jax.jit(jnp.cumsum)
    naive = 0
    for scale in (1.0, 3.3, 1000.0):
        x = (rng.exponential(size=k) * scale).astype(np.float32)
        want = np.asarray(cs(x))
        got = xla_math.cumsum(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.view(np.uint32))
        naive += int((torch.cumsum(torch.from_numpy(x), 0).numpy()
                      != want).sum())
    if k >= 256:
        assert naive > 0, "torch.cumsum happened to agree; pick other data"


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.6, 1.2, 0.07])
def test_paced_ticks_match_jax(rate):
    """The reference divides by a constant rate, which XLA compiles to a
    multiplication by its float32 reciprocal."""
    want = np.asarray(jax.jit(lambda: j_load.paced_ticks(270, rate))())
    got = load.paced_ticks(270, rate, "cpu").numpy()
    _assert_equal(want, got, f"rate {rate}")
    true_div = np.floor(np.arange(270, dtype=np.float32)
                        / np.float32(rate)).astype(np.int32)
    if rate in (0.3, 0.6, 1.2):
        assert (true_div != want).any(), "true division agreed here"


@pytest.mark.parametrize("tail", [0.25, 0.5, 1.0, 2.0])
def test_heavy_tail_pow_band_is_exact(tail):
    """Every float32 ``u`` within 2**16 ulps of each size step ``k**-tail``
    (k = 2, 3, 4 at E = 4, the presets' tails) gives the reference's
    size; outside the bands the power lies many ulps from every integer,
    where a 1-ulp difference in ``pow`` cannot move the floor."""
    e_max, half = 4, 1 << 16
    alpha = max(np.float32(tail), np.float32(1e-6))
    exponent = float(np.float32(-1.0) / alpha)

    def j_sizes(u):
        p = u ** (jnp.float32(-1.0) / jnp.maximum(jnp.float32(tail), 1e-6))
        return jnp.clip(jnp.floor(p), 1.0, float(e_max)).astype(jnp.int32)

    for k in range(2, e_max + 1):
        mid = np.float32(k ** -float(alpha)).view(np.int32)
        u = np.arange(mid - half, mid + half, dtype=np.int32).view(np.float32)
        want = np.asarray(jax.jit(j_sizes)(u))
        p = xla_math.pow(torch.from_numpy(u), exponent)
        got = torch.clamp(torch.floor(p), 1.0, float(e_max)).to(
            torch.int32).numpy()
        np.testing.assert_array_equal(want, got, err_msg=f"step {k}")
        assert set(np.unique(want)) == {k - 1, k}, "band misses the step"
        # The band edges sit far from the integer k.
        edge = p.numpy()[[0, -1]].astype(np.float64)
        assert np.all(np.abs(edge - k) > 16 * np.spacing(np.float32(k)))


@pytest.mark.parametrize("tail", [0.0, 0.25, 0.5, 1.0, 2.0])
def test_heavy_tail_sizes_match_jax(tail):
    for s in range(3):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jax.jit(j_load.heavy_tail_sizes,
                                  static_argnums=(1, 2, 3))(key, 270, 4,
                                                             tail))
        got = load.heavy_tail_sizes(_tkey(key), 270, 4, tail)
        _assert_equal(want, got, f"seed {s}")


ARRIVAL_CASES = {
    "poisson_names": dict(n=4096, events=67, chunks=4, window=8, rate=0.3,
                          names=16),
    "poisson_unnamed_fast": dict(n=500, events=270, chunks=4, window=7,
                                 rate=1.2),
    "poisson_slow": dict(n=1000, events=270, chunks=4, window=7, rate=0.1),
    "paced_adversarial": dict(n=1000, events=270, chunks=4, window=7,
                              rate=0.6, arrivals="paced", backlog=7,
                              hotspot=0.5, hotspot_node=11, size_tail=0.5),
    "poisson_tail2": dict(n=1000, events=100, chunks=4, window=7, rate=0.3,
                          size_tail=2.0, names=5, hotspot=1.0),
    "scheduled": dict(n=64, chunks=4, window=2, schedule=(
        (0, 5, -1), (0, 9, 2, 3), (3, 5, 2, 1), (7, 63, -1, 4))),
}


@pytest.mark.parametrize("case", sorted(ARRIVAL_CASES))
def test_arrival_arrays_match_jax(case):
    jcfg, cfg = _cfgs(**ARRIVAL_CASES[case])
    arrays = jax.jit(j_model.arrival_arrays, static_argnums=0)
    for s in range(5):
        key = jax.random.fold_in(jax.random.PRNGKey(s), j_model._SCHED_SALT)
        want = arrays(jcfg, key)
        got = arrival_arrays(cfg, _tkey(key))
        for name, w, g in zip(("tick", "origin", "name", "chunks"), want,
                              got):
            _assert_equal(w, g, f"{case} seed {s} {name}")


# -- the window and the selection seam ----------------------------------------


def _random_window(rng, w, k):
    """A window mid-stream: some slots hold events below the current ids,
    a batch of same-tick arrivals with names drawn from a small space."""
    slot_event = np.full(w, -1, np.int32)
    occ = rng.random(w) < rng.uniform(0.2, 1.0)
    ids = rng.choice(k // 2, size=w, replace=False).astype(np.int32)
    slot_event[occ] = ids[occ]
    slot_birth = rng.integers(0, 20, size=w).astype(np.int32)
    arrive = np.zeros(k, bool)
    arrive[k // 2 + rng.choice(k - k // 2, size=rng.integers(0, k // 2),
                               replace=False)] = True
    ev_name = rng.integers(-1, 4, size=k).astype(np.int32)
    return slot_event, slot_birth, arrive, ev_name


def test_admit_and_retire_match_jax():
    rng = np.random.default_rng(0)
    j_admit = jax.jit(j_window.admit)
    j_retire = jax.jit(j_window.retire, static_argnums=5)
    seen = np.zeros(3, int)  # overflow, coalesced, freed
    for case in range(240):
        # A few fixed shapes, so that each compiles once.
        w, k = ((1, 6), (3, 12), (4, 24), (8, 40))[case % 4]
        slot_event, slot_birth, arrive, ev_name = _random_window(rng, w, k)
        tick = np.int32(20)
        want = j_admit(slot_event, slot_birth, arrive, ev_name, tick)
        got = admit(*(torch.from_numpy(x) for x in (slot_event, slot_birth,
                                                    arrive, ev_name)),
                    torch.tensor(20, dtype=torch.int32))
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_equal(a, b, f"case {case} output {i}")
        seen += (int(want[4]) > 0, int(want[5]) > 0, bool(want[3].any()))
        done = rng.integers(0, 10, size=w).astype(np.int32)
        active = rng.integers(0, 3, size=w).astype(np.int32)
        birth = np.asarray(want[1])
        want_r = j_retire(np.asarray(want[0]), done, active, birth, tick, 7)
        got_r = retire(got[0], torch.from_numpy(done),
                       torch.from_numpy(active), got[1],
                       torch.tensor(20, dtype=torch.int32), 7)
        for i, (a, b) in enumerate(zip(want_r, got_r)):
            _assert_equal(a, b, f"case {case} retire {i}")
    assert seen.min() > 10, seen


@pytest.mark.parametrize("policy", POLICIES)
def test_select_chunk_matches_jax(policy):
    rng = np.random.default_rng(1)
    jcfg, cfg = _cfgs(n=64, chunks=5, window=3, rate=0.1, events=4,
                      policy=policy)
    rows = np.arange(64, dtype=np.int32)
    sel_j = jax.jit(j_model.select_chunk, static_argnums=0)
    for s in range(10):
        held = rng.random((64, 3, 5)) < rng.uniform(0.1, 0.9)
        cursor = rng.integers(0, 6, size=(64, 3)).astype(np.int8)
        serviced = rng.random((64, 3)) < 0.6
        key = jax.random.PRNGKey(s)
        want = sel_j(jcfg, key, rows, held, cursor, serviced)
        got = select_chunk(cfg, _tkey(key), torch.from_numpy(rows),
                           *(torch.from_numpy(x) for x in (held, cursor,
                                                           serviced)))
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_equal(a, b, f"seed {s} output {i}")


# -- the scan -----------------------------------------------------------------


SCAN_BASE = dict(n=768, events=60, chunks=4, window=4, fanout=4,
                 chunk_budget=2, loss=0.1, done_frac=0.9, rate=0.4, names=6)
SCAN_STEPS = 40


@functools.lru_cache(maxsize=None)
def _jax_scan(delivery, policy, steps=SCAN_STEPS, **extra):
    jcfg, _ = _cfgs(**{**SCAN_BASE, **dict(extra)}, delivery=delivery,
                    policy=policy)
    final, outs = j_scan(j_model.streamcast_init(jcfg),
                         jax.random.PRNGKey(SEED), jcfg, steps)
    return _np(final), _np(outs)


def _port_scan(cfg, steps):
    return streamcast_scan(streamcast_init(cfg, device="cpu"),
                           _tkey(jax.random.PRNGKey(SEED)), cfg, steps)


@pytest.mark.parametrize("policy", POLICIES)
def test_edges_scan_matches_jax(policy):
    _, cfg = _cfgs(**SCAN_BASE, delivery="edges", policy=policy)
    j_final, j_outs = _jax_scan("edges", policy)
    final, outs = _port_scan(cfg, SCAN_STEPS)
    for i, (a, b) in enumerate(zip(j_outs, outs)):
        _assert_equal(a, b, f"output {i}")
    _assert_equal(j_final, final, "final")
    assert int(final.delivered) > 0 and int(final.coalesced) > 0
    assert int(final.window_overflow) > 0
    assert final.cursor.dtype == torch.int8


def test_edges_scan_matches_jax_at_the_default_thread_count(one_torch_thread):
    """The module runs on one thread; here the edges scan runs at
    PyTorch's default count, at a size whose [n, W, E] planes are large
    enough for PyTorch to split across threads."""
    kw = dict(SCAN_BASE, n=4096, delivery="edges", policy="uniform")
    j_final, j_outs = _jax_scan("edges", "uniform", 6, n=4096)
    _, cfg = _cfgs(**kw)
    torch.set_num_threads(one_torch_thread)
    try:
        final, outs = _port_scan(cfg, 6)
    finally:
        torch.set_num_threads(1)
    for i, (a, b) in enumerate(zip(j_outs, outs)):
        _assert_equal(a, b, f"output {i}")
    _assert_equal(j_final, final, "final")


@functools.partial(jax.jit, static_argnums=(2, 3))
def _j_rate(contrib, p, fanout, n):
    """The reference's class rate from the contributions, as XLA compiles
    it (model.py's ``(s_tot - contrib) * fanout * p_live / (n - 1)``)."""
    s_tot = jnp.sum(contrib, axis=0)
    return (s_tot[None] - contrib) * fanout * p / max(n - 1, 1)


_j_threshold = jax.jit(lambda lam: -jnp.expm1(-lam))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _j_uniform(key, n, shape):
    return j_model.owned_uniform(key, jnp.arange(n, dtype=jnp.int32), shape)


def _aggregate_step_rule(jcfg, cfg, st_np, t, sched_np):
    """One aggregate round from the JAX state ``st_np``: the class rates
    equal in both packages, the shared uniforms bit-equal, and a
    receiver differing only where its uniform lies between the two
    thresholds (``check_arrivals``).  Returns the number of such
    receivers."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), t)
    st = state_from_numpy(st_np)
    sched = tuple(torch.from_numpy(np.array(a)) for a in sched_np)
    rows = torch.arange(cfg.n, dtype=torch.int32)
    _, k_loss, k_tie, k_chunk = t_model.round_keys(_tkey(key))
    adm = t_model.admit_stage(st, cfg, sched, rows)
    held, serviced, sel, _ = t_model.service_stage(cfg, k_tie, k_chunk, rows,
                                                   adm)
    p_live = t_model._p_live(cfg, st.tick)
    lam_t = t_model.aggregate_rate(cfg, held, serviced, sel, p_live,
                                   lambda x: torch.sum(x, 0, dtype=x.dtype))
    # The reference's rate from the same contributions, compiled by XLA.
    cidx = np.arange(cfg.chunks)
    contrib = (serviced.numpy()[..., None]
               & held.numpy() & (sel.numpy()[..., None] == cidx)
               ).astype(np.float32)
    p_j = np.float32(p_live) if isinstance(p_live, float) else p_live.numpy()
    lam_j = np.asarray(_j_rate(contrib, p_j, cfg.fanout, cfg.n))
    thr_j = np.asarray(_j_threshold(lam_j))
    u_j = np.asarray(_j_uniform(jax.random.split(key)[1], cfg.n,
                                (cfg.window, cfg.chunks)))
    u_t = owned_uniform(k_loss, rows, (cfg.window, cfg.chunks)).numpy()
    thr_t = (-torch.expm1(-lam_t)).numpy()
    return check_arrivals(u_j, u_t, thr_j, thr_t, lam_j, u_j < thr_j,
                          u_t < thr_t, lam_t.numpy())


@pytest.mark.parametrize("policy", POLICIES)
def test_aggregate_rounds_match_jax(policy):
    """Aggregate, tick by tick from the JAX state: the whole next state
    and outputs equal wherever no receiver sat between the thresholds."""
    jcfg, cfg = _cfgs(**SCAN_BASE, delivery="aggregate", policy=policy)
    step = jax.jit(j_model.streamcast_round, static_argnums=2)
    sched_np = _np(jax.jit(j_model.arrival_arrays, static_argnums=0)(
        jcfg, jax.random.fold_in(jax.random.PRNGKey(SEED),
                                 j_model._SCHED_SALT)))
    sched_t = tuple(torch.from_numpy(np.array(a)) for a in sched_np)
    state = _np(j_model.streamcast_init(jcfg))
    compared = 0
    for t in range(SCAN_STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), t)
        nxt, outs = step(state, key, jcfg, sched_np)
        got, got_outs = streamcast_round(state_from_numpy(state), _tkey(key),
                                         cfg, sched_t)
        if _aggregate_step_rule(jcfg, cfg, state, t, sched_np) == 0:
            _assert_equal(_np(nxt), got, f"tick {t}")
            for i, (a, b) in enumerate(zip(_np(outs), got_outs)):
                _assert_equal(a, b, f"tick {t} output {i}")
            compared += 1
        state = _np(nxt)
    assert compared >= SCAN_STEPS - 2
    assert int(state.delivered) > 0


def test_edges_scan_with_a_loss_ramp_matches_jax():
    ramps = (((5, 0.4), (20, 0.1)), ((10, 0.2),))
    j_final, j_outs = _jax_scan("edges", "pipeline", ramps=ramps)
    _, cfg = _cfgs(**SCAN_BASE, delivery="edges", policy="pipeline",
                   ramps=ramps)
    final, outs = _port_scan(cfg, SCAN_STEPS)
    for i, (a, b) in enumerate(zip(j_outs, outs)):
        _assert_equal(a, b, f"output {i}")
    _assert_equal(j_final, final, "final")


def test_edges_scan_paced_adversarial_matches_jax():
    extra = dict(arrivals="paced", backlog=3, hotspot=0.4, hotspot_node=5,
                 size_tail=1.0, names=0)
    j_final, j_outs = _jax_scan("edges", "rarest", **extra)
    _, cfg = _cfgs(**{**SCAN_BASE, **extra}, delivery="edges",
                   policy="rarest")
    final, outs = _port_scan(cfg, SCAN_STEPS)
    for i, (a, b) in enumerate(zip(j_outs, outs)):
        _assert_equal(a, b, f"output {i}")
    _assert_equal(j_final, final, "final")


def test_scheduled_four_tuples_match_jax():
    kw = dict(n=200, chunks=4, window=2, fanout=3, chunk_budget=1, loss=0.05,
              schedule=((0, 3, -1, 2), (0, 7, 1), (2, 9, 1, 3),
                        (4, 199, -1, 1), (4, 0, -1)))
    jcfg, cfg = _cfgs(**kw, policy="pipeline")
    j_final, j_outs = j_scan(j_model.streamcast_init(jcfg),
                             jax.random.PRNGKey(4), jcfg, 30)
    final, outs = streamcast_scan(streamcast_init(cfg, device="cpu"),
                                  _tkey(jax.random.PRNGKey(4)), cfg, 30)
    for i, (a, b) in enumerate(zip(_np(j_outs), outs)):
        _assert_equal(a, b, f"output {i}")
    _assert_equal(_np(j_final), final, "final")
    assert int(final.window_overflow) > 0 and int(final.coalesced) > 0


@pytest.mark.parametrize("delivery", ["edges", "aggregate"])
def test_w1_e1_is_the_port_broadcast(delivery):
    """At window 1 and one chunk a single scheduled event is the
    broadcast: ``done_count`` equals ``infected`` while the slot lives."""
    n, fanout, loss, steps = 128, 3, 0.05, 20
    scfg = StreamcastConfig(n=n, window=1, chunks=1, fanout=fanout,
                            loss=loss, schedule=((0, 0, -1),),
                            delivery=delivery)
    bcfg = BroadcastConfig(n=n, fanout=fanout, loss=loss, delivery=delivery)
    key = _tkey(jax.random.PRNGKey(3))
    _, infected = broadcast_scan(broadcast_init(bcfg, device="cpu"), key,
                                 bcfg, steps)
    _, outs = streamcast_scan(streamcast_init(scfg, device="cpu"), key, scfg,
                              steps)
    alive = outs[0][:, 0] == 0
    assert bool(alive.all()) or int(outs[4][-1]) == 1
    assert torch.equal(outs[2][:, 0][alive], infected[alive])


BAD_CONFIGS = [
    dict(n=8, rate=0.1, events=4, delivery="bogus"),
    dict(n=8, rate=0.1, events=4, chunks=0),
    dict(n=8, rate=0.1, events=4, chunk_budget=0),
    dict(n=8, rate=0.1, events=4, policy="fastest"),
    dict(n=8, rate=0.1, events=4, arrivals="bursty"),
    dict(n=8, rate=0.1, events=4, backlog=-1),
    dict(n=8, rate=0.1, events=4, size_tail=-0.5),
    dict(n=8, rate=0.1, events=4, hotspot=1.5),
    dict(n=8, rate=0.1, events=4, hotspot_node=8),
    dict(n=8, rate=0.1, events=4, done_frac=0.0),
    dict(n=8, rate=0.1, events=4, backlog=5),
    dict(n=8, rate=0.0, events=4),
    dict(n=8, rate=0.1),
    dict(n=8, rate=0.1, schedule=((0, 1, -1),)),
    dict(n=8, events=3, schedule=((0, 1, -1),)),
    dict(n=8, backlog=1, schedule=((0, 1, -1),)),
    dict(n=8, arrivals="paced", schedule=((0, 1, -1),)),
    dict(n=8, schedule=((0, 1),)),
    dict(n=8, chunks=2, schedule=((0, 1, -1, 3),)),
    dict(n=8, schedule=((-1, 1, -1),)),
    dict(n=8, schedule=((3, 1, -1), (2, 1, -1))),
    dict(n=8, schedule=((0, 8, -1),)),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=range(len(BAD_CONFIGS)))
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        j_model.StreamcastConfig(**kw)
    with pytest.raises(ValueError):
        StreamcastConfig(**kw)


def test_config_properties_and_fault_rejection():
    for kw in (dict(n=1000, rate=0.3, events=9, chunks=4, done_frac=0.999),
               dict(n=7, chunks=3, schedule=((0, 1, -1), (2, 3, 4, 2)))):
        jcfg, cfg = _cfgs(**kw)
        for prop in ("k_events", "done_target", "tx_limit", "fanout",
                     "retransmit_mult"):
            assert getattr(jcfg, prop) == getattr(cfg, prop), prop
    from consul_tpu_torch.sim import Partition
    with pytest.raises(ValueError, match="loss ramps only"):
        StreamcastConfig(n=8, rate=0.1, events=4, faults=FaultSchedule(
            partitions=(Partition(start=0, heal=5, segments=2),)))
    assert t_model.cursor_dtype(127) == torch.int8
    assert t_model.cursor_dtype(128) == torch.int16


def test_run_streamcast_matches_jax_report():
    kw = dict(SCAN_BASE, delivery="edges")
    jcfg, cfg = _cfgs(**kw)
    want = j_run_streamcast(jcfg, 30, seed=1, warmup=False,
                            policy="pipeline")
    got = run_streamcast(cfg, 30, seed=1, warmup=False, policy="pipeline",
                         device="cpu")
    ws, gs = want.summary(), got.summary()
    assert set(ws) == set(gs)
    ws.pop("sim_rounds_per_sec"), gs.pop("sim_rounds_per_sec")
    assert ws == gs
    assert got.policy == "pipeline" and got.shard_overflow is None
    assert got.device == "cpu"
    for name in ("slot_event", "done_count", "sent"):
        _assert_equal(getattr(want, name), getattr(got, name), name)


def test_run_streamcast_rejects_what_waits():
    _, cfg = _cfgs(**SCAN_BASE)
    with pytest.raises(ValueError, match="requires mesh"):
        run_streamcast(cfg, 2, exchange="ring", device="cpu")
    with pytest.raises(NotImplementedError, match="telemetry"):
        run_streamcast(cfg, 2, telemetry=True, device="cpu")
    with pytest.raises(ValueError, match="policy"):
        run_streamcast(cfg, 2, policy="fastest", device="cpu")
    with pytest.raises(ValueError, match="requires mesh"):
        stream100k(n=64, steps=10, exchange="ring", device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_stream100k_preset_matches_jax(policy):
    want = j_stream100k(seed=0, n=4096, steps=40, policy=policy)
    got = stream100k(seed=0, n=4096, steps=40, policy=policy, device="cpu")
    assert set(want) == set(got)
    want.pop("sim_rounds_per_sec"), got.pop("sim_rounds_per_sec")
    assert want == got


def test_state_round_trip_keeps_dtypes():
    jcfg, _ = _cfgs(**SCAN_BASE, delivery="edges", policy="pipeline")
    state, _ = _jax_scan("edges", "pipeline")
    back = state_from_numpy(state)
    assert isinstance(back, StreamcastState)
    assert back.cursor.dtype == torch.int8 and back.tick.dim() == 0
    _assert_equal(state, state_to_numpy(back), "round trip")
    del jcfg
