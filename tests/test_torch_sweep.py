"""The sweep plane: ``consul_tpu_torch.sweep`` against the JAX package's
``consul_tpu.sweep`` on the CPU.

Both packages run the same universes (the same keys, knob values and
stacked initial state); the reference's batched program is its
``make_sweep`` (``jax.jit(jax.vmap(...))``), as its ``run_sweep`` runs it.
Every per-tick output and every leaf of the final state must be equal,
dtype included.  (The aggregate paths draw their arrivals by the
threshold rule of ``torch_parity.check_arrivals``; in these universes no
receiver lies between the two packages' thresholds, so the trajectories
are equal.)

* U = 1 equals the port's plain scan and the reference's U = 1 sweep,
  for the five entrypoints and the ``pipeline`` policy;
* a ``loss`` knob at its default equals the static program; the swept
  suspicion-timeout table equals the reference's traced table, s = 1.0
  included, where it is not the static table;
* ``validate_knob`` rejects what the reference rejects, with its
  messages; keys are prefix-stable and equal the reference's;
* the report reductions, the Pareto mask and the optimizer equal the
  reference's on the same outputs;
* batching is real: one tick at U = 8 runs as many ATen ops (views
  aside) as at U = 1;
* ``telemetry=`` is its own cached program (tests/test_torch_obs_sweep.py
  holds its trace), and the composition's rejections use the reference's
  messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import consul_tpu.sweep.universe as JU
from consul_tpu.geo import GeoConfig as JGeo
from consul_tpu.models.broadcast import BroadcastConfig as JBroadcast
from consul_tpu.models.lifeguard import LifeguardConfig as JLifeguard
from consul_tpu.models.membership import MembershipConfig as JMembership
from consul_tpu.models.membership_sparse import (
    SparseMembershipConfig as JSparse,
)
from consul_tpu.models.swim import SwimConfig as JSwim
from consul_tpu.models.swim import _lifeguard_timeout_ticks
from consul_tpu.protocol.profiles import PROFILES as J_PROFILES
from consul_tpu.streamcast import StreamcastConfig as JStream
from consul_tpu.sweep import frontier as j_frontier
from consul_tpu.sweep import optimize as j_optimize
from consul_tpu_torch.convert import state_to_numpy, universe_from_numpy
from consul_tpu_torch.geo import GeoConfig
from consul_tpu_torch.models import (
    BroadcastConfig,
    LifeguardConfig,
    MembershipConfig,
    SparseMembershipConfig,
    SwimConfig,
)
from consul_tpu_torch.models.swim import timeout_table, traced_timeout_table
from consul_tpu_torch.ops import PRNGKey
from consul_tpu_torch.protocol import PROFILES
from consul_tpu_torch.sim import engine, run_sweep
from consul_tpu_torch.streamcast import StreamcastConfig
from consul_tpu_torch.sweep import (
    Universe,
    frontier,
    make_sweep,
    optimize,
    pareto_mask,
    stacked_init,
    summarize_sweep,
    validate_knob,
)
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (reference config, port config kwargs, steps) per entrypoint: the
# reference's own U = 1 pins (tests/test_sweep.py), with horizons long
# enough that SWIM declares deaths and the stream overflows its window.
GEO_KW = dict(n=64, segments=8, bridges_per_segment=2, events=4,
              wan_window=4, wan_msg_bytes=100, wan_capacity_bytes=800.0,
              wan_queue_bytes=1600.0, ae_batch=4, loss_wan=0.05)
STREAM_KW = dict(n=64, events=10, chunks=2, window=3, fanout=3,
                 chunk_budget=2, rate=0.4, names=3, loss=0.05,
                 delivery="edges")
SMALL = {
    "swim": (JSwim, SwimConfig, dict(n=64, subject=1, loss=0.05), 60),
    "lifeguard": (JLifeguard, LifeguardConfig,
                  dict(n=64, subject=1, subject_alive=True, ack_late=0.05,
                       loss=0.1), 30),
    "broadcast": (JBroadcast, BroadcastConfig,
                  dict(n=64, fanout=3, loss=0.05), 10),
    "streamcast": (JStream, StreamcastConfig, STREAM_KW, 10),
    "geo": (JGeo, GeoConfig, GEO_KW, 8),
}
PLAIN_SCAN = {
    "swim": engine.swim_scan, "lifeguard": engine.lifeguard_scan,
    "broadcast": engine.broadcast_scan,
    "streamcast": engine.streamcast_scan, "geo": engine.geo_scan,
}


def _leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [t.numpy() for t in x]


def _assert_leaves(want: list, got: list, what: str) -> None:
    assert len(want) == len(got), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype, f"{what} leaf {i}: {w.dtype} != {g.dtype}"
        np.testing.assert_array_equal(w, g, err_msg=f"{what} leaf {i}")


def sweep_both(entrypoint, jcfg, tcfg, steps, knobs=(), values=(),
               **seeding):
    """Run one sweep in both packages from the reference's keys, knob
    arrays and stacked state (carried over by ``convert``); returns
    ``((j_final, j_outs), (t_final, t_outs))`` as lists of numpy leaves."""
    ju = JU.Universe(entrypoint=entrypoint, cfg=jcfg, steps=steps,
                     knobs=knobs, values=values, **seeding)
    tu = Universe(entrypoint=entrypoint, cfg=tcfg, steps=steps,
                  knobs=knobs, values=values, **seeding)
    j_state, j_keys, j_vals = JU.stacked_init(ju), ju.keys(), ju.knob_arrays()
    keys, vals, state = universe_from_numpy(
        np.asarray(j_keys), knobs, [np.asarray(v) for v in j_vals],
        jax.tree_util.tree_map(np.asarray, j_state))
    np.testing.assert_array_equal(keys.numpy(), tu.keys("cpu").numpy())
    j_final, j_outs = JU.make_sweep(entrypoint, ju.U)(
        j_state, j_keys, j_vals, jcfg, steps, knobs, ())
    t_final, t_outs = make_sweep(entrypoint, tu.U)(
        state, keys, vals, tcfg, steps, knobs, ())
    return ((_leaves(j_final), _leaves(j_outs)),
            (_port_leaves(t_final), _port_leaves(t_outs)))


def assert_sweeps_equal(entrypoint, jcfg, tcfg, steps, knobs=(), values=(),
                        **seeding):
    (jf, jo), (tf, to) = sweep_both(entrypoint, jcfg, tcfg, steps, knobs,
                                    values, **seeding)
    _assert_leaves(jo, to, f"{entrypoint} per-tick outputs")
    _assert_leaves(jf, tf, f"{entrypoint} final state")
    return to


@pytest.mark.parametrize("case", ["swim", "lifeguard", "broadcast",
                                  "streamcast", "streamcast-pipeline",
                                  "geo"])
def test_u1_equals_plain_scan_and_reference(case):
    """U = 1 at seed 5: the port's sweep equals its plain scan (every
    output and state leaf, with the universe axis dropped) and the
    reference's U = 1 sweep."""
    entrypoint, _, policy = case.partition("-")
    jcls, tcls, kw, steps = SMALL[entrypoint]
    if policy:
        kw = dict(kw, policy=policy)
    jcfg, tcfg = jcls(**kw), tcls(**kw)
    (jf, jo), (tf, to) = sweep_both(entrypoint, jcfg, tcfg, steps,
                                    seeds=(5,))
    _assert_leaves(jo, to, "outputs vs reference")
    _assert_leaves(jf, tf, "final state vs reference")
    init = stacked_init(Universe(entrypoint=entrypoint, cfg=tcfg,
                                 steps=steps, seeds=(5,)), "cpu")
    p_final, p_outs = PLAIN_SCAN[entrypoint](
        type(init)(*(x[0] for x in init)), PRNGKey(5), tcfg, steps)
    _assert_leaves([x[0] for x in to], _port_leaves(p_outs),
                   "U=1 outputs vs plain scan")
    _assert_leaves([x[0] for x in tf], list(state_to_numpy(p_final)),
                   "U=1 final state vs plain scan")


def test_loss_knob_at_default_is_static():
    """The knob path with ``loss`` at the static config's own value
    reproduces the static program (the reference's pin at
    tests/test_sweep.py:145-160), on the edges path where the loss
    enters as ``1 - loss``."""
    jcls, tcls, kw, steps = SMALL["swim"]
    tcfg = tcls(**kw)
    knobbed = assert_sweeps_equal("swim", jcls(**kw), tcfg, steps,
                                  knobs=("loss",), values=((kw["loss"],),),
                                  seeds=(5,))
    _, plain = engine.swim_scan(
        stacked_init(Universe(entrypoint="swim", cfg=tcfg, steps=steps,
                              seeds=(5,)), "cpu"), PRNGKey(5)[None], tcfg,
        steps)
    _assert_leaves(knobbed, _port_leaves(plain), "knob at default")


def _faults(mod, churn: bool):
    return mod.FaultSchedule(
        ramps=(mod.LossRamp(pieces=((5, 0.3), (15, 0.1))),),
        degraded=(mod.DegradedSet(frac=0.2, drop=0.4, late=0.3, seed=3),),
        partitions=(mod.Partition(start=8, heal=20, severity=0.7),),
        churn=((mod.ChurnWindow(start=4, end=12, p_offline=0.1),)
               if churn else ()))


def _knob_case(name):
    """(entrypoint, reference cfg, port cfg, steps, knobs, values) of a
    knob combination the presets do not sweep."""
    from consul_tpu.sim import faults as jf
    from consul_tpu_torch.sim import faults as tf

    if name == "swim-edges":
        kw = dict(n=64, subject=3, loss=0.05, fail_at_tick=4)
        return ("swim", JSwim(**kw), SwimConfig(**kw), 70,
                ("loss", "suspicion_scale"),
                ((0.0, 0.2, 0.4, 0.05), (0.05, 0.3, 1.0, 2.0)))
    if name == "lifeguard-edges-faults":
        kw = dict(n=64, subject=3, subject_alive=True, loss=0.05,
                  ack_late=0.1)
        return ("lifeguard", JLifeguard(faults=_faults(jf, True), **kw),
                LifeguardConfig(faults=_faults(tf, True), **kw), 30,
                ("faults.ramps[0].scale", "faults.degraded[0].frac",
                 "faults.degraded[0].late", "faults.partitions[0].severity",
                 "faults.churn[0].p_offline"),
                ((0.0, 0.5, 1.0), (0.0, 0.2, 0.5), (0.0, 0.3, 0.9),
                 (0.0, 0.7, 1.0), (0.0, 0.1, 0.3)))
    if name == "lifeguard-off-aggregate":
        kw = dict(n=64, subject=3, fail_at_tick=6, loss=0.1,
                  lifeguard=False, delivery="aggregate")
        return ("lifeguard", JLifeguard(**kw), LifeguardConfig(**kw), 60,
                ("profile.gossip_nodes", "loss", "suspicion_scale"),
                ((2, 3, 5), (0.0, 0.1, 0.3), (0.1, 0.5, 1.0)))
    if name == "broadcast-aggregate":
        kw = dict(n=64, fanout=3, loss=0.05, delivery="aggregate")
        return ("broadcast", JBroadcast(**kw), BroadcastConfig(**kw), 12,
                ("fanout", "loss"), ((1, 2, 4, 6), (0.0, 0.1, 0.3, 0.6)))
    if name == "streamcast-schedule":
        kw = dict(n=64, schedule=((0, 1, -1), (1, 5, 0), (3, 7, 0, 1),
                                  (4, 9, 1), (6, 2, -1)),
                  chunks=3, window=2, fanout=3, loss=0.05,
                  delivery="edges", policy="rarest")
        return ("streamcast", JStream(faults=jf.FaultSchedule(
                    ramps=(jf.LossRamp(pieces=((2, 0.4),)),)), **kw),
                StreamcastConfig(faults=tf.FaultSchedule(
                    ramps=(tf.LossRamp(pieces=((2, 0.4),)),)), **kw), 20,
                ("loss", "chunk_budget", "faults.ramps[0].scale"),
                ((0.0, 0.1, 0.3), (1, 2, 1), (0.0, 0.5, 1.0)))
    if name == "streamcast-hotspot":
        kw = dict(n=128, events=30, chunks=4, window=4, fanout=3,
                  chunk_budget=2, rate=0.5, loss=0.05, hotspot=0.2,
                  delivery="aggregate", policy="pipeline")
        return ("streamcast", JStream(**kw), StreamcastConfig(**kw), 30,
                ("hotspot", "fanout", "rate"),
                ((0.0, 0.5, 1.0), (2, 3, 4), (0.3, 0.5, 0.9)))
    kw = dict(GEO_KW, adaptive=False)
    return ("geo", JGeo(faults=jf.FaultSchedule(
                ramps=(jf.LossRamp(pieces=((3, 0.5),)),)), **kw),
            GeoConfig(faults=tf.FaultSchedule(
                ramps=(tf.LossRamp(pieces=((3, 0.5),)),)), **kw), 30,
            ("loss_lan", "loss_wan", "ae_gain", "faults.ramps[0].scale"),
            ((0.0, 0.2, 0.5), (0.0, 0.1, 0.4), (0.1, 0.5, 0.9),
             (0.0, 0.5, 1.0)))


@pytest.mark.parametrize("name", [
    "swim-edges", "lifeguard-edges-faults", "lifeguard-off-aggregate",
    "broadcast-aggregate", "streamcast-schedule", "streamcast-hotspot",
    "geo-fixed-ramp"])
def test_knob_combinations_match_reference(name):
    """U > 1 with knob combinations the presets leave out (every fault
    primitive's severity with 0.0 rungs, Lifeguard off, the aggregate
    fanout of broadcast, a scheduled stream with a loss ramp, a swept
    hotspot, geo's fixed arm), equal to the reference's batched program
    on every output and state leaf."""
    entrypoint, jcfg, tcfg, steps, knobs, values = _knob_case(name)
    outs = assert_sweeps_equal(entrypoint, jcfg, tcfg, steps, knobs, values,
                               seeds=tuple(range(len(values[0]))))
    first = outs[0]
    assert any(not np.array_equal(first[0], row) for row in first[1:]), \
        "every universe ran the same study"


TABLE_SCALES = (0.05, 0.15, 0.5, 0.7, 1.0, 1.5, 2.0)


@pytest.mark.parametrize("profile", ["lan", "wan", "local"])
@pytest.mark.parametrize("n", [64, 100, 1024, 4096])
def test_traced_timeout_table_matches_reference(profile, n):
    """The per-universe table of a swept ``suspicion_scale`` equals the
    reference's ``_lifeguard_timeout_ticks`` under ``jax.jit(jax.vmap)``
    at every scale, 1.0 included; at WAN n=100 the traced table is not
    the static one even at s = 1 (its floor ``lo`` is not a whole
    tick)."""
    jcfg = JSwim(n=n, profile=J_PROFILES[profile])
    k = jcfg.confirmations_k

    def table(s):
        c = dataclasses.replace(jcfg, suspicion_scale=s)
        return _lifeguard_timeout_ticks(c, jnp.arange(k + 1, dtype=jnp.int32))

    scales = np.asarray(TABLE_SCALES, np.float32)
    want = np.asarray(jax.jit(jax.vmap(table))(jnp.asarray(scales)))
    tcfg = SwimConfig(n=n, profile=PROFILES[profile],
                      suspicion_scale=torch.from_numpy(scales))
    got = traced_timeout_table(tcfg).numpy()
    assert want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    if (profile, n) == ("wan", 100):
        static = timeout_table(SwimConfig(n=n, profile=PROFILES[profile]))
        assert not np.array_equal(got[TABLE_SCALES.index(1.0)],
                                  static.numpy())


# ---------------------------------------------------------------------------
# Knob validation: the reference's cases (tests/test_sweep.py:199-330).
# ---------------------------------------------------------------------------


def _fault_cfgs():
    from consul_tpu.sim import faults as jf
    from consul_tpu_torch.sim import faults as tf

    def cfg(mod, cls):
        return cls(n=64, subject=1, subject_alive=True, faults=mod.FaultSchedule(
            ramps=(mod.LossRamp(pieces=((2, 0.3),)),),
            degraded=(mod.DegradedSet(frac=0.1),)))

    return cfg(jf, JLifeguard), cfg(tf, LifeguardConfig)


def _membership_cfgs():
    kw = dict(n=48, fail_at=((3, 2),))
    return JMembership(**kw), MembershipConfig(**kw)


def _sparse_cfgs():
    jm, tm = _membership_cfgs()
    return JSparse(base=jm, k_slots=8), SparseMembershipConfig(base=tm,
                                                               k_slots=8)


def _cfgs(kind):
    if kind == "swim":
        return JSwim(n=64, subject=1), SwimConfig(n=64, subject=1)
    if kind == "swim-agg":
        kw = dict(n=64, subject=1, delivery="aggregate")
        return JSwim(**kw), SwimConfig(**kw)
    if kind == "stream":
        return JStream(**STREAM_KW), StreamcastConfig(**STREAM_KW)
    if kind == "faults":
        return _fault_cfgs()
    if kind == "membership":
        return _membership_cfgs()
    return _sparse_cfgs()


KNOB_CASES = [
    # (entrypoint, cfg kind, knob, value, raises, message pattern)
    *(("swim", "swim", k, 0.1, True, "shapes or trace-time structure")
      for k in ("n", "subject", "delivery", "profile.suspicion_mult",
                "profile.probe_interval_ms", "fail_at_tick")),
    ("swim", "swim", "n", 0.1, True, "sweepable for 'swim'"),
    ("swim", "swim", "profile.gossip_nodes", 4, True,
     r"\[n, fanout\].*aggregate"),
    ("swim", "swim-agg", "profile.gossip_nodes", 4, False, None),
    ("swim", "swim-agg", "fanout", 4, True,
     r"only via \['profile\.gossip_nodes'\]"),
    ("membership", "membership", "piggyback", 4, True, None),
    ("membership", "membership", "fanout", 4, True, None),
    ("sparse", "sparse", "k_slots", 16, True,
     "shapes or trace-time structure"),
    ("swim", "swim", "losss", 0.1, True, "has no field"),
    *(("streamcast", "stream", k, v, False, None)
      for k, v in (("rate", 0.5), ("chunk_budget", 3), ("size_tail", 1.0),
                   ("hotspot", 0.5))),
    *(("streamcast", "stream", k, 4, True, "shapes or trace-time structure")
      for k in ("window", "chunks", "events", "names", "policy", "backlog",
                "hotspot_node")),
    ("streamcast", "stream", "fanout", 4, True, r"\[n, fanout\].*aggregate"),
    *(("lifeguard", "faults", k, 0.5, False, None)
      for k in ("faults.ramps[0].scale", "faults.degraded[0].drop",
                "faults.degraded[0].frac")),
    ("lifeguard", "faults", "faults.degraded[0].seed", 1, True, None),
    ("swim", "swim", "faults.bandwidth[0].scale", 0.5, True, "has no field"),
]


@pytest.mark.parametrize(
    "case", KNOB_CASES,
    ids=[f"{c[0]}:{c[2]}:{'reject' if c[4] else 'ok'}" for c in KNOB_CASES])
def test_validate_knob_matches_reference(case):
    entrypoint, kind, knob, value, raises, pattern = case
    jcfg, tcfg = _cfgs(kind)
    messages = []
    for mod, cfg in ((JU, jcfg), (None, tcfg)):
        uni = JU.Universe if mod else Universe
        try:
            uni(entrypoint=entrypoint, cfg=cfg, steps=4, seeds=(0,),
                knobs=(knob,), values=((value,),))
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    assert messages[0] == messages[1]
    assert (messages[1] is not None) == raises
    if pattern is not None:
        import re
        assert re.search(pattern, messages[1])


@pytest.mark.parametrize("kw, pattern", [
    (dict(), "exactly one of"),
    (dict(seeds=(0,), split_from=1, universes=2), "exactly one of"),
    (dict(seeds=(0, 1), knobs=("loss",), values=((0.1,),)), "values for U="),
    (dict(seeds=(0,), universes=2), "silently ignored"),
])
def test_universe_construction_rejections(kw, pattern):
    with pytest.raises(ValueError, match=pattern):
        Universe(entrypoint="swim", cfg=SwimConfig(n=64, subject=1),
                 steps=4, **kw)
    with pytest.raises(ValueError, match=pattern):
        JU.Universe(entrypoint="swim", cfg=JSwim(n=64, subject=1), steps=4,
                    **kw)


def test_keys_prefix_stable_and_equal_reference():
    cfg, jcfg = SwimConfig(n=64, subject=1), JSwim(n=64, subject=1)
    k16 = Universe(entrypoint="swim", cfg=cfg, steps=1, split_from=3,
                   universes=16).keys("cpu")
    k64 = Universe(entrypoint="swim", cfg=cfg, steps=1, split_from=3,
                   universes=64).keys("cpu")
    assert torch.equal(k16, k64[:16])
    want = JU.Universe(entrypoint="swim", cfg=jcfg, steps=1, split_from=3,
                       universes=64).keys()
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  k64.numpy())
    seeds = Universe(entrypoint="swim", cfg=cfg, steps=1,
                     seeds=(0, 7, 2 ** 31)).keys("cpu")
    want = JU.Universe(entrypoint="swim", cfg=jcfg, steps=1,
                       seeds=(0, 7, 2 ** 31)).keys()
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  seeds.numpy())


def test_sweep_inputs_without_gpu_raise():
    """The stacked state, keys and knob rows default to CUDA, as the
    port's other entry points do: no silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    uni = Universe(entrypoint="swim", cfg=SwimConfig(n=16, subject=1),
                   steps=1, seeds=(0, 1), knobs=("loss",),
                   values=((0.1, 0.2),))
    for make in (lambda: stacked_init(uni), uni.keys, uni.knob_arrays,
                 lambda: run_sweep(uni)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# Host-side reductions: the same outputs give the reference's reports.
# ---------------------------------------------------------------------------


def _assert_metrics(want, got):
    assert sorted(want.metrics) == sorted(got.metrics)
    for name in want.metrics:
        np.testing.assert_array_equal(np.asarray(want.metrics[name]),
                                      np.asarray(got.metrics[name]),
                                      err_msg=name)


@pytest.mark.parametrize("entrypoint", ["swim", "lifeguard", "broadcast",
                                        "streamcast", "geo"])
def test_run_sweep_report_matches_reference(entrypoint):
    """``run_sweep`` on the CPU gives the reference's ``run_sweep``
    metrics on the same universes (knobs varying), and the registry
    names every metric emitted."""
    jcls, tcls, kw, steps = SMALL[entrypoint]
    knobs = {"swim": ("loss",), "lifeguard": ("ack_late",),
             "broadcast": ("loss",), "streamcast": ("rate",),
             "geo": ("loss_lan",)}[entrypoint]
    values = ((0.05, 0.3, 0.6),) if entrypoint != "streamcast" else (
        (0.2, 0.5, 1.0),)
    from consul_tpu.sim.engine import run_sweep as j_run_sweep

    want = j_run_sweep(JU.Universe(entrypoint=entrypoint, cfg=jcls(**kw),
                                   steps=steps, seeds=(1, 2, 3),
                                   knobs=knobs, values=values), warmup=False)
    got = run_sweep(Universe(entrypoint=entrypoint, cfg=tcls(**kw),
                             steps=steps, seeds=(1, 2, 3), knobs=knobs,
                             values=values), warmup=False, device="cpu")
    _assert_metrics(want, got)
    assert set(got.metrics) <= frontier.ENTRYPOINT_METRICS[entrypoint]
    assert got.U == 3 and got.device == "cpu"
    s = got.summary()
    assert s["universes"] == 3 and s["rounds_per_sec"] > 0


def test_summarize_and_pareto_match_reference():
    """``summarize_sweep`` on identical random host outputs, and
    ``pareto_mask``/``frontier`` on random point sets with NaNs and
    ties, equal the reference's."""
    rng = np.random.default_rng(0)
    for entrypoint in ("swim", "lifeguard"):
        kw = dict(n=64, subject=1, fail_at_tick=10)
        cls_j = JSwim if entrypoint == "swim" else JLifeguard
        cls_t = SwimConfig if entrypoint == "swim" else LifeguardConfig
        ju = JU.Universe(entrypoint=entrypoint, cfg=cls_j(**kw), steps=40,
                         seeds=(0, 1, 2, 3), knobs=("loss",),
                         values=((0.0, 0.1, 0.2, 0.3),))
        tu = Universe(entrypoint=entrypoint, cfg=cls_t(**kw), steps=40,
                      seeds=(0, 1, 2, 3), knobs=("loss",),
                      values=((0.0, 0.1, 0.2, 0.3),))
        n_out = 2 if entrypoint == "swim" else 5
        outs = tuple(np.sort(rng.integers(0, 64, (4, 40)), axis=1)
                     .astype(np.int32) for _ in range(n_out))
        if entrypoint == "lifeguard":
            outs = outs[:4] + (rng.random((4, 40)).astype(np.float32),)
        want = j_frontier.summarize_sweep(ju, outs, 1.5)
        got = summarize_sweep(tu, outs, 1.5)
        _assert_metrics(want, got)
        assert want.summary() == got.summary()
        if entrypoint == "lifeguard":
            assert (want.frontier("fp_rate", "detect_t90_ms")
                    == got.frontier("fp_rate", "detect_t90_ms"))
    for _ in range(20):
        pts = rng.integers(0, 5, (12, 2)).astype(float)
        pts[rng.random(12) < 0.15, 0] = np.nan
        np.testing.assert_array_equal(j_frontier.pareto_mask(pts),
                                      pareto_mask(pts))


def test_optimize_sweep_matches_reference():
    """The successive-halving and knee drivers visit the same points and
    answer the same on deterministic objectives (the reference's
    injected-evaluator mode)."""
    jkw = dict(n=64, subject=1, delivery="aggregate")
    grid = ((2, 2, 4, 4, 6, 6), (0.1, 1.5, 0.1, 1.5, 0.1, 1.5))
    knobs = ("profile.gossip_nodes", "suspicion_scale")

    def objective(rows):
        f, s = (np.asarray(r, float) for r in rows)
        return (f - 4.2) ** 2 + (s - 0.7) ** 2

    def knee(rows):
        return np.where(np.asarray(rows[0], float) > 0.77, 1.0, 0.0)

    for mode in ("min", "knee"):
        if mode == "min":
            ju = JU.Universe(entrypoint="swim", cfg=JSwim(**jkw), steps=4,
                             seeds=(0,) * 6, knobs=knobs, values=grid)
            tu = Universe(entrypoint="swim", cfg=SwimConfig(**jkw), steps=4,
                          seeds=(0,) * 6, knobs=knobs, values=grid)
            kw = dict(minimize=True, evaluate=objective)
            obj = "false_dead_mean"
        else:
            rates = ((0.1, 0.3, 0.6, 1.2),)
            ju = JU.Universe(entrypoint="streamcast",
                             cfg=JStream(**STREAM_KW), steps=4,
                             seeds=(0,) * 4, knobs=("rate",), values=rates)
            tu = Universe(entrypoint="streamcast",
                          cfg=StreamcastConfig(**STREAM_KW), steps=4,
                          seeds=(0,) * 4, knobs=("rate",), values=rates)
            kw = dict(knee_at=0.0, evaluate=knee)
            obj = "window_overflow"
        want = j_optimize.optimize_sweep(ju, obj, **kw)
        got = optimize.optimize_sweep(tu, obj, **kw)
        assert want.summary() == got.summary()
        assert want.history == got.history


# ---------------------------------------------------------------------------
# Batching is real, and the later slices raise.
# ---------------------------------------------------------------------------


# Metadata ops: views of an existing buffer, which launch no kernel.
# Which of them a reshape dispatches to depends on the strides (U = 1
# vs U = 8), so they are not counted.
VIEW_OPS = frozenset(f"aten::{op}" for op in (
    "view", "_reshape_alias", "reshape", "as_strided", "slice", "narrow",
    "select", "expand", "unsqueeze", "squeeze", "alias", "detach", "unbind",
    "t", "transpose", "permute", "split", "unflatten", "flatten",
    "view_as", "expand_as", "_unsafe_view"))


def _aten_ops_one_tick(entrypoint, U):
    jcls, tcls, kw, steps = SMALL[entrypoint]
    cfg = tcls(**kw)
    uni = Universe(entrypoint=entrypoint, cfg=cfg, steps=1,
                   seeds=tuple(range(U)))
    sweep = make_sweep(entrypoint, U)
    state, keys = stacked_init(uni, "cpu"), uni.keys("cpu")
    sweep(state, keys, (), cfg, 1)   # warm up lazy imports and caches
    state = stacked_init(uni, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sweep(state, keys, (), cfg, 1)
    return sum(1 for e in prof.events()
               if e.name.startswith("aten::") and e.name not in VIEW_OPS)


@pytest.mark.parametrize("entrypoint", ["swim", "lifeguard", "broadcast",
                                        "streamcast", "geo"])
def test_tick_op_count_does_not_grow_with_u(entrypoint):
    """The universe axis is a tensor dimension, not a loop: one tick of
    the sweep at U = 8 runs exactly as many ATen ops (other than views)
    as at U = 1."""
    ops1 = _aten_ops_one_tick(entrypoint, 1)
    ops8 = _aten_ops_one_tick(entrypoint, 8)
    assert ops1 > 0 and ops8 == ops1, (ops1, ops8)


def test_geo_sweep_host_syncs_per_tick():
    """The Knuth Poisson loop of the WAN gossip reads its predicate on the
    host once a block for the whole batch: at most 2 reads a tick at any
    U, as in the plain geo tick."""
    from consul_tpu_torch.ops import host_cond

    _, _, kw, _ = SMALL["geo"]
    cfg = GeoConfig(**kw)
    for U in (1, 6):
        uni = Universe(entrypoint="geo", cfg=cfg, steps=20,
                       seeds=tuple(range(U)))
        before = host_cond.syncs
        make_sweep("geo", U)(stacked_init(uni, "cpu"), uni.keys("cpu"), (),
                             cfg, 20)
        assert 0 < host_cond.syncs - before <= 2 * 20


def test_later_slices_raise():
    """``telemetry=`` no longer waits: it is one more cached program per
    axis point; the composition's own rejections use the reference's
    messages (no sharded twin for swim and lifeguard, a transport without
    a mesh)."""
    from consul_tpu_torch.parallel import mesh_for

    assert make_sweep("swim", 2, telemetry=True) is make_sweep("swim", 2,
                                                               True)
    assert make_sweep("swim", 2, telemetry=True) is not make_sweep("swim", 2)
    mesh = mesh_for(2, "cpu")
    assert make_sweep("sparse", 2, True, mesh) is not make_sweep(
        "sparse", 2, False, mesh)
    for entrypoint in ("swim", "lifeguard"):
        with pytest.raises(ValueError, match="no sharded twin"):
            make_sweep(entrypoint, 2, mesh=mesh_for(1, "cpu"))
    with pytest.raises(ValueError, match="requires mesh="):
        make_sweep("swim", 2, exchange="ring")
    uni = Universe(entrypoint="swim", cfg=SwimConfig(n=64, subject=1),
                   steps=2, seeds=(0, 1))
    with pytest.raises(ValueError, match="no sharded twin"):
        run_sweep(uni, warmup=False, mesh=mesh_for(2, "cpu"), device="cpu")
    rep = run_sweep(uni, warmup=False, telemetry=True, device="cpu")
    assert rep.metrics_trace.shape == (2, 2, 7)
    with pytest.raises(ValueError, match="unknown sweep entrypoint"):
        make_sweep("multidc", 2)
    assert make_sweep("swim", 3) is make_sweep("swim", 3)
    assert make_sweep("swim", 3) is not make_sweep("swim", 2)
    assert make_sweep("membership", 2) is not make_sweep("sparse", 2)
    with pytest.raises(ValueError, match="built for U=3"):
        make_sweep("swim", 3)(stacked_init(uni, "cpu"), uni.keys("cpu"), (),
                              uni.cfg, 2)


def test_validate_knob_is_the_construction_check():
    """``validate_knob`` alone accepts and rejects as construction does."""
    validate_knob("swim", SwimConfig(n=64, subject=1), "loss")
    with pytest.raises(ValueError, match="shapes or trace-time"):
        validate_knob("swim", SwimConfig(n=64, subject=1), "n")
