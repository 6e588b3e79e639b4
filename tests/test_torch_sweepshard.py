"""The sweep x shard composition: ``make_sweep(..., mesh=, exchange=)`` of
``consul_tpu_torch.sweep`` against the JAX package's composed program on
the CPU (its ``jax.vmap`` over the ``shard_map`` twins, on the virtual
CPU devices of ``tests/conftest.py``).

Both packages run the same universes (keys, knob values and stacked
state carried over by ``convert``).  Every per-tick output, every leaf of
the final state and the overflow per universe must be equal, dtype
included.  The ladder, as in the reference's ``tests/test_sweepshard.py``:

* U = 1 x D = 1 composed == the unsharded sweep == the plain scan ==
  the reference's composed program, per family (broadcast, dense and
  sparse membership, streamcast, geo);
* U = 2 x D = 2 with a knob varying == the reference's composed program;
* D = 2 == D = 1 (overflow 0) and ring == alltoall on the composed plane;
* one callable per (entrypoint, U, mesh, exchange); the reference's loud
  rejections;
* one composed tick runs as many ATen ops at U = 8 as at U = 1;
* ``run_sweep``, ``optimize_sweep`` and ``sweep.compose`` carry the
  overflow column.

The ring kernel itself runs only on the card; here its wrapper takes the
plain version, which ``chip_smoke.py`` holds the kernel against.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import consul_tpu.sweep.universe as JU
from consul_tpu.geo import GeoConfig as JGeo
from consul_tpu.models.broadcast import BroadcastConfig as JBroadcast
from consul_tpu.models.membership import MembershipConfig as JMembership
from consul_tpu.models.membership_sparse import (
    SparseMembershipConfig as JSparse,
)
from consul_tpu.parallel.mesh import mesh_for as j_mesh_for
from consul_tpu.streamcast import StreamcastConfig as JStream
from consul_tpu_torch.convert import universe_from_numpy
from consul_tpu_torch.geo import GeoConfig
from consul_tpu_torch.models import (
    BroadcastConfig,
    MembershipConfig,
    SparseMembershipConfig,
)
from consul_tpu_torch.ops import PRNGKey, ring_exchange
from consul_tpu_torch.parallel import mesh_for
from consul_tpu_torch.sim import engine, run_sweep
from consul_tpu_torch.streamcast import StreamcastConfig
from consul_tpu_torch.sweep import Universe, make_sweep, stacked_init
from consul_tpu_torch.sweep import optimize
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GEO_KW = dict(n=64, segments=8, bridges_per_segment=2, events=4,
              wan_window=4, wan_msg_bytes=100, wan_capacity_bytes=800.0,
              wan_queue_bytes=1600.0, ae_batch=4, loss_wan=0.05)
STREAM_KW = dict(n=64, events=10, chunks=2, window=3, fanout=3,
                 chunk_budget=2, rate=0.4, names=3, loss=0.05,
                 delivery="edges")
MEMB_KW = dict(n=48, loss=0.05, fail_at=((3, 2),))

# (reference cfg, port cfg, steps, track, knob, two knob values) per
# sharded-twin family: the reference's own shapes (tests/test_sweepshard.py;
# sparse keeps K < n, the sharded plane's requirement).
FAMS = {
    "broadcast": (JBroadcast(n=64, fanout=3, loss=0.05),
                  BroadcastConfig(n=64, fanout=3, loss=0.05), 10, (),
                  "loss", (0.05, 0.3)),
    "membership": (JMembership(**MEMB_KW), MembershipConfig(**MEMB_KW), 8,
                   (3,), "loss", (0.05, 0.3)),
    "sparse": (JSparse(base=JMembership(**MEMB_KW), k_slots=8),
               SparseMembershipConfig(base=MembershipConfig(**MEMB_KW),
                                      k_slots=8), 8, (3,), "base.loss",
               (0.05, 0.3)),
    "streamcast": (JStream(**STREAM_KW), StreamcastConfig(**STREAM_KW), 10,
                   (), "rate", (0.4, 0.9)),
    "geo": (JGeo(**GEO_KW), GeoConfig(**GEO_KW), 8, (), "loss_lan",
            (0.0, 0.3)),
}
# The aggregate paths of the twins, with the aggregate-only fanout knob:
# the shards' float32 sender counts summed per shard, then over shards.
# (Arrivals follow torch_parity.check_arrivals' threshold rule; in these
# universes no receiver lies between the two packages' thresholds.)
AGG_FAMS = {
    "broadcast-aggregate": (
        JBroadcast(n=64, fanout=3, loss=0.05, delivery="aggregate"),
        BroadcastConfig(n=64, fanout=3, loss=0.05, delivery="aggregate"),
        12, (), ("fanout", "loss"), ((2, 4), (0.05, 0.3))),
    "streamcast-aggregate": (
        JStream(**dict(STREAM_KW, delivery="aggregate")),
        StreamcastConfig(**dict(STREAM_KW, delivery="aggregate")), 12, (),
        ("fanout", "rate"), ((2, 4), (0.4, 0.9))),
}
PLAIN_SCAN = {
    "broadcast": engine.broadcast_scan,
    "membership": engine.membership_scan,
    "sparse": engine.sparse_membership_scan,
    "streamcast": engine.streamcast_scan,
    "geo": engine.geo_scan,
}


def _universes(model, U, knobbed):
    jcfg, tcfg, steps, track, knob, vals = FAMS[model]
    knobs, values = ((knob,), (vals[:U],)) if knobbed else ((), ())
    seeds = tuple(5 + 2 * u for u in range(U))
    kw = dict(entrypoint=model, steps=steps, seeds=seeds, knobs=knobs,
              values=values, track=track)
    return JU.Universe(cfg=jcfg, **kw), Universe(cfg=tcfg, **kw)


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return [a for t in x for a in _leaves(t)]
    if hasattr(x, "_fields"):
        return [np.asarray(t) if not isinstance(t, torch.Tensor)
                else t.numpy() for t in x]
    return [np.asarray(x)]


def _jax_leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _ref_run(model, U, D, knobbed):
    """The reference's composed (D >= 1) or unsharded (D == 0) sweep, as
    numpy leaves ``(final, outs, overflow)``; cached so that the module
    pays one compile per program."""
    ju, _ = _universes(model, U, knobbed)
    sweep = JU.make_sweep(model, U, False, j_mesh_for(D) if D else None,
                          "alltoall")
    out = sweep(JU.stacked_init(ju), ju.keys(), ju.knob_arrays(), ju.cfg,
                ju.steps, ju.knobs, ju.track)
    ov = np.asarray(out[2]) if D else None
    return _jax_leaves(out[0]), _jax_leaves(out[1]), ov


@functools.lru_cache(maxsize=None)
def _port_run(model, U, D, knobbed, exchange="alltoall"):
    """The port's composed (D >= 1) or unsharded (D == 0) sweep from the
    reference's keys, knob arrays and stacked state."""
    ju, tu = _universes(model, U, knobbed)
    keys, values, state = universe_from_numpy(
        np.asarray(ju.keys()), ju.knobs,
        [np.asarray(v) for v in ju.knob_arrays()],
        jax.tree_util.tree_map(np.asarray, JU.stacked_init(ju)))
    mesh = mesh_for(D, "cpu") if D else None
    sweep = make_sweep(model, U, False, mesh, exchange if D else "alltoall")
    out = sweep(state, keys, values, tu.cfg, tu.steps, tu.knobs, tu.track)
    ov = out[2].numpy() if D else None
    return _leaves(out[0]), _leaves(out[1]), ov


def _assert_leaves(want: list, got: list, what: str) -> None:
    assert len(want) == len(got), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype, f"{what} leaf {i}: {w.dtype} != {g.dtype}"
        np.testing.assert_array_equal(w, g, err_msg=f"{what} leaf {i}")


def _assert_runs(want, got, what):
    _assert_leaves(want[1], got[1], f"{what}: per-tick outputs")
    _assert_leaves(want[0], got[0], f"{what}: final state")
    if want[2] is not None:
        assert want[2].dtype == got[2].dtype, what
        np.testing.assert_array_equal(want[2], got[2], err_msg=what)


@pytest.mark.parametrize("model", sorted(FAMS))
def test_u1_d1_composed_equals_unsharded_plain_and_reference(model):
    """The acceptance pin: U = 1 x D = 1 composed == the unsharded sweep ==
    the plain scan == the reference's composed program, every leaf."""
    composed = _port_run(model, 1, 1, False)
    _assert_runs(_ref_run(model, 1, 1, False), composed, "vs reference")
    assert composed[2].shape == (1,) and int(composed[2][0]) == 0
    unsharded = _port_run(model, 1, 0, False)
    _assert_leaves(unsharded[1], composed[1], "composed vs unsharded outs")
    _assert_leaves(unsharded[0], composed[0], "composed vs unsharded final")
    _, tu = _universes(model, 1, False)
    init = stacked_init(tu, "cpu")
    args = (type(init)(*(x[0] for x in init)), PRNGKey(5), tu.cfg, tu.steps)
    if tu.track:
        args += (tu.track,)
    p_final, p_outs = PLAIN_SCAN[model](*args)
    _assert_leaves([x[0] for x in unsharded[1]], _leaves(p_outs),
                   "U=1 sweep vs plain scan outs")
    _assert_leaves([x[0] for x in unsharded[0]], _leaves(p_final),
                   "U=1 sweep vs plain scan final")


@pytest.mark.parametrize("model", sorted(FAMS))
def test_u2_d2_knobs_match_reference(model):
    """Both axes at once, with the knob varying over the universes: the
    port's composed program equals the reference's ``make_sweep(...,
    mesh_for(2))`` on every output, state leaf and overflow."""
    got = _port_run(model, 2, 2, True)
    _assert_runs(_ref_run(model, 2, 2, True), got, model)
    outs = got[1]
    assert any(not np.array_equal(o[0], o[1]) for o in outs), \
        "both universes ran the same study"


@pytest.mark.parametrize("case", sorted(AGG_FAMS))
def test_u2_d2_aggregate_knobs_match_reference(case):
    """The twins' aggregate delivery under the universe axis, fanout and a
    rate knob varying: equal to the reference's composed program."""
    jcfg, tcfg, steps, track, knobs, values = AGG_FAMS[case]
    model = case.split("-")[0]
    kw = dict(entrypoint=model, steps=steps, seeds=(5, 7), knobs=knobs,
              values=values, track=track)
    ju, tu = JU.Universe(cfg=jcfg, **kw), Universe(cfg=tcfg, **kw)
    out = JU.make_sweep(model, 2, False, j_mesh_for(2), "alltoall")(
        JU.stacked_init(ju), ju.keys(), ju.knob_arrays(), jcfg, steps,
        knobs, track)
    want = (_jax_leaves(out[0]), _jax_leaves(out[1]), np.asarray(out[2]))
    keys, vals, state = universe_from_numpy(
        np.asarray(ju.keys()), knobs,
        [np.asarray(v) for v in ju.knob_arrays()],
        jax.tree_util.tree_map(np.asarray, JU.stacked_init(ju)))
    for exchange in ("alltoall", "ring"):
        got = make_sweep(model, 2, False, mesh_for(2, "cpu"), exchange)(
            state, keys, vals, tcfg, steps, knobs, track)
        _assert_runs(want, (_leaves(got[0]), _leaves(got[1]),
                            got[2].numpy()), f"{case} {exchange}")


@pytest.mark.parametrize("case", ["sparse", "geo", "broadcast-aggregate",
                                  "streamcast-aggregate"])
def test_u3_d4_matches_reference(case):
    """U = 3 universes over D = 4 shards (U != D, so a universe axis
    broadcast against the shard axis cannot pass unnoticed), knobs
    varying, against the reference's composed program."""
    if case in FAMS:
        jcfg, tcfg, steps, track, knob, vals = FAMS[case]
        knobs, values = (knob,), (vals + (vals[0] / 2,),)
    else:
        jcfg, tcfg, steps, track, knobs, values = AGG_FAMS[case]
        values = tuple(v + (v[0],) for v in values)
    model = case.split("-")[0]
    kw = dict(entrypoint=model, steps=steps, seeds=(5, 7, 9), knobs=knobs,
              values=values, track=track)
    ju, tu = JU.Universe(cfg=jcfg, **kw), Universe(cfg=tcfg, **kw)
    out = JU.make_sweep(model, 3, False, j_mesh_for(4), "alltoall")(
        JU.stacked_init(ju), ju.keys(), ju.knob_arrays(), jcfg, steps,
        knobs, track)
    keys, vals, state = universe_from_numpy(
        np.asarray(ju.keys()), knobs,
        [np.asarray(v) for v in ju.knob_arrays()],
        jax.tree_util.tree_map(np.asarray, JU.stacked_init(ju)))
    got = make_sweep(model, 3, False, mesh_for(4, "cpu"), "ring")(
        state, keys, vals, tcfg, steps, knobs, track)
    _assert_runs((_jax_leaves(out[0]), _jax_leaves(out[1]),
                  np.asarray(out[2])),
                 (_leaves(got[0]), _leaves(got[1]), got[2].numpy()), case)


@pytest.mark.parametrize("model", sorted(FAMS))
def test_ring_equals_alltoall_and_d2_equals_d1(model):
    """The exchange backend is a pure transport knob under the universe
    axis, and sharding the inner study only moves it: D = 2 equals D = 1
    with overflow 0."""
    alltoall = _port_run(model, 2, 2, True)
    _assert_runs(alltoall, _port_run(model, 2, 2, True, "ring"), "ring")
    d1 = _port_run(model, 2, 1, True)
    assert int(alltoall[2].sum()) == 0
    _assert_leaves(d1[1], alltoall[1], f"{model}: outs D2 vs D1")
    _assert_leaves(d1[0], alltoall[0], f"{model}: final D2 vs D1")


def test_one_callable_per_axis_point():
    m1, m2 = mesh_for(1, "cpu"), mesh_for(2, "cpu")
    base = make_sweep("broadcast", 2)
    assert make_sweep("broadcast", 2, False, m2) is make_sweep(
        "broadcast", 2, False, mesh_for(2, "cpu"))
    assert make_sweep("broadcast", 2, False, m1) is not base
    assert make_sweep("broadcast", 2, False, m2) is not make_sweep(
        "broadcast", 2, False, m1)
    assert make_sweep("broadcast", 2, False, m2, "ring") is not make_sweep(
        "broadcast", 2, False, m2, "alltoall")
    assert make_sweep("broadcast", 3, False, m2) is not make_sweep(
        "broadcast", 2, False, m2)
    assert make_sweep("sparse", 2, False, m2).__name__ == "sweep_sparse_U2_D2"


@pytest.mark.parametrize("entrypoint, meshed, exchange, pattern", [
    ("swim", True, "alltoall", "no sharded twin"),
    ("lifeguard", True, "alltoall", "no sharded twin"),
    ("broadcast", False, "ring", "requires mesh="),
    ("broadcast", True, "carrier", "unknown exchange"),
])
def test_composition_rejections_match_reference(entrypoint, meshed, exchange,
                                                pattern):
    """The reference's loud rejections, with its messages."""
    messages = []
    for make, mesh in ((JU.make_sweep, j_mesh_for(1)),
                       (make_sweep, mesh_for(1, "cpu"))):
        with pytest.raises(ValueError, match=pattern) as err:
            make(entrypoint, 2, False, mesh if meshed else None, exchange)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# Metadata ops: views of an existing buffer, which launch no kernel (the
# list of tests/test_torch_sweep.py).
VIEW_OPS = frozenset(f"aten::{op}" for op in (
    "view", "_reshape_alias", "reshape", "as_strided", "slice", "narrow",
    "select", "expand", "unsqueeze", "squeeze", "alias", "detach", "unbind",
    "t", "transpose", "permute", "split", "unflatten", "flatten",
    "view_as", "expand_as", "_unsafe_view"))


def _aten_ops_one_composed_tick(model, U):
    _, tcfg, _, track, _, _ = FAMS[model]
    uni = Universe(entrypoint=model, cfg=tcfg, steps=1,
                   seeds=tuple(range(U)), track=track)
    sweep = make_sweep(model, U, False, mesh_for(2, "cpu"), "ring")
    keys = uni.keys("cpu")
    sweep(stacked_init(uni, "cpu"), keys, (), tcfg, 1, (), track)
    state = stacked_init(uni, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sweep(state, keys, (), tcfg, 1, (), track)
    def outermost(e):
        p = e.cpu_parent
        return p is None or not p.name.startswith("aten::")

    return sum(1 for e in prof.events()
               if e.name.startswith("aten::") and e.name not in VIEW_OPS
               and outermost(e))


@pytest.mark.parametrize("model", sorted(FAMS))
def test_composed_tick_op_count_does_not_grow_with_u(model):
    """The universe axis is a tensor dimension of the composed tick too:
    one tick at U = 8 x D = 2 makes exactly as many ATen calls (views
    aside) as at U = 1, so the ring exchange stays one call a tick.  The
    calls are counted at the outermost level: how an op dispatches inside
    (``zero_`` fills a large tensor and memsets a small one) depends on
    the sizes, not on the program."""
    ops1 = _aten_ops_one_composed_tick(model, 1)
    ops8 = _aten_ops_one_composed_tick(model, 8)
    assert ops1 > 0 and ops8 == ops1, (ops1, ops8)


def test_composed_universe_equals_the_sharded_twin_under_overflow():
    """Universe 0 of a composed sparse ladder whose outboxes overflow
    equals the plain sharded twin at the same seed and loss, every tick
    and in the final state: the witness ``chip_smoke.py`` phase 11 holds
    the full-width ladder to, where no universe meets the unsharded
    sweep's overflow of 0."""
    from consul_tpu_torch.models import sparse_membership_init
    from consul_tpu_torch.parallel import sharded_sparse_membership_scan

    base = MembershipConfig(n=1024, loss=0.2, fail_at=((5, 3), (100, 5)),
                            leave_at=((77, 10),))
    cfg = SparseMembershipConfig(base=base, k_slots=8)
    mesh, steps, track = mesh_for(4, "cpu"), 20, (5,)
    final, outs = sharded_sparse_membership_scan(
        sparse_membership_init(cfg, device="cpu"), PRNGKey(0, device="cpu"),
        cfg, steps, mesh, track, "ring")
    uni = Universe(entrypoint="sparse", cfg=cfg, steps=steps, seeds=(0,) * 3,
                   track=track, knobs=("base.loss",),
                   values=((0.2, 0.3, 0.1),))
    got_final, got_outs, overflow = make_sweep("sparse", 3, False, mesh,
                                               "ring")(
        stacked_init(uni, "cpu"), uni.keys("cpu"), uni.knob_arrays("cpu"),
        cfg, steps, uni.knobs, track)
    assert int(final.overflow) > 0
    assert int(overflow[0]) == int(final.overflow)
    for i, (want, got) in enumerate(zip(outs[:4], got_outs)):
        assert want.dtype == got.dtype and torch.equal(want, got[0]), i
    for name, want, got in zip(final._fields, final, got_final):
        assert want.dtype == got.dtype and torch.equal(want, got[0]), name


def test_composed_run_sweep_reports_overflow_and_matches_reference():
    """``run_sweep(mesh=)`` returns the reference's metrics with the
    overflow column and the shard count in its summary."""
    from consul_tpu.sim.engine import run_sweep as j_run_sweep

    ju, tu = _universes("sparse", 2, True)
    want = j_run_sweep(ju, warmup=False, mesh=j_mesh_for(2))
    got = run_sweep(tu, warmup=False, mesh=mesh_for(2, "cpu"),
                    exchange="ring")
    assert sorted(want.metrics) == sorted(got.metrics)
    for name in want.metrics:
        np.testing.assert_array_equal(np.asarray(want.metrics[name]),
                                      np.asarray(got.metrics[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(want.outbox_overflow),
                                  got.outbox_overflow)
    s = got.summary()
    assert s["devices"] == 2 and s["overflow_total"] == 0
    assert want.summary()["overflow_total"] == s["overflow_total"]
    assert got.device == "cpu"
    plain = run_sweep(tu, warmup=False, device="cpu")
    assert plain.outbox_overflow is None and "overflow_total" not in (
        plain.summary())


def test_optimize_sweep_composed_matches_reference():
    """Every generation of a composed search runs on the mesh, and the
    answer carries the summed overflow, as the reference's does."""
    from consul_tpu.sweep.optimize import optimize_sweep as j_optimize

    grid = ((0.0, 0.2, 0.4, 0.6),)
    kw = dict(entrypoint="broadcast", steps=6, seeds=(0,) * 4,
              knobs=("loss",), values=grid)
    ju = JU.Universe(cfg=FAMS["broadcast"][0], **kw)
    tu = Universe(cfg=FAMS["broadcast"][1], **kw)
    want = j_optimize(ju, "t99_ms", minimize=True, mesh=j_mesh_for(2),
                      max_generations=2)
    got = optimize.optimize_sweep(tu, "t99_ms", minimize=True,
                                  mesh=mesh_for(2, "cpu"), device="cpu",
                                  max_generations=2)
    assert got.overflow_total == 0
    assert want.summary() == got.summary()
    assert want.history == got.history


def test_compose_real_run_on_the_cpu():
    """``sweep.compose``'s real run: a composed sparse sweep over the
    shards, equal to the reference's composed run's overflow and
    detection column, with the table not measured off the card."""
    from consul_tpu.sweep.compose import _compose_real_run
    from consul_tpu_torch.sweep import compose

    want = _compose_real_run(2, 64, 8, 2, 4, 0)
    got = compose.compose_real_run(2, 64, 8, 2, 4, 0, "cpu")
    for k in ("universes", "devices", "steps", "overflow_per_universe",
              "overflow_total", "dead_known_final"):
        assert want[k] == got[k], k
    assert got["rounds_per_sec"] > 0


def test_composed_ring_launches_nothing_on_the_cpu():
    """On CPU tensors the ring wrapper takes the plain version."""
    before = ring_exchange.launches
    _port_run.__wrapped__("broadcast", 2, 2, True, "ring")
    _port_run.__wrapped__("geo", 2, 2, True, "ring")
    assert ring_exchange.launches == before
