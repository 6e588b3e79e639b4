"""The telemetry seam of the sweep plane: ``make_sweep(..., telemetry=True)``
of ``consul_tpu_torch.sweep`` against the JAX package's on the CPU.

Both packages run the same universes (keys, knob values and stacked state
carried over by ``convert``), at the reference's small configs of
``tests/test_obs.py`` with a knob varying:

* U = 1 equals the plain scan's trace, for all seven entrypoints;
* U = 2 equals the reference's ``make_sweep(ep, 2, True)``: the
  ``[U, steps, M]`` trace bit for bit, every other output as with
  telemetry off (the broadcast case sweeps the aggregate ``fanout``, whose
  ``[U]`` int32 knob multiplies the ``memberlist.gossip`` count);
* the composed plane at U = 2 x D = 2, both transports, equals the
  reference's composed program and the unsharded sweep;
* one batched telemetry tick makes as many ATen ops at U = 8 as at U = 1;
* ``run_sweep`` and ``optimize_sweep`` carry the trace, and its bridge
  labels each universe.
"""

import functools

import jax
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
from consul_tpu.parallel.mesh import mesh_for as j_mesh_for
from consul_tpu.streamcast import StreamcastConfig as JStream
from consul_tpu_torch import obs, telemetry
from consul_tpu_torch.convert import universe_from_numpy
from consul_tpu_torch.geo import GeoConfig
from consul_tpu_torch.models import (
    BroadcastConfig,
    LifeguardConfig,
    MembershipConfig,
    SparseMembershipConfig,
    SwimConfig,
)
from consul_tpu_torch.ops import PRNGKey
from consul_tpu_torch.parallel import mesh_for
from consul_tpu_torch.sim import engine, run_sweep
from consul_tpu_torch.streamcast import StreamcastConfig
from consul_tpu_torch.sweep import Universe, make_sweep, stacked_init
from consul_tpu_torch.sweep import optimize
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 8
MEMB_KW = dict(n=48, loss=0.05, fail_at=((3, 2),))
STREAM_KW = dict(n=64, events=12, chunks=2, window=4, fanout=3,
                 chunk_budget=2, rate=0.4, names=3, loss=0.05,
                 delivery="edges")
GEO_KW = dict(n=64, segments=8, bridges_per_segment=2, events=4,
              wan_window=4, wan_msg_bytes=100, wan_capacity_bytes=800.0,
              wan_queue_bytes=1600.0, ae_batch=4, loss_wan=0.05)
BCAST_KW = dict(n=64, fanout=3, loss=0.05, delivery="aggregate")
# entrypoint -> (reference config, port config, track, knob, two values)
FAMS = {
    "swim": (JSwim(n=64, subject=1, loss=0.05),
             SwimConfig(n=64, subject=1, loss=0.05), (), "loss",
             (0.05, 0.3)),
    "lifeguard": (JLifeguard(n=64, subject=1, subject_alive=True),
                  LifeguardConfig(n=64, subject=1, subject_alive=True), (),
                  "ack_late", (0.0, 0.3)),
    "broadcast": (JBroadcast(**BCAST_KW), BroadcastConfig(**BCAST_KW), (),
                  "fanout", (2, 4)),
    "membership": (JMembership(**MEMB_KW), MembershipConfig(**MEMB_KW),
                   (3,), "loss", (0.05, 0.3)),
    "sparse": (JSparse(base=JMembership(**MEMB_KW), k_slots=8),
               SparseMembershipConfig(base=MembershipConfig(**MEMB_KW),
                                      k_slots=8), (3,), "base.loss",
               (0.05, 0.3)),
    "streamcast": (JStream(**STREAM_KW), StreamcastConfig(**STREAM_KW), (),
                   "rate", (0.4, 0.9)),
    "geo": (JGeo(**GEO_KW), GeoConfig(**GEO_KW), (), "loss_lan",
            (0.0, 0.3)),
}
SHARDED = ("broadcast", "membership", "sparse", "streamcast", "geo")
PLAIN_SCAN = {
    "swim": engine.swim_scan, "lifeguard": engine.lifeguard_scan,
    "broadcast": engine.broadcast_scan, "membership": engine.membership_scan,
    "sparse": engine.sparse_membership_scan,
    "streamcast": engine.streamcast_scan, "geo": engine.geo_scan,
}


def _universes(model, U):
    jcfg, tcfg, track, knob, vals = FAMS[model]
    kw = dict(entrypoint=model, steps=STEPS, seeds=tuple(5 + 2 * u
                                                         for u in range(U)),
              knobs=(knob,), values=(vals[:U],), track=track)
    return JU.Universe(cfg=jcfg, **kw), Universe(cfg=tcfg, **kw)


def _np(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(t) for t in x]


@functools.lru_cache(maxsize=None)
def ref_sweep(model, U, D=0):
    """The reference's telemetry=True sweep (composed over D virtual CPU
    devices when D > 0): ``(outputs, trace)`` as numpy arrays."""
    ju, _ = _universes(model, U)
    sweep = JU.make_sweep(model, U, True, j_mesh_for(D) if D else None,
                          "alltoall")
    out = sweep(JU.stacked_init(ju), ju.keys(), ju.knob_arrays(), ju.cfg,
                ju.steps, ju.knobs, ju.track)
    outs = [np.asarray(x) for x in jax.tree_util.tree_leaves(out[1])]
    return outs[:-1], outs[-1]


@functools.lru_cache(maxsize=None)
def port_sweep(model, U, D=0, exchange="alltoall", telemetry=True):
    """The port's sweep from the reference's keys, knob arrays and state:
    ``(outputs, trace or None)``."""
    ju, tu = _universes(model, U)
    keys, values, state = universe_from_numpy(
        np.asarray(ju.keys()), ju.knobs,
        [np.asarray(v) for v in ju.knob_arrays()],
        jax.tree_util.tree_map(np.asarray, JU.stacked_init(ju)))
    mesh = mesh_for(D, "cpu") if D else None
    out = make_sweep(model, U, telemetry, mesh, exchange)(
        state, keys, values, tu.cfg, tu.steps, tu.knobs, tu.track)
    outs = _np(out[1])
    return (outs[:-1], outs[-1]) if telemetry else (outs, None)


def _assert_equal(want: list, got: list, what: str) -> None:
    assert len(want) == len(got), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype, f"{what} {i}: {w.dtype} != {g.dtype}"
        np.testing.assert_array_equal(w, g, err_msg=f"{what} {i}")


def _assert_trace(want, got, what):
    assert got.dtype == np.float32 and got.shape == want.shape, what
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32),
                                  err_msg=what)


@pytest.mark.parametrize("model", list(FAMS))
def test_u1_equals_plain_trace(model):
    """U = 1 at seed 5: the sweep's [1, steps, M] trace is the plain
    scan's [steps, M] trace."""
    _, tcfg, track, _, _ = FAMS[model]
    tu = Universe(entrypoint=model, cfg=tcfg, steps=STEPS, seeds=(5,),
                  track=track)
    init = stacked_init(tu, "cpu")
    _, outs = make_sweep(model, 1, True)(init, tu.keys("cpu"), (), tcfg,
                                         STEPS, (), track)
    args = (type(init)(*(x[0] for x in init)), PRNGKey(5), tcfg, STEPS)
    if track:
        args += (track,)
    _, plain = PLAIN_SCAN[model](*args, telemetry=True)
    assert outs[-1].shape == (1, STEPS, obs.metric_count(model))
    _assert_trace(plain[-1].numpy(), outs[-1][0].numpy(), model)


@pytest.mark.parametrize("model", list(FAMS))
def test_u2_knob_matches_reference(model):
    """The knob varying over two universes: the trace bit for bit against
    the reference's, every other output as the reference's and as the
    port's telemetry-off sweep."""
    want_outs, want_trace = ref_sweep(model, 2)
    got_outs, got_trace = port_sweep(model, 2)
    _assert_trace(want_trace, got_trace, model)
    _assert_equal(want_outs, got_outs, f"{model} outputs")
    _assert_equal(port_sweep(model, 2, telemetry=False)[0], got_outs,
                  f"{model} on != off")
    assert not np.array_equal(got_trace[0], got_trace[1]), \
        "both universes ran the same study"


@pytest.mark.parametrize("model", SHARDED)
def test_composed_u2_d2_matches_reference(model):
    """U = 2 x D = 2: the per-shard counts summed over the shard axis give
    the reference's composed trace and the unsharded sweep's, over both
    transports."""
    want_outs, want_trace = ref_sweep(model, 2, 2)
    _assert_trace(want_trace, port_sweep(model, 2)[1], f"{model} unsharded")
    for exchange in ("alltoall", "ring"):
        got_outs, got_trace = port_sweep(model, 2, 2, exchange)
        _assert_trace(want_trace, got_trace, f"{model} {exchange}")
        _assert_equal(want_outs, got_outs, f"{model} {exchange} outputs")


# Metadata ops: views of an existing buffer, which launch no kernel (the
# list of tests/test_torch_sweep.py).
VIEW_OPS = frozenset(f"aten::{op}" for op in (
    "view", "_reshape_alias", "reshape", "as_strided", "slice", "narrow",
    "select", "expand", "unsqueeze", "squeeze", "alias", "detach", "unbind",
    "t", "transpose", "permute", "split", "unflatten", "flatten",
    "view_as", "expand_as", "_unsafe_view", "movedim"))


def _aten_ops_one_tick(model, U, mesh=None):
    _, tcfg, track, _, _ = FAMS[model]
    uni = Universe(entrypoint=model, cfg=tcfg, steps=1,
                   seeds=tuple(range(U)), track=track)
    sweep = make_sweep(model, U, True, mesh)
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


@pytest.mark.parametrize("model", list(FAMS))
def test_telemetry_tick_op_count_does_not_grow_with_u(model):
    """The emitters batch over the universe axis: one telemetry tick at
    U = 8 makes as many ATen calls (views aside) as at U = 1, plain and
    composed (D = 2) alike."""
    ops1 = _aten_ops_one_tick(model, 1)
    assert ops1 > 0 and _aten_ops_one_tick(model, 8) == ops1
    if model in SHARDED:
        mesh = mesh_for(2, "cpu")
        ops1 = _aten_ops_one_tick(model, 1, mesh)
        assert _aten_ops_one_tick(model, 8, mesh) == ops1


def test_run_sweep_carries_the_trace_and_bridges_per_universe():
    """``run_sweep(telemetry=True)`` reports the trace (composed too) with
    the same summary as off; its bridge labels each universe's series."""
    _, tu = _universes("broadcast", 2)
    on = run_sweep(tu, warmup=False, telemetry=True, device="cpu")
    off = run_sweep(tu, warmup=False, device="cpu")
    assert off.metrics_trace is None and off.metric_names == ()
    assert on.metric_names == obs.metric_names("broadcast")
    _assert_trace(port_sweep("broadcast", 2)[1], on.metrics_trace, "run")
    for name, v in off.metrics.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(on.metrics[name]))
    composed = run_sweep(tu, warmup=False, telemetry=True,
                         mesh=mesh_for(2, "cpu"), exchange="ring",
                         device="cpu")
    _assert_trace(on.metrics_trace, composed.metrics_trace, "composed")
    assert composed.devices == 2
    sink = obs.bridge_report("broadcast", composed, telemetry.Metrics())
    for u in (0, 1):
        labels = {"universe": str(u)}
        assert sink.get_counter("memberlist.gossip", labels) == STEPS
        assert sink.get_gauge("consul.broadcast.infected", labels) == float(
            composed.metrics_trace[u, -1, 2])


def test_optimize_sweep_passes_telemetry(monkeypatch):
    """``optimize_sweep(telemetry=True)`` runs every generation with the
    trace on, as the reference's does."""
    seen = []
    real = engine.run_sweep

    def spy(universe, **kw):
        seen.append(kw.get("telemetry"))
        return real(universe, **kw)

    monkeypatch.setattr(engine, "run_sweep", spy)
    cfg = BroadcastConfig(**BCAST_KW)
    uni = Universe(entrypoint="broadcast", cfg=cfg, steps=STEPS,
                   seeds=(0,) * 4, knobs=("loss",),
                   values=((0.0, 0.1, 0.2, 0.3),))
    res = optimize.optimize_sweep(uni, "t99_ms", minimize=True,
                                  max_generations=1, device="cpu",
                                  telemetry=True)
    assert seen and all(seen) and res.evaluations > 0
