"""The in-scan telemetry plane: ``consul_tpu_torch.obs`` and the
``telemetry=`` seam of every ``run_*`` against the JAX package on the CPU.

The seven scan families at the reference's own small configs
(``tests/test_obs.py``, 8 ticks, seed 0):

* the port's ``metrics_trace`` equals the reference's
  ``run_*(telemetry=True).metrics_trace``: the same names in the same
  order, float32, bit for bit (no receiver of these aggregate studies
  lies between the two packages' arrival thresholds, the rule of
  ``torch_parity.check_arrivals``, so the traces are equal);
* every existing output is the same with telemetry on and off, and off
  runs no emitter;
* the sharded twins at D = 1 and D = 2, both transports, equal the
  reference's sharded trace at D = 2 (which its own tests hold equal to
  its unsharded trace), and the port's D = 1 equals its unsharded run;
* the registry, the ``Metrics`` copy and the bridge's snapshots equal the
  reference's, labels and stddev included; int32 counts round to float32
  as the reference's do; telemetry adds no host sync.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.geo.model import GeoConfig as JGeo
from consul_tpu.models.broadcast import BroadcastConfig as JBroadcast
from consul_tpu.models.lifeguard import LifeguardConfig as JLifeguard
from consul_tpu.models.membership import MembershipConfig as JMembership
from consul_tpu.models.membership_sparse import (
    SparseMembershipConfig as JSparse,
)
from consul_tpu.models.swim import SwimConfig as JSwim
from consul_tpu import obs as j_obs
from consul_tpu.parallel import make_mesh as j_make_mesh
from consul_tpu.sim import engine as j_engine
from consul_tpu.streamcast.model import StreamcastConfig as JStream
from consul_tpu import telemetry as j_telemetry
from consul_tpu_torch import obs, telemetry
from consul_tpu_torch.geo import GeoConfig
from consul_tpu_torch.models import (
    BroadcastConfig,
    LifeguardConfig,
    MembershipConfig,
    SparseMembershipConfig,
    SwimConfig,
)
from consul_tpu_torch.obs import spec
from consul_tpu_torch.parallel import mesh_for
from consul_tpu_torch.sim import engine
from consul_tpu_torch.streamcast import StreamcastConfig
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
# family -> (reference config, port config, run_* name, track): the
# reference's tests/test_obs.py configs.
FAMS = {
    "swim": (JSwim(n=64, subject=1, loss=0.05),
             SwimConfig(n=64, subject=1, loss=0.05), "run_swim", None),
    "lifeguard": (JLifeguard(n=64, subject=1, subject_alive=True),
                  LifeguardConfig(n=64, subject=1, subject_alive=True),
                  "run_lifeguard", None),
    "broadcast": (JBroadcast(n=64, fanout=3, delivery="edges"),
                  BroadcastConfig(n=64, fanout=3, delivery="edges"),
                  "run_broadcast", None),
    "membership": (JMembership(**MEMB_KW), MembershipConfig(**MEMB_KW),
                   "run_membership", (3,)),
    "sparse": (JSparse(base=JMembership(**MEMB_KW), k_slots=8),
               SparseMembershipConfig(base=MembershipConfig(**MEMB_KW),
                                      k_slots=8),
               "run_membership_sparse", (3,)),
    "streamcast": (JStream(**STREAM_KW), StreamcastConfig(**STREAM_KW),
                   "run_streamcast", None),
    "geo": (JGeo(**GEO_KW), GeoConfig(**GEO_KW), "run_geo", None),
}
SHARDED = ("broadcast", "membership", "sparse", "streamcast", "geo")


def _report(out):
    """The report of a ``run_*`` result (sparse returns (report, overflow))."""
    return out[0] if isinstance(out, tuple) else out


def _kw(family, telemetry):
    track = FAMS[family][3]
    kw = dict(seed=0, warmup=False, telemetry=telemetry)
    return kw if track is None else dict(kw, track=track)


@functools.lru_cache(maxsize=None)
def ref_study(family, devices=0):
    """The reference's telemetry=True study (sharded over ``devices`` of
    the virtual CPU mesh when given), one compile per program."""
    jcfg, _, run, _ = FAMS[family]
    kw = _kw(family, True)
    if devices:
        kw["mesh"] = j_make_mesh(jax.devices()[:devices])
    return _report(getattr(j_engine, run)(jcfg, STEPS, **kw))


@functools.lru_cache(maxsize=None)
def port_study(family, telemetry=True, devices=0, exchange="alltoall"):
    """The port's study on the CPU: ``(report, overflow or None)``."""
    _, tcfg, run, _ = FAMS[family]
    kw = dict(_kw(family, telemetry), device="cpu")
    if devices:
        kw.update(mesh=mesh_for(devices, "cpu"), exchange=exchange)
    out = getattr(engine, run)(tcfg, STEPS, **kw)
    return (out if isinstance(out, tuple) else (out, None))


def _existing_outputs(report) -> dict:
    """The report's outputs that exist without telemetry (the reference's
    ``tests/test_obs.py`` selection)."""
    return {k: v for k, v in vars(report).items()
            if isinstance(v, np.ndarray)
            and k not in ("metrics_trace", "metric_names", "wall_s")}


def _assert_trace(want, got, what):
    assert got.dtype == np.float32 and want.dtype == np.float32, what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# The registry, the Metrics copy and the float32 cast.
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    """Names, order, kinds and shard reductions of all seven families;
    an unknown family is rejected with the reference's message."""
    assert set(obs.METRIC_SPECS) == set(j_obs.METRIC_SPECS) == set(FAMS)
    for family in FAMS:
        assert obs.metric_names(family) == j_obs.metric_names(family)
        assert obs.metric_count(family) == j_obs.metric_count(family)
        assert obs.sum_mask(family) == j_obs.sum_mask(family)
        assert ([(s.kind, s.reduce) for s in obs.METRIC_SPECS[family]]
                == [(s.kind, s.reduce) for s in j_obs.METRIC_SPECS[family]])
    with pytest.raises(ValueError, match="no metric specs"):
        obs.metric_names("multidc")
    with pytest.raises(ValueError, match="bad kind"):
        obs.MetricSpec("x", "timer", "sum", None)


def _drive(m):
    m.incr_counter("a.b", 2.0)
    m.incr_counter("a.b", 5.0)
    m.incr_counter("a.b", 1.0, labels={"universe": "1"})
    m.set_gauge("g", 3.5)
    m.set_gauge("g", 4.5, labels={"universe": "0", "dc": "x"})
    for v in (1.0, 2.0, 4.0, 8.0):
        m.add_sample("s", v)
    m.add_sample("one", 3.0)
    return m


def test_metrics_copy_matches_reference():
    """The copied sink gives the reference's snapshot (the wall-clock
    ``Timestamp`` aside), getters and reset."""
    want, got = _drive(j_telemetry.Metrics()), _drive(telemetry.Metrics())
    a, b = want.snapshot(), got.snapshot()
    assert set(b) == {"Timestamp", "Gauges", "Counters", "Samples"}
    a.pop("Timestamp")
    b.pop("Timestamp")
    assert a == b
    assert got.get_counter("a.b") == want.get_counter("a.b") == 2
    assert got.get_gauge("g", {"dc": "x", "universe": "0"}) == 4.5
    sample = {s["Name"]: s for s in b["Samples"]}
    assert sample["s"]["Stddev"] == pytest.approx(
        float(np.std([1.0, 2.0, 4.0, 8.0], ddof=1)), abs=1e-6)
    assert sample["one"]["Stddev"] == 0.0
    got.reset()
    assert got.snapshot()["Counters"] == []
    old, m = telemetry.metrics(), telemetry.Metrics()
    try:
        assert telemetry.set_global(m) is m and telemetry.metrics() is m
    finally:
        telemetry.set_global(old)


def test_int32_counts_round_to_float32_as_the_reference():
    """Counts above 2**24 round to nearest even in the float32 trace, and
    int32 sums wrap, as the reference's do."""
    vals = np.array([2 ** 24 + 1, 2 ** 24 + 3, 2 ** 25 + 2, 268_435_455,
                     2 ** 31 - 1, -(2 ** 31), 7], np.int32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.float32))
    got = torch.from_numpy(vals).to(torch.float32).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
    big = np.full(3, 2 ** 30 + 5, np.int32)
    want = np.asarray(jnp.sum(jnp.asarray(big), dtype=jnp.int32))
    got = torch.sum(torch.from_numpy(big), dtype=torch.int32).numpy()
    assert want == got


def test_reduce_over_shards():
    """"sum" columns sum over the shard axis, "rep" columns come from
    shard 0, per universe."""
    vec = torch.arange(2 * 3 * 5, dtype=torch.int32).view(2, 3, 5)
    keep = spec.shard_keep("sparse", 2, "cpu")   # sum, sum, sum, rep, rep
    got = obs.reduce_over_shards(vec, keep)
    want = vec[0].clone()
    want[:, :3] += vec[1, :, :3]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# The unsharded families against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMS))
def test_trace_matches_reference(family):
    """Bit for bit, with the reference's names and column order."""
    want = ref_study(family)
    got = port_study(family)[0]
    assert got.metric_names == want.metric_names
    _assert_trace(np.asarray(want.metrics_trace), got.metrics_trace, family)
    assert (got.metrics_trace == np.round(got.metrics_trace)).all()


@pytest.mark.parametrize("family", list(FAMS))
def test_outputs_equal_on_and_off(family):
    """Telemetry on leaves every existing output as it is off (dtype
    included); off carries no trace."""
    on, ov_on = port_study(family, True)
    off, ov_off = port_study(family, False)
    outs_on, outs_off = _existing_outputs(on), _existing_outputs(off)
    assert outs_off and set(outs_on) == set(outs_off)
    for k, v in outs_off.items():
        assert v.dtype == outs_on[k].dtype, (family, k)
        np.testing.assert_array_equal(v, outs_on[k], err_msg=f"{family} {k}")
    assert ov_on == ov_off
    assert off.metrics_trace is None and off.metric_names == ()


@pytest.mark.parametrize("family", list(FAMS))
def test_off_runs_no_emitter(family, monkeypatch):
    """With telemetry off no emitter runs and no trace is built (both
    raise here); on, the same patch stops the study."""
    def boom(*args, **kwargs):
        raise AssertionError("telemetry=False reached the emitters")

    monkeypatch.setattr(spec, "emit_local", boom)
    monkeypatch.setattr(spec.MetricsTrace, "__init__", boom)
    _, tcfg, run, _ = FAMS[family]
    getattr(engine, run)(tcfg, 2, **dict(_kw(family, False), device="cpu"))
    with pytest.raises(AssertionError, match="reached the emitters"):
        getattr(engine, run)(tcfg, 2, **dict(_kw(family, True),
                                             device="cpu"))


# ---------------------------------------------------------------------------
# The sharded twins.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", SHARDED)
def test_sharded_trace_matches_reference(family):
    """D = 1 (equal to the unsharded run) and D = 2 over both transports:
    the reference's D = 2 sharded trace, bit for bit, with every existing
    output equal across the transports and the overflow too."""
    want = np.asarray(ref_study(family, devices=2).metrics_trace)
    plain = port_study(family)[0]
    runs = {(d, ex): port_study(family, True, d, ex)
            for d in (1, 2) for ex in ("alltoall", "ring")}
    for (d, ex), (rep, _) in runs.items():
        _assert_trace(want, rep.metrics_trace, f"{family} D={d} {ex}")
        assert rep.metric_names == obs.metric_names(family)
    _assert_trace(plain.metrics_trace, runs[1, "alltoall"][0].metrics_trace,
                  f"{family} D=1 == unsharded")
    ring, alltoall = runs[2, "ring"], runs[2, "alltoall"]
    for k, v in _existing_outputs(alltoall[0]).items():
        np.testing.assert_array_equal(v, _existing_outputs(ring[0])[k],
                                      err_msg=f"{family} ring {k}")
    assert ring[1] == alltoall[1]
    off = port_study(family, False, 2, "ring")[0]
    for k, v in _existing_outputs(off).items():
        np.testing.assert_array_equal(v, _existing_outputs(ring[0])[k],
                                      err_msg=f"{family} on != off {k}")


# ---------------------------------------------------------------------------
# The bridge.
# ---------------------------------------------------------------------------


def _snap(sink) -> dict:
    out = sink.snapshot()
    out.pop("Timestamp")
    return out


@pytest.mark.parametrize("family", list(FAMS))
def test_bridge_matches_reference(family):
    """The port's trace bridged into a fresh ``Metrics`` gives the
    reference's snapshot of its own trace; a [U, steps, M] trace bridges
    per universe under ``{"universe": "u"}`` labels merged over the
    caller's."""
    trace = port_study(family)[0].metrics_trace
    want = j_obs.bridge_trace(family, np.asarray(ref_study(family)
                                                 .metrics_trace),
                              j_telemetry.Metrics())
    got = obs.bridge_trace(family, trace, telemetry.Metrics())
    assert _snap(got) == _snap(want)
    stacked = np.stack([trace, trace[::-1]])
    labels = {"dc": "dc1"}
    want = j_obs.bridge_trace(family, stacked, j_telemetry.Metrics(),
                              labels=labels)
    got = obs.bridge_trace(family, stacked, telemetry.Metrics(),
                           labels=labels)
    assert _snap(got) == _snap(want)
    assert {g["Labels"]["universe"] for g in _snap(got)["Gauges"]} == {
        "0", "1"}


def test_bridge_report_and_rejections():
    """``bridge_report`` reads a telemetry=True report and rejects the
    rest with the reference's messages."""
    rep = port_study("broadcast")[0]
    sink = obs.bridge_report("broadcast", rep, telemetry.Metrics())
    assert sink.get_counter("memberlist.gossip") == STEPS
    assert sink.get_gauge("consul.broadcast.infected") == float(
        rep.infected[-1])
    with pytest.raises(ValueError, match="telemetry=True"):
        obs.bridge_report("broadcast", port_study("broadcast", False)[0],
                          telemetry.Metrics())
    with pytest.raises(ValueError, match="expected a"):
        obs.bridge_trace("swim", np.zeros((4, 3), np.float32),
                         telemetry.Metrics())
    with pytest.raises(ValueError, match="no metric specs"):
        obs.bridge_trace("multidc", np.zeros((4, 3), np.float32),
                         telemetry.Metrics())


def test_telemetry_adds_no_host_sync():
    """The sparse tick (and its twin) and the geo tick read the host
    exactly as often with telemetry on as off."""
    from consul_tpu_torch.ops import host_cond

    def syncs(family, telemetry, devices=0):
        _, tcfg, run, _ = FAMS[family]
        kw = dict(_kw(family, telemetry), device="cpu")
        if devices:
            kw["mesh"] = mesh_for(devices, "cpu")
        before = host_cond.syncs
        getattr(engine, run)(tcfg, STEPS, **kw)
        return host_cond.syncs - before

    for family, devices in (("sparse", 0), ("sparse", 2), ("geo", 0),
                            ("geo", 2)):
        off = syncs(family, False, devices)
        assert off > 0 and syncs(family, True, devices) == off, family
