"""The six sweep presets, scaled down: ``consul_tpu_torch.sweep.presets``
against ``consul_tpu.sweep.presets`` on the CPU.

Each preset's port and reference factories build the same universes
(knobs varying across universes); both packages' batched programs run
them from the same keys and state, and every per-tick output and final
state leaf must be equal, dtype included:

* ``seeds4k``: ``split_from`` keys, every universe detecting;
* ``tuning``: a 2 x 2 fanout x suspicion-scale Lifeguard grid;
* ``faultmatrix``: the 27 severity rungs, 0.0 (a swept zero, which the
  port does not skip) included;
* ``streamload``: the rate ladder per policy, aggregate (paced, as
  bench.py runs it, and Poisson with the true division) and edges;
* ``streamadv``: the heavy-tail ladder per policy, and the ``powf``
  band of the traced exponent at its tails;
* ``wanbrownout``: the brownout ladder over the port's derived
  latencies, with the accounting identity in every universe.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import consul_tpu.sweep.presets as jp
from consul_tpu.sim.engine import run_sweep as j_run_sweep
from consul_tpu_torch.sim import run_sweep
from consul_tpu_torch.sim.load import heavy_tail_sizes
from consul_tpu_torch.sweep import make_preset, presets as tp, stream_points
from test_torch_sweep import assert_sweeps_equal
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _both(factory, **kw):
    return getattr(jp, factory)(**kw), getattr(tp, factory)(**kw)


def check_preset(j_uni, t_uni):
    """The port's Universe mirrors the reference's, and both sweeps agree
    on every output and state leaf; returns the port's outputs."""
    assert (j_uni.entrypoint, j_uni.steps, j_uni.knobs, j_uni.values,
            j_uni.seeds, j_uni.split_from, j_uni.universes) == (
        t_uni.entrypoint, t_uni.steps, t_uni.knobs, t_uni.values,
        t_uni.seeds, t_uni.split_from, t_uni.universes)
    seeding = (dict(seeds=j_uni.seeds) if j_uni.seeds else
               dict(split_from=j_uni.split_from, universes=j_uni.universes))
    return assert_sweeps_equal(j_uni.entrypoint, j_uni.cfg, t_uni.cfg,
                               j_uni.steps, j_uni.knobs, j_uni.values,
                               **seeding)


def test_seeds4k_split_keys_detect_everywhere():
    j_uni, t_uni = _both("seed_sweep", universes=6, n=128, steps=40)
    check_preset(j_uni, t_uni)
    want = j_run_sweep(j_uni, warmup=False)
    got = run_sweep(t_uni, warmup=False, device="cpu")
    first = got.metrics["first_suspect_ms"]
    np.testing.assert_array_equal(want.metrics["first_suspect_ms"], first)
    assert not np.isnan(first).any(), "a universe never detected"


def test_tuning_grid_2x2():
    j_uni, t_uni = _both("tuning_grid", n=128, fanouts=(2, 4),
                         scales=(0.15, 1.5), fail_at=30, steps=120)
    check_preset(j_uni, t_uni)


def test_faultmatrix_with_zero_rungs():
    """27 universes of one static fault shape whose three severities are
    swept over (0.0, 0.45, 0.9): the swept 0.0 takes the arithmetic path
    in both packages, and every rung changes the dynamics."""
    j_uni, t_uni = _both("fault_matrix", n=96, steps=40)
    outs = check_preset(j_uni, t_uni)
    assert 0.0 in t_uni.values[0]
    awareness = outs[4][:, -1]
    assert len(np.unique(awareness)) > 9


STREAM = dict(n=256, steps=40, window=7, chunks=4, fanout=4, chunk_budget=4,
              done_frac=0.99)


@pytest.mark.parametrize("policy", ["uniform", "pipeline", "rarest"])
@pytest.mark.parametrize("mode", ["aggregate-paced", "aggregate-poisson",
                                  "edges-poisson"])
def test_streamload_per_policy(policy, mode):
    delivery, arrivals = mode.split("-")
    j_uni, t_uni = _both("stream_load_curve", policy=policy,
                         arrivals=arrivals, **STREAM)
    if delivery == "edges":
        j_uni = dataclasses.replace(
            j_uni, cfg=dataclasses.replace(j_uni.cfg, delivery="edges"))
        t_uni = dataclasses.replace(
            t_uni, cfg=dataclasses.replace(t_uni.cfg, delivery="edges"))
    outs = check_preset(j_uni, t_uni)
    overflow = outs[6][:, -1]
    assert overflow[0] == 0 and overflow[-1] > 0, overflow
    if mode == "aggregate-paced":
        rep = run_sweep(t_uni, warmup=False, device="cpu")
        points, knee = stream_points(rep, t_uni.values[0])
        assert len(points) == 4 and knee in t_uni.values[0]


@pytest.mark.parametrize("policy", ["uniform", "pipeline", "rarest"])
def test_streamadv_per_policy(policy):
    j_uni, t_uni = _both("stream_adversarial_ladder", policy=policy, n=256,
                         steps=40)
    outs = check_preset(j_uni, t_uni)
    done_count = outs[2]
    assert any(not np.array_equal(done_count[0], d) for d in done_count[1:]), \
        "every tail rung ran the same stream"


@pytest.mark.parametrize("tail", [0.25, 0.5, 1.0, 2.0])
def test_traced_tail_pow_band_is_exact(tail):
    """Under a swept tail the reference takes ``u ** (f32(-1) / tail)``
    with a traced exponent from glibc's ``powf``, at 1.0 too.  Every
    float32 ``u`` within 2**16 ulps of each size step ``k**-tail`` (k =
    2, 3, 4 at E = 4) gives the reference's size through the port's
    traced path (the power in float64, rounded once); the band edges sit
    far from every integer."""
    e_max, half = 4, 1 << 16

    def j_sizes(u, t):
        p = u ** (jnp.float32(-1.0) / jnp.maximum(t, 1e-6))
        return jnp.clip(jnp.floor(p), 1.0, float(e_max)).astype(jnp.int32)

    tail_t = torch.tensor([tail], dtype=torch.float32)
    exponent = -1.0 / torch.clamp(tail_t, min=1e-6)
    for k in range(2, e_max + 1):
        mid = np.float32(k ** -float(np.float32(tail))).view(np.int32)
        u = np.arange(mid - half, mid + half, dtype=np.int32).view(np.float32)
        want = np.asarray(jax.jit(j_sizes)(u, jnp.float32(tail)))
        p = torch.pow(torch.from_numpy(u).double(), exponent.double()).float()
        got = torch.clamp(torch.floor(p), 1.0, float(e_max)).to(
            torch.int32).numpy()
        np.testing.assert_array_equal(want, got, err_msg=f"step {k}")
        assert set(np.unique(want)) == {k - 1, k}, "band misses the step"
        edge = p.numpy()[[0, -1]].astype(np.float64)
        assert np.all(np.abs(edge - k) > 16 * np.spacing(np.float32(k)))
    # The port's sweep path takes exactly this power.
    key = torch.tensor([[0, 3]], dtype=torch.int64)
    sizes = heavy_tail_sizes(key, 270, e_max, tail_t)
    assert sizes.shape == (1, 270) and sizes.dtype == torch.int32


def test_wanbrownout_ladder_accounting():
    """The brownout ladder over the port's Vivaldi-derived latencies
    (equal to the reference's), every universe's outputs equal, and the
    accounting identity in every universe."""
    j_uni = jp.wan_brownout(n=256, steps=60)
    t_uni = tp.wan_brownout(n=256, steps=60, device="cpu")
    assert j_uni.cfg.wan_latency_ticks == t_uni.cfg.wan_latency_ticks
    check_preset(j_uni, t_uni)
    rep = run_sweep(t_uni, warmup=False, device="cpu")
    assert rep.accounting_ok().all()
    admitted = rep.metrics["wan_admitted_bytes"]
    assert admitted[0] > admitted[-1], "the brownout cut nothing"


def test_make_preset_names_and_overrides():
    assert sorted(tp.PRESETS) == sorted(jp.PRESETS)
    uni = make_preset("seeds4k", universes=3)
    assert uni.U == 3 and uni.split_from == 0
    assert uni == tp.PRESETS["seeds4k"](universes=3)
    with pytest.raises(TypeError):
        make_preset("seeds4k", universes=3, n=64)
    for name in ("tuning", "faultmatrix", "streamload", "streamadv",
                 "wanbrownout"):
        with pytest.raises(ValueError, match="grid preset"):
            make_preset(name, universes=2)
    with pytest.raises(ValueError, match="unknown sweep preset"):
        make_preset("nope")
