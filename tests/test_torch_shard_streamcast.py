"""The sharded streamcast twin: the port against the JAX package on the CPU.

``sharded_streamcast_scan`` over D in {1, 2, 4, 8} logical shards, with
both outbox transports, against the reference's ``sharded_streamcast_scan``
with ``exchange="alltoall"`` on the 8 virtual CPU devices of
``tests/conftest.py``: every per-tick output (the window snapshots, the
counters and the running outbox overflow) and the final state, dtype
included.  Edges messages to other shards ride the outbox with three
payload planes (receiver, slot, chunk); the aggregate path shares only
the per-shard sender counts.  Also: D == 1 equals the port's unsharded
scan, a budget small enough to overflow the outbox, and
``run_streamcast(mesh=)``.
"""

import functools

import jax
import pytest
import torch

from consul_tpu.parallel import mesh_for as j_mesh_for
from consul_tpu.parallel import shard as j_shard
from consul_tpu.streamcast import model as j_model
from consul_tpu_torch.parallel import make_mesh
from consul_tpu_torch.parallel import shard as t_shard
from consul_tpu_torch.parallel import sharded_streamcast_scan
from consul_tpu_torch.sim import run_streamcast, streamcast_scan
from consul_tpu_torch.streamcast import streamcast_init
from test_torch_streamcast import (
    SCAN_BASE,
    _aggregate_step_rule,
    _assert_equal,
    _cfgs,
    _np,
    _tkey,
)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 30
SEED = 0


def _kw(delivery, policy):
    return dict(SCAN_BASE, delivery=delivery, policy=policy)


@functools.lru_cache(maxsize=None)
def _jax_sharded(delivery, policy, d, steps=STEPS):
    jcfg, _ = _cfgs(**_kw(delivery, policy))
    final, outs = j_shard.sharded_streamcast_scan(
        j_model.streamcast_init(jcfg), jax.random.PRNGKey(SEED), jcfg, steps,
        j_mesh_for(d), "alltoall")
    return _np(final), _np(outs)


@functools.lru_cache(maxsize=None)
def _first_flip(policy):
    """First tick of the aggregate trajectory with a receiver between the
    two packages' thresholds (STEPS if none)."""
    jcfg, cfg = _cfgs(**_kw("aggregate", policy))
    step = jax.jit(j_model.streamcast_round, static_argnums=2)
    sched = _np(jax.jit(j_model.arrival_arrays, static_argnums=0)(
        jcfg, jax.random.fold_in(jax.random.PRNGKey(SEED),
                                 j_model._SCHED_SALT)))
    state = _np(j_model.streamcast_init(jcfg))
    for t in range(STEPS):
        if _aggregate_step_rule(jcfg, cfg, state, t, sched):
            return t
        state, _ = step(state, jax.random.fold_in(jax.random.PRNGKey(SEED), t),
                        jcfg, sched)
        state = _np(state)
    return STEPS


def _port_sharded(cfg, d, exchange, steps=STEPS):
    return sharded_streamcast_scan(
        streamcast_init(cfg, device="cpu"), _tkey(jax.random.PRNGKey(SEED)),
        cfg, steps, make_mesh(d, "cpu"), exchange)


@pytest.mark.parametrize("exchange", ["alltoall", "ring"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("delivery,policy", [
    ("edges", "uniform"), ("edges", "pipeline"), ("aggregate", "rarest")])
def test_sharded_scan_matches_jax(delivery, policy, d, exchange):
    _, cfg = _cfgs(**_kw(delivery, policy))
    final, outs = _port_sharded(cfg, d, exchange)
    j_final, j_outs = _jax_sharded(delivery, policy, d)
    upto = STEPS if delivery == "edges" else _first_flip(policy)
    assert upto >= STEPS // 2
    for i, (a, b) in enumerate(zip(j_outs, outs)):
        _assert_equal(a[:upto], b[:upto], f"output {i}")
    if upto == STEPS:
        _assert_equal(j_final, final, "final")
    assert int(outs[-1][-1]) == 0
    assert outs[-1].dtype == torch.int32


@pytest.mark.parametrize("delivery", ["edges", "aggregate"])
def test_d1_equals_the_unsharded_scan(delivery):
    _, cfg = _cfgs(**_kw(delivery, "pipeline"))
    want_f, want = streamcast_scan(streamcast_init(cfg, device="cpu"),
                                   _tkey(jax.random.PRNGKey(SEED)), cfg,
                                   STEPS)
    for exchange in ("alltoall", "ring"):
        got_f, got = _port_sharded(cfg, 1, exchange)
        for i, (a, b) in enumerate(zip(want, got)):
            assert torch.equal(a, b), f"{exchange} output {i}"
        for name in want_f._fields:
            assert torch.equal(getattr(want_f, name), getattr(got_f, name))


def test_outbox_overflow_matches_jax(monkeypatch):
    """A 3-slot outbox budget drops messages at D = 4; the port drops the
    same ones (stable destination order) on both transports."""
    steps = STEPS - 5  # its own trace in the reference's jit cache
    monkeypatch.setattr(j_shard, "outbox_budget", lambda s, d, **k: 3)
    monkeypatch.setattr(t_shard, "outbox_budget", lambda s, d, **k: 3)
    jcfg, cfg = _cfgs(**_kw("edges", "uniform"))
    j_final, j_outs = j_shard.sharded_streamcast_scan(
        j_model.streamcast_init(jcfg), jax.random.PRNGKey(SEED), jcfg, steps,
        j_mesh_for(4), "alltoall")
    j_final, j_outs = _np(j_final), _np(j_outs)
    assert int(j_outs[-1][-1]) > 0
    unsharded = streamcast_scan(streamcast_init(cfg, device="cpu"),
                                _tkey(jax.random.PRNGKey(SEED)), cfg,
                                steps)[1]
    for exchange in ("alltoall", "ring"):
        final, outs = _port_sharded(cfg, 4, exchange, steps)
        for i, (a, b) in enumerate(zip(j_outs, outs)):
            _assert_equal(a, b, f"{exchange} output {i}")
        _assert_equal(j_final, final, f"{exchange} final")
    assert not all(torch.equal(a, b) for a, b in zip(unsharded, outs))


@pytest.mark.parametrize("exchange", ["alltoall", "ring"])
def test_run_streamcast_mesh_reports_shard_overflow(exchange):
    _, cfg = _cfgs(**_kw("edges", "rarest"))
    plain = run_streamcast(cfg, STEPS, warmup=False, device="cpu")
    rep = run_streamcast(cfg, STEPS, warmup=False,
                         mesh=make_mesh(2, "cpu"), exchange=exchange)
    assert rep.shard_overflow == 0 and rep.device == "cpu"
    want, got = plain.summary(), rep.summary()
    assert got.pop("shard_overflow") == 0
    want.pop("sim_rounds_per_sec"), got.pop("sim_rounds_per_sec")
    assert want == got


def test_sharded_rejects_bad_layouts():
    _, cfg = _cfgs(**_kw("edges", "uniform"))
    with pytest.raises(ValueError, match="does not divide"):
        _port_sharded(cfg, 5, "ring", 2)
    with pytest.raises(ValueError, match="unknown exchange"):
        _port_sharded(cfg, 2, "nccl", 2)
