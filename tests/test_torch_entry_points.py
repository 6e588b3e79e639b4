"""The port's public surface against the JAX package's: the parameters of
every ``run_*`` of ``sim/engine.py`` (names, order, defaults) and the
fields of ``GossipProfile`` (order, defaults, which are required).  The
port may only add trailing parameters with defaults (``device``)."""

import dataclasses
import inspect

import pytest

import consul_tpu.protocol.profiles as j_profiles
import consul_tpu.sim.engine as j_engine
import consul_tpu_torch.protocol.profiles as t_profiles
import consul_tpu_torch.sim.engine as t_engine


def _entry_points(module) -> set:
    return {name for name, fn in vars(module).items()
            if name.startswith("run_") and inspect.isfunction(fn)}


def test_same_entry_points():
    assert _entry_points(t_engine) == _entry_points(j_engine)


@pytest.mark.parametrize("name", sorted(_entry_points(j_engine)))
def test_entry_point_parameters(name):
    want = list(inspect.signature(getattr(j_engine, name)).parameters.values())
    have = list(inspect.signature(getattr(t_engine, name)).parameters.values())
    assert [(p.name, p.kind, p.default) for p in have[:len(want)]] == [
        (p.name, p.kind, p.default) for p in want]
    extra = have[len(want):]
    assert all(p.default is not inspect.Parameter.empty for p in extra), extra


def test_gossip_profile_fields():
    def fields(cls):
        return [(f.name, f.default is dataclasses.MISSING
                 and f.default_factory is dataclasses.MISSING, f.default)
                for f in dataclasses.fields(cls)]

    assert fields(t_profiles.GossipProfile) == fields(j_profiles.GossipProfile)
    for name in ("LAN", "WAN", "LOCAL"):
        assert dataclasses.astuple(getattr(t_profiles, name)) == \
            dataclasses.astuple(getattr(j_profiles, name))


def test_placement_knobs_rejected():
    """``sharded`` (and on SWIM and Lifeguard ``mesh``) wait for several
    cards; passed where the reference takes them, they are refused."""
    from consul_tpu_torch.models import (
        BroadcastConfig,
        LifeguardConfig,
        SwimConfig,
    )
    from consul_tpu_torch.parallel import mesh_for

    mesh = mesh_for(2, device="cpu")
    cases = [
        (t_engine.run_broadcast, BroadcastConfig(n=64), (0, 0, True), {}),
        (t_engine.run_swim, SwimConfig(n=64), (0, True), {}),
        (t_engine.run_swim, SwimConfig(n=64), (0, False, mesh), {}),
        (t_engine.run_lifeguard, LifeguardConfig(n=64), (0, True), {}),
        (t_engine.run_lifeguard, LifeguardConfig(n=64), (), {"mesh": mesh}),
    ]
    for run, cfg, args, kw in cases:
        with pytest.raises(NotImplementedError, match="is not ported yet"):
            run(cfg, 2, *args, device="cpu", **kw)
