"""The BASELINE presets of the broadcast and membership paths: the port
against the JAX package on the CPU.

* ``dev3`` (config 1) at its preset size;
* ``event100k`` (config 3): its configuration called directly at n=8192
  in both forms (aggregate unsharded; edges over 8 shards with both
  transports), since the 100k preset takes tens of seconds on the CPU
  here; the presets' own dicts are checked for their keys and knobs;
* ``probe1k(devices=8, exchange="ring")`` (config 2 over the dense twin)
  against the reference's ``probe1k(devices=8)``, both cut to 30 ticks
  (the full 300 ticks take minutes under ``pytest -n 6`` and run with
  ``-m slow``);
* the knobs that are rejected: ``exchange`` without ``devices``, and
  ``telemetry``.
"""

import numpy as np
import pytest

from consul_tpu.models.broadcast import BroadcastConfig as JConfig
from consul_tpu.parallel import mesh_for as j_mesh_for
from consul_tpu.sim.engine import run_broadcast as j_run_broadcast
from consul_tpu.sim.scenarios import dev3 as j_dev3
from consul_tpu.sim import scenarios as j_scenarios
from consul_tpu.sim.scenarios import probe1k as j_probe1k
from consul_tpu_torch.parallel import mesh_for
from consul_tpu_torch.sim import run_broadcast
from consul_tpu_torch.sim import scenarios
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = 8192


def _same_summary(want: dict, got: dict):
    """The reference's summary, key for key; the port adds the device it
    ran on, and the wall-clock rate differs."""
    got = dict(got)
    assert got.pop("device", "cpu") == "cpu"
    for d in (want, got):
        d.pop("sim_rounds_per_sec")
    assert want == got


def test_dev3_matches_jax():
    _same_summary(j_dev3(seed=0), scenarios.dev3(seed=0, device="cpu"))


@pytest.mark.parametrize("seed", [0, 5])
def test_event100k_aggregate_form_matches_jax(seed):
    """Aggregate at n=8192: uniforms bit-equal, so the curves agree unless
    a receiver's uniform lies between the two packages' thresholds (the
    broadcast tests pin that rule tick by tick)."""
    cfg = scenarios.event100k_config(None, n=SMALL)
    jcfg = JConfig(n=SMALL, fanout=4, delivery="aggregate")
    want = j_run_broadcast(jcfg, 100, seed=seed, warmup=False)
    got = run_broadcast(cfg, 100, seed=seed, warmup=False, device="cpu")
    np.testing.assert_array_equal(want.infected, got.infected)
    assert got.summary()["infected_final"] == SMALL


@pytest.mark.parametrize("exchange", ["alltoall", "ring"])
def test_event100k_sharded_form_matches_jax(exchange):
    cfg = scenarios.event100k_config(8, n=SMALL)
    jcfg = JConfig(n=SMALL, fanout=4, delivery="edges")
    want = j_run_broadcast(jcfg, 100, seed=0, warmup=False,
                           mesh=j_mesh_for(8))
    got = run_broadcast(cfg, 100, seed=0, warmup=False,
                        mesh=mesh_for(8, "cpu"), exchange=exchange)
    np.testing.assert_array_equal(want.infected, got.infected)
    assert got.overflow == want.overflow == 0
    _same_summary(want.summary(), got.summary())


def test_event100k_preset_keys_and_knobs(monkeypatch):
    """The preset at the preset's own steps, with its config shrunk to
    n=1024 through ``event100k_config``."""
    real = scenarios.event100k_config
    monkeypatch.setattr(scenarios, "event100k_config",
                        lambda devices=None, n=None: real(devices, n=1024))
    got = scenarios.event100k(seed=0, devices=4, exchange="ring",
                              device="cpu")
    assert got["scenario"] == "event100k" and got["devices"] == 4
    assert got["exchange_backend"] == "ring" and got["shard_overflow"] == 0
    assert got["ticks"] == 100 and got["infected_final"] == 1024
    plain = scenarios.event100k(seed=0, device="cpu")
    assert "devices" not in plain and plain["n"] == 1024
    with pytest.raises(ValueError, match="requires mesh"):
        scenarios.event100k(exchange="ring", device="cpu")


PROBE_DEPTH = 30


def test_probe1k_over_8_shards_matches_jax_at_reduced_depth(monkeypatch):
    """The preset's own wiring (its config, ``devices=8`` as an 8-shard
    mesh, the ring transport, its summary) with both packages' study cut
    to 30 ticks, past the first suspicions: the reference's summary."""
    real_j, real_t = j_scenarios.run_membership, scenarios.run_membership
    monkeypatch.setattr(j_scenarios, "run_membership",
                        lambda cfg, steps, **kw: real_j(cfg, PROBE_DEPTH,
                                                        **kw))
    monkeypatch.setattr(scenarios, "run_membership",
                        lambda cfg, steps, **kw: real_t(cfg, PROBE_DEPTH,
                                                        **kw))
    want = j_scenarios.probe1k(seed=0, devices=8)
    got = scenarios.probe1k(seed=0, devices=8, exchange="ring", device="cpu")
    assert got.pop("exchange_backend") == "ring"
    assert want.pop("exchange_backend") == "alltoall"
    _same_summary(want, got)
    assert got["mean_first_suspect_ms"] is not None
    assert got["shard_overflow"] == 0


@pytest.mark.slow
def test_probe1k_over_8_shards_matches_jax():
    """The preset in full (300 ticks, all ten crashes detected)."""
    want = j_probe1k(seed=0, devices=8)
    got = scenarios.probe1k(seed=0, devices=8, exchange="ring", device="cpu")
    assert got.pop("exchange_backend") == "ring"
    assert want.pop("exchange_backend") == "alltoall"
    _same_summary(want, got)
    assert got["all_detected"] and got["shard_overflow"] == 0


@pytest.mark.parametrize("preset", ["dev3", "probe1k", "event100k",
                                    "stream100k"])
def test_rejected_knobs(preset):
    fn = getattr(scenarios, preset)
    with pytest.raises(NotImplementedError, match="telemetry"):
        fn(telemetry=True, device="cpu")
    if preset == "probe1k":
        with pytest.raises(ValueError, match="requires mesh"):
            fn(exchange="ring", device="cpu")
