"""The reference's statistical claims, re-verified on the port.

Each runs the port's entry points on the CPU on one intra-op thread:

  * ``tests/test_swim_paper.py``: the broadcast's infection curve follows
    the mean field ``x' = x + (1 - x)(1 - exp(-F x))`` within 0.02 and
    its 99% time within a round of it; quadrupling n adds at most three
    rounds to the 99% time; and (slow tier) the expected first-detection
    time of a crash does not depend on the group size;
  * ``tests/test_lifeguard.py``: on degraded1m's environment at n=1024,
    Lifeguard strictly lowers the false-positive suspicion rate and does
    not raise the incarnation flaps.
"""

import numpy as np
import pytest

from consul_tpu_torch.models import BroadcastConfig
from consul_tpu_torch.sim import run_broadcast, run_lifeguard
from torch_parity import one_torch_thread  # noqa: F401 (fixture)
from test_torch_swim_paper import _first_detection_periods

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _infection_fraction(n: int, steps: int, seed: int) -> np.ndarray:
    cfg = BroadcastConfig(n=n, fanout=4, delivery="edges")
    rep = run_broadcast(cfg, steps, seed=seed, origin=0, warmup=False,
                        device="cpu")
    return rep.infected / n


def test_infection_curve_matches_mean_field():
    n, steps, fanout = 20_000, 16, 4
    x = _infection_fraction(n, steps, seed=3)
    mf = [1.0 / n]
    for _ in range(steps):
        xt = mf[-1]
        mf.append(xt + (1 - xt) * (1 - np.exp(-fanout * xt)))
    mf = np.array(mf[1:])
    assert np.abs(x - mf).max() < 0.02, np.abs(x - mf).max()
    t99_sim = int(np.argmax(x >= 0.99))
    t99_mf = int(np.argmax(mf >= 0.99))
    assert abs(t99_sim - t99_mf) <= 1, (t99_sim, t99_mf)


def test_infection_t99_grows_logarithmically():
    t99 = {}
    for n, seed in ((5_000, 4), (80_000, 5)):
        frac = _infection_fraction(n, 24, seed)
        assert frac[-1] >= 0.999
        t99[n] = int(np.argmax(frac >= 0.99))
    assert t99[80_000] - t99[5_000] <= 3, t99


@pytest.mark.slow  # 600 universes at two n, tick by tick
def test_first_detection_independent_of_n():
    small = _first_detection_periods(128, 300, seed0=1).mean()
    large = _first_detection_periods(1024, 300, seed0=2).mean()
    assert abs(small - large) / small < 0.10, (small, large)


def test_fp_rate_strictly_lower_with_lifeguard():
    import dataclasses

    from consul_tpu_torch.models import LifeguardConfig
    from consul_tpu_torch.protocol import WAN
    from consul_tpu_torch.sim.scenarios import degraded1m_environment

    faults, loss, ack_late = degraded1m_environment()
    on_cfg = LifeguardConfig(
        n=1024, subject=7, subject_alive=True, loss=loss, ack_late=ack_late,
        profile=WAN, delivery="aggregate", lifeguard=True, faults=faults)
    on = run_lifeguard(on_cfg, steps=400, seed=0, warmup=False, device="cpu")
    off = run_lifeguard(dataclasses.replace(on_cfg, lifeguard=False),
                        steps=400, seed=0, warmup=False, device="cpu")
    assert on.fp_total > 0, "the faulted universe must produce FPs"
    assert on.fp_rate < off.fp_rate, (on.fp_rate, off.fp_rate)
    assert on.flap_count <= off.flap_count
