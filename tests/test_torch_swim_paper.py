"""The SWIM paper's first-detection bands, re-verified on the port.

The port of ``tests/test_swim_paper.py``'s n=512, 400-universe mean and
CDF tests: each of the n-1 live members probes one uniform member per
protocol period, so first detection of a crashed member is
Geometric(p) in periods with p = 1-(1-1/(n-1))^(n-1) -> 1-1/e and mean
1/p ~ 1.58, independent of n (Das, Gupta, Motivala 2002, section 5).

The universes use the reference's keys (``split(PRNGKey(0), 400)``) and
run the port's round on the CPU until the first suspicion.  Slow tier
(``-m slow``): about 50 s on an 8-core CPU.
"""

import functools

import numpy as np
import pytest

from consul_tpu_torch.models import SwimConfig, swim_init, swim_round
from consul_tpu_torch.models.swim import VIEW_SUSPECT, swim_constants
from consul_tpu_torch.ops import PRNGKey, fold_in, split


@functools.lru_cache(maxsize=None)
def _first_detection_periods(n: int, seeds: int, seed0: int = 0):
    """First-detection time in probe periods of ``seeds`` universes of
    one crashed subject (read-only array, shared by the two tests)."""
    cfg = SwimConfig(n=n, subject=7, fail_at_tick=0)
    period = cfg.probe_interval_ticks
    consts = swim_constants(cfg, "cpu")
    periods = []
    for key in split(PRNGKey(seed0), seeds):
        state = swim_init(cfg, device="cpu")
        for t in range(30 * period):
            state = swim_round(state, fold_in(key, t), cfg, consts)
            if bool((state.view == VIEW_SUSPECT).any()):
                periods.append(t / period)
                break
        else:
            raise AssertionError("subject never detected")
    out = np.asarray(periods)
    out.setflags(write=False)
    return out


def geometric_p(n: int) -> float:
    return 1.0 - (1.0 - 1.0 / (n - 1)) ** (n - 1)


@pytest.mark.slow
def test_first_detection_mean_within_5pct():
    n = 512
    periods = _first_detection_periods(n, 400)
    expected = 1.0 / geometric_p(n)
    rel_err = abs(periods.mean() - expected) / expected
    assert rel_err < 0.05, (periods.mean(), expected, rel_err)


@pytest.mark.slow
def test_first_detection_cdf_within_5pct():
    n = 512
    periods = _first_detection_periods(n, 400)
    p = geometric_p(n)
    for k in range(1, 7):
        emp = (periods <= k).mean()
        geo = 1.0 - (1.0 - p) ** k
        assert abs(emp - geo) < 0.05, (k, emp, geo)


def test_first_detection_small():
    """Tier-1 twin at 20 universes: every universe detects the crash
    within a few periods."""
    periods = _first_detection_periods(128, 20)
    assert periods.shape == (20,) and periods.max() <= 10
