"""Vivaldi coordinates and the derived WAN latency matrix against the JAX
package.

* ``dc_placement`` is bit-equal (``normal`` is ``jax.random.normal``'s);
* ``vivaldi_round`` from the same state and key: the probe targets and the
  tick fields are equal, and every float field is within 2**-20 (about 8
  float32 ulps of 1.0; coordinates and RTTs are seconds of order 1) of the
  reference's, every round of a 400-round convergence run.  Not bit for
  bit: the reference's compiled round sums and fuses multiply-adds in
  XLA's order;
* ``derive_wan_latency`` returns the reference's matrix exactly, for the
  two pinned configurations (8 DCs x 5 bridges, 400 rounds; 8 x 3, 300
  rounds) and for 4 x 2 at seeds 0 and 3, with ``rel_rtt_error`` within
  1e-4 relative.
"""

import functools

import jax
import numpy as np
import pytest

from consul_tpu.geo.latency import dc_placement as j_dc_placement
from consul_tpu.geo.latency import derive_wan_latency as j_derive
from consul_tpu.models.vivaldi import VivaldiConfig as JConfig
from consul_tpu.models.vivaldi import estimated_rtt as j_estimated_rtt
from consul_tpu.models.vivaldi import euclidean_rtt_model as j_rtt_model
from consul_tpu.models.vivaldi import vivaldi_init as j_init
from consul_tpu.models.vivaldi import vivaldi_round as j_round
from consul_tpu_torch.convert import (
    key_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from consul_tpu_torch.geo import dc_placement, derive_wan_latency
from consul_tpu_torch.models import (
    VivaldiConfig,
    VivaldiState,
    vivaldi_init,
    vivaldi_round,
)
from consul_tpu_torch.models.vivaldi import estimated_rtt, euclidean_rtt_model

TOL = 2.0 ** -20
PINNED = {
    (5, 400): ((0, 4, 4, 5, 5, 2, 2, 5), (4, 0, 3, 1, 2, 4, 4, 3),
               (4, 3, 0, 5, 3, 4, 4, 4), (5, 1, 5, 0, 4, 5, 5, 4),
               (5, 2, 3, 4, 0, 4, 5, 1), (2, 4, 4, 5, 4, 0, 1, 3),
               (2, 4, 4, 5, 5, 1, 0, 4), (5, 3, 4, 4, 1, 3, 4, 0)),
    (3, 300): ((0, 4, 4, 5, 5, 2, 2, 5), (4, 0, 3, 1, 2, 4, 4, 3),
               (4, 3, 0, 4, 3, 4, 4, 4), (5, 1, 4, 0, 3, 5, 5, 4),
               (5, 2, 3, 3, 0, 4, 5, 1), (2, 4, 4, 5, 4, 0, 1, 3),
               (2, 4, 4, 5, 5, 1, 0, 4), (5, 3, 4, 4, 1, 3, 4, 0)),
}


def test_dc_placement_bit_equal():
    for segments, bridges, seed in ((8, 5, 0), (8, 3, 0), (4, 2, 3)):
        want = np.asarray(j_dc_placement(segments, bridges, seed=seed))
        got = dc_placement(segments, bridges, seed=seed, device="cpu").numpy()
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.view(np.uint32))


def _assert_close_state(want, got, msg):
    for name in VivaldiState._fields:
        a, b = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert a.dtype == b.dtype, f"{msg} {name} dtype"
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL,
                                       err_msg=f"{msg} {name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


@functools.lru_cache(maxsize=None)
def _jax_trajectory(rounds):
    """derive_wan_latency's run for (8, 5, seed 0): states 0..rounds."""
    jcfg = JConfig(n=40, rtt_jitter=0.05)
    rtt = j_rtt_model(j_dc_placement(8, 5, seed=0))
    step = jax.jit(lambda s, k: j_round(s, k, jcfg, rtt))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0x6E0)
    states = [j_init(jcfg)]
    for i in range(rounds):
        states.append(step(states[-1], jax.random.fold_in(key, i)))
    return [jax.tree.map(np.asarray, s) for s in states]


def test_init_matches():
    want = jax.tree.map(np.asarray, j_init(JConfig(n=40)))
    got = state_to_numpy(vivaldi_init(VivaldiConfig(n=40), device="cpu"))
    for name in VivaldiState._fields:
        np.testing.assert_array_equal(getattr(want, name), getattr(got, name))
        assert np.asarray(getattr(want, name)).dtype == getattr(got, name).dtype


def test_round_close_every_round():
    cfg = VivaldiConfig(n=40, rtt_jitter=0.05)
    rtt = euclidean_rtt_model(dc_placement(8, 5, seed=0, device="cpu"))
    states = _jax_trajectory(400)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0x6E0)
    for i in range(400):
        k = key_from_numpy(np.asarray(jax.random.fold_in(key, i)))
        got = state_to_numpy(vivaldi_round(state_from_numpy(states[i]), k,
                                           cfg, rtt))
        _assert_close_state(states[i + 1], got, f"round {i}")


def test_estimated_rtt_matches():
    final = _jax_trajectory(400)[-1]
    i = np.repeat(np.arange(40, dtype=np.int32), 40)
    j = np.tile(np.arange(40, dtype=np.int32), 40)
    want = np.asarray(j_estimated_rtt(final, i, j))
    import torch

    got = estimated_rtt(state_from_numpy(final), torch.from_numpy(i),
                        torch.from_numpy(j)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("bridges,rounds", sorted(PINNED))
def test_pinned_latency_matrices(bridges, rounds):
    want, want_info = j_derive(8, bridges, tick_ms=200, seed=0,
                               rounds=rounds, wan_window=8)
    got, info = derive_wan_latency(8, bridges, tick_ms=200, seed=0,
                                   rounds=rounds, wan_window=8, device="cpu")
    assert want == PINNED[(bridges, rounds)]
    assert got == want
    assert info["rounds"] == rounds and info["population"] == 8 * bridges
    assert info["rel_rtt_error"] == pytest.approx(
        want_info["rel_rtt_error"], rel=1e-4)
    assert info["mean_cross_rtt_ms"] == pytest.approx(
        want_info["mean_cross_rtt_ms"], rel=1e-5)


@pytest.mark.parametrize("seed", (0, 3))
def test_small_latency_matrix(seed):
    want, _ = j_derive(4, 2, tick_ms=200, seed=seed)
    got, _ = derive_wan_latency(4, 2, tick_ms=200, seed=seed, device="cpu")
    assert got == want


def test_latency_window_validation():
    with pytest.raises(ValueError, match="wan_window"):
        derive_wan_latency(4, 2, tick_ms=200, wan_window=1, device="cpu")
