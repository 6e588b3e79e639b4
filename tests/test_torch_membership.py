"""models/membership.py (dense): the port against the JAX package on the CPU.

Every tick starts both packages from the reference's state (carried by
``consul_tpu_torch.convert``) with the same round key; the reference
round runs jitted, as its scan runs it.  All comparisons are bit-equal,
dtype included:

* the suspicion-timeout table against the jitted reference for LAN, WAN
  and LOCAL at n from 8 to 1M;
* ``top_slots`` against ``jax.lax.top_k``'s order, ties included;
* ``membership_round`` per tick at n <= 64 with crashes, a leave and a
  late join, push/pull and probes on and off;
* ``run_membership``'s report arrays and ``probe1k`` (reduced depth in
  tier-1, the preset's 300 ticks behind ``slow``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.models import membership as jmem
from consul_tpu.protocol.profiles import PROFILES as J_PROFILES
from consul_tpu.sim.engine import run_membership as j_run_membership
from consul_tpu.sim.scenarios import probe1k as j_probe1k
from consul_tpu_torch.convert import (
    key_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from consul_tpu_torch.models import (
    MembershipConfig,
    MembershipState,
    membership_init,
    membership_round,
)
from consul_tpu_torch.models.membership import _schedule_array, top_slots
from consul_tpu_torch.models.swim import timeout_table
from consul_tpu_torch.ops import fold_in
from consul_tpu_torch.protocol import PROFILES
from consul_tpu_torch.sim import membership_scan, run_membership
from consul_tpu_torch.sim.scenarios import probe1k

SEED = 0
TABLE_NS = (8, 48, 100, 192, 1000, 4096, 16384, 100_000, 1_000_000)


@dataclasses.dataclass(frozen=True)
class Case:
    profile: str
    steps: int
    n: int
    loss: float = 0.0
    fail_at: tuple = ()
    leave_at: tuple = ()
    join_at: tuple = ()
    probe_enabled: bool = True
    push_pull_enabled: bool = True
    expect_dead: bool = False

    def kw(self):
        kw = dataclasses.asdict(self)
        del kw["profile"], kw["steps"], kw["expect_dead"]
        return kw

    def cfgs(self):
        return (jmem.MembershipConfig(profile=J_PROFILES[self.profile],
                                      **self.kw()),
                MembershipConfig(profile=PROFILES[self.profile], **self.kw()))


# LAN's suspicion minimum at n=48 is 33.6 ticks: the first case sees DEAD
# declarations after its crashes.
CASES = {
    "lan-crash-leave-join-n48": Case(
        "lan", 60, 48, loss=0.2, fail_at=((5, 3), (17, 8)),
        leave_at=((30, 12),), join_at=((40, 6),), expect_dead=True),
    "lan-no-probes-n40": Case("lan", 25, 40, loss=0.1, fail_at=((3, 2),),
                              probe_enabled=False),
    "local-no-pushpull-n40": Case("local", 70, 40, loss=0.1,
                                  fail_at=((3, 2),),
                                  push_pull_enabled=False),
    "wan-join-n64": Case("wan", 30, 64, loss=0.05, fail_at=((9, 1),),
                         join_at=((2, 4), (63, 9))),
}


def _np(state):
    return jax.tree.map(np.asarray, state)


_j_round = jax.jit(jmem.membership_round, static_argnums=(2,))


@functools.lru_cache(maxsize=None)
def _jax_trajectory(case: Case):
    jcfg, _ = case.cfgs()
    key = jax.random.PRNGKey(SEED)
    states = [jmem.membership_init(jcfg)]
    for t in range(case.steps):
        states.append(_j_round(states[-1], jax.random.fold_in(key, t), jcfg))
    return [_np(s) for s in states]


def _tkey(t):
    return fold_in(key_from_numpy(np.asarray(jax.random.PRNGKey(SEED))), t)


def assert_state_equal(want, got, cls, msg=""):
    for name in cls._fields:
        a, b = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert a.dtype == b.dtype, f"{msg} {name}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


# -- the timeout table --------------------------------------------------------


@pytest.mark.parametrize("profile", ["lan", "wan", "local"])
def test_timeout_table_matches_jitted_reference(profile):
    for n in TABLE_NS:
        jcfg = jmem.MembershipConfig(n=n, profile=J_PROFILES[profile])
        conf = jnp.arange(jcfg.confirmations_k + 1, dtype=jnp.int32)
        want = np.asarray(jax.jit(functools.partial(
            jmem._lifeguard_timeout_ticks, jcfg))(conf))
        got = timeout_table(MembershipConfig(
            n=n, profile=PROFILES[profile])).numpy()
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.view(np.uint32),
                                      err_msg=f"{profile} n={n}")


# -- the top-k order ----------------------------------------------------------


def test_top_slots_matches_lax_top_k_with_ties():
    rng = np.random.default_rng(3)
    rows, width, m = 64, 40, 8
    prio = rng.integers(0, 4, (rows, width)).astype(np.float32)
    prio += rng.integers(0, 3, (rows, width)).astype(np.float32) / 4
    prio[rng.random((rows, width)) < 0.3] = -np.inf
    prio[5] = -np.inf                        # a row that is all ties
    prio[6, :] = 1.5
    want = np.asarray(jax.jit(lambda p: jax.lax.top_k(p, m)[1])(prio))
    got = top_slots(torch.from_numpy(prio), m)
    np.testing.assert_array_equal(want, got.numpy())
    assert got.dtype == torch.int64


# -- the round ----------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_membership_round_matches_jax(name):
    case = CASES[name]
    states = _jax_trajectory(case)
    _, cfg = case.cfgs()
    for t in range(case.steps):
        got = state_to_numpy(membership_round(
            state_from_numpy(states[t], state_cls=MembershipState),
            _tkey(t), cfg))
        assert_state_equal(states[t + 1], got, MembershipState,
                           f"{name} tick {t}")
    ranks = np.stack([np.where(s.key >= 0, s.key & 3, -1) for s in states])
    # Only a failed probe starts a suspicion.
    assert (ranks == jmem.RANK_SUSPECT).any() == case.probe_enabled
    if case.expect_dead:
        assert (ranks == jmem.RANK_DEAD).any(), "no DEAD in the study"


def test_init_matches_jax():
    case = CASES["wan-join-n64"]
    jcfg, cfg = case.cfgs()
    assert_state_equal(_np(jmem.membership_init(jcfg)),
                       state_to_numpy(membership_init(cfg, device="cpu")),
                       MembershipState)


def test_membership_scan_final_state_matches_trajectory():
    case = CASES["lan-crash-leave-join-n48"]
    states = _jax_trajectory(case)
    _, cfg = case.cfgs()
    final, outs = membership_scan(
        state_from_numpy(states[0], state_cls=MembershipState),
        key_from_numpy(np.asarray(jax.random.PRNGKey(SEED))), cfg,
        case.steps, (5, 30))
    assert_state_equal(states[-1], state_to_numpy(final), MembershipState)
    ranks = np.stack([np.where(s.key >= 0, s.key & 3, -1)
                      for s in states[1:]])
    np.testing.assert_array_equal(
        outs[1].numpy(), (ranks[:, :, [5, 30]] == jmem.RANK_DEAD).sum(1))


def test_round_leaves_its_input_untouched():
    case = CASES["lan-crash-leave-join-n48"]
    states = _jax_trajectory(case)
    _, cfg = case.cfgs()
    st = state_from_numpy(states[20], state_cls=MembershipState)
    before = [t.clone() for t in st]
    membership_round(st, _tkey(20), cfg)
    for a, b in zip(before, st):
        assert torch.equal(a, b)


def test_run_membership_matches_jax():
    case = CASES["lan-crash-leave-join-n48"]
    jcfg, cfg = case.cfgs()
    track = (5, 17, 30)
    want = j_run_membership(jcfg, case.steps, seed=SEED, track=track,
                            warmup=False)
    got = run_membership(cfg, case.steps, seed=SEED, track=track,
                         warmup=False, device="cpu")
    for field in ("suspecting", "dead_known", "suspect_cells",
                  "known_members"):
        w, g = np.asarray(getattr(want, field)), getattr(got, field)
        assert w.dtype == g.dtype, field
        np.testing.assert_array_equal(w, g, err_msg=field)
    assert got.device == "cpu"
    ws, gs = want.summary(), got.summary()
    for field in ("first_suspect_ms", "dead_known_final",
                  "suspect_cells_final", "mean_membership_final"):
        assert ws[field] == gs[field], field


def test_probe1k_config_matches_jax_at_reduced_depth():
    """The probe1k study (n=1000, LAN, fanout 3, 10 crashes at tick 10)
    through 30 ticks: the per-tick report arrays are the reference's."""
    failed = tuple(range(0, 1000, 100))
    kw = dict(n=1000, loss=0.0, fanout=3,
              fail_at=tuple((f, 10) for f in failed))
    want = j_run_membership(jmem.MembershipConfig(profile=J_PROFILES["lan"],
                                                  **kw),
                            30, seed=SEED, track=failed, warmup=False)
    got = run_membership(MembershipConfig(profile=PROFILES["lan"], **kw), 30,
                         seed=SEED, track=failed, warmup=False, device="cpu")
    for field in ("suspecting", "dead_known", "suspect_cells",
                  "known_members"):
        np.testing.assert_array_equal(np.asarray(getattr(want, field)),
                                      getattr(got, field), err_msg=field)
    assert got.suspecting[-1].sum() > 0, "no suspicion by tick 30"


@pytest.mark.slow
def test_probe1k_matches_jax():
    """The preset in full (300 ticks): the reference's summary dict."""
    want = j_probe1k(seed=SEED)
    got = probe1k(seed=SEED, device="cpu")
    assert got["all_detected"]
    for field in ("n", "subjects", "mean_first_suspect_ms", "all_detected",
                  "mean_converged_ms"):
        assert want[field] == got[field], field


def test_schedule_rejects_out_of_range_node():
    with pytest.raises(IndexError, match="out of bounds"):
        _schedule_array(8, ((8, 3),), 0, "cpu")
    assert _schedule_array(8, ((-1, 3),), 0, "cpu")[7] == 3


def test_run_membership_rejects_later_slice_knobs():
    cfg = MembershipConfig(n=8)
    for kw in ({"mesh": object()}, {"exchange": "ring"},
               {"telemetry": True}, {"sharded": True}):
        with pytest.raises(NotImplementedError):
            run_membership(cfg, 2, device="cpu", **kw)


def test_run_membership_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_membership(MembershipConfig(n=8), 2)


def test_owned_uniform_rows_blocks_like_one_draw(monkeypatch):
    """The row-blocked tie-break draw equals the reference's one draw."""
    from consul_tpu.ops.sampling import owned_uniform as j_owned_uniform
    from consul_tpu_torch.ops import owned_uniform_rows, sampling

    key = jax.random.split(jax.random.PRNGKey(5))[1]
    want = np.asarray(jax.jit(j_owned_uniform, static_argnums=(2,))(
        key, jnp.arange(37, dtype=jnp.int32), (11,)))
    monkeypatch.setattr(sampling, "_DRAW_BLOCK", 50)  # 4 rows a block
    got = owned_uniform_rows(key_from_numpy(np.asarray(key)), 37, 11)
    np.testing.assert_array_equal(want.view(np.uint32),
                                  got.numpy().view(np.uint32))
