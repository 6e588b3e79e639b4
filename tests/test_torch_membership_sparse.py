"""models/membership_sparse.py: the top-K sparse model against the JAX package.

The reference round runs jitted; every comparison is bit-equal, dtype
included (int8 confirms/tx/awareness, the int16 age plane, the 0-d
overflow/forgotten/tick):

* K == n against the reference and, through ``densify``, against the
  port's own dense model (the reference's ``TestExactParity`` config);
* K < n per tick (n=192 K=16 for 60 ticks; n=64 K=4 with overflow > 0),
  ``amortize`` True and False;
* the chunked driver and the row-blocked branches, forced by lowering
  ``_CHUNK_A``/``_CHUNK_TARGET`` and ``_BLOCK_ROWS`` in both packages
  (a fresh ``jax.jit`` so the reference retraces);
* the expiry-age table against the reference's jitted expression, for
  LAN, WAN and LOCAL at n from 8 to 1M;
* ``densify``, the config validations, the benchmark's converged state
  stepped 8 ticks, ``run_membership_sparse``'s ``(report, overflow)``,
  and ``convert``'s round trip of both membership states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import consul_tpu.models.membership_sparse as jms
import consul_tpu.ops.sortmerge as jsm
import consul_tpu_torch.models.membership_sparse as tms
import consul_tpu_torch.ops.sortmerge as tsm
from consul_tpu.models import membership as jmem
from consul_tpu.protocol.profiles import PROFILES as J_PROFILES
from consul_tpu.sim.engine import run_membership_sparse as j_run_sparse
from consul_tpu_torch.convert import (
    key_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from consul_tpu_torch.models import (
    MembershipConfig,
    MembershipState,
    SparseMembershipConfig,
    SparseMembershipState,
    densify,
    membership_init,
    sparse_membership_init,
    sparse_membership_round,
)
from consul_tpu_torch.ops import PRNGKey, fold_in
from consul_tpu_torch.protocol import LAN, PROFILES
from consul_tpu_torch.sim import (
    membership_scan,
    run_membership_sparse,
    sparse_membership_scan,
)

TABLE_NS = (8, 48, 100, 192, 1000, 4096, 16384, 100_000, 1_000_000)


@dataclasses.dataclass(frozen=True)
class Case:
    n: int
    k: int
    steps: int
    seed: int = 0
    loss: float = 0.0
    fail_at: tuple = ()
    leave_at: tuple = ()
    profile: str = "lan"
    amortize: object = None

    def base_kw(self):
        return dict(n=self.n, loss=self.loss, fail_at=self.fail_at,
                    leave_at=self.leave_at)

    def cfgs(self):
        jb = jmem.MembershipConfig(profile=J_PROFILES[self.profile],
                                   **self.base_kw())
        tb = MembershipConfig(profile=PROFILES[self.profile],
                              **self.base_kw())
        return (jms.SparseMembershipConfig(jb, k_slots=self.k,
                                           amortize=self.amortize),
                SparseMembershipConfig(tb, k_slots=self.k,
                                       amortize=self.amortize))


CASES = {
    # The reference's TestSparseRegime config: one crash, K far below n.
    "k16-n192": Case(192, 16, 60, seed=1, loss=0.02, fail_at=((42, 5),)),
    # More concurrent crashes than four slots hold: overflow > 0.
    "k4-n64-overflow": Case(64, 4, 30, fail_at=tuple(
        (i, 3) for i in range(1, 24))),
    "k8-n64-wan-leave-slow-branch": Case(
        64, 8, 40, seed=2, loss=0.1, fail_at=((7, 3),), leave_at=((20, 6),),
        profile="wan", amortize=False),
}


def _np(state):
    return jax.tree.map(np.asarray, state)


def _tkey(seed, t):
    return fold_in(key_from_numpy(np.asarray(jax.random.PRNGKey(seed))), t)


def assert_state_equal(want, got, cls, msg=""):
    for name in cls._fields:
        a, b = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert a.dtype == b.dtype, f"{msg} {name}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


def _check_per_tick(jcfg, cfg, steps, seed, state0=None, step=None,
                    key=None):
    """Step the jitted reference from ``state0`` (init by default) and the
    port from each reference state; returns the reference's states."""
    step = step or jax.jit(jms.sparse_membership_round, static_argnums=(2,))
    key = jax.random.PRNGKey(seed) if key is None else key
    tkey = key_from_numpy(np.asarray(key))
    st = jms.sparse_membership_init(jcfg) if state0 is None else state0
    states = [_np(st)]
    for t in range(steps):
        st = step(st, jax.random.fold_in(key, t), jcfg)
        got = sparse_membership_round(
            state_from_numpy(states[-1], state_cls=SparseMembershipState),
            fold_in(tkey, t), cfg)
        states.append(_np(st))
        assert_state_equal(states[-1], state_to_numpy(got),
                           SparseMembershipState, f"tick {t}")
    return states


def assert_rows_sorted(slot_subj: np.ndarray):
    """The sorted-row invariant: subjects ascending, empties last, no
    duplicate subject, the self slot present."""
    keyed = np.where(slot_subj < 0, np.iinfo(np.int32).max, slot_subj)
    assert (np.diff(keyed, axis=1) >= 0).all()
    occ = slot_subj >= 0
    assert ((np.diff(keyed, axis=1) > 0) | ~occ[:, 1:]).all()
    rows = np.arange(slot_subj.shape[0])
    assert (slot_subj == rows[:, None]).any(axis=1).all()


# -- K < n, per tick ----------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_sparse_round_matches_jax(name):
    case = CASES[name]
    jcfg, cfg = case.cfgs()
    states = _check_per_tick(jcfg, cfg, case.steps, case.seed)
    final = states[-1]
    assert_rows_sorted(final.slot_subj)
    if name == "k4-n64-overflow":
        assert int(final.overflow) > 0
    else:
        assert int(final.overflow) == 0
    ranks = np.where(final.key >= 0, final.key & 3, -1)
    assert (ranks >= jmem.RANK_SUSPECT).any()


def test_chunked_and_blocked_drivers_match_jax(monkeypatch):
    """The >= 2M-node paths at n=192: the chunked delivery driver (the
    gossip and push/pull legs merged chunk by chunk) and the row-blocked
    claim construction and merge step."""
    for mod in (jms, tms):
        monkeypatch.setattr(mod, "_CHUNK_A", 512)
        monkeypatch.setattr(mod, "_CHUNK_TARGET", 512)
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "_BLOCK_ROWS", 16)
    case = Case(192, 16, 25, seed=1, loss=0.05, fail_at=((42, 5),),
                leave_at=((9, 4),))
    jcfg, cfg = case.cfgs()
    assert tms.arrival_count(cfg) > tms._CHUNK_A
    assert tsm._row_blocks(192) == (12, 16)
    step = jax.jit(lambda s, k, c: jms.sparse_membership_round(s, k, c),
                   static_argnums=(2,))
    syncs = tsm.host_cond.syncs
    states = _check_per_tick(jcfg, cfg, case.steps, case.seed, step=step)
    assert_rows_sorted(states[-1].slot_subj)
    # One host read per chunk merge, more than two a tick.
    assert tsm.host_cond.syncs - syncs > 2 * case.steps


# -- K == n -------------------------------------------------------------------


def test_k_equals_n_matches_jax_and_dense():
    """The reference's TestExactParity config: the sparse run equals the
    reference's sparse run field for field, and the port's dense run
    through densify."""
    n = 48
    kw = dict(n=n, loss=0.2, profile=LAN, fail_at=((5, 3), (17, 8)),
              leave_at=((30, 12),))
    jkw = dict(kw, profile=J_PROFILES["lan"])
    steps, seed = 50, 7
    jcfg = jms.SparseMembershipConfig(jmem.MembershipConfig(**jkw), k_slots=n)
    cfg = SparseMembershipConfig(MembershipConfig(**kw), k_slots=n)
    from consul_tpu.sim import sparse_membership_scan as j_scan

    want, _ = j_scan(jms.sparse_membership_init(jcfg),
                     jax.random.PRNGKey(seed), jcfg, steps)
    key = PRNGKey(seed)
    sparse, _ = sparse_membership_scan(
        sparse_membership_init(cfg, device="cpu"), key, cfg, steps)
    assert_state_equal(_np(want), state_to_numpy(sparse),
                       SparseMembershipState)
    dense, _ = membership_scan(membership_init(cfg.base, device="cpu"), key,
                               cfg.base, steps)
    for got, field in zip(densify(sparse, n),
                          ("key", "suspect_since", "confirms", "tx")):
        torch.testing.assert_close(got, getattr(dense, field), rtol=0,
                                   atol=0, msg=field)
    for field in ("own_inc", "awareness"):
        np.testing.assert_array_equal(
            getattr(sparse, field).numpy().astype(np.int32),
            getattr(dense, field).numpy(), err_msg=field)
    assert int(sparse.overflow) == 0


# -- tables and helpers -------------------------------------------------------


@pytest.mark.parametrize("profile", ["lan", "wan", "local"])
def test_threshold_table_matches_jitted_reference(profile):
    """The expiry-age table against the reference's own expression, jitted
    (XLA may fold its constant ``arange`` another way than the dense
    model's per-cell evaluation)."""
    for n in TABLE_NS:
        jb = jmem.MembershipConfig(n=n, profile=J_PROFILES[profile])

        def table(jb=jb):
            return jnp.minimum(jnp.ceil(jmem._lifeguard_timeout_ticks(
                jb, jnp.arange(jb.confirmations_k + 1, dtype=jnp.int32)
            )).astype(jnp.int32), jms.AGE_CAP + 1).astype(jms.SINCE_DTYPE)

        want = np.asarray(jax.jit(table)())
        got = tms.threshold_table(MembershipConfig(
            n=n, profile=PROFILES[profile])).numpy()
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got, err_msg=f"{profile} n={n}")


def test_densify_matches_jax():
    case = CASES["k16-n192"]
    jcfg, _ = case.cfgs()
    step = jax.jit(jms.sparse_membership_round, static_argnums=(2,))
    st = jms.sparse_membership_init(jcfg)
    for t in range(40):
        st = step(st, jax.random.fold_in(jax.random.PRNGKey(1), t), jcfg)
    want = jax.jit(jms.densify, static_argnums=(1,))(st, case.n)
    got = densify(state_from_numpy(_np(st), state_cls=SparseMembershipState),
                  case.n)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(w, g.numpy())


def _j_converged_state(jcfg, dead, tick=200):
    """bench.py's ``_sparse_steady_state`` (a nested helper there)."""
    n, K = jcfg.base.n, jcfg.k_slots
    ids = jnp.arange(n, dtype=jnp.int32)
    lo, hi = jnp.minimum(ids, dead), jnp.maximum(ids, dead)
    slot_subj = jnp.full((n, K), -1, jnp.int32)
    slot_subj = slot_subj.at[:, 0].set(lo)
    slot_subj = slot_subj.at[:, 1].set(jnp.where(ids == dead, -1, hi))
    dead_key = jnp.int32(jmem.make_key(0, jmem.RANK_DEAD))
    key = jnp.zeros((n, K), jnp.int32)
    key = key.at[:, 1].set(jnp.where((hi == dead) & (ids != dead),
                                     dead_key, 0))
    key = key.at[:, 0].set(jnp.where((lo == dead) & (ids != dead),
                                     dead_key, 0))
    return jms.sparse_membership_init(jcfg)._replace(
        slot_subj=slot_subj, key=key, tick=jnp.int32(tick))


def test_converged_state_stepped_8_ticks():
    """The benchmark's steady-state measure at n=256: the converged state
    is the reference's, and 8 ticks from it with PRNGKey(1) agree tick by
    tick with no allocation (one host read a tick)."""
    case = Case(256, 64, 8, loss=0.01, fail_at=((42, 5),))
    jcfg, cfg = case.cfgs()
    j0 = _j_converged_state(jcfg, 42)
    t0 = tms.converged_state(cfg, 42, device="cpu")
    assert_state_equal(_np(j0), state_to_numpy(t0), SparseMembershipState)
    syncs = tsm.host_cond.syncs
    states = _check_per_tick(jcfg, cfg, 8, 1, state0=j0)
    assert tsm.host_cond.syncs - syncs <= 2 * 8
    assert int(states[-1].overflow) == 0
    assert_rows_sorted(states[-1].slot_subj)


def test_run_membership_sparse_matches_jax():
    case = CASES["k16-n192"]
    jcfg, cfg = case.cfgs()
    want, want_ov = j_run_sparse(jcfg, 40, seed=3, track=(42, 7),
                                 warmup=False)
    got, got_ov = run_membership_sparse(cfg, 40, seed=3, track=(42, 7),
                                        warmup=False, device="cpu")
    assert got_ov == want_ov
    # known_members is the float32 gauge f32(n)*n - dead cells, exact here
    # (far below 2**24 dead cells), so it compares exactly.
    for field in ("suspecting", "dead_known", "suspect_cells",
                  "known_members"):
        w, g = np.asarray(getattr(want, field)), getattr(got, field)
        assert w.dtype == g.dtype, field
        np.testing.assert_array_equal(w, g, err_msg=field)
    assert got.suspecting[:, 0].max() > 0


def test_config_validation_matches_reference():
    def both(kw, profile=LAN, jprofile=J_PROFILES["lan"], **skw):
        errs = []
        for mcfg, scfg, prof in (
                (jmem.MembershipConfig, jms.SparseMembershipConfig, jprofile),
                (MembershipConfig, SparseMembershipConfig, profile)):
            with pytest.raises(ValueError) as err:
                scfg(mcfg(profile=prof, **kw), **skw)
            errs.append(str(err.value))
        return errs

    assert all("join_at" in e for e in both(dict(n=8, join_at=((3, 5),)),
                                            k_slots=8))
    assert all("k_slots" in e for e in both(dict(n=8), k_slots=1))
    big_tx = dataclasses.replace(LAN, retransmit_mult=50)
    j_big_tx = dataclasses.replace(J_PROFILES["lan"], retransmit_mult=50)
    assert all("tx_limit" in e for e in both(dict(n=100), big_tx, j_big_tx))
    many_conf = dataclasses.replace(LAN, suspicion_mult=200)
    j_many_conf = dataclasses.replace(J_PROFILES["lan"], suspicion_mult=200)
    assert all("confirmations_k" in e
               for e in both(dict(n=1000), many_conf, j_many_conf))
    aware = dataclasses.replace(LAN, awareness_max_multiplier=200)
    j_aware = dataclasses.replace(J_PROFILES["lan"],
                                  awareness_max_multiplier=200)
    assert all("awareness" in e for e in both(dict(n=100), aware, j_aware))
    assert all("AGE_CAP" in e
               for e in both(dict(n=100, suspicion_scale=1000.0)))


@pytest.mark.parametrize("cls_name", ["dense", "sparse"])
def test_convert_round_trips_membership_states(cls_name):
    """Both states through numpy and back, dtype for dtype: the narrow
    planes stay int8/int16 and the 0-d counters stay 0-d."""
    if cls_name == "dense":
        jcfg = jmem.MembershipConfig(n=16, fail_at=((3, 1),))
        st, cls = jmem.membership_init(jcfg), MembershipState
    else:
        jcfg, _ = CASES["k4-n64-overflow"].cfgs()
        st = jms.sparse_membership_init(jcfg)
        st = jax.jit(jms.sparse_membership_round, static_argnums=(2,))(
            st, jax.random.PRNGKey(0), jcfg)
        cls = SparseMembershipState
    ported = state_from_numpy(_np(st), state_cls=cls)
    back = state_to_numpy(ported)
    assert_state_equal(_np(st), back, cls)
    for name, t in zip(cls._fields, ported):
        assert t.dtype == getattr(torch, str(np.asarray(getattr(st, name))
                                             .dtype)), name
    if cls is SparseMembershipState:
        assert ported.confirms.dtype == torch.int8
        assert ported.suspect_since.dtype == torch.int16
        assert ported.overflow.dim() == 0 and ported.tick.dim() == 0


def test_run_membership_sparse_rejects_later_slice_knobs():
    cfg = SparseMembershipConfig(MembershipConfig(n=8), k_slots=4)
    for kw in ({"mesh": object()}, {"exchange": "ring"}, {"telemetry": True}):
        with pytest.raises(NotImplementedError):
            run_membership_sparse(cfg, 2, device="cpu", **kw)
