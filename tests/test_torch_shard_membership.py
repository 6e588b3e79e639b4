"""parallel/shard.py: the sharded dense and sparse membership twins against
the JAX package's ``sharded_membership_scan`` and
``sharded_sparse_membership_scan``.

Tolerance: bit-equality with dtype, for every per-tick output and every
field of the final state.  The JAX twins run jitted under ``shard_map``
on the 8 virtual CPU devices of ``tests/conftest.py`` with
``exchange="alltoall"`` (its ring kernel does not run on the installed
jax); the port runs both transports on the CPU (the ring's plain
version), which must agree with each other and with the reference.

* the registry's small configs (``consul_tpu/sim/engine.py``: dense
  n=48, sparse K=8) at D in {1, 2, 4, 8}, sparse with amortize on and
  off, and a sparse case with overflow (K=4 under 23 crashes);
* D == 1 against the port's own unsharded scans;
* sparse at n=16384 over D=2, where each shard's gossip sender budget
  (2048 of 8192 rows) binds: more than 2048 rows of a shard hold a live
  message after two ticks and the deferrals count into ``overflow``;
* the sharded expiry-age table at LOCAL n=8 and n=100, where the dense
  and sparse references disagree by one tick (ROADMAP Queue 3): the
  sharded reference follows the sparse model's constant-folded table,
  and the dense model's table would give other outputs;
* ``run_membership(mesh=)`` and ``run_membership_sparse(mesh=)``.
"""

import jax
import numpy as np
import pytest
import torch

import consul_tpu_torch.models.membership_sparse as tms
from consul_tpu.models import membership as jmem
from consul_tpu.models import membership_sparse as jms
from consul_tpu.parallel import make_mesh as j_make_mesh
from consul_tpu.parallel.shard import sharded_membership_scan as j_dense
from consul_tpu.parallel.shard import (
    sharded_sparse_membership_scan as j_sparse,
)
from consul_tpu.protocol.profiles import PROFILES as J_PROFILES
from consul_tpu.sim.engine import run_membership as j_run_membership
from consul_tpu.sim.engine import run_membership_sparse as j_run_sparse
from consul_tpu_torch.convert import key_from_numpy
from consul_tpu_torch.models import (
    MembershipConfig,
    SparseMembershipConfig,
    membership_init,
    sparse_membership_init,
)
from consul_tpu_torch.models.swim import timeout_table
from consul_tpu_torch.ops import host_cond
from consul_tpu_torch.parallel import (
    make_mesh,
    sharded_membership_scan,
    sharded_sparse_membership_scan,
)
from consul_tpu_torch.protocol import PROFILES
from consul_tpu_torch.sim import (
    membership_scan,
    run_membership,
    run_membership_sparse,
    sparse_membership_scan,
)

EXCHANGES = ("alltoall", "ring")
# The registry's small configs (consul_tpu/sim/engine.py, "small").
SMALL = dict(n=48, loss=0.05, fail_at=((3, 2),))
STEPS = 8
TRACK = (3,)


def _cfgs(profile="lan", k=None, amortize=None, **kw):
    jb = jmem.MembershipConfig(profile=J_PROFILES[profile], **kw)
    tb = MembershipConfig(profile=PROFILES[profile], **kw)
    if k is None:
        return jb, tb
    return (jms.SparseMembershipConfig(jb, k_slots=k, amortize=amortize),
            SparseMembershipConfig(tb, k_slots=k, amortize=amortize))


def _keys(seed):
    key = jax.random.PRNGKey(seed)
    return key, key_from_numpy(np.asarray(key))


def _assert_equal(want, got, msg):
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype, f"{msg} {i}: {w.dtype} != {g.dtype}"
        np.testing.assert_array_equal(w, g, err_msg=f"{msg} {i}")


def _assert_state_equal(want, got, msg=""):
    for name in got._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.dtype == g.dtype, f"{msg} {name}: {w.dtype} != {g.dtype}"
        np.testing.assert_array_equal(w, g, err_msg=f"{msg} {name}")


def _dense_case(d, seed=9, steps=STEPS, **kw):
    jcfg, cfg = _cfgs(**(kw or SMALL))
    jkey, tkey = _keys(seed)
    want_f, want = j_dense(jmem.membership_init(jcfg), jkey, jcfg, steps,
                           j_make_mesh(jax.devices()[:d]), TRACK,
                           "alltoall")
    for exchange in EXCHANGES:
        got_f, got = sharded_membership_scan(
            membership_init(cfg, device="cpu"), tkey, cfg, steps,
            make_mesh(d, "cpu"), TRACK, exchange)
        _assert_equal(want, got, f"dense D={d} {exchange} output")
        _assert_state_equal(want_f, got_f, f"dense D={d} {exchange}")
    return want_f, want


def _sparse_case(d, k, seed=4, steps=STEPS, track=TRACK, amortize=None,
                 **kw):
    jcfg, cfg = _cfgs(k=k, amortize=amortize, **(kw or SMALL))
    jkey, tkey = _keys(seed)
    want_f, want = j_sparse(jms.sparse_membership_init(jcfg), jkey, jcfg,
                            steps, j_make_mesh(jax.devices()[:d]), track,
                            "alltoall")
    for exchange in EXCHANGES:
        syncs = host_cond.syncs
        got_f, got = sharded_sparse_membership_scan(
            sparse_membership_init(cfg, device="cpu"), tkey, cfg, steps,
            make_mesh(d, "cpu"), track, exchange)
        per_tick = (host_cond.syncs - syncs) / steps
        assert per_tick <= (0 if amortize is False else 2), per_tick
        _assert_equal(want, got, f"sparse D={d} {exchange} output")
        _assert_state_equal(want_f, got_f, f"sparse D={d} {exchange}")
    return want_f, want


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_dense_twin_matches_jax(d):
    _, outs = _dense_case(d)
    assert int(np.asarray(outs[-1])) == 0  # no outbox or initiator miss


def test_dense_twin_matches_jax_through_expiry():
    """60 ticks over 4 shards: suspicions of node 3 confirm, expire and
    spread DEAD through the outbox and the budgeted push/pull."""
    _, outs = _dense_case(4, steps=60)
    assert np.asarray(outs[1])[-1, 0] > 0


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sparse_twin_matches_jax(d):
    final, _ = _sparse_case(d, 8)
    assert int(final.overflow) == 0


@pytest.mark.parametrize("d", [2, 8])
def test_sparse_twin_matches_jax_amortize_off(d):
    """The allocation branch every tick and no host read: the same
    results as the amortized dispatch, which skips it for all shards."""
    _sparse_case(d, 8, amortize=False)


@pytest.mark.parametrize("amortize", [None, False])
def test_sparse_twin_matches_jax_with_overflow(amortize):
    """More concurrent crashes than four slots hold, over 4 shards."""
    final, _ = _sparse_case(4, 4, steps=30, amortize=amortize, n=64,
                            loss=0.0,
                            fail_at=tuple((i, 3) for i in range(1, 24)))
    assert int(final.overflow) > 0


def test_sparse_sender_budget_engaged():
    """n=16384 over 2 shards: 2048 sender slots for 8192 rows a shard.
    410 leavers start a wave that puts more than 2048 rows of each shard
    on the air by tick 2, so the budget defers senders into overflow."""
    n = 16384
    kw = dict(n=n, leave_at=tuple((i, 0) for i in range(0, n, 40)))
    assert tms.gossip_sender_budget(n // 2) == 2048
    _, cfg = _cfgs(k=8, **kw)
    st, _ = sharded_sparse_membership_scan(
        sparse_membership_init(cfg, device="cpu"), _keys(0)[1], cfg, 2,
        make_mesh(2, "cpu"))
    on_air = torch.any(st.tx > 0, dim=1).view(2, -1).sum(dim=1)
    assert bool((on_air > 2048).all()), on_air
    final, _ = _sparse_case(2, 8, seed=0, steps=4, track=(0,), **kw)
    assert int(final.overflow) > 0


@pytest.mark.parametrize("n,k", [(8, 4), (100, 8)])
def test_sharded_expiry_table_follows_the_sparse_reference(n, k,
                                                           monkeypatch):
    """LOCAL at n=8 and n=100: one confirmation expires at 30 / 60 ticks
    in the sparse model's constant-folded table and at 31 / 61 in the
    dense model's.  The sharded reference's DEAD curve (node 1 crashing
    at tick 2, loss 0.3, 2 shards) and the other outputs are the port's
    with the sparse table,
    and the dense table would move the outputs."""
    kw = dict(n=n, loss=0.3, fail_at=((1, 2),))
    steps = 80 if n == 8 else 120
    _, cfg = _cfgs("local", k=k, **kw)
    sparse_thr = tms.threshold_table(cfg.base).tolist()
    dense_thr = torch.ceil(timeout_table(cfg.base)).to(torch.int32).tolist()
    assert sparse_thr[0] == dense_thr[0]
    assert sparse_thr[1] + 1 == dense_thr[1] == {8: 31, 100: 61}[n]
    _, want = _sparse_case(2, k, seed=0, steps=steps, track=(1,),
                           profile="local", **kw)
    monkeypatch.setattr(
        tms, "threshold_table",
        lambda base: torch.tensor(dense_thr, dtype=tms.SINCE_DTYPE))
    _, dense_table = sharded_sparse_membership_scan(
        sparse_membership_init(cfg, device="cpu"), _keys(0)[1], cfg, steps,
        make_mesh(2, "cpu"), (1,))
    assert not all(np.array_equal(np.asarray(w), g.numpy())
                   for w, g in zip(want, dense_table))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_d1_equals_the_unsharded_scan(kind):
    _, tkey = _keys(7)
    mesh = make_mesh(1, "cpu")
    if kind == "dense":
        _, cfg = _cfgs(n=48, loss=0.1, fail_at=((3, 2), (30, 4)),
                       leave_at=((11, 5),))
        want_f, want = membership_scan(membership_init(cfg, device="cpu"),
                                       tkey, cfg, 40, TRACK)
        got_f, got = sharded_membership_scan(
            membership_init(cfg, device="cpu"), tkey, cfg, 40, mesh, TRACK,
            "ring")
        assert int(got[-1]) == 0
    else:
        _, cfg = _cfgs(k=8, n=48, loss=0.1, fail_at=((3, 2), (30, 4)),
                       leave_at=((11, 5),))
        want_f, want = sparse_membership_scan(
            sparse_membership_init(cfg, device="cpu"), tkey, cfg, 40, TRACK)
        got_f, got = sharded_sparse_membership_scan(
            sparse_membership_init(cfg, device="cpu"), tkey, cfg, 40, mesh,
            TRACK, "ring")
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype
        assert torch.equal(w, g), i
    for name, w, g in zip(want_f._fields, want_f, got_f):
        assert w.dtype == g.dtype and torch.equal(w, g), name


def test_sparse_twin_rejects_k_equals_n():
    _, cfg = _cfgs(k=16, n=16)
    with pytest.raises(ValueError, match="k_slots < n"):
        sharded_sparse_membership_scan(
            sparse_membership_init(cfg, device="cpu"), _keys(0)[1], cfg, 2,
            make_mesh(1, "cpu"))


FIELDS = ("suspecting", "dead_known", "suspect_cells", "known_members")


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_run_membership_with_mesh_matches_jax(kind):
    jmesh = j_make_mesh(jax.devices()[:2])
    if kind == "dense":
        jcfg, cfg = _cfgs(**SMALL)
        want = j_run_membership(jcfg, 30, seed=2, track=TRACK, mesh=jmesh,
                                warmup=False)
        got = run_membership(cfg, 30, seed=2, track=TRACK,
                             mesh=make_mesh(2, "cpu"), exchange="ring",
                             warmup=False)
        assert got.overflow == want.overflow == 0
    else:
        jcfg, cfg = _cfgs(k=8, **SMALL)
        want, want_ov = j_run_sparse(jcfg, 30, seed=2, track=TRACK,
                                     mesh=jmesh, warmup=False)
        got, got_ov = run_membership_sparse(
            cfg, 30, seed=2, track=TRACK, mesh=make_mesh(2, "cpu"),
            exchange="ring", warmup=False)
        assert got_ov == want_ov
    assert got.device == "cpu"
    for field in FIELDS:
        w, g = np.asarray(getattr(want, field)), getattr(got, field)
        assert w.dtype == g.dtype, field
        np.testing.assert_array_equal(w, g, err_msg=field)


@pytest.mark.parametrize("seed", range(3))
def test_merge_segments_equal_one_merge_per_shard(seed):
    """``merge_into_rows(alloc_segments=D)`` over D shards' streams (each on
    its own row block) equals D merges of the row blocks, each with its own
    allocation budget, which binds here (3 slots a shard)."""
    from consul_tpu_torch.ops import merge_into_rows, sort_slot_rows

    rng = np.random.default_rng(seed)
    n, K, d, a_seg, subjects = 8, 4, 2, 40, 16
    blk = n // d
    cols = np.stack([rng.permutation(subjects)[:K] for _ in range(n)])
    slot_subj = torch.from_numpy(
        np.where(rng.random((n, K)) < 0.6, cols, -1).astype(np.int32))
    key = torch.from_numpy(rng.integers(0, 12, (n, K)).astype(np.int32))
    slot_subj, key = sort_slot_rows(slot_subj, key)
    key = torch.where(slot_subj >= 0, key, 0)
    recv = torch.from_numpy(np.concatenate(
        [rng.integers(0, blk, a_seg) + s * blk for s in range(d)])
        .astype(np.int32))
    subj, val = (torch.from_numpy(rng.integers(0, hi, d * a_seg)
                                  .astype(np.int32))
                 for hi in (subjects, 12))
    ok, alloc = (torch.from_numpy(rng.random(d * a_seg) < p)
                 for p in (0.8, 0.7))
    evictable = (slot_subj >= 0) & (key == 0)
    remembers = (slot_subj >= 0) & (key != 0)

    def merge(rows, lo, hi, segments, budget=3):
        return merge_into_rows(
            slot_subj[rows], (key[rows],), (0,), recv[lo:hi] - rows.start,
            subj[lo:hi], val[lo:hi], None, ok[lo:hi], alloc[lo:hi],
            evictable=evictable[rows], remembers=remembers[rows],
            default_val=0, allocate=True, alloc_budget=budget,
            amortize=False, alloc_segments=segments)

    whole = merge(slice(0, n), 0, d * a_seg, d)
    parts = [merge(slice(s * blk, (s + 1) * blk), s * a_seg, (s + 1) * a_seg,
                   1) for s in range(d)]
    for got, want in ((whole[0], [p[0] for p in parts]),
                      (whole[1][0], [p[1][0] for p in parts]),
                      (whole[2], [p[2] for p in parts]),
                      (whole[3], [p[3] for p in parts])):
        assert torch.equal(got, torch.cat(want))
    for i in (4, 5):  # dropped, forgot
        assert int(whole[i]) == sum(int(p[i]) for p in parts)
    unbudgeted = merge(slice(0, n), 0, d * a_seg, d, budget=None)
    assert int(whole[4]) > int(unbudgeted[4]), "the budget must bind"
