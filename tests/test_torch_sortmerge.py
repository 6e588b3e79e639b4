"""ops/sortmerge.py: the sort-merge delivery against the JAX package.

Random sorted-row tables and arrival streams from numpy seeds (duplicate
groups, value ties, partial and full rows, eviction pressure) go through
the jitted reference and the port on the CPU; every output is bit-equal,
dtype included:

* ``row_locate``/``row_locate_lo``, ``sort_slot_rows``;
* ``merge_deliveries`` (the full-sort path), allocate on and off;
* ``merge_into_rows`` with ``amortize`` True and False, ``alloc_budget``
  None and small, eviction masks as arrays and as callables of the plane
  operands, ``rx`` accumulators, and the blocked huge-table branch with
  ``_BLOCK_ROWS`` lowered in both packages;
* ``insert_rows_one``;
* the group max that stands in for ``_segmented_max3``'s associative
  scan, at the last position of every group (the only one read).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import consul_tpu.ops.sortmerge as jsm
import consul_tpu_torch.ops.sortmerge as tsm

DEFAULTS = (0, -1, 0, 0)
PLANE_DTYPES = (np.int32, np.int16, np.int8, np.int8)


def make_rows(rng, n, K, fill):
    """Rows holding the sorted-row invariant: per row up to ``fill``
    distinct subjects ascending, empties (-1) last."""
    slot_subj = np.full((n, K), -1, np.int32)
    for i in range(n):
        k = int(rng.integers(1, fill + 1))
        subs = np.sort(rng.choice(n, size=min(k, n), replace=False))
        slot_subj[i, :len(subs)] = subs
    return slot_subj


def random_stream(rng, n, A, val_hi=12):
    recv = rng.integers(0, n, A).astype(np.int32)
    subj = rng.integers(0, n, A).astype(np.int32)
    val = rng.integers(0, val_hi, A).astype(np.int32)
    sus = rng.integers(-1, 6, A).astype(np.int32)
    ok = rng.random(A) < 0.75
    alloc = rng.random(A) < 0.6
    return recv, subj, val, sus, ok, alloc


def random_case(seed, val_hi=12, n=None, A=None):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 12)) if n is None else n
    K = int(rng.integers(2, 7))
    A = int(rng.integers(1, 150)) if A is None else A
    slot_subj = make_rows(rng, n, K, fill=K)
    evictable = (rng.random((n, K)) < 0.5) & (slot_subj >= 0)
    remembers = (rng.random((n, K)) < 0.5) & (slot_subj >= 0)
    planes = tuple(
        np.where(slot_subj < 0, d, rng.integers(1, 50, (n, K))).astype(dt)
        for dt, d in zip(PLANE_DTYPES, DEFAULTS))
    rx = tuple(
        np.where(rng.random((n, K)) < 0.5, rng.integers(0, hi, (n, K)), -1)
        .astype(np.int32) for hi in (90, 9))
    return dict(slot_subj=slot_subj, planes=planes,
                stream=random_stream(rng, n, A, val_hi), evictable=evictable,
                remembers=remembers, rx=rx)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def assert_same(want, got, msg=""):
    """Nested tuples of arrays/tensors equal leaf for leaf, dtype too."""
    if isinstance(want, (tuple, list)):
        assert len(want) == len(got), msg
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same(w, g, f"{msg}[{i}]")
        return
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert w.dtype == g.dtype, f"{msg}: {w.dtype} != {g.dtype}"
    np.testing.assert_array_equal(w, g, err_msg=msg)


# -- row primitives -----------------------------------------------------------


@pytest.mark.parametrize("K", [1, 2, 3, 5, 8, 48, 64])
def test_row_locate_matches_reference(K):
    rng = np.random.default_rng(K)
    n = 7
    slot_subj = make_rows(rng, n, K, fill=min(K, n))
    recv = rng.integers(0, n, 200).astype(np.int32)
    subj = rng.integers(0, n + 3, 200).astype(np.int32)
    want = jax.jit(jsm.row_locate_lo)(_j(slot_subj), _j(recv), _j(subj))
    got = tsm.row_locate_lo(_t(slot_subj), _t(recv), _t(subj))
    assert_same(want, got, f"row_locate_lo K={K}")
    assert_same(want[0], tsm.row_locate(_t(slot_subj), _t(recv), _t(subj)))


def test_row_locate_broadcasts():
    """[n, 1] receivers against [n, F] subjects, as ``_view_of`` calls it."""
    rng = np.random.default_rng(9)
    slot_subj = make_rows(rng, 6, 4, fill=4)
    recv = np.arange(6, dtype=np.int32)[:, None]
    subj = rng.integers(0, 6, (6, 3)).astype(np.int32)
    want = jsm.row_locate(_j(slot_subj), _j(recv), _j(subj))
    assert_same(want, tsm.row_locate(_t(slot_subj), _t(recv), _t(subj)))


def test_sort_slot_rows_matches_reference():
    rng = np.random.default_rng(2)
    n, K = 9, 6
    slot_subj = make_rows(rng, n, K, fill=K)
    plane = rng.integers(0, 100, (n, K)).astype(np.int32)
    plane[slot_subj < 0] = 0
    perm = rng.permutation(K)
    want = jax.jit(jsm.sort_slot_rows)(_j(slot_subj[:, perm]),
                                       _j(plane[:, perm]))
    got = tsm.sort_slot_rows(_t(slot_subj[:, perm]), _t(plane[:, perm]))
    assert_same(want, got)
    np.testing.assert_array_equal(got[0].numpy(), slot_subj)


# -- the segmented max --------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_group_max_at_last_position_matches_scan(seed):
    """Long groups, all-negative groups and -1 values: at each group's last
    position the port's group max equals the reference's segmented
    associative scan."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([rng.integers(1, 4, 30), [200, 1, 57]])
    rng.shuffle(lengths)
    flags = np.zeros(int(lengths.sum()), bool)
    flags[np.concatenate([[0], np.cumsum(lengths)[:-1]])] = True
    m = flags.size
    x = rng.integers(-1, 20, m).astype(np.int32)
    y = np.where(rng.random(m) < 0.7, -1, rng.integers(0, 9, m)).astype(
        np.int32)
    z = (rng.random(m) < 0.1).astype(np.int32)
    want = jax.jit(jsm._segmented_max3)(_j(flags), _j(x), _j(y), _j(z))
    got = tsm._segmented_max3(_t(flags), _t(x), _t(y), _t(z))
    last = np.roll(flags, -1)
    last[-1] = True
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w[last], g[last])


# -- the full-sort path -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _j_merge_deliveries(default_val, allocate):
    return jax.jit(functools.partial(jsm.merge_deliveries,
                                     default_val=default_val,
                                     allocate=allocate))


@pytest.mark.parametrize("allocate", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_merge_deliveries_matches_reference(seed, allocate):
    c = random_case(seed)
    stream = c["stream"]
    want = _j_merge_deliveries(0, allocate)(
        _j(c["slot_subj"]), *map(_j, stream),
        evictable=_j(c["evictable"]), remembers=_j(c["remembers"]))
    got = tsm.merge_deliveries(
        _t(c["slot_subj"]), *map(_t, stream),
        evictable=_t(c["evictable"]), remembers=_t(c["remembers"]),
        default_val=0, allocate=allocate)
    assert_same(want, got, f"seed {seed}")


# -- the amortized tick -------------------------------------------------------


def _j_mask(kind, arr):
    """A reference eviction mask as an array or as a callable of the plane
    operands (the model's form), sliced like the blocked branch slices."""
    if kind == "array":
        return _j(arr)

    def mask(ss, planes, start, rows):
        key = planes[0]
        if start is not None:
            key = jax.lax.dynamic_slice(key, (start, 0), (rows, key.shape[1]))
            ss = jax.lax.dynamic_slice(ss, (start, 0), (rows, ss.shape[1]))
        return (ss >= 0) & (key % 3 != 0)
    return mask


def _t_mask(kind, arr):
    if kind == "array":
        return _t(arr)

    def mask(ss, planes, start, rows):
        key = planes[0]
        if start is not None:
            key, ss = key[start:start + rows], ss[start:start + rows]
        return (ss >= 0) & (key % 3 != 0)
    return mask


def _merge_both(c, *, allocate=True, amortize=True, alloc_budget=None,
                masks="array", rx=False, sus="array"):
    """Run the jitted reference and the port's merge_into_rows on case
    ``c``; returns (want, got)."""
    recv, subj, val, susv, ok, alloc = c["stream"]
    kw = dict(default_val=0, allocate=allocate, alloc_budget=alloc_budget,
              amortize=amortize)

    def j_run(slot_subj, planes, recv, subj, val, susv, ok, alloc, rx_in):
        return jsm.merge_into_rows(
            slot_subj, planes, DEFAULTS, recv, subj, val,
            None if sus == "none" else susv, ok, alloc,
            evictable=_j_mask(masks, c["evictable"]),
            remembers=_j_mask(masks, c["remembers"]),
            rx=rx_in, **kw)

    want = jax.jit(j_run)(
        _j(c["slot_subj"]), tuple(map(_j, c["planes"])), _j(recv), _j(subj),
        _j(val), _j(susv), _j(ok), _j(alloc),
        tuple(map(_j, c["rx"])) if rx else None)
    got = tsm.merge_into_rows(
        _t(c["slot_subj"]), tuple(map(_t, c["planes"])), DEFAULTS,
        _t(recv), _t(subj), _t(val), None if sus == "none" else _t(susv),
        _t(ok), _t(alloc),
        evictable=_t_mask(masks, c["evictable"]),
        remembers=_t_mask(masks, c["remembers"]),
        rx=tuple(map(_t, c["rx"])) if rx else None, **kw)
    return want, got


@pytest.mark.parametrize("amortize", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_merge_into_rows_matches_reference(seed, amortize):
    c = random_case(seed)
    for allocate in (True, False):
        want, got = _merge_both(c, allocate=allocate, amortize=amortize)
        assert_same(want, got, f"seed {seed} allocate={allocate}")


@pytest.mark.parametrize("budget", [1, 5])
def test_merge_into_rows_small_alloc_budget(budget):
    """Budget pressure: allocation-worthy arrivals past the budget count
    into dropped, the same in both packages."""
    c = random_case(21, val_hi=30, A=200)
    want, got = _merge_both(c, alloc_budget=budget)
    assert_same(want, got, f"budget {budget}")
    assert int(got[4]) > 0


@pytest.mark.parametrize("seed", [5, 6])
def test_merge_into_rows_callable_masks_and_rx(seed):
    c = random_case(seed, val_hi=30)
    for rx in (False, True):
        for sus in ("array", "none"):
            want, got = _merge_both(c, masks="callable", rx=rx, sus=sus)
            assert_same(want, got, f"seed {seed} rx={rx} sus={sus}")


def test_merge_into_rows_blocked_branch(monkeypatch):
    """The huge-table branch, forced by lowering ``_BLOCK_ROWS`` in both
    packages: still equal to the reference, and to the unblocked port."""
    c = random_case(3, n=12)
    simple = _merge_both(c, masks="callable", rx=True)[1]
    monkeypatch.setattr(jsm, "_BLOCK_ROWS", 2)
    monkeypatch.setattr(tsm, "_BLOCK_ROWS", 2)
    assert tsm._row_blocks(12) == (6, 2)
    want, got = _merge_both(c, masks="callable", rx=True)
    assert_same(want, got, "blocked")
    assert_same(simple, got, "blocked vs unblocked")


def test_host_cond_counts_one_sync_per_amortized_call():
    c = random_case(0)
    before = tsm.host_cond.syncs
    _merge_both(c, amortize=True)
    assert tsm.host_cond.syncs == before + 1
    _merge_both(c, amortize=False)
    assert tsm.host_cond.syncs == before + 1


def test_seated_stream_takes_the_fast_branch():
    """Every subject seated (the K == n identity table): no allocation, the
    table is untouched and the rx planes are the raw scatter-max."""
    rng = np.random.default_rng(5)
    n = 9
    ident = np.broadcast_to(np.arange(n, dtype=np.int32)[None, :],
                            (n, n)).copy()
    planes = tuple(np.full((n, n), d, dt)
                   for dt, d in zip(PLANE_DTYPES, DEFAULTS))
    c = dict(slot_subj=ident, planes=planes,
             stream=random_stream(rng, n, 120),
             evictable=np.zeros((n, n), bool),
             remembers=np.zeros((n, n), bool), rx=None)
    want, got = _merge_both(c, allocate=False)
    assert_same(want, got)
    np.testing.assert_array_equal(got[0].numpy(), ident)


# -- the single-claim insertion ----------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_insert_rows_one_matches_reference(seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(2, 10))
    K = int(rng.integers(2, 7))
    slot_subj = make_rows(rng, n, K, fill=K)
    evictable = (rng.random((n, K)) < 0.4) & (slot_subj >= 0)
    remembers = (rng.random((n, K)) < 0.5) & (slot_subj >= 0)
    planes = tuple(
        np.where(slot_subj < 0, d, rng.integers(1, 50, (n, K))).astype(dt)
        for dt, d in zip(PLANE_DTYPES, DEFAULTS))
    want_mask = rng.random(n) < 0.6
    new_subj = np.zeros(n, np.int32)
    for i in range(n):
        absent = [x for x in range(n + K) if x not in set(slot_subj[i])]
        new_subj[i] = int(rng.choice(absent))
    want = jax.jit(functools.partial(jsm.insert_rows_one,
                                     defaults=DEFAULTS))(
        _j(slot_subj), tuple(map(_j, planes)), want=_j(want_mask),
        new_subj=_j(new_subj), evictable=_j(evictable),
        remembers=_j(remembers))
    got = tsm.insert_rows_one(
        _t(slot_subj), tuple(map(_t, planes)), DEFAULTS, _t(want_mask),
        _t(new_subj), evictable=_t(evictable), remembers=_t(remembers))
    assert_same(want, got, f"seed {seed}")
