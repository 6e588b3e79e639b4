"""The membership entrypoints of the sweep plane: dense ``[U, n, n]`` and
sparse ``[U, n, K]`` universes against the JAX package's ``make_sweep``
on the CPU (the membership rows of the reference's ``tests/test_sweep.py``
and its ``TestAmortizeEscapeHatch``).

Both packages run the same universes (keys, knob values and stacked
state carried over by ``convert``); every per-tick output and every leaf
of the final state must be equal, dtype included:

* U = 1 equals the port's plain scan and the reference's U = 1 sweep;
* U > 1 with ``loss`` and ``suspicion_scale`` varying (the traced
  timeout tables of both models) equals the reference's batched program,
  also on the sparse model's chunked delivery and row-blocked claim
  paths (forced by lowering their module constants in both packages);
* ``amortize``: an explicit True equals False bit for bit, the auto
  setting reads nothing on the host in a sweep and still amortizes a
  plain scan;
* one tick at U = 8 runs as many ATen ops as at U = 1;
* ``run_sweep`` gives the reference's metrics.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import consul_tpu.sweep.universe as JU
from consul_tpu.models.membership import MembershipConfig as JMembership
from consul_tpu.models.membership_sparse import (
    SparseMembershipConfig as JSparse,
)
from consul_tpu_torch.convert import universe_from_numpy
from consul_tpu_torch.models import MembershipConfig, SparseMembershipConfig
from consul_tpu_torch.ops import PRNGKey, host_cond
from consul_tpu_torch.protocol import PROFILES
from consul_tpu_torch.sim import engine, run_sweep
from consul_tpu_torch.sweep import Universe, make_sweep, stacked_init
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MEMB_KW = dict(n=48, loss=0.05, fail_at=((3, 2),))


def _cfgs(model, k_slots=8, amortize=None, **kw):
    kw = dict(MEMB_KW, **kw)
    if model == "membership":
        return JMembership(**kw), MembershipConfig(**kw)
    return (JSparse(base=JMembership(**kw), k_slots=k_slots,
                    amortize=amortize),
            SparseMembershipConfig(base=MembershipConfig(**kw),
                                   k_slots=k_slots, amortize=amortize))


def _port_leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [t.numpy() for t in x]


def _assert_leaves(want, got, what):
    assert len(want) == len(got), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype, f"{what} leaf {i}: {w.dtype} != {g.dtype}"
        np.testing.assert_array_equal(w, g, err_msg=f"{what} leaf {i}")


def sweep_both(model, jcfg, tcfg, steps, knobs=(), values=(), seeds=(5,),
               track=(3,), fresh=False):
    """One sweep in both packages from the reference's keys, knob arrays
    and stacked state: ``((j_final, j_outs), (t_final, t_outs))`` as numpy
    leaves.  ``fresh`` traces the reference anew (its module constants
    were patched)."""
    kw = dict(entrypoint=model, steps=steps, knobs=knobs, values=values,
              seeds=seeds, track=track)
    ju, tu = JU.Universe(cfg=jcfg, **kw), Universe(cfg=tcfg, **kw)
    j_state, j_keys, j_vals = JU.stacked_init(ju), ju.keys(), ju.knob_arrays()
    keys, vals, state = universe_from_numpy(
        np.asarray(j_keys), knobs, [np.asarray(v) for v in j_vals],
        jax.tree_util.tree_map(np.asarray, j_state))
    make = JU._make_sweep.__wrapped__ if fresh else JU._make_sweep
    j_final, j_outs = make(model, ju.U, False, None, "alltoall")(
        j_state, j_keys, j_vals, jcfg, steps, knobs, track)
    t_final, t_outs = make_sweep(model, tu.U)(state, keys, vals, tcfg,
                                              steps, knobs, track)
    leaves = jax.tree_util.tree_leaves
    return (([np.asarray(x) for x in leaves(j_final)],
             [np.asarray(x) for x in leaves(j_outs)]),
            (_port_leaves(t_final), _port_leaves(t_outs)))


def assert_sweeps_equal(*args, **kw):
    (jf, jo), (tf, to) = sweep_both(*args, **kw)
    _assert_leaves(jo, to, "per-tick outputs")
    _assert_leaves(jf, tf, "final state")
    return to, tf


@pytest.mark.parametrize("model, k_slots", [
    ("membership", 0), ("sparse", 8), ("sparse", 48)])
def test_u1_equals_plain_scan_and_reference(model, k_slots):
    """U = 1: the port's sweep equals its plain scan and the reference's
    U = 1 sweep (the sparse model at K < n and at K == n)."""
    jcfg, tcfg = _cfgs(model, k_slots)
    outs, final = assert_sweeps_equal(model, jcfg, tcfg, 12)
    init = stacked_init(Universe(entrypoint=model, cfg=tcfg, steps=12,
                                 seeds=(5,), track=(3,)), "cpu")
    scan = (engine.membership_scan if model == "membership"
            else engine.sparse_membership_scan)
    if model == "sparse":
        # The sweep resolves the auto amortize to False; the plain scan
        # amortizes, with the same results.
        tcfg = dataclasses.replace(tcfg, amortize=False)
    p_final, p_outs = scan(type(init)(*(x[0] for x in init)), PRNGKey(5),
                           tcfg, 12, (3,))
    _assert_leaves([x[0] for x in outs], _port_leaves(p_outs),
                   "U=1 outputs vs plain scan")
    _assert_leaves([x[0] for x in final], _port_leaves(p_final),
                   "U=1 final state vs plain scan")


KNOB_CASES = {
    # (model, k_slots, extra cfg, steps, knobs, values)
    "membership-lan": ("membership", 0, {}, 40,
                       ("loss", "suspicion_scale"),
                       ((0.0, 0.1, 0.3), (0.5, 1.0, 2.0))),
    "membership-wan": ("membership", 0, dict(profile=PROFILES["wan"]), 30,
                       ("suspicion_scale",), ((0.05, 0.3, 1.0),)),
    "sparse-lan": ("sparse", 8, {}, 40, ("base.loss", "base.suspicion_scale"),
                   ((0.0, 0.1, 0.3), (0.5, 1.0, 2.0))),
    "sparse-local": ("sparse", 8, dict(profile=PROFILES["local"]), 30,
                     ("base.suspicion_scale",), ((0.1, 0.5, 1.0),)),
    "sparse-k-eq-n": ("sparse", 48, {}, 24, ("base.loss",),
                      ((0.0, 0.2, 0.5),)),
}


@pytest.mark.parametrize("name", sorted(KNOB_CASES))
def test_knobs_match_reference(name):
    """U = 3 with the knobs varying (the traced timeout tables included)
    equals the reference's batched program, and the universes differ."""
    model, k_slots, extra, steps, knobs, values = KNOB_CASES[name]
    from consul_tpu.protocol.profiles import PROFILES as J_PROFILES

    jextra = {k: (J_PROFILES[[p for p, v in PROFILES.items() if v is w][0]]
                  if k == "profile" else w) for k, w in extra.items()}
    jcfg = _cfgs(model, k_slots, **jextra)[0]
    tcfg = _cfgs(model, k_slots, **extra)[1]
    outs, _ = assert_sweeps_equal(model, jcfg, tcfg, steps, knobs, values,
                                  seeds=(1, 2, 3))
    assert any(not np.array_equal(o[0], o[1]) or not np.array_equal(o[0],
                                                                     o[2])
               for o in outs), "every universe ran the same study"


@pytest.mark.parametrize("path", ["chunked", "row-blocked"])
def test_sparse_large_table_paths_match_reference(path, monkeypatch):
    """The chunked delivery (chunk count per universe) and the row-blocked
    merge and claim, forced at n=48 by lowering the module constants in
    both packages, over U = 2 universes with the loss varying."""
    import consul_tpu.models.membership_sparse as jms
    import consul_tpu.ops.sortmerge as jsm
    import consul_tpu_torch.models.membership_sparse as tms
    import consul_tpu_torch.ops.sortmerge as tsm

    if path == "chunked":
        for mod in (jms, tms):
            monkeypatch.setattr(mod, "_CHUNK_A", 64)
            monkeypatch.setattr(mod, "_CHUNK_TARGET", 200)
    else:
        for mod in (jsm, tsm):
            monkeypatch.setattr(mod, "_BLOCK_ROWS", 16)
    jcfg, tcfg = _cfgs("sparse", 8)
    assert_sweeps_equal("sparse", jcfg, tcfg, 14, ("base.loss",),
                        ((0.02, 0.3),), seeds=(1, 2), fresh=True)


def test_amortize_true_equals_false_in_a_sweep():
    """An explicit ``amortize=True`` is honoured in a sweep (its
    predicates read once a tick for all universes, at most 2 reads) and
    gives ``False``'s outputs bit for bit."""
    values = ((0.0, 0.1, 0.3),)
    runs = {}
    for amortize in (True, False):
        jcfg, tcfg = _cfgs("sparse", 8, amortize=amortize)
        before = host_cond.syncs
        runs[amortize] = assert_sweeps_equal(
            "sparse", jcfg, tcfg, 20, ("base.loss",), values,
            seeds=(1, 2, 3))
        runs[amortize, "syncs"] = host_cond.syncs - before
    for a, b in zip(runs[True][0] + runs[True][1],
                    runs[False][0] + runs[False][1]):
        np.testing.assert_array_equal(a, b)
    assert 0 < runs[True, "syncs"] <= 2 * 20
    assert runs[False, "syncs"] == 0


def test_auto_amortize_reads_nothing_in_a_sweep_and_amortizes_a_plain_scan():
    """``amortize=None`` resolves to False for a sweep (0 host reads a
    tick, at U = 1 too) and to True for a plain scan."""
    _, tcfg = _cfgs("sparse", 8)
    assert tcfg.amortize is None
    for U in (1, 4):
        uni = Universe(entrypoint="sparse", cfg=tcfg, steps=10,
                       seeds=tuple(range(U)), track=(3,))
        before = host_cond.syncs
        make_sweep("sparse", U)(stacked_init(uni, "cpu"), uni.keys("cpu"),
                                (), tcfg, 10, (), (3,))
        assert host_cond.syncs == before
    from consul_tpu_torch.models import sparse_membership_init

    before = host_cond.syncs
    engine.sparse_membership_scan(sparse_membership_init(tcfg, "cpu"),
                                  PRNGKey(0), tcfg, 10, (3,))
    assert host_cond.syncs > before


VIEW_OPS = frozenset(f"aten::{op}" for op in (
    "view", "_reshape_alias", "reshape", "as_strided", "slice", "narrow",
    "select", "expand", "unsqueeze", "squeeze", "alias", "detach", "unbind",
    "t", "transpose", "permute", "split", "unflatten", "flatten",
    "view_as", "expand_as", "_unsafe_view"))


def _aten_ops_one_tick(model, U):
    _, tcfg = _cfgs(model)
    uni = Universe(entrypoint=model, cfg=tcfg, steps=1,
                   seeds=tuple(range(U)), track=(3,))
    sweep = make_sweep(model, U)
    keys = uni.keys("cpu")
    sweep(stacked_init(uni, "cpu"), keys, (), tcfg, 1, (), (3,))
    state = stacked_init(uni, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sweep(state, keys, (), tcfg, 1, (), (3,))
    return sum(1 for e in prof.events()
               if e.name.startswith("aten::") and e.name not in VIEW_OPS)


@pytest.mark.parametrize("model", ["membership", "sparse"])
def test_tick_op_count_does_not_grow_with_u(model):
    """One membership tick at U = 8 runs as many ATen ops (views aside)
    as at U = 1: the universes are a tensor axis, not a loop."""
    ops1 = _aten_ops_one_tick(model, 1)
    ops8 = _aten_ops_one_tick(model, 8)
    assert ops1 > 0 and ops8 == ops1, (ops1, ops8)


@pytest.mark.parametrize("model", ["membership", "sparse"])
def test_run_sweep_report_matches_reference(model):
    """``run_sweep`` on the CPU gives the reference's metrics on the same
    universes, the loss varying."""
    from consul_tpu.sim.engine import run_sweep as j_run_sweep

    jcfg, tcfg = _cfgs(model)
    knob = "loss" if model == "membership" else "base.loss"
    kw = dict(entrypoint=model, steps=30, seeds=(1, 2, 3), track=(3,),
              knobs=(knob,), values=((0.0, 0.2, 0.4),))
    want = j_run_sweep(JU.Universe(cfg=jcfg, **kw), warmup=False)
    got = run_sweep(Universe(cfg=tcfg, **kw), warmup=False, device="cpu")
    assert sorted(want.metrics) == sorted(got.metrics)
    for name in want.metrics:
        np.testing.assert_array_equal(np.asarray(want.metrics[name]),
                                      np.asarray(got.metrics[name]),
                                      err_msg=name)
    assert got.summary()["universes"] == 3
