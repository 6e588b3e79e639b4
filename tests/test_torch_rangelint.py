"""rangelint of the port: interval interpretation over one tick's graph.

The interval transfer functions against exact integer arithmetic; the
carry fixpoint and its trip-count widening; J7, J8 and J9 each fire on a
planted defect in torch idiom and stay silent on its clean twin; the
sparse@1m certificate table equals the reference's GOLDEN and the 10M
ledger is clean; for the small programs every plane the reference
certifies gets the same minimal dtype here (the planes whose interval
differs are printed: ``pytest -s``).

The reference's rangelint enters a ``pjit`` equation and the installed
JAX names it ``jit``, so the reference is read here through its own
pjit rule applied to ``jit`` (:func:`ref_analyze_spec`): without it every
certificate of the reference is its input bound.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from consul_tpu.analysis import rangelint as ref_rl
from consul_tpu.analysis.jaxlint import _sub_jaxprs
from consul_tpu.sim.engine import jaxlint_registry as ref_registry
from consul_tpu_torch.analysis import graph as g
from consul_tpu_torch.analysis.rangelint import (
    IV,
    RULES,
    Bound,
    _Interp,
    analyze_program,
    analyze_spec,
    minimal_signed_dtype,
    narrowing_ledger,
)
from consul_tpu_torch.ops import PRNGKey, fold_in, split, uniform
from consul_tpu_torch.sim.registry import SimProgram, jaxlint_registry

from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _ref_p_jit(self, frame, eqn, ins):
    """The reference's pjit rule (consul_tpu/analysis/rangelint.py
    eval_eqn) for the installed JAX's ``jit`` equation."""
    _, sub, consts = _sub_jaxprs(eqn)[0]
    outs, child = self.eval_jaxpr(sub, consts, ins[:len(sub.invars)])
    frame.children.append((eqn, child))
    outs = outs[:len(eqn.outvars)]
    outs += [ref_rl.AV(ref_rl._top(o)) for o in eqn.outvars[len(outs):]]
    return [ref_rl.AV(self._settle(None, av.iv, o), av.origin, av.token)
            for av, o in zip(outs, eqn.outvars)]


@pytest.fixture(scope="module")
def ref_analyze_spec():
    had = getattr(ref_rl._Interp, "_p_jit", None)
    ref_rl._Interp._p_jit = _ref_p_jit
    yield ref_rl.analyze_spec
    if had is None:
        del ref_rl._Interp._p_jit
    else:
        ref_rl._Interp._p_jit = had


# ---------------------------------------------------------------------------
# Transfer functions against exact arithmetic
# ---------------------------------------------------------------------------


def _out_iv(fn, shapes, bounds, dtype=torch.int32) -> IV:
    """The interval the interpreter gives ``fn``'s output for inputs in
    ``bounds``."""
    def make_args(device):
        return tuple(torch.zeros(s, dtype=dtype, device=device)
                     for s in shapes)

    gm = g.capture("t", lambda *a: (fn(*a),), make_args, 1)
    interp = _Interp("t", frozenset(RULES))
    interp.constants = gm.tick.constants
    env = interp.run(gm, [IV(lo, hi, True) for lo, hi in bounds])
    return env[g.output_nodes(gm)[0]]


class TestTransfer:
    OPS = {
        "add": (lambda a, b: a + b, lambda a, b: a + b),
        "sub": (lambda a, b: a - b, lambda a, b: a - b),
        "mul": (lambda a, b: a * b, lambda a, b: a * b),
        "min": (torch.minimum, np.minimum),
        "max": (torch.maximum, np.maximum),
        "rem": (torch.remainder, np.mod),
        "floordiv": (lambda a, b: torch.div(a, b, rounding_mode="floor"),
                     np.floor_divide),
    }
    RANGES = [(-7, 13), (0, 5), (3, 40), (-20, -2)]

    @pytest.mark.parametrize("op", sorted(OPS))
    def test_contains_every_concrete_result(self, op):
        fn, ref = self.OPS[op]
        for alo, ahi in self.RANGES:
            for blo, bhi in self.RANGES:
                if op in ("rem", "floordiv") and blo <= 0:
                    continue
                iv = _out_iv(fn, ((), ()), [(alo, ahi), (blo, bhi)])
                a = np.arange(alo, ahi + 1)[:, None]
                b = np.arange(blo, bhi + 1)[None, :]
                got = ref(a, b)
                assert iv.known and iv.lo <= got.min() and \
                    got.max() <= iv.hi, (op, (alo, ahi), (blo, bhi), iv)

    def test_sum_scales_by_count(self):
        iv = _out_iv(lambda x: torch.sum(x, dtype=torch.int32), ((10,),),
                     [(0, 3)])
        assert (iv.lo, iv.hi, iv.known) == (0, 30, True)

    def test_iota_and_shift(self):
        iv = _out_iv(lambda x: (torch.arange(16, dtype=torch.int32) << 2)
                     + x, ((16,),), [(0, 1)])
        assert (iv.lo, iv.hi) == (0, 61)

    def test_floor_mod_in_divisor_range(self):
        iv = _out_iv(lambda x: x % 7, ((4,),), [(-100, 100)])
        assert (iv.lo, iv.hi) == (0, 6)

    def test_decided_where_takes_one_side(self):
        iv = _out_iv(lambda x: torch.where(x >= 0, x, x - 1000), ((4,),),
                     [(0, 9)])
        assert (iv.lo, iv.hi) == (0, 9)

    def test_low_bits_mask_keeps_the_interval(self):
        iv = _out_iv(lambda x: (x.to(torch.int64) & 0xFFFFFFFF)
                     .to(torch.int32), ((4,),), [(3, 90)])
        assert (iv.lo, iv.hi) == (3, 90)

    def test_minimal_signed_dtype(self):
        assert minimal_signed_dtype(-1, 127) == "int8"
        assert minimal_signed_dtype(0, 128) == "int16"
        assert minimal_signed_dtype(0, 2 ** 31) is None


# ---------------------------------------------------------------------------
# The fixpoint, and J7-J9 on planted defects
# ---------------------------------------------------------------------------


class St(NamedTuple):
    c: torch.Tensor
    tick: torch.Tensor


def program(name, tick, steps=8, dtype=torch.int32, n=16):
    def make_args(device):
        return (St(torch.zeros(n, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device)),
                PRNGKey(0, device=device))

    def at_steps(t):
        def fn(state, key):
            out = torch.empty(t, dtype=torch.int32, device=key.device)
            for i in range(t):
                state, v = tick(state, key, i)
                out[i] = v
            return state, (out,)
        return fn

    return SimProgram(
        name=name, entrypoint="fixture", n=n, steps=steps,
        build=lambda: (at_steps(steps), make_args), at_steps=at_steps,
        bounds=lambda: (St(Bound(0, 0), Bound(0, 0)), Bound.any()))


def plane(rep, name):
    return {c.plane: c for c in rep.certificates}[name]


def test_counter_widens_over_the_trip_count():
    def tick(s, k, t):
        return St(s.c + 1, s.tick + 1), torch.sum(s.c, dtype=torch.int32)

    rep = analyze_spec("fx", program("fx", tick, steps=30))
    tick_cert = plane(rep, "[0].tick")
    assert tick_cert.lo == 0 and 30 <= tick_cert.hi <= 31
    assert tick_cert.minimal == "int8"


def test_clamped_plane_converges():
    def tick(s, k, t):
        return (St(torch.clamp(s.c + 3, max=10), s.tick + 1),
                torch.sum(s.c, dtype=torch.int32))

    c = plane(analyze_spec("fx", program("fx", tick, steps=10 ** 6)),
              "[0].c")
    assert (c.lo, c.hi, c.minimal) == (0, 10, "int8")


def _j7_bad(s, k, t):
    return (St((s.c + 100).clamp(max=100) + 100, s.tick + 1),
            torch.sum(s.c > 0, dtype=torch.int32))


def _j7_clean(s, k, t):
    return (St(torch.clamp(s.c, max=27) + 100, s.tick + 1),
            torch.sum(s.c > 0, dtype=torch.int32))


def _j8_draw_twice(s, k, t):
    kt = fold_in(k, t)
    a = uniform(kt, (16,))
    b = uniform(kt, (16,))
    return St(s.c, s.tick + 1), torch.sum(a < b, dtype=torch.int32)


def _j8_split_twice(s, k, t):
    kt = fold_in(k, t)
    a, b = split(kt).unbind(-2)
    c, d = split(kt).unbind(-2)
    x = uniform(a, (16,)) < uniform(c, (16,))
    return St(s.c, s.tick + 1), torch.sum(x, dtype=torch.int32)


def _j8_scan_key(s, k, t):
    a = uniform(k, (16,))
    return St(s.c, s.tick + 1), torch.sum(a < 0.5, dtype=torch.int32)


def _j8_clean(s, k, t):
    kt = fold_in(k, t)
    a, b = split(kt).unbind(-2)
    x = uniform(a, (16,)) < uniform(b, (16,))
    y = uniform(fold_in(kt, 7), (16,)) < 0.5
    return St(s.c, s.tick + 1), torch.sum(x & y, dtype=torch.int32)


def _drop(s, k, t, counted: bool):
    ok = uniform(fold_in(k, t), (16,)) < 0.5
    tgt = torch.arange(16, dtype=torch.int64)
    flat = torch.where(ok, tgt, 16)
    hits = torch.zeros(17, dtype=torch.int32)
    hits.index_put_((flat,), torch.ones(16, dtype=torch.int32),
                    accumulate=True)
    c = s.c + hits[:16]
    lost = torch.sum(~ok, dtype=torch.int32) if counted else \
        torch.sum(c, dtype=torch.int32)
    return St(c, s.tick + 1), lost


FIXTURES = {
    "J7": (program("fx", _j7_bad, dtype=torch.int8),
           program("fx", _j7_clean, dtype=torch.int8)),
    "J8": (program("fx", _j8_draw_twice), program("fx", _j8_clean)),
    "J9": (program("fx", lambda s, k, t: _drop(s, k, t, False)),
           program("fx", lambda s, k, t: _drop(s, k, t, True))),
}


def test_rule_ids_are_the_reference_s():
    assert sorted(RULES) == sorted(ref_rl.RULES)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fires_on_bad_fixture(rule):
    rep = analyze_spec("fx", FIXTURES[rule][0])
    assert rule in [f.rule for f in rep.findings], rep.findings
    assert all(f.where.startswith("tests/test_torch_rangelint.py:")
               for f in rep.findings if f.rule == rule)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_silent_on_clean_fixture(rule):
    assert analyze_spec("fx", FIXTURES[rule][1]).findings == []


@pytest.mark.parametrize("tick", [_j8_split_twice, _j8_scan_key])
def test_j8_other_lineage_defects(tick):
    rep = analyze_spec("fx", program("fx", tick))
    assert [f.rule for f in rep.findings] == ["J8"]


def test_bounds_congruent_for_every_small_program():
    import torch.utils._pytree as pytree

    for name, spec in jaxlint_registry(include=("small",)).items():
        if spec.bounds is None:
            continue
        _, make_args = spec.build()
        with torch.device("meta"):
            args = make_args(torch.device("meta"))
        leaves = pytree.tree_leaves(
            spec.bounds(), is_leaf=lambda x: isinstance(x, Bound))
        assert len(leaves) == len(pytree.tree_leaves(args)), name


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def big():
    return jaxlint_registry(include=("big",))


@pytest.fixture(scope="module")
def sparse_1m_report(big):
    return analyze_spec("sparse@1m", big["sparse@1m"])


def test_sparse_1m_table_equals_the_reference_golden(sparse_1m_report):
    """tests/test_rangelint.py:465-483's GOLDEN: plane, declared dtype, lo,
    hi <= hi_max and the proven minimal dtype."""
    import test_rangelint

    golden = test_rangelint.TestGoldenSparse1M.GOLDEN
    by_plane = {c.plane: c for c in sparse_1m_report.certificates}
    for name, (dtype, lo, hi_max, minimal) in golden.items():
        c = by_plane[name]
        assert (c.dtype, c.lo, c.minimal) == (dtype, lo, minimal), c
        assert c.hi <= hi_max, c
    assert sparse_1m_report.findings == []


@pytest.mark.slow
def test_ledger_at_10m_clean_and_priced(big):
    """tests/test_rangelint.py:507-520 at 10M nodes (chip_smoke.py phase
    14 reads it too)."""
    led = narrowing_ledger(big["sparse@1m"], 10_000_000)
    assert led.findings == [], "\n".join(f.format() for f in led.findings)
    by_plane = {c.plane: c for c in led.certificates}
    assert by_plane["[0].tx"].minimal == "int8"
    assert by_plane["[0].confirms"].minimal == "int8"
    assert np.iinfo("int8").max >= by_plane["[0].awareness"].hi
    assert by_plane["[0].suspect_since"].lo >= -1
    assert np.iinfo("int16").max > by_plane["[0].suspect_since"].hi
    assert by_plane["[0].tx"].elements == 10_000_000 * 64


def _compare(name, ours, ref) -> tuple:
    """(planes whose minimal dtype differs, planes whose interval does)."""
    mine = {c.plane: c for c in ours.certificates}
    theirs = {c.plane: c for c in ref.certificates}
    minimal = [(p, theirs[p].minimal, mine[p].minimal if p in mine else None)
               for p in sorted(theirs)
               if p not in mine or mine[p].minimal != theirs[p].minimal]
    interval = [(p, (theirs[p].lo, theirs[p].hi), (mine[p].lo, mine[p].hi))
                for p in sorted(set(theirs) & set(mine))
                if (mine[p].lo, mine[p].hi) != (theirs[p].lo, theirs[p].hi)]
    return minimal, interval


FAMILIES = ("broadcast@small", "membership@small", "sparse@small",
            "swim@small", "lifeguard@small", "multidc@small",
            "streamcast@small", "geo@small")


@pytest.mark.parametrize("name", FAMILIES)
def test_minimal_dtypes_equal_the_reference_s(name, ref_analyze_spec):
    ref = ref_analyze_spec(name, ref_registry(include=("small",))[name])
    ours = analyze_spec(name, jaxlint_registry(include=("small",))[name])
    minimal, interval = _compare(name, ours, ref)
    assert minimal == [], minimal
    for p, theirs, mine in interval:
        print(f"{name} {p}: reference {theirs}, port {mine}")


@pytest.mark.slow
def test_every_small_program_against_the_reference(ref_analyze_spec):
    ref = ref_registry(include=("small",))
    bad = {}
    for name, spec in jaxlint_registry(include=("small",)).items():
        if "/ring" in name:
            continue  # the reference's Pallas ring does not trace here
        minimal, _ = _compare(name, analyze_spec(name, spec),
                              ref_analyze_spec(name, ref[name]))
        if minimal:
            bad[name] = minimal
    assert bad == {}, bad


def test_analyze_program_takes_flat_bounds():
    def make_args(device):
        return (torch.zeros(4, dtype=torch.int32, device=device),)

    gm = g.capture("t", lambda x: (x + 1,), make_args, 1)
    rep = analyze_program("t", gm, bounds=[Bound(0, 5)])
    (cert,) = rep.certificates
    assert rep.findings == [] and (cert.plane, cert.lo) == ("[0]", 0)
    assert cert.minimal == "int8" and cert.saved_bytes == 12


def test_cli_rangelint_lists_rules(capsys):
    from consul_tpu_torch.cli import main

    assert main(["rangelint", "--list-rules"]) == 0
    assert "J9" in capsys.readouterr().out
