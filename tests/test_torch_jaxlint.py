"""jaxlint of the port: J1-J6 over the ATen graph of one tick.

Each rule fires on a planted defect (a tiny tick program in torch idiom)
and stays silent on its clean twin; the tick capture records what
``make_fx`` records; representative registry programs lint clean, with
J1's host reads a tick inside PERF.md section 2's budgets; the J6
estimate's arguments are the reference's input avals, byte for byte (the
threefry keys aside, int64 words where the reference holds uint32); the
registry-wide gates ride ``-m slow`` as the reference's do.
"""

import collections
import resource
from typing import NamedTuple

import pytest
import torch

from consul_tpu.sim.engine import jaxlint_registry as ref_registry
from consul_tpu_torch.analysis.jaxlint import (
    RULES,
    analyze_jaxpr,
    estimate_peak,
    lint_programs,
    sync_budget,
)
from consul_tpu_torch.ops import PRNGKey, ring_exchange_planes
from consul_tpu_torch.ops.sortmerge import host_cond
from consul_tpu_torch.sim.registry import SimProgram, jaxlint_registry

from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class St(NamedTuple):
    x: torch.Tensor
    tick: torch.Tensor


def program(name, tick, n=256, steps=4, devices=1, dtype=torch.float32):
    """A registry-shaped program: ``steps`` ticks of ``tick(state, key,
    t)`` from ``x = 0`` (``n`` values), one int32 output a tick."""

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

    return SimProgram(name=name, entrypoint="fixture",
                      build=lambda: (at_steps(steps), make_args), n=n,
                      devices=devices, steps=steps, at_steps=at_steps)


def rules_of(prog, **kw) -> list:
    findings, _ = lint_programs({prog.name: prog}, **kw)
    return [f.rule for f in findings]


def _next(state, x):
    return St(x, state.tick + 1)


def count(x) -> torch.Tensor:
    return torch.sum(x > 0, dtype=torch.int32)


BIG = torch.arange(1 << 19, dtype=torch.int32)      # 2 MiB
SMALL = torch.arange(8, dtype=torch.int32)

# rule -> (bad program, clean twin)


def _j1_bad(s, k, t):
    if host_cond(s.x.sum() > 0):
        s = _next(s, s.x + 1)
    return s, count(s.x)


def _j1_clean(s, k, t):
    return _next(s, torch.where(s.x.sum() > 0, s.x + 1, s.x)), count(s.x)


def _j2_bad(s, k, t):
    wide = s.x.to(torch.float64) * 2
    return _next(s, wide.to(torch.float32)), count(s.x)


def _j2_clean(s, k, t):
    return _next(s, s.x * 2), count(s.x)


def _j3_bad(s, k, t):
    new = s.x + 1
    late = s.x * 2          # the old plane read after its successor exists
    return _next(s, new), count(late)


def _j3_clean(s, k, t):
    early = s.x * 2
    return _next(s, s.x + 1), count(early)


def _j4_ring_tick(s, k, t):
    planes = [s.x.to(torch.int32).view(2, 2, -1)]
    (inbox,) = ring_exchange_planes(planes)
    return _next(s, inbox.reshape(-1).to(torch.float32)), count(s.x)


def _j4_slice_bad(s, k, t):
    per_shard = torch.sum(s.x.view(2, -1) > 0, dim=1, dtype=torch.int32)
    return _next(s, s.x + 1), per_shard[0]


def _j4_slice_clean(s, k, t):
    per_shard = torch.sum(s.x.view(2, -1) > 0, dim=1, dtype=torch.int32)
    return _next(s, s.x + 1), per_shard.sum(dtype=torch.int32)


def _j5_bad(s, k, t):
    return _next(s, s.x + BIG[:s.x.numel()].to(torch.float32)), count(s.x)


def _j5_clean(s, k, t):
    return (_next(s, s.x + SMALL.sum(dtype=torch.int32).to(torch.float32)),
            count(s.x))


FIXTURES = {
    "J1": (program("multidc@fx", _j1_bad), program("multidc@fx", _j1_clean)),
    "J2": (program("fx@bad", _j2_bad), program("fx@clean", _j2_clean)),
    "J3": (program("fx@bad", _j3_bad), program("fx@clean", _j3_clean)),
    "J4": (program("sharded_fx@small/D4", _j4_ring_tick, devices=4),
           program("sharded_fx@small/D2", _j4_ring_tick, devices=2)),
    "J5": (program("fx@bad", _j5_bad, n=1 << 19),
           program("fx@clean", _j5_clean, n=1 << 19)),
}
KW = {"J3": {"j3_bytes": 512}, "J6": {}}


def test_rule_ids_are_the_reference_s():
    from consul_tpu.analysis.jaxlint import RULES as REF

    assert sorted(RULES) == sorted(REF)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fires_on_bad_fixture(rule):
    bad, _ = FIXTURES[rule]
    assert rule in rules_of(bad, budget_gb=1.0, **KW.get(rule, {}))


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_silent_on_clean_fixture(rule):
    _, clean = FIXTURES[rule]
    assert rules_of(clean, budget_gb=1.0, **KW.get(rule, {})) == []


def test_j4_fires_on_one_shard_slice():
    bad = program("sharded_fx@small/D2", _j4_slice_bad, devices=2)
    clean = program("sharded_fx@small/D2", _j4_slice_clean, devices=2)
    assert "J4" in rules_of(bad, budget_gb=1.0)
    assert rules_of(clean, budget_gb=1.0) == []


def test_j1_fires_on_a_host_read_the_trace_cannot_hold():
    def tick(s, k, t):
        if s.x.sum().item() > 0:
            s = _next(s, s.x + 1)
        return s, count(s.x)

    findings, _ = lint_programs({"fx": program("fx", tick)}, budget_gb=1.0)
    assert [f.rule for f in findings] == ["J1"]
    assert "cannot be traced" in findings[0].message
    assert findings[0].where.startswith("tests/test_torch_jaxlint.py:")


def test_j6_fires_over_budget_and_not_under():
    prog = FIXTURES["J2"][1]
    assert "J6" in rules_of(prog, budget_gb=1e-6)
    assert "J6" not in rules_of(prog, budget_gb=1.0)


def test_j1_budgets_are_perf_md_s():
    assert sync_budget("sparse@1m") == 2
    assert sync_budget("sharded_sparse@small/D2/ring") == 2
    assert sync_budget("geo@small") == 2
    assert sync_budget("sweep_geo@small/U8") == 2
    assert sync_budget("sweep_sparse@100k/U8") == 0
    assert sync_budget("multidc@small") == 0
    assert sync_budget("swim@1m") == 0


# ---------------------------------------------------------------------------
# The capture and the J6 estimate
# ---------------------------------------------------------------------------


def test_capture_records_what_make_fx_records():
    """The tick capture is make_fx's sequence of ATen calls (the threefry
    block function held as one call)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    prog = jaxlint_registry(include=("small",))["swim@small"]
    gm = prog.trace()
    ours = [n.target for n in gm.graph.nodes if n.op == "call_function"
            and isinstance(n.target, torch._ops.OpOverload)]
    # make_fx of the same tick with the threefry block collapsed alike.
    from consul_tpu_torch.ops import threefry

    real = threefry.threefry2x32
    marker = []

    def block(k0, k1, x0, x1):
        marker.append(1)
        shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape,
                                       x1.shape)
        return (torch.empty(shape, dtype=torch.int64, device=k0.device),
                torch.empty(shape, dtype=torch.int64, device=k0.device))

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    _, make_args = prog.build()
    with fake:
        args = make_args(torch.device("cpu"))
    threefry.threefry2x32 = block
    try:
        ref = make_fx(prog.at_steps(1))(*args)
    finally:
        threefry.threefry2x32 = real
    theirs = [n.target for n in ref.graph.nodes if n.op == "call_function"
              and isinstance(n.target, torch._ops.OpOverload)
              and n.target is not torch.ops.aten.empty.memory_format]
    ours = [t for t in ours if t is not torch.ops.aten.empty.memory_format]
    # The same calls; make_fx may spell a reflected comparison (``a >= b``
    # as ``b <= a``) the other way round.
    flip = {"ge": "le", "gt": "lt"}

    def canon(ts):
        return collections.Counter(
            flip.get(t.overloadpacket.__name__, t.overloadpacket.__name__)
            for t in ts)

    assert marker and canon(ours) == canon(theirs)
    assert len(ours) == len(theirs)


def test_trace_allocates_nothing_at_10m():
    """sparse@10m traces on fake tensors: its graph, no storage."""
    prog = jaxlint_registry(include=("big",))["sparse@1m"].scale(10_000_000)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    gm = prog.trace("skipped")
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert grown < 1 << 20    # KiB: the [10M, 64] planes alone are 7.7 GB
    assert gm.tick.input_meta[0].shape == (10_000_000, 64)


def test_estimate_scales_with_steps_and_holds_the_successor():
    """steps = 1 vs 9: eight more rows of the per-tick output; from the
    second tick on the previous state beside the caller's, and the value
    the loop's local ``v`` still holds from the tick before."""
    one = program("fx@1", _j2_clean, steps=1).traces()
    nine = program("fx@9", _j2_clean, steps=9).traces()
    p1, p9 = estimate_peak(one), estimate_peak(nine)
    row = 512            # one int32 a tick, one allocator block
    successor = 1024 + 512   # x (256 float32) and tick, rounded
    carried = 512            # the int32 ``v``
    assert p9.total_bytes - p1.total_bytes == 8 * row + successor + carried
    assert p1.input_bytes == 1024 + 512 + 512   # x, tick, key


def test_estimate_counts_live_temporaries():
    def tick(s, k, t):
        a = s.x * 2          # 1 KiB
        b = a + 1            # 1 KiB, a still referenced
        c = (a + b) * 3      # the peak: a, b, a + b and c live
        return _next(s, c), count(c)

    prog = program("fx@tmp", tick, steps=1)
    rep = estimate_peak(prog.traces())
    assert rep.tick_bytes >= rep.input_bytes + 4 * 1024
    assert rep.at.startswith("tests/test_torch_jaxlint.py:")


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

REPRESENTATIVE = (
    "broadcast@small", "sparse@small", "geo@small", "multidc@small",
    "sharded_sparse@small/D2/ring", "sweep_sparse@small/U8xD2",
    "streamcast@small/telemetry",
)


@pytest.fixture(scope="module")
def small():
    return jaxlint_registry(include=("small",))


@pytest.fixture(scope="module")
def traced(small):
    return {name: small[name].traces() for name in REPRESENTATIVE}


@pytest.mark.parametrize("name", REPRESENTATIVE)
def test_representative_programs_lint_clean(name, small, traced):
    findings, peak = analyze_jaxpr(name, traced[name],
                                   budget_bytes=16 << 30,
                                   devices=small[name].devices)
    assert findings == [], "\n".join(f.format() for f in findings)
    assert peak.total_bytes > peak.input_bytes > 0


def test_host_reads_a_tick_within_budget(traced):
    reads = {name: max(len(gm.tick.syncs) for gm in graphs)
             for name, graphs in traced.items()}
    assert reads["sparse@small"] == 2            # the two lax.conds
    assert reads["sharded_sparse@small/D2/ring"] == 2
    assert 1 <= reads["geo@small"] <= 2          # the Knuth block test
    assert reads["multidc@small"] == 0
    assert reads["sweep_sparse@small/U8xD2"] == 0
    assert len(traced["sparse@small"]) == 2      # both branches traced


def test_ring_programs_hold_the_kernel_as_one_node(traced):
    (gm, *_) = traced["sharded_sparse@small/D2/ring"]
    rings = [n for n in gm.graph.nodes
             if str(n.target).startswith("consul_tpu_torch.ring_exchange")]
    assert len(rings) == 1
    shapes = [p.meta["out"][0].shape for p in rings[0].args[0]]
    assert all(s[:2] == (2, 2) for s in shapes)


@pytest.fixture(scope="module")
def ref_small():
    return ref_registry(include=("small",))


def _ref_input_bytes(spec) -> tuple:
    import jax

    leaves = jax.tree_util.tree_leaves(spec.build()[1])
    total = sum(int(x.size) * x.dtype.itemsize for x in leaves)
    keys = sum(int(x.size) for x in leaves if str(x.dtype) == "uint32"
               and x.shape[-1:] == (2,))
    return total, keys


@pytest.mark.parametrize("name", REPRESENTATIVE)
def test_input_bytes_equal_the_reference_s(name, traced, ref_small):
    """J6's arguments are the reference's input avals byte for byte, but
    the threefry keys: two uint32 words there, two int64 words here."""
    ref_total, key_words = _ref_input_bytes(ref_small[name])
    (gm, *_) = traced[name]
    ours = sum(m.nbytes for m in gm.tick.input_meta if m is not None)
    assert ours == ref_total + 4 * key_words


@pytest.mark.slow
class TestRegistryGate:
    """The registry-wide gates (the whole small set traces in about a
    minute here, the big one in half a minute)."""

    def test_small_registry_clean(self):
        findings, _ = lint_programs(jaxlint_registry(include=("small",)))
        assert findings == [], "\n".join(f.format() for f in findings)

    def test_big_registry_clean(self):
        findings, peaks = lint_programs(jaxlint_registry(include=("big",)))
        assert findings == [], "\n".join(f.format() for f in findings)
        assert peaks["sparse@10m"].chip_bytes > peaks["sparse@1m"].chip_bytes

    def test_every_input_equals_the_reference_s(self):
        ref = ref_registry(include=("small",))
        for name, spec in jaxlint_registry(include=("small",)).items():
            if "/ring" in name:
                continue  # the reference's Pallas ring does not trace here
            ref_total, key_words = _ref_input_bytes(ref[name])
            gm = spec.trace()
            ours = sum(m.nbytes for m in gm.tick.input_meta if m)
            assert ours == ref_total + 4 * key_words, name


def test_cli_jaxlint_module(tmp_path, capsys):
    from consul_tpu_torch.cli import main

    fixture = tmp_path / "fx.py"
    fixture.write_text(
        "from test_torch_jaxlint import FIXTURES\n"
        "JAXLINT_PROGRAMS = {'fx@bad': FIXTURES['J2'][0]}\n")
    assert main(["jaxlint", "--module", str(fixture)]) == 1
    assert "J2" in capsys.readouterr().out
    assert main(["jaxlint", "--list-rules"]) == 0
