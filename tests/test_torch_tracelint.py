"""tracelint and the build guards of the port (``consul_tpu_torch/analysis``).

Each rule fires on a planted defect in torch idiom and stays silent on its
clean twin; the port's own simulation plane lints clean, with every
suppression stating its reason and the R2 suppressions exactly the host
reads PERF.md section 2 allows; the rule table and the CLI keep the
reference's ids and exit codes; the guards count the builds the port
caches.
"""

import functools
import re
import textwrap
from pathlib import Path

import pytest

from consul_tpu.analysis import tracelint as ref_tracelint
from consul_tpu_torch.analysis import guards, tracelint
from consul_tpu_torch.analysis.tracelint import (
    RULES,
    default_paths,
    lint_paths,
    lint_source,
)

from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rules(src: str) -> list:
    return [v.rule for v in lint_source(textwrap.dedent(src), "fix.py")]


HEADER = """
import random
import time
import functools
import numpy as np
import torch
from consul_tpu_torch.ops.sortmerge import host_cond
"""

# rule -> (bad fixture, clean twin)
FIXTURES = {
    "R1": ("""
def tick_round(state, x: torch.Tensor):
    if x.sum() > 0:
        x = x + 1
    return x
""", """
def tick_round(state, x: torch.Tensor, cfg: int):
    if x.dim() == 1 and cfg > 0:
        x = torch.where(x > 0, x + 1, x)
    return x
"""),
    "R2": ("""
def tick_round(state, x: torch.Tensor):
    n = int(x.sum())
    m = x.max().item()
    return x[:1] * n * m
""", """
def tick_round(state, x: torch.Tensor):
    n = x.numel()
    return x * n
"""),
    "R3": ("""
def make(n):
    a = torch.zeros(n)
    b = torch.arange(n, dtype=torch.int64)
    return a, b
""", """
def make(n):
    a = torch.zeros(n, dtype=torch.float32)
    b = torch.arange(n, dtype=torch.int32)
    return a, b
"""),
    "R4": ("""
def tick_round(state, x: torch.Tensor):
    noise = torch.rand(x.shape)
    t = time.time()
    return x + noise + t + random.random()
""", """
def tick_round(state, x: torch.Tensor, g: torch.Generator):
    return x + torch.rand(x.shape, generator=g)
"""),
    "R5": ("""
@functools.lru_cache(maxsize=None)
def _make(entry, knobs):
    return entry

def use():
    return _make("swim", [1, 2])
""", """
@functools.lru_cache(maxsize=None)
def _make(entry, knobs):
    return entry

def use():
    return _make("swim", (1, 2))
"""),
    "R6": ("""
def tick_round(state, x: torch.Tensor):
    alive = x > 0
    picked = x[alive]
    idx = torch.nonzero(x)
    return picked, idx, torch.where(alive)
""", """
def tick_round(state, x: torch.Tensor):
    alive = x > 0
    return torch.where(alive, x, 0), torch.sum(alive, dtype=torch.int32)
"""),
    "R7": ("""
def tick_round(state, x: torch.Tensor):
    total = x[0]
    for row in x:
        total = total + row
    return total
""", """
def tick_round(state, x: torch.Tensor, planes: tuple):
    total = x.sum(dim=0)
    for p in planes:
        total = total + p.sum()
    return total, tuple(p + 1 for p in planes)
"""),
    "R8": ("""
def tick_round(state, key: torch.Tensor):
    state.knows[0] = True
    state.tx_left.add_(1)
    return state
""", """
def tick_round(state, key: torch.Tensor):
    knows = state.knows.clone()
    knows[0] = True
    out = torch.empty_like(state.tx_left)
    out.copy_(state.tx_left + 1)
    return state._replace(knows=knows, tx_left=out)
"""),
    "R9": ("""
@functools.lru_cache(maxsize=None)
def _make(entry, U):
    return entry

def use():
    return _make("swim", U=4)
""", """
@functools.lru_cache(maxsize=None)
def _make(entry, U):
    return entry

def use():
    return _make("swim", 4)
"""),
}


def test_rule_ids_are_the_reference_s():
    assert sorted(RULES) == sorted(ref_tracelint.RULES)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fires_on_bad_fixture(rule):
    bad, _ = FIXTURES[rule]
    assert rule in _rules(HEADER + bad), _rules(HEADER + bad)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_silent_on_clean_fixture(rule):
    _, clean = FIXTURES[rule]
    assert _rules(HEADER + clean) == []


def test_violation_cites_file_line():
    src = HEADER + FIXTURES["R2"][0]
    (first, *_) = lint_source(textwrap.dedent(src), "fix.py")
    assert first.format().startswith("fix.py:")
    assert src.splitlines()[first.line - 1].strip().startswith("n = int(")


def test_suppression_needs_a_reason():
    bare = HEADER + """
def tick_round(state, x: torch.Tensor):
    return bool(x.any())  # tracelint: disable=R2
"""
    reasoned = bare.replace("disable=R2", "disable=R2 (the counted read)")
    assert _rules(bare) == ["R2"]
    assert _rules(reasoned) == []


def test_port_tree_lints_clean():
    violations = lint_paths(default_paths())
    assert violations == [], "\n".join(v.format() for v in violations)


def _suppressions():
    """(file, function, rules, reason) of every suppression in the
    simulation plane."""
    out = []
    for root in default_paths():
        for path in sorted(root.rglob("*.py")):
            fn = "<module>"
            for line in path.read_text().splitlines():
                m = re.match(r"def (\w+)", line)
                if m:
                    fn = m.group(1)
                if "tracelint: disable" in line:
                    s = re.search(
                        r"disable=([A-Z0-9,]+)\s*(\((.*)\)|--\s*(.*))", line)
                    out.append((path.relative_to(root.parent).as_posix(), fn,
                                s.group(1) if s else None,
                                (s.group(3) or s.group(4)) if s else None))
    return out


def test_every_suppression_states_its_reason():
    sups = _suppressions()
    assert sups
    assert all(rules and reason and reason.strip()
               for _, _, rules, reason in sups), sups


def test_r2_suppressions_are_the_allowed_syncs():
    """host_cond's own read and its callers PERF.md section 2 allows: the
    sparse model's claim (a lax.cond), the Knuth block predicate and the
    rejection loop, and poisson's branch."""
    r2 = sorted((f, fn) for f, fn, rules, _ in _suppressions()
                if rules and "R2" in rules.split(","))
    assert r2 == [
        ("models/membership_sparse.py", "_claim_one"),
        ("ops/sortmerge.py", "host_cond"),
        ("ops/threefry.py", "_poisson_knuth"),
        ("ops/threefry.py", "_poisson_rejection"),
        ("ops/threefry.py", "poisson"),
    ]


def test_declared_64bit_sites_have_reasons():
    for rel, sites in tracelint.DECLARED_64BIT.items():
        assert (Path(tracelint.__file__).parents[1] / rel).is_file(), rel
        assert all(why.strip() for why in sites.values()), rel
    assert tracelint.declared_64bit("x/ops/threefry.py", "split")
    assert tracelint.declared_64bit("x/models/vivaldi.py", "f") is None


def test_cli_exit_codes(tmp_path, capsys):
    from consul_tpu_torch.cli import main

    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(HEADER + FIXTURES["R1"][0]))
    clean = tmp_path / "clean.py"
    clean.write_text(textwrap.dedent(HEADER + FIXTURES["R1"][1]))
    assert main(["lint", str(bad)]) == 1
    assert "R1" in capsys.readouterr().out
    assert main(["lint", str(clean)]) == 0
    assert main(["lint", "--list-rules"]) == 0
    assert "R9" in capsys.readouterr().out
    assert main(["lint", "--format", "json", str(bad)]) == 1


# ---------------------------------------------------------------------------
# guards: the builds the port caches
# ---------------------------------------------------------------------------


def test_trace_guard_counts_cache_misses():
    calls = []

    def build(entry, u):
        calls.append((entry, u))
        return entry * u

    g = guards.trace_guard(build, max_traces=1)
    assert g("a", 2) == "aa" and g("a", 2) == "aa"
    assert g.traces == 1 and g.calls == 2
    with pytest.raises(guards.RetraceError):
        g("a", 3)


def test_guard_over_make_sweep():
    from consul_tpu_torch.sweep.universe import _make_sweep

    gs = guards.guard_entrypoints(max_traces=1)
    assert set(gs) == set(guards.ENGINE_ENTRYPOINTS)
    g = gs["sweep.universe._make_sweep"]
    _make_sweep("swim", 3, False, None, "alltoall")
    _make_sweep("swim", 3, False, None, "alltoall")
    assert g.traces <= 1
    guards.check_all(gs)
    _make_sweep("swim", 5, False, None, "alltoall")
    _make_sweep("swim", 6, False, None, "alltoall")
    with pytest.raises(guards.RetraceError):
        g.check()


def test_second_build_of_one_kernel_fails(monkeypatch):
    from consul_tpu_torch.ops import _build

    g = guards.TraceGuard(_build.load, max_traces=5, name="ops._build.load")
    monkeypatch.setitem(_build.compiles, "libring_exchange-x.so", 2)
    with pytest.raises(guards.RetraceError, match="built twice"):
        g.check()


def test_guard_refuses_an_uncached_callable():
    with pytest.raises(TypeError):
        guards.TraceGuard(lambda: None)


def test_wrapped_builder_keeps_its_name():
    @functools.lru_cache(maxsize=None)
    def make_thing(x):
        return x

    g = guards.TraceGuard(make_thing)
    assert g.name == "make_thing" and g(1) == 1
