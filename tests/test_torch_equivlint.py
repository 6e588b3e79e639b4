"""equivlint of the port: the ladder's proofs and witnesses, the golden
fingerprints of the port's registry, and the DMA discipline of the CUDA
kernels (P1-P3), each rule on a planted defect and its clean twin.
"""

import copy
import json
import textwrap

import pytest
import torch

from consul_tpu.analysis import equivlint as ref_el
from consul_tpu_torch.analysis import equivlint as el
from consul_tpu_torch.analysis import graph as g
from consul_tpu_torch.sim.registry import EQUIV_PAIRS, jaxlint_registry

from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _trace(fn, *shapes):
    def make_args(device):
        return tuple(torch.zeros(s, dtype=torch.int32, device=device)
                     for s in shapes)
    return g.capture("t", lambda *a: (fn(*a),), make_args, 1)


def test_rule_ids_are_the_reference_s():
    assert list(el.EQUIV_RULES) == list(ref_el.EQUIV_RULES)


# ---------------------------------------------------------------------------
# The canonical form
# ---------------------------------------------------------------------------


def test_canonical_form_is_blind_to_spelling():
    a = _trace(lambda x, y: (x + y) * 2, (4,), (4,))
    b = _trace(lambda x, y: (y + x) * 2, (4,), (4,))
    dead = _trace(lambda x, y: ((x - y) * 7, (x + y) * 2)[1], (4,), (4,))
    assert el.canonicalize(a) == el.canonicalize(b) == el.canonicalize(dead)
    assert el.canonical_hash(a) == el.canonical_hash(b)


def test_canonical_form_sees_the_program():
    a = _trace(lambda x, y: (x + y) * 2, (4,), (4,))
    c = _trace(lambda x, y: (x - y) * 2, (4,), (4,))
    d = _trace(lambda x, y: (x + y) * 3, (4,), (4,))
    e = _trace(lambda x, y: (x + y) * 2, (5,), (5,))
    hashes = {el.canonical_hash(t) for t in (a, c, d, e)}
    assert len(hashes) == 4


def test_constants_by_content():
    k1 = torch.arange(4, dtype=torch.int32)
    k2 = torch.arange(4, dtype=torch.int32)
    k3 = torch.arange(4, dtype=torch.int32) + 1
    a = _trace(lambda x: x + k1, (4,))
    b = _trace(lambda x: x + k2, (4,))
    c = _trace(lambda x: x + k3, (4,))
    assert el.canonicalize(a) == el.canonicalize(b) != el.canonicalize(c)


# ---------------------------------------------------------------------------
# E1 over the ladder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    return jaxlint_registry(include=("small",))


@pytest.fixture(scope="module")
def verdicts(small):
    return el.prove_pairs(small, witness_device="cpu")


def test_every_rung_proved_or_witnessed(verdicts):
    assert len(verdicts) == len(EQUIV_PAIRS) == 22
    bad = [v.format() for v in verdicts
           if v.verdict not in ("PROVED", "WITNESSED")]
    assert bad == []


def test_explicit_default_rungs_are_proved(verdicts):
    proved = {v.pair for v in verdicts if v.verdict == "PROVED"}
    assert {"streamcast@small/uniform ~ streamcast@small",
            "broadcast@small/notelemetry ~ broadcast@small",
            "sparse@small/amortize ~ sparse@small"} <= proved


def test_rungs_the_reference_proves_hold_here(verdicts):
    """Every rung the reference PROVES (structurally, no witness) is
    PROVED or WITNESSED in the port."""
    from consul_tpu.sim.engine import EQUIV_PAIRS as REF_PAIRS
    from consul_tpu.sim.engine import jaxlint_registry as ref_registry

    ref_small = ref_registry(include=("small",))
    pairs = [p for p in REF_PAIRS if "/ring" not in p.a + p.b]
    ref = ref_el.prove_pairs(ref_small, pairs=pairs, witness=False)
    ref_proved = {v.pair for v in ref if v.verdict == "PROVED"}
    assert ref_proved
    ours = {v.pair: v.verdict for v in verdicts}
    assert all(ours[p] in ("PROVED", "WITNESSED") for p in ref_proved)


def test_a_broken_rung_fails(small):
    """A rung between two different programs is FAILED, never silent."""
    from consul_tpu_torch.sim.registry import EquivPair

    pair = EquivPair("swim@small", "lifeguard@small", relation="bogus",
                     family="swim")
    (v,) = el.prove_pairs(small, pairs=(pair,), witness_device="cpu")
    assert v.verdict == "FAILED"
    res = el.run_equivlint({k: small[k] for k in ("swim@small",
                                                  "lifeguard@small")},
                           pairs=(pair,), witness_device="cpu",
                           subset=True)
    assert [f.rule for f in res["findings"]] == ["E1"]


def test_witnesses_skip_without_a_card_unless_asked(small):
    pairs = tuple(p for p in EQUIV_PAIRS if p.a == "broadcast@small/telemetry")
    if torch.cuda.is_available():
        pytest.skip("a card is present: witnesses run there")
    (v,) = el.prove_pairs(small, pairs=pairs)
    assert v.verdict == "SKIPPED"


# ---------------------------------------------------------------------------
# E2/E3: the golden gate
# ---------------------------------------------------------------------------

GOLDEN_SAMPLE = ("broadcast@small", "sparse@small", "geo@small",
                 "sharded_sparse@small/D2/ring", "sweep_swim@small/U8")


@pytest.fixture(scope="module")
def live(small):
    return el.fingerprint_registry({k: small[k] for k in GOLDEN_SAMPLE})


def test_golden_covers_the_live_programs(live):
    assert el.diff_golden(live, subset=True) == []


def test_golden_names_the_whole_registry():
    gold = el.load_golden()["programs"]
    names = set(jaxlint_registry(include=("small", "big")))
    assert set(gold) == names


def test_e2_fires_when_a_program_changes(live):
    gold = copy.deepcopy(el.load_golden())
    name = "sparse@small"
    gold["programs"][name]["hash"] = "0" * 64
    gold["programs"][name]["eqns"] += 1
    found = el.diff_golden(live, gold, subset=True)
    assert [(f.program, f.rule) for f in found] == [(name, "E2")]
    assert "nodes" in found[0].message


def test_e3_fires_on_coverage_holes(live):
    gold = copy.deepcopy(el.load_golden())
    del gold["programs"]["geo@small"]
    gold["programs"]["ghost@small"] = gold["programs"]["sparse@small"]
    found = el.diff_golden(live, gold)
    got = {(f.program, f.rule) for f in found}
    assert ("geo@small", "E3") in got and ("ghost@small", "E3") in got


def test_update_golden_round_trip(tmp_path, live):
    path = tmp_path / "golden.json"
    el.write_golden({"sparse@small": live["sparse@small"]}, path=str(path))
    el.write_golden({"geo@small": live["geo@small"]}, path=str(path))
    doc = json.loads(path.read_text())
    assert set(doc["programs"]) == {"sparse@small", "geo@small"}
    assert el.diff_golden({"geo@small": live["geo@small"]},
                          el.load_golden(str(path)), subset=True) == []


# ---------------------------------------------------------------------------
# P1-P3 over CUDA sources
# ---------------------------------------------------------------------------

KERNELS = {
    "P1": ("""
__global__ void k(const int* src, int* dst) {
    __shared__ int stage[2][256];
    __pipeline_memcpy_async(&stage[0][threadIdx.x], &src[threadIdx.x], 4);
    __pipeline_commit();
    dst[threadIdx.x] = 0;
}
""", """
__global__ void k(const int* src, int* dst) {
    __shared__ int stage[2][256];
    __pipeline_memcpy_async(&stage[0][threadIdx.x], &src[threadIdx.x], 4);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    dst[threadIdx.x] = stage[0][threadIdx.x];
}
"""),
    "P2": ("""
__global__ void k(const int* src, int* dst) {
    __shared__ int stage[256];
    __pipeline_memcpy_async(&stage[threadIdx.x], &src[threadIdx.x], 4);
    __pipeline_commit();
    dst[threadIdx.x] = stage[threadIdx.x];
    __pipeline_wait_prior(0);
}
""", """
__global__ void k(const int* src, int* dst) {
    __shared__ int stage[256];
    __pipeline_memcpy_async(&stage[threadIdx.x], &src[threadIdx.x], 4);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    dst[threadIdx.x] = stage[threadIdx.x];
}
"""),
    "P3": ("""
__global__ void k(const CUtensorMap* map, int* dst) {
    __shared__ uint64_t bar;
    __shared__ int tile[256];
    asm volatile("mbarrier.init.shared.b64 [%0], 1;" :: "r"(0));
    asm volatile("cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];" :: "r"(0), "l"(map), "r"(0), "r"(0));
    asm volatile("mbarrier.try_wait.parity.shared.b64 p, [%0], 0;" :: "r"(0));
    dst[threadIdx.x] = tile[threadIdx.x];
}
""", """
__global__ void k(const CUtensorMap* map, int* dst) {
    __shared__ uint64_t bar;
    __shared__ int tile[256];
    asm volatile("mbarrier.init.shared.b64 [%0], 1;" :: "r"(0));
    asm volatile("fence.mbarrier_init.release.cluster;");
    asm volatile("cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];" :: "r"(0), "l"(map), "r"(0), "r"(0));
    asm volatile("mbarrier.try_wait.parity.shared.b64 p, [%0], 0;" :: "r"(0));
    dst[threadIdx.x] = tile[threadIdx.x];
}
"""),
}


@pytest.mark.parametrize("rule", sorted(KERNELS))
def test_p_rule_fires_on_bad_kernel(rule):
    found = el.pallas_findings("fx", textwrap.dedent(KERNELS[rule][0]),
                               "fx.cu")
    assert rule in [f.rule for f in found], found
    assert all(f.where.startswith("fx.cu:") for f in found)


@pytest.mark.parametrize("rule", sorted(KERNELS))
def test_p_rule_silent_on_clean_kernel(rule):
    assert el.pallas_findings("fx", textwrap.dedent(KERNELS[rule][1])) == []


def test_p1_second_copy_into_a_stage_in_flight_is_p2():
    src = """
__global__ void k(const int* src, int* dst) {
    __shared__ int stage[256];
    cuda::memcpy_async(stage, src, 1024, pipe);
    cuda::memcpy_async(stage, src + 256, 1024, pipe);
    pipe.producer_commit();
    pipe.consumer_wait();
}
"""
    rules = [f.rule for f in el.pallas_findings("fx", src)]
    assert rules == ["P2"]


def test_port_kernels_are_covered_and_clean():
    sources = el.kernel_sources()
    assert "consul_tpu_torch/csrc/ring_exchange.cu" in sources
    assert el.lint_pallas() == []


def test_cli_equivlint_module(tmp_path, capsys):
    from consul_tpu_torch.cli import main

    fixture = tmp_path / "kernels.py"
    bad = dict(bad=KERNELS["P1"][0])
    fixture.write_text(f"EQUIVLINT_PROGRAMS = {bad!r}\n")
    assert main(["equivlint", "--module", str(fixture)]) == 1
    assert "P1" in capsys.readouterr().out
    clean = tmp_path / "clean.py"
    clean.write_text(f"EQUIVLINT_PROGRAMS = {dict(ok=KERNELS['P1'][1])!r}\n")
    assert main(["equivlint", "--module", str(clean)]) == 0
    assert main(["equivlint", "--list-rules"]) == 0


@pytest.mark.slow
def test_registry_gate_clean():
    """The whole registry against the golden file, the ladder witnessed on
    the CPU, the kernels clean (about two minutes here)."""
    programs = jaxlint_registry(include=("small", "big"))
    res = el.run_equivlint(programs, witness_device="cpu")
    assert res["findings"] == [], [f.format() for f in res["findings"]]
