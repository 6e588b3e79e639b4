"""The exactness ladder as data (``consul_tpu_torch.sim.registry
.EQUIV_PAIRS``): the reference's 22 rungs, each walked on the CPU by
``walk_equiv_pairs``, which runs both sides from the same initial state
and ``PRNGKey(0)`` and compares the projected outputs bit for bit (the
port's form of equivlint's WITNESSED verdict).  A deliberately wrong
projection, or a pair of programs that are not equal, fails the walk.
"""

import pytest
import torch

from consul_tpu.sim import engine as j_engine
from consul_tpu_torch.sim import registry
from consul_tpu_torch.sim.registry import (
    EQUIV_PAIRS,
    EquivPair,
    walk_equiv_pairs,
)
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = registry.jaxlint_registry(include=("small",))
RELATIONS = {
    "D=1 slice == unsharded": 5, "ring == alltoall (D=2)": 5,
    "telemetry == off on every existing output": 7,
    "U=1 sweep == plain scan": 2,
}


def test_rungs_are_the_references():
    assert len(EQUIV_PAIRS) == 22
    want = [(p.a, p.b, p.relation, p.family,
             getattr(p.project_a, "__name__", None),
             getattr(p.project_b, "__name__", None))
            for p in j_engine.EQUIV_PAIRS]
    got = [(p.a, p.b, p.relation, p.family,
            getattr(p.project_a, "__name__", None),
            getattr(p.project_b, "__name__", None))
           for p in EQUIV_PAIRS]
    assert got == want
    for relation, count in RELATIONS.items():
        assert sum(p.relation == relation for p in EQUIV_PAIRS) == count
    assert sum(p.relation.startswith(("flag omitted", "amortize"))
               for p in EQUIV_PAIRS) == 3
    for p in EQUIV_PAIRS:
        assert p.a in SMALL and p.b in SMALL


@pytest.mark.parametrize("pair", EQUIV_PAIRS,
                         ids=[f"{p.a}=={p.b}" for p in EQUIV_PAIRS])
def test_rung_holds_on_the_cpu(pair):
    (record,) = walk_equiv_pairs(SMALL, "cpu", (pair,))
    assert (record["a"], record["b"]) == (pair.a, pair.b)
    assert record["seconds"] > 0


def test_walk_returns_one_record_a_rung_in_order():
    pairs = EQUIV_PAIRS[:3]
    assert [(r["a"], r["b"]) for r in walk_equiv_pairs(SMALL, "cpu", pairs)
            ] == [(p.a, p.b) for p in pairs]


def _bump_final_tick(out):
    final, outs = out
    return final._replace(tick=final.tick + 1), outs[0]


WRONG = [
    # The twin's trailing overflow kept: the output trees differ.
    (EquivPair("sharded_broadcast@small/D1", "broadcast@small",
               relation="no projection", family="broadcast"),
     "output structure"),
    # The right tree, one leaf moved: a value differs.
    (EquivPair("sharded_broadcast@small/D1", "broadcast@small",
               relation="a tick late", family="broadcast",
               project_a=_bump_final_tick),
     "values differ"),
    # The telemetry trace dropped from the wrong end.
    (EquivPair("swim@small/telemetry", "swim@small",
               relation="first output dropped", family="swim",
               project_a=lambda out: (out[0], tuple(out[1])[1:])),
     "values differ"),
    # Two programs that are not equal: another selection policy.
    (EquivPair("streamcast@small/pipeline", "streamcast@small",
               relation="policies differ", family="streamcast"),
     "values differ"),
    # The U=1 sweep without its universe axis squeezed.
    (EquivPair("sweep_broadcast@small/U1", "broadcast@small",
               relation="U axis kept", family="broadcast"),
     "torch.bool(1, 64) != torch.bool(64,)"),
]


@pytest.mark.parametrize("pair,why", WRONG, ids=[p.relation for p, _ in WRONG])
def test_a_wrong_rung_fails_the_walk(pair, why):
    with pytest.raises(AssertionError, match=f"rung {pair.a} == {pair.b}"
                       ) as err:
        walk_equiv_pairs(SMALL, "cpu", (pair,))
    assert why in str(err.value)


def test_the_sweep_rung_runs_its_own_arguments():
    """The U=1 rungs run the sweep program's own arguments, which are the
    plain program's: its initial state stacked to [1, ...], PRNGKey(0) and
    the config's own knob value."""
    (swim_u1,) = [p for p in EQUIV_PAIRS if p.a == "sweep_swim@small/U1"]
    _, make_args = SMALL[swim_u1.a].build()
    stacked, keys, values = make_args("cpu")
    state, key = SMALL[swim_u1.b].build()[1]("cpu")
    assert keys.shape == (1, 2) and torch.equal(keys[0], key)
    (loss,) = values
    assert loss.dtype == torch.float32 and float(loss) == pytest.approx(0.05)
    assert all(torch.equal(x[0], y) for x, y in zip(stacked, state))
