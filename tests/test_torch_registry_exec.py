"""Every small program of the port's registry executes on the CPU through
``obs.profile.profile_program(execute=True)`` from its own initial state
and ``PRNGKey(0)``, as phase 14 of ``chip_smoke.py`` executes programs on
the card.

PyTorch on the CPU raises ``IndexError`` on an index out of range where
the card would assert and poison its context, so a program that indexes
past a plane fails here first.  The reference's profile runs its programs
on zero-filled arguments; the port never does (a zero key, knob or
budget is not a study the reference runs).

The profile makes each program's arguments once and calls it twice, which
is sound only because a round never writes into its input:
``profile_program`` checks every argument against a copy after the timed
call, and the second test holds every argument unchanged by one call.
"""

import pytest
import torch

from consul_tpu_torch.obs.profile import profile_program
from consul_tpu_torch.sim import registry
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = registry.jaxlint_registry(include=("small",))


@pytest.mark.parametrize("name", list(SMALL))
def test_small_program_executes_on_the_cpu(name):
    prog = SMALL[name]
    p = profile_program(prog, execute=True, device="cpu")
    assert p.device == "cpu" and p.execute_skipped is None
    assert p.trace_s > 0 and p.compile_s > 0 and p.execute_s > 0
    assert p.argument_bytes == prog.state_bytes()
    assert p.output_bytes > 0
    # Device fields are the card's: not measured on the CPU.
    assert p.launches is None and p.device_ms is None
    assert p.peak_bytes is None and p.temp_bytes is None


@pytest.mark.parametrize("name", list(SMALL))
def test_a_call_leaves_its_arguments_unchanged(name):
    fn, make_args = SMALL[name].build()
    args = make_args("cpu")
    before = [x.clone() for x in torch.utils._pytree.tree_leaves(args)]
    fn(*args)
    after = torch.utils._pytree.tree_leaves(args)
    assert all(torch.equal(b, a) for b, a in zip(before, after)), name
