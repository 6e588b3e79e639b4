"""The profile harness (``consul_tpu_torch.obs.profile``) and ``cli
profile`` on the CPU.

* the counterparts of ``tests/test_obs.py``'s profile tests: the walls of
  an executed program, the execute budget and the deadline skipping
  loudly with the reference's messages, the abstract-only entry;
* ``memory_gate`` with a tiny budget fails loudly and never skips;
* ``run_with_profiler`` writes a Chrome trace;
* ``cli profile`` in text and JSON, ``--entry`` with no match exiting 1
  with the reference's message, and without ``--device`` refusing to run
  on a machine with no card.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from consul_tpu import cli as j_cli
from consul_tpu.sim import engine as j_engine
from consul_tpu_torch import cli, obs
from consul_tpu_torch.obs.profile import (
    MemoryGateError,
    ProgramProfile,
    memory_gate,
    profile_program,
    profile_registry,
    run_with_profiler,
)
from consul_tpu_torch.sim import registry
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tiny_registry():
    regs = registry.jaxlint_registry(include=("small",), sharded_devices=())
    return {"broadcast@small": regs["broadcast@small"],
            "swim@small": regs["swim@small"]}


def test_obs_exports_the_harness():
    for name in ("ProgramProfile", "profile_program", "profile_registry",
                 "run_with_profiler"):
        assert getattr(obs, name) is getattr(obs.profile, name)
        assert name in obs.__all__


def test_cost_and_walls():
    prog = _tiny_registry()["broadcast@small"]
    p = profile_program(prog, execute=True, device="cpu")
    assert p.trace_s > 0 and p.compile_s > 0
    assert p.execute_s is not None and p.execute_s > 0
    # No backend analysis here: the fields stay None, as the reference
    # leaves them.
    assert p.flops is None and p.bytes_accessed is None
    assert p.generated_code_bytes is None
    assert p.argument_bytes == prog.state_bytes() == 340
    assert p.output_bytes > 0
    json_row = p.to_json()
    assert json_row["name"] == "broadcast@small"
    assert json_row["device"] == "cpu"


def test_without_execute_nothing_runs():
    p = profile_program(_tiny_registry()["swim@small"])
    assert p.trace_s > 0 and p.argument_bytes == 3096
    assert p.compile_s is None and p.execute_s is None
    assert p.output_bytes is None and p.device == ""


def test_execute_budget_skips_loudly():
    profiles = profile_registry(
        _tiny_registry(), execute=True, execute_budget_s=1e-9, device="cpu"
    )
    assert profiles[0].execute_s is not None
    assert profiles[1].execute_s is None
    assert "exhausted" in profiles[1].execute_skipped


def test_deadline_skips_everything_loudly():
    profiles = profile_registry(
        _tiny_registry(), deadline=time.monotonic() - 1.0
    )
    assert all(
        p.execute_skipped == "section budget exhausted" for p in profiles
    )


def test_abstract_only_entry_is_sized_and_never_run():
    big = registry.jaxlint_registry(include=("big",))
    (p,) = profile_registry({"sparse@10m": big["sparse@10m"]}, execute=True,
                            device="cpu")
    assert p.execute_skipped == ("abstract-only registry entry "
                                 "(never compiled/executed)")
    assert p.execute_s is None and p.argument_bytes == 7_810_000_028


def test_window_bounds_the_first_call():
    prog = _tiny_registry()["swim@small"]
    whole = profile_program(prog, execute=True, device="cpu")
    assert whole.profiled_steps == prog.steps == 8
    cut = profile_program(prog, execute=True, device="cpu", window=3)
    assert cut.profiled_steps == 3
    # The timed call is still the whole study.
    assert cut.output_bytes == whole.output_bytes
    # A window as long as the study leaves the first call whole.
    assert profile_program(prog, execute=True, device="cpu",
                           window=8).profiled_steps == 8
    (row,) = profile_registry({"swim@small": prog}, execute=True,
                              device="cpu", window=2)
    assert row.profiled_steps == 2


def test_at_steps_cuts_the_same_study():
    prog = _tiny_registry()["swim@small"]
    fn, make_args = prog.build()
    whole = fn(*make_args("cpu"))
    cut = prog.at_steps(3)(*make_args("cpu"))
    for w, c in zip(torch.utils._pytree.tree_leaves(whole[1]),
                    torch.utils._pytree.tree_leaves(cut[1])):
        assert c.shape[0] == 3 and torch.equal(c, w[:3])


def test_a_program_that_writes_its_arguments_fails_the_profile():
    prog = _tiny_registry()["broadcast@small"]
    fn, make_args = prog.build()

    def writes(state, key):
        out = fn(state, key)
        key.add_(1)
        return out

    bad = dataclasses.replace(prog, build=lambda: (writes, make_args))
    with pytest.raises(RuntimeError, match="broadcast@small: a call wrote "
                                           "into its argument leaf"):
        profile_program(bad, execute=True, device="cpu")


def test_memory_gate_fails_loudly_over_the_budget():
    p = profile_program(_tiny_registry()["broadcast@small"], execute=True,
                        device="cpu")
    # No peak off the card: the gate refuses to pass what it cannot hold.
    with pytest.raises(MemoryGateError, match="no peak memory"):
        memory_gate(p, 1 << 40)
    p = ProgramProfile(name="x@small", entrypoint="x_scan", n=64,
                       trace_s=0.1, peak_bytes=4096)
    assert memory_gate(p, 4096) == 4096
    with pytest.raises(MemoryGateError, match="x@small: peak 4096 bytes "
                                              "over the budget of 4095"):
        memory_gate(p, 4095)
    assert p.execute_skipped is None


def test_run_with_profiler_writes_a_chrome_trace(tmp_path):
    out = run_with_profiler(str(tmp_path / "pf"), lambda: torch.ones(3) * 2)
    assert torch.equal(out, torch.full((3,), 2.0))
    trace = json.loads((tmp_path / "pf" / "trace.json").read_text())
    assert trace["traceEvents"]


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_profile_text(capsys):
    rc, out, err = _run(cli.main, ["profile", "--entry", "swim@small",
                                   "--device", "cpu"], capsys)
    assert rc == 0, err
    lines = out.splitlines()
    assert lines[0].split() == ["PROGRAM", "FLOPS", "BYTES", "TRACE_S",
                                "COMPILE_S", "EXECUTE_S", "LAUNCHES",
                                "DEVICE_MS", "PEAK_BYTES"]
    # The reference's substring match: the sweep twins contain the name.
    assert [ln.split()[0] for ln in lines[1:]] == [
        k for k in j_engine.jaxlint_registry(include=("small",))
        if "swim@small" in k]
    assert len(lines) == 6 and lines[1].split()[0] == "swim@small"


def test_cli_profile_json_executes(capsys):
    rc, out, err = _run(cli.main, ["profile", "--which", "small", "--entry",
                                   "multidc@small", "--execute", "--format",
                                   "json", "--device", "cpu"], capsys)
    assert rc == 0, err
    (row,) = json.loads(out)["programs"]
    assert row["name"] == "multidc@small" and row["execute_s"] > 0
    assert row["device"] == "cpu" and row["launches"] is None


def test_cli_profile_no_match_is_the_references_error(capsys):
    want = _run(j_cli.main, ["profile", "--entry", "nope"], capsys)
    got = _run(cli.main, ["profile", "--entry", "nope", "--device", "cpu"],
               capsys)
    assert got == want
    assert got[0] == 1 and "no registry entry matches 'nope'" in got[2]


def test_cli_profile_set_flag_is_the_references():
    args = cli.build_parser().parse_args(["profile", "--set", "big"])
    assert args.which == "big"
    args = cli.build_parser().parse_args(["profile", "--which", "all"])
    assert args.which == "all"


def test_cli_profile_runs_on_cuda_unless_told(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    rc, out, err = _run(cli.main, ["profile", "--entry", "swim@small",
                                   "--execute"], capsys)
    assert rc == 1 and out == "" and "no CUDA device" in err


def test_cli_profile_module_with_perfetto(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "consul_tpu_torch.cli", "profile", "--which",
         "small", "--entry", "broadcast@small", "--execute", "--format",
         "json", "--perfetto", str(tmp_path), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)["programs"]
    assert rows[0]["name"] == "broadcast@small"
    assert all(r["execute_s"] > 0 for r in rows)
    assert f"perfetto trace written under {tmp_path}" in proc.stderr
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
