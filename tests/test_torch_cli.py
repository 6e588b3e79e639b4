"""``run_scenario`` and the simulator commands of the command line
(``python -m consul_tpu_torch.cli sim|sweep``) against the JAX package's
on the CPU.

* ``run_scenario`` rejects what the reference rejects, with its messages,
  and knows the same presets;
* ``dev3`` with ``telemetry=True`` gives the reference's dict, metrics
  snapshot included (the wall-clock keys and the port's ``device`` aside);
* every check ``sim`` and ``sweep`` make before a study runs exits 1 with
  the reference's message;
* ``sim dev3 --metrics`` and a small ``sweep`` print the reference's JSON;
  ``--device`` is the port's own flag, and without it the commands run on
  CUDA or refuse.
"""

import inspect
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from consul_tpu import cli as j_cli
from consul_tpu.sim import scenarios as j_scenarios
from consul_tpu_torch import cli
from consul_tpu_torch.sim import engine, scenarios
from consul_tpu_torch.streamcast import POLICIES
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Keys that hold a wall-clock reading (or, for ``device``, the port's own
# record of where it ran).
WALL = ("sim_rounds_per_sec", "wall_s", "universes_per_sec",
        "rounds_per_sec", "rounds_per_sec_per_universe")


def _strip(out: dict) -> dict:
    out = {k: v for k, v in out.items() if k not in WALL}
    out.pop("device", None)
    if "metrics" in out:
        out["metrics"] = {k: v for k, v in out["metrics"].items()
                          if k != "Timestamp"}
    return out


REJECTIONS = [
    ("nope", {}),
    ("dev3", {"exchange": "ring"}),
    ("probe1k", {"exchange": "alltoall"}),
    ("suspect1m", {"telemetry": True}),
    ("multidc1m", {"telemetry": True}),
    ("degraded1m", {"telemetry": True}),
    ("dev3", {"policy": "pipeline"}),
    ("geo100k", {"policy": "rarest"}),
    ("dev3", {"devices": 2}),
    ("suspect1m", {"devices": 2}),
]


@pytest.mark.parametrize("name,kw", REJECTIONS,
                         ids=[f"{n}-{'-'.join(k) or 'name'}"
                              for n, k in REJECTIONS])
def test_run_scenario_rejections_match_reference(name, kw):
    with pytest.raises(ValueError) as want:
        j_scenarios.run_scenario(name, **kw)
    with pytest.raises(ValueError) as got:
        scenarios.run_scenario(name, **kw, device="cpu")
    assert str(got.value) == str(want.value)


def test_scenario_registry_matches_reference():
    assert list(scenarios.SCENARIOS) == list(j_scenarios.SCENARIOS)
    for name, fn in scenarios.SCENARIOS.items():
        want = set(inspect.signature(j_scenarios.SCENARIOS[name]).parameters)
        got = set(inspect.signature(fn).parameters)
        assert got == want | {"device"}, name
    assert cli.SIM_POLICY_CHOICES == POLICIES


def test_dev3_telemetry_matches_reference():
    """The reference's dict key for key, the bridged snapshot included."""
    want = j_scenarios.run_scenario("dev3", telemetry=True)
    got = scenarios.run_scenario("dev3", telemetry=True, device="cpu")
    assert got["device"] == "cpu"
    assert list(_strip(got)) == list(_strip(want))
    assert _strip(got) == _strip(want)
    names = {c["Name"] for c in got["metrics"]["Counters"]}
    assert "memberlist.gossip" in names


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_sim_metrics_prints_the_reference_json(capsys):
    rc, out, _ = _run(j_cli.main, ["sim", "dev3", "--metrics"], capsys)
    assert rc == 0
    want = json.loads(out)
    rc, out, _ = _run(cli.main, ["sim", "dev3", "--metrics", "--device",
                                 "cpu"], capsys)
    assert rc == 0
    got = json.loads(out)
    assert _strip(got) == _strip(want)


SIM_REJECTIONS = [
    [],
    ["nope"],
    ["dev3", "--exchange", "ring"],
    ["suspect1m", "--metrics"],
    ["dev3", "--policy", "pipeline"],
    ["dev3", "--devices", "2"],
]


@pytest.mark.parametrize("argv", SIM_REJECTIONS,
                         ids=["-".join(a) or "none" for a in SIM_REJECTIONS])
def test_sim_rejections_match_reference(argv, capsys):
    """Each exits 1 before a study runs, with the reference's message."""
    want = _run(j_cli.main, ["sim", *argv], capsys)
    got = _run(cli.main, ["sim", *argv, "--device", "cpu"], capsys)
    assert want[0] == 1 and got == want


def test_sim_list_names_the_presets(capsys):
    rc, out, _ = _run(cli.main, ["sim", "--list"], capsys)
    assert rc == 0
    assert [line.split()[0] for line in out.splitlines()] == sorted(
        scenarios.SCENARIOS)


SWEEP_REJECTIONS = [
    [],
    ["seeds4k", "--universes", "2", "--frontier-x", "detect_t90_mss"],
    ["seeds4k", "--universes", "2", "--frontier-y", "first_suspect"],
    ["streamload", "--exchange", "ring"],
    ["seeds4k", "--universes", "2", "--devices", "2"],
    ["tuning", "--devices", "2", "--exchange", "ring"],
    ["streamload", "--objective", "window_overflow", "--knee-at", "0"],
    ["streamload", "--minimize", "--max-generations", "3"],
    ["streamload", "--optimize"],
    ["streamload", "--optimize", "--objective", "window_overfloww"],
    ["nope"],
]


@pytest.mark.parametrize("argv", SWEEP_REJECTIONS,
                         ids=["-".join(a[:1] + a[2:][-2:]) or "none"
                              for a in SWEEP_REJECTIONS])
def test_sweep_rejections_match_reference(argv, capsys, monkeypatch):
    """Each exits 1 before any sweep runs (the port's ``run_sweep`` raises
    here if reached), with the reference's message."""
    def boom(*args, **kwargs):
        raise AssertionError("run_sweep must not be reached")

    monkeypatch.setattr(engine, "run_sweep", boom)
    want = _run(j_cli.main, ["sweep", *argv], capsys)
    got = _run(cli.main, ["sweep", *argv, "--device", "cpu"], capsys)
    assert want[0] == 1 and got == want
    assert "must not be reached" not in got[2]


def test_sweep_list_names_the_presets(capsys):
    want = _run(j_cli.main, ["sweep", "--list"], capsys)
    got = _run(cli.main, ["sweep", "--list"], capsys)
    assert got[0] == 0
    assert ([line.split()[0] for line in got[1].splitlines()]
            == [line.split()[0] for line in want[1].splitlines()])


def test_small_sweep_prints_the_reference_json(capsys):
    """``sweep seeds4k --universes 2`` (n=4096, 60 ticks) on the CPU."""
    argv = ["sweep", "seeds4k", "--universes", "2"]
    rc, out, _ = _run(j_cli.main, argv, capsys)
    assert rc == 0
    want = json.loads(out)
    rc, out, _ = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert rc == 0
    got = json.loads(out)
    assert got["universes"] == 2 and got["metrics"]
    assert _strip(got) == _strip(want)


def test_commands_run_on_cuda_unless_told(capsys):
    """Without ``--device`` the study runs on the CUDA card, and where
    there is none the command says so and exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    rc, out, err = _run(cli.main, ["sim", "dev3"], capsys)
    assert rc == 1 and out == "" and "no CUDA device" in err
    rc, out, err = _run(cli.main, ["sweep", "seeds4k", "--universes", "2"],
                        capsys)
    assert rc == 1 and out == "" and "no CUDA device" in err


def test_module_entry_point():
    """``python -m consul_tpu_torch.cli sim dev3 --metrics --device cpu``
    prints one JSON document with the bridged snapshot."""
    proc = subprocess.run(
        [sys.executable, "-m", "consul_tpu_torch.cli", "sim", "dev3",
         "--metrics", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["scenario"] == "dev3" and out["device"] == "cpu"
    assert {"Gauges", "Counters", "Samples"} <= set(out["metrics"])
