"""The sharded plane's multichip datapoint (``python -m
consul_tpu_torch.parallel.shard``) against the JAX package's ``main``, on
the CPU: the same JSON keys, and per transport the reference's
``infected_final`` and ``overflow``.  The reference runs its all_to_all
transport (its Pallas ring needs a TPU compiler; ROADMAP Queue 3): the
port's ring must equal it too."""

import json

import pytest

from consul_tpu.parallel import shard as j_shard
from consul_tpu_torch import BroadcastConfig
from consul_tpu_torch.parallel import mesh_for, shard
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--devices", "8", "--n", "4096", "--steps", "10"]


def _line(capsys, fn, argv) -> dict:
    capsys.readouterr()
    assert fn(argv) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    return json.loads(line)


def test_main_matches_reference(capsys):
    want = _line(capsys, j_shard.main, ARGS + ["--exchange", "alltoall"])
    got = _line(capsys, shard.main, ARGS + ["--exchange", "both",
                                            "--device", "cpu"])
    assert set(want) <= set(got)
    assert set(want["exchange_backends"]["alltoall"]) == set(
        got["exchange_backends"]["ring"])
    for k in ("devices", "nodes_aggregate", "nodes_per_device", "rounds",
              "infected_final", "overflow", "exchange_backend"):
        assert got[k] == want[k], k
    assert got["host_devices_forced"] is False
    ref = want["exchange_backends"]["alltoall"]
    for ex in ("alltoall", "ring"):
        row = got["exchange_backends"][ex]
        assert (row["infected_final"], row["overflow"]) == (
            ref["infected_final"], ref["overflow"]), ex
        assert row["exchange_wall_s"] > 0 and row["merge_wall_s"] > 0


@pytest.mark.parametrize("backend", ["alltoall", "ring"])
def test_exchange_phase_walls(backend):
    cfg = BroadcastConfig(n=4096, fanout=4, delivery="edges")
    walls = shard.exchange_phase_walls(cfg, mesh_for(8, "cpu"), backend,
                                       iters=3)
    assert set(walls) == {"exchange_wall_s", "merge_wall_s"}
    for v in walls.values():
        assert isinstance(v, float) and v > 0
    with pytest.raises(ValueError, match="backend"):
        shard.exchange_phase_walls(cfg, mesh_for(8, "cpu"), "nccl")


def test_main_rejects_uneven_shards(capsys):
    with pytest.raises(ValueError, match="divide"):
        shard.main(["--devices", "3", "--n", "64", "--steps", "1",
                    "--device", "cpu"])
