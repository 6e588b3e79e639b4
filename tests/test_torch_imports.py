"""The port stands alone: importing it loads neither JAX nor the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "consul_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "consul_tpu", "msgpack")

MODULES = (
    "consul_tpu_torch", "consul_tpu_torch.convert", "consul_tpu_torch.ops",
    "consul_tpu_torch.ops.ring_exchange", "consul_tpu_torch.ops.compact",
    "consul_tpu_torch.ops.sortmerge", "consul_tpu_torch.models",
    "consul_tpu_torch.models.swim", "consul_tpu_torch.models.lifeguard",
    "consul_tpu_torch.models.membership",
    "consul_tpu_torch.models.membership_sparse",
    "consul_tpu_torch.models.multidc", "consul_tpu_torch.models.vivaldi",
    "consul_tpu_torch.ops.xla_math", "consul_tpu_torch.geo",
    "consul_tpu_torch.geo.latency", "consul_tpu_torch.geo.model",
    "consul_tpu_torch.geo.report",
    "consul_tpu_torch.parallel", "consul_tpu_torch.protocol",
    "consul_tpu_torch.sim", "consul_tpu_torch.sim.faults",
    "consul_tpu_torch.sim.scenarios", "consul_tpu_torch.sim.breakdown",
    "consul_tpu_torch.sim.load", "consul_tpu_torch.streamcast",
    "consul_tpu_torch.streamcast.model", "consul_tpu_torch.streamcast.window",
    "consul_tpu_torch.streamcast.report", "consul_tpu_torch.ops.knobs",
    "consul_tpu_torch.sweep", "consul_tpu_torch.sweep.universe",
    "consul_tpu_torch.sweep.frontier", "consul_tpu_torch.sweep.presets",
    "consul_tpu_torch.sweep.optimize", "consul_tpu_torch.telemetry",
    "consul_tpu_torch.obs", "consul_tpu_torch.obs.spec",
    "consul_tpu_torch.obs.bridge", "consul_tpu_torch.obs.profile",
    "consul_tpu_torch.sim.registry", "consul_tpu_torch.cli",
    "consul_tpu_torch.net", "consul_tpu_torch.net.wire",
    "consul_tpu_torch.net.transport", "consul_tpu_torch.net.sim_transport",
    "consul_tpu_torch.net.security", "consul_tpu_torch.net.broadcast_queue",
    "consul_tpu_torch.net.suspicion", "consul_tpu_torch.net.vivaldi",
    "consul_tpu_torch.net.memberlist", "consul_tpu_torch.eventing",
    "consul_tpu_torch.eventing.lamport", "consul_tpu_torch.eventing.cluster",
    "consul_tpu_torch.eventing.coalesce", "consul_tpu_torch.eventing.snapshot",
    "consul_tpu_torch.consensus", "consul_tpu_torch.consensus.raft",
    "consul_tpu_torch.store", "consul_tpu_torch.store.iradix",
    "consul_tpu_torch.store.memdb", "consul_tpu_torch.store.state",
    "consul_tpu_torch.stream", "consul_tpu_torch.stream.publisher",
    "consul_tpu_torch.agent", "consul_tpu_torch.agent.fsm",
    "consul_tpu_torch.agent.snapshot",
    "chip_smoke",
)
# The host gossip plane: plain asyncio, no optional package at import time.
HOST_MODULES = ("consul_tpu_torch.net", "consul_tpu_torch.eventing")
HOST_FORBIDDEN = ("msgpack", "cryptography")


def test_every_port_module_is_checked():
    """Each module of the package is imported by the subprocess test."""
    names = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "consul_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    }
    imported = {m for m in MODULES if m != "chip_smoke"}
    missing = sorted(
        m for m in names
        if m not in imported and m.rsplit(".", 1)[0] not in imported
    )
    assert not missing, f"not in MODULES: {missing}"


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "", f"port loaded {out.stdout.strip()}"


def test_host_plane_loads_no_msgpack_or_cryptography():
    code = (
        "import importlib, sys\n"
        f"for m in {HOST_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from consul_tpu_torch.net import (InMemoryNetwork, Keyring,\n"
        "    Memberlist, MemberlistConfig, Node, NodeStatus,\n"
        "    TransmitLimitedQueue, UDPTransport)\n"
        "from consul_tpu_torch.eventing import (Cluster, ClusterConfig,\n"
        "    Coalescer, EventType, LamportClock, MemberStatus, Snapshotter)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {HOST_FORBIDDEN + FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "", f"host plane loaded {out.stdout.strip()}"


# The consistency plane runs on the host CPU by design: it loads no torch.
PLANE_MODULES = ("consul_tpu_torch.consensus", "consul_tpu_torch.store",
                 "consul_tpu_torch.stream", "consul_tpu_torch.agent")
PLANE_FORBIDDEN = HOST_FORBIDDEN + FORBIDDEN + ("torch",)


@pytest.mark.parametrize("module", PLANE_MODULES)
def test_consistency_plane_loads_no_torch(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {PLANE_FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "", f"{module} loaded {out.stdout.strip()}"


def test_port_names_load_on_first_use():
    """The package's top-level names resolve lazily, each to its module's
    object, and an unknown name still raises."""
    import consul_tpu_torch
    from consul_tpu_torch import net, sim

    assert consul_tpu_torch.run_swim is sim.run_swim
    assert net.SimBridge.__module__ == "consul_tpu_torch.net.sim_transport"
    assert "run_swim" in consul_tpu_torch.__all__
    with pytest.raises(AttributeError):
        consul_tpu_torch.no_such_name
    with pytest.raises(AttributeError):
        net.no_such_name


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_no_file_imports_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
