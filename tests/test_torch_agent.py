"""The port's agent plane (``consul_tpu_torch.agent``: ``Agent``, local
state and anti-entropy, checks, the cache, the config builder) beside the
JAX package's, on the CPU.

The reference's own scenarios run on both packages: ``tests/test_agent.py``,
``tests/test_config.py`` (its CLI boot test starts
``python -m consul_tpu_torch.cli agent`` for the port), ``tests/
test_cache.py``, and the publisher and ``Subscribe`` scenarios of
``tests/test_stream.py`` and the filter scenarios of ``tests/
test_surface.py``, which the agent's HTTP ``?filter=`` reaches.  Each
reference test module is loaded a second time with every import of
``consul_tpu`` pointed at ``consul_tpu_torch`` (:func:`reference_module`),
so the port runs the reference's test bodies unchanged.
"""

import asyncio
import importlib
import inspect
import pathlib
import re
import sys
import types

import pytest

TESTS = pathlib.Path(__file__).parent

# Reference test modules that other reference test modules import from.
_SHARED = ("test_http_dns", "test_cluster_agents")


def reference_module(name: str, package: str) -> types.ModuleType:
    """``tests/<name>.py`` as it runs on the JAX package (``"jax"``), or the
    same source with ``consul_tpu`` replaced by ``consul_tpu_torch`` in
    every import and name (``"torch"``); the modules it imports from
    (``_SHARED``) are loaded the same way."""
    if package == "jax":
        return importlib.import_module(name)
    key = f"torch_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = TESTS / f"{name}.py"
    src = re.sub(r"\bconsul_tpu\b", "consul_tpu_torch", path.read_text())
    for shared in _SHARED:
        src, n = re.subn(rf"\bfrom {shared} import\b",
                         f"from torch_{shared} import", src)
        if n and shared != name:
            reference_module(shared, "torch")
    mod = types.ModuleType(key)
    mod.__file__ = str(path)
    sys.modules[key] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def reference_cases(name: str, keep=lambda qualname, fn: True) -> list:
    """``(name, qualname)`` of the test functions and test methods of
    ``tests/<name>.py`` in source order, those that ``keep`` accepts."""
    mod = reference_module(name, "jax")
    found = []
    for attr, obj in vars(mod).items():
        if attr.startswith("test_") and inspect.isfunction(obj):
            found.append((attr, obj))
        elif attr.startswith("Test") and inspect.isclass(obj):
            found.extend((f"{attr}.{m}", fn) for m, fn in vars(obj).items()
                         if m.startswith("test_") and inspect.isfunction(fn))
    found.sort(key=lambda item: inspect.getsourcelines(item[1])[1])
    return [(name, q) for q, fn in found if keep(q, fn)]


def run_reference_case(case, package, request) -> None:
    """Run one reference test on ``package``, as pytest would: its skip
    marks honoured, its fixtures filled, a coroutine under ``asyncio.run``."""
    name, qualname = case
    owner, fn = None, reference_module(name, package)
    for part in qualname.split("."):
        owner, fn = fn, getattr(fn, part)
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "skipif" and mark.args and mark.args[0]:
            pytest.skip(mark.kwargs.get("reason", "skipped"))
    if inspect.isclass(owner):
        fn = getattr(owner(), qualname.rsplit(".", 1)[1])
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    if inspect.iscoroutinefunction(fn):
        asyncio.run(fn(**kwargs))
    else:
        fn(**kwargs)


def case_id(case) -> str:
    return f"{case[0]}::{case[1]}"


PUBLISHER = {"test_snapshot_then_live",
             "test_key_filtering_and_multiple_subscribers",
             "test_slow_subscriber_misses_nothing",
             "test_close_all_wakes_and_raises"}

CASES = (
    reference_cases("test_agent")
    + reference_cases("test_config")
    + reference_cases("test_cache")
    + reference_cases("test_stream", lambda q, fn: q in PUBLISHER
                      or q.startswith("TestSubscribeRPC."))
    + reference_cases("test_surface", lambda q, fn: q.startswith(
        "test_bexpr_"))
)


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_reference_scenario(case, package, request):
    run_reference_case(case, package, request)


def test_reference_cases_found():
    """The lists above are the reference's: 9 agent, 11 config, 5 cache,
    4 publisher and 2 Subscribe, 2 filter scenarios."""
    counts = {}
    for name, _ in CASES:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {"test_agent": 9, "test_config": 11, "test_cache": 5,
                      "test_stream": 6, "test_surface": 2}


def test_port_module_loads_no_reference():
    """The port's copy of a reference test module runs the port: every
    ``consul_tpu`` name in it is the port's."""
    mod = reference_module("test_agent", "torch")
    assert mod.Agent.__module__ == "consul_tpu_torch.agent.agent"
    assert mod.sync_scale_factor.__module__ == "consul_tpu_torch.agent.local"
