"""The port's API client, watches, agent commands and KV bench
(``consul_tpu_torch.api``, ``consul_tpu_torch.cli``,
``consul_tpu_torch.bench_kv``) beside the JAX package's, on the CPU.

* The reference's own scenarios on both packages (loaded as in
  ``tests/test_torch_agent.py``): ``tests/test_cli_api.py``, whose
  black-box case runs ``python -m consul_tpu_torch.cli agent -dev`` and
  the agent commands against it for the port.
* Each package's ``ConsulClient`` against each package's dev agent: one
  seeded script of KV, catalog, health and session calls gives equal
  results once generated IDs and Raft indexes are mapped out.
* The port's ``build_parser`` has the reference's subcommands, less its
  five static-analysis commands, with equal options; the studies
  (``sim``, ``sweep``, ``profile``) add ``--device``.
* ``bench_kv._run()`` of both packages, cut to one trial of 2 x 50
  requests, returns the same keys with rates above 0.
"""

import argparse
import asyncio
import re

import numpy as np
import pytest

from helpers import wait_for as wait_until

import consul_tpu.agent.agent as j_agent
import consul_tpu.agent.http as j_http
import consul_tpu.api as j_api
import consul_tpu.bench_kv as j_bench
import consul_tpu.cli as j_cli
import consul_tpu.net.transport as j_transport
import consul_tpu_torch.agent.agent as t_agent
import consul_tpu_torch.agent.http as t_http
import consul_tpu_torch.api as t_api
import consul_tpu_torch.bench_kv as t_bench
import consul_tpu_torch.cli as t_cli
import consul_tpu_torch.net.transport as t_transport
from test_torch_agent import case_id, reference_cases, run_reference_case

CASES = reference_cases("test_cli_api")


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_reference_scenario(case, package, request):
    run_reference_case(case, package, request)


def test_reference_cases_found():
    assert len(CASES) == 10


# ---------------------------------------------------------------------------
# each client against each agent
# ---------------------------------------------------------------------------

AGENTS = {"jax": (j_agent, j_http, j_transport),
          "torch": (t_agent, t_http, t_transport)}
CLIENTS = {"jax": j_api, "torch": t_api}
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")


def _script(seed: int) -> list:
    """A seeded list of client calls: (namespace, method, args, kwargs),
    with ``<sid>`` standing for the session the script created last."""
    rng = np.random.default_rng(seed)
    keys = [f"app/{a}/{b}" for a in ("db", "web", "cfg") for b in "xyz"]
    calls = []
    for i in range(4):
        node = f"n{i}"
        calls.append(("catalog", "register", ({
            "Node": node, "Address": f"10.0.0.{i + 1}",
            "Service": {"Service": ("db", "web")[i % 2], "Port": 80 + i,
                        "Tags": [f"t{i}"]},
            "Checks": [{"CheckID": f"c{i}", "Name": f"check {i}",
                        "ServiceID": ("db", "web")[i % 2],
                        "Status": ("passing", "warning",
                                   "critical")[int(rng.integers(3))]}]},),
            {}))
    for _ in range(40):
        roll = rng.random()
        key = keys[int(rng.integers(len(keys)))]
        if roll < 0.3:
            calls.append(("kv", "put", (key, rng.bytes(4)),
                          {"flags": int(rng.integers(3))}))
        elif roll < 0.45:
            calls.append(("kv", "get", (key,), {}))
        elif roll < 0.55:
            calls.append(("kv", "list", (key.rsplit("/", 1)[0],), {}))
        elif roll < 0.6:
            calls.append(("kv", "keys", ("app/",), {"separator": "/"}))
        elif roll < 0.65:
            calls.append(("kv", "delete", (key,),
                          {"recurse": bool(rng.random() < 0.3)}))
        elif roll < 0.7:
            # The pool's nodes have no serfHealth: their sessions name
            # their checks, or none.
            i = int(rng.integers(5))
            sess = {"Node": "dev"} if i == 4 else {
                "Node": f"n{i}",
                "Checks": [f"c{i}"] if rng.random() < 0.5 else []}
            calls.append(("session", "create", (dict(sess, Name="s",
                                                     TTL="30s"),), {}))
        elif roll < 0.75:
            calls.append(("kv", "put", (key, b"lock"),
                          {"acquire": "<sid>"}))
        elif roll < 0.8:
            calls.append(("session", "info", ("<sid>",), {}))
        elif roll < 0.85:
            calls.append(("health", "service", (("db", "web")[
                int(rng.integers(2))],),
                {"passing": bool(rng.random() < 0.5)}))
        elif roll < 0.9:
            calls.append(("health", "state", (("any", "passing", "warning",
                                               "critical")[
                int(rng.integers(4))],), {}))
        elif roll < 0.93:
            calls.append(("health", "checks", (("db", "web")[
                int(rng.integers(2))],), {}))
        elif roll < 0.96:
            calls.append(("catalog", "service", (("db", "web")[
                int(rng.integers(2))],), {}))
        else:
            calls.append(("catalog", "node", (f"n{int(rng.integers(4))}",),
                          {}))
    calls += [("session", "create", ({"Node": "dev", "Name": "tail",
                                      "TTL": "30s"},), {}),
              ("kv", "put", ("app/lock", b"x"), {"acquire": "<sid>"}),
              ("session", "node", ("dev",), {}),
              ("session", "renew", ("<sid>",), {}),
              ("kv", "get", ("app/lock",), {}),
              ("kv", "put", ("app/lock", b""), {"release": "<sid>"}),
              ("kv", "get", ("app/lock",), {})]
    calls += [("catalog", "nodes", (), {}), ("catalog", "services", (), {}),
              ("session", "list", (), {}), ("kv", "list", ("app",), {}),
              ("session", "destroy", ("<sid>",), {}),
              ("session", "list", (), {})]
    return calls


def _canon(obj, ids):
    """Generated IDs by first appearance, Raft indexes and times out."""
    if isinstance(obj, dict):
        return {k: ("<index>" if k.endswith("Index") or k == "index"
                    else _canon(v, ids)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v, ids) for v in obj]
    if isinstance(obj, str):
        return UUID.sub(lambda m: ids.setdefault(m.group(0),
                                                 f"<id {len(ids)}>"), obj)
    if hasattr(obj, "index") and hasattr(obj, "known_leader"):
        return "<meta>"
    return obj


async def _drive(client_pkg: str, agent_pkg: str, calls: list) -> list:
    agent_mod, http_mod, transport = AGENTS[agent_pkg]
    net = transport.InMemoryNetwork()
    agent = agent_mod.Agent(
        agent_mod.AgentConfig(node_name="dev", bootstrap_expect=1,
                              gossip_interval_scale=0.05,
                              sync_interval_s=30, sync_retry_interval_s=30,
                              reconcile_interval_s=30),
        gossip_transport=net.new_transport("dev:gossip"),
        rpc_transport=net.new_transport("dev:rpc"))
    await agent.start()
    await wait_until(lambda: agent.delegate.is_leader(), msg="leader")
    api = http_mod.HTTPApi(agent)
    addr = await api.start()
    client = CLIENTS[client_pkg].ConsulClient(addr)
    ids: dict = {}
    out, sid = [], ""
    try:
        for ns, method, args, kwargs in calls:
            args = tuple(sid if a == "<sid>" else a for a in args)
            kwargs = {k: sid if v == "<sid>" else v
                      for k, v in kwargs.items()}
            try:
                got = await getattr(getattr(client, ns), method)(*args,
                                                                 **kwargs)
            except Exception as e:  # noqa: BLE001 - the answer is compared
                got = ("error", type(e).__name__, str(e))
            if ns == "session" and method == "create":
                sid = got
            if ns == "session" and method in ("list", "node"):
                # Listed by their random IDs: put them in creation order.
                rows, meta = got
                got = sorted(rows, key=lambda r: r["CreateIndex"]), meta
            out.append(_canon(got, ids))
        return out
    finally:
        await api.stop()
        await agent.shutdown()


@pytest.mark.parametrize("seed", [0, 1])
def test_clients_and_agents_cross(seed):
    calls = _script(seed)
    got = {(c, a): asyncio.run(asyncio.wait_for(_drive(c, a, calls), 60))
           for c, a in (("jax", "jax"), ("torch", "jax"), ("jax", "torch"))}
    want = got[("jax", "jax")]
    assert got[("torch", "jax")] == want
    assert got[("jax", "torch")] == want
    assert sum(bool(r) and isinstance(r, (list, dict)) for r in want) > 20


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

LINT_COMMANDS = {"lint", "jaxlint", "rangelint", "equivlint", "check"}


def _commands(parser) -> dict:
    (sub,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return {name: [(a.option_strings, a.dest, a.default, a.choices, a.nargs,
                    a.required, a.type) for a in sp._actions]
            for name, sp in sub.choices.items()}


def test_parser_has_the_reference_commands():
    """Equal options on every command.  The studies (``sim``, ``sweep``,
    ``profile``) keep the port's own parsers, held to the reference by
    ``tests/test_torch_cli.py``: each has ``--device`` and every
    destination of the reference's.  The static-analysis commands add
    ``--witness-device`` where equivlint witnesses (``equivlint``,
    ``check``), and ``check``'s J6 budget defaults to the card's share
    (None) where the reference has one v5e's 16 GB."""
    want = _commands(j_cli.build_parser())
    got = _commands(t_cli.build_parser())
    assert sorted(got) == sorted(want)
    for name, options in got.items():
        if name in ("sim", "sweep", "profile"):
            assert sum(o[0] == ["--device"] for o in options) == 1, name
            assert {o[1] for o in want[name]} <= {o[1] for o in options}
        elif name in LINT_COMMANDS:
            ours = [o for o in options if o[0] != ["--witness-device"]]
            theirs = [(o[0], o[1], None, *o[3:])
                      if (name, o[1]) == ("check", "budget_gb") else o
                      for o in want[name]]
            assert ours == theirs, name
        else:
            assert options == want[name], name


def test_offline_commands_equal(capsys):
    """Commands refused before they call an agent print what the reference
    prints and exit with its codes; ``keygen`` prints a 32-byte key."""
    for argv in (["maint"], ["intention", "create"],
                 ["connect", "chain"], ["connect", "proxy"]):
        for cli in (j_cli, t_cli):
            code = cli.main(argv + ["-http-addr", "127.0.0.1:1"])
            assert code == 1, (cli.__name__, argv)
        j_out, t_out = capsys.readouterr().err.splitlines()[-2:]
        assert t_out == j_out, argv
    for cli in (j_cli, t_cli):
        assert cli.main(["keygen"]) == 0
    keys = capsys.readouterr().out.split()
    assert [len(k) for k in keys] == [44, 44]


# ---------------------------------------------------------------------------
# the KV bench
# ---------------------------------------------------------------------------


def test_bench_kv_small(monkeypatch):
    assert (t_bench.TRIALS, t_bench.WORKERS, t_bench.PER_WORKER) == (
        j_bench.TRIALS, j_bench.WORKERS, j_bench.PER_WORKER)
    rows = {}
    for name, mod in (("jax", j_bench), ("torch", t_bench)):
        monkeypatch.setattr(mod, "TRIALS", 1)
        monkeypatch.setattr(mod, "WORKERS", 2)
        monkeypatch.setattr(mod, "PER_WORKER", 50)
        rows[name] = asyncio.run(mod._run())
    assert sorted(rows["torch"]) == sorted(rows["jax"])
    for row in rows.values():
        assert row["kv_trials"] == 1 and row["kv_requests_per_trial"] == 100
        assert row["kv_put_median_per_s"] > 0
        assert row["kv_stale_get_median_per_s"] > 0
