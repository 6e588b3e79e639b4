"""The command line: ``python -m consul_tpu_torch.cli``.

The port of ``consul_tpu/cli.py``, with its flags, its checks before
anything runs, its output and its exit codes:

    python -m consul_tpu_torch.cli sim --list
    python -m consul_tpu_torch.cli sim event100k --devices 8 \
        --exchange ring --metrics
    python -m consul_tpu_torch.cli sweep seeds4k --universes 64
    python -m consul_tpu_torch.cli profile --which big --execute
    python -m consul_tpu_torch.cli agent -dev
    python -m consul_tpu_torch.cli members -http-addr 127.0.0.1:8500
    python -m consul_tpu_torch.cli kv put web/config '{"port": 80}'
    python -m consul_tpu_torch.cli intention create web db -deny
    python -m consul_tpu_torch.cli check --set small

The static-analysis commands (``lint``, ``jaxlint``, ``rangelint``,
``equivlint``, ``check``; ``consul_tpu_torch/analysis``) read the ATen
graph of one tick of each registered program on fake tensors: they
allocate nothing and need no card (``equivlint``'s witnesses run on the
card when there is one, on the CPU with ``--witness-device cpu``), and
exit nonzero on any finding.

``--devices D`` lays the study over D logical shards of one card
(``parallel.mesh_for``).  ``--device`` (the one flag the reference lacks)
names the device the study runs on: the current CUDA card unless given,
``cpu`` to run on the host.  ``agent`` runs a Consul agent over UDP with
its HTTP API and DNS; every other agent command talks to a running agent
over HTTP through the API client (``consul_tpu_torch.api``,
``-http-addr``, default 127.0.0.1:8500).  The agent commands are host
code and load no ``torch``.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import dataclasses
import inspect
import json
import math
import signal
import sys
from pathlib import Path
from typing import Optional

from consul_tpu_torch.api import ConsulClient, parse_watch
from consul_tpu_torch.version import __version__

DEFAULT_HTTP = "127.0.0.1:8500"

# Streamcast chunk-selection policies for ``sim --policy``: a literal copy
# of ``streamcast.model.POLICIES``, so that the parser builds without
# importing the model (tests pin the two equal).
SIM_POLICY_CHOICES = ("uniform", "pipeline", "rarest")


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not hasattr(args, "fn"):
        parser.print_help()
        return 1
    try:
        out = args.fn(args)
        # The agent's commands are coroutines, as in the reference; the
        # studies are plain functions.
        if inspect.iscoroutine(out):
            out = asyncio.run(out)
        return out or 0
    except KeyboardInterrupt:
        return 130
    except Exception as e:  # noqa: BLE001 (the command line: print, exit 1)
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _add_device(sp) -> None:
    sp.add_argument("--device", default=None,
                    help="device the study runs on (default: the current "
                         "CUDA card; 'cpu' runs on the host)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="consul-tpu-torch")
    sub = p.add_subparsers(dest="command")

    def cmd(name, fn, help=""):
        sp = sub.add_parser(name, help=help)
        sp.set_defaults(fn=fn)
        sp.add_argument("-http-addr", default=DEFAULT_HTTP)
        sp.add_argument("-token", default="",
                        help="ACL token (or X-Consul-Token equivalent)")
        return sp

    sp = sub.add_parser("agent", help="run an agent")
    sp.set_defaults(fn=cmd_agent)
    sp.add_argument("-dev", action="store_true",
                    help="single-server dev mode")
    sp.add_argument("-server", action="store_true")
    sp.add_argument("-node", default="")
    sp.add_argument("-datacenter", default=None)
    sp.add_argument("-bootstrap-expect", type=int, default=None)
    sp.add_argument("-join", action="append", default=[])
    sp.add_argument("-bind", default=None)
    sp.add_argument("-serf-port", type=int, default=0)
    sp.add_argument("-rpc-port", type=int, default=0)
    sp.add_argument("-http-port", type=int, default=None)
    sp.add_argument("-dns-port", type=int, default=None)
    sp.add_argument("-config-file", action="append", default=[],
                    dest="config_file", help="JSON/HCL config file")
    sp.add_argument("-config-dir", action="append", default=[],
                    dest="config_dir")
    sp.add_argument("-data-dir", default=None, dest="data_dir",
                    help="persistence root (serf snapshot, rejoin state)")

    # cluster membership --------------------------------------------------
    cmd("members", cmd_members, "list gossip pool members")
    sp = cmd("join", cmd_join, "join an agent to a cluster")
    sp.add_argument("addresses", nargs="+")
    cmd("leave", cmd_leave, "gracefully leave the cluster")
    sp = cmd("force-leave", cmd_force_leave,
             "force a failed member into the left state")
    sp.add_argument("node")
    cmd("info", cmd_info, "agent runtime info")

    # kv -------------------------------------------------------------------
    sp = cmd("kv", cmd_kv, "key/value store ops")
    sp.add_argument("verb", choices=["get", "put", "delete", "export",
                                     "import"])
    sp.add_argument("key", nargs="?", default="")
    sp.add_argument("value", nargs="?", default=None)
    sp.add_argument("-recurse", action="store_true")
    sp.add_argument("-keys", action="store_true")
    sp.add_argument("-detailed", action="store_true")

    # catalog --------------------------------------------------------------
    sp = cmd("catalog", cmd_catalog, "catalog queries")
    sp.add_argument("what", choices=["datacenters", "nodes", "services"])

    # events / watch -------------------------------------------------------
    sp = cmd("event", cmd_event, "fire a user event")
    sp.add_argument("-name", required=True)
    sp.add_argument("payload", nargs="?", default="")
    sp = cmd("watch", cmd_watch, "watch a view for changes")
    sp.add_argument("-type", required=True, dest="wtype")
    sp.add_argument("-key", default="")
    sp.add_argument("-prefix", default="")
    sp.add_argument("-service", default="")
    sp.add_argument("-tag", default="")
    sp.add_argument("-state", default="")
    sp.add_argument("-name", default="")
    sp.add_argument("-passingonly", action="store_true")
    sp.add_argument("-once", action="store_true",
                    help="print first result and exit")

    # sessions / locks ----------------------------------------------------
    sp = cmd("session", cmd_session, "session ops")
    sp.add_argument("verb", choices=["list", "destroy", "info"])
    sp.add_argument("sid", nargs="?", default="")
    sp = cmd("lock", cmd_lock, "run a command while holding a lock")
    sp.add_argument("prefix")
    sp.add_argument("shell_command")

    # ops ------------------------------------------------------------------
    sp = cmd("acl", cmd_acl, "ACL token and policy management")
    sp.add_argument("subsystem",
                    choices=["bootstrap", "token", "policy", "role",
                             "auth-method", "binding-rule"])
    sp.add_argument("verb", nargs="?", default="list",
                    choices=["list", "create", "delete", "read"])
    sp.add_argument("arg", nargs="?", default="",
                    help="JSON definition, id, name, or secret")

    sp = cmd("login", cmd_login,
             "exchange a bearer token for a Consul token")
    sp.add_argument("-method", required=True, dest="method")
    sp.add_argument("-bearer-token", required=True, dest="bearer_token")
    sp.add_argument("-token-sink-file", default="", dest="token_sink_file")
    sp = cmd("logout", cmd_logout, "destroy the current login token")

    sp = cmd("debug", cmd_debug, "capture a debug bundle")
    sp.add_argument("-output", default="consul-debug.tar.gz")

    cmd("keygen", cmd_keygen, "generate a gossip encryption key")
    sp = cmd("keyring", cmd_keyring, "manage gossip encryption keys")
    sp.add_argument("verb", choices=["list", "install", "use", "remove"])
    sp.add_argument("key", nargs="?", default="")

    sp = cmd("snapshot", cmd_snapshot, "save/restore cluster state")
    sp.add_argument("verb", choices=["save", "restore"])
    sp.add_argument("file")

    sp = cmd("operator", cmd_operator, "cluster operator tools")
    sp.add_argument("subsystem", choices=["raft"])
    sp.add_argument("action", choices=["list-peers"])
    sp = cmd("rtt", cmd_rtt, "estimate RTT between nodes")
    sp.add_argument("node1")
    sp.add_argument("node2", nargs="?", default="")
    sp = cmd("services", cmd_services, "register/deregister agent services")
    sp.add_argument("verb", choices=["register", "deregister"])
    sp.add_argument("arg", help="JSON definition file (or '-'), or id")
    sp = cmd("monitor", cmd_monitor, "stream the agent's live logs")
    sp.add_argument("-log-level", default="info", dest="log_level")
    sp = sub.add_parser("validate", help="validate config files")
    sp.set_defaults(fn=cmd_validate)
    sp.add_argument("paths", nargs="+", help="config files or dirs")
    cmd("reload", cmd_reload, "trigger a config reload on the agent")
    sp = cmd("maint", cmd_maint, "toggle node/service maintenance mode")
    sp.add_argument("-enable", action="store_true")
    sp.add_argument("-disable", action="store_true")
    sp.add_argument("-service", default="", help="service id (node-wide "
                    "when omitted)")
    sp.add_argument("-reason", default="")

    # connect --------------------------------------------------------------
    sp = cmd("connect", cmd_connect, "service mesh tools")
    sp.add_argument("verb", choices=["proxy", "ca-rotate", "chain"])
    sp.add_argument("-sidecar-for", default="", dest="sidecar_for",
                    help="proxy id to run the built-in proxy for")
    sp.add_argument("-listen-port", type=int, default=0,
                    help="public mTLS port (defaults to the registered "
                         "service port)")
    sp.add_argument("service", nargs="?", default="",
                    help="service name (chain verb)")
    sp = cmd("intention", cmd_intention, "manage connect intentions")
    sp.add_argument("verb", choices=["create", "delete", "list", "check"])
    sp.add_argument("src", nargs="?", default="")
    sp.add_argument("dst", nargs="?", default="")
    sp.add_argument("-deny", action="store_true")

    sp = sub.add_parser("sim", help="run a simulator scenario preset")
    sp.set_defaults(fn=cmd_sim)
    sp.add_argument("scenario", nargs="?", default="",
                    help="preset name (see --list)")
    sp.add_argument("--list", action="store_true", dest="list_scenarios",
                    help="enumerate scenario presets and exit")
    sp.add_argument("-seed", type=int, default=0)
    sp.add_argument("--devices", type=int, default=0,
                    help="lay the scenario's node axis over D logical "
                         "shards of the card (parallel/shard.py)")
    sp.add_argument("--exchange", default="",
                    choices=("", "alltoall", "ring"),
                    help="outbox transport of the sharded plane "
                         "(requires --devices): 'alltoall' = the plain "
                         "layout move, 'ring' = the CUDA ring kernel "
                         "(consul_tpu_torch/csrc/ring_exchange.cu); the "
                         "transports are bit-equal")
    sp.add_argument("--metrics", action="store_true", dest="metrics",
                    help="run the study with the in-scan telemetry on "
                         "(consul_tpu_torch/obs) and print the bridged "
                         "/v1/agent/metrics-shaped snapshot under "
                         "\"metrics\"")
    sp.add_argument("--policy", default="",
                    choices=("",) + SIM_POLICY_CHOICES,
                    help="chunk-selection schedule of the streamcast "
                         "plane (stream100k only; other presets reject "
                         "it): 'uniform' = a random held chunk, "
                         "'pipeline' = the round-robin cursor schedule, "
                         "'rarest' = greedy lowest index")
    _add_device(sp)

    sp = sub.add_parser(
        "sweep", help="run a universe-sweep preset: U (seed, knob, fault) "
                      "universes as one batched program "
                      "(consul_tpu_torch/sweep)"
    )
    sp.set_defaults(fn=cmd_sweep)
    sp.add_argument("preset", nargs="?", default="",
                    help="preset name (see --list)")
    sp.add_argument("--list", action="store_true", dest="list_presets",
                    help="enumerate sweep presets and exit")
    sp.add_argument("--universes", type=int, default=None,
                    help="universe count U (seed presets only; grid "
                         "presets derive U from their ladders)")
    sp.add_argument("-seed", type=int, default=0)
    sp.add_argument("--frontier-x", default="", dest="frontier_x",
                    help="robustness metric of the Pareto frontier "
                         "(default: preset-appropriate)")
    sp.add_argument("--frontier-y", default="", dest="frontier_y",
                    help="latency metric of the Pareto frontier")
    sp.add_argument("--devices", type=int, default=None,
                    help="compose the sweep with D logical node shards: U "
                         "universes x n/D nodes a shard in one batched "
                         "tick (sharded-twin entrypoints only)")
    sp.add_argument("--exchange", default="alltoall",
                    choices=("alltoall", "ring"),
                    help="outbox transport of a composed sweep "
                         "(requires --devices)")
    sp.add_argument("--optimize", action="store_true",
                    help="successive-halving/bisection over the preset's "
                         "knob ladders instead of evaluating its fixed "
                         "grid (consul_tpu_torch/sweep/optimize.py)")
    sp.add_argument("--objective", default="",
                    help="metric to optimize (--optimize; validated "
                         "against the entrypoint's metric registry)")
    sp.add_argument("--minimize", action="store_true",
                    help="minimize the objective (default: maximize)")
    sp.add_argument("--knee-at", type=float, default=None,
                    dest="knee_at",
                    help="knee mode: find the largest knob value whose "
                         "objective stays <= this threshold (e.g. "
                         "--objective window_overflow --knee-at 0)")
    sp.add_argument("--points-per-gen", type=int, default=None,
                    dest="points_per_gen",
                    help="universes per optimizer generation (U stays "
                         "constant, so every generation reuses one "
                         "batched program)")
    sp.add_argument("--max-generations", type=int, default=12,
                    dest="max_generations")
    _add_device(sp)

    sp = sub.add_parser(
        "profile",
        help="profile harness over the program registry "
             "(consul_tpu_torch/obs/profile.py): trace, first-call and "
             "execute walls, launches, device ms and peak memory per "
             "entrypoint",
    )
    sp.set_defaults(fn=cmd_profile)
    sp.add_argument("--set", "--which", default="small", dest="which",
                    choices=("small", "big", "all"),
                    help="registry tier to profile (default small; "
                         "big = the 1M-node bench shapes)")
    sp.add_argument("--entry", default="",
                    help="profile only registry entries whose name "
                         "contains this substring")
    sp.add_argument("--execute", action="store_true",
                    help="also execute each program from its initial "
                         "state, a first call and a timed one (without it "
                         "nothing is allocated: the arguments are sized "
                         "on the meta device)")
    sp.add_argument("--perfetto", default="", metavar="DIR",
                    help="additionally run one small telemetry=on study "
                         "under torch.profiler and write its Chrome trace "
                         "(DIR/trace.json, opens in Perfetto)")
    sp.add_argument("--format", choices=("text", "json"),
                    default="text")
    _add_device(sp)

    _add_analysis(sub)

    # Like the reference, version tolerates (and ignores) the client flags.
    sp = sub.add_parser("version", help="print the CLI version")
    sp.set_defaults(fn=cmd_version)
    sp.add_argument("-http-addr", default=DEFAULT_HTTP)
    sp.add_argument("-token", default="")
    return p


def _add_analysis(sub) -> None:
    """The static-analysis commands, with the reference's options (and
    ``--witness-device``, where equivlint's witnesses run)."""
    sp = sub.add_parser(
        "lint", help="tracelint: static analysis of the simulation plane")
    sp.set_defaults(fn=cmd_lint)
    sp.add_argument("paths", nargs="*",
                    help="files or directories (default: the package's "
                         "models/ sim/ ops/ ...)")
    sp.add_argument("--rules", default="",
                    help="comma-separated rule ids, e.g. R1,R3 "
                         "(default: all)")
    sp.add_argument("--list-rules", action="store_true",
                    dest="list_rules", help="enumerate rules and exit")
    sp.add_argument("--format", choices=["text", "json"], default="text",
                    dest="format",
                    help="json: machine-readable violations object")

    sp = sub.add_parser(
        "jaxlint", help="graph-level analysis of one tick of each "
                        "registered program (rules J1-J6 + the memory "
                        "budget gate)")
    sp.set_defaults(fn=cmd_jaxlint)
    sp.add_argument("--rules", default="",
                    help="comma-separated rule ids, e.g. J1,J6 "
                         "(default: all)")
    sp.add_argument("--list-rules", action="store_true",
                    dest="list_rules", help="enumerate rules and exit")
    sp.add_argument("--budget-gb", type=float, default=None,
                    dest="budget_gb",
                    help="memory budget for J6 (default: 0.9 of the card, "
                         "or of an H100 80GB HBM3 without one)")
    sp.add_argument("--format", choices=["text", "json"], default="text",
                    dest="format",
                    help="json: machine-readable findings object")
    sp.add_argument("--set", choices=["small", "big", "all"],
                    default="all", dest="which",
                    help="registry slice: small-n configs, the 1M-node "
                         "configs, or both (default)")
    sp.add_argument("--module", default="",
                    help="lint JAXLINT_PROGRAMS from a Python file "
                         "instead of the engine registry")

    sp = sub.add_parser(
        "rangelint",
        help="interval-domain abstract interpretation over the "
             "registered programs (rules J7-J9 + narrowing "
             "certificates)")
    sp.set_defaults(fn=cmd_rangelint)
    sp.add_argument("--rules", default="",
                    help="comma-separated rule ids, e.g. J7 "
                         "(default: all)")
    sp.add_argument("--list-rules", action="store_true",
                    dest="list_rules", help="enumerate rules and exit")
    sp.add_argument("--format", choices=["text", "json"], default="text",
                    dest="format")
    sp.add_argument("--set", choices=["small", "big", "all"],
                    default="all", dest="which")
    sp.add_argument("--at-n", type=int, default=0, dest="at_n",
                    help="also read the narrowing ledger at this "
                         "population via the registry scale hooks "
                         "(e.g. 10000000)")

    sp = sub.add_parser(
        "equivlint",
        help="exactness-ladder prover + golden fingerprint gate + the "
             "CUDA kernels' DMA discipline (rules E1-E3, P1-P3)")
    sp.set_defaults(fn=cmd_equivlint)
    sp.add_argument("--list-rules", action="store_true",
                    dest="list_rules", help="enumerate rules and exit")
    sp.add_argument("--format", choices=["text", "json"], default="text",
                    dest="format")
    sp.add_argument("--set", choices=["small", "big", "all"],
                    default="all", dest="which",
                    help="registry slice (default: both tiers — the "
                         "golden file covers small AND big)")
    sp.add_argument("--update-golden", action="store_true",
                    dest="update_golden",
                    help="regenerate tests/golden/torch_programs.json from "
                         "the live fingerprints (merge: entries outside "
                         "--set are kept)")
    sp.add_argument("--golden", default="",
                    help="alternate golden snapshot path")
    sp.add_argument("--no-witness", action="store_true",
                    dest="no_witness",
                    help="structural proofs only: would-be witness "
                         "executions report SKIPPED instead of running")
    sp.add_argument("--flops", action="store_true",
                    help="accepted for the reference's interface (the "
                         "port records no flops)")
    sp.add_argument("--module", default="",
                    help="lint EQUIVLINT_PROGRAMS (kernel sources) from a "
                         "Python file instead of the registry")
    _add_witness_device(sp)

    sp = sub.add_parser(
        "check",
        help="the umbrella pass: tracelint + jaxlint + rangelint + "
             "equivlint in one run, each registry program traced once, "
             "merged --format json, shared exit-code contract")
    sp.set_defaults(fn=cmd_check)
    sp.add_argument("--format", choices=["text", "json"], default="text",
                    dest="format")
    sp.add_argument("--set", choices=["small", "big", "all"],
                    default="small", dest="which",
                    help="registry slice for the graph passes (default "
                         "small; big adds the 1M configs)")
    sp.add_argument("--budget-gb", type=float, default=None,
                    dest="budget_gb",
                    help="memory budget for jaxlint J6 (default: 0.9 of "
                         "the card, or of an H100 80GB HBM3)")
    sp.add_argument("--changed", action="store_true",
                    help="git-diff-aware pre-commit mode: lint/prove only "
                         "programs whose family sources changed vs HEAD "
                         "(core-plane edits widen to the full registry)")
    sp.add_argument("--no-witness", action="store_true",
                    dest="no_witness",
                    help="equivlint structural proofs only (skip witness "
                         "executions)")
    _add_witness_device(sp)


def _add_witness_device(sp) -> None:
    sp.add_argument("--witness-device", default=None, dest="witness_device",
                    choices=("cuda", "cpu"),
                    help="where equivlint's witnesses run (default: the "
                         "card; without one they are SKIPPED unless cpu "
                         "is asked for)")


def cmd_lint(args) -> int:
    """tracelint over the simulation plane: exits nonzero on violations,
    printing ``file:line:col rule message`` lines.  Pure AST work."""
    from consul_tpu_torch.analysis.tracelint import main as tracelint_main

    argv = list(args.paths)
    if args.list_rules:
        argv.append("--list-rules")
    if args.rules:
        argv.extend(["--rules", args.rules])
    if args.format != "text":
        argv.extend(["--format", args.format])
    return tracelint_main(argv)


def cmd_jaxlint(args) -> int:
    """J1-J6 over one tick of each registered program (nothing
    allocated); exits nonzero on any finding."""
    from consul_tpu_torch.analysis.jaxlint import main as jaxlint_main

    argv = []
    if args.list_rules:
        argv.append("--list-rules")
    if args.rules:
        argv.extend(["--rules", args.rules])
    if args.budget_gb is not None:
        argv.extend(["--budget-gb", str(args.budget_gb)])
    if args.format != "text":
        argv.extend(["--format", args.format])
    if args.which != "all":
        argv.extend(["--set", args.which])
    if args.module:
        argv.extend(["--module", args.module])
    return jaxlint_main(argv)


def cmd_rangelint(args) -> int:
    """J7-J9 and the narrowing certificates; exits nonzero on any
    finding."""
    from consul_tpu_torch.analysis.rangelint import main as rangelint_main

    argv = []
    if args.list_rules:
        argv.append("--list-rules")
    if args.rules:
        argv.extend(["--rules", args.rules])
    if args.format != "text":
        argv.extend(["--format", args.format])
    if args.which != "all":
        argv.extend(["--set", args.which])
    if args.at_n:
        argv.extend(["--at-n", str(args.at_n)])
    return rangelint_main(argv)


def cmd_equivlint(args) -> int:
    """E1 over EQUIV_PAIRS, the E2/E3 golden gate, P1-P3 over
    ``csrc/*.cu``; exits nonzero on any FAILED rung, golden diff or
    kernel finding."""
    from consul_tpu_torch.analysis.equivlint import main as equivlint_main

    argv = []
    if args.list_rules:
        argv.append("--list-rules")
    if args.format != "text":
        argv.extend(["--format", args.format])
    argv.extend(["--set", "small,big" if args.which == "all"
                 else args.which])
    if args.update_golden:
        argv.append("--update-golden")
    if args.golden:
        argv.extend(["--golden", args.golden])
    if args.no_witness:
        argv.append("--no-witness")
    if args.flops:
        argv.append("--flops")
    if args.module:
        argv.extend(["--module", args.module])
    if args.witness_device:
        argv.extend(["--witness-device", args.witness_device])
    return equivlint_main(argv)


def cmd_check(args) -> int:
    """tracelint + jaxlint + rangelint + equivlint in one pass (each
    registry program traced once), merged ``--format json``, 0 clean and
    1 on any finding."""
    from consul_tpu_torch.analysis import run_check

    include = ("small", "big") if args.which == "all" else (args.which,)
    out = run_check(include=include, budget_gb=args.budget_gb,
                    changed=args.changed, witness=not args.no_witness,
                    witness_device=args.witness_device)
    if args.format == "json":
        print(json.dumps(out))
        return 0 if out["clean"] else 1
    for v in out["tracelint"]["violations"]:
        print(f"{v['path']}:{v['line']}:{v['col']} {v['rule']} "
              f"{v['message']}")
    for key in ("jaxlint", "rangelint", "equivlint"):
        for f in out[key]["findings"]:
            where = f["where"] or "<program>"
            print(f"{f['program']}: {where} {f['rule']} {f['message']}")
    el = out["equivlint"]
    n_bad = (len(out["tracelint"]["violations"])
             + len(out["jaxlint"]["findings"])
             + len(out["rangelint"]["findings"]) + len(el["findings"]))
    walls = ", ".join(f"{k} {v}s" for k, v in out["wall_s"].items())
    n_certs = sum(1 for cs in out["rangelint"]["certificates"].values()
                  for c in cs if c["saved_bytes"] > 0)
    print(f"check: {'clean' if out['clean'] else f'{n_bad} finding(s)'} "
          f"({out['tracelint']['files']} file(s), "
          f"{out['jaxlint']['programs']} program(s), {n_certs} narrowing "
          f"certificate(s), {el['proved']} proved + {el['witnessed']} "
          f"witnessed of {el['pairs']} pair(s), {el['golden_diffs']} "
          f"golden diff(s); {walls})", file=sys.stderr)
    return 0 if out["clean"] else 1


def build_runtime(args):
    """Files + flags → RuntimeConfig (the CLI half of config/builder.go:
    -config-file/-config-dir in order, flags last)."""
    from consul_tpu_torch.agent.config import Builder

    b = Builder()
    for path in args.config_file:
        b.add_file(path)
    for path in args.config_dir:
        b.add_dir(path)
    flags = {
        "node_name": args.node or None,
        "datacenter": args.datacenter,
        "server": True if (args.server or args.dev) else None,
        "bootstrap_expect": 1 if args.dev else args.bootstrap_expect,
        "bind_addr": args.bind,
        "ports_http": args.http_port,
        "ports_dns": args.dns_port,
        "data_dir": args.data_dir,
    }
    b.add_flags(flags)
    rc = b.build()
    if not args.node and rc.node_name == "node" and args.dev:
        rc = dataclasses.replace(rc, node_name="dev")
    return rc


async def cmd_agent(args) -> int:
    """Run an agent until SIGINT or SIGTERM (``consul agent``)."""
    from consul_tpu_torch.agent import Agent, AgentConfig
    from consul_tpu_torch.agent.config import reloadable_diff, thaw
    from consul_tpu_torch.agent.dns import DNSServer
    from consul_tpu_torch.agent.http import HTTPApi
    from consul_tpu_torch.net.transport import UDPTransport

    rc = build_runtime(args)
    node = rc.node_name
    server_mode = rc.server

    gossip = UDPTransport(rc.bind_addr, args.serf_port)
    rpc = UDPTransport(rc.bind_addr, args.rpc_port)
    await gossip.start()
    await rpc.start()
    agent = Agent(
        AgentConfig(
            node_name=node,
            datacenter=rc.datacenter,
            server=server_mode,
            bootstrap_expect=rc.bootstrap_expect,
            profile=rc.gossip_profile(),
            gossip_interval_scale=rc.gossip_interval_scale,
            acl_enabled=rc.acl_enabled,
            acl_default_policy=rc.acl_default_policy,
            acl_master_token=rc.acl_master_token,
            acl_agent_token=rc.acl_agent_token,
            encrypt_key=rc.encrypt,
            primary_datacenter=rc.primary_datacenter,
            acl_replication_token=rc.acl_replication_token,
            serf_snapshot_path=(
                str(Path(rc.data_dir) / "serf" / "local.snapshot")
                if rc.data_dir and server_mode
                else ""
            ),
            rejoin_after_leave=rc.rejoin_after_leave,
            auto_config_enabled=rc.auto_config_enabled,
            auto_config_intro_token=rc.auto_config_intro_token,
            auto_config_server_addresses=tuple(
                rc.auto_config_server_addresses),
            auto_config_authorizer=rc.auto_config_authorizer,
        ),
        gossip_transport=gossip,
        rpc_transport=rpc,
    )
    await agent.start()
    agent.load_definitions(
        [thaw(s) for s in rc.services], [thaw(c) for c in rc.checks]
    )
    agent.dns_only_passing = rc.dns_only_passing
    agent.dns_node_ttl_s = rc.dns_node_ttl_s
    agent.dns_recursors = list(rc.dns_recursors)
    api = HTTPApi(agent)
    http_addr = await api.start(rc.bind_addr, rc.ports_http)
    dns = DNSServer(agent)
    dns_addr = await dns.start(rc.bind_addr, rc.ports_dns)

    # SIGHUP: re-read the same sources, apply the reloadable subset
    # (agent.go reloadConfigInternal).
    def on_hup():
        """Returns None on success, the error on failure — the HTTP
        reload endpoint surfaces it to the caller (agent_endpoint.go
        AgentReload returns the error); SIGHUP just logs it."""
        nonlocal rc
        try:
            new_rc = build_runtime(args)
            apply = reloadable_diff(rc, new_rc)
            agent.reload(apply)
            rc = new_rc
            print(f"==> Reloaded configuration ({len(apply)} change(s))")
        except Exception as e:  # noqa: BLE001 - keep running on bad config
            print(f"==> Reload failed: {e}", file=sys.stderr)
            sys.stdout.flush()
            return e
        sys.stdout.flush()
        return None

    loop = asyncio.get_running_loop()
    try:
        loop.add_signal_handler(signal.SIGHUP, on_hup)
    except (NotImplementedError, AttributeError):  # pragma: no cover
        pass
    # PUT /v1/agent/reload triggers the same path as SIGHUP.
    agent.reload_handler = on_hup

    print("==> consul-tpu agent running!")
    print(f"         Node name: {node}")
    print(f"        Datacenter: {rc.datacenter}")
    print(f"            Server: {server_mode}")
    print(f"         HTTP addr: {http_addr}")
    print(f"          DNS addr: {dns_addr} (udp)")
    print(f"        Gossip via: {gossip.local_addr()}")
    print(f"          RPC addr: {rpc.local_addr()}")
    sys.stdout.flush()

    join_addrs = list(args.join) + [str(a) for a in rc.retry_join]
    if join_addrs:
        n = await agent.join(join_addrs)
        print(f"==> Joined {n} node(s)")
        sys.stdout.flush()

    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover - non-unix
            pass
    await stop.wait()
    print("==> Caught signal, gracefully leaving")
    await agent.leave()
    await api.stop()
    await dns.stop()
    await agent.shutdown()
    return 0


# ---------------------------------------------------------------------------
# client commands
# ---------------------------------------------------------------------------


def _client(args) -> ConsulClient:
    return ConsulClient(args.http_addr, token=getattr(args, "token", ""))


async def cmd_members(args) -> int:
    members = await _client(args).agent.members()
    status_names = {0: "none", 1: "alive", 2: "leaving", 3: "left",
                    4: "failed"}
    rows = [("Node", "Address", "Status", "Type", "DC")]
    for m in sorted(members, key=lambda m: m["Name"]):
        tags = m.get("Tags", {})
        rows.append((
            m["Name"], m["Addr"],
            status_names.get(m["Status"], str(m["Status"])),
            "server" if tags.get("role") == "consul" else "client",
            tags.get("dc", ""),
        ))
    _print_table(rows)
    return 0


async def cmd_join(args) -> int:
    c = _client(args)
    for addr in args.addresses:
        out = await c.agent.join(addr)
        print(f"Successfully joined cluster by contacting "
              f"{out.get('NumJoined', 0)} nodes.")
    return 0


async def cmd_leave(args) -> int:
    await _client(args).agent.leave()
    print("Graceful leave complete")
    return 0


async def cmd_force_leave(args) -> int:
    await _client(args).agent.force_leave(args.node)
    print(f"Force-left {args.node}")
    return 0


async def cmd_info(args) -> int:
    c = _client(args)
    self_info = await c.agent.self()
    leader = await c.status.leader()
    peers = await c.status.peers()
    print(json.dumps({"agent": self_info, "leader": leader,
                      "peers": peers}, indent=2, default=str))
    return 0


async def cmd_kv(args) -> int:
    c = _client(args)
    if args.verb == "get":
        if args.keys:
            keys, _ = await c.kv.keys(args.key)
            print("\n".join(keys))
        elif args.recurse:
            entries, _ = await c.kv.list(args.key)
            for e in entries:
                print(f"{e['Key']}:{e['Value'].decode(errors='replace')}")
        else:
            entry, _ = await c.kv.get(args.key)
            if entry is None:
                print(f"Error! No key exists at: {args.key}", file=sys.stderr)
                return 1
            if args.detailed:
                print(json.dumps(
                    {k: v for k, v in entry.items() if k != "Value"},
                    indent=2))
            print(entry["Value"].decode(errors="replace"))
    elif args.verb == "put":
        value = (args.value or "").encode()
        if args.value and args.value.startswith("@"):
            with open(args.value[1:], "rb") as f:
                value = f.read()
        await c.kv.put(args.key, value)
        print(f"Success! Data written to: {args.key}")
    elif args.verb == "delete":
        await c.kv.delete(args.key, recurse=args.recurse)
        print(f"Success! Deleted key: {args.key}")
    elif args.verb == "export":
        entries, _ = await c.kv.list(args.key)
        out = [{"key": e["Key"], "flags": e.get("Flags", 0),
                "value": base64.b64encode(e["Value"]).decode()}
               for e in entries]
        print(json.dumps(out, indent=2))
    elif args.verb == "import":
        data = json.loads(sys.stdin.read())
        for item in data:
            await c.kv.put(item["key"], base64.b64decode(item["value"]),
                           flags=item.get("flags", 0))
        print(f"Imported: {len(data)} keys")
    return 0


async def cmd_catalog(args) -> int:
    c = _client(args)
    if args.what == "datacenters":
        print("\n".join(await c.catalog.datacenters()))
    elif args.what == "nodes":
        nodes, _ = await c.catalog.nodes()
        rows = [("Node", "Address")]
        rows += [(n["Node"], n["Address"]) for n in nodes]
        _print_table(rows)
    elif args.what == "services":
        services, _ = await c.catalog.services()
        rows = [("Service", "Tags")]
        rows += [(name, ",".join(tags)) for name, tags in sorted(
            services.items())]
        _print_table(rows)
    return 0


async def cmd_event(args) -> int:
    out = await _client(args).event.fire(args.name, args.payload.encode())
    print(f"Event ID: {out['ID']}")
    return 0


async def cmd_watch(args) -> int:
    params = {"type": args.wtype}
    for field in ("key", "prefix", "service", "tag", "state", "name"):
        if getattr(args, field):
            params[field] = getattr(args, field)
    if args.passingonly:
        params["passingonly"] = True
    plan = parse_watch(params, _client(args))
    done = asyncio.Event()

    def handler(index, data):
        print(json.dumps({"index": index, "data": data}, indent=2,
                         default=_json_bytes))
        sys.stdout.flush()
        if args.once:
            done.set()

    plan.on_change(handler)
    plan.start()
    if args.once:
        await done.wait()
    else:
        await asyncio.Event().wait()  # until Ctrl-C
    plan.stop()
    return 0


async def cmd_session(args) -> int:
    c = _client(args)
    if args.verb == "list":
        sessions, _ = await c.session.list()
        rows = [("ID", "Node", "TTL", "Behavior")]
        rows += [(s["ID"], s["Node"], str(s.get("TTL", "")),
                  s.get("Behavior", "")) for s in sessions]
        _print_table(rows)
    elif args.verb == "destroy":
        await c.session.destroy(args.sid)
        print(f"Destroyed session {args.sid}")
    elif args.verb == "info":
        sess, _ = await c.session.info(args.sid)
        print(json.dumps(sess, indent=2))
    return 0


async def cmd_lock(args) -> int:
    """command/lock: acquire <prefix>/.lock with a session, run the
    command, release (reference lock command semantics)."""
    c = _client(args)
    sid = await c.session.create({"TTL": "15s"})
    key = f"{args.prefix.rstrip('/')}/.lock"
    try:
        while not await c.kv.put(key, b"", acquire=sid):
            await asyncio.sleep(0.2)
        proc = await asyncio.create_subprocess_shell(args.shell_command)
        renew = asyncio.create_task(_renew_loop(c, sid))
        code = await proc.wait()
        renew.cancel()
        return code
    finally:
        try:
            await c.kv.put(key, b"", release=sid)
            await c.session.destroy(sid)
        except Exception:  # noqa: BLE001 — best effort cleanup
            pass


async def _renew_loop(c: ConsulClient, sid: str) -> None:
    while True:
        await asyncio.sleep(5)
        await c.session.renew(sid)


async def cmd_acl(args) -> int:
    """command/acl: bootstrap, token list/create/delete, policy ..."""
    c = _client(args)
    if args.subsystem == "bootstrap":
        tok = await c.acl.bootstrap()
        print(f"SecretID: {tok['SecretID']}")
        return 0
    import json as _json

    if args.subsystem == "token":
        if args.verb == "list":
            for t in await c.acl.token_list():
                print(f"{t.get('SecretID', '')}\t{t.get('Type', '')}\t"
                      f"{t.get('Description', '')}")
        elif args.verb == "create":
            tok = await c.acl.token_create(
                _json.loads(args.arg) if args.arg else {}
            )
            print(f"SecretID: {tok['SecretID']}")
        elif args.verb == "read":
            tok = await c.acl.token_read(args.arg)
            print(_json.dumps(tok, indent=2))
        else:
            await c.acl.token_delete(args.arg)
            print("deleted")
        return 0
    if args.subsystem == "role":
        if args.verb == "list":
            for r in await c.acl.role_list():
                print(f"{r.get('ID', '')}\t{r.get('Name', '')}")
        elif args.verb == "create":
            r = await c.acl.role_create(_json.loads(args.arg))
            print(f"ID: {r['ID']}")
        elif args.verb == "read":
            r = await c.acl.role_read(name=args.arg)
            print(_json.dumps(r, indent=2))
        else:
            await c.acl.role_delete(args.arg)
            print("deleted")
        return 0
    if args.subsystem == "auth-method":
        if args.verb == "list":
            for mth in await c.acl.auth_method_list():
                print(f"{mth.get('Name', '')}\t{mth.get('Type', '')}")
        elif args.verb == "create":
            mth = await c.acl.auth_method_create(_json.loads(args.arg))
            print(f"Name: {mth['Name']}")
        elif args.verb == "read":
            mth = await c.acl.auth_method_read(args.arg)
            print(_json.dumps(mth, indent=2))
        else:
            await c.acl.auth_method_delete(args.arg)
            print("deleted")
        return 0
    if args.subsystem == "binding-rule":
        if args.verb == "list":
            for br in await c.acl.binding_rule_list():
                print(f"{br.get('ID', '')}\t{br.get('AuthMethod', '')}\t"
                      f"{br.get('BindType', '')}:{br.get('BindName', '')}")
        elif args.verb == "create":
            br = await c.acl.binding_rule_create(_json.loads(args.arg))
            print(f"ID: {br['ID']}")
        elif args.verb == "read":
            br = await c.acl.binding_rule_read(args.arg)
            print(_json.dumps(br, indent=2))
        else:
            await c.acl.binding_rule_delete(args.arg)
            print("deleted")
        return 0
    if args.verb == "list":
        for pl in await c.acl.policy_list():
            print(f"{pl.get('ID', '')}\t{pl.get('Name', '')}")
    elif args.verb == "create":
        pl = await c.acl.policy_create(_json.loads(args.arg))
        print(f"ID: {pl['ID']}")
    elif args.verb == "read":
        pl = await c.acl.policy_read(args.arg)
        print(_json.dumps(pl, indent=2))
    else:
        await c.acl.policy_delete(args.arg)
        print("deleted")
    return 0


async def cmd_login(args) -> int:
    """command/login: exchange an auth-method bearer token for a
    Consul token (command/acl/authmethod login.go)."""
    c = _client(args)
    tok = await c.acl.login(args.method, args.bearer_token)
    secret = tok.get("SecretID", "")
    if args.token_sink_file:
        import os as _os
        fd = _os.open(args.token_sink_file,
                      _os.O_WRONLY | _os.O_CREAT | _os.O_TRUNC, 0o600)
        with _os.fdopen(fd, "w") as f:
            f.write(secret)
        print(f"token written to {args.token_sink_file}")
    else:
        print(f"SecretID: {secret}")
    return 0


async def cmd_validate(args) -> int:
    """command/validate: parse + validate config sources without
    starting an agent (config/builder.go Validate)."""
    from pathlib import Path as _Path

    from consul_tpu_torch.agent.config import Builder, ConfigError

    b = Builder()
    try:
        for path in args.paths:
            if _Path(path).is_dir():
                b.add_dir(path)
            else:
                b.add_file(path)
        b.build()
    except (ConfigError, OSError, ValueError) as e:
        print(f"Config validation failed: {e}", file=sys.stderr)
        return 1
    print("Configuration is valid!")
    return 0


async def cmd_reload(args) -> int:
    """command/reload: PUT /v1/agent/reload (agent_endpoint.go
    AgentReload) — same effect as SIGHUP."""
    await _client(args).write("PUT", "/v1/agent/reload")
    print("Configuration reload triggered")
    return 0


async def cmd_maint(args) -> int:
    """command/maint: service or node maintenance toggle
    (agent.go:3411 EnableServiceMaintenance)."""
    if args.enable == args.disable:
        print("exactly one of -enable / -disable is required",
              file=sys.stderr)
        return 1
    c = _client(args)
    params = {"enable": "true" if args.enable else "false"}
    if args.reason:
        params["reason"] = args.reason
    if args.service:
        path = f"/v1/agent/service/maintenance/{args.service}"
    else:
        path = "/v1/agent/maintenance"
    await c.write("PUT", path, params=params)
    print("maintenance " + ("enabled" if args.enable else "disabled"))
    return 0


async def cmd_logout(args) -> int:
    """command/logout: destroy the login token in use."""
    c = _client(args)
    await c.acl.logout()
    print("logged out")
    return 0


async def cmd_debug(args) -> int:
    """command/debug: capture agent state (self, members, metrics,
    host) into a tar.gz bundle for offline analysis."""
    import io
    import tarfile
    import time as _time

    c = _client(args)
    captures = {}
    for name, path in (
        ("self.json", "/v1/agent/self"),
        ("members.json", "/v1/agent/members"),
        ("metrics.json", "/v1/agent/metrics"),
        ("host.json", "/v1/agent/host"),
    ):
        status, _, data = await c.request("GET", path)
        captures[name] = json.dumps(
            data if status == 200 else {"error": status}, indent=2,
            default=str,
        ).encode()
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, data in captures.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = int(_time.time())
            tar.addfile(info, io.BytesIO(data))
    with open(args.output, "wb") as fh:
        fh.write(buf.getvalue())
    print(f"Saved debug bundle to {args.output}")
    return 0


async def cmd_keygen(args) -> int:
    """command/keygen: a fresh 32-byte key, base64."""
    from consul_tpu_torch.net.security import generate_key

    print(generate_key())
    return 0


async def cmd_keyring(args) -> int:
    """command/keyring: -list/-install/-use/-remove over
    /v1/operator/keyring."""
    c = _client(args)
    method = {"list": "GET", "install": "POST", "use": "PUT",
              "remove": "DELETE"}[args.verb]
    body = {"Key": args.key} if args.verb != "list" else None
    status, _, data = await c.request(method, "/v1/operator/keyring",
                                      body=body)
    if status != 200:
        print(f"Error: HTTP {status}: {data}", file=sys.stderr)
        return 1
    print(json.dumps(data, indent=2, default=str))
    return 0


async def cmd_snapshot(args) -> int:
    """command/snapshot: save streams the archive to disk, restore
    uploads and installs it (inspect via the SHA256SUMS manifest)."""
    c = _client(args)
    if args.verb == "save":
        status, _, data = await c.request("GET", "/v1/snapshot")
        if status != 200:
            print(f"Error: HTTP {status}: {data}", file=sys.stderr)
            return 1
        with open(args.file, "wb") as fh:
            fh.write(data if isinstance(data, bytes) else bytes(data))
        print(f"Saved snapshot to {args.file}")
        return 0
    with open(args.file, "rb") as fh:
        blob = fh.read()
    status, _, data = await c.request("PUT", "/v1/snapshot", raw_body=blob)
    if status != 200:
        print(f"Error: HTTP {status}: {data}", file=sys.stderr)
        return 1
    print("Restored snapshot")
    return 0


async def cmd_operator(args) -> int:
    out = await _client(args).operator.raft_configuration()
    rows = [("Node", "Address", "State", "Voter")]
    for s in out.get("Servers", []):
        rows.append((s["ID"], s["Address"],
                     "leader" if s["Leader"] else "follower",
                     str(s["Voter"]).lower()))
    _print_table(rows)
    return 0


async def cmd_rtt(args) -> int:
    """command/rtt: Vivaldi distance between two nodes' coordinates."""
    c = _client(args)
    node2 = args.node2
    if not node2:
        self_info = await c.agent.self()
        node2 = self_info["Config"]["NodeName"]
    c1, _ = await c.coordinate.node(args.node1)
    c2, _ = await c.coordinate.node(node2)
    if not c1 or not c2:
        print("Error: coordinates not yet available", file=sys.stderr)
        return 1
    rtt = _coord_distance(c1[0]["Coord"], c2[0]["Coord"])
    print(f"Estimated {args.node1} <-> {node2} rtt: {rtt * 1000:.3f} ms")
    return 0


def _coord_distance(a: dict, b: dict) -> float:
    """coordinate.Coordinate.DistanceTo (Vivaldi 8-D + height)."""
    vec_a, vec_b = a.get("Vec", []), b.get("Vec", [])
    dist = math.sqrt(sum((x - y) ** 2 for x, y in zip(vec_a, vec_b)))
    dist += a.get("Height", 0.0) + b.get("Height", 0.0)
    adjusted = dist + a.get("Adjustment", 0.0) + b.get("Adjustment", 0.0)
    return max(adjusted, 0.0)


async def cmd_services(args) -> int:
    c = _client(args)
    if args.verb == "register":
        raw = sys.stdin.read() if args.arg == "-" else open(args.arg).read()
        await c.agent.service_register(json.loads(raw))
        print("Registered service")
    else:
        await c.agent.service_deregister(args.arg)
        print(f"Deregistered service: {args.arg}")
    return 0


async def cmd_monitor(args) -> int:
    """Stream the agent's live logs (command/monitor → chunked
    /v1/agent/monitor, agent_endpoint.go:1140)."""
    from consul_tpu_torch.api.client import APIError

    c = _client(args)
    try:
        async for chunk in c.stream(
            f"/v1/agent/monitor?loglevel={args.log_level}"
        ):
            sys.stdout.write(chunk.decode(errors="replace"))
            sys.stdout.flush()
    except APIError as e:
        print(f"monitor failed: {e}", file=sys.stderr)
        return 1
    except (asyncio.IncompleteReadError, KeyboardInterrupt):
        pass
    return 0


async def cmd_connect(args) -> int:
    """connect subcommands (command/connect): run the built-in sidecar
    proxy, rotate the CA, or print a compiled discovery chain."""
    c = _client(args)
    if args.verb == "ca-rotate":
        out = await c.write("PUT", "/v1/connect/ca/rotate")
        print(f"New active root: {out.get('RootID', '')}")
        return 0
    if args.verb == "chain":
        if not args.service:
            print("Error: chain requires a service name", file=sys.stderr)
            return 1
        out, _ = await c.read(f"/v1/discovery-chain/{args.service}")
        print(json.dumps(out, indent=2, default=_json_bytes))
        return 0
    # proxy: run until interrupted (connect/proxy/proxy.go main loop).
    if not args.sidecar_for:
        print("Error: -sidecar-for is required", file=sys.stderr)
        return 1
    from consul_tpu_torch.connect.proxy import ConnectProxy

    port = args.listen_port
    if not port:
        services = await c.agent.services()
        svc = services.get(args.sidecar_for)
        if svc is None:
            print(f"Error: no registered service {args.sidecar_for!r}",
                  file=sys.stderr)
            return 1
        port = int(svc.get("Port", 0))
    proxy = await ConnectProxy(args.sidecar_for, args.http_addr,
                               public_port=port).start()
    print(f"==> proxy for {args.sidecar_for} listening "
          f"(public mTLS {proxy.public_addr})")
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass
    await stop.wait()
    await proxy.stop()
    return 0


async def cmd_intention(args) -> int:
    """intention subcommands (command/intention)."""
    c = _client(args)
    if args.verb == "list":
        out, _ = await c.read("/v1/connect/intentions")
        rows = [("ID", "Source", "Destination", "Action")]
        for i in out or []:
            rows.append((i.get("ID", "")[:8], i.get("Source", ""),
                         i.get("Destination", ""), i.get("Action", "")))
        _print_table(rows)
        return 0
    if not args.src or not args.dst:
        print("Error: need SRC and DST", file=sys.stderr)
        return 1
    if args.verb == "create":
        out = await c.write("POST", "/v1/connect/intentions", body={
            "Source": args.src, "Destination": args.dst,
            "Action": "deny" if args.deny else "allow",
        })
        print(f"Created: {out.get('ID', '')}")
        return 0
    if args.verb == "check":
        out, _ = await c.read(
            "/v1/connect/intentions/check",
            params={"source": args.src, "target": args.dst})
        print("Allowed" if out.get("Authorized") else "Denied")
        return 0 if out.get("Authorized") else 2
    # delete: find by pair.
    out, _ = await c.read("/v1/connect/intentions")
    for i in out or []:
        if i.get("Source") == args.src and i.get("Destination") == args.dst:
            await c.write("DELETE", f"/v1/connect/intentions/{i['ID']}")
            print(f"Deleted: {i['ID']}")
            return 0
    print("Error: no such intention", file=sys.stderr)
    return 1


def cmd_version(args) -> int:
    print(f"consul-tpu v{__version__}")
    return 0


def cmd_sim(args) -> int:
    """Run (or list) the simulator's scenario presets."""
    from consul_tpu_torch.sim.scenarios import SCENARIOS, run_scenario

    if args.list_scenarios:
        for name in sorted(SCENARIOS):
            doc = (SCENARIOS[name].__doc__ or "").strip().splitlines()
            first = doc[0].strip() if doc else ""
            print(f"{name:<12} {first}")
        return 0
    if not args.scenario:
        print("Error: scenario name required (or --list)", file=sys.stderr)
        return 1
    out = run_scenario(args.scenario, seed=args.seed,
                       devices=args.devices or None,
                       exchange=args.exchange or None,
                       telemetry=args.metrics,
                       policy=args.policy or None,
                       device=args.device)
    print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_sweep(args) -> int:
    """Run (or list) the universe-sweep presets.  The summary JSON carries
    universes/s, the per-universe metric stats and the robustness/latency
    Pareto frontier where the preset defines both axes."""
    import numpy as np

    from consul_tpu_torch.sweep.presets import PRESETS, make_preset

    if args.list_presets:
        for name in sorted(PRESETS):
            doc = (PRESETS[name].__doc__ or "").strip().splitlines()
            print(f"{name:<12} {doc[0].strip() if doc else ''}")
        return 0
    if not args.preset:
        print("Error: preset name required (or --list)", file=sys.stderr)
        return 1
    universe = make_preset(args.preset, universes=args.universes,
                           seed=args.seed, device=args.device)

    # Requested frontier axes are checked against the entrypoint's metric
    # registry before the sweep runs: a typo must not cost a sweep.  Only
    # the default axes may fall back when a preset lacks them.
    from consul_tpu_torch.sweep.frontier import ENTRYPOINT_METRICS

    known = ENTRYPOINT_METRICS[universe.entrypoint]
    for requested in (args.frontier_x, args.frontier_y):
        if requested and requested not in known:
            print(
                f"Error: unknown frontier metric {requested!r} for "
                f"{universe.entrypoint!r} sweeps "
                f"(have: {', '.join(sorted(known))})",
                file=sys.stderr,
            )
            return 1

    # The sweep x shard composition: entrypoints without a sharded twin
    # are rejected before anything runs, as the axis typos are.
    mesh = None
    if args.exchange != "alltoall" and args.devices is None:
        print("Error: --exchange requires --devices (the outbox "
              "transport only exists on the composed plane)",
              file=sys.stderr)
        return 1
    if args.devices is not None:
        from consul_tpu_torch.sweep.universe import SWEEP_ENTRYPOINTS

        if SWEEP_ENTRYPOINTS[universe.entrypoint].sharded is None:
            composable = sorted(
                n for n, s in SWEEP_ENTRYPOINTS.items() if s.sharded
            )
            print(
                f"Error: entrypoint {universe.entrypoint!r} has no "
                f"sharded twin — --devices composes: "
                f"{', '.join(composable)}",
                file=sys.stderr,
            )
            return 1
        from consul_tpu_torch.parallel.mesh import mesh_for

        try:
            mesh = mesh_for(args.devices)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    if not args.optimize:
        # Optimizer flags without --optimize would silently run the full
        # fixed grid.
        stray = [flag for flag, hit in (
            ("--objective", bool(args.objective)),
            ("--minimize", args.minimize),
            ("--knee-at", args.knee_at is not None),
            ("--points-per-gen", args.points_per_gen is not None),
            ("--max-generations", args.max_generations != 12),
        ) if hit]
        if stray:
            print(f"Error: {', '.join(stray)} require(s) --optimize",
                  file=sys.stderr)
            return 1

    if args.optimize:
        if not args.objective:
            print("Error: --optimize requires --objective "
                  f"(metrics for {universe.entrypoint!r}: "
                  f"{', '.join(sorted(known))})", file=sys.stderr)
            return 1
        from consul_tpu_torch.sweep import optimize

        try:
            result = optimize.optimize_sweep(
                universe, args.objective,
                minimize=args.minimize, knee_at=args.knee_at,
                points_per_gen=args.points_per_gen,
                max_generations=args.max_generations,
                device=args.device, mesh=mesh, exchange=args.exchange,
            )
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        out = result.summary()
        if mesh is not None:
            out["devices"] = args.devices
            out["exchange"] = args.exchange
        print(json.dumps(out, indent=2, default=str))
        return 0

    from consul_tpu_torch.sim import engine

    # No warm-up run: the command's deliverable is the study's summary, not
    # a steady-state time.
    report = engine.run_sweep(universe, warmup=False, mesh=mesh,
                              exchange=args.exchange, device=args.device)
    out = report.summary()

    def _defined(name):
        return name in report.metrics and not np.all(
            np.isnan(np.asarray(report.metrics[name], np.float64))
        )

    fx = args.frontier_x or (
        "false_dead_mean" if _defined("false_dead_mean") else ""
    )
    fy = args.frontier_y or (
        "detect_t90_ms" if _defined("detect_t90_ms")
        else "first_suspect_ms"
    )
    if fx and _defined(fx) and _defined(fy):
        out["frontier"] = report.frontier(x=fx, y=fy)
        out["frontier_axes"] = [fx, fy]
    elif args.frontier_x or args.frontier_y:
        # A requested axis is never dropped silently: say which half of
        # the pair this study failed to provide (absent or all NaN).
        bad = next((m for m in (fx, fy) if m and not _defined(m)), None)
        what = (
            f"metric {bad!r} is not defined for this study"
            if bad else
            "no robustness axis is defined for this study "
            "(pass --frontier-x)"
        )
        have = [m for m in sorted(report.metrics) if _defined(m)]
        print(
            f"Error: cannot build the requested frontier: {what} "
            f"(defined: {', '.join(have)})",
            file=sys.stderr,
        )
        return 1
    print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_profile(args) -> int:
    """The profile harness (``obs/profile.py``) over the program registry
    (``sim/registry.py``): each program's trace wall and argument bytes,
    and with ``--execute`` its first-call and execute walls, launches,
    device ms and peak memory."""
    from consul_tpu_torch.obs.profile import (
        profile_registry,
        run_with_profiler,
    )
    from consul_tpu_torch.sim.registry import jaxlint_registry

    include = ("small", "big") if args.which == "all" else (args.which,)
    programs = jaxlint_registry(include=include)
    if args.entry:
        programs = {k: v for k, v in programs.items() if args.entry in k}
        if not programs:
            print(f"Error: no registry entry matches {args.entry!r}",
                  file=sys.stderr)
            return 1
    profiles = profile_registry(programs, execute=args.execute,
                                device=args.device)
    if args.perfetto:
        # One small telemetry=on study under the profiler: the trace
        # capture path (Perfetto UI).
        from consul_tpu_torch.models import BroadcastConfig
        from consul_tpu_torch.sim.engine import run_broadcast

        run_with_profiler(
            args.perfetto,
            lambda: run_broadcast(
                BroadcastConfig(n=4096, fanout=4, delivery="edges"),
                steps=30, warmup=True, telemetry=True, device=args.device,
            ),
        )
        print(f"perfetto trace written under {args.perfetto}",
              file=sys.stderr)
    if args.format == "json":
        print(json.dumps({"programs": [p.to_json() for p in profiles]}))
        return 0
    rows = [("PROGRAM", "FLOPS", "BYTES", "TRACE_S", "COMPILE_S",
             "EXECUTE_S", "LAUNCHES", "DEVICE_MS", "PEAK_BYTES")]

    def opt(v, fmt):
        return "-" if v is None else format(v, fmt)

    for p in profiles:
        rows.append((
            p.name, opt(p.flops, ".3g"), opt(p.bytes_accessed, ".3g"),
            f"{p.trace_s:.2f}", opt(p.compile_s, ".2f"),
            (f"{p.execute_s:.3f}" if p.execute_s is not None
             else (p.execute_skipped or "-")),
            opt(p.launches, "d"), opt(p.device_ms, ".3f"),
            opt(p.peak_bytes, "d"),
        ))
    _print_table(rows)
    return 0


def _print_table(rows: list[tuple]) -> None:
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(rows[0]))]
    for row in rows:
        print("  ".join(str(v).ljust(w) for v, w in zip(row, widths)).rstrip())



def _json_bytes(obj):
    if isinstance(obj, bytes):
        return obj.decode(errors="replace")
    return str(obj)


if __name__ == "__main__":
    sys.exit(main())
