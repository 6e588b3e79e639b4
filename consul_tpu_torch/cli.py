"""The command line: ``python -m consul_tpu_torch.cli``.

The port of the ``sim``, ``sweep``, ``profile``, ``agent`` and
``version`` commands of ``consul_tpu/cli.py``, with their flags, their
checks before anything runs and their output:

    python -m consul_tpu_torch.cli sim --list
    python -m consul_tpu_torch.cli sim event100k --devices 8 \
        --exchange ring --metrics
    python -m consul_tpu_torch.cli sweep seeds4k --universes 64
    python -m consul_tpu_torch.cli profile --which big --execute
    python -m consul_tpu_torch.cli agent -dev
    python -m consul_tpu_torch.cli agent -config-file agent.hcl

``--devices D`` lays the study over D logical shards of one card
(``parallel.mesh_for``).  ``--device`` (the one flag the reference lacks)
names the device the study runs on: the current CUDA card unless given,
``cpu`` to run on the host.  ``agent`` runs a Consul agent over UDP with
its HTTP API and DNS (host code, no ``torch``); the reference's other
agent commands talk to it through the API client, which is not ported
yet.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import signal
import sys
from pathlib import Path
from typing import Optional

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
        return args.fn(args) or 0
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

    # Like the reference, version tolerates (and ignores) the client flags.
    sp = sub.add_parser("version", help="print the CLI version")
    sp.set_defaults(fn=cmd_version)
    sp.add_argument("-http-addr", default=DEFAULT_HTTP)
    sp.add_argument("-token", default="")
    return p


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


def cmd_agent(args) -> int:
    """Run an agent until SIGINT or SIGTERM (``consul agent``)."""
    return asyncio.run(_run_agent(args))


async def _run_agent(args) -> int:
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


if __name__ == "__main__":
    sys.exit(main())
