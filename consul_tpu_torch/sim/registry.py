"""The program registry and the exactness ladder as data.

The port of the registry section of ``consul_tpu/sim/engine.py``: every
study entrypoint of the port at two configurations, "small" (the shapes
the unit tests pin) and "big" (the 1M-node north-star configurations of
``bench.py``), under the reference's names and in its order, and
:data:`EQUIV_PAIRS`, the rungs of the bit-equality ladder between them.

A :class:`SimProgram` carries no tensor.  ``build()`` returns ``(fn,
make_args)``; ``make_args(device)`` allocates the program's arguments,
its own initial state and ``PRNGKey(0)`` (a sweep: the state stacked U
times, U copies of the key and the configuration's own knob values), only
when it is called.  ``make_args("meta")`` is the port's ``jax.eval_shape``:
shapes and dtypes with no storage, so :meth:`SimProgram.state_bytes` of a
10M-node program costs nothing.  The sharded twins run over D logical
shards of one device, so every D registers whatever the device count.

The reference's analyzer metadata (``x64``, ``bounds``, ``trace()``)
serves jaxlint, rangelint and tracelint, which are not ported; the
registry carries none of it.  :func:`walk_equiv_pairs` executes both
sides of each rung and compares them bit for bit, the port's form of
equivlint's WITNESSED verdict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from consul_tpu_torch.geo.model import GeoConfig, geo_init
from consul_tpu_torch.models import (
    BroadcastConfig,
    LifeguardConfig,
    MembershipConfig,
    MultiDCConfig,
    SparseMembershipConfig,
    SwimConfig,
    broadcast_init,
    lifeguard_init,
    membership_init,
    multidc_init,
    sparse_membership_init,
    swim_init,
)
from consul_tpu_torch.models.membership_sparse import resolve_amortize
from consul_tpu_torch.obs.profile import tree_bytes
from consul_tpu_torch.ops import PRNGKey
from consul_tpu_torch.parallel.mesh import make_mesh
from consul_tpu_torch.parallel.shard import (
    SHARDED_EXTRA_OVERFLOW,
    SHARDED_TWINS,
    sharded_broadcast_scan,
    sharded_geo_scan,
    sharded_membership_scan,
    sharded_sparse_membership_scan,
    sharded_streamcast_scan,
)
from consul_tpu_torch.protocol import LAN, WAN
from consul_tpu_torch.sim.engine import (
    broadcast_scan,
    geo_scan,
    lifeguard_scan,
    membership_scan,
    multidc_scan,
    sparse_membership_scan,
    streamcast_scan,
    swim_scan,
)
from consul_tpu_torch.streamcast.model import StreamcastConfig, streamcast_init

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class SimProgram:
    """One registered study program.

    ``build()`` returns ``(fn, make_args)``: ``fn`` closes over the static
    configuration, and ``fn(*make_args(device))`` runs the study on
    ``device`` from the program's initial state.  ``per_chip`` marks the
    sharded twins (``devices`` logical shards); ``abstract_only`` marks a
    program that is sized but never executed (``sparse@10m``);
    ``budgeted`` is carried as the reference declares it (every
    registered program sets it; ``chip_smoke.py`` holds every executed
    program under ``obs.profile.memory_gate``).  ``scale`` rebuilds the
    same entrypoint at another population, ``init(device)`` builds the
    initial state alone (None for the sweep programs, whose arguments are
    ``(stacked_state, keys, knob_values)``).  ``steps`` is the study's
    length and ``at_steps(t)`` the same ``fn`` cut to ``t`` ticks, on the
    same arguments: the profile's bounded window."""

    name: str
    entrypoint: str
    build: Callable[[], tuple]
    n: int
    devices: int = 1
    per_chip: bool = False
    budgeted: bool = True
    note: str = ""
    abstract_only: bool = False
    scale: Optional[Callable[[int], "SimProgram"]] = None
    init: Optional[Callable[[Any], Any]] = None
    steps: Optional[int] = None
    at_steps: Optional[Callable[[int], Callable]] = None

    def state_bytes(self) -> int:
        """Bytes of the program's arguments, from their shapes on the
        ``meta`` device (the default device too, so an init's staging of
        config values lands there): nothing is allocated."""
        _, make_args = self.build()
        with META:
            return tree_bytes(make_args(META))


def _program(name: str, entrypoint: str, init: Callable, scan: Callable,
             cfg, steps: int, rest: tuple = (), **kw) -> SimProgram:
    """The program ``scan(state, key, cfg, steps, *rest)`` from
    ``init(cfg, device=...)`` and ``PRNGKey(0)``; ``n`` is the config's
    population unless given."""

    def init_on(device):
        return init(cfg, device=device)

    def at_steps(t: int) -> Callable:
        return lambda s, k: scan(s, k, cfg, t, *rest)

    def make_args(device):
        device = torch.device(device)
        return init_on(device), PRNGKey(0, device=device)

    def build():
        return at_steps(steps), make_args

    kw.setdefault("n", cfg.base.n if hasattr(cfg, "base") else cfg.n)
    return SimProgram(name=name, entrypoint=entrypoint, build=build,
                      init=init_on, steps=steps, at_steps=at_steps, **kw)


def sparse_program_at(n: int, steps: int = 3,
                      track: tuple = (42,)) -> SimProgram:
    """The sparse membership entrypoint at population ``n`` (the big
    entries' ``scale``): the big configuration's K, loss, profile and
    crash."""
    cfg = SparseMembershipConfig(
        base=MembershipConfig(n=n, loss=0.01, profile=LAN,
                              fail_at=((42, 5),)),
        k_slots=64,
    )
    return _program(f"sparse@n={n}", "sparse_membership_scan",
                    sparse_membership_init, sparse_membership_scan, cfg,
                    steps, (track,))


def swim_program_at(n: int, steps: int = 450) -> SimProgram:
    """The swim entrypoint at population ``n`` (the headline's config)."""
    cfg = SwimConfig(n=n, subject=42, loss=0.30, profile=WAN,
                     delivery="aggregate")
    return _program(f"swim@n={n}", "swim_scan", swim_init, swim_scan, cfg,
                    steps)


def broadcast_program_at(n: int, steps: int = 60) -> SimProgram:
    """The broadcast entrypoint at population ``n`` (aggregate, LAN)."""
    cfg = BroadcastConfig(n=n, fanout=4, profile=LAN, delivery="aggregate")
    return _program(f"broadcast@n={n}", "broadcast_scan", broadcast_init,
                    broadcast_scan, cfg, steps)


# Each family's initial state and scan, by the registry's name for it.
_FAMILIES = {
    "broadcast": (broadcast_init, broadcast_scan),
    "membership": (membership_init, membership_scan),
    "sparse": (sparse_membership_init, sparse_membership_scan),
    "swim": (swim_init, swim_scan),
    "lifeguard": (lifeguard_init, lifeguard_scan),
    "multidc": (multidc_init, multidc_scan),
    "streamcast": (streamcast_init, streamcast_scan),
    "geo": (geo_init, geo_scan),
}
_SHARDED_SCANS = {
    "sharded_broadcast_scan": sharded_broadcast_scan,
    "sharded_membership_scan": sharded_membership_scan,
    "sharded_sparse_membership_scan": sharded_sparse_membership_scan,
    "sharded_streamcast_scan": sharded_streamcast_scan,
    "sharded_geo_scan": sharded_geo_scan,
}


def jaxlint_registry(include=("small", "big"),
                     sharded_devices=(1, 2)) -> dict[str, SimProgram]:
    """The registry under the reference's name: the dense/sparse/broadcast
    scans, their sharded twins at D in ``sharded_devices`` (logical
    shards, each with a ``/ring`` twin at small n), Lifeguard, SWIM,
    multi-DC, streamcast and geo, their telemetry twins and the sweep
    programs, at the small and the 1M-node configurations.  Names, order,
    configurations and steps are the reference's with 8 devices (its
    sharded entries need D devices; the port's need none).  The dense
    membership entries register at n=16384, the [n, n] representation's
    ceiling on one chip."""
    from consul_tpu_torch.sweep.universe import abstract_sweep_program

    programs: dict[str, SimProgram] = {}

    def add(name: str, family: str, cfg, steps: int, *rest, **kw) -> None:
        """``{family}_scan(state, key, cfg, steps, *rest)``."""
        init, scan = _FAMILIES[family]
        programs[name] = _program(name, scan.__name__, init, scan, cfg,
                                  steps, rest, **kw)

    def add_twin(name: str, family: str, cfg, steps: int, d: int,
                 *rest) -> None:
        """The sharded twin over ``d`` logical shards:
        ``sharded_{family}_scan(state, key, cfg, steps, mesh, *rest)``."""
        init, scan = _FAMILIES[family]
        entrypoint = "sharded_" + scan.__name__
        programs[name] = _program(
            name, entrypoint, init, _SHARDED_SCANS[entrypoint], cfg, steps,
            (make_mesh(d),) + rest, devices=d, per_chip=True)

    def via(ex: str) -> str:
        return "" if ex == "alltoall" else f"/{ex}"

    def add_sharded(tag, d, bcfg, bsteps, mcfg, msteps, mtrack, scfg,
                    ssteps, strack, exchanges=("alltoall",)) -> None:
        for ex in exchanges:
            add_twin(f"sharded_broadcast@{tag}/D{d}{via(ex)}", "broadcast",
                     bcfg, bsteps, d, ex)
            add_twin(f"sharded_membership@{tag}/D{d}{via(ex)}",
                     "membership", mcfg, msteps, d, mtrack, ex)
            add_twin(f"sharded_sparse@{tag}/D{d}{via(ex)}", "sparse", scfg,
                     ssteps, d, strack, ex)

    def add_sharded_streamcast(tag, d, stcfg, ststeps,
                               exchanges=("alltoall",)) -> None:
        for ex in exchanges:
            add_twin(f"sharded_streamcast@{tag}/D{d}{via(ex)}",
                     "streamcast", stcfg, ststeps, d, ex)

    def add_sharded_geo(tag, d, gcfg, gsteps,
                        exchanges=("alltoall",)) -> None:
        for ex in exchanges:
            add_twin(f"sharded_geo@{tag}/D{d}{via(ex)}", "geo", gcfg,
                     gsteps, d, ex)

    if "small" in include:
        mcfg = MembershipConfig(n=48, loss=0.05, fail_at=((3, 2),))
        bcfg = BroadcastConfig(n=64, fanout=3, delivery="edges")
        scfg = SparseMembershipConfig(base=mcfg, k_slots=8)
        swcfg = SwimConfig(n=64, subject=1, loss=0.05)
        lgcfg = LifeguardConfig(n=64, subject=1, subject_alive=True)
        mdcfg = MultiDCConfig(n=64, segments=8)
        stcfg = StreamcastConfig(n=64, events=12, chunks=2, window=4,
                                 fanout=3, chunk_budget=2, rate=0.4,
                                 names=3, loss=0.05, delivery="edges")
        add("broadcast@small", "broadcast", bcfg, 8)
        add("membership@small", "membership", mcfg, 8, (3,))
        add("sparse@small", "sparse", scfg, 8, (3,))
        add("swim@small", "swim", swcfg, 8)
        add("lifeguard@small", "lifeguard", lgcfg, 8)
        add("multidc@small", "multidc", mdcfg, 8)
        add("streamcast@small", "streamcast", stcfg, 8)
        # Selection-policy twins: each policy is a distinct program,
        # unsharded and sharded.
        for pol in ("pipeline", "rarest"):
            stcfg_p = dataclasses.replace(stcfg, policy=pol)
            add(f"streamcast@small/{pol}", "streamcast", stcfg_p, 8)
            for d in sharded_devices:
                add_sharded_streamcast(f"small/{pol}", d, stcfg_p, 8)
        # Explicit-default twins: the same program spelled with its
        # defaults written out (the first rungs of EQUIV_PAIRS).
        add("streamcast@small/uniform", "streamcast",
            dataclasses.replace(stcfg, policy="uniform"), 8)
        add("broadcast@small/notelemetry", "broadcast", bcfg, 8, False)
        add("sparse@small/amortize", "sparse",
            dataclasses.replace(scfg, amortize=resolve_amortize(scfg)), 8,
            (3,))
        # Adversarial load (sim/load.py): standing backlog, heavy-tailed
        # sizes, hotspot origins.
        add("streamcast@small/adversarial", "streamcast",
            dataclasses.replace(stcfg, backlog=4, size_tail=1.0,
                                hotspot=0.5, policy="pipeline"), 8)
        gecfg = GeoConfig(n=64, segments=8, bridges_per_segment=2,
                          events=4, wan_window=4, wan_msg_bytes=100,
                          wan_capacity_bytes=800.0,
                          wan_queue_bytes=1600.0, ae_batch=4,
                          loss_wan=0.05)
        add("geo@small", "geo", gecfg, 8)
        for d in sharded_devices:
            add_sharded_geo("small", d, gecfg, 8,
                            exchanges=("alltoall", "ring"))
        for d in sharded_devices:
            add_sharded_streamcast("small", d, stcfg, 8,
                                   exchanges=("alltoall", "ring"))
        for d in sharded_devices:
            # Both transports at small n: the /ring twins launch the CUDA
            # ring kernel on the card.
            add_sharded("small", d, bcfg, 8, mcfg, 8, (3,),
                        scfg, 8, (3,), exchanges=("alltoall", "ring"))
        # telemetry=True twins of the seven entrypoints and of the five
        # sharded twins (alltoall: the emission does not depend on the
        # transport).
        add("broadcast@small/telemetry", "broadcast", bcfg, 8, True)
        add("membership@small/telemetry", "membership", mcfg, 8, (3,),
            True)
        add("sparse@small/telemetry", "sparse", scfg, 8, (3,), True)
        add("swim@small/telemetry", "swim", swcfg, 8, True)
        add("lifeguard@small/telemetry", "lifeguard", lgcfg, 8, True)
        add("streamcast@small/telemetry", "streamcast", stcfg, 8, True)
        add("geo@small/telemetry", "geo", gecfg, 8, True)
        for d in sharded_devices:
            tel = f"small/D{d}/telemetry"
            add_twin(f"sharded_broadcast@{tel}", "broadcast", bcfg, 8, d,
                     "alltoall", True)
            add_twin(f"sharded_membership@{tel}", "membership", mcfg, 8, d,
                     (3,), "alltoall", True)
            add_twin(f"sharded_sparse@{tel}", "sparse", scfg, 8, d, (3,),
                     "alltoall", True)
            add_twin(f"sharded_streamcast@{tel}", "streamcast", stcfg, 8,
                     d, "alltoall", True)
            add_twin(f"sharded_geo@{tel}", "geo", gecfg, 8, d, "alltoall",
                     True)
    if "big" in include:
        # The north-star shapes of bench.py: 1M nodes for the per-node
        # models (dense membership at its 16k [n, n] ceiling), and the
        # sharded twins at 1M nodes per shard (n = 1M x D, edges) at the
        # largest D.
        mcfg1m = MembershipConfig(n=16384, loss=0.01, profile=LAN,
                                  fail_at=((42, 5),))
        scfg1m = SparseMembershipConfig(
            base=MembershipConfig(n=1_000_000, loss=0.01, profile=LAN,
                                  fail_at=((42, 5),)),
            k_slots=64,
        )
        add("broadcast@1m", "broadcast",
            BroadcastConfig(n=1_000_000, fanout=4, profile=LAN,
                            delivery="aggregate"), 60,
            scale=broadcast_program_at)
        add("membership@16k", "membership", mcfg1m, 30, (42,),
            note="dense [n, n] ceiling: n >= 1e5 belongs to the sparse "
                 "model")
        add("sparse@1m", "sparse", scfg1m, 3, (42,), scale=sparse_program_at)
        # The 10M-node target, sized only: state_bytes() reads its
        # argument shapes on the meta device; profile_registry never runs
        # it.
        add("sparse@10m", "sparse",
            SparseMembershipConfig(
                base=MembershipConfig(n=10_000_000, loss=0.01, profile=LAN,
                                      fail_at=((42, 5),)),
                k_slots=64,
            ), 3, (42,), scale=sparse_program_at, abstract_only=True,
            note="abstract-only 10M capacity gate (never executed in "
                 "CI; J6 + rangelint read the traced program)")
        add("swim@1m", "swim",
            SwimConfig(n=1_000_000, subject=42, loss=0.30, profile=WAN,
                       delivery="aggregate"), 450, scale=swim_program_at)
        add("lifeguard@1m", "lifeguard",
            LifeguardConfig(n=1_000_000, subject=42, subject_alive=True,
                            ack_late=0.02, profile=WAN), 160)
        # The sustained-load workload at 1M: 4-chunk events through an
        # 8-slot window, Poisson offered load.
        add("streamcast@1m", "streamcast",
            StreamcastConfig(n=1_000_000, events=256, chunks=4, window=8,
                             fanout=4, chunk_budget=2, rate=0.5, names=32,
                             profile=LAN, done_frac=0.999,
                             delivery="aggregate"), 150)
        # The geo/WAN plane at 1M: 8 DCs, 16 concurrent events,
        # bandwidth-capped links.
        add("geo@1m", "geo",
            GeoConfig(n=1_000_000, segments=8, bridges_per_segment=5,
                      events=16, wan_window=8, wan_msg_bytes=1400,
                      wan_capacity_bytes=16 * 1400.0,
                      wan_queue_bytes=32 * 1400.0, ae_batch=16,
                      loss_wan=0.05), 60)
        d = max(sharded_devices, default=0)
        if d:
            add_sharded(
                "1m_per_chip", d,
                BroadcastConfig(n=1_000_000 * d, fanout=4, profile=LAN,
                                delivery="edges"),
                30,
                mcfg1m, 30, (42,),
                SparseMembershipConfig(
                    base=MembershipConfig(n=1_000_000 * d, loss=0.01,
                                          profile=LAN,
                                          fail_at=((42, 5),)),
                    k_slots=64,
                ),
                3, (42,),
            )
            add_sharded_streamcast(
                "1m_per_chip", d,
                StreamcastConfig(n=1_000_000 * d, events=256, chunks=4,
                                 window=8, fanout=4, chunk_budget=2,
                                 rate=0.5, names=32, profile=LAN,
                                 done_frac=0.999, delivery="edges"),
                10,
            )

    # The sweep programs: the batched scans at U in {1, 8}, each with a
    # live knob (at the configuration's own value), their policy and
    # telemetry twins and the composed sweep x shard programs.
    def add_sweep(tag: str, model: str, cfg, steps: int, U: int,
                  knobs: tuple, track: tuple, n: int,
                  telemetry: bool = False, d: int = 0) -> None:
        mesh = make_mesh(d) if d else None

        def program_at(t: int) -> tuple:
            return abstract_sweep_program(model, cfg, t, U, knobs, track,
                                          telemetry, mesh)

        sfx = "/telemetry" if telemetry else ""
        dfx = f"xD{d}" if d else ""
        name = f"sweep_{model}@{tag}/U{U}{dfx}{sfx}"
        programs[name] = SimProgram(
            name=name, entrypoint="sweep_scan",
            build=lambda: program_at(steps), n=n, devices=d or 1,
            per_chip=bool(d), steps=steps,
            at_steps=lambda t: program_at(t)[0],
        )

    if "small" in include:
        sw_small = (
            ("swim", SwimConfig(n=64, subject=1, loss=0.05), 8,
             ("loss",), (), 64),
            ("lifeguard", LifeguardConfig(n=64, subject=1,
                                          subject_alive=True), 8,
             ("loss", "ack_late"), (), 64),
            ("broadcast", BroadcastConfig(n=64, fanout=3,
                                          delivery="edges"), 8,
             ("loss",), (), 64),
            ("membership", MembershipConfig(n=48, loss=0.05,
                                            fail_at=((3, 2),)), 8,
             ("loss", "suspicion_scale"), (3,), 48),
            ("sparse", SparseMembershipConfig(
                base=MembershipConfig(n=48, loss=0.05,
                                      fail_at=((3, 2),)),
                k_slots=8), 8,
             ("base.loss",), (3,), 48),
            ("streamcast", StreamcastConfig(
                n=64, events=12, chunks=2, window=4, fanout=3,
                chunk_budget=2, rate=0.4, names=3, loss=0.05,
                delivery="edges"), 8,
             ("rate",), (), 64),
            ("geo", GeoConfig(n=64, segments=8, bridges_per_segment=2,
                              events=4, wan_window=4, wan_msg_bytes=100,
                              wan_capacity_bytes=800.0,
                              wan_queue_bytes=1600.0, ae_batch=4,
                              loss_wan=0.05), 8,
             ("loss_wan",), (), 64),
        )
        for model, cfg, steps, knobs, track, n in sw_small:
            for u in (1, 8):
                add_sweep("small", model, cfg, steps, u, knobs, track, n)
        _, st_cfg, st_steps, st_knobs, st_track, st_n = next(
            r for r in sw_small if r[0] == "streamcast")
        for pol in ("pipeline", "rarest"):
            pcfg = dataclasses.replace(st_cfg, policy=pol)
            for u in (1, 8):
                add_sweep(f"small/{pol}", "streamcast", pcfg, st_steps,
                          u, st_knobs, st_track, st_n)
        sw_model, sw_cfg, sw_steps, sw_knobs, sw_track, sw_n = sw_small[0]
        add_sweep("small", sw_model, sw_cfg, sw_steps, 8, sw_knobs,
                  sw_track, sw_n, telemetry=True)
        for model, cfg, steps, knobs, track, n in sw_small:
            if model in ("swim", "lifeguard"):
                continue  # no sharded twin
            for u in (1, 8):
                for d in sharded_devices:
                    add_sweep("small", model, cfg, steps, u, knobs,
                              track, n, d=d)
    if "big" in include:
        scfg100k = SparseMembershipConfig(
            base=MembershipConfig(n=100_000, loss=0.01, profile=LAN,
                                  fail_at=((42, 5),)),
            k_slots=64,
        )
        for u in (1, 8):
            add_sweep("100k", "sparse", scfg100k, 3, u,
                      ("base.loss",), (42,), 100_000)
    return programs


# ---------------------------------------------------------------------------
# EQUIV_PAIRS: the exactness ladder as data.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EquivPair:
    """One rung of the ladder: registry keys ``a`` and ``b`` and the
    relation between them.  ``project_a``/``project_b`` map each side's
    output onto the common domain (the sharded twin's trailing overflow
    dropped, say).  Each side runs on its own program's arguments: at
    U = 1 a sweep program's are the plain scan's state stacked to
    ``[1, ...]``, ``PRNGKey(0)`` and the config's own knob values."""

    a: str
    b: str
    relation: str
    family: str
    project_a: Optional[Callable[[Any], Any]] = None
    project_b: Optional[Callable[[Any], Any]] = None
    note: str = ""


def _drop_last_out(out):
    """(final, (outs..., extra)) -> (final, outs): strips the trailing
    output a sharded twin (overflow) or a telemetry twin (the trace)
    appends."""
    final, outs = out
    return (final, tuple(outs)[:-1])


def _scalar_out(out):
    """(final, (plane, extra)) -> (final, plane): the broadcast family's
    unsharded output is a bare tensor."""
    final, outs = out
    return (final, outs[0])


def _squeeze_u(out):
    """Drop the leading U=1 universe axis from every leaf."""
    return pytree.tree_map(lambda x: x[0], out)


def _build_equiv_pairs() -> tuple:
    pairs = [
        # Explicit-default rungs: the same program, another spelling.
        EquivPair("streamcast@small/uniform", "streamcast@small",
                  relation="flag omitted: policy='uniform' == default",
                  family="streamcast"),
        EquivPair("broadcast@small/notelemetry", "broadcast@small",
                  relation="flag omitted: telemetry=False == default",
                  family="broadcast"),
        EquivPair("sparse@small/amortize", "sparse@small",
                  relation="amortize auto == explicit resolved value",
                  family="sparse"),
    ]
    for sharded, family in sorted(SHARDED_TWINS.items()):
        if sharded == "sharded_broadcast":
            proj = _scalar_out
        elif sharded in SHARDED_EXTRA_OVERFLOW:
            proj = _drop_last_out
        else:
            proj = None  # outputs align 1:1 (sparse)
        pairs.append(EquivPair(
            f"{sharded}@small/D1", f"{family}@small",
            relation="D=1 slice == unsharded", family=family,
            project_a=proj,
        ))
        pairs.append(EquivPair(
            f"{sharded}@small/D2/ring", f"{sharded}@small/D2",
            relation="ring == alltoall (D=2)", family=family,
        ))
    for family, proj in (
        ("broadcast", _scalar_out),
        ("membership", _drop_last_out),
        ("sparse", _drop_last_out),
        ("swim", _drop_last_out),
        ("lifeguard", _drop_last_out),
        ("streamcast", _drop_last_out),
        ("geo", _drop_last_out),
    ):
        pairs.append(EquivPair(
            f"{family}@small/telemetry", f"{family}@small",
            relation="telemetry == off on every existing output",
            family=family, project_a=proj,
        ))
    for model in ("swim", "broadcast"):
        pairs.append(EquivPair(
            f"sweep_{model}@small/U1", f"{model}@small",
            relation="U=1 sweep == plain scan", family=model,
            project_a=_squeeze_u,
        ))
    return tuple(pairs)


EQUIV_PAIRS: tuple = _build_equiv_pairs()


def _first_difference(want, got) -> str:
    """'' when ``got`` equals ``want`` bit for bit (tree structure, dtype,
    shape and every byte of every leaf), else where they first differ."""
    w_leaves, w_spec = pytree.tree_flatten(want)
    g_leaves, g_spec = pytree.tree_flatten(got)
    if w_spec != g_spec:
        return f"output structure {g_spec} != {w_spec}"
    for i, (w, g) in enumerate(zip(w_leaves, g_leaves)):
        if not isinstance(w, torch.Tensor):
            if w != g:
                return f"leaf {i}: {g!r} != {w!r}"
            continue
        if w.dtype != g.dtype or w.shape != g.shape:
            return (f"leaf {i}: {g.dtype}{tuple(g.shape)} != "
                    f"{w.dtype}{tuple(w.shape)}")
        if not torch.equal(w.reshape(-1).view(torch.uint8),
                           g.reshape(-1).view(torch.uint8)):
            return f"leaf {i} ({w.dtype}{tuple(w.shape)}): values differ"
    return ""


def _run_side(prog: SimProgram, device):
    """Execute ``prog`` on ``device`` from its initial state and
    ``PRNGKey(0)``."""
    fn, make_args = prog.build()
    return fn(*make_args(device))


def walk_equiv_pairs(programs: dict, device, pairs: tuple = EQUIV_PAIRS
                     ) -> list:
    """Execute both sides of every rung in ``pairs`` on ``device`` from the
    same initial state and key and compare the projected outputs bit for
    bit.  Returns one record a rung (keys, relation, family, seconds);
    raises ``AssertionError`` naming the rung and the first difference."""
    device = torch.device(device)
    walked = []
    for pair in pairs:
        t0 = time.perf_counter()
        out_a = _run_side(programs[pair.a], device)
        out_b = _run_side(programs[pair.b], device)
        if pair.project_a is not None:
            out_a = pair.project_a(out_a)
        if pair.project_b is not None:
            out_b = pair.project_b(out_b)
        diff = _first_difference(out_b, out_a)
        if diff:
            raise AssertionError(
                f"rung {pair.a} == {pair.b} ({pair.relation}): {diff}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walked.append({"a": pair.a, "b": pair.b, "relation": pair.relation,
                       "family": pair.family,
                       "seconds": time.perf_counter() - t0})
    return walked
