"""Program-level observability: the profile harness over the registry.

The port of ``consul_tpu/obs/profile.py``.  The reference lowers and
compiles each registry program and reads XLA's cost and memory analyses;
the port has no compile step apart from the first call, which builds
the CUDA kernels on first use.  So a profile here executes the program
from its own initial state and ``PRNGKey(0)`` (``SimProgram.build()``'s
``make_args``) and reads:

  * ``trace_s``    the wall of ``build()`` plus ``make_args``;
  * ``compile_s``  the wall of the first call; on the card it runs under
                   ``torch.profiler`` (CUDA activity only), which gives
                   ``launches`` (kernel launches; copies and fills aside)
                   and ``device_ms`` (their summed device time) over its
                   ``profiled_steps`` ticks.  With ``window=`` the first
                   call is the study cut to that many ticks (the same
                   tick, shapes and kernels), since the profiler costs a
                   call tens of microseconds a launch;
  * ``execute_s``  one timed run of the whole study after that warm one,
                   fenced by ``torch.cuda.synchronize()`` and the copy of
                   the per-tick outputs to the host;
  * bytes: ``argument_bytes`` (``SimProgram.state_bytes()``, read on the
    ``meta`` device before anything is allocated), ``output_bytes``,
    ``peak_bytes`` (the timed run's ``torch.cuda.max_memory_allocated()``
    above what was allocated before its arguments) and ``temp_bytes``
    (the peak less arguments and outputs).

``flops``, ``bytes_accessed`` and ``generated_code_bytes`` stay None, as
the reference leaves them where the backend gives none; so do the device
fields of a CPU run.  :func:`memory_gate` is the port's form of jaxlint's
J6 capacity gate.  ``cli profile`` prints the table; ``cli profile
--perfetto DIR`` runs a study under :func:`run_with_profiler`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from consul_tpu_torch.device import resolve_device

# The memory gate's budget on the card: this share of its total memory.
MEMORY_BUDGET_SHARE = 0.9


@dataclasses.dataclass
class ProgramProfile:
    """What one execution of a registry program reports."""

    name: str
    entrypoint: str
    n: int
    trace_s: float
    compile_s: Optional[float] = None
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    execute_s: Optional[float] = None
    execute_skipped: Optional[str] = None
    launches: Optional[int] = None
    device_ms: Optional[float] = None
    profiled_steps: Optional[int] = None
    peak_bytes: Optional[int] = None
    device: str = ""

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("trace_s", "compile_s", "execute_s"):
            if d[k] is not None:
                d[k] = round(d[k], 4)
        return d


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (states are NamedTuples)."""
    return sum(x.numel() * x.element_size()
               for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _to_host(tree) -> None:
    """Copy every tensor leaf to the host: the fence of a timed run."""
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            x.cpu()


def kernel_events(prof):
    """``(name, device ns)`` of every kernel a finished ``torch.profiler``
    run saw: the CUDA-side events that are not copies, fills or a
    ``record_function`` range's device-side annotation.  Reads the raw
    event list, which for a whole 1M-node study is millions long, without
    building the profiler's per-event Python tree."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        name = e.name()
        if not name.startswith(("Memcpy", "Memset")):
            yield name, e.duration_ns()


def device_activity(prof) -> tuple:
    """(kernel launches, their summed device ms) of a finished profile."""
    launches, ns = 0, 0
    for _, dur in kernel_events(prof):
        launches += 1
        ns += dur
    return launches, ns / 1e6


def _unchanged(name: str, args, snapshot: list) -> None:
    """Raise unless every tensor leaf of ``args`` still equals its copy in
    ``snapshot``: the timed call reuses the first call's arguments."""
    leaves = [x for x in pytree.tree_leaves(args)
              if isinstance(x, torch.Tensor)]
    for i, (x, copy) in enumerate(zip(leaves, snapshot)):
        if not torch.equal(x, copy):
            raise RuntimeError(
                f"{name}: a call wrote into its argument leaf {i} "
                f"({x.dtype}{tuple(x.shape)})")


def profile_program(prog, execute: bool = False, device=None,
                    window: Optional[int] = None) -> ProgramProfile:
    """Profile one ``SimProgram`` (``sim/registry.py``).

    Without ``execute`` nothing is allocated: the arguments are read on
    the ``meta`` device.  With it, the program runs on ``device`` (None:
    the current CUDA card; ``"cpu"`` runs it on the host) from its own
    initial state: a first call (``compile_s``, under the profiler on the
    card) and a timed one (``execute_s``, peak memory).  ``window`` bounds
    the first call to that many ticks (``prog.at_steps``, the same
    arguments), so ``launches`` and ``device_ms`` are over
    ``profiled_steps`` ticks; without it the first call is the whole
    study.  The arguments are made once and copied, and after the timed
    call every one must still equal its copy (a round never writes into
    its input)."""
    t0 = time.perf_counter()
    fn, make_args = prog.build()
    argument_bytes = prog.state_bytes()
    if not execute:
        return ProgramProfile(
            name=prog.name, entrypoint=prog.entrypoint, n=prog.n,
            trace_s=time.perf_counter() - t0, argument_bytes=argument_bytes,
        )
    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def allocated() -> int:
        return torch.cuda.memory_allocated(dev) if on_card else 0

    first, ticks = fn, prog.steps
    if window is not None and prog.at_steps is not None \
            and prog.steps is not None and prog.steps > window:
        first, ticks = prog.at_steps(window), window
    before = allocated()
    args = make_args(dev)
    sync()
    out = ProgramProfile(
        name=prog.name, entrypoint=prog.entrypoint, n=prog.n,
        trace_s=time.perf_counter() - t0, argument_bytes=argument_bytes,
        device=(torch.cuda.get_device_name(dev) if on_card else dev.type),
    )
    # The copy stays allocated through both calls; the peak leaves it out.
    held = allocated()
    snapshot = [x.clone() for x in pytree.tree_leaves(args)
                if isinstance(x, torch.Tensor)]
    snapshot_bytes = allocated() - held
    t0 = time.perf_counter()
    if on_card:
        # Only the kernels' own records are read: leaving out the external
        # correlation records cuts the profiler's cost a launch by about a
        # tenth.
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                experimental_config=torch.profiler._ExperimentalConfig(
                    disable_external_correlation=True)) as prof:
            result = first(*args)
            sync()
        out.compile_s = time.perf_counter() - t0
        out.launches, out.device_ms = device_activity(prof)
        del prof
    else:
        result = first(*args)
        out.compile_s = time.perf_counter() - t0
    out.profiled_steps = ticks
    del result
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    result = fn(*args)
    sync()
    # The per-tick outputs (and a composed sweep's overflow) go to the host;
    # the final state stays where the run left it.
    _to_host(result[1:])
    out.execute_s = time.perf_counter() - t0
    out.output_bytes = tree_bytes(result)
    if on_card:
        out.peak_bytes = (torch.cuda.max_memory_allocated(dev) - before
                          - snapshot_bytes)
        out.temp_bytes = max(
            0, out.peak_bytes - argument_bytes - out.output_bytes)
    del result
    _unchanged(prog.name, args, snapshot)
    return out


def profile_registry(programs: dict, execute: bool = False,
                     execute_budget_s: float = 0.0,
                     deadline: Optional[float] = None,
                     device=None, window: Optional[int] = None) -> list:
    """Profile every registry entry; returns ``[ProgramProfile]`` in
    registry order.

    ``execute_budget_s`` bounds the summed execute walls: once spent, the
    remaining entries are sized but not run, LOUDLY
    (``execute_skipped``).  ``deadline`` (a ``time.monotonic()`` value)
    skips everything once passed.  An abstract-only entry
    (``sparse@10m``) is sized and never run."""
    profiles = []
    exec_spent = 0.0
    for prog in programs.values():
        if prog.abstract_only:
            profiles.append(ProgramProfile(
                name=prog.name, entrypoint=prog.entrypoint, n=prog.n,
                trace_s=0.0, compile_s=0.0,
                argument_bytes=prog.state_bytes(),
                execute_skipped="abstract-only registry entry "
                                "(never compiled/executed)",
            ))
            continue
        if deadline is not None and time.monotonic() >= deadline:
            profiles.append(ProgramProfile(
                name=prog.name, entrypoint=prog.entrypoint, n=prog.n,
                trace_s=0.0, compile_s=0.0,
                execute_skipped="section budget exhausted",
            ))
            continue
        run_exec = execute and (
            execute_budget_s <= 0.0 or exec_spent < execute_budget_s
        )
        p = profile_program(prog, execute=run_exec, device=device,
                            window=window)
        if execute and not run_exec:
            p.execute_skipped = (
                f"execute budget {execute_budget_s:.0f}s exhausted"
            )
        if p.execute_s is not None:
            exec_spent += p.execute_s
        profiles.append(p)
    return profiles


class MemoryGateError(RuntimeError):
    """A program's peak memory is over the gate's budget."""


def memory_budget(device=None) -> int:
    """The gate's budget on a card: :data:`MEMORY_BUDGET_SHARE` of its
    total memory."""
    dev = resolve_device(device)
    return int(MEMORY_BUDGET_SHARE
               * torch.cuda.get_device_properties(dev).total_memory)


def memory_gate(profile: ProgramProfile, budget_bytes: int) -> int:
    """Hold an executed program's peak memory to ``budget_bytes`` (the
    port's form of jaxlint's J6 gate; :func:`memory_budget` on the card).
    Returns the peak; raises :class:`MemoryGateError` when it is over the
    budget, or when the profile has no peak to hold (the program did not
    run on the card)."""
    if profile.peak_bytes is None:
        raise MemoryGateError(
            f"{profile.name}: no peak memory to gate (not executed on a "
            f"card: {profile.execute_skipped or profile.device or 'dry'})")
    if profile.peak_bytes > budget_bytes:
        raise MemoryGateError(
            f"{profile.name}: peak {profile.peak_bytes} bytes over the "
            f"budget of {budget_bytes}")
    return profile.peak_bytes


def run_with_profiler(log_dir: str, fn, *args, **kwargs):
    """Run ``fn`` under ``torch.profiler`` (host and, where there is a
    card, CUDA activity) and write its Chrome trace into ``log_dir``
    (``trace.json``); returns ``fn``'s result.  The ``cli profile
    --perfetto DIR`` path: the trace opens in Perfetto's UI."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        result = fn(*args, **kwargs)
        _to_host(result)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    return result
