"""jaxlint: graph-level analysis of one tick of each registered program.

The port of ``consul_tpu/analysis/jaxlint.py``.  tracelint sees the code
you wrote; this module sees the ATen calls the card receives.  Each
registered program (``sim.registry.jaxlint_registry``) is traced to the
ATen graph of one tick (``SimProgram.trace()``: fake tensors, nothing
allocated; ``analysis/graph.py``), once for each branch its host reads
can take, and the graph is walked by a small rule engine.

Rules (``--list-rules`` prints this table):

  J1  host-sync-in-tick       host reads of the tick (``host_sync`` nodes:
                              ``ops.sortmerge.host_cond``; a host read or
                              data-dependent shape the trace cannot hold,
                              ``aten._local_scalar_dense``, ``nonzero``)
                              counted per tick against PERF.md section 2's
                              budget for the family (:data:`SYNC_BUDGET`):
                              at most 2 a sparse or geo tick, 0 a multi-DC
                              tick, 0 in a sparse sweep
  J2  dtype-widening          a 64-bit tensor made outside the declared
                              sites (``tracelint.DECLARED_64BIT``) and not
                              a threefry key's words
  J3  state-held-beside-      a state input of 64 MiB or more that the tick
      successor               still reads after its successor exists: two
                              copies of the plane live at once, where a
                              round that read it first could drop it
  J4  shard-consistency       the logical-shard exchange: every ring box
                              ``[(U,) D, D, budget]`` with D the program's
                              shard count, and no per-shard value returned
                              whole through one shard's slice where
                              ``obs.spec.reduce_over_shards`` (a sum over
                              the shard axis) belongs
  J5  baked-constant          a tensor of 1 MiB or more captured from
                              outside the tick (pass it as an argument)
  J6  memory-over-budget      :func:`estimate_peak` of the study above the
                              budget: ``obs.profile.memory_budget()`` on
                              the card, else that share of an NVIDIA H100
                              80GB HBM3's memory

The J6 estimator
----------------

:func:`estimate_peak` sweeps the tick's nodes in order over storages (a
view or an in-place write allocates nothing):

* the arguments (state, key, knobs) are caller-held, live from start to
  end, as ``run_*`` and ``obs.profile.profile_program`` hold them;
* a node's new output storages are allocated at the node, rounded up to
  the CUDA caching allocator's 512-byte blocks; a storage is freed where
  the program dropped its last reference (``node.meta["frees"]``, read by
  finalizers on the fake tensors: eager frees are reference counts, not
  last uses);
* the per-tick output buffers hold ``steps`` rows, not the traced one;
  from the second tick on, the previous state (the fresh successors of
  the caller's planes) and what the previous tick left in the locals of
  the loop that runs it (:func:`_carried_bytes`) are live through the
  tick: all are added to the traced peak;
* the threefry block's node holds what its twenty rounds hold at their
  peak (``meta["scratch"]``, measured a shape at a time: its outputs,
  which its getitem children keep, and its temporaries); the ring
  kernel's node allocates its inboxes, as its fake kernel says.

A program traced on two branches (``taken``, ``skipped``) reports the
larger peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Iterable, Optional

import torch

from consul_tpu_torch.analysis import graph as g
from consul_tpu_torch.analysis.tracelint import declared_64bit, suppressed_at

RULES: dict[str, str] = {
    "J1": "host-sync-in-tick: host reads a tick over PERF.md section 2's "
          "budget for the family, or one the trace cannot hold",
    "J2": "dtype-widening: a 64-bit tensor outside the declared sites "
          "(the simulation plane is 32-bit)",
    "J3": "state-held-beside-successor: a state plane >= the threshold "
          "read after its successor exists keeps two copies live",
    "J4": "shard-consistency: ring boxes [D, D, budget] with D the "
          "program's shards; per-shard values summed, not sliced, into a "
          "whole output",
    "J5": "baked-constant: a large tensor captured from outside the tick "
          "instead of passed in",
    "J6": "memory-over-budget: estimated peak memory of the study exceeds "
          "the card's budget",
}
JAXLINT_RULES = RULES

J3_DEFAULT_BYTES = 64 << 20     # 64 MiB: the dense/sparse state planes
J5_DEFAULT_BYTES = 1 << 20      # 1 MiB: anything larger belongs in args
# torch.cuda.get_device_properties().total_memory of an NVIDIA H100 80GB
# HBM3 (read on the card, PERF.md section 6): the budget's base
# without a card.
H100_80GB_HBM3_BYTES = 85_017_493_504
ALLOC_BLOCK = 512               # the CUDA caching allocator's rounding
# Host reads a tick by registry family (PERF.md section 2); a family not
# named has 0.  Reads inside the sparse model's chunked delivery count
# once: its budget is one a chunk.
SYNC_BUDGET = {"sparse": 2, "geo": 2, "sweep_sparse": 0}
_CHUNKED = "_deliver_chunked"
# ATen calls that only reduce over dimensions (J4's legal shard merges).
_REDUCTIONS = frozenset({
    "sum", "amax", "amin", "any", "all", "max", "min", "prod", "mean",
    "logsumexp", "count_nonzero",
})
_SELECTS = frozenset({"select", "narrow", "slice", "index", "index_select",
                      "unbind", "split", "chunk"})
_64BIT = frozenset({torch.int64, torch.float64, torch.uint64,
                    torch.complex128})
_RING_OP = "consul_tpu_torch.ring_exchange_planes"


@dataclasses.dataclass(frozen=True)
class Finding:
    program: str
    rule: str
    message: str
    where: str = ""

    def format(self) -> str:
        where = self.where or "<program>"
        return f"{self.program}: {where} {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PeakReport:
    """J6 output for one program: the estimated peak bytes of the study
    and the node where the traced tick peaks.  The port's D logical shards
    share one card, so ``per_chip_bytes`` is always None and
    ``chip_bytes`` the whole."""

    total_bytes: int
    at: str = ""
    per_chip_bytes: Optional[int] = None
    per_chip_at: str = ""
    input_bytes: int = 0
    tick_bytes: int = 0
    branch: str = ""

    @property
    def chip_bytes(self) -> int:
        return (self.per_chip_bytes
                if self.per_chip_bytes is not None else self.total_bytes)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def format_bytes(n: int) -> str:
    if n < 1024:
        return f"{n} B"
    for unit, shift in (("KiB", 10), ("MiB", 20), ("GiB", 30)):
        if n < 1 << (shift + 10) or unit == "GiB":
            return f"{n / (1 << shift):.2f} {unit}"
    return f"{n} B"  # pragma: no cover


def default_budget_bytes() -> int:
    """``obs.profile.memory_budget()`` on the card, else its share of an
    NVIDIA H100 80GB HBM3."""
    from consul_tpu_torch.obs.profile import MEMORY_BUDGET_SHARE, memory_budget

    if torch.cuda.is_available():
        return memory_budget()
    return int(MEMORY_BUDGET_SHARE * H100_80GB_HBM3_BYTES)


def _graphs(traced) -> list:
    return list(traced) if isinstance(traced, (list, tuple)) else [traced]


def _op_name(node) -> str:
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return t.overloadpacket.__name__
    return getattr(t, "__name__", str(t))


def eqn_count(traced) -> int:
    """Call nodes of the (first) traced branch: the golden size metric."""
    gm = _graphs(traced)[0]
    return sum(1 for n in gm.graph.nodes if n.op == "call_function"
               and n.target is not g._getitem)


# ---------------------------------------------------------------------------
# J6: the peak estimate
# ---------------------------------------------------------------------------


def _round(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK if n else 0


def _tick_peak(gm) -> tuple:
    """(peak bytes of the traced tick, where, input bytes)."""
    live: dict = {}
    for m in gm.tick.input_meta:
        if m is not None:
            live[m.storage] = _round(m.storage_bytes)
    inputs = set(live)
    total = sum(live.values())
    in_bytes = total
    peak, at = total, "<inputs>"
    for n in gm.graph.nodes:
        if n.op != "call_function":
            continue
        for m in n.meta.get("out", ()):
            if m.storage not in live:
                live[m.storage] = _round(m.storage_bytes)
                total += live[m.storage]
        inside = total + n.meta.get("scratch", 0)
        if inside > peak:
            peak, at = inside, g.where(n) or _op_name(n)
        for key in n.meta.get("frees", ()):
            if key in live and key not in inputs:
                total -= live.pop(key)
    return peak, at, in_bytes


def _state_successor_bytes(gm) -> int:
    """Bytes of the fresh storages the tick hands the next tick as its
    state (those not the caller's own planes)."""
    tick = gm.tick
    inputs = {m.storage for m in tick.input_meta if m is not None}
    outs = g.output_nodes(gm)
    seen, total = set(), 0
    for i in range(tick.n_state if tick.carried else 0):
        node = outs[i]
        for m in getattr(node, "meta", {}).get("out", ()):
            if m.storage not in inputs and m.storage not in seen:
                seen.add(m.storage)
                total += _round(m.storage_bytes)
    return total


def _carried_bytes(gm) -> int:
    """Bytes a tick leaves behind in the locals of the loop that runs it:
    the storages the frame writing the per-tick outputs still holds at its
    last write, made during the tick, that are neither the state nor an
    output.  The loop rebinds them only at its next iteration, so they
    are live through most of the next tick."""
    outs = g.output_nodes(gm)
    writes = []
    for i in gm.tick.tick_outputs:
        wt = outs[i]
        while getattr(wt, "target", None) is g.write_through:
            writes.append(wt)
            wt = wt.args[0]
    if not writes:
        return 0
    last = max(writes, key=lambda n: n.meta["index"])
    first = min(n.meta["index"] for n in writes)
    # The tick starts at its key: the last fold_in the writing frame makes
    # before its first output write.
    frame = last.meta["stack"][-1][::2] if last.meta["stack"] else None
    start = 0
    for n in gm.graph.nodes:
        st = n.meta.get("stack") or ()
        if (n.op == "call_function" and n.meta.get("index", -1) < first
                and len(st) >= 2 and st[-1][2] == "fold_in"
                and st[-2][::2] == frame):
            start = n.meta["index"]
    keep = set()
    for node in list(outs[:gm.tick.n_state]) + [outs[i] for i in
                                                 gm.tick.tick_outputs]:
        while getattr(node, "target", None) is g.write_through:
            node = node.args[0]
        for m in getattr(node, "meta", {}).get("out", ()):
            keep.add(m.storage)
    total = 0
    for n in gm.graph.nodes:
        if n.op != "call_function" or n.meta.get("index", -1) < start:
            continue
        for m in n.meta.get("out", ()):
            if m.storage in last.meta.get("held", ()) and \
                    m.storage not in keep:
                keep.add(m.storage)
                total += _round(m.storage_bytes)
    return total


def _tick_output_bytes(gm) -> int:
    """Bytes of the per-tick output buffers at one row a buffer."""
    outs = g.output_nodes(gm)
    total = 0
    for i in gm.tick.tick_outputs:
        base = outs[i].args[0]
        for m in base.meta.get("out", ()):
            total += _round(m.storage_bytes)
    return total


def estimate_peak(traced, steps: Optional[int] = None) -> PeakReport:
    """Estimated peak device bytes of the study (see the module docstring
    for the cost model), over every traced branch; ``steps`` overrides
    the trace's trip count."""
    best = None
    for gm in _graphs(traced):
        s = steps if steps is not None else gm.tick.steps
        peak, at, in_bytes = _tick_peak(gm)
        rows = _tick_output_bytes(gm) * max(s - 1, 0)
        carried = (_state_successor_bytes(gm) + _carried_bytes(gm)
                   if s > 1 else 0)
        rep = PeakReport(total_bytes=peak + rows + carried, at=at,
                         input_bytes=in_bytes, tick_bytes=peak,
                         branch=gm.tick.branch)
        if best is None or rep.total_bytes > best.total_bytes:
            best = rep
    return best


# ---------------------------------------------------------------------------
# The rule walk
# ---------------------------------------------------------------------------


def _family(program: str) -> str:
    fam = program.split("@", 1)[0]
    return fam[len("sharded_"):] if fam.startswith("sharded_") else fam


def sync_budget(program: str) -> int:
    fam = _family(program)
    if fam in SYNC_BUDGET:
        return SYNC_BUDGET[fam]
    if fam.startswith("sweep_"):
        return SYNC_BUDGET.get(fam[len("sweep_"):], 0)
    return 0


def _key_nodes(gm) -> set:
    """Nodes holding threefry key words: the key inputs and whatever is
    made from them or from a threefry node by views, stacks and
    selections."""
    keys = set()
    carriers = {"select", "slice", "view", "reshape", "unsqueeze",
                "squeeze", "expand", "stack", "cat", "unbind", "clone",
                "_to_copy", "alias", "permute", "transpose", "index",
                "broadcast_tensors", "_unsafe_view"}
    for n in g.input_nodes(gm):
        m = n.meta.get("out", ())
        if m and m[0].dtype == torch.int64 and m[0].shape[-1:] == (2,):
            keys.add(n)
    for n in gm.graph.nodes:
        if n.op != "call_function":
            continue
        if n.target is g._getitem and n.args[0] in keys:
            keys.add(n)
        elif getattr(n.target, "__name__", "") == "threefry2x32":
            keys.add(n)
        elif _op_name(n) in carriers and any(
                a in keys for a in n.all_input_nodes):
            keys.add(n)
    return keys


class _Analyzer:
    def __init__(self, program: str, rules: frozenset, j3_bytes: int,
                 j5_bytes: int, devices: int = 1):
        self.program = program
        self.rules = rules
        self.j3_bytes = j3_bytes
        self.j5_bytes = j5_bytes
        self.devices = devices
        self.findings: list[Finding] = []
        self._seen: set = set()

    def report(self, node, rule: str, message: str, where: str = ""):
        if rule not in self.rules:
            return
        where = where or (g.where(node) if node is not None else "")
        if suppressed_at(where, rule):
            return
        key = (rule, where, message)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(self.program, rule, message, where))

    def run(self, traced) -> list:
        for gm in _graphs(traced):
            self._j1(gm)
            self._j2(gm)
            self._j3(gm)
            self._j4(gm)
            self._j5(gm)
        return self.findings

    def _j1(self, gm) -> None:
        budget = sync_budget(self.program)
        counted, chunked = 0, False
        for s in gm.tick.syncs:
            if _CHUNKED in s.get("stack_functions", ()):
                chunked = True
                continue
            counted += 1
        counted += int(chunked)
        if counted > budget:
            sites = ", ".join(s["site"] for s in gm.tick.syncs)
            self.report(None, "J1",
                        f"{counted} host reads a tick ({gm.tick.branch} "
                        f"branch) over the budget of {budget} for "
                        f"{_family(self.program)} (PERF.md section 2): "
                        f"{sites}", where=gm.tick.syncs[-1]["site"])

    def _j2(self, gm) -> None:
        keys = _key_nodes(gm)
        for n in gm.graph.nodes:
            if n.op != "call_function" or n in keys:
                continue
            if n.target in (g.write_through, g.host_sync):
                continue
            for m in n.meta.get("out", ()):
                if m.dtype not in _64BIT:
                    continue
                stack = n.meta.get("stack") or ()
                if stack and declared_64bit(stack[-1][0], stack[-1][2]):
                    break
                self.report(n, "J2",
                            f"{_op_name(n)} makes {m.dtype} "
                            f"{list(m.shape)} outside the declared 64-bit "
                            "sites (tracelint.DECLARED_64BIT) — the plane "
                            "is 32-bit")
                break

    def _j3(self, gm) -> None:
        tick = gm.tick
        if not tick.carried:
            return
        ins = g.input_nodes(gm)
        outs = g.output_nodes(gm)
        order = {n: i for i, n in enumerate(gm.graph.nodes)}
        for i in range(tick.n_state):
            m = tick.input_meta[i]
            if m is None or m.nbytes < self.j3_bytes:
                continue
            succ = outs[i]
            if succ is ins[i] or not hasattr(succ, "meta"):
                continue
            storage = succ.meta.get("out", (None,))
            storage = storage[0].storage if storage else None
            born = min((order[n] for n in gm.graph.nodes
                        if n.op == "call_function" and any(
                            o.storage == storage
                            for o in n.meta.get("out", ()))),
                       default=None)
            if born is None:
                continue
            readers = self._readers(ins[i])
            late = [n for n in readers if order[n] > born]
            if late:
                self.report(late[0], "J3",
                            f"state plane {tick.inputs[i]} "
                            f"({format_bytes(m.nbytes)}) is read after its "
                            f"successor exists ({g.where(succ)}): both "
                            "copies are live — read it before building the "
                            "new plane")

    @staticmethod
    def _readers(node) -> list:
        """Nodes reading ``node`` directly or through views of it."""
        views = {"select", "slice", "view", "reshape", "unsqueeze",
                 "squeeze", "expand", "permute", "transpose", "alias",
                 "_unsafe_view", "unbind"}
        out, stack, seen = [], [node], set()
        while stack:
            v = stack.pop()
            for u in v.users:
                if u in seen:
                    continue
                seen.add(u)
                if u.op == "call_function" and (
                        _op_name(u) in views or u.target is g._getitem):
                    stack.append(u)
                elif u.op == "call_function":
                    out.append(u)
        return out

    def _j4(self, gm) -> None:
        d = self.devices
        if d <= 1 and not self.program.startswith(("sharded_", "sweep_")):
            return
        for n in gm.graph.nodes:
            if n.op != "call_function":
                continue
            if str(getattr(n.target, "overloadpacket", "")) == _RING_OP or \
                    str(n.target).startswith(_RING_OP):
                planes = n.args[0]
                for p in planes:
                    (m,) = p.meta["out"][:1] or (None,)
                    if m is None or len(m.shape) < 3:
                        continue
                    if m.shape[-3] != m.shape[-2] or (
                            d > 1 and m.shape[-3] != d):
                        self.report(n, "J4",
                                    f"ring box {list(m.shape)} is not "
                                    f"[(U,) D, D, budget] with D = {d} "
                                    "(the program's logical shards)")
        self._j4_slices(gm, d)

    def _j4_slices(self, gm, d: int) -> None:
        """A value made per shard (a leading shard axis of size D in
        ``parallel/shard.py``) reaching a whole output through one
        shard's slice."""
        if d <= 1:
            return
        picked: dict = {}
        for n in gm.graph.nodes:
            if n.op != "call_function":
                continue
            name = _op_name(n)
            stack = n.meta.get("stack") or ()
            fns = {f for _, _, f in stack}
            if "reduce_over_shards" in fns:
                continue
            ins = [a for a in n.all_input_nodes if a in picked]
            if name in _SELECTS and n.args and hasattr(n.args[0], "meta"):
                src = n.args[0].meta.get("out", ())
                dim = n.args[1] if len(n.args) > 1 and isinstance(
                    n.args[1], int) else 0
                key_word = (src and dim == len(src[0].shape) - 1
                            and src[0].dtype == torch.int64
                            and src[0].shape[-1] == 2)
                if src and name == "select" and dim in (0, 1) and \
                        not key_word and len(src[0].shape) > dim and \
                        src[0].shape[dim] == d and _shard_axis(src[0], d):
                    picked[n] = g.where(n)
                    continue
            if ins and name not in _REDUCTIONS:
                picked[n] = picked[ins[0]]
        outs = g.output_nodes(gm)
        for i in gm.tick.tick_outputs:
            wt = outs[i]
            while getattr(wt, "target", None) is g.write_through:
                written = wt.args[1]
                src = written.args[1] if len(written.args) > 1 else None
                if src in picked:
                    self.report(written, "J4",
                                f"output {gm.tick.outputs[i]} takes one "
                                f"shard's value (sliced at {picked[src]}) "
                                "where the shards' values must be summed "
                                "(obs.spec.reduce_over_shards)")
                wt = wt.args[0]

    def _j5(self, gm) -> None:
        for name, t in gm.tick.constants.items():
            nbytes = t.numel() * t.element_size()
            if nbytes >= self.j5_bytes:
                node = next(n for n in gm.graph.nodes
                            if n.meta.get("constant") == name)
                self.report(node, "J5",
                            f"tensor {t.dtype}{list(t.shape)} "
                            f"({format_bytes(nbytes)}) captured from "
                            "outside the tick — pass it as an argument or "
                            "build it on the device")


def _shard_axis(m, d: int) -> bool:
    """A tensor laid out per shard: its shard axis (size D) leads, after
    a sweep's universe axis at most."""
    return m.shape[:1] == (d,) or m.shape[1:2] == (d,)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def untraceable_finding(program: str, err) -> Finding:
    """J1 for a tick that could not be traced (its reason and site)."""
    return Finding(program, "J1",
                   f"the tick cannot be traced: {err.reason} — a host read "
                   "or a data-dependent shape with no override",
                   where=err.where)


def analyze_jaxpr(program: str, traced,
                  rules: Optional[Iterable[str]] = None,
                  budget_bytes: Optional[int] = None,
                  j3_bytes: int = J3_DEFAULT_BYTES,
                  j5_bytes: int = J5_DEFAULT_BYTES,
                  devices: int = 1,
                  ) -> tuple[list, PeakReport]:
    """Run the rule engine over one traced program (a ``GraphModule`` or
    the list of its branches).  Returns (findings, peak report); J6 fires
    when ``budget_bytes`` is given and the estimate exceeds it."""
    active = frozenset(rules) if rules is not None else frozenset(RULES)
    unknown = active - set(RULES)
    if unknown:
        raise ValueError(
            f"unknown rule(s) {sorted(unknown)}; known: {sorted(RULES)}"
        )
    findings = _Analyzer(program, active, j3_bytes, j5_bytes,
                         devices).run(traced)
    peak = estimate_peak(traced)
    if ("J6" in active and budget_bytes is not None
            and peak.chip_bytes > budget_bytes):
        findings.append(Finding(
            program, "J6",
            f"estimated peak memory {format_bytes(peak.chip_bytes)} "
            f"exceeds the budget {format_bytes(budget_bytes)} (the tick "
            f"peaks at {peak.at}, {peak.branch} branch)",
        ))
    return findings, peak


def lint_programs(programs: dict,
                  rules: Optional[Iterable[str]] = None,
                  budget_gb: Optional[float] = None,
                  j3_bytes: int = J3_DEFAULT_BYTES,
                  j5_bytes: int = J5_DEFAULT_BYTES,
                  ) -> tuple[list, dict]:
    """Trace and analyze a registry of ``SimProgram`` specs (anything
    with ``.traces()``, ``.budgeted`` and ``.devices``).  ``budget_gb``
    None is :func:`default_budget_bytes`.  Returns all findings plus
    per-program peak reports."""
    budget_bytes = (int(budget_gb * (1 << 30)) if budget_gb is not None
                    else default_budget_bytes())
    findings: list = []
    peaks: dict = {}
    for name, spec in programs.items():
        try:
            traced = spec.traces()
        except g.Untraceable as e:
            findings.append(untraceable_finding(name, e))
            continue
        found, peak = analyze_jaxpr(
            name, traced, rules=rules,
            budget_bytes=budget_bytes if getattr(spec, "budgeted", True)
            else None, j3_bytes=j3_bytes, j5_bytes=j5_bytes,
            devices=getattr(spec, "devices", 1))
        findings.extend(found)
        peaks[name] = peak
    return findings, peaks


def peak_bytes_report(include=("big",)) -> dict:
    """name -> estimated peak bytes of the registered programs (nothing
    allocated)."""
    from consul_tpu_torch.sim.registry import jaxlint_registry

    return {name: estimate_peak(spec.traces()).chip_bytes
            for name, spec in jaxlint_registry(include=include).items()}


def _load_fixture_programs(path: str) -> dict:
    """``JAXLINT_PROGRAMS`` from a Python file: the fixture hook the CLI
    tests plant violations through."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_jaxlint_fixture", path)
    if spec is None or spec.loader is None:
        raise OSError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    programs = getattr(module, "JAXLINT_PROGRAMS", None)
    if not isinstance(programs, dict):
        raise OSError(f"{path} defines no JAXLINT_PROGRAMS dict")
    return programs


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="jaxlint",
        description="graph-level analysis of one tick of each registered "
                    "program (traced on fake tensors; nothing allocated)",
    )
    parser.add_argument("--rules", default="",
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        dest="list_rules")
    parser.add_argument("--budget-gb", type=float, default=None,
                        dest="budget_gb",
                        help="memory budget for J6 (default: "
                             "obs.profile.memory_budget() on the card, "
                             "else its share of an H100 80GB HBM3)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--set", choices=("small", "big", "all"),
                        default="all", dest="which",
                        help="registry slice: small-n configs, the "
                             "1M-node configs, or both (default)")
    parser.add_argument("--module", default="",
                        help="lint JAXLINT_PROGRAMS from a Python file "
                             "instead of the engine registry")
    args = parser.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    try:
        if args.module:
            programs = _load_fixture_programs(args.module)
        else:
            from consul_tpu_torch.sim.registry import jaxlint_registry

            include = (("small", "big") if args.which == "all"
                       else (args.which,))
            programs = jaxlint_registry(include=include)
        findings, peaks = lint_programs(programs, rules=rules,
                                        budget_gb=args.budget_gb)
    except (ValueError, OSError) as e:
        print(f"jaxlint: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "programs": len(programs),
            "peak_bytes": {n: p.chip_bytes for n, p in peaks.items()},
        }))
    else:
        for f in findings:
            print(f.format())
        for name, p in sorted(peaks.items()):
            print(f"jaxlint: {name}: peak {format_bytes(p.chip_bytes)} "
                  f"(at {p.at})", file=sys.stderr)
    if findings:
        print(f"jaxlint: {len(findings)} finding(s) in "
              f"{len(programs)} program(s)", file=sys.stderr)
        return 1
    if args.format != "json":
        print(f"jaxlint: clean ({len(programs)} program(s))",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
