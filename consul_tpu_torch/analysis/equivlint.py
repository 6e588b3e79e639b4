"""equivlint: tick-graph equivalence prover, golden fingerprints, and the
DMA discipline of the port's CUDA kernels.

The port of ``consul_tpu/analysis/equivlint.py``.  The correctness story
is an exactness ladder (``sim.registry.EQUIV_PAIRS``): D == 1 is the
unsharded program, ring == alltoall, U == 1 is the plain scan,
telemetry=off is the identity, a default is bit-equal to its explicit
spelling.  This module certifies each rung statically where it can and
concretely where not:

**Equivalence prover (E1).**  Both sides' tick graphs (every branch) are
canonicalized (:func:`canonicalize`: dead nodes dropped, nodes renamed by
definition order, commutative operands sorted, constants by content):
identical canonical forms PROVE the rung, zero executions.  A rung the
canonicalizer cannot close (a sharded twin, a telemetry twin: different
programs with equal *projected* outputs) is WITNESSED by
``sim.registry.walk_equiv_pairs``: both sides run from their own initial
state and ``PRNGKey(0)`` and compare bit for bit through the rung's
projection, on the card by default and on the CPU when asked
(``witness_device="cpu"``).  Anything else is FAILED and a finding;
without a card and unasked, a would-be witness is SKIPPED.

**Fingerprint gate (E2/E3).**  Every registry entry gets a fingerprint:
the canonical graph's sha256, its node count, the per-ATen-call
histogram and J6's peak bytes, committed in
``tests/golden/torch_programs.json``.  ``cli check`` diffs the live
registry against it: a change to what the card receives must regenerate
the goldens deliberately (``cli equivlint --update-golden``).  E2 fires
on drift, E3 on coverage holes.  The port records no flops: ATen has no
cost model (``flops`` stays None).

**DMA discipline (P1-P3)** over ``consul_tpu_torch/csrc/*.cu``, the
kernels the port writes by hand, each function a scope read in order:

  P1  every asynchronous copy is waited: each ``cp.async`` group committed
      (``cp.async.commit_group``, ``__pipeline_commit``), each
      ``cuda::memcpy_async`` and each bulk (TMA) copy has a later wait in
      its scope (``cp.async.wait_group``/``wait_all``,
      ``__pipeline_wait_prior``, ``cuda::pipeline::consumer_wait``, an
      ``mbarrier`` wait), and every ``mbarrier`` arrive is waited;
  P2  no shared-memory stage is touched before its wait: a read or write
      of a buffer an in-flight copy lands in, or a second copy into it,
      before the copy is waited;
  P3  barrier gating: an ``mbarrier`` used before its init, or a bulk
      copy completing on one whose init was never fenced to the async
      proxy (``fence.proxy.async``, ``fence.mbarrier_init``,
      ``__syncthreads``).

The ring kernel (``csrc/ring_exchange.cu``) makes plain loads and stores,
so it is covered and clean; the rules exist for the kernels later ones
will pipeline.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import re
import time
from pathlib import Path
from typing import Optional

import torch

from consul_tpu_torch.analysis import graph as g
from consul_tpu_torch.analysis.jaxlint import (
    Finding,
    estimate_peak,
    eqn_count,
    format_bytes,
)

__all__ = [
    "EQUIV_RULES",
    "Fingerprint",
    "PairVerdict",
    "canonicalize",
    "canonical_hash",
    "diff_golden",
    "eqn_histogram",
    "fingerprint",
    "fingerprint_registry",
    "golden_path",
    "lint_pallas",
    "load_golden",
    "main",
    "pallas_findings",
    "prove_pairs",
    "run_equivlint",
    "write_golden",
]

EQUIV_RULES = {
    "E1": "every declared EQUIV_PAIR must close: PROVED (canonical tick "
          "graphs identical) or WITNESSED (both sides run bit-equal "
          "through the rung's projection); FAILED is a finding",
    "E2": "live program fingerprint differs from the committed golden "
          "(tests/golden/torch_programs.json) — regenerate deliberately "
          "via cli equivlint --update-golden",
    "E3": "fingerprint coverage hole: live registry entry without a "
          "golden, or golden entry naming no live program",
    "P1": "every asynchronous copy (cp.async group, memcpy_async, bulk "
          "copy) and mbarrier arrive has a later wait in its scope",
    "P2": "no shared-memory stage is read, written or copied into again "
          "before the copy landing in it is waited",
    "P3": "an mbarrier is initialized before use, and fenced to the async "
          "proxy before a bulk copy completes on it",
}

_COMMUTATIVE = frozenset({
    "add", "mul", "maximum", "minimum", "bitwise_and", "bitwise_or",
    "bitwise_xor", "logical_and", "logical_or", "eq", "ne",
})
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")
_CSRC = Path(__file__).resolve().parents[1] / "csrc"


# ---------------------------------------------------------------------------
# Canonical form
# ---------------------------------------------------------------------------


def _meta_token(node) -> str:
    outs = node.meta.get("out", ()) if hasattr(node, "meta") else ()
    return ";".join(f"{str(m.dtype).replace('torch.', '')}"
                    f"{list(m.shape)}" for m in outs)


def _const_digest(t: torch.Tensor) -> str:
    h = hashlib.sha256()
    h.update(str(t.dtype).encode())
    h.update(str(tuple(t.shape)).encode())
    h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
             .numpy().tobytes())
    return h.hexdigest()[:16]


def _target_token(node) -> str:
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return str(t)
    return getattr(t, "__qualname__", type(t).__name__)


def _live_nodes(gm) -> list:
    """The nodes the outputs depend on, plus every host read and every
    write into a tensor that is kept (in order)."""
    nodes = list(gm.graph.nodes)
    live: set = set()
    for n in nodes:
        if n.op == "output":
            live.add(n)
    for n in reversed(nodes):
        keep = n in live or n.target is g.host_sync
        if not keep and n.op == "call_function":
            # An in-place write into a kept tensor.
            keep = any(u in live for u in n.users) or any(
                a in live and _writes(n) for a in n.all_input_nodes)
        if keep:
            live.add(n)
            live.update(n.all_input_nodes)
    return [n for n in nodes if n in live]


def _writes(node) -> bool:
    schema = getattr(node.target, "_schema", None)
    return schema is not None and any(
        a.alias_info is not None and a.alias_info.is_write
        for a in schema.arguments)


def canonicalize(traced) -> str:
    """Canonical text of a traced program (a tick graph or the list of
    its branches): see the module docstring for the normalizations.
    Identity of two canonical forms is the E1 proof; its sha256 the E2
    fingerprint."""
    graphs = traced if isinstance(traced, (list, tuple)) else [traced]
    return "\n--branch--\n".join(_canon(gm) for gm in graphs)


def _canon(gm) -> str:
    names: dict = {}
    digests: dict = {}
    lines = []
    for i, n in enumerate(g.input_nodes(gm)):
        names[n] = f"a{i}"
    lines.append("in " + " ".join(f"{names[n]}:{_meta_token(n)}"
                                  for n in g.input_nodes(gm)))
    lines.append(f"steps {gm.tick.steps} branch {gm.tick.branch}")
    serial = 0

    def atom(a) -> str:
        if isinstance(a, torch.fx.Node):
            return names.get(a, "_")
        if isinstance(a, (list, tuple)):
            return "(" + ",".join(atom(x) for x in a) + ")"
        if isinstance(a, torch.Tensor):
            return f"t[{_const_digest(a)}]"
        return _ADDR_RE.sub("0x", repr(a))

    for n in _live_nodes(gm):
        if n.op != "call_function":
            continue
        if n.target is g.constant:
            t = gm.tick.constants[n.meta["constant"]]
            d = _const_digest(t)
            digests.setdefault(d, f"c{len(digests)}")
            names[n] = digests[d]
            lines.append(f"  const {names[n]}:{_meta_token(n)} = {d}")
            continue
        names[n] = f"v{serial}"
        serial += 1
        args = [atom(a) for a in n.args]
        op = (n.target.overloadpacket.__name__
              if isinstance(n.target, torch._ops.OpOverload) else "")
        if op in _COMMUTATIVE and len(args) == 2:
            args = sorted(args)
        kwargs = ",".join(f"{k}={atom(v)}" for k, v in
                          sorted(n.kwargs.items()))
        lines.append(f"  {names[n]}:{_meta_token(n)} = {_target_token(n)}"
                     f"[{kwargs}] {' '.join(args)}")
    (out,) = [n for n in gm.graph.nodes if n.op == "output"]
    lines.append("out " + atom(out.args[0]))
    return "\n".join(lines)


def canonical_hash(traced) -> str:
    return hashlib.sha256(canonicalize(traced).encode()).hexdigest()


def eqn_histogram(traced) -> dict:
    """Per-call counts of the (first) branch's graph: the fingerprint's
    shape-of-the-program component."""
    gm = traced[0] if isinstance(traced, (list, tuple)) else traced
    hist: dict = {}
    for n in gm.graph.nodes:
        if n.op != "call_function" or n.target is g._getitem:
            continue
        t = n.target
        name = (t.overloadpacket.__name__
                if isinstance(t, torch._ops.OpOverload)
                else getattr(t, "__name__", str(t)))
        hist[name] = hist.get(name, 0) + 1
    return dict(sorted(hist.items()))


# ---------------------------------------------------------------------------
# Fingerprints and the golden gate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """One registry entry's snapshot: canonical hash, node count,
    histogram, J6 peak bytes, logical shards; ``flops`` is None (ATen has
    no cost model)."""

    hash: str
    eqns: int
    histogram: dict
    peak_bytes: int
    devices: int = 1
    flops: Optional[float] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def fingerprint(program, traced=None, flops: bool = False) -> Fingerprint:
    if traced is None:
        traced = program.traces()
    return Fingerprint(
        hash=canonical_hash(traced),
        eqns=eqn_count(traced),
        histogram=eqn_histogram(traced),
        peak_bytes=int(estimate_peak(traced).chip_bytes),
        devices=int(getattr(program, "devices", 1)),
        flops=None,
    )


def fingerprint_registry(programs: dict, traces: Optional[dict] = None,
                         flops: bool = False) -> dict:
    """name -> Fingerprint over a registry, reusing ``traces`` (name ->
    the program's branch graphs) where the caller already paid for
    them."""
    traces = traces if traces is not None else {}
    out = {}
    for name, prog in programs.items():
        if name not in traces:
            traces[name] = prog.traces()
        out[name] = fingerprint(prog, traced=traces[name], flops=flops)
    return out


def golden_path() -> str:
    """tests/golden/torch_programs.json at the repository root."""
    root = Path(__file__).resolve().parents[2]
    return str(root / "tests" / "golden" / "torch_programs.json")


def load_golden(path: Optional[str] = None) -> dict:
    path = path or golden_path()
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def write_golden(fingerprints: dict, path: Optional[str] = None,
                 merge: bool = True) -> str:
    """Write (or merge-update) the golden snapshot; ``merge`` keeps the
    entries outside ``fingerprints`` (a --set small update keeps the big
    set's)."""
    path = path or golden_path()
    doc = load_golden(path) if merge else {}
    programs = dict(doc.get("programs", {}))
    for name, fp in sorted(fingerprints.items()):
        programs[name] = fp.to_json()
    doc = {
        "meta": {
            "torch": torch.__version__.split("+")[0],
            "trace": "one tick on fake CPU tensors "
                     "(consul_tpu_torch/analysis/graph.py)",
            "note": "regenerate deliberately: cli equivlint "
                    "--update-golden",
        },
        "programs": dict(sorted(programs.items())),
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def _hist_delta(live: dict, gold: dict) -> str:
    moved = [f"{k} {gold.get(k, 0)}->{live.get(k, 0)}"
             for k in sorted(set(live) | set(gold))
             if live.get(k, 0) != gold.get(k, 0)]
    return ", ".join(moved[:6]) + ("..." if len(moved) > 6 else "")


def diff_golden(live: dict, golden: Optional[dict] = None,
                flops_rtol: float = 0.05, subset: bool = False) -> list:
    """E2/E3 findings of ``live`` (name -> Fingerprint) against the
    committed snapshot; ``subset`` (a deliberately partial registry)
    leaves out the golden-without-live direction."""
    if golden is None:
        golden = load_golden()
    gold = golden.get("programs", {})
    findings = []
    for name in sorted(live):
        fp, gp = live[name], gold.get(name)
        if gp is None:
            findings.append(Finding(
                program=name, rule="E3",
                message="no golden fingerprint — run `cli equivlint "
                        "--update-golden` and commit "
                        "tests/golden/torch_programs.json"))
            continue
        if fp.hash != gp["hash"]:
            detail = []
            if fp.eqns != gp["eqns"]:
                detail.append(f"nodes {gp['eqns']}->{fp.eqns}")
            hd = _hist_delta(fp.histogram, gp.get("histogram", {}))
            if hd:
                detail.append(f"histogram: {hd}")
            if fp.peak_bytes != gp["peak_bytes"]:
                detail.append(f"peak {format_bytes(gp['peak_bytes'])}->"
                              f"{format_bytes(fp.peak_bytes)}")
            what = "; ".join(detail) or "same shape, different program"
            findings.append(Finding(
                program=name, rule="E2",
                message=f"canonical tick graph drifted from golden "
                        f"({what}) — if intended, regenerate via "
                        "`cli equivlint --update-golden`"))
            continue
        if fp.eqns != gp["eqns"] or fp.histogram != gp.get("histogram") \
                or fp.peak_bytes != gp.get("peak_bytes"):
            findings.append(Finding(
                program=name, rule="E2",
                message="golden entry internally inconsistent (hash "
                        "matches, counts do not) — regenerate"))
    if subset:
        return findings
    for name in sorted(set(gold) - set(live)):
        findings.append(Finding(
            program=name, rule="E3",
            message="golden entry names no live registry program — stale "
                    "snapshot, regenerate via `cli equivlint "
                    "--update-golden`"))
    return findings


# ---------------------------------------------------------------------------
# E1: PROVED / WITNESSED / FAILED over EQUIV_PAIRS
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PairVerdict:
    pair: str          # "a ~ b"
    relation: str
    verdict: str       # PROVED | WITNESSED | FAILED | SKIPPED
    detail: str = ""
    wall_s: float = 0.0

    def format(self) -> str:
        d = f" ({self.detail})" if self.detail else ""
        return f"{self.verdict:9s} {self.pair} [{self.relation}]{d}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _witness_device(asked: Optional[str]) -> Optional[str]:
    """The device witnesses run on: the one asked for, else the card;
    None without a card and unasked."""
    if asked:
        return asked
    return "cuda" if torch.cuda.is_available() else None


def prove_pairs(programs: dict, pairs=None, traces: Optional[dict] = None,
                witness: bool = True,
                witness_device: Optional[str] = None) -> list:
    """E1 over the declared ladder: one PairVerdict per rung.  Structural
    proof first (projection-free rungs only), then the witness."""
    from consul_tpu_torch.sim.registry import EQUIV_PAIRS, walk_equiv_pairs

    pairs = EQUIV_PAIRS if pairs is None else pairs
    traces = traces if traces is not None else {}
    canon: dict = {}
    verdicts = []
    device = _witness_device(witness_device)

    def canon_of(name):
        if name not in canon:
            if name not in traces:
                traces[name] = programs[name].traces()
            canon[name] = canonicalize(traces[name])
        return canon[name]

    for pair in pairs:
        t0 = time.time()
        label = f"{pair.a} ~ {pair.b}"

        def verdict(v, detail=""):
            verdicts.append(PairVerdict(pair=label, relation=pair.relation,
                                        verdict=v, detail=detail,
                                        wall_s=time.time() - t0))

        if pair.a not in programs or pair.b not in programs:
            missing = pair.a if pair.a not in programs else pair.b
            verdict("SKIPPED", f"{missing} not in the registry slice")
            continue
        structural = pair.project_a is None and pair.project_b is None
        try:
            if structural and canon_of(pair.a) == canon_of(pair.b):
                verdict("PROVED", "canonical tick graphs identical")
                continue
            if not witness:
                verdict("SKIPPED", "witness disabled (--no-witness)")
                continue
            if device is None:
                verdict("SKIPPED", "no card to witness on (ask for "
                                   "--witness-device cpu)")
                continue
            walk_equiv_pairs(programs, device, (pair,))
            verdict("WITNESSED", f"both sides bit-equal on {device}")
        except Exception as e:  # noqa: BLE001 - verdicts are never silent
            verdict("FAILED", f"{type(e).__name__}: {e}")
    return verdicts


# ---------------------------------------------------------------------------
# P1-P3: the DMA discipline of csrc/*.cu
# ---------------------------------------------------------------------------

_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_FUNC_RE = re.compile(
    r"(?:__global__|__device__)[^;{]*?\b(\w+)\s*\([^)]*\)\s*\{")
_COMMIT_RE = re.compile(r"cp\.async\.commit_group|__pipeline_commit\s*\(|"
                        r"\bcp_async_commit\w*\s*\(|\.producer_commit\s*\(")
_WAIT_RE = re.compile(r"cp\.async\.wait_(?:group|all)|__pipeline_wait_prior"
                      r"\s*\(|\bcp_async_wait\w*\s*\(|\.consumer_wait\s*\(|"
                      r"cp\.async\.bulk\.wait_group")
_ASYNC_COPY_RE = re.compile(
    r"(?:cp\.async\.(?:ca|cg)\.shared\.global[^\"]*\"[^;]*?|"
    r"__pipeline_memcpy_async\s*\(|cuda::memcpy_async\s*\(|"
    r"\bcp_async\w*\s*\()\s*&?\s*(\w+)")
_BULK_RE = re.compile(r"cp\.async\.bulk(?:\.tensor)?[^\"]*\"")
_ARRIVE_RE = re.compile(r"mbarrier\.arrive|\.arrive\s*\(|"
                        r"mbarrier\.expect_tx|\barrive_and_expect_tx\s*\(")
_MBAR_WAIT_RE = re.compile(r"mbarrier\.(?:try_)?wait|\.wait\s*\(|"
                           r"\bmbarrier_wait\w*\s*\(")
_MBAR_INIT_RE = re.compile(r"mbarrier\.init|\binit\s*\(\s*&|"
                           r"\bmbarrier_init\w*\s*\(")
_FENCE_RE = re.compile(r"fence\.proxy\.async|fence\.mbarrier_init|"
                       r"__syncthreads\s*\(|fence_barrier_init\s*\(")
_MBAR_USE_RE = re.compile(r"mbarrier\.(?!init)|\barrive\w*\s*\(|"
                          r"\bmbarrier_(?!init)\w+\s*\(")


def _functions(source: str):
    """(name, body, line of the body's start) of each kernel or device
    function, comments stripped."""
    text = _COMMENT_RE.sub(lambda m: "\n" * m.group(0).count("\n"), source)
    for m in _FUNC_RE.finditer(text):
        start = m.end()
        depth, i = 1, start
        while i < len(text) and depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        yield m.group(1), text[start:i - 1], text.count("\n", 0, start) + 1


def _statements(body: str, line0: int):
    """(line, statement text) of a body, split at ';' and braces."""
    line = line0
    buf = ""
    in_str = False
    prev = ""
    for ch in body:
        if ch == "\n":
            line += 1
        if ch == '"' and prev != "\\":
            in_str = not in_str
        prev = ch
        if ch in ";{}" and not in_str:
            if buf.strip():
                yield line, buf.strip()
            buf = ""
        else:
            buf += ch
    if buf.strip():
        yield line, buf.strip()


def pallas_findings(program: str, source: str, path: str = "") -> list:
    """P1-P3 findings of one CUDA source text (``program`` names it in
    the findings, ``path`` in their ``where``)."""
    findings: list = []
    where_of = (lambda line: f"{path}:{line}") if path else (
        lambda line: f"line {line}")
    for fn, body, line0 in _functions(source):
        groups_open: list = []     # (line, stage buffers) committed
        uncommitted: list = []     # stage buffers of copies not committed
        bulk_open: list = []       # lines of bulk copies not yet waited
        arrives: list = []
        inited = fenced = False
        for line, stmt in _statements(body, line0):
            copies = [m.group(1) for m in _ASYNC_COPY_RE.finditer(stmt)]
            is_wait = bool(_WAIT_RE.search(stmt))
            mbar_wait = bool(_MBAR_WAIT_RE.search(stmt)) and not is_wait
            if _MBAR_INIT_RE.search(stmt):
                inited = True
                continue
            if _FENCE_RE.search(stmt):
                fenced = fenced or inited
            if (_MBAR_USE_RE.search(stmt) or _BULK_RE.search(stmt)) and \
                    not inited:
                findings.append(Finding(
                    program=program, rule="P3",
                    message=f"{fn}: an mbarrier is used before it is "
                            "initialized", where=where_of(line)))
                inited = True
            if _BULK_RE.search(stmt):
                if not fenced:
                    findings.append(Finding(
                        program=program, rule="P3",
                        message=f"{fn}: a bulk copy completes on an "
                                "mbarrier whose init was never fenced to "
                                "the async proxy (fence.proxy.async / "
                                "fence.mbarrier_init)",
                        where=where_of(line)))
                    fenced = True
                bulk_open.append(line)
            if _ARRIVE_RE.search(stmt):
                arrives.append(line)
            in_flight = uncommitted + [b for _, bufs in groups_open
                                       for b in bufs]
            for buf in copies:
                if buf in in_flight:
                    findings.append(Finding(
                        program=program, rule="P2",
                        message=f"{fn}: a second copy into stage {buf!r} "
                                "before the one in flight is waited",
                        where=where_of(line)))
            if not copies and not is_wait:
                for buf in set(in_flight):
                    if re.search(rf"\b{re.escape(buf)}\b", stmt):
                        findings.append(Finding(
                            program=program, rule="P2",
                            message=f"{fn}: stage {buf!r} is touched "
                                    "before the copy landing in it is "
                                    "waited", where=where_of(line)))
            uncommitted.extend(copies)
            if _COMMIT_RE.search(stmt):
                groups_open.append((line, uncommitted))
                uncommitted = []
            if is_wait:
                if not groups_open and not uncommitted and not bulk_open:
                    findings.append(Finding(
                        program=program, rule="P1",
                        message=f"{fn}: a wait with no copy in flight",
                        where=where_of(line)))
                n = _wait_depth(stmt)
                keep = groups_open[len(groups_open) - n:] if n else []
                groups_open = keep
                if not n:
                    uncommitted = []
                    bulk_open = []
            if mbar_wait:
                arrives = []
                bulk_open = []
        for line, _ in groups_open:
            findings.append(Finding(
                program=program, rule="P1",
                message=f"{fn}: a committed cp.async group is never "
                        "waited in this scope", where=where_of(line)))
        for line in bulk_open + arrives:
            findings.append(Finding(
                program=program, rule="P1",
                message=f"{fn}: an asynchronous copy or mbarrier arrive "
                        "is never waited in this scope",
                where=where_of(line)))
        if uncommitted:
            findings.append(Finding(
                program=program, rule="P1",
                message=f"{fn}: cp.async copies into "
                        f"{sorted(set(uncommitted))} are never committed "
                        "and waited", where=where_of(line0)))
    return findings


def _wait_depth(stmt: str) -> int:
    """Groups a wait leaves in flight: N of ``wait_group N`` /
    ``__pipeline_wait_prior(N)``, 0 for ``wait_all``."""
    m = re.search(r"(?:wait_group|wait_prior\s*\()\s*(\d+)", stmt)
    return int(m.group(1)) if m else 0


def kernel_sources() -> dict:
    """path -> text of every ``csrc/*.cu``."""
    return {str(p.relative_to(_CSRC.parents[1])): p.read_text()
            for p in sorted(_CSRC.glob("*.cu"))}


def lint_pallas(programs: Optional[dict] = None,
                traces: Optional[dict] = None,
                sources: Optional[dict] = None) -> list:
    """P1-P3 across the port's CUDA kernels (``sources``: path -> text,
    default every ``csrc/*.cu``).  ``programs`` and ``traces`` are the
    reference's signature: the kernels are read from their sources."""
    sources = kernel_sources() if sources is None else sources
    findings = []
    for path, text in sources.items():
        findings.extend(pallas_findings(path, text, path))
    return findings


# ---------------------------------------------------------------------------
# --changed: git-diff-aware program selection
# ---------------------------------------------------------------------------

_FAMILY_SOURCES = {
    "broadcast": ("consul_tpu_torch/models/broadcast.py",),
    "membership": ("consul_tpu_torch/models/membership.py",),
    "sparse": ("consul_tpu_torch/models/membership_sparse.py",
               "consul_tpu_torch/models/membership.py"),
    "swim": ("consul_tpu_torch/models/swim.py",),
    "lifeguard": ("consul_tpu_torch/models/lifeguard.py",
                  "consul_tpu_torch/models/swim.py"),
    "multidc": ("consul_tpu_torch/models/multidc.py",),
    "streamcast": ("consul_tpu_torch/streamcast/",),
    "geo": ("consul_tpu_torch/geo/", "consul_tpu_torch/models/multidc.py"),
}
_CORE_SOURCES = (
    "consul_tpu_torch/sim/", "consul_tpu_torch/parallel/",
    "consul_tpu_torch/ops/", "consul_tpu_torch/obs/",
    "consul_tpu_torch/sweep/", "consul_tpu_torch/protocol",
    "consul_tpu_torch/analysis/", "consul_tpu_torch/csrc/",
)


def git_changed_files(base: str = "HEAD") -> list:
    """Repository-relative paths changed against ``base`` plus untracked
    files; empty when git is unavailable."""
    import subprocess

    root = Path(__file__).resolve().parents[2]
    out: list = []
    for cmd in (["git", "diff", "--name-only", base],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, timeout=30, check=True)
        except Exception:  # noqa: BLE001 - no git: the full registry
            return []
        out.extend(x.strip() for x in res.stdout.splitlines() if x.strip())
    return sorted(set(out))


def _program_family(name: str) -> str:
    fam = name.split("@", 1)[0]
    for prefix in ("sharded_", "sweep_"):
        if fam.startswith(prefix):
            fam = fam[len(prefix):]
    return fam


def changed_program_keys(programs: dict, changed_files) -> set:
    """The registry subset a change set dirties (core-plane edits select
    everything)."""
    changed = list(changed_files)
    if any(f.startswith(_CORE_SOURCES) for f in changed):
        return set(programs)
    fams = {fam for fam, srcs in _FAMILY_SOURCES.items()
            if any(f.startswith(srcs) for f in changed)}
    return {n for n in programs if _program_family(n) in fams}


# ---------------------------------------------------------------------------
# Umbrella + CLI
# ---------------------------------------------------------------------------


def run_equivlint(programs: dict, traces: Optional[dict] = None,
                  pairs=None, golden: Optional[str] = None,
                  witness: bool = True, flops: bool = False,
                  subset: bool = False,
                  witness_device: Optional[str] = None) -> dict:
    """E1 verdicts + E2/E3 golden diff + P1-P3, sharing one trace
    cache."""
    t0 = time.time()
    traces = traces if traces is not None else {}
    verdicts = prove_pairs(programs, pairs=pairs, traces=traces,
                           witness=witness, witness_device=witness_device)
    findings = [Finding(program=v.pair, rule="E1",
                        message=f"declared equivalence failed: {v.detail} "
                                f"[{v.relation}]")
                for v in verdicts if v.verdict == "FAILED"]
    live = fingerprint_registry(programs, traces=traces, flops=flops)
    findings.extend(diff_golden(live, load_golden(golden), subset=subset))
    pallas = lint_pallas(programs, traces=traces)
    findings.extend(pallas)
    counts = {k: sum(1 for v in verdicts if v.verdict == k)
              for k in ("PROVED", "WITNESSED", "FAILED", "SKIPPED")}
    return {
        "verdicts": verdicts,
        "findings": findings,
        "fingerprints": live,
        "proved": counts["PROVED"],
        "witnessed": counts["WITNESSED"],
        "failed": counts["FAILED"],
        "skipped": counts["SKIPPED"],
        "golden_diffs": sum(1 for f in findings if f.rule in ("E2", "E3")),
        "pallas_findings": pallas,
        "wall_s": time.time() - t0,
    }


def _load_fixture_programs(path: str) -> dict:
    """``EQUIVLINT_PROGRAMS`` (name -> CUDA source text) from a Python
    file: the planted bad/clean kernel fixture hook."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_equivlint_fixture",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    progs = getattr(mod, "EQUIVLINT_PROGRAMS", None)
    if not isinstance(progs, dict):
        raise SystemExit(f"{path} does not define an EQUIVLINT_PROGRAMS dict")
    return progs


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="equivlint",
        description="tick-graph equivalence prover + golden fingerprint "
                    "gate + the CUDA kernels' DMA discipline")
    parser.add_argument("--set", default="small,big",
                        help="registry set(s), comma-separated: small | "
                             "big | small,big (default both; a single "
                             "tier diffs as a subset)")
    parser.add_argument("--update-golden", action="store_true",
                        help="regenerate tests/golden/torch_programs.json "
                             "for the selected set (merge-updates)")
    parser.add_argument("--golden", default=None,
                        help="alternate golden snapshot path")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--no-witness", action="store_true",
                        help="skip witness executions (structural proofs "
                             "and fingerprints only)")
    parser.add_argument("--witness-device", default=None,
                        choices=("cuda", "cpu"),
                        help="where witnesses run (default: the card; "
                             "without one they are SKIPPED unless cpu is "
                             "asked for)")
    parser.add_argument("--flops", action="store_true",
                        help="accepted for the reference's interface: the "
                             "port records no flops")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--module", default=None,
                        help="lint kernel sources from a module file "
                             "defining EQUIVLINT_PROGRAMS instead of the "
                             "registry")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in EQUIV_RULES.items():
            print(f"{rule}: {desc}")
        return 0
    if args.module:
        progs = _load_fixture_programs(args.module)
        findings = []
        for name, text in progs.items():
            findings.extend(pallas_findings(name, text))
        if args.format == "json":
            print(json.dumps([f.to_json() for f in findings], indent=1))
        else:
            for f in findings:
                print(f.format())
            print(f"equivlint[module]: {len(findings)} finding(s) over "
                  f"{len(progs)} fixture kernel(s)")
        return 1 if findings else 0

    from consul_tpu_torch.sim.registry import jaxlint_registry

    include = tuple(s.strip() for s in args.set.split(",") if s.strip())
    programs = jaxlint_registry(include=include)
    traces: dict = {}
    if args.update_golden:
        live = fingerprint_registry(programs, traces=traces)
        path = write_golden(live, path=args.golden)
        print(f"wrote {len(live)} fingerprint(s) to {path}")
        return 0
    res = run_equivlint(programs, traces=traces, golden=args.golden,
                        witness=not args.no_witness,
                        subset=not {"small", "big"} <= set(include),
                        witness_device=args.witness_device)
    if args.format == "json":
        print(json.dumps({
            "verdicts": [v.to_json() for v in res["verdicts"]],
            "findings": [f.to_json() for f in res["findings"]],
            "proved": res["proved"], "witnessed": res["witnessed"],
            "failed": res["failed"], "skipped": res["skipped"],
            "golden_diffs": res["golden_diffs"], "wall_s": res["wall_s"],
        }, indent=1))
    else:
        for v in res["verdicts"]:
            print(v.format())
        for f in res["findings"]:
            print(f.format())
        print(f"equivlint: {len(programs)} program(s), {res['proved']} "
              f"proved / {res['witnessed']} witnessed / {res['failed']} "
              f"failed / {res['skipped']} skipped, {res['golden_diffs']} "
              f"golden diff(s), {len(res['pallas_findings'])} kernel "
              f"finding(s) in {res['wall_s']:.1f}s")
    return 1 if res["findings"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
