"""Correctness tooling for the port's simulation plane.

The port of ``consul_tpu/analysis``.  Five passes keep a study's tick
(its host reads, its memory, its values, its program) what the port
claims as the code grows:

* :mod:`~consul_tpu_torch.analysis.tracelint`: an AST pass (rules R1-R9)
  over the tick code: branches on a tensor's value, host syncs, 64-bit
  dtypes outside the declared sites, the global generator, boolean masks,
  writes into the state a tick was handed.  CLI: ``python -m
  consul_tpu_torch.cli lint``.
* :mod:`~consul_tpu_torch.analysis.jaxlint`: rules J1-J6 over the ATen
  graph of one tick of each registered program
  (:mod:`~consul_tpu_torch.analysis.graph`, fake tensors, nothing
  allocated): host reads a tick against PERF.md's budgets, 64-bit
  tensors, a state plane held beside its successor, the logical-shard
  exchange, captured constants, and the study's peak memory (J6's
  :func:`estimate_peak`).  CLI: ``cli jaxlint``.
* :mod:`~consul_tpu_torch.analysis.rangelint`: an interval interpreter
  (rules J7-J9) over the same graphs, run to the carry fixpoint: proven
  integer-overflow freedom with per-plane narrowing certificates, threefry
  key lineage, silent drops.  CLI: ``cli rangelint``.
* :mod:`~consul_tpu_torch.analysis.equivlint`: the exactness ladder
  (E1: ``EQUIV_PAIRS`` PROVED by canonical graphs or WITNESSED by
  execution), golden fingerprints (E2/E3, ``tests/golden/
  torch_programs.json``) and the DMA discipline of ``csrc/*.cu``
  (P1-P3).  CLI: ``cli equivlint``.
* :mod:`~consul_tpu_torch.analysis.guards`: runtime counts of the builds
  the port caches (``_make_sweep``, the nvcc builds).

``cli check`` runs the first four at once, tracing each program once.
Nothing here executes a study but E1's witnesses, so no card is needed.
Re-exports resolve lazily: the AST pass imports no ``torch``.
"""

import importlib

_EXPORTS = {
    "ENGINE_ENTRYPOINTS": "guards",
    "RetraceError": "guards",
    "TraceGuard": "guards",
    "check_all": "guards",
    "guard_entrypoints": "guards",
    "trace_guard": "guards",
    "RULES": "tracelint",
    "Violation": "tracelint",
    "lint_file": "tracelint",
    "lint_paths": "tracelint",
    "lint_source": "tracelint",
    "Finding": "jaxlint",
    "JAXLINT_RULES": "jaxlint",
    "PeakReport": "jaxlint",
    "analyze_jaxpr": "jaxlint",
    "eqn_count": "jaxlint",
    "estimate_peak": "jaxlint",
    "lint_programs": "jaxlint",
    "peak_bytes_report": "jaxlint",
    "RANGELINT_RULES": "rangelint",
    "Bound": "rangelint",
    "NarrowingCertificate": "rangelint",
    "RangeReport": "rangelint",
    "analyze_program": "rangelint",
    "analyze_spec": "rangelint",
    "lint_registry": "rangelint",
    "narrowing_ledger": "rangelint",
    "EQUIV_RULES": "equivlint",
    "Fingerprint": "equivlint",
    "PairVerdict": "equivlint",
    "canonical_hash": "equivlint",
    "canonicalize": "equivlint",
    "diff_golden": "equivlint",
    "fingerprint_registry": "equivlint",
    "lint_pallas": "equivlint",
    "prove_pairs": "equivlint",
    "run_equivlint": "equivlint",
}

__all__ = sorted(_EXPORTS)


def run_check(include=("small", "big"), budget_gb=None, paths=None,
              changed: bool = False, witness: bool = True,
              witness_device=None) -> dict:
    """The ``cli check`` umbrella: tracelint + jaxlint + rangelint +
    equivlint in one pass, tracing each registry program once (each of
    its branches) and sharing the graphs between the graph passes.

    ``changed=True`` is the git-diff-aware pre-commit path: only programs
    whose family sources changed are traced (core-plane edits widen to the
    whole registry), tracelint reads the changed files only, and the
    golden gate diffs the traced subset.  ``witness=False`` turns would-be
    witness executions into SKIPPED; ``witness_device`` picks where they
    run (default the card).  ``budget_gb`` None is J6's default budget.

    Returns the merged dict (``--format json``'s payload): per-pass
    findings and wall seconds, the peak bytes, the certificates, the
    verdicts and ``clean``.  Callers own the exit code (nonzero on any
    finding)."""
    import time as _time
    from pathlib import Path as _Path

    from consul_tpu_torch.analysis import equivlint as _el
    from consul_tpu_torch.analysis import graph as _g
    from consul_tpu_torch.analysis import jaxlint as _jl
    from consul_tpu_torch.analysis import rangelint as _rl
    from consul_tpu_torch.analysis import tracelint as _tl

    out: dict = {"wall_s": {}}
    changed_files = _el.git_changed_files() if changed else None

    t0 = _time.monotonic()
    files: list = []
    for p in (paths or _tl.default_paths()):
        p = _Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    if changed_files is not None:
        root = _Path(__file__).resolve().parents[2]
        keep = {str((root / f).resolve()) for f in changed_files}
        files = [f for f in files if str(_Path(f).resolve()) in keep]
    violations = _tl.lint_paths(files)
    out["tracelint"] = {"violations": [v.to_json() for v in violations],
                        "files": len(files)}
    out["wall_s"]["tracelint"] = round(_time.monotonic() - t0, 2)

    from consul_tpu_torch.sim.registry import EQUIV_PAIRS, jaxlint_registry

    programs = jaxlint_registry(include=include)
    pairs = EQUIV_PAIRS
    if changed_files is not None:
        keys = _el.changed_program_keys(programs, changed_files)
        pairs = tuple(p for p in pairs if p.a in keys or p.b in keys)
        for p in pairs:
            keys.update(k for k in (p.a, p.b) if k in programs)
        programs = {n: s for n, s in programs.items() if n in keys}
    out["changed"] = (None if changed_files is None
                      else sorted(changed_files))

    budget = (int(budget_gb * (1 << 30)) if budget_gb is not None
              else _jl.default_budget_bytes())
    jl_findings, peaks = [], {}
    rl_findings, certs = [], {}
    traces: dict = {}
    t_trace = t_jl = t_rl = 0.0
    for name, spec in programs.items():
        t0 = _time.monotonic()
        try:
            traced = spec.traces()
        except _g.Untraceable as e:
            jl_findings.append(_jl.untraceable_finding(name, e))
            t_trace += _time.monotonic() - t0
            continue
        traces[name] = traced
        t_trace += _time.monotonic() - t0
        t0 = _time.monotonic()
        found, peak = _jl.analyze_jaxpr(
            name, traced, budget_bytes=budget if spec.budgeted else None,
            devices=spec.devices)
        jl_findings.extend(found)
        peaks[name] = peak
        t_jl += _time.monotonic() - t0
        t0 = _time.monotonic()
        rep = _rl.analyze_spec(name, spec, traced=traced)
        rl_findings.extend(rep.findings)
        if rep.certificates:
            certs[name] = rep.certificates
        t_rl += _time.monotonic() - t0
    out["jaxlint"] = {
        "findings": [f.to_json() for f in jl_findings],
        "programs": len(programs),
        "peak_bytes": {n: p.chip_bytes for n, p in peaks.items()},
        "budget_bytes": budget,
    }
    out["rangelint"] = {
        "findings": [f.to_json() for f in rl_findings],
        "programs": len(programs),
        "certificates": {n: [c.to_json() for c in cs]
                         for n, cs in certs.items()},
    }

    t0 = _time.monotonic()
    partial = (changed_files is not None
               or not {"small", "big"} <= set(include))
    traced_programs = {n: s for n, s in programs.items() if n in traces}
    el = _el.run_equivlint(traced_programs, traces=traces, pairs=pairs,
                           witness=witness, subset=partial,
                           witness_device=witness_device)
    out["equivlint"] = {
        "findings": [f.to_json() for f in el["findings"]],
        "verdicts": [v.to_json() for v in el["verdicts"]],
        "proved": el["proved"],
        "witnessed": el["witnessed"],
        "failed": el["failed"],
        "skipped": el["skipped"],
        "golden_diffs": el["golden_diffs"],
        "pairs": len(pairs),
    }
    out["wall_s"]["equivlint"] = round(_time.monotonic() - t0, 2)
    out["wall_s"]["trace"] = round(t_trace, 2)
    out["wall_s"]["jaxlint"] = round(t_jl, 2)
    out["wall_s"]["rangelint"] = round(t_rl, 2)
    out["clean"] = not (violations or jl_findings or rl_findings
                        or el["findings"])
    return out


def __getattr__(name):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
