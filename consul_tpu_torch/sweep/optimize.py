"""Closed-loop autotuning: drive ``make_sweep`` from the frontier.

The port of ``consul_tpu/sweep/optimize.py`` (host logic over the port's
``run_sweep``, on the composed ``mesh=`` plane too).

A grid preset (``sweep/presets.py``) names a knob SPACE — the paths,
the bounds, and the resolution its ladder was drawn at — and running
the preset burns the whole fixed grid even when the question is "where
is the knee".  This module closes the loop: a successive-halving /
bisection driver seeds one coarse batched generation (one batched
program, U points), culls to the surviving bracket HOST-side,
and re-batches the next generation inside the shrunken box — so the
answer costs a few generations of U evaluations instead of the full
grid.

Program-reuse discipline: every generation evaluates the SAME number
of points U, so the lru-cached sweep program (make_sweep — keyed on
(entrypoint, U)) is built ONCE and every later generation re-runs it
with new knob values.

Three modes:

  min / max   successive halving toward the objective's arg-optimum:
              each generation keeps the best ~third of its lattice and
              shrinks the box to their bounding interval (one current
              grid-cell of margin per side), until every axis reaches
              the preset's own resolution.
  knee        1-D bisection for a threshold crossing: the largest knob
              value whose objective stays <= ``knee_at`` (e.g. the
              largest offered load with window_overflow == 0 — the
              saturation knee of the streamload ladder).  Each
              generation lays U points across the (pass, fail)
              bracket and tightens it to the adjacent pair.

NaN objectives (a universe where the metric is undefined) rank WORST
in every mode — an optimizer must never converge onto a universe that
failed to measure.

All host-side numpy; the device programs stay exactly the batched
sweeps.  Deterministic by construction: generations derive points from
the bracket arithmetic alone (no RNG), so a rerun retraces the same
trajectory.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

import torch

from consul_tpu_torch.sweep.frontier import ENTRYPOINT_METRICS
from consul_tpu_torch.sweep.universe import Universe, knob_dtype


@dataclasses.dataclass
class OptimizeResult:
    """One closed-loop tuning answer, plus its full audit trail."""

    entrypoint: str
    objective: str
    mode: str                    # "min" | "max" | "knee"
    knee_at: float               # threshold (knee mode; else NaN)
    knobs: tuple                 # the VARYING knob paths searched
    fixed: dict                  # non-varying knob paths -> pinned value
    best: dict                   # knob values + objective at the answer
    bracket: dict                # path -> [lo, hi] final bracket
    cell: dict                   # path -> the preset grid's resolution
    evaluations: int             # universe-evaluations actually spent
    generations: int
    grid_evaluations: int        # the preset's own fixed-grid cost
    points_per_gen: int
    history: list                # per-generation {points, objective}
    overflow_total: int = None   # composed runs: the summed overflow of
    #                              every generation

    def summary(self) -> dict:
        """JSON-ready summary of the answer and its trail."""
        return {
            "entrypoint": self.entrypoint,
            "objective": self.objective,
            "mode": self.mode,
            **({"knee_at": self.knee_at}
               if self.mode == "knee" else {}),
            "knobs": list(self.knobs),
            "fixed": self.fixed,
            "best": self.best,
            "bracket": self.bracket,
            "cell": self.cell,
            "evaluations": self.evaluations,
            "generations": self.generations,
            "grid_evaluations": self.grid_evaluations,
            "points_per_gen": self.points_per_gen,
            "evaluations_saved_vs_grid": (
                self.grid_evaluations - self.evaluations
            ),
            # A composed search must say when a generation overflowed.
            **({"overflow_total": self.overflow_total}
               if self.overflow_total is not None else {}),
        }


def knob_space(universe: Universe) -> tuple:
    """(varying, fixed, bounds, cell) of a grid preset's knob space.

    ``varying`` — paths with >= 2 distinct ladder values (the search
    axes); ``fixed`` — single-valued paths pinned at their value;
    ``bounds[path]`` = (lo, hi) of the ladder; ``cell[path]`` = the
    ladder's finest adjacent spacing — the resolution the fixed grid
    was drawn at, and the optimizer's convergence target (landing
    "within one grid-cell" is exactly matching the grid's answer)."""
    varying, fixed, bounds, cell = [], {}, {}, {}
    for path, row in zip(universe.knobs, universe.values):
        vals = sorted(set(float(v) for v in row))
        if len(vals) < 2:
            fixed[path] = vals[0] if vals else None
            continue
        varying.append(path)
        bounds[path] = (vals[0], vals[-1])
        cell[path] = min(
            b - a for a, b in zip(vals, vals[1:])
        )
    return tuple(varying), fixed, bounds, cell


def _axis_points(lo: float, hi: float, g: int, is_int: bool) -> list:
    """g evenly spaced points over [lo, hi] (ints rounded, deduped by
    repetition so the count STAYS g — the program-reuse contract)."""
    if g == 1:
        pts = [0.5 * (lo + hi)]
    else:
        pts = [lo + (hi - lo) * i / (g - 1) for i in range(g)]
    if is_int:
        pts = [float(int(round(p))) for p in pts]
    return pts


def _grid_cost(universe: Universe) -> int:
    """Evaluations the preset's own fixed grid pays: its universe
    count — exactly what running the preset itself burns.  Not a
    span/cell or per-axis-product reconstruction: both invent phantom
    points on non-uniform or jointly-laddered (diagonal) presets."""
    return len(universe.values[0])


def _rebuild(universe: Universe, paths_to_rows: dict, U: int) -> Universe:
    """A U-point generation Universe: the preset's structure with its
    knob rows replaced (varying axes from the lattice, fixed axes
    repeated), seeds normalized to U copies of the preset's base seed
    (grid semantics: points differ only in their knob coordinates)."""
    values = tuple(
        tuple(paths_to_rows[p]) for p in universe.knobs
    )
    # seeds-only by construction: optimize_sweep rejects split_from=
    # universes up front (per-slot folded keys break grid semantics).
    return dataclasses.replace(
        universe, seeds=(universe.seeds[0],) * U, values=values
    )


def optimize_sweep(
    universe: Universe,
    objective: str,
    *,
    minimize: bool = False,
    knee_at: float = None,
    points_per_gen: int = None,
    max_generations: int = 12,
    evaluate=None,
    device=None,
    mesh=None,
    exchange: str = "alltoall",
    telemetry: bool = False,
) -> OptimizeResult:
    """Find the objective's optimum (or knee) over a grid preset's
    knob space in a few batched generations.

    ``universe`` is a GRID preset (>= 1 knob with >= 2 ladder values —
    the ladder defines bounds and the convergence cell).  ``objective``
    must be a registered metric of the entrypoint
    (frontier.ENTRYPOINT_METRICS — validated BEFORE any program runs, so
    a typo costs no sweep).  ``knee_at`` switches to knee mode:
    the answer is the largest value of the single varying knob whose
    objective stays <= knee_at.  Every generation is one
    ``run_sweep`` on ``device`` (CUDA unless given); ``mesh=``/
    ``exchange=`` run every generation on the composed plane, and the
    answer's ``overflow_total`` sums their overflow; ``telemetry`` runs
    every generation with the metrics trace on (the objective reads the
    same outputs).

    ``evaluate`` (tests): a callable ``(values_rows: tuple) ->
    float[U]`` replacing the real run_sweep evaluator — the optimizer
    unit tests drive it against brute-force grid argmins on
    deterministic objectives."""
    if universe.entrypoint not in ENTRYPOINT_METRICS:
        raise ValueError(
            f"unknown entrypoint {universe.entrypoint!r}"
        )
    known = ENTRYPOINT_METRICS[universe.entrypoint]
    if objective not in known:
        raise ValueError(
            f"unknown objective {objective!r} for "
            f"{universe.entrypoint!r} sweeps "
            f"(have: {', '.join(sorted(known))})"
        )
    if universe.split_from is not None:
        raise ValueError(
            "optimize needs ONE shared key per generation (grid "
            "semantics: points differ only in their knob "
            "coordinates), but split_from= folds a DISTINCT key into "
            "every universe slot — the same knob value would measure "
            "differently depending on which lattice slot it lands "
            "in.  Build the grid preset with seeds=(s,) * U instead."
        )
    varying, fixed, bounds, cell = knob_space(universe)
    if not varying:
        raise ValueError(
            "nothing to optimize: every knob of this universe has a "
            "single ladder value — grid presets define the search "
            "space through their ladders"
        )
    if knee_at is not None and minimize:
        raise ValueError(
            "--minimize and --knee-at are contradictory: knee mode "
            "finds the largest knob value whose objective stays <= "
            "the threshold, not an arg-minimum — pick one"
        )
    mode = "knee" if knee_at is not None else (
        "min" if minimize else "max"
    )
    if mode == "knee" and len(varying) != 1:
        raise ValueError(
            f"knee mode bisects ONE knob axis; this space has "
            f"{len(varying)}: {list(varying)} — pin the others to a "
            "single ladder value"
        )
    is_int = {
        p: knob_dtype(p) == torch.int32 for p in varying
    }

    k = len(varying)
    if points_per_gen is None:
        points_per_gen = 4 if k == 1 else max(2, round(9 ** (1 / k))) ** k
    if points_per_gen < 1:
        raise ValueError(
            f"points_per_gen must be >= 1, got {points_per_gen}"
        )
    if mode == "knee" and points_per_gen < 2:
        raise ValueError("knee mode needs >= 2 points per generation")
    # Per-axis lattice counts whose product is the (constant) U.
    # points_per_gen is a CEILING: it sizes the batched program (the
    # composed max-U-per-chip tables are exactly this bound), so the
    # lattice must never exceed it — reject rather than round up.
    if k == 1:
        per_axis = {varying[0]: points_per_gen}
        U = points_per_gen
    else:
        g = int(points_per_gen ** (1 / k))
        while (g + 1) ** k <= points_per_gen:
            g += 1
        if g < 2:
            raise ValueError(
                f"points_per_gen {points_per_gen} cannot lattice "
                f"{k} knob axes: the smallest shrinking lattice is "
                f"2**{k} = {2 ** k} points per generation"
            )
        per_axis = {p: g for p in varying}
        U = g ** k

    overflow_seen: list = []   # composed generations' overflow
    if evaluate is None:
        def evaluate(values_rows):
            from consul_tpu_torch.sim import engine

            gen = _rebuild(
                universe, dict(zip(universe.knobs, values_rows)), U
            )
            rep = engine.run_sweep(gen, warmup=False, device=device,
                                   telemetry=telemetry, mesh=mesh,
                                   exchange=exchange)
            if rep.outbox_overflow is not None:
                overflow_seen.append(
                    int(np.asarray(rep.outbox_overflow).sum()))
            return np.asarray(rep.metrics[objective], float)

    box = {p: list(bounds[p]) for p in varying}
    history = []
    evaluations = 0
    seen_pts: list = []   # (coords tuple, objective) over ALL gens
    generations = 0

    for _gen in range(max_generations):
        # Lattice over the current box (axis-major cartesian product).
        # Knee refinements lay points strictly INSIDE the bracket —
        # its endpoints were measured by the previous generation, and
        # re-paying them would halve the bisection rate (the bracket
        # shrinks by 1/(U+1) per interior generation instead of
        # 1/(U-1)).
        if mode == "knee" and _gen > 0:
            p0 = varying[0]
            lo, hi = box[p0]
            if is_int[p0]:
                # Integer axis: lay points over the DISTINCT interior
                # integers — naive rounding of evenly spaced reals
                # collides them onto each other and back onto the
                # already-measured bracket endpoints.  Repeats happen
                # only when the bracket holds < U interior integers
                # (inherent to the constant-U program-reuse contract;
                # a batch costs a batch either way).
                cands = [float(v) for v in
                         range(int(math.floor(lo)) + 1,
                               int(math.ceil(hi)))]
                if not cands:
                    cands = [float(int(round(0.5 * (lo + hi))))]
                pts = [cands[round(i * (len(cands) - 1) / (U - 1))]
                       if U > 1 else cands[len(cands) // 2]
                       for i in range(U)]
            else:
                pts = [lo + (hi - lo) * (i + 1) / (U + 1)
                       for i in range(U)]
            axes = {p0: pts}
        else:
            axes = {
                p: _axis_points(box[p][0], box[p][1], per_axis[p],
                                is_int[p])
                for p in varying
            }
        coords = [()]
        for p in varying:
            coords = [c + (v,) for c in coords for v in axes[p]]
        assert len(coords) == U
        rows = {
            p: [c[i] for c in coords] for i, p in enumerate(varying)
        }
        # Fixed axes repeat their pinned value; unknown paths cannot
        # exist (knob_space covered every preset knob).
        for p, v in fixed.items():
            rows[p] = [v] * U
        obj = np.asarray(evaluate(
            tuple(tuple(rows[p]) for p in universe.knobs)
        ), float)
        if obj.shape != (U,):
            raise ValueError(
                f"evaluator returned shape {obj.shape}, wanted ({U},)"
            )
        evaluations += U
        generations += 1
        history.append({
            "points": {p: list(rows[p]) for p in varying},
            "objective": [None if math.isnan(o) else float(o)
                          for o in obj],
        })
        seen_pts.extend(zip(coords, obj))

        if mode == "knee":
            p0 = varying[0]
            xs = np.asarray(rows[p0], float)
            order = np.argsort(xs)
            xs_s, obj_s = xs[order], obj[order]
            passing = ~np.isnan(obj_s) & (obj_s <= knee_at)
            # The bracket invariant: lo is the largest KNOWN-passing
            # value (or the box floor, unproven), hi the smallest
            # known-failing value above it (or the box ceiling).
            new_lo = (float(xs_s[np.flatnonzero(passing)[-1]])
                      if passing.any() else box[p0][0])
            fail_xs = xs_s[~passing]
            fail_xs = fail_xs[fail_xs > new_lo]
            new_hi = (float(fail_xs.min()) if fail_xs.size
                      else box[p0][1])
            box[p0] = [new_lo, new_hi]
            if new_hi - new_lo <= cell[p0] + 1e-12:
                break
        else:
            score = np.where(np.isnan(obj), np.inf, obj)
            if mode == "max":
                score = np.where(np.isnan(obj), np.inf, -obj)
            keep = np.argsort(score, kind="stable")[
                : max(1, -(-U // 3))
            ]
            done = True
            shrunk = False
            for i, p in enumerate(varying):
                vals = [coords[j][i] for j in keep]
                # Survivor bounding box + HALF a current-cell of
                # margin per side, clamped to the current box.  When
                # the survivors span the whole lattice the clamp keeps
                # the box unchanged — `shrunk` detects that below.
                span = 0.5 * (
                    axes[p][1] - axes[p][0]
                    if len(axes[p]) > 1 else cell[p]
                )
                lo = max(box[p][0], min(vals) - span)
                hi = min(box[p][1], max(vals) + span)
                if hi <= lo:   # degenerate (int axis collapsed)
                    lo, hi = box[p]
                if (lo, hi) != tuple(box[p]):
                    shrunk = True
                box[p] = [lo, hi]
                if hi - lo > cell[p] + 1e-12:
                    done = False
            # No axis moved: the next lattice would be IDENTICAL and
            # the evaluator is deterministic — re-paying U evaluations
            # per generation buys nothing.  The global argmin over
            # seen_pts is already this lattice's best answer.
            if done or not shrunk:
                break

    # The answer, over EVERY evaluated point (generations only narrow
    # where to look next; the argmin itself is global over the trail).
    if mode == "knee":
        passing = [(c, o) for c, o in seen_pts
                   if not math.isnan(o) and o <= knee_at]
        if not passing:
            best_c, best_o = None, float("nan")
        else:
            best_c, best_o = max(passing, key=lambda t: t[0][0])
    else:
        valid = [(c, o) for c, o in seen_pts if not math.isnan(o)]
        if not valid:
            best_c, best_o = None, float("nan")
        else:
            best_c, best_o = (min if mode == "min" else max)(
                valid, key=lambda t: t[1]
            )
    best = {"objective": None if math.isnan(best_o) else float(best_o)}
    if best_c is not None:
        for i, p in enumerate(varying):
            best[p] = best_c[i]
    return OptimizeResult(
        entrypoint=universe.entrypoint,
        objective=objective,
        mode=mode,
        knee_at=float("nan") if knee_at is None else float(knee_at),
        knobs=tuple(varying),
        fixed=fixed,
        best=best,
        bracket={p: [float(box[p][0]), float(box[p][1])]
                 for p in varying},
        cell={p: float(cell[p]) for p in varying},
        evaluations=evaluations,
        generations=generations,
        grid_evaluations=_grid_cost(universe),
        points_per_gen=U,
        history=history,
        overflow_total=(sum(overflow_seen) if overflow_seen else None),
    )
