"""Universe sweeps: U studies of one family as one batched program.

The port of ``consul_tpu/sweep``.  The scan entrypoints of
``consul_tpu_torch.sim.engine`` (broadcast, SWIM, Lifeguard, dense and
sparse membership, streamcast, geo) run over a leading universe axis of
size U, and with ``mesh=`` over the sharded twins of
``consul_tpu_torch.parallel`` (the sweep x shard composition: U
universes x D logical shards in one batched tick), so one tick advances U
universes with one set of kernel launches: seeds for error bars,
protocol knobs (loss, suspicion-timeout scale, aggregate fanout,
offered load) for tuning curves, and fault-schedule severities for
coverage matrices.

  universe.py   the :class:`Universe` spec (per-universe keys, ``[U]``
                knob tensors vs static structure) and :func:`make_sweep`,
                one batched program per (entrypoint, U, telemetry, mesh,
                exchange)
  frontier.py   per-universe metric reduction into a
                :class:`SweepReport` + Pareto-frontier extraction, and
                the streaming curve's points and knee
  presets.py    seed sweeps, knob grids, fault-severity matrices, the
                streaming ladders and the WAN brownout ladder
  optimize.py   successive-halving/bisection generations over a grid
                preset's knob space, reusing one sweep program
  compose.py    ``python -m consul_tpu_torch.sweep.compose``: the
                composed plane's memory per universe on the card and a
                composed sparse sweep's rounds/s and overflow

``sim.engine.run_sweep`` runs a :class:`Universe` and returns its
:class:`SweepReport` (with ``outbox_overflow`` and ``devices`` on the
composed plane) and, with ``telemetry=True``, the ``[U, steps, M]``
metrics trace (``metrics_trace``, ``metric_names``).
"""

from consul_tpu_torch.sweep.frontier import (
    ENTRYPOINT_METRICS,
    SweepReport,
    pareto_mask,
    stream_points,
    summarize_sweep,
)
from consul_tpu_torch.sweep.optimize import OptimizeResult, optimize_sweep
from consul_tpu_torch.sweep.presets import PRESETS, make_preset
from consul_tpu_torch.sweep.universe import (
    SWEEP_ENTRYPOINTS,
    Universe,
    apply_knobs,
    knob_dtype,
    make_sweep,
    stacked_init,
    validate_knob,
)

__all__ = [
    "ENTRYPOINT_METRICS",
    "OptimizeResult",
    "PRESETS",
    "SWEEP_ENTRYPOINTS",
    "SweepReport",
    "Universe",
    "apply_knobs",
    "knob_dtype",
    "make_preset",
    "make_sweep",
    "optimize_sweep",
    "pareto_mask",
    "stacked_init",
    "stream_points",
    "summarize_sweep",
    "validate_knob",
]
