"""consul_tpu_torch.obs: the in-scan telemetry plane.

``spec``    the static per-entrypoint MetricSpec registry: Consul-style
            metric names bound to pure in-scan emitters; the
            ``telemetry=True`` seam of every scan writes them into a
            [steps, M] trace (``[*B, steps, M]`` under a sweep).
``bridge``  replays a trace into ``telemetry.Metrics`` (the
            /v1/agent/metrics JSON shape) under the reference names.
``profile`` executes registry programs (``sim/registry.py``) from their
            initial states and reads the trace, first-call and execute
            walls, launches, device ms and peak memory.
"""

from consul_tpu_torch.obs.bridge import bridge_report, bridge_trace
from consul_tpu_torch.obs.profile import (
    ProgramProfile,
    profile_program,
    profile_registry,
    run_with_profiler,
)
from consul_tpu_torch.obs.spec import (
    MetricSpec,
    emit_local,
    emit_metrics,
    metric_count,
    metric_names,
    reduce_over_shards,
    sum_mask,
)


def __getattr__(name: str):
    # PEP 562, as obs/spec.py: METRIC_SPECS builds the families (and
    # imports the models) on first touch only.
    if name == "METRIC_SPECS":
        from consul_tpu_torch.obs import spec

        return spec.METRIC_SPECS
    raise AttributeError(name)


__all__ = [
    "METRIC_SPECS",
    "MetricSpec",
    "ProgramProfile",
    "bridge_report",
    "bridge_trace",
    "emit_local",
    "emit_metrics",
    "metric_count",
    "metric_names",
    "profile_program",
    "profile_registry",
    "reduce_over_shards",
    "run_with_profiler",
    "sum_mask",
]
