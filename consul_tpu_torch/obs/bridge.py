"""Host bridge: replay an in-scan metrics trace into telemetry.Metrics.

The port of ``consul_tpu/obs/bridge.py``.  The scan side (``obs/spec.py``)
writes one [M] row a tick; this side turns a study's ``[steps, M]``
trace, or a whole sweep's ``[U, steps, M]`` trace, into the
go-metrics-shaped sink (``consul_tpu_torch/telemetry.py``) under the
reference metric names: counters ``incr_counter`` once a tick with that
tick's count, gauges ``set_gauge`` to the final tick's level, so
``metrics().snapshot()`` (the /v1/agent/metrics JSON shape) describes a
simulated study as it describes a live agent.  A sweep's universes land
as separate series under the same names, labelled ``{"universe": "u"}``
(the reference DisplayMetrics label shape).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from consul_tpu_torch.obs.spec import _specs
from consul_tpu_torch.telemetry import Metrics, metrics


def bridge_trace(entrypoint: str, trace,
                 sink: Optional[Metrics] = None,
                 labels: Optional[dict] = None) -> Metrics:
    """Replay a ``[steps, M]`` study trace, or a ``[U, steps, M]`` sweep
    trace, into ``sink`` (the process-global registry by default).

    Counter columns land as one ``incr_counter(name, count_t)`` a tick
    (``Count`` = ticks, ``Sum`` = the study total, min/max/mean/stddev
    the per-tick distribution); gauge columns land as the final tick's
    level.  A 3-D trace bridges per universe: universe ``u``'s series
    carry ``{"universe": str(u)}`` merged over ``labels``.  Returns the
    sink."""
    sink = metrics() if sink is None else sink
    specs = _specs(entrypoint)
    # Python floats for the host-side aggregates, as the reference.
    arr = np.asarray(trace, dtype=float)
    if arr.ndim == 3 and arr.shape[2] == len(specs):
        for u in range(arr.shape[0]):
            u_labels = dict(labels or {})
            u_labels["universe"] = str(u)
            bridge_trace(entrypoint, arr[u], sink, labels=u_labels)
        return sink
    if arr.ndim != 2 or arr.shape[1] != len(specs):
        raise ValueError(
            f"expected a [steps, {len(specs)}] (or [U, steps, "
            f"{len(specs)}]) trace for {entrypoint!r}, got shape "
            f"{arr.shape}"
        )
    for j, spec in enumerate(specs):
        series = arr[:, j]
        if spec.kind == "gauge":
            sink.set_gauge(spec.name, float(series[-1]), labels=labels)
        else:
            for v in series:
                sink.incr_counter(spec.name, float(v), labels=labels)
    return sink


def bridge_report(entrypoint: str, report,
                  sink: Optional[Metrics] = None) -> Metrics:
    """Bridge a ``run_*`` (or ``run_sweep``) report that carries
    ``metrics_trace`` (a ``telemetry=True`` study); raises when the study
    ran without telemetry.  Sweep reports bridge per universe."""
    trace = getattr(report, "metrics_trace", None)
    if trace is None:
        raise ValueError(
            "report carries no metrics_trace — run the study with "
            "telemetry=True"
        )
    return bridge_trace(entrypoint, trace, sink)
