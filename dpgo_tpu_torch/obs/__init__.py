"""Run-scoped telemetry of the PyTorch port (port of ``dpgo_tpu.obs``).

The jax-free core of the JAX package's observability, copied with its
imports pointed at the port:

* ``MetricsRegistry`` (``metrics.py``) — thread-safe counters / gauges /
  histograms with labels, safe to call from the agents' optimization
  threads (``agent.PGOAgent.start_optimization_loop``).
* ``EventStream`` (``events.py``) — structured JSONL with run id, wall and
  monotonic timestamps, sequence number and phase on every line.
* ``TelemetryRun`` (``run.py``) — one registry + one event stream scoped to
  a run directory, installed as the process-ambient run (``start_run`` /
  ``get_run`` / ``run_scope``).  Instrumented paths take a no-telemetry
  early exit when ``get_run()`` is None; every device readback the
  instrumentation performs goes through ``materialize``, reached only
  behind that fence.
* Exporters (``exporters.py``) — Prometheus text, optional TensorBoard
  scalars, the JSON metrics snapshot.
* Spans (``trace.py``) — ``iterate`` / ``publish`` / ``scatter`` spans
  through the event stream, with trace context riding the wire.
* Numerical health (``health.py``) — ``HealthMonitor`` anomaly detectors
  and the ``HealthConfig`` thresholds the verdict program folds in.

* Flight recorder (``recorder.py``) — bounded ring of eval scalars and
  exact state snapshots, dumped as ``blackbox.npz`` + ``blackbox.jsonl``
  on anomaly or crash; ``python -m dpgo_tpu_torch.obs.recorder --replay``
  reproduces the recorded trajectory bit for bit.
* Profiling (``profile.py``, ``devprof.py``) — programs' first-call
  records (wall, kernel launches, CUDA-event device time) and
  ``torch.profiler`` device-time attribution.
* Offline tools — ``timeline`` (merge per-process streams into one
  Chrome trace), ``report`` (``python -m dpgo_tpu_torch.obs.report``),
  ``regress`` (the convergence gate) and ``ledger``.

Not ported yet (ROADMAP A9b/A10b): ``fleetobs``.
"""

from __future__ import annotations

from .events import (
    EventStream,
    metric_record,
    nonfinite_str,
    read_events,
    read_events_meta,
    restore_nonfinite,
)
from .exporters import to_prometheus_text, write_tensorboard_scalars
from .health import HealthConfig, HealthMonitor, SolverHealthError, monitor_for
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .recorder import FlightRecorder
from .run import (
    TelemetryRun,
    end_run,
    get_run,
    materialize,
    run_scope,
    start_run,
)
from . import profile  # noqa: E402  (first-call / device profiling)
from . import trace  # noqa: E402  (span API: trace.span / trace.start_span)

__all__ = [
    "profile",
    "Counter",
    "EventStream",
    "FlightRecorder",
    "Gauge",
    "HealthConfig",
    "HealthMonitor",
    "Histogram",
    "MetricsRegistry",
    "SolverHealthError",
    "TelemetryRun",
    "end_run",
    "get_run",
    "materialize",
    "metric_record",
    "monitor_for",
    "nonfinite_str",
    "read_events",
    "read_events_meta",
    "restore_nonfinite",
    "run_scope",
    "start_run",
    "to_prometheus_text",
    "trace",
    "write_tensorboard_scalars",
]
