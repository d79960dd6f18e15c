"""Observability (counterpart of ``ratelimiter_tpu/observability/``).

Four layers over the metrics registry the service carries:

- request-lifecycle tracing (``trace.LatencyTracer``): monotonic stage
  timestamps stamped at enqueue -> batch-assembly -> device-step ->
  resolve, aggregated into the ``ratelimiter.latency.*`` histograms,
  with optional 1-in-N full-trace sampling into the enriched
  ``DecisionTrace`` ring;
- Prometheus text exposition (``prometheus.render``) at
  ``GET /actuator/prometheus``;
- the flight recorder (``flightrecorder.FlightRecorder``): a bounded
  structured-event ring that subsystems append to at state transitions,
  plus an anomaly hook that snapshots the stage breakdown of any
  dispatch over the SLO threshold; ``GET /actuator/flightrecorder``;
- the fleet telemetry plane (``telemetry.TelemetryPlane``): client
  lease-burn reports folded into fleet-true ``ratelimiter.decisions.*``
  counters, per-tenant usage accounting (``usage.UsageRing``,
  ``GET /actuator/tenants``, ``UsageSignals`` for an adaptive
  controller), and 64-bit trace-id lineage (``telemetry.TraceLineage``).
"""

from ratelimiter_tpu_torch.observability.flightrecorder import (  # noqa: F401
    FlightRecorder,
    flight_recorder,
)
from ratelimiter_tpu_torch.observability.prometheus import (  # noqa: F401
    render as render_prometheus,
)
from ratelimiter_tpu_torch.observability.telemetry import (  # noqa: F401
    ClientTelemetry,
    TelemetryPlane,
    TraceLineage,
    decode_report,
    mint_trace_id,
    trace_hex,
)
from ratelimiter_tpu_torch.observability.trace import LatencyTracer  # noqa: F401
from ratelimiter_tpu_torch.observability.usage import (  # noqa: F401
    UsageRing,
    UsageSignals,
)
