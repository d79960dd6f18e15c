"""Observability (counterpart of ``ratelimiter_tpu/observability/``).

Only the flight recorder (``flightrecorder.FlightRecorder``) is ported
so far: a bounded structured-event ring that the breaker, the storage
and the outage drill append to at state transitions, plus the
slow-dispatch anomaly hook.  The request-lifecycle tracer, the
Prometheus exposition and the fleet telemetry plane come with the
service tier.
"""

from ratelimiter_tpu_torch.observability.flightrecorder import (  # noqa: F401
    FlightRecorder,
    flight_recorder,
)
