"""Application wiring (counterpart of ``ratelimiter_tpu/service/wiring.py``).

The reference's Spring ``@Configuration`` builds one storage bean, a meter
registry, and three named limiters (config/RateLimiterConfig.java:31-95):

- ``apiRateLimiter``   — sliding window, 100/min, local cache on (100 ms TTL)
- ``authRateLimiter``  — sliding window, 10/min, cache OFF (strictness)
- ``burstRateLimiter`` — token bucket, capacity 50, refill 10/sec

This module builds the identical trio over the storage selected by
``storage.backend``: ``tpu`` (the name the properties file gives the
device backend) is ``GpuBatchedStorage`` on the card, ``memory`` is
``InMemoryStorage``.  A storage the app builds itself is composed as
``retry(breaker(chaos?(storage)))``, with the degraded host limiter behind
the breaker subscribed to policy updates, and is warmed at boot.  When the
properties turn them on, the token-lease manager (``ratelimiter.lease.*``)
and the in-process edge aggregator (``ratelimiter.edge.*``) are built over
the raw device storage, not over the wrappers, as the reference builds
them.

The tiers the port does not have yet refuse to boot: when the properties
turn one on, :func:`build_app` raises ``NotImplementedError`` naming the
ROADMAP queue item that ports it, rather than serving without it.  Two
keys are read and ignored: ``jax.cache.dir`` (the reference's XLA compile
cache; the port's kernels build from source at first use into
``build/kernels/``) and ``link.probe.enabled`` (the port has no link
profile; its stream loops run on the reference's no-profile elections).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from ratelimiter_tpu_torch.algorithms import (
    SlidingWindowRateLimiter,
    TokenBucketRateLimiter,
)
from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.core.limiter import RateLimiter
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.storage import (
    CircuitBreakerStorage,
    DegradedHostLimiter,
    FaultInjectingStorage,
    GpuBatchedStorage,
    InMemoryStorage,
    RateLimitStorage,
    RetryingStorage,
    RetryPolicy,
)
from ratelimiter_tpu_torch.storage.gpu import resolve_device
from ratelimiter_tpu_torch.utils.logging import get_logger

log = get_logger("service.wiring")

#: The reference's tiers that the port has not ported: the property that
#: turns each on (a true bool; for the control port, a port above 0) and
#: the ROADMAP queue item that ports it.
UNPORTED_TIERS = (
    ("ratelimiter.sidecar.enabled", "A7 (service/sidecar.py)"),
    ("ratelimiter.control.enabled", "A7 (control/)"),
    ("ratelimiter.control.fleet.enabled", "A7 (control/fleet.py)"),
    ("ratelimiter.fleet.enabled", "A7 (fleet/)"),
    ("replication.enabled", "A6 (replication/)"),
    ("ratelimiter.control.port", "A6 (replication/control.py)"),
    ("ratelimiter.orchestrator.enabled",
     "A5 and A6 (replication/orchestrator.py over a sharded engine)"),
)


@dataclasses.dataclass
class AppContext:
    props: AppProperties
    storage: RateLimitStorage
    registry: MeterRegistry
    limiters: Dict[str, RateLimiter]
    fail_open: bool
    # The CircuitBreakerStorage layer (None when breaker.enabled=false or
    # the storage was injected) — the health state machine reads it.
    breaker: object = None
    # The flight recorder behind GET /actuator/flightrecorder.
    recorder: object = None
    # Seconds the boot warmup took (the kernels' first build included);
    # None when no warmup ran.
    warmup_s: float | None = None
    # Token-lease manager (ratelimiter.lease.enabled): serves in-process
    # LeaseClients through DirectTransport.
    leases: object = None
    # In-process edge aggregator (ratelimiter.edge.enabled): bulk leases
    # subleased to in-process clients behind GET /actuator/edge.
    edge: object = None

    def close(self) -> None:
        if self.edge is not None:
            # Return every outstanding bulk budget before the lease
            # manager (and its storage) goes away.
            try:
                self.edge.release_all()
            except Exception:  # noqa: BLE001 — best-effort drain
                pass
        self.storage.close()


def check_unported_tiers(props: AppProperties) -> None:
    """Raise ``NotImplementedError`` when the properties turn on a tier
    the port does not have (:data:`UNPORTED_TIERS`)."""
    for key, item in UNPORTED_TIERS:
        on = (props.get_int(key, 0) > 0 if key == "ratelimiter.control.port"
              else props.get_bool(key, False))
        if on:
            raise NotImplementedError(
                f"{key} turns on a tier the PyTorch port does not have yet "
                f"(ROADMAP {item}); set it off to serve without it")


def warmup_shapes(storage: RateLimitStorage, max_batch: int = 8192) -> float:
    """Run the hot dispatch shapes once before traffic arrives, and return
    the seconds it took.

    Padding-only batches (slot -1) at 1 and ``max_batch`` lanes run the
    micro step of both algorithms (the solver and both write-backs) and
    the two peeks without touching any real slot state.  On the card the
    first launch of each kernel builds it from source, so a fresh checkout
    pays the ``nvcc`` time here rather than in its first requests.  Any
    failure (a kernel that does not build or launch) propagates and ends
    the boot."""
    engine = getattr(storage, "engine", None)
    if engine is None:
        return 0.0
    t0 = time.perf_counter()
    now = 1  # any positive stamp; padding batches never write state
    for n in (1, max_batch):
        engine.sw_acquire([-1] * n, [0] * n, [1] * n, now)
        engine.tb_acquire([-1] * n, [0] * n, [1] * n, now)
    engine.sw_available([0], [0], now)
    engine.tb_available([0], [0], now)
    engine.block_until_ready()
    return time.perf_counter() - t0


def build_storage(props: AppProperties, meter_registry=None, *,
                  device=None) -> RateLimitStorage:
    """The storage ``storage.backend`` names: ``tpu`` builds
    ``GpuBatchedStorage`` on ``device`` (None: the card, raising without
    one), ``memory`` an ``InMemoryStorage``.

    ``parallel.shard`` at ``auto`` / ``true`` / ``on`` shards the
    reference's slot array over every visible device; the port has one
    device per storage, so with more than one visible card it raises
    rather than serve on one of them (set ``parallel.shard=off``)."""
    backend = (props.get("storage.backend") or "tpu").lower()
    if backend == "memory":
        return InMemoryStorage()
    if backend != "tpu":
        raise ValueError(f"unknown storage.backend: {backend!r}")
    dev = resolve_device(device)
    shard = (props.get("parallel.shard") or "auto").lower()
    if (dev.type == "cuda" and shard in ("auto", "true", "on")
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            f"parallel.shard={shard} with {torch.cuda.device_count()} "
            "visible CUDA devices: sharding the slot array is ROADMAP A5; "
            "set parallel.shard=off to serve on one card")
    return GpuBatchedStorage(
        num_slots=props.get_int("storage.num_slots", 1 << 20),
        max_batch=props.get_int("batcher.max_batch", 8192),
        max_delay_ms=props.get_float("batcher.max_delay_ms", 0.5),
        max_inflight=props.get_int("batcher.max_inflight", 4),
        # Admission control (engine/batcher.py): bounded pending queue +
        # per-request queue-deadline budgets; sheds raise OverloadedError,
        # which service/app.py maps to 429 + Retry-After.
        max_pending=props.get_int("ratelimiter.overload.max_pending",
                                  65536),
        queue_deadline_ms=props.get_float(
            "ratelimiter.overload.deadline_ms", 1000.0),
        meter_registry=meter_registry,
        device=dev,
        trace_sample=props.get_int("ratelimiter.obs.trace_sample", 0),
        obs_slo_ms=props.get_float("ratelimiter.obs.slo_ms", 0.0),
        adaptive_flush=props.get_bool(
            "ratelimiter.microbatch.adaptive_flush", True),
        flush_floor_ms=props.get_float(
            "ratelimiter.microbatch.flush_floor_ms", 0.05),
        serving_cache=props.get_bool("ratelimiter.cache.hybrid.enabled",
                                     False),
        serving_cache_ttl_ms=props.get_float(
            "ratelimiter.cache.hybrid.ttl_ms", 50.0),
        serving_cache_max_keys=props.get_int(
            "ratelimiter.cache.hybrid.max_keys", 65536),
        serving_cache_unconfirmed_cap=props.get_int(
            "ratelimiter.cache.hybrid.unconfirmed_cap", 64),
        serving_cache_guard_ms=props.get_float(
            "ratelimiter.cache.hybrid.guard_ms", 5.0),
        usage_max_tenants=props.get_int("ratelimiter.usage.max_tenants",
                                        256),
        telemetry_max_clients=props.get_int(
            "ratelimiter.telemetry.max_clients", 1024),
        lineage_capacity=props.get_int("ratelimiter.obs.lineage_capacity",
                                       256),
        table_capacity=props.get_int("ratelimiter.table.capacity", 64),
    )


def _maybe_chaos(storage: RateLimitStorage, props: AppProperties):
    """Wrap the backend in the fault injector when a chaos drill is on."""
    rate = props.get_float("chaos.failure_rate", 0.0)
    latency = props.get_float("chaos.latency_ms", 0.0)
    if rate <= 0 and latency <= 0:
        return storage
    return FaultInjectingStorage(storage, failure_rate=rate,
                                 latency_ms=latency)


def _maybe_breaker(storage: RateLimitStorage, props: AppProperties,
                   registry: MeterRegistry):
    """Circuit breaker between retry and chaos — ``retry(breaker(chaos(
    storage)))`` — so every retry attempt against a dead backend counts
    toward the threshold, and once open, decisions short-circuit to the
    degraded host limiter instead of paying retry exhaustion per request.
    Returns ``(wrapped_storage, breaker_or_None)``."""
    if not props.get_bool("breaker.enabled", True):
        return storage, None
    fallback = None
    if (props.get_bool("ratelimiter.degraded.enabled", True)
            and getattr(storage, "supports_device_batching", False)):
        # Walk the wrapper chain for the raw storage's telemetry plane
        # so degraded decisions stay in the fleet counters.
        plane, inner, seen = None, storage, set()
        while inner is not None and id(inner) not in seen:
            seen.add(id(inner))
            plane = getattr(inner, "telemetry", None)
            if plane is not None:
                break
            inner = getattr(inner, "_inner", None)
        fallback = DegradedHostLimiter(
            registry=registry,
            max_keys=props.get_int("ratelimiter.degraded.max_keys", 65536),
            telemetry=plane)
    breaker = CircuitBreakerStorage(
        storage,
        failure_threshold=props.get_int("breaker.failure_threshold", 8),
        open_ms=props.get_float("breaker.open_ms", 5000.0),
        half_open_probes=props.get_int("breaker.half_open_probes", 1),
        fallback=fallback,
        registry=registry,
    )
    return breaker, breaker


def _maybe_retry(storage: RateLimitStorage, props: AppProperties):
    """Per-op retry around the (possibly chaos-wrapped) backend — the
    RedisRateLimitStorage.java:155-178 analog, composed so transient faults
    are absorbed here and only retry exhaustion reaches fail-open."""
    attempts = props.get_int("storage.retry.max_retries", 3)
    if attempts <= 0:
        return storage
    return RetryingStorage(storage, RetryPolicy(
        max_retries=attempts,
        retry_delay_ms=props.get_float("storage.retry.delay_ms", 10.0)))


def _maybe_leases(storage: RateLimitStorage, props: AppProperties,
                  registry: MeterRegistry):
    """The token-lease tier when ``ratelimiter.lease.enabled`` (off by
    default): a ``LeaseManager`` over the device storage, serving
    in-process ``LeaseClient``s through ``DirectTransport``.  A backend
    without the ``lease_reserve`` surface (``storage.backend=memory``)
    leaves it off with a warning, as the reference does."""
    if not props.get_bool("ratelimiter.lease.enabled", False):
        return None
    if not getattr(storage, "supports_device_batching", False) \
            and not hasattr(storage, "lease_reserve"):
        log.warning("ratelimiter.lease.enabled but the %s backend has no "
                    "lease_reserve surface; leases disabled",
                    type(storage).__name__)
        return None
    from ratelimiter_tpu_torch.leases import LeaseManager

    return LeaseManager(
        storage,
        default_budget=props.get_int("ratelimiter.lease.default_budget",
                                     64),
        max_budget=props.get_int("ratelimiter.lease.max_budget", 1024),
        ttl_ms=props.get_float("ratelimiter.lease.ttl_ms", 2000.0),
        deny_ttl_ms=props.get_float("ratelimiter.lease.deny_ttl_ms", 25.0),
        max_leases=props.get_int("ratelimiter.lease.max_leases", 65536),
        # Bound every tenant's aggregate outstanding lease budget
        # (0 = unbounded).
        max_concurrent=props.get_int("ratelimiter.control.max_concurrent",
                                     0),
        # Aggregator-tier bulk leases may exceed the per-client cap; 0
        # keeps bulk clamped like ordinary grants.
        max_bulk_budget=props.get_int("ratelimiter.lease.max_bulk_budget",
                                      0),
        registry=registry,
    )


def _maybe_edge(leases, props: AppProperties, registry: MeterRegistry):
    """The in-process edge aggregator when ``ratelimiter.edge.enabled``
    (off by default): an ``EdgeAggregator`` over a ``DirectTransport`` to
    the lease manager.  ``LeaseClient``s built on ``ctx.edge.session()``
    burn slices of one bulk lease per hot (lid, key), and the aggregator
    renews its whole portfolio in one batch per flush interval.  Without
    the lease tier it stays off with a warning."""
    if not props.get_bool("ratelimiter.edge.enabled", False):
        return None
    if leases is None:
        log.warning("ratelimiter.edge.enabled requires "
                    "ratelimiter.lease.enabled; edge aggregator disabled")
        return None
    from ratelimiter_tpu_torch.edge import EdgeAggregator
    from ratelimiter_tpu_torch.leases import DirectTransport

    return EdgeAggregator(
        DirectTransport(leases),
        bulk_budget=props.get_int("ratelimiter.edge.bulk_budget", 4096),
        slice_budget=props.get_int("ratelimiter.edge.slice_budget", 64),
        flush_ms=props.get_float("ratelimiter.edge.flush_ms", 50.0),
        registry=registry,
    )


def build_app(props: AppProperties | None = None,
              storage: RateLimitStorage | None = None, *,
              device=None) -> AppContext:
    """The reference's ``build_app``: the trio over ``storage`` as given,
    or over the storage ``props`` name (built on ``device``; None: the
    card), warmed and wrapped as ``retry(breaker(chaos?(storage)))``."""
    props = props or AppProperties.load()
    from ratelimiter_tpu_torch.observability import flight_recorder
    from ratelimiter_tpu_torch.utils.logging import setup_logging

    setup_logging(props)
    check_unported_tiers(props)
    registry = MeterRegistry()
    # Flight recorder (observability/flightrecorder.py): the process-
    # global ring every subsystem appends state transitions to; sized +
    # SLO-armed from config here, served at /actuator/flightrecorder.
    recorder = flight_recorder()
    recorder.resize(props.get_int("ratelimiter.obs.flight_capacity", 1024))
    slo_ms = props.get_float("ratelimiter.obs.slo_ms", 0.0)
    if slo_ms > 0:
        recorder.set_slo_ms(slo_ms)
    own_storage = storage is None
    if own_storage:
        storage = build_storage(props, meter_registry=registry,
                                device=device)
    breaker = None
    warmup_s = None
    leases = None
    edge = None
    if own_storage:
        if props.get_bool("warmup.enabled", True):
            warmup_s = warmup_shapes(
                storage, max_batch=props.get_int("batcher.max_batch", 8192))
            log.info("warmup of the micro steps and peeks: %.3f s", warmup_s)
        serving = storage
        # Leases grant against the raw device storage, beneath the
        # retry / breaker wrappers.
        leases = _maybe_leases(serving, props, registry)
        edge = _maybe_edge(leases, props, registry)
        wrapped, breaker = _maybe_breaker(_maybe_chaos(storage, props),
                                          props, registry)
        storage = _maybe_retry(wrapped, props)
        # Degraded-mode seeds must follow live policy updates: an outage
        # after a set_policy approximates under the generation that is
        # actually serving, not the boot-time registration.
        if breaker is not None and breaker.fallback is not None \
                and hasattr(serving, "add_policy_listener"):
            serving.add_policy_listener(breaker.fallback.update_policy)

    limiters: Dict[str, RateLimiter] = {
        # Default API limiter: 100 req/min sliding window with local cache
        # (config/RateLimiterConfig.java:46-59).
        "api": SlidingWindowRateLimiter(
            storage,
            RateLimitConfig(max_permits=100, window_ms=60_000,
                            enable_local_cache=True, local_cache_ttl_ms=100),
            registry,
        ),
        # Strict auth limiter: 10/min, no cache (:65-77).
        "auth": SlidingWindowRateLimiter(
            storage,
            RateLimitConfig(max_permits=10, window_ms=60_000,
                            enable_local_cache=False),
            registry,
        ),
        # Burst-friendly token bucket: 50 capacity, 10/sec refill (:83-95).
        "burst": TokenBucketRateLimiter(
            storage,
            RateLimitConfig(max_permits=50, window_ms=60_000,
                            refill_rate=10.0),
            registry,
        ),
    }
    return AppContext(
        props=props,
        storage=storage,
        registry=registry,
        limiters=limiters,
        fail_open=props.get_bool("ratelimiter.fail_open", True),
        breaker=breaker,
        recorder=recorder,
        warmup_s=warmup_s,
        leases=leases,
        edge=edge,
    )
