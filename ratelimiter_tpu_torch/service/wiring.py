"""Application wiring (counterpart of ``ratelimiter_tpu/service/wiring.py``).

The reference's Spring ``@Configuration`` builds one storage bean, a meter
registry, and three named limiters (config/RateLimiterConfig.java:31-95):

- ``apiRateLimiter``   — sliding window, 100/min, local cache on (100 ms TTL)
- ``authRateLimiter``  — sliding window, 10/min, cache OFF (strictness)
- ``burstRateLimiter`` — token bucket, capacity 50, refill 10/sec

This module builds the identical trio over the storage selected by
``storage.backend``: ``tpu`` (the name the properties file gives the
device backend) is ``GpuBatchedStorage`` on the card, sharded over every
visible card when there are several (``parallel.shard``,
:func:`sharded_engine`), ``memory`` is ``InMemoryStorage``.  A storage the app builds itself is composed as
``retry(breaker(chaos?(storage)))``, with the degraded host limiter behind
the breaker subscribed to policy updates, and is warmed at boot.  When the
properties turn them on, the token-lease manager (``ratelimiter.lease.*``)
and the in-process edge aggregator (``ratelimiter.edge.*``) are built over
the raw device storage, not over the wrappers, as the reference builds
them.  So are replication (``replication.*``: role ``primary`` journals
the storage and ships its epoch frames to a standby, role ``standby``
listens for them) and the control-plane RPC (``ratelimiter.control.port``:
the storage's fence, serving-lease and promotion authority), and the
binary TCP decision sidecar (``ratelimiter.sidecar.*``), which exposes
the trio under their limiter ids and serves the lease manager's v3 ops.
A sharded storage replicates per shard (``replication.targets``, one
standby a shard).  The in-process orchestrator
(``ratelimiter.orchestrator.*``, a sharded engine only) builds the N+1
topology: a flat standby a shard fed by per-shard epoch streams, a
``ShardFailoverRouter`` that the app, the lease manager and the wrappers
serve through, and the ``FailoverOrchestrator`` that fences, promotes and
re-seeds a dead shard on its own; it supersedes ``replication.*``.  The
adaptive policy controller (``ratelimiter.control.enabled``) runs its AIMD
loop over the serving storage (the router when the orchestrator is on), or,
with ``ratelimiter.control.fleet.enabled``, over an epoch-fenced
``FleetControlPlane`` whose members are the cell's control ports (this
node's own ``ratelimiter.control.port`` when no peers are listed), with a
``ControllerElection``.  The fleet node manager (``ratelimiter.fleet.*``)
spawns, adopts, probes and retires the cell's node processes (the port's
``replication/hostproc.py``) behind ``GET /actuator/fleet`` and the health
fold; with it the election rides the manager's probe tick, without it the
election runs on its own cadence thread.  Two
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


@dataclasses.dataclass
class ReplicationHandle:
    """What replication wiring hands the app: the primary's replicator
    or the standby's receiver+server, behind one close()."""

    role: str
    replicator: object = None
    receiver: object = None
    server: object = None

    def status(self) -> Dict:
        out = {"role": self.role}
        if self.replicator is not None:
            log = self.replicator.log
            if hasattr(log, "epochs"):  # sharded: an epoch stream a shard
                out.update(epochs=list(log.epochs),
                           shards=self.replicator.shard_status(),
                           journal=log.journal_kind)
            else:
                out.update(epoch=log.epoch, journal=log.journal_kind)
            out.update(lag_ms=self.replicator.lag_ms(),
                       frames_shipped=self.replicator.frames_shipped,
                       bytes_shipped=self.replicator.bytes_shipped,
                       errors=self.replicator.errors)
            if hasattr(self.replicator, "coalesced"):
                out["coalesced"] = self.replicator.coalesced
        if self.receiver is not None:
            out.update(applied_epoch=self.receiver.last_epoch,
                       consistent=self.receiver.consistent,
                       promoted=self.receiver.promoted,
                       frames_applied=self.receiver.frames_applied)
        return out

    def close(self) -> None:
        if self.replicator is not None:
            self.replicator.close()
        if self.server is not None:
            self.server.stop()


@dataclasses.dataclass
class OrchestratorHandle:
    """Self-healing failover wiring (``ratelimiter.orchestrator.*``): the
    orchestrator, the router the app serves through, the per-shard
    replicator feeding the in-process standby set."""

    orchestrator: object
    router: object
    replicator: object
    standby_set: object

    def status(self) -> Dict:
        out = {"enabled": True, **self.orchestrator.status()}
        out["router"] = {str(q): v
                         for q, v in self.router.shard_status().items()}
        out["replication"] = {str(q): v for q, v in
                              self.replicator.shard_status().items()}
        return out

    def close(self) -> None:
        self.orchestrator.close()
        self.replicator.close()
        # A standby whose receiver was PROMOTED is now the serving
        # replacement (closed with the router's chain); re-seeded fresh
        # standbys are ours to close.
        promoted = tuple(
            q for q, rx in enumerate(self.standby_set.receivers)
            if getattr(rx, "promoted", False))
        self.standby_set.close(except_shards=promoted)


@dataclasses.dataclass
class FleetControlHandle:
    """Fleet-true control wiring (``ratelimiter.control.fleet.*``): the
    epoch-fenced ``FleetControlPlane`` the adaptive controller actuates
    through, and the ``ControllerElection`` repairing leader death."""

    plane: object
    election: object

    def lagging_nodes(self) -> list:
        """Members whose last applied policy generation sits behind the
        leader's last broadcast — the generation-convergence invariant's
        health-fold signal (reads the plane's cached view; no RPC)."""
        target = int(self.plane.last_broadcast_generation)
        if target <= 0:
            return []
        return sorted(
            name for name, gen in self.plane.node_generations.items()
            if int(gen) < target)

    def status(self) -> Dict:
        out = {"enabled": True, "fleet": True,
               **self.plane.fleet_status()}
        out["election"] = self.election.status()
        out["lagging_nodes"] = self.lagging_nodes()
        return out

    def close(self) -> None:
        self.election.close()
        self.plane.close()


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
    # Replication (replication.enabled): the primary's replicator or the
    # standby's receiver and listener, behind GET /actuator/replication.
    replication: ReplicationHandle | None = None
    # Control-plane RPC listener (ratelimiter.control.port): this node's
    # probe / fence / lease / restore (/ promote on a standby) surface.
    control: object = None
    # The TCP decision sidecar (ratelimiter.sidecar.enabled): the health
    # state machine folds its shed and connection stats in.
    sidecar: object = None
    # Self-healing failover (ratelimiter.orchestrator.enabled): the
    # fence / promote / re-seed loop over a sharded primary, behind
    # GET /actuator/orchestrator.
    orchestrator: OrchestratorHandle | None = None
    # Adaptive policy controller (ratelimiter.control.enabled): the AIMD
    # loop behind GET /actuator/policies and the pin actuator.
    controller: object = None
    # Fleet NodeManager (ratelimiter.fleet.enabled): node lifecycle and the
    # autopilot's substrate behind GET /actuator/fleet.
    fleet: object = None
    # Fleet-true control plane (ratelimiter.control.fleet.enabled): the
    # epoch-fenced controller leadership and policy broadcast behind
    # GET /actuator/controller.
    fleet_control: FleetControlHandle | None = None

    def close(self) -> None:
        if self.edge is not None:
            # Return every outstanding bulk budget before the lease
            # manager (and its storage) goes away.
            try:
                self.edge.release_all()
            except Exception:  # noqa: BLE001 — best-effort drain
                pass
        if self.fleet is not None:
            self.fleet.close()
        if self.controller is not None:
            self.controller.close()
        if self.fleet_control is not None:
            self.fleet_control.close()
        if self.control is not None:
            self.control.stop()
        if self.sidecar is not None:
            self.sidecar.stop()
        if self.replication is not None:
            self.replication.close()
        if self.orchestrator is not None:
            self.orchestrator.close()
        self.storage.close()


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


def sharded_engine(props: AppProperties, devices):
    """The sharded engine ``build_storage`` serves over ``devices`` (a list
    of ``torch.device``), as the reference's wiring chooses it: with
    ``parallel.shard`` at ``auto`` / ``true`` / ``on`` and more than one
    device, a ``ShardedDeviceEngine`` of ``max(storage.num_slots // n,
    1)`` slots a shard; otherwise None (one engine on one device)."""
    shard = (props.get("parallel.shard") or "auto").lower()
    if shard not in ("auto", "true", "on") or len(devices) < 2:
        return None
    from ratelimiter_tpu_torch.engine.state import LimiterTable
    from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine

    num_slots = props.get_int("storage.num_slots", 1 << 20)
    table = LimiterTable(
        capacity=props.get_int("ratelimiter.table.capacity", 64),
        device=devices[0])
    return ShardedDeviceEngine(max(num_slots // len(devices), 1), table,
                               devices=devices)


def build_storage(props: AppProperties, meter_registry=None, *,
                  device=None) -> RateLimitStorage:
    """The storage ``storage.backend`` names: ``tpu`` builds
    ``GpuBatchedStorage`` (``device`` None: the card, raising without
    one), ``memory`` an ``InMemoryStorage``.

    With ``device`` None, ``parallel.shard`` at ``auto`` / ``true`` /
    ``on`` and more than one visible CUDA device, the slot array is
    sharded over all of them (:func:`sharded_engine`), as the reference
    shards over every visible device; one card, ``parallel.shard=off`` or
    a named device serve one engine."""
    backend = (props.get("storage.backend") or "tpu").lower()
    if backend == "memory":
        return InMemoryStorage()
    if backend != "tpu":
        raise ValueError(f"unknown storage.backend: {backend!r}")
    dev = resolve_device(device)
    engine = None
    if device is None:
        engine = sharded_engine(props, [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return GpuBatchedStorage(
        engine=engine,
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


def _maybe_sidecar(storage: RateLimitStorage, props: AppProperties,
                   registry: MeterRegistry):
    """The TCP decision sidecar when ``ratelimiter.sidecar.enabled`` (off
    by default), over the raw device storage: its pipelined
    ``acquire_async`` path needs the micro-batcher, and its per-frame
    admission control composes with (not under) the breaker and retry
    wrappers that serve the HTTP tier.  A backend without the batched
    decision protocol (``storage.backend=memory``) leaves it off with a
    warning, as the reference does."""
    if not props.get_bool("ratelimiter.sidecar.enabled", False):
        return None
    if not getattr(storage, "supports_device_batching", False):
        log.warning("ratelimiter.sidecar.enabled but the %s backend has no "
                    "batched decision protocol; sidecar disabled",
                    type(storage).__name__)
        return None
    from ratelimiter_tpu_torch.service.sidecar import SidecarServer

    return SidecarServer.from_props(storage, props, registry).start()


def _maybe_leases(storage: RateLimitStorage, sidecar, props: AppProperties,
                  registry: MeterRegistry):
    """The token-lease tier when ``ratelimiter.lease.enabled`` (off by
    default): a ``LeaseManager`` over the device storage, serving
    in-process ``LeaseClient``s through ``DirectTransport`` and, when a
    sidecar runs, its v3 LEASE / RENEW / RELEASE ops.  A backend without
    the ``lease_reserve`` surface (``storage.backend=memory``) leaves it
    off with a warning, as the reference does."""
    if not props.get_bool("ratelimiter.lease.enabled", False):
        return None
    if not getattr(storage, "supports_device_batching", False) \
            and not hasattr(storage, "lease_reserve"):
        log.warning("ratelimiter.lease.enabled but the %s backend has no "
                    "lease_reserve surface; leases disabled",
                    type(storage).__name__)
        return None
    from ratelimiter_tpu_torch.leases import LeaseManager

    manager = LeaseManager(
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
    if sidecar is not None:
        sidecar.attach_leases(manager)
    return manager


def _maybe_replication(storage: RateLimitStorage, props: AppProperties,
                       registry: MeterRegistry) -> ReplicationHandle | None:
    """Config-gated replication wiring (OFF by default).

    ``replication.role=primary`` journals this storage and ships epoch
    frames to ``replication.target`` (host:port of a standby's
    listener); ``replication.role=standby`` starts the frame listener on
    ``replication.listen_port`` over this storage, which then idles as a
    shadow until an operator promotes it.

    A SHARDED primary replicates per shard: ``replication.targets`` lists
    one standby ``host:port`` a shard (comma-separated, in shard order),
    and each shard ships its own epoch stream to an ordinary flat standby
    of ``slots_per_shard`` slots, so a promotion replaces one shard, never
    the world.  Another count of targets warns and disables replication,
    as the reference does."""
    if not props.get_bool("replication.enabled", False):
        return None
    if not getattr(getattr(storage, "engine", None), "supports_replication",
                   False):
        log.warning("replication.enabled but the %s backend has no "
                    "journaled engine; replication disabled",
                    type(storage).__name__)
        return None
    from ratelimiter_tpu_torch.replication import (
        ReplicationLog,
        ReplicationServer,
        Replicator,
        ShardedReplicationLog,
        ShardedReplicator,
        SocketSink,
        StandbyReceiver,
    )

    role = (props.get("replication.role") or "primary").lower()
    if role == "primary":
        engine = storage.engine
        if hasattr(engine, "n_shards"):
            targets = (props.get("replication.targets")
                       or props.get("replication.target") or "")
            parts = [t.strip() for t in targets.split(",") if t.strip()]
            if len(parts) != engine.n_shards:
                log.warning(
                    "sharded replication needs one replication.targets "
                    "entry per shard (%d given, %d shards); replication "
                    "disabled", len(parts), engine.n_shards)
                return None
            ack_s = props.get_float("replication.ack_timeout_ms",
                                    5000.0) / 1000.0
            sinks = {}
            for q, part in enumerate(parts):
                host, _, port = part.rpartition(":")
                sinks[q] = SocketSink(host or "127.0.0.1", int(port),
                                      ack_timeout=ack_s)
            repl = ShardedReplicator(
                ShardedReplicationLog(storage), sinks,
                interval_ms=props.get_float("replication.interval_ms",
                                            200.0),
                registry=registry,
            ).start()
            return ReplicationHandle(role="primary", replicator=repl)
        target = props.get("replication.target")
        if not target:
            log.warning("replication.role=primary without "
                        "replication.target; replication disabled")
            return None
        host, _, port = target.rpartition(":")
        repl = Replicator(
            ReplicationLog(storage),
            SocketSink(host or "127.0.0.1", int(port),
                       ack_timeout=props.get_float(
                           "replication.ack_timeout_ms", 5000.0) / 1000.0),
            interval_ms=props.get_float("replication.interval_ms", 200.0),
            registry=registry,
        ).start()
        return ReplicationHandle(role="primary", replicator=repl)
    if role == "standby":
        receiver = StandbyReceiver(storage, registry=registry)
        server = ReplicationServer(
            receiver, port=props.get_int("replication.listen_port", 7401),
        ).start()
        return ReplicationHandle(role="standby", receiver=receiver,
                                 server=server)
    raise ValueError(f"unknown replication.role: {role!r}")


def _maybe_control(storage: RateLimitStorage, props: AppProperties,
                   replication: ReplicationHandle | None):
    """Config-gated control-plane RPC port (OFF by default).

    Exposes this process's fence / lease / probe authority over the
    length-prefixed-JSON wire (replication/control.py) so a remote
    orchestrator, or an operator with a socket, can PROBE it, FENCE it,
    grant or renew its serving lease, and RESTORE (unfence) it.  A
    standby-role process also serves the remote-promotion RPC and the
    lease-relay mailbox.  Always binds the raw device storage: fencing
    authority is node-local and must not route through the wrappers."""
    port = props.get_int("ratelimiter.control.port", 0)
    if port <= 0:
        return None
    if not hasattr(storage, "fence"):
        log.warning("ratelimiter.control.port set but the %s backend has "
                    "no fence/lease surface; control port disabled",
                    type(storage).__name__)
        return None
    from ratelimiter_tpu_torch.replication.control import (
        ControlServer,
        primary_handlers,
        standby_handlers,
    )

    host = props.get("ratelimiter.control.host") or "127.0.0.1"
    if replication is not None and replication.receiver is not None:
        handlers = standby_handlers(storage, replication.receiver,
                                    repl_server=replication.server)
    else:
        handlers = primary_handlers(
            storage,
            replicator=(replication.replicator
                        if replication is not None else None))
    return ControlServer(handlers, host=host, port=port).start()


def _maybe_orchestrator(storage: RateLimitStorage, props: AppProperties,
                        registry: MeterRegistry):
    """Config-gated self-healing failover (OFF by default).

    Needs a SHARDED engine.  Builds the single-host N+1 topology: an
    in-process standby set (one flat ``GpuBatchedStorage`` of
    ``slots_per_shard`` slots a shard, on the engine's first device, with
    one C index: a shard's frames carry one index's fingerprints), the
    per-shard replication streams, a ``ShardFailoverRouter`` the app
    serves through, and the ``FailoverOrchestrator`` watching them: a
    dead shard is fenced, its standby promoted, its keys re-routed and a
    fresh standby re-seeded with no operator involved.  Over a flat
    engine it warns and stays off, as the reference does.

    Returns ``(handle or None, serving storage)``: when enabled, the
    ROUTER is the storage the breaker and retry wrappers compose around.
    """
    if not props.get_bool("ratelimiter.orchestrator.enabled", False):
        return None, storage
    engine = getattr(storage, "engine", None)
    if not hasattr(engine, "n_shards"):
        log.warning(
            "ratelimiter.orchestrator.enabled but the %s backend has no "
            "sharded engine (orchestrated failover promotes one shard of "
            "N); orchestrator disabled", type(storage).__name__)
        return None, storage
    from ratelimiter_tpu_torch.replication import (
        BackendLeaseChannel,
        FailoverOrchestrator,
        OrchestratorConfig,
        ShardedReplicationLog,
        ShardedReplicator,
        ShardFailoverRouter,
        ShardStandbySet,
    )

    sps = int(engine.slots_per_shard)

    def standby_factory():
        return GpuBatchedStorage(num_slots=sps, device=engine.device,
                                 host_parallel=0)

    standbys = ShardStandbySet(int(engine.n_shards), standby_factory,
                               registry=registry)
    repl = ShardedReplicator(
        ShardedReplicationLog(storage), standbys.in_process_sinks(),
        interval_ms=props.get_float("replication.interval_ms", 200.0),
        registry=registry,
    ).start()
    router = ShardFailoverRouter(storage)
    # The distributed fence lease: with a TTL set, every shard's channel
    # grants the one in-process primary, so the lease guards "the
    # orchestrator loop is alive and talking to us" (a hung or killed
    # orchestrator self-fences the storage within one TTL).  The
    # cross-host topology builds remote channels (replication/remote.py).
    lease_ttl = props.get_float(
        "ratelimiter.orchestrator.fence_lease_ttl_ms", 0.0)
    lease_channels = ({q: BackendLeaseChannel(storage)
                       for q in range(int(engine.n_shards))}
                      if lease_ttl > 0 else None)
    orch = FailoverOrchestrator(
        router, standbys, repl, standby_factory=standby_factory,
        config=OrchestratorConfig(
            probe_interval_ms=props.get_float(
                "ratelimiter.orchestrator.probe_interval_ms", 100.0),
            suspect_threshold=props.get_int(
                "ratelimiter.orchestrator.suspect_threshold", 3),
            hysteresis_ms=props.get_float(
                "ratelimiter.orchestrator.hysteresis_ms", 500.0),
            promote_retries=props.get_int(
                "ratelimiter.orchestrator.promote_retries", 3),
            promote_backoff_ms=props.get_float(
                "ratelimiter.orchestrator.promote_backoff_ms", 50.0),
            reseed=props.get_bool("ratelimiter.orchestrator.reseed", True),
            fence_lease_ttl_ms=lease_ttl,
            fence_wait_slack_ms=props.get_float(
                "ratelimiter.orchestrator.fence_wait_slack_ms", 100.0),
        ),
        lease_channels=lease_channels,
        registry=registry,
    ).start()
    handle = OrchestratorHandle(orchestrator=orch, router=router,
                                replicator=repl, standby_set=standbys)
    return handle, router


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


def _maybe_controller(serving: RateLimitStorage, props: AppProperties,
                      registry: MeterRegistry, breaker, recorder):
    """The adaptive policy controller when ``ratelimiter.control.enabled``
    (off by default): the tick-driven AIMD loop over ``serving`` (the
    router when the orchestrator is on, so policy updates reach promoted
    replacements as decisions do; the fleet plane in fleet mode),
    observing the telemetry plane's ``UsageSignals`` and the breaker's
    state, actuating live ``set_policy`` row updates.  A surface without
    ``set_policy`` or a telemetry plane (``storage.backend=memory``)
    leaves it off with a warning, as the reference does."""
    if not props.get_bool("ratelimiter.control.enabled", False):
        return None
    if not hasattr(serving, "set_policy") \
            or getattr(serving, "telemetry", None) is None:
        log.warning("ratelimiter.control.enabled but the %s backend has no "
                    "set_policy/telemetry surface; adaptive control "
                    "disabled", type(serving).__name__)
        return None
    from ratelimiter_tpu_torch.control import (
        AdaptivePolicyController,
        ControlConfig,
    )

    return AdaptivePolicyController(
        serving,
        ControlConfig(
            interval_ms=props.get_float("ratelimiter.control.interval_ms",
                                        1000.0),
            window_ms=props.get_int("ratelimiter.control.window_ms", 2000),
            target_excess=props.get_float(
                "ratelimiter.control.target_excess", 0.5),
            increase_fraction=props.get_float(
                "ratelimiter.control.increase_fraction", 0.1),
            decrease_factor=props.get_float(
                "ratelimiter.control.decrease_factor", 0.5),
            floor_fraction=props.get_float(
                "ratelimiter.control.floor_fraction", 0.1),
            global_cap_per_s=props.get_float(
                "ratelimiter.control.global_cap_per_s", 0.0),
            staleness_bound_ms=props.get_float(
                "ratelimiter.control.staleness_bound_ms", 0.0),
        ),
        breaker=breaker,
        registry=registry,
        recorder=recorder,
    ).start()


def _maybe_fleet_control(serving: RateLimitStorage, props: AppProperties,
                         registry: MeterRegistry, recorder, fleet=None):
    """The fleet-true control plane when
    ``ratelimiter.control.fleet.enabled`` (off by default): the adaptive
    controller then runs over a ``FleetControlPlane`` (fleet-summed
    ``UsageSignals`` in, epoch-fenced generation-stamped ``set_policy``
    broadcasts out) whose members are ``ratelimiter.control.fleet.peers``
    (``host:port`` control ports), or this node's own
    ``ratelimiter.control.port`` alone; without either it warns and stays
    off.  With a fleet node manager the ``ControllerElection`` rides its
    probe tick (leader death is repaired on the tick that notices node
    death); without one it runs on its own cadence thread.

    Returns ``(handle or None, controller surface)``: when enabled, the
    PLANE is what ``_maybe_controller`` builds on."""
    if not props.get_bool("ratelimiter.control.fleet.enabled", False):
        return None, serving
    import os

    peers = [p.strip() for p in
             (props.get("ratelimiter.control.fleet.peers") or "").split(",")
             if p.strip()]
    if not peers:
        # A single-node cell: this process's own control port is the one
        # member seat (leadership is then trivially held, but the epoch
        # and generation discipline and the actuator surface are those of
        # the multi-host shape).
        port = props.get_int("ratelimiter.control.port", 0)
        if port <= 0:
            log.warning("ratelimiter.control.fleet.enabled needs peers or "
                        "an own ratelimiter.control.port to form a member "
                        "set; fleet control disabled")
            return None, serving
        host = props.get("ratelimiter.control.host") or "127.0.0.1"
        peers = [f"{host}:{port}"]
    from ratelimiter_tpu_torch.control import (
        ControllerElection,
        FleetControlPlane,
    )
    from ratelimiter_tpu_torch.replication.control import ControlClient
    from ratelimiter_tpu_torch.replication.remote import RemoteBackend

    members = {}
    for part in peers:
        peer_host, _, peer_port = part.rpartition(":")
        backend = RemoteBackend(
            ControlClient(peer_host or "127.0.0.1", int(peer_port)),
            label=part)
        members[backend.label] = backend
    node = (props.get("ratelimiter.control.fleet.node")
            or f"ctrl-{os.getpid()}")
    plane = FleetControlPlane(
        node, members,
        ttl_ms=props.get_float("ratelimiter.control.fleet.ttl_ms", 3000.0),
        recorder=recorder)
    election = ControllerElection(
        [plane],
        interval_ms=props.get_float(
            "ratelimiter.control.fleet.interval_ms", 500.0),
        registry=registry, recorder=recorder)
    if fleet is not None:
        fleet.attach(election)
    else:
        election.start()
    return FleetControlHandle(plane=plane, election=election), plane


def _maybe_fleet(props: AppProperties, registry: MeterRegistry, recorder,
                 device=None):
    """The fleet ``NodeManager`` when ``ratelimiter.fleet.enabled`` (off
    by default).  It starts its probe cadence with an empty fleet: nodes
    are spawned or adopted by operator tooling (or an attached
    ``FleetAutopilot``); the service contributes the actuator, the health
    fold and the ``ratelimiter.fleet.*`` meters.  Spawned nodes run on
    ``device`` (None: the card)."""
    if not props.get_bool("ratelimiter.fleet.enabled", False):
        return None
    from ratelimiter_tpu_torch.fleet import LocalExecutor, NodeManager

    return NodeManager(
        executor=LocalExecutor(
            device=torch.device(device).type if device is not None
            else "cuda",
            boot_timeout_s=props.get_float(
                "ratelimiter.fleet.boot_timeout_s", 180.0)),
        probe_interval_ms=props.get_float(
            "ratelimiter.fleet.probe_interval_ms", 500.0),
        probe_fail_threshold=props.get_int(
            "ratelimiter.fleet.probe_fail_threshold", 3),
        registry=registry, recorder=recorder,
    ).start()


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
    replication = None
    control = None
    sidecar = None
    orchestrator = None
    controller = None
    fleet = None
    fleet_control = None
    if own_storage:
        # Self-healing failover: the orchestrator runs its own per-shard
        # replication into an in-process standby set, so it supersedes
        # the replication.* wiring (both would fight over the journal).
        orchestrator, serving = _maybe_orchestrator(storage, props,
                                                    registry)
        if orchestrator is not None and props.get_bool(
                "replication.enabled", False):
            log.warning("ratelimiter.orchestrator.enabled supersedes "
                        "replication.* wiring (the orchestrator runs its "
                        "own per-shard streams); replication.* ignored")
        elif orchestrator is None:
            # Replication journals the raw device storage (the engine's
            # hooks), beneath the wrappers; the control port binds its
            # fence and lease authority (and the standby's promotion).
            replication = _maybe_replication(storage, props, registry)
        # The sidecar decides over the raw storage too, beneath the
        # wrappers that serve the HTTP tier.
        sidecar = _maybe_sidecar(storage, props, registry)
        control = _maybe_control(storage, props, replication)
        if props.get_bool("warmup.enabled", True):
            warmup_s = warmup_shapes(
                storage, max_batch=props.get_int("batcher.max_batch", 8192))
            log.info("warmup of the micro steps and peeks: %.3f s", warmup_s)
        # The router (when the orchestrator is on) is the storage the
        # leases and the breaker / retry wrappers compose around; the
        # warmup ran on the raw device storage, and the sidecar decides
        # over it, as the reference's does.
        storage = serving
        # Leases grant against the serving storage, beneath the retry /
        # breaker wrappers, so a promoted replacement takes the charges
        # for its keys as it takes their decisions.
        leases = _maybe_leases(serving, sidecar, props, registry)
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
        fleet = _maybe_fleet(props, registry, recorder, device=device)
        # The adaptive controller actuates on the serving storage (the
        # router when present) and reads the breaker's overload state —
        # or, in fleet mode, on the epoch-fenced FleetControlPlane
        # broadcasting to the whole cell.
        fleet_control, control_target = _maybe_fleet_control(
            serving, props, registry, recorder, fleet)
        controller = _maybe_controller(control_target, props, registry,
                                       breaker, recorder)

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
    if sidecar is not None:
        # Expose the HTTP tier's limiters to sidecar clients under their
        # limiter ids: both front doors share one device counter per key.
        for limiter in limiters.values():
            lid = getattr(limiter, "_lid", None)
            if lid is not None:
                algo = ("tb" if isinstance(limiter, TokenBucketRateLimiter)
                        else "sw")
                sidecar.expose(lid, algo, limiter._config)
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
        replication=replication,
        control=control,
        sidecar=sidecar,
        orchestrator=orchestrator,
        controller=controller,
        fleet=fleet,
        fleet_control=fleet_control,
    )
