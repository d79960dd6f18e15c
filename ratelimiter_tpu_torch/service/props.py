"""Application properties (counterpart of
``ratelimiter_tpu/service/props.py``; C13 parity).

The reference configures itself via Spring ``application.properties``
(redis.host/redis.port/server.port, application.properties:1-15) with env
overrides from docker-compose.  Here: the same ``key=value`` file format,
env-var overrides (``RATELIMITER_<KEY with . -> _ uppercased>``), and typed
accessors with defaults.

Values are validated at construction: a malformed int/float/bool for a
known key logs a warning naming the offending key and falls back to the
default (a typo'd ``batcher.max_batch=81q2`` must not crash — or silently
zero — the batcher at first access), and unknown ``RATELIMITER_*`` env
keys / unknown file keys are warned about instead of passing silently.

The keys, defaults and parsing are the reference's, so one properties file
configures either package.  ``storage.backend=tpu`` names the device
backend (``GpuBatchedStorage`` on the card here).  ``service/wiring.py``
says which keys the port refuses (tiers it has not ported) and which it
ignores.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ratelimiter_tpu_torch.utils.logging import get_logger

log = get_logger("service.props")


DEFAULTS = {
    "server.port": "8080",
    # "tpu" (device-batched) or "memory" (host dict) — the storage plugin.
    "storage.backend": "tpu",
    "storage.num_slots": str(1 << 20),
    "batcher.max_batch": "8192",
    "batcher.max_delay_ms": "0.5",
    # Device batches allowed in flight at once (dispatched, fetch pending).
    # >1 overlaps fetch latency with the next dispatches.
    "batcher.max_inflight": "4",
    # Fail-open on storage failure: documented in the reference's
    # architecture notes but never implemented there (SURVEY.md §5.3);
    # implemented here and ON by default as documented.
    "ratelimiter.fail_open": "true",
    # Admission control (engine/batcher.py): bound on each algo's pending
    # micro-batch queue (0 = unbounded) and the per-request QUEUE deadline
    # budget in ms (0 = none) — a request not dispatched within it is shed
    # with a 429 + Retry-After instead of waiting forever.
    "ratelimiter.overload.max_pending": "65536",
    "ratelimiter.overload.deadline_ms": "1000",
    # /actuator/health reports SHEDDING while a shed happened within this
    # window (sheds are bursty; an instantaneous queue-depth read flaps).
    "ratelimiter.overload.shed_health_window_ms": "5000",
    # Circuit breaker (storage/breaker.py), composed retry(breaker(chaos(
    # storage))): consecutive backend faults open it; while open, decisions
    # short-circuit to the degraded host limiter (storage/degraded.py)
    # instead of paying retry exhaustion per request.
    "breaker.enabled": "true",
    "breaker.failure_threshold": "8",
    "breaker.open_ms": "5000",
    "breaker.half_open_probes": "1",
    # Degraded-mode host limiter: fail-approximate instead of fail-open
    # while the breaker is open (device-batching backends only).
    # max_keys bounds the last-seen-counter snapshot cache.
    "ratelimiter.degraded.enabled": "true",
    "ratelimiter.degraded.max_keys": "65536",
    # Decision sidecar (service/sidecar.py): binary TCP ingress funneling
    # every connection into the shared micro-batcher.  OFF by default —
    # when enabled, build_app starts it next to the HTTP tier on
    # sidecar.port.  The hardening bounds (0 disables each): frame/key
    # size caps answered in-protocol with BAD_FRAME, per-connection
    # pipeline cap shed with a typed retry-after status, global
    # connection limit, idle/read deadlines (slowloris), the bound on
    # waiting for a wedged batch, and the graceful-drain budget of stop().
    "ratelimiter.sidecar.enabled": "false",
    "ratelimiter.sidecar.port": "7400",
    "ratelimiter.sidecar.max_frame_bytes": "4096",
    "ratelimiter.sidecar.max_key_bytes": "1024",
    "ratelimiter.sidecar.max_pipeline": "1024",
    "ratelimiter.sidecar.max_connections": "1024",
    "ratelimiter.sidecar.idle_timeout_ms": "60000",
    "ratelimiter.sidecar.read_timeout_ms": "5000",
    "ratelimiter.sidecar.resolve_timeout_ms": "30000",
    "ratelimiter.sidecar.drain_timeout_ms": "1000",
    # Micro-batch assembly (ARCHITECTURE §6d).  adaptive_flush: the
    # flush deadline/size trigger track the measured device-step time
    # (engine/flush_control.py), hard-clamped within
    # [flush_floor_ms, batcher.max_delay_ms] / [32, batcher.max_batch].
    "ratelimiter.microbatch.adaptive_flush": "true",
    "ratelimiter.microbatch.flush_floor_ms": "0.05",
    # Hybrid host-side serving tier (cache/hybrid.py): answers hot
    # repeat-reject and safely-under-limit keys host-side from exact
    # adopted state, device-confirmed asynchronously; over-admission
    # bounded like the degraded path (one extra max_permits per key per
    # window, worst case).  OFF by default.  ttl_ms bounds staleness
    # since the last device confirmation; unconfirmed_cap bounds
    # forwarded-but-unconfirmed mutations per key; guard_ms refuses
    # host serves in the last slice of a sliding window.
    "ratelimiter.cache.hybrid.enabled": "false",
    "ratelimiter.cache.hybrid.ttl_ms": "50",
    "ratelimiter.cache.hybrid.max_keys": "65536",
    "ratelimiter.cache.hybrid.unconfirmed_cap": "64",
    "ratelimiter.cache.hybrid.guard_ms": "5",
    # Token leases (leases/, ARCHITECTURE §14): the server grants
    # clients bounded per-key permit budgets burned locally (protocol
    # v3 LEASE/RENEW/RELEASE on the sidecar) — one wire frame per
    # budget instead of one per decision.  OFF by default.
    # default_budget/max_budget bound grants (wire cap 65535); ttl_ms
    # bounds a dead client's strand (sliding-window leases also clamp
    # to the remaining window); deny_ttl_ms is the retry hint a zero
    # grant carries; max_leases bounds the server table.
    "ratelimiter.lease.enabled": "false",
    "ratelimiter.lease.default_budget": "64",
    "ratelimiter.lease.max_budget": "1024",
    "ratelimiter.lease.ttl_ms": "2000",
    "ratelimiter.lease.deny_ttl_ms": "25",
    "ratelimiter.lease.max_leases": "65536",
    # Bulk (aggregator-tier, §14b) grants may exceed max_budget up to
    # this cap; 0 keeps them clamped like ordinary grants.
    "ratelimiter.lease.max_bulk_budget": "0",
    # Edge aggregator tier (edge/, ARCHITECTURE §14b): one bulk lease
    # per hot (lid, key) subleased to in-process clients, the whole
    # portfolio renewed in ONE columnar frame per flush interval.
    # Requires ratelimiter.lease.enabled.  OFF by default.
    "ratelimiter.edge.enabled": "false",
    "ratelimiter.edge.bulk_budget": "4096",
    "ratelimiter.edge.slice_budget": "64",
    "ratelimiter.edge.flush_ms": "50",
    # Observability (observability/, ARCHITECTURE §13).  trace_sample:
    # record one full per-request lifecycle trace per ~N requests into
    # the enriched /actuator/trace ring (0 = off).  slo_ms: any dispatch
    # slower than this snapshots its stage breakdown + recent flight-
    # recorder events as an anomaly (0 = off).  flight_capacity: bound
    # on the structured-event ring behind /actuator/flightrecorder.
    "ratelimiter.obs.trace_sample": "0",
    "ratelimiter.obs.slo_ms": "0",
    "ratelimiter.obs.flight_capacity": "1024",
    # Fleet telemetry plane (observability/telemetry.py + usage.py,
    # ARCHITECTURE §13e): per-tenant usage ring bound (tenants over the
    # cap are counted, not tracked), the LRU window of distinct clients
    # tracked for the staleness gauge, and the trace-lineage ring bound
    # (sampled trace ids whose hop paths are retained).
    "ratelimiter.usage.max_tenants": "256",
    "ratelimiter.telemetry.max_clients": "1024",
    "ratelimiter.obs.lineage_capacity": "256",
    # Shard the slot array over all visible devices when > 1 (the port
    # refuses to boot on several visible cards unless this is off).
    "parallel.shard": "auto",
    # Run the hot dispatch shapes at boot (on the card this builds the
    # kernels at first use, before the first requests).
    "warmup.enabled": "true",
    # Boot-time host<->device link probe feeding the streaming loops'
    # elections and chunk plans (storage/gpu.py); a failing probe ends
    # the boot on the card.
    "link.probe.enabled": "true",
    # The reference's persistent XLA compile-cache dir; the port ignores
    # it (its kernels build from source at first use).
    "jax.cache.dir": "",
    # Chaos drill: inject StorageException on this fraction of storage ops
    # (0 = off) and/or add latency to every op (fault-tolerance rehearsal).
    "chaos.failure_rate": "0",
    "chaos.latency_ms": "0",
    # Console logging (application.properties:9-11 analog): level for the
    # ratelimiter_tpu_torch logger hierarchy + the console pattern (single
    # source of truth for the default lives in utils/logging.py).
    "logging.level": "INFO",
    "logging.pattern": "",  # empty -> utils/logging.DEFAULT_PATTERN
    # Per-op storage retry (RedisRateLimitStorage.java:155-178 analog):
    # attempts with linear backoff delay*attempt, then StorageException
    # escalates to fail-open. 0 retries disables the wrapper.
    "storage.retry.max_retries": "3",
    "storage.retry.delay_ms": "10",
    # Live state replication (replication/): OFF by default.  A primary
    # journals dirty slots and ships epoch frames to replication.target
    # (host:port of a standby's listener); a standby listens on
    # replication.listen_port, applies frames to its shadow engine, and
    # promotes via POST /actuator/replication/promote on failover.
    "replication.enabled": "false",
    "replication.role": "primary",
    "replication.target": "",
    "replication.targets": "",
    "replication.listen_port": "7401",
    "replication.interval_ms": "200",
    # Standby-link ack deadline (replication/transport.py): a send or
    # heartbeat unacked within this window fails fast, and enough
    # consecutive failures mark the link DEAD (standby gone, replica
    # going stale) instead of silently growing the coalescing queue.
    "replication.ack_timeout_ms": "5000",
    # Self-healing failover orchestrator (replication/orchestrator.py):
    # OFF by default.  When enabled on a SHARDED primary it builds an
    # in-process standby mesh (one flat standby per shard), replicates
    # per shard, routes through a ShardFailoverRouter, and watches
    # per-shard liveness through the MONITORING -> SUSPECT (consecutive
    # failures + hysteresis) -> FENCING (monotonic fence epoch; zombie
    # dispatches refused with FencedError) -> PROMOTING (bounded
    # retry/backoff) -> RESTORED (fresh standby re-seeded, back to N+1)
    # state machine — zero manual actuator calls.
    "ratelimiter.orchestrator.enabled": "false",
    "ratelimiter.orchestrator.probe_interval_ms": "100",
    "ratelimiter.orchestrator.suspect_threshold": "3",
    "ratelimiter.orchestrator.hysteresis_ms": "500",
    "ratelimiter.orchestrator.promote_retries": "3",
    "ratelimiter.orchestrator.promote_backoff_ms": "50",
    "ratelimiter.orchestrator.reseed": "true",
    # Distributed fence lease (ARCHITECTURE §10c): > 0 makes the
    # orchestrator grant the serving storage an epoch lease of this TTL,
    # renewed while probes answer — a primary partitioned from its
    # orchestrator self-fences within one TTL (bounded over-admission
    # with no quorum machinery).  0 keeps the process-local fence.
    # Keep the TTL at or above the detection budget
    # ((suspect_threshold+1)*probe_interval + hysteresis) or a healthy
    # flap can expire the lease mid-hysteresis.  fence_wait_slack_ms
    # pads the wait for an UNREACHABLE zombie's lease to expire before
    # its replacement is installed.
    "ratelimiter.orchestrator.fence_lease_ttl_ms": "0",
    "ratelimiter.orchestrator.fence_wait_slack_ms": "100",
    # Control-plane RPC port (replication/control.py; 0 = off).  Exposes
    # PROBE / FENCE / LEASE / RESTORE over length-prefixed JSON so a
    # REMOTE orchestrator (or an operator's script) can drive this
    # process's fence/lease authority — the cross-host topology's
    # per-node surface.  Binds ratelimiter.control.host (default
    # loopback; set to a mesh-reachable address in a real deployment).
    "ratelimiter.control.port": "0",
    "ratelimiter.control.host": "127.0.0.1",
    # Adaptive policy control plane (control/, ARCHITECTURE §15): OFF by
    # default.  When enabled, a tick-driven AIMD controller adjusts each
    # tenant's effective rate between an operator floor
    # (floor_fraction * the registered ceiling) and the ceiling —
    # additive raises while the tenant's denied+shed share of its
    # observed load stays under target_excess, multiplicative cuts
    # (decrease_factor) on overload — actuated as live set_policy row
    # updates stamped with a monotonic policy generation.
    # global_cap_per_s adds the hierarchical aggregate cap (0 = off):
    # when fleet observed load exceeds it, every tenant's effective
    # rate is scaled by cap/admitted.  Operators pin lids out of the
    # loop via POST /actuator/policies/<lid>/pin.
    "ratelimiter.control.enabled": "false",
    "ratelimiter.control.interval_ms": "1000",
    "ratelimiter.control.window_ms": "2000",
    "ratelimiter.control.target_excess": "0.5",
    "ratelimiter.control.increase_fraction": "0.1",
    "ratelimiter.control.decrease_factor": "0.5",
    "ratelimiter.control.floor_fraction": "0.1",
    "ratelimiter.control.global_cap_per_s": "0",
    # Telemetry staleness bound for the controller (ms; 0 = off): when
    # the plane's worst reporter staleness exceeds it, the controller
    # FREEZES raises (stale signals must never justify giving a tenant
    # more) while cuts stay allowed; each frozen tick emits a coalesced
    # ``control.signals_stale`` flight event.
    "ratelimiter.control.staleness_bound_ms": "0",
    # Fleet-true control plane (control/fleet.py, ARCHITECTURE §15):
    # OFF by default.  When enabled, the adaptive controller runs over
    # a FleetControlPlane instead of the local storage: observations
    # are the SUMMED UsageSignals of every peer (the global cap sees
    # fleet load), and actuations broadcast generation-stamped
    # set_policy rows to every peer — but only while this process
    # HOLDS the cell's controller lease (a majority of peer seats at
    # its fence epoch, renewed within ttl_ms on its own clock; losing
    # either self-demotes and refuses to actuate).  node is this
    # controller's identity (empty -> ctrl-<pid>); peers is a comma-
    # separated host:port list of member control ports (empty -> this
    # process's own ratelimiter.control.port, the single-node cell);
    # interval_ms is the election/renewal cadence.
    "ratelimiter.control.fleet.enabled": "false",
    "ratelimiter.control.fleet.node": "",
    "ratelimiter.control.fleet.peers": "",
    "ratelimiter.control.fleet.ttl_ms": "3000",
    "ratelimiter.control.fleet.interval_ms": "500",
    # Concurrency slots (leases as slots, ARCHITECTURE §15): bound every
    # tenant's aggregate outstanding lease budget to this many permits
    # (0 = unbounded).  Per-lid overrides via
    # LeaseManager.set_concurrency_cap.
    "ratelimiter.control.max_concurrent": "0",
    # Policy-table capacity (rows).  The table grows implicitly when
    # full, but a mid-traffic grow recompiles the device step for the
    # new table shape (LimiterTable._grow warns) — pre-size to the
    # expected tenant count.
    "ratelimiter.table.capacity": "64",
    # Fleet autopilot (fleet/, ARCHITECTURE §16): OFF by default.  When
    # enabled, this process runs a NodeManager that probes its managed
    # hostproc nodes every probe_interval_ms (one muxed probe_all RPC
    # per NODE), declares a node FAILED after probe_fail_threshold
    # consecutive probe misses or a process exit, and surfaces the
    # fleet on GET /actuator/fleet (FAILED/DRAINING nodes fold the
    # health state machine to DEGRADED).  boot_timeout_s bounds a
    # spawned node's wait for its ready line; reseed_deadline_s bounds
    # every automated cross-host re-seed job (a job past it is failed
    # loudly instead of wedging the cell at N+0); node_version is the
    # deploy version tag replacement nodes are spawned at — a rolling
    # upgrade bumps it, then drains nodes.
    "ratelimiter.fleet.enabled": "false",
    "ratelimiter.fleet.probe_interval_ms": "500",
    "ratelimiter.fleet.probe_fail_threshold": "3",
    "ratelimiter.fleet.boot_timeout_s": "180",
    "ratelimiter.fleet.reseed_deadline_s": "120",
    "ratelimiter.fleet.node_version": "v0",
}

# Typed keys: anything listed here is parse-checked at construction.
_INT_KEYS = (
    "server.port", "storage.num_slots", "batcher.max_batch",
    "batcher.max_inflight", "storage.retry.max_retries",
    "replication.listen_port", "ratelimiter.overload.max_pending",
    "breaker.failure_threshold", "breaker.half_open_probes",
    "ratelimiter.degraded.max_keys", "ratelimiter.sidecar.port",
    "ratelimiter.sidecar.max_frame_bytes",
    "ratelimiter.sidecar.max_key_bytes",
    "ratelimiter.sidecar.max_pipeline",
    "ratelimiter.sidecar.max_connections",
    "ratelimiter.obs.trace_sample",
    "ratelimiter.obs.flight_capacity",
    "ratelimiter.usage.max_tenants",
    "ratelimiter.telemetry.max_clients",
    "ratelimiter.obs.lineage_capacity",
    "ratelimiter.orchestrator.suspect_threshold",
    "ratelimiter.orchestrator.promote_retries",
    "ratelimiter.control.port",
    "ratelimiter.cache.hybrid.max_keys",
    "ratelimiter.cache.hybrid.unconfirmed_cap",
    "ratelimiter.lease.default_budget",
    "ratelimiter.lease.max_budget",
    "ratelimiter.lease.max_leases",
    "ratelimiter.lease.max_bulk_budget",
    "ratelimiter.edge.bulk_budget",
    "ratelimiter.edge.slice_budget",
    "ratelimiter.control.window_ms",
    "ratelimiter.control.max_concurrent",
    "ratelimiter.table.capacity",
    "ratelimiter.fleet.probe_fail_threshold",
)
_FLOAT_KEYS = (
    "batcher.max_delay_ms", "chaos.failure_rate", "chaos.latency_ms",
    "storage.retry.delay_ms", "replication.interval_ms",
    "ratelimiter.overload.deadline_ms",
    "ratelimiter.overload.shed_health_window_ms", "breaker.open_ms",
    "ratelimiter.sidecar.idle_timeout_ms",
    "ratelimiter.sidecar.read_timeout_ms",
    "ratelimiter.sidecar.resolve_timeout_ms",
    "ratelimiter.sidecar.drain_timeout_ms",
    "ratelimiter.obs.slo_ms",
    "replication.ack_timeout_ms",
    "ratelimiter.orchestrator.probe_interval_ms",
    "ratelimiter.orchestrator.hysteresis_ms",
    "ratelimiter.orchestrator.promote_backoff_ms",
    "ratelimiter.orchestrator.fence_lease_ttl_ms",
    "ratelimiter.orchestrator.fence_wait_slack_ms",
    "ratelimiter.microbatch.flush_floor_ms",
    "ratelimiter.cache.hybrid.ttl_ms",
    "ratelimiter.cache.hybrid.guard_ms",
    "ratelimiter.lease.ttl_ms",
    "ratelimiter.lease.deny_ttl_ms",
    "ratelimiter.edge.flush_ms",
    "ratelimiter.control.interval_ms",
    "ratelimiter.control.target_excess",
    "ratelimiter.control.increase_fraction",
    "ratelimiter.control.decrease_factor",
    "ratelimiter.control.floor_fraction",
    "ratelimiter.control.global_cap_per_s",
    "ratelimiter.control.staleness_bound_ms",
    "ratelimiter.control.fleet.ttl_ms",
    "ratelimiter.control.fleet.interval_ms",
    "ratelimiter.fleet.probe_interval_ms",
    "ratelimiter.fleet.boot_timeout_s",
    "ratelimiter.fleet.reseed_deadline_s",
)
_BOOL_KEYS = (
    "ratelimiter.fail_open", "warmup.enabled", "replication.enabled",
    "link.probe.enabled", "breaker.enabled", "ratelimiter.degraded.enabled",
    "ratelimiter.sidecar.enabled", "ratelimiter.orchestrator.enabled",
    "ratelimiter.orchestrator.reseed",
    "ratelimiter.microbatch.adaptive_flush",
    "ratelimiter.cache.hybrid.enabled",
    "ratelimiter.lease.enabled",
    "ratelimiter.edge.enabled",
    "ratelimiter.control.enabled",
    "ratelimiter.control.fleet.enabled",
    "ratelimiter.fleet.enabled",
)
_BOOL_TOKENS = ("1", "true", "yes", "on", "0", "false", "no", "off")

# RATELIMITER_* env vars read directly by engine/ops modules, not through
# this properties layer — the unknown-env scan must not warn about them.
_ENV_DIRECT = frozenset({
    "RATELIMITER_SORT_UNIQUES", "RATELIMITER_RATE_PROBE",
    "RATELIMITER_PALLAS", "RATELIMITER_PALLAS_INTERPRET",
    "RATELIMITER_BLOCK_SCATTER", "RATELIMITER_BLOCK_SCATTER_INTERPRET",
})


def _env_key(key: str) -> str:
    return "RATELIMITER_" + key.replace(".", "_").replace("-", "_").upper()


def _parses(key: str, value: str) -> bool:
    try:
        if key in _INT_KEYS:
            int(value)
        elif key in _FLOAT_KEYS:
            float(value)
        elif key in _BOOL_KEYS:
            return value.strip().lower() in _BOOL_TOKENS
        return True
    except (TypeError, ValueError):
        return False


class AppProperties:
    def __init__(self, values: Optional[Dict[str, str]] = None):
        self._values = dict(DEFAULTS)
        if values:
            for key in values:
                if key not in DEFAULTS:
                    log.warning("unknown property key %r (kept, but no "
                                "component reads it — typo?)", key)
            self._values.update(values)
        self._validate()

    def _validate(self) -> None:
        """Replace malformed typed values with their defaults, loudly."""
        for key, value in list(self._values.items()):
            if key in DEFAULTS and not _parses(key, value):
                log.warning(
                    "malformed value %r for property %r; using default %r",
                    value, key, DEFAULTS[key])
                self._values[key] = DEFAULTS[key]

    @classmethod
    def load(cls, path: Optional[str] = None) -> "AppProperties":
        values: Dict[str, str] = {}
        if path and os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line or line.startswith(("#", "!")):
                        continue
                    if "=" in line:
                        k, v = line.split("=", 1)
                        values[k.strip()] = v.strip()
        known_env = {_env_key(k): k for k in DEFAULTS}
        for env_name, env_value in os.environ.items():
            if not env_name.startswith("RATELIMITER_"):
                continue
            key = known_env.get(env_name)
            if key is not None:
                values[key] = env_value
            elif env_name not in _ENV_DIRECT:
                log.warning("unknown env override %s (no property maps to "
                            "it — typo?)", env_name)
        return cls(values)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._values.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        value = self._values.get(key)
        if value is None:
            return default
        try:
            return int(value)
        except (TypeError, ValueError):
            log.warning("malformed int %r for property %r; using %r",
                        value, key, default)
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        value = self._values.get(key)
        if value is None:
            return default
        try:
            return float(value)
        except (TypeError, ValueError):
            log.warning("malformed float %r for property %r; using %r",
                        value, key, default)
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        value = self._values.get(key)
        if value is None:
            return default
        return value.strip().lower() in ("1", "true", "yes", "on")
