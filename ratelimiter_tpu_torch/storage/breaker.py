"""Circuit breaker over the storage plugin boundary (counterpart of
``ratelimiter_tpu/storage/breaker.py``, without the per-shard health of
the replicated router, which the port does not have yet).

Composed in ``service/wiring.py`` as ``retry(breaker(chaos(storage)))``:
the breaker sits INSIDE the retry wrapper, so every retry attempt against
a persistently-failing backend counts toward the consecutive-failure
threshold — a sustained outage stops paying full retry exhaustion after
``ceil(threshold / max_retries)`` requests instead of forever ("When Two
is Worse Than One", PAPERS.md: naive retry layering over a dead backend
only inflates tail latency).

States:

- **closed** — ops pass through; ``failure_threshold`` consecutive
  backend faults (validation/overload/lifecycle errors excluded) open it.
- **open** — for ``open_ms``, ops never touch the backend.  Decisions
  (``acquire`` / ``available_many`` / ``reset_key``) short-circuit to the
  attached ``DegradedHostLimiter`` when one is wired (fail-*approximate*);
  everything else raises ``CircuitOpenError`` immediately (a
  ``StorageException``, so the service tier's fail-open still applies on
  paths with no fallback).
- **half_open** — after ``open_ms``, up to ``half_open_probes`` ops are
  let through as probes.  A probe failure re-opens; once all probes
  succeed the breaker closes and **resyncs**: every key the degraded
  limiter mutated is reset on the device (its host-approximate state and
  the device's stale pre-outage state are both discarded), restoring
  decisions bit-identical to ``semantics/oracle.py`` — the contract
  ``storage/chaos.py:outage_drill`` proves.

The breaker also snapshots the last device-reported counter per key on
the healthy ``acquire`` path (into the fallback's ``note_seen`` cache) so
degraded mode starts each key from its last known budget rather than a
blank slate.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from ratelimiter_tpu_torch.engine.errors import OverloadedError, ShutdownError
from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.storage.chaos import _DECISION_OPS, _LEGACY_OPS
from ratelimiter_tpu_torch.storage.errors import CircuitOpenError
from ratelimiter_tpu_torch.utils.logging import get_logger

log = get_logger("storage.breaker")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

# Never counted as backend faults and never short-circuited into
# CircuitOpenError conversions: caller bugs and local admission/lifecycle
# signals (see RetryPolicy.no_retry for the same family).
_NO_COUNT = (ValueError, TypeError, KeyError,
             OverloadedError, ShutdownError, CircuitOpenError)

# Ops the breaker gates.  acquire/available_many/reset_key get explicit
# methods (they can fall back to the degraded limiter); the rest are
# generated pass-through-or-raise wrappers.
_GATED_PLAIN = tuple(op for op in _DECISION_OPS
                     if op not in ("acquire", "available_many", "reset_key")
                     ) + _LEGACY_OPS


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000


class CircuitBreakerStorage(RateLimitStorage):
    """Wraps a backend; opens after consecutive faults, degrades, resyncs."""

    def __init__(
        self,
        inner: RateLimitStorage,
        failure_threshold: int = 8,
        open_ms: float = 5000.0,
        half_open_probes: int = 1,
        clock_ms: Callable[[], int] = _wall_clock_ms,
        fallback=None,
        registry=None,
        recorder=None,
    ):
        if recorder is None:
            from ratelimiter_tpu_torch.observability import flight_recorder

            recorder = flight_recorder()
        self._recorder = recorder
        self._inner = inner
        self.failure_threshold = max(int(failure_threshold), 1)
        self.open_ms = float(open_ms)
        self.half_open_probes = max(int(half_open_probes), 1)
        self._clock_ms = clock_ms
        self.fallback = fallback
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._open_until = 0
        self._probe_budget = 0
        self._probe_successes = 0
        self.opened_total = 0
        self.resyncs_total = 0
        self._registry = registry
        self._state_gauge = (
            registry.gauge("ratelimiter.breaker.state",
                           "Breaker state: 0=closed 1=half_open 2=open")
            if registry is not None else None)
        self._opened_counter = (
            registry.counter("ratelimiter.breaker.opened",
                             "Breaker open transitions")
            if registry is not None else None)
        self._short_counter = (
            registry.counter(
                "ratelimiter.breaker.short_circuited",
                "Ops short-circuited while the breaker was open "
                "(degraded decisions + immediate CircuitOpenErrors)")
            if registry is not None else None)

    # -- state machine --------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def status(self) -> dict:
        with self._lock:
            out = {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "opened_total": self.opened_total,
                "resyncs_total": self.resyncs_total,
                "degraded_fallback": self.fallback is not None,
            }
        # A shard-aware backend (replication/sharded.py's failover
        # router): its per-shard serving state, so one failed shard reads
        # as DEGRADED capacity behind a closed breaker, not DOWN.
        shard_health = getattr(self._inner, "shard_health", None)
        if callable(shard_health):
            try:
                shards = shard_health()
                out["shards"] = {str(q): v for q, v in shards.items()}
                out["degraded_shards"] = sorted(
                    str(q) for q, v in shards.items() if v != "active")
            except Exception:  # noqa: BLE001 — status stays best-effort
                pass
        return out

    def trip(self) -> None:
        """Force-open (ops/test hook): behave as if the threshold tripped."""
        with self._lock:
            self._open_locked()

    def _set_gauge_locked(self) -> None:
        if self._state_gauge is not None:
            self._state_gauge.set(_STATE_GAUGE[self._state])

    def _open_locked(self) -> None:
        self._state = OPEN
        self._open_until = self._clock_ms() + self.open_ms
        self._probe_budget = 0
        self._probe_successes = 0
        self.opened_total += 1
        if self._opened_counter is not None:
            self._opened_counter.increment()
        self._set_gauge_locked()
        self._recorder.record(
            "breaker.open", consecutive_failures=self._consecutive,
            degraded=self.fallback is not None)
        log.warning("circuit breaker OPEN for %.0f ms (%d consecutive "
                    "failures); decisions %s", self.open_ms,
                    self._consecutive,
                    "degrade to the host limiter" if self.fallback is not None
                    else "short-circuit to CircuitOpenError")

    def _gate(self) -> str:
        """Admission verdict for one op: 'inner' | 'probe' | 'open'."""
        with self._lock:
            if self._state == CLOSED:
                return "inner"
            if self._state == OPEN:
                if self._clock_ms() >= self._open_until:
                    self._state = HALF_OPEN
                    self._probe_budget = self.half_open_probes
                    self._probe_successes = 0
                    self._set_gauge_locked()
                    self._recorder.record("breaker.half_open")
                    log.info("circuit breaker HALF_OPEN: probing backend")
                else:
                    return "open"
            # HALF_OPEN: hand out the probe budget; everyone else stays out.
            if self._probe_budget > 0:
                self._probe_budget -= 1
                return "probe"
            return "open"

    def _on_success(self, mode: str) -> None:
        resync = False
        with self._lock:
            self._consecutive = 0
            if mode == "probe" and self._state == HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    self._state = CLOSED
                    self._set_gauge_locked()
                    resync = True
                    self._recorder.record("breaker.close")
                    log.info("circuit breaker CLOSED: backend recovered")
        if resync:
            self._resync()

    def _on_failure(self, mode: str) -> None:
        with self._lock:
            if mode == "probe":
                log.warning("half-open probe failed; breaker re-opens")
                self._open_locked()
                return
            self._consecutive += 1
            if self._state == CLOSED and \
                    self._consecutive >= self.failure_threshold:
                self._open_locked()

    def _return_probe(self, mode: str) -> None:
        """A probe slot consumed by an op that raised a non-backend error
        (caller bug / overload) goes back to the budget."""
        if mode != "probe":
            return
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_budget += 1

    def _short_circuited(self) -> None:
        if self._short_counter is not None:
            self._short_counter.increment()

    def _call(self, op: str, *args, **kwargs):
        mode = self._gate()
        if mode == "open":
            self._short_circuited()
            raise CircuitOpenError(
                f"circuit breaker open; {op} short-circuited")
        try:
            out = getattr(self._inner, op)(*args, **kwargs)
        except _NO_COUNT:
            self._return_probe(mode)
            raise
        except Exception:
            self._on_failure(mode)
            raise
        self._on_success(mode)
        return out

    # -- resync (open -> closed) ----------------------------------------------
    def _resync(self) -> None:
        """Discard both sides of every key that diverged while degraded:
        reset it on the device (stale pre-outage counters) and drop the
        host approximation — decisions return to bit-identical-vs-oracle.
        A resync failure (backend flapped again) re-opens the breaker with
        the touched set intact, so the next recovery retries it."""
        fb = self.fallback
        if fb is None:
            return
        touched = fb.touched()
        try:
            for algo, lid, key in touched:
                self._inner.reset_key(algo, lid, key)
        except Exception as exc:  # noqa: BLE001 — reopen, keep the set
            log.warning("post-recovery resync failed (%s); breaker "
                        "re-opens with %d key(s) still to reset",
                        exc, len(touched))
            with self._lock:
                self._open_locked()
            return
        fb.clear_state()
        self.resyncs_total += 1
        self._recorder.record("breaker.resync", keys=len(touched))
        if touched:
            log.info("resynced %d degraded key(s) onto the device",
                     len(touched))

    # -- decision surface with degraded fallback -------------------------------
    def acquire(self, algo: str, lid: int, key: str, permits: int,
                **kwargs) -> dict:
        mode = self._gate()
        if mode == "open":
            self._short_circuited()
            if self.fallback is not None:
                return self.fallback.acquire(algo, lid, key, permits)
            raise CircuitOpenError(
                "circuit breaker open; acquire short-circuited")
        try:
            out = self._inner.acquire(algo, lid, key, permits, **kwargs)
        except _NO_COUNT:
            self._return_probe(mode)
            raise
        except Exception:
            self._on_failure(mode)
            raise
        self._on_success(mode)
        if self.fallback is not None:
            # Healthy-path snapshot: the device's post-op counter seeds
            # this key's degraded budget if an outage starts.
            val = out.get("cache_value", out.get("remaining"))
            if val is not None:
                self.fallback.note_seen(algo, lid, key, int(val),
                                        self._clock_ms())
        return out

    def available_many(self, algo: str, lid: int, keys, **kwargs):
        mode = self._gate()
        if mode == "open":
            self._short_circuited()
            if self.fallback is not None:
                import numpy as np

                return np.asarray(
                    self.fallback.available(algo, lid, list(keys)),
                    dtype=np.int64)
            raise CircuitOpenError(
                "circuit breaker open; available_many short-circuited")
        try:
            out = self._inner.available_many(algo, lid, keys, **kwargs)
        except _NO_COUNT:
            self._return_probe(mode)
            raise
        except Exception:
            self._on_failure(mode)
            raise
        self._on_success(mode)
        return out

    def reset_key(self, algo: str, lid: int, key: str, **kwargs) -> None:
        mode = self._gate()
        if mode == "open":
            self._short_circuited()
            if self.fallback is not None:
                # Applied host-side now; reaches the device at resync.
                return self.fallback.reset(algo, lid, key)
            raise CircuitOpenError(
                "circuit breaker open; reset_key short-circuited")
        try:
            out = self._inner.reset_key(algo, lid, key, **kwargs)
        except _NO_COUNT:
            self._return_probe(mode)
            raise
        except Exception:
            self._on_failure(mode)
            raise
        self._on_success(mode)
        return out

    def register_limiter(self, algo: str, config) -> int:
        """Pass-through + policy capture so the degraded limiter can
        approximate this lid during an outage.  Not failure-counted:
        registration happens at boot, before traffic."""
        lid = self._inner.register_limiter(algo, config)
        if self.fallback is not None:
            self.fallback.register(lid, algo, config)
        return lid

    # -- plumbing -------------------------------------------------------------
    def __getattr__(self, name):
        # Non-gated surface (flush, engine, trace, probe_link, checkpoint
        # hooks, _batcher, ...) passes straight through, mirroring the
        # retry/chaos wrappers.
        return getattr(self._inner, name)

    @property
    def supports_device_batching(self):  # type: ignore[override]
        return getattr(self._inner, "supports_device_batching", False)

    def is_available(self) -> bool:
        # Health reporting, never failure-counted: the health endpoint
        # combines this with the breaker state itself.
        return self._inner.is_available()

    def close(self) -> None:
        self._inner.close()


def _wrap(op: str):
    def method(self, *args, **kwargs):
        return self._call(op, *args, **kwargs)

    method.__name__ = op
    return method


for _op in _GATED_PLAIN:
    setattr(CircuitBreakerStorage, _op, _wrap(_op))
# The abstract-method set was frozen before the loop filled the contract in.
CircuitBreakerStorage.__abstractmethods__ = frozenset()
