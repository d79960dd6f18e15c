"""Fault-injecting storage wrapper (chaos testing) and the sustained-outage
drill (counterpart of ``ratelimiter_tpu/storage/chaos.py``: its
``FaultInjectingStorage`` and ``outage_drill``; the TCP fault proxy and
the other drills need the sidecar, replication, leases and control,
which the port does not have yet).

The reference has no fault injection at all (SURVEY.md §5.3 — its failure
handling is asserted, not exercised). This wrapper makes failure paths
first-class testable: it delegates to any ``RateLimitStorage`` and injects
``StorageException`` (and optional latency) on a configurable schedule, so
retry logic, fail-open policy, and metric accounting can be driven
deterministically in tests and chaos drills.

Determinism: failures come from a seeded RNG; ``fail_next(n)`` forces the
next n operations to fail regardless of probability — the tool for exact
retry-count assertions (the reference's retry wrapper does 3 attempts with
linear backoff; ``service/app.py`` implements the documented fail-open on
exhaustion).
"""

from __future__ import annotations

import collections
import random
import threading
import time

from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.storage.errors import StorageException

_DECISION_OPS = ("acquire", "acquire_many", "acquire_many_ids",
                 "acquire_stream_ids", "acquire_stream_strs",
                 "available_many", "reset_key")
_LEGACY_OPS = ("increment_and_expire", "get", "set", "compare_and_set",
               "delete", "z_add", "z_remove_range_by_score", "z_count",
               "eval_script")


class FaultInjectingStorage(RateLimitStorage):
    """Wraps a real backend; injects failures/latency on configured ops."""

    def __init__(
        self,
        inner: RateLimitStorage,
        failure_rate: float = 0.0,
        latency_ms: float = 0.0,
        seed: int = 0,
        ops: tuple = _DECISION_OPS + _LEGACY_OPS,
    ):
        self._inner = inner
        self.failure_rate = float(failure_rate)
        self.latency_ms = float(latency_ms)
        self._rng = random.Random(seed)
        self._ops = set(ops)
        self._lock = threading.Lock()
        self._forced = 0
        self.injected_failures = 0
        # Recent op names only — bounded so long-running drills can't leak.
        self.calls = collections.deque(maxlen=1024)

    # -- control surface ------------------------------------------------------
    def fail_next(self, n: int = 1) -> None:
        """Force the next ``n`` wrapped operations to fail."""
        with self._lock:
            self._forced += int(n)

    def heal(self) -> None:
        """Cancel any remaining forced failures (drills: end an outage)."""
        with self._lock:
            self._forced = 0

    def _maybe_fail(self, op: str) -> None:
        if op not in self._ops:
            return
        with self._lock:
            self.calls.append(op)
            if self._forced > 0:
                self._forced -= 1
                self.injected_failures += 1
                raise StorageException(f"injected failure in {op}")
            if self.failure_rate and self._rng.random() < self.failure_rate:
                self.injected_failures += 1
                raise StorageException(f"injected failure in {op}")
        if self.latency_ms:
            time.sleep(self.latency_ms / 1000.0)

    def __getattr__(self, name):
        # Everything not explicitly wrapped (register_limiter, flush,
        # checkpoints, attributes like engine/trace) passes straight through.
        return getattr(self._inner, name)

    # -- wrapped surface ------------------------------------------------------
    @property
    def supports_device_batching(self):  # type: ignore[override]
        return getattr(self._inner, "supports_device_batching", False)


def _wrap(op: str):
    def method(self, *args, **kwargs):
        self._maybe_fail(op)
        return getattr(self._inner, op)(*args, **kwargs)

    method.__name__ = op
    return method


for _op in _DECISION_OPS + _LEGACY_OPS + ("is_available", "close"):
    setattr(FaultInjectingStorage, _op, _wrap(_op))
# is_available/close are wrapped for delegation but never injected by
# default (they are the health/shutdown path; pass them in ``ops`` to
# chaos-test the health check itself).
#
# The abstract-method set was frozen before the loop above filled the
# contract in; clear it so the wrapper instantiates.
FaultInjectingStorage.__abstractmethods__ = frozenset()


# ---------------------------------------------------------------------------
# Sustained-outage drill (breaker open -> degraded -> resync -> bit-identical)
# ---------------------------------------------------------------------------

def outage_drill(
    num_slots: int = 512,
    n_keys: int = 24,
    healthy_waves: int = 3,
    outage_waves: int = 4,
    post_waves: int = 3,
    batch: int = 24,
    seed: int = 0,
    failure_threshold: int = 4,
    max_retries: int = 2,
    open_ms: float = 5000.0,
    registry=None,
    storage_factory=None,
) -> dict:
    """Deterministic sustained-outage drill over the production composition
    ``retry(breaker(chaos(storage)))``, differential vs the oracle.

    Phases, all under a controlled clock:

    1. **Healthy** — mixed sw/tb waves through single ``acquire``; every
       decision checked bit-exact against ``semantics/oracle.py`` (and the
       breaker's healthy path snapshots each key's last counter into the
       degraded limiter's seed cache).
    2. **Outage** — every backend op is forced to fail.  The drill proves
       the breaker opens within ``ceil(threshold / attempts)`` requests
       (each retry attempt counts), then that decisions are served by the
       degraded host limiter — marked ``degraded``, ZERO backend calls
       (the short-circuit claim, checked against the injector's op log),
       and per-key-per-window admission never exceeds ``max_permits``
       (bounded over-admission: fail-*approximate*, not fail-open).
    3. **Recovery** — the fault is healed and the clock advanced past
       ``open_ms``; a half-open probe on a dedicated key closes the
       breaker, which resyncs: every key the degraded limiter mutated is
       reset on the device.  The drill mirrors those resets in the oracle.
    4. **Post-resync** — waves again, bit-identical vs the oracle.

    The storage is ``GpuBatchedStorage(num_slots=num_slots, clock_ms=...)``
    on the card, or what ``storage_factory(num_slots, clock_ms)`` returns
    (for example a ``device="cpu"`` storage, or one that counts its
    clears).

    Returns a report dict; raises AssertionError on any violated claim.
    """
    import math
    import random

    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.storage.breaker import (
        CLOSED,
        OPEN,
        CircuitBreakerStorage,
    )
    from ratelimiter_tpu_torch.storage.degraded import DegradedHostLimiter
    from ratelimiter_tpu_torch.storage.errors import (
        RetryPolicy,
        StorageException,
    )
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
    from ratelimiter_tpu_torch.storage.retry import RetryingStorage

    from ratelimiter_tpu_torch.observability import flight_recorder

    frec = flight_recorder()
    fmark = frec.mark()
    rng = random.Random(seed)
    clock = {"t": 1_753_000_000_000}
    if storage_factory is None:
        def storage_factory(n, clock_ms):
            return GpuBatchedStorage(num_slots=n, clock_ms=clock_ms)
    inner = storage_factory(num_slots, lambda: clock["t"])
    chaos = FaultInjectingStorage(inner)
    fallback = DegradedHostLimiter(clock_ms=lambda: clock["t"],
                                   registry=registry)
    breaker = CircuitBreakerStorage(
        chaos, failure_threshold=failure_threshold, open_ms=open_ms,
        half_open_probes=1, clock_ms=lambda: clock["t"], fallback=fallback,
        registry=registry)
    storage = RetryingStorage(breaker, RetryPolicy(
        max_retries=max_retries, retry_delay_ms=0.01))

    cfg_sw = RateLimitConfig(max_permits=12, window_ms=2000,
                             enable_local_cache=False)
    cfg_tb = RateLimitConfig(max_permits=20, window_ms=2000, refill_rate=8.0)
    lid_sw = storage.register_limiter("sw", cfg_sw)
    lid_tb = storage.register_limiter("tb", cfg_tb)
    oracle_sw = SlidingWindowOracle(cfg_sw)
    oracle_tb = TokenBucketOracle(cfg_tb)

    report = {"decisions": 0, "mismatches": 0, "requests_to_open": 0,
              "degraded_decisions": 0, "over_admissions": 0,
              "touched_keys": 0, "shorted_backend_calls": 0}

    def one(algo, lid, oracle, key, permits, check=True):
        now = clock["t"]
        out = storage.acquire(algo, lid, key, permits)
        if not check:
            return out
        d = oracle.try_acquire(key, permits, now)
        report["decisions"] += 1
        hint = out.get("cache_value", out.get("remaining"))
        if (bool(out["allowed"]) != d.allowed
                or int(out["observed"]) != d.observed
                or int(hint) != d.remaining_hint):
            report["mismatches"] += 1
        return out

    def wave(check=True):
        clock["t"] += rng.choice([3, 17, 250, 999, 2000])
        for _ in range(batch):
            key = f"u{rng.randrange(n_keys)}"
            permits = rng.choice([1, 1, 1, 2, 5])
            one("sw", lid_sw, oracle_sw, key, permits, check=check)
            one("tb", lid_tb, oracle_tb, key, permits, check=check)

    try:
        # Phase 1: healthy, bit-identical.
        for _ in range(healthy_waves):
            wave()
        assert report["mismatches"] == 0, (
            f"healthy phase diverged from the oracle: {report}")

        # Phase 2: sustained outage.
        chaos.fail_next(10_000_000)
        budget = math.ceil(failure_threshold / max(max_retries, 1)) + 1
        opened_after = None
        for i in range(budget):
            try:
                storage.acquire("sw", lid_sw, f"u{i % n_keys}", 1)
            except StorageException:
                pass
            if breaker.state == OPEN:
                opened_after = i + 1
                break
        assert opened_after is not None, (
            f"breaker failed to open within {budget} requests of a "
            f"sustained outage (threshold={failure_threshold}, "
            f"attempts/request={max_retries})")
        report["requests_to_open"] = opened_after

        # Degraded service: no exceptions, no backend traffic, admission
        # bounded per key per window by the policy ceiling.
        backend_calls_at_open = len(chaos.calls)
        admitted: dict = {}
        for _ in range(outage_waves):
            clock["t"] += rng.choice([3, 17, 250, 999])
            for _ in range(batch):
                key = f"u{rng.randrange(n_keys)}"
                permits = rng.choice([1, 1, 2, 5])
                out = storage.acquire("sw", lid_sw, key, permits)
                assert out.get("degraded"), (
                    "breaker open but the decision did not come from the "
                    f"degraded host limiter: {out}")
                report["degraded_decisions"] += 1
                if out["allowed"]:
                    # The sw bucket counts REQUESTS (one increment per
                    # acquire regardless of permits — reference quirk
                    # Q1/Q2), so the per-bucket admission ceiling is
                    # max_permits requests.
                    win = clock["t"] // cfg_sw.window_ms
                    admitted[key, win] = admitted.get((key, win), 0) + 1
        report["shorted_backend_calls"] = (
            len(chaos.calls) - backend_calls_at_open)
        assert report["shorted_backend_calls"] == 0, (
            "degraded decisions still reached the backend: "
            f"{report['shorted_backend_calls']} op(s) after open")
        report["over_admissions"] = sum(
            1 for count in admitted.values() if count > cfg_sw.max_permits)
        assert report["over_admissions"] == 0, (
            f"degraded mode over-admitted past the policy ceiling: {admitted}")

        # Phase 3: heal, half-open probe, close + resync.
        chaos.heal()
        clock["t"] += int(open_ms) + 1
        touched = fallback.touched()
        report["touched_keys"] = len(touched)
        assert report["touched_keys"] > 0, "outage phase mutated no keys?"
        probe = storage.acquire("sw", lid_sw, "__probe__", 1)
        assert not probe.get("degraded") and breaker.state == CLOSED, (
            f"half-open probe did not close the breaker: state="
            f"{breaker.state}")
        assert breaker.resyncs_total == 1
        # Mirror the resync in the oracle: reset exactly the touched keys.
        oracle_sw.try_acquire("__probe__", 1, clock["t"])
        for algo, _lid, key in touched:
            (oracle_sw if algo == "sw" else oracle_tb).reset(key, clock["t"])

        # Phase 4: post-resync, bit-identical again.
        for _ in range(post_waves):
            wave()
        assert report["mismatches"] == 0, (
            f"post-resync decisions diverged from the oracle: {report}")

        # Flight-recorder timeline (ARCHITECTURE §13): the outage must
        # read back as open -> half_open -> close -> resync, in order.
        kinds = [e["kind"] for e in frec.events(kind="breaker",
                                                since=fmark)]
        timeline = iter(kinds)
        assert all(k in timeline for k in (
            "breaker.open", "breaker.half_open", "breaker.close",
            "breaker.resync")), (
            f"flight recorder missed the outage timeline: {kinds}")
        report["flight_timeline"] = kinds
    finally:
        storage.close()
    return report
