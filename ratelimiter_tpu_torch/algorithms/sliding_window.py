"""Sliding-window-counter limiter over the batched storage (counterpart of
``ratelimiter_tpu/algorithms/sliding_window.py``).

Behavioral parity with ``algorithms/SlidingWindowRateLimiter.java:34-189``:
two fixed window buckets with a weighted estimate, a local negative cache
that short-circuits repeat rejections (lines 93-100), pre-check then
increment-by-one (quirks Q1/Q2), and the same metric names (lines 67-77).
The estimate is the exact integer arithmetic of ``semantics/oracle.py``.

Over a storage that batches on the device (``GpuBatchedStorage``, or the
wrappers around it) every decision is a registered-limiter device step;
over any other storage (``InMemoryStorage``) the limiter takes the
reference's compat path, one storage operation at a time.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from ratelimiter_tpu_torch.cache import TTLCache
from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.core.limiter import RateLimiter
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.utils.logging import get_logger
from ratelimiter_tpu_torch.utils.tracing import (
    LIMITER_TRY_ACQUIRE_MANY,
    LIMITER_TRY_ACQUIRE_STREAM_IDS,
    span,
)

log = get_logger("algorithms.sliding_window")

# Calls of at least this many keys on a limiter without a local cache go
# through the pipelined string stream (storage.acquire_stream_strs)
# instead of one synchronous batch.
_STREAM_MIN = 1 << 15


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000


class SlidingWindowRateLimiter(RateLimiter):
    def __init__(
        self,
        storage: RateLimitStorage,
        config: RateLimitConfig,
        meter_registry: MeterRegistry,
        clock_ms: Callable[[], int] = _wall_clock_ms,
    ):
        config.validate()
        self._storage = storage
        self._config = config
        self._clock_ms = clock_ms

        # Local cache to reduce storage round trips; short TTL balances
        # performance vs accuracy (SlidingWindowRateLimiter.java:55-64).
        if config.enable_local_cache:
            self._local_cache = TTLCache(
                ttl_ms=config.local_cache_ttl_ms, max_size=10_000, clock_ms=clock_ms
            )
        else:
            self._local_cache = None

        self._allowed = meter_registry.counter(
            "ratelimiter.requests.allowed", "Number of allowed requests")
        self._rejected = meter_registry.counter(
            "ratelimiter.requests.rejected", "Number of rejected requests")
        self._cache_hits = meter_registry.counter(
            "ratelimiter.cache.hits", "Number of local cache hits")

        # Device-batching backend: whole decisions run as device steps
        # behind the same storage boundary; per-op storage calls otherwise.
        self._lid = (
            storage.register_limiter("sw", config)
            if getattr(storage, "supports_device_batching", False)
            else None
        )

    # -- RateLimiter ----------------------------------------------------------
    def try_acquire(self, key: str, permits: int = 1) -> bool:
        if permits <= 0:
            raise ValueError("permits must be positive")

        # Fast path: recently-seen count at/over the limit -> reject without
        # touching storage (SlidingWindowRateLimiter.java:93-100).
        if self._local_cache is not None:
            cached = self._local_cache.get_if_present(key)
            if cached is not None and cached >= self._config.max_permits:
                self._cache_hits.increment()
                self._rejected.increment()
                return False

        if self._lid is not None:
            out = self._storage.acquire("sw", self._lid, key, permits)
            if self._local_cache is not None:
                self._local_cache.put(key, int(out["cache_value"]))
            allowed = bool(out["allowed"])
            # Decision trace (SlidingWindowRateLimiter.java:176-177 analog).
            log.debug("sw decision key=%s permits=%d observed=%d allowed=%s",
                      key, permits, int(out["observed"]), allowed)
            (self._allowed if allowed else self._rejected).increment()
            return allowed

        now = self._clock_ms()
        current = self._current_count(key, now)

        if current + permits > self._config.max_permits:
            # Cache the rejection to avoid hammering storage
            # (SlidingWindowRateLimiter.java:104-111).
            if self._local_cache is not None:
                self._local_cache.put(key, current)
            self._rejected.increment()
            return False

        # Increment the current bucket atomically (quirk Q1: by 1, not by
        # `permits`) and re-check on the raw counter (quirk Q2).
        win = self._config.window_ms
        new_count = self._storage.increment_and_expire(
            self._window_key(key, now, win), win)

        if self._local_cache is not None:
            self._local_cache.put(key, new_count)

        allowed = new_count <= self._config.max_permits
        log.debug("sw decision key=%s permits=%d count=%d allowed=%s",
                  key, permits, new_count, allowed)
        (self._allowed if allowed else self._rejected).increment()
        return allowed

    def try_acquire_many(self, keys, permits=None):
        """Vectorized tryAcquire: one device batch for the whole call, or,
        from ``_STREAM_MIN`` keys on a limiter without a local cache, the
        string stream (``storage.acquire_stream_strs``; unit permits go
        without a permits lane, so they take the relay).  A cached
        limiter keeps the batch, whose ``cache_value`` lane feeds the
        cache.  Without a device-batching storage: the scalar loop."""
        with span(LIMITER_TRY_ACQUIRE_MANY):
            if self._lid is None:
                return super().try_acquire_many(keys, permits)
            n = len(keys)
            unit = permits is None
            if not unit:
                permits = [int(p) for p in permits]
                if any(p <= 0 for p in permits):
                    raise ValueError("permits must be positive")
            if (n >= _STREAM_MIN and self._local_cache is None
                    and hasattr(self._storage, "acquire_stream_strs")):
                return self._tally(self._storage.acquire_stream_strs(
                    "sw", self._lid, list(keys),
                    None if unit else np.asarray(permits, dtype=np.int64)))
            out = self._storage.acquire_many(
                "sw", [self._lid] * n, list(keys),
                [1] * n if unit else permits)
            allowed = np.asarray(out["allowed"], dtype=bool)
            if self._local_cache is not None:
                for k, v in zip(keys, out["cache_value"]):
                    self._local_cache.put(k, int(v))
            return self._tally(allowed)

    def try_acquire_ids(self, key_ids, permits=None):
        """Integer-key vectorized tryAcquire: one C index call assigns the
        slots, one device batch decides (device-batching storage only)."""
        if self._lid is None:
            raise NotImplementedError(
                "try_acquire_ids requires a device-batching storage")
        key_ids = np.ascontiguousarray(key_ids, dtype=np.int64)
        permits = (np.ones(len(key_ids), dtype=np.int64) if permits is None
                   else np.ascontiguousarray(permits, dtype=np.int64))
        out = self._storage.acquire_many_ids("sw", self._lid, key_ids,
                                             permits)
        return self._tally(np.asarray(out["allowed"], dtype=bool))

    def try_acquire_stream_ids(self, key_ids, permits=None, *,
                               batch: int = 1 << 14, subbatches: int = 4):
        """Whole-stream integer-key tryAcquire (storage.acquire_stream_ids:
        the relay for unit permits, the weighted relay for permits in
        [1, 255], else the flat sorted step in super-batches of ``batch *
        subbatches`` requests); decisions match try_acquire_ids on the same
        chunking. The local cache is bypassed, as for
        try_acquire_ids."""
        with span(LIMITER_TRY_ACQUIRE_STREAM_IDS):
            if self._lid is None:
                raise NotImplementedError("try_acquire_stream_ids requires a "
                                          "device-batching storage")
            return self._tally(self._storage.acquire_stream_ids(
                "sw", self._lid, key_ids, permits, batch=batch,
                subbatches=subbatches))

    def _tally(self, allowed: np.ndarray) -> np.ndarray:
        n_allowed = int(allowed.sum())
        self._allowed.add(n_allowed)
        self._rejected.add(len(allowed) - n_allowed)
        return allowed

    def get_available_permits(self, key: str) -> int:
        if self._lid is not None:
            return int(self._storage.available_many("sw", self._lid,
                                                    [key])[0])
        current = self._current_count(key, self._clock_ms())
        return max(0, self._config.max_permits - current)

    def reset(self, key: str) -> None:
        if self._lid is not None:
            self._storage.reset_key("sw", self._lid, key)
            if self._local_cache is not None:
                self._local_cache.invalidate(key)
            return
        now = self._clock_ms()
        win = self._config.window_ms
        # Clear current and previous windows
        # (SlidingWindowRateLimiter.java:140-153).
        self._storage.delete(self._window_key(key, now, win))
        self._storage.delete(self._window_key(key, now - win, win))
        if self._local_cache is not None:
            self._local_cache.invalidate(key)

    # -- internals ------------------------------------------------------------
    def _current_count(self, key: str, now: int) -> int:
        """Weighted two-window estimate, exact integer form
        (SlidingWindowRateLimiter.java:158-180)."""
        win = self._config.window_ms
        curr = self._storage.get(self._window_key(key, now, win))
        prev = self._storage.get(self._window_key(key, now - win, win))
        rem = now % win
        return curr + (prev * (win - rem)) // win

    @staticmethod
    def _window_key(key: str, timestamp_ms: int, window_ms: int) -> str:
        window_start = (timestamp_ms // window_ms) * window_ms
        return f"rl:{key}:{window_start}"
