"""Token-bucket limiter over the batched storage (counterpart of
``ratelimiter_tpu/algorithms/token_bucket.py``).

Behavioral parity with ``algorithms/TokenBucketRateLimiter.java:28-159``:
burst-friendly, atomic refill-then-consume executed inside the storage
backend (a device step on ``GpuBatchedStorage``), TTL = 2x window
refreshed only on allow, permits > capacity rejected client-side
(lines 110-116), and the same metric names (lines 87-93).
``get_available_permits`` is a read-only refill (the reference's version
always threw, quirk Q3).

Over a storage that batches on the device (``GpuBatchedStorage``, or the
wrappers around it) every decision is a registered-limiter device step;
over any other storage (``InMemoryStorage``) the limiter runs the
backend's ``token_bucket`` script per call, as the reference's compat
path does (``token_bucket_peek`` for the available permits).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from ratelimiter_tpu_torch.core.config import RateLimitConfig, TOKEN_FP_ONE
from ratelimiter_tpu_torch.core.limiter import RateLimiter
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.utils.logging import get_logger
from ratelimiter_tpu_torch.utils.tracing import (
    LIMITER_TRY_ACQUIRE_MANY,
    LIMITER_TRY_ACQUIRE_STREAM_IDS,
    span,
)

log = get_logger("algorithms.token_bucket")

# Calls of at least this many keys go through the pipelined string stream
# (storage.acquire_stream_strs) instead of one synchronous batch.
_STREAM_MIN = 1 << 15


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000


class TokenBucketRateLimiter(RateLimiter):
    def __init__(
        self,
        storage: RateLimitStorage,
        config: RateLimitConfig,
        meter_registry: MeterRegistry,
        clock_ms: Callable[[], int] = _wall_clock_ms,
    ):
        config.validate()
        if config.refill_rate <= 0:
            raise ValueError(
                "Token bucket requires positive refillRate. "
                "Use RateLimitConfig(refill_rate=...)")
        self._storage = storage
        self._config = config
        self._clock_ms = clock_ms

        self._allowed = meter_registry.counter(
            "ratelimiter.tokenbucket.allowed", "Allowed requests (token bucket)")
        self._rejected = meter_registry.counter(
            "ratelimiter.tokenbucket.rejected", "Rejected requests (token bucket)")

        self._lid = (
            storage.register_limiter("tb", config)
            if getattr(storage, "supports_device_batching", False)
            else None
        )

    # -- RateLimiter ----------------------------------------------------------
    def try_acquire(self, key: str, permits: int = 1) -> bool:
        if permits <= 0:
            raise ValueError("permits must be positive")
        cfg = self._config
        if permits > cfg.max_permits:
            # Can never fulfill this request
            # (TokenBucketRateLimiter.java:110-116).
            self._rejected.increment()
            return False

        if self._lid is not None:
            out = self._storage.acquire("tb", self._lid, key, permits)
            allowed = bool(out["allowed"])
            log.debug("tb decision key=%s permits=%d remaining=%d "
                      "allowed=%s", key, permits, int(out["remaining"]),
                      allowed)
            (self._allowed if allowed else self._rejected).increment()
            return allowed

        now = self._clock_ms()
        allowed_flag, _tokens_fp = self._storage.eval_script(
            "token_bucket",
            keys=[f"tb:{key}"],
            args=[
                cfg.max_permits_fp,
                cfg.refill_rate_fp,
                permits * TOKEN_FP_ONE,
                now,
                cfg.window_ms * 2,  # TTL: 2x window for safety
            ],
        )
        allowed = allowed_flag == 1
        log.debug("tb decision key=%s permits=%d tokens_fp=%d allowed=%s",
                  key, permits, _tokens_fp, allowed)
        (self._allowed if allowed else self._rejected).increment()
        return allowed

    def try_acquire_many(self, keys, permits=None):
        """Vectorized tryAcquire: one device batch, or from
        ``_STREAM_MIN`` keys the string stream
        (``storage.acquire_stream_strs``; unit permits go without a
        permits lane, so they take the relay).  The device step itself
        rejects permits > capacity pre-consume.  Without a device-batching
        storage: the scalar loop."""
        with span(LIMITER_TRY_ACQUIRE_MANY):
            if self._lid is None:
                return super().try_acquire_many(keys, permits)
            n = len(keys)
            unit = permits is None
            if not unit:
                permits = [int(p) for p in permits]
                if any(p <= 0 for p in permits):
                    raise ValueError("permits must be positive")
            if n >= _STREAM_MIN and hasattr(self._storage,
                                             "acquire_stream_strs"):
                allowed = self._storage.acquire_stream_strs(
                    "tb", self._lid, list(keys),
                    None if unit else np.asarray(permits, dtype=np.int64))
            else:
                out = self._storage.acquire_many(
                    "tb", [self._lid] * n, list(keys),
                    [1] * n if unit else permits)
                allowed = np.asarray(out["allowed"], dtype=bool)
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
        out = self._storage.acquire_many_ids("tb", self._lid, key_ids,
                                             permits)
        return self._tally(np.asarray(out["allowed"], dtype=bool))

    def try_acquire_stream_ids(self, key_ids, permits=None, *,
                               batch: int = 1 << 14, subbatches: int = 4):
        """Whole-stream integer-key tryAcquire (storage.acquire_stream_ids:
        the relay for unit permits, the weighted relay for permits in
        [1, 255], else the flat sorted step in super-batches of ``batch *
        subbatches`` requests); decisions match try_acquire_ids on the same
        chunking."""
        with span(LIMITER_TRY_ACQUIRE_STREAM_IDS):
            if self._lid is None:
                raise NotImplementedError("try_acquire_stream_ids requires a "
                                          "device-batching storage")
            return self._tally(self._storage.acquire_stream_ids(
                "tb", self._lid, key_ids, permits, batch=batch,
                subbatches=subbatches))

    def _tally(self, allowed: np.ndarray) -> np.ndarray:
        n_allowed = int(allowed.sum())
        self._allowed.add(n_allowed)
        self._rejected.add(len(allowed) - n_allowed)
        return allowed

    def get_available_permits(self, key: str) -> int:
        if self._lid is not None:
            return int(self._storage.available_many("tb", self._lid,
                                                    [key])[0])
        cfg = self._config
        (tokens_fp,) = self._storage.eval_script(
            "token_bucket_peek",
            keys=[f"tb:{key}"],
            args=[cfg.max_permits_fp, cfg.refill_rate_fp, self._clock_ms()],
        )
        return tokens_fp // TOKEN_FP_ONE

    def reset(self, key: str) -> None:
        if self._lid is not None:
            self._storage.reset_key("tb", self._lid, key)
            return
        self._storage.delete(f"tb:{key}")
