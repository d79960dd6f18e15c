"""Core rate-limiter contract.

Mirrors the reference's algorithm-agnostic interface
``core/RateLimiter.java:16-43``: ``tryAcquire(key)``,
``tryAcquire(key, permits)``, ``getAvailablePermits(key)``, ``reset(key)``.

Batched extension: the batch entry points ``try_acquire_many`` /
``available_permits_many`` accept vectors of keys so callers (the HTTP
service, the benchmark harness, the micro-batcher) can amortize one device
dispatch over many decisions — the framework's replacement for the
reference's per-request Redis round-trip.
"""

from __future__ import annotations

import abc
from typing import Sequence

import numpy as np


class RateLimiter(abc.ABC):
    """Abstract rate limiter (core/RateLimiter.java:7-44)."""

    @abc.abstractmethod
    def try_acquire(self, key: str, permits: int = 1) -> bool:
        """Try to acquire ``permits`` permits for ``key`` without blocking.

        Returns True if acquired, False if the rate limit is exceeded.
        Raises ValueError if ``permits <= 0`` (the reference throws
        IllegalArgumentException, SlidingWindowRateLimiter.java:87-89).
        """

    @abc.abstractmethod
    def get_available_permits(self, key: str) -> int:
        """Remaining permits for ``key`` (core/RateLimiter.java:31-37)."""

    @abc.abstractmethod
    def reset(self, key: str) -> None:
        """Reset the limit for ``key`` (core/RateLimiter.java:39-43)."""

    # -- batch extensions (device batching) ----------------------------------
    def try_acquire_many(
        self, keys: Sequence[str], permits: Sequence[int] | None = None
    ) -> np.ndarray:
        """Vectorized tryAcquire. Default: loop over the scalar path."""
        if permits is None:
            permits = [1] * len(keys)
        return np.array(
            [self.try_acquire(k, int(p)) for k, p in zip(keys, permits)], dtype=bool
        )

    def available_permits_many(self, keys: Sequence[str]) -> np.ndarray:
        return np.array([self.get_available_permits(k) for k in keys], dtype=np.int64)
