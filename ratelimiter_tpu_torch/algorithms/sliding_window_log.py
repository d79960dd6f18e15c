"""Sliding-window-log limiter — exact (non-approximated) sliding window
(counterpart of ``ratelimiter_tpu/algorithms/sliding_window_log.py``).

The reference declares sorted-set storage methods for this algorithm but
never implements it (quirk Q5 in SURVEY.md: ``zAdd``/``zRemoveRangeByScore``/
``zCount`` are dead surface).  This framework implements it, making the
zset portion of the storage contract load-bearing:

- every allowed request appends a timestamped member to the key's zset,
- expired members (older than ``now - window``) are pruned on access,
- the decision counts live members: exact sliding window, O(window·rate)
  memory per key (vs O(1) for the counter approximation).

This algorithm runs over the generic storage contract (host-side on both
backends — per-key event lists are deliberately not a device structure; the
device engines implement the O(1)-per-key algorithms).  Use it when exact
boundary behavior matters more than hyperscale throughput.

Semantics notes:
- ``try_acquire(key, permits)`` admits iff live_count + permits <= max and
  then records ``permits`` members (unlike the counter algorithm's quirky
  increment-by-one, this algorithm is exact — documented difference).
- Members are unique per (timestamp, sequence) so equal-ms requests don't
  collapse.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.core.limiter import RateLimiter
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.storage.base import RateLimitStorage


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000


class SlidingWindowLogRateLimiter(RateLimiter):
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
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._allowed = meter_registry.counter(
            "ratelimiter.log.allowed", "Allowed requests (sliding window log)")
        self._rejected = meter_registry.counter(
            "ratelimiter.log.rejected", "Rejected requests (sliding window log)")

    def _zkey(self, key: str) -> str:
        return f"rll:{key}"

    def try_acquire(self, key: str, permits: int = 1) -> bool:
        if permits <= 0:
            raise ValueError("permits must be positive")
        cfg = self._config
        now = self._clock_ms()
        zkey = self._zkey(key)
        with self._lock:
            # Prune members outside the window, count the rest, then admit.
            self._storage.z_remove_range_by_score(
                zkey, float("-inf"), float(now - cfg.window_ms))
            live = self._storage.z_count(zkey, float("-inf"), float("inf"))
            if live + permits > cfg.max_permits:
                self._rejected.increment()
                return False
            for _ in range(permits):
                self._storage.z_add(zkey, float(now), f"{now}-{next(self._seq)}")
        self._allowed.increment()
        return True

    def get_available_permits(self, key: str) -> int:
        cfg = self._config
        now = self._clock_ms()
        zkey = self._zkey(key)
        with self._lock:
            self._storage.z_remove_range_by_score(
                zkey, float("-inf"), float(now - cfg.window_ms))
            live = self._storage.z_count(zkey, float("-inf"), float("inf"))
        return max(0, cfg.max_permits - live)

    def reset(self, key: str) -> None:
        self._storage.delete(self._zkey(key))
