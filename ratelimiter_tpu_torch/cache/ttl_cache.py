"""Host-side TTL cache — the Caffeine analog (C7 in SURVEY.md).

The reference builds a Caffeine cache with ``expireAfterWrite(localCacheTtl)``
and ``maximumSize(10000)`` (SlidingWindowRateLimiter.java:57-64) and uses it
as a *negative* cache: the last-seen count per key short-circuits repeat
rejections without touching Redis (SlidingWindowRateLimiter.java:93-100).

This implementation keeps the same contract — ``get_if_present`` /
``put`` / ``invalidate`` with expire-after-write semantics and a bounded
size (oldest-write eviction) — with an injectable millisecond clock so tests
control time deterministically.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000


class TTLCache:
    """Bounded expire-after-write cache keyed by string."""

    def __init__(
        self,
        ttl_ms: int,
        max_size: int = 10_000,
        clock_ms: Callable[[], int] = _wall_clock_ms,
    ):
        if ttl_ms <= 0:
            raise ValueError("ttl_ms must be positive")
        if max_size <= 0:
            raise ValueError("max_size must be positive")
        self._ttl_ms = int(ttl_ms)
        self._max_size = int(max_size)
        self._clock_ms = clock_ms
        # key -> (value, write_deadline_ms); insertion order == write order.
        self._data: "OrderedDict[str, tuple]" = OrderedDict()
        self._lock = threading.Lock()

    def get_if_present(self, key: str):
        now = self._clock_ms()
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return None
            value, deadline = entry
            if now >= deadline:
                del self._data[key]
                return None
            return value

    def put(self, key: str, value) -> None:
        now = self._clock_ms()
        with self._lock:
            if key in self._data:
                del self._data[key]
            self._data[key] = (value, now + self._ttl_ms)
            while len(self._data) > self._max_size:
                self._data.popitem(last=False)

    def invalidate(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def invalidate_all(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)
