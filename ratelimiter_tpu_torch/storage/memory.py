"""Process-local in-memory storage backend (counterpart of
``ratelimiter_tpu/storage/memory.py``).

The framework's *real* (not mocked) test double and single-process deployment
backend — the role SURVEY.md §4 prescribes to invert the reference's
Mockito-mock-only testing.  Implements every method of the
``RateLimitStorage`` contract with Redis-accurate TTL semantics (a key is
gone at/after its deadline) under one lock, so the compat algorithm classes
running over it reproduce the oracle's decisions exactly.

An injectable millisecond clock makes time fully deterministic in tests; the
token-bucket scripts take ``now`` as an argument (exactly like the Lua script
receives ARGV[4], TokenBucketRateLimiter.java:126) so script execution is
time-independent of the storage clock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.storage.errors import StorageException


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000

_NO_DEADLINE = 1 << 62


class InMemoryStorage(RateLimitStorage):
    def __init__(self, clock_ms: Callable[[], int] = _wall_clock_ms):
        self._clock_ms = clock_ms
        self._lock = threading.RLock()
        # key -> (value, deadline_ms)
        self._counters: Dict[str, Tuple[int, int]] = {}
        # key -> {member: score}
        self._zsets: Dict[str, Dict[str, float]] = {}
        # key -> (tokens_fp, last_refill_ms, deadline_ms) — token buckets
        self._buckets: Dict[str, Tuple[int, int, int]] = {}
        self._available = True

    # -- counters -------------------------------------------------------------
    def _live_counter(self, key: str, now: int) -> int | None:
        entry = self._counters.get(key)
        if entry is None:
            return None
        value, deadline = entry
        if now >= deadline:
            del self._counters[key]
            return None
        return value

    def increment_and_expire(self, key: str, ttl_ms: int) -> int:
        now = self._clock_ms()
        with self._lock:
            value = self._live_counter(key, now) or 0
            value += 1
            self._counters[key] = (value, now + int(ttl_ms))
            return value

    def get(self, key: str) -> int:
        now = self._clock_ms()
        with self._lock:
            value = self._live_counter(key, now)
            return 0 if value is None else value

    def set(self, key: str, value: int, ttl_ms: int) -> None:
        now = self._clock_ms()
        with self._lock:
            self._counters[key] = (int(value), now + int(ttl_ms))

    def compare_and_set(self, key: str, expect: int, update: int) -> bool:
        now = self._clock_ms()
        with self._lock:
            current = self._live_counter(key, now) or 0
            if current != expect:
                return False
            # Preserve any existing deadline (Redis SET without PX on a live
            # key in a MULTI clears TTL; the reference's CAS sets no TTL —
            # RedisRateLimitStorage.java:73-92 — so neither do we).
            self._counters[key] = (int(update), _NO_DEADLINE)
            return True

    def delete(self, key: str) -> None:
        with self._lock:
            self._counters.pop(key, None)
            self._zsets.pop(key, None)
            self._buckets.pop(key, None)

    # -- sorted sets ----------------------------------------------------------
    def z_add(self, key: str, score: float, member: str) -> None:
        with self._lock:
            self._zsets.setdefault(key, {})[member] = float(score)

    def z_remove_range_by_score(self, key: str, min_score: float, max_score: float) -> int:
        with self._lock:
            zset = self._zsets.get(key, {})
            doomed = [m for m, s in zset.items() if min_score <= s <= max_score]
            for m in doomed:
                del zset[m]
            return len(doomed)

    def z_count(self, key: str, min_score: float, max_score: float) -> int:
        with self._lock:
            zset = self._zsets.get(key, {})
            return sum(1 for s in zset.values() if min_score <= s <= max_score)

    # -- scripts --------------------------------------------------------------
    def eval_script(self, script: str, keys: List[str], args: List[int]) -> Sequence[int]:
        if script == "token_bucket":
            return self._script_token_bucket(keys[0], *map(int, args))
        if script == "token_bucket_peek":
            return self._script_token_bucket_peek(keys[0], *map(int, args))
        raise StorageException(f"unknown script: {script!r}")

    def _refill(self, key: str, cap_fp: int, rate_fp: int, now: int) -> Tuple[int, int]:
        """Returns (tokens_fp, last_refill) after lazy init + refill; exact
        oracle math (semantics/oracle.py:TokenBucketOracle._refilled)."""
        entry = self._buckets.get(key)
        if entry is None or now >= entry[2]:
            self._buckets.pop(key, None)
            return cap_fp, now
        tokens_fp, last_refill, _ = entry
        elapsed = now - last_refill
        elapsed = min(elapsed, cap_fp // max(rate_fp, 1) + 1)
        return min(cap_fp, tokens_fp + elapsed * rate_fp), last_refill

    def _script_token_bucket(
        self, key: str, cap_fp: int, rate_fp: int, requested_fp: int, now: int, ttl_ms: int
    ) -> Sequence[int]:
        with self._lock:
            tokens_fp, _ = self._refill(key, cap_fp, rate_fp, now)
            if tokens_fp >= requested_fp:
                tokens_fp -= requested_fp
                self._buckets[key] = (tokens_fp, now, now + ttl_ms)
                return (1, tokens_fp)
            return (0, tokens_fp)

    def _script_token_bucket_peek(
        self, key: str, cap_fp: int, rate_fp: int, now: int
    ) -> Sequence[int]:
        with self._lock:
            tokens_fp, _ = self._refill(key, cap_fp, rate_fp, now)
            return (tokens_fp,)

    # -- health ---------------------------------------------------------------
    def is_available(self) -> bool:
        return self._available

    def set_available(self, available: bool) -> None:
        """Fault-injection hook for failure-path tests (the reference has no
        fault injection at all — SURVEY.md §5.3)."""
        self._available = available
