"""The storage plugin boundary.

Capability parity with the reference's 10-method backend contract
``storage/RateLimitStorage.java:10-70`` ("Allows swapping backends without
changing rate limiter logic").  Implementations in this framework:

- ``InMemoryStorage`` — process-local dict-based backend; the *real* (not
  mocked) test double and single-process deployment option.
- ``GpuBatchedStorage`` — the device-resident array backend that
  micro-batches operations (storage/gpu.py).

Design deviations from the reference, both deliberate:

- ``eval_script`` takes a *named device script* plus integer args instead of
  a Lua source string.  The reference ships Lua to Redis for atomicity
  (TokenBucketRateLimiter.java:38-68); our backends execute named atomic ops
  (the registered scripts are this framework's "stored procedures" — on the
  device backend they are device kernels).  Script names: ``token_bucket``,
  ``token_bucket_peek``.
- z-set methods (``z_add``/``z_remove_range_by_score``/``z_count``) are kept
  for interface parity (quirk Q5: dead surface in the reference for an
  unimplemented sliding-window-log algorithm) and are fully implemented by
  ``InMemoryStorage`` so a sliding-window-log algorithm can be built on them.
"""

from __future__ import annotations

import abc
from typing import List, Sequence


class RateLimitStorage(abc.ABC):
    """Abstract distributed-storage backend (storage/RateLimitStorage.java)."""

    # -- counters -------------------------------------------------------------
    @abc.abstractmethod
    def increment_and_expire(self, key: str, ttl_ms: int) -> int:
        """Atomically increment a counter and (re)set its TTL; returns the new
        value (RateLimitStorage.java:20-28, pipelined INCR+PEXPIRE)."""

    @abc.abstractmethod
    def get(self, key: str) -> int:
        """Current value of a counter; 0 if absent/expired."""

    @abc.abstractmethod
    def set(self, key: str, value: int, ttl_ms: int) -> None:
        """Set a value with expiration."""

    @abc.abstractmethod
    def compare_and_set(self, key: str, expect: int, update: int) -> bool:
        """Atomic CAS; True if the value was updated
        (RateLimitStorage.java:37-41)."""

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        """Delete a key."""

    # -- sorted sets (sliding-window-log support) -----------------------------
    @abc.abstractmethod
    def z_add(self, key: str, score: float, member: str) -> None:
        """Add to a sorted set; score is typically a timestamp."""

    @abc.abstractmethod
    def z_remove_range_by_score(self, key: str, min_score: float, max_score: float) -> int:
        """Remove members with min <= score <= max; returns count removed."""

    @abc.abstractmethod
    def z_count(self, key: str, min_score: float, max_score: float) -> int:
        """Count members with min <= score <= max."""

    # -- scripts --------------------------------------------------------------
    @abc.abstractmethod
    def eval_script(self, script: str, keys: List[str], args: List[int]) -> Sequence[int]:
        """Execute a named atomic script (RateLimitStorage.java:60-64).

        Known scripts:

        ``token_bucket`` — keys=[bucket_key],
            args=[cap_fp, rate_fp, requested_fp, now_ms, ttl_ms];
            returns (allowed, tokens_fp_after) with the exact semantics of
            ``semantics.oracle.TokenBucketOracle``.
        ``token_bucket_peek`` — keys=[bucket_key],
            args=[cap_fp, rate_fp, now_ms]; returns (tokens_fp,) after a
            read-only refill.
        """

    # -- health ---------------------------------------------------------------
    @abc.abstractmethod
    def is_available(self) -> bool:
        """Health check (RateLimitStorage.java:66-69)."""

    def close(self) -> None:  # parity with RedisRateLimitStorage.close()
        pass
