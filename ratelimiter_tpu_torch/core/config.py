"""Per-limiter configuration.

Capability parity with the reference's immutable Lombok value class
``core/RateLimitConfig.java:14-81``: ``maxPermits``, ``window``, ``refillRate``
(token bucket only, default 0), ``enableLocalCache`` (default True),
``localCacheTtl`` (default 100 ms), a ``validate()`` method and
``perSecond/perMinute/perHour`` factories (core/RateLimitConfig.java:61-80).

Device-path addition: ``refill_rate_fp`` exposes the refill rate in integer
fixed-point micro-tokens per millisecond (scale 2**TOKEN_FP_SHIFT), which is
the exact arithmetic the device kernels use instead of the reference's Lua
float math (TokenBucketRateLimiter.java:55-67).  See
``ratelimiter_tpu_torch.semantics.oracle`` for the equivalence argument.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Union

# Fixed-point scale for token-bucket accounting: 1 token == 1000*2**20 "fp
# units".  The factor 1000 makes the tokens/sec -> tokens/ms conversion exact
# in integers: the refill rate becomes round(refill_rate * 2**20) fp-units per
# millisecond — an integer with NO rounding for any rate of the form k/2**20
# (all integral and most practical fractional rates) — and a refill is then a
# pure multiply with no division, so fixed-point token values coincide exactly
# with the mathematical rational semantics.  Billion-token buckets still fit
# int64 (1000*2**20*1e9 ~= 2**60); the refill clamps elapsed time (see
# semantics/oracle.py) so device int64 arithmetic cannot overflow.
TOKEN_FP_SHIFT = 20
TOKEN_FP_ONE = 1000 << TOKEN_FP_SHIFT  # fp units per whole token

DurationLike = Union[timedelta, int, float]


def _to_millis(d: DurationLike) -> int:
    """Accept a timedelta or a number of milliseconds."""
    if isinstance(d, timedelta):
        return int(d.total_seconds() * 1000)
    return int(d)


@dataclasses.dataclass(frozen=True)
class RateLimitConfig:
    """Immutable rate-limit policy for one limiter instance.

    Parameters mirror core/RateLimitConfig.java:14-56.
    """

    max_permits: int
    window_ms: int
    refill_rate: float = 0.0  # tokens per second (token bucket only)
    enable_local_cache: bool = True
    local_cache_ttl_ms: int = 100

    def __post_init__(self):
        object.__setattr__(self, "max_permits", int(self.max_permits))
        object.__setattr__(self, "window_ms", _to_millis(self.window_ms))
        object.__setattr__(self, "local_cache_ttl_ms", _to_millis(self.local_cache_ttl_ms))

    # -- validation (core/RateLimitConfig.java:44-56) -------------------------
    def validate(self) -> "RateLimitConfig":
        if self.max_permits <= 0:
            raise ValueError("maxPermits must be positive")
        if self.max_permits > 2**31 - 1:
            # Java-int parity with the reference (int maxPermits); also what
            # lets device counters travel as one i32 lane (ops/sliding_window).
            raise ValueError("maxPermits must fit a 32-bit signed int")
        if self.window_ms <= 0:
            raise ValueError("window must be a positive duration")
        if self.window_ms > 2**30:
            # ~12.4 days; keeps 2*window deadline offsets within i32 on the
            # device path. The reference's Duration has no bound, but windows
            # beyond days are outside rate-limiting semantics.
            raise ValueError("window must be at most 2^30 ms (~12 days)")
        if self.refill_rate < 0:
            raise ValueError("refillRate cannot be negative")
        return self

    # -- derived quantities ---------------------------------------------------
    @property
    def refill_rate_fp(self) -> int:
        """Refill rate in fp units per MILLISECOND (integer fixed point).

        Equals round(refill_rate * 2**TOKEN_FP_SHIFT): exact (no rounding)
        whenever refill_rate is k/2**TOKEN_FP_SHIFT — in particular for every
        integral rate — because TOKEN_FP_ONE carries the factor 1000.  The
        reference converts tokens/sec to tokens/ms as a double
        (TokenBucketRateLimiter.java:85); this is the same quantity with the
        rounding done once at config time instead of every refill.
        """
        return round(self.refill_rate * (1 << TOKEN_FP_SHIFT))

    @property
    def max_permits_fp(self) -> int:
        return self.max_permits * TOKEN_FP_ONE

    # -- factories (core/RateLimitConfig.java:61-80) --------------------------
    @staticmethod
    def per_second(max_permits: int) -> "RateLimitConfig":
        return RateLimitConfig(max_permits=max_permits, window_ms=1_000)

    @staticmethod
    def per_minute(max_permits: int) -> "RateLimitConfig":
        return RateLimitConfig(max_permits=max_permits, window_ms=60_000)

    @staticmethod
    def per_hour(max_permits: int) -> "RateLimitConfig":
        return RateLimitConfig(max_permits=max_permits, window_ms=3_600_000)
