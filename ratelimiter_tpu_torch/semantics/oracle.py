"""Sequential reference semantics ("the oracle").

This module is the *specification* of what every execution backend in the
framework — the device engine's batched steps and the kernels under them —
must decide, bit for bit.
It is a direct, pure-Python, integer-arithmetic restatement of the reference
implementation's behavior:

- Sliding-window counter: ``algorithms/SlidingWindowRateLimiter.java:86-188``
  including its two documented quirks (SURVEY.md §7):
  Q1 — ``tryAcquire(key, permits)`` checks ``count + permits > max`` but
  increments by **1**, not ``permits`` (lines 104-116);
  Q2 — a request can be counted-then-rejected by the post-increment check
  ``newCount <= maxPermits`` (lines 114-123), inflating the window.
  Window-bucket expiry follows Redis PEXPIRE semantics: each increment sets
  the bucket's TTL to exactly ``window`` (RedisRateLimitStorage.java:38-49),
  so the *previous* bucket disappears ``window`` ms after its last increment,
  not at the 2x-window boundary.

- Token bucket: the Redis Lua script ``TokenBucketRateLimiter.java:38-68``:
  lazy init to full capacity, refill ``min(cap, tokens + elapsed*rate)``,
  consume-if-enough, write-back (with TTL = 2x window,
  TokenBucketRateLimiter.java:121-128) **only on allow** — a denied request
  leaves the stored state untouched, which is observationally equivalent for
  tokens (refill is idempotent) but does *not* refresh the TTL.

Arithmetic model
----------------
The reference mixes Java doubles (the sliding-window weight,
SlidingWindowRateLimiter.java:170-174) and Lua floats (token refill).  This
framework instead defines **exact integer semantics**:

- Sliding window estimate: ``curr + (prev * (window - now % window)) // window``
  — the exact rational floor.  The Java double expression
  ``(long)(prev * (1 - (now % win)/win) + curr)`` equals this except when the
  exact weighted product ``prev*(window-rem)/window`` is an integer and double
  rounding falls below it; since the rational has denominator ``window``
  (<= 3.6e6), any non-integer value is at least ``1/window`` (~2.8e-7) from an
  integer while double error is a few ulps (~1e-12 at realistic counts), so the
  two agree everywhere except that measure-zero boundary.  Property tests in
  ``tests/test_oracle.py`` compare against a float emulation.

- Token bucket: integer fixed point, 1 token == 2**20 fp units
  (``core/config.py:TOKEN_FP_SHIFT``); the refill rate is rounded once at
  config time (relative error <= 0.5/rate_fp, i.e. ~5e-5 for 10 tokens/sec).

Both choices make decisions deterministic and device-friendly (pure int64
ops, no data-dependent float rounding), at the cost of a documented,
quantified deviation on exact ties.

``getAvailablePermits`` for the token bucket is implemented *correctly*
(refill-then-floor) rather than reproducing the reference's WRONGTYPE crash
(quirk Q3: TokenBucketRateLimiter.java:146-151 string-GETs a Redis hash).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ratelimiter_tpu_torch.core.config import RateLimitConfig, TOKEN_FP_ONE


@dataclasses.dataclass(frozen=True)
class Decision:
    """Outcome of one try_acquire."""

    allowed: bool
    # Whether the current-window counter was incremented (sliding window) or
    # the bucket was written (token bucket). Due to quirk Q2 a sliding-window
    # request can increment yet be denied.
    mutated: bool
    # Sliding window: the weighted estimate read before the increment check.
    # Token bucket: whole tokens available after refill (pre-consume), floored.
    observed: int
    # Sliding window: raw current-bucket counter after the operation.
    # Token bucket: whole tokens remaining after the operation, floored.
    remaining_hint: int


class SlidingWindowOracle:
    """Exact sequential semantics of the sliding-window-counter limiter.

    Storage model: dict (key, window_start) -> (count, expiry_deadline_ms),
    mirroring one Redis string counter per window bucket with PEXPIRE.
    """

    def __init__(self, config: RateLimitConfig):
        config.validate()
        self.config = config
        self._buckets: Dict[Tuple[str, int], Tuple[int, int]] = {}

    def reconfigure(self, config: RateLimitConfig) -> None:
        """Adopt a live policy update (control/, ARCHITECTURE §15): only
        the rates move — the window is part of the state shape (bucket
        keys, PEXPIRE deadlines) and is immutable, exactly the
        ``LimiterTable.set_policy`` contract.  Stored bucket state is
        untouched: the device keeps every counter across a policy
        update, so the oracle must too — a generation-schedule replay
        feeds the same updates at the same boundaries and stays
        bit-identical."""
        config.validate()
        if config.window_ms != self.config.window_ms:
            raise ValueError("reconfigure cannot change the window")
        self.config = config

    # -- storage model --------------------------------------------------------
    def _get_bucket(self, key: str, window_start: int, now_ms: int) -> int:
        entry = self._buckets.get((key, window_start))
        if entry is None:
            return 0
        count, deadline = entry
        if now_ms >= deadline:  # Redis PEXPIRE: gone at/after the deadline
            del self._buckets[(key, window_start)]
            return 0
        return count

    def _increment_bucket(self, key: str, window_start: int, now_ms: int) -> int:
        """INCR + PEXPIRE(window) pipelined (RedisRateLimitStorage.java:38-49)."""
        count = self._get_bucket(key, window_start, now_ms)
        count += 1
        self._buckets[(key, window_start)] = (count, now_ms + self.config.window_ms)
        return count

    # -- estimate (SlidingWindowRateLimiter.java:158-180) ---------------------
    def current_count(self, key: str, now_ms: int) -> int:
        win = self.config.window_ms
        curr_ws = (now_ms // win) * win
        prev_ws = curr_ws - win
        curr = self._get_bucket(key, curr_ws, now_ms)
        prev = self._get_bucket(key, prev_ws, now_ms)
        rem = now_ms % win
        # Exact-integer form of: (long)(prev * (1 - rem/win) + curr)
        return curr + (prev * (win - rem)) // win

    # -- RateLimiter surface --------------------------------------------------
    def try_acquire(self, key: str, permits: int, now_ms: int) -> Decision:
        if permits <= 0:
            raise ValueError("permits must be positive")
        cfg = self.config
        win = cfg.window_ms
        estimated = self.current_count(key, now_ms)

        if estimated + permits > cfg.max_permits:
            # Rejected pre-increment (SlidingWindowRateLimiter.java:104-111).
            return Decision(allowed=False, mutated=False, observed=estimated,
                            remaining_hint=self._get_bucket(key, (now_ms // win) * win, now_ms))

        curr_ws = (now_ms // win) * win
        new_count = self._increment_bucket(key, curr_ws, now_ms)
        # Post-increment check on the RAW bucket counter, not the weighted
        # estimate (SlidingWindowRateLimiter.java:114-123) — quirks Q1/Q2.
        allowed = new_count <= cfg.max_permits
        return Decision(allowed=allowed, mutated=True, observed=estimated,
                        remaining_hint=new_count)

    def get_available_permits(self, key: str, now_ms: int) -> int:
        return max(0, self.config.max_permits - self.current_count(key, now_ms))

    # -- lease reserve/credit (spec for ops/lease.py) -------------------------
    def reserve(self, key: str, requested: int, now_ms: int) -> Tuple[int, int]:
        """Bulk-reserve up to ``requested`` permits in one atomic step:
        grant ``min(requested, max_permits - estimate)`` (clamped >= 0) and
        charge the current-window bucket by the granted count, with the
        same PEXPIRE refresh an increment applies.  This is the host
        specification of the device RESERVE kernel (ops/lease.py) that
        backs token leases (leases/): the grant is bounded by the
        remaining-window budget, which is what bounds lease
        over-admission by construction.  Returns ``(granted,
        window_start)`` — the window the charge landed in, which a later
        :meth:`credit` must present."""
        if requested <= 0:
            return 0, (now_ms // self.config.window_ms) * self.config.window_ms
        win = self.config.window_ms
        estimated = self.current_count(key, now_ms)
        granted = max(0, min(int(requested),
                             self.config.max_permits - estimated))
        curr_ws = (now_ms // win) * win
        if granted > 0:
            count = self._get_bucket(key, curr_ws, now_ms) + granted
            self._buckets[(key, curr_ws)] = (count, now_ms + win)
        return granted, curr_ws

    def credit(self, key: str, unused: int, grant_ws: int,
               now_ms: int) -> int:
        """Return ``unused`` reserved permits (lease release/renewal).
        Credits apply only while the window the charge landed in is still
        the CURRENT window (``grant_ws``): once the window rolled, the
        charge already ages out as previous-window weight, and crediting
        a later window would under-count live traffic.  The decrement
        never refreshes the bucket TTL (a credit is not an increment).
        Returns the permits actually credited."""
        if unused <= 0:
            return 0
        win = self.config.window_ms
        curr_ws = (now_ms // win) * win
        if curr_ws != int(grant_ws):
            return 0
        count = self._get_bucket(key, curr_ws, now_ms)
        if count <= 0:
            return 0
        credited = min(int(unused), count)
        _, deadline = self._buckets[(key, curr_ws)]
        self._buckets[(key, curr_ws)] = (count - credited, deadline)
        return credited

    def seed_count(self, key: str, count: int, now_ms: int) -> None:
        """Install ``count`` as the current-window bucket as of ``now_ms``
        (TTL = one window, as a real increment would set).  Used by the
        degraded-mode host limiter (storage/degraded.py) to start its
        approximation from the last counter value the device reported."""
        win = self.config.window_ms
        self._buckets[(key, (now_ms // win) * win)] = (
            max(int(count), 0), now_ms + win)

    def reset(self, key: str, now_ms: int) -> None:
        win = self.config.window_ms
        curr_ws = (now_ms // win) * win
        self._buckets.pop((key, curr_ws), None)
        self._buckets.pop((key, curr_ws - win), None)


class TokenBucketOracle:
    """Exact sequential semantics of the token-bucket limiter (fixed point).

    Storage model: dict key -> (tokens_fp, last_refill_ms, ttl_deadline_ms),
    mirroring the Redis hash {tokens, last_refill} with PEXPIRE(2*window)
    refreshed only by the Lua script's allow branch
    (TokenBucketRateLimiter.java:60-64).
    """

    def __init__(self, config: RateLimitConfig):
        config.validate()
        if config.refill_rate <= 0:
            raise ValueError(
                "Token bucket requires positive refillRate. "
                "Use RateLimitConfig(refill_rate=...)"
            )
        self.config = config
        self._buckets: Dict[str, Tuple[int, int, int]] = {}

    def reconfigure(self, config: RateLimitConfig) -> None:
        """Adopt a live policy update (see SlidingWindowOracle
        .reconfigure): capacity and refill rate move, window (the TTL
        shape) does not; stored fixed-point state is untouched — a
        bucket holding more than the NEW capacity reads as exactly the
        new capacity (the ``min(cap, ...)`` in :meth:`_refilled`),
        which is the device kernel's own refill arithmetic."""
        config.validate()
        if config.window_ms != self.config.window_ms:
            raise ValueError("reconfigure cannot change the window")
        if config.refill_rate <= 0:
            raise ValueError("Token bucket requires positive refillRate")
        self.config = config

    def _load(self, key: str, now_ms: int) -> Tuple[int, int]:
        """Returns (tokens_fp, last_refill) applying lazy init on absent or
        expired state (Lua lines: `if tokens == nil then tokens = capacity`)."""
        entry = self._buckets.get(key)
        if entry is None:
            return self.config.max_permits_fp, now_ms
        tokens_fp, last_refill, deadline = entry
        if now_ms >= deadline:
            del self._buckets[key]
            return self.config.max_permits_fp, now_ms
        return tokens_fp, last_refill

    def _refilled(self, key: str, now_ms: int) -> int:
        """Refill = min(cap, tokens + elapsed_ms * rate_fp) — a pure integer
        multiply (rate_fp is fp-units/ms), exact w.r.t. the rational
        semantics.  Elapsed is clamped once the refill is guaranteed to cap
        the bucket, bounding the product within int64 on device."""
        tokens_fp, last_refill = self._load(key, now_ms)
        elapsed = now_ms - last_refill
        cap_fp = self.config.max_permits_fp
        rate_fp = self.config.refill_rate_fp
        elapsed = min(elapsed, cap_fp // max(rate_fp, 1) + 1)
        return min(cap_fp, tokens_fp + elapsed * rate_fp)

    def try_acquire(self, key: str, permits: int, now_ms: int) -> Decision:
        if permits <= 0:
            raise ValueError("permits must be positive")
        cfg = self.config
        if permits > cfg.max_permits:
            # Can never be fulfilled (TokenBucketRateLimiter.java:110-116);
            # rejected client-side without touching storage.
            whole = self._refilled(key, now_ms) // TOKEN_FP_ONE
            return Decision(allowed=False, mutated=False,
                            observed=whole, remaining_hint=whole)

        tokens_fp = self._refilled(key, now_ms)
        observed = tokens_fp // TOKEN_FP_ONE
        requested_fp = permits * TOKEN_FP_ONE

        if tokens_fp >= requested_fp:
            tokens_fp -= requested_fp
            # HMSET + PEXPIRE(2*window) — only on the allow branch.
            self._buckets[key] = (tokens_fp, now_ms, now_ms + 2 * cfg.window_ms)
            return Decision(allowed=True, mutated=True, observed=observed,
                            remaining_hint=tokens_fp // TOKEN_FP_ONE)
        # Deny: no write-back (state, including TTL, untouched).
        return Decision(allowed=False, mutated=False, observed=observed,
                        remaining_hint=tokens_fp // TOKEN_FP_ONE)

    def get_available_permits(self, key: str, now_ms: int) -> int:
        """Refill-then-floor, replacing the reference's broken string-GET of a
        hash (quirk Q3)."""
        return self._refilled(key, now_ms) // TOKEN_FP_ONE

    # -- lease reserve/credit (spec for ops/lease.py) -------------------------
    def reserve(self, key: str, requested: int, now_ms: int) -> Tuple[int, int]:
        """Bulk-reserve up to ``requested`` whole tokens atomically:
        grant ``min(requested, refilled // ONE)``, consume the granted
        tokens, and write back with the allow-branch TTL.  Host
        specification of the device RESERVE kernel backing token leases.
        Returns ``(granted, 0)`` — the token bucket has no window start;
        the second element keeps the surface uniform with the sliding
        window."""
        if requested <= 0:
            return 0, 0
        tokens_fp = self._refilled(key, now_ms)
        granted = min(int(requested), tokens_fp // TOKEN_FP_ONE)
        if granted > 0:
            tokens_fp -= granted * TOKEN_FP_ONE
            self._buckets[key] = (tokens_fp, now_ms,
                                  now_ms + 2 * self.config.window_ms)
        return granted, 0

    def credit(self, key: str, unused: int, grant_ws: int,
               now_ms: int) -> int:
        """Return ``unused`` reserved tokens (lease release/renewal):
        refill, then add back up to capacity.  State is written only
        when something was actually absorbed (a bucket already at
        capacity stays bit-untouched, like the deny branch).
        ``grant_ws`` is ignored (uniform surface).  Returns whole tokens
        absorbed."""
        if unused <= 0:
            return 0
        cfg = self.config
        tokens_fp = self._refilled(key, now_ms)
        absorbed = min(int(unused) * TOKEN_FP_ONE,
                       cfg.max_permits_fp - tokens_fp)
        if absorbed <= 0:
            return 0
        self._buckets[key] = (tokens_fp + absorbed, now_ms,
                              now_ms + 2 * cfg.window_ms)
        return absorbed // TOKEN_FP_ONE

    def seed_tokens(self, key: str, whole_tokens: int, now_ms: int) -> None:
        """Install a bucket holding ``whole_tokens`` as of ``now_ms`` (TTL =
        2x window, as the allow branch would set).  Degraded-mode seeding:
        the device's last reported remaining-token count becomes the
        approximation's starting state (storage/degraded.py)."""
        cfg = self.config
        fp = max(0, min(cfg.max_permits_fp, int(whole_tokens) * TOKEN_FP_ONE))
        self._buckets[key] = (fp, now_ms, now_ms + 2 * cfg.window_ms)

    def reset(self, key: str, now_ms: int) -> None:
        self._buckets.pop(key, None)
