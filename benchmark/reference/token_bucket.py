"""Token bucket, plain NumPy.

The semantics of the reference's Redis Lua script
(``TokenBucketRateLimiter.java:38-68``) in exact integer fixed point:
one token is ``1000 * 2**20`` units; the refill rate is
``round(refill_rate * 2**20)`` units a millisecond; absent or expired
state reads as a full bucket refilled now; refill is
``min(cap, tokens + elapsed * rate)`` with ``elapsed`` clamped once the
bucket must be full; a request takes one token if a whole one is there;
the state (tokens, last refill, and an expiry two windows on) is written
only when a request is allowed.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import Grouped, decide

FP_SHIFT = 20
ONE = 1000 << FP_SHIFT


# Columns of a key's row: whether it holds state, its tokens, its last
# refill and its expiry.
LIVE, TOKENS, LAST, DEADLINE = range(4)


class TokenBucket:
    def __init__(self, limiter: dict, num_keys: int):
        self.cap = int(limiter["max_permits"]) * ONE
        self.rate = int(round(float(limiter["refill_rate"]) * (1 << FP_SHIFT)))
        self.window_ms = int(limiter["window_ms"])
        self.rows = np.zeros((num_keys, 4), dtype=np.int64)

    def _refilled(self, r: np.ndarray, now: int) -> np.ndarray:
        live = (r[:, LIVE] != 0) & (now < r[:, DEADLINE])
        tokens = np.where(live, r[:, TOKENS], self.cap)
        last = np.where(live, r[:, LAST], now)
        elapsed = np.minimum(now - last, self.cap // max(self.rate, 1) + 1)
        return np.minimum(self.cap, tokens + elapsed * self.rate)

    def call(self, g: Grouped, now: int,
             lost_updates: bool = False) -> np.ndarray:
        """Decide one call of unit requests stamped ``now``; returns the
        decisions in arrival order."""
        refilled = self._refilled(self.rows[g.keys], now)
        allowed = np.minimum(g.counts, refilled // ONE)
        taken = np.minimum(allowed, 1) if lost_updates else allowed
        w = allowed > 0
        r = np.empty((int(w.sum()), 4), dtype=np.int64)
        r[:, LIVE] = 1
        r[:, TOKENS] = refilled[w] - taken[w] * ONE
        r[:, LAST] = now
        r[:, DEADLINE] = now + 2 * self.window_ms
        self.rows[g.keys[w]] = r
        return decide(g, allowed, lost_updates)

    def available(self, keys: np.ndarray, now: int) -> np.ndarray:
        """Whole tokens after refill (``getAvailablePermits``)."""
        keys = np.asarray(keys, dtype=np.int64)
        return self._refilled(self.rows[keys], now) // ONE


Reference = TokenBucket
