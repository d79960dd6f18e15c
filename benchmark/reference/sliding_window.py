"""Sliding-window counter, plain NumPy.

The semantics of ``SlidingWindowRateLimiter.java:86-188`` over Redis:
one counter per key and window bucket (``now // window * window``), each
increment setting the bucket's expiry to ``window`` after it; the
estimate is ``curr + prev * (window - now % window) // window`` in exact
integers; a request of one permit is refused if ``estimate + 1`` exceeds
``max_permits``, else the current bucket is incremented by one and the
request allowed if the raw counter stays within ``max_permits``.
For one permit the raw counter never exceeds the estimate, so an
increment is always allowed.  Each key keeps its two most recent
buckets, all that an estimate reads, in one row; while every write has
gone to one bucket and none can have expired, a count a key is all the
state there is.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import Grouped, decide


# Columns of a key's row: its most recent bucket (start, count, expiry)
# and the one before; a start of -1 marks none.
WS0, C0, DL0, WS1, C1, DL1 = range(6)


class SlidingWindow:
    def __init__(self, limiter: dict, num_keys: int):
        self.max = int(limiter["max_permits"])
        self.win = int(limiter["window_ms"])
        self.num_keys = num_keys
        # While every write went to one bucket and none can have expired,
        # a key's state is its count in that bucket and its last write.
        self.bucket = None
        self.first = None
        self.count = np.zeros(num_keys, dtype=np.int64)
        self.last = np.zeros(num_keys, dtype=np.int64)
        # Afterwards, a row a key.
        self.rows = None

    def _one_bucket(self, now: int) -> bool:
        return self.rows is None and (
            self.bucket is None or (now // self.win * self.win == self.bucket
                                    and now < self.first + self.win))

    def _to_rows(self) -> None:
        rows = np.zeros((self.num_keys, 6), dtype=np.int64)
        rows[:, WS0] = np.where(self.count > 0, self.bucket or 0, -1)
        rows[:, C0] = self.count
        rows[:, DL0] = self.last + self.win
        rows[:, WS1] = -1
        self.rows, self.count, self.last = rows, None, None

    def _estimate(self, r: np.ndarray, now: int):
        """(current bucket's count, estimate) of the rows ``r``."""
        cur = now // self.win * self.win

        def bucket(ws):
            return (np.where((r[:, WS0] == ws) & (now < r[:, DL0]),
                             r[:, C0], 0)
                    + np.where((r[:, WS1] == ws) & (now < r[:, DL1]),
                               r[:, C1], 0))
        curr = bucket(cur)
        prev = bucket(cur - self.win)
        return curr, curr + prev * (self.win - now % self.win) // self.win

    def call(self, g: Grouped, now: int,
             lost_updates: bool = False) -> np.ndarray:
        """Decide one call of one-permit requests stamped ``now``; returns
        the decisions in arrival order."""
        cur = now // self.win * self.win
        if self._one_bucket(now):
            curr = self.count[g.keys]
            allowed = np.clip(self.max - curr, 0, g.counts)
            added = np.minimum(allowed, 1) if lost_updates else allowed
            w = allowed > 0
            if w.any():
                self.count[g.keys[w]] = curr[w] + added[w]
                self.last[g.keys[w]] = now
                self.bucket = cur
                self.first = now if self.first is None else self.first
            return decide(g, allowed, lost_updates)
        if self.rows is None:
            self._to_rows()
        r = self.rows[g.keys]
        curr, est = self._estimate(r, now)
        allowed = np.clip(self.max - est, 0, g.counts)
        added = np.minimum(allowed, 1) if lost_updates else allowed
        w = allowed > 0
        r, curr, added = r[w], curr[w], added[w]
        # A new current bucket pushes the most recent one back.
        roll = r[:, WS0] != cur
        r[roll, WS1:DL1 + 1] = r[roll, WS0:DL0 + 1]
        r[:, WS0] = cur
        r[:, C0] = curr + added
        r[:, DL0] = now + self.win
        self.rows[g.keys[w]] = r
        return decide(g, allowed, lost_updates)

    def available(self, keys: np.ndarray, now: int) -> np.ndarray:
        """``max(0, max_permits - estimate)`` (``getAvailablePermits``)."""
        keys = np.asarray(keys, dtype=np.int64)
        if self._one_bucket(now):
            return np.maximum(0, self.max - self.count[keys])
        if self.rows is None:
            self._to_rows()
        return np.maximum(0, self.max - self._estimate(self.rows[keys],
                                                       now)[1])


Reference = SlidingWindow
