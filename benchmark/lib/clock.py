"""The clock the storage and the limiter read.

The benchmark owns it, so that the reference replays the same
timestamps: frozen at a value the benchmark sets (a stream call is
stamped once, before it starts), or live (the request cell's micro
batches read epoch milliseconds that advance with the host's clock),
with the lowest and highest value it handed out while live.
"""

from __future__ import annotations

import threading
import time

# Epoch milliseconds at the start of a 60 s window bucket, near the
# present: every run starts its clock here, so window boundaries fall at
# the same place in every run.
BASE_MS = 1_759_999_980_000


class RecordedClock:
    def __init__(self, base_ms: int = BASE_MS):
        self.base_ms = int(base_ms)
        self._now = self.base_ms
        self._live_from = None  # (perf_counter at go_live, ms at go_live)
        self._lock = threading.Lock()
        self.live_max = None

    def __call__(self) -> int:
        if self._live_from is None:
            return self._now
        t0, ms0 = self._live_from
        now = ms0 + int((time.perf_counter() - t0) * 1000.0)
        with self._lock:
            if self.live_max is None or now > self.live_max:
                self.live_max = now
        return now

    def set(self, ms: int) -> int:
        """Freeze the clock at ``ms``."""
        self._live_from = None
        self._now = int(ms)
        return self._now

    def go_live(self) -> None:
        """Advance from the frozen value with the host's clock."""
        self._live_from = (time.perf_counter(), self._now)

    def freeze(self) -> int:
        """Stop at the present live value."""
        if self._live_from is not None:
            self._now = self()
            self._live_from = None
        return self._now
