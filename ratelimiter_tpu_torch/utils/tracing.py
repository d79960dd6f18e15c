"""Decision tracing (counterpart of ``ratelimiter_tpu/utils/tracing.py``).

``DecisionTrace`` is a lock-protected ring buffer of per-dispatch records
(wall time, algo, batch size, allowed count, dispatch latency, route),
cheap enough to leave on; the storage feeds it from every drained micro
batch and stream chunk (``GpuBatchedStorage.trace``), and the
request-lifecycle tracer (``observability/trace.py``) adds 1-in-N sampled
micro traces carrying their stage breakdown (``stages_us``) and, with
lineage sampling, their trace id (``trace``).  The reference's
``device_profile`` (a JAX profiler context) has no counterpart here.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class DecisionTrace:
    """Fixed-capacity ring of per-batch dispatch records."""

    __slots__ = ("_records", "_capacity", "_next", "_total", "_lock")

    def __init__(self, capacity: int = 4096):
        self._capacity = int(capacity)
        self._records: List[Optional[dict]] = [None] * self._capacity
        self._next = 0
        self._total = 0
        self._lock = threading.Lock()

    def record(self, algo: str, batch: int, allowed: int, latency_us: float,
               **extra) -> None:
        """One dispatch record; ``extra`` enriches it (``path``: micro,
        relay|digest, relay|bits, relay_w|..., flat|sorted, flat|scan;
        ``stages_us``: a sampled micro trace's stage breakdown;
        ``trace``: a sampled trace id)."""
        entry = {
            "t_ms": time.time_ns() // 1_000_000,
            "algo": algo,
            "batch": batch,
            "allowed": allowed,
            "latency_us": round(latency_us, 1),
        }
        if extra:
            entry.update(extra)
        with self._lock:
            self._records[self._next] = entry
            self._next = (self._next + 1) % self._capacity
            self._total += 1

    def snapshot(self, last: int = 100) -> Dict:
        with self._lock:
            ordered = [
                r for r in (
                    self._records[self._next:] + self._records[:self._next])
                if r is not None
            ]
        return {"total_dispatches": self._total, "recent": ordered[-last:]}
