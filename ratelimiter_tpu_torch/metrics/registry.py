"""Metrics counters.

Capability parity with the reference's Micrometer usage (C12 in SURVEY.md):
named monotonic counters registered against a registry, e.g.
``ratelimiter.requests.allowed`` / ``ratelimiter.requests.rejected`` /
``ratelimiter.cache.hits`` (SlidingWindowRateLimiter.java:67-77) and
``ratelimiter.tokenbucket.allowed`` / ``ratelimiter.tokenbucket.rejected``
(TokenBucketRateLimiter.java:87-93), exposed by the service's actuator-style
endpoints (application.properties:14-15).

The reference also *documents* a ``ratelimiter.storage.latency`` histogram
that it never implements (ARCHITECTURE.md:172-185); here we implement it —
``Timer`` records microsecond latencies with percentile snapshots.

Counters use per-instance locks and support batch increments (``add(n)``)
because one device step resolves thousands of decisions at once.
"""

from __future__ import annotations

import threading
from typing import Dict, List


class Counter:
    """A named monotonic counter (Micrometer Counter analog)."""

    __slots__ = ("name", "description", "_value", "_lock")

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._value = 0.0
        self._lock = threading.Lock()

    def increment(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    # Batch-friendly alias: one device step yields many decisions.
    def add(self, amount: float) -> None:
        self.increment(amount)

    def count(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A named point-in-time value (Micrometer Gauge analog).

    Unlike ``Counter`` it is set, not accumulated — used for values that
    can move both ways, e.g. ``ratelimiter.replication.lag_ms``.
    """

    __slots__ = ("name", "description", "_value", "_lock")

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def value(self) -> float:
        with self._lock:
            return self._value


class Timer:
    """Latency recorder: fixed log2-bucket histogram with interpolated
    percentile snapshots.

    Implements the ``ratelimiter.storage.latency`` histogram the reference
    documents but never ships (ARCHITECTURE.md:172-185).  Bucket ``i``
    counts samples in ``(2^(i-1), 2^i]`` microseconds (bucket 0 holds
    ``<= 1 us``; the last bucket is unbounded), so

    - ``record_us`` is O(1) and lock-free — one bit_length plus three
      in-place adds.  CPython's GIL makes each add a read-modify-write
      that can lose a count under extreme contention, which is an
      accepted trade for a hot path that previously took a lock per
      sample;
    - ``snapshot`` walks 64 fixed counters instead of sorting an up-to-
      64Ki reservoir under the recorder's lock.

    Percentiles interpolate linearly inside the target bucket at rank
    ``p * n`` (the Prometheus ``histogram_quantile`` convention), which
    also removes the old reservoir's index bias: ``int(p * len)``
    returned the element *after* the p-quantile on small sample sets.

    ``max_samples`` is accepted for back-compat and ignored (there is no
    reservoir to bound).
    """

    __slots__ = ("name", "description", "_counts", "_count", "_total_us")

    #: Number of log2 buckets; bucket N_BUCKETS-1 is unbounded (+Inf).
    N_BUCKETS = 64

    def __init__(self, name: str, description: str = "",
                 max_samples: int = 0):
        self.name = name
        self.description = description
        self._counts = [0] * self.N_BUCKETS
        self._count = 0
        self._total_us = 0.0

    def record_us(self, micros: float) -> None:
        if micros > 1.0:
            # ceil(micros) - 1, then bit_length: value v lands in the
            # bucket whose range (2^(i-1), 2^i] contains it.
            idx = (-int(-micros) - 1).bit_length()
            if idx >= self.N_BUCKETS:
                idx = self.N_BUCKETS - 1
        else:
            idx = 0
        self._counts[idx] += 1
        self._count += 1
        self._total_us += micros

    # -- raw surfaces (Prometheus exposition; observability/prometheus.py) --
    def bucket_bounds_us(self) -> List[float]:
        """Inclusive upper bound of each bucket in us; last is +Inf."""
        return [float(1 << i) for i in range(self.N_BUCKETS - 1)] + [
            float("inf")]

    def bucket_counts(self) -> List[int]:
        return list(self._counts)

    def merge(self, sparse_buckets, total_us: float) -> None:
        """Fold pre-bucketed samples recorded elsewhere with the SAME
        log2 scheme (a lease client's local-latency histogram arriving
        in a telemetry report): ``sparse_buckets`` is an iterable of
        ``(bucket_idx, count)``."""
        added = 0
        for idx, count in sparse_buckets:
            idx = min(max(int(idx), 0), self.N_BUCKETS - 1)
            self._counts[idx] += int(count)
            added += int(count)
        self._count += added
        self._total_us += float(total_us)

    def count(self) -> int:
        return self._count

    def total_us(self) -> float:
        return self._total_us

    def _quantile(self, counts: List[int], n: int, p: float) -> float:
        rank = p * n
        cum = 0
        value = 0.0
        for i, c in enumerate(counts):
            if not c:
                continue
            lo = float(1 << (i - 1)) if i else 0.0
            # The unbounded last bucket interpolates over one octave.
            hi = float(1 << i) if i < self.N_BUCKETS - 1 else 2.0 * lo
            value = lo + (hi - lo) * min((rank - cum) / c, 1.0)
            if cum + c >= rank:
                return value
            cum += c
        return value

    def snapshot(self) -> Dict[str, float]:
        counts = list(self._counts)
        n = sum(counts)
        total = self._total_us
        if n == 0:
            return {"count": 0, "mean_us": 0.0, "p50_us": 0.0,
                    "p95_us": 0.0, "p99_us": 0.0}
        return {
            "count": n,
            "mean_us": total / n,
            "p50_us": self._quantile(counts, n, 0.50),
            "p95_us": self._quantile(counts, n, 0.95),
            "p99_us": self._quantile(counts, n, 0.99),
        }


class MeterRegistry:
    """Registry of named meters (SimpleMeterRegistry analog,
    config/RateLimiterConfig.java:37-40)."""

    def __init__(self):
        self._meters: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, description: str = "") -> Counter:
        with self._lock:
            meter = self._meters.get(name)
            if meter is None:
                meter = Counter(name, description)
                self._meters[name] = meter
            if not isinstance(meter, Counter):
                raise TypeError(f"meter {name!r} already registered as {type(meter).__name__}")
            return meter

    def gauge(self, name: str, description: str = "") -> Gauge:
        with self._lock:
            meter = self._meters.get(name)
            if meter is None:
                meter = Gauge(name, description)
                self._meters[name] = meter
            if not isinstance(meter, Gauge):
                raise TypeError(f"meter {name!r} already registered as {type(meter).__name__}")
            return meter

    def timer(self, name: str, description: str = "") -> Timer:
        with self._lock:
            meter = self._meters.get(name)
            if meter is None:
                meter = Timer(name, description)
                self._meters[name] = meter
            if not isinstance(meter, Timer):
                raise TypeError(f"meter {name!r} already registered as {type(meter).__name__}")
            return meter

    def meters(self) -> Dict[str, object]:
        """The live meter objects by name (a copy of the map, not the
        meters) — the Prometheus renderer needs bucket-level access that
        ``scrape()``'s value view flattens away."""
        with self._lock:
            return dict(self._meters)

    def scrape(self) -> Dict[str, object]:
        """All meter values, for the /actuator/metrics endpoint."""
        with self._lock:
            meters = dict(self._meters)
        out: Dict[str, object] = {}
        for name, meter in meters.items():
            if isinstance(meter, Counter):
                out[name] = meter.count()
            elif isinstance(meter, Gauge):
                out[name] = meter.value()
            elif isinstance(meter, Timer):
                out[name] = meter.snapshot()
        return out
