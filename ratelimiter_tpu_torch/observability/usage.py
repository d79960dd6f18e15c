"""Per-tenant usage accounting: a sliding multi-resolution time ring
(counterpart of ``ratelimiter_tpu/observability/usage.py``).

An adaptive per-tenant controller needs fresh per-tenant observed-load /
shed / goodput signals, and token leases move decisions off the server,
so those signals cannot be derived from server dispatches alone.  This
module is the aggregation point: every decision source feeds one ring —

- server-side dispatches (micro drains + stream chunks,
  ``storage/gpu.py:_record_dispatch`` / the micro drainer),
- degraded-path decisions (``storage/degraded.py``),
- admission-control sheds (batcher queue_full/deadline),
- client-reported lease burns (telemetry reports,
  ``observability/telemetry.py``),

so per-tenant rates are fleet-true again regardless of where the
decision ran.

**Shape.**  Per tenant (= limiter id, the device policy-table row), one
fixed bucket ring per resolution — 1 s x 64, 10 s x 64, 60 s x 64 by
default — each bucket a 4-vector (admitted, denied, shed, lease_local)
stamped with its epoch (``now // bucket_ms``).  ``record`` is O(1):
one epoch compare + one vector add per resolution (a stale bucket is
zeroed in place when its epoch rotates — no sweeper thread, no
allocation after the first touch).  Memory is fixed:
``max_tenants * sum(slots) * 4`` int64s; tenants over the cap are
counted in ``dropped_tenants`` and not tracked (the controller can
only actuate rows it observes — a silent cap would read as zero load).

**Exactness.**  A bucket only counts toward a window when its stamped
epoch is inside the window's epoch range, so overwritten-but-stale
slots can never leak old counts into a fresh window —
the reference's tests assert window sums equal a brute-force
recount of the raw event log across rotations and long clock jumps.

Exported at ``GET /actuator/tenants``, as labeled Prometheus series
(via ``TelemetryPlane.prometheus_samples``), and programmatically as
:class:`UsageSignals` — the observation contract an adaptive controller
consumes (ARCHITECTURE §13e).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

#: Bucketed fields, in ring order.
FIELDS = ("admitted", "denied", "shed", "lease_local")
_NF = len(FIELDS)

#: Default resolutions: (bucket_ms, n_buckets) — 64 s of 1 s buckets,
#: ~10 min of 10 s buckets, ~1 h of 60 s buckets.
RESOLUTIONS: Tuple[Tuple[int, int], ...] = (
    (1_000, 64), (10_000, 64), (60_000, 64))


def _wall_ms() -> int:
    return time.time_ns() // 1_000_000


class UsageSignals(NamedTuple):
    """One tenant's observation vector — the contract the adaptive
    per-tenant controller consumes.  Counts cover the
    last ``window_s`` seconds (bucket-aligned); rates are counts /
    window_s.  ``observed_load`` is everything the tenant ASKED for
    (admitted + denied + shed, /s); ``goodput`` is what it got
    (admitted, /s).  ``lease_local`` is the subset of ``admitted``
    decided client-side against leases — included in ``admitted``, so
    the totals stay fleet-true under leases."""

    tenant: int
    window_s: float
    admitted: int
    denied: int
    shed: int
    lease_local: int
    admitted_rate: float
    denied_rate: float
    shed_rate: float
    lease_local_rate: float
    observed_load: float
    goodput: float


class _TenantRing:
    """One tenant's buckets: per resolution, counts[slots, 4] + epoch
    stamps; plus lifetime totals."""

    __slots__ = ("counts", "epochs", "totals")

    def __init__(self, resolutions):
        self.counts = [np.zeros((n, _NF), dtype=np.int64)
                       for _, n in resolutions]
        self.epochs = [np.full(n, -1, dtype=np.int64)
                       for _, n in resolutions]
        self.totals = np.zeros(_NF, dtype=np.int64)


class UsageRing:
    """Sliding multi-resolution per-tenant usage accounting."""

    def __init__(self, clock_ms=None, max_tenants: int = 256,
                 resolutions: Sequence[Tuple[int, int]] = RESOLUTIONS):
        self._clock_ms = clock_ms or _wall_ms
        self._res = tuple((int(b), int(n)) for b, n in resolutions)
        if not self._res:
            raise ValueError("usage ring needs at least one resolution")
        self.max_tenants = max(int(max_tenants), 1)
        self._tenants: Dict[int, _TenantRing] = {}
        self._lock = threading.Lock()
        self.dropped_tenants = 0   # records refused over max_tenants
        self.recorded_total = 0

    # -- recording -------------------------------------------------------------
    def record(self, tenant: int, admitted: int = 0, denied: int = 0,
               shed: int = 0, lease_local: int = 0,
               now_ms: Optional[int] = None) -> bool:
        """Fold one batch of decisions into the tenant's buckets.
        O(1): one epoch check + vector add per resolution.  Returns
        False when the tenant cap refused a NEW tenant."""
        if not (admitted or denied or shed or lease_local):
            return True
        now = int(self._clock_ms() if now_ms is None else now_ms)
        vec = (int(admitted), int(denied), int(shed), int(lease_local))
        with self._lock:
            ring = self._tenants.get(int(tenant))
            if ring is None:
                if len(self._tenants) >= self.max_tenants:
                    self.dropped_tenants += 1
                    return False
                ring = _TenantRing(self._res)
                self._tenants[int(tenant)] = ring
            for r, (bucket_ms, slots) in enumerate(self._res):
                epoch = now // bucket_ms
                i = epoch % slots
                if ring.epochs[r][i] != epoch:
                    ring.counts[r][i] = 0
                    ring.epochs[r][i] = epoch
                ring.counts[r][i] += vec
            ring.totals += vec
            self.recorded_total += 1
        return True

    # -- reading ---------------------------------------------------------------
    def _pick_res(self, window_ms: int) -> int:
        """Finest resolution whose ring spans the window (else the
        coarsest)."""
        for r, (bucket_ms, slots) in enumerate(self._res):
            if bucket_ms * slots >= window_ms:
                return r
        return len(self._res) - 1

    def window_counts(self, tenant: int, window_ms: int,
                      now_ms: Optional[int] = None):
        """Counts over the trailing window: every bucket whose epoch
        falls in the last ``ceil(window/bucket)`` epochs INCLUDING the
        current (partial) one.  Returns ``(counts_dict, covered_ms)``
        — ``covered_ms`` is the bucket-aligned span actually summed,
        the denominator for exact rates."""
        now = int(self._clock_ms() if now_ms is None else now_ms)
        r = self._pick_res(int(window_ms))
        bucket_ms, slots = self._res[r]
        k = min(max(-(-int(window_ms) // bucket_ms), 1), slots)
        e_now = now // bucket_ms
        with self._lock:
            ring = self._tenants.get(int(tenant))
            if ring is None:
                vec = np.zeros(_NF, dtype=np.int64)
            else:
                live = ring.epochs[r] > (e_now - k)
                # epochs are stamped at record time and never run ahead
                # of the recorder's clock; with a monotonic clock the
                # upper bound is implied, but guard it anyway so an
                # injected-clock test stepping backwards can't read
                # future buckets.
                live &= ring.epochs[r] <= e_now
                vec = ring.counts[r][live].sum(axis=0)
        counts = {f: int(vec[i]) for i, f in enumerate(FIELDS)}
        return counts, k * bucket_ms

    def signals(self, tenant: int, window_ms: int = 10_000,
                now_ms: Optional[int] = None) -> UsageSignals:
        counts, covered_ms = self.window_counts(tenant, window_ms, now_ms)
        w = covered_ms / 1000.0
        adm, den = counts["admitted"], counts["denied"]
        shed, local = counts["shed"], counts["lease_local"]
        return UsageSignals(
            tenant=int(tenant), window_s=w,
            admitted=adm, denied=den, shed=shed, lease_local=local,
            admitted_rate=adm / w, denied_rate=den / w,
            shed_rate=shed / w, lease_local_rate=local / w,
            observed_load=(adm + den + shed) / w,
            goodput=adm / w,
        )

    def all_signals(self, window_ms: int = 10_000,
                    now_ms: Optional[int] = None) -> Dict[int, UsageSignals]:
        """The controller's observation sweep: one UsageSignals per
        tracked tenant."""
        with self._lock:
            tenants = list(self._tenants)
        return {t: self.signals(t, window_ms, now_ms) for t in tenants}

    def tenants(self):
        with self._lock:
            return sorted(self._tenants)

    def totals(self, tenant: int) -> Dict[str, int]:
        with self._lock:
            ring = self._tenants.get(int(tenant))
            vec = (np.zeros(_NF, dtype=np.int64) if ring is None
                   else ring.totals.copy())
        return {f: int(vec[i]) for i, f in enumerate(FIELDS)}

    def snapshot(self, now_ms: Optional[int] = None) -> Dict:
        """The ``GET /actuator/tenants`` payload body: per tenant,
        lifetime totals plus rates at each configured resolution's
        natural window (one full bucket span of the finest, 10 buckets
        of each coarser one — enough to see a storm and its decay)."""
        now = int(self._clock_ms() if now_ms is None else now_ms)
        out: Dict[str, Dict] = {}
        for t in self.tenants():
            entry: Dict = {"totals": self.totals(t)}
            for bucket_ms, _slots in self._res:
                window = bucket_ms * 10
                counts, covered = self.window_counts(t, window, now)
                entry[f"last_{window // 1000}s"] = {
                    **counts,
                    "rate_per_s": {f: round(c / (covered / 1000.0), 3)
                                   for f, c in counts.items()},
                }
            out[str(t)] = entry
        return {"tenants": out, "dropped_tenants": self.dropped_tenants,
                "resolutions_ms": [b for b, _ in self._res]}
