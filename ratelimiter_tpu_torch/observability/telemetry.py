"""Fleet telemetry plane: client burn reports + end-to-end trace ids
(counterpart of ``ratelimiter_tpu/observability/telemetry.py``).

Token leases move the bulk of decisions off the server: a leased client
burns permits locally and the server only sees coarse ``used`` counts at
renewal, so server-side dispatch meters alone miss most of the fleet.
This module restores fleet-true visibility with three pieces:

1. **Client burn telemetry** (:class:`ClientTelemetry` + the wire
   codec).  ``LeaseClient`` accumulates per-(lid, key-class)
   allow/deny/permit counts and a local-decision latency histogram
   (same log2-bucket scheme as ``metrics/registry.Timer``), and flushes
   them as one compact binary report — piggybacked on RENEW wire ops
   and on a bounded cadence, with **drop-don't-block** semantics:
   telemetry must never add a wire round trip (the TELEMETRY sidecar op
   is response-less) nor stall a decision (a send that cannot complete
   promptly is dropped and counted, never retried inline).

2. **The server-side plane** (:class:`TelemetryPlane`).  Folds decoded
   reports — plus server-side dispatch results, degraded-path decisions
   and admission-control sheds — into the registry
   (``ratelimiter.decisions.*`` is again the true fleet-wide decision
   count) and into the per-tenant :class:`~ratelimiter_tpu_torch.
   observability.usage.UsageRing`.  A per-client staleness gauge
   (``ratelimiter.telemetry.staleness_ms``) bounds how far behind the
   fleet counters can be: one client flush interval.

3. **Trace context** (:func:`mint_trace_id` + :class:`TraceLineage`).
   A 64-bit trace id is minted at ingress (or carried in on a v4
   sidecar frame), threaded through the micro-batcher, the dispatch
   paths and the lease protocol; sampled ids accumulate ordered hops
   (client -> sidecar -> batcher -> shard -> resolve) in a bounded
   lineage ring so one slow or surprising decision can be followed
   across the whole distributed decision surface.  Explicitly
   client-supplied ids are always sampled (the caller asked); minted
   ids head-sample 1-in-N so the ring costs O(sampled), not O(requests).
"""

from __future__ import annotations

import collections
import itertools
import os
import struct
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _wall_ms() -> int:
    return time.time_ns() // 1_000_000


def _mix64(x: int) -> int:
    """splitmix64 finalizer — the same mixer the shard router family
    uses; decorrelates sequential mint counters so head-sampling by
    ``tid % n`` is unbiased."""
    x = (x + _GOLDEN) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


_MINT = itertools.count(int.from_bytes(os.urandom(8), "little")).__next__


def mint_trace_id() -> int:
    """A fresh nonzero 64-bit trace id (0 means "no trace")."""
    return _mix64(_MINT() & _M64) or 1


def trace_hex(tid: int) -> str:
    return f"{int(tid) & _M64:016x}"


#: Number of latency buckets mirrored from ``metrics/registry.Timer``.
N_LATENCY_BUCKETS = 64


def latency_bucket(micros: float) -> int:
    """The Timer log2 bucket index for one latency sample — value v
    lands in the bucket whose range (2^(i-1), 2^i] us contains it."""
    if micros > 1.0:
        idx = (-int(-micros) - 1).bit_length()
        return idx if idx < N_LATENCY_BUCKETS else N_LATENCY_BUCKETS - 1
    return 0


def default_key_class(key: str) -> str:
    """Bound the telemetry label space: the segment before the first
    ``:`` (the common ``tenant:user`` shape), or ``*`` for unstructured
    keys — raw keys are unbounded-cardinality and must never become
    label values wholesale."""
    i = key.find(":")
    return key[:i] if i > 0 else "*"


# ---------------------------------------------------------------------------
# Trace lineage
# ---------------------------------------------------------------------------

class TraceLineage:
    """Bounded per-trace-id hop ring.

    ``record`` is a no-op unless the id is sampled, so arming this on
    the hot path costs one dict probe + one modulo per candidate.
    Explicit ids (a client sent one over the wire) are ``force``d —
    always sampled; minted ids head-sample 1-in-``sample_n``.
    """

    def __init__(self, capacity: int = 256, sample_n: int = 0,
                 max_hops: int = 64):
        self._capacity = max(int(capacity), 1)
        self._sample_n = max(int(sample_n), 0)
        self._max_hops = max(int(max_hops), 1)
        self._traces: "collections.OrderedDict[int, List[dict]]" = \
            collections.OrderedDict()
        self._forced: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.recorded_hops = 0
        self.dropped_hops = 0   # hops refused by the per-trace bound

    @property
    def sample_n(self) -> int:
        return self._sample_n

    def force(self, tid: int) -> None:
        """Mark an explicitly-propagated id as always-sampled."""
        if not tid:
            return
        with self._lock:
            self._forced[int(tid)] = None
            self._forced.move_to_end(int(tid))
            while len(self._forced) > self._capacity:
                self._forced.popitem(last=False)

    def sampled(self, tid: int) -> bool:
        if not tid:
            return False
        if int(tid) in self._forced:
            return True
        return (self._sample_n > 0
                and (_mix64(int(tid)) % self._sample_n) == 0)

    def record(self, tid: int, hop: str, **fields) -> bool:
        """Append one hop under a sampled trace id; returns whether it
        was recorded."""
        if not self.sampled(tid):
            return False
        entry = {"hop": hop, "t_ms": _wall_ms()}
        if fields:
            entry.update(fields)
        with self._lock:
            hops = self._traces.get(int(tid))
            if hops is None:
                hops = []
                self._traces[int(tid)] = hops
                while len(self._traces) > self._capacity:
                    self._traces.popitem(last=False)
            if len(hops) >= self._max_hops:
                self.dropped_hops += 1
                return False
            hops.append(entry)
            self._traces.move_to_end(int(tid))
            self.recorded_hops += 1
        return True

    def lineage(self, tid: int) -> List[dict]:
        with self._lock:
            return list(self._traces.get(int(tid), ()))

    def hops(self, tid: int) -> List[str]:
        return [h["hop"] for h in self.lineage(tid)]

    def snapshot(self, last: int = 16) -> Dict:
        with self._lock:
            items = list(self._traces.items())[-last:]
            return {
                "traces": {trace_hex(t): list(h) for t, h in items},
                "recorded_hops": self.recorded_hops,
                "sample_n": self._sample_n,
            }


# ---------------------------------------------------------------------------
# Client-side accumulator + wire codec
# ---------------------------------------------------------------------------

class TelemetryReport(NamedTuple):
    """One decoded client report."""

    client_id: int
    allowed: int            # local decisions allowed (all classes)
    denied: int             # local decisions denied
    hist: Tuple[Tuple[int, int], ...]   # (bucket idx, count), sparse
    hist_total_us: int
    # (lid, key_class, allowed, denied, permits)
    records: Tuple[Tuple[int, str, int, int, int], ...]


_HDR = struct.Struct("<BQQQQB")       # ver, client_id, allowed, denied,
#                                        hist_total_us, n_buckets
_BUCKET = struct.Struct("<BQ")        # idx, count
_REC_HDR = struct.Struct("<IIIQB")    # lid, allowed, denied, permits,
#                                        class_len
_WIRE_VERSION = 1

#: Overflow class: records past ``max_classes`` fold here so one
#: misbehaving key namespace cannot balloon the report (or the label
#: space it becomes).
OVERFLOW_CLASS = "~other"


class ClientTelemetry:
    """Per-client burn/deny accumulator with a local-latency histogram.

    NOT thread-safe on its own — it lives inside a ``LeaseClient``,
    which is single-caller by contract (one burner per key).
    """

    def __init__(self, client_id: Optional[int] = None,
                 key_class: Optional[Callable[[str], str]] = None,
                 max_classes: int = 64, max_key_cache: int = 4096):
        self.client_id = int(client_id) if client_id else mint_trace_id()
        self._key_class = key_class or default_key_class
        self.max_classes = max(int(max_classes), 1)
        self.max_key_cache = max(int(max_key_cache), 1)
        # (lid, class) -> [allowed, denied, permits]
        self._counts: Dict[Tuple[int, str], List[int]] = {}
        # (lid, key) -> row: skips the class split + tuple build on the
        # hot burn path (a leased client hits the same keys over and
        # over — that is what a lease IS).
        self._row_cache: Dict[Tuple[int, str], List[int]] = {}
        self._hist = [0] * N_LATENCY_BUCKETS
        self._hist_total_us = 0
        self.allowed = 0
        self.denied = 0
        # Sampled latency stamping (one stamp per flush interval): the
        # perf_counter pair costs ~1 µs per local burn — material on a
        # path whose whole budget is a few µs (the reference's bench note).
        # The caller checks ``stamp_pending`` and only pays the pair
        # while a sample is wanted; the first latency-carrying record
        # clears it, and the next flush re-arms it.  The histogram
        # becomes one sample per client per flush interval — the shape
        # survives, the per-burn cost does not.
        self.stamp_pending = True

    def _row(self, lid: int, key: str) -> List[int]:
        row = self._row_cache.get((lid, key))
        if row is not None:
            return row
        cls = self._key_class(key)
        k = (int(lid), cls)
        row = self._counts.get(k)
        if row is None:
            if len(self._counts) >= self.max_classes:
                k = (int(lid), OVERFLOW_CLASS)
                row = self._counts.setdefault(k, [0, 0, 0])
            else:
                row = self._counts[k] = [0, 0, 0]
        if len(self._row_cache) < self.max_key_cache:
            self._row_cache[(lid, key)] = row
        return row

    def record_burn(self, lid: int, key: str, permits: int,
                    latency_us: Optional[float] = None) -> None:
        row = self._row(lid, key)
        row[0] += 1
        row[2] += int(permits)
        self.allowed += 1
        if latency_us is not None:
            self._hist[latency_bucket(latency_us)] += 1
            self._hist_total_us += int(latency_us)
            self.stamp_pending = False

    def record_deny(self, lid: int, key: str,
                    latency_us: Optional[float] = None) -> None:
        row = self._row(lid, key)
        row[1] += 1
        self.denied += 1
        if latency_us is not None:
            self._hist[latency_bucket(latency_us)] += 1
            self._hist_total_us += int(latency_us)
            self.stamp_pending = False

    def pending(self) -> bool:
        return bool(self.allowed or self.denied)

    def encode_and_reset(self) -> bytes:
        """Snapshot the accumulated report as one wire blob and clear.
        The caller owns delivery; on a dropped flush it may simply keep
        accumulating (counts since the snapshot are a fresh report)."""
        buckets = [(i, c) for i, c in enumerate(self._hist) if c]
        parts = [_HDR.pack(_WIRE_VERSION, self.client_id,
                           self.allowed, self.denied,
                           self._hist_total_us, len(buckets))]
        parts.extend(_BUCKET.pack(i, c) for i, c in buckets)
        records = list(self._counts.items())
        parts.append(struct.pack("<H", len(records)))
        for (lid, cls), (alw, den, permits) in records:
            raw = cls.encode()[:255]
            parts.append(_REC_HDR.pack(lid, alw, den, permits, len(raw)))
            parts.append(raw)
        self._counts.clear()
        self._row_cache.clear()   # rows were just detached from _counts
        self._hist = [0] * N_LATENCY_BUCKETS
        self._hist_total_us = 0
        self.allowed = 0
        self.denied = 0
        self.stamp_pending = True   # re-arm: one sample per interval
        return b"".join(parts)


def decode_report(blob: bytes) -> TelemetryReport:
    """Decode one wire report; raises ``ValueError`` on malformed input
    (the server counts those, never crashes on them)."""
    try:
        ver, client_id, allowed, denied, hist_total, n_buckets = \
            _HDR.unpack_from(blob)
        if ver != _WIRE_VERSION:
            raise ValueError(f"telemetry wire version {ver}")
        off = _HDR.size
        hist = []
        for _ in range(n_buckets):
            idx, count = _BUCKET.unpack_from(blob, off)
            off += _BUCKET.size
            if idx >= N_LATENCY_BUCKETS:
                raise ValueError(f"latency bucket {idx} out of range")
            hist.append((idx, count))
        (n_records,) = struct.unpack_from("<H", blob, off)
        off += 2
        records = []
        for _ in range(n_records):
            lid, alw, den, permits, class_len = \
                _REC_HDR.unpack_from(blob, off)
            off += _REC_HDR.size
            cls = blob[off:off + class_len]
            if len(cls) != class_len:
                raise ValueError("truncated key-class")
            off += class_len
            records.append((lid, cls.decode(), alw, den, permits))
        if off != len(blob):
            raise ValueError(f"{len(blob) - off} trailing bytes")
    except (struct.error, UnicodeDecodeError) as exc:
        raise ValueError(str(exc)) from exc
    return TelemetryReport(client_id, allowed, denied, tuple(hist),
                           hist_total, tuple(records))


# ---------------------------------------------------------------------------
# Server-side plane
# ---------------------------------------------------------------------------

class TelemetryPlane:
    """Folds every decision source into fleet-true registry counters and
    the per-tenant usage ring.

    ``ratelimiter.decisions.allowed/denied`` count EVERY decision in the
    fleet — server dispatches, degraded-path host decisions, and
    client-local lease burns (from telemetry reports) — so they
    reconcile with ground truth to within one client flush interval
    (the documented staleness bound, surfaced as the
    ``ratelimiter.telemetry.staleness_ms`` gauge).
    """

    def __init__(self, registry=None, clock_ms=None, usage=None,
                 max_clients: int = 1024, max_classes: int = 512):
        from ratelimiter_tpu_torch.observability.usage import UsageRing

        self._clock_ms = clock_ms or _wall_ms
        self.usage = usage if usage is not None else UsageRing(
            clock_ms=self._clock_ms)
        self.max_clients = max(int(max_clients), 1)
        self.max_classes = max(int(max_classes), 1)
        # client_id -> wall-clock ms of the last folded report.
        self._clients: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()
        # (lid, key_class) -> [allowed, denied, permits] — the labeled
        # Prometheus series behind prometheus_samples().
        self._classes: Dict[Tuple[int, str], List[int]] = {}
        self._lock = threading.Lock()
        # Plain totals (drills/benches read these without a registry).
        self.allowed_total = 0
        self.denied_total = 0
        self.shed_total = 0
        self.lease_local_total = 0
        self.reports_total = 0
        self.reports_rejected = 0
        if registry is not None:
            mk = registry.counter
            self._m_allowed = mk(
                "ratelimiter.decisions.allowed",
                "Fleet-wide allowed decisions: server dispatches + "
                "degraded-path decisions + client-reported lease burns")
            self._m_denied = mk(
                "ratelimiter.decisions.denied",
                "Fleet-wide denied decisions (all decision surfaces)")
            self._m_shed = mk(
                "ratelimiter.decisions.shed",
                "Decisions refused by admission control before reaching "
                "a decision surface (batcher queue/deadline, sidecar "
                "pipeline cap)")
            self._m_lease_local = mk(
                "ratelimiter.decisions.lease_local",
                "Subset of fleet decisions decided client-side against "
                "token leases, folded from telemetry reports")
            self._m_reports = mk(
                "ratelimiter.telemetry.reports",
                "Client telemetry reports folded into the fleet counters")
            self._m_rejected = mk(
                "ratelimiter.telemetry.rejected",
                "Client telemetry reports the server failed to decode")
            self._m_clients = registry.gauge(
                "ratelimiter.telemetry.clients",
                "Distinct clients that have reported telemetry (bounded "
                "LRU window)")
            self._m_staleness = registry.gauge(
                "ratelimiter.telemetry.staleness_ms",
                "Age of the OLDEST client's last telemetry report — the "
                "bound on how far the fleet decision counters trail "
                "ground truth (~ one client flush interval when healthy)")
            self._m_latency = registry.timer(
                "ratelimiter.telemetry.local_latency",
                "Client-local lease decision latency, folded from "
                "telemetry reports (us)")
        else:
            self._m_allowed = self._m_denied = self._m_shed = None
            self._m_lease_local = self._m_reports = self._m_rejected = None
            self._m_clients = self._m_staleness = self._m_latency = None

    # -- server-side decision sources -----------------------------------------
    def note_server(self, lid: int, n: int, allowed: int,
                    now_ms: Optional[int] = None) -> None:
        """One server-side dispatch's outcome for one tenant: ``n``
        decisions, ``allowed`` of them admitted.  O(1) — called per
        micro batch / per stream chunk, never per decision."""
        allowed = int(allowed)
        denied = max(int(n) - allowed, 0)
        self.allowed_total += allowed
        self.denied_total += denied
        if self._m_allowed is not None:
            if allowed:
                self._m_allowed.add(allowed)
            if denied:
                self._m_denied.add(denied)
        self.usage.record(lid, admitted=allowed, denied=denied,
                          now_ms=now_ms)

    def note_batch(self, lids, allowed_mask,
                   now_ms: Optional[int] = None) -> None:
        """A mixed-tenant micro batch: fold per-tenant outcomes in one
        bincount pass."""
        import numpy as np

        lids = np.asarray(lids)
        mask = np.asarray(allowed_mask, dtype=bool)
        if lids.size == 0:
            return
        uniq, inv = np.unique(lids, return_inverse=True)
        n_per = np.bincount(inv, minlength=len(uniq))
        a_per = np.bincount(inv, weights=mask, minlength=len(uniq))
        for lid, n, a in zip(uniq.tolist(), n_per.tolist(),
                             a_per.tolist()):
            self.note_server(int(lid), int(n), int(a), now_ms=now_ms)

    def note_shed(self, lid: int, n: int = 1,
                  now_ms: Optional[int] = None) -> None:
        self.shed_total += int(n)
        if self._m_shed is not None:
            self._m_shed.add(int(n))
        self.usage.record(lid, shed=int(n), now_ms=now_ms)

    def note_degraded(self, lid: int, allowed: bool,
                      now_ms: Optional[int] = None) -> None:
        self.note_server(lid, 1, 1 if allowed else 0, now_ms=now_ms)

    # -- client telemetry ------------------------------------------------------
    def fold(self, blob_or_report, now_ms: Optional[int] = None) -> int:
        """Fold one client report (wire blob or decoded); returns the
        record count, or -1 when the blob was malformed (counted in
        ``ratelimiter.telemetry.rejected``, never raised — telemetry is
        advisory input from the network)."""
        if isinstance(blob_or_report, (bytes, bytearray, memoryview)):
            try:
                report = decode_report(bytes(blob_or_report))
            except ValueError:
                self.reports_rejected += 1
                if self._m_rejected is not None:
                    self._m_rejected.increment()
                return -1
        else:
            report = blob_or_report
        now = int(self._clock_ms() if now_ms is None else now_ms)
        self.allowed_total += report.allowed
        self.denied_total += report.denied
        self.lease_local_total += report.allowed + report.denied
        self.reports_total += 1
        if self._m_allowed is not None:
            if report.allowed:
                self._m_allowed.add(report.allowed)
            if report.denied:
                self._m_denied.add(report.denied)
            if report.allowed or report.denied:
                self._m_lease_local.add(report.allowed + report.denied)
            self._m_reports.increment()
        if self._m_latency is not None and report.hist:
            self._m_latency.merge(report.hist, report.hist_total_us)
        for lid, cls, allowed, denied, permits in report.records:
            self.usage.record(lid, admitted=allowed, denied=denied,
                              lease_local=allowed, now_ms=now)
            with self._lock:
                row = self._classes.get((lid, cls))
                if row is None:
                    if len(self._classes) >= self.max_classes:
                        row = self._classes.setdefault(
                            (lid, OVERFLOW_CLASS), [0, 0, 0])
                    else:
                        row = self._classes[(lid, cls)] = [0, 0, 0]
                row[0] += allowed
                row[1] += denied
                row[2] += permits
        with self._lock:
            self._clients[report.client_id] = now
            self._clients.move_to_end(report.client_id)
            while len(self._clients) > self.max_clients:
                self._clients.popitem(last=False)
        self._refresh_gauges(now)
        return len(report.records)

    # -- staleness -------------------------------------------------------------
    def staleness_ms(self, now_ms: Optional[int] = None) -> float:
        """Age of the OLDEST client's last report (0 with no clients):
        the bound on how far the fleet counters trail ground truth."""
        now = int(self._clock_ms() if now_ms is None else now_ms)
        with self._lock:
            if not self._clients:
                return 0.0
            oldest = min(self._clients.values())
        return float(max(now - oldest, 0))

    def _refresh_gauges(self, now: int) -> None:
        if self._m_clients is not None:
            with self._lock:
                n = len(self._clients)
            self._m_clients.set(float(n))
            self._m_staleness.set(self.staleness_ms(now))

    # -- export surfaces -------------------------------------------------------
    def signals(self, tenant: int, window_ms: int = 10_000):
        """ARCHITECTURE §13e: the adaptive controller's observation."""
        return self.usage.signals(tenant, window_ms)

    def all_signals(self, window_ms: int = 10_000):
        return self.usage.all_signals(window_ms)

    def tenants_payload(self) -> Dict:
        """``GET /actuator/tenants``."""
        now = int(self._clock_ms())
        self._refresh_gauges(now)
        with self._lock:
            n_clients = len(self._clients)
        payload = self.usage.snapshot(now)
        payload["telemetry"] = {
            "reports": self.reports_total,
            "rejected": self.reports_rejected,
            "clients": n_clients,
            "staleness_ms": self.staleness_ms(now),
            "lease_local_decisions": self.lease_local_total,
        }
        return payload

    def prometheus_samples(self):
        """Labeled series for the Prometheus exposition (the registry
        carries only unlabeled meters): per-tenant usage totals and
        per-(lid, key-class) client burn counts.  Label VALUES are
        escaped by the renderer — key classes come off the wire."""
        samples = []
        tenant_rows = {f: [] for f in ("admitted", "denied", "shed",
                                       "lease_local")}
        for t in self.usage.tenants():
            totals = self.usage.totals(t)
            for f, rows in tenant_rows.items():
                rows.append(({"tenant": str(t)}, totals[f]))
        for f, rows in tenant_rows.items():
            if rows:
                samples.append((
                    f"ratelimiter.tenant.{f}", "counter",
                    f"Per-tenant {f} decisions (usage ring totals)",
                    rows))
        with self._lock:
            classes = sorted(self._classes.items())
        for idx, name in ((0, "allowed"), (1, "denied"), (2, "permits")):
            rows = [({"lid": str(lid), "key_class": cls}, row[idx])
                    for (lid, cls), row in classes if row[idx]]
            if rows:
                samples.append((
                    f"ratelimiter.telemetry.class_{name}", "counter",
                    f"Client-reported lease-local {name} per "
                    "(limiter, key class)", rows))
        return samples
