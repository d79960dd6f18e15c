"""Flight recorder: a bounded structured-event ring for state transitions
(counterpart of ``ratelimiter_tpu/observability/flightrecorder.py``).

Metrics answer "how much"; the flight recorder answers "what happened,
in what order".  Subsystems append one event per *state transition* —
breaker open/half-open/close, health state changes, shed bursts, Pallas
election verdicts and fused-relay fallback, replication promotion /
``reordered`` / ``coalesced``, shard failover — so after an incident the
ring reads as a timeline (open -> degraded -> resync; kill -> promote ->
bit-identical) without log archaeology.  The chaos drills
(``storage/chaos.py``) assert exactly those sequences.

Events are rare by construction (transitions, not requests), so the ring
takes a plain lock; per-kind coalescing (``coalesce_ms``) keeps bursty
kinds — shed storms, replicator coalescing — from flooding the ring:
a repeat of the same kind within the window increments the previous
event's ``n`` instead of appending.

The **anomaly hook** is the one per-dispatch touch point: any dispatch
whose wall time exceeds the configured SLO threshold gets its stage
breakdown snapshotted together with the last ``context_events`` ring
events — the "where did this request's 3.2 ms go" artifact, captured at
the moment it happened.  The threshold check itself is one float compare
on the recording path (``storage/tpu.py:_record_dispatch``).

A process-global default instance (``flight_recorder()``) exists so that
deeply-nested subsystems (the breaker inside the wrapper chain, the
Pallas election, the standby receiver) need no plumbing; components
accept an explicit ``recorder=`` for isolation in tests.
Exposed at ``GET /actuator/flightrecorder``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class FlightRecorder:
    """Fixed-capacity ring of structured transition events + anomalies."""

    def __init__(self, capacity: int = 1024, anomaly_capacity: int = 64,
                 slo_ms: float = 0.0, context_events: int = 16):
        self._capacity = max(int(capacity), 1)
        self._anomaly_capacity = max(int(anomaly_capacity), 1)
        self._context_events = max(int(context_events), 1)
        self._slo_us = float(slo_ms) * 1000.0
        self._events: List[Optional[dict]] = [None] * self._capacity
        self._next = 0
        self._seq = 0          # total events ever recorded (wrap counter)
        self._anomalies: List[dict] = []
        self._anomaly_total = 0
        self._last_by_kind: Dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- configuration --------------------------------------------------------
    def set_slo_ms(self, slo_ms: float) -> None:
        """Arm (or disarm, 0) the slow-dispatch anomaly hook."""
        self._slo_us = float(slo_ms) * 1000.0

    def resize(self, capacity: int) -> None:
        """Re-bound the ring (boot-time config; keeps the newest events
        that fit)."""
        capacity = max(int(capacity), 1)
        with self._lock:
            kept = self._ordered_locked()[-capacity:]
            self._capacity = capacity
            self._events = kept + [None] * (capacity - len(kept))
            self._next = len(kept) % capacity

    @property
    def slo_us(self) -> float:
        return self._slo_us

    # -- recording ------------------------------------------------------------
    def record(self, kind: str, coalesce_ms: float = 0.0, **fields) -> None:
        """Append one transition event.

        ``coalesce_ms`` > 0: a repeat of ``kind`` within the window
        bumps the previous event's ``n`` count instead of appending —
        a burst reads as one event with a tally, not a flood.
        """
        now_ms = time.time_ns() // 1_000_000
        with self._lock:
            if coalesce_ms > 0:
                last = self._last_by_kind.get(kind)
                if last is not None and now_ms - last["t_ms"] <= coalesce_ms:
                    last["n"] = last.get("n", 1) + 1
                    last["t_last_ms"] = now_ms
                    return
            event = {"seq": self._seq, "t_ms": now_ms, "kind": kind}
            if fields:
                event.update(fields)
            self._events[self._next] = event
            self._next = (self._next + 1) % self._capacity
            self._seq += 1
            self._last_by_kind[kind] = event

    def record_transition(self, kind: str, state: str, **fields) -> bool:
        """Record only when ``state`` differs from the last recorded
        state of this ``kind`` — the health poll calls this on every
        scrape and only transitions land in the ring.  Returns whether
        an event was recorded."""
        with self._lock:
            last = self._last_by_kind.get(kind)
            if last is not None and last.get("state") == state:
                return False
        self.record(kind, state=state, **fields)
        return True

    def anomaly(self, kind: str, total_us: float,
                stages: Optional[dict] = None, **fields) -> None:
        """Snapshot a slow dispatch: its stage breakdown plus the last
        ``context_events`` ring events (what the system was doing when
        the tail happened)."""
        with self._lock:
            entry = {
                "seq": self._seq,
                "t_ms": time.time_ns() // 1_000_000,
                "kind": kind,
                "total_us": round(float(total_us), 1),
                "slo_us": self._slo_us,
                "context": self._ordered_locked()[-self._context_events:],
            }
            if stages:
                entry["stages_us"] = {
                    k: round(float(v), 1) for k, v in stages.items()}
            if fields:
                entry.update(fields)
            self._anomalies.append(entry)
            self._anomaly_total += 1
            if len(self._anomalies) > self._anomaly_capacity:
                del self._anomalies[0]

    def note_dispatch(self, total_us: float, stages: Optional[dict] = None,
                      **fields) -> None:
        """The per-dispatch anomaly hook: one float compare when the SLO
        threshold is unarmed or met; a full snapshot when exceeded."""
        if self._slo_us > 0.0 and total_us > self._slo_us:
            self.anomaly("slow_dispatch", total_us, stages, **fields)

    # -- reading --------------------------------------------------------------
    def _ordered_locked(self) -> List[dict]:
        return [e for e in (self._events[self._next:]
                            + self._events[:self._next]) if e is not None]

    def mark(self) -> int:
        """Current sequence number — drills snapshot it, then assert on
        ``events(since=mark)``."""
        with self._lock:
            return self._seq

    def events(self, kind: Optional[str] = None,
               since: int = -1,
               since_ms: Optional[int] = None) -> List[dict]:
        """Ring events in order, optionally filtered by kind prefix, by
        ``seq >= since``, and by wall-clock ``t_ms >= since_ms``."""
        with self._lock:
            out = self._ordered_locked()
        if since >= 0:
            out = [e for e in out if e["seq"] >= since]
        if since_ms is not None:
            out = [e for e in out if e["t_ms"] >= since_ms]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind
                   or e["kind"].startswith(kind + ".")]
        return out

    def snapshot(self, last: int = 256, kind: Optional[str] = None,
                 since_ms: Optional[int] = None) -> dict:
        """Full payload for ``GET /actuator/flightrecorder``; ``kind``
        (exact or dotted prefix) and ``since_ms`` filter ring-side so an
        incident query returns only the relevant slice, not the whole
        ring for the client to sift."""
        filtered = kind is not None or since_ms is not None
        with self._lock:
            events = self._ordered_locked()
            anomalies = list(self._anomalies)
            total = self._seq
        if filtered:
            if since_ms is not None:
                events = [e for e in events if e["t_ms"] >= since_ms]
                anomalies = [a for a in anomalies
                             if a["t_ms"] >= since_ms]
            if kind is not None:
                events = [e for e in events if e["kind"] == kind
                          or e["kind"].startswith(kind + ".")]
                anomalies = [a for a in anomalies if a["kind"] == kind
                             or a["kind"].startswith(kind + ".")]
        out = {
            "total_events": total,
            "capacity": self._capacity,
            "slo_ms": self._slo_us / 1000.0,
            "events": events[-last:],
            "anomaly_total": self._anomaly_total,
            "anomalies": anomalies,
        }
        if filtered:
            out["filtered"] = {"kind": kind, "since_ms": since_ms,
                               "matched": len(events)}
        return out

    def reset(self) -> None:
        """Drop everything (test isolation for the global instance)."""
        with self._lock:
            self._events = [None] * self._capacity
            self._next = 0
            self._seq = 0
            self._anomalies = []
            self._anomaly_total = 0
            self._last_by_kind.clear()


_GLOBAL = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-global recorder (see module docstring)."""
    return _GLOBAL
