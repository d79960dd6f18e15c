"""Async replicator: ships epoch frames from a ReplicationLog to a sink
(counterpart of ``ratelimiter_tpu/replication/replicator.py``).

Replication is strictly OFF the decision path ("When Two is Worse Than
One", PAPERS.md — naive synchronous redundancy degrades tail latency):
the hot path only marks a dirty mask; this thread wakes every
``interval_ms``, cuts an epoch, and pushes the frames through the sink.
A slow or dead standby therefore costs the primary nothing but memory
for the dirty mask — decisions never wait on the wire.

Backpressure: the background loop runs a CUTTER thread (cuts + encodes
epochs into a byte-bounded in-flight queue) and a SENDER thread (drains
the queue through the sink).  When the standby link is slower than the
delta rate the queue fills; the cutter then SKIPS cuts instead of
queueing more — the marks stay in the journal (a fixed-size bitmap) and
coalesce into the next epoch that does ship.  Host memory is bounded by
``max_queue_bytes`` no matter how slow the link gets, and every skipped
cut counts in ``ratelimiter.replication.coalesced``.

Failure model: a sink error re-marks the failed frames' slots into the
journal and requests a FULL next frame (the standby's epoch stream now
has a gap it will refuse to promote across until re-baselined), bumps
the error counter, and keeps looping — asynchronous replication degrades
to "standby lags further", never to "primary stops deciding".

Metrics (metrics/registry.py, scraped by /actuator/metrics):
  ratelimiter.replication.lag_ms    gauge   age of the oldest unshipped
                                            mutation at the last cut
  ratelimiter.replication.epoch     gauge   newest epoch cut
  ratelimiter.replication.frames    counter frames shipped
  ratelimiter.replication.bytes     counter encoded bytes shipped
  ratelimiter.replication.errors    counter ship failures
  ratelimiter.replication.coalesced counter cuts skipped against a full
                                            in-flight queue (the deltas
                                            coalesced in the journal)
"""

from __future__ import annotations

import collections
import threading
import time

from ratelimiter_tpu_torch.replication.wire import encode_frame
from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("replication")

# In-flight encoded epochs the background pipeline may hold before the
# cutter starts coalescing: four wire-budget frames' worth.
DEFAULT_MAX_QUEUE_BYTES = 64 << 20


class Replicator:
    def __init__(self, log, sink, interval_ms: float = 200.0,
                 registry=None, max_queue_bytes: int = DEFAULT_MAX_QUEUE_BYTES):
        self.log = log
        self.sink = sink
        self.interval_ms = float(interval_ms)
        self.max_queue_bytes = int(max_queue_bytes)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._sender: threading.Thread | None = None
        self._ship_lock = threading.Lock()
        # Orders cut-and-enqueue/send atomically: without it, a ship_now
        # racing the background cutter could cut epoch N+2 and send it
        # ahead of a still-queued N+1 — the receiver would then refuse
        # N+1 as stale and force a needless full re-baseline.
        self._cut_lock = threading.Lock()
        # In-flight epochs: deque of (frames, encoded, bytes) triples.
        self._queue = collections.deque()
        self._queue_cv = threading.Condition()
        self._queue_bytes = 0
        self.frames_shipped = 0
        self.bytes_shipped = 0
        self.errors = 0
        self.coalesced = 0
        if registry is not None:
            self._m_lag = registry.gauge(
                "ratelimiter.replication.lag_ms",
                "Age (ms) of the oldest unreplicated mutation at the "
                "last epoch cut")
            self._m_epoch = registry.gauge(
                "ratelimiter.replication.epoch",
                "Newest replication epoch cut on the primary")
            self._m_frames = registry.counter(
                "ratelimiter.replication.frames",
                "Replication frames shipped to the standby")
            self._m_bytes = registry.counter(
                "ratelimiter.replication.bytes",
                "Encoded replication bytes shipped")
            self._m_errors = registry.counter(
                "ratelimiter.replication.errors",
                "Replication ship failures (frames re-marked, next "
                "frame full)")
            self._m_coalesced = registry.counter(
                "ratelimiter.replication.coalesced",
                "Cuts skipped against a full in-flight queue; their "
                "deltas coalesced in the journal (slow standby link)")
            self._m_link = registry.gauge(
                "ratelimiter.replication.link_up",
                "1 while the standby link answers (sends/heartbeats "
                "acked); 0 once it is marked DEAD")
            self._m_link.set(1.0)
        else:
            self._m_lag = self._m_epoch = None
            self._m_frames = self._m_bytes = self._m_errors = None
            self._m_coalesced = None
            self._m_link = None
        self._link_last = None

    # -- link liveness ---------------------------------------------------------
    def link_state(self) -> str:
        """The sink's view of the standby link (``unknown`` for sinks
        that do not track one)."""
        fn = getattr(self.sink, "link_state", None)
        return fn() if fn is not None else "unknown"

    def _observe_link(self) -> None:
        """Record DEAD<->UP transitions: gauge + flight event.  A DEAD
        link means the standby behind it is going STALE — the signal the
        failover orchestrator uses to refuse promoting onto it."""
        state = self.link_state()
        if state == self._link_last or state == "unknown":
            return
        from ratelimiter_tpu_torch.observability import flight_recorder

        if state == "dead":
            if self._m_link is not None:
                self._m_link.set(0.0)
            flight_recorder().record("replication.link_dead")
            _log.warning("replication link marked DEAD (standby gone, "
                         "not merely slow); its replica is going stale")
        elif state == "up":
            if self._m_link is not None:
                self._m_link.set(1.0)
            if self._link_last == "dead":
                flight_recorder().record("replication.link_restored")
        self._link_last = state

    # -- one synchronous ship cycle (tests drive this deterministically) ------
    def ship_now(self) -> int:
        """Drain any queued epochs, then cut a fresh one and ship it;
        returns frames shipped this call (0 = clean)."""
        with self._ship_lock, self._cut_lock:
            shipped = self._drain_queue_locked()
            # A sink that reconnected since the last cycle may be talking
            # to a RESTARTED standby with empty state: re-baseline with a
            # full frame before shipping more deltas into a gap.
            consume = getattr(self.sink, "consume_reconnected", None)
            if consume is not None and consume():
                _log.warning("replication link reconnected; re-baselining "
                             "with a full frame")
                self.log.request_full()
            frames = self.log.cut()
            if self._m_lag is not None:
                self._m_lag.set(self.log.last_cut_lag_ms)
            if not frames:
                return shipped
            if self._m_epoch is not None:
                self._m_epoch.set(self.log.epoch)
            return shipped + self._send_frames_locked(
                frames, [encode_frame(f) for f in frames])

    def _send_frames_locked(self, frames, encoded) -> int:
        """Send one epoch's frames (caller holds _ship_lock); on failure
        re-mark the unshipped tail and request a full re-baseline."""
        shipped = 0
        try:
            for data in encoded:
                self.sink.send(data)
                shipped += 1
                self.frames_shipped += 1
                self.bytes_shipped += len(data)
                if self._m_frames is not None:
                    self._m_frames.increment()
                    self._m_bytes.add(len(data))
        except Exception:
            # Unshipped rows go back in the journal; the epoch the
            # standby half-saw is re-baselined by a full next frame.
            self.errors += 1
            if self._m_errors is not None:
                self._m_errors.increment()
            self.log.remark(frames[shipped:])
            self.log.request_full()
            self._observe_link()
            raise
        self._observe_link()
        return shipped

    def _drain_queue_locked(self) -> int:
        shipped = 0
        while True:
            with self._queue_cv:
                if not self._queue:
                    return shipped
                frames, encoded, nbytes = self._queue.popleft()
                self._queue_bytes -= nbytes
                self._queue_cv.notify_all()
            shipped += self._send_frames_locked(frames, encoded)

    # -- background pipeline (cutter + sender) --------------------------------
    def start(self) -> "Replicator":
        if self._thread is None:
            self._sender = threading.Thread(
                target=self._send_loop, name="replicator-send", daemon=True)
            self._sender.start()
            self._thread = threading.Thread(
                target=self._run, name="replicator", daemon=True)
            self._thread.start()
        return self

    def queue_bytes(self) -> int:
        with self._queue_cv:
            return self._queue_bytes

    def _run(self) -> None:
        while not self._stop.wait(self.interval_ms / 1000.0):
            try:
                self._cut_cycle()
            except Exception as exc:  # noqa: BLE001 — async loop survives
                _log.warning("replication cut failed: %s (will retry)", exc)

    def _cut_cycle(self) -> None:
        with self._queue_cv:
            backlogged = self._queue_bytes >= self.max_queue_bytes
        if backlogged:
            # Slow link: skip the cut entirely — the journal keeps the
            # marks (fixed-size bitmap) and the next unskipped cut ships
            # one coalesced delta.  Host memory stays bounded.
            self.coalesced += 1
            if self._m_coalesced is not None:
                self._m_coalesced.increment()
            from ratelimiter_tpu_torch.observability import flight_recorder

            flight_recorder().record("replication.coalesced",
                                     coalesce_ms=2000.0)
            return
        with self._cut_lock:
            consume = getattr(self.sink, "consume_reconnected", None)
            if consume is not None and consume():
                _log.warning("replication link reconnected; re-baselining "
                             "with a full frame")
                self.log.request_full()
            frames = self.log.cut()
            if self._m_lag is not None:
                self._m_lag.set(self.log.last_cut_lag_ms)
            if not frames:
                # Idle cycle: heartbeat the link so a standby that died
                # SILENTLY (partition, power cut — no RST) is detected
                # even with no deltas flowing.
                hb = getattr(self.sink, "heartbeat", None)
                if hb is not None:
                    hb()
                self._observe_link()
                return
            if self._m_epoch is not None:
                self._m_epoch.set(self.log.epoch)
            encoded = [encode_frame(f) for f in frames]
            nbytes = sum(len(d) for d in encoded)
            with self._queue_cv:
                self._queue.append((frames, encoded, nbytes))
                self._queue_bytes += nbytes
                self._queue_cv.notify_all()

    def _send_loop(self) -> None:
        while True:
            with self._queue_cv:
                while not self._queue and not self._stop.is_set():
                    self._queue_cv.wait(0.2)
                if not self._queue and self._stop.is_set():
                    return
                if not self._queue:
                    continue
            try:
                with self._ship_lock:
                    # Re-check under the ship lock: ship_now may have
                    # drained the queue while we were acquiring.
                    with self._queue_cv:
                        if not self._queue:
                            continue
                        frames, encoded, nbytes = self._queue.popleft()
                        self._queue_bytes -= nbytes
                        self._queue_cv.notify_all()
                    self._send_frames_locked(frames, encoded)
            except Exception as exc:  # noqa: BLE001 — sender survives
                _log.warning("replication ship failed: %s (will retry "
                             "with a full frame)", exc)

    def stop(self, final_ship: bool = False) -> None:
        self._stop.set()
        with self._queue_cv:
            self._queue_cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._sender is not None:
            self._sender.join(timeout=5.0)
            self._sender = None
        if final_ship:
            try:
                self.ship_now()
            except Exception as exc:  # noqa: BLE001 — best effort drain
                _log.warning("final replication ship failed: %s", exc)
        self._stop.clear()

    def close(self) -> None:
        self.stop()
        self.log.detach()
        if hasattr(self.sink, "close"):
            self.sink.close()

    def lag_ms(self) -> float:
        """Current lag estimate: the last cut's measured lag, or — when
        mutations are pending — the time since the interval began."""
        return self.log.last_cut_lag_ms
