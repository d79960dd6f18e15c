"""Micro-batcher: coalesces concurrent tryAcquire calls into device batches.

The reference's unit of concurrency is a servlet thread blocking on a Redis
round-trip (ARCHITECTURE.md latency model); ours is a Future that
resolves when its device batch's results land.  Threads submit requests; a
dedicated flusher thread dispatches a batch when either

- the pending batch reaches the size trigger (``max_batch``, or the
  adaptive controller's applied trigger), or
- the oldest pending request has waited the flush deadline
  (``max_delay_ms``, or the controller's applied deadline — SURVEY.md §7
  "Batching latency vs p99"),

whichever comes first.  With an ``AdaptiveFlushController`` attached
(engine/flush_control.py), both bounds track the measured device-step
time, hard-clamped within the configured ones.

**Double-buffered assembly.**  Requests are packed at submit time into a
preallocated combined staging buffer (``_Pending``), so batch N+1's host
assembly happens on the submitters' threads while batch N is in flight; a
flush swaps the active buffer for a recycled standby, and dispatch
collapses to one device upload plus the step's launches.

**Pipelined dispatch/drain.**  Dispatching a batch (enqueue on device,
state advanced) and draining it (the blocking device->host fetch that
resolves the waiters' futures) are decoupled: the flusher only dispatches;
a pool of drain threads fetches.  Up to ``max_inflight`` batches ride the
wire at once.  Correctness does not depend on drain order: dispatches are
serialized (single flusher + the dispatch lock), so device state advances
in submission order; each drain only reads its own batch's output buffer.

Eviction-clears stay safe for the same reason: cleared slots are zeroed in
the dispatch stream ahead of the batch that reuses them.

**Admission control and overload protection** (the reference's):

- ``max_pending`` bounds each algo's pending queue; a submit over the
  bound is shed with a typed ``OverloadedError`` (reason ``queue_full``)
  instead of queuing forever.
- ``deadline_ms`` gives each request a *queue* budget: a request that
  cannot be dispatched within its deadline (a hung device holds the
  dispatch lock) is failed with ``OverloadedError`` (reason ``deadline``)
  at take time or by the watchdog.  The budget covers queue wait only —
  once dispatched, a batch's drain latency is the device's business.
- a watchdog thread expires queued deadlines even while the flusher is
  wedged inside a dispatch, and detects a dead flusher (failing
  everything queued rather than hanging callers).
- ``close()`` fails every still-pending future with a typed
  ``ShutdownError`` after a bounded wait — a caller blocked on
  ``Future.result()`` is never stranded by shutdown.

With a ``tracer`` (``observability/trace.py:LatencyTracer``) each drained
batch's lifecycle stamps feed the ``ratelimiter.latency.*`` histograms;
with a ``recorder`` (the flight recorder) each shed burst leaves one
coalesced ``overload.shed`` event.

Besides ``submit``, two bulk surfaces serve the sidecar's pipelined and
columnar frames (``service/sidecar.py``): ``submit_many`` stages a burst
in one cv hold and returns a future per request; ``submit_block`` stages
it the same way under ONE future, which rides every lane of the block
and resolves once, to the lanes' array slices.  ``forget`` withdraws
still-queued requests a dead connection abandoned.

This is the reference batcher (``ratelimiter_tpu/engine/batcher.py``)
with its deadline shed's repair: a shed (or a ``forget``) that empties a
queue drops its age, so the flusher does not spin on it.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Set

import numpy as np

from ratelimiter_tpu_torch.engine.errors import OverloadedError, ShutdownError
from ratelimiter_tpu_torch.utils.logging import get_logger

log = get_logger("engine.batcher")

#: Initial staging-buffer lane count (the _MICRO_FLOOR bucket); buffers
#: grow by doubling so every capacity is a valid dispatch bucket.
_STAGE_CAP = 32


class _Pending:
    """One algo's pending queue, double-buffered.

    Requests are packed **at submit time** into a preallocated combined
    i64[4, cap] staging buffer (row 0 slots / 1 lids / 2 permits / 3 the
    batch timestamp lane — engine/engine.py:MICRO_STAGE_ROWS), so batch
    N+1's assembly happens on the submitters' threads while batch N is in
    flight, and flush-time "assembly" collapses to one device upload.
    Padding lanes carry their fill values permanently: a take hands the
    staged buffer to the dispatch as-is, and recycling re-fills only the
    lanes a batch actually used.  The per-request lists (futures, queue
    deadlines, submit stamps, trace ids) are host-resolution bookkeeping
    the device never sees.
    """

    __slots__ = ("buf", "n", "futures", "deadlines", "t_sub", "traces",
                 "clears", "born")

    #: Parallel per-request lists that shed/forget filtering must keep in
    #: lockstep with the staging-buffer lanes.
    LISTS = ("futures", "deadlines", "t_sub", "traces")

    def __init__(self, cap: int = _STAGE_CAP):
        self.buf = np.empty((4, cap), dtype=np.int64)
        self.buf[0] = -1  # slots   (pad: masked lane)
        self.buf[1] = 0   # lids
        self.buf[2] = 1   # permits
        self.buf[3, 0] = 0  # batch timestamp (stamped at dispatch)
        self.n = 0
        self.futures: List[Future] = []
        self.deadlines: List[float] = []  # monotonic queue deadlines (inf=none)
        self.t_sub: List[float] = []      # perf_counter at submit (tracing)
        self.traces: List[int] = []       # 64-bit trace ids (0 = untraced)
        self.clears: List[int] = []
        self.born: float | None = None  # monotonic time of oldest request

    @property
    def cap(self) -> int:
        return self.buf.shape[1]

    def append(self, slot: int, lid: int, permits: int) -> None:
        i = self.n
        if i == self.cap:
            self._grow(self.cap * 2)
        self.buf[0, i] = slot
        self.buf[1, i] = lid
        self.buf[2, i] = permits
        self.n = i + 1

    def extend(self, slots, lids, permits) -> None:
        i, n = self.n, len(slots)
        need = i + n
        if need > self.cap:
            grown = self.cap * 2
            while grown < need:
                grown *= 2
            self._grow(grown)
        self.buf[0, i:need] = slots
        self.buf[1, i:need] = lids
        self.buf[2, i:need] = permits
        self.n = need

    def _grow(self, cap: int) -> None:
        new = np.empty((4, cap), dtype=np.int64)
        new[0] = -1
        new[1] = 0
        new[2] = 1
        new[:, : self.n] = self.buf[:, : self.n]
        self.buf = new

    def slot_list(self) -> List[int]:
        return self.buf[0, : self.n].tolist()

    def compact(self, keep: List[int]) -> None:
        """Keep only the requests at the given indices (shed/forget),
        restoring padding fills behind the new tail."""
        k = len(keep)
        if k:
            idx = np.asarray(keep, dtype=np.int64)
            for row in (0, 1, 2):
                self.buf[row, :k] = self.buf[row, idx]
        self.buf[0, k: self.n] = -1
        self.buf[1, k: self.n] = 0
        self.buf[2, k: self.n] = 1
        self.n = k
        for name in self.LISTS:
            vals = getattr(self, name)
            setattr(self, name, [vals[i] for i in keep])

    def recycle(self) -> None:
        """Reset for reuse as the next standby buffer.  New list objects:
        the drain pipeline still holds the dispatched batch's futures."""
        self.buf[0, : self.n] = -1
        self.buf[1, : self.n] = 0
        self.buf[2, : self.n] = 1
        self.n = 0
        self.futures = []
        self.deadlines = []
        self.t_sub = []
        self.traces = []
        self.clears = []
        self.born = None


class MicroBatcher:
    """One batching queue per algorithm kind ('sw' | 'tb')."""

    def __init__(
        self,
        dispatch: Dict[str, Callable],      # algo -> fn(slots, lids, permits) -> handle
        dispatch_staged: Dict[str, Callable],  # algo -> fn(staged_buf, n) -> handle
        drain: Dict[str, Callable],         # algo -> fn(handle, n) -> dict
        clear: Dict[str, Callable],         # algo -> fn(slots) -> None
        max_batch: int = 8192,
        max_delay_ms: float = 0.5,
        max_inflight: int = 4,
        max_pending: int = 0,
        deadline_ms: float = 0.0,
        controller=None,
        meter_registry=None,
        tracer=None,
        recorder=None,
    ):
        # The flusher hands queued batches over as the pre-packed combined
        # staging buffer (see _Pending); dispatch_direct keeps the list
        # contract.  Both return a handle that ``drain`` fetches.
        self._dispatch = dispatch
        self._dispatch_staged = dispatch_staged
        self._drain = drain
        # Adaptive flush control (engine/flush_control.py): when present,
        # the flusher reads its applied deadline/size trigger each cycle
        # and the drain feeds it the measured device-step time.
        self._controller = controller
        # Request-lifecycle tracing (observability/trace.py): stages are
        # stamped regardless (one perf_counter per submit) and observed
        # only when a tracer is attached.  The flight recorder gets one
        # coalesced event per shed burst (not per shed request).
        self._tracer = tracer
        self._recorder = recorder
        self._clear = clear
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.max_inflight = max(int(max_inflight), 1)
        # Admission control (0 disables either bound — the library
        # default; the service wiring turns both on from the
        # ratelimiter.overload.* properties).
        self.max_pending = int(max_pending)
        self.deadline_ms = float(deadline_ms)
        self.shed_total = 0           # queue-full sheds (submit refused)
        self.deadline_total = 0       # queued requests expired pre-dispatch
        self.abandoned_total = 0      # queued requests withdrawn via forget()
        self.last_shed_s = 0.0        # monotonic stamp of the last shed
        self._shed_counter = (
            meter_registry.counter(
                "ratelimiter.overload.shed",
                "Requests shed at submit: pending queue at max_pending")
            if meter_registry is not None else None)
        self._deadline_counter = (
            meter_registry.counter(
                "ratelimiter.overload.deadline_exceeded",
                "Queued requests failed: not dispatched within deadline_ms")
            if meter_registry is not None else None)
        self._depth_gauge = (
            meter_registry.gauge(
                "ratelimiter.overload.queue_depth",
                "Pending micro-batch queue depth (largest algo queue)")
            if meter_registry is not None else None)
        self._cv = threading.Condition()
        self._pending: Dict[str, _Pending] = {a: _Pending() for a in dispatch}
        # Recycled standby staging buffers (the other half of the double
        # buffer): _take swaps one in, the drain returns the dispatched
        # one once its results were fetched.  Oversized buffers from a
        # burst are dropped instead of pooled.
        self._spare: Dict[str, List[_Pending]] = {a: [] for a in dispatch}
        self._spare_cap_max = max(2 * self.max_batch, 4 * _STAGE_CAP)
        self._waiters: Set[Future] = set()  # every unresolved submit future
        self._dispatch_lock = threading.Lock()  # serializes device batches
        self._closed = False
        self._flusher_dead = False
        self.max_depth_seen = 0  # high-water mark of any algo queue
        # Concurrent fetches: one worker per in-flight batch; the semaphore
        # is the backpressure bound on the device queue.
        self._drain_pool = ThreadPoolExecutor(
            max_workers=self.max_inflight,
            thread_name_prefix="ratelimiter-drain")
        self._inflight_sem = threading.Semaphore(self.max_inflight)
        self._flusher = threading.Thread(
            target=self._run, name="ratelimiter-flusher", daemon=True)
        self._flusher.start()
        # Watchdog: expires queued deadlines even while the flusher is
        # wedged inside a dispatch, and fails the queue if the flusher
        # dies.  Cheap (one lock + O(pending) scan per tick).
        self._watch_stop = threading.Event()
        self._watch_interval = (
            max(0.005, min(0.05, self.deadline_ms / 4000.0))
            if self.deadline_ms > 0 else 0.05)
        self._watchdog = threading.Thread(
            target=self._watch, name="ratelimiter-watchdog", daemon=True)
        self._watchdog.start()

    # -- submission -----------------------------------------------------------
    def submit(self, algo: str, slot: int, lid: int, permits: int,
               deadline_ms: float | None = None,
               trace_id: int = 0) -> Future:
        """Queue one decision; returns its Future.

        ``deadline_ms`` overrides the batcher-wide queue-deadline budget
        for this request (None = default; 0 = no deadline).
        ``trace_id`` is an optional 64-bit trace id carried to the drain
        (observability/telemetry.py lineage).  Raises
        ``OverloadedError`` when the pending queue is at ``max_pending``
        or the flusher has died, ``ShutdownError`` when closed.
        """
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise ShutdownError("batcher closed")
            if self._flusher_dead:
                raise OverloadedError(
                    "flusher thread died; nothing will dispatch this queue",
                    reason="flusher_dead", retry_after_ms=1000.0)
            pend = self._pending[algo]
            self._check_admission(pend, 1)
            if pend.born is None:
                pend.born = time.monotonic()
            budget = self.deadline_ms if deadline_ms is None else deadline_ms
            pend.append(slot, lid, permits)
            pend.futures.append(fut)
            pend.deadlines.append(
                time.monotonic() + budget / 1000.0 if budget and budget > 0
                else math.inf)
            pend.t_sub.append(time.perf_counter())
            pend.traces.append(int(trace_id))
            if pend.n > self.max_depth_seen:
                self.max_depth_seen = pend.n
            self._waiters.add(fut)
            self._cv.notify()
        return fut

    def _stage_burst(self, algo: str, slots, lids, permits, futs,
                     deadline_ms, traces) -> None:
        """Stage a burst's lanes (cv held by the caller): one admission
        check for the whole burst, three vectorized staging-buffer writes,
        one shared queue deadline; ``futs`` holds one future per lane."""
        n = len(slots)
        if self._closed:
            raise ShutdownError("batcher closed")
        if self._flusher_dead:
            raise OverloadedError(
                "flusher thread died; nothing will dispatch this queue",
                reason="flusher_dead", retry_after_ms=1000.0)
        pend = self._pending[algo]
        self._check_admission(pend, n)
        if pend.born is None:
            pend.born = time.monotonic()
        budget = self.deadline_ms if deadline_ms is None else deadline_ms
        deadline = (time.monotonic() + budget / 1000.0
                    if budget and budget > 0 else math.inf)
        pend.extend(slots, lids, permits)
        pend.futures.extend(futs)
        pend.deadlines.extend([deadline] * n)
        pend.t_sub.extend([time.perf_counter()] * n)
        pend.traces.extend(traces)
        if pend.n > self.max_depth_seen:
            self.max_depth_seen = pend.n

    def submit_many(self, algo: str, slots, lids, permits,
                    deadline_ms: float | None = None,
                    trace_ids=None) -> List[Future]:
        """Bulk :meth:`submit` for a pipelined burst whose slots were
        assigned in one batched index call (storage.acquire_async_many):
        one cv acquisition and three vectorized staging-buffer writes
        instead of a Python round trip per request.  All-or-nothing
        admission: a burst that would cross ``max_pending`` is shed
        whole."""
        n = len(slots)
        futs = [Future() for _ in range(n)]
        with self._cv:
            self._stage_burst(
                algo, slots, lids, permits, futs, deadline_ms,
                [int(t) for t in trace_ids] if trace_ids else [0] * n)
            self._waiters.update(futs)
            self._cv.notify()
        return futs

    def submit_block(self, algo: str, slots, lids, permits,
                     deadline_ms: float | None = None,
                     trace_id: int = 0) -> Future:
        """One future for a whole columnar burst (the sidecar's v5 batch
        frame): the n requests stage exactly like :meth:`submit_many` —
        contiguous lanes, all-or-nothing admission, one shared deadline —
        but resolve through a SINGLE future whose result maps each output
        key to its lanes' array slice ({"allowed": bool[n], ...}), so a
        thousand-row frame costs one Future and one set_result instead of
        a thousand.  The future object rides every one of its lanes in
        the parallel staging lists (tagged ``_lanes = n``), which keeps
        compaction, forget(), deadline expiry, and close() positional:
        the shared deadline makes expiry all-or-nothing, forget() drops
        every lane at once, and repeated _fail/cancel calls are no-ops
        after the first."""
        n = len(slots)
        fut = Future()
        fut._lanes = n
        if n == 0:
            fut.set_result({})
            return fut
        with self._cv:
            self._stage_burst(algo, slots, lids, permits, [fut] * n,
                              deadline_ms, [int(trace_id)] * n)
            self._waiters.add(fut)
            self._cv.notify()
        return fut

    def _check_admission(self, pend: _Pending, incoming: int) -> None:
        """Queue-full shed check (cv held)."""
        if not self.max_pending or pend.n + incoming <= self.max_pending:
            return
        self.shed_total += incoming
        self.last_shed_s = time.monotonic()
        if self._shed_counter is not None:
            self._shed_counter.add(incoming)
        if self._recorder is not None:
            self._recorder.record(
                "overload.shed", coalesce_ms=1000.0,
                reason="queue_full", depth=pend.n)
        # The queue drains one max_batch per dispatch cycle; a rough
        # cycle estimate keeps the hint cheap and honest.
        cycles = max(pend.n / max(self.max_batch, 1), 1.0)
        raise OverloadedError(
            f"pending queue full ({pend.n} >= {self.max_pending})",
            reason="queue_full",
            retry_after_ms=cycles * max(self.max_delay_s * 1000.0, 1.0))

    def queue_depth(self) -> int:
        """Largest per-algo pending queue (the admission-control bound's
        operand), for health reporting."""
        with self._cv:
            return max((p.n for p in self._pending.values()), default=0)

    def add_clear(self, algo: str, slot: int) -> None:
        """Schedule a slot zeroing ahead of the next batch (eviction)."""
        with self._cv:
            pend = self._pending[algo]
            if pend.born is None:
                pend.born = time.monotonic()
            pend.clears.append(slot)
            self._cv.notify()

    def pending_slots(self, algo: str) -> Set[int]:
        """Slots referenced by queued requests (pin set for eviction)."""
        with self._cv:
            return set(self._pending[algo].slot_list())

    def forget(self, futures) -> int:
        """Withdraw still-QUEUED requests whose futures the caller has
        abandoned (e.g. a sidecar connection died mid-burst): they are
        removed from the pending queue and cancelled, so a dead client's
        frames stop consuming device capacity and their slots stop
        pinning eviction.  Requests already dispatched are untouched —
        their futures resolve normally (the caller must still consume
        those).  Returns the number of lanes withdrawn."""
        targets = set(futures)
        removed: List[Future] = []
        with self._cv:
            for pend in self._pending.values():
                if not pend.futures or targets.isdisjoint(pend.futures):
                    continue
                keep = [i for i, f in enumerate(pend.futures)
                        if f not in targets]
                removed.extend(f for f in pend.futures if f in targets)
                pend.compact(keep)
                if not pend.n and not pend.clears:
                    # An empty queue must not keep waking the flusher.
                    pend.born = None
            for fut in removed:
                self._waiters.discard(fut)
        for fut in removed:
            fut.cancel()
        self.abandoned_total += len(removed)
        return len(removed)

    # -- flushing -------------------------------------------------------------
    def _take(self, algo: str) -> _Pending | None:
        """Swap the active staging buffer out (cv held): the taken batch
        is already packed; the standby buffer (recycled from a previous
        dispatch when one is available) starts filling immediately."""
        pend = self._pending[algo]
        if not pend.n and not pend.clears:
            return None
        spare = self._spare[algo]
        self._pending[algo] = spare.pop() if spare else _Pending()
        return pend

    def _recycle(self, algo: str, pend: _Pending) -> None:
        """Return a dispatched batch's staging buffer to the standby pool
        (its results were fetched, so the device is done reading it)."""
        if pend.cap > self._spare_cap_max:
            return  # burst-grown buffer: let it go instead of pinning RAM
        pend.recycle()
        with self._cv:
            spare = self._spare.get(algo)
            if spare is not None and len(spare) < 2:
                spare.append(pend)

    def flush(self) -> None:
        """Dispatch everything pending (admin/reset/shutdown and read
        barriers).  Returns once the batches are in the device stream —
        later reads observe them (dispatch order == device order); the
        waiters' futures resolve asynchronously via the drainer."""
        with self._cv:
            taken = {a: self._take(a) for a in self._pending}
        self._execute(taken)

    def _finish(self, futures: List[Future]) -> None:
        """Drop resolved futures from the stranding-watch set."""
        with self._cv:
            for fut in futures:
                self._waiters.discard(fut)

    def _fail(self, fut: Future, exc: Exception) -> None:
        if not fut.done():
            fut.set_exception(exc)
        with self._cv:
            self._waiters.discard(fut)

    def _resolve(self, algo: str, handle, futures: List[Future],
                 stamps, pend: _Pending) -> None:
        """Fetch a dispatched batch's results, resolve its futures and
        recycle its staging buffer.

        ``stamps`` is the lifecycle tuple ``(t_sub_list, t_take, t_disp,
        trace_ids)``; the adaptive controller measures the device stage
        from ``t_disp``, and the drain adds the device-done and resolved
        stamps and hands the batch to the tracer AFTER every waiter
        resolved (observability stays off the caller's critical path)."""
        out = None
        try:
            out = self._drain[algo](handle, len(futures))
            t_dev = time.perf_counter()
            if self._controller is not None:
                # Adaptive flush feedback: the measured device stage
                # (dispatch enqueued -> results fetched) for this batch.
                self._controller.observe(t_dev - stamps[2], len(futures))
            i, nf = 0, len(futures)
            while i < nf:
                fut = futures[i]
                # submit_block rides one future across its lanes; such a
                # future resolves once, to the lanes' array slices.
                lanes = getattr(fut, "_lanes", 1)
                j = min(i + lanes, nf)
                if not fut.done():  # close() may have failed it already
                    if lanes == 1:
                        fut.set_result({k: v[i] for k, v in out.items()})
                    else:
                        fut.set_result({k: np.asarray(v[i:j])
                                        for k, v in out.items()})
                i = j
        except Exception as exc:  # noqa: BLE001 — fail every waiter
            for fut in futures:
                if not fut.done():
                    fut.set_exception(exc)
        else:
            if self._tracer is not None:
                t_subs, t_take, t_disp, traces = stamps
                try:
                    self._tracer.observe_batch(
                        algo, out, t_subs, t_take, t_disp, t_dev,
                        time.perf_counter(), trace_ids=traces)
                except Exception:  # noqa: BLE001 — tracing must not fail waiters
                    log.exception("latency tracer failed (ignored)")
        finally:
            self._finish(futures)
            # The fetch completed, so the device is done reading the
            # staged buffer (a CPU-device dispatch may alias the host
            # numpy memory zero-copy — recycling any earlier would corrupt
            # an in-flight batch).
            self._recycle(algo, pend)

    def _enqueue_drain(self, algo: str, handle, futures: List[Future],
                       stamps, pend: _Pending) -> None:
        self._inflight_sem.acquire()  # backpressure on the device queue

        def job():
            try:
                self._resolve(algo, handle, futures, stamps, pend)
            finally:
                self._inflight_sem.release()

        try:
            self._drain_pool.submit(job)
        except RuntimeError:  # pool shut down mid-close: resolve inline
            job()

    def _execute(self, taken) -> None:
        with self._dispatch_lock:
            self._execute_locked(taken)

    def _shed_expired(self, pend: _Pending, now: float,
                      in_queue: bool = False) -> None:
        """Fail requests whose queue deadline passed before dispatch.

        Mutates ``pend`` in place (both taken batches and — under the cv,
        from the watchdog — the live queues).  The deadline budget covers
        queue wait only; a dispatched batch is never expired.
        """
        if not pend.futures or all(d > now for d in pend.deadlines):
            return
        keep = [i for i, d in enumerate(pend.deadlines) if d > now]
        expired = [f for f, d in zip(pend.futures, pend.deadlines)
                   if d <= now]
        n = len(expired)
        self.deadline_total += n
        self.last_shed_s = now
        if self._deadline_counter is not None:
            self._deadline_counter.add(n)
        if self._recorder is not None:
            self._recorder.record("overload.shed", coalesce_ms=1000.0,
                                  reason="deadline", count=n)
        log.warning("shed %d queued request(s): queue deadline exceeded "
                    "before dispatch%s", n,
                    " (watchdog)" if in_queue else "")
        pend.compact(keep)
        if not pend.n and not pend.clears:
            # An emptied queue must not keep its stale age: the flusher
            # would find it ready with nothing to take, and spin (the
            # reference's batcher does, until the next submit, and after
            # close() for good).
            pend.born = None
        exc = OverloadedError(
            "queue deadline exceeded before dispatch", reason="deadline",
            retry_after_ms=max(self.max_delay_s * 1000.0, 1.0))
        for fut in expired:
            self._fail(fut, exc)

    def _execute_locked(self, taken) -> None:
        for algo, pend in taken.items():
            if pend is None:
                continue
            self._shed_expired(pend, time.monotonic())
            t_take = time.perf_counter()  # assembly starts (tracing)
            try:
                if pend.clears:
                    self._clear[algo](pend.clears)
                if pend.n:
                    log.debug("dispatch algo=%s batch=%d clears=%d",
                              algo, pend.n, len(pend.clears))
                    # The batch was packed at submit time; hand the
                    # combined buffer over whole (one upload inside).
                    handle = self._dispatch_staged[algo](pend.buf, pend.n)
                    futures = pend.futures
                    stamps = (pend.t_sub, t_take, time.perf_counter(),
                              pend.traces)
                    # The staging buffer recycles at DRAIN time (a CPU-
                    # device dispatch may alias the host numpy memory
                    # zero-copy — it is free only once the results were
                    # fetched).
                    # With no other batch in flight, the drain-pool
                    # handoff (task queue + worker wake) is pure added
                    # latency — the fetch releases the GIL anyway, and
                    # in a request-response loop the next submissions
                    # only arrive AFTER these futures resolve.  Resolve
                    # inline; pipelined load keeps the pool.
                    if (self._inflight_sem._value >= self.max_inflight
                            and self._inflight_sem.acquire(blocking=False)):
                        try:
                            self._resolve(algo, handle, futures, stamps,
                                          pend)
                        finally:
                            self._inflight_sem.release()
                    else:
                        self._enqueue_drain(algo, handle, futures, stamps,
                                            pend)
                else:
                    self._recycle(algo, pend)
            except Exception as exc:  # noqa: BLE001 — fail every waiter
                log.warning("dispatch failed algo=%s batch=%d: %s",
                            algo, pend.n, exc)
                for fut in pend.futures:
                    if not fut.done():
                        fut.set_exception(exc)
                self._finish(pend.futures)

    def dispatch_direct(self, algo: str, slots, lids, permits, clears=None):
        """Synchronous whole-batch dispatch (the vectorized/bench path).

        Flushes everything pending first, then runs this batch under the
        same dispatch lock — so direct batches serialize with queued
        traffic and see a consistent state stream.  The direct batch's own
        fetch happens inline (its results are independent of the queued
        batches' fetches, which continue to drain in the background).
        """
        with self._cv:
            taken = {a: self._take(a) for a in self._pending}
        with self._dispatch_lock:
            self._execute_locked(taken)
            if clears:
                self._clear[algo](clears)
            handle = self._dispatch[algo](slots, lids, permits)
        return self._drain[algo](handle, len(slots))

    def _watch(self) -> None:
        """Overload watchdog: queue-deadline expiry that does not depend on
        the flusher being schedulable (it may be wedged inside a dispatch
        holding the dispatch lock), plus dead-flusher detection so queued
        callers fail instead of blocking forever."""
        while not self._watch_stop.wait(self._watch_interval):
            with self._cv:
                if self._closed:
                    return
                now = time.monotonic()
                for pend in self._pending.values():
                    self._shed_expired(pend, now, in_queue=True)
                if self._depth_gauge is not None:
                    self._depth_gauge.set(max(
                        (p.n for p in self._pending.values()), default=0))
                if not self._flusher_dead and not self._flusher.is_alive():
                    self._flusher_dead = True
                if self._flusher_dead:
                    taken = {a: self._take(a) for a in self._pending}
                else:
                    continue
            self._fail_taken(taken, OverloadedError(
                "flusher thread died; request abandoned",
                reason="flusher_dead", retry_after_ms=1000.0))

    def _fail_taken(self, taken, exc: Exception) -> None:
        for pend in taken.values():
            if pend is None:
                continue
            for fut in pend.futures:
                self._fail(fut, exc)

    def _run(self) -> None:
        try:
            self._run_loop()
        except Exception:  # noqa: BLE001 — flusher must never die silently
            log.exception("flusher died; failing all queued requests")
            with self._cv:
                self._flusher_dead = True
                taken = {a: self._take(a) for a in self._pending}
            self._fail_taken(taken, OverloadedError(
                "flusher thread died; request abandoned",
                reason="flusher_dead", retry_after_ms=1000.0))

    def _run_loop(self) -> None:
        while True:
            locked = False
            with self._cv:
                while not self._closed:
                    now = time.monotonic()
                    ready, wait = [], None
                    # Adaptive flush (engine/flush_control.py): the
                    # controller's applied deadline/size trigger replace
                    # the static bounds, re-read every cycle; both are
                    # clamped so they never exceed the configured ones.
                    # Pacing the flush against the device-step time only
                    # pays while the device pipeline is OCCUPIED (a
                    # flush faster than the service rate just queues at
                    # the dispatch lock); with every in-flight slot free
                    # the wait is pure added latency, so an idle device
                    # flushes at the controller's floor.
                    if self._controller is not None:
                        idle = (self._inflight_sem._value
                                >= self.max_inflight)
                        delay_s = min(self._controller.floor_s if idle
                                      else self._controller.delay_s(),
                                      self.max_delay_s)
                        trigger = min(self._controller.size_trigger(),
                                      self.max_batch)
                    else:
                        delay_s, trigger = self.max_delay_s, self.max_batch
                    for algo, pend in self._pending.items():
                        if pend.born is None:
                            continue
                        age = now - pend.born
                        if pend.n >= trigger or age >= delay_s:
                            ready.append(algo)
                        else:
                            remaining = delay_s - age
                            wait = remaining if wait is None else min(wait, remaining)
                    if ready:
                        # Deadline hit — but if a dispatch is mid-flight,
                        # do NOT freeze the batch yet: a batch taken now
                        # would sit waiting for the lock while new
                        # arrivals start a fresh queue and pay a whole
                        # extra dispatch cycle (a convoy of batcher-owned
                        # latency).
                        # Keep accumulating and re-check shortly; the
                        # take happens with the lock ALREADY HELD, so
                        # the batch carries everything that arrived
                        # during the previous step.
                        if self._dispatch_lock.acquire(blocking=False):
                            locked = True
                            break
                        # Floored: with max_delay_ms=0 an unfloored wait
                        # would spin the cv at full speed for as long as
                        # the in-flight dispatch holds the lock.
                        self._cv.wait(timeout=max(
                            min(self.max_delay_s, 3e-4), 5e-5))
                        continue
                    self._cv.wait(timeout=wait)
                if self._closed and not any(
                    p.born is not None for p in self._pending.values()
                ):
                    if locked:
                        self._dispatch_lock.release()
                    return
                taken = {a: self._take(a) for a in self._pending}
            try:
                if locked:
                    self._execute_locked(taken)
                else:  # close() drained the cv loop: plain locked path
                    self._execute(taken)
            finally:
                if locked:
                    self._dispatch_lock.release()

    def close(self, timeout: float = 5.0) -> None:
        """Shut down; never strands a waiter.

        The healthy path dispatches whatever is queued and waits for the
        in-flight drains.  Every path that can hang is bounded: a stuck
        dispatch (lock never acquired), a dead flusher, or a hung drain
        all end with the remaining futures failed by a typed
        ``ShutdownError`` after ``timeout`` — a caller blocked on
        ``Future.result()`` always gets an answer.
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._watch_stop.set()
        self._flusher.join(timeout=timeout)
        # Dispatch the remaining queue — but never hang on a wedged
        # dispatch: if the lock cannot be had, the queued futures are
        # failed below instead of dispatched.
        with self._cv:
            taken = {a: self._take(a) for a in self._pending}
        if any(p is not None for p in taken.values()):
            if self._dispatch_lock.acquire(timeout=max(timeout, 0.1)):
                try:
                    self._execute_locked(taken)
                finally:
                    self._dispatch_lock.release()
            else:
                self._fail_taken(taken, ShutdownError(
                    "batcher closed before the batch could be dispatched"))
        # Resolve whatever is on the wire, bounded by the same timeout.
        self._drain_pool.shutdown(wait=False)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                if not self._waiters:
                    break
            time.sleep(0.005)
        with self._cv:
            stranded = [f for f in self._waiters if not f.done()]
            self._waiters.clear()
        if stranded:
            log.warning("close(): failing %d stranded future(s)",
                        len(stranded))
            exc = ShutdownError("batcher closed; request abandoned")
            for fut in stranded:
                if not fut.done():
                    fut.set_exception(exc)
