"""Admission control, port against the JAX package: the cases of
``tests/test_overload.py`` that time no drill, on both packages'
``MicroBatcher`` with a gated dispatch, on both storages, and through
both HTTP apps.

A request is answered — allowed, denied, shed with a typed retryable
error, or failed by shutdown — but never stranded.  Each case runs the
same steps on both batchers and compares what the caller sees (results,
exception types, reasons and retry hints) and the batcher's own
counters (``shed_total``, ``deadline_total``, ``queue_depth()``).  The
dispatch is held on an ``Event``; the tests wait on the batcher's own
state (the gate entered, the queue depth) with a bounded poll, never on
one fixed sleep.
"""

import json
import threading
import time
import http.client

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine.batcher import MicroBatcher as RefBatcher
from ratelimiter_tpu.engine.errors import (
    OverloadedError as RefOverloaded,
    ShutdownError as RefShutdown,
)
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.observability import FlightRecorder as RefRecorder
from ratelimiter_tpu.service import app as ref_app
from ratelimiter_tpu.service.props import AppProperties as RefProps
from ratelimiter_tpu.service.wiring import build_app as ref_build_app
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine.batcher import MicroBatcher
from ratelimiter_tpu_torch.engine.errors import OverloadedError, ShutdownError
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.observability import FlightRecorder
from ratelimiter_tpu_torch.service import app as port_app
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.service.wiring import build_app
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_760_000_000_000
WAIT_S = 10.0


def poll(cond, what: str, timeout: float = WAIT_S) -> None:
    """Wait until ``cond()`` holds, failing after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.002)


class Gate:
    """A dispatch hold: ``entered`` is set when a dispatch reaches the
    gate, which then waits for ``release`` (bounded)."""

    def __init__(self, hold: bool = True):
        self.entered = threading.Event()
        self.release = threading.Event()
        if not hold:
            self.release.set()

    def __call__(self):
        self.entered.set()
        self.release.wait(timeout=30)


def make_batcher(ref: bool, gate: Gate, **kw):
    """One package's batcher over an instant dispatch behind ``gate``:
    the reference in its synchronous list mode, the port through its
    staged dispatch and drain."""
    kw.setdefault("max_delay_ms", 10_000.0)  # accumulate unless told not to
    clear = {"sw": lambda slots: None}
    if ref:
        def dispatch(slots, lids, permits):
            gate()
            return {"allowed": [True] * len(slots)}

        return RefBatcher(dispatch={"sw": dispatch}, clear=clear, **kw)

    def staged(buf, n):
        gate()
        return n

    def listed(slots, lids, permits):
        gate()
        return len(slots)

    return MicroBatcher(dispatch={"sw": listed},
                        dispatch_staged={"sw": staged},
                        drain={"sw": lambda h, n: {
                            "allowed": np.ones(n, dtype=bool)}},
                        clear=clear, **kw)


def outcome(fut, timeout: float = WAIT_S):
    """What a caller of ``fut.result()`` sees, package-neutral."""
    try:
        return ("ok", bool(fut.result(timeout=timeout)["allowed"]))
    except (OverloadedError, RefOverloaded) as exc:
        return ("overloaded", exc.reason, exc.retry_after_ms)
    except (ShutdownError, RefShutdown) as exc:
        return ("shutdown", str(exc))


def submit_outcome(b, *args, **kw):
    """A submit's future, or what it raised, package-neutral."""
    try:
        return b.submit(*args, **kw)
    except (OverloadedError, RefOverloaded) as exc:
        return ("overloaded", exc.reason, exc.retry_after_ms)
    except (ShutdownError, RefShutdown) as exc:
        return ("shutdown", str(exc))


def counters(b):
    return (b.shed_total, b.deadline_total, b.queue_depth(),
            b.max_pending, b.deadline_ms)


def run_both(scenario):
    return [scenario(ref) for ref in (True, False)]


@pytest.mark.parametrize("max_pending", [1, 2, 5])
def test_submit_sheds_at_max_pending_like_reference(max_pending):
    def scenario(ref):
        b = make_batcher(ref, Gate(hold=False), max_pending=max_pending,
                         meter_registry=RefRegistry() if ref
                         else MeterRegistry())
        try:
            futs = [b.submit("sw", i, 0, 1) for i in range(max_pending)]
            shed = [submit_outcome(b, "sw", 99 + i, 0, 1) for i in range(3)]
            before = counters(b)
            b.flush()
            return (shed, before, [outcome(f) for f in futs], counters(b),
                    b._shed_counter.count())
        finally:
            b.close()

    ref, port = run_both(scenario)
    assert port == ref
    assert ref[0][0][:2] == ("overloaded", "queue_full")
    assert ref[0][0][2] > 0
    assert ref[1][:3] == (3, 0, max_pending)


def test_zero_max_pending_disables_the_bound_like_reference():
    def scenario(ref):
        b = make_batcher(ref, Gate(hold=False), max_pending=0)
        try:
            futs = [b.submit("sw", i, 0, 1) for i in range(64)]
            b.flush()
            return [outcome(f) for f in futs], counters(b)
        finally:
            b.close()

    ref, port = run_both(scenario)
    assert port == ref
    assert ref[1][0] == 0 and all(o == ("ok", True) for o in ref[0])


@pytest.mark.parametrize("per_request", [False, True])
def test_queue_deadline_expires_undispatched_like_reference(per_request):
    """A request queued behind a wedged dispatch is failed by the watchdog
    with a typed deadline error — the batcher-wide budget, or one request's
    own (``deadline_ms=`` on submit, with no batcher default) — while the
    dispatched one is never shed."""
    def scenario(ref):
        gate = Gate()
        b = make_batcher(ref, gate, max_delay_ms=0.0,
                         deadline_ms=0.0 if per_request else 60.0)
        try:
            first = b.submit("sw", 0, 0, 1)   # wedges inside dispatch
            poll(gate.entered.is_set, "the first dispatch")
            poll(lambda: b.queue_depth() == 0, "the flusher's take")
            second = (b.submit("sw", 1, 0, 1, deadline_ms=50.0)
                      if per_request else b.submit("sw", 1, 0, 1))
            untimed = b.submit("sw", 2, 0, 1, deadline_ms=0.0)
            got = outcome(second)
            poll(lambda: b.queue_depth() == 1, "the watchdog's expiry")
            mid = counters(b)
            gate.release.set()
            return got, mid, outcome(first), outcome(untimed), counters(b)
        finally:
            gate.release.set()
            b.close()

    ref, port = run_both(scenario)
    assert port == ref
    assert ref[0][:2] == ("overloaded", "deadline")
    assert ref[1][1] == 1 and ref[2] == ("ok", True) == ref[3]


def test_dead_flusher_fails_queue_and_refuses_submits_like_reference():
    def scenario(ref):
        b = make_batcher(ref, Gate(hold=False))
        try:
            queued = b.submit("sw", 0, 0, 1)
            b.max_delay_s = None  # poison: the flusher loop dies on compare
            with b._cv:
                b._cv.notify_all()
            got = outcome(queued)
            poll(lambda: b._flusher_dead, "the watchdog to flag the flusher")
            return got, submit_outcome(b, "sw", 1, 0, 1)
        finally:
            b.max_delay_s = 10.0
            b.close()

    ref, port = run_both(scenario)
    assert port == ref
    assert ref[0][:2] == ("overloaded", "flusher_dead") == ref[1][:2]


def test_close_fails_pending_futures_like_reference():
    """close() fails still-pending futures with ShutdownError, bounded,
    even when a dispatch is wedged and never returns; a submit after
    close raises ShutdownError."""
    def scenario(ref):
        gate = Gate()
        b = make_batcher(ref, gate, max_delay_ms=0.0)
        dispatched = b.submit("sw", 0, 0, 1)
        poll(gate.entered.is_set, "the first dispatch")
        poll(lambda: b.queue_depth() == 0, "the flusher's take")
        queued = b.submit("sw", 1, 0, 1)
        t0 = time.monotonic()
        b.close(timeout=0.3)
        bounded = time.monotonic() - t0 < 5
        out = (bounded, outcome(dispatched, 1), outcome(queued, 1),
               submit_outcome(b, "sw", 2, 0, 1))
        gate.release.set()
        return out

    ref, port = run_both(scenario)
    assert port == ref
    assert ref[0] and ref[1][0] == ref[2][0] == ref[3][0] == "shutdown"


def test_emptied_queue_leaves_the_flusher_idle():
    """A deadline shed that empties the queue resets its age: the flusher
    waits for the next request instead of finding an aged, empty queue
    ready on every cycle, and ``close()`` ends it.  (The reference's
    flusher spins there until the next submit, and for good after
    ``close()``; ROADMAP C7.  It is not run here: its thread would spin
    for the rest of the process.)"""
    gate = Gate()
    b = make_batcher(False, gate, max_delay_ms=0.0, deadline_ms=50.0)
    try:
        first = b.submit("sw", 0, 0, 1)
        poll(gate.entered.is_set, "the first dispatch")
        poll(lambda: b.queue_depth() == 0, "the flusher's take")
        second = b.submit("sw", 1, 0, 1)
        assert outcome(second)[:2] == ("overloaded", "deadline")
        takes = []
        take = b._take

        def counted_take(algo):
            takes.append(algo)
            return take(algo)

        b._take = counted_take
        gate.release.set()
        assert outcome(first) == ("ok", True)
        time.sleep(0.3)
        assert len(takes) < 50, f"{len(takes)} takes of an empty queue"
        third = b.submit("sw", 2, 0, 1)
        assert outcome(third) == ("ok", True)
    finally:
        gate.release.set()
        b.close(timeout=1.0)
    b._flusher.join(timeout=5)
    assert not b._flusher.is_alive()


class _PausingLock:
    """The batcher's dispatch lock, but a blocking acquire from the
    thread ``pause_in`` waits for ``go`` first (``waiting`` says it is
    there); every other acquire goes straight through."""

    def __init__(self, lock):
        self._lock = lock
        self.pause_in = None
        self.waiting = threading.Event()
        self.go = threading.Event()

    def acquire(self, blocking=True, timeout=-1):
        if blocking and threading.current_thread() is self.pause_in:
            self.waiting.set()
            self.go.wait(timeout=WAIT_S)
        return self._lock.acquire(blocking, timeout)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


@pytest.mark.parametrize("entry", ["flush", "dispatch_direct"])
def test_a_barrier_waiting_for_the_dispatch_lock_keeps_submit_order(entry):
    """A caller that flushes (a replication ship, a read barrier, a
    direct batch) while the flusher can also dispatch: lanes go to the
    device in submit order.  The barrier takes the queue only once it
    holds the dispatch lock, so a batch it took cannot be overtaken by
    a later one that the flusher took while the barrier waited for the
    lock.  (The reference takes first and locks after, so the flusher
    can dispatch the later lanes first; ROADMAP C12.  It is not run
    here.)"""
    order = []

    def staged(buf, n):
        order.extend(buf[0, :n].tolist())
        return n

    def listed(slots, lids, permits):
        order.extend(list(slots))
        return len(slots)

    b = MicroBatcher(dispatch={"sw": listed},
                     dispatch_staged={"sw": staged},
                     drain={"sw": lambda h, n: {
                         "allowed": np.ones(n, dtype=bool)}},
                     clear={"sw": lambda slots: None},
                     max_batch=2, max_delay_ms=10_000.0)
    lock = _PausingLock(b._dispatch_lock)
    b._dispatch_lock = lock
    try:
        futs = [b.submit("sw", 0, 0, 1)]
        if entry == "flush":
            barrier = threading.Thread(target=b.flush)
        else:
            barrier = threading.Thread(
                target=b.dispatch_direct, args=("sw", [9], [0], [1]))
        lock.pause_in = barrier
        barrier.start()
        assert lock.waiting.wait(timeout=WAIT_S)
        futs += [b.submit("sw", 1, 0, 1), b.submit("sw", 2, 0, 1)]
        # Two queued lanes meet the size trigger: the flusher dispatches.
        poll(lambda: len(order) >= 2, "the flusher's dispatch")
        lock.go.set()
        barrier.join(timeout=WAIT_S)
        assert not barrier.is_alive()
        b.flush()
        for fut in futs:
            assert outcome(fut) == ("ok", True)
    finally:
        lock.go.set()
        b.close(timeout=1.0)
    queued = [s for s in order if s != 9]
    assert queued == [0, 1, 2], order
    if entry == "dispatch_direct":
        # The direct batch runs after everything queued before it.
        assert order.index(9) > order.index(0), order


# ---------------------------------------------------------------------------
# The storages: sheds at submit, deadlines, the telemetry plane
# ---------------------------------------------------------------------------

def _gated_storage(ref: bool, clock, gate: Gate, **kw):
    now = lambda: clock["t"]  # noqa: E731
    if ref:
        st = TpuBatchedStorage(num_slots=1024, clock_ms=now, host_parallel=0,
                               recorder=RefRecorder(), **kw)
    else:
        st = GpuBatchedStorage(num_slots=1024, clock_ms=now, device="cpu",
                               host_parallel=0, recorder=FlightRecorder(),
                               **kw)
    staged = st._batcher._dispatch_staged
    for algo, fn in list(staged.items()):
        def held(buf, n, fn=fn):
            gate()
            return fn(buf, n)
        staged[algo] = held
    return st


@pytest.mark.parametrize("deadline_ms", [0.0, 500.0])
def test_storage_sheds_and_deadlines_like_reference(deadline_ms):
    """``max_pending=2`` (and a storage-wide queue deadline): sheds raise
    OverloadedError from ``acquire_async`` and count against the lid in
    the telemetry plane; an expired request fails with reason
    ``deadline``.  One queued request opts out of the deadline, so no
    expiry empties the queue (the reference's flusher then spins, see
    ``test_emptied_queue_leaves_the_flusher_idle``)."""
    def scenario(ref):
        gate = Gate()
        clock = {"t": T0}
        st = _gated_storage(ref, clock, gate, max_pending=2,
                            queue_deadline_ms=deadline_ms, max_delay_ms=0.0)
        try:
            cfg = (RefConfig if ref else RateLimitConfig)(
                max_permits=3, window_ms=1_000, refill_rate=1.0)
            lid = st.register_limiter("tb", cfg)
            first = st.acquire_async("tb", lid, "a", 1)
            poll(gate.entered.is_set, "the first dispatch")
            poll(lambda: st._batcher.queue_depth() == 0, "the take")
            queued = [st.acquire_async("tb", lid, "u", 1, deadline_ms=0.0),
                      st.acquire_async("tb", lid, "b", 1)]
            shed = []
            for k in "de":
                try:
                    st.acquire_async("tb", lid, k, 1)
                except (OverloadedError, RefOverloaded) as exc:
                    shed.append((exc.reason, exc.retry_after_ms))
            if deadline_ms:
                poll(lambda: st._batcher.queue_depth() == 1,
                     "the watchdog's expiry")
            mid = counters(st._batcher)
            gate.release.set()
            outs = [outcome(f) for f in [first] + queued]
            return (shed, mid, outs, counters(st._batcher),
                    st.telemetry.tenants_payload(),
                    st.registry.counter("ratelimiter.overload.shed").count(),
                    st.registry.counter(
                        "ratelimiter.overload.deadline_exceeded").count())
        finally:
            gate.release.set()
            st.close()

    require_reference_native()
    ref, port = run_both(scenario)
    assert port == ref
    assert [r for r, _ in ref[0]] == ["queue_full", "queue_full"]
    assert ref[1][1] == (1 if deadline_ms else 0)


# ---------------------------------------------------------------------------
# The service tier: the overload 429 with Retry-After, SHEDDING
# ---------------------------------------------------------------------------

def _get(srv, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=30)
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    body = resp.read()
    out = (resp.status, body,
           {k: v for k, v in resp.getheaders() if k != "Date"})
    conn.close()
    return out


def _serve(ctx, app_module):
    srv = app_module.make_server(ctx, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def test_overload_429_and_shedding_health_like_reference():
    """A real shed through each app: one request wedges in the dispatch,
    two queue (``max_pending=2``), the next is answered 429 Overloaded
    with ``Retry-After``; ``/actuator/health`` reads SHEDDING with the
    batcher's counts; the held requests then answer 200."""
    require_reference_native()

    def scenario(ref):
        gate = Gate()
        clock = {"t": T0}
        st = _gated_storage(ref, clock, gate, max_pending=2,
                            max_delay_ms=0.0)
        props = (RefProps if ref else AppProperties)({"server.port": "0"})
        ctx = (ref_build_app if ref else build_app)(props, storage=st)
        srv, thread = _serve(ctx, ref_app if ref else port_app)
        held = []
        try:
            def fire(user):
                held.append((user, _get(srv, "/api/data",
                                        {"X-User-ID": user})))
            threads = [threading.Thread(target=fire, args=("u0",))]
            threads[0].start()
            poll(gate.entered.is_set, "the first dispatch")
            poll(lambda: st._batcher.queue_depth() == 0, "the take")
            for user in ("u1", "u2"):
                threads.append(threading.Thread(target=fire, args=(user,)))
                threads[-1].start()
            poll(lambda: st._batcher.queue_depth() == 2, "two queued")
            shed = _get(srv, "/api/data", {"X-User-ID": "u3"})
            health = _get(srv, "/actuator/health")
            gate.release.set()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
            meters = json.loads(_get(srv, "/actuator/metrics")[1])["meters"]
            # The reference's health read registers its TPU kernel's
            # fallback gauge; the port has no such probe.
            meters.pop("ratelimiter.pallas.fused_fallback", None)
            health_json = json.loads(health[1])
            health_json.pop("pallas", None)
            return (shed, health[0], health_json,
                    sorted((u, r[0]) for u, r in held), meters)
        finally:
            gate.release.set()
            srv.shutdown()
            thread.join(timeout=5)
            ctx.close()

    ref, port = run_both(scenario)
    assert port == ref
    status, body, headers = ref[0]
    assert status == 429 and headers["Retry-After"] == "1"
    assert json.loads(body) == {
        "error": "Overloaded",
        "message": "Server is shedding load. Please retry later.",
        "reason": "queue_full"}
    assert ref[2]["status"] == "SHEDDING"
    assert ref[2]["overload"]["shed_total"] == 1
    assert ref[3] == [("u0", 200), ("u1", 200), ("u2", 200)]


class _StubBatcher:
    max_pending = 8
    shed_total = 3
    deadline_total = 1

    def __init__(self, last_shed_s):
        self.last_shed_s = last_shed_s

    def queue_depth(self):
        return 8


@pytest.mark.parametrize("age_s", [0.0, 3600.0])
def test_health_shedding_window_like_reference(age_s):
    """A shed inside the health window reads SHEDDING; outside it, UP."""
    require_reference_native()

    def scenario(ref):
        clock = {"t": T0}
        st = _gated_storage(ref, clock, Gate(hold=False))
        props = (RefProps if ref else AppProperties)({"server.port": "0"})
        ctx = (ref_build_app if ref else build_app)(props, storage=st)
        try:
            real = st._batcher
            st._batcher = _StubBatcher(time.monotonic() - age_s)
            payload = (ref_app if ref else port_app).health_payload(ctx)
            st._batcher = real
            payload.pop("pallas", None)
            return payload
        finally:
            ctx.close()

    ref, port = run_both(scenario)
    assert port == ref
    assert ref["status"] == ("SHEDDING" if age_s == 0.0 else "UP")
