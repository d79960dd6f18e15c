"""Decision tracing (counterpart of ``ratelimiter_tpu/utils/tracing.py``).

``DecisionTrace`` is a lock-protected ring buffer of per-dispatch records
(wall time, algo, batch size, allowed count, dispatch latency, route),
cheap enough to leave on; the storage feeds it from every drained micro
batch and stream chunk (``GpuBatchedStorage.trace``), and the
request-lifecycle tracer (``observability/trace.py``) adds 1-in-N sampled
micro traces carrying their stage breakdown (``stages_us``) and, with
lineage sampling, their trace id (``trace``).

``device_profile`` is the reference's profiler context on the card: a
``torch.profiler`` session with CPU and CUDA activity around a block,
written as a Chrome trace into a directory, with a summary read from that
trace (:class:`DeviceProfile`): the device time it holds, the port's
kernels in it, and the threads and streams they came from.  It records
every thread where the installed torch can, so its traces hold the spans
of the assign and drain pools too.

``span`` is the port's one span primitive: a ``record_function`` range
on the profiler's own clock while a profiler runs, and a shared no-op
context otherwise.  Every span name is a constant of :data:`SPANS`.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

# The port's spans, ``rl.<layer>.<stage>``.  A name is never formatted at
# run time: the benchmark sums a trace's idle gaps by span name.
# On the calling thread (the limiters' entries; in ``_run_chunks`` the
# first chunk's assign, the wait on a prefetched one, the dispatch window
# that ``host_s`` times and the wait on a pass's drains):
LIMITER_TRY_ACQUIRE_MANY = "rl.limiter.try_acquire_many"
LIMITER_TRY_ACQUIRE_STREAM_IDS = "rl.limiter.try_acquire_stream_ids"
STREAM_ASSIGN = "rl.stream.assign"
STREAM_ASSIGN_WAIT = "rl.stream.assign_wait"
STREAM_DISPATCH = "rl.stream.dispatch"
STREAM_DRAIN_WAIT = "rl.stream.drain_wait"
# Wherever the work runs, mostly the assign and drain pools' threads: the
# string hashing, the slice and packing inside it, one chunk's drain.
INDEX_HASH = "rl.index.hash"
INDEX_KEY_PACK = "rl.index.key_pack"
STREAM_DRAIN = "rl.stream.drain"
SPANS = (
    LIMITER_TRY_ACQUIRE_MANY, LIMITER_TRY_ACQUIRE_STREAM_IDS,
    STREAM_ASSIGN, STREAM_ASSIGN_WAIT, STREAM_DISPATCH, STREAM_DRAIN_WAIT,
    INDEX_HASH, INDEX_KEY_PACK, STREAM_DRAIN,
)

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context over a stage of the port, named by a constant of
    :data:`SPANS`: ``torch.profiler.record_function(name)`` while a
    profiler runs in the process, so the range lies on the profiler's
    clock with the device events; else one shared no-op context, so with
    no profiler a span costs a flag read and the call (0.33 us on the
    H100 machine's host).  A span keeps no clock or buffer of its own: the
    counters beside it are the stream records'."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


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


# The port's CUDA kernels (``ops/cuda/*.cu``) by the launch counter of the
# wrapper that launches them.
PORT_KERNELS = {
    "solve_segments_kernel": "solver",
    "tb_writeback_kernel": "tb_writeback",
    "sw_writeback_kernel": "sw_writeback",
    "scatter_rows_kernel": "block_scatter",
    "tb_relay_kernel": "relay_step",
    "sw_relay_kernel": "relay_step",
}
# Chrome-trace categories of work on the card, and of the host calls that
# launch it (their correlation ids tie a kernel to its launching thread).
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _kernel_counter(name: str) -> Optional[str]:
    """The launch counter of a device event's kernel name, as the trace
    demangles it (``void (anonymous namespace)::tb_relay_kernel<unsigned
    char>(int*, ...)``); None for other kernels."""
    words = (name.replace("(anonymous namespace)::", "").split("(")[0]
             .split("<")[0].split())
    return PORT_KERNELS.get(words[-1].split("::")[-1]) if words else None


class DeviceProfile:
    """One profiled block: its ``activities``, the Chrome trace it wrote
    (``trace_path``), its wall time (``wall_s``, the card synchronised
    before the clock stops) and :meth:`summary`, read from the trace."""

    def __init__(self, activities: tuple, trace_path: Optional[str] = None,
                 wall_s: Optional[float] = None):
        self.activities = activities
        self.trace_path = trace_path
        self.wall_s = wall_s
        self.caller_thread = threading.get_native_id()
        self._summary: Optional[dict] = None

    def summary(self) -> dict:
        """What the trace holds: ``device_us`` (the device events'
        durations summed: kernels, copies, sets), ``busy_us`` (their union
        on the card's clock) and ``idle_share`` (1 - busy / wall; None
        without device time), the ``device_events``, the trace's events
        by ``categories``, ``port_kernels`` and ``port_kernel_us``
        (launches and device time by wrapper counter), the ``top`` three
        device events by summed time (name, us), the ``streams`` and host
        ``threads`` the port's kernels came from (launches per native
        thread id, "None" where the trace ties a kernel to no launch
        call), the ``caller_thread`` and ``holds_device_time``.  A trace
        without device time says so here: it is not an idle card."""
        if self._summary is not None:
            return self._summary
        if self.trace_path is None:
            raise RuntimeError("the profile is still running")
        with open(self.trace_path) as f:
            events = json.load(f).get("traceEvents", [])
        launch_tid = {}
        cats: Dict[str, int] = {}
        for ev in events:
            cat = str(ev.get("cat"))
            cats[cat] = cats.get(cat, 0) + 1
            if ev.get("ph") == "X" and ev.get("cat") in _LAUNCH_CATS:
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_tid[corr] = ev.get("tid")
        device_us = 0.0
        spans = []
        port: Dict[str, int] = {}
        port_us: Dict[str, float] = {}
        by_name: Dict[str, float] = {}
        streams: Dict[str, int] = {}
        threads: Dict[str, int] = {}
        n_dev = 0
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") not in _DEVICE_CATS:
                continue
            n_dev += 1
            dur = float(ev.get("dur", 0.0))
            ts = float(ev.get("ts", 0.0))
            device_us += dur
            spans.append((ts, ts + dur))
            name = ev.get("name", "")
            by_name[name] = by_name.get(name, 0.0) + dur
            counter = (_kernel_counter(name)
                       if ev.get("cat") == "kernel" else None)
            if counter is None:
                continue
            args = ev.get("args") or {}
            port[counter] = port.get(counter, 0) + 1
            port_us[counter] = port_us.get(counter, 0.0) + dur
            stream = str(args.get("stream", ev.get("tid")))
            streams[stream] = streams.get(stream, 0) + 1
            tid = str(launch_tid.get(args.get("correlation")))
            threads[tid] = threads.get(tid, 0) + 1
        busy_us = 0.0
        end = None
        for a, b in sorted(spans):
            if end is None or a > end:
                busy_us += b - a
                end = b
            elif b > end:
                busy_us += b - end
                end = b
        wall = self.wall_s or 0.0
        self._summary = {
            "trace": self.trace_path,
            "activities": list(self.activities),
            "wall_s": wall,
            "trace_events": len(events),
            "categories": cats,
            "device_events": n_dev,
            "device_us": device_us,
            "busy_us": busy_us,
            "idle_share": (1.0 - busy_us / 1e6 / wall
                           if wall > 0 and busy_us > 0 else None),
            "holds_device_time": device_us > 0,
            "port_kernels": port,
            "port_kernel_us": port_us,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:3],
            "streams": streams,
            "threads": threads,
            "caller_thread": str(self.caller_thread),
        }
        return self._summary

    def describe(self) -> str:
        """One line of :meth:`summary`."""
        s = self.summary()
        if not s["holds_device_time"]:
            return (f"no device time recorded ({s['trace_events']} trace "
                    f"events {s['categories']}, activities "
                    f"{', '.join(s['activities'])}; {s['trace']})")
        kernels = ", ".join(
            f"{k} {v} ({s['port_kernel_us'][k] / 1e3:.4f} ms)"
            for k, v in sorted(s["port_kernels"].items())) or "none"
        top = "; ".join(f"{n[:60]} {us / 1e3:.4f} ms" for n, us in s["top"])
        return (f"device time {s['device_us'] / 1e3:.4f} ms "
                f"({s['busy_us'] / 1e3:.4f} ms busy) in {s['wall_s']:.4f} s, "
                f"idle share {s['idle_share']:.6f}; {s['device_events']} "
                f"device events; port kernels {kernels} on streams "
                f"{sorted(s['streams'])} from threads {s['threads']} "
                f"(caller {s['caller_thread']}); top: {top}")


def all_threads_config():
    """The profiler's experimental config that records every thread
    (``profile_all_threads``), or None where the installed torch has no
    such setting: then a profile records the thread that started it
    only."""
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def device_profile(log_dir: Optional[str]):
    """Profile the block into ``log_dir`` (no-op when None, yielding
    None): ``torch.profiler`` with CPU activity and, where there is a card
    and the build traces it, CUDA activity, exported as a Chrome trace
    (``device_profile-<pid>-<ns>.pt.trace.json``).  Where the installed
    torch can (:func:`all_threads_config`), it records every thread's
    host events, so the trace holds the worker threads' spans (the string
    hashing, the drains) beside the calling thread's.  Yields a
    :class:`DeviceProfile` whose summary is readable after the block;
    with CUDA activity the block's queued work is synchronised before the
    profiler stops.

    Once a process has run for minutes, CUPTI's device timestamps can
    stray from the host clock, and the profiler then leaves out of the
    trace the device events that fall outside its window: a short pass's
    trace can hold its launch calls and no device event.  The summary
    says so (``holds_device_time``); a trace that must hold device time
    is taken in a fresh process."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities

    os.makedirs(log_dir, exist_ok=True)
    device = (torch.cuda.is_available()
              and ProfilerActivity.CUDA in supported_activities())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device
                                     else [])
    handle = DeviceProfile(tuple(a.name for a in acts))
    config = all_threads_config()
    kwargs = {} if config is None else {"experimental_config": config}
    with profile(activities=acts, **kwargs) as prof:
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            if device:
                torch.cuda.synchronize()
            handle.wall_s = time.perf_counter() - t0
    path = os.path.join(log_dir, f"device_profile-{os.getpid()}-"
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    handle.trace_path = path
