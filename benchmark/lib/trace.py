"""The device trace of a run's traced part, and what it holds.

The profiler session and the arithmetic of the summary are frozen copies
of ``DeviceProfile`` / ``device_profile`` in
``ratelimiter_tpu_torch/utils/tracing.py`` at commit 6150e04: device
events are the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events, a device's busy time is the union of its events on the card's
clock, and a kernel is named by the launch counter of the wrapper that
launches it.  Added here: busy time per device inside the traced
block's own span (a ``benchmark.traced`` annotation), the top device
operations, and the idle gaps by the innermost host event that spans
each gap's middle.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

PORT_KERNELS = {
    "solve_segments_kernel": "solver",
    "tb_writeback_kernel": "tb_writeback",
    "sw_writeback_kernel": "sw_writeback",
    "scatter_rows_kernel": "block_scatter",
    "tb_relay_kernel": "relay_step",
    "sw_relay_kernel": "relay_step",
}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
              "user_annotation")
MARK = "benchmark.traced"
# Longest name kept of a device operation or a host event.
NAME_CHARS = 120
# Idle gaps labelled one by one; the shorter ones are summed unlabelled.
LABELLED_GAPS = 200


def kernel_counter(name: str) -> Optional[str]:
    """The launch counter of a device event's kernel name, as the trace
    demangles it; None for other kernels."""
    words = (name.replace("(anonymous namespace)::", "").split("(")[0]
             .split("<")[0].split())
    return PORT_KERNELS.get(words[-1].split("::")[-1]) if words else None


def union_us(spans) -> float:
    busy = 0.0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


class Session:
    """One traced part of a window: :meth:`start` and :meth:`stop` the
    profiler (CPU and, with a card, CUDA activity; the devices
    synchronised before it stops) around it, and after the window
    :meth:`summary` writes the Chrome trace under ``TMPDIR``, reads it
    (:func:`summarize`) and deletes it."""

    def __init__(self, devices: List[int]):
        self.devices = devices
        self._prof = None
        self._mark = None
        self._t0 = 0.0
        self.wall_s = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        for d in self.devices:
            torch.cuda.synchronize(d)
        self.wall_s = time.perf_counter() - self._t0
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def summary(self) -> dict:
        out = tempfile.mkdtemp(prefix="benchmark-trace-")
        try:
            path = os.path.join(out, "trace.json")
            self._prof.export_chrome_trace(path)
            return summarize(path, self.wall_s)
        finally:
            shutil.rmtree(out, ignore_errors=True)
            self._prof = None


def prime(devices: List[int]) -> None:
    """Start and stop the profiler once, in set-up: its first start in a
    process loads and initialises the tracing library, which takes
    seconds and holds up the other threads' CUDA calls, and must not
    fall in the window."""
    s = Session(devices)
    s.start()
    s.stop()
    s._prof = None


def summarize(path: str, wall_s: float) -> dict:
    """What the trace holds inside the traced block's span: ``window_us``,
    ``busy_us`` by device, device time by port kernel counter
    (``kernel_us``), ``device_ops`` (the ten device
    operations with the most time, seconds) and ``idle_gaps`` (idle
    seconds of the first device by the innermost host event over each
    gap's middle, the ten largest)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    mark = [ev for ev in events
            if ev.get("ph") == "X" and ev.get("name") == MARK]
    if mark:
        w0 = float(mark[0]["ts"])
        w1 = w0 + float(mark[0].get("dur", 0.0))
    else:
        w0 = min((float(ev["ts"]) for ev in events if "ts" in ev),
                 default=0.0)
        w1 = w0 + wall_s * 1e6
    spans: Dict[str, list] = {}
    kernel_us: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    host = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
        if cat in _HOST_CATS and ev.get("name") != MARK:
            host.append((ts, ts + dur, ev.get("name", "")))
            continue
        if cat not in _DEVICE_CATS:
            continue
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        args = ev.get("args") or {}
        dev = str(args.get("device", ev.get("pid")))
        spans.setdefault(dev, []).append((a, b))
        name = ev.get("name", "")
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        counter = kernel_counter(name) if cat == "kernel" else None
        if counter is not None:
            kernel_us[counter] = kernel_us.get(counter, 0.0) + dur
    busy = {d: union_us(s) for d, s in spans.items()}
    gaps = _gaps(spans[sorted(spans)[0]] if spans else [], w0, w1)
    idle: Dict[str, float] = {}
    host.sort()
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:LABELLED_GAPS]:
        label = _gap_label(a, b, starts, ends, host)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    rest = sum(b - a for a, b in gaps[LABELLED_GAPS:]) / 1e6
    if rest > 0:
        idle[f"gaps shorter than the {LABELLED_GAPS} longest"] = rest
    return {
        "window_us": w1 - w0,
        "wall_s": wall_s,
        "busy_us": busy,
        "kernel_us": kernel_us,
        "device_ops": [[n[:NAME_CHARS], us / 1e6] for n, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n[:NAME_CHARS], s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def _gap_label(a: float, b: float, starts, ends, host) -> str:
    """What the host was doing in the idle gap [a, b]: the innermost
    traced host event over its middle, else the first host event that
    starts inside it (the host's untraced work led up to that call)."""
    mid = (a + b) / 2
    over = np.flatnonzero((starts <= mid) & (ends >= mid))
    if len(over):
        return host[int(over[np.argmin(ends[over] - starts[over])])][2]
    k = int(np.searchsorted(starts, a))
    if k < len(host) and starts[k] <= b:
        return f"untraced host work, then {host[k][2]}"
    return "no traced host event"


def _gaps(spans, w0: float, w1: float):
    """The idle intervals of one device inside [w0, w1]."""
    out = []
    end = w0
    for a, b in sorted(spans):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if w1 > end:
        out.append((end, w1))
    return out
