"""Each metric's reader computes its ratio from a fixture: stream
records as ``GpuBatchedStorage.stream_stats`` writes them, a Chrome
trace as the profiler exports it, latencies and launch counters."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.lib import roofline, spec, trace

RECORDS = [
    {"path": "relay", "n": 1000, "u": 400, "mode": "digest",
     "assign_s": 0.0002, "host_s": 0.00005, "fetch_s": 0.0001},
    {"path": "relay", "n": 3000, "u": 600, "mode": "digest",
     "assign_s": 0.0006, "host_s": 0.00015, "fetch_s": 0.0001},
]
SHARDED = [
    {"path": "relay_sharded", "n": 2000, "u": 900, "mode": "digest",
     "assign_s": 0.0001, "host_s": 0.0003, "route_s": 0.00004,
     "fetch_s": 0.0},
]


def chrome_trace(path):
    """A traced part of 1000 us on two cards: card 0 busy 100 us (a relay
    kernel of 40 us inside a copy of 100 us), card 1 busy 50 us."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.MARK,
         "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 1100, "dur": 100, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel",
         "name": "void (anonymous namespace)::sw_relay_kernel<unsigned "
                 "char>(int*, long)", "ts": 1150, "dur": 40,
         "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "void other_kernel()",
         "ts": 1500, "dur": 50, "args": {"device": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1300,
         "dur": 400},
        {"ph": "X", "cat": "kernel", "name": "outside the part",
         "ts": 5000, "dur": 10, "args": {"device": 0}},
    ]
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.summarize(str(path), 0.001)


def run_of(kind, chips=1, memory_peak_bytes=0, **window):
    w = SimpleNamespace(records=None, traced_records=None, trace=None,
                        launches=None, latencies_s=None, seconds=2.0,
                        completed=0, attempted=0)
    w.__dict__.update(window)
    return SimpleNamespace(kind=kind, algo="sw", chips=chips, setup_s=12.5,
                           window=w, memory_peak_bytes=memory_peak_bytes)


def read(name, run):
    return spec.reader(name)(run)


def test_trace_summary(tmp_path):
    s = chrome_trace(tmp_path / "t.json")
    assert s["window_us"] == 1000
    assert s["busy_us"] == {"0": 100.0, "1": 50.0}
    assert s["kernel_us"] == {"relay_step": 40.0}
    assert s["device_ops"][0] == ["Memcpy HtoD", 100 / 1e6]
    # Card 0's idle 900 us: 100 before the copy, then the copy of
    # 400 us on the host over the gap's middle, and the rest.
    assert sum(x for _, x in s["idle_gaps"]) == pytest.approx(900 / 1e6)
    assert s["idle_gaps"][0][0] == "aten::copy_"


def test_walk_host_and_route(tmp_path):
    run = run_of("stream", records=RECORDS)
    assert read("walk_ns_per_request.stream", run) == pytest.approx(
        0.0008 / 4000 * 1e9)
    assert read("host_ns_per_request.stream", run) == pytest.approx(
        0.0002 / 4000 * 1e9)
    assert read("route_ns_per_request.stream", run) is None
    run = run_of("stream", records=SHARDED + RECORDS)
    assert read("route_ns_per_request.stream", run) == pytest.approx(
        0.00004 / 2000 * 1e9)
    assert read("walk_ns_per_request.stream", run_of("requests")) is None


def test_relay_roofline(tmp_path):
    tr = chrome_trace(tmp_path / "t.json")
    run = run_of("stream", trace=tr, traced_records=RECORDS)
    need = roofline.relay_step_bytes(400, "sw") + roofline.relay_step_bytes(
        600, "sw")
    assert need == 1000 * (5 + 8 * 6)
    assert read("relay_step_roofline", run) == pytest.approx(
        100 * need / roofline.HBM_BYTES_PER_S / 40e-6)
    words = [dict(RECORDS[0], mode="bits")] + RECORDS[1:]
    assert read("relay_step_roofline",
                run_of("stream", trace=tr, traced_records=words)) is None
    no_kernel = dict(tr, kernel_us={})
    assert read("relay_step_roofline", run_of(
        "stream", trace=no_kernel, traced_records=RECORDS)) is None


def test_idle_shares(tmp_path):
    tr = chrome_trace(tmp_path / "t.json")
    two = run_of("stream", chips=2, trace=tr)
    assert read("device_idle_share.stream", two) == pytest.approx(
        100 * (1 - 75 / 1000))
    assert read("device_idle_share.requests", two) is None
    req = run_of("requests", chips=2, trace=tr)
    assert read("device_idle_share.requests", req) == pytest.approx(92.5)
    empty = dict(tr, busy_us={})
    assert read("device_idle_share.stream",
                run_of("stream", trace=empty)) is None


def test_request_metrics():
    lat = np.arange(1, 201) / 1000.0  # 1..200 ms
    run = run_of("requests", latencies_s=lat, attempted=400, completed=390,
                 launches={"sw_writeback": 40, "tb_writeback": 0,
                           "solver": 40})
    assert read("request_p99_ms.requests", run) == pytest.approx(199.0)
    assert read("requests_per_step.requests", run) == pytest.approx(10.0)
    assert read("request_decisions_per_s", run) == pytest.approx(195.0)
    off_card = run_of("requests", latencies_s=lat, attempted=400,
                      launches={"sw_writeback": 0, "tb_writeback": 0})
    assert read("requests_per_step.requests", off_card) is None


def test_end_to_end_readers():
    run = run_of("stream", completed=8_000_000)
    assert read("stream_decisions_per_s", run) == pytest.approx(4e6)
    assert read("decisions_per_s.stream", run) == pytest.approx(4e6)
    assert read("decisions_per_s.stream", run_of("requests")) is None
    assert read("device_memory_peak_mb", run) is None
    on_card = run_of("stream", memory_peak_bytes=109_601_280)
    assert read("device_memory_peak_mb", on_card) == pytest.approx(109.60128)
    assert read("request_decisions_per_s", run) is None
    assert read("setup_s", run) == 12.5
