"""The port's profiler context (``utils/tracing.py:device_profile``) on the
CPU.

- ``device_profile(None)`` does nothing and yields None, as the
  reference's;
- with a directory it writes one Chrome trace there, and its summary says
  the trace holds no device time (this build traces the CPU only);
- the summary's reading of a trace with device events (a written trace of
  the shape the CUDA profiler exports): device time summed and as a
  union, the idle share, the port's kernels by launch counter, their
  streams and launching threads.
"""

import json
import os

import numpy as np
import torch

from ratelimiter_tpu_torch.utils.tracing import (
    PORT_KERNELS,
    DeviceProfile,
    device_profile,
)

torch.set_num_threads(1)


def test_none_does_nothing(tmp_path):
    with device_profile(None) as prof:
        np.arange(10).sum()
    assert prof is None
    with device_profile("") as prof:
        pass
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_directory_gets_a_trace_without_device_time(tmp_path):
    log_dir = tmp_path / "prof"
    with device_profile(str(log_dir)) as prof:
        x = torch.arange(4096, dtype=torch.float32)
        (x * 2).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert prof.trace_path == str(log_dir / files[0])
    with open(prof.trace_path) as f:
        assert json.load(f)["traceEvents"]
    s = prof.summary()
    assert s["trace_events"] > 0
    assert s["device_events"] == 0 and s["device_us"] == 0.0
    assert s["holds_device_time"] is False and s["idle_share"] is None
    assert s["port_kernels"] == {} and s["wall_s"] > 0
    assert prof.describe().startswith("no device time recorded")


def test_summary_reads_device_events(tmp_path):
    def kernel(name, ts, dur, stream, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": f"stream {stream}", "ts": ts, "dur": dur,
                "args": {"device": 0, "stream": stream,
                         "correlation": corr}}

    def launch(tid, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 1, "tid": tid, "ts": 0, "dur": 1,
                "args": {"correlation": corr}}

    events = [
        kernel("void (anonymous namespace)::tb_relay_kernel<unsigned char>"
               "(int*, long, unsigned int const*)", 100, 10, 7, 1),
        kernel("void solve_segments_kernel(long const*)", 105, 10, 13, 2),
        kernel("scatter_rows_kernel", 300, 5, 7, 3),
        kernel("void at::native::elementwise_kernel<128, 4>", 400, 10, 7, 4),
        kernel("(anonymous namespace)::fill_kernel", 410, 10, 7, 4),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0,
         "tid": "stream 7", "ts": 500, "dur": 50, "args": {"stream": 7}},
        launch(111, 1), launch(222, 2), launch(111, 3), launch(111, 4),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
         "tid": 111, "ts": 0, "dur": 3},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    prof = DeviceProfile(("CPU", "CUDA"), str(path), 0.001)
    s = prof.summary()
    assert s["device_events"] == 6 and s["device_us"] == 95.0
    assert s["busy_us"] == 90.0  # the first two kernels overlap by 5 us
    assert abs(s["idle_share"] - (1 - 90e-6 / 0.001)) < 1e-12
    assert s["port_kernels"] == {"relay_step": 1, "solver": 1,
                                 "block_scatter": 1}
    assert s["port_kernel_us"] == {"relay_step": 10.0, "solver": 10.0,
                                   "block_scatter": 5.0}
    assert s["top"][0] == ("Memcpy DtoH", 50.0)
    assert s["streams"] == {"7": 2, "13": 1}
    assert s["threads"] == {"111": 2, "222": 1}
    assert s["holds_device_time"] is True
    assert ("port kernels block_scatter 1 (0.0050 ms), relay_step 1 "
            "(0.0100 ms), solver 1 (0.0100 ms) on streams ['13', '7']"
            in prof.describe())
    assert set(PORT_KERNELS.values()) == {
        "solver", "tb_writeback", "sw_writeback", "block_scatter",
        "relay_step"}
