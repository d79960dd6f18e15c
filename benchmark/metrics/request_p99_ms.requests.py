"""``request_p99_ms.requests``: the 99th percentile of every request's
latency in the window (sent to returned, on the benchmark's clock), in
ms, picked by index as ``ratelimiter_tpu_torch/bench/harness.py:_pcts``
picks it."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    if run.kind != "requests" or lat is None or len(lat) == 0:
        return None
    lat = np.sort(lat)
    return float(lat[min(len(lat) - 1, int(0.99 * len(lat)))]) * 1e3
