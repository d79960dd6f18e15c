"""Host <-> device link probe (counterpart of
``ratelimiter_tpu/utils/link.py``).

One measurement for ``GpuBatchedStorage.probe_link`` and any caller that
logs the link: the reference's probe sizes (a 4 MiB upload and download),
repetition counts and arithmetic, on an explicit device.

- The round trip: a tiny tensor's sum read back with ``.item()``.
- The upload: the 4 MiB host buffer goes to the device the way the stream
  loops upload their lanes (``torch.from_numpy(...).to(device,
  non_blocking=True)`` from pageable memory,
  ``engine/engine.py:DeviceEngine._upload``), then its sum is read back;
  the round trip is taken off.
- The download: distinct device tensors, each fetched once.

The first shape of each is run untimed.  Each time is clamped at 1e-6 s,
as the reference clamps it.  Nothing is caught: a failing probe raises.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

PROBE_BYTES = 4 << 20  # 4 MiB upload and download probes


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device, non_blocking=True)


def _fetch_sum(t: torch.Tensor) -> int:
    return int(t.sum().item())


def measure_link(device=None, rtt_reps: int = 3, upload_reps: int = 2
                 ) -> Tuple[float, float, float]:
    """(upload bytes/s, round-trip seconds, download bytes/s) between the
    host and ``device`` (``None``: the card, ``cuda``).  The two
    directions are probed apart, as the reference probes them: the
    words-or-digest election trades upload bytes against download
    bytes."""
    dev = torch.device("cuda" if device is None else device)
    tiny = np.zeros(1024, dtype=np.int32)
    _fetch_sum(_upload(tiny, dev))  # settle
    t0 = time.perf_counter()
    for _ in range(rtt_reps):
        _fetch_sum(_upload(tiny, dev))
    rtt_s = (time.perf_counter() - t0) / rtt_reps
    buf = np.random.default_rng(7).integers(
        0, 1 << 20, PROBE_BYTES // 4).astype(np.int32)
    _fetch_sum(_upload(buf, dev))  # this shape untimed
    t0 = time.perf_counter()
    for _ in range(upload_reps):
        _fetch_sum(_upload(buf, dev))
    up_s = max((time.perf_counter() - t0) / upload_reps - rtt_s, 1e-6)
    # Download: distinct 4 MiB tensors made on the device (no upload in
    # the timed window), each fetched once.
    handles = [torch.full((PROBE_BYTES // 4,), i, dtype=torch.int32,
                          device=dev) for i in range(upload_reps + 1)]
    handles[0].cpu().numpy()  # settle: every fill is queued before it
    t0 = time.perf_counter()
    for h in handles[1:]:
        h.cpu().numpy()
    down_s = max((time.perf_counter() - t0) / upload_reps - rtt_s, 1e-6)
    return PROBE_BYTES / up_s, rtt_s, PROBE_BYTES / down_s
