"""Peaks of the card and the least time of the relay step's work.

``HBM_BYTES_PER_S`` and :func:`bound_s` are frozen copies of
``chip_smoke.py``'s ``HBM_BYTES_PER_S`` and ``bound_ms`` (bytes term) at
commit 6150e04, and :func:`relay_step_bytes` of its byte count for the
relay step (``chip_smoke.py:1415``): each live lane's word read (4
bytes) and its count written (1 byte), and each live lane's state row
read and written, at 4 bytes a column (4 columns for the token bucket,
6 for the sliding window).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: device memory bandwidth, bytes/s.
HBM_BYTES_PER_S = 3.35e12
ROW_COLUMNS = {"tb": 4, "sw": 6}


def relay_step_bytes(live_lanes: int, algo: str) -> int:
    return live_lanes * 5 + live_lanes * 8 * ROW_COLUMNS[algo]


def bound_s(nbytes: float) -> float:
    """The least time of moving ``nbytes`` through device memory."""
    return nbytes / HBM_BYTES_PER_S
