"""Segmented solver: the CUDA kernel (``solver.cu``) and its dispatch.

Counterpart of ``ratelimiter_tpu/ops/pallas/solver.py``.  The plain
version is ``ops/segments.py:solve_threshold_recurrence``; it serves a
tensor on the CPU and nothing else.  A CUDA tensor launches the kernel or
raises: there is no fallback and no election.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ratelimiter_tpu_torch.ops import segments
from ratelimiter_tpu_torch.ops.cuda import build

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0
_count_lock = threading.Lock()
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("solver").rl_solve_segments
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def solve_cuda(u: torch.Tensor, w: torch.Tensor,
               first: torch.Tensor) -> torch.Tensor:
    """Launch the solver on the current CUDA stream; returns ``inc``
    (int64, a new tensor).  ``u``, ``w``: int64[n]; ``first``: bool[n]."""
    build.require(u, "u", torch.int64, 1)
    build.require(w, "w", torch.int64, 1, u.device)
    build.require(first, "first", torch.bool, 1, u.device)
    n = u.shape[0]
    if w.shape[0] != n or first.shape[0] != n:
        raise ValueError(f"solver: lane counts differ (u {n}, w "
                         f"{w.shape[0]}, first {first.shape[0]})")
    inc = torch.empty_like(u)
    if n:
        err = _kernel()(u.data_ptr(), w.data_ptr(), first.data_ptr(),
                        inc.data_ptr(), n,
                        torch.cuda.current_stream(u.device).cuda_stream)
        if err:
            raise RuntimeError(f"solver kernel launch failed: CUDA error "
                               f"{err}")
        global launches
        with _count_lock:
            launches += 1
    return inc


def solve_threshold_recurrence_auto(u: torch.Tensor, w: torch.Tensor,
                                    first: torch.Tensor) -> torch.Tensor:
    """The steps' solver entry: the plain version for a CPU tensor, the
    kernel for a CUDA tensor (int64 throughout, no shift: Hopper computes
    the recurrence natively in int64)."""
    if u.device.type == "cpu":
        return segments.solve_threshold_recurrence(u, w, first)
    return solve_cuda(u, w, first)
