"""Row scatter: the CUDA kernel (``block_scatter.cu``) wrapper.

Counterpart of ``ratelimiter_tpu/ops/pallas/block_scatter.py``.  The plain
version and the choice between the two live in ``ops/scatter.py``: a CPU
tensor takes the plain ``index_put_`` form, a CUDA tensor this kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ratelimiter_tpu_torch.ops.cuda import build

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0
_count_lock = threading.Lock()
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("block_scatter").rl_scatter_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def scatter_rows(state: torch.Tensor, slots: torch.Tensor,
                 write_mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """In place: ``state[slots[j]] = rows[j]`` for each lane with
    ``write_mask[j]`` and a slot inside the table, on the current CUDA
    stream.  ``state``: int32[S, L]; ``slots``: int64[B]; ``write_mask``:
    bool[B]; ``rows``: int32[B, L].  Returns ``state``."""
    build.require(state, "state", torch.int32, 2)
    build.require(slots, "slots", torch.int64, 1, state.device)
    build.require(write_mask, "write_mask", torch.bool, 1, state.device)
    build.require(rows, "rows", torch.int32, 2, state.device)
    n, lanes = rows.shape
    if slots.shape[0] != n or write_mask.shape[0] != n \
            or lanes != state.shape[1]:
        raise ValueError(
            f"scatter: shapes do not agree (state {tuple(state.shape)}, "
            f"slots {tuple(slots.shape)}, mask {tuple(write_mask.shape)}, "
            f"rows {tuple(rows.shape)})")
    if n:
        err = _kernel()(state.data_ptr(), state.shape[0], lanes,
                        slots.data_ptr(), write_mask.data_ptr(),
                        rows.data_ptr(), n,
                        torch.cuda.current_stream(state.device).cuda_stream)
        if err:
            raise RuntimeError(f"scatter kernel launch failed: CUDA error "
                               f"{err}")
        global launches
        with _count_lock:
            launches += 1
    return state
