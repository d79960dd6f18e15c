"""Step write-back and row scatter: the CUDA kernels' (``block_scatter.cu``)
wrappers.

Counterpart of ``ratelimiter_tpu/ops/pallas/block_scatter.py`` and of the
XLA epilogue that fed it in the steps.  The plain versions and the choice
between them and these kernels live beside their callers: a CPU tensor
takes ``ops/token_bucket.py:tb_writeback_plain``,
``ops/sliding_window.py:sw_writeback_plain`` or
``ops/scatter.py:scatter_rows_plain``; a CUDA tensor one of these kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ratelimiter_tpu_torch.ops.cuda import build

#: Launches of each kernel since import (or since a caller last reset them
#: to 0): the row scatter, the token-bucket and the sliding-window
#: write-back.
launches = 0
tb_writeback_launches = 0
sw_writeback_launches = 0
_count_lock = threading.Lock()
_fns = {}

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    "rl_scatter_rows": [_P, _I64, _INT, _P, _P, _P, _I64, _P],
    "rl_tb_writeback": [_P, _I64] + [_P] * 7 + [_I64, _P],
    "rl_sw_writeback": [_P, _I64] + [_P] * 8 + [_INT, _P, _INT, _P, _I64,
                                                _P],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("block_scatter"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, state: torch.Tensor, *args) -> None:
    err = _kernel(name)(*args,
                        torch.cuda.current_stream(state.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


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
        _launch("rl_scatter_rows", state, state.data_ptr(), state.shape[0],
                lanes, slots.data_ptr(), write_mask.data_ptr(),
                rows.data_ptr(), n)
        global launches
        with _count_lock:
            launches += 1
    return state


def _require_state(state: torch.Tensor, lanes: int) -> None:
    build.require(state, "state", torch.int32, 2)
    if state.shape[1] != lanes:
        raise ValueError(f"state: expected {lanes} lanes a row, got "
                         f"{tuple(state.shape)}")
    if state.data_ptr() % 16:
        raise ValueError("state: must start on a 16-byte boundary")


def _require_lanes(state: torch.Tensor, n: int, **columns) -> None:
    for name, t in columns.items():
        build.require(t, name, torch.int64, 1, state.device)
        if t.shape[0] != n:
            raise ValueError(f"{name}: {t.shape[0]} lanes, expected {n}")


def _per_lane_or_one(state: torch.Tensor, t: torch.Tensor, name: str,
                     n: int) -> int:
    """Step between lanes of ``t``: 1 for an int64[n], 0 for a 0-d int64
    that holds one value for every lane."""
    build.require(t, name, torch.int64, t.dim(), state.device)
    if t.dim() == 0:
        return 0
    _require_lanes(state, n, **{name: t})
    return 1


def tb_writeback(state: torch.Tensor, s: torch.Tensor, inc: torch.Tensor,
                 req: torch.Tensor, v1: torch.Tensor,
                 tokens_old: torch.Tensor, last_old: torch.Tensor,
                 now: torch.Tensor) -> torch.Tensor:
    """The token-bucket step's write-back, in place, on the current CUDA
    stream: for the last lane of each segment of valid slots in the
    slot-sorted ``s``, the segment's new (tokens, last refill) row, packed,
    into ``state`` (int32[S, 4]).  Every lane input is int64[B]; ``now`` is
    a 0-d int64.  Returns ``state``."""
    _require_state(state, 4)
    n = s.shape[0] if s.dim() == 1 else -1
    _require_lanes(state, n, s=s, inc=inc, req=req, v1=v1,
                   tokens_old=tokens_old, last_old=last_old)
    build.require(now, "now", torch.int64, 0, state.device)
    if n:
        _launch("rl_tb_writeback", state, state.data_ptr(), state.shape[0],
                s.data_ptr(), inc.data_ptr(), req.data_ptr(), v1.data_ptr(),
                tokens_old.data_ptr(), last_old.data_ptr(), now.data_ptr(),
                n)
        global tb_writeback_launches
        with _count_lock:
            tb_writeback_launches += 1
    return state


def sw_writeback(state: torch.Tensor, s: torch.Tensor, inc: torch.Tensor,
                 curr_e: torch.Tensor, prev_e: torch.Tensor,
                 prev_dl_e: torch.Tensor, ws_old: torch.Tensor,
                 cdl_old: torch.Tensor, win: torch.Tensor,
                 curr_ws: torch.Tensor, now: torch.Tensor) -> torch.Tensor:
    """The sliding-window step's write-back, in place, on the current CUDA
    stream: for the last lane of each segment of valid slots in the
    slot-sorted ``s``, the segment's rolled and counted row, packed, into
    ``state`` (int32[S, 6]).  Lane inputs are int64[B]; ``win`` and
    ``curr_ws`` int64[B] or 0-d (one tenant); ``now`` a 0-d int64.
    Returns ``state``."""
    _require_state(state, 6)
    n = s.shape[0] if s.dim() == 1 else -1
    _require_lanes(state, n, s=s, inc=inc, curr_e=curr_e, prev_e=prev_e,
                   prev_dl_e=prev_dl_e, ws_old=ws_old, cdl_old=cdl_old)
    win_step = _per_lane_or_one(state, win, "win", n)
    ws_step = _per_lane_or_one(state, curr_ws, "curr_ws", n)
    build.require(now, "now", torch.int64, 0, state.device)
    if n:
        _launch("rl_sw_writeback", state, state.data_ptr(), state.shape[0],
                s.data_ptr(), inc.data_ptr(), curr_e.data_ptr(),
                prev_e.data_ptr(), prev_dl_e.data_ptr(), ws_old.data_ptr(),
                cdl_old.data_ptr(), win.data_ptr(), win_step,
                curr_ws.data_ptr(), ws_step, now.data_ptr(), n)
        global sw_writeback_launches
        with _count_lock:
            sw_writeback_launches += 1
    return state
