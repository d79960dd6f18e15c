"""Fused digest relay step: the CUDA kernel (``relay_step.cu``) wrappers.

Counterpart of ``ratelimiter_tpu/ops/pallas/relay_step.py``.  The plain
version and the choice between the two live in ``ops/relay.py``: a CPU
tensor takes the plain torch form, a CUDA tensor this kernel, which
raises on anything it does not take.  The kernel serves every
scalar-limiter digest dispatch, at any table size and any lane count,
with the uniques sorted by slot or not.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ratelimiter_tpu_torch.ops.cuda import build

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0
_count_lock = threading.Lock()
_fns = {}

_COUNT_BYTES = {torch.uint8: 1, torch.uint16: 2}
_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    # state, num_rows, uwords, u, rank_bits, <policy columns>, lid, now,
    # counts, count_bytes, stream
    "tb": [_VP, _I64, _VP, _I64, _INT, _VP, _VP, _VP, _VP, _I64, _I64, _VP,
           _INT, _VP],
    "sw": [_VP, _I64, _VP, _I64, _INT, _VP, _VP, _I64, _I64, _VP, _INT,
           _VP],
}


def _kernel(algo: str):
    fn = _fns.get(algo)
    if fn is None:
        fn = getattr(build.load("relay_step"), f"rl_{algo}_relay_counts")
        fn.argtypes = _ARGTYPES[algo]
        fn.restype = ctypes.c_int
        _fns[algo] = fn
    return fn


def _launch(algo: str, packed: torch.Tensor, policy, uwords: torch.Tensor,
            lid: int, now: int, rank_bits: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    lanes = 4 if algo == "tb" else 6
    build.require(packed, "packed", torch.int32, 2)
    if packed.shape[1] != lanes:
        raise ValueError(f"{algo} relay: state rows have {packed.shape[1]} "
                         f"lanes, expected {lanes}")
    build.require(uwords, "uwords", torch.int32, 1, packed.device)
    for name, col in policy:
        build.require(col, name, torch.int64, 1, packed.device)
        if not 0 <= lid < col.shape[0]:
            raise ValueError(f"{algo} relay: lid {lid} outside the limiter "
                             f"table ({col.shape[0]} rows)")
    if not 1 <= rank_bits <= 30:
        raise ValueError(f"{algo} relay: rank_bits {rank_bits} not in 1..30")
    if packed.shape[0] >= 1 << (31 - rank_bits):
        raise ValueError(f"{algo} relay: {packed.shape[0]} rows do not fit "
                         f"the {31 - rank_bits}-bit slot field beside the "
                         "padding word")
    if out_dtype not in _COUNT_BYTES:
        raise ValueError(f"{algo} relay: counts dtype {out_dtype} is not "
                         "uint8 or uint16")
    u = uwords.shape[0]
    counts = torch.empty(u, dtype=out_dtype, device=packed.device)
    if u:
        err = _kernel(algo)(
            packed.data_ptr(), packed.shape[0], uwords.data_ptr(), u,
            rank_bits, *(col.data_ptr() for _, col in policy), int(lid),
            int(now), counts.data_ptr(), _COUNT_BYTES[out_dtype],
            torch.cuda.current_stream(packed.device).cuda_stream)
        if err:
            raise RuntimeError(f"{algo} relay kernel launch failed: CUDA "
                               f"error {err}")
        global launches
        with _count_lock:
            launches += 1
    return counts


def tb_relay_counts(packed: torch.Tensor, table, uwords: torch.Tensor,
                    lid: int, now: int, *, rank_bits: int,
                    out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Launch the token-bucket relay step on the current CUDA stream:
    ``packed`` int32[S, 4] is updated in place; ``uwords`` int32[U] carries
    the word bits; returns out_dtype[U] allowed counts (a new tensor)."""
    return _launch("tb", packed,
                   (("cap_fp", table.cap_fp), ("rate_fp", table.rate_fp),
                    ("max_permits", table.max_permits),
                    ("ttl2_ms", table.ttl2_ms)),
                   uwords, lid, now, rank_bits, out_dtype)


def sw_relay_counts(packed: torch.Tensor, table, uwords: torch.Tensor,
                    lid: int, now: int, *, rank_bits: int,
                    out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Launch the sliding-window relay step (see :func:`tb_relay_counts`);
    ``packed`` is int32[S, 6]."""
    return _launch("sw", packed,
                   (("max_permits", table.max_permits),
                    ("window_ms", table.window_ms)),
                   uwords, lid, now, rank_bits, out_dtype)
