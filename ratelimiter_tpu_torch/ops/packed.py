"""Fused-output steps (counterpart of ``ratelimiter_tpu/ops/packed.py``,
micro-batch route only).

All per-request outputs of a step are stacked into ONE ``i64[3, B]``
tensor, so a batch's results come back to the host in one copy.  These
are pure wrappers: the underlying step is the single source of decision
logic.  The resident state is updated in place.
"""

from __future__ import annotations

import torch

from ratelimiter_tpu_torch.ops.sliding_window import sw_step_p
from ratelimiter_tpu_torch.ops.token_bucket import tb_step_p


def sw_step_fused(state, table, slots, limiter_ids, permits, now):
    """Row 0: allowed | mutated<<1;  row 1: observed;  row 2: cache_value."""
    out = sw_step_p(state, table, slots, limiter_ids, permits, now)
    flags = out.allowed.to(torch.int64) | (out.mutated.to(torch.int64) << 1)
    return torch.stack([flags, out.observed, out.cache_value])


def tb_step_fused(state, table, slots, limiter_ids, permits, now):
    """Row 0: allowed;  row 1: observed;  row 2: remaining."""
    out = tb_step_p(state, table, slots, limiter_ids, permits, now)
    return torch.stack(
        [out.allowed.to(torch.int64), out.observed, out.remaining])


def decode_sw_fused(arr):
    """numpy i64[3, B] -> dict matching DeviceEngine.sw_acquire's contract."""
    flags = arr[0]
    return {
        "allowed": (flags & 1).astype(bool),
        "mutated": (flags & 2).astype(bool),
        "observed": arr[1],
        "cache_value": arr[2],
    }


def decode_tb_fused(arr):
    return {
        "allowed": (arr[0] & 1).astype(bool),
        "observed": arr[1],
        "remaining": arr[2],
    }
