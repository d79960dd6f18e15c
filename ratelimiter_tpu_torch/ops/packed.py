"""Fused-output steps and the K-step scan (counterpart of
``ratelimiter_tpu/ops/packed.py``).

1. Fused outputs (``sw_step_fused`` / ``tb_step_fused``), the micro-batch
   route: all per-request outputs of a step are stacked into ONE
   ``i64[3, B]`` tensor, so a batch's results come back to the host in
   one copy.
2. The scan (``sw_scan_bits`` / ``tb_scan_bits``), the flat stream path's
   super-batches past its lane cap: K sequential steps on one state, each
   at its own ``now`` (exactly K successive flushes), returning only the
   allow bits, packed 8 to a byte, as ``uint8[K, ceil(B / 8)]``.  The
   reference's ``lax.scan`` is a Python loop here.

These are pure wrappers: the underlying step is the single source of
decision logic.  The resident state is updated in place.
"""

from __future__ import annotations

import torch

from ratelimiter_tpu_torch.ops.flat import packbits
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


# -- K-step scan with bit-packed decisions -------------------------------------
# Shapes: slots int[K, B]; permits int[K, B] (or None: one permit each);
# lids a 0-d id (one tenant) or int[K, B]; now int64[K] (each step's stamp).


def _scan(step, state, table, slots, lids, permits, now):
    bits = []
    for k in range(slots.shape[0]):
        s = slots[k].to(torch.int64)
        lid = lids.to(torch.int64) if lids.dim() == 0 else lids[k].to(
            torch.int64)
        p = (torch.ones_like(s) if permits is None
             else permits[k].to(torch.int64))
        bits.append(packbits(step(state, table, s, lid, p, now[k]).allowed))
    return torch.stack(bits)


def sw_scan_bits(state, table, slots, lids, permits, now):
    return _scan(sw_step_p, state, table, slots, lids, permits, now)


def tb_scan_bits(state, table, slots, lids, permits, now):
    return _scan(tb_step_p, state, table, slots, lids, permits, now)
