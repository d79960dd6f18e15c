"""Flat sorted steps of the stream routes (counterpart of
``ratelimiter_tpu/ops/flat.py``).

Every request of a stream chunk is stamped with the chunk's time, and at
one timestamp K sequential sub-batches decide exactly as ONE flat batch of
their K*B requests sorted stably by slot: a key's requests still form one
segment in arrival order, and the refill or window roll at the shared
``now`` happens once per slot either way.  So a chunk is one sorted step:

    stable sort by slot (payloads gathered along) -> gather rows ->
    refill / roll to now -> solve each segment -> write back the segment's
    last lane -> allow bits back in arrival order, packed 8 to a byte

``permits=None`` (unit permits) gives every lane of a segment the same
weight and threshold, so the recurrence has the closed form
``inc = rank * w <= u``; a permits lane goes through the solver
(``ops/cuda/solver.py``: the CUDA kernel on the card, the plain sandwich
iteration on the CPU).  The write-back is the micro steps' own
(``tb_writeback`` / ``sw_writeback``): its plain version computes the
segment totals of ``req * inc`` (or of ``inc``), writes the segment's row
at its last lane and keeps the old row where nothing passed, which is what
the reference's flat epilogue computes (its closed forms for unit permits
are these totals), so on the card the flat step launches
``rl_tb_writeback`` / ``rl_sw_writeback``.

The sort is a library sort (``torch.argsort(stable=True)``), as the
reference's was XLA's.  Bits are packed MSB first, as ``np.packbits``.
The state is updated in place; a step returns its bits.
"""

from __future__ import annotations

import torch

from ratelimiter_tpu_torch.core.config import TOKEN_FP_ONE
from ratelimiter_tpu_torch.ops.cuda.solver import (
    solve_threshold_recurrence_auto,
)
from ratelimiter_tpu_torch.ops.segments import (
    first_occurrence,
    segmented_cumsum_exclusive,
)
from ratelimiter_tpu_torch.ops.sliding_window import (
    _rolled,
    _sw_decode,
    sw_writeback,
)
from ratelimiter_tpu_torch.ops.token_bucket import (
    _refilled,
    _tb_decode,
    floor_div,
    tb_writeback,
)
from ratelimiter_tpu_torch.ops.transfer import device_scalar

def packbits(bits: torch.Tensor) -> torch.Tensor:
    """bool or 0/1 [n] -> uint8[ceil(n / 8)], MSB first and zero-padded,
    as ``np.packbits``."""
    b = bits.to(torch.int32)
    pad = -b.shape[0] % 8
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    # Bit j of a byte is lane 7 - j.  The shifts are made on the device: a
    # host tensor would go up as a pageable copy, which waits for the
    # stream's queued work.
    shift = torch.arange(7, -1, -1, dtype=torch.int32, device=b.device)
    return (b.view(-1, 8) << shift).sum(1).to(torch.uint8)


def _sort_by_slot(slots: torch.Tensor, *payloads: torch.Tensor):
    """Stable sort by slot id with the payloads gathered along.  Returns
    (sorted slots as int64, the forward order, sorted payloads)."""
    order = torch.argsort(slots, stable=True)
    return (slots[order].to(torch.int64), order,
            [p[order] for p in payloads])


def _unsort_bits(order: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """Arrival-order packed bits from sorted-order decisions."""
    back = torch.empty_like(allowed)
    back[order] = allowed
    return packbits(back)


def _seg_rank(first: torch.Tensor) -> torch.Tensor:
    """Rank of each lane within its segment (0-based arrival order)."""
    idx = torch.arange(first.shape[0], device=first.device)
    head = torch.cummax(torch.where(first, idx, 0), 0).values
    return idx - head


def _unpack_lanes(slots, lids, permits):
    """Sort the lanes; returns (s, order, lid, p) with ``lid`` the 0-d
    limiter id or the sorted int64 lane, ``p`` the sorted int64 permits or
    None."""
    scalar_lid = lids.dim() == 0
    payloads = ([] if scalar_lid else [lids]) + (
        [] if permits is None else [permits])
    s, order, payloads = _sort_by_slot(slots, *payloads)
    lid = lids.to(torch.int64) if scalar_lid else payloads.pop(0).to(
        torch.int64)
    p = None if permits is None else payloads.pop(0).to(torch.int64)
    return s, order, lid, p


def _policy_index(lid, rows: int):
    """A limiter id as given (an int or a 0-d tensor), or a lane of them
    clipped into the table, as the reference clips it."""
    if not isinstance(lid, torch.Tensor) or lid.dim() == 0:
        return lid
    return torch.clamp(lid.to(torch.int64), 0, rows - 1)


def tb_flat_bits(packed: torch.Tensor, table, slots: torch.Tensor,
                 lids: torch.Tensor, permits: torch.Tensor | None,
                 now) -> torch.Tensor:
    """One flat sorted batch of token-bucket decisions; ``packed``
    (i32[S, 4]) is updated in place.

    ``slots`` int[B] (< 0: padding or a forced deny); ``lids`` a 0-d id or
    int[B]; ``permits`` None (unit) or uint8 / int32 [B]; ``now`` an int64
    scalar.  Returns uint8[ceil(B / 8)] arrival-order allow bits."""
    now = device_scalar(now, packed.device)
    s, order, lid, p = _unpack_lanes(slots, lids, permits)
    valid = s >= 0
    sc = torch.clamp(s, 0, packed.shape[0] - 1)
    lidc = _policy_index(lid, table.cap_fp.shape[0])
    cap = table.cap_fp[lidc]
    rate = table.rate_fp[lidc]
    maxp = table.max_permits[lidc]
    ttl2 = table.ttl2_ms[lidc]

    rows = _tb_decode(packed[sc])
    v1 = _refilled(rows, cap, rate, ttl2, now)

    if p is None:
        req = torch.full_like(v1, TOKEN_FP_ONE)
        pre_ok = valid & (maxp >= 1)
    else:
        req = p * TOKEN_FP_ONE
        pre_ok = valid & (p <= maxp)
    u = torch.where(pre_ok, v1 - req, -1)
    first = first_occurrence(s)
    if p is None:
        # Segment-uniform weight: the first max(0, u // w + 1) ranks pass.
        inc = (_seg_rank(first) * TOKEN_FP_ONE <= u).to(torch.int64)
    else:
        inc = solve_threshold_recurrence_auto(u, req, first)
    allowed = (inc == 1) & valid

    tb_writeback(packed, s, inc, req, v1, rows.tokens_fp, rows.last_refill,
                 now)
    return _unsort_bits(order, allowed)


def sw_flat_bits(packed: torch.Tensor, table, slots: torch.Tensor,
                 lids: torch.Tensor, permits: torch.Tensor | None,
                 now) -> torch.Tensor:
    """Flat sliding-window counterpart of :func:`tb_flat_bits` (same
    contract), with the reference's quirks: a request checks ``count +
    permits`` but increments by 1 (Q1), and the decision re-checks the
    count after the increment (Q2)."""
    now = device_scalar(now, packed.device)
    s, order, lid, p = _unpack_lanes(slots, lids, permits)
    valid = s >= 0
    sc = torch.clamp(s, 0, packed.shape[0] - 1)
    lidc = _policy_index(lid, table.max_permits.shape[0])
    maxp = table.max_permits[lidc]
    win = table.window_ms[lidc]

    rows = _sw_decode(packed[sc])
    curr_ws, curr_e, prev_e, prev_dl_e = _rolled(rows, win, now)
    rem = torch.remainder(now, win)
    base = floor_div(prev_e * (win - rem), win)

    u = torch.where(valid, maxp - base - curr_e - (1 if p is None else p),
                    -1)
    first = first_occurrence(s)
    if p is None:
        rank = _seg_rank(first)
        inc = (rank <= u).to(torch.int64)
        S = torch.minimum(rank, torch.clamp(u + 1, min=0))
    else:
        inc = solve_threshold_recurrence_auto(u, torch.ones_like(u), first)
        S = segmented_cumsum_exclusive(inc, first)
    allowed = (inc == 1) & (curr_e + S + 1 <= maxp) & valid

    sw_writeback(packed, s, inc, curr_e, prev_e, prev_dl_e, rows.win_start,
                 rows.curr_dl, win, curr_ws, now)
    return _unsort_bits(order, allowed)
