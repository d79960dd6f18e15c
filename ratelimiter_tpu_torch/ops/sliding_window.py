"""Batched sliding-window decision step (counterpart of
``ratelimiter_tpu/ops/sliding_window.py``).

One invocation decides a whole micro-batch against the slot state:

    gather slot rows -> roll windows forward to `now` -> weighted estimate ->
    segmented sequential-semantics solve -> write back updated rows

Decision math is the exact integer semantics of ``semantics/oracle.py``.
All requests in a batch share one timestamp ``now`` (stamped at flush by
the micro-batcher).  Plain functions on tensors; the resident packed state
is updated in place (the reference donated the buffer).  Every ``//`` and
``%`` keeps floor semantics (``torch.div(..., rounding_mode="floor")``,
``torch.remainder``): operands can be negative.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ratelimiter_tpu_torch.engine.state import SWState, TableArrays
from ratelimiter_tpu_torch.ops.cuda import block_scatter
from ratelimiter_tpu_torch.ops.cuda.solver import (
    solve_threshold_recurrence_auto,
)
from ratelimiter_tpu_torch.ops.scatter import scatter_rows, scatter_rows_plain
from ratelimiter_tpu_torch.ops.segments import (
    first_occurrence,
    last_occurrence,
    segment_totals,
    segmented_cumsum_exclusive,
)
from ratelimiter_tpu_torch.ops.sorting import sort_batch, unsort
from ratelimiter_tpu_torch.ops.token_bucket import (
    floor_div,
    i64_to_pair,
    pair_to_i64,
)

# -- compact row codec --------------------------------------------------------
# The five i64 fields travel as SIX i32 lanes: [ws_lo, ws_hi, curr, prev,
# cdl_off, pdl_off], byte-equal to the reference's layout.  Counts fit i32 by
# construction (counter <= max_permits <= 2^31-1), and the expiry deadlines
# are stored as offsets from the row's own win_start.  A dead deadline (0)
# encodes as offset 0, which decodes to win_start — equally dead in every
# comparison (`now < deadline` with now >= win_start).


def _sw_encode(ws, curr, cdl, prev, pdl) -> torch.Tensor:
    """5 x i64[...] -> i32[..., 6]."""
    cols = [
        i64_to_pair(ws),
        curr.to(torch.int32)[..., None],
        prev.to(torch.int32)[..., None],
        torch.clamp(cdl - ws, min=0).to(torch.int32)[..., None],
        torch.clamp(pdl - ws, min=0).to(torch.int32)[..., None],
    ]
    return torch.cat(cols, dim=-1)


def _sw_decode(rows: torch.Tensor) -> SWState:
    """i32[..., 6] -> (ws, curr, cdl, prev, pdl) as i64[...]."""
    ws = pair_to_i64(rows[..., 0:2])
    return SWState(
        win_start=ws,
        curr=rows[..., 2].to(torch.int64),
        curr_dl=ws + rows[..., 4],
        prev=rows[..., 3].to(torch.int64),
        prev_dl=ws + rows[..., 5],
    )


def sw_pack_state(state: SWState) -> torch.Tensor:
    """SWState (5 x i64[S]) -> the resident packed form i32[S, 6]."""
    return _sw_encode(state.win_start, state.curr, state.curr_dl,
                      state.prev, state.prev_dl)


def sw_unpack_state(packed: torch.Tensor) -> SWState:
    """The resident packed form i32[S, 6] -> SWState (5 x i64[S])."""
    return _sw_decode(packed)


def make_sw_packed(num_slots: int, device) -> torch.Tensor:
    return torch.zeros((num_slots, 6), dtype=torch.int32, device=device)


class SWOut(NamedTuple):
    allowed: torch.Tensor      # bool[B]
    mutated: torch.Tensor      # bool[B] — whether this request incremented
    observed: torch.Tensor     # i64[B] — weighted estimate seen by the request
    cache_value: torch.Tensor  # i64[B] — value the host cache should store


def _rolled(state_rows: SWState, win, now):
    """Advance gathered rows to `now`'s window, applying expiry deadlines."""
    ws0, curr, cdl, prev, pdl = state_rows
    zero = torch.zeros_like(curr)
    curr_ws = now - torch.remainder(now, win)
    same = ws0 == curr_ws
    next1 = ws0 == curr_ws - win
    curr_e = torch.where(same, curr, zero)
    prev_alive = now < pdl
    curr_alive = now < cdl
    prev_e = torch.where(
        same,
        torch.where(prev_alive, prev, zero),
        torch.where(next1 & curr_alive, curr, zero),
    )
    prev_dl_e = torch.where(same, pdl, torch.where(next1, cdl, zero))
    return curr_ws, curr_e, prev_e, prev_dl_e


def sw_step_p(packed: torch.Tensor, table: TableArrays, slots: torch.Tensor,
              limiter_ids: torch.Tensor, permits: torch.Tensor,
              now) -> SWOut:
    """One batch of sliding-window decisions; ``packed`` (i32[S, 6]) is
    updated in place.

    ``slots`` i64[B] (< 0 = padding), ``limiter_ids`` i64[B] or 0-d (one
    tenant), ``permits`` i64[B], ``now`` an int64 scalar.
    """
    now = torch.as_tensor(now, dtype=torch.int64, device=packed.device)
    if limiter_ids.dim() == 0:
        inv, s, (p,) = sort_batch(slots, permits)
        lid = limiter_ids
    else:
        inv, s, (lid, p) = sort_batch(slots, limiter_ids, permits)
    valid = s >= 0
    sc = torch.clamp(s, 0, packed.shape[0] - 1)
    lidc = torch.clamp(lid, 0, table.max_permits.shape[0] - 1)

    maxp = table.max_permits[lidc]
    win = table.window_ms[lidc]

    rows = _sw_decode(packed[sc])  # one 6-lane i32 row gather
    curr_ws, curr_e, prev_e, prev_dl_e = _rolled(rows, win, now)

    # Weighted estimate base: exact integer floor of prev * (1 - rem/win).
    rem = torch.remainder(now, win)
    base = floor_div(prev_e * (win - rem), win)

    # inc[j] = [ base + curr_e + S[j] + p[j] <= maxp ],  S = prior increments.
    u = torch.where(valid, maxp - base - curr_e - p,
                    torch.full_like(curr_e, -1))
    first = first_occurrence(s)
    inc = solve_threshold_recurrence_auto(u, torch.ones_like(u), first)
    S = segmented_cumsum_exclusive(inc, first)

    c_j = curr_e + S                     # raw curr counter seen by request j
    observed = base + c_j                # weighted estimate at request j
    allowed = (inc == 1) & (c_j + 1 <= maxp)
    # Host-cache value: raw new counter when incremented, the estimate on
    # pre-check rejection.
    cache_value = torch.where(inc == 1, c_j + 1, observed)

    sw_writeback(packed, s, inc, curr_e, prev_e, prev_dl_e, rows.win_start,
                 rows.curr_dl, win, curr_ws, now)

    return SWOut(
        allowed=unsort(allowed & valid, inv),
        mutated=unsort((inc == 1) & valid, inv),
        observed=unsort(observed, inv),
        cache_value=unsort(cache_value, inv),
    )


def sw_writeback_plain(packed: torch.Tensor, s: torch.Tensor,
                       inc: torch.Tensor, curr_e: torch.Tensor,
                       prev_e: torch.Tensor, prev_dl_e: torch.Tensor,
                       ws_old: torch.Tensor, cdl_old: torch.Tensor,
                       win: torch.Tensor, curr_ws: torch.Tensor,
                       now: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the write-back kernel: one state write per
    segment of valid slots, at its last lane (the row rolled to ``now``'s
    window and counted)."""
    first = first_occurrence(s)
    lastm = last_occurrence(s) & (s >= 0)
    tot = segment_totals(inc, first)
    any_inc = tot > 0
    curr_new = curr_e + tot
    samew = ws_old == curr_ws
    cdl_new = torch.where(any_inc, now + win,
                          torch.where(samew, cdl_old,
                                      torch.zeros_like(curr_e)))

    curr_ws_b = torch.broadcast_to(curr_ws, s.shape)
    new_rows = _sw_encode(curr_ws_b, curr_new, cdl_new, prev_e, prev_dl_e)
    return scatter_rows_plain(packed, s, lastm, new_rows)


def sw_writeback(packed: torch.Tensor, s: torch.Tensor, inc: torch.Tensor,
                 curr_e: torch.Tensor, prev_e: torch.Tensor,
                 prev_dl_e: torch.Tensor, ws_old: torch.Tensor,
                 cdl_old: torch.Tensor, win: torch.Tensor,
                 curr_ws: torch.Tensor, now: torch.Tensor) -> torch.Tensor:
    """The step's write-back into ``packed`` (in place) over the
    slot-sorted batch ``s``: the plain version for a CPU tensor, the kernel
    (``ops/cuda/block_scatter.cu``) for a CUDA tensor."""
    if packed.device.type == "cpu":
        return sw_writeback_plain(packed, s, inc, curr_e, prev_e, prev_dl_e,
                                  ws_old, cdl_old, win, curr_ws, now)
    return block_scatter.sw_writeback(packed, s, inc, curr_e, prev_e,
                                      prev_dl_e, ws_old, cdl_old, win,
                                      curr_ws, now)


def sw_peek_p(packed: torch.Tensor, table: TableArrays, slots: torch.Tensor,
              limiter_ids: torch.Tensor, now) -> torch.Tensor:
    """Read-only availablePermits: max(0, maxPermits - estimate)."""
    now = torch.as_tensor(now, dtype=torch.int64, device=packed.device)
    sc = torch.clamp(slots, 0, packed.shape[0] - 1)
    lidc = torch.clamp(limiter_ids, 0, table.max_permits.shape[0] - 1)
    maxp = table.max_permits[lidc]
    win = table.window_ms[lidc]
    _, curr_e, prev_e, _ = _rolled(_sw_decode(packed[sc]), win, now)
    rem = torch.remainder(now, win)
    est = curr_e + floor_div(prev_e * (win - rem), win)
    return torch.clamp(maxp - est, min=0)


def sw_reset_p(packed: torch.Tensor, slots: torch.Tensor) -> None:
    """Zero the given slots in place (delete curr + prev buckets);
    negative slots are dropped."""
    zeros = torch.zeros((slots.shape[0], packed.shape[1]), dtype=torch.int32,
                        device=packed.device)
    scatter_rows(packed, slots, slots >= 0, zeros)
