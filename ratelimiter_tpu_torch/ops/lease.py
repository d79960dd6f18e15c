"""Batched lease RESERVE / CREDIT steps (counterpart of
``ratelimiter_tpu/ops/lease.py``).

Token leases (``leases/``) push enforcement to the client: the server
reserves a bounded per-key permit budget in one device pass — gather slot
rows -> roll/refill to ``now`` -> greedy segmented grant -> scatter the
updated rows — and the client burns the budget locally.  These steps are
the device half of that contract:

- **RESERVE** charges up to ``requested`` permits per key against the
  live counters.  Sliding window: grant ``min(requested, max_permits -
  weighted_estimate)`` and charge the current-window bucket with the
  usual PEXPIRE refresh.  Token bucket: grant ``min(requested,
  refilled_whole_tokens)`` and consume them with the allow-branch
  write-back.
- **CREDIT** returns unused permits at renewal/release.  Sliding window:
  the decrement applies only while the charged window (``grant_ws``) is
  still current, and never refreshes the TTL.  Token bucket: refill, then
  add up to capacity; a bucket already at capacity stays bit-untouched.

Decision math is ``semantics/oracle.py:{SlidingWindowOracle,
TokenBucketOracle}.reserve/credit``.  Duplicate slots within a batch are
granted greedily in sorted order by the closed form ``grant_j =
clip(avail - cumsum_excl(req)_j, 0, req_j)``: exactly the sequential
semantics.  The segmented cumsum is a running-maximum trick that needs
inputs of 0 or more, so requests and credits are clamped before it.

Plain functions on tensors.  Each step updates the packed state in place
through ``ops/scatter.py:scatter_rows``, one row per segment at its last
lane: on a CUDA tensor that is the ``rl_scatter_rows`` kernel, on a CPU
tensor its plain version.  Both reserves write every valid segment's row
(the sliding window its rolled row, the token bucket its old row where
nothing was granted); both credits write only where something was
credited.  Every ``//`` and ``%`` keeps floor semantics.
"""

from __future__ import annotations

import torch

from ratelimiter_tpu_torch.core.config import TOKEN_FP_ONE
from ratelimiter_tpu_torch.engine.state import TableArrays
from ratelimiter_tpu_torch.ops.scatter import scatter_rows
from ratelimiter_tpu_torch.ops.segments import (
    first_occurrence,
    last_occurrence,
    segment_totals,
    segmented_cumsum_exclusive,
)
from ratelimiter_tpu_torch.ops.sliding_window import (
    _rolled,
    _sw_decode,
    _sw_encode,
)
from ratelimiter_tpu_torch.ops.sorting import sort_batch, unsort
from ratelimiter_tpu_torch.ops.token_bucket import (
    _refilled,
    _tb_decode,
    _tb_encode,
    floor_div,
)


def _clip(x: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, hi)``: the lower bound first, then the upper."""
    return torch.minimum(torch.clamp(x, min=0), hi)


def _live(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``where(keep, max(x, 0), 0)``: the segmented cumsum's operand."""
    return torch.where(keep, torch.clamp(x, min=0), torch.zeros_like(x))


def _sorted_lanes(packed, table, slots, limiter_ids, *others):
    """Sort the batch by slot; returns (inv, s, valid, the gather slots
    and the limiter ids clipped into their tables, the other lanes)."""
    inv, s, (lid, *rest) = sort_batch(slots, limiter_ids, *others)
    sc = torch.clamp(s, 0, packed.shape[0] - 1)
    lidc = torch.clamp(lid, 0, table.max_permits.shape[0] - 1)
    return inv, s, s >= 0, sc, lidc, rest


def sw_reserve_p(packed: torch.Tensor, table: TableArrays,
                 slots: torch.Tensor, limiter_ids: torch.Tensor,
                 requested: torch.Tensor, now):
    """Sliding-window reserve; ``packed`` (i32[S, 6]) is updated in place.

    ``slots`` i64[B] (< 0 = padding), ``limiter_ids`` i64[B],
    ``requested`` i64[B] (padding 0), ``now`` an int64 scalar.  Returns
    ``(granted i64[B], window_start i64[B])`` in arrival order."""
    now = torch.as_tensor(now, dtype=torch.int64, device=packed.device)
    inv, s, valid, sc, lidc, (req,) = _sorted_lanes(
        packed, table, slots, limiter_ids, requested)
    maxp = table.max_permits[lidc]
    win = table.window_ms[lidc]

    rows = _sw_decode(packed[sc])
    curr_ws, curr_e, prev_e, prev_dl_e = _rolled(rows, win, now)
    rem = torch.remainder(now, win)
    base = floor_div(prev_e * (win - rem), win)
    avail = torch.clamp(maxp - base - curr_e, min=0)

    req = _live(req, valid)
    first = first_occurrence(s)
    grant = _clip(avail - segmented_cumsum_exclusive(req, first), req)
    tot = segment_totals(grant, first)

    lastm = last_occurrence(s) & valid
    samew = rows.win_start == curr_ws
    # PEXPIRE refresh exactly where an increment would apply it.
    cdl_new = torch.where(tot > 0, now + win,
                          torch.where(samew, rows.curr_dl,
                                      torch.zeros_like(curr_e)))
    curr_ws_b = torch.broadcast_to(curr_ws, s.shape)
    scatter_rows(packed, s, lastm,
                 _sw_encode(curr_ws_b, curr_e + tot, cdl_new, prev_e,
                            prev_dl_e))
    return unsort(grant, inv), unsort(curr_ws_b, inv)


def sw_credit_p(packed: torch.Tensor, table: TableArrays,
                slots: torch.Tensor, limiter_ids: torch.Tensor,
                credit: torch.Tensor, grant_ws: torch.Tensor, now):
    """Sliding-window credit; ``grant_ws`` i64[B] is the window each
    charge landed in.  Returns ``credited i64[B]`` in arrival order."""
    now = torch.as_tensor(now, dtype=torch.int64, device=packed.device)
    inv, s, valid, sc, lidc, (cr, gws) = _sorted_lanes(
        packed, table, slots, limiter_ids, credit, grant_ws)
    win = table.window_ms[lidc]

    rows = _sw_decode(packed[sc])
    curr_ws, curr_e, prev_e, prev_dl_e = _rolled(rows, win, now)
    cr = _live(cr, valid & (gws == curr_ws))
    first = first_occurrence(s)
    credited = _clip(curr_e - segmented_cumsum_exclusive(cr, first), cr)
    tot = segment_totals(credited, first)

    # A nonzero credit implies the row is in the charged (current) window,
    # so a written row keeps its deadline (a credit is no increment: no
    # TTL refresh).
    lastm = last_occurrence(s) & valid & (tot > 0)
    samew = rows.win_start == curr_ws
    cdl_keep = torch.where(samew, rows.curr_dl, torch.zeros_like(curr_e))
    curr_ws_b = torch.broadcast_to(curr_ws, s.shape)
    scatter_rows(packed, s, lastm,
                 _sw_encode(curr_ws_b, curr_e - tot, cdl_keep, prev_e,
                            prev_dl_e))
    return unsort(credited, inv)


def tb_reserve_p(packed: torch.Tensor, table: TableArrays,
                 slots: torch.Tensor, limiter_ids: torch.Tensor,
                 requested: torch.Tensor, now):
    """Token-bucket reserve; ``packed`` (i32[S, 4]) is updated in place.
    Returns ``(granted i64[B], zeros i64[B])`` (the second output keeps
    the reserve surface uniform with the sliding window)."""
    now = torch.as_tensor(now, dtype=torch.int64, device=packed.device)
    inv, s, valid, sc, lidc, (req,) = _sorted_lanes(
        packed, table, slots, limiter_ids, requested)
    rows = _tb_decode(packed[sc])
    v1 = _refilled(rows, table.cap_fp[lidc], table.rate_fp[lidc],
                   table.ttl2_ms[lidc], now)

    req = _live(req, valid)
    first = first_occurrence(s)
    grant = _clip(floor_div(v1, TOKEN_FP_ONE)
                  - segmented_cumsum_exclusive(req, first), req)
    tot = segment_totals(grant, first)

    # Every valid segment writes; one that was granted nothing writes its
    # old row back (the deny branch keeps the state bit for bit).
    lastm = last_occurrence(s) & valid
    any_g = tot > 0
    tokens_new = torch.where(any_g, v1 - tot * TOKEN_FP_ONE, rows.tokens_fp)
    last_new = torch.where(any_g, torch.clamp(now, min=1), rows.last_refill)
    scatter_rows(packed, s, lastm, _tb_encode(tokens_new, last_new))
    return unsort(grant, inv), torch.zeros_like(grant)


def tb_credit_p(packed: torch.Tensor, table: TableArrays,
                slots: torch.Tensor, limiter_ids: torch.Tensor,
                credit: torch.Tensor, grant_ws: torch.Tensor, now):
    """Token-bucket credit (``grant_ws`` is ignored: a uniform surface).
    Returns ``credited i64[B]`` in arrival order."""
    del grant_ws
    now = torch.as_tensor(now, dtype=torch.int64, device=packed.device)
    inv, s, valid, sc, lidc, (cr,) = _sorted_lanes(
        packed, table, slots, limiter_ids, credit)
    cap = table.cap_fp[lidc]
    rows = _tb_decode(packed[sc])
    v1 = _refilled(rows, cap, table.rate_fp[lidc], table.ttl2_ms[lidc], now)
    gap = torch.clamp(cap - v1, min=0)

    # The cumsum runs in fixed point, so a partial token absorbs exactly.
    cr_fp = _live(cr, valid) * TOKEN_FP_ONE
    first = first_occurrence(s)
    absorbed = _clip(gap - segmented_cumsum_exclusive(cr_fp, first), cr_fp)
    tot = segment_totals(absorbed, first)

    # A bucket already at capacity stays bit-untouched.
    lastm = last_occurrence(s) & valid & (tot > 0)
    last_new = torch.broadcast_to(torch.clamp(now, min=1), s.shape)
    scatter_rows(packed, s, lastm, _tb_encode(v1 + tot, last_new))
    return unsort(floor_div(absorbed, TOKEN_FP_ONE), inv)


RESERVE_STEPS = {"sw": sw_reserve_p, "tb": tb_reserve_p}
CREDIT_STEPS = {"sw": sw_credit_p, "tb": tb_credit_p}
