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

The sharded engine reserves and credits through the host mirrors of the
steps (:func:`host_reserve_rows`, :func:`host_credit_rows`): read the
rows, compute on the host, write the changed rows back.
"""

from __future__ import annotations

import numpy as np
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


# -- host mirrors (the sharded engine's read-rows -> update -> write-rows) -----
# The reference's per-lane restatement of the steps over decoded host rows
# (``ratelimiter_tpu/ops/lease.py:host_reserve_rows`` / ``host_credit_rows``).
# Lanes are independent: callers pass UNIQUE slots per call (the lease
# manager reserves or credits one key at a time).  Python's ``//`` and
# ``%`` floor, as the steps do.

def _pair_i64(rows: np.ndarray, lo: int) -> np.ndarray:
    """Two little-endian int32 lanes -> int64 (a bitcast, as the steps')."""
    return np.ascontiguousarray(
        rows[:, lo:lo + 2].astype(np.int32)).view(np.int64).ravel()


def _i64_pair(vals: np.ndarray) -> np.ndarray:
    """int64[n] -> int32[n, 2], the inverse bitcast."""
    return np.ascontiguousarray(
        vals.astype(np.int64)).view(np.int32).reshape(-1, 2)


def _sw_host_roll(row, win: int, now: int):
    """One decoded row rolled to ``now`` (``ops/sliding_window.py:_rolled``
    on the host): ``(curr_ws, curr, prev, prev_dl)``."""
    ws0, curr0, cdl0, prev0, pdl0 = row
    curr_ws = now - now % win
    if ws0 == curr_ws:
        return curr_ws, curr0, (prev0 if now < pdl0 else 0), pdl0
    if ws0 == curr_ws - win:
        return curr_ws, 0, (curr0 if now < cdl0 else 0), cdl0
    return curr_ws, 0, 0, 0


def _sw_decode_host(rows: np.ndarray):
    ws = _pair_i64(rows, 0)
    return (ws, rows[:, 2].astype(np.int64), ws + rows[:, 4],
            rows[:, 3].astype(np.int64), ws + rows[:, 5])


def _sw_encode_host(ws: int, curr: int, cdl: int, prev: int,
                    pdl: int) -> np.ndarray:
    out = np.empty(6, dtype=np.int32)
    out[0:2] = _i64_pair(np.array([ws]))[0]
    out[2] = curr
    out[3] = prev
    out[4] = max(cdl - ws, 0)
    out[5] = max(pdl - ws, 0)
    return out


def _tb_host_refill(row: np.ndarray, cap: int, rate: int, ttl2: int,
                    now: int) -> int:
    """One row's tokens refilled to ``now``
    (``ops/token_bucket.py:_refilled`` on the host)."""
    tokens = int(_pair_i64(row[None], 0)[0])
    last = int(_pair_i64(row[None], 2)[0])
    if last == 0 or now >= last + ttl2:
        tokens, last = cap, now
    elapsed = min(max(now - last, 0), cap // max(rate, 1) + 1)
    return min(cap, tokens + elapsed * rate)


def _tb_row(tokens: int, now: int) -> np.ndarray:
    out = np.empty(4, dtype=np.int32)
    out[0:2] = _i64_pair(np.array([tokens]))[0]
    out[2:4] = _i64_pair(np.array([max(now, 1)]))[0]
    return out


def host_reserve_rows(algo: str, rows: np.ndarray, lids, requested,
                      policies, now: int):
    """:func:`sw_reserve_p` / :func:`tb_reserve_p` over host rows of unique
    slots.  ``policies(lid)`` gives ``(max_permits, window_ms, cap_fp,
    rate_fp, ttl2_ms)`` (``LimiterTable.host_policy``).  Returns
    ``(granted i64[n], ws i64[n], new_rows, changed bool[n])``: the
    sliding window rewrites every row (rolled), the token bucket only
    where it granted."""
    n = len(rows)
    granted = np.zeros(n, dtype=np.int64)
    ws_out = np.zeros(n, dtype=np.int64)
    changed = np.zeros(n, dtype=bool)
    new_rows = np.array(rows, dtype=np.int32, copy=True)
    now = int(now)
    if algo == "sw":
        dec = _sw_decode_host(rows)
        for i in range(n):
            maxp, win, _, _, _ = policies(int(lids[i]))
            row = tuple(int(f[i]) for f in dec)
            curr_ws, curr, prev, prev_dl = _sw_host_roll(row, win, now)
            base = (prev * (win - now % win)) // win
            g = max(0, min(int(requested[i]), maxp - base - curr))
            cdl = (now + win) if g > 0 else (
                row[2] if row[0] == curr_ws else 0)
            new_rows[i] = _sw_encode_host(curr_ws, curr + g, cdl, prev,
                                          prev_dl)
            granted[i] = g
            ws_out[i] = curr_ws
            changed[i] = True
        return granted, ws_out, new_rows, changed
    for i in range(n):
        _, _, cap, rate, ttl2 = policies(int(lids[i]))
        v1 = _tb_host_refill(rows[i], cap, rate, ttl2, now)
        g = max(0, min(int(requested[i]), v1 // TOKEN_FP_ONE))
        granted[i] = g
        if g > 0:
            new_rows[i] = _tb_row(v1 - g * TOKEN_FP_ONE, now)
            changed[i] = True
    return granted, ws_out, new_rows, changed


def host_credit_rows(algo: str, rows: np.ndarray, lids, credit, grant_ws,
                     policies, now: int):
    """:func:`sw_credit_p` / :func:`tb_credit_p` over host rows of unique
    slots (``policies`` as :func:`host_reserve_rows`'); returns
    ``(credited i64[n], new_rows, changed bool[n])``, changed only where
    something was credited."""
    n = len(rows)
    credited = np.zeros(n, dtype=np.int64)
    changed = np.zeros(n, dtype=bool)
    new_rows = np.array(rows, dtype=np.int32, copy=True)
    now = int(now)
    if algo == "sw":
        dec = _sw_decode_host(rows)
        for i in range(n):
            _, win, _, _, _ = policies(int(lids[i]))
            row = tuple(int(f[i]) for f in dec)
            curr_ws, curr, prev, prev_dl = _sw_host_roll(row, win, now)
            if curr_ws != int(grant_ws[i]) or curr <= 0:
                continue
            c = min(max(int(credit[i]), 0), curr)
            if c <= 0:
                continue
            # curr > 0: the row is in the current window already, so its
            # deadline stays (a credit never refreshes the TTL).
            new_rows[i] = _sw_encode_host(curr_ws, curr - c, row[2], prev,
                                          prev_dl)
            credited[i] = c
            changed[i] = True
        return credited, new_rows, changed
    for i in range(n):
        _, _, cap, rate, ttl2 = policies(int(lids[i]))
        v1 = _tb_host_refill(rows[i], cap, rate, ttl2, now)
        absorbed = min(max(int(credit[i]), 0) * TOKEN_FP_ONE, cap - v1)
        if absorbed <= 0:
            continue
        new_rows[i] = _tb_row(v1 + absorbed, now)
        credited[i] = absorbed // TOKEN_FP_ONE
        changed[i] = True
    return credited, new_rows, changed


RESERVE_STEPS = {"sw": sw_reserve_p, "tb": tb_reserve_p}
CREDIT_STEPS = {"sw": sw_credit_p, "tb": tb_credit_p}
