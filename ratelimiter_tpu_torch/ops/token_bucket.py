"""Batched token-bucket decision step (counterpart of
``ratelimiter_tpu/ops/token_bucket.py``).

One invocation is the batched equivalent of N executions of the
reference's atomic Lua script: lazy init on absent/expired buckets, exact
fixed-point refill, sequential-semantics consume within duplicate-slot
segments, and write-back (tokens, last_refill) only for slots where at
least one request was allowed — a fully denied slot keeps its prior row
bit for bit.  Decision math is ``semantics/oracle.py:TokenBucketOracle``.

Plain functions on tensors.  The resident packed state is updated in
place (the reference donated the buffer).  Every ``//`` of the reference
is a floor division here (``torch.div(..., rounding_mode="floor")``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ratelimiter_tpu_torch.core.config import TOKEN_FP_ONE
from ratelimiter_tpu_torch.engine.state import TableArrays, TBState
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

# -- packed resident form -----------------------------------------------------
# (tokens_fp, last_refill) live as FOUR i32 lanes [tok_lo, tok_hi, last_lo,
# last_hi], byte-equal to the reference's bitcast layout: an int64 viewed as
# int32 on a little-endian machine puts the low word first.


def i64_to_pair(x: torch.Tensor) -> torch.Tensor:
    """i64[...] -> i32[..., 2] (low word, high word).  Always a copy with
    unit strides: a broadcast one-element column counts as contiguous but
    has stride 0, and cannot be viewed as pairs."""
    return (x.clone(memory_format=torch.contiguous_format)
            .view(torch.int32).reshape(*x.shape, 2))


def pair_to_i64(pair: torch.Tensor) -> torch.Tensor:
    """i32[..., 2] -> i64[...] (inverse of :func:`i64_to_pair`)."""
    return pair.contiguous().view(torch.int64).squeeze(-1)


def floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _tb_encode(tokens: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    return torch.cat([i64_to_pair(tokens), i64_to_pair(last)], dim=-1)


def _tb_decode(rows: torch.Tensor) -> TBState:
    return TBState(pair_to_i64(rows[..., 0:2]), pair_to_i64(rows[..., 2:4]))


def tb_pack_state(state: TBState) -> torch.Tensor:
    """TBState (2 x i64[S]) -> the resident packed form i32[S, 4]."""
    return _tb_encode(state.tokens_fp, state.last_refill)


def tb_unpack_state(packed: torch.Tensor) -> TBState:
    """The resident packed form i32[S, 4] -> TBState (2 x i64[S])."""
    return _tb_decode(packed)


def make_tb_packed(num_slots: int, device) -> torch.Tensor:
    return torch.zeros((num_slots, 4), dtype=torch.int32, device=device)


class TBOut(NamedTuple):
    allowed: torch.Tensor    # bool[B]
    observed: torch.Tensor   # i64[B] — whole tokens available pre-consume
    remaining: torch.Tensor  # i64[B] — whole tokens after the operation


def _refilled(state_rows: TBState, cap, rate, ttl2, now):
    """Lazy init + exact fixed-point refill (oracle: _refilled).  Expired
    is ``now >= last_refill + ttl2``, with ``last_refill == 0`` the
    absent-key sentinel."""
    tokens, last = state_rows
    expired = (last == 0) | (now >= last + ttl2)
    v0 = torch.where(expired, cap, tokens)
    last_e = torch.where(expired, now, last)
    hi = floor_div(cap, torch.clamp(rate, min=1)) + 1
    elapsed = torch.minimum(torch.clamp(now - last_e, min=0), hi)
    return torch.minimum(cap, v0 + elapsed * rate)


def tb_step_p(packed: torch.Tensor, table: TableArrays, slots: torch.Tensor,
              limiter_ids: torch.Tensor, permits: torch.Tensor,
              now) -> TBOut:
    """One batch of token-bucket decisions; ``packed`` (i32[S, 4]) is
    updated in place.

    ``slots`` i64[B] (< 0 = padding), ``limiter_ids`` i64[B] or 0-d (one
    tenant: the policy row is read once), ``permits`` i64[B], ``now`` an
    int64 scalar (0-d tensor or int).
    """
    now = torch.as_tensor(now, dtype=torch.int64, device=packed.device)
    if limiter_ids.dim() == 0:
        inv, s, (p,) = sort_batch(slots, permits)
        lid = limiter_ids
    else:
        inv, s, (lid, p) = sort_batch(slots, limiter_ids, permits)
    valid = s >= 0
    sc = torch.clamp(s, 0, packed.shape[0] - 1)
    lidc = torch.clamp(lid, 0, table.cap_fp.shape[0] - 1)

    cap = table.cap_fp[lidc]
    rate = table.rate_fp[lidc]
    maxp = table.max_permits[lidc]
    ttl2 = table.ttl2_ms[lidc]

    rows = _tb_decode(packed[sc])  # one 4-lane i32 row gather
    v1 = _refilled(rows, cap, rate, ttl2, now)

    req = p * TOKEN_FP_ONE
    # Client-side reject above capacity; padding never passes.
    pre_ok = valid & (p <= maxp)
    # inc[j] = [ W[j] + req[j] <= v1 ],  W = fp tokens consumed by prior
    # requests in the segment (all share `now`: no intra-batch refill).
    u = torch.where(pre_ok, v1 - req, torch.full_like(req, -1))
    first = first_occurrence(s)
    inc = solve_threshold_recurrence_auto(u, req, first)
    W = segmented_cumsum_exclusive(req * inc, first)

    v_j = v1 - W                         # fp tokens seen by request j
    allowed = inc == 1
    after = v_j - req * inc              # Lua returns tokens post-op either way

    tb_writeback(packed, s, inc, req, v1, rows.tokens_fp, rows.last_refill,
                 now)

    return TBOut(
        allowed=unsort(allowed & valid, inv),
        observed=unsort(floor_div(v_j, TOKEN_FP_ONE), inv),
        remaining=unsort(floor_div(after, TOKEN_FP_ONE), inv),
    )


def tb_writeback_plain(packed: torch.Tensor, s: torch.Tensor,
                       inc: torch.Tensor, req: torch.Tensor, v1: torch.Tensor,
                       tokens_old: torch.Tensor, last_old: torch.Tensor,
                       now: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the write-back kernel: one state write per
    segment of valid slots, at its last lane; a segment that allowed
    nothing writes its old row back."""
    first = first_occurrence(s)
    lastm = last_occurrence(s) & (s >= 0)
    tot_w = segment_totals(req * inc, first)
    tot_inc = segment_totals(inc, first)
    any_inc = tot_inc > 0
    tokens_new = torch.where(any_inc, v1 - tot_w, tokens_old)
    # Clamp to >= 1 so a write at epoch instant 0 cannot alias the
    # absent-key sentinel (last_refill == 0).
    last_new = torch.where(any_inc, torch.clamp(now, min=1), last_old)
    return scatter_rows_plain(packed, s, lastm,
                              _tb_encode(tokens_new, last_new))


def tb_writeback(packed: torch.Tensor, s: torch.Tensor, inc: torch.Tensor,
                 req: torch.Tensor, v1: torch.Tensor,
                 tokens_old: torch.Tensor, last_old: torch.Tensor,
                 now: torch.Tensor) -> torch.Tensor:
    """The step's write-back into ``packed`` (in place) over the
    slot-sorted batch ``s``: the plain version for a CPU tensor, the kernel
    (``ops/cuda/block_scatter.cu``) for a CUDA tensor."""
    if packed.device.type == "cpu":
        return tb_writeback_plain(packed, s, inc, req, v1, tokens_old,
                                  last_old, now)
    return block_scatter.tb_writeback(packed, s, inc, req, v1, tokens_old,
                                      last_old, now)


def tb_peek_p(packed: torch.Tensor, table: TableArrays, slots: torch.Tensor,
              limiter_ids: torch.Tensor, now) -> torch.Tensor:
    """Read-only refilled whole-token count (the fixed availablePermits)."""
    now = torch.as_tensor(now, dtype=torch.int64, device=packed.device)
    sc = torch.clamp(slots, 0, packed.shape[0] - 1)
    lidc = torch.clamp(limiter_ids, 0, table.cap_fp.shape[0] - 1)
    rows = _tb_decode(packed[sc])
    v1 = _refilled(rows, table.cap_fp[lidc], table.rate_fp[lidc],
                   table.ttl2_ms[lidc], now)
    return floor_div(v1, TOKEN_FP_ONE)


def tb_reset_p(packed: torch.Tensor, slots: torch.Tensor) -> None:
    """Zero the given slots in place (delete bucket); negative slots are
    dropped."""
    zeros = torch.zeros((slots.shape[0], packed.shape[1]), dtype=torch.int32,
                        device=packed.device)
    scatter_rows(packed, slots, slots >= 0, zeros)
