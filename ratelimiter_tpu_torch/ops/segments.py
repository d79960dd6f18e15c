"""Segmented-batch primitives (counterpart of ``ratelimiter_tpu/ops/segments.py``).

A micro-batch of ``B`` requests is sorted (stably) by slot id; requests for
the same slot form a contiguous *segment* that must observe sequential
semantics: request ``j`` in a segment sees the effects of requests ``i < j``.

Both algorithms reduce to the same self-referential recurrence

    inc[j] = 1  iff  S[j] <= u[j],     S[j] = sum_{i<j in segment} w[i]*inc[i]

(sliding window: w == 1, u = max - base - permits - c0; token bucket:
w = requested_fp, u = refilled_tokens - requested_fp).

:func:`solve_threshold_recurrence` here is the plain PyTorch version of the
solver: the monotone sandwich iteration of the reference package, as
tensor ops.  ``F(x)[j] = (segcumsum_excl(w*x)[j] <= u[j])`` is antitone in
x, the sequential solution is its unique fixpoint, and iterating
``lo <- F(hi), hi <- F(lo)`` from (0, 1) closes on it in at most
max-segment-length steps.  It serves CPU tensors and is what the CUDA
kernel (``ops/cuda/solver.cu``, a sequential walk per segment) is held to.
"""

from __future__ import annotations

import torch


def first_occurrence(sorted_slots: torch.Tensor) -> torch.Tensor:
    """Boolean mask marking the first element of each segment.

    ``sorted_slots`` must be sorted; padding slots (<0) sort first and form
    their own segment.
    """
    prev = torch.cat([sorted_slots[:1] - 1, sorted_slots[:-1]])
    return sorted_slots != prev


def last_occurrence(sorted_slots: torch.Tensor) -> torch.Tensor:
    nxt = torch.cat([sorted_slots[1:], sorted_slots[-1:] + 1])
    return sorted_slots != nxt


def segmented_cumsum_exclusive(x: torch.Tensor,
                               first: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative sum of non-negative ``x`` within each segment.

    Running-total trick: with x >= 0 the global cumsum is non-decreasing,
    so the segment base (global exclusive cumsum at the segment's first
    element) propagates with a running maximum.
    """
    excl = torch.cumsum(x, 0) - x
    seg_base = torch.cummax(torch.where(first, excl, torch.zeros_like(excl)),
                            0).values
    return excl - seg_base


def segment_totals(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Inclusive within-segment running sum — at a segment's LAST element
    this is the segment total (used for the single per-slot state write)."""
    return segmented_cumsum_exclusive(x, first) + x


def solve_threshold_recurrence(u: torch.Tensor, w: torch.Tensor,
                               first: torch.Tensor) -> torch.Tensor:
    """Solve inc[j] = (segcumsum_excl(w*inc)[j] <= u[j]) by sandwich
    iteration; returns the int64 0/1 vector ``inc``.

    ``u``: int64 thresholds (padding and pre-rejected lanes carry a
    negative value); ``w``: non-negative int64 weights; ``first``: the
    segment-head mask over the sorted batch.

    A batch whose live lanes are all segment heads has the closed form
    ``inc = (u >= 0)``; only duplicates among live lanes force the
    iteration (the same fast path as the reference's ``lax.cond``).
    """
    u = u.to(torch.int64)
    w = w.to(torch.int64)
    if not bool(torch.any(~first & (u >= 0))):
        return (u >= 0).to(torch.int64)

    def F(x):
        s = segmented_cumsum_exclusive(w * x, first)
        return (s <= u).to(torch.int64)

    lo = torch.zeros_like(u)
    hi = torch.ones_like(u)
    it = 0
    while bool(torch.any(lo != hi)) and it < u.shape[0] + 2:
        lo, hi = F(hi), F(lo)
        it += 1
    return lo
