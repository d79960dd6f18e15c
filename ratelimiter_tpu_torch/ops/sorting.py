"""Batch sort/unsort helpers (counterpart of ``ratelimiter_tpu/ops/sorting.py``).

Stable argsort by slot id groups duplicate keys into contiguous segments
while preserving arrival order within each segment — the order the
sequential semantics are defined over.  ``torch.argsort(stable=True)``
gives the same permutation as ``jnp.argsort(stable=True)``: ties keep
their input order in both.

Unsorting gathers through the inverse permutation, computed once per
step (one index write of ``arange``) and shared by every output.
"""

from __future__ import annotations

import torch


def sort_batch(slots: torch.Tensor, *others: torch.Tensor):
    """Stable-sort the batch by slot id.

    Returns (inv, sorted_slots, tuple_of_sorted_others) where ``inv`` is the
    inverse permutation (pass to :func:`unsort`).
    """
    order = torch.argsort(slots, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv, slots[order], tuple(o[order] for o in others)


def unsort(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Invert the sort permutation (gather back to arrival order)."""
    return x[inv]
