"""Row scatter into the resident slot state (counterpart of
``ratelimiter_tpu/ops/scatter.py``).

``scatter_rows`` is the one entry: a tensor on the CPU takes the plain
``index_put_`` form below; a CUDA tensor launches the hand-written kernel
(``ops/cuda/block_scatter.cu``), which raises on anything it does not
take.  Nothing else selects between them.

Both forms update ``state`` in place (the reference donated the buffer)
and drop lanes that are masked out or whose slot lies outside the table,
like the reference's XLA drop-mode scatter.  Live slots must be unique,
or carry identical rows (resets write zeros).
"""

from __future__ import annotations

import torch

from ratelimiter_tpu_torch.ops.cuda import block_scatter


def scatter_rows_plain(state: torch.Tensor, slots: torch.Tensor,
                       write_mask: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the scatter kernel."""
    live = write_mask & (slots >= 0) & (slots < state.shape[0])
    state.index_put_((slots[live],), rows[live])
    return state


def scatter_rows(state: torch.Tensor, slots: torch.Tensor,
                 write_mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """state[slot] <- rows[j] for each j with write_mask[j]; returns state."""
    if state.device.type == "cpu":
        return scatter_rows_plain(state, slots, write_mask, rows)
    return block_scatter.scatter_rows(state, slots, write_mask, rows)
