"""Device-resident state: slot rows + the multi-tenant limiter table
(counterpart of ``ratelimiter_tpu/engine/state.py``).

The port keeps the reference's packed row layout (``ops/sliding_window.py``,
``ops/token_bucket.py``): a slot whose row is all zeros behaves exactly
like an absent Redis key, so slot allocation is free.

``LimiterTable`` holds per-tenant policy rows on the host (numpy) with a
mirror of int64 tensors on the engine's device.  The mirror is rebuilt
lazily after every :meth:`LimiterTable.register` and
:meth:`LimiterTable.set_policy`; steps read it through
:attr:`LimiterTable.device_arrays`, under the table lock, so a dispatch
sees either the old rows or the new ones.

:func:`load_reference_state` carries state and policy exported from the
reference package (as numpy arrays) into a port engine, so both packages
can compute from the same starting point.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("engine.state")


class SWState(NamedTuple):
    """Sliding-window per-slot fields, decoded from a packed row.

    win_start — window-start timestamp the curr bucket belongs to
    curr      — current-window bucket counter
    curr_dl   — curr bucket's expiry deadline (last increment + window)
    prev      — previous-window bucket counter
    prev_dl   — prev bucket's expiry deadline
    """

    win_start: torch.Tensor  # i64[...]
    curr: torch.Tensor
    curr_dl: torch.Tensor
    prev: torch.Tensor
    prev_dl: torch.Tensor


class TBState(NamedTuple):
    """Token-bucket per-slot fields (the Redis hash {tokens, last_refill}).

    ``last_refill == 0`` is the absent-key sentinel; the expiry deadline is
    always ``last_refill + 2*window`` and is recomputed, not stored."""

    tokens_fp: torch.Tensor    # i64[...]
    last_refill: torch.Tensor  # i64[...]


class TableArrays(NamedTuple):
    """Per-limiter policy rows, int64 tensors gathered by limiter id."""

    max_permits: torch.Tensor
    window_ms: torch.Tensor
    cap_fp: torch.Tensor     # token bucket
    rate_fp: torch.Tensor    # token bucket
    ttl2_ms: torch.Tensor    # 2 * window — token bucket TTL


_FIELDS = ("_max_permits", "_window_ms", "_cap_fp", "_rate_fp", "_ttl2_ms")


class LimiterTable:
    """Host-side registry of limiter configs with a device mirror.

    Row 0 is a sentinel (window 1 ms, zero permits) so padded/clamped
    lookups are always in range and never divide by zero.
    """

    SENTINEL_ROWS = 1

    def __init__(self, capacity: int = 64, *, device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._capacity = max(int(capacity), 2)
        self._n = self.SENTINEL_ROWS
        self._max_permits = np.zeros(self._capacity, dtype=np.int64)
        self._window_ms = np.ones(self._capacity, dtype=np.int64)
        self._cap_fp = np.zeros(self._capacity, dtype=np.int64)
        self._rate_fp = np.zeros(self._capacity, dtype=np.int64)
        self._ttl2_ms = np.ones(self._capacity, dtype=np.int64)
        self._device: TableArrays | None = None
        # Policy generation: a monotonic counter bumped by every live
        # set_policy, plus the generation each row last changed at.
        self._generation = 0
        self._row_gen = np.zeros(self._capacity, dtype=np.int64)
        self.implicit_grows = 0

    def register(self, config: RateLimitConfig) -> int:
        """Add a policy row; returns its limiter id."""
        config.validate()
        with self._lock:
            if self._n == self._capacity:
                self._grow()
            lid = self._n
            self._n += 1
            self._write_row(lid, config.max_permits, config.window_ms,
                            config.max_permits_fp, config.refill_rate_fp,
                            2 * config.window_ms)
            return lid

    def set_policy(self, lid: int, config: RateLimitConfig,
                   generation: Optional[int] = None) -> int:
        """Live-update one registered policy row; returns the new policy
        generation.

        Only the rates move (max_permits / cap_fp / rate_fp): the window,
        and with it ttl2, is part of the state's meaning and is immutable.
        ``generation`` installs an externally dictated stamp instead of
        bumping the local counter.
        """
        config.validate()
        with self._lock:
            i = int(lid)
            if not (self.SENTINEL_ROWS <= i < self._n):
                raise KeyError(f"no limiter registered under lid={lid}")
            if config.window_ms != int(self._window_ms[i]):
                raise ValueError(
                    f"set_policy cannot change the window (lid={lid}: "
                    f"{self._window_ms[i]} ms -> {config.window_ms} ms); "
                    "the window is part of the state shape — register a "
                    "new limiter instead")
            self._write_row(i, config.max_permits, config.window_ms,
                            config.max_permits_fp, config.refill_rate_fp,
                            int(self._ttl2_ms[i]))
            if generation is None:
                self._generation += 1
                self._row_gen[i] = self._generation
            else:
                self._generation = max(self._generation, int(generation))
                self._row_gen[i] = int(generation)
            return self._generation

    def load_rows(self, rows: Sequence[Sequence[int]]) -> None:
        """Replace the whole table with ``rows`` of ``(max_permits,
        window_ms, cap_fp, rate_fp, ttl2_ms)``, one per limiter id, row 0
        the sentinel — the reference's ``LimiterTable.host_policy(lid)``
        for every lid."""
        with self._lock:
            while self._capacity < len(rows):
                self._grow()
            for lid, row in enumerate(rows):
                self._write_row(lid, *(int(v) for v in row))
            self._n = len(rows)

    def _write_row(self, i, max_permits, window_ms, cap_fp, rate_fp,
                   ttl2_ms) -> None:
        """Host row write (lock held); the device mirror rebuilds lazily."""
        self._max_permits[i] = max_permits
        self._window_ms[i] = window_ms
        self._cap_fp[i] = cap_fp
        self._rate_fp[i] = rate_fp
        self._ttl2_ms[i] = ttl2_ms
        self._device = None

    @property
    def generation(self) -> int:
        """Monotonic policy generation (0 until the first set_policy)."""
        with self._lock:
            return self._generation

    def row_generation(self, lid: int) -> int:
        """Generation the row last changed at (0 = as registered)."""
        with self._lock:
            return int(self._row_gen[int(lid)])

    def bump_generation(self, generation: int) -> None:
        """Adopt a generation floor from outside: a storage applying
        another's limiter dump (``engine/checkpoint.py:
        apply_limiter_policies``) must never report an older generation
        than the policies it now serves."""
        with self._lock:
            if int(generation) > self._generation:
                self._generation = int(generation)

    def _grow(self) -> None:
        new_cap = self._capacity * 2
        for name in _FIELDS + ("_row_gen",):
            old = getattr(self, name)
            fill = 1 if name in ("_window_ms", "_ttl2_ms") else 0
            fresh = np.full(new_cap, fill, dtype=np.int64)
            fresh[: self._capacity] = old
            setattr(self, name, fresh)
        self.implicit_grows += 1
        _log.warning("limiter table grew %d -> %d under traffic; pre-size "
                     "it with table_capacity", self._capacity, new_cap)
        self._capacity = new_cap
        self._device = None

    @property
    def device_arrays(self) -> TableArrays:
        with self._lock:
            if self._device is None:
                self._device = TableArrays(*(
                    torch.as_tensor(getattr(self, name), device=self.device)
                    for name in _FIELDS))
            return self._device

    def __len__(self) -> int:
        return self._n

    @property
    def max_permits_registered(self) -> int:
        """Largest max_permits across registered policies (0 if none) —
        the relay word layout's rank-clamp ceiling must exceed this."""
        with self._lock:
            return int(self._max_permits[:self._n].max(initial=0))


def load_reference_state(engine, sw_packed: np.ndarray,
                         tb_packed: np.ndarray,
                         policy_rows: Sequence[Sequence[int]], *,
                         sw_lid_map: Optional[np.ndarray] = None,
                         tb_lid_map: Optional[np.ndarray] = None) -> None:
    """Load the reference package's state and policy into a port engine.

    ``sw_packed`` (i32[S, 6]) and ``tb_packed`` (i32[S, 4]) are the
    reference engine's resident arrays as numpy (``np.asarray(
    engine.sw_packed)``); the layouts are byte-identical.  ``policy_rows``
    is the reference table's ``host_policy(lid)`` for every lid.
    ``sw_lid_map`` / ``tb_lid_map`` (i32[S], optional) are its resident
    digest's lid maps.  The engine's resident tensors are overwritten in
    place.
    """
    arrays = [("sw_packed", sw_packed), ("tb_packed", tb_packed)]
    arrays += [(name, arr) for name, arr in (("sw_lid_map", sw_lid_map),
                                             ("tb_lid_map", tb_lid_map))
               if arr is not None]
    for name, arr in arrays:
        dst = getattr(engine, name)
        src = np.array(arr, dtype=np.int32, order="C")  # a writable copy
        if src.shape != tuple(dst.shape):
            raise ValueError(f"{name}: shape {src.shape} != engine's "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src))
    engine.table.load_rows(policy_rows)
