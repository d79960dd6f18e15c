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

The replication journals (``SlotJournal`` on the host, ``DeviceSlotJournal``
on the engine's device) collect the slots each dispatch touches between two
replication cuts (``replication/log.py``).  The reference's
``mark_matrix`` / ``mark_words_matrix`` serve only its sharded engine and
wait for it (ROADMAP A5); neither journal here has them.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

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


class SlotJournal:
    """Host-side dirty-slot journal feeding the replication log.

    Every ``DeviceEngine`` mutation path calls :meth:`mark` with the
    host-side slot ids of the rows its step touches, once the step is
    enqueued — a boolean scatter into a per-algo mask, O(batch) and off
    the device critical path.  ``drain`` atomically swaps the masks out
    and returns the coalesced dirty slot set per algo — the delta a
    replication epoch ships (replication/log.py).

    Marks are a superset of actual mutations (a denied request's slot is
    marked even though the row may be unchanged); shipping an unchanged
    row is idempotent, so over-marking costs bytes, never correctness.
    Out-of-range ids (batch padding -1, relay padding words) are
    filtered here so callers can mark their raw lane arrays.
    """

    __slots__ = ("num_slots", "_lock", "_dirty", "_all", "_oldest_ns",
                 "marks")

    def __init__(self, num_slots: int):
        self.num_slots = int(num_slots)
        self._lock = threading.Lock()
        self._dirty: Dict[str, np.ndarray] = {
            "sw": np.zeros(self.num_slots, dtype=bool),
            "tb": np.zeros(self.num_slots, dtype=bool),
        }
        self._all = {"sw": False, "tb": False}
        # Wall time of the first mark since the last drain — the age of
        # the oldest unreplicated mutation, i.e. the replication lag.
        self._oldest_ns: Optional[int] = None
        self.marks = 0

    def mark(self, algo: str, slots) -> None:
        a = np.asarray(slots).reshape(-1).astype(np.int64, copy=False)
        if not len(a):
            return
        sel = a[(a >= 0) & (a < self.num_slots)]
        with self._lock:
            self.marks += 1
            if len(sel):
                self._dirty[algo][sel] = True
                if self._oldest_ns is None:
                    self._oldest_ns = time.time_ns()

    def mark_words(self, algo: str, words, rank_bits: int) -> None:
        """Mark from relay uwords (uint32: slot in the high bits; padding
        words decode past num_slots and are filtered by :meth:`mark`)."""
        self.mark(algo, np.asarray(words).astype(np.uint64)
                  >> np.uint64(rank_bits + 1))

    def mark_all(self, algo: str) -> None:
        """Mark every slot dirty (bulk restores/imports, or a full-state
        catch-up frame after a ship failure or a late-joining standby)."""
        with self._lock:
            self._all[algo] = True
            if self._oldest_ns is None:
                self._oldest_ns = time.time_ns()

    def drain(self) -> Tuple[Dict[str, np.ndarray], Optional[int], bool]:
        """Swap out and return ``(dirty slot ids per algo, wall ns of the
        oldest pending mark, whether any algo was marked-all)``."""
        with self._lock:
            out: Dict[str, np.ndarray] = {}
            was_all = False
            for algo, mask in self._dirty.items():
                if self._all[algo]:
                    out[algo] = np.arange(self.num_slots, dtype=np.int64)
                    self._all[algo] = False
                    mask[:] = False
                    was_all = True
                else:
                    ids = np.nonzero(mask)[0]
                    if len(ids):
                        out[algo] = ids
                        mask[ids] = False
            oldest = self._oldest_ns
            self._oldest_ns = None
            return out, oldest, was_all

    def pending(self) -> int:
        """Total dirty slots across algos (cheap visibility for tests
        and the lag gauge)."""
        with self._lock:
            return sum(self.num_slots if self._all[a] else int(m.sum())
                       for a, m in self._dirty.items())


class DeviceSlotJournal:
    """Dirty-slot journal on the engine's device: one bool bitmap per
    algorithm, marked by a few torch ops over the lane tensor the dispatch
    already uploaded (the reference's jitted ``bits.at[...].max`` scatter,
    ``ratelimiter_tpu/engine/state.py:433``).  A mark costs its op
    launches and no host work or upload; ``drain`` copies the bitmap to the
    host off the decision path (the replicator's thread).

    Each bitmap has ``num_slots + 1`` entries: lanes out of range (padding
    -1, relay padding words, anything at or past ``num_slots``) are sent
    to the sink entry ``num_slots`` and every lane writes True, so a
    scatter of duplicate or clipped lanes can never unset a live lane's
    mark, and no negative index wraps.  Relay words arrive as int32
    tensors holding the uint32 bits (``engine/engine.py:_upload_words``);
    the slot field is decoded through int64 with the sign bits masked off,
    so a slot that sets bit 31 and the all-ones padding word decode as the
    unsigned words they are.

    Same contract as ``SlotJournal``: marks are a superset of mutations,
    and marks racing a drain land in the next epoch (the bitmap is swapped
    under the journal lock; on CUDA the drain's copy to the host waits for
    the marks queued on the stream before the swap).
    """

    device = True  # engine hooks pass the dispatch's device lanes

    __slots__ = ("num_slots", "_dev", "_lock", "_bits", "_all",
                 "_oldest_ns", "marks", "_true")

    def __init__(self, num_slots: int, device="cuda"):
        self.num_slots = int(num_slots)
        self._dev = torch.device(device)
        self._lock = threading.Lock()
        self._bits: Dict[str, torch.Tensor] = {
            "sw": self._zeros(), "tb": self._zeros()}
        self._all = {"sw": False, "tb": False}
        self._oldest_ns: Optional[int] = None
        self.marks = 0
        self._true = torch.ones((), dtype=torch.bool, device=self._dev)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.num_slots + 1, dtype=torch.bool,
                           device=self._dev)

    def _as_device(self, arr) -> Optional[torch.Tensor]:
        if isinstance(arr, torch.Tensor):
            return arr
        a = np.asarray(arr)
        if a.size == 0:
            return None
        return torch.from_numpy(np.ascontiguousarray(
            a.astype(np.int64, copy=False))).to(self._dev)

    def _apply(self, algo: str, slots: Optional[torch.Tensor]) -> None:
        """Mark int64 slot ids (any value): in range sets its bit, the rest
        set the sink's.  ``clamp`` folds every out-of-range id onto -1 or
        ``num_slots`` and the remainder by ``num_slots + 1`` (floored, as
        Python's) takes -1 to the sink too."""
        if slots is None or slots.numel() == 0:
            return
        idx = torch.remainder(slots.reshape(-1).clamp(-1, self.num_slots),
                              self.num_slots + 1)
        with self._lock:
            self.marks += 1
            self._bits[algo].index_put_((idx,), self._true)
            if self._oldest_ns is None:
                self._oldest_ns = time.time_ns()

    def mark(self, algo: str, slots) -> None:
        arr = self._as_device(slots)
        self._apply(algo, None if arr is None else arr.to(torch.int64))

    def mark_words(self, algo: str, words, rank_bits: int) -> None:
        """Mark from relay words: int32 tensors of the uint32 bits, or
        host arrays of uint32 words."""
        arr = self._as_device(np.asarray(words, dtype=np.uint32)
                              if not isinstance(words, torch.Tensor)
                              else words)
        if arr is None:
            return
        self._apply(algo, (arr.to(torch.int64) & 0xFFFFFFFF)
                    >> (int(rank_bits) + 1))

    def mark_all(self, algo: str) -> None:
        with self._lock:
            self._all[algo] = True
            if self._oldest_ns is None:
                self._oldest_ns = time.time_ns()

    def drain(self) -> Tuple[Dict[str, np.ndarray], Optional[int], bool]:
        """Swap the bitmaps for fresh ones under the lock, then copy the
        old ones to the host; same return contract as
        ``SlotJournal.drain``."""
        with self._lock:
            taken = {}
            was_all = False
            for algo in ("sw", "tb"):
                taken[algo] = (self._bits[algo], self._all[algo])
                self._bits[algo] = self._zeros()
                was_all |= self._all[algo]
                self._all[algo] = False
            oldest = self._oldest_ns
            self._oldest_ns = None
        out: Dict[str, np.ndarray] = {}
        for algo, (bits, marked_all) in taken.items():
            if marked_all:
                out[algo] = np.arange(self.num_slots, dtype=np.int64)
                continue
            ids = np.flatnonzero(bits[:self.num_slots].cpu().numpy())
            if len(ids):
                out[algo] = ids.astype(np.int64)
        return out, oldest, was_all

    def pending(self) -> int:
        with self._lock:
            return sum(self.num_slots if self._all[a]
                       else int(b[:self.num_slots].sum())
                       for a, b in self._bits.items())
