"""The keyed host slot index (the port's copy of
``ratelimiter_tpu/engine/slots.py``).

The device state is a fixed-capacity slot array (engine/state.py); this
index owns the mapping from (limiter_id, key) to slot ids, with
LRU-ordered assignment and eviction of the least-recently-touched key
when the slot array is full.  The C index (``engine/native_index.py``)
has the same contract and stores fingerprints; this one keeps the keys
themselves, so its dump can be re-keyed into any geometry
(``engine/checkpoint.py``).  ``GpuBatchedStorage(checkpointable=True)``
uses it.

Eviction contract: an evicted slot's device state MUST be cleared before
the slot is reused (a zeroed slot behaves as an absent key).  ``assign``
returns the slot to clear, and callers (the micro-batcher) schedule the
clear ahead of the reusing batch.  Slots referenced by the pending batch
can be pinned so eviction never pulls state out from under queued
requests.  This index sees one key per call, so each call is its own
batch, and its recency equals the C index's batch recency (a key's
repeats in one batch count as one touch).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Hashable, Optional, Set, Tuple

import numpy as np


class SlotIndex:
    """LRU slot assignment over a fixed slot capacity."""

    def __init__(self, num_slots: int):
        if num_slots <= 0:
            raise ValueError("num_slots must be positive")
        self.num_slots = int(num_slots)
        self._lock = threading.Lock()
        self._map: "OrderedDict[Hashable, int]" = OrderedDict()  # key -> slot, LRU order
        self._free = list(range(self.num_slots - 1, -1, -1))
        # Refcounted held pins (streams: assign -> dispatch-enqueue window).
        self._pins: Dict[int, int] = {}
        # Slots removed (admin reset) while pinned: freed on last unpin via
        # the dirty list, and reported as their own eviction when reassigned
        # so the caller re-clears the (possibly stale) device state first.
        self._deferred: Set[int] = set()
        self._dirty: list = []

    def get(self, key: Hashable) -> Optional[int]:
        """Slot for key, or None; refreshes recency."""
        with self._lock:
            slot = self._map.get(key)
            if slot is not None:
                self._map.move_to_end(key)
            return slot

    def assign(
        self, key: Hashable, pinned: Optional[Set[int]] = None,
        hold_pin: bool = False
    ) -> Tuple[int, Optional[int]]:
        """Slot for key, allocating (and possibly evicting) if absent.

        Returns (slot, evicted_slot): ``evicted_slot`` is not None when an
        LRU victim was displaced — its device state must be cleared before
        this slot's next use.  Raises RuntimeError if every slot is pinned.
        """
        def held(slot):
            if hold_pin:
                self._pins[slot] = self._pins.get(slot, 0) + 1
            return slot

        with self._lock:
            slot = self._map.get(key)
            if slot is not None:
                self._map.move_to_end(key)
                return held(slot), None
            if self._free:
                slot = self._free.pop()
                self._map[key] = slot
                return held(slot), None
            # Removed-while-pinned slots, since unpinned: may carry a stale
            # write from the formerly-pinned dispatch — reported as their
            # own eviction so the caller clears them before reuse.  A dirty
            # slot can have been RE-pinned since it was listed (a queued
            # request via the per-call pinned set): skip those, exactly as
            # the LRU eviction scan below does.
            for i in range(len(self._dirty) - 1, -1, -1):
                slot = self._dirty[i]
                if self._pins.get(slot) or (pinned and slot in pinned):
                    continue
                del self._dirty[i]
                self._map[key] = slot
                return held(slot), slot
            # Evict the least-recently-used non-pinned key.
            for victim_key, victim_slot in self._map.items():
                if pinned and victim_slot in pinned:
                    continue
                if self._pins.get(victim_slot):
                    continue
                del self._map[victim_key]
                self._map[key] = victim_slot
                return held(victim_slot), victim_slot
            raise RuntimeError("all slots pinned; increase num_slots or flush")

    def pin_batch(self, slots) -> None:
        """Refcounted pins (duplicates fine) held across a dispatch-prep
        window so concurrent assigns can't evict these slots."""
        with self._lock:
            for s in np.asarray(slots):
                s = int(s)
                if 0 <= s < self.num_slots:
                    self._pins[s] = self._pins.get(s, 0) + 1

    def unpin_batch(self, slots) -> None:
        with self._lock:
            for s in np.asarray(slots):
                s = int(s)
                c = self._pins.get(s, 0)
                if c <= 1:
                    self._pins.pop(s, None)
                    if c == 1 and s in self._deferred:
                        self._deferred.discard(s)
                        self._dirty.append(s)
                else:
                    self._pins[s] = c - 1

    def remove(self, key: Hashable) -> Optional[int]:
        """Drop a key (admin reset); returns its slot (caller clears it).

        A slot with a live pin refcount (a stream's assign->dispatch window)
        is not freed immediately — it joins the dirty list at last unpin so
        a new key can never receive the pinned dispatch's stale write."""
        with self._lock:
            slot = self._map.pop(key, None)
            if slot is not None:
                if self._pins.get(slot):
                    self._deferred.add(slot)
                else:
                    self._free.append(slot)
            return slot

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)
