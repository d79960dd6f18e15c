"""The partitioned host slot index: T C sub-indexes, one worker thread each.

The port's copy of ``ratelimiter_tpu/engine/partitioned.py``.  The C slot
walk is bound by DRAM latency and serial in one index; partitioning the key
space over T sub-indexes lets T walks run at once (ctypes releases the GIL
inside each C call).

Semantics, as the reference's: a key lives in the partition its routing
picks (``engine/routing.py``: splitmix64 for int keys, the fingerprint's
h1 for string keys), eviction is LRU within each partition (a key's slot
never moves between partitions), and the global slot is ``partition *
slots_per_part + local slot``.  Batch outputs merge partition-major: slot
lanes go back to request order, unique words are concatenated partition
by partition with each partition's slot base folded into the slot field,
and ``uidx`` is offset by the uniques of the partitions before it.

The storage elects it (``storage/gpu.py:elect_host_parallel``).  The
checkpoint reads it as the reference's does: ``_parts``, ``n_parts`` and
``slots_per_part``, :meth:`PartitionedSlotIndex.dump_fp` and
:meth:`PartitionedSlotIndex.lookup_fps`; a restore goes partition by
partition (``engine/checkpoint.py``).  The port's index hashes every
string batch natively or raises, so the reference's per-key Python
routing fallback has no counterpart here.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Hashable, Optional, Set, Tuple

import numpy as np

from ratelimiter_tpu_torch.engine.errors import consume_pending_clears
from ratelimiter_tpu_torch.engine.native_index import (
    NativeSlotIndex,
    _fingerprints,
    _slots_i32,
    hash_str_keys,
    route_hashes,
    shard_route,
)
from ratelimiter_tpu_torch.engine.routing import shard_of_key


class PartitionedSlotIndex:
    """The surface of :class:`NativeSlotIndex` (the scalar contract and
    the batched int and string assigns, plain and unique-compacting) over
    ``n_parts`` sub-indexes of ``num_slots / n_parts`` slots each, walked
    in parallel on a pool of ``n_parts`` threads (shut by :meth:`close`)."""

    def __init__(self, num_slots: int, n_parts: int = 4):
        if num_slots % n_parts:
            raise ValueError("num_slots must divide evenly by n_parts")
        self.num_slots = int(num_slots)
        self.n_parts = int(n_parts)
        self.slots_per_part = self.num_slots // self.n_parts
        self._parts = [NativeSlotIndex(self.slots_per_part)
                       for _ in range(self.n_parts)]
        self._pool = cf.ThreadPoolExecutor(
            self.n_parts, thread_name_prefix="slotidx")

    def close(self) -> None:
        self._pool.shutdown(wait=False)

    # -- scalar interface ------------------------------------------------------
    def _local_pins(self, pinned, part):
        if not pinned:
            return None
        spp = self.slots_per_part
        return {s % spp for s in pinned if s // spp == part}

    def get(self, key: Hashable) -> Optional[int]:
        p = shard_of_key(key, self.n_parts)
        local = self._parts[p].get(key)
        return None if local is None else p * self.slots_per_part + local

    def assign(self, key: Hashable, pinned: Optional[Set[int]] = None,
               hold_pin: bool = False) -> Tuple[int, Optional[int]]:
        p = shard_of_key(key, self.n_parts)
        base = p * self.slots_per_part
        local, evicted = self._parts[p].assign(
            key, pinned=self._local_pins(pinned, p), hold_pin=hold_pin)
        return base + local, None if evicted is None else base + evicted

    def remove(self, key: Hashable) -> Optional[int]:
        p = shard_of_key(key, self.n_parts)
        local = self._parts[p].remove(key)
        return None if local is None else p * self.slots_per_part + local

    def __len__(self) -> int:
        return sum(len(p) for p in self._parts)

    # -- vectorized interface --------------------------------------------------
    def _scatter_merge(self, n, parts_pos, results, kind, rank_bits=0):
        """Merge per-partition outputs back to request order.

        kind 'slots': results are (slots, ev) -> (slots i32[n], clears).
        kind 'uniques': results are (uwords, uidx, rank, ev) -> (uwords
        concatenated with each partition's slot base folded into the slot
        field, uidx i32[n] offset per partition, rank i32[n], clears).
        """
        spp = self.slots_per_part
        if kind == "slots":
            out = np.empty(n, dtype=np.int32)
            clears: list = []
            for p, (pos, res) in enumerate(zip(parts_pos, results)):
                if res is None:
                    continue
                slots, ev = res
                out[pos] = slots + p * spp
                clears.extend(p * spp + int(e) for e in ev)
            return out, clears
        rb = rank_bits
        uw_all, clears = [], []
        uidx = np.empty(n, dtype=np.int32)
        rank = np.empty(n, dtype=np.int32)
        offset = 0
        for p, (pos, res) in enumerate(zip(parts_pos, results)):
            if res is None:
                continue
            uw, ui, rk, ev = res
            # The slot rides in bits rank_bits + 1 and up, so adding
            # base << (rank_bits + 1) addresses it globally.
            uw_all.append(uw + np.uint32(p * spp << (rb + 1)))
            uidx[pos] = ui + offset
            rank[pos] = rk
            offset += len(uw)
            clears.extend(p * spp + int(e) for e in ev)
        uwords = (np.concatenate(uw_all) if uw_all
                  else np.empty(0, dtype=np.uint32))
        return uwords, uidx, rank, clears

    def _collect(self, futs, unpin_of):
        """Gather per-partition futures.  If a partition raised: release
        the pins the partitions that succeeded took (their results never
        reach the caller), put every eviction the batch applied (theirs
        and the failing partitions' partial lists) on the error as global
        ``pending_clears``, and re-raise it."""
        results, err = [], None
        spp = self.slots_per_part
        clears: list = []
        for p, f in enumerate(futs):
            if f is None:
                results.append(None)
                continue
            try:
                results.append(f.result())
            except Exception as exc:  # noqa: BLE001 — re-raised below
                err = err if err is not None else exc
                clears.extend(consume_pending_clears(exc, p * spp))
                results.append(None)
        if err is not None:
            for p, res in enumerate(results):
                if res is None:
                    continue
                if unpin_of is not None:
                    self._parts[p].unpin_batch(unpin_of(res))
                # Every assign result ends with its eviction list.
                clears.extend(p * spp + int(e) for e in res[-1])
            try:  # keep the original type; just carry the clears
                err.pending_clears = (np.asarray(clears, dtype=np.int64)
                                      if clears else None)
            except AttributeError:  # exotic __slots__ exception
                pass
            raise err
        return results

    def _submit(self, parts_pos, pinned, run, unpin_of, args):
        """One pool task per non-empty partition: ``run(p, *args(p, pos),
        local pins)``; returns (parts_pos, results)."""
        futs = []
        for p, pos in enumerate(parts_pos):
            if not len(pos):
                futs.append(None)
                continue
            futs.append(self._pool.submit(run, p, *args(p, pos),
                                          self._local_pins(pinned, p)))
        return parts_pos, self._collect(futs, unpin_of)

    def _split(self, order, counts):
        offs = np.zeros(self.n_parts + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        return offs, [order[offs[p]:offs[p + 1]]
                      for p in range(self.n_parts)]

    def _parallel(self, key_ids, pinned, run, unpin_of=None):
        """Split an int batch by partition (one C routing pass: a stable
        counting sort, so each partition's positions are one slice of its
        order) and run the partitions' C walks on the pool.
        ``unpin_of(result) -> local slots`` must be given when the run
        holds pins, so that a partial failure releases them."""
        _, order, counts = shard_route(key_ids, self.n_parts)
        _, parts_pos = self._split(order, counts)
        return self._submit(parts_pos, pinned, run, unpin_of,
                            lambda p, pos: (pos,))

    def _parallel_fps(self, h1, h2, pinned, run_fp, unpin_of=None):
        """Route hashed string keys by h1 (``routing.shard_of_key``'s
        string branch) and feed each partition its fingerprint slice."""
        h1, h2 = _fingerprints(h1, h2)
        _, order, counts = route_hashes(h1, self.n_parts)
        offs, parts_pos = self._split(order, counts)
        h1st, h2st = h1[order], h2[order]

        def fps(p, pos):
            lo, hi = int(offs[p]), int(offs[p + 1])
            return h1st[lo:hi], h2st[lo:hi]
        return self._submit(parts_pos, pinned, run_fp, unpin_of, fps)

    @staticmethod
    def _unpin_uniques(rank_bits: int):
        return lambda res: (res[0] >> np.uint32(rank_bits + 1)).astype(
            np.int32)

    def assign_batch_ints(self, keys: np.ndarray, lid: int,
                          pinned: Optional[Set[int]] = None,
                          hold_pins: bool = False):
        keys = np.ascontiguousarray(keys, dtype=np.int64)

        def run(p, pos, pins):
            return self._parts[p].assign_batch_ints(
                keys[pos], lid, pinned=pins, hold_pins=hold_pins)

        parts_pos, results = self._parallel(
            keys, pinned, run,
            unpin_of=(lambda res: res[0]) if hold_pins else None)
        slots, clears = self._scatter_merge(len(keys), parts_pos, results,
                                            "slots")
        return slots, np.asarray(clears, dtype=np.int32)

    def assign_batch_ints_multi(self, keys: np.ndarray, lids: np.ndarray,
                                pinned: Optional[Set[int]] = None,
                                hold_pins: bool = False):
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        lids = np.ascontiguousarray(lids, dtype=np.uint64)

        def run(p, pos, pins):
            return self._parts[p].assign_batch_ints_multi(
                keys[pos], lids[pos], pinned=pins, hold_pins=hold_pins)

        parts_pos, results = self._parallel(
            keys, pinned, run,
            unpin_of=(lambda res: res[0]) if hold_pins else None)
        slots, clears = self._scatter_merge(len(keys), parts_pos, results,
                                            "slots")
        return slots, np.asarray(clears, dtype=np.int32)

    def assign_batch_ints_uniques(self, keys: np.ndarray, lid: int,
                                  rank_bits: int,
                                  pinned: Optional[Set[int]] = None,
                                  hold_pins: bool = False):
        keys = np.ascontiguousarray(keys, dtype=np.int64)

        def run(p, pos, pins):
            return self._parts[p].assign_batch_ints_uniques(
                keys[pos], lid, rank_bits, pinned=pins,
                hold_pins=hold_pins)

        parts_pos, results = self._parallel(
            keys, pinned, run,
            unpin_of=self._unpin_uniques(rank_bits) if hold_pins else None)
        return self._scatter_merge(len(keys), parts_pos, results, "uniques",
                                   rank_bits)

    def assign_batch_ints_multi_uniques(self, keys: np.ndarray,
                                        lids: np.ndarray, rank_bits: int,
                                        pinned: Optional[Set[int]] = None,
                                        hold_pins: bool = False):
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        lids = np.ascontiguousarray(lids, dtype=np.uint64)

        def run(p, pos, pins):
            return self._parts[p].assign_batch_ints_multi_uniques(
                keys[pos], lids[pos], rank_bits, pinned=pins,
                hold_pins=hold_pins)

        parts_pos, results = self._parallel(
            keys, pinned, run,
            unpin_of=self._unpin_uniques(rank_bits) if hold_pins else None)
        return self._scatter_merge(len(keys), parts_pos, results, "uniques",
                                   rank_bits)

    def assign_batch_fps(self, h1: np.ndarray, h2: np.ndarray,
                         pinned: Optional[Set[int]] = None,
                         hold_pins: bool = False):
        def run_fp(p, h1, h2, pins):
            return self._parts[p].assign_batch_fps(
                h1, h2, pinned=pins, hold_pins=hold_pins)

        parts_pos, results = self._parallel_fps(
            h1, h2, pinned, run_fp,
            unpin_of=(lambda res: res[0]) if hold_pins else None)
        slots, clears = self._scatter_merge(len(h1), parts_pos, results,
                                            "slots")
        return slots, np.asarray(clears, dtype=np.int32)

    def assign_batch_fps_uniques(self, h1: np.ndarray, h2: np.ndarray,
                                 rank_bits: int,
                                 pinned: Optional[Set[int]] = None,
                                 hold_pins: bool = False):
        def run_fp(p, h1, h2, pins):
            return self._parts[p].assign_batch_fps_uniques(
                h1, h2, rank_bits, pinned=pins, hold_pins=hold_pins)

        parts_pos, results = self._parallel_fps(
            h1, h2, pinned, run_fp,
            unpin_of=self._unpin_uniques(rank_bits) if hold_pins else None)
        return self._scatter_merge(len(h1), parts_pos, results, "uniques",
                                   rank_bits)

    def assign_batch_strs(self, keys, lid: int,
                          pinned: Optional[Set[int]] = None,
                          hold_pins: bool = False, start: int = 0,
                          count: int | None = None):
        """The string keys ``keys[start:start + count]`` of one limiter,
        hashed once, then :meth:`assign_batch_fps`."""
        h1, h2 = hash_str_keys(keys, lid, start, count)
        return self.assign_batch_fps(h1, h2, pinned=pinned,
                                     hold_pins=hold_pins)

    def assign_batch_strs_uniques(self, keys, lid: int, rank_bits: int,
                                  pinned: Optional[Set[int]] = None,
                                  hold_pins: bool = False, start: int = 0,
                                  count: int | None = None):
        """The string keys ``keys[start:start + count]`` of one limiter,
        hashed once, then :meth:`assign_batch_fps_uniques`."""
        h1, h2 = hash_str_keys(keys, lid, start, count)
        return self.assign_batch_fps_uniques(h1, h2, rank_bits,
                                             pinned=pinned,
                                             hold_pins=hold_pins)

    # -- held pins -------------------------------------------------------------
    def _per_part(self, slots, fn_name: str) -> None:
        slots = _slots_i32(slots)
        part = slots // self.slots_per_part
        for q, sub in enumerate(self._parts):
            m = part == q
            if m.any():
                getattr(sub, fn_name)(
                    slots[m] - np.int32(q * self.slots_per_part))

    def pin_batch(self, slots) -> None:
        """Refcounted pins on global slots, each in its partition."""
        self._per_part(slots, "pin_batch")

    def unpin_batch(self, slots) -> None:
        """Release pins on global slots, each in its partition."""
        self._per_part(slots, "unpin_batch")

    # -- fingerprint enumeration (checkpoints) ---------------------------------
    # No restore_fp: a fingerprint does not carry its key's partition, so
    # only the checkpoint's per-partition payloads restore (sub-index by
    # sub-index); a flat fingerprint dump is refused there.
    def dump_fp(self):
        """Every partition's (h1, h2, slots) with the partition's slot base
        folded in, concatenated partition by partition (each one most
        recent first)."""
        h1s, h2s, slots = [], [], []
        for p, part in enumerate(self._parts):
            h1, h2, sl = part.dump_fp()
            h1s.append(h1)
            h2s.append(h2)
            slots.append(sl + np.int32(p * self.slots_per_part))
        return np.concatenate(h1s), np.concatenate(h2s), np.concatenate(slots)

    def lookup_fps(self, h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
        """Global slots of the given fingerprints (-1 if absent), probing
        every partition (a fingerprint does not say its partition); no
        LRU touch."""
        h1, h2 = _fingerprints(h1, h2)
        out = np.full(len(h1), -1, dtype=np.int32)
        for p, sub in enumerate(self._parts):
            local = sub.lookup_fps(h1, h2)
            hit = (out == -1) & (local >= 0)
            out[hit] = local[hit] + p * self.slots_per_part
        return out
