"""The sharded engine: the slot array split over several devices
(counterpart of ``ratelimiter_tpu/parallel/sharded.py``).

Keys are pinned to shards by hash (``engine/routing.py``: splitmix64 for
int keys, the index fingerprint's h1 for string keys), so a request batch
splits on the host into per-shard parts and every shard decides its part
with LOCAL slot ids and no traffic to any other shard.  Global slot =
``shard * slots_per_shard + local``.

The reference runs one ``shard_map`` program over its mesh and sums the
step totals with a ``psum``.  Here each shard's state is its own pair of
int32 tensors, ``(S_local, 6)`` and ``(S_local, 4)``, on its own device,
and each shard runs the single-device steps of ``ops/`` on its part: the
micro step (the solver and the write-back kernels), the flat step and its
K-step scan, the relay digest (the relay-step kernel for one limiter),
words mode and the clears (the row scatter).  The totals are summed on
the host.

Streams.  On CUDA every shard owns a stream on its device; all of a
shard's work (uploads, steps, reads, the copy of the limiter table it
reads) runs under ``torch.cuda.device(dev)`` and ``torch.cuda.stream(s)``
(:meth:`ShardedDeviceEngine._on`), since a kernel wrapper launches on the
calling thread's current device and stream.  A tensor is made on the
stream that uses it, so no tensor crosses streams; a result is copied to
the host on its shard's stream.  Whole-engine reads (the state views,
``read_rows``, checkpoints) read each shard on its own stream, after the
work queued there.

Locks.  Each shard has an RLock.  Per-shard paths (the relay dispatch,
``clear_shard``) take only theirs; whole-engine paths take every one in
ascending order (:meth:`ShardedDeviceEngine._exclusive`), so they never
deadlock against each other.  Each path marks the attached journal after
its steps are enqueued, under the locks it holds (the reference marks
before taking them, ROADMAP C10).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import numpy as np
import torch

from ratelimiter_tpu_torch.engine.engine import (
    _COUNTS_TORCH,
    _DECODE,
    _FLAT_STEPS,
    _RELAY_BITS_STEPS,
    _RELAY_STEPS,
    _SCAN_STEPS,
    _STEPS,
    MICRO_STAGE_ROWS,
)
from ratelimiter_tpu_torch.engine.native_index import NativeSlotIndex
from ratelimiter_tpu_torch.engine.routing import (
    route_count,
    shard_of_int_keys,
    shard_of_key,
)
from ratelimiter_tpu_torch.engine.slots import SlotIndex
from ratelimiter_tpu_torch.engine.state import (
    LimiterTable,
    SWState,
    TableArrays,
    TBState,
)
from ratelimiter_tpu_torch.ops import lease as lease_ops
from ratelimiter_tpu_torch.ops import relay as relay_ops
from ratelimiter_tpu_torch.ops.scatter import scatter_rows
from ratelimiter_tpu_torch.ops.sliding_window import (
    make_sw_packed,
    sw_pack_state,
    sw_peek_p,
    sw_reset_p,
    sw_unpack_state,
)
from ratelimiter_tpu_torch.ops.token_bucket import (
    make_tb_packed,
    tb_pack_state,
    tb_peek_p,
    tb_reset_p,
    tb_unpack_state,
)
from ratelimiter_tpu_torch.ops.transfer import device_scalar, land, to_device
from ratelimiter_tpu_torch.parallel.mesh import make_devices

__all__ = ["ShardedDeviceEngine", "ShardedSlotIndex", "shard_of_int_keys",
           "shard_of_key"]

# Micro lanes bucket from here up the pow2 ladder (the flat engine's floor).
_MICRO_FLOOR = 32
_RELAY_LANE_STEPS = {"sw": relay_ops.sw_relay_counts_lanes,
                     "tb": relay_ops.tb_relay_counts_lanes}
_PEEKS = {"sw": sw_peek_p, "tb": tb_peek_p}
_RESETS = {"sw": sw_reset_p, "tb": tb_reset_p}
_LANES = {"sw": 6, "tb": 4}


def _bucket(n: int, floor: int = 256) -> int:
    """Smallest power-of-two multiple of ``floor`` at or above ``n``."""
    size = floor
    while size < n:
        size *= 2
    return size


class ShardedSlotIndex:
    """Key -> global slot with one LRU sub-index per shard; eviction is
    shard-local (a key's state never moves between shards).

    The sub-indexes are the C index (``engine/native_index.py``), which
    builds or raises, or with ``native=False`` the keyed Python index
    (``engine/slots.py``, for ``checkpointable=True``).  The reference
    falls back to the Python index when its library is missing; the port
    does not."""

    def __init__(self, slots_per_shard: int, n_shards: int,
                 native: bool = True):
        self.slots_per_shard = int(slots_per_shard)
        self.n_shards = int(n_shards)
        self.num_slots = self.slots_per_shard * self.n_shards
        sub_cls = NativeSlotIndex if native else SlotIndex
        self._sub = [sub_cls(self.slots_per_shard)
                     for _ in range(self.n_shards)]
        # The sharded streams assign per shard in batches: ints need the
        # C index's batch assigns, strings its fingerprint assigns.
        self.supports_batch_ints = all(
            hasattr(s, "assign_batch_ints") for s in self._sub)
        self.supports_batch_strs = all(
            hasattr(s, "assign_batch_fps_uniques") for s in self._sub)

    def get(self, key):
        shard = shard_of_key(key, self.n_shards)
        local = self._sub[shard].get(key)
        return None if local is None else shard * self.slots_per_shard + local

    def assign(self, key, pinned=None, hold_pin=False):
        shard = shard_of_key(key, self.n_shards)
        local_pinned = None
        if pinned:
            local_pinned = {s % self.slots_per_shard for s in pinned
                            if s // self.slots_per_shard == shard}
        local, evicted = self._sub[shard].assign(key, pinned=local_pinned,
                                                 hold_pin=hold_pin)
        base = shard * self.slots_per_shard
        return base + local, None if evicted is None else base + evicted

    def remove(self, key):
        shard = shard_of_key(key, self.n_shards)
        local = self._sub[shard].remove(key)
        return None if local is None else shard * self.slots_per_shard + local

    def __len__(self):
        return sum(len(s) for s in self._sub)

    def _by_shard(self, slots, fn_name: str) -> None:
        slots = np.ascontiguousarray(slots, dtype=np.int64)
        shard = slots // self.slots_per_shard
        for q, sub in enumerate(self._sub):
            m = shard == q
            if m.any():
                getattr(sub, fn_name)(
                    (slots[m] - q * self.slots_per_shard).astype(np.int32))

    def pin_batch(self, slots) -> None:
        self._by_shard(slots, "pin_batch")

    def unpin_batch(self, slots) -> None:
        self._by_shard(slots, "unpin_batch")


class ShardedDeviceEngine:
    """The surface of ``engine/engine.py:DeviceEngine`` (global slot ids
    in, numpy decisions out) over per-shard state on ``devices`` (default:
    every visible CUDA device; ``parallel/mesh.py:make_devices``), plus
    the per-shard relay dispatch and clear of the sharded streams and
    ``route_on_device``.  ``last_step_totals`` is ``(allowed, total)`` of
    the newest drained micro step, summed over the shards."""

    # Every mutation path marks its slots in ``journal`` (global ids).
    supports_replication = True

    def __init__(self, slots_per_shard: int, table: LimiterTable,
                 devices=None):
        self.devices = make_devices(devices)
        self.n_shards = len(self.devices)
        self.slots_per_shard = int(slots_per_shard)
        self.num_slots = self.n_shards * self.slots_per_shard
        # The storage's device: the table and the host-facing helpers.
        self.device = self.devices[0]
        if make_devices([table.device])[0] != self.device:
            raise ValueError(f"table lives on {table.device}, the first "
                             f"shard on {self.device}")
        self.table = table
        self.journal = None
        # Upload bytes by way (ops/transfer.py:to_device); CUDA only.
        self.upload_bytes = {"pinned": 0, "copied": 0}
        self._lock = threading.RLock()
        self._shard_locks = [threading.RLock() for _ in self.devices]
        self.last_step_totals = (0, 0)
        # Concurrent drains finish in any order; a monotone stamp keeps
        # last_step_totals from going back to an older step.
        self._totals_seq = 0
        self._totals_seen = 0
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                         else None for d in self.devices]
        # Per-shard copies of the table's device arrays, keyed by the
        # TableArrays instance (rebuilt on any policy change).
        self._table_parts: tuple = (None, {})
        self._parts = {"sw": [], "tb": []}
        for q, d in enumerate(self.devices):
            with self._on(q):
                self._parts["sw"].append(make_sw_packed(
                    self.slots_per_shard, d))
                self._parts["tb"].append(make_tb_packed(
                    self.slots_per_shard, d))
        # Relay word layout per SHARD: the slot field covers
        # slots_per_shard, so the rank field is wider than one device's
        # at the same total capacity.
        self.rank_bits = 31 - max(self.slots_per_shard.bit_length(), 1)

    # -- devices, streams, locks ------------------------------------------------
    @contextlib.contextmanager
    def _on(self, q: int):
        """Run the enclosed torch work on shard ``q``'s device and stream
        (a no-op for a CPU shard)."""
        stream = self._streams[q]
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[q]), torch.cuda.stream(stream):
            yield

    @contextlib.contextmanager
    def _exclusive(self):
        """Hold every shard lock, ascending (the per-shard paths take one,
        so the order cannot deadlock)."""
        for lk in self._shard_locks:
            lk.acquire()
        try:
            yield
        finally:
            for lk in reversed(self._shard_locks):
                lk.release()

    def _table_for(self, q: int) -> TableArrays:
        """Shard ``q``'s copy of the limiter table, made on its stream.
        Taken before the shard lock (it takes the engine lock, and the
        lock order is engine, then shard)."""
        src = self.table.device_arrays
        with self._lock:
            cache_src, per = self._table_parts
            if cache_src is not src:
                per = {}
                self._table_parts = (src, per)
            tab = per.get(q)
            if tab is None:
                with self._on(q):
                    stream = self._streams[q]
                    if stream is not None and src[0].device == stream.device:
                        # The copy reads the source on this stream: keep
                        # its memory from reuse until the copy is done.
                        # (A copy across devices orders itself.)
                        for t in src:
                            t.record_stream(stream)
                    tab = TableArrays(*(t.to(self.devices[q], copy=True)
                                        for t in src))
                per[q] = tab
            return tab

    def _upload(self, q: int, values, dtype) -> torch.Tensor:
        """A host array as a tensor of ``dtype`` (numpy's) on shard ``q``
        (call under :meth:`_on`), without waiting for the shard's stream
        (``ops/transfer.py:to_device``: a page-locked array goes up as it
        is).  On a CPU shard it may alias the array, so the caller must
        not change it before the result is drained."""
        return to_device(values, dtype, self.devices[q], self.upload_bytes)

    def _upload_words(self, q: int, words) -> torch.Tensor:
        return self._upload(q, np.ascontiguousarray(
            words, dtype=np.uint32).view(np.int32), np.int32)

    def _lid_lanes(self, q: int, lids) -> torch.Tensor:
        if np.ndim(lids) == 0:
            return device_scalar(int(lids), self.devices[q])
        return self._upload(q, lids, np.int32)

    def fetch(self, q: int, tensor: torch.Tensor) -> np.ndarray:
        """A shard's result on the host, copied on its stream (so after
        the step that made it)."""
        with self._on(q):
            return tensor.cpu().numpy()

    def land(self, q: int, tensor: torch.Tensor, host: np.ndarray):
        """Start copying shard ``q``'s CUDA result into the page-locked
        ``host`` array on the shard's stream, after the step that made it;
        returns the CUDA event recorded behind the copy
        (``ops/transfer.py:land``).  The stream loops' drains wait on that
        event alone."""
        with self._on(q):
            return land(tensor, host)

    def fetch_matrix(self, handle, width: int, dtype) -> np.ndarray:
        """A per-shard result handle (one tensor or None a shard) as an
        ``(n_shards, width)`` host array; shards that ran nothing give
        zeros."""
        out = np.zeros((self.n_shards, width), dtype=dtype)
        for q, t in enumerate(handle):
            if t is not None:
                arr = self.fetch(q, t)
                out[q, :arr.shape[-1]] = arr.reshape(-1)[:width]
        return out

    # -- dirty-slot journal hooks ----------------------------------------------
    def _mark_mat(self, algo: str, mat) -> None:
        j = self.journal
        if j is not None:
            j.mark_matrix(algo, mat, self.slots_per_shard)

    def _mark_global(self, algo: str, slots) -> None:
        j = self.journal
        if j is not None:
            j.mark(algo, slots)

    def _mark_words_shard(self, algo: str, q: int, words) -> None:
        """Journal one shard's relay words: the LOCAL slot field plus the
        shard's base; padding decodes past slots_per_shard and is
        dropped."""
        j = self.journal
        if j is None:
            return
        loc = (np.asarray(words).astype(np.uint64)
               >> np.uint64(self.rank_bits + 1)).astype(np.int64)
        base = q * self.slots_per_shard
        j.mark(algo, np.where(loc < self.slots_per_shard, loc + base, -1))

    # -- state views (checkpoints) ----------------------------------------------
    def packed_host(self, algo: str) -> np.ndarray:
        """The whole packed state, ``(num_slots, L)`` int32 on the host in
        global slot order, each shard read on its stream."""
        with self._lock, self._exclusive():
            return np.concatenate([self.fetch(q, p) for q, p in
                                   enumerate(self._parts[algo])])

    @property
    def sw_state(self) -> SWState:
        return sw_unpack_state(torch.from_numpy(self.packed_host("sw")))

    @sw_state.setter
    def sw_state(self, state) -> None:
        self._copy_in("sw", sw_pack_state(self._fields(state)))

    @property
    def tb_state(self) -> TBState:
        return tb_unpack_state(torch.from_numpy(self.packed_host("tb")))

    @tb_state.setter
    def tb_state(self, state) -> None:
        self._copy_in("tb", tb_pack_state(self._fields(state)))

    @staticmethod
    def _fields(state):
        """A state tuple's fields as flat int64 CPU tensors."""
        return type(state)(*(torch.as_tensor(
            np.asarray(f.cpu() if isinstance(f, torch.Tensor) else f),
            dtype=torch.int64).reshape(-1) for f in state))

    def _copy_in(self, algo: str, src: torch.Tensor) -> None:
        """Copy a whole ``(num_slots, L)`` packed state into the shards'
        resident tensors, in place, each on its stream."""
        if tuple(src.shape) != (self.num_slots, _LANES[algo]):
            raise ValueError(f"state of shape {tuple(src.shape)} for "
                             f"{self.num_slots} slots")
        sps = self.slots_per_shard
        with self._lock, self._exclusive():
            for q, part in enumerate(self._parts[algo]):
                with self._on(q):
                    part.copy_(src[q * sps:(q + 1) * sps].to(
                        self.devices[q]))
            if self.journal is not None:
                self.journal.mark_all(algo)

    def make_slot_index(self) -> ShardedSlotIndex:
        return ShardedSlotIndex(self.slots_per_shard, self.n_shards)

    # -- routing ---------------------------------------------------------------
    def _route(self, slots, floor: int = _MICRO_FLOOR):
        """Split global-slot requests into an ``(n_shards, B)`` matrix of
        local slots (-1 padding; requests with a negative slot go to
        shard 0 as padding).  Returns ``(mat, shard, cols, counts)``: each
        request's shard row and column, and the requests per shard."""
        slots = np.asarray(slots, dtype=np.int64)
        shard = np.clip(slots, 0, None) // self.slots_per_shard
        local = np.where(slots < 0, -1, slots % self.slots_per_shard)
        counts = np.bincount(shard, minlength=self.n_shards)
        width = _bucket(max(int(counts.max(initial=0)), 1), floor)
        order = np.argsort(shard, kind="stable")
        offsets = np.zeros(self.n_shards + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        cols = np.empty(len(slots), dtype=np.int64)
        cols[order] = np.arange(len(slots)) - offsets[shard[order]]
        mat = np.full((self.n_shards, width), -1, dtype=np.int32)
        mat[shard, cols] = local
        return mat, shard, cols, counts

    def route_on_device(self, key_ids=None, hashes=None):
        """``(shard, order, counts)`` of one chunk binned on the first
        shard's device (``engine/routing.py:route_count``): the host C
        router's contract.  ``key_ids`` int64 keys, or ``hashes`` the
        uint64 fingerprint h1 of string keys."""
        int_keys = hashes is None
        arr = (np.ascontiguousarray(key_ids, dtype=np.int64) if int_keys
               else np.ascontiguousarray(hashes, dtype=np.uint64
                                         ).view(np.int64))
        with self._on(0):
            shard, order, counts = route_count(
                self._upload(0, arr, np.int64), self.n_shards, int_keys)
            return (shard.cpu().numpy(), order.cpu().numpy(),
                    counts.cpu().numpy())

    # -- the micro step ----------------------------------------------------------
    def _micro_dispatch(self, algo: str, slots, limiter_ids, permits,
                        now_ms: int):
        mat, shard, cols, counts = self._route(slots)
        width = mat.shape[1]
        lanes = np.zeros((self.n_shards, MICRO_STAGE_ROWS, width),
                         dtype=np.int64)
        lanes[:, 0] = mat
        lanes[:, 2] = 1
        lanes[shard, 1, cols] = np.asarray(limiter_ids, dtype=np.int64)
        lanes[shard, 2, cols] = np.asarray(permits, dtype=np.int64)
        lanes[:, 3, 0] = now_ms
        active = [q for q in range(self.n_shards) if counts[q]]
        tables = {q: self._table_for(q) for q in active}
        step = _STEPS[algo]
        outs = [None] * self.n_shards
        with self._lock, self._exclusive():
            for q in active:
                with self._on(q):
                    dev = self._upload(q, lanes[q], np.int64)
                    outs[q] = step(self._parts[algo][q], tables[q], dev[0],
                                   dev[1], dev[2], dev[3, 0])
            self._mark_mat(algo, mat)
            self._totals_seq += 1
            seq = self._totals_seq
        live = int((np.asarray(slots) >= 0).sum())
        return outs, shard, cols, seq, live

    def _micro_drain(self, algo: str, handle, n: int):
        outs, shard, cols, seq, live = handle
        fused = np.zeros((3, n), dtype=np.int64)
        for q, out in enumerate(outs):
            if out is None:
                continue
            arr = self.fetch(q, out)
            sel = shard == q
            fused[:, sel] = arr[:, cols[sel]]
        res = _DECODE[algo](fused)
        self._set_totals(seq, (int(res["allowed"].sum()), live))
        return res

    def _set_totals(self, seq: int, totals) -> None:
        with self._lock:
            if seq > self._totals_seen:
                self._totals_seen = seq
                self.last_step_totals = totals

    def micro_staged_dispatch(self, algo: str, staged: np.ndarray, n: int):
        """The micro-batcher's staged dispatch (``DeviceEngine``'s
        contract): ``staged`` the i64[4, cap] buffer, ``n`` its live
        lanes; the lanes are split by shard into buffers of their own."""
        return self._micro_dispatch(algo, staged[0, :n], staged[1, :n],
                                    staged[2, :n], int(staged[3, 0]))

    def micro_staged_drain(self, algo: str, handle, n: int):
        return self._micro_drain(algo, handle, n)

    def sw_acquire_dispatch(self, slots, limiter_ids, permits, now_ms: int):
        return self._micro_dispatch("sw", slots, limiter_ids, permits, now_ms)

    def sw_acquire_drain(self, handle, n: int):
        return self._micro_drain("sw", handle, n)

    def sw_acquire(self, slots, limiter_ids, permits, now_ms: int):
        """Batched sliding-window tryAcquire: a dict of numpy arrays
        (allowed, mutated, observed, cache_value) in request order."""
        return self.sw_acquire_drain(self.sw_acquire_dispatch(
            slots, limiter_ids, permits, now_ms), len(slots))

    def tb_acquire_dispatch(self, slots, limiter_ids, permits, now_ms: int):
        return self._micro_dispatch("tb", slots, limiter_ids, permits, now_ms)

    def tb_acquire_drain(self, handle, n: int):
        return self._micro_drain("tb", handle, n)

    def tb_acquire(self, slots, limiter_ids, permits, now_ms: int):
        return self.tb_acquire_drain(self.tb_acquire_dispatch(
            slots, limiter_ids, permits, now_ms), len(slots))

    # -- read-only and resets ----------------------------------------------------
    def _available(self, algo: str, slots, limiter_ids, now_ms: int):
        mat, shard, cols, counts = self._route(slots)
        lid_mat = np.zeros(mat.shape, dtype=np.int64)
        lid_mat[shard, cols] = np.asarray(limiter_ids, dtype=np.int64)
        mat = np.maximum(mat, 0)  # a padding lane's read is discarded
        out = np.zeros(len(shard), dtype=np.int64)
        active = [q for q in range(self.n_shards) if counts[q]]
        tables = {q: self._table_for(q) for q in active}
        with self._lock, self._exclusive():
            for q in active:
                with self._on(q):
                    got = _PEEKS[algo](
                        self._parts[algo][q], tables[q],
                        self._upload(q, mat[q], np.int64),
                        self._upload(q, lid_mat[q], np.int64), now_ms)
                    got = got.cpu().numpy()
                sel = shard == q
                out[sel] = got[cols[sel]]
        return out

    def sw_available(self, slots, limiter_ids, now_ms: int) -> np.ndarray:
        return self._available("sw", slots, limiter_ids, now_ms)

    def tb_available(self, slots, limiter_ids, now_ms: int) -> np.ndarray:
        return self._available("tb", slots, limiter_ids, now_ms)

    def _clear(self, algo: str, slots) -> None:
        mat, _, _, counts = self._route(slots)
        with self._lock, self._exclusive():
            for q in range(self.n_shards):
                if counts[q]:
                    with self._on(q):
                        _RESETS[algo](self._parts[algo][q],
                                      self._upload(q, mat[q], np.int64))
            self._mark_mat(algo, mat)

    def sw_clear(self, slots: Sequence[int]) -> None:
        self._clear("sw", slots)

    def tb_clear(self, slots: Sequence[int]) -> None:
        self._clear("tb", slots)

    def clear_shard(self, algo: str, shard: int, local_slots) -> None:
        """Zero LOCAL slots of one shard on its stream, under its lock
        only: the sharded streams' eviction clears.  Each shard's stream
        work is a FIFO, so a clear lands before the dispatch that reuses
        its slots, with no cross-shard barrier."""
        local = np.asarray(list(local_slots), dtype=np.int64)
        if not len(local):
            return
        with self._shard_locks[shard]:
            with self._on(shard):
                _RESETS[algo](self._parts[algo][shard],
                              self._upload(shard, local, np.int64))
            self._mark_global(algo, local + shard * self.slots_per_shard)

    # -- the stream steps ----------------------------------------------------------
    def relay_usable(self) -> bool:
        return relay_ops.relay_usable(self.rank_bits,
                                      self.table.max_permits_registered)

    def counts_dtype(self):
        return relay_ops.counts_dtype(self.table.max_permits_registered)

    def relay_shard_dispatch(self, algo: str, shard: int, flavor: str,
                             words, lids, now_ms: int, out_dtype=None):
        """ONE shard's relay step on its device and stream, under its lock
        only: the per-shard stream lanes' dispatch.  ``words`` uint32
        with LOCAL slots in the relay layout of ``rank_bits`` (padding
        0xFFFFFFFF); ``lids`` one limiter id or a lane (per unique for
        ``counts``, per request for ``bits``).  ``counts`` returns the
        ``out_dtype`` allowed counts per unique (one limiter: the relay
        step kernel); ``bits`` the packed allow bits of words mode.  The
        result stays on the card: :meth:`fetch` it."""
        tab = self._table_for(shard)
        part = self._parts[algo]
        with self._shard_locks[shard]:
            with self._on(shard):
                dev_words = self._upload_words(shard, words)
                if flavor == "bits":
                    out = _RELAY_BITS_STEPS[algo](
                        part[shard], tab, dev_words,
                        self._lid_lanes(shard, lids), int(now_ms),
                        rank_bits=self.rank_bits)
                elif np.ndim(lids) == 0:
                    out = _RELAY_STEPS[algo](
                        part[shard], tab, dev_words, int(lids), int(now_ms),
                        rank_bits=self.rank_bits,
                        out_dtype=_COUNTS_TORCH[np.dtype(out_dtype)])
                else:
                    out = _RELAY_LANE_STEPS[algo](
                        part[shard], tab, dev_words,
                        self._upload(shard, lids, np.int32), int(now_ms),
                        rank_bits=self.rank_bits,
                        out_dtype=_COUNTS_TORCH[np.dtype(out_dtype)])
            self._mark_words_shard(algo, shard, words)
        return out

    def _stream_lanes(self, q: int, lids, permits, dtype):
        """Shard ``q``'s lid and permit lanes of a whole-engine stream
        dispatch (one lid, or a lane; None permits stay None)."""
        lid_q = (self._lid_lanes(q, lids) if np.ndim(lids) == 0
                 else self._upload(q, lids[q], np.int32))
        perm_q = (None if permits is None
                  else self._upload(q, permits[q], dtype))
        return lid_q, perm_q

    def _flat_dispatch(self, algo: str, slots_sb, lids, permits_sb,
                       now_ms: int):
        """``slots_sb`` int32[n_shards, B] LOCAL slots (-1 padding);
        ``lids`` one limiter id or int32[n_shards, B]; ``permits_sb`` None
        or [n_shards, B] (uint8 when it is so, else int32).  One flat
        sorted step a shard with live lanes; returns the per-shard handle
        of uint8[ceil(B / 8)] allow bits (:meth:`fetch_matrix`)."""
        slots_sb = np.ascontiguousarray(slots_sb, dtype=np.int32)
        dtype = (np.uint8 if getattr(permits_sb, "dtype", None) == np.uint8
                 else np.int32)
        active = [q for q in range(self.n_shards) if (slots_sb[q] >= 0).any()]
        tables = {q: self._table_for(q) for q in active}
        outs = [None] * self.n_shards
        with self._lock, self._exclusive():
            for q in active:
                with self._on(q):
                    lid_q, perm_q = self._stream_lanes(q, lids, permits_sb,
                                                       dtype)
                    outs[q] = _FLAT_STEPS[algo](
                        self._parts[algo][q], tables[q],
                        self._upload(q, slots_sb[q], np.int32), lid_q,
                        perm_q, int(now_ms))
            self._mark_mat(algo, slots_sb)
        return outs

    def sw_flat_sharded_dispatch(self, slots_sb, lids, permits_sb, now_ms):
        return self._flat_dispatch("sw", slots_sb, lids, permits_sb, now_ms)

    def tb_flat_sharded_dispatch(self, slots_sb, lids, permits_sb, now_ms):
        return self._flat_dispatch("tb", slots_sb, lids, permits_sb, now_ms)

    def _scan_dispatch(self, algo: str, slots_skb, lids, permits_skb,
                       now_k):
        """``slots_skb`` int32[n_shards, K, B] LOCAL slots; ``lids`` one id
        or int32[n_shards, K, B]; ``permits_skb`` None or [n_shards, K, B];
        ``now_k`` int64[K].  K sequential steps a shard; returns the
        per-shard handle of uint8[K, ceil(B / 8)] bits."""
        slots_skb = np.ascontiguousarray(slots_skb, dtype=np.int32)
        dtype = (np.uint8 if getattr(permits_skb, "dtype", None) == np.uint8
                 else np.int32)
        tables = [self._table_for(q) for q in range(self.n_shards)]
        outs = [None] * self.n_shards
        with self._lock, self._exclusive():
            for q in range(self.n_shards):
                with self._on(q):
                    lid_q, perm_q = self._stream_lanes(q, lids, permits_skb,
                                                       dtype)
                    outs[q] = _SCAN_STEPS[algo](
                        self._parts[algo][q], tables[q],
                        self._upload(q, slots_skb[q], np.int32), lid_q,
                        perm_q, self._upload(q, now_k, np.int64))
            self._mark_mat(algo, slots_skb)
        return outs

    def sw_scan_dispatch(self, slots_skb, lids, permits_skb, now_k):
        return self._scan_dispatch("sw", slots_skb, lids, permits_skb, now_k)

    def tb_scan_dispatch(self, slots_skb, lids, permits_skb, now_k):
        return self._scan_dispatch("tb", slots_skb, lids, permits_skb, now_k)

    # -- raw packed rows -----------------------------------------------------------
    def read_rows(self, algo: str, slots) -> np.ndarray:
        """Packed rows of GLOBAL slots (host int32[n, L]), each shard's
        gathered on its stream."""
        slots = np.asarray(slots, dtype=np.int64)
        out = np.empty((len(slots), _LANES[algo]), dtype=np.int32)
        shard = slots // self.slots_per_shard
        with self._lock, self._exclusive():
            for q in np.unique(shard):
                sel = shard == q
                with self._on(int(q)):
                    idx = self._upload(int(q), slots[sel] % self.slots_per_shard,
                                       np.int64)
                    out[sel] = self._parts[algo][int(q)][idx].cpu().numpy()
        return out

    def write_rows(self, algo: str, slots, rows: np.ndarray) -> None:
        """Overwrite packed rows of GLOBAL slots (unique), each shard's
        through the row scatter on its stream."""
        slots = np.asarray(slots, dtype=np.int64)
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        shard = slots // self.slots_per_shard
        with self._lock, self._exclusive():
            for q in np.unique(shard):
                q = int(q)
                sel = shard == q
                with self._on(q):
                    idx = self._upload(q, slots[sel] % self.slots_per_shard,
                                       np.int64)
                    scatter_rows(self._parts[algo][q], idx,
                                 torch.ones_like(idx, dtype=torch.bool),
                                 self._upload(q, rows[sel], np.int32))
            self._mark_global(algo, slots)

    # -- lease reserve / credit (ops/lease.py host mirrors) ------------------------
    # A read-rows -> host arithmetic -> write-rows round trip under every
    # shard lock (read_rows and write_rows re-enter them), as the
    # reference's sharded engine does.  Callers pass unique slots.
    def lease_reserve(self, algo: str, slots, limiter_ids, requested,
                      now_ms: int):
        slots = np.asarray(slots, dtype=np.int64)
        with self._lock, self._exclusive():
            rows = self.read_rows(algo, slots)
            granted, ws, new_rows, changed = lease_ops.host_reserve_rows(
                algo, rows, np.asarray(limiter_ids, dtype=np.int64),
                np.asarray(requested, dtype=np.int64),
                self.table.host_policy, int(now_ms))
            if changed.any():
                self.write_rows(algo, slots[changed], new_rows[changed])
        return granted, ws

    def lease_credit(self, algo: str, slots, limiter_ids, credit, grant_ws,
                     now_ms: int) -> np.ndarray:
        slots = np.asarray(slots, dtype=np.int64)
        with self._lock, self._exclusive():
            rows = self.read_rows(algo, slots)
            credited, new_rows, changed = lease_ops.host_credit_rows(
                algo, rows, np.asarray(limiter_ids, dtype=np.int64),
                np.asarray(credit, dtype=np.int64),
                np.asarray(grant_ws, dtype=np.int64),
                self.table.host_policy, int(now_ms))
            if changed.any():
                self.write_rows(algo, slots[changed], new_rows[changed])
        return credited

    def block_until_ready(self) -> None:
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)
