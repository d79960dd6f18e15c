"""Single-device decision engine (counterpart of
``ratelimiter_tpu/engine/engine.py``): the micro-batch route and the
stream routes (the relay in its three modes — digest, words and resident
digest —, the weighted relay, the flat sorted step and its K-step scan),
and the lease reserve and credit steps.  Every mutation path marks the
slots it touches in the replication journal when one is attached
(``replication/log.py``).

Owns the device-resident packed slot state for both algorithms and runs
the steps on it.  The state tensors are updated in place (the reference
donated its buffers to jitted steps); every access goes through one lock
so the ops of two dispatches never interleave.

A dispatch enqueues its step on the current CUDA stream and returns the
output tensor without waiting: the fused ``i64[3, B]`` of a micro step,
the per-unique allowed counts of a relay step, or the packed allow bits
of a words-mode, flat, scan or weighted step.  The stream dispatches'
uploads and scalars go through page-locked memory (``ops/transfer.py``),
so an enqueue never waits for the steps before it; the stream loops land
each result in a pinned buffer behind a CUDA event (``storage/gpu.py``),
and the micro route's drain is the ``.cpu()`` copy of its tensor, which
waits for the step.  On a CPU engine (``device="cpu"``, as the tests run
it) the same code runs the plain versions of the kernels synchronously.

This is the device half of ``GpuBatchedStorage``; the host half (key->slot
index + micro-batcher) lives in engine/native_index.py,
engine/partitioned.py and engine/batcher.py.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from ratelimiter_tpu_torch.engine.state import LimiterTable, SWState, TBState
from ratelimiter_tpu_torch.ops import lease as lease_ops
from ratelimiter_tpu_torch.ops import relay as relay_ops
from ratelimiter_tpu_torch.ops.flat import sw_flat_bits, tb_flat_bits
from ratelimiter_tpu_torch.ops.packed import (
    decode_sw_fused,
    decode_tb_fused,
    sw_scan_bits,
    sw_step_fused,
    tb_scan_bits,
    tb_step_fused,
)
from ratelimiter_tpu_torch.ops.scatter import scatter_rows
from ratelimiter_tpu_torch.ops.transfer import device_scalar, to_device
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

# Micro-batch floor: small batches bucket at {32, 64, 128} before joining
# the pow2 ladder, so a handful of shapes serve every batch size.
_MICRO_FLOOR = 32

# Staged micro-batch layout: one i64[4, B] host buffer carries the whole
# batch — row 0 slots (pad -1), row 1 limiter ids (pad 0), row 2 permits
# (pad 1), row 3 lane 0 the batch timestamp — so a dispatch is one copy to
# the device.
MICRO_STAGE_ROWS = 4

_STEPS = {"sw": sw_step_fused, "tb": tb_step_fused}
_DECODE = {"sw": decode_sw_fused, "tb": decode_tb_fused}
_RELAY_STEPS = {"sw": relay_ops.sw_relay_counts,
                "tb": relay_ops.tb_relay_counts}
_RELAY_BITS_STEPS = {"sw": relay_ops.sw_relay_bits,
                     "tb": relay_ops.tb_relay_bits}
_SPLIT_STEPS = {"sw": relay_ops.sw_relay_counts_split,
                "tb": relay_ops.tb_relay_counts_split}
_RESIDENT_STEPS = {"sw": relay_ops.sw_relay_counts_resident,
                   "tb": relay_ops.tb_relay_counts_resident}
_FLAT_STEPS = {"sw": sw_flat_bits, "tb": tb_flat_bits}
_SCAN_STEPS = {"sw": sw_scan_bits, "tb": tb_scan_bits}
_WEIGHTED_STEPS = {"sw": relay_ops.sw_relay_weighted,
                   "tb": relay_ops.tb_relay_weighted}
_WEIGHTED_COUNTS_STEPS = {"sw": relay_ops.sw_relay_weighted_counts,
                          "tb": relay_ops.tb_relay_weighted_counts}
# Per-unique count dtypes of the relay route: numpy's on the host, torch's
# on the device.
_COUNTS_TORCH = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.uint16): torch.uint16}


def _bucket_size(n: int) -> int:
    size = _MICRO_FLOOR
    while size < n:
        size *= 2
    return size


class DeviceEngine:
    """Batched decision engine over device-resident counter rows."""

    # Every mutation path marks its slots in ``journal`` (replication).
    supports_replication = True

    def __init__(self, num_slots: int, table: LimiterTable, *, device):
        self.num_slots = int(num_slots)
        self.device = torch.device(device)
        if table.device != self.device:
            raise ValueError(f"table lives on {table.device}, engine on "
                             f"{self.device}")
        self.table = table
        self._lock = threading.RLock()
        self.sw_packed = make_sw_packed(self.num_slots, self.device)
        self.tb_packed = make_tb_packed(self.num_slots, self.device)
        # Relay word layout (ops/relay.py): the slot field covers num_slots
        # with the all-ones padding word left over; the remaining bits of
        # the uint32 carry the clamped request count.
        self.slot_bits = max(self.num_slots.bit_length(), 1)
        self.rank_bits = 31 - self.slot_bits
        # Largest per-request permits the weighted relay carries (a uint8
        # permits lane); larger permits take the flat sorted step.
        self.weighted_permit_cap = 255
        # The resident digest's limiter id per slot, one map per
        # algorithm: a slot's lid cannot change while it is assigned, so
        # the storage uploads only the pairs the map does not hold yet.
        self.sw_lid_map = torch.zeros(self.num_slots, dtype=torch.int32,
                                      device=self.device)
        self.tb_lid_map = torch.zeros(self.num_slots, dtype=torch.int32,
                                      device=self.device)
        # Optional dirty-slot journal (engine/state.py: SlotJournal or
        # DeviceSlotJournal): when set, every mutation path marks the slots
        # its step touches; replication/log.py drains it into epoch frames.
        # None (the default) costs one attribute check a dispatch.
        self.journal = None
        # Bytes the uploads sent from page-locked buffers as they were
        # ("pinned") and through a pinned copy ("copied"); CUDA only.
        self.upload_bytes = {"pinned": 0, "copied": 0}

    # -- dirty-slot journal hooks (replication) --------------------------------
    # Each hook takes the host lane array and, where the dispatch uploaded
    # it, the same lanes on the device: a device journal marks from the
    # device tensor (no host work, no extra upload), the host journal from
    # the numpy array (a device tensor would force a copy back).
    #
    # A mutation marks its slots after its step is enqueued, under the
    # engine lock (the reference marks before taking the lock, ROADMAP
    # C10).  A cut drains the journal and then reads the rows under the
    # same lock, so a mark it drains belongs to a step enqueued before the
    # read, and a step it cannot see yet marks into the next epoch.
    def _mark(self, algo: str, slots, dev=None) -> None:
        j = self.journal
        if j is not None:
            j.mark(algo, dev if dev is not None
                   and getattr(j, "device", False) else slots)

    def _mark_words(self, algo: str, words, dev=None) -> None:
        """Mark from relay words (slot in the high bits; padding words
        decode past num_slots and are filtered by the journal)."""
        j = self.journal
        if j is not None:
            j.mark_words(algo, dev if dev is not None
                         and getattr(j, "device", False) else words,
                         self.rank_bits)

    def _lanes(self, values) -> torch.Tensor:
        """Host lane values as an int64 tensor on the engine's device,
        through pinned memory (a clear inside a stream never waits for the
        steps queued before it)."""
        return to_device(np.asarray(values, dtype=np.int64), np.int64,
                         self.device)

    def _upload(self, values, dtype) -> torch.Tensor:
        """A host array as a tensor of ``dtype`` (numpy's) on the device,
        without waiting for the card (``ops/transfer.py:to_device``): a
        page-locked array of ``dtype`` (a stream's staging buffer) goes up
        as it is, without a host copy.  On a CPU engine the tensor may
        alias the array, so the caller must not change it before the
        step's result is drained."""
        return to_device(values, dtype, self.device, self.upload_bytes)

    def _upload_words(self, uwords) -> torch.Tensor:
        """Relay words (uint32 on the host) as an int32 tensor of the same
        bits on the device."""
        return self._upload(np.ascontiguousarray(
            uwords, dtype=np.uint32).view(np.int32), np.int32)

    def _lid_lanes(self, lids) -> torch.Tensor:
        """One limiter id as a 0-d int64 tensor, or a lane of them."""
        if np.ndim(lids) == 0:
            return device_scalar(int(lids), self.device)
        return self._upload(lids, np.int32)

    def _permit_lanes(self, permits):
        """Permits as uint8 lanes when the host built them so (every
        permit in [0, 255]), else int32; None stays None (unit)."""
        if permits is None:
            return None
        dtype = (np.uint8 if getattr(permits, "dtype", None) == np.uint8
                 else np.int32)
        return self._upload(permits, dtype)

    def _packed(self, algo: str) -> torch.Tensor:
        return self.sw_packed if algo == "sw" else self.tb_packed

    # -- i64 field view (checkpoints) -----------------------------------------
    # Reading a view decodes the resident packed tensor.  Setting one
    # encodes the fields and copies them into the resident tensor in
    # place: the steps write that tensor in place and other holders keep
    # a reference to it, so it is never rebound.
    @property
    def sw_state(self) -> SWState:
        with self._lock:
            return sw_unpack_state(self.sw_packed)

    @sw_state.setter
    def sw_state(self, state: SWState) -> None:
        self._copy_in("sw", sw_pack_state(self._fields(state)))

    @property
    def tb_state(self) -> TBState:
        with self._lock:
            return tb_unpack_state(self.tb_packed)

    @tb_state.setter
    def tb_state(self, state: TBState) -> None:
        self._copy_in("tb", tb_pack_state(self._fields(state)))

    def _fields(self, state):
        """A state tuple's fields (numpy arrays or tensors) as int64
        tensors on the engine's device."""
        return type(state)(*(torch.as_tensor(f, dtype=torch.int64,
                                             device=self.device)
                             for f in state))

    def _copy_in(self, algo: str, src: torch.Tensor) -> None:
        dst = self._packed(algo)
        if src.shape != dst.shape:
            raise ValueError(f"state of shape {tuple(src.shape)} for a "
                             f"resident tensor of {tuple(dst.shape)}")
        with self._lock:
            dst.copy_(src)
            if self.journal is not None:
                self.journal.mark_all(algo)

    # -- acquire --------------------------------------------------------------
    # Each step is split into DISPATCH (enqueue, state updated, returns the
    # fused output tensor — engine lock held only here) and DRAIN (the
    # blocking device->host copy + decode, outside the lock), so the
    # micro-batcher can keep several batches in flight.

    def _acquire_dispatch(self, algo: str, slots, limiter_ids, permits,
                          now_ms: int):
        """List-surface dispatch: stage the batch into a combined buffer
        and run the same staged step the micro-batcher's flusher uses."""
        n = len(slots)
        size = _bucket_size(n)
        staged = np.empty((MICRO_STAGE_ROWS, size), dtype=np.int64)
        staged[0] = -1
        staged[1] = 0
        staged[2] = 1
        staged[0, :n] = np.asarray(slots, dtype=np.int64)
        staged[1, :n] = np.asarray(limiter_ids, dtype=np.int64)
        staged[2, :n] = np.asarray(permits, dtype=np.int64)
        staged[3, 0] = now_ms
        return self.micro_staged_dispatch(algo, staged, n)

    def sw_acquire_dispatch(self, slots, limiter_ids, permits, now_ms: int):
        """Dispatch a sliding-window batch; returns the fused output
        tensor (pass to :meth:`sw_acquire_drain` with the batch length)."""
        return self._acquire_dispatch("sw", slots, limiter_ids, permits,
                                      now_ms)

    @staticmethod
    def sw_acquire_drain(handle, n: int):
        return DeviceEngine.micro_staged_drain("sw", handle, n)

    def sw_acquire(self, slots, limiter_ids, permits, now_ms: int):
        """Batched sliding-window tryAcquire.  Returns a dict of numpy
        arrays (allowed, mutated, observed, cache_value) of the input's
        length."""
        handle = self.sw_acquire_dispatch(slots, limiter_ids, permits, now_ms)
        return self.sw_acquire_drain(handle, len(slots))

    def tb_acquire_dispatch(self, slots, limiter_ids, permits, now_ms: int):
        return self._acquire_dispatch("tb", slots, limiter_ids, permits,
                                      now_ms)

    @staticmethod
    def tb_acquire_drain(handle, n: int):
        return DeviceEngine.micro_staged_drain("tb", handle, n)

    def tb_acquire(self, slots, limiter_ids, permits, now_ms: int):
        handle = self.tb_acquire_dispatch(slots, limiter_ids, permits, now_ms)
        return self.tb_acquire_drain(handle, len(slots))

    # -- staged micro-batch dispatch ------------------------------------------
    def micro_staged_dispatch(self, algo: str, staged: np.ndarray, n: int):
        """Dispatch a pre-staged micro-batch: ``staged`` is the combined
        i64[4, cap] host buffer (cap a pow2 >= _MICRO_FLOOR, padding lanes
        holding their fill values, timestamp at [3, 0]); ``n`` is the live
        lane count.  Returns the fused output tensor for
        :meth:`micro_staged_drain`.

        The copy to the device is issued with ``non_blocking=True`` from
        the caller's numpy buffer; on a CPU engine the tensor ALIASES that
        buffer.  Either way the caller must not reuse the buffer before the
        batch is drained (the batcher recycles staging buffers at drain
        time for exactly this reason)."""
        size = _bucket_size(n)
        if size != staged.shape[1]:
            staged = np.ascontiguousarray(staged[:, :size])
        lanes = torch.from_numpy(staged).to(self.device, non_blocking=True)
        step = _STEPS[algo]
        with self._lock:
            out = step(self._packed(algo), self.table.device_arrays,
                       lanes[0], lanes[1], lanes[2], lanes[3, 0])
            self._mark(algo, staged[0, :n], dev=lanes[0])
        return out

    @staticmethod
    def micro_staged_drain(algo: str, handle, n: int):
        return _DECODE[algo](handle[:, :n].cpu().numpy())

    # -- relay digest dispatch (ops/relay.py) ---------------------------------
    def relay_usable(self) -> bool:
        """Whether the relay word layout can carry every registered
        limiter (the rank clamp must exceed each max_permits)."""
        return relay_ops.relay_usable(self.rank_bits,
                                      self.table.max_permits_registered)

    def counts_dtype(self):
        """numpy dtype of the per-unique allowed counts (None if none
        fits the registered limiters)."""
        return relay_ops.counts_dtype(self.table.max_permits_registered)

    def sw_relay_counts_dispatch(self, uwords, lid: int, now_ms: int,
                                 out_dtype):
        return self._relay_counts_dispatch("sw", uwords, lid, now_ms,
                                           out_dtype)

    def tb_relay_counts_dispatch(self, uwords, lid: int, now_ms: int,
                                 out_dtype):
        return self._relay_counts_dispatch("tb", uwords, lid, now_ms,
                                           out_dtype)

    def _relay_counts_dispatch(self, algo: str, uwords, lid: int,
                               now_ms: int, out_dtype):
        """``uwords``: the host's uint32[U] words (slot | clamped count;
        padding 0xFFFFFFFF); ``lid``: one limiter id.  Uploads the words,
        runs the relay step in place on the state and returns the
        ``out_dtype[U]`` allowed-count tensor without waiting.

        The caller must not reuse ``uwords`` before the counts are
        drained: on a CPU engine the uploaded tensor aliases it."""
        words = self._upload_words(uwords)
        with self._lock:
            out = _RELAY_STEPS[algo](
                self._packed(algo), self.table.device_arrays, words,
                int(lid), int(now_ms), rank_bits=self.rank_bits,
                out_dtype=_COUNTS_TORCH[np.dtype(out_dtype)])
            self._mark_words(algo, uwords, dev=words)
        return out

    def sw_relay_counts_split_dispatch(self, s3, mwords, lid: int,
                                       now_ms: int, out_dtype):
        return self._relay_counts_split_dispatch("sw", s3, mwords, lid,
                                                 now_ms, out_dtype)

    def tb_relay_counts_split_dispatch(self, s3, mwords, lid: int,
                                       now_ms: int, out_dtype):
        return self._relay_counts_split_dispatch("tb", s3, mwords, lid,
                                                 now_ms, out_dtype)

    def _relay_counts_split_dispatch(self, algo: str, s3, mwords, lid: int,
                                     now_ms: int, out_dtype):
        """The split digest (``ops/relay.py:*_relay_counts_split``):
        ``s3`` the host's uint8[S, 3] singles plane (little-endian slots,
        padding 0xFFFFFF, S a multiple of 8), ``mwords`` its uint32[M]
        multi words (padding 0xFFFFFFFF), ``lid`` one limiter id.  Returns
        the uint8[S / 8 + M * itemsize] tensor (the singles' allow bits,
        then the multis' counts as bytes) without waiting.  The singles'
        and the multis' slots are marked after the step, under the engine
        lock (ROADMAP C10).

        The caller must not reuse ``s3`` or ``mwords`` before the result
        is drained: on a CPU engine the uploaded tensors alias them."""
        plane = self._upload(s3, np.uint8)
        words = self._upload_words(mwords)
        with self._lock:
            out = _SPLIT_STEPS[algo](
                self._packed(algo), self.table.device_arrays, plane, words,
                int(lid), int(now_ms), rank_bits=self.rank_bits,
                out_dtype=_COUNTS_TORCH[np.dtype(out_dtype)])
            if self.journal is not None:
                # Padding singles decode past num_slots; the journal drops
                # them.
                if getattr(self.journal, "device", False):
                    singles = relay_ops._decode_s3(plane, self.num_slots)[0]
                else:
                    s3a = np.asarray(s3, dtype=np.int64)
                    singles = (s3a[:, 0] | (s3a[:, 1] << 8)
                               | (s3a[:, 2] << 16))
                self._mark(algo, singles)
                self._mark_words(algo, mwords, dev=words)
        return out

    def sw_relay_counts_resident_dispatch(self, uwords, delta_slots,
                                          delta_lids, now_ms: int,
                                          out_dtype):
        return self._resident_dispatch("sw", uwords, delta_slots,
                                       delta_lids, now_ms, out_dtype)

    def tb_relay_counts_resident_dispatch(self, uwords, delta_slots,
                                          delta_lids, now_ms: int,
                                          out_dtype):
        return self._resident_dispatch("tb", uwords, delta_slots,
                                       delta_lids, now_ms, out_dtype)

    def _resident_dispatch(self, algo: str, uwords, delta_slots, delta_lids,
                           now_ms: int, out_dtype):
        """The digest for per-request limiter ids: ``uwords`` as
        :meth:`_relay_counts_dispatch`'s; ``delta_slots`` / ``delta_lids``
        the int32 (slot, lid) pairs the lid map does not hold yet (padding
        slot -1).  Folds the pairs into the algorithm's lid map, runs the
        step under each unique's mapped lid and returns the
        ``out_dtype[U]`` allowed counts without waiting."""
        words = self._upload_words(uwords)
        d_slots = self._upload(delta_slots, np.int32)
        d_lids = self._upload(delta_lids, np.int32)
        lid_map = self.sw_lid_map if algo == "sw" else self.tb_lid_map
        with self._lock:
            out = _RESIDENT_STEPS[algo](
                self._packed(algo), lid_map, self.table.device_arrays,
                words, d_slots, d_lids, int(now_ms),
                rank_bits=self.rank_bits,
                out_dtype=_COUNTS_TORCH[np.dtype(out_dtype)])
            self._mark_words(algo, uwords, dev=words)
        return out

    # -- words mode (ops/relay.py:*_relay_bits) --------------------------------
    def sw_relay_dispatch(self, words, lids, now_ms: int):
        return self._relay_bits_dispatch("sw", words, lids, now_ms)

    def tb_relay_dispatch(self, words, lids, now_ms: int):
        return self._relay_bits_dispatch("tb", words, lids, now_ms)

    def _relay_bits_dispatch(self, algo: str, words, lids, now_ms: int):
        """``words`` the host's uint32[B] per-request words (slot | clamped
        rank | last; padding 0xFFFFFFFF); ``lids`` one limiter id or
        int32[B].  Returns the uint8[ceil(B / 8)] arrival-order allow bits
        without waiting."""
        dev_words = self._upload_words(words)
        lids = self._lid_lanes(lids)
        with self._lock:
            out = _RELAY_BITS_STEPS[algo](
                self._packed(algo), self.table.device_arrays, dev_words,
                lids, int(now_ms), rank_bits=self.rank_bits)
            self._mark_words(algo, words, dev=dev_words)
        return out

    # -- flat sorted step and its K-step scan (ops/flat.py, ops/packed.py) ------
    # One flat sorted batch per dispatch (every request at the dispatch's
    # timestamp), or K sequential steps of one per super-batch past the
    # flat step's lane cap; packed allow bits back.

    def sw_flat_dispatch(self, slots, lids, permits, now_ms: int):
        return self._flat_dispatch("sw", slots, lids, permits, now_ms)

    def tb_flat_dispatch(self, slots, lids, permits, now_ms: int):
        return self._flat_dispatch("tb", slots, lids, permits, now_ms)

    def _flat_dispatch(self, algo: str, slots, lids, permits, now_ms: int):
        """``slots`` int32[B] (-1: padding or a forced deny); ``lids`` one
        limiter id or int32[B]; ``permits`` None (unit), uint8[B] or
        int32[B].  Returns the uint8[ceil(B / 8)] arrival-order allow bits
        without waiting."""
        dev_slots = self._upload(slots, np.int32)
        lids = self._lid_lanes(lids)
        permits = self._permit_lanes(permits)
        with self._lock:
            out = _FLAT_STEPS[algo](self._packed(algo),
                                    self.table.device_arrays, dev_slots,
                                    lids, permits, int(now_ms))
            self._mark(algo, slots, dev=dev_slots)
        return out

    def sw_scan_dispatch(self, slots_kb, lids, permits_kb, now_k):
        return self._scan_dispatch("sw", slots_kb, lids, permits_kb, now_k)

    def tb_scan_dispatch(self, slots_kb, lids, permits_kb, now_k):
        return self._scan_dispatch("tb", slots_kb, lids, permits_kb, now_k)

    def _scan_dispatch(self, algo: str, slots_kb, lids, permits_kb, now_k):
        """``slots_kb`` int32[K, B]; ``lids`` one limiter id or int32[K, B];
        ``permits_kb`` None, uint8 or int32 [K, B]; ``now_k`` int64[K], the
        steps' stamps.  Returns the uint8[K, ceil(B / 8)] allow bits
        without waiting."""
        dev_slots = self._upload(slots_kb, np.int32)
        lids = self._lid_lanes(lids)
        permits_kb = self._permit_lanes(permits_kb)
        now_k = self._upload(now_k, np.int64)
        with self._lock:
            out = _SCAN_STEPS[algo](self._packed(algo),
                                    self.table.device_arrays, dev_slots,
                                    lids, permits_kb, now_k)
            self._mark(algo, slots_kb, dev=dev_slots)
        return out

    # -- weighted relay (ops/relay.py:*_relay_weighted*) ----------------------
    def sw_weighted_dispatch(self, uwords, perms_rank, roff, lid: int,
                             now_ms: int, r_steps: int):
        return self._weighted_dispatch("sw", uwords, perms_rank, roff, lid,
                                       now_ms, r_steps)

    def tb_weighted_dispatch(self, uwords, perms_rank, roff, lid: int,
                             now_ms: int, r_steps: int):
        return self._weighted_dispatch("tb", uwords, perms_rank, roff, lid,
                                       now_ms, r_steps)

    def _weighted_dispatch(self, algo: str, uwords, perms_rank, roff,
                           lid: int, now_ms: int, r_steps: int):
        """``uwords`` uint32[U] (slot | count; padding 0xFFFFFFFF) in
        count-descending segment order, ``perms_rank`` uint8[L] the
        rank-major permits, ``roff`` the host's int64 rank offsets (at
        least ``r_steps``).  Returns the uint8[L / 8] decision bits in the
        rank-major layout without waiting."""
        words = self._upload_words(uwords)
        perms_rank = self._upload(perms_rank, np.uint8)
        with self._lock:
            out = _WEIGHTED_STEPS[algo](
                self._packed(algo), self.table.device_arrays, words,
                perms_rank, np.asarray(roff), int(lid), int(now_ms),
                rank_bits=self.rank_bits, r_steps=int(r_steps))
            self._mark_words(algo, uwords, dev=words)
        return out

    def sw_weighted_counts_dispatch(self, uwords, wlane, lid: int,
                                    now_ms: int, out_dtype):
        return self._weighted_counts_dispatch("sw", uwords, wlane, lid,
                                              now_ms, out_dtype)

    def tb_weighted_counts_dispatch(self, uwords, wlane, lid: int,
                                    now_ms: int, out_dtype):
        return self._weighted_counts_dispatch("tb", uwords, wlane, lid,
                                              now_ms, out_dtype)

    def _weighted_counts_dispatch(self, algo: str, uwords, wlane, lid: int,
                                  now_ms: int, out_dtype):
        """Coalesced weighted step: ``uwords`` uint32[U] (slot | clamped
        count; padding 0xFFFFFFFF), ``wlane`` uint8[U] each segment's one
        weight.  Returns the ``out_dtype[U]`` allowed counts without
        waiting.  Only valid when every repeat of a key in the chunk
        carries the same weight."""
        words = self._upload_words(uwords)
        wlane = self._upload(wlane, np.uint8)
        with self._lock:
            out = _WEIGHTED_COUNTS_STEPS[algo](
                self._packed(algo), self.table.device_arrays, words, wlane,
                int(lid), int(now_ms), rank_bits=self.rank_bits,
                out_dtype=_COUNTS_TORCH[np.dtype(out_dtype)])
            self._mark_words(algo, uwords, dev=words)
        return out

    # -- lease reserve / credit (ops/lease.py; leases/) -----------------------
    # Charge (or return) a per-key permit budget in one gather -> roll or
    # refill -> greedy grant -> scatter pass, under the lock every other
    # dispatch takes, on the same stream.  Rare by design (one reserve
    # serves a whole client-side budget), so each runs synchronously:
    # enqueue and fetch in one call.

    def _lease_lanes(self, n: int, now_ms: int, *columns) -> torch.Tensor:
        """The call's lanes padded to its bucket, one upload: the given
        columns, slots first (pad -1, the others pad 0), and a last row
        whose lane 0 is the timestamp (a Python int turned into a tensor
        on the card would wait for the stream)."""
        lanes = np.zeros((1 + len(columns), _bucket_size(n)), dtype=np.int64)
        lanes[0] = -1
        for row, values in enumerate(columns):
            lanes[row, :n] = np.asarray(values, dtype=np.int64)
        lanes[-1, 0] = now_ms
        return torch.from_numpy(lanes).to(self.device, non_blocking=True)

    def lease_reserve(self, algo: str, slots, limiter_ids, requested,
                      now_ms: int):
        """Grant up to ``requested[i]`` permits against each slot's live
        counters.  Returns ``(granted i64[n], ws i64[n])``: ``ws`` is the
        window the charge landed in (sliding window; zeros for the token
        bucket), which a later :meth:`lease_credit` must present."""
        n = len(slots)
        with self._lock:
            lanes = self._lease_lanes(n, now_ms, slots, limiter_ids,
                                      requested)
            granted, ws = lease_ops.RESERVE_STEPS[algo](
                self._packed(algo), self.table.device_arrays, lanes[0],
                lanes[1], lanes[2], lanes[3, 0])
            self._mark(algo, slots, dev=lanes[0])
        out = torch.stack([granted[:n], ws[:n]]).cpu().numpy()
        return out[0], out[1]

    def lease_credit(self, algo: str, slots, limiter_ids, credit, grant_ws,
                     now_ms: int) -> np.ndarray:
        """Return unused reserved permits; ``grant_ws`` is the per-lane
        window :meth:`lease_reserve` returned (sliding window: a rolled
        window drops the credit, the charge already ages out with it).
        Returns the permits credited per lane."""
        n = len(slots)
        with self._lock:
            lanes = self._lease_lanes(n, now_ms, slots, limiter_ids, credit,
                                      grant_ws)
            credited = lease_ops.CREDIT_STEPS[algo](
                self._packed(algo), self.table.device_arrays, lanes[0],
                lanes[1], lanes[2], lanes[3], lanes[4, 0])
            self._mark(algo, slots, dev=lanes[0])
        return credited[:n].cpu().numpy()

    # -- read-only ------------------------------------------------------------
    def _available(self, algo: str, peek, slots, limiter_ids, now_ms: int):
        with self._lock:
            out = peek(self._packed(algo), self.table.device_arrays,
                       self._lanes(slots), self._lanes(limiter_ids), now_ms)
        return out.cpu().numpy()

    def sw_available(self, slots, limiter_ids, now_ms: int) -> np.ndarray:
        return self._available("sw", sw_peek_p, slots, limiter_ids, now_ms)

    def tb_available(self, slots, limiter_ids, now_ms: int) -> np.ndarray:
        return self._available("tb", tb_peek_p, slots, limiter_ids, now_ms)

    # -- reset ----------------------------------------------------------------
    def sw_clear(self, slots: Sequence[int]) -> None:
        lanes = self._lanes(slots)
        with self._lock:
            sw_reset_p(self.sw_packed, lanes)
            self._mark("sw", slots, dev=lanes)

    def tb_clear(self, slots: Sequence[int]) -> None:
        lanes = self._lanes(slots)
        with self._lock:
            tb_reset_p(self.tb_packed, lanes)
            self._mark("tb", slots, dev=lanes)

    # -- raw packed-row access ------------------------------------------------
    def read_rows(self, algo: str, slots) -> np.ndarray:
        """Packed state rows for the given slots (host numpy i32[n, lanes])."""
        with self._lock:
            rows = self._packed(algo)[self._lanes(slots)]
        return rows.cpu().numpy()

    def write_rows(self, algo: str, slots, rows: np.ndarray) -> None:
        """Overwrite packed state rows (slots unique)."""
        idx = self._lanes(slots)
        vals = torch.as_tensor(np.ascontiguousarray(rows, dtype=np.int32),
                               device=self.device)
        with self._lock:
            scatter_rows(self._packed(algo), idx,
                         torch.ones_like(idx, dtype=torch.bool), vals)
            self._mark(algo, slots, dev=idx)

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
