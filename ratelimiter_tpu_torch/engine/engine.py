"""Single-device decision engine (counterpart of
``ratelimiter_tpu/engine/engine.py``): the micro-batch route and the relay
digest route.

Owns the device-resident packed slot state for both algorithms and runs
the steps on it.  The state tensors are updated in place (the reference
donated its buffers to jitted steps); every access goes through one lock
so the ops of two dispatches never interleave.

A dispatch enqueues its step on the current CUDA stream and returns the
output tensor without waiting: the fused ``i64[3, B]`` of a micro step,
or the per-unique allowed counts of a relay step.  The drain is the
``.cpu()`` copy of that tensor, which waits for the step.  On a CPU engine
(``device="cpu"``, as the tests run it) the same code runs the plain
versions of the kernels synchronously.

This is the device half of ``GpuBatchedStorage``; the host half (key->slot
index + micro-batcher) lives in engine/native_index.py and
engine/batcher.py.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from ratelimiter_tpu_torch.engine.native_index import NativeSlotIndex
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.ops import relay as relay_ops
from ratelimiter_tpu_torch.ops.packed import (
    decode_sw_fused,
    decode_tb_fused,
    sw_step_fused,
    tb_step_fused,
)
from ratelimiter_tpu_torch.ops.scatter import scatter_rows
from ratelimiter_tpu_torch.ops.sliding_window import (
    make_sw_packed,
    sw_peek_p,
    sw_reset_p,
)
from ratelimiter_tpu_torch.ops.token_bucket import (
    make_tb_packed,
    tb_peek_p,
    tb_reset_p,
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

    def _lanes(self, values) -> torch.Tensor:
        """Host lane values as an int64 tensor on the engine's device."""
        return torch.as_tensor(np.asarray(values, dtype=np.int64),
                               device=self.device)

    def _packed(self, algo: str) -> torch.Tensor:
        return self.sw_packed if algo == "sw" else self.tb_packed

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
            return step(self._packed(algo), self.table.device_arrays,
                        lanes[0], lanes[1], lanes[2], lanes[3, 0])

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
        words = torch.from_numpy(
            np.ascontiguousarray(uwords, dtype=np.uint32).view(np.int32)
        ).to(self.device, non_blocking=True)
        with self._lock:
            return _RELAY_STEPS[algo](
                self._packed(algo), self.table.device_arrays, words,
                int(lid), int(now_ms), rank_bits=self.rank_bits,
                out_dtype=_COUNTS_TORCH[np.dtype(out_dtype)])

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
        with self._lock:
            sw_reset_p(self.sw_packed, self._lanes(slots))

    def tb_clear(self, slots: Sequence[int]) -> None:
        with self._lock:
            tb_reset_p(self.tb_packed, self._lanes(slots))

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

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def make_slot_index(self) -> NativeSlotIndex:
        """The C slot index over this engine's slots (built at first use;
        a failed build raises)."""
        return NativeSlotIndex(self.num_slots)
