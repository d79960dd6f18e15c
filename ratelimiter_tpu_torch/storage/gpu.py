"""GpuBatchedStorage — the GPU-resident storage backend, micro-batch route
(counterpart of ``ratelimiter_tpu/storage/tpu.py:TpuBatchedStorage``).

Behind the ``RateLimitStorage`` plugin boundary, ``tryAcquire()`` calls are
micro-batched on the host (engine/batcher.py) and dispatched to counter
rows resident on the card (engine/engine.py), one fused step per batch,
with decisions bit-identical to ``semantics/oracle.py``.

The surface is the batched decision protocol: ``register_limiter``,
``set_policy``, ``acquire`` / ``acquire_async`` (one decision through the
batcher), ``acquire_many`` (one synchronous batch), ``available_many``,
``reset_key``, ``flush`` and ``close``.  The host-side legacy counter and
script contract of ``RateLimitStorage`` is not served by this backend.

The storage runs on the card: ``device=None`` resolves to ``cuda`` and
raises when no CUDA device is present.  Pass ``device="cpu"`` to run the
same code on the CPU (the kernels' plain versions serve CPU tensors).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.engine.batcher import MicroBatcher
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.flush_control import AdaptiveFlushController
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.storage.base import RateLimitStorage


# The adaptive flush deadline's lower clamp (the reference's default).
_FLUSH_FLOOR_MS = 0.05


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000


def resolve_device(device) -> torch.device:
    """``None`` means the card: ``cuda``, or a RuntimeError when no CUDA
    device is present (never a silent move to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "GpuBatchedStorage runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class GpuBatchedStorage(RateLimitStorage):
    supports_device_batching = True

    def __init__(
        self,
        num_slots: int = 1 << 20,
        max_batch: int = 8192,
        max_delay_ms: float = 0.5,
        clock_ms: Callable[[], int] = _wall_clock_ms,
        meter_registry: MeterRegistry | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self._clock_ms = clock_ms
        if meter_registry is None:
            meter_registry = MeterRegistry()
        self.registry = meter_registry
        self.table = LimiterTable(device=self.device)
        self.engine = DeviceEngine(num_slots, self.table, device=self.device)
        self._configs: Dict[int, Tuple[str, RateLimitConfig]] = {}
        self._index = {"sw": self.engine.make_slot_index(),
                       "tb": self.engine.make_slot_index()}
        # Batch timestamps are clamped monotonically non-decreasing: a wall
        # clock stepping backwards must not roll windows backwards (the
        # slot rows keep only the curr and prev buckets).  Each absorbed
        # regression is counted.
        self._last_stamp = 0
        self._stamp_lock = threading.Lock()
        self.backward_clamps = 0

        def _stamp() -> int:
            with self._stamp_lock:
                now = self._clock_ms()
                if now < self._last_stamp:
                    self.backward_clamps += 1
                else:
                    self._last_stamp = now
                return self._last_stamp

        self._monotonic_now = _stamp

        # Dispatch/drain split (engine + batcher): the flusher only
        # enqueues device work and the drainers copy results back, so
        # several batches can be in flight.  The list surface
        # (dispatch_direct) and the staged surface (the flusher's
        # pre-packed buffer) return the same fused tensor, so one drain
        # per algo serves both.
        def _dispatcher(fn):
            def run(s, l, p):
                return fn(s, l, p, _stamp())

            return run

        def _staged_dispatcher(algo):
            def run(buf, n):
                buf[3, 0] = _stamp()
                return self.engine.micro_staged_dispatch(algo, buf, n)

            return run

        def _drainer(algo):
            return lambda handle, n: self.engine.micro_staged_drain(
                algo, handle, n)

        # Adaptive flush control (engine/flush_control.py): the applied
        # deadline and size trigger track the measured step time, clamped
        # within [_FLUSH_FLOOR_MS, max_delay_ms] and [32, max_batch].
        controller = AdaptiveFlushController(
            base_delay_ms=max_delay_ms,
            floor_ms=min(_FLUSH_FLOOR_MS, max_delay_ms)
            if max_delay_ms > 0 else _FLUSH_FLOOR_MS,
            cap_ms=max(max_delay_ms, _FLUSH_FLOOR_MS),
            size_floor=32,
            size_cap=max_batch,
            meter_registry=meter_registry,
        )
        self._batcher = MicroBatcher(
            dispatch={
                "sw": _dispatcher(self.engine.sw_acquire_dispatch),
                "tb": _dispatcher(self.engine.tb_acquire_dispatch),
            },
            drain={"sw": _drainer("sw"), "tb": _drainer("tb")},
            dispatch_staged={"sw": _staged_dispatcher("sw"),
                             "tb": _staged_dispatcher("tb")},
            clear={
                "sw": lambda slots: self._clear_slots("sw", slots),
                "tb": lambda slots: self._clear_slots("tb", slots),
            },
            max_batch=max_batch,
            max_delay_ms=max_delay_ms,
            controller=controller,
        )

    # ------------------------------------------------------------------------
    # Batched decision protocol (the hot path)
    # ------------------------------------------------------------------------
    def register_limiter(self, algo: str, config: RateLimitConfig) -> int:
        """Register a limiter policy; returns its limiter id (table row)."""
        if algo not in ("sw", "tb"):
            raise ValueError(f"unknown algorithm kind: {algo!r}")
        config.validate()
        lid = self.table.register(config)
        self._configs[lid] = (algo, config)
        return lid

    def set_policy(self, lid: int, config: RateLimitConfig) -> int:
        """Live-update one limiter's policy; returns the policy generation
        the update installed.  Pending micro-batch traffic is flushed
        first, so every decision stamped before this call ran under the
        old row and every later one under the new."""
        entry = self._configs.get(int(lid))
        if entry is None:
            raise KeyError(f"no limiter registered under lid={lid}")
        algo, _old = entry
        config.validate()
        self._batcher.flush()
        gen = self.table.set_policy(int(lid), config)
        self._configs[int(lid)] = (algo, config)
        return gen

    def acquire(self, algo: str, lid: int, key: str, permits: int) -> dict:
        """Single decision through the micro-batcher (blocks until the
        batch holding this request lands; bounded by max_delay_ms)."""
        return self.acquire_async(algo, lid, key, permits).result()

    def acquire_async(self, algo: str, lid: int, key: str, permits: int):
        """Future-returning :meth:`acquire`: a caller may submit many
        before resolving any, so they coalesce into one flush."""
        slot = self._assign_slot(algo, lid, key, hold_pin=True)
        # The pin (taken inside the assign) holds until the submit has
        # registered the slot in the batcher's pending set.
        with self._pins_released(self._index[algo], [slot]):
            return self._batcher.submit(algo, slot, lid, permits)

    def acquire_many(
        self, algo: str, lid_per_req: Sequence[int], keys: Sequence[str],
        permits: Sequence[int],
    ) -> Dict[str, np.ndarray]:
        """Whole-batch synchronous decision (the vectorized path)."""
        index = self._index[algo]
        pinned = self._batcher.pending_slots(algo)
        slots: List[int] = []
        clears: List[int] = []
        # try/finally from the FIRST assign: a mid-loop raise ("all slots
        # pinned") must release the pins earlier iterations took — and
        # clear the evictions they applied.
        try:
            try:
                for lid, key in zip(lid_per_req, keys):
                    slot, evicted = index.assign((lid, key), pinned=pinned,
                                                 hold_pin=True)
                    if evicted is not None:
                        clears.append(evicted)
                    pinned.add(slot)
                    slots.append(slot)
            except Exception:
                if clears:
                    self._clear_slots(algo, clears)
                raise
            return self._batcher.dispatch_direct(
                algo, slots, list(lid_per_req), list(permits), clears)
        finally:
            if slots:
                index.unpin_batch(np.asarray(slots, dtype=np.int64))

    def available_many(
        self, algo: str, lid: int, keys: Sequence[str]
    ) -> np.ndarray:
        """Read-only availablePermits; unknown keys are computed host-side
        (absent state: full availability)."""
        _, config = self._configs[lid]
        index = self._index[algo]
        known: List[Tuple[int, int]] = []  # (position, slot)
        out = np.empty(len(keys), dtype=np.int64)
        for i, key in enumerate(keys):
            slot = index.get((lid, key))
            if slot is None:
                out[i] = config.max_permits
            else:
                known.append((i, slot))
        if known:
            # Flush queued mutations so the read observes them.
            self._batcher.flush()
            now = self._monotonic_now()
            slots = [s for _, s in known]
            available = (self.engine.sw_available if algo == "sw"
                         else self.engine.tb_available)
            vals = available(slots, [lid] * len(slots), now)
            for (i, _), v in zip(known, vals):
                out[i] = v
        return out

    def reset_key(self, algo: str, lid: int, key: str) -> None:
        """Admin reset: flush pending, clear the slot, then release it —
        zeroed while still mapped to the old key, so no other key can be
        assigned the slot before it is clean."""
        index = self._index[algo]
        if index.get((lid, key)) is None:
            return
        self._batcher.flush()
        slot = index.get((lid, key))
        if slot is None:
            return
        self._clear_slots(algo, [slot])
        index.remove((lid, key))

    def flush(self) -> None:
        self._batcher.flush()

    def is_available(self) -> bool:
        """Health check: the device must complete its queued work."""
        try:
            self.engine.block_until_ready()
            return True
        except RuntimeError:
            return False

    def close(self) -> None:
        self._batcher.close()

    # ------------------------------------------------------------------------
    # Legacy host-side contract: not served by this backend
    # ------------------------------------------------------------------------
    def _legacy(self, *_args, **_kwargs):
        raise NotImplementedError(
            "GpuBatchedStorage serves registered limiters only; the legacy "
            "counter/script contract is not part of this backend")

    increment_and_expire = get = set = compare_and_set = delete = _legacy
    z_add = z_remove_range_by_score = z_count = eval_script = _legacy

    # ------------------------------------------------------------------------
    @contextlib.contextmanager
    def _pins_released(self, index, slots):
        """Release pins taken atomically inside an assign (``hold_pin``)
        once the enclosed submit is queued: without them, concurrent
        traffic under eviction pressure could reassign-and-clear a slot
        between the assignment and the submit."""
        try:
            yield
        finally:
            if len(slots):
                index.unpin_batch(slots)

    def _clear_slots(self, algo: str, slots) -> None:
        """Single choke point for zeroing evicted/reset slots."""
        if len(slots):
            (self.engine.sw_clear if algo == "sw"
             else self.engine.tb_clear)(list(slots))

    def _assign_slot(self, algo: str, lid: int, key: str,
                     hold_pin: bool = False) -> int:
        index = self._index[algo]
        pinned = self._batcher.pending_slots(algo)
        slot, evicted = index.assign((lid, key), pinned=pinned,
                                     hold_pin=hold_pin)
        if evicted is not None:
            self._batcher.add_clear(algo, evicted)
        return slot
