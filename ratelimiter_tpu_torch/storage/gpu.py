"""GpuBatchedStorage — the GPU-resident storage backend (counterpart of
``ratelimiter_tpu/storage/tpu.py:TpuBatchedStorage``): the micro-batch
route and the relay stream route.

Behind the ``RateLimitStorage`` plugin boundary, ``tryAcquire()`` calls are
micro-batched on the host (engine/batcher.py) and dispatched to counter
rows resident on the card (engine/engine.py), one fused step per batch,
with decisions bit-identical to ``semantics/oracle.py``.  Integer-key
streams of unit-permit requests take the relay route instead
(:meth:`GpuBatchedStorage.acquire_stream_ids`): per chunk the C slot index
compacts the requests to one word per unique slot, one device step decides
every unique slot at once, and the host rebuilds each request's decision.

The surface is the batched decision protocol: ``register_limiter``,
``set_policy``, ``acquire`` / ``acquire_async`` (one decision through the
batcher), ``acquire_many`` / ``acquire_many_ids`` (one synchronous
batch), ``acquire_stream_ids`` (a whole stream, pipelined),
``available_many``, ``reset_key``, ``flush`` and ``close``.  The host-side
legacy counter and script contract of ``RateLimitStorage`` is not served
by this backend.

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
from ratelimiter_tpu_torch.engine.native_index import (
    relay_decide,
    sort_uniques,
)
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.storage.base import RateLimitStorage


# The adaptive flush deadline's lower clamp (the reference's default).
_FLUSH_FLOOR_MS = 0.05

# Relay stream chunking (the reference's schedule, storage/tpu.py:70-84):
# the first chunk is _RELAY_CHUNK requests; each later chunk grows toward
# the digest wire budget at the bytes per request the previous chunk
# measured, capped at _RELAY_CHUNK_MAX.  Zipf traffic compacts harder in
# bigger chunks, so skewed streams grow to a few giant chunks.
_RELAY_CHUNK = 1 << 19
_RELAY_CHUNK_MAX = 1 << 24
_RELAY_WIRE_BUDGET_DIGEST = 16 << 20
# Digest wire bytes per unique slot: the 4 B word up and a 1-2 B count
# back (the reference's single-tenant constant, ops/relay.py:wire_costs).
_DIGEST_BYTES_PER_UNIQUE = 6.0
# At or above this many uniques the C index sorts a chunk's uniques by
# slot, so the device step walks the state rows in address order.
_SORT_UNIQUES_MIN = 1 << 12


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000


def _pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


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
        # Per-chunk host timings of the last acquire_stream_ids call.
        self.last_stream_chunks: List[dict] = []
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
        lid0 = lid_per_req[0] if len(lid_per_req) else 0
        if all(lid == lid0 for lid in lid_per_req):
            # One limiter: one C call maps the whole batch, after queued
            # traffic is flushed (the reference's native path; a key's
            # repeats in the batch count as one recency touch).
            self._batcher.flush()
            with self._evictions_cleared(algo):
                slots, clears = index.assign_batch_strs(
                    list(keys), lid0,
                    pinned=self._batcher.pending_slots(algo), hold_pins=True)
            with self._pins_released(index, slots):
                return self._batcher.dispatch_direct(
                    algo, slots, list(lid_per_req), list(permits),
                    list(clears))
        pinned = self._batcher.pending_slots(algo)
        slots: List[int] = []
        clears: List[int] = []
        # try/finally from the FIRST assign: a mid-loop raise ("all slots
        # pinned") must release the pins earlier iterations took — and
        # clear the evictions they applied.
        try:
            try:
                # Each slot is held pinned as it is assigned, so later
                # keys of the batch cannot evict it.
                for lid, key in zip(lid_per_req, keys):
                    slot, evicted = index.assign((lid, key), pinned=pinned,
                                                 hold_pin=True)
                    if evicted is not None:
                        clears.append(evicted)
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

    def acquire_many_ids(self, algo: str, lid: int, key_ids: np.ndarray,
                         permits: np.ndarray) -> Dict[str, np.ndarray]:
        """Int-key whole-batch decision: one C call assigns the slots
        (pinned until the batch is enqueued), one device batch decides."""
        index = self._index[algo]
        self._batcher.flush()
        with self._evictions_cleared(algo):
            slots, clears = index.assign_batch_ints(
                np.ascontiguousarray(key_ids, dtype=np.int64), lid,
                pinned=self._batcher.pending_slots(algo), hold_pins=True)
        lids = np.full(len(slots), lid, dtype=np.int32)
        with self._pins_released(index, slots):
            return self._batcher.dispatch_direct(algo, slots, lids, permits,
                                                 list(clears))

    def acquire_stream_ids(self, algo: str, lid: int, key_ids: np.ndarray,
                           permits: np.ndarray | None = None) -> np.ndarray:
        """Whole-stream int-key decisions for unit-permit requests, on the
        relay route; returns bool[n] allowed, in arrival order.

        Decisions equal ``acquire_many_ids`` on the same chunking: every
        request of a chunk is stamped with the chunk's time.  Keys share
        the (lid, key) namespace of ``acquire_many_ids`` and ``acquire``,
        so the paths mix freely on one limiter.  Pending micro-batch
        traffic is flushed first.

        Served here: one limiter id for the whole stream, unit permits,
        and every registered max_permits below the word layout's count
        clamp and within uint16.  A per-request lid array, a permits lane
        and wider limits raise NotImplementedError."""
        if np.ndim(lid) != 0:
            raise NotImplementedError(
                "acquire_stream_ids: per-request limiter ids (the resident "
                "lid map) are not ported yet (ROADMAP A2)")
        if permits is not None:
            raise NotImplementedError(
                "acquire_stream_ids: a permits lane (the weighted relay, "
                "ROADMAP A2, and the flat path, ROADMAP A3) is not ported "
                "yet; pass permits=None for unit permits")
        if not self.engine.relay_usable():
            raise NotImplementedError(
                "acquire_stream_ids: a registered max_permits reaches the "
                "relay word's count clamp; the flat path that serves it is "
                "not ported yet (ROADMAP A3)")
        if self.engine.counts_dtype() is None:
            raise NotImplementedError(
                "acquire_stream_ids: a registered max_permits exceeds "
                "uint16 counts; the words mode that serves it is not "
                "ported yet (ROADMAP A2)")
        self._batcher.flush()
        return self._stream_relay(
            algo, int(lid), np.ascontiguousarray(key_ids, dtype=np.int64))

    def _stream_relay(self, algo: str, lid: int,
                      key_ids: np.ndarray) -> np.ndarray:
        """The relay digest loop, pipelined one deep in one thread: chunk
        k is dispatched, chunk k+1 is assigned while the card runs chunk k
        (the C walk releases the GIL), then chunk k is drained.

        Per chunk: the C index assigns the slots and returns one word per
        unique slot (slot | clamped count) plus each request's (unique
        index, rank), with the unique slots pinned; the evictions are
        cleared; the uniques are sorted by slot when there are many; the
        words are padded to a power of two with 0xFFFFFFFF and dispatched
        at the chunk's timestamp; the pins are released once the step is
        enqueued.  The drain copies the per-unique allowed counts back and
        rebuilds each request's decision as ``rank < counts[uidx]``.

        Each chunk's host timings (seconds) and sizes are recorded in
        ``last_stream_chunks``."""
        eng = self.engine
        index = self._index[algo]
        rb = eng.rank_bits
        cdt = eng.counts_dtype()
        dispatch = (eng.sw_relay_counts_dispatch if algo == "sw"
                    else eng.tb_relay_counts_dispatch)
        n = len(key_ids)
        out = np.empty(n, dtype=bool)
        chunks: List[dict] = []
        self.last_stream_chunks = chunks

        def assign(start: int, count: int):
            t0 = time.perf_counter()
            with self._evictions_cleared(algo):
                res = index.assign_batch_ints_uniques(
                    key_ids[start:start + count], lid, rb,
                    pinned=self._batcher.pending_slots(algo), hold_pins=True)
            return (start, count, *res, time.perf_counter() - t0)

        def drain(counts, uidx, rank, start, count, rec):
            t0 = time.perf_counter()
            out[start:start + count] = relay_decide(counts.cpu().numpy(),
                                                    uidx, rank)
            rec["drain_s"] = time.perf_counter() - t0

        nxt = assign(0, min(_RELAY_CHUNK, n)) if n else None
        try:
            while nxt is not None:
                start, count, uwords, uidx, rank, clears, assign_s = nxt
                nxt = None
                u = len(uwords)
                rec = {"requests": count, "uniques": u, "assign_s": assign_s}
                chunks.append(rec)
                uslots = (uwords >> np.uint32(rb + 1)).astype(np.int32)
                with self._pins_released(index, uslots):
                    if len(clears):
                        self._clear_slots(algo, list(clears))
                    t0 = time.perf_counter()
                    if u >= _SORT_UNIQUES_MIN:
                        sort_uniques(uwords, rb, uidx)
                    t1 = time.perf_counter()
                    # A fresh buffer per chunk: the upload may alias it
                    # until the chunk is drained.
                    words = np.full(_pow2(u), 0xFFFFFFFF, dtype=np.uint32)
                    words[:u] = uwords
                    counts = dispatch(words, lid, self._monotonic_now(), cdt)
                    rec["sort_s"] = t1 - t0
                    rec["enqueue_s"] = time.perf_counter() - t1
                bpr = max(_DIGEST_BYTES_PER_UNIQUE * u / count, 1e-3)
                chunk = int(min(max(_RELAY_WIRE_BUDGET_DIGEST / bpr,
                                    _RELAY_CHUNK), _RELAY_CHUNK_MAX))
                if start + count < n:
                    nxt = assign(start + count, min(chunk, n - start - count))
                drain(counts[:u], uidx, rank, start, count, rec)
        finally:
            if nxt is not None:
                # An assignment the loop never dispatched: its evictions
                # are applied in the index and its uniques pinned.
                uwords, clears = nxt[2], nxt[5]
                try:
                    if len(clears):
                        self._clear_slots(algo, list(clears))
                finally:
                    index.unpin_batch(
                        (uwords >> np.uint32(rb + 1)).astype(np.int32))
        return out

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

    @contextlib.contextmanager
    def _evictions_cleared(self, algo: str):
        """A failed batch assignment still applied the evictions of the
        lanes that succeeded before it (engine/errors.py
        SlotCapacityError.pending_clears): those slots already map to new
        keys, so zero their device state before the error propagates, as
        the success path clears evictions ahead of reuse.  Clears once
        (the attribute is consumed) however many handlers the raise
        passes through."""
        try:
            yield
        except Exception as exc:  # noqa: BLE001 — always re-raised
            pending = getattr(exc, "pending_clears", None)
            if pending is not None and len(pending):
                # Clear first, null after: a clear that fails propagates
                # with the clears still attached (zeroing is idempotent).
                self._clear_slots(algo, [int(s) for s in pending])
                exc.pending_clears = None
            raise

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
